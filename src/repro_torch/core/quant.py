"""SmoothQuant W8A8 quantization (paper §III-E).

1. **Calibrate** — run the fp model over sample batches while a
   calibration context records per-channel activation absmax for every
   named linear (:func:`calibration`, :func:`record_act_stats`).
2. **Smooth** — migrate activation outliers into the weights with
   ``s_j = amax(X_j)^alpha / amax(W_j,:)^(1-alpha)``, normalised by the
   median factor; activations are divided by ``s`` and weight rows
   multiplied by it.
3. **Quantize** — per-output-channel symmetric int8 weights, dynamic
   per-token symmetric int8 activations.

Every function reproduces the JAX package's ``repro/core/quant.py`` bit for
bit on the same inputs: both frameworks round half to even, and the
median of an even channel count averages the two middle values here
explicitly (``torch.median`` would return the lower one).
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

_local = threading.local()


@contextlib.contextmanager
def calibration():
    """Context under which forward passes record activation absmax."""
    stats: Dict[str, torch.Tensor] = {}
    _local.stats = stats
    try:
        yield stats
    finally:
        _local.stats = None


def record_act_stats(name: str, x: torch.Tensor) -> None:
    """Called by ``linear()`` on its input when calibration is active."""
    stats = getattr(_local, "stats", None)
    if stats is None:
        return
    amax = x.float().reshape(-1, x.shape[-1]).abs().amax(dim=0)
    prev = stats.get(name)
    stats[name] = amax if prev is None else torch.maximum(prev, amax)


@functools.cache
def _libm_powf():
    path = ctypes.util.find_library("m")
    if path is None:
        raise RuntimeError("the C math library (libm) was not found")
    fn = ctypes.CDLL(path).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def _powf(x: torch.Tensor, e: float) -> torch.Tensor:
    """Elementwise float32 ``x ** e`` through the C library's ``powf``,
    which is what XLA's CPU ``pow`` lowers to.  ``torch.pow`` (and
    ``torch.sqrt``) round differently in the last place for a fraction of
    inputs, and the smoothing factors must be bit-identical to the JAX
    package's.  Host-side and per element: it runs once per linear at
    quantization time."""
    powf = _libm_powf()
    arr = x.detach().float().cpu().numpy()
    out = np.fromiter((powf(v, e) for v in arr.ravel().tolist()),
                      dtype=np.float32, count=arr.size)
    return torch.from_numpy(out.reshape(arr.shape)).to(x.device)


def _median(s: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the midpoint of the two middle values."""
    srt = torch.sort(s).values
    n = srt.numel()
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def smooth_factors(act_amax: torch.Tensor, w: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """Per-in-channel smoothing factors s (K,) for weight w (K, N)."""
    w_amax = w.float().abs().amax(dim=1)
    a = torch.clamp(act_amax.float(), min=1e-5)
    wmax = torch.clamp(w_amax, min=1e-5)
    s = _powf(a, alpha) / _powf(wmax, 1.0 - alpha)
    s = s / _median(s)  # the median channel is unscaled
    return torch.clamp(s, 1e-3, 1e3)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8. w (K, N) -> (w_q, scale (1, N))."""
    amax = w.float().abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_act(x: torch.Tensor):
    """Symmetric dynamic per-token int8. x (M, K) -> (x_q, scale (M, 1))."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    x_q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return x_q, scale


def quantize_linear_params(w: torch.Tensor, bias: Optional[torch.Tensor],
                           act_amax: Optional[torch.Tensor] = None,
                           alpha: float = 0.5) -> Dict[str, torch.Tensor]:
    """The serving-side quantized linear group from an fp weight."""
    if act_amax is None:  # no calibration -> plain W8A8
        smooth = torch.ones(w.shape[0], dtype=torch.float32, device=w.device)
    else:
        smooth = smooth_factors(act_amax.to(w.device), w, alpha)
    w_q, w_scale = quantize_weight(w.float() * smooth[:, None])
    out = {"w_q": w_q, "w_scale": w_scale, "smooth": smooth}
    if bias is not None:
        out["bias"] = bias.float()
    return out
