"""Layer primitives: linear (dense or W8A8), norms, rotary positions,
activations, MLP, embeddings.

Parameters are plain dicts of tensors with the JAX package's keys
(``{"w"}`` / ``{"w_q", "w_scale", "smooth"[, "bias"]}``, ``{"w", "b"}``
norms, ``{"table"}`` embeddings), so the weight bridge maps them one to
one.  ``linear`` is the single entry point for every matmul: it runs the
Fused MP kernel (``ops.quant_matmul``) when the group is quantized, and
a dense product otherwise, feeding the SmoothQuant calibration recorder.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.tree import tree_map
from repro_torch.kernels import ops


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                dtype=torch.float32, device=None,
                bias: bool = False) -> Dict[str, torch.Tensor]:
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=device)
    p = {"w": w * (1.0 / d_in ** 0.5)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
           name: str = "") -> torch.Tensor:
    """x (..., K) -> (..., N), dense or W8A8 depending on the params."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if "w_q" in p:  # quantized serving path -> Fused MP kernel
        xs = x2.float() * (1.0 / p["smooth"])[None, :]
        x_q, x_scale = quant.quantize_act(xs)
        y = ops.quant_matmul(x_q, p["w_q"], x_scale, p["w_scale"],
                             p.get("bias"), out_dtype=x.dtype)
    else:
        quant.record_act_stats(name, x2)
        y = x2 @ p["w"].to(x.dtype)
        if "b" in p:
            y = y + p["b"].to(x.dtype)
    return y.reshape(*lead, y.shape[-1])


def norm_init(d: int, kind: str, *, dtype=torch.float32, device=None):
    p = {"w": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["w"].float() + p["b"].float()
    elif kind == "rmsnorm":
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["w"].float()
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_freqs(half: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The rotary frequencies ``theta ** (-i / half)``, float32 (half,).
    The exponent is rounded to float32 as the JAX package rounds it, the
    power is taken in float64 and rounded once: bit-identical to the
    reference's float32 ``pow`` on every table tried (``torch.pow`` in
    float32 differs from it in the last place on a few entries)."""
    e = (-torch.arange(0, half, dtype=torch.float32) / half).double()
    return (theta ** e).float().to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding of ``x`` (..., S, H, D) or (..., S, D) at
    ``positions`` (..., S): each half-pair ``(x1, x2)`` of the head
    dimensions turns by ``position * freq``, in float32, rounded to x's
    dtype.  The angles are bit-identical to the reference's; ``torch.cos``
    and ``torch.sin`` differ from XLA's by an ulp on a few percent of
    them, so the outputs agree within a few float32 ulps."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * rope_freqs(half, float(theta),
                                                    x.device)
    while ang.dim() < x.dim():  # broadcast over the heads
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` operation for operation, each
    rounded to x's dtype, with the constants rounded to it first as JAX
    does.  In bf16 (the calibration forward) this is bit-identical to the
    reference, where ``F.gelu`` rounds once and disagrees on many values;
    in float32 both differ from it by an ulp through tanh."""
    c, a = _gelu_consts(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


@functools.cache
def _gelu_consts(dtype: torch.dtype):
    """sqrt(2 / pi) and 0.044715 rounded to ``dtype``."""
    return tuple(float(torch.tensor(v, dtype=dtype))
                 for v in (0.7978845608028654, 0.044715))


#: the smallest normal float32 (and bf16) magnitude
_TINY = 2.0 ** -126


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormals flushed to a zero of their own sign, as XLA's CPU code
    flushes every float32 result."""
    return torch.where(t.abs() < _TINY, t * 0.0, t)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.jit(jax.nn.silu)`` as XLA compiles it, ``x * (1 / (exp(-x) +
    1))``, one fused loop in float32 whose every result is flushed to zero
    below 2^-126 and, for a bf16 ``x``, rounded to bf16 before the next
    operation.  In bf16 this is bit-identical to the reference on every
    finite input, subnormals included (``F.silu`` rounds once and
    disagrees on about one value in twenty).  In float32 ``torch.exp``
    and XLA's ``exp`` differ in the last place on a few percent of
    inputs, so the two agree only to a few ulps there (on 211,000 seeded
    samples on an x86 CPU, 3.45% differ, by at most 4 ulps)."""
    def step(t: torch.Tensor) -> torch.Tensor:
        return _ftz(t).to(x.dtype).float()

    xf = _ftz(x.float())
    e = step(torch.exp(step(-xf)))
    return step(xf * step(1.0 / step(e + 1.0))).to(x.dtype)


def activation_fn(name: str):
    return {
        "swiglu": silu,
        "geglu": gelu_tanh,
        "gelu_mlp": gelu_tanh,
        "relu2_mlp": lambda x: F.relu(x).square(),
    }[name]


def mlp_init(gen, d: int, d_ff: int, activation: str, *, dtype=torch.float32,
             device=None):
    p = {"up": linear_init(gen, d, d_ff, dtype=dtype, device=device),
         "down": linear_init(gen, d_ff, d, dtype=dtype, device=device)}
    if activation in ("swiglu", "geglu"):
        p["gate"] = linear_init(gen, d, d_ff, dtype=dtype, device=device)
    return p


def mlp(p, x: torch.Tensor, activation: str, name: str = ""):
    """Gated (swiglu/geglu) or plain 2-layer MLP."""
    act = activation_fn(activation)
    h = linear(p["up"], x, name + ".up")
    if activation in ("swiglu", "geglu"):
        h = act(linear(p["gate"], x, name + ".gate")) * h
    else:
        h = act(h)
    return linear(p["down"], h, name + ".down")


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32, device=None):
    t = torch.randn((vocab, d), generator=gen, dtype=dtype, device=device)
    return {"table": t * 0.02}


def embed(p, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits via the tied embedding transpose."""
    return x @ p["table"].to(x.dtype).T


def to_device(tree, device: Optional[torch.device]):
    """Move every tensor of a params, cache or train-state tree."""
    return tree_map(lambda t: t.to(device), tree)
