"""Plain PyTorch reference of the served decoder stacks: what the family
files (``gpt2.py``, ``olmoe.py``) share.

It imports nothing of the program and takes nothing the program made: it
gets the float weights from the seed again (``harness.weights``) and the
calibration tokens the benchmark drew, and works out SmoothQuant's
factors, the int8 weights and their scales itself, as the configuration
states them:

  * calibration: a forward of the float model with bfloat16 activations,
    recording each linear's per-channel input absmax, taken over every
    token and over the layers (one set of factors per linear type);
  * smoothing ``s = amax(x)^a / amax(w)^(1-a)`` (a = 0.5) over its median
    (the mean of the two middle values), clamped to ``[1e-3, 1e3]``;
    weight rows multiplied by ``s``, activations by ``1 / s``;
  * per-output-channel symmetric int8 weights, per-token symmetric int8
    activations (round half to even), an exact integer product (float64
    holds every partial sum), then ``acc * x_scale * w_scale``;
  * the stream between linears in float32, keys and values rounded to
    bfloat16 (the page pool's type), attention in float32.

Everything else runs in float32 with TF32 off.  The controls are the
same model a precision lower: ``bits=4``, 4-bit weights and activations
(levels ``-7 .. 7``); ``float_dtype=torch.bfloat16``, every float32
part (the stream, norms, attention, router, experts, a tied head) in
bfloat16 around the int8 linears; ``expert_dtype=torch.bfloat16``, a
MoE stack's expert products alone in bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

NEG_INF = -1e30


def exact_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# quantization


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quantize_rows(x: torch.Tensor, bits: int, dim: int, floor: float):
    """Symmetric quantization along ``dim``: ``(levels, scale)``, levels
    as float integers in ``[-q, q]``."""
    q = qmax(bits)
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=floor) / q
    return torch.clamp(torch.round(x / scale), -q, q), scale


def median_mid(s: torch.Tensor) -> torch.Tensor:
    srt = torch.sort(s).values
    n = srt.numel()
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def smooth_factors(act_amax: torch.Tensor, w: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """Per input channel; the powers are taken in float64 and rounded once
    to float32."""
    a = torch.clamp(act_amax.float(), min=1e-5).double()
    wm = torch.clamp(w.abs().amax(dim=1).float(), min=1e-5).double()
    s = (a ** alpha).float() / (wm ** (1.0 - alpha)).float()
    s = s / median_mid(s)
    return torch.clamp(s, 1e-3, 1e3)


class QLinear:
    """One W``bits``A``bits`` linear from its float weight (K, N)."""

    def __init__(self, w: torch.Tensor, amax: Optional[torch.Tensor],
                 bits: int, bias: Optional[torch.Tensor] = None):
        self.bits = bits
        if amax is None:
            smooth = torch.ones(w.shape[0], dtype=torch.float32,
                                device=w.device)
        else:
            smooth = smooth_factors(amax.to(w.device), w)
        self.inv_smooth = 1.0 / smooth
        levels, self.w_scale = quantize_rows(w.float() * smooth[:, None],
                                             bits, 0, 1e-8)
        self.w_levels = levels.double()
        self.bias = None if bias is None else bias.float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.float() * self.inv_smooth[None, :]
        x_levels, x_scale = quantize_rows(xs, self.bits, -1, 1e-6)
        acc = (x_levels.double() @ self.w_levels).float()
        y = acc * x_scale * self.w_scale
        return y if self.bias is None else y + self.bias


# ---------------------------------------------------------------------------
# layers


def layernorm(x, p, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["w"].float() + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(x, p, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["w"].float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh GELU, each operation in x's type, its constants
    rounded to that type first."""
    c = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype))
    a = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x / (1 + exp(-x))``, each operation rounded to x's type."""
    return x * (1.0 / (torch.exp(-x) + 1.0))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary positions on (S, H, D): each half pair turns by
    ``position * theta ** (-i / half)`` (exponent in float32, power in
    float64 rounded once), in float32, rounded to x's type."""
    half = x.shape[-1] // 2
    e = (-torch.arange(half, dtype=torch.float32, device=x.device)
         / half).double()
    freqs = (theta ** e).float()
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def causal_attention(q, k, v, *, calib: bool):
    """One sequence: q (S, H, D), k and v (S, Hkv, D) -> (S, H * D).
    Serving: float32 softmax and products (k and v already rounded to the
    cache's bfloat16).  Calibration: the probabilities rounded to v's
    type, the output to q's."""
    S, H, D = q.shape
    group = H // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q.float(), kf) / math.sqrt(D)
    ar = torch.arange(S, device=q.device)
    scores = torch.where(ar[None, :] <= ar[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if calib:
        probs = probs.to(v.dtype).float()
    out = torch.einsum("hqk,khd->qhd", probs, vf)
    return out.to(q.dtype).reshape(S, H * D)


# ---------------------------------------------------------------------------
# the model


class Linears:
    """The linear map of a forward: float products in ``dtype`` recording
    input absmax (calibration), or the quantized linears."""

    def __init__(self, weights: Dict, dtype, quant: Optional[Dict] = None):
        self.weights = weights
        self.dtype = dtype
        self.quant = quant
        self.amax: Dict[str, torch.Tensor] = {}

    def __call__(self, path: str, kind: str, x: torch.Tensor):
        if self.quant is not None:
            return self.quant[path](x)
        a = x.float().abs().amax(dim=0)
        prev = self.amax.get(kind)
        self.amax[kind] = a if prev is None else torch.maximum(prev, a)
        node = self.weights
        for k in path.split("/"):
            node = node[int(k)] if k.isdigit() else node[k]
        y = x @ node["w"].to(x.dtype)
        return y + node["b"].to(x.dtype) if "b" in node else y


def walk(weights: Dict, path: str):
    node = weights
    for k in path.split("/"):
        node = node[int(k)] if k.isdigit() else node[k]
    return node


class Reference:
    """The reference of one family (``family``: a module with
    ``linears(model)``, ``hidden(...)`` and ``head(...)``) on the seed's
    float weights, calibrated on ``calib`` (token arrays (rows, S))."""

    def __init__(self, family, weights: Dict, model: Dict, calib,
                 *, bits: int = 8, expert_dtype=torch.float32,
                 float_dtype=torch.float32, smooth_head: bool = False):
        self.family, self.weights, self.model = family, weights, model
        self.expert_dtype, self.float_dtype = expert_dtype, float_dtype
        dev = weights["final_ln"]["w"].device
        rec = Linears(weights, torch.bfloat16)
        with torch.no_grad():
            for batch in calib:
                for row in batch:
                    toks = torch.as_tensor(row, device=dev).long()
                    family.hidden(weights, model, [toks], rec,
                                  torch.bfloat16, torch.bfloat16)
        quant = {}
        for path, kind in family.linears(model):
            amax = rec.amax.get(kind)
            if kind == "lm_head" and not smooth_head:
                amax = None
            quant[path] = QLinear(walk(weights, path)["w"], amax, bits,
                                  walk(weights, path).get("b"))
        self.lin = Linears(weights, torch.float32, quant)

    @torch.no_grad()
    def final_hidden(self, seqs: List[torch.Tensor]) -> torch.Tensor:
        """(sum of lengths, d): each sequence from position 0."""
        fd = self.float_dtype
        if fd == torch.float32:
            return self.family.hidden(self.weights, self.model, seqs,
                                      self.lin, fd, self.expert_dtype)
        return self.family.hidden(self.weights, self.model, seqs, self.lin,
                                  fd, fd, router_dtype=fd)

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.family.head(self.weights, self.model, h, self.lin)


def split(seqs: List[torch.Tensor]) -> List[slice]:
    out, at = [], 0
    for s in seqs:
        out.append(slice(at, at + s.numel()))
        at += s.numel()
    return out

