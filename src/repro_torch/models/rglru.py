"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(x_t W_r + b_r)           (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)           (input gate)
    a_t = exp(c * r_t * log(a))     with a = sigmoid(Lambda), c = -8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A width-4 causal conv precedes the gating, with its 3-sample tail kept in
the decode state.  The full-sequence path (the calibration forward) runs
the linear recurrence as the reference's ``jax.lax.associative_scan``,
combining the same pairs in the same order (:func:`associative_scan`), so
its float32 sums round as the reference's do; the chunked path (prefill
and verify) and the decode step thread the state one token at a time,
as the reference's ``lax.scan`` does.  Those two run compiled in the
reference (its engine's steps, and every ``lax.scan`` body), where XLA
contracts ``a * b + c`` into one fused multiply-add: they round the same
way here (:func:`fma`), while the full-sequence path, which the
reference's calibration runs op by op, rounds each product and sum.
The gates and the recurrence are plain PyTorch, as they are plain
``jnp`` in the reference; ``in_proj`` and ``out_proj`` go through
``linear`` (the MP kernel under W8A8), while ``w_r``/``w_i`` stay
floating point.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gelu_tanh, linear, linear_init

_C = 8.0
_CONV_W = 4


def rglru_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device=None):
    d = cfg.d_model
    w = cfg.lru_width or d
    kw = {"dtype": dtype, "device": device}
    return {
        "in_proj": linear_init(gen, d, 2 * w, **kw),  # [x | gate] branch
        "conv": torch.randn((_CONV_W, w), generator=gen, **kw) * 0.3,
        "w_r": linear_init(gen, w, w, bias=True, **kw),
        "w_i": linear_init(gen, w, w, bias=True, **kw),
        # a = sigmoid(Lambda) in (0.9, 0.999), as the reference draws it
        "lam": 2.2 + 4.7 * torch.rand((w,), generator=gen,
                                      dtype=torch.float32, device=device),
        "out_proj": linear_init(gen, w, d, **kw),
    }


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    float64 product of two float32 values is exact, and the sum rounds to
    float32 as the fused operation does (bar a double rounding, which no
    seeded test has met)."""
    return (a.double() * b.double() + c).float()


def _gates(p, xw: torch.Tensor, fused: bool):
    xf = xw.float()
    r = torch.sigmoid(linear(p["w_r"], xf))
    i = torch.sigmoid(linear(p["w_i"], xf))
    log_a = _C * r * F.logsigmoid(p["lam"].float())
    a = torch.exp(log_a)
    one_m = fma(-a, a, 1.0) if fused else 1.0 - a.square()
    b = torch.sqrt(torch.clamp_min(one_m, 1e-9)) * (i * xf)
    return a, b


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Along dim 1: a[0], b[0], a[1], b[1], ... (len(a) - len(b) is 0 or
    1)."""
    n = a.shape[1] + b.shape[1]
    out = a.new_empty((a.shape[0], n) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along dim 1, as
    ``jax.lax.associative_scan`` computes it: combine adjacent pairs,
    scan the pairs recursively, then combine the odd prefixes with the
    even elements, so every product and sum is the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _conv(xp: torch.Tensor, conv: torch.Tensor, n: int,
          order: str = "sum") -> torch.Tensor:
    """The width-4 causal conv over ``xp`` (B, 3 + n, w) float32 in the
    reference's rounding: ``"sum"`` adds the four products in tap order
    (its sequence path, op by op); ``"chunk"`` is that sum compiled, tap
    0 fused onto tap 1's product and taps 2 and 3 fused on in turn;
    ``"dot"`` is the decode step's ``einsum``, a fused chain from tap 0."""
    cw = conv.float()

    def tap(i):
        return xp[:, i:i + n], cw[i][None, None]

    if order == "sum":
        out = tap(0)[0] * tap(0)[1]
        for i in range(1, _CONV_W):
            out = out + tap(i)[0] * tap(i)[1]
        return out
    if order == "chunk":
        out = fma(*tap(0), tap(1)[0].double() * tap(1)[1])
        start = 2
    else:
        out = tap(0)[0] * tap(0)[1]
        start = 1
    for i in range(start, _CONV_W):
        out = fma(*tap(i), out)
    return out


def _gated_out(p, hseq: torch.Tensor, gate: torch.Tensor, dtype, name):
    y = hseq.to(dtype) * gelu_tanh(gate.float()).to(dtype)
    return linear(p["out_proj"], y, name + ".out")


def rglru_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str = ""):
    """Full-sequence path. x (B, S, d) -> (out (B, S, d), final state)."""
    B, S, _ = x.shape
    h = linear(p["in_proj"], x, name + ".in")  # (B, S, 2w)
    xw, gate = h.chunk(2, dim=-1)
    xp = F.pad(xw.float(), (0, 0, _CONV_W - 1, 0))
    a, b = _gates(p, _conv(xp, p["conv"], S), fused=False)
    _, hseq = associative_scan(a, b)
    tail = F.pad(
        xw, (0, 0, max(0, _CONV_W - 1 - S), 0))[:, -(_CONV_W - 1):]
    state = {"h": hseq[:, -1], "conv_tail": tail}
    return _gated_out(p, hseq, gate, x.dtype, name), state


def rglru_chunk(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                name: str = "") -> Tuple[torch.Tensor, Dict]:
    """C tokens (B, C, d) against a carried state: the projections and
    gates batched over the chunk, the recurrence a token at a time from
    ``state``.  Returns ``(out (B, C, d), traj)``, ``traj[:, t]`` being
    the state after chunk tokens ``0..t``.  The intra-chunk conv taps
    round through the tail's storage dtype first, as the decode step
    reads every tap back from the cached tail (a float32 stream over a
    bf16 cache)."""
    B, C, _ = x.shape
    h = linear(p["in_proj"], x, name + ".in")
    xw, gate = h.chunk(2, dim=-1)
    tail = state["conv_tail"]  # (B, 3, w)
    hist = torch.cat([tail, xw.to(tail.dtype)], dim=1)  # (B, 3 + C, w)
    a, b = _gates(p, _conv(hist.float(), p["conv"], C, "chunk"), fused=True)
    # the fused a_t * h + b_t of each token, in float64 (exact product,
    # one rounding to float32 per token)
    a64, b64 = a.double(), b.double()
    hseq = torch.empty_like(a)  # (B, C, w)
    hprev = state["h"].float()
    for t in range(C):
        hprev = torch.addcmul(b64[:, t], a64[:, t], hprev.double()).float()
        hseq[:, t] = hprev
    out = _gated_out(p, hseq, gate, x.dtype, name)
    tails = torch.stack([hist[:, t + 1:t + _CONV_W] for t in range(C)],
                        dim=1)  # (B, C, 3, w)
    return out, {"h": hseq, "conv_tail": tails}


def rglru_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                                 device=device),
    }


def rglru_step(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
               name: str = "") -> Tuple[torch.Tensor, Dict]:
    """One decode token. x (B, 1, d) -> (out (B, 1, d), new state)."""
    h = linear(p["in_proj"], x[:, 0], name + ".in")  # (B, 2w)
    xw, gate = h.chunk(2, dim=-1)
    tail = state["conv_tail"]
    hist = torch.cat([tail, xw[:, None].to(tail.dtype)], dim=1)  # (B, 4, w)
    a, b = _gates(p, _conv(hist.float(), p["conv"], 1, "dot")[:, 0],
                  fused=True)
    h_new = fma(a, state["h"], b)
    out = _gated_out(p, h_new, gate, x.dtype, name)[:, None]
    return out, {"h": h_new, "conv_tail": hist[:, 1:]}
