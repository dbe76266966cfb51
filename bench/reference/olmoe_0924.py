"""Plain reference of OLMoE-1B-7B-0924 in its published routing and
expert precision (pre-RMSNorm blocks, rotary positions, multi-head
attention with W8A8 projections, a top-k MoE FFN of SwiGLU experts, an
untied W8A8 head).

The router's top-k softmax probabilities weigh the experts as they are
(``norm_topk_prob`` false).  The experts compute the routed tokens only,
one expert at a time, in the configuration's ``expert_dtype``, at the
rounding points the port states (``models/moe.py``): each routed row
rounded to that dtype, each bank product accumulated in float32 and
rounded to it, SiLU rounded after each of its operations, its product
with the up projection rounded once; the output cast to the stream's
type and weighed by its gate there, the k choices summed in their order.

``Reference`` passes ``expert_dtype=torch.float32`` when no control is
asked: the configuration's stated dtype is taken then.  Two controls lie
below it, each with per-output-channel banks, per-row inputs, an exact
product scaled to float32, and float32 between the products:
``torch.float8_e4m3fn``, the 8-bit float below bfloat16 (each row and
channel scaled to the format's largest value, 448, then rounded to
nearest even), and ``torch.int8`` (symmetric levels, round half to
even).

Departures from the published model, as the port serves it (named in
the configuration's file): no QK-norm, the router in float32.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from olmoe import head, linears  # noqa: F401  (the family's interface)
from reference_common import (causal_attention, quantize_rows, rmsnorm,
                              rope, silu, split)


def experts_dtype(model: Dict, asked, dtype):
    """The dtype the experts run in: the stated one where ``Reference``
    asks for float32 (no control), else what it asks for."""
    if asked == torch.float32:
        stated = model.get("expert_dtype")
        return getattr(torch, stated) if stated else dtype
    return asked


#: float8_e4m3fn's largest finite value
FP8_MAX = 448.0


def _int8_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-row int8 ``x`` times per-output-channel int8 ``w``, exactly,
    scaled to float32."""
    xl, xs = quantize_rows(x.float(), 8, -1, 1e-6)
    wl, ws = quantize_rows(w.float(), 8, 0, 1e-8)
    return (xl.double() @ wl.double()).float() * xs * ws


def _fp8(x: torch.Tensor, dim: int, floor: float):
    """``x`` scaled along ``dim`` to float8_e4m3fn's range and rounded
    to it: ``(values as float, scale)``."""
    scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True),
                        min=floor) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float(), scale


def _fp8_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-row float8 ``x`` times per-output-channel float8 ``w``,
    exactly, scaled to float32."""
    xq, xs = _fp8(x.float(), -1, 1e-6)
    wq, ws = _fp8(w.float(), 0, 1e-8)
    return (xq.double() @ wq.double()).float() * xs * ws


#: the controls' products, by the ``expert_dtype`` that asks for them
LOW = {torch.int8: _int8_product, torch.float8_e4m3fn: _fp8_product}


def expert(p: Dict, e: int, xe: torch.Tensor, ed) -> torch.Tensor:
    """Expert ``e``'s SwiGLU on its routed rows ``xe``, in ``ed``."""
    if ed in LOW:
        prod = LOW[ed]
        g = silu(prod(xe, p["w_gate"][e]))
        u = prod(xe, p["w_up"][e])
        return prod(g * u, p["w_down"][e])
    xe = xe.to(ed)
    h = silu(xe @ p["w_gate"][e].to(ed)) * (xe @ p["w_up"][e].to(ed))
    return h @ p["w_down"][e].to(ed)


def moe(p: Dict, h: torch.Tensor, model: Dict, dtype, ed,
        router_dtype=torch.float32) -> torch.Tensor:
    """(T, d) -> (T, d) in ``dtype``: the router's product in
    ``router_dtype`` (softmax as exp of the shifted float32 logits over
    their sum), the top-k probabilities as gates (renormalised only where
    the configuration's ``norm_topk_prob`` says so), each routed token
    through its experts in ``ed``."""
    k = model["experts_per_token"]
    logits = (h.to(router_dtype) @ p["router"]["w"].to(router_dtype)
              ).float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    gates, experts = torch.topk(probs, k, dim=-1)
    if model.get("norm_topk_prob", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    ys = torch.zeros((h.shape[0], k, h.shape[1]), dtype=dtype,
                     device=h.device)
    for e in torch.unique(experts).tolist():
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        y = expert(p, e, h[tok], ed)
        ys[tok, slot] = y.to(dtype) * gates[tok, slot][:, None].to(dtype)
    return ys.sum(dim=1)


def hidden(P: Dict, model: Dict, seqs: List[torch.Tensor], lin, dtype,
           expert_dtype=torch.float32, router_dtype=torch.float32
           ) -> torch.Tensor:
    H, D = model["n_heads"], model["head_dim"]
    Hkv = model["n_kv_heads"]
    theta = float(model.get("rope_theta", 10000.0))
    calib = dtype != torch.float32
    ed = experts_dtype(model, expert_dtype, dtype)
    toks = torch.cat(seqs)
    parts = split(seqs)
    pos = torch.cat([torch.arange(s.numel(), device=toks.device)
                     for s in seqs])
    x = P["embed"]["table"].to(dtype)[toks]
    for i, lp in enumerate(P["layers"]):
        h = rmsnorm(x, lp["ln1"])
        q = lin(f"layers/{i}/attn/q", "attn.q", h).to(dtype)
        k = lin(f"layers/{i}/attn/k", "attn.k", h).to(dtype)
        v = lin(f"layers/{i}/attn/v", "attn.v", h).to(dtype)
        q = rope(q.reshape(-1, H, D), pos, theta)
        k = rope(k.reshape(-1, Hkv, D), pos, theta)
        v = v.reshape(-1, Hkv, D)
        if not calib:
            k = k.to(torch.bfloat16)
            v = v.to(torch.bfloat16)
        att = torch.cat([causal_attention(q[s], k[s], v[s], calib=calib)
                         for s in parts])
        x = x + lin(f"layers/{i}/attn/out", "attn.out", att.to(dtype)
                    ).to(dtype)
        h = rmsnorm(x, lp["ln2"])
        x = x + moe(lp["moe"], h, model, dtype, ed, router_dtype)
    return x
