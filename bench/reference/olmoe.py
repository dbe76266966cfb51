"""Plain reference of OLMoE as the configuration runs it (pre-RMSNorm
blocks, rotary positions, multi-head attention with W8A8 projections, a
top-k MoE FFN of SwiGLU experts in float32, an untied W8A8 head).

Departures from the published model, kept because the port serves this
form (named in the configuration's file): no QK-norm, the top-k gates
renormalised to sum to one, router and experts in float32.  The experts
here compute the routed tokens only, one expert at a time: the same sum
as the port's padded batched products, with no capacity."""
from __future__ import annotations

from typing import Dict, List

import torch

from reference_common import causal_attention, rmsnorm, rope, silu, split


def linears(model: Dict):
    out = []
    for i in range(model["n_layers"]):
        for n in ("q", "k", "v", "out"):
            out.append((f"layers/{i}/attn/{n}", f"attn.{n}"))
    out.append(("lm_head", "lm_head"))
    return out


def moe(p: Dict, h: torch.Tensor, model: Dict, dtype, expert_dtype,
        router_dtype=torch.float32):
    """(T, d) -> (T, d): the router's product in ``router_dtype`` (softmax
    as exp of the shifted float32 logits over their sum), top-k gates
    renormalised, each routed token through its experts in
    ``expert_dtype``, weighed by its gates in ``dtype`` (the
    activations')."""
    k = model["experts_per_token"]
    logits = (h.to(router_dtype) @ p["router"]["w"].to(router_dtype)
              ).float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    ed = expert_dtype
    for e in torch.unique(experts).tolist():
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        xe = h[tok].to(ed)
        g = silu((xe @ p["w_gate"][e].to(ed)))
        u = xe @ p["w_up"][e].to(ed)
        y = (g * u) @ p["w_down"][e].to(ed)
        # weighed in the activations' type, summed over the k in float32
        y = (y.to(dtype) * gates[tok, slot][:, None].to(dtype)).float()
        out.index_add_(0, tok, y)
    return out.to(dtype)


def hidden(P: Dict, model: Dict, seqs: List[torch.Tensor], lin, dtype,
           expert_dtype=torch.float32, router_dtype=torch.float32
           ) -> torch.Tensor:
    H, D = model["n_heads"], model["head_dim"]
    Hkv = model["n_kv_heads"]
    theta = float(model.get("rope_theta", 10000.0))
    calib = dtype != torch.float32
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
        x = x + moe(lp["moe"], h, model, dtype,
                    dtype if calib else expert_dtype, router_dtype)
    return x


def head(P: Dict, model: Dict, x: torch.Tensor, lin) -> torch.Tensor:
    """Float32 logits of rows of ``hidden``: the W8A8 head on the final
    norm's output in the stream's type."""
    h = rmsnorm(x, P["final_ln"]).float()
    return lin("lm_head", "lm_head", h).float()
