"""Plain reference of GPT-2 as the configuration runs it (pre-LayerNorm
blocks, learned positions, multi-head attention, a tanh-GELU MLP, the
head tied to the embedding; no linear biases, as the port's init has
none).  Shared pieces are in
``reference_common.py``."""
from __future__ import annotations

from typing import Dict, List

import torch

from reference_common import causal_attention, gelu_tanh, layernorm, split


def linears(model: Dict):
    """(path, kind) of every quantized linear; kind names its smoothing
    group."""
    out = []
    for i in range(model["n_layers"]):
        for n in ("q", "k", "v", "out"):
            out.append((f"layers/{i}/attn/{n}", f"attn.{n}"))
        for n in ("up", "down"):
            out.append((f"layers/{i}/mlp/{n}", f"mlp.{n}"))
    return out


def hidden(P: Dict, model: Dict, seqs: List[torch.Tensor], lin, dtype,
           expert_dtype=None, router_dtype=None) -> torch.Tensor:
    """The final norm's input for every position of every sequence,
    concatenated: (sum of lengths, d) in ``dtype`` (a dense stack: the
    experts' and the router's types do not apply)."""
    H, D = model["n_heads"], model["head_dim"]
    Hkv = model["n_kv_heads"]
    calib = dtype != torch.float32
    toks = torch.cat(seqs)
    pos = torch.cat([torch.arange(s.numel(), device=toks.device)
                     for s in seqs])
    x = P["embed"]["table"].to(dtype)[toks] + P["pos_embed"].to(dtype)[pos]
    parts = split(seqs)
    for i, lp in enumerate(P["layers"]):
        h = layernorm(x, lp["ln1"])
        q = lin(f"layers/{i}/attn/q", "attn.q", h).to(dtype)
        k = lin(f"layers/{i}/attn/k", "attn.k", h).to(dtype)
        v = lin(f"layers/{i}/attn/v", "attn.v", h).to(dtype)
        if not calib:  # the page pool holds K and V in bfloat16
            k = k.to(torch.bfloat16)
            v = v.to(torch.bfloat16)
        att = torch.cat([causal_attention(
            q[s].reshape(-1, H, D), k[s].reshape(-1, Hkv, D),
            v[s].reshape(-1, Hkv, D), calib=calib) for s in parts])
        x = x + lin(f"layers/{i}/attn/out", "attn.out", att.to(dtype)
                    ).to(dtype)
        h = layernorm(x, lp["ln2"])
        u = gelu_tanh(lin(f"layers/{i}/mlp/up", "mlp.up", h).to(dtype))
        x = x + lin(f"layers/{i}/mlp/down", "mlp.down", u).to(dtype)
    return x


def head(P: Dict, model: Dict, x: torch.Tensor, lin) -> torch.Tensor:
    """Float32 logits of rows of ``hidden``: the tied embedding's product
    in the stream's type."""
    h = layernorm(x, P["final_ln"])
    return (h @ P["embed"]["table"].to(h.dtype).T).float()
