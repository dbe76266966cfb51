"""Random weights made on the device from the run's seed.

A frozen copy of the port's init for the stacks the benchmark serves
(decoders of global-attention layers with a dense MLP or a top-k MoE
FFN): the parameter tree's keys and shapes, and its scales (a linear or
expert bank ``N(0, 1) / sqrt(d_in)``, the embedding ``0.02``, learned
positions ``0.01``, norms one and zero).  Leaves of one scale are drawn
together, by one ``randn`` call per piece of at most 2**30 elements from
a ``torch.Generator`` on the device, and scaled in place, so a set-up
makes gigabytes in a few calls.  The same seed gives the same tensors on
the same device: that is how the reference gets them again once the
program's state is freed.

Linears and the float leaves the program keeps (embedding, positions,
norms, router, expert banks) are drawn into separate buffers, so that
the float masters of the quantized linears are freed with the tree that
holds them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_PIECE = 1 << 30


def _leaves(m: Dict, max_seq: int) -> List[Tuple[str, tuple, float, str]]:
    """(path, shape, scale, group) of every random leaf, in draw order."""
    d, V, L = m["d_model"], m["vocab_size"], m["n_layers"]
    q_dim = m["n_heads"] * m["head_dim"]
    kv_dim = m["n_kv_heads"] * m["head_dim"]
    f, E = m["d_ff"], m.get("n_experts", 0)
    gated = m["activation"] in ("swiglu", "geglu")
    out = [("embed/table", (V, d), 0.02, "keep")]
    if m["pos"] == "learned":
        out.append(("pos_embed", (max_seq, d), 0.01, "keep"))
    for i in range(L):
        p = f"layers/{i}"
        for name, shape in (("q", (d, q_dim)), ("k", (d, kv_dim)),
                            ("v", (d, kv_dim)), ("out", (q_dim, d))):
            out.append((f"{p}/attn/{name}/w", shape, shape[0] ** -0.5,
                        "linear"))
        if E:
            out.append((f"{p}/moe/router/w", (d, E), d ** -0.5, "keep"))
            out.append((f"{p}/moe/w_up", (E, d, f), d ** -0.5, "keep"))
            out.append((f"{p}/moe/w_down", (E, f, d), f ** -0.5, "keep"))
            if gated:
                out.append((f"{p}/moe/w_gate", (E, d, f), d ** -0.5, "keep"))
        else:
            out.append((f"{p}/mlp/up/w", (d, f), d ** -0.5, "linear"))
            out.append((f"{p}/mlp/down/w", (f, d), f ** -0.5, "linear"))
            if gated:
                out.append((f"{p}/mlp/gate/w", (d, f), d ** -0.5, "linear"))
    if not m.get("tie_embeddings", False):
        out.append(("lm_head/w", (d, V), d ** -0.5, "linear"))
    return out


def _set(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        if k.isdigit():
            node = node[int(k)]
        else:
            node = node.setdefault(k, {})
    node[keys[-1]] = value


def _norm(d: int, kind: str, device) -> Dict:
    p = {"w": torch.ones(d, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


@torch.no_grad()
def make(model: Dict, max_seq: int, seed: int, device) -> Dict:
    """The float32 parameter tree of ``model`` (a configuration's
    ``model`` fields) on ``device``, drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    d, kind = model["d_model"], model["norm"]
    tree: Dict = {"layers": [{} for _ in range(model["n_layers"])]}
    # pieces: leaves of one (group, scale), cut at _PIECE elements
    pieces: Dict[tuple, List[List]] = {}
    for path, shape, scale, group in _leaves(model, max_seq):
        runs = pieces.setdefault((group, scale), [[]])
        n = math.prod(shape)
        if runs[-1] and sum(math.prod(s) for _, s in runs[-1]) + n > _PIECE:
            runs.append([])
        runs[-1].append((path, shape))
    for (group, scale), runs in pieces.items():
        for run in runs:
            total = sum(math.prod(s) for _, s in run)
            flat = torch.randn(total, generator=gen, dtype=torch.float32,
                               device=device)
            flat.mul_(scale)
            off = 0
            for path, shape in run:
                n = math.prod(shape)
                _set(tree, path, flat[off:off + n].view(shape))
                off += n
    for layer in tree["layers"]:
        layer["ln1"] = _norm(d, kind, device)
        if model["d_ff"] > 0:
            layer["ln2"] = _norm(d, kind, device)
    tree["final_ln"] = _norm(d, kind, device)
    return tree
