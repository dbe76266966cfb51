"""A whole model call's least time, for ``step_mfu``: a decoder stack of
global-attention layers with a W8A8 dense MLP or a float MoE FFN, served
with float32 activations on bf16 pages (the configurations' ``serving``).

Per call the operations of every part are summed per precision and the
bytes of every part are summed; the bound is the larger of the two
times (``harness.peaks.bound_s``).  The parts: each W8A8 linear
(``mp_matmul``), the attention (``paged_mha_decode`` for a decode step,
``paged_verify`` for a prefill chunk), the MoE FFN (``moe_ffn``), the
head (a W8A8 linear, or the tied embedding's float32 product), and the
embedding rows gathered.  Norms, residuals and other elementwise
operations move a few activation rows and are left out."""
from pathlib import Path

from harness import peaks
from harness.spec import load_module

_HERE = Path(__file__).resolve().parent


def _mod(name):
    return load_module(_HERE / f"{name}.py")


def _add(acc, part):
    for p, n in part["ops"].items():
        acc["ops"][p] = acc["ops"].get(p, 0.0) + n
    acc["bytes"] += part["bytes"]


def cost(model: dict, call: dict, *, max_seq: int, page_size: int) -> dict:
    """Operations per precision and bytes of one recorded model call
    (``harness.probes``: a decode step over ``lengths``, or a prefill
    chunk at ``start``)."""
    mp, moe_ffn = _mod("mp_matmul"), _mod("moe_ffn")
    d, L, V = model["d_model"], model["n_layers"], model["vocab_size"]
    H, Hkv, D = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    f, E = model["d_ff"], model.get("n_experts", 0)
    gated = model["activation"] in ("swiglu", "geglu")
    n_pg = max_seq // page_size
    if call["kind"] == "decode":
        M, M_head = call["rows"], call["rows"]
        attn = _mod("paged_mha_decode").cost(
            [int(x) + 1 for x in call["lengths"]], H, Hkv, D, n_pg)
    else:
        M, M_head = call["C"], 1
        attn = _mod("paged_verify").cost(call["start"], call["C"], H, Hkv,
                                         D, n_pg)
    acc = {"ops": {}, "bytes": 0.0}
    layer = {"ops": {}, "bytes": 0.0}
    for K, N in ((d, H * D), (d, Hkv * D), (d, Hkv * D), (H * D, d)):
        _add(layer, mp.cost(M, K, N))
    _add(layer, attn)
    if E:
        _add(layer, moe_ffn.cost(M, d, f, E, model["experts_per_token"],
                                 gated=gated))
    else:
        for K, N in ((d, f), (f, d)) + (((d, f),) if gated else ()):
            _add(layer, mp.cost(M, K, N))
    for _ in range(L):
        _add(acc, layer)
    if model.get("tie_embeddings", False):
        _add(acc, {"ops": {"fp32": 2.0 * M_head * d * V},
                   "bytes": 4.0 * (V * d + M_head * d + M_head * V)})
    else:
        _add(acc, mp.cost(M_head, d, V))
    rows = M * (2 if model["pos"] == "learned" else 1)
    _add(acc, {"ops": {}, "bytes": 4.0 * rows * d})
    return acc


def bound_s(model: dict, call: dict, *, max_seq: int,
            page_size: int) -> float:
    c = cost(model, call, max_seq=max_seq, page_size=page_size)
    return peaks.bound_s(c["ops"], c["bytes"])
