"""A whole model call's least time, for ``step_mfu.moe``: the stacks of
``decoder_step.py`` (W8A8 linears, paged attention, float32 activations
on bf16 pages) with the MoE FFN's experts in bf16 (``moe_ffn_bf16.py``),
as a configuration whose ``expert_dtype`` is ``bfloat16`` serves them.

``parts`` gives each part's operations per precision and bytes, for every
layer together: the attention's linears (``mp_matmul``), the attention
(``paged_mha_decode`` for a decode step, ``paged_verify`` for a prefill
chunk), the FFN (``moe_ffn_bf16``, or a dense MLP's W8A8 linears), the
head (a W8A8 linear, or the tied embedding's float32 product) and the
embedding rows gathered; ``cost`` is their sum and the bound the larger
of its two times (``harness.peaks.bound_s``).  Norms, residuals and other
elementwise operations move a few activation rows and are left out, as
in ``decoder_step.py``."""
from pathlib import Path

from harness import peaks
from harness.spec import load_module

_HERE = Path(__file__).resolve().parent


def _mod(name):
    return load_module(_HERE / f"{name}.py")


def _sum(parts) -> dict:
    acc = {"ops": {}, "bytes": 0.0}
    for part in parts:
        for p, n in part["ops"].items():
            acc["ops"][p] = acc["ops"].get(p, 0.0) + n
        acc["bytes"] += part["bytes"]
    return acc


def _times(part: dict, n: int) -> dict:
    return {"ops": {p: n * v for p, v in part["ops"].items()},
            "bytes": n * part["bytes"]}


def parts(model: dict, call: dict, *, max_seq: int, page_size: int) -> dict:
    """{part: {"ops", "bytes"}} of one recorded model call
    (``harness.probes``: a decode step over ``lengths``, or a prefill
    chunk at ``start``)."""
    mp = _mod("mp_matmul")
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
    linears = _sum(mp.cost(M, K, N) for K, N in (
        (d, H * D), (d, Hkv * D), (d, Hkv * D), (H * D, d)))
    if E:
        ffn = _mod("moe_ffn_bf16").cost(M, d, f, E,
                                        model["experts_per_token"],
                                        gated=gated)
    else:
        ffn = _sum(mp.cost(M, K, N) for K, N in ((d, f), (f, d))
                   + (((d, f),) if gated else ()))
    if model.get("tie_embeddings", False):
        head = {"ops": {"fp32": 2.0 * M_head * d * V},
                "bytes": 4.0 * (V * d + M_head * d + M_head * V)}
    else:
        head = mp.cost(M_head, d, V)
    rows = M * (2 if model["pos"] == "learned" else 1)
    return {"linears": _times(linears, L), "attention": _times(attn, L),
            "ffn": _times(ffn, L), "head": head,
            "embed": {"ops": {}, "bytes": 4.0 * rows * d}}


def cost(model: dict, call: dict, *, max_seq: int, page_size: int) -> dict:
    """Operations per precision and bytes of one recorded model call."""
    return _sum(parts(model, call, max_seq=max_seq,
                      page_size=page_size).values())


def bound_s(model: dict, call: dict, *, max_seq: int,
            page_size: int) -> float:
    c = cost(model, call, max_seq=max_seq, page_size=page_size)
    return peaks.bound_s(c["ops"], c["bytes"])
