"""The paged verify kernel, causal body (``ops.paged_verify`` ->
``csrc/paged_verify.cu`` on ``verify_attn.cuh``, split kernel plus
combine), as chunked prefill calls it: ``C`` queries of one row at
positions ``start .. start + C - 1``, each attending every cached key at
or below it.

Operations: ``4 H D`` per (query, visible key) pair, on the tensor cores
(bf16 ``mma.sync``).  Bytes: the ``start + C`` keys' K and V read once,
the block-table row, the queries read and the outputs written once."""


def cost(start: int, C: int, H: int, Hkv: int, D: int, n_pg: int, *,
         q_bytes: int = 4, kv_bytes: int = 2) -> dict:
    pairs = C * start + C * (C + 1) / 2.0
    keys = start + C
    nbytes = (2.0 * keys * Hkv * D * kv_bytes + n_pg * 4 + 4
              + 2.0 * C * H * D * q_bytes)
    return {"ops": {"bf16": 4.0 * H * D * pairs}, "bytes": nbytes}


def cost_of(rec: dict) -> dict:
    return cost(rec["start"], rec["C"], rec["H"], rec["Hkv"], rec["D"],
                rec["n_pg"], q_bytes=rec["q_bytes"], kv_bytes=rec["kv_bytes"])
