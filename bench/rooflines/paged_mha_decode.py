"""The paged decode kernel (``ops.paged_mha_decode`` ->
``csrc/paged_mha.cu`` on ``decode_attn.cuh``, split kernel plus
combine): one query per row and head against the row's cached keys.

``keys[b]`` is row b's cached length with the new token (the engine's
host-side ``kv.lengths`` + 1); every row of the batch is computed, idle
ones over their single parked key.  Operations: ``4 H D`` per key of a
row (``q k`` and ``p v``), run in float32 on the CUDA cores.  Bytes: each
row's K and V read once from the pages, its block-table row, the query
read and the output written once."""


def cost(keys, H: int, Hkv: int, D: int, n_pg: int, *, q_bytes: int = 4,
         kv_bytes: int = 2) -> dict:
    total = float(sum(int(k) for k in keys))
    B = len(keys)
    nbytes = (2.0 * total * Hkv * D * kv_bytes + B * n_pg * 4 + B * 4
              + 2.0 * B * H * D * q_bytes)
    return {"ops": {"fp32": 4.0 * H * D * total}, "bytes": nbytes}


def cost_of(rec: dict) -> dict:
    return cost(rec["keys"], rec["H"], rec["Hkv"], rec["D"], rec["n_pg"],
                q_bytes=rec["q_bytes"], kv_bytes=rec["kv_bytes"])
