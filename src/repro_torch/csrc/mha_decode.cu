// Decode attention over a contiguous KV cache: one new query token per row.
//
// Replaces: src/repro/kernels/mha_kernel.py :: mha_decode (_mha_kernel), the
// Pallas TPU kernel behind repro.kernels.ops.mha_decode (the paper's Fused
// MHA kernel on the stacked cache layout; the draft model of speculative
// decoding decodes through it).
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions p < lengths[b] (and p >= lengths[b] - window with a
// window) of the cache (B, Hkv, S, D).  GQA maps query head h to KV head
// h / group.  A row with no valid key returns 0 (the TPU kernel's
// zero-denominator clamp).  The TPU wrapper pads S to its 128-key block;
// here the walk stops at min(lengths[b], S) itself, so any S is taken.
//
// What bounds it on the H100: bytes.  Each call reads every live K and V
// row once (2 * len * Hkv * D * elem bytes per row) and does ~4 * group
// operations per element read, far below the float32 ridge.
//
// Design: the C = 1 contiguous case of the shared body in paged_attn.cuh.
// One block per (row, KV head) addresses (b, hk, p) directly and serves the
// group's query heads together, so each key is read once per KV head; it
// stages 64-key tiles of K and V in shared memory (never the S keys of a
// row at once: at S = 1024 that would need far more than the 227 KB a block
// may have) and keeps an f32 online softmax.  Keys and values may be bf16
// or float32 (a float32 engine's draft cache), queries float32 or bf16.
#include "paged_attn.cuh"

namespace {

template <typename QT>
int launch_mha(const void* q, const void* k, const void* v,
               const void* lengths, void* out, int kv_bf16, int B, int H,
               int Hkv, int S, int D, int window, int kt, void* stream) {
  if (kv_bf16)
    return launch_paged_attn<QT, __nv_bfloat16, true>(
        q, k, v, lengths, /*bt=*/nullptr, /*anc=*/nullptr, out, B, 1, H, Hkv,
        /*ps=*/1, D, /*n_pg=*/S, /*base_shift=*/-1, window, /*cq=*/1, kt,
        stream);
  return launch_paged_attn<QT, float, true>(
      q, k, v, lengths, /*bt=*/nullptr, /*anc=*/nullptr, out, B, 1, H, Hkv,
      /*ps=*/1, D, /*n_pg=*/S, /*base_shift=*/-1, window, /*cq=*/1, kt,
      stream);
}

}  // namespace

// q_bf16: 0 -> q/out float32, 1 -> bf16; kv_bf16: 0 -> k/v float32, 1 ->
// bf16.  lengths: (B,) int32 valid cache entries per row, the new token
// included.  kt: keys per shared-memory tile.  Returns cudaGetLastError().
extern "C" int mha_decode(const void* q, const void* k_cache,
                          const void* v_cache, const void* lengths, void* out,
                          int q_bf16, int kv_bf16, int B, int H, int Hkv,
                          int S, int D, int window, int kt, void* stream) {
  if (q_bf16)
    return launch_mha<__nv_bfloat16>(q, k_cache, v_cache, lengths, out,
                                     kv_bf16, B, H, Hkv, S, D, window, kt,
                                     stream);
  return launch_mha<float>(q, k_cache, v_cache, lengths, out, kv_bf16, B, H,
                           Hkv, S, D, window, kt, stream);
}
