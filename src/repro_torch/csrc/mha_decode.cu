// Decode attention over a contiguous KV cache: one new query token per row.
//
// Replaces: src/repro/kernels/mha_kernel.py:89 :: mha_decode (_mha_kernel),
// the Pallas TPU kernel behind repro.kernels.ops.mha_decode (the paper's
// Fused MHA kernel on the stacked cache layout; the draft model of
// speculative decoding decodes through it).
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions p < min(lengths[b], S) (and p >= lengths[b] - window
// with a window) of the cache (B, Hkv, S, D).  GQA maps query head h to KV
// head h / group.  A row with no valid key returns 0 (the TPU kernel's
// zero-denominator clamp).  The TPU wrapper pads S to its 128-key block;
// here the walk stops at min(lengths[b], S) itself, so any S is taken.
//
// What bounds it on the H100: bytes.  Each call reads every live K and V
// row once (2 * len * Hkv * D * elem bytes per row) and does ~4 * group
// operations per element read, far below the float32 ridge.  At the draft
// model's decode (B 8, 16 heads of 64, a float32 cache of 1,024 positions
// a row) 4,259 live keys are 35 MB, 10.4 us at 3.35 TB/s.
//
// Design: the contiguous case of the split-KV decode body, decode_attn.cuh
// (its Contig addressing), shared with paged_mha.cu: blocks over (row, KV
// head, head chunk of up to 8 query heads, key split), the splits runs of
// whole 16-key tiles from the shapes alone, each warp walking its own
// tiles through a cp.async ring, then the verify body's combine kernel
// merging the splits in split order.  The cache may be bf16 or float32: a
// lane holds 8 dimensions of a key, one 16-byte chunk of a bf16 row or two
// of a float32 row.
#include "decode_attn.cuh"

// q_bf16: 0 -> q/out float32, 1 -> bf16; kv_bf16: 0 -> k/v float32, 1 ->
// bf16.  lengths: (B,) int32 valid cache entries per row, the new token
// included.  scratch: splits * B * H * (D + 2) floats.  hg query heads per
// block, kps keys per split (a multiple of 16) and splits: the wrapper's
// geometry.  Returns cudaGetLastError().
extern "C" int mha_decode(const void* q, const void* k_cache,
                          const void* v_cache, const void* lengths, void* out,
                          void* scratch, int q_bf16, int kv_bf16, int B,
                          int H, int Hkv, int S, int D, int window, int hg,
                          int kps, int splits, void* stream) {
  if (kps % decode::TILE != 0) return (int)cudaErrorInvalidValue;
  const decode::Call c{q, k_cache, v_cache,
                       static_cast<const int*>(lengths), out,
                       static_cast<float*>(scratch), q_bf16, B, H, Hkv,
                       window, hg, kps, splits,
                       static_cast<cudaStream_t>(stream)};
  const decode::Contig addr{S};
  if (kv_bf16) return decode::launch<__nv_bfloat16>(c, D, addr, S);
  return decode::launch<float>(c, D, addr, S);
}
