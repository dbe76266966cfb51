// Decode attention over a paged KV cache: one new query token per row.
//
// Replaces: src/repro/kernels/paged_mha_kernel.py:92 :: paged_mha_decode
// (_paged_mha_kernel), the Pallas TPU kernel behind
// repro.kernels.ops.paged_mha_decode.
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions p < lengths[b] (and p >= lengths[b] - window with a
// window), where position p lives in page block_table[b, p / ps].  GQA maps
// query head h to KV head h / group.  A row with no valid key returns 0.
//
// What bounds it on the H100, and the design: see decode_attn.cuh, the body
// this entry launches (a split-KV kernel whose warps own keys, then the
// verify body's combine kernel, which merges the splits in a fixed order).
#include "decode_attn.cuh"

// q_bf16: 0 -> q/out float32, 1 -> bf16.  lengths: (B,) int32 valid cache
// entries per row, the new token included.  scratch: splits * B * H *
// (D + 2) floats.  hg query heads per block, pps pages per split, splits:
// the wrapper's geometry.  Returns cudaGetLastError().
extern "C" int paged_mha_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* lengths,
                                const void* block_table, void* out,
                                void* scratch, int q_bf16, int B, int H,
                                int Hkv, int ps, int D, int n_pg, int window,
                                int hg, int pps, int splits, void* stream) {
  const decode::Call c{q, k_pages, v_pages,
                       static_cast<const int*>(lengths), out,
                       static_cast<float*>(scratch), q_bf16, B, H, Hkv,
                       window, hg, pps * ps, splits,
                       static_cast<cudaStream_t>(stream)};
  const decode::Paged addr{static_cast<const int*>(block_table), n_pg, ps};
  return decode::launch<__nv_bfloat16>(c, D, addr,
                                          (long long)n_pg * ps);
}
