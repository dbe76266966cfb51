// Chunked attention over a paged KV cache: C query positions per row (a
// prefill chunk, or a speculative verify chunk) attending in place, under
// the causal mask (paged_verify) or a token tree's ancestor mask
// (paged_verify_tree).
//
// Replaces: src/repro/kernels/paged_verify_kernel.py:173 :: paged_verify,
// both bodies behind repro.kernels.ops.paged_verify: the causal one
// (_paged_verify_kernel, :42) and the tree one (_paged_verify_tree_kernel,
// :101, the `anc` ancestor bitmask of tree speculation).
//
// Computes, for query c of row b at logical position base[b] + c, the
// softmax attention over every cached position p <= base[b] + c (and
// p > base[b] + c - window with a window).  With `anc` (B, C, C) int32 the
// in-chunk part of that mask is replaced: query c attends every p < base[b]
// plus exactly the positions base[b] + j with anc[b, c, j] != 0, whatever
// the order of c and j.  The chunk's own K/V are already in the pages (the
// caller writes them first).  A row left with no valid key returns zeros.
//
// What bounds it on the H100, and the design: see verify_attn.cuh, the
// body both entries launch (a split-KV kernel on tensor cores, then a
// combine kernel that merges the splits in a fixed order).
#include "verify_attn.cuh"

namespace {

int launch_verify(const void* q, const void* k_pages, const void* v_pages,
                  const void* base, const void* block_table, const void* anc,
                  void* out, void* scratch, int q_bf16, int B, int C, int H,
                  int Hkv, int ps, int D, int n_pg, int window, int nq,
                  int pps, int splits, void* stream) {
  if (q_bf16)
    return verify::launch<__nv_bfloat16>(
        q, k_pages, v_pages, base, block_table, anc, out, scratch, B, C, H,
        Hkv, ps, D, n_pg, window, nq, pps, splits, stream);
  return verify::launch<float>(q, k_pages, v_pages, base, block_table, anc,
                               out, scratch, B, C, H, Hkv, ps, D, n_pg,
                               window, nq, pps, splits, stream);
}

}  // namespace

// q_bf16: 0 -> q/out float32, 1 -> bf16.  base: (B,) int32 position of
// query 0 per row.  scratch: splits * B * C * H * (D + 2) floats.  nq
// queries per block, pps pages per split, splits: the wrapper's geometry.
// Returns cudaGetLastError().
extern "C" int paged_verify(const void* q, const void* k_pages,
                            const void* v_pages, const void* base,
                            const void* block_table, void* out,
                            void* scratch, int q_bf16, int B, int C, int H,
                            int Hkv, int ps, int D, int n_pg, int window,
                            int nq, int pps, int splits, void* stream) {
  return launch_verify(q, k_pages, v_pages, base, block_table, nullptr, out,
                       scratch, q_bf16, B, C, H, Hkv, ps, D, n_pg, window, nq,
                       pps, splits, stream);
}

// The tree body: anc (B, C, C) int32 ancestor bitmask, no window.
extern "C" int paged_verify_tree(const void* q, const void* k_pages,
                                 const void* v_pages, const void* base,
                                 const void* block_table, const void* anc,
                                 void* out, void* scratch, int q_bf16, int B,
                                 int C, int H, int Hkv, int ps, int D,
                                 int n_pg, int nq, int pps, int splits,
                                 void* stream) {
  return launch_verify(q, k_pages, v_pages, base, block_table, anc, out,
                       scratch, q_bf16, B, C, H, Hkv, ps, D, n_pg,
                       /*window=*/0, nq, pps, splits, stream);
}
