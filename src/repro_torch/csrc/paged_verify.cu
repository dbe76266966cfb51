// Chunked attention over a paged KV cache: C query positions per row (a
// prefill chunk, or a speculative verify chunk) attending in place, under
// the causal mask (paged_verify) or a token tree's ancestor mask
// (paged_verify_tree).
//
// Replaces: src/repro/kernels/paged_verify_kernel.py :: paged_verify, both
// bodies behind repro.kernels.ops.paged_verify: the causal one
// (_paged_verify_kernel) and the tree one (_paged_verify_tree_kernel, the
// `anc` ancestor bitmask of tree speculation).
//
// Computes, for query c of row b at logical position base[b] + c, the
// softmax attention over every cached position p <= base[b] + c (and
// p > base[b] + c - window with a window).  With `anc` (B, C, C) int32 the
// in-chunk part of that mask is replaced: query c attends every p < base[b]
// plus exactly the positions base[b] + j with anc[b, c, j] != 0, whatever
// the order of c and j (the TPU kernel walks every page and resolves the
// bits with a one-hot matmul; here each score looks its bit up).  The
// chunk's own K/V are already in the pages (the caller writes them first).
// A row left with no valid key returns zeros.
//
// What bounds it on the H100: bytes.  On the serving path (a prefill chunk
// B = 1, C = 32; a verify B = slots, C = k + 1; D = 64) the live K and V
// pages of each row are read once per block against ~4 * C * group
// operations per element.  The re-reads of a page by the blocks of
// different query slices hit L2.
//
// Design: the shared body in paged_attn.cuh.  One block per (row, KV head,
// slice of cq query positions) holds cq x group query rows and walks the
// pages up to min(n_pg, ceil((base + last query + 1) / ps)), with the tree
// mask up to the chunk's last position, so it never reads a block-table
// entry at or past n_pg: a row parked at base >= n_pg * ps (output never
// read) stays inside the table.  Slicing the chunk's queries across blocks
// gives a B = 1 prefill chunk Hkv * ceil(C / cq) blocks instead of Hkv.  A
// tree walk that starts at the same page as the causal walk and only adds
// fully masked tiles at its end, so a lower-triangular `anc` gives output
// bit-identical to the causal kernel.
#include "paged_attn.cuh"

namespace {

int launch_verify(const void* q, const void* k_pages, const void* v_pages,
                  const void* base, const void* block_table, const void* anc,
                  void* out, int q_bf16, int B, int C, int H, int Hkv, int ps,
                  int D, int n_pg, int window, int cq, int kt_pages,
                  void* stream) {
  if (q_bf16)
    return launch_paged_attn<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, base, block_table, anc, out, B, C, H, Hkv, ps,
        D, n_pg, /*base_shift=*/0, window, cq, kt_pages, stream);
  return launch_paged_attn<float, __nv_bfloat16, false>(
      q, k_pages, v_pages, base, block_table, anc, out, B, C, H, Hkv, ps, D,
      n_pg, /*base_shift=*/0, window, cq, kt_pages, stream);
}

}  // namespace

// q_bf16: 0 -> q/out float32, 1 -> bf16.  base: (B,) int32 position of
// query 0 per row.  Returns cudaGetLastError().
extern "C" int paged_verify(const void* q, const void* k_pages,
                            const void* v_pages, const void* base,
                            const void* block_table, void* out, int q_bf16,
                            int B, int C, int H, int Hkv, int ps, int D,
                            int n_pg, int window, int cq, int kt_pages,
                            void* stream) {
  return launch_verify(q, k_pages, v_pages, base, block_table, nullptr, out,
                       q_bf16, B, C, H, Hkv, ps, D, n_pg, window, cq,
                       kt_pages, stream);
}

// The tree body: anc (B, C, C) int32 ancestor bitmask, no window.
extern "C" int paged_verify_tree(const void* q, const void* k_pages,
                                 const void* v_pages, const void* base,
                                 const void* block_table, const void* anc,
                                 void* out, int q_bf16, int B, int C, int H,
                                 int Hkv, int ps, int D, int n_pg, int cq,
                                 int kt_pages, void* stream) {
  return launch_verify(q, k_pages, v_pages, base, block_table, anc, out,
                       q_bf16, B, C, H, Hkv, ps, D, n_pg, /*window=*/0, cq,
                       kt_pages, stream);
}
