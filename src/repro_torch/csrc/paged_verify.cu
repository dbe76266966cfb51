// Chunked causal attention over a paged KV cache: C query positions per row
// (a prefill chunk, or a speculative verify chunk) attending in place.
//
// Replaces: src/repro/kernels/paged_verify_kernel.py :: paged_verify, the
// causal body (_paged_verify_kernel), behind
// repro.kernels.ops.paged_verify.  The tree body (_paged_verify_tree_kernel,
// the `anc` ancestor mask) is not ported yet; the Python wrapper refuses it.
//
// Computes, for query c of row b at logical position base[b] + c, the
// softmax attention over every cached position p <= base[b] + c (and
// p > base[b] + c - window with a window).  The chunk's own K/V are already
// in the pages (the caller writes them first).  A row left with no valid key
// returns zeros.
//
// What bounds it on the H100: on the serving path (B = 1, C = 32, D = 64),
// bytes: the live K and V pages of the row, read once per block, against
// ~4 * C * group operations per element.  The re-reads of a page by the
// blocks of different query slices hit L2.
//
// Design: the shared body in paged_attn.cuh.  One block per (row, KV head,
// slice of cq query positions) holds cq x group query rows and walks the
// pages up to min(n_pg, ceil((base + last query + 1) / ps)), so it never
// reads a block-table entry at or past n_pg: a row parked at
// base >= n_pg * ps (output never read) stays inside the table.  Slicing
// the chunk's queries across blocks gives a B = 1 prefill chunk
// Hkv * ceil(C / cq) blocks instead of Hkv.
#include "paged_attn.cuh"

// q_bf16: 0 -> q/out float32, 1 -> bf16.  base: (B,) int32 position of
// query 0 per row.  Returns cudaGetLastError().
extern "C" int paged_verify(const void* q, const void* k_pages,
                            const void* v_pages, const void* base,
                            const void* block_table, void* out, int q_bf16,
                            int B, int C, int H, int Hkv, int ps, int D,
                            int n_pg, int window, int cq, int kt_pages,
                            void* stream) {
  if (q_bf16)
    return launch_paged_attn<__nv_bfloat16>(
        q, k_pages, v_pages, base, block_table, out, B, C, H, Hkv, ps, D,
        n_pg, /*base_shift=*/0, window, cq, kt_pages, stream);
  return launch_paged_attn<float>(
      q, k_pages, v_pages, base, block_table, out, B, C, H, Hkv, ps, D, n_pg,
      /*base_shift=*/0, window, cq, kt_pages, stream);
}
