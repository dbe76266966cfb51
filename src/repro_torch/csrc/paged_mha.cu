// Decode attention over a paged KV cache: one new query token per row.
//
// Replaces: src/repro/kernels/paged_mha_kernel.py :: paged_mha_decode
// (_paged_mha_kernel), the Pallas TPU kernel behind
// repro.kernels.ops.paged_mha_decode.
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions p < lengths[b] (and p >= lengths[b] - window with a
// window), where position p lives in page block_table[b, p / ps].  GQA maps
// query head h to KV head h / group.  A row with no valid key returns 0.
//
// What bounds it on the H100: bytes.  Each call reads every live K and V
// page of every row once (2 * len * Hkv * D * 2 bytes per row) and does
// ~4 * group operations per element read, far below the float32 ridge.
//
// Design: the C = 1 case of the shared body in paged_attn.cuh, with the
// query sitting at lengths[b] - 1.  One block per (row, KV head) serves the
// group query heads together, so each page is read once per KV head.  The
// block reads its own block-table entries and length and loops over the
// row's live pages only; an f32 online softmax keeps the scores out of
// device memory.  q may be float32 (the W8A8 engine's activation stream) or
// bf16, with bf16 pages.  Splitting a long row's pages across blocks
// (flash-decoding) is later work.
#include "paged_attn.cuh"

// q_bf16: 0 -> q/out float32, 1 -> bf16.  lengths: (B,) int32 valid cache
// entries per row, the new token included.  Returns cudaGetLastError().
extern "C" int paged_mha_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* lengths,
                                const void* block_table, void* out,
                                int q_bf16, int B, int H, int Hkv, int ps,
                                int D, int n_pg, int window, int kt_pages,
                                void* stream) {
  if (q_bf16)
    return launch_paged_attn<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, lengths, block_table, /*anc=*/nullptr, out, B,
        1, H, Hkv, ps, D, n_pg, /*base_shift=*/-1, window, /*cq=*/1,
        kt_pages, stream);
  return launch_paged_attn<float, __nv_bfloat16, false>(
      q, k_pages, v_pages, lengths, block_table, /*anc=*/nullptr, out, B, 1,
      H, Hkv, ps, D, n_pg, /*base_shift=*/-1, window, /*cq=*/1, kt_pages,
      stream);
}
