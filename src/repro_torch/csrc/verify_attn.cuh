// Chunked attention over a paged KV cache, split over the card: the body of
// both entries of paged_verify.cu (causal/window and tree-masked).
//
// Replaces: src/repro/kernels/paged_verify_kernel.py:173 (paged_verify),
// bodies _paged_verify_kernel (:42) and _paged_verify_tree_kernel (:101).
//
// Computes, for query c of row b at logical position qpos = base[b] + c,
// softmax attention over the paged keys: every position p <= qpos (and
// p > qpos - window with a window), or with `anc` (B, C, C) int32 every
// p < base[b] plus exactly the positions base[b] + j with anc[b, c, j] != 0,
// in any order.  Position p lives in page bt[b, p / ps] at offset p % ps of
// the pool (P, Hkv, ps, D).  q and out are float32 or bf16, pages bf16,
// arithmetic float32 with an online softmax.  A row with no visible key
// returns zeros.
//
// What bounds it on the H100: bytes.  At the serving shapes (GPT-2 345M:
// D 64, one query head per KV head; a prefill chunk B 1 x C 32, verifies
// B 8 x C 5 or 9) each live K/V element is read once against ~4 x C x group
// operations, far below the ~295 operations per byte where the tensor
// cores would bound it.  At 2-14 MB of live pages the time is latency:
// how many loads are in flight, and how soon the first block starts.  The
// TPU kernel walked a row's pages as one sequential grid axis; run that way
// here, a B 1 chunk kept 32 of 132 SMs busy, each walking 32 pages in
// turn with synchronous loads and scalar dot products.
//
// Design:
//   * Split-KV (flash-decoding).  The grid is (row, KV head, key split,
//     query tile), one block each.  A query tile is the ROWS = 16 query rows
//     (query, head of the KV head's group) of one m16 MMA tile: 16 / group
//     queries.  A split is a fixed run of pages [s * pps, (s + 1) * pps)
//     whose first position is a multiple of TILE; the wrapper derives pps and
//     the number of splits from the shapes alone (never from `base`, which
//     lives on the card), aiming at a few blocks per SM.  A block clips its
//     split to the keys its queries can see, [key_lo, key_end), and exits at
//     once, writing m = -inf and l = 0, when nothing is left.
//   * Inside a block each of the 4 warps walks its own 16-key tiles (tile i
//     of the block's run goes to warp i % 4) with its own running max, sum
//     and accumulators: no block barrier inside the walk.  Each warp stages
//     its tiles in a ring of STAGES buffers with 16-byte cp.async copies
//     (K and V rows gathered through the block table, a padded row stride
//     so ldmatrix is conflict-free), so the next tile's loads are in flight
//     while the current one computes.  Keys past key_end are zero-filled,
//     never read, so no block-table entry at or past n_pg is touched: a
//     parked row (base >= n_pg * ps) walks the whole table and its output
//     stays finite.
//   * Tensor cores through mma.sync m16n8k16 (bf16 in, float32 out) for
//     Q K^T and P V.  K and V are exact in bf16.  A float32 q is split as
//     q_hi + q_lo, two bf16 operands and two MMAs, and so are the float32
//     probabilities (p_hi + p_lo): about 16 significant bits each, where a
//     single bf16 operand would keep 8.  The score fragment becomes the
//     P V operand in registers.
//   * Registers: a lane holds its rows' Q fragments (hi and lo: D / 2
//     registers) and its share of the 16 x D float32 accumulator (D / 2).
//     Up to D 128 both stay in registers.  At D 256 that would be 256
//     registers before the scores, so there the block stages Q hi and lo
//     once in shared memory (a padded row stride, conflict-free 4-byte
//     reads), each warp reading the fragments of one k16 step at a time,
//     and the P V product is split over D: two blocks (the grid's fastest
//     index) each compute the same scores over all 256 dimensions of K
//     and accumulate half of the value dimensions, DV = 128 (64
//     accumulator registers).  They see the same keys in the same order,
//     so their maxima and sums are equal, and the first writes them.
//   * The tree mask: the block's rows of `anc` are packed once into bit
//     words in shared memory (one ballot per 32 keys); each score tests
//     its bit there.
//   * A tile none of whose scores is visible to any row of the warp is
//     skipped, so it leaves the running max, sum and accumulators exactly
//     as they were.  The causal and the tree entries share the geometry
//     and the walk (the tree's only reaches further, to the chunk's end),
//     so a lower-triangular `anc` gives output bit-identical to the causal
//     kernel.
//   * The 4 warps merge in shared memory, in warp order, into one float32
//     partial (m, l, acc[D]) per query row and split, written to scratch
//     the wrapper allocates.  A second kernel, one warp per output vector,
//     merges the splits in split order: deterministic, no atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace verify {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;   // query rows per block: one m16 MMA tile
constexpr int TILE = 16;   // keys per warp step: one k16 step of P V
constexpr int STAGES = 2;  // K/V tiles in each warp's ring
constexpr float M_INIT = -1e30f;  // finite: exp2(M_INIT - M_INIT) is 1
// The widest head whose Q fragments and accumulator stay in registers;
// past it Q is staged in shared memory and P V split over two blocks.
constexpr int REG_MAX_D = 128;

// Value dimensions one block accumulates: all of them up to REG_MAX_D,
// half of them past it.
__host__ __device__ constexpr int value_dims(int D) {
  return D > REG_MAX_D ? D / 2 : D;
}

// Shared memory of the split kernel, in bytes: the warps' K/V rings (reused
// by the warp merge), Q hi and lo (past REG_MAX_D), the merge's maxima and
// sums, the anc bit words.
inline size_t smem_bytes(int D, int C, int nq) {
  const int DV = value_dims(D);
  const size_t ring =
      (size_t)WARPS * STAGES * TILE * ((D + 8) + (DV + 8)) * 2;
  const size_t merge = (size_t)WARPS * ROWS * DV * 4;
  const size_t qs = D > REG_MAX_D ? (size_t)2 * ROWS * (D + 8) * 2 : 0;
  return (ring > merge ? ring : merge) + qs + 2 * WARPS * ROWS * 4 +
         (size_t)nq * ((C + 31) / 32) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with fill false, 16 zero bytes (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x0, x1) = hi + lo, each a bf16 pair: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block per (row b, KV head hk, split s, query tile qt, value half dh),
// blockIdx.x = (((b * Hkv + hk) * splits + s) * q_tiles + qt) * (D / DV) +
// dh.  Scratch: part_o
// (splits, B, C, H, D) and part_ml (splits, B, C, H, 2) float32.
template <typename QT, int D>
__global__ void __launch_bounds__(THREADS)
split_kernel(const QT* __restrict__ q,                // (B, C, H, D)
             const __nv_bfloat16* __restrict__ kpool,  // (P, Hkv, ps, D)
             const __nv_bfloat16* __restrict__ vpool,
             const int* __restrict__ base,  // (B,)
             const int* __restrict__ bt,    // (B, n_pg)
             const int* __restrict__ anc,   // (B, C, C) or nullptr
             float* __restrict__ part_o, float* __restrict__ part_ml, int B,
             int C, int H, int Hkv, int ps, int n_pg, int window, int nq,
             int pps, int splits, float scale_log2) {
  constexpr int KS = D / 16;  // k16 steps of Q K^T
  constexpr bool WIDE = D > REG_MAX_D;  // Q staged, P V split over D
  constexpr int DV = value_dims(D);     // value dimensions of this block
  constexpr int NT = DV / 8;   // n8 tiles of P V
  constexpr int DP = D + 8;    // staged K and Q row stride (bf16)
  constexpr int DVP = DV + 8;  // staged V row stride (bf16)
  constexpr int SLOT = TILE * (DP + DVP);  // ring slot: K then V
  constexpr bool SPLIT_Q = std::is_same<QT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int q_tiles = (C + nq - 1) / nq;
  int idx = blockIdx.x;
  const int dh = idx % (D / DV);
  idx /= D / DV;
  const int qt = idx % q_tiles;
  idx /= q_tiles;
  const int s = idx % splits;
  idx /= splits;
  const int hk = idx % Hkv, b = idx / Hkv;
  const int group = H / Hkv;
  const int c0 = qt * nq, nqb = min(nq, C - c0);
  const int R = nqb * group;  // live rows: r is (c0 + r / group, r % group)
  const int S = n_pg * ps;
  const int row0 = base[b];
  const int q0 = row0 + c0;
  const bool tree = anc != nullptr;
  // keys the block's queries can see: the tree mask may admit any in-chunk
  // key, the causal one nothing past the block's last query
  const int key_end = min(tree ? row0 + C : q0 + nqb, S);
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int split_lo = s * pps * ps;  // a multiple of TILE
  const int t_lo = max(split_lo, key_lo) / TILE;
  const int t_hi = (min(split_lo + pps * ps, key_end) + TILE - 1) / TILE;
  const size_t BCH = (size_t)B * C * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto vec = [&](int r) {  // output vector of block row r
    return ((size_t)b * C + c0 + r / group) * H + hk * group + r % group;
  };

  if (t_lo >= t_hi) {  // nothing of this split is visible to the block
    for (int r = tid; r < R && dh == 0; r += THREADS) {
      float* ml = part_ml + 2 * ((size_t)s * BCH + vec(r));
      ml[0] = -INFINITY;
      ml[1] = 0.0f;
    }
    return;
  }

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                        (size_t)warp * STAGES * SLOT;
  const int* row_bt = bt + (size_t)b * n_pg;
  // stage tile t (positions 16 t .. 16 t + 15) of K and of this block's
  // value dimensions of V into slot st
  auto issue = [&](int t, int st) {
    __nv_bfloat16* sk = ring + st * SLOT;
    __nv_bfloat16* sv = sk + TILE * DP;
    auto row = [&](int pos) {  // element offset of key pos's row
      return (((size_t)row_bt[pos / ps] * Hkv + hk) * ps + pos % ps) * D;
    };
    constexpr int CH = D / 8, CHV = DV / 8;  // 16-byte chunks per row
#pragma unroll
    for (int k = 0; k < TILE * CH / 32; ++k) {
      const int j = (lane + 32 * k) / CH, part = (lane + 32 * k) % CH;
      const int pos = t * TILE + j;
      const bool in = pos < key_end;
      const size_t src = (in ? row(pos) : 0) + 8 * part;
      cp_async16(sk + j * DP + 8 * part, kpool + src, in);
      if constexpr (!WIDE)
        cp_async16(sv + j * DP + 8 * part, vpool + src, in);
    }
    if constexpr (WIDE) {
#pragma unroll
      for (int k = 0; k < TILE * CHV / 32; ++k) {
        const int j = (lane + 32 * k) / CHV, part = (lane + 32 * k) % CHV;
        const int pos = t * TILE + j;
        const bool in = pos < key_end;
        cp_async16(sv + j * DVP + 8 * part,
                   vpool + (in ? row(pos) + dh * DV : 0) + 8 * part, in);
      }
    }
  };
  // this warp's tiles: t_lo + warp, t_lo + warp + WARPS, ...; the first
  // STAGES - 1 are in flight while the block reads anc and Q
  const int span = t_hi - t_lo;
  const int mine = span > warp ? (span - warp + WARPS - 1) / WARPS : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < mine) issue(t_lo + warp + WARPS * st, st);
    cp_async_commit();
  }

  const size_t ring_bytes = (size_t)WARPS * STAGES * SLOT * 2;
  const size_t merge_bytes = (size_t)WARPS * ROWS * DV * 4;
  // Q hi then Q lo, [ROWS][DP] bf16 each, when staged
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes));
  constexpr int Q_ELEMS = WIDE ? 2 * ROWS * DP : 0;
  float* mw = reinterpret_cast<float*>(qs + Q_ELEMS);
  float* lw = mw + WARPS * ROWS;
  uint32_t* words = reinterpret_cast<uint32_t*>(lw + WARPS * ROWS);
  const int W = (C + 31) / 32;  // bit words per query's anc row
  if (tree) {
    for (int i = warp; i < nqb * W; i += WARPS) {
      const int j = 32 * (i % W) + lane;
      const bool bit =
          j < C && anc[((size_t)b * C + c0 + i / W) * C + j] != 0;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) words[i] = word;
    }
  }
  if constexpr (WIDE) {  // the block's Q rows, split hi + lo; dead rows 0
    for (int i = tid; i < ROWS * D / 2; i += THREADS) {
      const int r = i / (D / 2), d = 2 * (i % (D / 2));
      float x0 = 0.0f, x1 = 0.0f;
      if (r < R) {
        const QT* qr = q + vec(r) * D;
        x0 = to_f(qr[d]);
        x1 = to_f(qr[d + 1]);
      }
      uint32_t hi, lo;
      split2(x0, x1, hi, lo);
      *reinterpret_cast<uint32_t*>(qs + r * DP + d) = hi;
      *reinterpret_cast<uint32_t*>(qs + (ROWS + r) * DP + d) = lo;
    }
  }
  __syncthreads();

  // this thread's rows of the m16 tile: gid and gid + 8
  const int gid = lane >> 2, tig = lane & 3;
  bool live[2];
  int qpos[2];
  const uint32_t* wrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gid + 8 * i;
    live[i] = r < R;
    qpos[i] = q0 + r / group;
    wrow[i] = words + (live[i] ? r / group : 0) * W;
  }

  // Q as MMA A fragments, hi and lo: register 2 * half + i holds row
  // gid + 8 i, dims 16 kk + 8 half + 2 tig and + 1 (in registers up to
  // D 128; from shared memory, one k16 step at a time, past it)
  constexpr int KR = WIDE ? 1 : KS;
  uint32_t qh[KR][4], ql[KR][4];
  auto q_frag = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (gid + 8 * i) * DP + 16 * kk + 8 * half + 2 * tig;
        h[2 * half + i] = *reinterpret_cast<const uint32_t*>(qs + at);
        if (SPLIT_Q)
          l[2 * half + i] =
              *reinterpret_cast<const uint32_t*>(qs + ROWS * DP + at);
      }
  };
  if constexpr (!WIDE) {
    const QT* qr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qr[i] = live[i] ? q + vec(gid + 8 * i) * D : nullptr;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = 16 * kk + 8 * half + 2 * tig;
          const float x0 = qr[i] ? to_f(qr[i][d]) : 0.0f;
          const float x1 = qr[i] ? to_f(qr[i][d + 1]) : 0.0f;
          split2(x0, x1, qh[kk][2 * half + i], ql[kk][2 * half + i]);
        }
  }

  auto visible = [&](int pos, int i) {
    if (!live[i] || pos >= key_end) return false;
    if (tree) {
      const int rel = pos - row0;
      return rel < 0 || ((wrow[i][rel >> 5] >> (rel & 31)) & 1u) != 0;
    }
    return pos <= qpos[i] && (window <= 0 || pos > qpos[i] - window);
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.0f, 0.0f};
  const int mi = lane >> 3, rr = lane & 7;  // ldmatrix row-address roles
  for (int j = 0; j < mine; ++j) {
    const int jn = j + STAGES - 1;
    if (jn < mine) issue(t_lo + warp + WARPS * jn, jn % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();

    const int t = t_lo + warp + WARPS * j;
    // score (nt, e): row gid + 8 (e >> 1), key 8 nt + 2 tig + (e & 1)
    bool ok[2][4];
    bool any = false;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[nt][e] = visible(t * TILE + 8 * nt + 2 * tig + (e & 1), e >> 1);
        any |= ok[nt][e];
      }
    if (__any_sync(0xffffffffu, any)) {
      const __nv_bfloat16* sk = ring + (j % STAGES) * SLOT;
      const __nv_bfloat16* sv = sk + TILE * DP;
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int kq = WIDE ? 0 : kk;
        if constexpr (WIDE) q_frag(kk, qh[0], ql[0]);
        uint32_t kb[4];  // keys 0-7 / 8-15 x dims 16 kk + 0-7 / 8-15
        ldsm_x4(kb, sk + ((mi >> 1) * 8 + rr) * DP + 16 * kk + (mi & 1) * 8);
        mma(sc[0], qh[kq], kb[0], kb[1]);
        mma(sc[1], qh[kq], kb[2], kb[3]);
        if (SPLIT_Q) {
          mma(sc[0], ql[kq], kb[0], kb[1]);
          mma(sc[1], ql[kq], kb[2], kb[3]);
        }
      }
      // online softmax in base 2; masked scores are -inf, so exactly 0
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = ok[nt][e] ? sc[nt][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - m[e >> 1]);
          rs[e >> 1] += sc[nt][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // the score fragments are the P operand: keys 0-7 then 8-15
      uint32_t ph[4], pl[4];
      split2(sc[0][0], sc[0][1], ph[0], pl[0]);
      split2(sc[0][2], sc[0][3], ph[1], pl[1]);
      split2(sc[1][0], sc[1][1], ph[2], pl[2]);
      split2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        uint32_t vb[4];  // keys 0-7 / 8-15 x dims 16 n2 + 0-7 / 8-15
        ldsm_x4_trans(vb,
                      sv + ((mi & 1) * 8 + rr) * DVP + 16 * n2 +
                          (mi >> 1) * 8);
        mma(o[2 * n2], ph, vb[0], vb[1]);
        mma(o[2 * n2], pl, vb[0], vb[1]);
        mma(o[2 * n2 + 1], ph, vb[2], vb[3]);
        mma(o[2 * n2 + 1], pl, vb[2], vb[3]);
      }
    }
    __syncwarp();  // the slot is refilled next step
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // merge the warps, in warp order, into the split's partial
  __syncthreads();  // every ring is spent: reuse it for the accumulators
  float* ow = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][DV]
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mw[warp * ROWS + gid + 8 * i] = m[i];
      lw[warp * ROWS + gid + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[(warp * ROWS + gid + 8 * (e >> 1)) * DV + 8 * n + 2 * tig +
         (e & 1)] = o[n][e];
  __syncthreads();
  for (int i = tid; i < R * DV; i += THREADS) {
    const int r = i / DV, d = i % DV;
    float M = M_INIT;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * ROWS + r]);
    float L = 0.0f, O = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(mw[w * ROWS + r] - M);
      L += lw[w * ROWS + r] * f;
      O += ow[(w * ROWS + r) * DV + d] * f;
    }
    const size_t v = (size_t)s * BCH + vec(r);
    if (L > 0.0f) part_o[v * D + dh * DV + d] = O;
    if (d == 0 && dh == 0) {
      part_ml[2 * v] = L > 0.0f ? M : -INFINITY;
      part_ml[2 * v + 1] = L;
    }
  }
}

// One warp per output vector: merge its splits in split order.  A split
// with m = -inf saw no key and wrote no accumulator.
template <typename QT, int D>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_o,
               const float* __restrict__ part_ml, QT* __restrict__ out,
               int BCH, int splits) {
  constexpr int PER = (D + 31) / 32;
  const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= BCH) return;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part_ml[2 * ((size_t)s * BCH + v)]);
  float L = 0.0f, O[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) O[k] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t sv = (size_t)s * BCH + v;
    const float m = part_ml[2 * sv];
    if (m == -INFINITY) continue;
    const float f = exp2f(m - M);
    L += part_ml[2 * sv + 1] * f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int d = lane + 32 * k;
      if (d < D) O[k] += part_o[sv * D + d] * f;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int d = lane + 32 * k;
    if (d < D) store(out + (size_t)v * D + d, L > 0.0f ? O[k] / L : 0.0f);
  }
}

template <typename QT, int D>
int launch_d(const void* q, const void* kpool, const void* vpool,
             const void* base, const void* bt, const void* anc, void* out,
             float* scratch, int B, int C, int H, int Hkv, int ps, int n_pg,
             int window, int nq, int pps, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, C, nq);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<QT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BCH = B * C * H;
  const int q_tiles = (C + nq - 1) / nq;
  float* part_o = scratch;
  float* part_ml = scratch + (size_t)splits * BCH * D;
  constexpr int parts = D / value_dims(D);
  split_kernel<QT, D>
      <<<B * Hkv * splits * q_tiles * parts, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool), static_cast<const int*>(base),
      static_cast<const int*>(bt), static_cast<const int*>(anc), part_o,
      part_ml, B, C, H, Hkv, ps, n_pg, window, nq, pps, splits,
      1.4426950408889634f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<QT, D><<<(BCH + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      part_o, part_ml, static_cast<QT*>(out), BCH, splits);
  return (int)cudaGetLastError();
}

// Launch both kernels on `stream`; returns cudaGetLastError().  D is 16
// (the reduced configs), 64, 128 or 256; H / Hkv <= ROWS; pps * ps a multiple
// of TILE; scratch holds splits * B * C * H * (D + 2) floats.  anc =
// nullptr is the causal/window mask.
template <typename QT>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* base, const void* bt, const void* anc, void* out,
           void* scratch, int B, int C, int H, int Hkv, int ps, int D,
           int n_pg, int window, int nq, int pps, int splits, void* stream) {
  if (H % Hkv != 0 || H / Hkv > ROWS || nq < 1 || nq * (H / Hkv) > ROWS ||
      (pps * ps) % TILE != 0 || (long long)splits * pps < n_pg)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<QT, 16>(q, kpool, vpool, base, bt, anc, out, sc, B, C,
                              H, Hkv, ps, n_pg, window, nq, pps, splits, st);
    case 64:
      return launch_d<QT, 64>(q, kpool, vpool, base, bt, anc, out, sc, B, C,
                              H, Hkv, ps, n_pg, window, nq, pps, splits, st);
    case 128:
      return launch_d<QT, 128>(q, kpool, vpool, base, bt, anc, out, sc, B, C,
                               H, Hkv, ps, n_pg, window, nq, pps, splits, st);
    case 256:
      return launch_d<QT, 256>(q, kpool, vpool, base, bt, anc, out, sc, B, C,
                               H, Hkv, ps, n_pg, window, nq, pps, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace verify
