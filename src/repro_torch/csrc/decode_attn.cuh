// One-token attention over a paged KV cache, split over the card: the body
// of paged_mha.cu.
//
// Replaces: src/repro/kernels/paged_mha_kernel.py:92 (paged_mha_decode,
// body _paged_mha_kernel).
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions key_lo <= p < key_end, with key_end = min(lengths[b],
// n_pg * ps) and key_lo = max(0, lengths[b] - window) under a window (else
// 0).  Position p lives in page bt[b, p / ps] at offset p % ps of the pool
// (P, Hkv, ps, D); query head h reads KV head h / group.  q and out are
// float32 or bf16, pages bf16, arithmetic float32 with an online softmax.
// A row with no key returns zeros.
//
// What bounds it on the H100: bytes.  Each live K and V element is read once
// per KV head against ~4 x group operations; at GPT-2's decode (B 8, 16
// heads of 64, up to 1,024 keys a row) that is 2-17 MB, a few microseconds
// of HBM time, so what matters is how many blocks are loading at once.
//
// Design (flash-decoding):
//   * Split-KV.  The grid is (row, KV head, head chunk, key split), one block
//     each.  A split is a run of pps whole pages; the wrapper derives pps and
//     the number of splits from the shapes alone (the lengths live on the
//     card, and reading them would synchronise), aiming at a few blocks per
//     SM.  A block clips its split to [key_lo, key_end) and, when nothing is
//     left, writes m = -inf and l = 0 and exits.  Keys at or past key_end
//     are never read, so no block-table entry at or past n_pg is touched.
//   * A block serves HG query heads of its KV head (the whole group when it
//     is at most 8; a wider group takes ceil(group / 8) head chunks), so each
//     page is read once per KV head for groups up to 8.
//   * Each of the 4 warps walks its own 16-key tiles of the block's run (tile
//     i goes to warp i % 4) through a ring of STAGES buffers filled with
//     16-byte cp.async copies of bf16 K and V rows: no block barrier inside
//     the walk.  Inside a warp, D / 8 lanes share a key, each holding 8
//     dimensions of it (16 bytes): 4 keys at once for D 64.  The dot product
//     is 8 FMAs per head and lane, then a shuffle reduction over the key's
//     lanes.
//   * Each key slot (the lanes of one key) keeps its own float32 running
//     max, sum and accumulators (8 dimensions per head and lane), so the walk
//     needs no shuffle across keys.  At the end the key slots merge by a
//     fixed butterfly of shuffles, the warps in shared memory in warp order,
//     into one float32 partial (m, l, acc[D]) per head and split in scratch
//     the wrapper allocates.
//   * verify_attn.cuh's combine kernel, with one query position, merges the
//     splits in split order: two calls are bit-identical, no atomics.
//   * No tensor cores: at group 1 a decode does about 2 operations per byte.
#pragma once

#include "verify_attn.cuh"

namespace decode {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16;   // keys per warp step
constexpr int STAGES = 3;  // K/V tiles in each warp's ring
constexpr int MAX_HG = 8;  // query heads per block
constexpr float M_INIT = -1e30f;  // finite: exp2(M_INIT - M_INIT) is 1

// Shared memory of the split kernel, in bytes: the warps' K/V rings, reused
// for the warps' partials.
inline size_t smem_bytes(int D, int HG) {
  const size_t ring = (size_t)WARPS * STAGES * 2 * TILE * D * 2;
  const size_t merge = (size_t)WARPS * HG * (D + 2) * 4;
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// One block per (row b, KV head hk, head chunk hc, split s), blockIdx.x =
// ((b * Hkv + hk) * h_chunks + hc) * splits + s.  Scratch: part_o (splits,
// B, H, D) and part_ml (splits, B, H, 2) float32, the layout of
// verify::combine_kernel with C = 1.
template <int D, int HG>
__global__ void __launch_bounds__(THREADS)
split_kernel(const void* __restrict__ q_,  // (B, H, D) float32 or bf16
             const __nv_bfloat16* __restrict__ kpool,  // (P, Hkv, ps, D)
             const __nv_bfloat16* __restrict__ vpool,
             const int* __restrict__ lengths,  // (B,)
             const int* __restrict__ bt,       // (B, n_pg)
             float* __restrict__ part_o, float* __restrict__ part_ml,
             int q_bf16, int B, int H, int Hkv, int ps, int n_pg, int window,
             int pps, int splits, float scale_log2) {
  constexpr int LPK = D / 8;         // lanes per key
  constexpr int KPI = 32 / LPK;      // keys a warp holds at once
  constexpr int ITERS = TILE / KPI;  // key steps per tile
  constexpr int CH = D / 8;          // 16-byte chunks per key row
  constexpr int STAGE = 2 * TILE * D;  // bf16 elements per ring slot
  extern __shared__ __align__(16) unsigned char smem[];

  const int group = H / Hkv;
  const int h_chunks = (group + HG - 1) / HG;
  int idx = blockIdx.x;
  const int s = idx % splits;
  idx /= splits;
  const int hc = idx % h_chunks;
  idx /= h_chunks;
  const int hk = idx % Hkv, b = idx / Hkv;
  const int h0 = hk * group + hc * HG;      // the block's first query head
  const int nh = min(HG, group - hc * HG);  // its live heads
  const int len = lengths[b];
  const int key_end = min(len, n_pg * ps);
  const int key_lo = window > 0 ? max(0, len - window) : 0;
  const int lo = max(s * pps * ps, key_lo);
  const int hi = min((s + 1) * pps * ps, key_end);
  const size_t BH = (size_t)B * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (lo >= hi) {  // nothing of this split is visible to the row
    for (int r = tid; r < nh; r += THREADS) {
      float* ml = part_ml + 2 * ((size_t)s * BH + (size_t)b * H + h0 + r);
      ml[0] = -INFINITY;
      ml[1] = 0.0f;
    }
    return;
  }

  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem) + (size_t)warp * STAGES * STAGE;
  const int* row_bt = bt + (size_t)b * n_pg;
  // stage tile t (keys lo + 16 t .. + 15) of K and V into slot st
  auto issue = [&](int t, int st) {
    __nv_bfloat16* sk = ring + st * STAGE;
    __nv_bfloat16* sv = sk + TILE * D;
#pragma unroll
    for (int k = 0; k < TILE * CH / 32; ++k) {
      const int j = (lane + 32 * k) / CH, part = (lane + 32 * k) % CH;
      const int pos = lo + t * TILE + j;
      const bool in = pos < hi;
      size_t src = 0;
      if (in)
        src = (((size_t)row_bt[pos / ps] * Hkv + hk) * ps + pos % ps) * D +
              8 * part;
      verify::cp_async16(sk + j * D + 8 * part, kpool + src, in);
      verify::cp_async16(sv + j * D + 8 * part, vpool + src, in);
    }
  };
  const int span = (hi - lo + TILE - 1) / TILE;
  const int mine = span > warp ? (span - warp + WARPS - 1) / WARPS : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < mine) issue(warp + WARPS * st, st);
    verify::cp_async_commit();
  }

  // this lane's key slot and its 8 dimensions; q pre-scaled to base 2
  const int ks = lane / LPK, dp = lane % LPK;
  float qr[HG][8];
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = 0.0f;
      if (h < nh) {
        const size_t at = ((size_t)b * H + h0 + h) * D + 8 * dp + e;
        v = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q_)[at])
                   : static_cast<const float*>(q_)[at];
      }
      qr[h][e] = v * scale_log2;
    }

  float m[HG], l[HG], o[HG][8];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = M_INIT;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[h][e] = 0.0f;
  }
  for (int i = 0; i < mine; ++i) {
    const int in = i + STAGES - 1;
    if (in < mine) issue(warp + WARPS * in, in % STAGES);
    verify::cp_async_commit();
    verify::cp_async_wait<STAGES - 1>();
    __syncwarp();

    const int t = warp + WARPS * i;
    const __nv_bfloat16* sk = ring + (i % STAGES) * STAGE;
    const __nv_bfloat16* sv = sk + TILE * D;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int j = it * KPI + ks;
      const bool valid = lo + t * TILE + j < hi;
      float kf[8], vf[8];
      unpack8(*reinterpret_cast<const uint4*>(sk + j * D + 8 * dp), kf);
      unpack8(*reinterpret_cast<const uint4*>(sv + j * D + 8 * dp), vf);
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float sc = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sc = fmaf(qr[h][e], kf[e], sc);
#pragma unroll
        for (int off = 1; off < LPK; off <<= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        if (valid) {
          const float m_new = fmaxf(m[h], sc);
          const float alpha = exp2f(m[h] - m_new);
          const float p = exp2f(sc - m_new);
          m[h] = m_new;
          l[h] = l[h] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) o[h][e] = fmaf(p, vf[e], o[h][e] * alpha);
        }
      }
    }
    __syncwarp();  // the slot is refilled next step
  }
  verify::cp_async_wait<0>();

  // merge the key slots: a fixed butterfly over the lanes of other keys
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float M = fmaxf(m[h], mo);
      const float fa = exp2f(m[h] - M), fb = exp2f(mo - M);
      l[h] = l[h] * fa + lo_ * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float oo = __shfl_xor_sync(0xffffffffu, o[h][e], off);
        o[h][e] = o[h][e] * fa + oo * fb;
      }
      m[h] = M;
    }

  // merge the warps, in warp order, into the split's partial
  __syncthreads();  // every ring is spent: reuse it
  float* ow = reinterpret_cast<float*>(smem);  // [WARPS][HG][D]
  float* mw = ow + WARPS * HG * D;             // [WARPS][HG]
  float* lw = mw + WARPS * HG;                 // [WARPS][HG]
  if (ks == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ow[(warp * HG + h) * D + 8 * dp + e] = o[h][e];
      if (dp == 0) {
        mw[warp * HG + h] = m[h];
        lw[warp * HG + h] = l[h];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = M_INIT;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * HG + h]);
    float L = 0.0f, O = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(mw[w * HG + h] - M);
      L += lw[w * HG + h] * f;
      O += ow[(w * HG + h) * D + d] * f;
    }
    const size_t v = (size_t)s * BH + (size_t)b * H + h0 + h;
    if (L > 0.0f) part_o[v * D + d] = O;
    if (d == 0) {
      part_ml[2 * v] = L > 0.0f ? M : -INFINITY;
      part_ml[2 * v + 1] = L;
    }
  }
}

template <int D, int HG>
int launch_hg(const void* q, const void* kpool, const void* vpool,
              const void* lengths, const void* bt, void* out, float* scratch,
              int q_bf16, int B, int H, int Hkv, int ps, int n_pg, int window,
              int pps, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, HG);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<D, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H;
  const int h_chunks = (H / Hkv + HG - 1) / HG;
  float* part_o = scratch;
  float* part_ml = scratch + (size_t)splits * BH * D;
  split_kernel<D, HG><<<B * Hkv * h_chunks * splits, THREADS, smem, stream>>>(
      q, static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool),
      static_cast<const int*>(lengths), static_cast<const int*>(bt), part_o,
      part_ml, q_bf16, B, H, Hkv, ps, n_pg, window, pps, splits,
      1.4426950408889634f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = (BH + verify::WARPS - 1) / verify::WARPS;
  if (q_bf16)
    verify::combine_kernel<__nv_bfloat16, D>
        <<<grid, verify::THREADS, 0, stream>>>(
            part_o, part_ml, static_cast<__nv_bfloat16*>(out), BH, splits);
  else
    verify::combine_kernel<float, D><<<grid, verify::THREADS, 0, stream>>>(
        part_o, part_ml, static_cast<float*>(out), BH, splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* kpool, const void* vpool,
             const void* lengths, const void* bt, void* out, float* scratch,
             int q_bf16, int B, int H, int Hkv, int ps, int n_pg, int window,
             int hg, int pps, int splits, cudaStream_t stream) {
  switch (hg) {
    case 1:
      return launch_hg<D, 1>(q, kpool, vpool, lengths, bt, out, scratch,
                             q_bf16, B, H, Hkv, ps, n_pg, window, pps, splits,
                             stream);
    case 2:
      return launch_hg<D, 2>(q, kpool, vpool, lengths, bt, out, scratch,
                             q_bf16, B, H, Hkv, ps, n_pg, window, pps, splits,
                             stream);
    case 4:
      return launch_hg<D, 4>(q, kpool, vpool, lengths, bt, out, scratch,
                             q_bf16, B, H, Hkv, ps, n_pg, window, pps, splits,
                             stream);
    case 8:
      return launch_hg<D, 8>(q, kpool, vpool, lengths, bt, out, scratch,
                             q_bf16, B, H, Hkv, ps, n_pg, window, pps, splits,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch the split kernel and the combine on `stream`; returns
// cudaGetLastError().  D is 16, 64 or 128; hg (query heads per block) 1, 2,
// 4 or 8; scratch holds splits * B * H * (D + 2) floats.
inline int launch(const void* q, const void* kpool, const void* vpool,
                  const void* lengths, const void* bt, void* out,
                  void* scratch, int q_bf16, int B, int H, int Hkv, int ps,
                  int D, int n_pg, int window, int hg, int pps, int splits,
                  void* stream) {
  if (H % Hkv != 0 || pps < 1 || splits < 1 ||
      (long long)splits * pps < n_pg)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(q, kpool, vpool, lengths, bt, out, sc, q_bf16, B,
                          H, Hkv, ps, n_pg, window, hg, pps, splits, st);
    case 64:
      return launch_d<64>(q, kpool, vpool, lengths, bt, out, sc, q_bf16, B,
                          H, Hkv, ps, n_pg, window, hg, pps, splits, st);
    case 128:
      return launch_d<128>(q, kpool, vpool, lengths, bt, out, sc, q_bf16, B,
                           H, Hkv, ps, n_pg, window, hg, pps, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode
