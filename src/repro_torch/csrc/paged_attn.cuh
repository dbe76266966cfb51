// Attention of C query positions per row over a cache of keys addressed by
// position: the body of mha_decode.cu (decode over a contiguous cache, with
// C = 1 and no tree mask), its only user.  The paged decode (paged_mha.cu)
// and the chunked verify (paged_verify.cu) have their own split-KV bodies,
// decode_attn.cuh and verify_attn.cuh.
//
// Query c of row b sits at logical position qpos = base[b] + base_shift + c
// and attends every cached position p with p <= qpos (and, with a window,
// p > qpos - window).  Decode passes the new cache length with
// base_shift = -1, which is exactly the decode mask p < length.  With a tree
// mask (`anc`, (B, C, C) int32) query c instead attends every p below the
// row's chunk base plus the in-chunk positions p = base + j whose bit
// anc[b, c, j] is set, in any order.
//
// Two key layouts, chosen at compile time:
//   * paged (CONTIG = false): position p lives in page bt[b, p / ps] at
//     offset p % ps of the pool (P, Hkv, ps, D); no entry launches it now;
//   * contiguous (CONTIG = true): position p of row b is (b, hk, p) of a
//     (B, Hkv, S, D) cache, run with ps = 1 and n_pg = S, so the tile walk
//     below is the same with one-position "pages" and no table.
// Queries and outputs are (B, C, H, D) in float32 or bf16, keys and values
// bf16 (or float32 in the contiguous layout); all arithmetic is float32 with
// an online softmax over key tiles.  A row left with no valid key returns
// zeros (the zero-denominator clamp), never NaN.
//
// Design: one block per (row b, KV head, slice of cq query positions); it
// serves all `group` query heads of its KV head, so each key it needs is
// read once for all of them.  The block reads its row's base and block
// table itself (the TPU kernels had them as scalar prefetch) and walks only
// the pages between the window's first key and its last query,
//   pages [lo / ps, ceil(min(qpos_max + 1, n_pg * ps) / ps)),
// (with a tree mask, up to the chunk's last position base + C - 1), so it
// never reads a block-table entry at or past n_pg: a parked verify row
// (base >= n_pg * ps) walks the whole table and its output is never read.
// Each step stages kt_pages pages of K and V in shared memory as float,
// computes the score tile, updates the per-query-row running max and sum
// (one warp per row), and rescales the float32 accumulators, which live in
// registers (at most MAX_ACC per thread).  A tile whose keys are all masked
// leaves every accumulator, maximum and sum exactly as it was (its scores
// are -inf, so its probabilities are exactly 0 and its rescale factor 1):
// a lower-triangular `anc` walks more tiles than the causal mask and gives
// bit-identical output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ATTN_THREADS = 128;
constexpr int MAX_ACC = 8;  // (query row, dim) accumulators per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// four consecutive cache elements (8-byte aligned bf16, 16-byte float)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename QT, typename KVT, bool CONTIG>
__global__ void __launch_bounds__(ATTN_THREADS)
paged_attn_kernel(const QT* __restrict__ q,      // (B, C, H, D)
                  const KVT* __restrict__ kpool,  // (P, Hkv, ps, D) or
                  const KVT* __restrict__ vpool,  // (B, Hkv, S, D)
                  const int* __restrict__ base,  // (B,)
                  const int* __restrict__ bt,    // (B, n_pg); unused CONTIG
                  const int* __restrict__ anc,   // (B, C, C) or nullptr
                  QT* __restrict__ out,          // (B, C, H, D)
                  int C, int H, int Hkv, int ps, int D, int n_pg,
                  int base_shift, int window, int cq, int kt_pages,
                  float scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = ATTN_THREADS / 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const int c0 = blockIdx.z * cq;
  const int nc = min(cq, C - c0);
  const int R = nc * group;  // query rows: row r = (c0 + r / group, r % group)
  const int KT = kt_pages * ps;
  const int Dp = D + 1;  // padded K row stride (conflict-free score reads)

  float* sq = smem;                   // [R][D]
  float* sk = sq + cq * group * D;    // [KT][Dp]
  float* sv = sk + KT * Dp;           // [KT][D]
  float* ss = sv + KT * D;            // [R][KT] scores, then probabilities
  float* sm = ss + cq * group * KT;   // [R] running max
  float* sl = sm + cq * group;        // [R] running sum
  float* sa = sl + cq * group;        // [R] this tile's rescale factor

  const int row0 = base[b] + base_shift;  // position of query 0 of the row
  const int q0 = row0 + c0;               // position of the block's first query
  const int q1 = q0 + nc - 1;             // position of its last query
  const int S = n_pg * ps;
  // the tree mask may admit any in-chunk key, whatever the query's order
  const int key_hi = min((anc != nullptr ? row0 + C - 1 : q1) + 1, S);
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int pg_lo = key_lo / ps;
  const int pg_hi = key_hi > key_lo ? (key_hi + ps - 1) / ps : pg_lo;

  for (int i = tid; i < R * D; i += ATTN_THREADS) {
    const int r = i / D, d = i % D;
    const int c = c0 + r / group, h = hk * group + r % group;
    sq[i] = to_f(q[(((size_t)b * C + c) * H + h) * D + d]);
  }
  for (int r = tid; r < R; r += ATTN_THREADS) {
    sm[r] = -1e30f;
    sl[r] = 0.0f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.0f;
  __syncthreads();

  const int* row_bt = CONTIG ? nullptr : bt + (size_t)b * n_pg;
  for (int p0 = pg_lo; p0 < pg_hi; p0 += kt_pages) {
    const int np = min(kt_pages, pg_hi - p0);
    const int nk = np * ps;
    const int kpos0 = p0 * ps;
    // stage K and V: 4 elements per load, contiguous within a page
    for (int i = tid; i < nk * D / 4; i += ATTN_THREADS) {
      const int e = 4 * i;
      const int j = e / D, d = e % D;
      size_t src;
      if (CONTIG) {
        src = (((size_t)b * Hkv + hk) * S + kpos0 + j) * D + d;
      } else {
        const int page = row_bt[p0 + j / ps];
        src = (((size_t)page * Hkv + hk) * ps + j % ps) * D + d;
      }
      const float4 kf = load4(kpool + src), vf = load4(vpool + src);
      float* kd = sk + j * Dp + d;
      kd[0] = kf.x; kd[1] = kf.y; kd[2] = kf.z; kd[3] = kf.w;
      float* vd = sv + j * D + d;
      vd[0] = vf.x; vd[1] = vf.y; vd[2] = vf.z; vd[3] = vf.w;
    }
    __syncthreads();
    // scores; masked keys get -inf so exp() makes them exactly 0
    for (int i = tid; i < R * nk; i += ATTN_THREADS) {
      const int r = i / nk, j = i % nk;
      const int pos = kpos0 + j;
      const int qpos = q0 + r / group;
      bool valid;
      if (anc != nullptr) {  // the row's prefix, then the query's root path
        const int rel = pos - row0;
        valid = rel < 0 ||
                (rel < C && __ldg(anc + ((size_t)b * C + c0 + r / group) * C +
                                  rel) != 0);
      } else {
        valid = pos <= qpos && pos < key_hi;
        if (window > 0) valid = valid && pos > qpos - window;
      }
      float s = -INFINITY;
      if (valid) {
        const float* qr = sq + r * D;
        const float* kr = sk + j * Dp;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ss[r * KT + j] = s;
    }
    __syncthreads();
    // online softmax update, one warp per query row
    for (int r = warp; r < R; r += n_warps) {
      float* sr = ss + r * KT;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < nk; j += 32) {
        const float p = __expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    // rescale and accumulate P V
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int i = tid + a * ATTN_THREADS;
      if (i < R * D) {
        const int r = i / D, d = i % D;
        const float* pr = ss + r * KT;
        float v = acc[a] * sa[r];
        for (int j = 0; j < nk; ++j) v = fmaf(pr[j], sv[j * D + d], v);
        acc[a] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int i = tid + a * ATTN_THREADS;
    if (i < R * D) {
      const int r = i / D, d = i % D;
      const int c = c0 + r / group, h = hk * group + r % group;
      const float l = sl[r];
      from_f(out + (((size_t)b * C + c) * H + h) * D + d,
             acc[a] / (l > 0.0f ? l : 1.0f));
    }
  }
}

// Shared memory the kernel needs, in bytes.
inline size_t paged_attn_smem(int group, int D, int ps, int cq,
                              int kt_pages) {
  const size_t R = (size_t)cq * group, KT = (size_t)kt_pages * ps;
  return sizeof(float) *
         (R * D + KT * (D + 1) + KT * D + R * KT + 3 * R);
}

// Launch on `stream`; returns cudaGetLastError().  CONTIG takes ps = 1,
// n_pg = S and bt = nullptr; anc = nullptr is the causal/window mask.
template <typename QT, typename KVT, bool CONTIG>
int launch_paged_attn(const void* q, const void* kpool, const void* vpool,
                      const void* base, const void* bt, const void* anc,
                      void* out, int B, int C, int H, int Hkv, int ps, int D,
                      int n_pg, int base_shift, int window, int cq,
                      int kt_pages, void* stream) {
  const size_t smem = paged_attn_smem(H / Hkv, D, ps, cq, kt_pages);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<QT, KVT, CONTIG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv, (C + cq - 1) / cq);
  paged_attn_kernel<QT, KVT, CONTIG><<<grid, ATTN_THREADS, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kpool),
      static_cast<const KVT*>(vpool), static_cast<const int*>(base),
      static_cast<const int*>(bt), static_cast<const int*>(anc),
      static_cast<QT*>(out), C, H, Hkv, ps, D, n_pg, base_shift, window, cq,
      kt_pages, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace
