// Attention of C query positions per row over a block-table-addressed page
// pool: the body shared by paged_mha.cu (decode, C = 1) and
// paged_verify.cu (chunked prefill / verify, C = chunk).
//
// Query c of row b sits at logical position qpos = base[b] + base_shift + c
// and attends every cached position p with p <= qpos (and, with a window,
// p > qpos - window).  Decode passes the new cache length with
// base_shift = -1, which is exactly the decode mask p < length.  Positions
// live in page bt[b, p / ps] at offset p % ps of the pool (P, Hkv, ps, D),
// bf16.  Queries and outputs are (B, C, H, D) in float32 or bf16; all
// arithmetic is float32 with an online softmax over key tiles.  A row left
// with no valid key returns zeros (the zero-denominator clamp), never NaN.
//
// Design: one block per (row b, KV head, slice of cq query positions); it
// serves all `group` query heads of its KV head, so each page it needs is
// read once for all of them.  The block reads its row's base and block
// table itself (the TPU kernel had them as scalar prefetch) and walks only
// the pages between the window's first key and its last query,
//   pages [lo / ps, ceil(min(qpos_max + 1, n_pg * ps) / ps)),
// so it never reads a block-table entry at or past n_pg: a parked verify
// row (base >= n_pg * ps) walks the whole table and its output is never
// read.  Each step stages kt_pages pages of K and V in shared memory as
// float, computes the score tile, updates the per-query-row running max and
// sum (one warp per row), and rescales the float32 accumulators, which
// live in registers (at most MAX_ACC per thread).
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
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename QT>
__global__ void __launch_bounds__(ATTN_THREADS)
paged_attn_kernel(const QT* __restrict__ q,                 // (B, C, H, D)
                  const __nv_bfloat16* __restrict__ kpool,  // (P, Hkv, ps, D)
                  const __nv_bfloat16* __restrict__ vpool,
                  const int* __restrict__ base,  // (B,)
                  const int* __restrict__ bt,    // (B, n_pg)
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

  const int q0 = base[b] + base_shift + c0;  // position of the first query
  const int q1 = q0 + nc - 1;                // position of the last query
  const int S = n_pg * ps;
  const int key_hi = min(q1 + 1, S);
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

  const int* row_bt = bt + (size_t)b * n_pg;
  for (int p0 = pg_lo; p0 < pg_hi; p0 += kt_pages) {
    const int np = min(kt_pages, pg_hi - p0);
    const int nk = np * ps;
    const int kpos0 = p0 * ps;
    // stage K and V: 4 bf16 (8 bytes) per load, contiguous within a page
    for (int i = tid; i < nk * D / 4; i += ATTN_THREADS) {
      const int e = 4 * i;
      const int j = e / D, d = e % D;
      const int page = row_bt[p0 + j / ps];
      const size_t src = (((size_t)page * Hkv + hk) * ps + j % ps) * D + d;
      const uint2 kw = *reinterpret_cast<const uint2*>(kpool + src);
      const uint2 vw = *reinterpret_cast<const uint2*>(vpool + src);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kw);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vw);
      const float2 ka = __bfloat1622float2(k2[0]), kb = __bfloat1622float2(k2[1]);
      const float2 va = __bfloat1622float2(v2[0]), vb = __bfloat1622float2(v2[1]);
      float* kd = sk + j * Dp + d;
      kd[0] = ka.x; kd[1] = ka.y; kd[2] = kb.x; kd[3] = kb.y;
      float* vd = sv + j * D + d;
      vd[0] = va.x; vd[1] = va.y; vd[2] = vb.x; vd[3] = vb.y;
    }
    __syncthreads();
    // scores; masked keys get -inf so exp() makes them exactly 0
    for (int i = tid; i < R * nk; i += ATTN_THREADS) {
      const int r = i / nk, j = i % nk;
      const int pos = kpos0 + j;
      const int qpos = q0 + r / group;
      bool valid = pos <= qpos && pos < key_hi;
      if (window > 0) valid = valid && pos > qpos - window;
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

template <typename QT>
int launch_paged_attn(const void* q, const void* kpool, const void* vpool,
                      const void* base, const void* bt, void* out, int B,
                      int C, int H, int Hkv, int ps, int D, int n_pg,
                      int base_shift, int window, int cq, int kt_pages,
                      void* stream) {
  const size_t smem = paged_attn_smem(H / Hkv, D, ps, cq, kt_pages);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv, (C + cq - 1) / cq);
  paged_attn_kernel<QT><<<grid, ATTN_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool),
      static_cast<const int*>(base), static_cast<const int*>(bt),
      static_cast<QT*>(out), C, H, Hkv, ps, D, n_pg, base_shift, window, cq,
      kt_pages, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace
