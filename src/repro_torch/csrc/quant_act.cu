// SmoothQuant activation quantization of a W8A8 linear's input in one
// launch: the smoothing multiply, the per-token absolute maximum and the
// int8 rounding.
//
// Replaces no TPU kernel: the JAX package runs this as plain jnp in its
// linear (src/repro/models/layers.py:95 and src/repro/core/quant.py:85),
// and the port ran it as about eleven ATen kernels per quantized linear
// (reciprocal, multiplies, abs, amax, clamp, divisions, round, clamp,
// cast), each a launch and a round trip of the row through device memory.
// It exists because those launches were the largest block of the card's
// time in a W8A8 decode step.
//
// Computes, for each row of x (M, K) and the smoothing factors s (K,):
//   xs    = float(x) * (1 / s)                      (float32)
//   scale = max(max|xs|, 1e-6) / 127
//   x_q   = clip(round_half_even(xs / scale), -127, 127)
// and writes x_q as int8 (M, K) and scale as float32 (M, 1).  This is the
// arithmetic of the plain version (kernels/ref.quant_act_ref) and of the
// JAX package: 1 / s, xs / scale and the scale's division by 127 are IEEE
// divisions (__fdiv_rn), never a multiply by a reciprocal; the product is
// a separate round-to-nearest multiply (__fmul_rn), which the compiler
// cannot contract into an FMA; rounding is rintf (half to even).  A
// maximum has no order, so the kernel agrees with the plain version bit
// for bit.
//
// What bounds it on the H100: bytes, and at a decode step's sizes the
// launch itself.  A call reads 4MK + 4K bytes (x in float32, s) and writes
// MK + 4M (x_q, scale), with a few operations per element, far below any
// compute ridge: at M 127 x K 1,024 that is 650 KB, 0.2 us at 3.35 TB/s.
//
// Design: one block per row (M 127 takes 127 of the 132 SMs), its width
// from K.  Each thread takes chunks of 4 consecutive columns, chunk i of
// thread t at column (i * T + t) * 4 for a block of T threads: the row is
// read once, x as one 16-byte load a chunk in float32 (8 bytes in bf16),
// s as one 16-byte load, and x_q stored as one packed 4-byte word, when K
// is a multiple of 4 and the rows aligned (VEC), else element by element
// with the ragged edge masked.  Up to 4 chunks a thread (16,384 columns
// in a block of 1,024) the row's xs stays in registers between the
// maximum and the rounding (NV, the fewest that hold the row); a wider
// row (NV 0) takes its maximum in a first pass and reads the row again,
// from L2, in the second.  The maximum is a butterfly in every warp, then
// over the warps from shared memory (row_reduce.cuh).  No allocation, no
// host synchronisation: the wrapper allocates x_q and scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

// 4 columns from `col` as float32, masked by K unless VEC
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int col, int K,
                                      float* f) {
  if (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(p + col);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = col + e < K ? p[col + e] : 0.0f;
  }
}
template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int col, int K,
                                      float* f) {
  if (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + col);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = col + e < K ? __bfloat162float(p[col + e]) : 0.0f;
  }
}

// xs of the 4 columns from `col`; 0 past the row's end
template <bool VEC, typename TX>
__device__ __forceinline__ void smooth4(const TX* x, const float* s, int col,
                                        int K, float* v) {
  float a[4], f[4];
  load4<VEC>(x, col, K, a);
  load4<VEC>(s, col, K, f);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = VEC || col + e < K ? __fmul_rn(a[e], __fdiv_rn(1.0f, f[e])) : 0.0f;
}

__device__ __forceinline__ float absmax4(float m, const float* v) {
#pragma unroll
  for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(v[e]));
  return m;
}

// the 4 columns from `col` rounded to int8 and stored, masked by K unless
// VEC (one packed word)
template <bool VEC>
__device__ __forceinline__ void quant4(int8_t* p, int col, int K,
                                       const float* v, float sc) {
  int8_t q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[e], sc)), -127.0f), 127.0f);
  if (VEC) {
    *reinterpret_cast<uint32_t*>(p + col) =
        (uint32_t)(uint8_t)q[0] | (uint32_t)(uint8_t)q[1] << 8 |
        (uint32_t)(uint8_t)q[2] << 16 | (uint32_t)(uint8_t)q[3] << 24;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < K) p[col + e] = q[e];
  }
}

// One block per row.  NV > 0: NV chunks of 4 columns a thread, held in
// registers; NV == 0: two passes over a row of any width.
template <int NV, bool VEC, typename TX>
__global__ void __launch_bounds__(MAX_THREADS)
quant_act_kernel(const TX* __restrict__ x, const float* __restrict__ s,
                 int8_t* __restrict__ xq, float* __restrict__ scale, int K) {
  __shared__ float red[MAX_THREADS / 32];
  const int t = threadIdx.x, T = blockDim.x;
  const size_t off = (size_t)blockIdx.x * K;
  x += off;
  xq += off;
  float amax = 0.0f;
  float v[NV > 0 ? NV : 1][4];
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * T + t) * 4;
      if (col < K) {
        smooth4<VEC>(x, s, col, K, v[i]);
        amax = absmax4(amax, v[i]);
      }
    }
  } else {
    for (int col = t * 4; col < K; col += T * 4) {
      smooth4<VEC>(x, s, col, K, v[0]);
      amax = absmax4(amax, v[0]);
    }
  }
  const float sc =
      __fdiv_rn(fmaxf(row_reduce<true>(amax, red, T >> 5), 1e-6f), 127.0f);
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * T + t) * 4;
      if (col < K) quant4<VEC>(xq, col, K, v[i], sc);
    }
  } else {
    for (int col = t * 4; col < K; col += T * 4) {
      smooth4<VEC>(x, s, col, K, v[0]);
      quant4<VEC>(xq, col, K, v[0], sc);
    }
  }
  if (t == 0) scale[blockIdx.x] = sc;
}

template <int NV, bool VEC, typename TX>
int launch(const void* x, const void* s, void* xq, void* scale, int M, int K,
           int threads, cudaStream_t stream) {
  quant_act_kernel<NV, VEC, TX><<<M, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(s),
      static_cast<int8_t*>(xq), static_cast<float*>(scale), K);
  return (int)cudaGetLastError();
}

template <bool VEC, typename TX>
int launch_nv(const void* x, const void* s, void* xq, void* scale, int M,
              int K, int threads, int nv, cudaStream_t stream) {
  switch (nv) {
    case 0: return launch<0, VEC, TX>(x, s, xq, scale, M, K, threads, stream);
    case 1: return launch<1, VEC, TX>(x, s, xq, scale, M, K, threads, stream);
    case 2: return launch<2, VEC, TX>(x, s, xq, scale, M, K, threads, stream);
    case 4: return launch<4, VEC, TX>(x, s, xq, scale, M, K, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int launch_vec(const void* x, const void* s, void* xq, void* scale, int M,
               int K, int threads, int nv, int vec, cudaStream_t stream) {
  return vec ? launch_nv<true, TX>(x, s, xq, scale, M, K, threads, nv, stream)
             : launch_nv<false, TX>(x, s, xq, scale, M, K, threads, nv, stream);
}

}  // namespace

// x: (M, K) rows, bf16 when x_bf16 is 1, else float32; s: (K,) float32.
// Outputs: x_q (M, K) int8, scale (M,) float32.  threads: the block's
// width, a multiple of 32 up to 1,024; nv: 4-column chunks a thread holds
// in registers (1, 2 or 4), or 0 for two passes; vec 1 for 16-byte
// accesses (K % 4 == 0, x and s 16-byte aligned, x_q 4-byte aligned).
// Returns cudaGetLastError().
extern "C" int quant_act(const void* x, const void* s, void* xq, void* scale,
                         int M, int K, int x_bf16, int threads, int nv,
                         int vec, void* stream) {
  if ((vec && K % 4 != 0) || threads % 32 != 0 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_vec<__nv_bfloat16>(x, s, xq, scale, M, K, threads, nv, vec,
                                     st);
  return launch_vec<float>(x, s, xq, scale, M, K, threads, nv, vec, st);
}
