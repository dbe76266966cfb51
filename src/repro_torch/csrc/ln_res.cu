// Residual add, LayerNorm or RMSNorm, scale and shift, then per-token
// symmetric int8 quantisation, in one pass: the paper's Fused LN&Res kernel.
//
// Replaces: src/repro/kernels/ln_res_kernel.py :: ln_res (_ln_res_kernel),
// the Pallas TPU kernel behind repro.kernels.ops.ln_res, reached (as in the
// JAX package) only through core/mdk.MDK_REGISTRY["ln_res"].
//
// Computes, for each row of x, res (B, D):
//   r     = x + res                                   (float32)
//   y     = (r - mean(r)) / sqrt(var(r) + eps) * w + b   (layernorm)
//         = r / sqrt(mean(r^2) + eps) * w + b            (rmsnorm)
//   scale = max(max|y|, 1e-6) / 127
//   y_q   = clip(round_half_even(y / scale), -127, 127)
// and writes y as bf16, r in the residual's dtype, y_q as int8 and scale as
// float32 (B, 1).  The variance takes two passes over the row, as the
// reference does (the mean, then the mean of (r - mean)^2), never
// E[r^2] - mean^2, which cancels catastrophically on a row with a large mean.
//
// Where the card's defaults differ from the plain version, the kernel takes
// the plain version's rounding: 1 / sqrt (both IEEE, __fsqrt_rn and
// __fdiv_rn) rather than rsqrtf (up to 2 ulp), an IEEE division y / scale
// rather than a multiply by the reciprocal, round-half-to-even (rintf), and
// __float2bfloat16_rn for the bf16 casts.  The normalise, scale and shift
// are issued as separate round-to-nearest multiplies and adds so that the
// compiler cannot contract them into an FMA.  The sums behind the mean and
// the variance are taken in float64, as in the plain version: a float32 sum
// in another order than the plain version's moves the mean of a row with a
// large mean by an ulp of the sum, and every output near zero by far more
// than a bf16 ulp of its own.  In float64 the sums are exact (or nearly),
// so both round them to the same float32 mean and variance, and the
// outputs agree bit for bit.
//
// What bounds it on the H100: bytes, and at decode sizes the launch itself.
// A row of D elements is read twice (x and res) and written three times (y,
// r, y_q) with ~10 operations per element, far below any compute ridge; at
// B 8 x D 1024 that is 131 KB, 0.04 us at 3.35 TB/s, so a few microseconds of
// launch and block scheduling are the whole cost.
//
// Design: one block per row (the TPU kernel's (bb, D) row block held in
// VMEM becomes one row held in shared memory).  The block reads x and res
// once, keeps r in shared memory as float32 (D * 4 bytes of dynamic shared
// memory: up to ~58,000 columns, so every width of configs/ fits), and makes
// three block reductions over it (sum, squared deviation, absolute maximum)
// by warp shuffles and a 32-entry scratch.  Threads stride over the row, so
// neighbouring threads touch neighbouring addresses and a ragged D is masked
// by the loop bound; nothing pads.  x and res may be bf16 or float32 each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum (or maximum) over the block; every thread gets the result.  The
// order is fixed by the thread layout, so a row gives the same bits on
// every launch.
template <bool MAX, typename T>
__device__ T block_reduce(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? (v > u ? v : u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the scratch may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? (v > u ? v : u) : v + u;
  }
  return v;
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(THREADS)
ln_res_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
              const float* __restrict__ w, const float* __restrict__ b,
              __nv_bfloat16* __restrict__ y, TR* __restrict__ rn,
              int8_t* __restrict__ yq, float* __restrict__ scale, int D,
              int rms, float eps) {
  extern __shared__ float row[];
  __shared__ double red[32];
  __shared__ float redf[32];
  const size_t off = (size_t)blockIdx.x * D;

  // float64 sums of float32 terms, each product exact: r * r and d * d
  // have at most 48 significant bits
  double s = 0.0;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float r = __fadd_rn(to_f(x[off + i]), to_f(res[off + i]));
    row[i] = r;
    store(rn + off + i, r);
    s = rms ? __dadd_rn(s, __dmul_rn(r, r)) : __dadd_rn(s, (double)r);
  }
  s = block_reduce<false>(s, red);
  float mu = 0.0f, var;
  if (rms) {
    var = __double2float_rn(__ddiv_rn(s, (double)D));
  } else {
    mu = __double2float_rn(__ddiv_rn(s, (double)D));
    double s2 = 0.0;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float d = __fsub_rn(row[i], mu);
      s2 = __dadd_rn(s2, __dmul_rn(d, d));
    }
    var = __double2float_rn(__ddiv_rn(block_reduce<false>(s2, red),
                                      (double)D));
  }
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  float amax = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float c = rms ? row[i] : __fsub_rn(row[i], mu);
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(c, rstd), w[i]), b[i]);
    row[i] = v;  // each thread rereads only its own columns
    y[off + i] = __float2bfloat16_rn(v);
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_reduce<true>(amax, redf);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(row[i], sc)), -127.0f),
                          127.0f);
    yq[off + i] = (int8_t)q;
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = sc;
}

template <typename TX, typename TR>
int launch(const void* x, const void* res, const void* w, const void* b,
           void* y, void* rn, void* yq, void* scale, int B, int D, int rms,
           float eps, void* stream) {
  const size_t smem = (size_t)D * sizeof(float);
  auto kernel = ln_res_kernel<TX, TR>;
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const TX*)x, (const TR*)res, (const float*)w, (const float*)b,
      (__nv_bfloat16*)y, (TR*)rn, (int8_t*)yq, (float*)scale, D, rms, eps);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_res(const void* x, const void* res, const void* w, const void* b,
               void* y, void* rn, void* yq, void* scale, int res_bf16, int B,
               int D, int rms, float eps, void* stream) {
  if (res_bf16)
    return launch<TX, __nv_bfloat16>(x, res, w, b, y, rn, yq, scale, B, D,
                                     rms, eps, stream);
  return launch<TX, float>(x, res, w, b, y, rn, yq, scale, B, D, rms, eps,
                           stream);
}

}  // namespace

// x, res: (B, D) rows, bf16 when x_bf16 / res_bf16 is 1, else float32.
// w, b: (D,) float32.  Outputs: y (B, D) bf16, rn (B, D) in the residual's
// dtype, yq (B, D) int8, scale (B,) float32.  rms: 0 -> LayerNorm, 1 ->
// RMSNorm.  Returns cudaGetLastError() (or the attribute call's error).
extern "C" int ln_res(const void* x, const void* res, const void* w,
                      const void* b, void* y, void* rn, void* yq, void* scale,
                      int x_bf16, int res_bf16, int B, int D, int rms,
                      float eps, void* stream) {
  if (x_bf16)
    return launch_res<__nv_bfloat16>(x, res, w, b, y, rn, yq, scale,
                                     res_bf16, B, D, rms, eps, stream);
  return launch_res<float>(x, res, w, b, y, rn, yq, scale, res_bf16, B, D,
                           rms, eps, stream);
}
