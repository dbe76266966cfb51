// Residual add, LayerNorm or RMSNorm, scale and shift, then per-token
// symmetric int8 quantisation, in one pass: the paper's Fused LN&Res kernel.
//
// Replaces: src/repro/kernels/ln_res_kernel.py:64 :: ln_res (_ln_res_kernel
// :29), the Pallas TPU kernel behind repro.kernels.ops.ln_res, reached (as
// in the JAX package) only through core/mdk.MDK_REGISTRY["ln_res"].
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
// B 8 x D 1024 that is 131 KB, 0.04 us at 3.35 TB/s, so the call's time is
// its launch and the chain of dependent steps inside one row's threads:
// two trips to memory and three reductions.
//
// Design: one block of 256 threads per row, the row in registers, read
// once and never staged.  Each thread holds NV chunks of 8 consecutive
// columns, chunk i of thread t at column (i * 256 + t) * 8, NV the fewest
// power of two that covers the row (1 up to 2,048 columns, at most 8, so
// up to 16,384 columns); x, res, w and b are loaded together as 16-byte
// vectors (two for a float32 chunk, one for bf16, 8 bytes for the int8
// output) when D is a multiple of 8 and every pointer 16-byte aligned
// (VEC), else element by element, so the row costs one trip to memory
// before its stores.  A ragged D is masked by the column bound, never
// padded.  The float64 sums run a chain per chunk, then over the chunks.
// Each of the three reductions (the sum, the squared deviation, the
// absolute maximum) is a butterfly of shuffles in every warp, then one
// barrier and a sum over the 8 warps' results in warp order from its own
// 8-entry shared buffer.  A warp per row (4 chunks a lane at D 1024)
// measured slower than a block per row at 8, 32 and 256 rows on the H100:
// the serial work on a lane's 32 values (float64 sums, IEEE divisions)
// outlasts the block's barriers.
// Every reduction has a fixed order, so a row gives the same bits on every
// launch.  x and res may be bf16 or float32 each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

constexpr int THREADS = 256;  // per row (one block)
constexpr int NW = THREADS / 32;

// 8 columns from `col` (masked by D unless VEC) as float32
template <bool VEC>
__device__ __forceinline__ void load8(const float* p, int col, int D,
                                      float* f) {
  if (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(p + col);
    const float4 b = *reinterpret_cast<const float4*>(p + col + 4);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = col + e < D ? p[col + e] : 0.0f;
  }
}
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int col, int D,
                                      float* f) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + col);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = col + e < D ? __bfloat162float(p[col + e]) : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* p, int col, int D,
                                       const float* f) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + col) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + col + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < D) p[col + e] = f[e];
  }
}
template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int col, int D,
                                       const float* f) {
  if (VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __halves2bfloat162(__float2bfloat16_rn(f[2 * i]),
                                __float2bfloat16_rn(f[2 * i + 1]));
    *reinterpret_cast<uint4*>(p + col) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < D) p[col + e] = __float2bfloat16_rn(f[e]);
  }
}
template <bool VEC>
__device__ __forceinline__ void store8(int8_t* p, int col, int D,
                                       const float* f) {
  if (VEC) {
    uint2 u;
    int8_t* c = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = (int8_t)f[e];
    *reinterpret_cast<uint2*>(p + col) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < D) p[col + e] = (int8_t)f[e];
  }
}

// One block per row, NV chunks of 8 columns per thread.
template <int NV, bool VEC, typename TX, typename TR>
__global__ void __launch_bounds__(THREADS)
ln_res_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
              const float* __restrict__ w, const float* __restrict__ b,
              __nv_bfloat16* __restrict__ y, TR* __restrict__ rn,
              int8_t* __restrict__ yq, float* __restrict__ scale, int D,
              int rms, float eps) {
  __shared__ double red_s[NW], red_v[NW];
  __shared__ float red_m[NW];
  const int t = threadIdx.x;
  const int row = blockIdx.x;
  const size_t off = (size_t)row * D;

  float r[NV][8], wf[NV][8], bf[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * THREADS + t) * 8;
    float a[8] = {}, c[8] = {};
    if (col < D) {
      load8<VEC>(x + off, col, D, a);
      load8<VEC>(res + off, col, D, c);
      load8<VEC>(w, col, D, wf[i]);
      load8<VEC>(b, col, D, bf[i]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) r[i][e] = __fadd_rn(a[e], c[e]);
  }
  // float64 sums of float32 terms, each product exact (r * r and d * d
  // have at most 48 significant bits): a chain per chunk, then the chunks
  // in order
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * THREADS + t) * 8;
    if (col >= D) continue;
    store8<VEC>(rn + off, col, D, r[i]);
    double cs = 0.0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < D)
        cs = rms ? __dadd_rn(cs, __dmul_rn(r[i][e], r[i][e]))
                 : __dadd_rn(cs, (double)r[i][e]);
    s = __dadd_rn(s, cs);
  }
  s = row_reduce<false>(s, red_s, NW);
  float mu = 0.0f, var;
  if (rms) {
    var = __double2float_rn(__ddiv_rn(s, (double)D));
  } else {
    mu = __double2float_rn(__ddiv_rn(s, (double)D));
    double s2 = 0.0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * THREADS + t) * 8;
      double cs = 0.0;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < D) {
          const float d = __fsub_rn(r[i][e], mu);
          cs = __dadd_rn(cs, __dmul_rn(d, d));
        }
      s2 = __dadd_rn(s2, cs);
    }
    var = __double2float_rn(
        __ddiv_rn(row_reduce<false>(s2, red_v, NW), (double)D));
  }
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  // y, kept in place of r
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * THREADS + t) * 8;
    if (col >= D) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = rms ? r[i][e] : __fsub_rn(r[i][e], mu);
      const float v =
          __fadd_rn(__fmul_rn(__fmul_rn(c, rstd), wf[i][e]), bf[i][e]);
      r[i][e] = v;
      if (col + e < D) amax = fmaxf(amax, fabsf(v));
    }
    store8<VEC>(y + off, col, D, r[i]);
  }
  amax = row_reduce<true>(amax, red_m, NW);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * THREADS + t) * 8;
    if (col >= D) continue;
    float qf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[e] = fminf(fmaxf(rintf(__fdiv_rn(r[i][e], sc)), -127.0f), 127.0f);
    store8<VEC>(yq + off, col, D, qf);
  }
  if (t == 0) scale[row] = sc;
}

struct Args {
  const void *x, *res, *w, *b;
  void *y, *rn, *yq, *scale;
  int B, D, rms;
  float eps;
  cudaStream_t stream;
};

template <int NV, bool VEC, typename TX, typename TR>
int launch(const Args& a) {
  ln_res_kernel<NV, VEC, TX, TR><<<a.B, THREADS, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TR*>(a.res),
      static_cast<const float*>(a.w), static_cast<const float*>(a.b),
      static_cast<__nv_bfloat16*>(a.y), static_cast<TR*>(a.rn),
      static_cast<int8_t*>(a.yq), static_cast<float*>(a.scale), a.D, a.rms,
      a.eps);
  return (int)cudaGetLastError();
}

template <bool VEC, typename TX, typename TR>
int launch_nv(const Args& a, int nv) {
  switch (nv) {
    case 1: return launch<1, VEC, TX, TR>(a);
    case 2: return launch<2, VEC, TX, TR>(a);
    case 4: return launch<4, VEC, TX, TR>(a);
    case 8: return launch<8, VEC, TX, TR>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, typename TR>
int launch_vec(const Args& a, int nv, int vec) {
  return vec ? launch_nv<true, TX, TR>(a, nv) : launch_nv<false, TX, TR>(a, nv);
}

template <typename TX>
int launch_res(const Args& a, int res_bf16, int nv, int vec) {
  return res_bf16 ? launch_vec<TX, __nv_bfloat16>(a, nv, vec)
                  : launch_vec<TX, float>(a, nv, vec);
}

}  // namespace

// x, res: (B, D) rows, bf16 when x_bf16 / res_bf16 is 1, else float32.
// w, b: (D,) float32.  Outputs: y (B, D) bf16, rn (B, D) in the residual's
// dtype, yq (B, D) int8, scale (B,) float32.  rms: 0 -> LayerNorm, 1 ->
// RMSNorm.  nv: 8-column chunks per thread (1, 2, 4 or 8), vec 1 for
// 16-byte accesses (D % 8 == 0, every pointer 16-byte aligned).
// Returns cudaGetLastError().
extern "C" int ln_res(const void* x, const void* res, const void* w,
                      const void* b, void* y, void* rn, void* yq, void* scale,
                      int x_bf16, int res_bf16, int B, int D, int rms,
                      float eps, int nv, int vec, void* stream) {
  if (vec && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const Args a{x, res, w, b, y, rn, yq, scale, B, D, rms, eps,
               static_cast<cudaStream_t>(stream)};
  if (x_bf16)
    return launch_res<__nv_bfloat16>(a, res_bf16, nv, vec);
  return launch_res<float>(a, res_bf16, nv, vec);
}
