// A reduction over one block's threads, shared by the row kernels
// (ln_res.cu, quant_act.cu).
#pragma once

#include <cuda_runtime.h>

// Sum (or maximum) over the block's threads; every thread gets the same
// bits.  A warp's butterfly is exact in its order (each add is
// commutative), then the `nw` warps in warp order from `red` (nw entries
// of its own, so one barrier suffices).  The block's width is a multiple
// of 32.
template <bool MAX, typename T>
__device__ __forceinline__ T row_reduce(T v, T* red, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? (v > u ? v : u) : v + u;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < nw; ++w) v = MAX ? (v > red[w] ? v : red[w]) : v + red[w];
  return v;
}
