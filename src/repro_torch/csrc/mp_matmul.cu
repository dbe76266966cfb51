// W8A8 GEMM with its dequantisation epilogue: the paper's Fused MP kernel on
// Hopper, as two launches (the int32 GEMM over K slices, then the epilogue).
//
// Replaces: src/repro/kernels/mp_kernel.py :: mp_matmul (_mp_kernel), the
// Pallas TPU kernel behind repro.kernels.ops.quant_matmul.
//
// Computes  y[m, n] = (sum_k x_q[m, k] * w_q[k, n]) * x_scale[m] * w_scale[n]
//                     + bias[n]
// with int8 x int8 products accumulated exactly in int32, then the epilogue
// in float32 in the reference's order ((acc * x_scale) * w_scale) + bias,
// written as float32 or bfloat16.  The multiplies and the add are issued
// with round-to-nearest intrinsics so the compiler cannot contract them into
// an FMA: the result is bit-identical to the plain version.
//
// What bounds it on the H100: bytes.  On the serving path M is the slot
// count (1-8) on a decode tick or the chunk size (32) on a prefill chunk,
// while K x N is 1024 x 1024 .. 4096 x 1024, so the int8 weight read
// (1-4 MB per call) dwarfs the 2*M*K*N integer operations: at M = 32 there
// are 64 operations per weight byte against the ~590 the int8 tensor cores
// need to be the limit.
//
// Design: each block owns a 64-column strip of the output, BM rows (BM = 8
// when M <= 8, so a decode tick wastes no rows; BM = 32 otherwise) and one
// slice of K, and streams its weight strip once through shared memory, 128
// K-rows at a time.  A GPT-2 layer has only 16-64 such strips, so K is
// split across blocks until the grid holds about two blocks per SM: each
// split writes its exact int32 partial sums to a workspace, and a second
// kernel adds the splits in order and applies the epilogue (integer sums
// are exact in any order, so the split changes no bit of the result).
// Every call takes this path, one split or many: the serving shapes always
// split, so a fused one-split epilogue would be code no caller runs.  Weights
// arrive row-major (K, N); each thread loads a 4 x 4 byte block (four
// K-rows of four columns, 32-bit loads that neighbouring threads issue on
// neighbouring addresses) and transposes it in registers with __byte_perm
// into four words of four consecutive K values, the operand layout __dp4a
// wants.  Activations are K-contiguous already.  The inner loop is one
// __dp4a per (row, word).  Ragged M, N and K edges are masked here
// (zero-filled), and an unaligned or non-multiple-of-4 row falls back to
// byte loads, so the caller pads nothing.  Tensor-core MMA and TMA
// pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 128;       // K rows per shared-memory tile
constexpr int KW = BK / 4;    // packed 4-byte words per tile row
constexpr int THREADS = 128;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four bytes w[k][n..n+3] as one little-endian word, zero past the edges.
__device__ __forceinline__ uint32_t load_w_row(const int8_t* __restrict__ w,
                                               int k, int n, int K, int N,
                                               bool vec) {
  if (k >= K) return 0u;
  const int8_t* row = w + (size_t)k * N;
  if (vec && n + 3 < N) return *reinterpret_cast<const uint32_t*>(row + n);
  uint32_t v = 0u;
  for (int i = 0; i < 4; ++i)
    if (n + i < N) v |= (uint32_t)(uint8_t)row[n + i] << (8 * i);
  return v;
}

// Four bytes x[m][k..k+3] of a row of K as one little-endian word, zero at
// and past k_end.
__device__ __forceinline__ uint32_t load_x_word(const int8_t* __restrict__ x,
                                                int m, int k, int M, int K,
                                                int k_end, bool vec) {
  if (m >= M) return 0u;
  const int8_t* row = x + (size_t)m * K;
  if (vec && k + 3 < k_end) return *reinterpret_cast<const uint32_t*>(row + k);
  uint32_t v = 0u;
  for (int i = 0; i < 4; ++i)
    if (k + i < k_end) v |= (uint32_t)(uint8_t)row[k + i] << (8 * i);
  return v;
}

// The epilogue in the reference's order: ((acc * x_scale) * w_scale) + bias,
// each step rounded to nearest so that no FMA contraction changes a bit.
__device__ __forceinline__ float dequant(int acc, float xsm, float wsn,
                                         float bn) {
  const float v = __fmul_rn(__int2float_rn(acc), xsm);
  return __fadd_rn(__fmul_rn(v, wsn), bn);
}

// The int32 partial sums of this block's K slice, written to part
// (splits, M, N).
template <int BM>
__global__ void __launch_bounds__(THREADS)
mp_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int* __restrict__ part, int M, int N, int K,
                 int k_per_split) {
  constexpr int RPT = BM / 2;  // output rows per thread
  __shared__ uint32_t sx[BM][KW];
  __shared__ uint32_t sw[KW][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // compute mapping: one output column per thread, every other row
  const int col = tid % BN;
  const int rsub = tid / BN;  // 0 or 1
  // weight-load mapping: 16 column groups of 4 x 8 K-row groups of 4
  const int cg = tid % (BN / 4);
  const int kg = tid / (BN / 4);
  const bool vec_w = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  const bool vec_x = (K % 4 == 0) && ((uintptr_t)x % 4 == 0);

  int acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // weight tile: BK x BN bytes as KW x BN packed words
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int kw = kg + 8 * j;
      const int k = k0 + 4 * kw;
      const int n = n0 + 4 * cg;
      const uint32_t r0 = load_w_row(w, k + 0, n, k_end, N, vec_w);
      const uint32_t r1 = load_w_row(w, k + 1, n, k_end, N, vec_w);
      const uint32_t r2 = load_w_row(w, k + 2, n, k_end, N, vec_w);
      const uint32_t r3 = load_w_row(w, k + 3, n, k_end, N, vec_w);
      // 4 x 4 byte transpose: word c = (r0[c], r1[c], r2[c], r3[c])
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      sw[kw][4 * cg + 0] = __byte_perm(lo01, lo23, 0x5410);
      sw[kw][4 * cg + 1] = __byte_perm(lo01, lo23, 0x7632);
      sw[kw][4 * cg + 2] = __byte_perm(hi01, hi23, 0x5410);
      sw[kw][4 * cg + 3] = __byte_perm(hi01, hi23, 0x7632);
    }
    // activation tile: BM x BK bytes as BM x KW words
    for (int i = tid; i < BM * KW; i += THREADS) {
      const int m = i / KW, kw = i % KW;
      sx[m][kw] = load_x_word(x, m0 + m, k0 + 4 * kw, M, K, k_end, vec_x);
    }
    __syncthreads();
#pragma unroll 8
    for (int kw = 0; kw < KW; ++kw) {
      const int b = (int)sw[kw][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = __dp4a((int)sx[rsub + 2 * i][kw], b, acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + col;
  if (n >= N) return;
  int* dst = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + rsub + 2 * i;
    if (m < M) dst[(size_t)m * N + n] = acc[i];
  }
}

// Sum the splits' int32 partials in order and apply the epilogue.
template <typename OutT>
__global__ void __launch_bounds__(256)
mp_splitk_epilogue(const int* __restrict__ part, const float* __restrict__ xs,
                   const float* __restrict__ ws,
                   const float* __restrict__ bias, OutT* __restrict__ y, int M,
                   int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  const int m = (int)(i / N), n = (int)(i % N);
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += part[s * MN + i];
  const float bn = bias != nullptr ? bias[n] : 0.0f;
  store_out(y + i, dequant(acc, xs[m], ws[n], bn));
}

template <int BM, typename OutT>
void launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
            const float* bias, OutT* y, int* part, int M, int N, int K,
            int splits, cudaStream_t stream) {
  // whole BK tiles per split keep every slice 4-byte aligned; a split
  // past K finds no tile and writes zeros
  const int k_tiles = (K + BK - 1) / BK;
  const int k_per_split = (k_tiles + splits - 1) / splits * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  mp_matmul_kernel<BM><<<grid, THREADS, 0, stream>>>(x, w, part, M, N, K,
                                                      k_per_split);
  const size_t MN = (size_t)M * N;
  mp_splitk_epilogue<OutT><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, xs, ws, bias, y, M, N, splits);
}

template <typename OutT>
void dispatch(const void* x, const void* w, const void* xs, const void* ws,
              const void* bias, void* y, void* part, int M, int N, int K,
              int splits, cudaStream_t stream) {
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  OutT* yo = static_cast<OutT*>(y);
  int* p = static_cast<int*>(part);
  if (M <= 8)
    launch<8, OutT>(xq, wq, xsf, wsf, bf, yo, p, M, N, K, splits, stream);
  else
    launch<32, OutT>(xq, wq, xsf, wsf, bf, yo, p, M, N, K, splits, stream);
}

}  // namespace

// out_bf16: 0 -> float32 output, 1 -> bfloat16 output.  bias may be null.
// splits: the number of K slices (the wrapper picks it); part is an int32
// workspace of splits * M * N.  Launches mp_matmul_kernel, then
// mp_splitk_epilogue; returns cudaGetLastError() after both.
extern "C" int mp_matmul(const void* x_q, const void* w_q, const void* x_scale,
                         const void* w_scale, const void* bias, void* y,
                         void* part, int M, int N, int K, int splits,
                         int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dispatch<__nv_bfloat16>(x_q, w_q, x_scale, w_scale, bias, y, part, M, N,
                            K, splits, s);
  else
    dispatch<float>(x_q, w_q, x_scale, w_scale, bias, y, part, M, N, K,
                    splits, s);
  return static_cast<int>(cudaGetLastError());
}
