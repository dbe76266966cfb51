// The MoE FFN's experts over the routed rows alone: a grouped product of
// the choices sorted by expert, with the gated activation in the epilogue
// of its first half.
//
// Replaces no TPU kernel: the JAX package runs the experts as a padded
// batched einsum over an (E, C, d) dispatch buffer (src/repro/models/
// moe.py), and the port ran it as a zero-filled scatter, three torch.bmm
// calls over (E, T k, .) and about eight elementwise passes of the SwiGLU
// over the padded buffers.  At exact capacity (C = T k) every expert was
// padded to T k rows: at a 32-token decode step each of 64 experts holds
// about 4 routed rows of its 256, so 64 times the needed work went through
// the banks and, far worse, through the elementwise flood.
//
// Computes, for the choices sorted by expert (order: the flat choice at
// each sorted position; offsets (E + 1): each expert's first sorted
// position), at the rounding points of models/moe.py:
//   a = bf16(x[order[p] / k])                      (the routed row)
//   h[p] = bf16(act(bf16(a W_gate[e])) * bf16(a W_up[e]))
//   y[p] = bf16(h[p] W_down[e])
// for every sorted position p of expert e, each product accumulated in
// float32.  act is layers.silu's steps (flush to zero below 2^-126, round
// to bf16 after each operation, IEEE division, expf) or layers.gelu_tanh's
// (each operation rounded to bf16); its product with the up projection is
// rounded once.  Each sum walks K in order, k16 MMA step by step, as
// cuBLAS's bf16 products do when they do not split K: on an H100 the
// outputs equal the padded bmm's and a per-expert loop of cuBLAS products
// bit for bit (T 32 and 256 at OLMoE-1B-7B's widths).  The CPU's products
// sum in another order.
//
// What bounds it on the H100: bytes.  Each touched expert's three banks are
// read once (6 MB per expert of OLMoE-1B-7B: d 2,048, f 1,024, bf16); the
// products need 2 T k d f operations each.  At a 32-token step that is about
// 40 operations per byte, far under the ~295 where the tensor cores would
// bound it, so the time is the touched banks' bytes over 3.35 TB/s (about
// 0.24 ms a layer when 63 of 64 experts are touched).
//
// Design:
//   * Two launches on the caller's stream: the gate and up products with
//     the activation (K = d, N = f, writing h (T k, f) in sorted order), then
//     the down product (K = f, N = d, writing y (T k, d) in sorted order).
//     The combine reads y at each choice's sorted position.  No dispatch
//     buffer: the first launch reads its rows straight from x through
//     order / k and rounds them to bf16 as it builds its MMA fragments.
//   * Grid: (N / BN column tiles, m-tiles).  The m-tiles are an upper bound
//     from the shapes alone, floor((T k + (BM - 1) min(E, T k)) / BM): each
//     block reads the E + 1 offsets, finds its (expert, row tile) by a warp
//     prefix sum of the experts' tile counts, and returns when it has none.
//     Nothing waits for the host.  BM = 16 MT rows; the wrapper takes
//     MT = 2 when the experts hold 32 rows or more on average (a long
//     prefill), else 1, from T k / E.
//   * mma.sync m16n8k16 (bf16 in, float32 out), the tokens as the MMA's
//     rows: at a decode step an expert's ~4 rows would leave wgmma's 64-row
//     tile mostly empty, and the operations are not the bound.
//   * Each block walks K in order through a ring of STAGES stages of KT = 64
//     rows, filled by all its threads with 16-byte cp.async copies (the
//     rows of x or h, and 128-byte rows of each bank: BN = 64 columns), one
//     block barrier a stage; ~70 KB per block and two or more blocks per SM
//     are in flight.  Each of the 4 warps owns 16 of the block's columns, so
//     every output is one float32 accumulator that takes its k16 MMA steps
//     in K order.  (Splitting K over the warps and adding their partials,
//     an earlier design, was 5% faster at T 32 but left about 3% of
//     outputs one bf16 place from cuBLAS's, and over 16 layers the served
//     tokens drifted from a reference computed with cuBLAS: the OLMoE
//     cell's mean gap read 0.0021 against a limit of 0.00105.)  Weight
//     tiles are (K, N)
//     row-major; ldmatrix.trans makes their column fragments.  The epilogue
//     runs on the accumulators in registers and stores bf16 pairs.  An
//     expert with several row tiles reads its banks once per tile; its
//     tiles run side by side and meet in L2.
//   * K and N edges are masked in 16-byte chunks (K, N multiples of 8);
//     rows past the expert's end are zero-filled and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 64;          // output columns per block
constexpr int WN = BN / WARPS;  // a warp's columns: two n8 MMA tiles
constexpr int KT = 64;          // K rows per stage: four k16 MMA steps
constexpr int STAGES = 4;       // stages in the block's ring
constexpr int AP = KT + 8;      // elements between staged rows of A
constexpr int BP = BN + 8;      // bf16 elements between staged bank rows

enum Act { SILU = 0, GELU_TANH = 1 };

// Bytes of one stage: BM rows of A and NB bank tiles of KT x BN.
template <int MT, int NB, typename TA>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)16 * MT * AP * sizeof(TA) +
         (size_t)NB * KT * BP * sizeof(__nv_bfloat16);
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

// Two consecutive elements of a staged A row as one bf16x2 MMA register,
// rounded to bf16 on the way from float32.
__device__ __forceinline__ uint32_t a_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t a_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// layers._ftz: a subnormal becomes a zero of its own sign
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435082228751e-38f ? copysignf(0.0f, v) : v;
}
// layers.silu on a bf16 value: x * (1 / (exp(-x) + 1)), every result
// flushed to zero below 2^-126 and rounded to bf16
__device__ __forceinline__ float silu_steps(float x) {
  const float xf = ftz(x);
  const float e = bf16r(ftz(expf(bf16r(ftz(-xf)))));
  const float s = bf16r(ftz(__fadd_rn(e, 1.0f)));
  const float r = bf16r(ftz(__fdiv_rn(1.0f, s)));
  return bf16r(ftz(__fmul_rn(xf, r)));
}
// layers.gelu_tanh on a bf16 value: x * (0.5 * (1 + tanh(c * (x + a x^3))))
// with c and a rounded to bf16 first, every operation rounded to bf16
__device__ __forceinline__ float gelu_tanh_steps(float x) {
  const float c = 0.796875f, a = 0.044677734375f;
  const float x3 = bf16r(__fmul_rn(bf16r(__fmul_rn(x, x)), x));
  const float in =
      bf16r(__fmul_rn(c, bf16r(__fadd_rn(x, bf16r(__fmul_rn(a, x3))))));
  const float t = bf16r(tanhf(in));
  return bf16r(__fmul_rn(x, bf16r(__fmul_rn(0.5f, bf16r(__fadd_rn(1.0f, t))))));
}

// One block: BN columns of NB banks (2: gate and up, with the activation;
// 1: down) for one row tile of one expert.
//   A: rows of TA, row order[p] / k of `a` when `order` is given (the
//      first launch, a = x (T, K)), else row p (the second, a = h (Tk, K));
//   w0, w1: banks (E, K, N) bf16; out (Tk, N) bf16.
template <int MT, int NB, typename TA, int ACT>
__global__ void __launch_bounds__(THREADS)
experts_kernel(const TA* __restrict__ a, const int64_t* __restrict__ order,
               const int* __restrict__ offsets,
               const __nv_bfloat16* __restrict__ w0,
               const __nv_bfloat16* __restrict__ w1,
               __nv_bfloat16* __restrict__ out, int K, int N, int E, int k) {
  constexpr int BM = 16 * MT;
  constexpr int A_STAGE = BM * AP;  // TA elements
  constexpr size_t STAGE_BYTES = stage_bytes<MT, NB, TA>();
  constexpr int CA = KT * (int)sizeof(TA) / 16;  // 16-byte chunks a row
  constexpr int EA = 16 / (int)sizeof(TA);       // elements a chunk
  constexpr int A_CHUNKS = BM * CA / THREADS;    // a thread's, per stage
  constexpr int B_CHUNKS = KT * (BN / 8) / THREADS;
  static_assert(A_CHUNKS * THREADS == BM * CA &&
                    B_CHUNKS * THREADS == KT * (BN / 8),
                "every thread stages whole chunks of A and of each bank");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN;

  // this block's (expert, first row): the experts' row tiles in order
  int e = -1, m0 = 0;
  {
    int before = 0;  // tiles of the experts already passed
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int ee = e0 + lane;
      const int rows = ee < E ? offsets[ee + 1] - offsets[ee] : 0;
      const int t = (rows + BM - 1) / BM;
      int inc = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int y = (int)blockIdx.y - before;
      const unsigned hit =
          __ballot_sync(0xffffffffu, y >= inc - t && y < inc);
      if (hit) {
        const int src = __ffs(hit) - 1;
        e = e0 + src;
        m0 = (y - __shfl_sync(0xffffffffu, inc - t, src)) * BM;
        break;
      }
      before += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  if (e < 0) return;  // every warp finds the same: no tile for this block
  const int row0 = offsets[e] + m0;
  const int rows = min(BM, offsets[e + 1] - row0);

  // this thread's A chunks: chunk c = tid + THREADS j is row c / CA, part
  // c % CA of the stage
  const TA* a_row[A_CHUNKS];
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    const int r = (tid + THREADS * j) / CA;
    a_row[j] = nullptr;
    if (r < rows) {
      const int64_t p = row0 + r;
      a_row[j] = a + (size_t)(order ? order[p] / k : p) * K;
    }
  }
  const __nv_bfloat16* wb[2] = {w0 + (size_t)e * K * N,
                                NB > 1 ? w1 + (size_t)e * K * N : nullptr};

  // stage s (K rows KT s .. KT s + KT - 1) into slot st
  auto issue = [&](int s, int st) {
    TA* sa = reinterpret_cast<TA*>(smem + st * STAGE_BYTES);
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sa + A_STAGE);
    const int k0 = s * KT;
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int c = tid + THREADS * j, r = c / CA, part = c % CA;
      const int col = k0 + part * EA;
      const bool in = a_row[j] != nullptr && col < K;
      cp_async16(sa + r * AP + part * EA, in ? a_row[j] + col : a, in);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < B_CHUNKS; ++j) {
        const int c = tid + THREADS * j, r = c / (BN / 8),
                  part = c % (BN / 8);
        const int kr = k0 + r, col = n0 + 8 * part;
        const bool in = kr < K && col < N;
        cp_async16(sb + (b * KT + r) * BP + 8 * part,
                   in ? wb[b] + (size_t)kr * N + col : wb[0], in);
      }
  };

  const int n_stages = (K + KT - 1) / KT;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages) issue(st, st);
    cp_async_commit();
  }

  float acc[NB][MT][2][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[b][m][n][0] = acc[b][m][n][1] = acc[b][m][n][2] =
            acc[b][m][n][3] = 0.0f;

  const int g = lane >> 2, t4 = lane & 3;   // fragment row and pair
  const int mi = lane >> 3, rr = lane & 7;  // ldmatrix row-address roles
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with s - 1
    const int sn = s + STAGES - 1;
    if (sn < n_stages) issue(sn, sn % STAGES);
    cp_async_commit();

    const TA* sa =
        reinterpret_cast<const TA*>(smem + (s % STAGES) * STAGE_BYTES);
    const __nv_bfloat16* sb =
        reinterpret_cast<const __nv_bfloat16*>(sa + A_STAGE);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const TA* r0 = sa + (16 * m + g) * AP + 16 * kk + 2 * t4;
        af[m][0] = a_pair(r0);
        af[m][1] = a_pair(r0 + 8 * AP);
        af[m][2] = a_pair(r0 + 8);
        af[m][3] = a_pair(r0 + 8 * AP + 8);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint32_t vb[4];  // K 0-7 / 8-15 x the warp's columns 0-7 / 8-15
        ldsm_x4_trans(vb, sb + (b * KT + 16 * kk + (mi & 1) * 8 + rr) * BP +
                              WN * warp + (mi >> 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[b][m][0], af[m], vb[0], vb[1]);
          mma(acc[b][m][1], af[m], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the epilogue on the accumulators: rows 16 m + g (+ 8), columns
  // n0 + WN warp + 8 n + 2 t4 (+ 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * m + g + 8 * half;
        const int col = n0 + WN * warp + 8 * n + 2 * t4;
        if (r >= rows || col >= N) continue;
        float o[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = bf16r(acc[0][m][n][2 * half + i]);
          if constexpr (NB == 2) {
            const float act = ACT == SILU ? silu_steps(v) : gelu_tanh_steps(v);
            o[i] = __fmul_rn(act, bf16r(acc[1][m][n][2 * half + i]));
          } else {
            o[i] = v;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N +
                                           col) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
}

template <int MT, int NB, typename TA, int ACT>
cudaError_t launch(const TA* a, const int64_t* order, const int* offsets,
                   const void* w0, const void* w1, void* out, int K, int N,
                   int E, int k, int m_tiles, cudaStream_t stream) {
  constexpr size_t smem = STAGES * stage_bytes<MT, NB, TA>();
  auto kernel = experts_kernel<MT, NB, TA, ACT>;
  static bool attributed = false;  // once per kernel and process
  if (!attributed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attributed = true;
  }
  const dim3 grid((N + BN - 1) / BN, m_tiles);
  kernel<<<grid, THREADS, smem, stream>>>(
      a, order, offsets, static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<__nv_bfloat16*>(out), K, N, E, k);
  return cudaGetLastError();
}

template <int MT, typename TX, int ACT>
int run(const void* x, const int64_t* order, const int* offsets,
        const void* w_gate, const void* w_up, const void* w_down, void* h,
        void* y, int d, int f, int E, int k, int m_tiles,
        cudaStream_t stream) {
  cudaError_t err = launch<MT, 2, TX, ACT>(
      static_cast<const TX*>(x), order, offsets, w_gate, w_up, h, d, f, E, k,
      m_tiles, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch<MT, 1, __nv_bfloat16, SILU>(
      static_cast<const __nv_bfloat16*>(h), nullptr, offsets, w_down,
      nullptr, y, f, d, E, k, m_tiles, stream);
  return (int)err;
}

template <int MT>
int run_mt(const void* x, const int64_t* order, const int* offsets,
           const void* w_gate, const void* w_up, const void* w_down, void* h,
           void* y, int d, int f, int E, int k, int x_bf16, int act,
           int m_tiles, cudaStream_t stream) {
  if (x_bf16)
    return act == GELU_TANH
               ? run<MT, __nv_bfloat16, GELU_TANH>(x, order, offsets, w_gate,
                                                   w_up, w_down, h, y, d, f,
                                                   E, k, m_tiles, stream)
               : run<MT, __nv_bfloat16, SILU>(x, order, offsets, w_gate,
                                              w_up, w_down, h, y, d, f, E, k,
                                              m_tiles, stream);
  return act == GELU_TANH
             ? run<MT, float, GELU_TANH>(x, order, offsets, w_gate, w_up,
                                         w_down, h, y, d, f, E, k, m_tiles,
                                         stream)
             : run<MT, float, SILU>(x, order, offsets, w_gate, w_up, w_down,
                                    h, y, d, f, E, k, m_tiles, stream);
}

}  // namespace

// x: (T, d) the routed tokens, bf16 when x_bf16 is 1, else float32;
// order: (T k,) int64, the flat choice at each sorted position; offsets:
// (E + 1,) int32, each expert's first sorted position (offsets[E] = T k);
// w_gate, w_up: (E, d, f) bf16; w_down: (E, f, d) bf16.  Outputs: h (T k,
// f) bf16 scratch, y (T k, d) bf16, both in sorted order.  act: 0 SiLU
// (swiglu), 1 tanh GELU (geglu).  mt: m16 row tiles a block (1 or 2);
// m_tiles: the grid's row-tile bound.  d and f multiples of 8, every
// pointer 16-byte aligned.  Launches the two kernels and returns
// cudaGetLastError().
extern "C" int moe_experts(const void* x, const void* order,
                           const void* offsets, const void* w_gate,
                           const void* w_up, const void* w_down, void* h,
                           void* y, int T, int d, int f, int E, int k,
                           int x_bf16, int act, int mt, int m_tiles,
                           void* stream) {
  if (d % 8 != 0 || f % 8 != 0 || T <= 0 || m_tiles <= 0 ||
      (act != SILU && act != GELU_TANH))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* ord = static_cast<const int64_t*>(order);
  const int* off = static_cast<const int*>(offsets);
  switch (mt) {
    case 1:
      return run_mt<1>(x, ord, off, w_gate, w_up, w_down, h, y, d, f, E, k,
                       x_bf16, act, m_tiles, st);
    case 2:
      return run_mt<2>(x, ord, off, w_gate, w_up, w_down, h, y, d, f, E, k,
                       x_bf16, act, m_tiles, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
