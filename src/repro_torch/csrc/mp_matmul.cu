// W8A8 GEMM with its dequantisation epilogue: the paper's Fused MP kernel on
// Hopper, in one launch on the int8 tensor cores.
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
// count (1-8) on a decode tick, the chunk size (32) on a prefill chunk, or
// 40 / 72 on a speculative verify, while K x N is 1024 x 1024 .. 4096 x 1024,
// so the int8 weight read (1-4 MB per call) dwarfs the 2*M*K*N integer
// operations.  At 1-4 MB a call is over in a few microseconds, so what
// matters is how many weight bytes are in flight at once, and that nothing
// but the weights waits on memory.
//
// Design:
//   * Swapped operands on mma.sync.m16n8k32 (s8 x s8 -> s32).  The weights'
//     output columns are the MMA's 16 rows and the tokens its 8 columns, so
//     a decode tick's 8 tokens fill one n8 tile and M 32 / 40 / 72 take 4 / 5
//     / 9 of them; a block holds BM = 8 * MT tokens (MT 1, 2, 4 or 8) and
//     skips the tiles past M.
//   * The grid is (K split, 64-column strip, BM-token block).  The K splits
//     of one strip form a thread-block cluster (1, 2, 4 or 8 blocks; the
//     wrapper's `splits`, from the shapes alone), each split a run of whole
//     32-row K tiles.  Each of a block's 4 warps walks its own K tiles (tile
//     i of the block's run goes to warp i % 4) through its own ring of
//     STAGES buffers filled by 16-byte cp.async.cg copies: 32 K rows x 64
//     columns of weights and BM x 32 bytes of activations per tile, 4 KB of
//     weights in flight per warp and 16 KB per block, no block barrier
//     inside the walk.  (Four stages, or 8 warps to a block and half the
//     cluster, measured no faster: a call is as long as its first loads'
//     latency, the cluster barrier and the launch, not its streaming.)
//   * Operand layout.  Both s8 operands must be K-contiguous.  x_q is; the
//     weight tile is (K, N) row-major, and ldmatrix.trans moves 16-bit
//     elements only, so each thread reads four K rows of eight columns from
//     the tile (8-byte shared loads) and transposes each 4 x 4 byte block
//     with __byte_perm into words of four consecutive K values of one
//     column: the MMA's A registers.  A thread owns columns 8 g .. 8 g + 7
//     (g = lane / 4); MMA tile j takes column 8 g + 2 j as its row g and
//     8 g + 2 j + 1 as its row g + 8, so one 4 x 4 transpose feeds two
//     MMAs and no byte is read twice.  The 64-byte tile rows are 80 bytes
//     apart and their 16-byte chunks swizzled by bit 3 of the row, so those
//     reads are free of bank conflicts.
//   * Split-K in one launch.  Integer sums are exact in any order, so the
//     split cannot change a bit.  The warps of a block add their int32 tiles
//     in shared memory in warp order; each block of the cluster owns an
//     equal share of the strip's outputs, and every block stores its sums
//     for that share into the owner's shared memory (distributed shared
//     memory: stores, which nothing waits on, rather than loads), between
//     the two halves of one cluster barrier and one release/acquire
//     barrier.  The owner adds them in rank order and applies the
//     epilogue, whose scales and bias it loaded while the weights streamed.
//     No global workspace, no second launch.
//   * Ragged M, N and K are masked in the kernel (zero-filled copies).  When
//     N or K is not a multiple of 16, or a pointer is not 16-byte aligned,
//     the same walk stages its tiles with byte loads instead of cp.async, so
//     the caller pads nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 64;        // output columns per block (one strip)
constexpr int KT = 32;        // K rows per tile: one k32 MMA step
constexpr int STAGES = 2;     // tiles in each warp's ring
constexpr int W_STRIDE = 80;  // bytes between weight-tile rows
constexpr int X_STRIDE = 48;  // bytes between activation-tile rows
constexpr int MAX_SPLITS = 8; // the portable cluster size
constexpr int W_TILE = KT * W_STRIDE;

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
// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 4 x 4 byte transpose: rows r0..r3 (four columns each) -> c[i] holds
// column i's four bytes (r0[i], r1[i], r2[i], r3[i]), lowest K first
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t* c) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}
// byte offset of 16-byte chunk c (0-3) of weight-tile row r
__device__ __forceinline__ int w_off(int r, int c) {
  return r * W_STRIDE + 16 * (c ^ (((r >> 3) & 1) << 1));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The epilogue in the reference's order: ((acc * x_scale) * w_scale) + bias,
// each step rounded to nearest so that no FMA contraction changes a bit.
__device__ __forceinline__ float dequant(int acc, float xsm, float wsn,
                                         float bn) {
  const float v = __fmul_rn(__int2float_rn(acc), xsm);
  return __fadd_rn(__fmul_rn(v, wsn), bn);
}

// 16 bytes of `row` from `col` on, zero at and past `end` (byte loads)
__device__ __forceinline__ uint4 load16_bytes(const int8_t* row, int col,
                                              int end) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (col + i < end) v[i >> 2] |= (uint32_t)(uint8_t)row[col + i]
                                    << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The cluster barrier in two halves: arrive (relaxed: orders nothing) and
// wait, and the pair that publishes distributed shared-memory stores.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_release_acquire() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory of a block, in bytes: the warps' rings, reused for the
// warps' int32 tiles (whichever is larger), the int32 partials the
// cluster's blocks send this block for its share of the strip (BM x BN in
// all), and the epilogue's scales and bias.
__host__ __device__ constexpr int ring_bytes(int MT) {
  return WARPS * STAGES * (W_TILE + 8 * MT * X_STRIDE) >
                 WARPS * 8 * MT * BN * 4
             ? WARPS * STAGES * (W_TILE + 8 * MT * X_STRIDE)
             : WARPS * 8 * MT * BN * 4;
}
__host__ __device__ constexpr int smem_bytes(int MT) {
  return ring_bytes(MT) + 8 * MT * BN * 4 + (8 * MT + 2 * BN) * 4;
}

// blockIdx = (split, strip, token block); the splits of a strip are one
// cluster.  VEC: N and K multiples of 16 and x/w 16-byte aligned.
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
mp_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, void* __restrict__ y,
                 int out_bf16, int M, int N, int K) {
  constexpr int BM = 8 * MT;
  constexpr int STAGE = W_TILE + BM * X_STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();  // blocks: K splits

  const int splits = gridDim.x;
  const int s = blockIdx.x;  // the block's rank in its cluster
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * BM;
  const int mb = min(BM, M - m0);       // live tokens of the block
  const int mtiles = (mb + 7) / 8;      // live n8 token tiles
  const int k_tiles = (K + KT - 1) / KT;
  const int tps = (k_tiles + splits - 1) / splits;
  const int t_lo = min(k_tiles, s * tps);
  const int t_hi = min(k_tiles, t_lo + tps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  unsigned char* ring = smem + warp * STAGES * STAGE;
  // stage K tile t into slot st: 32 rows x 4 chunks of weights, mtiles * 8
  // rows x 2 chunks of activations
  auto issue = [&](int t, int st) {
    unsigned char* sw = ring + st * STAGE;
    unsigned char* sx = sw + W_TILE;
    const int k0 = t * KT;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = lane + 32 * u;
      const int r = i >> 2, c = i & 3;
      const int k = k0 + r, n = n0 + 16 * c;
      unsigned char* dst = sw + w_off(r, c);
      if (VEC) {
        const bool in = k < K && n < N;
        cp_async16(dst, in ? w + (size_t)k * N + n : w, in);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            k < K ? load16_bytes(w + (size_t)k * N, n, N)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = lane; i < mtiles * 8 * 2; i += 32) {
      const int r = i >> 1, c = i & 1;
      const int m = m0 + r, k = k0 + 16 * c;
      unsigned char* dst = sx + r * X_STRIDE + 16 * c;
      if (VEC) {
        const bool in = m < M && k < K;
        cp_async16(dst, in ? x + (size_t)m * K + k : x, in);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            m < M ? load16_bytes(x + (size_t)m * K, k, K)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const int span = t_hi - t_lo;
  const int mine = span > warp ? (span - warp + WARPS - 1) / WARPS : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < mine) issue(t_lo + warp + WARPS * st, st);
    cp_async_commit();
  }
  // tell the cluster this block runs (its shared memory may be written);
  // the matching wait comes after the walk
  cluster_arrive_relaxed();

  int* recv = reinterpret_cast<int*>(smem + ring_bytes(MT));  // [splits][per]
  float* sxs = reinterpret_cast<float*>(recv + BM * BN);      // [BM]
  float* sws = sxs + BM;                                      // [BN]
  float* sbias = sws + BN;                                    // [BN]
  // the epilogue's scales and bias, loaded while the weights stream
  if (tid < BM) sxs[tid] = m0 + tid < M ? xs[m0 + tid] : 0.0f;
  if (tid < BN) {
    const int n = n0 + tid;
    sws[tid] = n < N ? ws[n] : 0.0f;
    sbias[tid] = n < N && bias != nullptr ? bias[n] : 0.0f;
  }

  int acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0;

  for (int i = 0; i < mine; ++i) {
    const int in = i + STAGES - 1;
    if (in < mine) issue(t_lo + warp + WARPS * in, in % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();

    const unsigned char* sw = ring + (i % STAGES) * STAGE;
    const unsigned char* sx = sw + W_TILE;
    // col[h][c]: column 8 g + c, K rows 16 h + 4 tig .. + 3 of the tile
    uint32_t col[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 rows[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = 16 * h + 4 * tig + r;
        rows[r] = *reinterpret_cast<const uint2*>(sw + w_off(kr, g >> 1) +
                                                  8 * (g & 1));
      }
      transpose4(rows[0].x, rows[1].x, rows[2].x, rows[3].x, col[h]);
      transpose4(rows[0].y, rows[1].y, rows[2].y, rows[3].y, col[h] + 4);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t < mtiles) {
        const unsigned char* xr = sx + (8 * t + g) * X_STRIDE + 4 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {col[0][2 * j], col[0][2 * j + 1],
                                 col[1][2 * j], col[1][2 * j + 1]};
          mma_s8(acc[t][j], a, b0, b1);
        }
      }
    }
    __syncwarp();  // the slot is refilled next step
  }
  cp_async_wait<0>();

  // The warps' tiles, [warp][token][column], in the spent rings.  Within
  // each aligned group of four columns the word of column n sits at
  // n ^ ((m >> 1) & 3), so that the fragment stores below hit 16 banks
  // where plain rows would hit 4; a group stays one 16-byte word.
  __syncthreads();
  int* wacc = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * tig + (e & 1);
        const int n = 8 * g + 2 * j + (e >> 1);
        wacc[(warp * BM + m) * BN + (n ^ ((m >> 1) & 3))] = acc[t][j][e];
      }
  __syncthreads();
  // Element i of the strip's BM x BN tile belongs to rank i / per.  Each
  // block adds its warps' tiles in warp order, four columns at a time, and
  // sends the sums to the owner's shared memory (slot [rank][i % per]);
  // every block of the cluster has started by now (the wait), and the
  // release/acquire barrier then makes all the sends visible.
  const int per = BM * BN / splits;
  cluster_wait();
  for (int i = 4 * tid; i < mb * BN; i += 4 * THREADS) {
    int4 v = reinterpret_cast<const int4*>(wacc)[i / 4];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) {
      const int4 u = reinterpret_cast<const int4*>(wacc + ww * BM * BN)[i / 4];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int sw = ((i / BN) >> 1) & 3;  // undo the swizzle of row i / BN
    if (sw & 1) {
      const int x = v.x, z = v.z;
      v.x = v.y, v.y = x, v.z = v.w, v.w = z;
    }
    if (sw & 2) {
      const int x = v.x, y = v.y;
      v.x = v.z, v.y = v.w, v.z = x, v.w = y;
    }
    *reinterpret_cast<int4*>(cluster.map_shared_rank(recv, i / per) +
                             s * per + i % per) = v;
  }
  cluster_sync_release_acquire();
  // this block's share: the splits' partials in rank order, the epilogue
  for (int i = tid; i < per; i += THREADS) {
    const int e = s * per + i;
    const int ml = e / BN, nl = e % BN;
    const int m = m0 + ml, n = n0 + nl;
    if (ml >= mb || n >= N) continue;
    int v = 0;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) v += recv[r * per + i];
    const float out = dequant(v, sxs[ml], sws[nl], sbias[nl]);
    if (out_bf16)
      store_out(static_cast<__nv_bfloat16*>(y) + (size_t)m * N + n, out);
    else
      store_out(static_cast<float*>(y) + (size_t)m * N + n, out);
  }
}

template <int MT, bool VEC>
int launch(const int8_t* x, const int8_t* w, const float* xs,
           const float* ws, const float* bias, void* y, int out_bf16, int M,
           int N, int K, int splits, cudaStream_t stream) {
  auto kernel = mp_matmul_kernel<MT, VEC>;
  constexpr int smem = smem_bytes(MT);
  static bool attributed = false;  // once per kernel and process
  cudaError_t err;
  if (!attributed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attributed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + BN - 1) / BN, (M + 8 * MT - 1) / (8 * MT));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, xs, ws, bias, y, out_bf16, M,
                           N, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MT>
int launch_mt(const int8_t* x, const int8_t* w, const float* xs,
              const float* ws, const float* bias, void* y, int out_bf16,
              int M, int N, int K, int splits, cudaStream_t stream) {
  const bool vec = N % 16 == 0 && K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    return launch<MT, true>(x, w, xs, ws, bias, y, out_bf16, M, N, K, splits,
                            stream);
  return launch<MT, false>(x, w, xs, ws, bias, y, out_bf16, M, N, K, splits,
                           stream);
}

}  // namespace

// out_bf16: 0 -> float32 output, 1 -> bfloat16 output.  bias may be null.
// splits: the K splits, one cluster of blocks per 64-column strip (1, 2, 4
// or 8; the wrapper picks it).  The token block is 8, 16, 32 or 64 rows,
// the smallest that holds M (64 above 32).  One launch; returns
// cudaGetLastError() after it.
extern "C" int mp_matmul(const void* x_q, const void* w_q, const void* x_scale,
                         const void* w_scale, const void* bias, void* y,
                         int M, int N, int K, int splits, int out_bf16,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    return launch_mt<1>(x, w, xs, ws, b, y, out_bf16, M, N, K, splits, s);
  if (M <= 16)
    return launch_mt<2>(x, w, xs, ws, b, y, out_bf16, M, N, K, splits, s);
  if (M <= 32)
    return launch_mt<4>(x, w, xs, ws, b, y, out_bf16, M, N, K, splits, s);
  return launch_mt<8>(x, w, xs, ws, b, y, out_bf16, M, N, K, splits, s);
}
