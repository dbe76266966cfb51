// One-token attention over a KV cache, split over the card: the body of
// paged_mha.cu (a paged cache) and mha_decode.cu (a contiguous one).
//
// Replaces: src/repro/kernels/paged_mha_kernel.py:92 (paged_mha_decode,
// body _paged_mha_kernel) and src/repro/kernels/mha_kernel.py:89
// (mha_decode, body _mha_kernel).
//
// Computes, for query head h of row b, softmax(q . k_p / sqrt(D)) v_p over
// the cached positions key_lo <= p < key_end, with key_end = min(lengths[b],
// cap) and key_lo = max(0, lengths[b] - window) under a window (else 0).
// The addressing is a template parameter: a paged cache keeps position p in
// page bt[b, p / ps] at offset p % ps of the pool (P, Hkv, ps, D), cap =
// n_pg * ps; a contiguous cache (B, Hkv, S, D) keeps it at row
// (b * Hkv + hk) * S + p, cap = S.  Query head h reads KV head h / group.
// q and out are float32 or bf16, the cache bf16 or float32 (a template
// parameter), arithmetic float32 with an online softmax.  A row with no key
// returns zeros.
//
// What bounds it on the H100: bytes.  Each live K and V element is read once
// per KV head against ~4 x group operations; at GPT-2's decode (B 8, 16
// heads of 64, up to 1,024 keys a row) that is 2-17 MB in bf16 and twice
// that in float32, a few microseconds of HBM time, so what matters is how
// many blocks are loading at once.
//
// Design (flash-decoding):
//   * Split-KV.  The grid is (row, KV head, head chunk, key split), one block
//     each.  A split is a run of kps keys (whole pages for a paged cache,
//     whole 16-key tiles for a contiguous one); the wrapper derives kps and
//     the number of splits from the shapes alone (the lengths live on the
//     card, and reading them would synchronise), aiming at a few blocks per
//     SM.  A block clips its split to [key_lo, key_end) and, when nothing is
//     left, writes m = -inf and l = 0 and exits.  Keys at or past key_end
//     are never read, so no block-table entry at or past n_pg is touched.
//   * A block serves HG query heads of its KV head (the whole group when it
//     is at most 8; a wider group takes ceil(group / 8) head chunks), so each
//     key is read once per KV head for groups up to 8, and any group is
//     taken.
//   * Each of the 4 warps walks its own 16-key tiles of the block's run (tile
//     i goes to warp i % 4) through a ring of STAGES buffers filled with
//     16-byte cp.async copies of K and V rows: no block barrier inside the
//     walk.  Where four warps' rings would not fit a block's shared memory
//     (a float32 cache at D 256: 393,216 of 232,448 bytes) the block runs
//     2 warps, tile i going to warp i % 2; the split geometry is the same.
//     Inside a warp, D / 8 lanes share a key, each holding 8 of its
//     dimensions: one 16-byte chunk of a bf16 row, two of a float32 row (a
//     lane's c-th chunk sits c * D / 2 elements into the row, so the 8
//     lanes of each quarter-warp read 128 consecutive bytes of shared
//     memory per load).  Four float32 dimensions per lane, D / 4 lanes a
//     key, measured slower at the draft's shape, and this keeps one lane
//     geometry for both element types.  The dot product is 8 FMAs per head
//     and lane, then a shuffle reduction over the key's lanes.
//   * Each key slot (the lanes of one key) keeps its own float32 running
//     max, sum and accumulators (8 dimensions per head and lane), so the
//     walk needs no shuffle across keys.  At the end the key slots merge by
//     a fixed butterfly of shuffles, the warps in shared memory in warp
//     order, into one float32 partial (m, l, acc[D]) per head and split in
//     scratch the wrapper allocates.
//   * verify_attn.cuh's combine kernel, with one query position, merges the
//     splits in split order: two calls are bit-identical, no atomics.
//   * No tensor cores: at group 1 a decode does about 2 operations per byte.
#pragma once

#include "verify_attn.cuh"

namespace decode {

constexpr int WARPS = 4;  // warps per block, where the rings fit
constexpr int TILE = 16;   // keys per warp step
constexpr int STAGES = 3;  // K/V tiles in each warp's ring
constexpr int MAX_HG = 8;  // query heads per block
constexpr int EPL = 8;     // dimensions of a key per lane
constexpr float M_INIT = -1e30f;  // finite: exp2(M_INIT - M_INIT) is 1
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use

// Warps per block for `elem`-byte cache elements at head dim D: WARPS, or
// half as many where WARPS rings would not fit.
constexpr int warps(int D, int elem) {
  return (size_t)WARPS * STAGES * 2 * TILE * D * elem <= SMEM_LIMIT
             ? WARPS
             : WARPS / 2;
}

// Shared memory of the split kernel, in bytes: the warps' K/V rings of
// `elem`-byte elements, reused for the warps' partials.
inline size_t smem_bytes(int D, int HG, int elem) {
  const int w = warps(D, elem);
  const size_t ring = (size_t)w * STAGES * 2 * TILE * D * elem;
  const size_t merge = (size_t)w * HG * (D + 2) * 4;
  return ring > merge ? ring : merge;
}

// Where position `pos` of row b, KV head hk sits, in rows of D elements.
struct Paged {
  const int* bt;  // (B, n_pg)
  int n_pg, ps;
  __device__ __forceinline__ int cap() const { return n_pg * ps; }
  __device__ __forceinline__ size_t row(int b, int hk, int Hkv,
                                        int pos) const {
    return ((size_t)bt[(size_t)b * n_pg + pos / ps] * Hkv + hk) * ps +
           pos % ps;
  }
};

struct Contig {
  int S;
  __device__ __forceinline__ int cap() const { return S; }
  __device__ __forceinline__ size_t row(int b, int hk, int Hkv,
                                        int pos) const {
    return ((size_t)b * Hkv + hk) * S + pos;
  }
};

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// One block per (row b, KV head hk, head chunk hc, split s), blockIdx.x =
// ((b * Hkv + hk) * h_chunks + hc) * splits + s.  Scratch: part_o (splits,
// B, H, D) and part_ml (splits, B, H, 2) float32, the layout of
// verify::combine_kernel with C = 1.
template <typename T, typename Addr, int D, int HG, int W>
__global__ void __launch_bounds__(32 * W)
split_kernel(const void* __restrict__ q_,  // (B, H, D) float32 or bf16
             const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ lengths,  // (B,)
             Addr addr, float* __restrict__ part_o,
             float* __restrict__ part_ml, int q_bf16, int B, int H, int Hkv,
             int window, int kps, int splits, float scale_log2) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int NCH = EPL / VEC;            // chunks a lane holds per key
  constexpr int LPK = D / EPL;              // lanes per key
  constexpr int KPI = 32 / LPK;             // keys a warp holds at once
  constexpr int ITERS = TILE / KPI;         // key steps per tile
  constexpr int CH = D / VEC;               // 16-byte chunks per key row
  constexpr int STAGE = 2 * TILE * D;       // elements per ring slot
  constexpr int NTH = 32 * W;               // threads
  static_assert(EPL % VEC == 0 && D % EPL == 0 && 32 % LPK == 0 &&
                    TILE % KPI == 0 && (TILE * CH) % 32 == 0,
                "unsupported head dim / lane split");
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
  const int key_end = min(len, addr.cap());
  const int key_lo = window > 0 ? max(0, len - window) : 0;
  const int lo = max(s * kps, key_lo);
  const int hi = min((s + 1) * kps, key_end);
  const size_t BH = (size_t)B * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (lo >= hi) {  // nothing of this split is visible to the row
    for (int r = tid; r < nh; r += NTH) {
      float* ml = part_ml + 2 * ((size_t)s * BH + (size_t)b * H + h0 + r);
      ml[0] = -INFINITY;
      ml[1] = 0.0f;
    }
    return;
  }

  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * STAGES * STAGE;
  // stage tile t (keys lo + 16 t .. + 15) of K and V into slot st
  auto issue = [&](int t, int st) {
    T* sk = ring + st * STAGE;
    T* sv = sk + TILE * D;
#pragma unroll
    for (int k = 0; k < TILE * CH / 32; ++k) {
      const int j = (lane + 32 * k) / CH, part = (lane + 32 * k) % CH;
      const int pos = lo + t * TILE + j;
      const bool in = pos < hi;
      const size_t src = in ? addr.row(b, hk, Hkv, pos) * D + VEC * part
                            : 0;
      verify::cp_async16(sk + j * D + VEC * part, kc + src, in);
      verify::cp_async16(sv + j * D + VEC * part, vc + src, in);
    }
  };
  const int span = (hi - lo + TILE - 1) / TILE;
  const int mine = span > warp ? (span - warp + W - 1) / W : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < mine) issue(warp + W * st, st);
    verify::cp_async_commit();
  }

  // this lane's key slot and the dimensions it holds; q pre-scaled to
  // base 2
  const int ks = lane / LPK, dp = lane % LPK;
  auto dim = [&](int e) {
    return (e / VEC) * (D / NCH) + VEC * dp + e % VEC;
  };
  float qr[HG][EPL];
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float v = 0.0f;
      if (h < nh) {
        const size_t at = ((size_t)b * H + h0 + h) * D + dim(e);
        v = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q_)[at])
                   : static_cast<const float*>(q_)[at];
      }
      qr[h][e] = v * scale_log2;
    }

  float m[HG], l[HG], o[HG][EPL];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = M_INIT;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[h][e] = 0.0f;
  }
  for (int i = 0; i < mine; ++i) {
    const int in = i + STAGES - 1;
    if (in < mine) issue(warp + W * in, in % STAGES);
    verify::cp_async_commit();
    verify::cp_async_wait<STAGES - 1>();
    __syncwarp();

    const int t = warp + W * i;
    const T* sk = ring + (i % STAGES) * STAGE;
    const T* sv = sk + TILE * D;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int j = it * KPI + ks;
      const bool valid = lo + t * TILE + j < hi;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        load16(sk + j * D + dim(c * VEC), kf + c * VEC);
        load16(sv + j * D + dim(c * VEC), vf + c * VEC);
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float sc = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) sc = fmaf(qr[h][e], kf[e], sc);
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
          for (int e = 0; e < EPL; ++e)
            o[h][e] = fmaf(p, vf[e], o[h][e] * alpha);
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
      for (int e = 0; e < EPL; ++e) {
        const float oo = __shfl_xor_sync(0xffffffffu, o[h][e], off);
        o[h][e] = o[h][e] * fa + oo * fb;
      }
      m[h] = M;
    }

  // merge the warps, in warp order, into the split's partial
  __syncthreads();  // every ring is spent: reuse it
  float* ow = reinterpret_cast<float*>(smem);  // [W][HG][D]
  float* mw = ow + W * HG * D;             // [W][HG]
  float* lw = mw + W * HG;                 // [W][HG]
  if (ks == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) ow[(warp * HG + h) * D + dim(e)] = o[h][e];
      if (dp == 0) {
        mw[warp * HG + h] = m[h];
        lw[warp * HG + h] = l[h];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += NTH) {
    const int h = i / D, d = i % D;
    float M = M_INIT;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, mw[w * HG + h]);
    float L = 0.0f, O = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
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

// The shape of one call, as the wrapper's geometry gives it.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* scratch;  // splits * B * H * (D + 2) floats
  int q_bf16, B, H, Hkv, window, hg, kps, splits;
  cudaStream_t stream;
};

template <typename T, typename Addr, int D, int HG>
int launch_hg(const Call& c, Addr addr) {
  constexpr int W = warps(D, (int)sizeof(T));
  const size_t smem = smem_bytes(D, HG, (int)sizeof(T));
  auto kernel = split_kernel<T, Addr, D, HG, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BH = c.B * c.H;
  const int h_chunks = (c.H / c.Hkv + HG - 1) / HG;
  float* part_o = c.scratch;
  float* part_ml = c.scratch + (size_t)c.splits * BH * D;
  kernel<<<c.B * c.Hkv * h_chunks * c.splits, 32 * W, smem, c.stream>>>(
      c.q, static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      c.lengths, addr, part_o, part_ml, c.q_bf16, c.B, c.H, c.Hkv, c.window,
      c.kps, c.splits, 1.4426950408889634f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = (BH + verify::WARPS - 1) / verify::WARPS;
  if (c.q_bf16)
    verify::combine_kernel<__nv_bfloat16, D>
        <<<grid, verify::THREADS, 0, c.stream>>>(
            part_o, part_ml, static_cast<__nv_bfloat16*>(c.out), BH,
            c.splits);
  else
    verify::combine_kernel<float, D><<<grid, verify::THREADS, 0, c.stream>>>(
        part_o, part_ml, static_cast<float*>(c.out), BH, c.splits);
  return (int)cudaGetLastError();
}

template <typename T, typename Addr, int D>
int launch_d(const Call& c, Addr addr) {
  switch (c.hg) {
    case 1:
      return launch_hg<T, Addr, D, 1>(c, addr);
    case 2:
      return launch_hg<T, Addr, D, 2>(c, addr);
    case 4:
      return launch_hg<T, Addr, D, 4>(c, addr);
    case 8:
      return launch_hg<T, Addr, D, 8>(c, addr);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch the split kernel and the combine on c.stream; returns
// cudaGetLastError().  D is 16, 64, 128 or 256; hg (query heads per block) 1,
// 2, 4 or 8; kps keys per split, splits * kps covering addr.cap().
template <typename T, typename Addr>
int launch(const Call& c, int D, Addr addr, long long cap) {
  if (c.H % c.Hkv != 0 || c.kps < 1 || c.splits < 1 ||
      (long long)c.splits * c.kps < cap)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch_d<T, Addr, 16>(c, addr);
    case 64:
      return launch_d<T, Addr, 64>(c, addr);
    case 128:
      return launch_d<T, Addr, 128>(c, addr);
    case 256:
      return launch_d<T, Addr, 256>(c, addr);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode
