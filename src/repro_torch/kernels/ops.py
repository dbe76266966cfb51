"""Kernel wrappers: CPU tensors take the plain version, CUDA tensors the
hand-written Hopper kernel.

The dispatch is decided by where the tensors lie and nothing else: a
tensor on the CPU goes to :mod:`repro_torch.kernels.ref`, a tensor on the
card launches the CUDA kernel (built at first use, see
:mod:`repro_torch.kernels.build`) or raises.  A ``meta`` tensor (the dry
run's) takes the plain version too, which on ``meta`` computes shapes
only.  There is no fallback from a CUDA tensor to the plain version.
Each wrapper checks device, dtype,
shape, contiguity and alignment, allocates its output, launches on
PyTorch's current stream, raises if the launch reports an error, and
adds one to its launch counter (``<wrapper>.launches``) per call that
launches its kernel: ``quant_matmul`` launches one CUDA function, a
cluster of blocks per output strip; ``paged_mha_decode``,
``mha_decode`` and ``paged_verify`` launch two each (the split-KV
attention, then the combine of its splits) and count once, the verify's
causal and tree-masked calls apart (``launches``, ``tree_launches``);
``quant_act`` launches one per call; ``moe_experts`` launches two (the
gate and up products with the activation, then the down product) and
counts both.  ``ln_res``
is reached only through ``core/mdk.MDK_REGISTRY["ln_res"]``, as in the
JAX package.  Unlike the TPU wrappers these pad nothing: the kernels
mask their own ragged edges.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

#: the H100's shared memory per block (bytes)
_SMEM_LIMIT = 232_448
#: the H100's streaming multiprocessors
_N_SMS = 132
#: mp_matmul.cu: output columns per block (a strip), K rows per tile,
#: warps per block, tiles in each warp's ring, the largest K-split cluster,
#: and the bytes between the rows of a staged weight and activation tile
_MP_BN, _MP_KT, _MP_WARPS, _MP_STAGES, _MP_MAX_SPLITS = 64, 32, 4, 2, 8
_MP_W_STRIDE, _MP_X_STRIDE = 80, 48
#: blocks the mp_matmul geometry aims at: two per SM
_MP_BLOCKS = 2 * _N_SMS
#: verify_attn.cuh: warps per block, query rows per block (one m16 MMA
#: tile), keys per warp step, K/V tiles in each warp's ring, head dims built,
#: the widest head whose Q fragments and accumulators stay in registers
#: (wider heads stage Q in shared memory and split P V over two blocks)
_VERIFY_WARPS, _VERIFY_ROWS, _VERIFY_TILE, _VERIFY_STAGES = 4, 16, 16, 2
_VERIFY_HEAD_DIMS = (16, 64, 128, 256)
_VERIFY_REG_MAX_D = 128
#: blocks the verify geometry aims at: a few per SM
_VERIFY_BLOCKS = 4 * _N_SMS
#: decode_attn.cuh: warps per block (where their rings fit), keys per warp
#: step, K/V tiles in each warp's ring, query heads per block at most, head
#: dims built; blocks the decode geometry aims at
_DECODE_WARPS, _DECODE_TILE, _DECODE_STAGES, _DECODE_MAX_HG = 4, 16, 3, 8
_DECODE_HEAD_DIMS = (16, 64, 128, 256)
_DECODE_BLOCKS = 4 * _N_SMS
#: ln_res.cu: threads per row (one block), 8-column chunks a thread may
#: hold
_LN_THREADS, _LN_MAX_NV = 256, 8
#: quant_act.cu: the widest block
_QA_MAX_THREADS = 1024
#: moe_experts.cu: rows of one m16 MMA tile; the gated activations it
#: applies, by the code the kernel takes
_MOE_M16 = 16
_MOE_ACTS = {"swiglu": 0, "geglu": 1}


class MpGeometry(NamedTuple):
    """Launch geometry of ``mp_matmul.cu``."""
    bm: int         # tokens per block: 8, 16, 32 or 64
    strips: int     # 64-column output strips
    m_blocks: int   # token blocks
    splits: int     # K splits: blocks per cluster (1, 2, 4 or 8)
    smem: int       # dynamic shared memory per block, bytes


def _mp_geometry(M: int, N: int, K: int) -> MpGeometry:
    """The one-launch geometry of ``mp_matmul``: the smallest token block
    that holds M (64 above 32), and K split into a cluster of as many
    blocks as bring the grid to about two per SM, a power of two of at
    most 8 and at most one per 32-row K tile (the kernel splits whole
    tiles)."""
    bm = next(b for b in (8, 16, 32, 64) if M <= b or b == 64)
    strips, m_blocks = -(-N // _MP_BN), -(-M // bm)
    cap = min(_MP_MAX_SPLITS, -(-K // _MP_KT),
              -(-_MP_BLOCKS // (strips * m_blocks)))
    splits = 1 << (cap.bit_length() - 1)
    # the warps' rings, reused for their int32 tiles; the cluster's
    # partials of this block's share; the epilogue's scales and bias
    ring = max(_MP_WARPS * _MP_STAGES * (_MP_KT * _MP_W_STRIDE
                                         + bm * _MP_X_STRIDE),
               _MP_WARPS * bm * _MP_BN * 4)
    smem = ring + 4 * bm * _MP_BN + 4 * (bm + 2 * _MP_BN)
    return MpGeometry(bm, strips, m_blocks, splits, smem)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version; raises on
    mixed or unsupported devices.  The plain version serves CPU tensors
    and ``meta`` tensors, on which it computes shapes only (the dry run,
    ``launch/dryrun.py``): nothing is allocated or launched there."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type in ("cpu", "meta"):
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: unsupported device {dev}")


def _contig(name: str, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")


def launch_counts() -> Dict[str, int]:
    """Calls that launched each kernel since the last reset."""
    return {"mp_matmul": quant_matmul.launches,
            "paged_mha_decode": paged_mha_decode.launches,
            "paged_verify": paged_verify.launches,
            "paged_verify_tree": paged_verify.tree_launches,
            "mha_decode": mha_decode.launches,
            "ln_res": ln_res.launches,
            "quant_act": quant_act.launches,
            "moe_experts": moe_experts.launches}


def reset_launch_counts() -> None:
    quant_matmul.launches = 0
    paged_mha_decode.launches = 0
    paged_verify.launches = 0
    paged_verify.tree_launches = 0
    mha_decode.launches = 0
    ln_res.launches = 0
    quant_act.launches = 0
    moe_experts.launches = 0


# ---------------------------------------------------------------------------


def quant_matmul(x_q, w_q, x_scale, w_scale, bias=None, *,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused W8A8 matmul (the paper's Fused MP kernel):
    ``(x_q @ w_q) * x_scale * w_scale + bias`` with int32 accumulation.

    ``x_q`` int8 (M, K), ``w_q`` int8 (K, N), ``x_scale`` f32 (M, 1),
    ``w_scale`` f32 (1, N), ``bias`` f32 (N,) or None; output (M, N) in
    ``out_dtype`` (float32 or bfloat16)."""
    name = "quant_matmul"
    if not _route(name, x_q, w_q, x_scale, w_scale, bias):
        return ref.quant_matmul_ref(x_q, w_q, x_scale, w_scale, bias,
                                    out_dtype=out_dtype)
    _require(x_q.dim() == 2 and w_q.dim() == 2
             and x_q.shape[1] == w_q.shape[0],
             f"{name}: shapes {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    M, K = x_q.shape
    N = w_q.shape[1]
    _require(x_q.dtype == torch.int8 and w_q.dtype == torch.int8,
             f"{name}: x_q/w_q must be int8")
    _require(x_scale.dtype == torch.float32
             and tuple(x_scale.shape) == (M, 1),
             f"{name}: x_scale must be float32 ({M}, 1)")
    _require(w_scale.dtype == torch.float32
             and tuple(w_scale.shape) == (1, N),
             f"{name}: w_scale must be float32 (1, {N})")
    if bias is not None:
        _require(bias.dtype == torch.float32 and tuple(bias.shape) == (N,),
                 f"{name}: bias must be float32 ({N},)")
        _contig(name, bias=bias)
    _require(out_dtype in (torch.float32, torch.bfloat16),
             f"{name}: out_dtype {out_dtype} not float32/bfloat16")
    _require(M > 0 and N > 0 and K > 0, f"{name}: empty operand")
    _contig(name, x_q=x_q, w_q=w_q, x_scale=x_scale, w_scale=w_scale)
    y = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    geo = _mp_geometry(M, N, K)
    err = build.library().mp_matmul(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), M, N, K, geo.splits,
        int(out_dtype == torch.bfloat16), _stream(x_q))
    _check_launch(name, err)
    quant_matmul.launches += 1
    return y


def _check_attn(name, q, k, v, rows, kv_dtypes):
    """Checks shared by the attention wrappers: q (B, ..., H, D) against
    a K/V tensor (N, Hkv, S, D) whose dtype is one of ``kv_dtypes``, and
    ``rows`` (B,) int32; returns (Hkv, D)."""
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    _require(k.dim() == 4 and k.shape == v.shape,
             f"{name}: k/v must both be 4-d and of one shape")
    _require(k.dtype in kv_dtypes and v.dtype == k.dtype,
             f"{name}: k/v must be one of {kv_dtypes}")
    Hkv, D = k.shape[1], k.shape[3]
    H = q.shape[-2]
    _require(q.shape[-1] == D and H % Hkv == 0,
             f"{name}: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    B = q.shape[0]
    _require(rows.dtype == torch.int32 and tuple(rows.shape) == (B,),
             f"{name}: lengths/base must be int32 ({B},)")
    _contig(name, q=q, k=k, v=v, rows=rows)
    # the kernels stage K/V rows with 16-byte copies
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             f"{name}: k/v must be 16-byte aligned")
    return Hkv, D


def _check_paged(name, q, k_pages, v_pages, rows, block_table):
    """Shared checks of the paged-attention wrappers; returns
    (Hkv, ps, D, n_pg)."""
    Hkv, D = _check_attn(name, q, k_pages, v_pages, rows, (torch.bfloat16,))
    B = q.shape[0]
    _require(block_table.dtype == torch.int32 and block_table.dim() == 2
             and block_table.shape[0] == B,
             f"{name}: block_table must be int32 ({B}, n_pg)")
    _contig(name, block_table=block_table)
    return Hkv, k_pages.shape[2], D, block_table.shape[1]


class DecodeGeometry(NamedTuple):
    """Launch geometry of the split-KV decode kernel (``decode_attn.cuh``)."""
    hg: int         # query heads per block (1, 2, 4 or 8)
    h_chunks: int   # blocks along a KV head's group
    pps: int        # pages per key split
    splits: int     # key splits per (row, KV head, head chunk)
    smem: int       # dynamic shared memory per block, bytes
    scratch: int    # float32 partials: splits * B * H * (D + 2)


def _head_chunks(group: int):
    """(query heads per block, blocks along the group) of the decode body:
    the whole group when it is at most 8, else chunks of 8."""
    hg = next(g for g in (1, 2, 4, 8) if group <= g or g == _DECODE_MAX_HG)
    return hg, -(-group // hg)


def _decode_warps(D: int, elem: int) -> int:
    """Warps of a decode block (``decode::warps``): 4, or 2 where four
    warps' rings of ``elem``-byte elements would not fit (float32 at D
    256)."""
    ring = _DECODE_WARPS * _DECODE_STAGES * 2 * _DECODE_TILE * D * elem
    return _DECODE_WARPS if ring <= _SMEM_LIMIT else _DECODE_WARPS // 2


def _decode_smem(D: int, hg: int, elem: int) -> int:
    """Shared memory of the decode body's block: the warps' K/V rings of
    ``elem``-byte elements, reused for the warps' partials of ``hg``
    heads (``decode::smem_bytes``)."""
    w = _decode_warps(D, elem)
    ring = w * _DECODE_STAGES * 2 * _DECODE_TILE * D * elem
    return max(ring, w * hg * (D + 2) * 4)


def _decode_geometry(B: int, H: int, Hkv: int, ps: int, D: int,
                     n_pg: int) -> DecodeGeometry:
    """The split-KV geometry of ``paged_mha_decode``, from the shapes alone
    (the lengths live on the card; reading them would synchronise).  A
    block serves up to 8 query heads of one KV head, so each page is read
    once per KV head for groups up to 8.  Each split is a run of whole
    pages giving each warp at least one 16-key tile; splits are added
    until the grid holds about ``_DECODE_BLOCKS`` blocks."""
    hg, h_chunks = _head_chunks(H // Hkv)
    least = -(-_DECODE_WARPS * _DECODE_TILE // ps)
    wanted = -(-_DECODE_BLOCKS // (B * Hkv * h_chunks))
    pps = max(least, -(-n_pg // wanted))
    splits = -(-n_pg // pps)
    return DecodeGeometry(hg, h_chunks, pps, splits, _decode_smem(D, hg, 2),
                          splits * B * H * (D + 2))


class MhaGeometry(NamedTuple):
    """Launch geometry of the contiguous decode (``decode_attn.cuh``'s
    contiguous addressing)."""
    hg: int         # query heads per block (1, 2, 4 or 8)
    h_chunks: int   # blocks along a KV head's group
    kps: int        # keys per split: whole 16-key tiles
    splits: int     # key splits per (row, KV head, head chunk)
    smem: int       # dynamic shared memory per block, bytes
    scratch: int    # float32 partials: splits * B * H * (D + 2)


def _mha_geometry(B: int, H: int, Hkv: int, S: int, D: int,
                  elem: int) -> MhaGeometry:
    """The split-KV geometry of ``mha_decode`` over a (B, Hkv, S, D) cache
    of ``elem``-byte elements, from the shapes alone (never the lengths,
    which live on the card), as ``_decode_geometry`` with runs of whole
    16-key tiles in place of pages: each split gives every warp at least
    one tile, and splits are added until the grid holds about
    ``_DECODE_BLOCKS`` blocks."""
    hg, h_chunks = _head_chunks(H // Hkv)
    tiles = -(-S // _DECODE_TILE)
    wanted = -(-_DECODE_BLOCKS // (B * Hkv * h_chunks))
    tps = max(_DECODE_WARPS, -(-tiles // wanted))
    splits = -(-tiles // tps)
    return MhaGeometry(hg, h_chunks, tps * _DECODE_TILE, splits,
                       _decode_smem(D, hg, elem), splits * B * H * (D + 2))


class VerifyGeometry(NamedTuple):
    """Launch geometry of the split-KV verify kernel (``verify_attn.cuh``)."""
    nq: int         # queries per block (16 // group query rows)
    q_tiles: int    # blocks along the chunk
    parts: int      # blocks along the value dimensions (2 past D 128)
    pps: int        # pages per key split
    splits: int     # key splits per (row, KV head, query tile)
    smem: int       # dynamic shared memory per block, bytes
    scratch: int    # float32 partials: splits * B * C * H * (D + 2)


def _verify_geometry(B: int, C: int, H: int, Hkv: int, ps: int, D: int,
                     n_pg: int) -> VerifyGeometry:
    """The split-KV geometry of ``paged_verify``, from the shapes alone (the
    bases live on the card; reading them would synchronise): the same for
    the causal and the tree entry.  Each split is a run of whole pages that
    starts on a 16-key tile and gives each warp at least one tile; splits
    are added until the grid holds about ``_VERIFY_BLOCKS`` blocks."""
    group = H // Hkv
    nq = _VERIFY_ROWS // group
    q_tiles = -(-C // nq)
    unit = _VERIFY_TILE // math.gcd(_VERIFY_TILE, ps)

    def whole(pages: int) -> int:  # rounded up to a multiple of `unit`
        return -(-pages // unit) * unit

    least = whole(-(-_VERIFY_WARPS * _VERIFY_TILE // ps))
    wanted = -(-_VERIFY_BLOCKS // (B * Hkv * q_tiles))
    pps = max(least, whole(-(-n_pg // wanted)))
    splits = -(-n_pg // pps)
    # past D 128: Q hi and lo staged, each block half the value dims
    wide = D > _VERIFY_REG_MAX_D
    dv = D // 2 if wide else D
    ring = (_VERIFY_WARPS * _VERIFY_STAGES * _VERIFY_TILE
            * ((D + 8) + (dv + 8)) * 2)
    merge = _VERIFY_WARPS * _VERIFY_ROWS * dv * 4
    qs = 2 * _VERIFY_ROWS * (D + 8) * 2 if wide else 0
    smem = (max(ring, merge) + qs + 2 * _VERIFY_WARPS * _VERIFY_ROWS * 4
            + nq * -(-C // 32) * 4)
    return VerifyGeometry(nq, q_tiles, D // dv, pps, splits, smem,
                          splits * B * C * H * (D + 2))


def _ln_res_chunks(D: int) -> int:
    """8-column chunks each of ``ln_res.cu``'s 256 threads holds in
    registers: the fewest power of two that covers a row of ``D``."""
    chunks = -(-D // (8 * _LN_THREADS))
    return 1 << (chunks - 1).bit_length()


def mha_decode(q, k_cache, v_cache, lengths, *,
               window: int = 0) -> torch.Tensor:
    """One-token attention over a contiguous KV cache.

    ``q`` (B, H, D) f32/bf16, ``k_cache``/``v_cache`` (B, Hkv, S, D) bf16
    or float32, ``lengths`` (B,) int32 valid entries per row (the new
    token included).  Returns (B, H, D) in q's dtype.  The kernel returns
    zeros for a row with no valid key; the plain version, like the JAX
    oracle, returns NaN there.

    On the card one call launches two CUDA functions, the split-KV
    attention and the combine of its splits (``_mha_geometry``), and
    counts one launch."""
    name = "mha_decode"
    if not _route(name, q, k_cache, v_cache, lengths):
        return ref.mha_decode_ref(q, k_cache, v_cache, lengths,
                                  window=window)
    _require(q.dim() == 3 and k_cache.dim() == 4
             and k_cache.shape[0] == q.shape[0],
             f"{name}: q must be (B, H, D) and k/v (B, Hkv, S, D)")
    Hkv, D = _check_attn(name, q, k_cache, v_cache, lengths,
                         (torch.bfloat16, torch.float32))
    B, H, _ = q.shape
    S = k_cache.shape[2]
    _require(B > 0 and S > 0, f"{name}: empty operand")
    _require(D in _DECODE_HEAD_DIMS,
             f"{name}: head_dim {D} not one of {_DECODE_HEAD_DIMS}")
    geo = _mha_geometry(B, H, Hkv, S, D, k_cache.element_size())
    _require(geo.smem <= _SMEM_LIMIT,
             f"{name}: needs {geo.smem} B shared memory")
    out = torch.empty_like(q)
    scratch = torch.empty(geo.scratch, dtype=torch.float32, device=q.device)
    err = build.library().mha_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        B, H, Hkv, S, D, int(window), geo.hg, geo.kps, geo.splits,
        _stream(q))
    _check_launch(name, err)
    mha_decode.launches += 1
    return out


def paged_mha_decode(q, k_pages, v_pages, lengths, block_table, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention over a paged KV cache.

    ``q`` (B, H, D) f32/bf16, pages (P, Hkv, ps, D) bf16, ``lengths``
    (B,) int32 valid entries per row (the new token included),
    ``block_table`` (B, n_pg) int32.  Returns (B, H, D) in q's dtype.

    On the card one call launches two CUDA functions, the split-KV
    attention and the combine of its splits (``_decode_geometry``), and
    counts one launch."""
    name = "paged_mha_decode"
    if not _route(name, q, k_pages, v_pages, lengths, block_table):
        return ref.paged_mha_decode_ref(q, k_pages, v_pages, lengths,
                                        block_table, window=window)
    _require(q.dim() == 3, f"{name}: q must be (B, H, D)")
    Hkv, ps, D, n_pg = _check_paged(name, q, k_pages, v_pages, lengths,
                                    block_table)
    B, H, _ = q.shape
    _require(B > 0 and n_pg > 0, f"{name}: empty operand")
    _require(D in _DECODE_HEAD_DIMS,
             f"{name}: head_dim {D} not one of {_DECODE_HEAD_DIMS}")
    geo = _decode_geometry(B, H, Hkv, ps, D, n_pg)
    _require(geo.smem <= _SMEM_LIMIT,
             f"{name}: needs {geo.smem} B shared memory")
    out = torch.empty_like(q)
    scratch = torch.empty(geo.scratch, dtype=torch.float32, device=q.device)
    err = build.library().paged_mha_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), block_table.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), int(q.dtype == torch.bfloat16), B, H, Hkv, ps, D,
        n_pg, int(window), geo.hg, geo.pps, geo.splits, _stream(q))
    _check_launch(name, err)
    paged_mha_decode.launches += 1
    return out


def paged_verify(q, k_pages, v_pages, base, block_table, *,
                 window: int = 0,
                 anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked causal attention over a paged KV cache (prefill/verify).

    ``q`` (B, C, H, D): query ``j`` of row ``b`` sits at ``base[b] + j``
    and attends every cached position at or below it, the chunk's own K/V
    included.  ``anc`` (B, C, C) int32 replaces the in-chunk causal mask
    with a token tree's ancestor bitmask (query ``j`` attends ``base[b] +
    i`` where ``anc[b, j, i]`` is set, and everything below ``base[b]``);
    it is exclusive with ``window`` and launches the tree kernel.

    On the card one call launches two CUDA functions, the split-KV
    attention and the combine of its splits (``_verify_geometry``), and
    counts one launch."""
    name = "paged_verify"
    if anc is not None and window:
        raise ValueError("window and anc are mutually exclusive")
    if not _route(name, q, k_pages, v_pages, base, block_table, anc):
        return ref.paged_verify_ref(q, k_pages, v_pages, base, block_table,
                                    window=window, anc=anc)
    _require(q.dim() == 4, f"{name}: q must be (B, C, H, D)")
    Hkv, ps, D, n_pg = _check_paged(name, q, k_pages, v_pages, base,
                                    block_table)
    B, C, H, _ = q.shape
    _require(B > 0 and C > 0 and n_pg > 0, f"{name}: empty operand")
    _require(D in _VERIFY_HEAD_DIMS,
             f"{name}: head_dim {D} not one of {_VERIFY_HEAD_DIMS}")
    # a block's 16 MMA rows hold 16 // group queries of all its heads
    _require(H // Hkv <= _VERIFY_ROWS,
             f"{name}: group {H // Hkv} exceeds {_VERIFY_ROWS} query rows")
    geo = _verify_geometry(B, C, H, Hkv, ps, D, n_pg)
    _require(geo.smem <= _SMEM_LIMIT,
             f"{name}: needs {geo.smem} B shared memory")
    out = torch.empty_like(q)
    scratch = torch.empty(geo.scratch, dtype=torch.float32, device=q.device)
    lib = build.library()
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            base.data_ptr(), block_table.data_ptr())
    shape = (int(q.dtype == torch.bfloat16), B, C, H, Hkv, ps, D, n_pg)
    split = (geo.nq, geo.pps, geo.splits, _stream(q))
    if anc is None:
        err = lib.paged_verify(*args, out.data_ptr(), scratch.data_ptr(),
                               *shape, int(window), *split)
        _check_launch(name, err)
        paged_verify.launches += 1
        return out
    _require(anc.device == q.device and anc.dtype == torch.int32
             and tuple(anc.shape) == (B, C, C),
             f"{name}: anc must be int32 ({B}, {C}, {C}) on {q.device}")
    _contig(name, anc=anc)
    err = lib.paged_verify_tree(*args, anc.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), *shape, *split)
    _check_launch(name, err)
    paged_verify.tree_launches += 1
    return out


def ln_res(x, res, weight, bias=None, *, kind: str = "layernorm",
           eps: float = 1e-5):
    """Fused residual add + LayerNorm/RMSNorm + scale/shift + per-token
    int8 quantization (the paper's Fused LN&Res kernel).

    ``x``, ``res`` (B, D) float32 or bf16 (each its own), ``weight`` and
    ``bias`` (D,); ``bias=None`` is zeros.  Returns ``(y bf16 (B, D), r
    (B, D) in res's dtype, y_q int8 (B, D), scale float32 (B, 1))``."""
    name = "ln_res"
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"{name}: unknown norm kind {kind!r}")
    D = x.shape[-1]
    if bias is None:
        bias = torch.zeros((D,), dtype=torch.float32, device=x.device)
    if not _route(name, x, res, weight, bias):
        return ref.ln_res_ref(x, res, weight, bias, kind=kind, eps=eps)
    _require(x.dim() == 2 and res.shape == x.shape,
             f"{name}: x {tuple(x.shape)} and res {tuple(res.shape)} must "
             "be one (B, D) shape")
    B = x.shape[0]
    _require(B > 0 and D > 0, f"{name}: empty input")
    for k, t in (("x", x), ("res", res)):
        _require(t.dtype in (torch.float32, torch.bfloat16),
                 f"{name}: {k} must be float32 or bfloat16, got {t.dtype}")
    _require(tuple(weight.shape) == (D,) and tuple(bias.shape) == (D,),
             f"{name}: weight and bias must be ({D},)")
    nv = _ln_res_chunks(D)
    _require(nv <= _LN_MAX_NV,
             f"{name}: D={D} exceeds the {8 * _LN_THREADS * _LN_MAX_NV} "
             "columns a block holds in registers")
    w32 = weight.float().contiguous()
    b32 = bias.float().contiguous()
    _contig(name, x=x, res=res)
    y = torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
    rn = torch.empty_like(res)
    yq = torch.empty((B, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    # 16-byte accesses when every row starts 16-byte aligned
    vec = D % 8 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (x, res, w32, b32, y, rn, yq))
    err = build.library().ln_res(
        x.data_ptr(), res.data_ptr(), w32.data_ptr(), b32.data_ptr(),
        y.data_ptr(), rn.data_ptr(), yq.data_ptr(), scale.data_ptr(),
        int(x.dtype == torch.bfloat16), int(res.dtype == torch.bfloat16), B,
        D, int(kind == "rmsnorm"), float(eps), nv, int(vec), _stream(x))
    _check_launch(name, err)
    ln_res.launches += 1
    return y, rn, yq, scale


@functools.cache
def _quant_act_geometry(K: int):
    """(threads, nv) of ``quant_act.cu`` for rows of ``K`` columns: the
    fewest 4-column chunks a thread (1, 2 or 4) with which a block of at
    most 1,024 threads holds the row in registers, and the fewest threads,
    a multiple of 32, that cover the row; past 16,384 columns, 1,024
    threads and two passes over the row (nv 0)."""
    chunks = -(-K // 4)
    for nv in (1, 2, 4):
        if chunks <= nv * _QA_MAX_THREADS:
            return 32 * -(-chunks // (32 * nv)), nv
    return _QA_MAX_THREADS, 0


def quant_act(x, smooth):
    """A W8A8 linear's input smoothed and quantized per token, in one
    launch: ``xs = x * (1 / smooth)``, then symmetric per-token int8.

    ``x`` (M, K) float32 or bf16, ``smooth`` float32 (K,).  Returns
    ``(x_q int8 (M, K), scale float32 (M, 1))``, bit for bit the plain
    version's (``ref.quant_act_ref``)."""
    name = "quant_act"
    if not _route(name, x, smooth):
        return ref.quant_act_ref(x, smooth)
    _require(x.dim() == 2 and x.shape[1] > 0
             and x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: x must be (M, K) float32 or bfloat16, K > 0")
    M, K = x.shape
    _require(smooth.dtype == torch.float32 and smooth.shape == (K,),
             f"{name}: smooth must be float32 ({K},)")
    _require(x.is_contiguous() and smooth.is_contiguous(),
             f"{name}: x and smooth must be contiguous")
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return x_q, scale
    threads, nv = _quant_act_geometry(K)
    # 16-byte loads and packed stores when every row starts aligned
    vec = (K % 4 == 0 and x.data_ptr() % 16 == 0
           and smooth.data_ptr() % 16 == 0)
    err = build.library().quant_act(
        x.data_ptr(), smooth.data_ptr(), x_q.data_ptr(), scale.data_ptr(), M,
        K, int(x.dtype == torch.bfloat16), threads, nv, int(vec), _stream(x))
    _check_launch(name, err)
    quant_act.launches += 1
    return x_q, scale


class MoeGeometry(NamedTuple):
    """Launch geometry of ``moe_experts.cu``."""
    mt: int         # m16 row tiles a block: 1, or 2 past 32 rows an expert
    m_tiles: int    # the grid's row tiles: an upper bound from the shapes


def _moe_geometry(Tk: int, E: int) -> MoeGeometry:
    """The row tiling of ``moe_experts`` for ``Tk`` sorted choices over
    ``E`` experts, from the shapes alone (the experts' counts live on the
    card): two m16 tiles a block when the experts hold 32 rows or more on
    average, else one; and the most row tiles any routing can need, each
    non-empty expert (at most ``min(E, Tk)``) rounding its rows up to a
    whole tile."""
    mt = 2 if Tk >= 2 * _MOE_M16 * E else 1
    bm = _MOE_M16 * mt
    return MoeGeometry(mt, (Tk + (bm - 1) * min(E, Tk)) // bm)


def moe_experts(x, order, offsets, w_gate, w_up, w_down, k: int, *,
                activation: str = "swiglu") -> torch.Tensor:
    """The MoE FFN's experts over the routed rows alone, in expert order.

    ``x`` (T, d) the tokens, float32 or bf16; ``order`` (T k,) int64, the
    flat choice (token ``order // k``) at each sorted position;
    ``offsets`` (E + 1,) int32, each expert's first sorted position;
    ``w_gate``, ``w_up`` (E, d, f) and ``w_down`` (E, f, d) bf16.  Returns
    ``y`` (T k, d) bf16: row p is expert e's FFN of its routed row, for
    ``offsets[e] <= p < offsets[e + 1]``, at the rounding points of
    ``models/moe.py`` (``activation`` ``"swiglu"`` or ``"geglu"``).

    On the card one call launches two CUDA functions (gate and up with
    the activation, then down; ``_moe_geometry``) and counts both."""
    name = "moe_experts"
    if not _route(name, x, order, offsets, w_gate, w_up, w_down):
        return ref.moe_experts_ref(x, order, offsets, w_gate, w_up, w_down,
                                   k, activation=activation)
    _require(activation in _MOE_ACTS,
             f"{name}: activation {activation!r} not one of "
             f"{tuple(_MOE_ACTS)}")
    _require(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: x must be (T, d) float32 or bfloat16")
    T, d = x.shape
    E, f = w_gate.shape[0], w_gate.shape[2]
    _require(w_gate.shape == w_up.shape == (E, d, f)
             and w_down.shape == (E, f, d),
             f"{name}: banks {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
             f"{tuple(w_down.shape)} do not fit x {tuple(x.shape)}")
    _require(all(w.dtype == torch.bfloat16 for w in (w_gate, w_up, w_down)),
             f"{name}: the banks must be bfloat16")
    _require(order.dtype == torch.int64 and tuple(order.shape) == (T * k,),
             f"{name}: order must be int64 ({T * k},)")
    _require(offsets.dtype == torch.int32
             and tuple(offsets.shape) == (E + 1,),
             f"{name}: offsets must be int32 ({E + 1},)")
    _require(d % 8 == 0 and f % 8 == 0,
             f"{name}: d {d} and f {f} must be multiples of 8")
    _contig(name, x=x, order=order, offsets=offsets, w_gate=w_gate,
            w_up=w_up, w_down=w_down)
    # the kernels stage rows and bank tiles with 16-byte copies
    _require(all(t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, w_down)),
             f"{name}: x and the banks must be 16-byte aligned")
    y = torch.empty((T * k, d), dtype=torch.bfloat16, device=x.device)
    if T * k == 0:
        return y
    h = torch.empty((T * k, f), dtype=torch.bfloat16, device=x.device)
    geo = _moe_geometry(T * k, E)
    _require(geo.m_tiles <= 65535, f"{name}: {T * k} rows exceed the grid")
    err = build.library().moe_experts(
        x.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
        y.data_ptr(), T, d, f, E, k, int(x.dtype == torch.bfloat16),
        _MOE_ACTS[activation], geo.mt, geo.m_tiles, _stream(x))
    _check_launch(name, err)
    moe_experts.launches += 2
    return y


reset_launch_counts()
