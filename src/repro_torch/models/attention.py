"""Attention: the full-sequence path (calibration forward), the paged
serving paths and the contiguous (stacked) cache paths.

Paged decode routes through the paged decode kernel
(``ops.paged_mha_decode``), chunked prefill and speculative verify
through the paged verify kernel (``ops.paged_verify``, causal or
tree-masked with ``anc``); both attend in place over the page pool, with
no gathered ``max_seq`` view.  On the contiguous ``(B, Hkv, S, hd)``
cache (``kv_layout="stacked"``, and the draft model of speculative
decoding) decode goes through the contiguous decode kernel
(``ops.mha_decode``) and a chunk attends in plain PyTorch, causal or
tree-masked, as in the reference.  A sliding-window layer keeps a ring
of W slots (slot = position mod W): its decode goes through the same
contiguous decode kernel over the ring, and its chunk attends in plain
PyTorch over the pre-write ring and its own K/V.  Whisper's encoder
attends unmasked through the full-sequence path, and its decoder's
cross-attention attends the encoder output there and, at decode, the
static cross cache through the contiguous decode kernel.  Caches and
page pools are updated **in place** (``index_put_``): the functions return them
only to keep the reference's call shape.

Where the JAX reference relies on jnp's clamped gathers and dropped
scatters, these functions mask explicitly (torch raises on out-of-range
indices, or would wrap a negative one): inactive decode rows and
out-of-range chunk positions resolve to the null page 0, whose content
is never unmasked, and contiguous-cache writes past the cache are
dropped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import linear, linear_init, rope

_NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device=None):
    kw = {"dtype": dtype, "device": device}
    return {
        "q": linear_init(gen, cfg.d_model, cfg.q_dim, **kw),
        "k": linear_init(gen, cfg.d_model, cfg.kv_dim, **kw),
        "v": linear_init(gen, cfg.d_model, cfg.kv_dim, **kw),
        "out": linear_init(gen, cfg.q_dim, cfg.d_model, **kw),
    }


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, name: str,
                 positions: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd); on a rotary stack q and k
    turned to ``positions`` (B, S), as the reference turns them."""
    B, S = x.shape[:2]
    q = linear(p["q"], x, name + ".q").reshape(
        B, S, cfg.n_heads, cfg.head_dim)
    k = linear(p["k"], x, name + ".k").reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p["v"], x, name + ".v").reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                   window: int = 0, causal: bool = True,
                   cross_kv: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                   name: str = ""):
    """Self-attention over a whole sequence (B, S, D) -> ``(out (B, S, D),
    (k, v))``, k and v (B, S, Hkv, hd) for a cache fill.  Causal unless
    ``causal=False`` (the encoder); with ``window`` each query attends
    only its last ``window`` keys (itself included).  ``cross_kv`` (k, v)
    (B, Se, Hkv, hd) takes the place of the sequence's own K/V, unmasked
    (the decoder's cross-attention): as in the reference, the sequence's
    k and v are still projected, so calibration records them under
    ``name + ".k"`` and ``".v"``."""
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, name, positions)
    if cross_kv is not None:
        k, v = cross_kv
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, S, cfg.n_kv_heads, group, cfg.head_dim)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.float(), k.float()) / (cfg.head_dim ** 0.5)
    if causal and cross_kv is None:
        ar = torch.arange(S, device=x.device)
        mask = ar[None, :] <= ar[:, None]
        if window:
            mask = mask & (ar[None, :] > ar[:, None] - window)
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    out = out.to(x.dtype).reshape(B, S, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), (k, v)


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache (B, Hkv, S, hd) <- new (B, Hkv, hd) at position ``pos[b]``
    per row, in place; a row whose position is outside the cache writes
    nothing (the reference's dropped scatter).  Such a row rewrites its
    slot 0 with that slot's own content, so no host sync is needed to
    filter it."""
    B, _, S, _ = cache.shape
    rows = torch.arange(B, device=cache.device)
    ok = (pos >= 0) & (pos < S)
    idx = torch.where(ok, pos, 0)
    cache[rows, :, idx] = torch.where(
        ok[:, None, None], new.to(cache.dtype), cache[rows, :, idx])


def decode_attention(
    p: Dict,
    x: torch.Tensor,  # (B, 1, D) current token
    cfg: ModelConfig,
    k_cache: torch.Tensor,  # (B, Hkv, S, hd) contiguous per-slot cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) i32 tokens already cached
    *,
    cross: bool = False,
    name: str = "",
):
    """One-token attention against the contiguous cache through the
    contiguous decode kernel (``ops.mha_decode``).  The new token (turned
    to position ``lengths[b]`` on a rotary stack) writes its K/V at that
    position first (a row at or past the cache end writes nothing), then
    it attends ``lengths[b] + 1`` positions.  With ``cross=True`` the
    cache is the static encoder K/V (whisper's cross-attention): nothing
    is written, the token attends ``lengths[b]`` positions (the encoder
    lengths), and only q is projected (the reference projects k and v
    too and drops them).  Returns ``(out (B, 1, D), k_cache,
    v_cache)``."""
    B = x.shape[0]
    if cross:
        q = linear(p["q"], x, name + ".q").reshape(
            B, 1, cfg.n_heads, cfg.head_dim)
        if cfg.pos == "rope":
            q = rope(q, lengths[:, None], cfg.rope_theta)
        attn_len = lengths.to(torch.int32)
    else:
        q, k, v = _project_qkv(p, cfg, x, name, lengths[:, None])
        pos = lengths.long()
        _write_rows(k_cache, k[:, 0], pos)
        _write_rows(v_cache, v[:, 0], pos)
        attn_len = (lengths + 1).to(torch.int32)
    out = ops.mha_decode(q[:, 0].contiguous(), k_cache, v_cache, attn_len)
    out = out.reshape(B, 1, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), k_cache, v_cache


def ring_decode_attention(
    p: Dict,
    x: torch.Tensor,  # (B, 1, D) current token
    cfg: ModelConfig,
    k_ring: torch.Tensor,  # (B, Hkv, W, hd) rotating-window cache
    v_ring: torch.Tensor,
    lengths: torch.Tensor,  # (B,) i32 position of the new token
    *,
    active: Optional[torch.Tensor] = None,  # (B,) bool rows really decoding
    name: str = "",
):
    """One-token sliding-window attention over a ring (slot = position mod
    W), through the contiguous decode kernel (``ops.mha_decode``).  The
    new token writes its K/V at slot ``lengths[b] % W`` (rows outside
    ``active`` write nothing: a ring has no length mask), then attends
    ``min(lengths[b], W) + 1`` entries.  Once the ring is full that is W
    + 1 > W: every slot holds one of the last W positions, and the kernel
    and its plain version both read no further than the ring's end.
    Returns ``(out (B, 1, D), k_ring, v_ring)``."""
    B = x.shape[0]
    W = k_ring.shape[2]
    q, k, v = _project_qkv(p, cfg, x, name, lengths[:, None])
    pos = lengths.long()
    rows = torch.arange(B, device=x.device)
    slot = pos % W
    ok = (torch.ones(B, dtype=torch.bool, device=x.device) if active is None
          else active)
    for ring, new in ((k_ring, k), (v_ring, v)):
        ring[rows, :, slot] = torch.where(
            ok[:, None, None], new[:, 0].to(ring.dtype), ring[rows, :, slot])
    out = ops.mha_decode(q[:, 0].contiguous(), k_ring, v_ring,
                         (torch.clamp_max(lengths, W) + 1).to(torch.int32))
    out = out.reshape(B, 1, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), k_ring, v_ring


def chunk_attention_rotating(
    p: Dict,
    x: torch.Tensor,  # (B, C, D) chunk of prompt / draft tokens
    cfg: ModelConfig,
    k_ring: torch.Tensor,  # (B, Hkv, W, hd) rotating-window cache
    v_ring: torch.Tensor,
    positions: torch.Tensor,  # (B, C) absolute positions, contiguous per row
    limits: torch.Tensor,  # (B,) positions at or past it write nothing
    *,
    name: str = "",
):
    """Multi-token attention for a sliding-window layer, in plain
    PyTorch as in the reference.  A ring cannot hold both the chunk's new
    K/V and the positions they evict, so the chunk attends over the
    *pre-write* ring (slot ``s`` holding the latest position below the
    row's chunk start congruent to ``s``) concatenated with its own K/V,
    under the mask ``query - W < key <= query``.  Then the ring is
    written in place, last write wins: only positions in ``[limit - W,
    limit)`` write, so an over-window chunk leaves the ring a token-by-
    token replay would, and padding or a parked verify row (``limits``
    at the chunk start) writes nothing.  The positions that do not write
    rewrite the slot of the row's last writing position with the same
    value, or, in a row that writes nothing, their slot with its own
    content: every slot written twice in one call gets one value, with no
    host sync to filter.  Returns ``(out (B, C, D), k_ring, v_ring)``."""
    B, C = x.shape[:2]
    W = k_ring.shape[2]
    dev = x.device
    q, k, v = _project_qkv(p, cfg, x, name, positions)
    # the chunk's K/V at ring precision, read and written alike
    k = k.to(k_ring.dtype)
    v = v.to(v_ring.dtype)
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, C, cfg.n_kv_heads, group, cfg.head_dim).float()
    pos = positions.long()
    off = pos[:, :1]  # (B, 1) first chunk position per row
    s_idx = torch.arange(W, device=dev)[None]
    cache_pos = off - 1 - torch.remainder(off - 1 - s_idx, W)  # (B, W)
    scale = cfg.head_dim ** 0.5
    sc_cache = torch.einsum("bqhgd,bhkd->bhgqk", qg, k_ring.float()) / scale
    sc_self = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / scale
    qpos = pos[:, None, None, :, None]
    cpos = cache_pos[:, None, None, None, :]
    mask_cache = (cpos >= 0) & (cpos > qpos - W)
    kpos = pos[:, None, None, None, :]
    mask_self = (kpos <= qpos) & (kpos > qpos - W)
    scores = torch.cat([torch.where(mask_cache, sc_cache, _NEG_INF),
                        torch.where(mask_self, sc_self, _NEG_INF)], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    vals = torch.cat([v_ring, v.transpose(1, 2)], dim=2)  # (B, Hkv, W+C, hd)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(vals.dtype).float(),
                       vals.float())
    out = out.to(x.dtype).reshape(B, C, cfg.q_dim)
    lim = limits.long()[:, None]
    wvalid = (pos < lim) & (pos >= lim - W)  # distinct slots
    last = (lim - 1 - off).clamp(0, C - 1)  # the last writing index
    src = torch.where(wvalid, torch.arange(C, device=dev)[None], last)
    slot = torch.remainder(torch.gather(pos, 1, src), W)
    writes = (lim > off)[..., None, None]  # (B, 1, 1, 1)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, C)
    for ring, new in ((k_ring, k), (v_ring, v)):
        ring[b_idx, :, slot] = torch.where(
            writes, new[b_idx, src], ring[b_idx, :, slot])
    return linear(p["out"], out, name + ".out"), k_ring, v_ring


def chunk_attention(
    p: Dict,
    x: torch.Tensor,  # (B, C, D) chunk of tokens
    cfg: ModelConfig,
    k_cache: torch.Tensor,  # (B, Hkv, S, hd) contiguous (slot-view) cache
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # (B, C) absolute positions
    *,
    anc: Optional[torch.Tensor] = None,  # (B, C, C) tree ancestor bitmask
    rope_positions: Optional[torch.Tensor] = None,  # (B, C) logical
    name: str = "",
):
    """Multi-token attention over the contiguous cache, in plain
    PyTorch as in the reference: the chunk's K/V are written at their
    positions first (positions outside the cache, such as a last prefill
    chunk hanging past ``max_seq`` or a verify row parked there, write
    nothing), then each query attends every key at or below its position.
    With ``anc`` (tree verify) query ``i`` attends every key below the
    chunk's base ``positions[:, 0]`` and exactly the chunk positions
    ``anc[b, i]`` names.  On a rotary stack q and k turn to
    ``rope_positions`` (a tree node's logical position, base + depth)
    where given, else to ``positions``, while the K/V land at
    ``positions``.  Returns ``(out (B, C, D), k_cache, v_cache)``."""
    B, C = x.shape[:2]
    S = k_cache.shape[2]
    q, k, v = _project_qkv(
        p, cfg, x, name,
        positions if rope_positions is None else rope_positions)
    pos = positions.long()
    # a position outside the cache rewrites its row's position 0 with that
    # position's own content (no boolean indexing: that would wait for the
    # device); a row that writes position 0 itself starts at 0 and, C being
    # at most S, has no position outside the cache
    ok = (pos >= 0) & (pos < S)
    idx = torch.where(ok, pos, 0)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, C)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[b_idx, :, idx] = torch.where(
            ok[..., None, None], new.to(cache.dtype), cache[b_idx, :, idx])
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, C, cfg.n_kv_heads, group, cfg.head_dim)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                          k_cache.float()) / (cfg.head_dim ** 0.5)
    ar_s = torch.arange(S, device=x.device)
    if anc is not None:
        base = pos[:, :1]  # (B, 1)
        rel = ar_s[None] - base  # (B, S) chunk-relative key position
        in_chunk = (rel >= 0) & (rel < C)
        bits = torch.gather(anc.bool(), 2,
                            rel.clamp(0, C - 1)[:, None, :].expand(B, C, S))
        mask = ((ar_s[None] < base)[:, None, :]
                | (in_chunk[:, None, :] & bits))[:, None, None]
    else:
        mask = ar_s[None, None, None, None, :] <= pos[:, None, None, :, None]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.to(x.dtype).reshape(B, C, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), k_cache, v_cache


def paged_decode_attention(
    p: Dict,
    x: torch.Tensor,  # (B, 1, D) current token
    cfg: ModelConfig,
    k_pages: torch.Tensor,  # (P, Hkv, ps, hd) global page pool
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) i32 tokens already cached
    block_table: torch.Tensor,  # (B, n_pg) i32
    *,
    active: Optional[torch.Tensor] = None,  # (B,) bool rows really decoding
    name: str = "",
):
    """One-token attention against the paged cache.

    The new token's K/V are written into the page the block table names
    for position ``lengths[b]``; rows the ``active`` mask declares as
    tag-alongs park their write on the null page (position ``n_pg * ps``,
    past the table), as the reference does; on a rotary stack every row
    turns to ``lengths[b]``, parked or not.  Idle rows may all write page
    0 at once: the write order there does not matter.  Returns
    ``(out (B, 1, D), k_pages, v_pages)``."""
    B = x.shape[0]
    ps, n_pg = k_pages.shape[2], block_table.shape[1]
    q, k, v = _project_qkv(p, cfg, x, name, lengths[:, None])
    wpos = lengths.long()
    if active is not None:
        wpos = torch.where(active, wpos, n_pg * ps)
    blk = wpos // ps
    rows = torch.arange(B, device=x.device)
    page = torch.where(
        blk < n_pg, block_table[rows, blk.clamp(max=n_pg - 1)].long(), 0)
    off = wpos % ps
    k_pages[page, :, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page, :, off] = v[:, 0].to(v_pages.dtype)
    out = ops.paged_mha_decode(
        q[:, 0].contiguous(), k_pages, v_pages,
        (lengths + 1).to(torch.int32), block_table)
    out = out.reshape(B, 1, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), k_pages, v_pages


def paged_chunk_attention(
    p: Dict,
    x: torch.Tensor,  # (B, C, D) chunk of prompt tokens
    cfg: ModelConfig,
    k_pages: torch.Tensor,  # (P, Hkv, ps, hd)
    v_pages: torch.Tensor,
    positions: torch.Tensor,  # (B, C) absolute positions, contiguous per row
    block_tables: torch.Tensor,  # (B, n_pg) i32
    *,
    anc: Optional[torch.Tensor] = None,  # (B, C, C) i32 ancestor bitmask
    rope_positions: Optional[torch.Tensor] = None,  # (B, C) logical
    name: str = "",
):
    """Multi-token attention in place over the paged cache (chunked
    prefill, speculative verify).  The chunk's K/V are scattered into the
    pages the block table names for each position, then the chunk queries
    attend through the paged verify kernel with ``base = positions[:,
    0]``.  Positions whose block is past the table (a last chunk hanging
    past the cache, a verify row parked at ``max_seq``) resolve to the
    null page explicitly.  With ``anc`` (tree verify) query ``j`` attends
    the row's prefix and exactly the chunk positions its bits name; the
    K/V still land at the flat chunk positions, so they survive
    :func:`repro_torch.models.lm.compact_accepted_path`, while on a rotary
    stack q and k turn to ``rope_positions``, each node's logical position
    (base + depth).  (With learned positions the logical position moves
    the position embedding instead, which
    :func:`repro_torch.models.lm.verify_chunk` adds.)  Returns ``(out (B,
    C, D), k_pages, v_pages)``."""
    B, C = x.shape[:2]
    ps, n_pg = k_pages.shape[2], block_tables.shape[1]
    q, k, v = _project_qkv(
        p, cfg, x, name,
        positions if rope_positions is None else rope_positions)
    pos = positions.long()
    blk = pos // ps
    page = torch.where(
        blk < n_pg,
        torch.gather(block_tables.long(), 1, blk.clamp(0, n_pg - 1)), 0)
    off = pos % ps
    k_pages[page, :, off] = k.to(k_pages.dtype)
    v_pages[page, :, off] = v.to(v_pages.dtype)
    out = ops.paged_verify(
        q.contiguous(), k_pages, v_pages,
        positions[:, 0].to(torch.int32).contiguous(), block_tables, anc=anc)
    out = out.reshape(B, C, cfg.q_dim)
    return linear(p["out"], out, name + ".out"), k_pages, v_pages
