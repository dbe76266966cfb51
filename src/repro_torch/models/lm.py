"""Decoder-only language model: init, full-sequence forward, and the
serving steps (``decode_step``, ``prefill_into_slot``, the speculative
``verify_chunk`` and ``compact_accepted_path``).

Parameters are ``{"embed": {"table"}, "layers": [block params...],
"final_ln", "pos_embed"[, "lm_head"]}`` — one dict per layer, where the
JAX package stacks layers on a ``periods`` axis for ``lax.scan``; the
weight bridge (``repro_torch/bridge.py``) converts between the two.  The
cache is ``{"layers": [{"k", "v"}]}``, per layer either a page pool
``(P, Hkv, ps, hd)`` addressed through block tables (``layout="paged"``)
or a contiguous ``(B, Hkv, max_seq, hd)`` per-slot cache
(``layout="stacked"``, which the draft model uses too).  The serving
steps update it in place and also return it;
:func:`gather_request_cache` / :func:`scatter_request_cache` copy one
request's share of it to host memory and back (preemption to host).

The stacks served are decoders with every layer global ``attn``: GPT-2
(learned positions, tied embeddings), the RoPE family (Llama, TinyLlama,
Minitron, Gemma: rotary positions, GQA, an untied ``lm_head`` or a tied
one) and the MoE decoders (OLMoE, Kimi K2: the same with a top-k MoE
FFN); no other block kind and no encoder.  Anything else raises
``NotImplementedError`` (:func:`check_supported`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (apply_norm, embed, embed_init,
                                       linear, linear_init, norm_init,
                                       unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a stack this package cannot run."""
    bad = []
    if any(k != "attn" for k in cfg.block_pattern):
        bad.append(f"block kinds {sorted(set(cfg.block_pattern))}")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        bad.append("encoder/frontend")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported (global-attention "
            "decoder stacks only)")


def init(cfg: ModelConfig, gen: torch.Generator, *, max_seq: int = 0,
         dtype=torch.float32, device=None) -> Dict:
    """Random parameters drawn from ``gen`` (which must live on
    ``device``), with the JAX package's init scales."""
    check_supported(cfg)
    kw = {"dtype": dtype, "device": device}
    params: Dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "layers": [blocks.block_init(gen, cfg, cfg.block_kind(li), **kw)
                   for li in range(cfg.n_layers)],
        "final_ln": norm_init(cfg.d_model, cfg.norm, **kw),
    }
    if cfg.pos == "learned":
        if max_seq <= 0:
            raise ValueError("learned positions need max_seq at init")
        params["pos_embed"] = torch.randn(
            (max_seq, cfg.d_model), generator=gen, **kw) * 0.01
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        **kw)
    return params


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    x = apply_norm(params["final_ln"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x, "lm_head")


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Logits (B, S, V) of a full causal sequence (B, S)."""
    check_supported(cfg)
    S = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][None, :S].to(dtype)
    for li, layer_p in enumerate(params["layers"]):
        x = blocks.block_apply_seq(layer_p, x, cfg, cfg.block_kind(li),
                                   name=f"l{li}")
    return _logits(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: str = "paged", dtype=torch.bfloat16,
               device=None) -> Dict:
    """The KV cache.  ``layout="paged"``: per layer a pool of ``batch``
    pages of ``max_seq`` (= page size) tokens, page 0 being the null page.
    ``layout="stacked"``: per layer ``batch`` contiguous slots of
    ``max_seq`` positions.  (The reference's argument order; its default
    layout is "stacked", this package's engine default is "paged".)"""
    if layout not in ("paged", "stacked"):
        raise NotImplementedError(
            f"cache layout {layout!r} is not ported: only 'paged' and "
            "'stacked' are")
    check_supported(cfg)
    return {"layers": [
        blocks.block_init_cache(cfg, cfg.block_kind(li), batch, max_seq,
                                dtype=dtype, device=device)
        for li in range(cfg.n_layers)]}


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict, lengths: torch.Tensor, *,
                block_table: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                dtype=torch.bfloat16):
    """One auto-regressive step for every row: ``token`` (B, 1) enters at
    position ``lengths[b]``.  With ``block_table`` (B, n_pg) the cache is
    the page pool and rows outside ``active`` ride along with their
    writes parked on the null page; without, it is the stacked cache,
    row ``b`` being slot ``b``.  Returns ``(logits (B, V), cache)``."""
    x = embed(params["embed"], token, dtype)  # (B, 1, d)
    if cfg.pos == "learned":
        # idle rows may sit at the table end: clamp explicitly (the
        # reference's gather clamps implicitly); their logits go unused
        P = params["pos_embed"].shape[0]
        pos = lengths.long().clamp(max=P - 1)
        x = x + params["pos_embed"].to(dtype)[pos][:, None]
    layers = []
    for li, layer_p in enumerate(params["layers"]):
        x, c = blocks.block_apply_step(
            layer_p, x, cache["layers"][li], lengths, cfg,
            cfg.block_kind(li), block_table=block_table, active=active,
            name=f"l{li}")
        layers.append(c)
    return _logits(params, cfg, x)[:, 0], {"layers": layers}


def prefill_into_slot(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict, offset: int, *,
                      block_table: Optional[torch.Tensor] = None,
                      slot: Optional[int] = None,
                      valid: Optional[int] = None,
                      dtype=torch.bfloat16):
    """Chunked prefill: write one prompt chunk ``tokens`` (C,), right-padded
    past ``valid`` real tokens, at absolute positions ``offset..`` of one
    request, with one forward call: on the page pool through the
    request's block-table row ``block_table`` (n_pg,), or, without a
    table, into slot ``slot`` of the stacked cache (positions past the
    cache are dropped).  The chunk attends causally over itself and the
    request's cache below ``offset``; padding lands above the prompt and
    stays masked by the length accounting.  Returns
    ``(logits (V,) f32 at chunk position valid - 1, cache)``."""
    C = tokens.shape[-1]
    valid = C if valid is None else int(valid)
    if (block_table is None) == (slot is None):
        raise ValueError("pass exactly one of block_table (paged cache) "
                         "and slot (stacked cache)")
    tokens = tokens.reshape(1, C)
    positions = (offset + torch.arange(C, device=tokens.device))[None]
    x = embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        # clipped gather: the last chunk may hang past the table end
        P = params["pos_embed"].shape[0]
        x = x + params["pos_embed"][positions.clamp(0, P - 1)].to(dtype)
    if block_table is None:
        # the slot's rows of the stacked cache, as views written in place
        view = [{k: t[slot:slot + 1] for k, t in c.items()}
                for c in cache["layers"]]
        bts = None
    else:
        view = cache["layers"]
        bts = block_table[None]
    for li, layer_p in enumerate(params["layers"]):
        x, _ = blocks.block_apply_chunk(
            layer_p, x, view[li], cfg, cfg.block_kind(li),
            positions=positions, block_tables=bts, name=f"l{li}")
    logits = _logits(params, cfg, x[:, valid - 1:valid])
    return logits[0, 0].float(), cache


def gather_request_cache(cfg: ModelConfig, cache: Dict, slot: int, *,
                         page_ids=None) -> Dict:
    """Copy one request's cache to host memory (preemption to host): slot
    ``slot`` of a stacked cache, or with ``page_ids`` the request's pages
    of the page pool, in block-table order.  Returns ``{"layers": [{"k",
    "v"}]}`` of CPU tensors that no later write to the cache touches;
    :func:`scatter_request_cache` is its inverse."""
    idx = slot if page_ids is None else torch.as_tensor(
        list(page_ids), dtype=torch.long,
        device=cache["layers"][0]["k"].device)
    return {"layers": [{k: t[idx].to("cpu", copy=True)
                        for k, t in layer.items()}
                       for layer in cache["layers"]]}


def scatter_request_cache(cfg: ModelConfig, cache: Dict, blob: Dict,
                          slot: int, *, page_ids=None) -> Dict:
    """Write a :func:`gather_request_cache` snapshot back into slot
    ``slot`` of a stacked cache, or into the pages ``page_ids`` (the
    restore target's, in block-table order; they need not be the pages it
    was gathered from).  In place; returns the cache."""
    idx = slot if page_ids is None else torch.as_tensor(
        list(page_ids), dtype=torch.long,
        device=cache["layers"][0]["k"].device)
    for layer, saved in zip(cache["layers"], blob["layers"]):
        for k, t in layer.items():
            t[idx] = saved[k].to(t.device, t.dtype)
    return cache


def verify_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: Dict, lengths: torch.Tensor, *,
                 block_tables: Optional[torch.Tensor] = None,
                 anc: Optional[torch.Tensor] = None,
                 depths: Optional[torch.Tensor] = None,
                 dtype=torch.bfloat16):
    """Score C tokens per row against the cache in ONE forward call
    (speculative verification).  Row ``b``'s tokens occupy positions
    ``lengths[b] .. lengths[b] + C - 1``; their K/V are written into the
    pages the row's table names (``block_tables``), or into slot ``b`` of
    the stacked cache (without), and ``logits[b, i]`` is the next-token
    distribution after ``tokens[b, :i + 1]``.  A row parked at
    ``lengths[b] >= max_seq`` writes nothing (the null page, or a dropped
    write) and its logits must not be used.

    Tree verification (``anc`` (B, C, C), ``depths`` (B, C)): position
    ``j`` holds a tree node in DFS layout.  Its K/V still land at the flat
    position ``lengths[b] + j``, it attends the row's prefix and exactly
    the chunk positions ``anc[b, j]`` names (its root path), and its
    position signal (the position embedding, or the rotary phase of its q
    and k) is that of its logical position ``lengths[b] + depths[b, j]``,
    so ``logits[b, j]`` follows the context plus ``j``'s root path.
    Returns ``(logits (B, C, V) f32, cache)``."""
    B, C = tokens.shape
    dev = tokens.device
    base = lengths.long()[:, None]
    positions = base + torch.arange(C, device=dev)[None]
    logical = None if depths is None else base + depths.long()
    x = embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        # logical positions drive the embedding; parked rows and padding
        # read a clamped row, as the reference's clipped gather does
        epos = positions if logical is None else logical
        P = params["pos_embed"].shape[0]
        x = x + params["pos_embed"][epos.clamp(0, P - 1)].to(dtype)
    if anc is not None:
        anc = anc.to(torch.int32).contiguous()
    for li, layer_p in enumerate(params["layers"]):
        x, _ = blocks.block_apply_chunk(
            layer_p, x, cache["layers"][li], cfg, cfg.block_kind(li),
            positions=positions, block_tables=block_tables, anc=anc,
            rope_positions=logical, name=f"l{li}")
    return _logits(params, cfg, x).float(), cache


def compact_accepted_path(cfg: ModelConfig, cache: Dict, src: torch.Tensor,
                          dst: torch.Tensor, *,
                          block_tables: Optional[torch.Tensor] = None
                          ) -> Dict:
    """Copy an accepted tree path's K/V from its flat chunk positions
    ``src`` (B, m) to the contiguous positions ``dst`` (B, m) plain decode
    would have used, in every layer: through the block tables as they
    were at verify time (call it before ``rewind`` releases pages), or,
    without, in row ``b`` of the stacked cache.  Entries whose ``dst``
    lies outside the row's table or cache are dropped, never redirected
    onto live K/V or the null page.  Every source is read before any
    target is written, so overlapping paths move correctly.  The indices
    are resolved on the device of ``src``/``dst``/``block_tables`` (host
    tensors cost the card no sync) and then moved to the cache's.
    Returns the cache."""
    src, dst = src.long(), dst.long()
    rows = torch.arange(src.shape[0], device=src.device)[:, None].expand(
        src.shape)
    dev = cache["layers"][0]["k"].device
    if block_tables is None:
        S = cache["layers"][0]["k"].shape[2]
        keep = (dst >= 0) & (dst < S)
        r, s_, d_ = (t[keep].to(dev) for t in (rows, src.clamp(0, S - 1),
                                               dst))
        for c in cache["layers"]:
            for t in c.values():
                t[r, :, d_] = t[r, :, s_]
        return cache
    bt = block_tables.long()
    n_pg = bt.shape[1]
    ps = cache["layers"][0]["k"].shape[2]
    keep = (dst >= 0) & (dst < n_pg * ps)
    r, s_, d_ = rows[keep], src[keep], dst[keep]
    blk_s = s_ // ps
    pg_s = torch.where(blk_s < n_pg, bt[r, blk_s.clamp(0, n_pg - 1)], 0)
    pg_d = bt[r, d_ // ps]
    pg_s, off_s, pg_d, off_d = (t.to(dev) for t in
                                (pg_s, s_ % ps, pg_d, d_ % ps))
    for c in cache["layers"]:
        for pool in c.values():
            pool[pg_d, :, off_d] = pool[pg_s, :, off_s]
    return cache
