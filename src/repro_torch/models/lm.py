"""Language models: init (and ``init_abstract``, shapes and dtypes on
the meta device), the full-sequence forward and the training loss
(``loss_fn``), and the serving steps
(``decode_step``, ``prefill_into_slot``, the speculative
``verify_chunk``, ``compact_accepted_path`` and, for rings and recurrent
states, ``verify_snapshot`` and ``commit_verify``), plus whisper's
encoder (``encode``) and the model-level prefills of the reference
(``prefill``, a replay through ``decode_step``, and ``batch_prefill``,
one forward whose states fill the cache).

Parameters are ``{"embed": {"table"}, "layers": [block params...],
"final_ln", "pos_embed"[, "lm_head"][, "encoder"]}`` — one dict per
layer, where the JAX package stacks layers on a ``periods`` axis for
``lax.scan``; the weight bridge (``repro_torch/bridge.py``) converts
between the two.  The cache is ``{"layers": [...]}``, per attention
layer ``{"k", "v"}``: either a page pool ``(P, Hkv, ps, hd)`` addressed
through block tables (``layout="paged"``) or a contiguous ``(B, Hkv,
max_seq, hd)`` per-slot cache (``layout="stacked"``, which the draft
model uses too); a recurrent layer's entry is its state
(``blocks.init_state``).  The paged layout is per kind: only global
``attn`` layers take the page pool, while a mixed stack's rings and
recurrent states stay slot-resident, one row per slot as on the stacked
layout (``init_cache(layout="paged", slots=, slot_seq=)``).  The serving
steps update it in place and also return it;
:func:`gather_request_cache` / :func:`scatter_request_cache` copy one
request's share of it to host memory and back (preemption to host).

The stacks served are decoders of any of the reference's decoder block
kinds: global ``attn`` (GPT-2 with learned positions and tied
embeddings; the RoPE family, Llama, TinyLlama, Minitron, Gemma; the MoE
decoders, OLMoE and Kimi K2), and the hybrid stacks' ``local_attn``,
``rglru``, ``mlstm`` and ``slstm`` (RecurrentGemma, xLSTM).  A
sliding-window layer's cache is a ring of ``min(window, max_seq)`` slots
and a recurrent layer's a carried state, both one row per slot, beside
the other layers' K/V; pages hold global ``attn`` layers only, so a
mixed stack pages its ``attn`` layers and keeps the rest slot-resident,
and an attention-free stack does not page.  Whisper
(``is_encoder_decoder``) adds an encoder over stub frame embeddings and a cross sub-block per decoder
layer, whose decode attends a static ``cache["cross"]`` filled at
prefill; Pixtral's stub patch embeddings go before the tokens in
:func:`forward` and :func:`batch_prefill` (the serving engine, like the
reference's, takes tokens only).

Rings and states have no length mask, so a speculative verify that
rejects drafts must undo them: :func:`verify_snapshot` copies the ring
slots a verify will overwrite, and :func:`commit_verify` puts back those
of rejected drafts and selects each recurrent state off the verify's
trajectory.

Over a mesh, the distributed engine's ``sharded_decode_step``,
``sharded_prefill_into_slot``, ``sharded_verify_chunk``,
``sharded_commit_verify`` and ``sharded_compact_accepted_path`` call
these on each shard's own cache, one cache dict per shard.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (apply_norm, embed, embed_init,
                                       linear, linear_init, norm_init,
                                       unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind this package does
    not know; every registered config passes."""
    unknown = sorted(set(cfg.block_pattern) - set(blocks.KINDS))
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {unknown} not ported (stacks of "
            f"{', '.join(blocks.KINDS)} only)")


def _paged_gate(cfg: ModelConfig, what: str) -> None:
    """Refuse the paged layout for a stack with no global-attention layer
    (nothing to page), naming every layer, with the reference's
    ``ValueError``.  A mixed stack pages its ``attn`` layers and keeps
    its rings and recurrent states slot-resident."""
    if blocks.paged_capable(cfg):
        return
    bad = ", ".join(
        f"layer {i} ({cfg.block_kind(i)})" for i in range(cfg.n_layers)
        if cfg.block_kind(i) != "attn")
    raise ValueError(
        f"{what} requires at least one global-attention layer for the "
        f"paged layout, but every layer of this stack is non-pageable "
        f"({bad}) — serve it with the stacked layout")


def _slot_resident(cfg: ModelConfig, li: int, paged: bool) -> bool:
    """True when layer ``li``'s cache entry has one row per slot: every
    entry of a stacked cache, the rings and states of a paged one."""
    return not paged or cfg.block_kind(li) != "attn"


def init(cfg: ModelConfig, gen: Optional[torch.Generator], *,
         max_seq: int = 0, dtype=torch.float32, device=None) -> Dict:
    """Random parameters drawn from ``gen`` (which must live on
    ``device``), with the JAX package's init scales.  An encoder-decoder
    adds ``"encoder": {"layers", "final_ln", "pos_embed"}`` and a cross
    sub-block in every decoder layer.  On the meta device nothing is
    drawn and ``gen`` may be None (:func:`init_abstract`)."""
    check_supported(cfg)
    kw = {"dtype": dtype, "device": device}
    cross = cfg.is_encoder_decoder
    params: Dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "layers": [blocks.block_init(gen, cfg, cfg.block_kind(li),
                                     cross=cross, **kw)
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
    if cross:
        params["encoder"] = {
            "layers": [blocks.block_init(gen, cfg, "attn", **kw)
                       for _ in range(cfg.n_encoder_layers)],
            "final_ln": norm_init(cfg.d_model, cfg.norm, **kw),
            "pos_embed": torch.randn((cfg.encoder_seq, cfg.d_model),
                                     generator=gen, **kw) * 0.01,
        }
    return params


def init_abstract(cfg: ModelConfig, *, max_seq: int = 0,
                  dtype=torch.float32) -> Dict:
    """The parameter tree's shapes and dtypes as meta tensors, with no
    allocation and no generator (the reference's ``jax.eval_shape`` of
    ``init``)."""
    return init(cfg, None, max_seq=max_seq, dtype=dtype, device="meta")


def encode(params: Dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder: ``frames`` (B, Se, d), the stub frontend's
    embeddings, plus the encoder's positions, through its unmasked
    attention layers and final norm -> (B, Se, d) in ``frames``' dtype."""
    enc = params["encoder"]
    Se = frames.shape[1]
    x = frames + enc["pos_embed"][None, :Se].to(frames.dtype)
    for layer_p in enc["layers"]:
        x, _, _ = blocks.block_apply_seq(layer_p, x, cfg, "attn",
                                         causal=False)
    return apply_norm(enc["final_ln"], x, cfg.norm)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    x = apply_norm(params["final_ln"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x, "lm_head")


def _forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
             frames: Optional[torch.Tensor] = None,
             patches: Optional[torch.Tensor] = None,
             remat: bool = False, moe_cf: Optional[float] = 1.25,
             dtype=torch.bfloat16):
    """``(logits (B, S_tot, V), aux, states, encoder_out)``: ``aux`` is
    the layers' MoE aux loss summed (float32; 0 without experts),
    ``states`` every layer's prefill-to-decode handoff
    (:func:`blocks.block_apply_seq`); ``encoder_out`` is None for a
    decoder-only stack.  ``patches`` (B, P, d) go before the token
    embeddings (S_tot = P + S) and take positions 0..P-1; an
    encoder-decoder needs ``frames``.  ``moe_cf`` is the experts'
    capacity factor (None: exact).  ``remat`` recomputes each decoder
    layer in the backward pass instead of keeping its activations (the
    reference checkpoints each pattern period)."""
    check_supported(cfg)
    x = embed(params["embed"], tokens, dtype)
    if patches is not None:
        x = torch.cat([patches.to(dtype), x], dim=1)
    S_tot = x.shape[1]
    if cfg.pos == "learned":
        x = x + params["pos_embed"][None, :S_tot].to(dtype)
    encoder_out = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} is encoder-decoder: pass frames")
        encoder_out = encode(params, cfg, frames.to(dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    states = []
    for li, layer_p in enumerate(params["layers"]):
        fn = blocks.block_apply_seq
        if remat:
            fn = partial(checkpoint, fn, use_reentrant=False)
        x, a, st = fn(layer_p, x, cfg, cfg.block_kind(li),
                      encoder_out=encoder_out, moe_cf=moe_cf,
                      name=f"l{li}")
        aux = aux + a
        states.append(st)
    return _logits(params, cfg, x), aux, states, encoder_out


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            moe_cf: Optional[float] = 1.25,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Logits (B, S_tot, V) of a full causal sequence (B, S): with
    ``patches`` (B, P, d) the patch prefix comes first (S_tot = P + S);
    an encoder-decoder attends the encoding of ``frames`` (B, Se, d).
    ``moe_cf`` defaults to the reference's training capacity factor;
    serving callers pass None (exact capacity)."""
    return _forward(params, cfg, tokens, frames=frames, patches=patches,
                    moe_cf=moe_cf, dtype=dtype)[0]


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False, aux_weight: float = 0.01):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE aux loss
    -> ``(loss, {"ce", "aux"})``, float32 scalars.  ``batch``: ``tokens``
    (B, S) [+ ``frames`` / ``patches``]; position t predicts token t + 1
    over the text region only.  The reference's operations in its order:
    logits in the forward's dtype (bf16), the row max taken there and
    detached, the shift in that dtype, exp and sum in float32; the gold
    logit is a gather, equal bit for bit to the reference's one-hot
    contraction (a form it takes for vocab sharding)."""
    tokens = batch["tokens"]
    logits, aux, _, _ = _forward(
        params, cfg, tokens, frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat)
    n_prefix = logits.shape[1] - tokens.shape[1]
    lg = logits[:, n_prefix:-1]
    tgt = tokens[:, 1:].long()
    gold = lg.gather(-1, tgt[..., None])[..., 0].float()
    m = lg.amax(dim=-1).detach()
    shifted = lg - m[..., None]
    sumexp = torch.exp(shifted.float()).sum(dim=-1)
    lse = m.float() + torch.log(sumexp)
    ce = (lse - gold).mean()
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: str = "paged", dtype=torch.bfloat16,
               device=None, *, slots: Optional[int] = None,
               slot_seq: Optional[int] = None) -> Dict:
    """The cache.  ``layout="paged"`` (stacks with a global-attention
    layer): per ``attn`` layer a pool of ``batch`` pages of ``max_seq``
    (= page size) tokens, page 0 being the null page; a mixed stack's
    rings and recurrent states stay slot-resident, ``slots`` rows of
    ``slot_seq`` positions each (``ValueError`` without them).
    ``layout="stacked"``: per layer ``batch`` rows, contiguous
    ``max_seq`` positions for an ``attn`` layer, a ring of ``min(window,
    max_seq)`` slots for ``local_attn``, a carried state for a recurrent
    kind.  (The reference's argument order; its default layout is
    "stacked", this package's engine default is "paged".)"""
    if layout not in ("paged", "stacked"):
        raise NotImplementedError(
            f"cache layout {layout!r} is not ported: only 'paged' and "
            "'stacked' are")
    check_supported(cfg)
    paged = layout == "paged"
    if paged:
        _paged_gate(cfg, "init_cache")
        if not blocks.page_addressable(cfg) and (slots is None
                                                 or slot_seq is None):
            raise ValueError(
                "a mixed paged stack keeps its non-attn state slot-resident"
                " — pass slots= and slot_seq= alongside the page pool dims")

    def entry(li):
        kind = cfg.block_kind(li)
        rows, seq = ((slots, slot_seq) if paged and kind != "attn"
                     else (batch, max_seq))
        return blocks.block_init_cache(cfg, kind, rows, seq, dtype=dtype,
                                       device=device)

    cache = {"layers": [entry(li) for li in range(cfg.n_layers)]}
    if cfg.is_encoder_decoder:
        shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
        cache["cross"] = [
            {k: torch.zeros(shape, dtype=dtype, device=device)
             for k in ("k", "v")} for _ in range(cfg.n_layers)]
    return cache


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict, lengths: torch.Tensor, *,
                block_table: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                enc_lengths: Optional[torch.Tensor] = None,
                moe_cf: Optional[float] = None, dtype=torch.bfloat16):
    """One auto-regressive step for every row: ``token`` (B, 1) enters at
    position ``lengths[b]``.  With ``block_table`` (B, n_pg) the cache is
    the paged one: ``attn`` layers address the page pool through it, rows
    outside ``active`` riding along with their writes parked on the null
    page, and a mixed stack's rings and states take row ``b`` as slot
    ``b``; without, it is the stacked cache, row ``b`` being slot ``b``.
    Either way rows outside ``active`` leave their rings and recurrent
    states untouched (their global K/V writes stay masked).
    An encoder-decoder's layers also attend the first ``enc_lengths[b]``
    positions of the cache's static ``"cross"`` K/V.  ``moe_cf`` is the
    experts' capacity factor (None, the serving paths': exact).  Returns
    ``(logits (B, V), cache)``."""
    x = embed(params["embed"], token, dtype)  # (B, 1, d)
    if cfg.pos == "learned":
        # idle rows may sit at the table end: clamp explicitly (the
        # reference's gather clamps implicitly); their logits go unused
        P = params["pos_embed"].shape[0]
        pos = lengths.long().clamp(max=P - 1)
        x = x + params["pos_embed"].to(dtype)[pos][:, None]
    cross = cache.get("cross")
    if cross is not None and enc_lengths is None:
        raise ValueError(f"{cfg.name} is encoder-decoder: pass enc_lengths")
    layers = []
    for li, layer_p in enumerate(params["layers"]):
        x, c = blocks.block_apply_step(
            layer_p, x, cache["layers"][li], lengths, cfg,
            cfg.block_kind(li), block_table=block_table, active=active,
            cross_cache=None if cross is None else cross[li],
            enc_lengths=enc_lengths, moe_cf=moe_cf, name=f"l{li}")
        layers.append(c)
    out = dict(cache)
    out["layers"] = layers
    return _logits(params, cfg, x)[:, 0], out


def prefill_into_slot(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict, offset: int, *,
                      block_table: Optional[torch.Tensor] = None,
                      slot: Optional[int] = None,
                      valid: Optional[int] = None,
                      dtype=torch.bfloat16):
    """Chunked prefill: write one prompt chunk ``tokens`` (C,), right-padded
    past ``valid`` real tokens, at absolute positions ``offset..`` of one
    request, with one forward call.  With ``block_table`` (the request's
    row, (n_pg,)) the cache is the paged one: ``attn`` layers write and
    read the page pool through it, and a mixed stack's rings and states
    use row ``slot`` of their slot-resident entries.  Without a table,
    slot ``slot`` of the stacked cache (positions past the cache are
    dropped).  The chunk attends causally over itself and the request's
    cache below ``offset``; padding lands above the prompt and stays
    masked by the length accounting, writes no ring slot and commits no
    recurrent state (a recurrent layer commits its state after ``valid``
    tokens).  Returns
    ``(logits (V,) f32 at chunk position valid - 1, cache)``."""
    C = tokens.shape[-1]
    valid = C if valid is None else int(valid)
    paged = block_table is not None
    if not paged and slot is None:
        raise ValueError("pass block_table (paged cache) or slot (stacked "
                         "cache)")
    if paged and slot is None and not blocks.page_addressable(cfg):
        raise ValueError("a mixed paged stack needs slot= for its "
                         "slot-resident rings and states")
    tokens = tokens.reshape(1, C)
    positions = (offset + torch.arange(C, device=tokens.device))[None]
    valids = torch.full((1,), valid, dtype=torch.int32, device=tokens.device)
    x = embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        # clipped gather: the last chunk may hang past the table end
        P = params["pos_embed"].shape[0]
        x = x + params["pos_embed"][positions.clamp(0, P - 1)].to(dtype)
    # the page pool whole, the slot's rows as views written in place
    view = [{k: t[slot:slot + 1] for k, t in c.items()}
            if _slot_resident(cfg, li, paged) else c
            for li, c in enumerate(cache["layers"])]
    bts = block_table[None] if paged else None
    for li, layer_p in enumerate(params["layers"]):
        x, _, _ = blocks.block_apply_chunk(
            layer_p, x, view[li], cfg, cfg.block_kind(li),
            positions=positions, valids=valids, block_tables=bts,
            name=f"l{li}")
    logits = _logits(params, cfg, x[:, valid - 1:valid])
    return logits[0, 0].float(), cache


def _fill_cross_cache(params: Dict, cfg: ModelConfig, cache: Dict,
                      enc_out: torch.Tensor) -> Dict:
    """Write every decoder layer's static cross K/V, ``cross_kv`` of the
    encoder output laid out (B, Hkv, Se, hd), into ``cache["cross"]``.
    The entries are new contiguous tensors in the projections' dtype, as
    the reference's are (it keeps no cache dtype there)."""
    cache["cross"] = [
        {k: t.transpose(1, 2).contiguous() for k, t in zip(
            ("k", "v"), blocks.cross_kv(p["cross_attn"], enc_out, cfg))}
        for p in params["layers"]]
    return cache


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lengths: torch.Tensor, cache: Dict, *,
            frames: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
    """Sequential prefill on the stacked cache: the right-padded prompts
    ``tokens`` (B, S) of ``prompt_lengths`` (B,) tokens replay through
    :func:`decode_step` one position a call, from position 0 (an
    encoder-decoder first encodes ``frames`` and fills the cross cache).
    Every row writes at every step; a row past its prompt keeps its
    length, so its later writes stay masked.  Returns ``(last_logits (B,
    V) f32 at each row's last prompt token, cache, lengths)``."""
    B, S = tokens.shape
    dev = tokens.device
    enc_lengths = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, frames.to(dtype))
        cache = _fill_cross_cache(params, cfg, cache, enc_out)
        enc_lengths = torch.full((B,), enc_out.shape[1], dtype=torch.int32,
                                 device=dev)
    plen = prompt_lengths.to(dev).long()
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    last = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)
    for t in range(S):
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                    lengths, enc_lengths=enc_lengths,
                                    dtype=dtype)
        lengths = lengths + (t < plen).to(torch.int32)
        last = torch.where((t == plen - 1)[:, None], logits.float(), last)
    return last, cache, lengths


def batch_prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, *, frames: Optional[torch.Tensor] = None,
                  patches: Optional[torch.Tensor] = None,
                  moe_cf: Optional[float] = None, dtype=torch.bfloat16):
    """Parallel prefill on the stacked cache: one full-sequence forward of
    the uniform prompts ``tokens`` (B, S) (after ``patches`` (B, P, d),
    if given) whose every layer's state is written into rows ``0..B-1``
    of the cache, in place: K/V at positions ``0..S_tot-1`` and zeros
    above, a ring's last W positions at their slots, a recurrent layer's
    final state; an encoder-decoder also fills its cross cache.
    ``moe_cf`` is the experts' capacity factor (None: exact).  Returns
    ``(last_logits (B, V) f32, cache, lengths)``, every length S_tot."""
    B, S = tokens.shape
    logits, _, states, enc_out = _forward(
        params, cfg, tokens, frames=frames, patches=patches, moe_cf=moe_cf,
        dtype=dtype)
    S_tot = logits.shape[1]
    for li, (state, entry) in enumerate(zip(states, cache["layers"])):
        kind = cfg.block_kind(li)
        if kind not in ("attn", "local_attn"):
            for k, t in entry.items():
                t.copy_(state[k].to(t.dtype))
            continue
        W = entry["k"].shape[2]
        for k, t in zip(("k", "v"), state):
            t = t.transpose(1, 2)  # (B, Hkv, S_tot, hd)
            dst = entry[k]
            if dst.shape[0] != B or (kind == "attn" and S_tot > W):
                raise ValueError(
                    f"batch_prefill: {B} rows of {S_tot} positions do not "
                    f"fit a cache of {tuple(dst.shape)}")
            dst.zero_()
            if kind == "local_attn" and S_tot >= W:
                slots = torch.arange(S_tot - W, S_tot,
                                     device=dst.device) % W
                dst[:, :, slots] = t[:, :, S_tot - W:].to(dst.dtype)
            else:
                dst[:, :, :S_tot] = t.to(dst.dtype)
    if cfg.is_encoder_decoder:
        cache = _fill_cross_cache(params, cfg, cache, enc_out)
    lengths = torch.full((B,), S_tot, dtype=torch.int32,
                         device=tokens.device)
    return logits[:, -1].float(), cache, lengths


def _request_index(cfg: ModelConfig, cache: Dict, li: int, slot: int,
                   page_ids):
    """Layer ``li``'s index of one request: its pages (in block-table
    order) for an ``attn`` entry of a paged cache, else its slot."""
    if page_ids is None or cfg.block_kind(li) != "attn":
        return slot
    return torch.as_tensor(list(page_ids), dtype=torch.long,
                           device=cache["layers"][li]["k"].device)


def gather_request_cache(cfg: ModelConfig, cache: Dict, slot: int, *,
                         page_ids=None) -> Dict:
    """Copy one request's cache to host memory (preemption to host): slot
    ``slot`` of a stacked cache, or with ``page_ids`` a paged cache's
    per-kind share: the request's pages of each ``attn`` layer's pool, in
    block-table order, and row ``slot`` of each slot-resident ring and
    state.  ``page_ids=()`` gathers the slot-resident state alone (the
    ``attn`` entries come out empty).  Returns ``{"layers": [{...}]}`` of
    CPU tensors that no later write to the cache touches;
    :func:`scatter_request_cache` is its inverse."""
    return {"layers": [
        {k: t[_request_index(cfg, cache, li, slot, page_ids)].to(
            "cpu", copy=True) for k, t in layer.items()}
        for li, layer in enumerate(cache["layers"])]}


def scatter_request_cache(cfg: ModelConfig, cache: Dict, blob: Dict,
                          slot: int, *, page_ids=None) -> Dict:
    """Write a :func:`gather_request_cache` snapshot back into slot
    ``slot`` of a stacked cache, or per kind into a paged one: the pages
    ``page_ids`` (the restore target's, in block-table order; they need
    not be the pages it was gathered from) and row ``slot`` of the
    slot-resident entries (``page_ids=()``: those alone).  In place;
    returns the cache."""
    for li, (layer, saved) in enumerate(zip(cache["layers"],
                                            blob["layers"])):
        idx = _request_index(cfg, cache, li, slot, page_ids)
        for k, t in layer.items():
            t[idx] = saved[k].to(t.device, t.dtype)
    return cache


def verify_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: Dict, lengths: torch.Tensor, *,
                 block_tables: Optional[torch.Tensor] = None,
                 anc: Optional[torch.Tensor] = None,
                 depths: Optional[torch.Tensor] = None,
                 valids: Optional[torch.Tensor] = None,
                 with_traj: bool = False,
                 dtype=torch.bfloat16):
    """Score C tokens per row against the cache in ONE forward call
    (speculative verification).  Row ``b``'s tokens occupy positions
    ``lengths[b] .. lengths[b] + C - 1``; their global K/V are written
    into the pages the row's table names (``block_tables``; a mixed
    stack's rings and states take row ``b`` as slot ``b``), or into slot
    ``b`` of the stacked cache (without), and ``logits[b, i]`` is the
    next-token distribution after ``tokens[b, :i + 1]``.  A row parked at
    ``lengths[b] >= max_seq`` writes nothing (the null page, or a dropped
    write) and its logits must not be used.

    Tree verification (``anc`` (B, C, C), ``depths`` (B, C)): position
    ``j`` holds a tree node in DFS layout.  Its K/V still land at the flat
    position ``lengths[b] + j``, it attends the row's prefix and exactly
    the chunk positions ``anc[b, j]`` names (its root path), and its
    position signal (the position embedding, or the rotary phase of its q
    and k) is that of its logical position ``lengths[b] + depths[b, j]``,
    so ``logits[b, j]`` follows the context plus ``j``'s root path.

    ``valids`` (B,) bounds each row's real tokens (``cur_tok`` plus its
    drafts; 0 parks a row, default C): ring writes stop there and
    recurrent states commit after that many tokens.  With ``with_traj``
    the call also returns each layer's state trajectory (None for
    attention layers), which :func:`commit_verify` selects from once the
    drafts are accepted or rejected.
    Returns ``(logits (B, C, V) f32, cache[, traj])``."""
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
    traj = []
    for li, layer_p in enumerate(params["layers"]):
        x, _, tr = blocks.block_apply_chunk(
            layer_p, x, cache["layers"][li], cfg, cfg.block_kind(li),
            positions=positions, valids=valids, block_tables=block_tables,
            anc=anc, rope_positions=logical, name=f"l{li}")
        traj.append(tr)
    logits = _logits(params, cfg, x).float()
    if with_traj:
        return logits, cache, traj
    return logits, cache


def _ring_slots(lengths: torch.Tensor, chunk: int, W: int) -> torch.Tensor:
    """(B, chunk) ring slots of a verify's positions ``lengths[b] + j``."""
    j = torch.arange(chunk, device=lengths.device)
    return torch.remainder(lengths.long()[:, None] + j[None], W)


def verify_snapshot(cfg: ModelConfig, cache: Dict, lengths: torch.Tensor,
                    *, chunk: int) -> Dict:
    """Before a verify of ``chunk`` tokens per row at ``lengths`` (B,):
    copy the ring slots it may overwrite, ``(lengths[b] + j) % W`` for
    ``j < chunk``, in every ``local_attn`` layer: ``{layer: {"k", "v"}}``
    of (B, chunk, Hkv, hd).  That is all :func:`commit_verify` needs to
    undo: the reference keeps the whole pre-verify cache, which costs
    nothing in JAX, where this cache is updated in place.  A recurrent
    layer needs no copy: a row that commits nothing (``counts == 0``)
    keeps what the verify left, as in the reference."""
    snap = {}
    for li, c in enumerate(cache["layers"]):
        if cfg.block_kind(li) != "local_attn":
            continue
        slots = _ring_slots(lengths.to(c["k"].device), chunk,
                            c["k"].shape[2])
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        snap[li] = {k: t[rows, :, slots] for k, t in c.items()}
    return snap


def commit_verify(cfg: ModelConfig, snap: Dict, cache: Dict, traj,
                  lengths: torch.Tensor, counts: torch.Tensor,
                  valids: torch.Tensor, *, chunk: int) -> Dict:
    """Commit the accepted prefix of a verify (``verify_chunk(...,
    valids=valids, with_traj=True)`` at base ``lengths``), in place:
    ``counts[b]`` chunk tokens are kept (``cur_tok`` and the accepted
    drafts; 0 for a parked row).  A rejected draft's ring write at ``(pos
    % W)`` evicted position ``pos - W``, which the window still needs: the
    slots of ``counts <= j < valids`` get their ``snap`` content back
    (:func:`verify_snapshot`).  A recurrent layer's state becomes its
    trajectory's entry after ``counts`` tokens; rows with ``counts == 0``
    keep theirs.  Global-attention K/V rewind by length alone (the cache
    managers' ``rewind``).  The ring slots of one row are distinct only
    while ``chunk <= W``, which the engine checks.  No host sync: every
    index stays on the device.  Returns the cache."""
    j = torch.arange(chunk, device=counts.device)[None]
    undo = (j >= counts.long()[:, None]) & (j < valids.long()[:, None])
    for li, c in enumerate(cache["layers"]):
        kind = cfg.block_kind(li)
        if kind == "local_attn":
            slots = _ring_slots(lengths.to(counts.device), chunk,
                                c["k"].shape[2])
            rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
            for k, t in c.items():
                t[rows, :, slots] = torch.where(
                    undo[..., None, None], snap[li][k], t[rows, :, slots])
        elif kind in blocks.RECURRENT_KINDS:
            keep = counts > 0
            sel = blocks.select_traj(traj[li], counts)
            for k, t in c.items():
                m = keep.reshape((-1,) + (1,) * (t.dim() - 1))
                t.copy_(torch.where(m, sel[k].to(t.dtype), t))
    return cache


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


# ---------------------------------------------------------------------------
# serving over a mesh: the distributed engine's per-shard calls
# ---------------------------------------------------------------------------
#
# The distributed engine (serving/distributed) partitions request slots
# over the shards of a mesh.  The reference holds one cache whose leading
# axis is the shard axis and runs the single-device function per device
# under ``shard_map``; here one controller loops over the shards.  A
# shard's cache is the ordinary cache dict on ``mesh.devices[s]``, held in
# a list indexed by shard (``caches[s]``), and every other per-shard input
# is a list too (entry s on device s; host integers for a prefill's slot,
# offset and valid count).  ``params`` is one params tree per shard, each
# on its shard's device (on one card named several times, the same
# tensors).  K/V never leave their shard: only tokens, lengths, block
# tables and logits cross.  ``shards`` names the shards that have work in
# a call; the others are skipped, their caches untouched and their logits
# zeros (the reference runs them on parked rows, which write nothing).


def _gather_or_keep(parts, gather_logits: bool):
    from repro_torch.core import collectives

    return collectives.ring_all_gather(parts) if gather_logits else parts


def _filled(outs, shards, like_shape, mesh):
    """Per-shard outputs with zeros for skipped shards."""
    ref = next(o for o in outs if o is not None)
    return [o if o is not None else
            torch.zeros(like_shape, dtype=ref.dtype, device=d)
            for o, d in zip(outs, mesh.devices)]


def sharded_decode_step(params, cfg: ModelConfig, mesh, tokens, caches,
                        lengths, *, actives=None, block_tables=None,
                        shards=None, gather_logits: bool = True,
                        dtype=torch.bfloat16):
    """One decode step on every shard (:func:`decode_step` on shard s's
    cache with its ``tokens[s]`` (Bs, 1), ``lengths[s]`` (Bs,),
    ``actives[s]`` and, paged, ``block_tables[s]``).  With
    ``gather_logits`` each shard's (Bs, V) logits ride the ring
    all-gather (:func:`repro_torch.core.collectives.ring_all_gather`), so
    every device holds the (D * Bs, V) batch in global slot order;
    otherwise the per-shard logits come back.  Returns (per-device
    logits, caches)."""
    run = range(mesh.size) if shards is None else shards
    outs = [None] * mesh.size
    for s in run:
        outs[s], caches[s] = decode_step(
            params[s], cfg, tokens[s], caches[s], lengths[s],
            active=None if actives is None else actives[s],
            block_table=None if block_tables is None else block_tables[s],
            dtype=dtype)
    Bs = tokens[run[0]].shape[0]
    outs = _filled(outs, run, (Bs, cfg.vocab_size), mesh)
    return _gather_or_keep(outs, gather_logits), caches


def sharded_prefill_into_slot(params, cfg: ModelConfig, mesh, tokens,
                              caches, slots, offsets, valids, actives, *,
                              block_tables=None, dtype=torch.bfloat16):
    """One prefill round: every shard with ``actives[s]`` writes its chunk
    ``tokens[s]`` (C,) at ``offsets[s]`` into local slot ``slots[s]``
    (:func:`prefill_into_slot`, ``valids[s]`` real tokens; paged through
    the slot's table row ``block_tables[s]``).  Other shards keep their
    caches.  Returns (per-shard last logits (V,) float32, zeros for an
    idle shard, caches)."""
    outs = [None] * mesh.size
    for s in range(mesh.size):
        if not actives[s]:
            continue
        bt = ({} if block_tables is None
              else {"block_table": block_tables[s]})
        outs[s], caches[s] = prefill_into_slot(
            params[s], cfg, tokens[s], caches[s], int(offsets[s]),
            slot=int(slots[s]), valid=int(valids[s]), dtype=dtype, **bt)
    return _filled(outs, None, (cfg.vocab_size,), mesh), caches


def sharded_verify_chunk(params, cfg: ModelConfig, mesh, tokens, caches,
                         lengths, *, valids=None, block_tables=None,
                         anc=None, depths=None, with_traj: bool = False,
                         shards=None, gather_logits: bool = True,
                         dtype=torch.bfloat16):
    """One speculative verify on every shard (:func:`verify_chunk` on
    shard s's cache with ``tokens[s]`` (Bs, C), ``lengths[s]`` and the
    optional ``valids``, ``block_tables``, ``anc``, ``depths`` entries).
    Rows parked at ``lengths >= max_seq`` (``valids == 0``) write
    nothing, so a wave's verify never touches the other wave's rows.
    With ``gather_logits`` the (Bs, C, V) logits ride the ring
    all-gather as in :func:`sharded_decode_step`.  Returns (per-device
    logits, caches[, per-shard trajectories, None for skipped
    shards])."""
    run = range(mesh.size) if shards is None else shards
    outs, trajs = [None] * mesh.size, [None] * mesh.size

    def at(x, s):
        return None if x is None else x[s]

    for s in run:
        res = verify_chunk(
            params[s], cfg, tokens[s], caches[s], lengths[s],
            valids=at(valids, s), block_tables=at(block_tables, s),
            anc=at(anc, s), depths=at(depths, s), with_traj=with_traj,
            dtype=dtype)
        outs[s], caches[s] = res[0], res[1]
        if with_traj:
            trajs[s] = res[2]
    Bs, C = tokens[run[0]].shape
    outs = _gather_or_keep(_filled(outs, run, (Bs, C, cfg.vocab_size),
                                   mesh), gather_logits)
    if with_traj:
        return outs, caches, trajs
    return outs, caches


def sharded_commit_verify(cfg: ModelConfig, mesh, snaps, caches, trajs,
                          lengths, counts, valids, *, chunk: int):
    """:func:`commit_verify` on every shard that verified (``snaps[s]``
    not None: :func:`verify_snapshot` of its cache), on its own device:
    rings and recurrent states never leave their shard.  ``lengths``,
    ``counts`` and ``valids`` are (D, Bs) host arrays.  Rows with
    ``counts == 0`` (the other wave, idle slots) pass through, so the
    commit may land a tick after the verify.  Returns the caches."""
    for s, snap in enumerate(snaps):
        if snap is None:
            continue
        dev = mesh.devices[s]

        def put(a):
            return torch.as_tensor(a[s], dtype=torch.int32).to(
                dev, non_blocking=True)

        caches[s] = commit_verify(cfg, snap, caches[s], trajs[s],
                                  put(lengths), put(counts), put(valids),
                                  chunk=chunk)
    return caches


def sharded_compact_accepted_path(cfg: ModelConfig, mesh, caches, src, dst,
                                  *, block_tables=None):
    """:func:`compact_accepted_path` on every shard: ``src`` / ``dst``
    (D, Bs, m) and ``block_tables`` (D, Bs, n_pg) host arrays.  A row
    whose targets lie past its table or cache (the other wave, chain-
    shaped accepts) moves nothing, and a shard with no such row is
    skipped.  Returns the caches."""
    for s in range(mesh.size):
        if (np.asarray(src[s]) == np.asarray(dst[s])).all():
            continue
        bt = (None if block_tables is None
              else torch.as_tensor(block_tables[s]))
        caches[s] = compact_accepted_path(
            cfg, caches[s], torch.as_tensor(src[s]),
            torch.as_tensor(dst[s]), block_tables=bt)
    return caches
