"""Transformer blocks: pre-norm mixers with a shared residual, for every
decoder block kind of the JAX package.

Kinds: ``attn`` (global causal attention), ``local_attn`` (a sliding
window over a rotating ring cache: slot = position mod W), and the
recurrent kinds ``rglru`` (``models/rglru.py``), ``mlstm`` and ``slstm``
(``models/xlstm.py``).  The FFN after the mixer is a dense MLP, or with
``cfg.n_experts`` a top-k MoE (``models/moe.py``): the full-sequence
path takes the reference's training capacity factor (``moe_cf=1.25``) by
default and returns the MoE aux loss, the serving calls use exact
capacity, as the reference's do.
sLSTM blocks have no FFN.  Whisper's decoder layers carry a
cross-attention sub-block between the mixer and the FFN
(:func:`cross_kv`; its decode attends a static cross cache).

  * ``block_init``        — params for one layer
  * ``block_apply_seq``   — full-sequence path (training, calibration
    forward, batched prefill, whisper's encoder)
  * ``block_apply_step``  — one decode token against the layer's cache
  * ``block_apply_chunk`` — a prefill or verify chunk against it
  * ``block_init_cache``  — the layer's cache: a page pool or contiguous
    K/V (``attn``), a ring of ``min(window, max_seq)`` slots
    (``local_attn``) or a carried recurrent state

Caches are written **in place**.  A global-attention cache is masked by
length, but rings and recurrent states are not, so the decode step
writes them only for ``active`` rows, a chunk writes a ring only below
each row's ``limit`` and commits a state only at its ``valids``-th
token, and a row at position 0 enters with the kind's init state (slot
reuse must not leak the previous occupant's state).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe, rglru, xlstm
from repro_torch.models.layers import (apply_norm, linear, mlp, mlp_init,
                                       norm_init)

KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")
_SEQ = {"rglru": rglru.rglru_seq, "mlstm": xlstm.mlstm_seq,
        "slstm": xlstm.slstm_seq}
_CHUNK = {"rglru": rglru.rglru_chunk, "mlstm": xlstm.mlstm_chunk,
          "slstm": xlstm.slstm_chunk}
_STEP = {"rglru": rglru.rglru_step, "mlstm": xlstm.mlstm_step,
         "slstm": xlstm.slstm_step}


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# stack predicates (the reference's, ``repro/models/blocks.py``)


def page_addressable(cfg: ModelConfig) -> bool:
    """True when every layer's cache is addressed by absolute position: a
    decoder of global ``attn`` layers only.  Such stacks page, and only
    they can back a draft model (its cache rewinds by length alone)."""
    return (not cfg.is_encoder_decoder) and all(
        k == "attn" for k in cfg.block_pattern)


def paged_capable(cfg: ModelConfig) -> bool:
    """True when the stack has at least one global ``attn`` layer to put
    on pages.  A stack with none has nothing to page and serves on the
    stacked layout."""
    return (not cfg.is_encoder_decoder) and "attn" in cfg.block_pattern


def chunk_capable(cfg: ModelConfig) -> bool:
    """The chunk body covers every decoder-only stack."""
    return not cfg.is_encoder_decoder


def window_capped(cfg: ModelConfig) -> bool:
    """True when no layer's state grows with the sequence: rings pin at
    most W positions and recurrent kinds O(1), so a stack with no global
    ``attn`` layer serves prompts of any length from fixed-size slots
    (the engine's ceiling comes from ``FIFOAdmission.slot_price``)."""
    return (not cfg.is_encoder_decoder) and all(
        k != "attn" for k in cfg.block_pattern)


# ---------------------------------------------------------------------------
# init


def block_init(gen, cfg: ModelConfig, kind: str, *, cross: bool = False,
               dtype=torch.float32, device=None) -> Dict:
    """One layer's params; ``cross`` adds whisper's decoder
    cross-attention sub-block (``cross_ln``, ``cross_attn``)."""
    _check_kind(kind)
    kw = {"dtype": dtype, "device": device}
    p: Dict = {"ln1": norm_init(cfg.d_model, cfg.norm, **kw)}
    if kind in ("attn", "local_attn"):
        p["attn"] = attention.attn_init(gen, cfg, **kw)
    elif kind == "rglru":
        p["rglru"] = rglru.rglru_init(gen, cfg, **kw)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(gen, cfg, **kw)
    else:
        p["slstm"] = xlstm.slstm_init(gen, cfg, **kw)
    if cross:
        p["cross_ln"] = norm_init(cfg.d_model, cfg.norm, **kw)
        p["cross_attn"] = attention.attn_init(gen, cfg, **kw)
    if cfg.d_ff > 0 and kind != "slstm":
        p["ln2"] = norm_init(cfg.d_model, cfg.norm, **kw)
        if cfg.n_experts:
            p["moe"] = moe.moe_init(gen, cfg, **kw)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                **kw)
    return p


def _ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str,
         moe_cf: Optional[float] = None):
    """The FFN sub-block -> ``(x_out, aux)``: the MoE aux loss, or None
    for a dense MLP or no FFN."""
    if "mlp" in p:
        h = apply_norm(p["ln2"], x, cfg.norm)
        return x + mlp(p["mlp"], h, cfg.activation, name + ".mlp"), None
    if "moe" in p:
        h = apply_norm(p["ln2"], x, cfg.norm)
        out, aux = moe.moe_apply(p["moe"], h, cfg, capacity_factor=moe_cf)
        return x + out, aux
    return x, None


def block_apply_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, causal: bool = True,
                    encoder_out: Optional[torch.Tensor] = None,
                    moe_cf: Optional[float] = 1.25, name: str = ""):
    """The full-sequence path (B, S, d) -> ``(x_out, aux, state)``: aux
    is the MoE aux loss (float32 scalar, 0 without experts) and state the
    prefill-to-decode handoff, (k, v) (B, S, Hkv, hd) for the attention
    kinds and the final recurrent state otherwise.  ``moe_cf`` is the
    experts' capacity factor, the reference's training default 1.25
    (choices past capacity drop); ``None`` is exact capacity, which every
    serving caller passes.  With ``encoder_out`` a layer that has a cross
    sub-block attends it after the mixer (``causal=False`` is the
    encoder's unmasked attention)."""
    _check_kind(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind in ("attn", "local_attn"):
        out, state = attention.full_attention(
            p["attn"], h, cfg, window=cfg.window if kind == "local_attn"
            else 0, causal=causal, name=name + ".attn")
    else:
        out, state = _SEQ[kind](p[kind], h, cfg, f"{name}.{kind}")
    x = x + out
    if "cross_attn" in p and encoder_out is not None:
        h = apply_norm(p["cross_ln"], x, cfg.norm)
        out, _ = attention.full_attention(
            p["cross_attn"], h, cfg, causal=False,
            cross_kv=cross_kv(p["cross_attn"], encoder_out, cfg),
            name=name + ".cross")
        x = x + out
    x, aux = _ffn(p, x, cfg, name, moe_cf)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, state


def cross_kv(p_attn: Dict, encoder_out: torch.Tensor, cfg: ModelConfig):
    """K and V (B, Se, Hkv, hd) of the encoder output through a cross
    sub-block's k and v weights (linear names ``"cross.k"`` and
    ``"cross.v"``, as in the reference); they also fill the static cross
    cache at prefill."""
    B, Se = encoder_out.shape[:2]
    k = linear(p_attn["k"], encoder_out, "cross.k").reshape(
        B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p_attn["v"], encoder_out, "cross.v").reshape(
        B, Se, cfg.n_kv_heads, cfg.head_dim)
    return k, v


# ---------------------------------------------------------------------------
# caches and carried state


def init_state(cfg: ModelConfig, kind: str, batch: int, dtype=torch.float32,
               device=None) -> Dict:
    """A recurrent kind's start-of-sequence state (RG-LRU's conv tail in
    ``dtype``, everything else float32)."""
    if kind == "rglru":
        return rglru.rglru_init_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm.slstm_init_state(cfg, batch, device)
    raise ValueError(kind)


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                     dtype=torch.bfloat16, device=None) -> Dict:
    """The layer's cache.  ``attn``: K/V ``(batch, Hkv, seq, hd)``, a page
    pool of ``batch`` pages of ``seq`` tokens or a contiguous cache of
    ``batch`` slots of ``seq`` positions; ``local_attn``: a ring of
    ``min(cfg.window, seq)`` slots per row; recurrent kinds: their init
    state for ``batch`` rows."""
    _check_kind(kind)
    if kind in RECURRENT_KINDS:
        return init_state(cfg, kind, batch, dtype, device)
    S = seq if kind == "attn" else min(cfg.window, seq)
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _entering_state(cfg: ModelConfig, kind: str, cache: Dict,
                    fresh: torch.Tensor) -> Dict:
    """The state a row enters with: the kind's init state where ``fresh``
    (position 0: a request's first token), the cached one elsewhere.  New
    tensors; the cache is not touched."""
    init = init_state(cfg, kind, fresh.shape[0], device=fresh.device)
    out = {}
    for k, c in cache.items():
        m = fresh.reshape((-1,) + (1,) * (c.dim() - 1))
        out[k] = torch.where(m, init[k].to(c.dtype), c)
    return out


def _commit(cache: Dict, new: Dict, keep: Optional[torch.Tensor]) -> None:
    """Write ``new`` into the state ``cache`` in place, except on rows
    where ``keep`` (B,) is false."""
    for k, c in cache.items():
        n = new[k].to(c.dtype)
        if keep is not None:
            n = torch.where(keep.reshape((-1,) + (1,) * (c.dim() - 1)), n, c)
        c.copy_(n)


def select_traj(traj: Dict, counts: torch.Tensor) -> Dict:
    """Per row, the trajectory's state after ``counts[b]`` chunk tokens
    (``traj[k]`` is (B, C, ...)); rows with ``counts == 0`` get entry 0,
    which callers mask."""
    B, C = counts.shape[0], next(iter(traj.values())).shape[1]
    rows = torch.arange(B, device=counts.device)
    idx = (counts.long() - 1).clamp(0, C - 1)
    return {k: t[rows, idx] for k, t in traj.items()}


# ---------------------------------------------------------------------------
# decode step and chunk


def block_apply_step(p: Dict, x: torch.Tensor, cache: Dict,
                     lengths: torch.Tensor, cfg: ModelConfig, kind: str, *,
                     block_table: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     cross_cache: Optional[Dict] = None,
                     enc_lengths: Optional[torch.Tensor] = None,
                     name: str = ""):
    """One decode token (B, 1, d) -> (x_out, cache); the cache is written
    in place.  ``attn``: with ``block_table`` the cache is the page pool
    and rows outside ``active`` park their writes on the null page;
    without, it is the contiguous per-slot cache, where a tag-along row's
    write at its length stays masked until its next real write replaces
    it.  Rings and recurrent states are written for ``active`` rows only
    (every row when ``active`` is None).  With ``cross_cache`` (the
    layer's static encoder K/V) a cross sub-block attends its first
    ``enc_lengths[b]`` positions after the mixer."""
    _check_kind(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "attn":
        if block_table is None:
            out, k_c, v_c = attention.decode_attention(
                p["attn"], h, cfg, cache["k"], cache["v"], lengths,
                name=name + ".attn")
        else:
            out, k_c, v_c = attention.paged_decode_attention(
                p["attn"], h, cfg, cache["k"], cache["v"], lengths,
                block_table, active=active, name=name + ".attn")
        cache = {"k": k_c, "v": v_c}
    elif kind == "local_attn":
        out, _, _ = attention.ring_decode_attention(
            p["attn"], h, cfg, cache["k"], cache["v"], lengths,
            active=active, name=name + ".attn")
    else:
        state = _entering_state(cfg, kind, cache, lengths == 0)
        out, new = _STEP[kind](p[kind], h, state, cfg, f"{name}.{kind}")
        _commit(cache, new, active)
    x = x + out
    if "cross_attn" in p and cross_cache is not None:
        h = apply_norm(p["cross_ln"], x, cfg.norm)
        out, _, _ = attention.decode_attention(
            p["cross_attn"], h, cfg, cross_cache["k"], cross_cache["v"],
            enc_lengths, cross=True, name=name + ".cross")
        x = x + out
    return _ffn(p, x, cfg, name)[0], cache


def block_apply_chunk(p: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ModelConfig, kind: str, *,
                      positions: torch.Tensor,
                      valids: Optional[torch.Tensor] = None,
                      block_tables: Optional[torch.Tensor] = None,
                      anc: Optional[torch.Tensor] = None,
                      rope_positions: Optional[torch.Tensor] = None,
                      name: str = ""):
    """One prefill or verify chunk (B, C, d) -> (x_out, cache, traj); the
    cache is written in place.  ``valids`` (B,) counts each row's real
    tokens (default C; 0 parks a row).

      * ``attn`` — the page pool through ``block_tables``, or the
        contiguous cache without; ``anc`` is an optional tree mask on
        either, and ``rope_positions`` (B, C) the tree nodes' logical
        positions for a rotary stack's phase (``positions`` without).
      * ``local_attn`` — the ring (:func:`~repro_torch.models.attention.
        chunk_attention_rotating`), written below ``positions[:, 0] +
        valids``.
      * recurrent kinds — the state threaded through the chunk from the
        entering state; the cache commits the state after ``valids``
        tokens (rows with ``valids == 0`` keep the entering state), and
        ``traj`` holds the state after every chunk token, for
        :func:`repro_torch.models.lm.commit_verify`.

    ``traj`` is None for the attention kinds.  A tree mask on any other
    kind than ``attn`` raises ``ValueError``: a ring write or a carried
    state cannot fork across branches."""
    _check_kind(kind)
    B, C = x.shape[:2]
    if anc is not None and kind != "attn":
        raise ValueError(
            f"tree ancestor masks need kind='attn', got {kind!r}")
    if valids is None:
        valids = torch.full((B,), C, dtype=torch.int32, device=x.device)
    traj = None
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "attn":
        if block_tables is None:
            out, _, _ = attention.chunk_attention(
                p["attn"], h, cfg, cache["k"], cache["v"], positions,
                anc=anc, rope_positions=rope_positions, name=name + ".attn")
        else:
            out, _, _ = attention.paged_chunk_attention(
                p["attn"], h, cfg, cache["k"], cache["v"], positions,
                block_tables, anc=anc, rope_positions=rope_positions,
                name=name + ".attn")
    elif kind == "local_attn":
        out, _, _ = attention.chunk_attention_rotating(
            p["attn"], h, cfg, cache["k"], cache["v"], positions,
            positions[:, 0] + valids, name=name + ".attn")
    else:
        state = _entering_state(cfg, kind, cache, positions[:, 0] == 0)
        out, traj = _CHUNK[kind](p[kind], h, state, cfg, f"{name}.{kind}")
        sel = select_traj(traj, valids)
        _commit(cache, {k: torch.where(
            (valids > 0).reshape((-1,) + (1,) * (s.dim() - 1)), s,
            state[k].to(s.dtype)) for k, s in sel.items()}, None)
    return _ffn(p, x + out, cfg, name)[0], cache, traj
