"""Transformer blocks: pre-norm attention + MLP with a shared residual.

The ``attn`` kind only (global causal attention), which is every layer of
GPT-2, of the RoPE dense decoders (Llama, TinyLlama, Minitron, Gemma) and
of the MoE decoders (OLMoE, Kimi K2); the other kinds of the JAX package
(``local_attn``, ``rglru``, ``mlstm``, ``slstm``) raise
``NotImplementedError``.  The FFN is a dense MLP, or with
``cfg.n_experts`` a top-k MoE (``models/moe.py``) whose serving calls use
exact capacity, as the reference's do; its aux loss is dropped here.

  * ``block_init``        — params for one layer
  * ``block_apply_seq``   — full-sequence path (calibration forward)
  * ``block_apply_step``  — one-token decode against the page pool (with a
    block table) or the contiguous cache (without)
  * ``block_apply_chunk`` — a prefill or verify chunk, the same two ways
  * ``block_init_cache``  — the layer's page pool or contiguous cache
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe
from repro_torch.models.layers import apply_norm, mlp, mlp_init, norm_init


def _require_attn(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported: only 'attn' is")


def block_init(gen, cfg: ModelConfig, kind: str, *, dtype=torch.float32,
               device=None) -> Dict:
    _require_attn(kind)
    kw = {"dtype": dtype, "device": device}
    p: Dict = {"ln1": norm_init(cfg.d_model, cfg.norm, **kw),
               "attn": attention.attn_init(gen, cfg, **kw)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg.d_model, cfg.norm, **kw)
        if cfg.n_experts:
            p["moe"] = moe.moe_init(gen, cfg, **kw)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                **kw)
    return p


def _ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str):
    if "mlp" in p:
        h = apply_norm(p["ln2"], x, cfg.norm)
        x = x + mlp(p["mlp"], h, cfg.activation, name + ".mlp")
    elif "moe" in p:
        h = apply_norm(p["ln2"], x, cfg.norm)
        out, _ = moe.moe_apply(p["moe"], h, cfg, capacity_factor=None)
        x = x + out
    return x


def block_apply_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, name: str = "") -> torch.Tensor:
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    x = x + attention.full_attention(p["attn"], h, cfg, name=name + ".attn")
    return _ffn(p, x, cfg, name)


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                     dtype=torch.bfloat16, device=None) -> Dict:
    """The layer's K/V ``(batch, Hkv, seq, head_dim)``: a page pool of
    ``batch`` pages of ``seq`` tokens, or a contiguous cache of ``batch``
    slots of ``seq`` positions."""
    _require_attn(kind)
    shape = (batch, cfg.n_kv_heads, seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_apply_step(p: Dict, x: torch.Tensor, cache: Dict,
                     lengths: torch.Tensor, cfg: ModelConfig, kind: str, *,
                     block_table: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     name: str = ""):
    """One decode token (B, 1, d) -> (x_out, cache); the cache is written
    in place.  With ``block_table`` the cache is the page pool and rows
    outside ``active`` park their writes on the null page; without, it is
    the contiguous per-slot cache, where a tag-along row's write at its
    length stays masked until its next real write replaces it."""
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if block_table is None:
        out, k_c, v_c = attention.decode_attention(
            p["attn"], h, cfg, cache["k"], cache["v"], lengths,
            name=name + ".attn")
    else:
        out, k_c, v_c = attention.paged_decode_attention(
            p["attn"], h, cfg, cache["k"], cache["v"], lengths, block_table,
            active=active, name=name + ".attn")
    x = _ffn(p, x + out, cfg, name)
    return x, {"k": k_c, "v": v_c}


def block_apply_chunk(p: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ModelConfig, kind: str, *,
                      positions: torch.Tensor,
                      block_tables: Optional[torch.Tensor] = None,
                      anc: Optional[torch.Tensor] = None,
                      rope_positions: Optional[torch.Tensor] = None,
                      name: str = ""):
    """One prefill or verify chunk (B, C, d) -> (x_out, cache); the cache
    is written in place: the page pool through ``block_tables``, or the
    contiguous cache without; ``anc`` is an optional tree mask on
    either, and ``rope_positions`` (B, C) the tree nodes' logical
    positions for a rotary stack's phase (``positions`` without)."""
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if block_tables is None:
        out, k_c, v_c = attention.chunk_attention(
            p["attn"], h, cfg, cache["k"], cache["v"], positions, anc=anc,
            rope_positions=rope_positions, name=name + ".attn")
    else:
        out, k_c, v_c = attention.paged_chunk_attention(
            p["attn"], h, cfg, cache["k"], cache["v"], positions,
            block_tables, anc=anc, rope_positions=rope_positions,
            name=name + ".attn")
    x = _ffn(p, x + out, cfg, name)
    return x, {"k": k_c, "v": v_c}
