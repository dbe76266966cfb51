"""Decoder-only language model: init, full-sequence forward, and the
paged serving steps (``decode_step``, ``prefill_into_slot``).

Parameters are ``{"embed": {"table"}, "layers": [block params...],
"final_ln", "pos_embed"[, "lm_head"]}`` — one dict per layer, where the
JAX package stacks layers on a ``periods`` axis for ``lax.scan``; the
weight bridge (``repro_torch/bridge.py``) converts between the two.  The
paged cache is ``{"layers": [{"k", "v"} page pools]}`` and is updated in
place by the serving steps, which also return it.

The stacks served are those of GPT-2: every layer global ``attn``,
learned (or no) positions, no MoE and no encoder; anything else raises
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
    if cfg.pos not in ("learned", "none"):
        bad.append(f"pos={cfg.pos!r}")
    if cfg.n_experts:
        bad.append("MoE")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        bad.append("encoder/frontend")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported (global-attention "
            "decoder stacks with learned positions only)")


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


def init_cache(cfg: ModelConfig, n_pages: int, page_size: int,
               layout: str = "paged", dtype=torch.bfloat16,
               device=None) -> Dict:
    """The paged KV cache: per layer a pool of ``n_pages`` pages of
    ``page_size`` tokens, page 0 being the null page."""
    if layout != "paged":
        raise NotImplementedError(
            f"cache layout {layout!r} is not ported: only 'paged' is")
    check_supported(cfg)
    return {"layers": [
        blocks.block_init_cache(cfg, cfg.block_kind(li), n_pages, page_size,
                                dtype=dtype, device=device)
        for li in range(cfg.n_layers)]}


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict, lengths: torch.Tensor, *,
                block_table: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                dtype=torch.bfloat16):
    """One auto-regressive step for every row: ``token`` (B, 1) enters at
    position ``lengths[b]``.  Rows outside ``active`` ride along with
    their writes parked on the null page.  Returns
    ``(logits (B, V), cache)``."""
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
                      block_table: torch.Tensor,
                      valid: Optional[int] = None,
                      dtype=torch.bfloat16):
    """Chunked prefill: write one prompt chunk ``tokens`` (C,), right-padded
    past ``valid`` real tokens, at absolute positions ``offset..`` of the
    request whose block-table row is ``block_table`` (n_pg,), with one
    forward call.  The chunk attends causally over itself and the
    request's cache below ``offset``; padding lands above the prompt and
    stays masked by the length accounting.  Returns
    ``(logits (V,) f32 at chunk position valid - 1, cache)``."""
    C = tokens.shape[-1]
    valid = C if valid is None else int(valid)
    tokens = tokens.reshape(1, C)
    positions = (offset + torch.arange(C, device=tokens.device))[None]
    x = embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        # clipped gather: the last chunk may hang past the table end
        P = params["pos_embed"].shape[0]
        x = x + params["pos_embed"][positions.clamp(0, P - 1)].to(dtype)
    bts = block_table[None]
    layers = []
    for li, layer_p in enumerate(params["layers"]):
        x, c = blocks.block_apply_chunk(
            layer_p, x, cache["layers"][li], cfg, cfg.block_kind(li),
            positions=positions, block_tables=bts, name=f"l{li}")
        layers.append(c)
    logits = _logits(params, cfg, x[:, valid - 1:valid])
    return logits[0, 0].float(), {"layers": layers}
