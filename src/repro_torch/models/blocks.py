"""Transformer blocks: pre-norm attention + MLP with a shared residual.

The ``attn`` kind only (global causal attention), which is every layer of
GPT-2; the other kinds of the JAX package (``local_attn``, ``rglru``,
``mlstm``, ``slstm``) raise ``NotImplementedError``.

  * ``block_init``        — params for one layer
  * ``block_apply_seq``   — full-sequence path (calibration forward)
  * ``block_apply_step``  — one-token decode against the page pool
  * ``block_apply_chunk`` — a prefill chunk against the page pool
  * ``block_init_cache``  — the layer's page pool
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
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
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, **kw)
    return p


def _ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str):
    if "mlp" in p:
        h = apply_norm(p["ln2"], x, cfg.norm)
        x = x + mlp(p["mlp"], h, cfg.activation, name + ".mlp")
    return x


def block_apply_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, name: str = "") -> torch.Tensor:
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    x = x + attention.full_attention(p["attn"], h, cfg, name=name + ".attn")
    return _ffn(p, x, cfg, name)


def block_init_cache(cfg: ModelConfig, kind: str, n_pages: int,
                     page_size: int, *, dtype=torch.bfloat16,
                     device=None) -> Dict:
    """The layer's page pool ``(n_pages, Hkv, page_size, head_dim)``."""
    _require_attn(kind)
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_apply_step(p: Dict, x: torch.Tensor, cache: Dict,
                     lengths: torch.Tensor, cfg: ModelConfig, kind: str, *,
                     block_table: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     name: str = ""):
    """One decode token (B, 1, d) -> (x_out, cache); the page pool is
    written in place."""
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    out, k_c, v_c = attention.paged_decode_attention(
        p["attn"], h, cfg, cache["k"], cache["v"], lengths, block_table,
        active=active, name=name + ".attn")
    x = _ffn(p, x + out, cfg, name)
    return x, {"k": k_c, "v": v_c}


def block_apply_chunk(p: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ModelConfig, kind: str, *,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      name: str = ""):
    """One prefill chunk (B, C, d) -> (x_out, cache); the page pool is
    written in place."""
    _require_attn(kind)
    h = apply_norm(p["ln1"], x, cfg.norm)
    out, k_c, v_c = attention.paged_chunk_attention(
        p["attn"], h, cfg, cache["k"], cache["v"], positions, block_tables,
        name=name + ".attn")
    x = _ffn(p, x + out, cfg, name)
    return x, {"k": k_c, "v": v_c}
