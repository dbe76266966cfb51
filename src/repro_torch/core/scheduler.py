"""Temporal MDK scheduler — the stage program of Fig 3(c).

Turns a model config into an explicit sequence of (stage, MDK kind)
pairs.  The analytic perf model walks the same program, and the serving
engine reports its per-token kernel reuse from it.  A copy of the JAX
package's ``repro/core/scheduler.py`` for every decoder block kind.  As
in the reference, some stages are priced as MP-kernel stages although
the W8A8 conversion leaves them in floating point: a MoE block's expert
products (``moe_up``, ``moe_down``, k experts a token) and sLSTM's
``gates``.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mdk import MDKStats


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str  # e.g. "l3.qkv"
    kernel: str  # MDK kind: mp | mha | ln_res | func
    # matmul (K, N) for mp, (head_dim, heads) for mha, width otherwise
    k: int = 0
    n: int = 0


def _attn_stages(cfg: ModelConfig, li: int, local: bool) -> List[Stage]:
    d, pre = cfg.d_model, f"l{li}."
    return [
        Stage(pre + "ln1", "ln_res", k=d, n=d),
        Stage(pre + "qkv", "mp", k=d, n=cfg.q_dim + 2 * cfg.kv_dim),
        Stage(pre + ("local_attn" if local else "attn"), "mha",
              k=cfg.head_dim, n=cfg.n_heads),
        Stage(pre + "attn_out", "mp", k=cfg.q_dim, n=d),
    ]


def _ffn_stages(cfg: ModelConfig, li: int) -> List[Stage]:
    if not cfg.d_ff:
        return []
    d, pre = cfg.d_model, f"l{li}."
    up_n = 2 * cfg.d_ff if cfg.activation in ("swiglu", "geglu") \
        else cfg.d_ff
    stages = [Stage(pre + "ln2", "ln_res", k=d, n=d)]
    if cfg.n_experts:
        k = cfg.experts_per_token  # active experts per token
        return stages + [
            Stage(pre + "router", "func", k=d, n=cfg.n_experts),
            Stage(pre + "moe_up", "mp", k=d, n=up_n * k),
            Stage(pre + "act", "func", k=cfg.d_ff, n=1),
            Stage(pre + "moe_down", "mp", k=cfg.d_ff * k, n=d),
        ]
    return stages + [
        Stage(pre + "ffn_up", "mp", k=d, n=up_n),
        Stage(pre + "act", "func", k=cfg.d_ff, n=1),
        Stage(pre + "ffn_down", "mp", k=cfg.d_ff, n=d),
    ]


def _recurrent_stages(cfg: ModelConfig, li: int, kind: str) -> List[Stage]:
    d, pre = cfg.d_model, f"l{li}."
    if kind == "rglru":
        w = cfg.lru_width or d
        return [
            Stage(pre + "ln1", "ln_res", k=d, n=d),
            Stage(pre + "lru_in", "mp", k=d, n=2 * w),
            Stage(pre + "rglru", "func", k=w, n=1),
            Stage(pre + "lru_out", "mp", k=w, n=d),
        ]
    if kind == "mlstm":
        return [
            Stage(pre + "ln1", "ln_res", k=d, n=d),
            Stage(pre + "qkv", "mp", k=d, n=cfg.q_dim + 2 * cfg.kv_dim),
            Stage(pre + "mlstm", "func", k=cfg.head_dim, n=cfg.n_heads),
            Stage(pre + "out", "mp", k=cfg.q_dim, n=d),
        ]
    if kind == "slstm":
        return [
            Stage(pre + "ln1", "ln_res", k=d, n=d),
            Stage(pre + "gates", "mp", k=d, n=4 * d),
            Stage(pre + "slstm", "func", k=d, n=1),
        ]
    raise ValueError(kind)


def block_program(cfg: ModelConfig, li: int) -> List[Stage]:
    kind = cfg.block_kind(li)
    if kind in ("attn", "local_attn"):
        mixer = _attn_stages(cfg, li, local=kind == "local_attn")
    else:
        mixer = _recurrent_stages(cfg, li, kind)
    return mixer + _ffn_stages(cfg, li)


def model_program(cfg: ModelConfig) -> List[Stage]:
    """Full per-token decode program: L blocks + final norm + LM head."""
    stages: List[Stage] = []
    for li in range(cfg.n_layers):
        stages.extend(block_program(cfg, li))
    d = cfg.d_model
    stages.append(Stage("final_ln", "ln_res", k=d, n=d))
    stages.append(Stage("lm_head", "mp", k=d, n=cfg.vocab_size))
    return stages


def mdk_stats(cfg: ModelConfig) -> MDKStats:
    """Per-token MDK activation/reuse accounting (the Fig 3c argument)."""
    stats = MDKStats()
    for st in model_program(cfg):
        stats.record(st.kernel, st.name)
    return stats
