"""Temporal MDK scheduler — the stage program of Fig 3(c).

Turns a model config into an explicit sequence of (stage, MDK kind)
pairs.  The analytic perf model walks the same program, and the serving
engine reports its per-token kernel reuse from it.  A copy of the JAX
package's ``repro/core/scheduler.py`` for the stacks this package serves
(global-attention blocks with a dense or a MoE FFN).  As in the
reference, a MoE block's expert products are priced as MP-kernel stages
(``moe_up``, ``moe_down``, k experts a token) although the W8A8
conversion leaves the expert banks in floating point.
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


def block_program(cfg: ModelConfig, li: int) -> List[Stage]:
    kind = cfg.block_kind(li)
    if kind != "attn":
        raise NotImplementedError(
            f"stage program for block kind {kind!r} is not ported")
    d, pre = cfg.d_model, f"l{li}."
    stages = [
        Stage(pre + "ln1", "ln_res", k=d, n=d),
        Stage(pre + "qkv", "mp", k=d, n=cfg.q_dim + 2 * cfg.kv_dim),
        Stage(pre + "attn", "mha", k=cfg.head_dim, n=cfg.n_heads),
        Stage(pre + "attn_out", "mp", k=cfg.q_dim, n=d),
    ]
    if not cfg.d_ff:
        return stages
    up_n = 2 * cfg.d_ff if cfg.activation in ("swiglu", "geglu") \
        else cfg.d_ff
    stages.append(Stage(pre + "ln2", "ln_res", k=d, n=d))
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
