"""AdamW with a warmup-cosine schedule and global-norm clipping, the JAX
package's ``repro/training/optimizer.py`` in PyTorch.

Not ``torch.optim.AdamW``: its order of operations, and where it applies
the weight decay and eps, round differently.  Here every quantity is the
reference's, in float32 and in its order: the bias corrections ``1 - b **
step`` from a float32 step, ``delta = mh / (sqrt(vh) + eps) + wd * p``,
``p - lr * delta``.  The state mirrors the params tree (``m`` and ``v``
in ``state_dtype``; bf16 halves the optimizer's memory).
:func:`apply_updates` writes params, ``m`` and ``v`` in place, under
``torch.no_grad()``: at full width that saves a copy of every tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: torch.dtype = torch.float32  # bf16 for huge models


def init_state(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    step_dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=step_dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), float32: linear
    warmup over ``warmup_steps``, then a cosine down to ``min_lr_frac``
    of ``lr`` at ``total_steps``."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step of ``grads`` (clipped to ``clip_norm`` by their
    global norm) at ``schedule(state.step)``.  Writes ``params``,
    ``state.m`` and ``state.v`` in place and returns ``(params,
    new_state, {"grad_norm", "lr"})``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(state.step, cfg)
    bc1 = 1.0 - torch.pow(cfg.b1, step.float())
    bc2 = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state.m, state.v)
    return (params, AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm, "lr": lr})
