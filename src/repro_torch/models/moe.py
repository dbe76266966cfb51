"""Top-k MoE FFN with capacity-based dispatch, a copy of the JAX package's
``repro/models/moe.py``.

The router runs in float32: softmax, top-k, the gates renormalised over
the chosen k (``cfg.norm_topk_prob``; without it the top-k probabilities
weigh the experts as they are).  Each (token, choice) gets its rank
within its expert from a stable sort; the tokens are scattered into an
``(E, C, d)`` buffer, every expert's FFN runs as one batched product over
E, and the results are gathered back and weighed by their gates.  A
choice ranked past an expert's capacity C is dropped (its gate is 0).
``C`` comes from the shapes alone, so nothing here waits for the card.

Parameters: ``{"router": {"w": (d, E)}, "w_up": (E, d, f), "w_down":
(E, f, d)[, "w_gate": (E, d, f)]}``.  The router is not a quantized
linear and the expert banks are not ``{"w"}`` groups, so the W8A8
conversion leaves all of them in floating point, as the reference does.
The expert products run in ``cfg.expert_dtype``, or in the activation
stream's dtype where the config leaves it empty (every registered
config: the reference's arithmetic); a serving engine converts the banks
to that dtype once (``serving.quantize.serving_params``).  Rounding
points, with ``ed`` that dtype and ``xd`` the stream's: the dispatched
rows in ``ed``; each bank product accumulated in float32 and rounded to
``ed`` (as cuBLAS and the CPU's ``bmm`` give); the activation rounded to
``ed`` after each of its operations (``layers.silu``) and its product
with the up projection once; the gathered outputs cast to ``xd`` and
multiplied by the gates in ``xd``; the sum over the k choices in ``xd``.

Inside a tick the FFN opens four stages (``telemetry.stage``):
``model.moe.route`` (router, softmax, top-k, slots),
``model.moe.dispatch`` (the scatter), ``model.moe.experts`` (the bank
products and the activation) and ``model.moe.combine`` (gather, gates,
the sum over k); and counts ``moe.rows_computed`` (E x C rows through
the banks) and ``moe.rows_routed`` (T x k), both from shapes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation_fn, linear_init
from repro_torch.serving.telemetry import count, stage


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32,
             device=None) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = {"generator": gen, "dtype": dtype, "device": device}
    s_in, s_out = 1.0 / d ** 0.5, 1.0 / f ** 0.5
    p = {
        "router": linear_init(gen, d, E, device=device),  # float32 always
        "w_up": torch.randn((E, d, f), **kw) * s_in,
        "w_down": torch.randn((E, f, d), **kw) * s_out,
    }
    if cfg.activation in ("swiglu", "geglu"):  # a separate gate bank
        p["w_gate"] = torch.randn((E, d, f), **kw) * s_in
    return p


def capacity(cfg: ModelConfig, T: int,
             capacity_factor: Optional[float]) -> int:
    """Slots per expert for ``T`` tokens: ``T * k`` when
    ``capacity_factor`` is None (exact: nothing can drop, so a decode
    step equals the forward), else ``max(1, int(cf * k * T / E))``."""
    k = cfg.experts_per_token
    if capacity_factor is None:
        return T * k
    return max(1, int(capacity_factor * k * T / cfg.n_experts))


def router_probs(p: Dict, xt: torch.Tensor) -> torch.Tensor:
    """The router's float32 probabilities (T, E) of tokens ``xt`` (T, d),
    in ``jax.nn.softmax``'s form: exp of the shifted logits over their
    sum."""
    logits = xt.float() @ p["router"]["w"].float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def slots_of(experts: torch.Tensor, n_experts: int, C: int) -> torch.Tensor:
    """Each choice's slot (T * k,) for the chosen ``experts`` (T, k): its
    rank within its expert by a stable sort of the flattened choices, or
    ``C`` when that rank is past the capacity (a drop)."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                               device=experts.device))
    rank_sorted = (torch.arange(flat_e.numel(), device=experts.device)
                   - seg_start[sorted_e])
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return torch.where(rank < C, rank, C)


def expert_dtype(cfg: ModelConfig, stream: torch.dtype) -> torch.dtype:
    """The dtype of the expert products: ``cfg.expert_dtype``, else the
    activation stream's ``stream``."""
    return getattr(torch, cfg.expert_dtype) if cfg.expert_dtype else stream


def route(p: Dict, xt: torch.Tensor, cfg: ModelConfig,
          capacity_factor: Optional[float]):
    """The router and the slot assignment of tokens ``xt`` (T, d).
    Returns ``(gates (T, k) f32, experts (T, k), slots (T * k,), C,
    aux)``: a choice's slot is its rank within its expert, or ``C`` when
    it is dropped.  The gates are renormalised over the k unless
    ``cfg.norm_topk_prob`` is False."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = router_probs(p, xt)
    gates, experts = torch.topk(probs, k, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balancing loss: E * sum(mean prob * mean choices)
    me = probs.mean(dim=0)
    chosen = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    chosen.scatter_add_(1, experts, torch.ones_like(gates))
    aux = E * torch.sum(me * chosen.mean(dim=0))

    C = capacity(cfg, T, capacity_factor)
    return gates, experts, slots_of(experts, E, C), C, aux


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, d) -> ``(out (B, S, d), aux_loss scalar f32)``.
    ``capacity_factor=None`` is exact capacity (the serving paths'); a
    number sets ``C`` as the reference does, and choices past it drop.
    The expert products run in :func:`expert_dtype` at the rounding
    points of the module's docstring; a bank in another dtype (a
    training or calibration tree, which no engine converted) is cast to
    it on the call."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    ed = expert_dtype(cfg, x.dtype)
    xt = x.reshape(T, d)
    with stage("model.moe.route"):
        gates, experts, slots, C, aux = route(p, xt, cfg, capacity_factor)
    count("moe.rows_computed", E * C)
    count("moe.rows_routed", T * k)
    flat_e = experts.reshape(-1)
    keep = slots < C

    with stage("model.moe.dispatch"):
        # scatter into (E * C + 1, d) rows: the last row takes the drops,
        # and the (E, C, d) view before it is what the experts read
        rows = torch.where(keep, flat_e * C + slots, E * C)
        buf = torch.zeros((E * C + 1, d), dtype=ed, device=x.device)
        buf[rows] = xt.to(ed).repeat_interleave(k, dim=0)
        buf = buf[:E * C].view(E, C, d)

    with stage("model.moe.experts"):
        act = activation_fn(cfg.activation)
        h = torch.bmm(buf, p["w_up"].to(ed))
        if cfg.activation in ("swiglu", "geglu"):
            h = act(torch.bmm(buf, p["w_gate"].to(ed))) * h
        else:
            h = act(h)
        y_buf = torch.bmm(h, p["w_down"].to(ed))  # (E, C, d)

    with stage("model.moe.combine"):
        # gather back; a dropped choice reads some kept row with a gate
        # of 0
        y = y_buf[flat_e, slots.clamp(max=C - 1)].reshape(T, k, d)
        y = y.to(x.dtype) * (gates * keep.reshape(T, k))[..., None].to(
            x.dtype)
        out = y.sum(dim=1).reshape(B, S, d)
    return out, aux
