"""Top-k MoE FFN with capacity-based dispatch, a copy of the JAX package's
``repro/models/moe.py``, and a grouped path over the routed rows alone.

The router runs in float32: softmax, top-k, the gates renormalised over
the chosen k (``cfg.norm_topk_prob``; without it the top-k probabilities
weigh the experts as they are).  A stable sort of the flattened choices
orders them by expert (``order``; ``offsets`` (E + 1) holds each
expert's first sorted position) and gives each choice its rank within
its expert, its slot.  ``C`` comes from the shapes alone, so nothing
here waits for the card.  Two paths compute the experts:

* grouped: on the card, at exact capacity (``capacity_factor=None``:
  every serving call) with bf16 experts and a gated activation,
  ``ops.moe_experts`` runs each expert's routed rows alone, in sorted
  order (two hand-written kernels, the activation in the first one's
  epilogue), and the combine reads a choice's output at its sorted
  position ``offsets[e] + slot``;
* padded (the reference's): the tokens are scattered into an ``(E, C,
  d)`` buffer, every expert's FFN runs as one batched product over E,
  and the results are gathered back.  A choice ranked past an expert's
  capacity C is dropped (its gate is 0).  Float32 and other expert
  dtypes take it, an ungated activation, every capacity factor (the
  training forward's, where choices drop; calibration runs at exact
  capacity), and every call on the CPU or ``meta``: there the batched
  products are the reference's arithmetic bit for bit, where
  ``ops.moe_experts``' plain version, a per-expert loop, can in rare
  shapes round a sum one place from them.

Parameters: ``{"router": {"w": (d, E)}, "w_up": (E, d, f), "w_down":
(E, f, d)[, "w_gate": (E, d, f)]}``.  The router is not a quantized
linear and the expert banks are not ``{"w"}`` groups, so the W8A8
conversion leaves all of them in floating point, as the reference does.
The expert products run in ``cfg.expert_dtype``, or in the activation
stream's dtype where the config leaves it empty (every registered
config: the reference's arithmetic); a serving engine converts the banks
to that dtype once (``serving.quantize.serving_params``).  Rounding
points, the same on both paths, with ``ed`` that dtype and ``xd`` the
stream's: the routed rows in ``ed``; each bank product accumulated in
float32 and rounded to ``ed`` (as cuBLAS and the CPU's ``bmm`` give; on
the card the grouped kernels walk K in cuBLAS's order and give its
bits); the activation rounded to
``ed`` after each of its operations (``layers.silu``) and its product
with the up projection once; the gathered outputs cast to ``xd`` and
multiplied by the gates in ``xd``; the sum over the k choices in ``xd``.

Inside a tick the FFN opens four stages (``telemetry.stage``), with the
load-balancing loss (a training term) and the padded path's mask of kept
choices between the first two, in no stage:
``model.moe.route`` (router, softmax, top-k, the sort and slots),
``model.moe.dispatch`` (the scatter into the padded buffer, or each
choice's sorted position), ``model.moe.experts`` (the bank products and
the activation) and ``model.moe.combine`` (gather, gates, the sum over
k); and counts, from shapes, ``moe.rows_routed`` (T x k) and
``moe.rows_computed``, the rows the banks multiply: T x k on the grouped
path (the masked rows inside a tile are not counted), E x C padded.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
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


def sort_choices(experts: torch.Tensor, n_experts: int, C: int):
    """The chosen ``experts`` (T, k) sorted by expert: ``(slots (T * k,),
    order (T * k,), offsets (E + 1,) int32)``.  ``order`` is a stable
    argsort of the flattened choices, ``offsets[e]`` expert e's first
    sorted position (``offsets[E] = T * k``), and a choice's slot its
    rank within its expert, or ``C`` when that rank is past the capacity
    (a drop)."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    offsets = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, dtype=sorted_e.dtype,
                               device=experts.device), out_int32=True)
    rank_sorted = (torch.arange(flat_e.numel(), device=experts.device)
                   - offsets[sorted_e])
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return torch.where(rank < C, rank, C), order, offsets


def expert_dtype(cfg: ModelConfig, stream: torch.dtype) -> torch.dtype:
    """The dtype of the expert products: ``cfg.expert_dtype``, else the
    activation stream's ``stream``."""
    return getattr(torch, cfg.expert_dtype) if cfg.expert_dtype else stream


class Routing(NamedTuple):
    """What :func:`route` decides for T tokens."""
    gates: torch.Tensor    # (T, k) float32
    experts: torch.Tensor  # (T, k)
    slots: torch.Tensor    # (T * k,): rank within the expert, C if dropped
    C: int                 # slots per expert
    probs: torch.Tensor    # (T, E) float32: the router's probabilities
    order: torch.Tensor    # (T * k,): the flat choice at each sorted position
    offsets: torch.Tensor  # (E + 1,) int32: each expert's first position


def route(p: Dict, xt: torch.Tensor, cfg: ModelConfig,
          capacity_factor: Optional[float]) -> Routing:
    """The router and the slot assignment of tokens ``xt`` (T, d), with
    the choices sorted by expert (:func:`sort_choices`).  The gates are
    renormalised over the k unless ``cfg.norm_topk_prob`` is False."""
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = router_probs(p, xt)
    gates, experts = torch.topk(probs, k, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    C = capacity(cfg, xt.shape[0], capacity_factor)
    slots, order, offsets = sort_choices(experts, E, C)
    return Routing(gates, experts, slots, C, probs, order, offsets)


def balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """The Switch-style load-balancing loss, scalar float32: ``E * sum(mean
    prob * mean choices)`` over the T tokens."""
    T = probs.shape[0]
    chosen = torch.zeros((T, n_experts), dtype=torch.float32,
                         device=probs.device)
    chosen.scatter_add_(1, experts, torch.ones_like(experts,
                                                    dtype=torch.float32))
    return n_experts * torch.sum(probs.mean(dim=0) * chosen.mean(dim=0))


def grouped(cfg: ModelConfig, ed: torch.dtype,
            capacity_factor: Optional[float], device: torch.device) -> bool:
    """Whether a call's experts run over the routed rows alone
    (``ops.moe_experts``): on a CUDA ``device``, at exact capacity, with
    bf16 experts and a gated activation.  Otherwise the padded batched
    products."""
    return (device.type == "cuda" and capacity_factor is None
            and ed == torch.bfloat16
            and cfg.activation in ("swiglu", "geglu"))


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, d) -> ``(out (B, S, d), aux_loss scalar f32)``.
    ``capacity_factor=None`` is exact capacity (the serving paths'); a
    number sets ``C`` as the reference does, and choices past it drop.
    The expert products run in :func:`expert_dtype` at the rounding
    points of the module's docstring, on the grouped path where
    :func:`grouped` says so, else padded; a bank in another dtype (a
    training or calibration tree, which no engine converted) is cast to
    it on the call."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    ed = expert_dtype(cfg, x.dtype)
    xt = x.reshape(T, d)
    with stage("model.moe.route"):
        r = route(p, xt, cfg, capacity_factor)
    aux = balance_loss(r.probs, r.experts, E)  # training's term, no stage
    is_grouped = grouped(cfg, ed, capacity_factor, x.device)
    count("moe.rows_computed", T * k if is_grouped else E * r.C)
    count("moe.rows_routed", T * k)
    flat_e = r.experts.reshape(-1)

    if is_grouped:
        with stage("model.moe.dispatch"):
            pos = r.offsets[flat_e] + r.slots  # each choice's sorted row
        with stage("model.moe.experts"):
            y_rows = ops.moe_experts(
                xt.contiguous(), r.order, r.offsets, p["w_gate"].to(ed),
                p["w_up"].to(ed), p["w_down"].to(ed), k,
                activation=cfg.activation)
        with stage("model.moe.combine"):
            out = _combine(y_rows[pos], r.gates, x)
        return out, aux

    C = r.C
    keep = r.slots < C
    with stage("model.moe.dispatch"):
        # scatter into (E * C + 1, d) rows: the last row takes the drops,
        # and the (E, C, d) view before it is what the experts read
        rows = torch.where(keep, flat_e * C + r.slots, E * C)
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
        out = _combine(y_buf[flat_e, r.slots.clamp(max=C - 1)],
                       r.gates * keep.reshape(T, k), x)
    return out, aux


def _combine(y: torch.Tensor, gates: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """The choices' outputs ``y`` (T * k, d) cast to the stream's dtype,
    weighed by their ``gates`` (T, k) and summed over the k in order;
    shaped as ``x``."""
    T, k = gates.shape
    y = y.reshape(T, k, -1).to(x.dtype) * gates[..., None].to(x.dtype)
    return y.sum(dim=1).reshape(x.shape)
