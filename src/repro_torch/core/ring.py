"""Ring-overlap tensor parallelism: the paper's ring of nodes, where the
transfer of block k+1 hides inside the matmul of block k (Fig 4c).

The collective matmul: the all-gather or reduce-scatter around a
Megatron linear is split into ``n`` ring hops interleaved with per-chunk
partial products.  The JAX package writes each as a per-device body
under ``shard_map`` with ``ppermute`` hops; here one controller drives
every shard.  ``ring_ag_matmul`` and friends take lists of per-shard
tensors (entry ``i`` on ``devices[i]``) and return one, with the
reference's hop schedule and accumulation order: a hop is a
``copy_(non_blocking=True)`` into a buffer on the receiving device,
issued before the partial product it overlaps.  The naive variants
(gather, then one product) are the exposed-collective baselines.

``tp_matmul`` and ``tp_quant_matmul`` take whole tensors and a
:class:`~repro_torch.launch.mesh.DeviceMesh`, split them over the mesh
axis, run the shards on their devices and concatenate the output columns
on the input's device.  ``tp_quant_matmul`` runs the Fused MP kernel
(``ops.quant_matmul``) on each shard's (K, N / n) column block; weight
scales are per output channel and activation scales per token, so every
output column is computed by exactly the arithmetic of the unsharded
call and the result is bit-identical to it.  Both take ``shards=``, a
dict owned by the caller (``layers.tp_context`` keeps one, the serving
engine one for its life): each weight is split once, and later calls
find its shards there, so a call launches only the shard products and
the concatenation.  A weight is keyed by its identity, so its shards are
never refreshed: params are not written in place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.collectives import _buffers, _hop


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=float32)``: bf16 products
    are exact in float32, so the operands are widened first."""
    return a.float() @ b.float()


def ring_ag_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``Y_i = X @ W_i`` with the all-gather of X hidden in the ring.

    ``xs[i]`` (M, Kl): device i's feature shard of X (K = n * Kl);
    ``ws[i]`` (K, Nl): the full-K rows of its output-column shard.
    Returns ``ys[i]`` (M, Nl) in X's dtype.  At step t device i multiplies
    the chunk that came from device ``i + t`` while forwarding it to
    device ``i - 1``; the hop is issued before the product."""
    n = len(xs)
    Kl = xs[0].shape[1]
    accs = [torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                        device=x.device) for x, w in zip(xs, ws)]
    held = list(xs)
    # the ring runs backwards (i receives from i + 1): the buffers of
    # device i take its successor's chunk shape, which is every chunk's
    bufs = _buffers(xs) if n > 1 else None
    for t in range(n):
        nxt = None
        if t < n - 1:
            nxt = []
            for i in range(n):  # receive from the successor
                dst = bufs[i][t % 2]
                dst.copy_(held[(i + 1) % n], non_blocking=True)
                nxt.append(dst)
        for i in range(n):
            src = (i + t) % n
            accs[i] += _f32_dot(held[i], ws[i][src * Kl:(src + 1) * Kl])
        held = nxt
    return [a.to(x.dtype) for a, x in zip(accs, xs)]


def naive_ag_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Exposed-collective baseline: all-gather X, then one product."""
    n = len(xs)
    outs = []
    for i in range(n):
        x_full = torch.cat([xs[j].to(xs[i].device) for j in range(n)], 1)
        outs.append(_f32_dot(x_full, ws[i]).to(xs[i].dtype))
    return outs


def ring_rs_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``Y_i = reduce_scatter(X_i @ W_i)`` with the reduce-scatter in the
    ring: ``xs[i]`` (M, Kl), ``ws[i]`` (Kl, N); returns block ``i`` (M,
    N / n) of the summed product on device i.  A travelling accumulator
    picks up each device's partial product and lands home after n - 1
    hops (device i works on block ``(i - t - 1) % n`` at step t)."""
    n = len(xs)
    Nl = ws[0].shape[1] // n

    def part(i, b):
        return _f32_dot(xs[i], ws[i][:, b * Nl:(b + 1) * Nl])

    accs = [part(i, (i - 1) % n) for i in range(n)]
    bufs = _buffers(accs) if n > 1 else None
    for t in range(1, n):
        recv = _hop(accs, bufs, t)
        accs = [recv[i] + part(i, (i - t - 1) % n) for i in range(n)]
    return [a.to(x.dtype) for a, x in zip(accs, xs)]


def naive_rs_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Exposed-collective baseline: product, then a reduce-scatter (the
    partial sums added in device order)."""
    n = len(xs)
    Nl = ws[0].shape[1] // n
    ys = [_f32_dot(x, w) for x, w in zip(xs, ws)]
    outs = []
    for i in range(n):
        acc = ys[0][:, i * Nl:(i + 1) * Nl].to(xs[i].device)
        for j in range(1, n):
            acc = acc + ys[j][:, i * Nl:(i + 1) * Nl].to(xs[i].device)
        outs.append(acc.to(xs[i].dtype))
    return outs


_STRATEGIES: Dict[str, Callable] = {
    "ring_ag": ring_ag_matmul,
    "naive_ag": naive_ag_matmul,
    "ring_rs": ring_rs_matmul,
    "naive_rs": naive_rs_matmul,
}


def _split(t: torch.Tensor, n: int, dim: int, devices) -> List[torch.Tensor]:
    """``n`` contiguous blocks of ``t`` along ``dim``, block i on
    ``devices[i]``."""
    return [b.contiguous().to(d, non_blocking=True)
            for b, d in zip(t.chunk(n, dim=dim), devices)]


def shard_weight(t: torch.Tensor, dim: int, devices,
                 shards: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``_split`` of a weight (cast to ``dtype`` first), memoised in
    ``shards`` under the weight's identity; the entry holds the weight
    itself, so its id cannot be taken by another tensor while the entry
    lives."""
    dtype = dtype or t.dtype
    if shards is None:
        return _split(t.to(dtype), len(devices), dim, devices)
    key = (id(t), dim, dtype, tuple(devices))
    hit = shards.get(key)
    if hit is None:
        hit = shards[key] = (t, _split(t.to(dtype), len(devices), dim,
                                       devices))
    return hit[1]


def tp_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model",
              strategy: str = "ring_ag", *,
              shards: Optional[dict] = None) -> torch.Tensor:
    """Distributed ``x @ w`` over ``mesh``'s ``axis`` with the given
    schedule: x split on K; for ``*_ag`` w split on N (full-K column
    blocks), for ``*_rs`` on K (full-N row blocks), in x's dtype.  The
    (M, N) result, its column blocks concatenated, lands on x's
    device."""
    fn = _STRATEGIES[strategy]
    devs = mesh.axis_devices(axis)
    xs = _split(x, len(devs), 1, devs)
    ws = shard_weight(w, 1 if strategy.endswith("_ag") else 0, devs,
                      shards, x.dtype)
    return torch.cat([y.to(x.device) for y in fn(xs, ws)], dim=1)


def tp_quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, mesh,
                    axis: str = "model",
                    out_dtype: torch.dtype = torch.bfloat16,
                    shards: Optional[dict] = None) -> torch.Tensor:
    """W8A8 matmul split over output columns (Megatron column-parallel):
    every device runs ``ops.quant_matmul`` (the Fused MP kernel on a card)
    on the whole activations and its (K, N / n) weight block; the column
    blocks concatenate on x_q's device.  Bit-identical to the unsharded
    call."""
    from repro_torch.kernels import ops

    devs = mesh.axis_devices(axis)
    ws = shard_weight(w_q, 1, devs, shards)
    wss = shard_weight(w_scale, 1, devs, shards)
    bs = (shard_weight(bias, 0, devs, shards) if bias is not None
          else [None] * len(devs))
    ys = [ops.quant_matmul(x_q.to(d, non_blocking=True),
                           w, x_scale.to(d, non_blocking=True), s, b,
                           out_dtype=out_dtype)
          for d, w, s, b in zip(devs, ws, wss, bs)]
    return torch.cat([y.to(x_q.device) for y in ys], dim=1)
