"""Ring collectives over a list of per-shard tensors: the double-buffered
ring all-gather of the distributed serving tick, and the int8-wire ring
all-reduce.

The JAX package writes these as per-device bodies under ``shard_map``
whose hops are ``ppermute``.  Here one controller drives every shard:
each function takes a list whose entry ``i`` lies on ``devices[i]`` and
returns one, and a hop is ``dst.copy_(src, non_blocking=True)`` into a
receive buffer preallocated on the next device (two per device, used in
turn).  The copy of hop t+1 is issued before hop t's block is written
into the output, the reference's double-buffer order, so on cards with
their own copy engines the wire transfer overlaps the copy-in.  On one
card named several times a hop is a copy on that card.  The buffers stay
referenced until every copy that reads them is enqueued.

``compressed_psum`` keeps the reference's arithmetic: an int8 wire with
one symmetric scale per chunk, requantized at every hop, its chunk
order and its fused multiply-add, so the same float32 inputs give the
same float32 sums, bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def _quantize(x: torch.Tensor):
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _buffers(like: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Two receive buffers on each device, shaped as the block that
    device will receive (its predecessor's)."""
    n = len(like)
    return [[torch.empty_like(like[(i - 1) % n], device=like[i].device)
             for _ in range(2)] for i in range(n)]


def _hop(held: Sequence[torch.Tensor], bufs, t: int) -> List[torch.Tensor]:
    """Forward every device's block to the next device (i -> i + 1), into
    that device's buffer ``t % 2``; returns the received blocks."""
    n = len(held)
    out = []
    for i in range(n):
        dst = bufs[i][t % 2]
        dst.copy_(held[(i - 1) % n], non_blocking=True)
        out.append(dst)
    return out


def ring_all_gather(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Ring all-gather of per-device blocks (m, ...): returns, on every
    device, the (n * m, ...) concatenation with device ``i``'s block at
    rows ``[i * m, (i + 1) * m)``.

    Step t forwards the block each device holds (hop t + 1) before that
    block is copied into the device's output; n - 1 hops suffice, the
    last block received being copied in without a trailing hop."""
    n = len(blocks)
    m = blocks[0].shape[0]
    outs = [torch.empty((n * m,) + tuple(b.shape[1:]), dtype=b.dtype,
                        device=b.device) for b in blocks]
    held = list(blocks)
    bufs = _buffers(blocks) if n > 1 else None
    for t in range(n - 1):
        nxt = _hop(held, bufs, t)  # overlaps the copy-in below
        for i in range(n):
            src = (i - t) % n  # whose block device i holds
            outs[i][src * m:(src + 1) * m].copy_(held[i])
        held = nxt
    for i in range(n):
        src = (i - (n - 1)) % n
        outs[i][src * m:(src + 1) * m].copy_(held[i])
    return outs


def compressed_psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """int8-wire ring all-reduce of flat float32 vectors (L,), L divisible
    by the number of devices: returns the sum on every device.

    A ring reduce-scatter (the travelling accumulator of chunk ``(i - t -
    1) % n`` picks up device i's chunk at step t and is requantized for
    each hop), then a ring all-gather of the reduced chunks, each hop
    carrying an int8 chunk and its float32 scale."""
    n = len(xs)
    L = xs[0].shape[0]
    if L % n:
        raise ValueError(f"length {L} does not divide over {n} devices")
    chunk = L // n

    def get(i, b):
        return xs[i][b * chunk:(b + 1) * chunk]

    acc = [get(i, (i - 1) % n) for i in range(n)]
    if n > 1:
        q0, s0 = zip(*(_quantize(a) for a in acc))
        qbufs, sbufs = _buffers(q0), _buffers(s0)
    for t in range(1, n):  # reduce-scatter
        q, s = zip(*(_quantize(a) for a in acc))
        q, s = _hop(q, qbufs, t), _hop(s, sbufs, t)
        # XLA fuses the dequantize and the add into one multiply-add
        # (rounded once); the float64 product of float32 values is exact,
        # so one rounding of the float64 sum gives the same float32
        acc = [(q[i].double() * s[i].double()
                + get(i, (i - t - 1) % n).double()).float()
               for i in range(n)]
    q, s = (list(v) for v in zip(*(_quantize(a) for a in acc)))
    outs = [torch.empty((L,), dtype=torch.float32, device=x.device)
            for x in xs]
    for t in range(n):  # all-gather
        nq, ns = ((_hop(q, qbufs, t), _hop(s, sbufs, t)) if t < n - 1
                  else (None, None))
        for i in range(n):
            src = (i - t) % n
            outs[i][src * chunk:(src + 1) * chunk] = _dequantize(q[i], s[i])
        q, s = nq, ns
    return outs
