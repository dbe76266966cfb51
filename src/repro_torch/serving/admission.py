"""Admission pricing, the preemption victim policy and the per-tick
prefill schedule.

Requests are priced in KV-cache pages: the worst-case lifetime footprint
(prompt plus every token it may generate, capped at the cache), net of
prefix-shared pages — the formula ``PagedCacheManager.alloc`` enforces —
or, under :class:`OvercommitAdmission`, the prompt alone, with
preemption (:func:`victim_order`) covering a pool that runs dry.  On the
stacked layout every request takes one slot; :meth:`FIFOAdmission.
slot_price` is its per-layer footprint in positions, and
:meth:`FIFOAdmission.combined_price` the larger of the two on a mixed
stack's per-kind paged layout.
Each tick, prompt chunks ride along with the batched decode up to a token
budget derived from the analytic stage program: decode streams every
weight through the MP kernel anyway, so the budget is however many
pipelined prefill tokens fit in a fixed fraction of a decode tick
(``core/perfmodel.py``, the paper's FPGA model).

For the distributed engine: :class:`ShardPlacement` picks the one pool
shard a request lives on (prefix affinity, then least loaded), and
:class:`DecodeWaveScheduler` splits the decoding slots into the two
phase-shifted decode waves.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.perfmodel import FPGAPerfModel
from repro_torch.models import blocks


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One scheduled prompt chunk: ``n`` tokens from prompt offset
    ``start`` into cache slot ``slot``."""

    slot: int
    start: int
    n: int


def derive_prefill_budget(cfg: ModelConfig, chunk_size: int, *,
                          nodes: int = 2, hide_frac: float = 0.5) -> int:
    """Prefill tokens that fit inside ``hide_frac`` of one decode tick,
    clamped to [chunk_size, 8 * chunk_size] so a P-token prompt always
    costs ``ceil(P / chunk_size)`` forward calls."""
    pm = FPGAPerfModel(cfg, nodes=nodes)
    fit = int(hide_frac * pm.token_latency()["total"]
              / max(pm.prefill_token_latency(), 1e-12))
    return max(chunk_size, min(fit, 8 * chunk_size))


class ShardPlacement:
    """Deterministic shard choice for the distributed engine's admission.
    A request lives on exactly one pool shard (its pages never straddle
    shards).  Preference: (1) prefix affinity, the shards holding the
    longest ready shared prefix of the prompt (page links work within one
    shard's page ids); on a hit only those shards are candidates, so a
    momentarily full prefix shard makes the request wait rather than lose
    the link; (2) the most available pages (paged) or free slots
    (stacked); (3) the lowest shard id."""

    def order(self, shards, prompt=None, *, share: bool = True):
        """Candidate shard ids, most preferred first."""
        hits = [(m.shared_prefix_pages(prompt)
                 if share and prompt is not None
                 and hasattr(m, "shared_prefix_pages") else 0)
                for m in shards]

        def key(i):
            avail = getattr(shards[i], "available_pages", None)
            if avail is None:
                avail = shards[i].n_free
            return (-hits[i], -avail, i)

        order = sorted(range(len(shards)), key=key)
        best = max(hits, default=0)
        if best > 0:  # commit to the copy-free link
            order = [i for i in order if hits[i] == best]
        return order


class DecodeWaveScheduler:
    """Decoding slots in ``n_waves`` phase-shifted decode waves (the
    paper's alternating dual-FPGA batches).  The distributed engine
    dispatches each wave apart within a tick, so one wave's logits fetch
    lands while the other's call is in flight.  Invariants: waves never
    share a slot (one ``wave[slot]`` array); a slot that starts decoding
    joins the lightest wave (lowest id on ties); a wave that runs empty
    takes half the movable slots of the heaviest, which idle one tick."""

    def __init__(self, n_slots: int, n_waves: int = 2):
        if n_waves < 1 or n_slots < 1:
            raise ValueError(f"n_slots={n_slots}, n_waves={n_waves}")
        self.n_waves = n_waves
        self.wave = np.full((n_slots,), -1, np.int64)  # -1 = unassigned

    def counts(self) -> List[int]:
        return [int((self.wave == w).sum()) for w in range(self.n_waves)]

    def imbalance(self) -> float:
        """(heaviest - lightest) / assigned, 0 when balanced or empty."""
        c = self.counts()
        total = sum(c)
        return (max(c) - min(c)) / total if total else 0.0

    def members(self, w: int) -> List[int]:
        return [b for b in range(len(self.wave)) if self.wave[b] == w]

    def release(self, slot: int) -> None:
        self.wave[slot] = -1

    def join(self, slot: int) -> int:
        """Seat a slot that starts decoding in the lightest wave (no-op
        for an assigned one); returns its wave."""
        if self.wave[slot] < 0:
            self.wave[slot] = int(np.argmin(self.counts()))
        return int(self.wave[slot])

    def assign(self, movable: Sequence[int]) -> None:
        """Place unassigned slots and refill emptied waves; only
        ``movable`` slots (no dispatch in flight) join or move."""
        movable = list(movable)
        for b in movable:
            if self.wave[b] < 0:
                self.wave[b] = int(np.argmin(self.counts()))
        for w in range(self.n_waves):
            c = self.counts()
            if c[w]:
                continue
            donor = int(np.argmax(c))
            pool = [b for b in movable if self.wave[b] == donor]
            for b in pool[:min(len(pool), c[donor] // 2)]:
                self.wave[b] = w


def victim_order(candidates, pages_of):
    """Preemption victim policy: seated requests in eviction order —
    lowest priority first, most pages first (``pages_of``: pages held, or
    the stacked layout's committed length), newest (highest rid) first.
    Returns a new list."""
    return sorted(candidates,
                  key=lambda r: (r.priority, -pages_of(r), -r.rid))


class FIFOAdmission:
    """FIFO admission + per-tick prefill-chunk budget."""

    #: reservation pricing (worst-case lifetime up front) — never preempts
    overcommit = False

    def __init__(self, cfg: ModelConfig, *, chunk_size: int = 32,
                 budget_tokens: Optional[int] = None, nodes: int = 2):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size={chunk_size} must be positive")
        self.chunk_size = chunk_size
        if budget_tokens is None:
            budget_tokens = derive_prefill_budget(cfg, chunk_size,
                                                  nodes=nodes)
        self.budget_tokens = max(budget_tokens, chunk_size)

    def page_price(self, prompt_len: int, max_new: int, *, page_size: int,
                   max_seq: int, shared_tokens: int = 0) -> int:
        """Admission price of one request in KV-cache pages."""
        total = -(-min(prompt_len + max_new, max_seq) // page_size)
        return max(0, total - shared_tokens // page_size)

    def slot_price(self, cfg: ModelConfig, prompt_len: int, max_new: int,
                   *, max_seq: int) -> int:
        """Admission price of one request in contiguous-slot positions: the
        per-layer maximum of its lifetime footprint.  A global-attention
        layer pins ``min(len, max_seq)`` positions, a sliding-window
        layer at most its window, ``min(len, W, max_seq)``, and a
        recurrent layer one position's worth of state at any length.  The
        engine's request ceiling (``seq_ceiling``) is this formula taken
        past the cache: lifted where the price saturates below it."""
        toks = prompt_len + max_new
        price = 1
        for kind in cfg.block_pattern:
            if kind == "attn":
                price = max(price, min(toks, max_seq))
            elif kind == "local_attn":
                price = max(price, min(toks, cfg.window or max_seq,
                                       max_seq))
        return price

    def combined_price(self, cfg: ModelConfig, prompt_len: int,
                       max_new: int, *, page_size: int, max_seq: int,
                       shared_tokens: int = 0) -> int:
        """Admission price in pages on the per-kind paged layout: the
        larger of the page cost (the ``attn`` layers' K/V, the only part
        prefix sharing discounts) and the slot-resident cost of the rings
        and states in positions, rounded up to pages.  The layers cover
        the same tokens, so the footprint is the max, not the sum; a
        global-attention stack prices its pages alone."""
        pages = self.page_price(prompt_len, max_new, page_size=page_size,
                                max_seq=max_seq, shared_tokens=shared_tokens)
        if blocks.page_addressable(cfg):
            return pages
        slot_pages = -(-self.slot_price(cfg, prompt_len, max_new,
                                        max_seq=max_seq) // page_size)
        return max(pages, slot_pages)

    def plan_chunks(self, prefilling: Sequence[Tuple[int, int, int]]
                    ) -> List[PrefillChunk]:
        """This tick's prompt chunks from (slot, prompt_len, filled)
        triples in FIFO order: at most one chunk per request, the total
        capped by ``budget_tokens`` (a chunk that does not fit waits for
        the next tick rather than splitting)."""
        budget = self.budget_tokens
        out: List[PrefillChunk] = []
        for slot, prompt_len, filled in prefilling:
            n = min(self.chunk_size, prompt_len - filled)
            if n <= 0:
                continue
            if n > budget:
                break
            out.append(PrefillChunk(slot=slot, start=filled, n=n))
            budget -= n
        return out


class OvercommitAdmission(FIFOAdmission):
    """Over-commit admission with preemption: a request is admitted when
    its *prompt* pages fit and the pool's occupancy stays under
    ``watermark * (n_pages - 1)``; decode growth claims from the free
    pool, and when that runs dry the engine preempts a victim to host
    memory or to a recompute requeue instead of refusing arrivals."""

    overcommit = True

    def __init__(self, cfg: ModelConfig, *, watermark: float = 1.0,
                 **kwargs):
        super().__init__(cfg, **kwargs)
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark must be in (0, 1], got "
                             f"{watermark}")
        self.watermark = watermark

    def page_price(self, prompt_len: int, max_new: int, *, page_size: int,
                   max_seq: int, shared_tokens: int = 0) -> int:
        """Admission price in pages: the prompt alone, net of
        prefix-shared pages."""
        total = -(-min(prompt_len, max_seq) // page_size)
        return max(0, total - shared_tokens // page_size)
