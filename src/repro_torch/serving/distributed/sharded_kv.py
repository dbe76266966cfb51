"""Sharded KV allocators: one page pool (or slot pool) per shard.

A :class:`ShardedPageAllocator` owns ``n_shards`` host-side
:class:`~repro_torch.serving.kv_cache.PagedCacheManager` instances
(metadata only, ``with_cache=False``); the K/V live in one cache per
shard, on that shard's device, which the engine holds in a list
(``caches[s]``) — the reference's leading shard axis.  Nothing in the
engine's tick moves them.

Shard locality (the reference's invariants):

  * **Page ids are shard-local.**  Each shard numbers its pages
    ``0..n_pages-1``; a block-table row is only handed to the shard that
    allocated it.
  * **A request never straddles shards.**  ``alloc`` places the whole
    request (prompt pages, decode-growth reservation, prefix links) on one
    shard chosen by :class:`~repro_torch.serving.admission.ShardPlacement`;
    a request too large for every single shard raises ``ValueError`` even
    when the shards' free pages together would cover it.
  * **Only metadata travels.**  Block-table rows, token ids, lengths and
    logits cross the host/device boundary each tick, each far smaller
    than one page-pool leaf.

Global slot ids are ``shard * slots_per_shard + local_slot``; the engine
sees globals, the managers locals.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.admission import ShardPlacement
from repro_torch.serving.kv_cache import (PagedCacheManager,
                                          PagePoolExhausted,
                                          SlotCacheManager)


class _ShardedBase:
    """Global-slot-id delegation shared by the paged and stacked pools."""

    shards: List
    slots_per_shard: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def state(self):
        """The stack's ``StateStore`` (None for pure-attention stacks);
        the shards are alike, so shard 0's serves them all."""
        return self.shards[0].state

    def shard_of(self, slot: int) -> Tuple[int, int]:
        """Global slot id -> (shard, local slot)."""
        return divmod(slot, self.slots_per_shard)

    def advance(self, slot: int, n: int) -> None:
        s, ls = self.shard_of(slot)
        self.shards[s].advance(ls, n)

    def advance_mask(self, mask) -> None:
        mask = np.asarray(mask).reshape(self.n_shards, self.slots_per_shard)
        for s, m in enumerate(self.shards):
            m.advance_mask(mask[s])

    def length_of(self, slot: int) -> int:
        s, ls = self.shard_of(slot)
        return self.shards[s].length_of(ls)

    def has_room(self, slot: int, n: int = 1) -> bool:
        s, ls = self.shard_of(slot)
        return self.shards[s].has_room(ls, n)

    def free(self, slot: int) -> None:
        s, ls = self.shard_of(slot)
        self.shards[s].free(ls)

    def pages_held(self, slot: int) -> int:
        s, ls = self.shard_of(slot)
        return self.shards[s].pages_held(ls)

    def rewind(self, slot: int, new_len: int) -> None:
        """Roll a global slot back to ``new_len`` on its own shard (the
        speculative rejection path)."""
        s, ls = self.shard_of(slot)
        self.shards[s].rewind(ls, new_len)

    # -- preemption and migration: the host round trip ---------------------
    def evict_to_host(self, slot: int, *, cache=None, shard=None) -> Dict:
        """Snapshot a global slot's pages or rows from its shard's cache
        (``cache`` is the engine's per-shard list) to host memory and free
        it; the blob records the source shard."""
        s, ls = self.shard_of(slot)
        blob = self.shards[s].evict_to_host(ls, cache=cache, shard=s)
        blob["shard"] = s
        return blob

    def restore(self, blob: Dict, *, lifetime_tokens=None, cache=None,
                shard=None):
        """Re-seat a host blob on ``shard`` (a migration target) or on the
        first shard of the placement order that can take it.  Returns
        ``(global_slot, cache)`` or None (retry next tick)."""
        order = ([shard] if shard is not None
                 else self.placement.order(self.shards))
        for s in order:
            res = self.shards[s].restore(
                blob, lifetime_tokens=lifetime_tokens, cache=cache, shard=s)
            if res is not None:
                ls, cache = res
                return s * self.slots_per_shard + ls, cache
        return None

    # -- device-call views -------------------------------------------------
    def lengths_array(self) -> np.ndarray:
        """(D, Bs) int32 per-shard slot lengths."""
        return np.stack([m.lengths for m in self.shards])

    @property
    def n_free(self) -> int:
        return sum(m.n_free for m in self.shards)

    @property
    def n_used(self) -> int:
        return sum(m.n_used for m in self.shards)

    def stats(self) -> Dict[str, int]:
        per_shard = [m.stats() for m in self.shards]
        return {k: sum(d[k] for d in per_shard) for k in per_shard[0]}


class ShardedPageAllocator(_ShardedBase):
    """Per-shard paged KV pools behind one global-slot-id allocator."""

    def __init__(self, cfg: ModelConfig, n_shards: int, slots_per_shard: int,
                 max_seq: int, *, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 placement: Optional[ShardPlacement] = None,
                 overcommit: bool = False, watermark: float = 1.0):
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards}")
        self.cfg = cfg
        self.slots_per_shard = slots_per_shard
        self.max_seq = max_seq
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        self.placement = placement or ShardPlacement()
        self.shards = [
            PagedCacheManager(cfg, slots_per_shard, max_seq,
                              page_size=page_size, n_pages=n_pages,
                              prefix_sharing=prefix_sharing,
                              with_cache=False, overcommit=overcommit,
                              watermark=watermark)
            for _ in range(n_shards)]
        self.pages_per_seq = self.shards[0].pages_per_seq
        self.n_pages = self.shards[0].n_pages  # per shard

    def probe_pending(self, prompt: Sequence[int]) -> bool:
        """True if any shard holds a not-yet-ready registration of this
        prompt's next prefix page."""
        return any(m.probe_pending(prompt) for m in self.shards)

    def alloc(self, prompt: Sequence[int], max_new: int = 1, *,
              share: bool = True, shard: Optional[int] = None
              ) -> Optional[Tuple[int, int]]:
        """Place one request on a single shard: the placement order's
        candidates (or the forced ``shard``) in turn.  Returns
        ``(global_slot, shared_tokens)``, or None when every candidate is
        momentarily full.  Raises ``ValueError`` when no candidate could
        ever fit it: pages never straddle shards."""
        order = ([shard] if shard is not None
                 else self.placement.order(
                     self.shards, prompt,
                     share=share and self.prefix_sharing))
        never_fits = 0
        err: Optional[ValueError] = None
        for s in order:
            try:
                res = self.shards[s].alloc(prompt, max_new, share=share)
            except ValueError as e:  # this shard can never fit it
                never_fits += 1
                err = e
                continue
            if res is not None:
                local, shared_tokens = res
                return s * self.slots_per_shard + local, shared_tokens
        if never_fits == len(order):
            raise ValueError(
                f"request fits no single pool shard ({err}); K/V pages "
                "never straddle shards, so aggregate free pages across "
                f"{self.n_shards} shards cannot admit it — raise n_pages "
                "per shard or lower max_new")
        return None

    def ensure_decode_room(self, mask, n=1) -> None:
        """Per-shard decode room; ``n`` a scalar or one count per global
        slot.  An exhausted shard raises with the global slot id."""
        mask = np.asarray(mask).reshape(self.n_shards, self.slots_per_shard)
        ns = np.broadcast_to(
            np.asarray(n, np.int64), (self.n_shards * self.slots_per_shard,)
        ).reshape(mask.shape)
        for s, m in enumerate(self.shards):
            try:
                m.ensure_decode_room(mask[s], ns[s])
            except PagePoolExhausted as e:
                gslot = (s * self.slots_per_shard + e.slot
                         if e.slot is not None else None)
                raise PagePoolExhausted(f"shard {s}: {e}",
                                        slot=gslot) from None

    def block_tables_array(self) -> np.ndarray:
        """(D, Bs, pages_per_seq) int32, shard-local page ids."""
        return np.stack([m.block_tables for m in self.shards])

    def owned_pages(self, slot: int) -> set:
        s, ls = self.shard_of(slot)
        return set(self.shards[s]._slot_pages.get(ls, []))

    def check_shard_locality(self, caches=None, mesh=None) -> None:
        """Assert every live slot's block table resolves inside its own
        shard's page ids and ownership records; with ``caches`` and
        ``mesh``, also that every cache tensor of shard s lies on
        ``mesh.devices[s]``."""
        for s, m in enumerate(self.shards):
            for ls in m._used_slots:
                row = set(int(p) for p in m.block_tables[ls])
                owned = set(m._slot_pages[ls]) | {0}
                assert row <= owned, (s, ls, row, owned)
                assert all(0 <= p < m.n_pages for p in row), (s, ls, row)
        if caches is not None:
            _check_devices(caches, mesh)

    @property
    def available_pages(self) -> List[int]:
        return [m.available_pages for m in self.shards]


class ShardedSlotAllocator(_ShardedBase):
    """Per-shard contiguous slot pools (``kv_layout="stacked"``)."""

    def __init__(self, cfg: ModelConfig, n_shards: int, slots_per_shard: int,
                 max_seq: int, *, placement: Optional[ShardPlacement] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards}")
        self.cfg = cfg
        self.slots_per_shard = slots_per_shard
        self.max_seq = max_seq
        self.placement = placement or ShardPlacement()
        self.shards = [SlotCacheManager(cfg, slots_per_shard, max_seq,
                                        with_cache=False)
                       for _ in range(n_shards)]

    def alloc(self, *, shard: Optional[int] = None) -> Optional[int]:
        """A slot on the least-loaded shard (or the forced ``shard``), or
        None when every candidate is full."""
        order = ([shard] if shard is not None
                 else self.placement.order(self.shards))
        for s in order:
            local = self.shards[s].alloc()
            if local is not None:
                return s * self.slots_per_shard + local
        return None

    def check_shard_locality(self, caches=None, mesh=None) -> None:
        if caches is not None:
            _check_devices(caches, mesh)


def _check_devices(caches, mesh) -> None:
    for s, cache in enumerate(caches):
        for layer in cache["layers"]:
            for t in layer.values():
                assert t.device == mesh.devices[s], (s, t.device)
