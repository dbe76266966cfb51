"""KV-cache managers for the serving engine: contiguous slots and pages.

Copies of the JAX package's managers (``repro/serving/kv_cache.py``),
behind one engine-facing seam (alloc / free / advance / lengths /
has_room / rewind / evict_to_host / restore):

  * :class:`SlotCacheManager` — ``batch_slots`` rows, one per request
    (``kv_layout="stacked"``): contiguous ``max_seq`` positions for each
    global-attention layer, a ring for each sliding-window layer, a
    carried state for each recurrent one.  Its ``rewind`` is mask-only;
    a stack with rings or states also owns a :class:`StateStore`, the
    seam that undoes what a speculative verify wrote into them.  On a
    window-capped stack (``bounded=False``) a request may grow past
    ``max_seq``.
  * :class:`PagedCacheManager` — a global page pool, per-request block
    tables, refcounted pages and copy-free prefix sharing
    (``kv_layout="paged"``, stacks with a global-attention layer).  The
    layout is per kind: only ``attn`` layers take pages; a mixed stack's
    rings and recurrent states stay slot-resident, one row per slot, so
    this manager owns a :class:`StateStore` too.  Prefix sharing there
    saves pages only: the shared pages are linked, but slot-resident
    state cannot be shared, so ``alloc`` returns ``shared_tokens=0`` and
    the whole prompt is prefilled again, its ``attn`` writes landing in
    the shared pages with the content they already hold.

Correctness model for pages: logical position ``p`` of a slot lives in
page ``block_tables[slot, p // page_size]`` at offset ``p % page_size``;
entries past a slot's allocated pages name the null page 0, whose content
is never unmasked, because attention only reads positions below the
slot's length and the engine grows a length only after its pages exist.
Only *full* prompt pages enter the prefix map, so a shared page is never
written again.  A freed prefix page is *cached*: it keeps its content and
map entry until a fresh claim needs it, so a later request with the same
prefix resurrects it.  In reservation mode every request reserves its
worst-case page count at admission, so decode-time growth cannot fail;
in over-commit mode (``overcommit=True``) only the prompt is priced, and
growth past the pool raises :class:`PagePoolExhausted` for the engine to
preempt a victim.

Preemption to host (``evict_to_host`` / ``restore``) copies a request's
cache rows (stacked) or pages (paged, in block-table order, with a mixed
stack's slot-resident rows) to host memory and scatters them back
verbatim into a fresh slot or fresh pages.

For the distributed engine (``serving/distributed``) a manager can hold
host metadata only (``with_cache=False``): the engine keeps one cache per
shard, on that shard's device, in a list, and passes it with the shard
index to ``evict_to_host`` / ``restore`` (``cache=caches, shard=s``).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class PagePoolExhausted(RuntimeError):
    """Mid-decode page growth found the pool empty.  Only the over-commit
    admission mode can raise this (reservation mode pre-pays every
    request's worst-case lifetime); the engine catches it and preempts a
    victim.  ``slot`` names the request whose growth hit the wall, which
    locates the exhausted shard of a sharded pool."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


def _own_or_given(own: Optional[Dict], cache, shard: Optional[int]) -> Dict:
    """The cache an eviction or restore works on: the manager's own, or
    the given one (entry ``shard`` of a per-shard list)."""
    if cache is None:
        return own
    return cache if shard is None else cache[shard]


def blob_nbytes(blob: Dict) -> int:
    """Host bytes an ``evict_to_host`` snapshot occupies."""
    return int(sum(t.numel() * t.element_size()
                   for layer in blob["kv"]["layers"] for t in layer.values()))


class StateStore:
    """The carried-state rewind seam, owned beside the slot pool.

    Rings and recurrent states have no length mask: a speculative verify
    writes them for every draft position, accepted or not, so the
    managers' mask-only ``rewind`` cannot undo a rejection.  The store
    does: :meth:`snapshot` copies the ring slots a verify will overwrite
    (the reference holds the whole pre-verify cache instead, which its
    immutable arrays make free and this in-place cache would make a full
    copy), and :meth:`commit` restores the rejected ones and selects each
    recurrent state off the verify's trajectory
    (:func:`repro_torch.models.lm.commit_verify`).  Only stacks with a
    non-``attn`` layer own one, on either layout: on the paged one the
    rings and states are the slot-resident entries, and the manager's
    ``rewind`` releases the ``attn`` side's rejected pages."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def snapshot(self, cache: Dict, lengths: torch.Tensor, *,
                 chunk: int) -> Dict:
        return lm.verify_snapshot(self.cfg, cache, lengths, chunk=chunk)

    def commit(self, snap: Dict, cache: Dict, traj, lengths: torch.Tensor,
               counts: torch.Tensor, valids: torch.Tensor, *,
               chunk: int) -> Dict:
        """Keep ``counts`` of the ``valids`` chunk tokens a verify at base
        ``lengths`` applied per row; returns the committed cache."""
        return lm.commit_verify(self.cfg, snap, cache, traj, lengths,
                                counts, valids, chunk=chunk)

    def commit_sharded(self, mesh, snaps, caches, trajs, lengths, counts,
                       valids, *, chunk: int):
        """:meth:`commit` on every shard of a mesh, each on its own device
        (:func:`repro_torch.models.lm.sharded_commit_verify`): ``snaps``,
        ``caches`` and ``trajs`` are per-shard lists, ``lengths`` /
        ``counts`` / ``valids`` (D, Bs).  Rows with ``counts == 0`` pass
        through, so one wave's commit may land a tick late."""
        return lm.sharded_commit_verify(self.cfg, mesh, snaps, caches,
                                        trajs, lengths, counts, valids,
                                        chunk=chunk)

    def evict_to_host(self, cache: Dict, slot: int) -> Dict:
        """The slot-resident entries (rings, recurrent states) of ``slot``
        on host memory: ``page_ids=()`` gathers no page of an ``attn``
        entry."""
        return lm.gather_request_cache(self.cfg, cache, slot, page_ids=())

    def restore(self, cache: Dict, blob: Dict, slot: int) -> Dict:
        """Scatter an :meth:`evict_to_host` snapshot back into ``slot``;
        in place, returns the cache."""
        return lm.scatter_request_cache(self.cfg, cache, blob, slot,
                                        page_ids=())


class SlotCacheManager:
    """The slot pool, per-slot lengths and the stacked cache.

    ``cache`` holds ``batch_slots`` rows per layer (on ``device``);
    ``lengths`` is a host array the engine sends to the device once per
    call.  Freeing is mask-only: a slot's stale K/V stays below nothing,
    since its length restarts at 0, and a ring or recurrent state is
    reset when its row next starts at position 0.  ``bounded=False``
    (window-capped stacks) lifts the ``max_seq`` ceiling from the length
    accounting: no layer ever holds more than ``min(len, W)`` positions."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_seq: int, *,
                 dtype=torch.bfloat16, device=None, bounded: bool = True,
                 with_cache: bool = True):
        self.cfg = cfg
        self.B = batch_slots
        self.max_seq = max_seq
        self.bounded = bounded
        self.state: Optional[StateStore] = (
            StateStore(cfg)
            if any(k != "attn" for k in cfg.block_pattern) else None)
        # with_cache=False: host metadata only (the distributed engine
        # keeps the caches, one per shard)
        self.cache: Optional[Dict] = (
            lm.init_cache(cfg, batch_slots, max_seq, layout="stacked",
                          dtype=dtype, device=device)
            if with_cache else None)
        self.lengths = np.zeros((batch_slots,), np.int32)
        # heap-backed free list: lowest slot first, as the reference
        self._free: List[int] = list(range(batch_slots))
        heapq.heapify(self._free)
        self._used: set = set()
        self.slots_in_use_peak = 0

    # -- slot lifecycle -------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Claim a free slot (length reset to 0), or None if none is free."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._used.add(slot)
        self.slots_in_use_peak = max(self.slots_in_use_peak, len(self._used))
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Return a slot to the pool; its stale content stays masked."""
        if slot not in self._used:
            raise ValueError(f"free of unallocated slot {slot}")
        self._used.discard(slot)
        heapq.heappush(self._free, slot)
        self.lengths[slot] = 0

    # -- preemption: host round trip ------------------------------------
    def evict_to_host(self, slot: int, *, cache=None,
                      shard: Optional[int] = None) -> Dict:
        """Snapshot a slot's cache rows to host memory and free the slot
        (from the manager's cache, or ``cache[shard]`` of a per-shard
        list, or ``cache``)."""
        if slot not in self._used:
            raise ValueError(f"evict of unallocated slot {slot}")
        src = _own_or_given(self.cache, cache, shard)
        blob = {"layout": "stacked", "length": int(self.lengths[slot]),
                "kv": lm.gather_request_cache(self.cfg, src, slot)}
        self.free(slot)
        return blob

    def restore(self, blob: Dict, *, lifetime_tokens: Optional[int] = None,
                cache=None, shard: Optional[int] = None):
        """Re-seat a host snapshot into a fresh slot.  Returns None when no
        slot is free, else the slot, or ``(slot, cache)`` when a ``cache``
        was given (written in place)."""
        slot = self.alloc()
        if slot is None:
            return None
        self.lengths[slot] = blob["length"]
        lm.scatter_request_cache(self.cfg, _own_or_given(self.cache, cache,
                                                         shard),
                                 blob["kv"], slot)
        return slot if cache is None else (slot, cache)

    def pages_held(self, slot: int) -> int:
        """Victim-policy weight: the stacked layout has no pages, so the
        footprint is the slot's committed length."""
        return int(self.lengths[slot])

    # -- length accounting ---------------------------------------------
    def advance(self, slot: int, n: int) -> None:
        """Record n prefill tokens written to a slot."""
        self.lengths[slot] += n

    def advance_mask(self, mask) -> None:
        """Advance every masked slot by one token (one decode tick)."""
        self.lengths += np.asarray(mask, np.int32)

    def rewind(self, slot: int, new_len: int) -> None:
        """Set a slot's valid length after a multi-token (speculative)
        write, mask-only: lengths gate attention, so the K/V of rejected
        positions above ``new_len`` are never read and the next write
        there replaces them.  ``new_len`` may exceed the current length
        (the verify writes before the engine commits)."""
        if slot not in self._used:
            raise ValueError(f"rewind of unallocated slot {slot}")
        if new_len < 0 or (self.bounded and new_len > self.max_seq):
            raise ValueError(
                f"rewind of slot {slot} to {new_len} outside the cache "
                f"(max_seq={self.max_seq})")
        self.lengths[slot] = new_len

    def length_of(self, slot: int) -> int:
        return int(self.lengths[slot])

    # -- introspection --------------------------------------------------
    def has_room(self, slot: int, n: int = 1) -> bool:
        if not self.bounded:
            return True  # window-capped: rings wrap, states are O(1)
        return self.length_of(slot) + n <= self.max_seq

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def stats(self) -> Dict[str, int]:
        """The slot analogue of ``PagedCacheManager.stats``."""
        return {
            "slots_in_use": len(self._used),
            "slots_in_use_peak": self.slots_in_use_peak,
            "n_free_slots": len(self._free),
        }


class PagedCacheManager:
    """Page-pool KV cache: block tables, refcounts, and prefix sharing.

    ``cache`` holds ``n_pages`` pages of ``page_size`` tokens per layer
    (on ``device``); ``block_tables`` and ``lengths`` are host arrays the
    engine sends to the device once per call."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_seq: int, *,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_sharing: bool = True, dtype=torch.bfloat16,
                 device=None, overcommit: bool = False,
                 watermark: float = 1.0, with_cache: bool = True):
        if max_seq % page_size:
            raise ValueError(
                f"page_size={page_size} must divide max_seq={max_seq}")
        self.cfg = cfg
        self.B = batch_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_seq = max_seq // page_size
        if n_pages is None:
            # worst case every slot holds a full sequence, +1 null page
            n_pages = 1 + batch_slots * self.pages_per_seq
        if n_pages < 2:
            raise ValueError("need at least the null page and one real page")
        self.n_pages = n_pages
        self.prefix_sharing = prefix_sharing
        # over-commit: price prompts only and admit fresh requests while
        # occupancy stays under watermark * usable pages; decode growth
        # past the pool raises PagePoolExhausted
        self.overcommit = overcommit
        if not 0.0 < watermark <= 1.0:
            raise ValueError(
                f"watermark={watermark} must be in (0, 1]: it is the "
                "occupancy fraction fresh admissions may fill")
        self.watermark = watermark
        # rings and recurrent states of a mixed stack: slot-resident, with
        # the stacked layout's rewind seam
        self.state: Optional[StateStore] = (
            StateStore(cfg)
            if any(k != "attn" for k in cfg.block_pattern) else None)
        # with_cache=False: host metadata only (see SlotCacheManager)
        self.cache: Optional[Dict] = (
            lm.init_cache(cfg, n_pages, page_size, layout="paged",
                          dtype=dtype, device=device, slots=batch_slots,
                          slot_seq=max_seq)
            if with_cache else None)
        self.lengths = np.zeros((batch_slots,), np.int32)
        self.block_tables = np.zeros(
            (batch_slots, self.pages_per_seq), np.int32)

        self._free_slots: List[int] = list(range(batch_slots))
        heapq.heapify(self._free_slots)
        self._used_slots: set = set()
        # free pages in two tiers: never-mapped ("clean") pages first,
        # then cached prefix pages (lazy-deleted heap + membership set)
        self._free_clean: List[int] = list(range(1, n_pages))  # 0 = null
        heapq.heapify(self._free_clean)
        self._free_cached: List[int] = []
        self._free_cached_set: set = set()
        self._cached_heap_pids: set = set()
        self._refcount = np.zeros((n_pages,), np.int64)
        self._slot_pages: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}  # slot -> pages still owed
        self._min_len: Dict[int, int] = {}  # slot -> rewind floor (prompt)
        # prefix map: chained hash of full prompt pages -> page id.  The
        # hash only accelerates lookup: a match also requires the page's
        # exact tokens and predecessor page (_page_meta), so a collision
        # can never link another request's K/V.
        self._prefix_map: Dict[int, int] = {}
        self._page_hash: Dict[int, int] = {}
        self._page_meta: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._page_ready: set = set()
        self._pending_ready: Dict[int, List[Tuple[int, int]]] = {}

        self.pages_allocated_total = 0
        self.prefix_hit_pages = 0
        self.pages_in_use_peak = 0

    # -- page math ------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_clean) + len(self._free_cached_set)

    @property
    def available_pages(self) -> int:
        """Free pages net of outstanding decode-growth reservations."""
        return self.n_free_pages - sum(self._reserved.values())

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - self.n_free_pages

    # -- prefix sharing -------------------------------------------------
    @staticmethod
    def _chain(h: int, page_tokens: Tuple[int, ...]) -> int:
        return hash((h, page_tokens))

    def _match_prefix(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Ready full prefix pages for ``prompt`` (at least one prompt
        token is always left to prefill); returns (page ids, chain hash)."""
        ps = self.page_size
        pids: List[int] = []
        h, parent = 0, 0
        if not self.prefix_sharing:
            return pids, h
        for i in range((len(prompt) - 1) // ps):
            toks = tuple(prompt[i * ps:(i + 1) * ps])
            nh = self._chain(h, toks)
            pid = self._prefix_map.get(nh)
            if (pid is None or pid not in self._page_ready
                    or self._page_meta.get(pid) != (parent, toks)):
                break
            h = nh
            pids.append(pid)
            parent = pid
        return pids, h

    def shared_prefix_pages(self, prompt: Sequence[int]) -> int:
        """Ready full prefix pages this pool holds for ``prompt`` (no
        change to the pool): the shard-placement affinity signal."""
        return len(self._match_prefix(prompt)[0])

    def probe_pending(self, prompt: Sequence[int]) -> bool:
        """True if the prompt's next unshared full prefix page is
        registered by a live request whose prefill has not covered it
        yet: admission waits a tick and links it instead of copying."""
        if not self.prefix_sharing:
            return False
        ps = self.page_size
        h, parent = 0, 0
        for i in range((len(prompt) - 1) // ps):
            toks = tuple(prompt[i * ps:(i + 1) * ps])
            h = self._chain(h, toks)
            pid = self._prefix_map.get(h)
            if pid is None or self._page_meta.get(pid) != (parent, toks):
                return False
            if pid not in self._page_ready:
                return True
            parent = pid
        return False

    def _claim_page(self) -> int:
        if self._free_clean:
            pid = heapq.heappop(self._free_clean)
        else:
            pid = self._pop_cached()
        self._refcount[pid] = 1
        self.pages_allocated_total += 1
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        return pid

    def _pop_cached(self) -> int:
        """Evict the lowest-id cached free page for fresh use."""
        while self._free_cached:
            pid = heapq.heappop(self._free_cached)
            self._cached_heap_pids.discard(pid)
            if pid in self._free_cached_set:  # lazy deletion
                self._free_cached_set.discard(pid)
                self._evict(pid)
                return pid
        raise RuntimeError("page claim past the free pool")

    def _evict(self, pid: int) -> None:
        """Drop a page's prefix-map registration."""
        h = self._page_hash.pop(pid, None)
        if h is not None and self._prefix_map.get(h) == pid:
            del self._prefix_map[h]
        self._page_meta.pop(pid, None)
        self._page_ready.discard(pid)

    def _release_page(self, pid: int) -> None:
        self._refcount[pid] -= 1
        if self._refcount[pid] < 0:
            raise RuntimeError(f"page {pid} released below refcount 0")
        if self._refcount[pid] == 0:
            if pid in self._page_ready and pid in self._page_hash:
                # ready prefix page: keep content + map entry cached
                if pid not in self._cached_heap_pids:
                    heapq.heappush(self._free_cached, pid)
                    self._cached_heap_pids.add(pid)
                self._free_cached_set.add(pid)
            else:
                self._evict(pid)
                heapq.heappush(self._free_clean, pid)

    # -- slot lifecycle -------------------------------------------------
    def alloc(self, prompt: Sequence[int], max_new: int = 1, *,
              share: bool = True) -> Optional[Tuple[int, int]]:
        """Admit one request: claim a slot, link shared prefix pages,
        claim fresh pages for the rest of the prompt and reserve its
        decode growth.  Returns ``(slot, shared_tokens)`` — prefill starts
        at ``shared_tokens``, which is 0 on a mixed stack (its
        slot-resident state is prefilled again over the linked pages) —
        or None when slots or pages are short.
        Raises ``ValueError`` for a request that can never fit."""
        plen = len(prompt)
        if plen > self.max_seq:
            raise ValueError(
                f"prompt ({plen} tokens) exceeds the cache (max_seq="
                f"{self.max_seq}); admitting it would corrupt the mask")
        total_pages = self.pages_for(min(plen + max_new, self.max_seq))
        prompt_pages = self.pages_for(plen)
        if self.overcommit:
            # only the prompt must fit: decode growth is preemption's
            # problem, not admission's
            if prompt_pages > self.n_pages - 1:
                raise ValueError(
                    f"prompt needs {prompt_pages} pages but the pool only "
                    f"has {self.n_pages - 1}; it can never be admitted "
                    "(raise n_pages or shorten the prompt)")
        elif total_pages > self.n_pages - 1:
            raise ValueError(
                f"request needs {total_pages} pages but the pool only has "
                f"{self.n_pages - 1}; it can never be admitted (raise "
                "n_pages or lower max_new)")
        if not self._free_slots:
            return None
        ps = self.page_size
        shared_pids, h = (self._match_prefix(prompt) if share else ([], 0))
        n_shared = len(shared_pids)
        # resurrecting a cached (refcount-0) page consumes a free page
        n_cached = sum(1 for pid in shared_pids if self._refcount[pid] == 0)
        if self.overcommit:
            fresh = (prompt_pages - n_shared) + n_cached
            if (fresh > self.n_free_pages
                    or self.pages_in_use + fresh
                    > self.watermark * (self.n_pages - 1)):
                return None
        elif (total_pages - n_shared) + n_cached > self.available_pages:
            return None

        slot = heapq.heappop(self._free_slots)
        self._used_slots.add(slot)
        pages: List[int] = []
        for pid in shared_pids:
            if self._refcount[pid] == 0:
                self._free_cached_set.discard(pid)
            self._refcount[pid] += 1
            pages.append(pid)
        self.prefix_hit_pages += n_shared
        pending: List[Tuple[int, int]] = []
        register = share and self.prefix_sharing
        for i in range(n_shared, prompt_pages):
            pid = self._claim_page()
            pages.append(pid)
            if register and (i + 1) * ps <= plen:  # full page -> shareable
                toks = tuple(prompt[i * ps:(i + 1) * ps])
                h = self._chain(h, toks)
                if h not in self._prefix_map:
                    self._prefix_map[h] = pid
                    self._page_hash[pid] = h
                    self._page_meta[pid] = (pages[i - 1] if i else 0, toks)
                    pending.append((pid, (i + 1) * ps))
        self._slot_pages[slot] = pages
        self._reserved[slot] = (0 if self.overcommit
                                else total_pages - prompt_pages)
        # rewind floor: prompt pages may be prefix-shared or registered;
        # rejected drafts always sit above them
        self._min_len[slot] = plen
        self._pending_ready[slot] = pending
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        shared_tokens = 0 if self.state is not None else n_shared * ps
        self.lengths[slot] = shared_tokens
        return slot, shared_tokens

    def free(self, slot: int) -> None:
        """Release a slot: decref its pages (shared pages survive their
        other sharers) and drop its reservation."""
        if slot not in self._used_slots:
            raise ValueError(f"free of unallocated slot {slot}")
        self._used_slots.discard(slot)
        for pid in self._slot_pages.pop(slot):
            self._release_page(pid)
        self._reserved.pop(slot, None)
        self._min_len.pop(slot, None)
        self._pending_ready.pop(slot, None)
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        heapq.heappush(self._free_slots, slot)

    # -- preemption: host round trip ------------------------------------
    def evict_to_host(self, slot: int, *, cache=None,
                      shard: Optional[int] = None) -> Dict:
        """Snapshot a slot's pages (in block-table order) and, on a mixed
        stack, its slot-resident rings and states to host memory, and free
        the slot.  Shared pages are copied, then released by the free; the
        restore scatters onto fresh, unshared pages.  ``cache`` /
        ``shard`` as in :meth:`SlotCacheManager.evict_to_host`."""
        if slot not in self._used_slots:
            raise ValueError(f"evict of unallocated slot {slot}")
        pages = list(self._slot_pages[slot])
        src = _own_or_given(self.cache, cache, shard)
        blob = {"layout": "paged", "length": int(self.lengths[slot]),
                "min_len": self._min_len.get(slot, 0),
                "n_pages": len(pages),
                "kv": lm.gather_request_cache(self.cfg, src, slot,
                                              page_ids=pages)}
        self.free(slot)
        return blob

    def restore(self, blob: Dict, *, lifetime_tokens: Optional[int] = None,
                cache=None, shard: Optional[int] = None):
        """Re-seat a host snapshot: claim a slot and fresh pages (the same
        count, any ids: the block table re-maps them), scatter the content
        back (a mixed stack's rings and states into the new slot's rows)
        and resume the length where it stopped.  Returns the slot, or
        ``(slot, cache)`` when a ``cache`` was given, or None (wait).
        Restores bypass the over-commit watermark (the request paid
        admission once) but need the pages; in reservation mode the rest
        of the worst-case lifetime (``lifetime_tokens``) is reserved
        again."""
        need = blob["n_pages"]
        if not self._free_slots:
            return None
        if self.overcommit:
            if need > self.n_free_pages:
                return None
            reserve = 0
        else:
            total = self.pages_for(min(
                blob["length"] if lifetime_tokens is None
                else lifetime_tokens, self.max_seq))
            reserve = max(0, total - need)
            if need + reserve > self.available_pages:
                return None
        slot = heapq.heappop(self._free_slots)
        self._used_slots.add(slot)
        pages = [self._claim_page() for _ in range(need)]
        self._slot_pages[slot] = pages
        self._reserved[slot] = reserve
        self._min_len[slot] = blob["min_len"]
        self._pending_ready[slot] = []
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        self.lengths[slot] = blob["length"]
        lm.scatter_request_cache(self.cfg, _own_or_given(self.cache, cache,
                                                         shard),
                                 blob["kv"], slot, page_ids=pages)
        return slot if cache is None else (slot, cache)

    def pages_held(self, slot: int) -> int:
        """Victim-policy weight: pages currently backing the slot."""
        return len(self._slot_pages.get(slot, ()))

    # -- length accounting ---------------------------------------------
    def advance(self, slot: int, n: int) -> None:
        """Record n prefill tokens written; full prompt pages the new fill
        level covers become shareable."""
        self.lengths[slot] += n
        filled = int(self.lengths[slot])
        pending = self._pending_ready.get(slot)
        if pending:
            still = []
            for pid, end in pending:
                if end <= filled:
                    self._page_ready.add(pid)
                else:
                    still.append((pid, end))
            self._pending_ready[slot] = still

    def advance_mask(self, mask) -> None:
        """Advance every masked slot by one token (one decode tick)."""
        self.lengths += np.asarray(mask, np.int32)

    def length_of(self, slot: int) -> int:
        return int(self.lengths[slot])

    def rewind(self, slot: int, new_len: int) -> None:
        """Set a slot's length after a multi-token (speculative) write,
        releasing the pages wholly past it.

        A verify writes the current token and every draft token, then the
        engine commits the accepted prefix: ``new_len`` may exceed the
        current length while sitting below the pages
        :meth:`ensure_decode_room` grew for the whole draft.  Pages whose
        first position is at or past ``new_len`` return to the free pool
        and to the slot's reservation, so pages held plus pages reserved
        stay the request's worst case.  Rewinding below the prompt raises:
        prompt pages may be prefix-shared, and rejected drafts only ever
        sit above the prompt."""
        if slot not in self._used_slots:
            raise ValueError(f"rewind of unallocated slot {slot}")
        if not self._min_len.get(slot, 0) <= new_len <= self.max_seq:
            raise ValueError(
                f"rewind of slot {slot} to {new_len} outside "
                f"[prompt={self._min_len.get(slot, 0)}, "
                f"max_seq={self.max_seq}]: prompt pages may be "
                "prefix-shared (releasing them would tear another "
                "request's sharing chain)")
        keep = self.pages_for(new_len)
        pages = self._slot_pages[slot]
        if len(pages) < keep:
            raise RuntimeError(
                f"rewind of slot {slot} to {new_len} beyond its "
                f"{len(pages)} allocated pages")
        while len(pages) > keep:
            pid = pages.pop()
            if self._refcount[pid] != 1:
                raise RuntimeError(
                    f"rewind reached shared page {pid} of slot {slot} "
                    f"(refcount {int(self._refcount[pid])})")
            self._release_page(pid)
            if not self.overcommit:
                # over-commit holds no reservation to credit back
                self._reserved[slot] = self._reserved.get(slot, 0) + 1
            self.block_tables[slot, len(pages)] = 0
        self.lengths[slot] = new_len

    def ensure_decode_room(self, mask, n=1) -> None:
        """Grow block tables so every masked slot can take ``n`` more
        tokens (an int, or one count per slot: a speculative verify
        writes each row's draft length + 1), drawing on its
        admission-time reservation, or under over-commit on the free pool
        (raising :class:`PagePoolExhausted` when it is empty)."""
        ns = np.broadcast_to(np.asarray(n, np.int64), (self.B,))
        for slot, active in enumerate(mask):
            if not active:
                continue
            pages = self._slot_pages[slot]
            need = int(self.lengths[slot]) + int(ns[slot])
            while len(pages) * self.page_size < need:
                if self._reserved.get(slot, 0) > 0:
                    pid = self._claim_page()
                    self._reserved[slot] -= 1
                elif self.overcommit:
                    if self.n_free_pages == 0:
                        raise PagePoolExhausted(
                            f"slot {slot} page growth to {need} tokens "
                            "found the over-committed pool empty",
                            slot=slot)
                    pid = self._claim_page()
                else:
                    raise RuntimeError(
                        f"slot {slot} page growth to {need} tokens exceeds "
                        "its admission-time reservation")
                self.block_tables[slot, len(pages)] = pid
                pages.append(pid)

    # -- introspection --------------------------------------------------
    def has_room(self, slot: int, n: int = 1) -> bool:
        return self.length_of(slot) + n <= self.max_seq

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_used(self) -> int:
        return len(self._used_slots)

    def refcount(self, pid: int) -> int:
        return int(self._refcount[pid])

    def stats(self) -> Dict[str, int]:
        return {
            "pages_allocated_total": self.pages_allocated_total,
            "prefix_hit_pages": self.prefix_hit_pages,
            "pages_in_use": self.pages_in_use,
            "pages_in_use_peak": self.pages_in_use_peak,
            "n_free_pages": self.n_free_pages,
            "cached_free_pages": len(self._free_cached_set),
        }
