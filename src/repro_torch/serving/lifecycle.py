"""Request lifecycle for the serving engine.

The JAX package's state machine (``repro/serving/lifecycle.py``):

  * an explicit state machine with a legality table — ``QUEUED ->
    PREFILL -> DECODE -> DONE`` is the happy path; under pool pressure a
    request detours through ``PREEMPTED_HOST`` (its cache round-trips to
    host memory and is restored verbatim) or ``PREEMPTED_RECOMPUTE``
    (everything is freed and ``prompt + out[:-1]`` is prefilled again),
    and ``cancel`` ends it in ``CANCELLED``.  ``MIGRATING`` (the JAX
    distributed engine's cross-shard move) is kept in the table as data;
    no engine of this package enters it.  Every state change goes through
    :func:`transition`, which raises :class:`IllegalTransition` on
    anything outside :data:`LEGAL_TRANSITIONS`.
  * :class:`LifecycleMixin` — the engine's slot bookkeeping: priority /
    deadline ordered admission (exact FIFO when every request carries the
    defaults), seating, emission (TTFT/TPOT accounting, retirement),
    preemption with a victim policy, host restore, recompute resume and
    ``cancel(rid)``.

Resume is an arithmetic identity: a request that has emitted ``m``
tokens holds ``P + m - 1`` cache positions (``out[-1]`` is the pending
current token, not yet written).  A recompute resume prefills exactly
that context, ``prompt + out[:-1]``, and restarts decode at ``out[-1]``
without emitting from the resume prefill's logits; a host restore
scatters the saved cache back and continues decoding.  Greedy streams
are then the uninterrupted run's token for token.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving import sampler as samplers
from repro_torch.serving.admission import victim_order
from repro_torch.serving.kv_cache import PagePoolExhausted, blob_nbytes
from repro_torch.serving.telemetry import (TID_REQUEST, exponential_edges,
                                           registry_counter)

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
PREEMPTED_HOST = "preempted_host"
PREEMPTED_RECOMPUTE = "preempted_recompute"
MIGRATING = "migrating"
DONE = "done"
CANCELLED = "cancelled"

TERMINAL = frozenset({DONE, CANCELLED})

#: the legality table: ``transition`` refuses anything not listed here
#: (same-state transitions are no-ops except out of a terminal state)
LEGAL_TRANSITIONS: Dict[str, frozenset] = {
    QUEUED: frozenset({PREFILL, CANCELLED}),
    PREFILL: frozenset({DECODE, DONE, CANCELLED, PREEMPTED_RECOMPUTE}),
    DECODE: frozenset({DONE, CANCELLED, PREEMPTED_HOST,
                       PREEMPTED_RECOMPUTE, MIGRATING}),
    # a host-evicted cache restores verbatim: straight back to decode
    PREEMPTED_HOST: frozenset({DECODE, CANCELLED}),
    # a recompute prefills its context again before decoding
    PREEMPTED_RECOMPUTE: frozenset({PREFILL, CANCELLED}),
    MIGRATING: frozenset({PREFILL, DECODE, CANCELLED}),
    DONE: frozenset(),
    CANCELLED: frozenset(),
}


class IllegalTransition(ValueError):
    """A lifecycle transition outside :data:`LEGAL_TRANSITIONS`."""


def transition(req: "Request", new_state: str) -> None:
    """Move ``req`` to ``new_state``, enforcing the legality table."""
    cur = req.state
    if new_state == cur and cur not in TERMINAL:
        return
    if cur not in LEGAL_TRANSITIONS:
        raise IllegalTransition(
            f"request {req.rid}: unknown lifecycle state {cur!r}")
    if new_state not in LEGAL_TRANSITIONS[cur]:
        raise IllegalTransition(
            f"request {req.rid}: illegal lifecycle transition "
            f"{cur!r} -> {new_state!r}")
    req.state = new_state


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    sampling: samplers.SamplingParams = samplers.GREEDY
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    slot: Optional[int] = None
    state: str = QUEUED
    filled: int = 0  # context tokens already written to the slot's cache
    #: the context a recompute resume prefills (``prompt + out[:-1]``)
    ctx: Optional[List[int]] = None
    #: the resume prefill's last logits must not emit: ``out[-1]`` is
    #: already the pending current token
    resume_decode: bool = False
    #: the host snapshot while ``PREEMPTED_HOST``
    host_blob: Optional[dict] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def priority(self) -> int:
        return self.sampling.priority

    @property
    def deadline(self) -> float:
        d = self.sampling.deadline_s
        return float("inf") if d is None else d

    @property
    def context(self) -> List[int]:
        """What prefill writes: the prompt, or the resume context while
        recovering from a recompute preemption."""
        return self.prompt if self.ctx is None else self.ctx

    @property
    def remaining_new(self) -> int:
        """Generation budget left, counting the pending (unwritten)
        ``out[-1]``: ``len(context) + remaining_new`` is the original
        ``len(prompt) + max_new``."""
        if not self.out:
            return self.max_new
        return self.max_new - len(self.out) + 1

    @property
    def resuming(self) -> bool:
        return self.state in (PREEMPTED_HOST, PREEMPTED_RECOMPUTE,
                              MIGRATING)


def admission_key(req: Request):
    """Queue order: priority descending, then resuming before fresh, then
    the earliest deadline, then FIFO by rid.  All-default requests reduce
    to ``(0, 1, inf, rid)``: exact FIFO."""
    return (-req.priority, 0 if req.resuming else 1, req.deadline, req.rid)


def submit_request(engine, prompt, max_new: int, sampling) -> int:
    """Validate and queue one request; returns its rid.  Raises
    ``ValueError`` for an empty prompt, one that leaves no room to
    generate under the engine's ``seq_ceiling``, or ``max_new < 1``."""
    prompt = [int(t) for t in prompt]
    ceiling = engine.seq_ceiling
    if not prompt or (ceiling is not None and len(prompt) >= ceiling):
        raise ValueError(
            f"prompt ({len(prompt)} tokens) must be non-empty and fit the "
            f"cache with room to generate (max_seq={engine.max_seq})")
    if max_new < 1:
        raise ValueError(
            f"max_new={max_new}: a request must generate at least one token")
    rid = engine._next_rid
    engine._next_rid += 1
    engine.queue.append(Request(
        rid=rid, prompt=prompt, max_new=max_new,
        sampling=sampling or samplers.GREEDY, t_submit=time.monotonic()))
    tr = engine.tel.tracer
    if tr.enabled:
        tr.async_begin("request", rid)
        tr.instant("req.queued", "request", TID_REQUEST,
                   {"rid": rid, "prompt_len": len(prompt),
                    "max_new": max_new})
    return rid


def drain_engine(engine, max_ticks: int, on_stall: str) -> List[Request]:
    """Tick until nothing is queued or seated, or ``max_ticks`` loop
    iterations pass.  Leftovers raise (``on_stall="raise"``) or are
    counted in ``stats()["stalled"]`` (``"ignore"``)."""
    if on_stall not in ("raise", "ignore"):
        raise ValueError(f"on_stall={on_stall!r} must be 'raise' or 'ignore'")
    spent = 0
    while (engine.queue or any(s is not None for s in engine.slots)) \
            and spent < max_ticks:
        engine.tick()
        spent += 1
    queued = [r.rid for r in engine.queue]
    in_flight = [r.rid for r in engine.slots if r is not None]
    engine.stalled = len(queued) + len(in_flight)
    engine.stalled_detail = {"queued": queued, "in_flight": in_flight}
    if engine.stalled and on_stall == "raise":
        raise RuntimeError(
            f"engine stalled: max_ticks={max_ticks} exhausted with "
            f"{len(queued)} queued (rids {queued[:8]}) and {len(in_flight)} "
            f"in-flight (rids {in_flight[:8]}) requests")
    return engine.finished


def latency_stats(engine) -> Dict[str, float]:
    """TTFT / TPOT aggregates from the registry's histograms."""
    reg = engine.tel.registry
    th, ph = reg.histogram("ttft_s"), reg.histogram("tpot_s")
    return {
        "requests": th.count,
        "mean_ttft_s": th.mean(),
        "mean_tok_latency_s": ph.mean(),
        "p50_ttft_s": th.quantile(0.5),
        "p99_ttft_s": th.quantile(0.99),
        "p50_tpot_s": ph.quantile(0.5),
        "p99_tpot_s": ph.quantile(0.99),
    }


class LifecycleMixin:
    """The request state machine of the serving engine.  Host
    attributes: ``kv``, ``paged``, ``_share``, ``queue``, ``slots``,
    ``finished``, ``tel``, ``admission``, ``seq_ceiling``, ``eos_id``,
    ``cur_tok``, ``_temp``/``_topk``/``_topp``, ``_h_ttft``/``_h_tpot``,
    ``proposer`` and ``adaptive`` (None without speculation)."""

    preemptions = registry_counter("preemptions")
    preempt_host = registry_counter("preempt_host")
    preempt_recompute = registry_counter("preempt_recompute")
    restores = registry_counter("restores")
    cancelled = registry_counter("cancelled")

    def _init_lifecycle(self) -> None:
        """Call after ``self.tel`` and ``self.admission`` exist."""
        self.preemptions = 0
        self.preempt_host = 0
        self.preempt_recompute = 0
        self.restores = 0
        self.cancelled = 0
        reg = self.tel.registry
        self._c_evicted = reg.counter("evicted_bytes_total")
        self._h_evict = reg.histogram(
            "evicted_bytes", edges=exponential_edges(1.0, 1e12,
                                                     per_decade=2))
        self.cancelled_reqs: List[Request] = []
        self.overcommit = bool(getattr(self.admission, "overcommit", False))

    def lifecycle_stats(self) -> Dict[str, float]:
        return {
            "preemptions": self.preemptions,
            "preempt_host": self.preempt_host,
            "preempt_recompute": self.preempt_recompute,
            "restores": self.restores,
            "cancelled": self.cancelled,
            "evicted_bytes_total": self._c_evicted.value,
            "evicted_bytes_p99": self._h_evict.quantile(0.99),
        }

    # -- admission ---------------------------------------------------------
    def _admit(self) -> None:
        """Seat queued (and preempted) requests while they place.  The
        candidate is the queue's minimum under :func:`admission_key` (the
        FIFO head for all-default requests); one that cannot place blocks
        admission unless it outranks a seated victim, whose preemption
        then makes room."""
        while self.queue:
            req = min(self.queue, key=admission_key)
            placed = self._try_place(req)
            if placed is None:
                placed = self._admit_by_preemption(req)
            if placed is None:
                return
            self.queue.remove(req)
            slot, shared_tokens = placed
            if req.host_blob is not None:
                self._seat_restored(req, slot)
            else:
                self._seat(req, slot, shared_tokens)

    def _try_place(self, req: Request):
        """One placement attempt: None (wait) or ``(slot,
        shared_tokens)``.  Raises ``ValueError`` for a request that can
        never fit."""
        if req.host_blob is not None:
            slot = self.kv.restore(
                req.host_blob, lifetime_tokens=len(req.prompt) + req.max_new)
            return None if slot is None else (slot, 0)
        if not self.paged:
            slot = self.kv.alloc()
            return None if slot is None else (slot, 0)
        ctx = req.context
        # prefix sharing is for fresh prompts: a resume context holds
        # generated tokens, which must not enter the prefix map
        share = self._share and req.ctx is None
        # a live request is prefilling this very prefix: wait one tick
        # and link its pages instead of prefilling them again
        if share and self.kv.probe_pending(ctx):
            return None
        return self.kv.alloc(ctx, req.remaining_new, share=share)

    def _admit_by_preemption(self, req: Request):
        """Make room for a higher-priority arrival by preempting strictly
        lower-priority victims; default-priority traffic never preempts."""
        preempted = False
        for _ in range(len(self.slots)):
            victim = self._pick_victim(max_priority=req.priority)
            if victim is None:
                break
            self._preempt(victim)
            preempted = True
            placed = self._try_place(req)
            if placed is not None:
                return placed
        return self._try_place(req) if preempted else None

    # -- seating -----------------------------------------------------------
    def _seat_common(self, req: Request, slot: int) -> None:
        req.slot = slot
        self.slots[slot] = req
        if self.adaptive is not None:
            self.adaptive.alloc(slot)
        self._temp[slot] = req.sampling.temperature
        self._topk[slot] = req.sampling.top_k
        self._topp[slot] = req.sampling.top_p

    def _seat(self, req: Request, slot: int, shared_tokens: int) -> None:
        transition(req, PREFILL)
        # a prefix-sharing hit starts prefill past the shared pages
        req.filled = shared_tokens
        self._seat_common(req, slot)
        self.cur_tok[slot, 0] = req.context[0]  # replay's first token
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.admitted", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": slot,
                        "shared_tokens": shared_tokens})
        if self.proposer is not None:
            self.proposer.alloc(slot, req.context, shared_tokens)

    def _seat_restored(self, req: Request, slot: int) -> None:
        """Seat a host-restored request: its cache already holds
        ``prompt + out[:-1]``, so it skips prefill and decodes on from
        ``out[-1]``."""
        transition(req, DECODE)
        req.filled = len(req.prompt)
        req.host_blob = None
        self._seat_common(req, slot)
        ctx = req.prompt + req.out
        if self.proposer is not None:
            # bring the proposer back in step: a draft model replays the
            # context through its own cache, the n-gram table rebuilds
            self.proposer.alloc(slot, ctx[:-1], len(ctx) - 1)
        self.cur_tok[slot, 0] = req.out[-1]
        self.restores += 1
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.restored", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": slot, "mode": "host"})

    def _finish_prefill(self, req: Request, sample_tok) -> None:
        """The slot's context is written.  A fresh request emits its first
        token off the prefill logits (``sample_tok()``); a recompute
        resume does not: ``out[-1]`` becomes the current token again."""
        if not req.resume_decode:
            self._emit(req, sample_tok(), time.monotonic())
            return
        req.resume_decode = False
        req.ctx = None
        transition(req, DECODE)
        self.cur_tok[req.slot, 0] = req.out[-1]
        self.restores += 1
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.restored", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": req.slot,
                        "mode": "recompute"})

    # -- emission ----------------------------------------------------------
    def _emit(self, req: Request, tok: int, now: float) -> None:
        """Record one generated token and retire the request if done."""
        tr = self.tel.tracer
        if req.t_first is None:
            req.t_first = now
            self._h_ttft.record(now - req.t_submit)
            if tr.enabled:
                tr.instant("req.first_token", "request", TID_REQUEST,
                           {"rid": req.rid, "ttft_s": now - req.t_submit})
        req.out.append(tok)
        if (tok == self.eos_id or len(req.out) >= req.max_new
                or (self.seq_ceiling is not None
                    and len(req.prompt) + len(req.out) >= self.seq_ceiling)):
            transition(req, DONE)
            req.t_done = now
            if len(req.out) > 1:
                self._h_tpot.record(
                    (req.t_done - req.t_first) / (len(req.out) - 1))
            if tr.enabled:
                tr.instant("req.done", "request", TID_REQUEST,
                           {"rid": req.rid, "tokens": len(req.out)})
                tr.async_end("request", req.rid)
            self.finished.append(req)
            self._free_slot(req)
        else:
            transition(req, DECODE)
            self.cur_tok[req.slot, 0] = tok

    def _free_slot(self, req: Request, *, free_kv: bool = True) -> None:
        """Release what a seated request holds (cache, draft state,
        sampling row); ``req.slot`` stays set for post-mortem accounting."""
        slot = req.slot
        self.slots[slot] = None
        if free_kv:
            self.kv.free(slot)
        if self.proposer is not None:
            self.proposer.free(slot)
        if self.adaptive is not None:
            self.adaptive.free(slot)
        self.cur_tok[slot, 0] = 0

    # -- preemption --------------------------------------------------------
    def _pick_victim(self, *, max_priority: Optional[int] = None
                     ) -> Optional[Request]:
        """The victim policy (:func:`~repro_torch.serving.admission.
        victim_order`) over seated requests, restricted to those of a
        priority below ``max_priority`` when it is given."""
        cands = [r for r in self.slots if r is not None
                 and (max_priority is None or r.priority < max_priority)]
        if not cands:
            return None
        return victim_order(cands, lambda r: self.kv.pages_held(r.slot))[0]

    def _preempt(self, req: Request, mode: str = "auto") -> None:
        """Evict a seated request and queue it for resume.  ``"host"``
        copies its cache to host memory (restored verbatim, no
        recompute); ``"recompute"`` frees everything and prefills
        ``prompt + out[:-1]`` again; ``"auto"`` takes host for a decoding
        request with output and recompute for one still in prefill."""
        if mode not in ("auto", "host", "recompute"):
            raise ValueError(f"preempt mode {mode!r}")
        if mode == "auto":
            mode = ("recompute" if req.state == PREFILL or not req.out
                    else "host")
        slot = req.slot
        if mode == "host":
            transition(req, PREEMPTED_HOST)
            req.host_blob = self.kv.evict_to_host(slot)
            nbytes = blob_nbytes(req.host_blob)
            self._c_evicted.value += nbytes
            self._h_evict.record(nbytes)
            self._free_slot(req, free_kv=False)
            self.preempt_host += 1
        else:
            transition(req, PREEMPTED_RECOMPUTE)
            self._free_slot(req)
            req.filled = 0
            # the resume context is exactly the cache it lost
            req.ctx = list(req.prompt) + req.out[:-1] if req.out else None
            req.resume_decode = bool(req.out)
            self.preempt_recompute += 1
        self.preemptions += 1
        req.slot = None
        self.queue.append(req)
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.preempted", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": slot, "mode": mode})

    def _ensure_room(self, mask, n=1) -> np.ndarray:
        """Grow block tables for the masked rows' next ``n`` tokens (an
        int, or one count per slot).  Under over-commit a dry pool
        preempts a victim (possibly one of the masked rows, whose bit is
        cleared) until the growth fits.  Returns the mask to decode
        with; the stacked layout has nothing to grow."""
        mask = np.asarray(mask, bool).copy()
        if not self.paged:
            return mask
        while True:
            try:
                self.kv.ensure_decode_room(mask, n)
                return mask
            except PagePoolExhausted:
                victim = self._pick_victim()
                if victim is None:
                    raise
                vslot = victim.slot
                self._preempt(victim)
                mask[vslot] = False

    # -- cancel ------------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue, or tear down its slot
        (cache, draft state, sampling row) if seated.  Returns True if the
        rid was live."""
        for r in list(self.queue):
            if r.rid == rid:
                self.queue.remove(r)
                self._finalize_cancel(r)
                return True
        for r in self.slots:
            if r is not None and r.rid == rid:
                self._free_slot(r)
                self._finalize_cancel(r)
                return True
        return False

    def _finalize_cancel(self, req: Request) -> None:
        transition(req, CANCELLED)
        req.host_blob = None
        self.cancelled += 1
        self.cancelled_reqs.append(req)
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.cancelled", "request", TID_REQUEST,
                       {"rid": req.rid, "tokens": len(req.out)})
            tr.async_end("request", req.rid)
