"""Request lifecycle for the serving engine.

The happy path of the JAX package's state machine
(``repro/serving/lifecycle.py``): ``QUEUED -> PREFILL -> DECODE -> DONE``,
enforced by :func:`transition`.  :class:`LifecycleMixin` holds the slot
bookkeeping of paged serving — FIFO admission, seating, emission
(TTFT/TPOT accounting, retirement) and freeing, with the speculative
proposer's and adaptive draft sizer's slot hooks.  The detours
(preemption to host or recompute, cancel, migration) are not ported;
with reservation pricing a decode never runs out of pages, so
:meth:`LifecycleMixin._ensure_room` only grows block tables.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving import sampler as samplers
from repro_torch.serving.telemetry import TID_REQUEST

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"

LEGAL_TRANSITIONS: Dict[str, frozenset] = {
    QUEUED: frozenset({PREFILL}),
    PREFILL: frozenset({DECODE, DONE}),
    DECODE: frozenset({DONE}),
    DONE: frozenset(),
}


class IllegalTransition(ValueError):
    """A lifecycle transition outside :data:`LEGAL_TRANSITIONS`."""


def transition(req: "Request", new_state: str) -> None:
    cur = req.state
    if new_state == cur and cur != DONE:
        return
    if new_state not in LEGAL_TRANSITIONS.get(cur, frozenset()):
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
    filled: int = 0  # prompt tokens already written to the cache

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit


def submit_request(engine, prompt, max_new: int, sampling) -> int:
    """Validate and queue one request; returns its rid.  Raises
    ``ValueError`` for an empty prompt, one that leaves no room to
    generate, or ``max_new < 1``."""
    prompt = [int(t) for t in prompt]
    if not prompt or len(prompt) >= engine.max_seq:
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
    """Slot bookkeeping of paged serving.  Host attributes: ``kv``,
    ``_share``, ``queue``, ``slots``, ``finished``, ``tel``, ``max_seq``,
    ``eos_id``, ``cur_tok``, ``_temp``/``_topk``/``_topp``,
    ``_h_ttft``/``_h_tpot``, ``proposer`` and ``adaptive`` (None without
    speculation)."""

    def _admit(self) -> None:
        """Seat queued requests in FIFO order while they place; the head
        blocks the queue when it cannot (no skipping ahead)."""
        while self.queue:
            req = self.queue[0]
            # a live request is prefilling this very prefix: wait one tick
            # and link its pages instead of re-prefilling them
            if self._share and self.kv.probe_pending(req.prompt):
                return
            placed = self.kv.alloc(req.prompt, req.max_new,
                                   share=self._share)
            if placed is None:
                return
            self.queue.popleft()
            self._seat(req, *placed)

    def _seat(self, req: Request, slot: int, shared_tokens: int) -> None:
        transition(req, PREFILL)
        req.slot = slot
        # a prefix-sharing hit starts prefill past the shared pages
        req.filled = shared_tokens
        self.slots[slot] = req
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.admitted", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": slot,
                        "shared_tokens": shared_tokens})
        if self.proposer is not None:
            self.proposer.alloc(slot, req.prompt, shared_tokens)
        if self.adaptive is not None:
            self.adaptive.alloc(slot)
        self._temp[slot] = req.sampling.temperature
        self._topk[slot] = req.sampling.top_k
        self._topp[slot] = req.sampling.top_p

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
                or len(req.prompt) + len(req.out) >= self.max_seq):
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

    def _free_slot(self, req: Request) -> None:
        """Release a finished request's pages and slot row (``req.slot``
        stays set for post-mortem accounting)."""
        self.slots[req.slot] = None
        self.kv.free(req.slot)
        if self.proposer is not None:
            self.proposer.free(req.slot)
        if self.adaptive is not None:
            self.adaptive.free(req.slot)
        self.cur_tok[req.slot, 0] = 0

    def _ensure_room(self, mask, n=1) -> np.ndarray:
        """Grow block tables for the masked rows' next ``n`` tokens (an
        int, or one count per slot); the admission-time reservation
        guarantees the pages exist."""
        mask = np.asarray(mask, bool).copy()
        self.kv.ensure_decode_room(mask, n)
        return mask
