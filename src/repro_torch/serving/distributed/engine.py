"""Distributed serving engine: the serving tick over the shards of a mesh.

``DistributedServeEngine`` runs the serving core of
:mod:`repro_torch.serving.engine` across the shards of a ``("shard",)``
:class:`~repro_torch.launch.mesh.DeviceMesh`, the paper's multi-FPGA
deployment, driven by one controller:

  * **Sharded KV pools.**  Each shard owns one page pool
    (:class:`~repro_torch.serving.distributed.sharded_kv.
    ShardedPageAllocator`) or slot pool (``kv_layout="stacked"``) on its
    device; a request lives on one shard, chosen by prefix affinity then
    load, and only its block-table row travels with it.  ``self.caches``
    holds one cache per shard.
  * **Per-shard compute.**  One :func:`repro_torch.models.lm.
    sharded_decode_step` call per wave dispatch runs each shard's rows on
    its device and returns the logits through the ring all-gather; one
    :func:`repro_torch.models.lm.sharded_prefill_into_slot` call per round
    prefills up to one chunk per shard.
  * **Dual decode waves.**  The decoding slots split into two
    phase-shifted waves (:class:`~repro_torch.serving.admission.
    DecodeWaveScheduler`).  Each tick consumes and redispatches the waves
    in turn, so one wave's logits fetch and host-side sampling land while
    the other wave's call is in flight, in pure-decode ticks too.
  * **Overlapped transfers.**  The tick is software-pipelined so every
    host <-> device transfer is staged behind in-flight compute
    (:class:`~repro_torch.serving.distributed.transfer.TransferScheduler`
    meters it as ``overlap_ratio``, per phase):

        phase A    dispatch this tick's prefill rounds,
        phase B/C  per wave w: consume wave w's last results (the fetch
                   hides behind wave 1-w's call and phase A's prefills),
                   then redispatch wave w,
        phase D    consume this tick's prompt-completing prefill logits
                   (hidden behind the waves' just-dispatched calls).

    Decode results are emitted one tick after their dispatch, a change of
    schedule only: greedy streams are token for token the single-device
    ``ServeEngine``'s on both layouts.  Sampling runs on the host over the
    fetched logits, from the engine's own generator, so a non-greedy
    stream draws from the same distributions in another order.
  * **Speculation.**  With ``spec=SpecConfig(...)`` every wave dispatch
    is one :func:`repro_torch.models.lm.sharded_verify_chunk` (chain or
    tree) whose width is the wave's largest draft plus one; accept/reject
    rides the same one-tick-delayed consume; rejection rolls each slot
    back on its own shard (``kv.rewind``; rings and states through
    ``StateStore.commit_sharded``).  Rows outside the dispatched wave are
    parked (``lengths >= max_seq``, ``valids == 0``) and write nothing,
    so a wave's verify never touches the other wave's in-flight draft
    positions; for that reason there is no plain-decode fallback in spec
    mode (a plain step's tag-along write would land inside the other
    wave's unconsumed verify).
  * **Migration.**  ``migrate(rid, to_shard, mode)`` moves a decoding
    request to another shard, shipping its cache through the host
    (``"state"``) or re-prefilling ``prompt + out[:-1]`` there
    (``"recompute"``).

Shards without work in a call are skipped (the reference runs them on
parked rows, which write nothing); the device transfers staged are those
the port's calls take (tokens, lengths, actives, block tables; a prefill
chunk's slot, offset and valid count are host integers here).  On one
card named several times the shards share the card: every shard's params
are ``tensor.to(device)``, the same tensors, and nothing writes params in
place.  The rings, states and K/V caches are written in place, so a
verify's rewind snapshot (``StateStore.snapshot``) is taken before the
dispatch and committed at the consume.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.perfmodel import FPGAPerfModel
from repro_torch.launch.mesh import DeviceMesh, make_serving_mesh
from repro_torch.models import blocks, lm
from repro_torch.models.layers import to_device
from repro_torch.serving import sampler as samplers
from repro_torch.serving import speculative
from repro_torch.serving.admission import (DecodeWaveScheduler,
                                           FIFOAdmission, ShardPlacement)
from repro_torch.serving.distributed.sharded_kv import (
    ShardedPageAllocator, ShardedSlotAllocator)
from repro_torch.serving.distributed.transfer import TransferScheduler
from repro_torch.serving.kv_cache import blob_nbytes
from repro_torch.serving.lifecycle import (DECODE, MIGRATING, PREFILL,
                                           LifecycleMixin, Request,
                                           drain_engine, latency_stats,
                                           submit_request, transition)
from repro_torch.serving.quantize import serving_params
from repro_torch.serving.telemetry import (TID_ENGINE, TID_REQUEST,
                                           Telemetry, linear_edges,
                                           registry_counter, set_active)


class DistributedServeEngine(LifecycleMixin):
    ticks = registry_counter("ticks")
    model_calls = registry_counter("model_calls")
    prefill_calls = registry_counter("prefill_calls")
    stalled = registry_counter("stalled")
    spec_ticks = registry_counter("spec_ticks")
    spec_proposed = registry_counter("spec_proposed")
    spec_accepted = registry_counter("spec_accepted")
    spec_emitted = registry_counter("spec_emitted")
    migrations = registry_counter("migrations")

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        mesh: Optional[DeviceMesh] = None,
        n_shards: Optional[int] = None,
        slots_per_shard: int = 2,
        max_seq: int = 256,
        eos_id: int = 0,
        quantized: bool = False,
        calibration_batches=None,
        seed: int = 0,
        chunk_size: int = 32,
        kv_layout: str = "auto",  # auto | paged | stacked
        page_size: int = 16,
        n_pages: Optional[int] = None,  # per shard
        prefix_sharing: bool = True,
        admission: Optional[FIFOAdmission] = None,
        placement: Optional[ShardPlacement] = None,
        act_dtype: Optional[torch.dtype] = None,
        spec: Optional[speculative.SpecConfig] = None,
        decode_waves: int = 2,
        telemetry: Optional[Telemetry] = None,
    ):
        self.tel = telemetry or Telemetry()
        if not blocks.chunk_capable(cfg):
            raise ValueError(
                "the distributed engine drives chunked prefill only; "
                f"{cfg.name} is encoder-decoder (cross-attention has no "
                "chunk path)")
        if kv_layout not in ("auto", "paged", "stacked"):
            raise ValueError(f"kv_layout={kv_layout!r} must be 'auto', "
                             "'paged' or 'stacked'")
        lm.check_supported(cfg)
        if mesh is None:
            mesh = make_serving_mesh(n_shards)
        if "shard" not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no 'shard'")
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.D = mesh.shape["shard"]
        self.Bs = slots_per_shard
        self.B = self.D * self.Bs
        self.cfg = cfg
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.chunk_size = min(chunk_size, max_seq)
        params, self.act_dtype = serving_params(
            params, cfg, self.devices[0], quantized=quantized,
            calibration_batches=calibration_batches, act_dtype=act_dtype)
        self.params = params
        # one tree per shard: ``.to`` of an already-placed tensor is the
        # tensor itself, so shards on one card share every weight
        self.shard_params = [to_device(params, d) for d in self.devices]
        self.admission = admission or FIFOAdmission(
            cfg, chunk_size=self.chunk_size)
        if self.admission.chunk_size > self.chunk_size:
            raise ValueError(
                "admission schedules chunks larger than the engine's "
                f"prefill buffer ({self.admission.chunk_size} > "
                f"{self.chunk_size})")
        self._init_lifecycle()
        # admission stays bounded per shard
        self.seq_ceiling: Optional[int] = max_seq
        if kv_layout == "auto":
            kv_layout = ("paged" if blocks.paged_capable(cfg)
                         and max_seq % page_size == 0 else "stacked")
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        if self.paged:
            if max_seq % page_size:
                raise ValueError(
                    f"page_size={page_size} must divide max_seq={max_seq}")
            self.kv = ShardedPageAllocator(
                cfg, self.D, slots_per_shard, max_seq, page_size=page_size,
                n_pages=n_pages, prefix_sharing=prefix_sharing,
                placement=placement, overcommit=self.overcommit,
                watermark=getattr(self.admission, "watermark", 1.0))
            self.caches = [
                lm.init_cache(cfg, self.kv.n_pages, page_size,
                              layout="paged", device=d,
                              slots=slots_per_shard, slot_seq=max_seq)
                for d in self.devices]
        else:
            self.kv = ShardedSlotAllocator(cfg, self.D, slots_per_shard,
                                           max_seq, placement=placement)
            self.caches = [
                lm.init_cache(cfg, slots_per_shard, max_seq,
                              layout="stacked", device=d)
                for d in self.devices]
        self._share = self.paged and prefix_sharing
        self._state_store = self.kv.state

        self.xfer = TransferScheduler(tracer=self.tel.tracer,
                                      devices=self.devices)
        self.cur_tok = np.zeros((self.D, self.Bs, 1), np.int64)
        self._temp = np.zeros((self.B,), np.float32)
        self._topk = np.zeros((self.B,), np.int64)
        self._topp = np.ones((self.B,), np.float32)
        # host-side sampling over fetched logits
        self.gen = torch.Generator().manual_seed(seed)

        self.spec = spec
        # one proposer over the global slots, on the first shard's device
        # (a draft model keeps its own contiguous cache there)
        self.proposer, self.adaptive = speculative.engine_draft(
            cfg, spec, self.B, max_seq, chunk_size=self.chunk_size,
            dtype=self.act_dtype, device=self.devices[0],
            tracer=self.tel.tracer)

        self.slots: List[Optional[Request]] = [None] * self.B
        self.queue: deque = deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        self.ticks = 0
        self.model_calls = 0
        self.prefill_calls = 0
        self.stalled = 0
        self.spec_ticks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.migrations = 0
        self.n_waves = max(1, int(decode_waves))
        self.waves = DecodeWaveScheduler(self.B, self.n_waves)
        # each wave's last verify width and the run's extremes
        self._wave_vwidth = [0] * self.n_waves
        self._vwidth_min = 0
        self._vwidth_max = 0
        # per-wave in-flight dispatch (dicts from _dispatch_wave) or None
        self._pending_wave: List[Optional[dict]] = [None] * self.n_waves
        self._busy_ticks = np.zeros((self.D,), np.int64)
        self.mdk_stats = sched.mdk_stats(cfg)
        self.stalled_detail: Dict[str, List[int]] = {
            "queued": [], "in_flight": []}

        reg = self.tel.registry
        self._h_ttft = reg.histogram("ttft_s")
        self._h_tpot = reg.histogram("tpot_s")
        self._h_tick = reg.histogram("tick_wall_s")
        self._h_wave_occ = reg.histogram(
            "wave_occupancy", edges=linear_edges(0.0, self.B + 1,
                                                 self.B + 1))
        self._g_wave = [reg.gauge(f"wave{w}_slots")
                        for w in range(self.n_waves)]
        self._h_accept = (
            reg.histogram("spec_accept_len",
                          edges=linear_edges(0.0, spec.k + 2, spec.k + 2))
            if spec is not None else None)
        pm = FPGAPerfModel(cfg, nodes=self.D)
        self._modeled_decode_s = pm.token_latency()["total"]
        self._modeled_prefill_tok_s = pm.prefill_token_latency()
        self._c_pref_mod = reg.counter("prefill_modeled_s")
        self._c_pref_meas = reg.counter("prefill_measured_s")
        self._c_migr_bytes = reg.counter("migrated_bytes_total")
        self._c_dec_mod = reg.counter("decode_modeled_s")
        self._c_dec_meas = reg.counter("decode_measured_s")

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32,
               sampling: Optional[samplers.SamplingParams] = None) -> int:
        return submit_request(self, prompt, max_new, sampling)

    # -- lifecycle hooks -------------------------------------------------
    def _set_cur_tok(self, slot: int, tok: int) -> None:
        s, ls = self.kv.shard_of(slot)
        self.cur_tok[s, ls, 0] = tok

    def _in_flight_slots(self) -> frozenset:
        """Slots with an unconsumed wave dispatch: their eviction,
        cancel and migration wait for the consume."""
        out = set()
        for pend in self._pending_wave:
            if pend is not None:
                out.update(np.flatnonzero(pend["mask"]).tolist())
        return frozenset(out)

    def _slot_shard(self, slot: int) -> int:
        return self.kv.shard_of(slot)[0]

    def _on_decode_start(self, req: Request) -> None:
        # the slot joins the lightest wave the moment it starts decoding
        self.waves.join(req.slot)

    def _release_slot_extra(self, slot: int) -> None:
        self.waves.release(slot)

    def _admit_args(self, req: Request, slot: int,
                    shared_tokens: int) -> dict:
        return {"rid": req.rid, "slot": slot,
                "shard": self._slot_shard(slot),
                "shared_tokens": shared_tokens}

    def _evict_blob(self, req: Request) -> dict:
        return self.kv.evict_to_host(req.slot, cache=self.caches)

    def _restore_blob(self, req: Request) -> Optional[int]:
        res = self.kv.restore(
            req.host_blob, lifetime_tokens=len(req.prompt) + req.max_new,
            cache=self.caches, shard=req.forced_shard)
        if res is None:
            return None
        slot, self.caches = res
        return slot

    # ------------------------------------------------------------------
    def migrate(self, rid: int, to_shard: Optional[int] = None, *,
                mode: str = "auto") -> bool:
        """Move a decoding request to another shard between ticks.

        ``mode="state"`` ships the slot's cache through the host (evict,
        then restore on the target shard), metered as a ``migrate.state``
        transfer; ``"recompute"`` ships nothing and re-prefills ``prompt +
        out[:-1]`` on the target; ``"auto"`` takes state on the stacked
        layout and recompute on the paged one.  Greedy streams are the
        unmigrated run's token for token.  Returns True if the request
        was detached, or will be at the consume of its in-flight dispatch
        (toward ``to_shard``, default the least-loaded other shard); a
        request that finishes off that dispatch drops the migration.
        Requests mid-prefill or being cancelled are left alone."""
        if mode not in ("auto", "state", "recompute"):
            raise ValueError(f"migrate mode {mode!r}")
        req = next((r for r in self.slots
                    if r is not None and r.rid == rid), None)
        if req is None or req.state != DECODE or req.cancel_requested:
            return False
        src = self._slot_shard(req.slot)
        if to_shard is None:
            order = [s for s in self.kv.placement.order(self.kv.shards)
                     if s != src]
            if not order:
                return False
            to_shard = order[0]
        if to_shard == src or not 0 <= to_shard < self.D:
            return False
        if mode == "auto":
            mode = "recompute" if self.paged else "state"
        if req.slot in self._in_flight_slots():
            req.migrate_to = (to_shard, mode)
            return True
        self._do_migrate(req, to_shard, mode)
        return True

    def _do_migrate(self, req: Request, to_shard: int, mode: str) -> None:
        """Detach a decoding request toward ``to_shard`` (no dispatch in
        flight holds its slot)."""
        req.migrate_to = None
        src = self._slot_shard(req.slot)
        slot = req.slot
        transition(req, MIGRATING)
        if mode == "state":
            blob = self._evict_blob(req)
            nbytes = blob_nbytes(blob)
            self.xfer.note("migrate.state", nbytes)
            req.host_blob = blob
            self._free_slot(req, free_kv=False)
        else:
            nbytes = 0
            self._free_slot(req)
            req.filled = 0
            req.ctx = list(req.prompt) + req.out[:-1]
            req.resume_decode = True
        req.slot = None
        req.forced_shard = to_shard
        req.n_migrations += 1
        self.migrations += 1
        self._c_migr_bytes.value += nbytes
        self.queue.append(req)
        tr = self.tel.tracer
        if tr.enabled:
            tr.instant("req.migrated", "request", TID_REQUEST,
                       {"rid": req.rid, "slot": slot, "from": src,
                        "to": to_shard, "mode": mode, "bytes": nbytes})

    # -- host-side sampling ------------------------------------------------
    def _sample_rows(self, logits: torch.Tensor) -> List[int]:
        return samplers.sample_batch(
            logits, self.gen, torch.from_numpy(self._temp),
            torch.from_numpy(self._topk), torch.from_numpy(self._topp)
        ).tolist()

    def _sample_one(self, logits_row: torch.Tensor, req: Request) -> int:
        sp = req.sampling
        return int(samplers.sample_batch(
            logits_row[None], self.gen,
            torch.tensor([sp.temperature], dtype=torch.float32),
            torch.tensor([sp.top_k], dtype=torch.int64),
            torch.tensor([sp.top_p], dtype=torch.float32))[0])

    def _accept_args(self):
        return (self.gen, torch.from_numpy(self._temp),
                torch.from_numpy(self._topk), torch.from_numpy(self._topp))

    def _stage(self, name: str, value):
        """A (D, ...) host array, row s to shard s's device."""
        return self.xfer.stage(name, value, self.devices)

    @staticmethod
    def _live(mask: np.ndarray) -> List[int]:
        """The shards with a row in ``mask`` (D, Bs)."""
        return np.flatnonzero(mask.any(axis=1)).tolist()

    # ------------------------------------------------------------------
    def _plan_prefill(self):
        """Per-shard chunk plans (at most one chunk per request per tick,
        each shard within its own prefill-token budget)."""
        plans = []
        for s in range(self.D):
            prefilling = sorted(
                (r for r in self.slots[s * self.Bs:(s + 1) * self.Bs]
                 if r is not None and r.state == PREFILL),
                key=lambda r: r.rid)
            triples = [(self.kv.shard_of(r.slot)[1], len(r.context),
                        r.filled) for r in prefilling]
            plans.append(deque(self.admission.plan_chunks(triples)))
        return plans

    def _dispatch_prefill_round(self, chunks):
        """One prefill call over the shards: ``chunks[s]`` is shard s's
        ``PrefillChunk`` or None.  Returns (op, logits, completions)."""
        C = self.chunk_size
        toks = np.zeros((self.D, C), np.int64)
        slots = np.zeros((self.D,), np.int64)
        offs = np.zeros((self.D,), np.int64)
        valids = np.zeros((self.D,), np.int64)
        acts = np.zeros((self.D,), bool)
        bts = (np.zeros((self.D, self.kv.pages_per_seq), np.int32)
               if self.paged else None)
        live = []
        for s, ch in enumerate(chunks):
            if ch is None:
                continue
            gslot = s * self.Bs + ch.slot
            req = self.slots[gslot]
            if not self.kv.has_room(gslot, ch.n):
                raise ValueError(
                    f"prefill chunk ({ch.n} tokens at offset {ch.start}) "
                    f"overruns slot {gslot}'s cache "
                    f"(len={self.kv.length_of(gslot)}, "
                    f"max_seq={self.max_seq})")
            toks[s, :ch.n] = req.context[ch.start:ch.start + ch.n]
            slots[s], offs[s], valids[s], acts[s] = ch.slot, ch.start, \
                ch.n, True
            if self.paged:
                bts[s] = self.kv.shards[s].block_tables[ch.slot]
            live.append((s, req, ch))

        tr = self.tel.tracer
        t0 = time.perf_counter()
        with tr.span("prefill.round", "stage", TID_ENGINE,
                     ({"shards": len(live), "tokens": int(valids.sum()),
                       # shards prefill side by side: the round costs the
                       # widest chunk
                       "modeled_s": (int(valids.max())
                                     * self._modeled_prefill_tok_s)}
                      if tr.enabled else None)):
            kw = {}
            if self.paged:
                kw["block_tables"] = self._stage("prefill.block_tables",
                                                 bts)
            logits, self.caches = lm.sharded_prefill_into_slot(
                self.shard_params, self.cfg, self.mesh,
                self._stage("prefill.tokens", toks), self.caches, slots,
                offs, valids, acts, dtype=self.act_dtype, **kw)
            op = self.xfer.dispatch("prefill", logits)
        self._c_pref_mod.value += (int(valids.max(initial=0))
                                   * self._modeled_prefill_tok_s)
        self._c_pref_meas.value += time.perf_counter() - t0

        completions = []
        for s, req, ch in live:
            self.model_calls += 1
            self.prefill_calls += 1
            req.filled += ch.n
            self.kv.advance(req.slot, ch.n)
            if self.proposer is not None:
                self.proposer.prefill_chunk(req.slot, toks[s], ch.start,
                                            ch.n)
            if req.filled == len(req.context):
                completions.append((s, req))
        return op, logits, completions

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> None:
        """One pipelined tick: phases A, B/C per wave, D (module
        docstring).  The engine's tracer is the active one for the tick
        (``telemetry.stage``)."""
        prev = set_active(self.tel.tracer)
        try:
            self._tick()
        finally:
            set_active(prev)

    def _tick(self) -> None:
        t0 = time.perf_counter()
        did = False
        tick_ops = []
        tr = self.tel.tracer
        with tr.span("tick", "engine"):
            # -- phase A: prefill rounds, behind last tick's wave calls
            with tr.span("admit"):
                self._admit()
            plans = self._plan_prefill()
            self.xfer.set_phase("prefill" if any(plans) else "drain")
            pending_first = []  # (op, logits, [(shard, req)])
            busy = np.zeros((self.D,), bool)
            while any(plans):
                chunks = [p.popleft() if p else None for p in plans]
                op, logits, completions = self._dispatch_prefill_round(
                    chunks)
                tick_ops.append(op)
                busy |= np.asarray([c is not None for c in chunks])
                if completions:
                    pending_first.append((op, logits, completions))
                did = True

            # -- phases B/C, per wave: consume, then redispatch
            for w in range(self.n_waves):
                did |= self._consume_wave(w)
                did |= self._dispatch_wave(w, busy)

            # -- phase D: first tokens off completed prefills
            if pending_first:
                with tr.span("first_tokens"):
                    for op, logits, completions in pending_first:
                        logits_h = self.xfer.fetch("prefill.logits", logits,
                                                   of=op)
                        for s, req in completions:
                            self._finish_prefill(
                                req, lambda row=logits_h[s], r=req:
                                self._sample_one(row, r))
            for op in tick_ops:  # prefill ops shadow this tick only
                self.xfer.retire(op)
        if did:
            self._busy_ticks += busy
            self.ticks += 1
            self._h_tick.record(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _consume_wave(self, w: int) -> bool:
        """Phase B: fetch wave w's in-flight logits, sample or accept,
        emit."""
        pend = self._pending_wave[w]
        if pend is None:
            return False
        self._pending_wave[w] = None
        kind = pend["kind"]
        tr = self.tel.tracer
        with tr.span("wave.consume", "wave", TID_ENGINE,
                     ({"wave": w, "kind": kind,
                       "rows": int(pend["mask"].sum())}
                      if tr.enabled else None)):
            logits_h = self.xfer.fetch(f"{kind}.w{w}.logits",
                                       pend["logits"][0], of=pend["op"])
            now = time.monotonic()
            if kind == "decode":
                sampled = self._sample_rows(logits_h)
                for b, req in enumerate(self.slots):
                    if req is None or not pend["mask"][b]:
                        continue
                    if req.cancel_requested:
                        self._free_slot(req)
                        self._finalize_cancel(req)
                        continue
                    if req.state == DECODE:
                        self._emit(req, int(sampled[b]), now)
                        if not req.done and req.migrate_to is not None:
                            self._do_migrate(req, *req.migrate_to)
            elif pend.get("tree"):
                self._consume_tree_verify(pend, logits_h, now)
            else:
                self._consume_verify(pend, logits_h, now)
        return True

    def _dispatch_wave(self, w: int, busy: np.ndarray) -> bool:
        """Phase C: assign free decoding slots to waves and dispatch wave
        w's decode step (or verify)."""
        decoding = np.asarray(
            [r is not None and r.state == DECODE for r in self.slots])
        in_flight = np.zeros((self.B,), bool)
        for pend in self._pending_wave:
            if pend is not None:
                in_flight |= pend["mask"]
        free = decoding & ~in_flight
        self.waves.assign(np.flatnonzero(free))
        mask = free & (self.waves.wave == w)
        if not mask.any():
            return False
        if self.spec is None:
            # over-commit: a dry pool preempts a victim here
            mask = self._ensure_room(mask)
            if not mask.any():
                return False
        rows = int(mask.sum())
        self._h_wave_occ.record(rows)
        self._g_wave[w].set(rows)
        tr = self.tel.tracer
        t0 = time.perf_counter()
        with tr.span("wave.dispatch", "wave", TID_ENGINE,
                     ({"wave": w, "rows": rows,
                       "kind": ("verify" if self.spec is not None
                                else "decode"),
                       "modeled_s": self._modeled_decode_s}
                      if tr.enabled else None)):
            if self.spec is None:
                self._dispatch_plain_wave(w, mask)
            elif self.spec.tree:
                self._dispatch_tree_verify_wave(w, mask)
            else:
                self._dispatch_verify_wave(w, mask)
        self._c_dec_mod.value += self._modeled_decode_s
        self._c_dec_meas.value += time.perf_counter() - t0
        self.model_calls += 1
        busy |= mask.reshape(self.D, self.Bs).any(axis=1)
        return True

    def _dispatch_plain_wave(self, w: int, mask: np.ndarray) -> None:
        """One decode step over wave w's slots.  Other rows of a live shard
        ride along: their global K/V writes stay masked (on the paged
        layout they land on the null page) and their rings and states are
        left alone (``actives``)."""
        m = mask.reshape(self.D, self.Bs)
        kw = {}
        if self.paged:
            kw["block_tables"] = self._stage(f"decode.w{w}.block_tables",
                                             self.kv.block_tables_array())
        logits, self.caches = lm.sharded_decode_step(
            self.shard_params, self.cfg, self.mesh,
            self._stage(f"decode.w{w}.tokens", self.cur_tok), self.caches,
            self._stage(f"decode.w{w}.lengths", self.kv.lengths_array()),
            actives=self._stage(f"decode.w{w}.actives", m),
            shards=self._live(m), dtype=self.act_dtype, **kw)
        self.kv.advance_mask(mask)
        op = self.xfer.dispatch(f"decode.w{w}", logits)
        self._pending_wave[w] = {"kind": "decode", "op": op,
                                 "logits": logits, "mask": mask}

    def _record_verify_width(self, w: int, W: int) -> None:
        self._wave_vwidth[w] = W
        self._vwidth_min = W if self._vwidth_min == 0 else min(
            self._vwidth_min, W)
        self._vwidth_max = max(self._vwidth_max, W)

    def _dispatch_verify_wave(self, w: int, mask: np.ndarray) -> None:
        """One chain verify over wave w's slots, ``W = max(counts) + 1``
        positions wide (a wave that proposed nothing verifies one
        position, a decode step's width).  Rows outside the wave are
        parked and write nothing; host lengths settle at the consume
        (``kv.rewind``)."""
        k = self.spec.k
        lengths_h = self.kv.lengths_array().reshape(self.B).copy()
        caps = speculative.draft_caps(self.slots, lengths_h, mask, k,
                                      self.seq_ceiling,
                                      adaptive=self.adaptive)
        draft, counts = self.proposer.propose(
            self.slots, self.cur_tok.reshape(self.B, 1), lengths_h, mask,
            caps)
        # over-commit may narrow the wave; cleared rows park
        mask = self._ensure_room(mask, counts + 1)
        W = int(counts[mask].max(initial=0)) + 1
        self._record_verify_width(w, W)
        counts = np.minimum(counts, W - 1)
        toks = np.zeros((self.B, W), np.int64)
        toks[:, 0] = self.cur_tok.reshape(self.B)
        toks[:, 1:] = draft[:, :W - 1]
        vlen = np.where(mask, lengths_h, self.max_seq).astype(np.int32)
        valids = np.where(mask, counts + 1, 0).astype(np.int32)
        m = mask.reshape(self.D, self.Bs)
        live = self._live(m)
        store = self._state_store
        kw = {}
        if self.paged:
            kw["block_tables"] = self._stage(f"verify.w{w}.block_tables",
                                             self.kv.block_tables_array())
        toks_d = self._stage(f"verify.w{w}.tokens",
                             toks.reshape(self.D, self.Bs, W))
        lens_d = self._stage(f"verify.w{w}.lengths",
                             vlen.reshape(self.D, self.Bs))
        snaps, trajs = None, None
        if store is None:
            logits, self.caches = lm.sharded_verify_chunk(
                self.shard_params, self.cfg, self.mesh, toks_d, self.caches,
                lens_d, shards=live, dtype=self.act_dtype, **kw)
        else:
            # the ring slots this verify overwrites, copied first; the
            # commit one tick later restores the rejected ones
            snaps = [None] * self.D
            for s in live:
                snaps[s] = store.snapshot(self.caches[s], lens_d[s],
                                          chunk=W)
            logits, self.caches, trajs = lm.sharded_verify_chunk(
                self.shard_params, self.cfg, self.mesh, toks_d, self.caches,
                lens_d, valids=self._stage(f"verify.w{w}.valids",
                                           valids.reshape(self.D, self.Bs)),
                with_traj=True, shards=live, dtype=self.act_dtype, **kw)
        self.spec_ticks += 1
        op = self.xfer.dispatch(f"verify.w{w}", logits)
        self._pending_wave[w] = {
            "kind": "verify", "op": op, "logits": logits, "mask": mask,
            "draft": draft, "counts": counts, "lengths": lengths_h,
            "valids": valids, "width": W, "snaps": snaps, "traj": trajs}

    def _dispatch_tree_verify_wave(self, w: int, mask: np.ndarray) -> None:
        """One tree verify over wave w's slots: every node of each slot's
        token tree in one chunk under its ancestor mask, K/V at flat
        offsets, positions at root-path depths; accept and path
        compaction at the consume."""
        k = self.spec.k
        lengths_h = self.kv.lengths_array().reshape(self.B).copy()
        caps = speculative.draft_caps(self.slots, lengths_h, mask, k,
                                      self.seq_ceiling,
                                      adaptive=self.adaptive)
        trees = self.proposer.propose_tree(
            self.slots, self.cur_tok.reshape(self.B, 1), lengths_h, mask,
            caps, branch=self.spec.branch)
        tokens_a, parents, n_nodes, anc, depths = speculative.tree_arrays(
            trees, k, k + 1)
        mask = self._ensure_room(mask, n_nodes + 1)
        W = int(n_nodes[mask].max(initial=0)) + 1
        self._record_verify_width(w, W)
        toks = np.zeros((self.B, W), np.int64)
        toks[:, 0] = self.cur_tok.reshape(self.B)
        toks[:, 1:] = tokens_a[:, :W - 1]
        vlen = np.where(mask, lengths_h, self.max_seq).astype(np.int32)
        # (k+1)-wide masks cut to the wave's width: every wave row fits
        # (its n_nodes bound W) and parked rows stay causal
        anc_w = np.ascontiguousarray(anc[:, :W, :W]).astype(np.int32)
        dep_w = np.ascontiguousarray(depths[:, :W])
        m = mask.reshape(self.D, self.Bs)
        kw = {}
        if self.paged:
            kw["block_tables"] = self._stage(f"verify.w{w}.block_tables",
                                             self.kv.block_tables_array())
        logits, self.caches = lm.sharded_verify_chunk(
            self.shard_params, self.cfg, self.mesh,
            self._stage(f"verify.w{w}.tokens",
                        toks.reshape(self.D, self.Bs, W)),
            self.caches,
            self._stage(f"verify.w{w}.lengths",
                        vlen.reshape(self.D, self.Bs)),
            anc=self._stage(f"verify.w{w}.anc",
                            anc_w.reshape(self.D, self.Bs, W, W)),
            depths=self._stage(f"verify.w{w}.depths",
                               dep_w.reshape(self.D, self.Bs, W)),
            shards=self._live(m), dtype=self.act_dtype, **kw)
        self.spec_ticks += 1
        op = self.xfer.dispatch(f"verify.w{w}", logits)
        self._pending_wave[w] = {
            "kind": "verify", "tree": True, "op": op, "logits": logits,
            "mask": mask, "tokens": tokens_a, "parents": parents,
            "n_nodes": n_nodes, "lengths": lengths_h, "width": W}

    def _settle(self, b: int, req: Request, tokens: List[int], new_len: int,
                now: float) -> None:
        """Emit one verify's tokens for the request in global slot ``b``;
        if it lives on, commit ``new_len`` positions on its shard."""
        for tok in tokens:
            self._emit(req, int(tok), now)
            self.spec_emitted += 1
            if req.done:
                return
        self.kv.rewind(b, new_len)
        self.proposer.commit(b, req.prompt + req.out, new_len)
        if req.migrate_to is not None:
            self._do_migrate(req, *req.migrate_to)

    def _consume_verify(self, pend: dict, logits_h: torch.Tensor,
                        now: float) -> None:
        """Accept/reject a wave's chain verify one tick after its
        dispatch, rewind each slot on its own shard and, for rings and
        states, commit through ``StateStore.commit_sharded``."""
        mask, draft = pend["mask"], pend["draft"]
        counts, base, W = pend["counts"], pend["lengths"], pend["width"]
        if W == 1:
            # a zero-proposal wave: spec_accept_batch needs a draft
            # position, so pad one; with counts == 0 it is never read
            logits_h = torch.cat([logits_h, logits_h], dim=1)
            draft_s = np.zeros((self.B, 1), np.int32)
        else:
            draft_s = draft[:, :W - 1]
        n_acc, next_tok = samplers.spec_accept_batch(
            logits_h, torch.from_numpy(np.ascontiguousarray(draft_s)),
            torch.from_numpy(counts), *self._accept_args())
        n_acc, next_tok = n_acc.tolist(), next_tok.tolist()
        if self._state_store is not None:
            commit = np.where(mask, np.asarray(n_acc) + 1, 0)
            shape = (self.D, self.Bs)
            self.caches = self._state_store.commit_sharded(
                self.mesh, pend["snaps"], self.caches, pend["traj"],
                base.reshape(shape), commit.reshape(shape),
                pend["valids"].reshape(shape), chunk=W)
        for b in range(self.B):
            req = self.slots[b]
            if not mask[b] or req is None:
                continue
            if req.cancel_requested:
                self._free_slot(req)
                self._finalize_cancel(req)
                continue
            m = int(n_acc[b])
            self._h_accept.record(m)
            self.spec_proposed += int(counts[b])
            self.spec_accepted += m
            if self.adaptive is not None:
                self.adaptive.observe(b, int(counts[b]), m)
            L = int(base[b])
            self._settle(b, req, [int(t) for t in draft[b, :m]]
                         + [int(next_tok[b])], L + m + 1, now)

    def _consume_tree_verify(self, pend: dict, logits_h: torch.Tensor,
                             now: float) -> None:
        """Tree settle one tick after the dispatch: the longest accepted
        root-to-leaf path per row, its K/V compacted to ``L+1..L+m`` on
        each shard before any rewind releases pages, then emit."""
        mask, base = pend["mask"], pend["lengths"]
        tokens_a, parents = pend["tokens"], pend["parents"]
        n_nodes, W = pend["n_nodes"], pend["width"]
        k = self.spec.k
        _, acc, next_tok = samplers.spec_accept_tree(
            logits_h, torch.from_numpy(
                np.ascontiguousarray(tokens_a[:, :W - 1])),
            torch.from_numpy(np.ascontiguousarray(parents[:, :W - 1])),
            torch.from_numpy(n_nodes), *self._accept_args())
        acc, next_tok = acc.numpy().astype(bool), next_tok.tolist()
        paths = [np.flatnonzero(acc[b, 1:]) + 1 if mask[b]
                 else np.zeros(0, np.int64) for b in range(self.B)]
        src = np.full((self.B, k), self.max_seq, np.int64)
        dst = np.full((self.B, k), self.max_seq, np.int64)
        for b in range(self.B):
            m = len(paths[b])
            src[b, :m] = base[b] + paths[b]
            dst[b, :m] = base[b] + 1 + np.arange(m)
        if (src != dst).any():
            # other-wave and parked rows carry src == dst == max_seq and
            # move nothing
            shape = (self.D, self.Bs, k)
            self.caches = lm.sharded_compact_accepted_path(
                self.cfg, self.mesh, self.caches, src.reshape(shape),
                dst.reshape(shape),
                block_tables=(self.kv.block_tables_array() if self.paged
                              else None))
        for b in range(self.B):
            req = self.slots[b]
            if not mask[b] or req is None:
                continue
            if req.cancel_requested:
                self._free_slot(req)
                self._finalize_cancel(req)
                continue
            m = len(paths[b])
            self._h_accept.record(m)
            self.spec_proposed += int(n_nodes[b])
            self.spec_accepted += m
            if self.adaptive is not None:
                self.adaptive.observe_tree(b, int(n_nodes[b]), m)
            L = int(base[b])
            self._settle(b, req, [int(tokens_a[b, j - 1]) for j in paths[b]]
                         + [int(next_tok[b])], L + m + 1, now)

    # ------------------------------------------------------------------
    def run(self, max_ticks: int = 10_000, *,
            on_stall: str = "raise") -> List[Request]:
        """Tick until drained (nothing queued, seated or in flight); see
        :func:`~repro_torch.serving.lifecycle.drain_engine` for stalls.
        The shards' devices are synchronized either way."""
        try:
            return drain_engine(
                self, max_ticks, on_stall,
                pending=lambda: (
                    self.queue or any(s is not None for s in self.slots)
                    or any(p is not None for p in self._pending_wave)))
        finally:
            self.xfer.sync()

    def utilization(self) -> np.ndarray:
        """Per-shard busy-tick fraction (busy: prefilled a chunk or
        decoded a slot in the tick)."""
        return self._busy_ticks / max(self.ticks, 1)

    def reset_counters(self) -> None:
        """Zero the counters, histograms, trace events and transfer log
        (between a warm-up and the measured run); only while drained."""
        if any(p is not None for p in self._pending_wave):
            raise RuntimeError("reset_counters with a wave in flight")
        self.tel.reset()
        self._busy_ticks[:] = 0
        self.xfer.reset()

    def dump_trace(self, path: str) -> str:
        return self.tel.dump_trace(path)

    def stats(self) -> Dict[str, float]:
        """The keys of ``telemetry.STATS_KEYS_DISTRIBUTED`` (with
        speculation, the spec keys beside them; a stacked engine reports
        the slot pool's keys in place of the page pool's)."""
        out = latency_stats(self)
        out.update({
            "ticks": self.ticks,
            "model_calls": self.model_calls,
            "prefill_calls": self.prefill_calls,
            "stalled": self.stalled,
            "stalled_queued": len(self.stalled_detail["queued"]),
            "stalled_in_flight": len(self.stalled_detail["in_flight"]),
            "mdk_mp_reuse": self.mdk_stats.reuse_factor().get("mp", 0),
            "n_shards": self.D,
            "decode_waves": self.n_waves,
            "mean_device_utilization": float(np.mean(self.utilization())),
            "tick_p50_ms": self._h_tick.quantile(0.5) * 1e3,
            "tick_p99_ms": self._h_tick.quantile(0.99) * 1e3,
            "wave_occupancy_mean": self._h_wave_occ.mean(),
            "wave_occupancy_p50": self._h_wave_occ.quantile(0.5),
            "wave_imbalance": self.waves.imbalance(),
            "decode_modeled_s": self._c_dec_mod.value,
            "decode_measured_s": self._c_dec_meas.value,
            "prefill_modeled_s": self._c_pref_mod.value,
            "prefill_measured_s": self._c_pref_meas.value,
            "migrations": self.migrations,
            "migrated_bytes_total": self._c_migr_bytes.value,
        })
        out.update(self.lifecycle_stats())
        if self.spec is not None:
            out.update({
                "spec_ticks": self.spec_ticks,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_emitted": self.spec_emitted,
                "acceptance_rate": (
                    self.spec_accepted / max(self.spec_proposed, 1)),
                "tokens_per_verify_call": (
                    self.spec_emitted / max(self.spec_ticks, 1)),
                "draft_calls": getattr(self.proposer, "draft_calls", 0),
                "spec_accept_len_p50": self._h_accept.quantile(0.5),
                "spec_accept_len_p99": self._h_accept.quantile(0.99),
                "verify_width_min": self._vwidth_min,
                "verify_width_max": self._vwidth_max,
            })
            out.update({f"wave{w}_verify_width": self._wave_vwidth[w]
                        for w in range(self.n_waves)})
            if self.adaptive is not None:
                out.update(self.adaptive.stats())
        out.update(self.xfer.stats())
        out.update(self.kv.stats())
        return out
