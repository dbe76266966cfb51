"""Continuous-batching serving engine.

The paper's schedule: a fixed set of cache slots runs one batched decode
step every tick, and prompt work rides along in chunks without stalling
it.

  * **Chunked prefill** — an admitted prompt is written ``chunk_size``
    tokens at a time through :func:`repro_torch.models.lm.prefill_into_slot`
    (one forward call per chunk; ``ceil(P / chunk_size)`` calls per
    prompt), within a per-tick token budget from
    :mod:`repro_torch.serving.admission`.
  * **KV layouts** — ``kv_layout="paged"``:
    :class:`~repro_torch.serving.kv_cache.PagedCacheManager` allocates
    pages through per-request block tables, prices admission in pages,
    and shares full prompt pages copy-free between requests with a
    common prefix; the layout is per kind, so a mixed stack's rings and
    recurrent states stay slot-resident beside the pages (prefix sharing
    then saves pages, and the prompt is prefilled whole).  ``"stacked"``:
    :class:`~repro_torch.serving.kv_cache.SlotCacheManager` gives each
    request one row: a contiguous ``max_seq`` region per global-attention
    layer, a ring per sliding-window layer, a state per recurrent layer.
    ``"auto"`` pages a stack with a global-attention layer when
    ``page_size`` divides ``max_seq`` and serves an attention-free one
    stacked.  Both give the same greedy tokens.  A window-capped stack
    (no global ``attn`` layer: ``recurrentgemma-9b``, ``xlstm-350m``) has
    no request ceiling: its rings wrap and its states are O(1), so
    requests run past ``max_seq``.
  * **Quantized serving** — ``quantized=True`` calibrates SmoothQuant on
    ``calibration_batches`` and runs every linear through the Fused MP
    kernel; the activation stream between kernels stays float32.
  * **Per-request sampling** — one :func:`~repro_torch.serving.sampler.sample_batch`
    call per tick over per-slot parameters, drawn from the engine's
    ``torch.Generator``.
  * **Speculative decoding** — with ``spec=SpecConfig(...)`` each decode
    tick proposes up to k draft tokens per slot (n-gram lookup or a
    draft model, :mod:`repro_torch.serving.speculative`), as a chain or
    as a token tree, verifies every slot's draft in ONE chunked forward
    call (:func:`repro_torch.models.lm.verify_chunk`), and emits 1..k+1
    tokens through the distribution-preserving accept rules of
    :mod:`repro_torch.serving.sampler`.  Greedy streams are token for
    token those of plain decode; rejected K/V are dropped by
    ``kv.rewind``, and an accepted tree path is first compacted to
    contiguous positions (:func:`repro_torch.models.lm.
    compact_accepted_path`).  A tick on which no slot proposes anything
    falls back to the plain decode step.
  * **Request lifecycle** — :mod:`repro_torch.serving.lifecycle`:
    priority / deadline ordered admission, over-commit admission
    (``admission=OvercommitAdmission(...)``, paged) with preemption to
    host memory or by recompute when the pool runs dry, and
    ``cancel(rid)``.
  * **Hybrid stacks** — rings and recurrent states have no length mask:
    the decode step writes them for decoding rows only, and a chain
    verify snapshots the ring slots it will overwrite and commits
    through the ``StateStore`` seam (rejected ring writes restored,
    each recurrent state taken off the verify's trajectory at the
    accepted length), all on the device, on either layout (on the paged
    one ``kv.rewind`` then releases the ``attn`` layers' rejected
    pages).  Tree speculation and a draft
    model need a global-attention stack and refuse others with
    ``ValueError``, as in the reference.

Every tick on the card goes through the CUDA kernels: the MP kernel for
each quantized linear; on the paged layout the paged decode kernel for
the decode step, the paged verify kernel for each prefill chunk and chain
verify, and its tree body for a tree verify; on the stacked layout the
contiguous decode kernel for the decode step (a chunk attends in plain
PyTorch there, as in the reference); on either layout the contiguous
decode kernel for a sliding-window layer's decode over its ring and for
each step of a draft model.  The recurrences run in plain PyTorch, as in
the reference.  The engine runs on ``device`` (default
``"cuda"``) and raises if that device is missing; the CPU tests pass
``device="cpu"``, which takes the plain versions.

The stacks served are decoders of every block kind of the reference
with a dense or a MoE FFN (``models/moe.py``: the router and the expert
banks stay in floating point under W8A8, as in the reference, and run as
batched products in the activation stream's dtype).  Not ported (it
raises ``NotImplementedError``): ring tensor parallelism (``mesh=``).
``prefill_mode="replay"``
(the reference's A/B debug mode and its serving bench's baseline)
replays each prompt one token a tick through the decode step, on either
layout.  An encoder-decoder (whisper) is refused with ``ValueError``:
the reference's engine cannot serve it either (its replay step passes
no encoder lengths), and it runs at model level
(``lm.prefill``/``lm.batch_prefill``, ``lm.decode_step(enc_lengths=)``).
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
from repro_torch.models import blocks, lm
from repro_torch.models.layers import to_device
from repro_torch.serving import sampler as samplers
from repro_torch.serving import speculative
from repro_torch.serving.admission import FIFOAdmission
from repro_torch.serving.kv_cache import PagedCacheManager, SlotCacheManager
from repro_torch.serving.lifecycle import (DECODE, PREFILL, LifecycleMixin,
                                           Request, drain_engine,
                                           latency_stats, submit_request)
from repro_torch.serving.quantize import calibrate, quantize_model_params
from repro_torch.serving.telemetry import (TID_ENGINE, Telemetry,
                                           linear_edges, registry_counter)


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


class ServeEngine(LifecycleMixin):
    ticks = registry_counter("ticks")
    model_calls = registry_counter("model_calls")
    prefill_calls = registry_counter("prefill_calls")
    stalled = registry_counter("stalled")
    spec_ticks = registry_counter("spec_ticks")
    spec_proposed = registry_counter("spec_proposed")
    spec_accepted = registry_counter("spec_accepted")
    spec_emitted = registry_counter("spec_emitted")
    verify_touched_positions = registry_counter("verify_touched_positions")
    verify_dense_positions = registry_counter("verify_dense_positions")

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_slots: int = 4,
        max_seq: int = 256,
        eos_id: int = 0,
        quantized: bool = False,
        calibration_batches=None,
        seed: int = 0,
        chunk_size: int = 32,
        prefill_mode: str = "auto",  # auto | chunked | replay
        kv_layout: str = "auto",  # auto | paged | stacked
        page_size: int = 16,
        n_pages: Optional[int] = None,
        prefix_sharing: bool = True,
        admission: Optional[FIFOAdmission] = None,
        mesh=None,
        act_dtype: Optional[torch.dtype] = None,
        spec: Optional[speculative.SpecConfig] = None,
        telemetry: Optional[Telemetry] = None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=) is not ported: this engine serves on "
                "one device")
        if prefill_mode not in ("auto", "chunked", "replay"):
            raise ValueError(f"prefill_mode={prefill_mode!r} must be "
                             "'auto', 'chunked' or 'replay'")
        if kv_layout not in ("auto", "paged", "stacked"):
            raise ValueError(f"kv_layout={kv_layout!r} must be 'auto', "
                             "'paged' or 'stacked'")
        if cfg.is_encoder_decoder:
            # the reference refuses chunked with this ValueError and, in
            # auto or replay, fails at the first tick (its replay step
            # passes no encoder lengths); whisper serves at model level
            raise ValueError(
                f"{cfg.name} is encoder-decoder: the engine serves decoder "
                "stacks; run it through lm.prefill / lm.batch_prefill and "
                "lm.decode_step(enc_lengths=)")
        if prefill_mode == "replay" and spec is not None:
            raise ValueError("speculative decoding needs chunked prefill "
                             "(prefill_mode='replay' replays the prompt "
                             "through plain decode steps)")
        lm.check_supported(cfg)
        self.tel = telemetry or Telemetry()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.B = batch_slots
        self.chunk_size = min(chunk_size, max_seq)
        params = to_device(params, self.device)
        if quantized:
            stats = None
            if calibration_batches is not None:
                stats = calibrate(params, cfg, calibration_batches)
            params = quantize_model_params(params, cfg, stats)
        # the W8A8 path re-quantizes activations at every MP kernel input,
        # so the stream between kernels stays float32
        self.act_dtype = act_dtype or (torch.float32 if quantized
                                       else torch.bfloat16)
        self.params = params
        # every decoder stack chunks; replay is the A/B debug mode
        self.prefill_mode = "replay" if prefill_mode == "replay" \
            else "chunked"
        self.admission = admission or FIFOAdmission(
            cfg, chunk_size=self.chunk_size)
        if self.admission.chunk_size > self.chunk_size:
            raise ValueError(
                "admission schedules chunks larger than the engine's "
                f"prefill buffer ({self.admission.chunk_size} > "
                f"{self.chunk_size})")
        # preemption / restore / cancel counters, and the over-commit flag
        # taken from the admission policy
        self._init_lifecycle()
        # a probe one position past the cache: a stack whose slot
        # footprint saturates below max_seq would lift the request
        # ceiling; every global-attention stack keeps it
        probe = self.admission.slot_price(cfg, max_seq + 1, 0,
                                          max_seq=max_seq + 1)
        self.seq_ceiling: Optional[int] = (
            None if probe <= max_seq and cfg.pos != "learned" else max_seq)
        if kv_layout == "auto":
            # page any stack with a global-attention layer (a mixed one
            # keeps its rings and states slot-resident), with a page size
            # that divides max_seq; an attention-free stack serves stacked
            kv_layout = ("paged" if blocks.paged_capable(cfg)
                         and max_seq % page_size == 0 else "stacked")
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        if self.paged:
            if max_seq % page_size:
                raise ValueError(
                    f"page_size={page_size} must divide max_seq={max_seq} "
                    "(pass page_size explicitly or pick a page-multiple "
                    "max_seq)")
            self.kv = PagedCacheManager(
                cfg, batch_slots, max_seq, page_size=page_size,
                n_pages=n_pages, prefix_sharing=prefix_sharing,
                device=self.device, overcommit=self.overcommit,
                watermark=getattr(self.admission, "watermark", 1.0))
        else:
            # a slot holds a request's whole lifetime: nothing to
            # over-commit, so an over-commit policy only orders the queue
            self.kv = SlotCacheManager(cfg, batch_slots, max_seq,
                                       device=self.device,
                                       bounded=self.seq_ceiling is not None)
        # rings and recurrent states: the verify's rewind seam
        self._state_store = getattr(self.kv, "state", None)
        # prefix sharing links pages: the paged layout with chunked
        # prefill only (replay teacher-forces every prompt token)
        self._share = (self.paged and prefix_sharing
                       and self.prefill_mode == "chunked")
        self.cur_tok = np.zeros((batch_slots, 1), np.int64)
        self._temp = np.zeros((batch_slots,), np.float32)
        self._topk = np.zeros((batch_slots,), np.int64)
        self._topp = np.ones((batch_slots,), np.float32)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        self.spec = spec
        self.proposer: Optional[speculative.DraftProposer] = None
        self.adaptive: Optional[speculative.AdaptiveDraft] = None
        if spec is not None:
            if spec.k < 1:
                raise ValueError(f"SpecConfig.k={spec.k} must be >= 1")
            if spec.tree and spec.branch < 1:
                raise ValueError(
                    f"SpecConfig.branch={spec.branch} must be >= 1")
            if "local_attn" in cfg.block_pattern:
                W = min(cfg.window, max_seq)
                if spec.k + 1 > W:
                    raise ValueError(
                        f"SpecConfig.k={spec.k}: a verify writes k+1 ring "
                        f"positions but the rotating window holds {W} — "
                        "state rewind needs k+1 <= W so an accepted write "
                        "can never share a ring slot with a rejected one")
            if spec.tree and not blocks.page_addressable(cfg):
                raise ValueError(
                    "tree speculation forks K/V across sibling branches, "
                    "which only absolute-position attn caches support — "
                    "rings rotate and recurrent states carry, neither can "
                    "hold two candidate futures at once.  This stack has "
                    f"kinds {sorted(set(cfg.block_pattern))}; use linear "
                    "speculation (tree=False) for hybrid stacks")
            self.proposer = speculative.make_proposer(
                spec, batch_slots, max_seq, chunk_size=self.chunk_size,
                dtype=self.act_dtype, device=self.device)
            self.proposer.tracer = self.tel.tracer
            self.adaptive = speculative.AdaptiveDraft.from_spec(spec)

        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: deque = deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        self.ticks = 0
        self.model_calls = 0  # decode steps + prefill chunks
        self.prefill_calls = 0
        self.stalled = 0
        self.spec_ticks = 0  # verify calls issued
        self.spec_proposed = 0  # draft tokens submitted for verification
        self.spec_accepted = 0  # draft tokens accepted
        self.spec_emitted = 0  # tokens emitted off verify calls
        # verify traffic in K/V positions per layer: the in-place paged
        # verify touches each row's live pages; "dense" is what a gathered
        # max_seq view per active row would move, there and back
        self.verify_touched_positions = 0
        self.verify_dense_positions = 0
        self.stalled_detail: Dict[str, List[int]] = {
            "queued": [], "in_flight": []}
        self.mdk_stats = sched.mdk_stats(cfg)

        reg = self.tel.registry
        self._h_ttft = reg.histogram("ttft_s")
        self._h_tpot = reg.histogram("tpot_s")
        self._h_tick = reg.histogram("tick_wall_s")
        self._h_accept = (
            reg.histogram("spec_accept_len",
                          edges=linear_edges(0.0, spec.k + 2, spec.k + 2))
            if spec is not None else None)
        # the paper's FPGA model's predicted cost per call, kept beside
        # the measured host time of the same call
        pm = FPGAPerfModel(cfg)
        self._modeled_decode_s = pm.token_latency()["total"]
        self._modeled_prefill_tok_s = pm.prefill_token_latency()
        self._c_pref_mod = reg.counter("prefill_modeled_s")
        self._c_pref_meas = reg.counter("prefill_measured_s")
        self._c_dec_mod = reg.counter("decode_modeled_s")
        self._c_dec_meas = reg.counter("decode_measured_s")

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32,
               sampling: Optional[samplers.SamplingParams] = None) -> int:
        return submit_request(self, prompt, max_new, sampling)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits: torch.Tensor, rows) -> List[int]:
        return samplers.sample_batch(
            logits, self.gen, self._dev(self._temp[rows]),
            self._dev(self._topk[rows]), self._dev(self._topp[rows])).tolist()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> None:
        """One engine tick: prefill chunks within the budget, then one
        batched decode step over every decoding slot (with
        ``prefill_mode="replay"``: :meth:`_tick_replay`)."""
        if self.prefill_mode == "replay":
            return self._tick_replay()
        t_tick = time.perf_counter()
        tr = self.tel.tracer
        with tr.span("tick", "engine"):
            with tr.span("admit"):
                self._admit()
            did = False
            # a recompute resume prefills its context, prompt + out[:-1]
            prefilling = sorted(
                (r for r in self.slots
                 if r is not None and r.state == PREFILL),
                key=lambda r: r.rid)
            plan = self.admission.plan_chunks(
                [(r.slot, len(r.context), r.filled) for r in prefilling])
            for ch in plan:
                req = self.slots[ch.slot]
                if not self.kv.has_room(ch.slot, ch.n):
                    raise ValueError(
                        f"prefill chunk ({ch.n} tokens at offset {ch.start}) "
                        f"overruns slot {ch.slot}'s cache (len="
                        f"{self.kv.length_of(ch.slot)}, max_seq="
                        f"{self.max_seq})")
                chunk = np.zeros((self.chunk_size,), np.int64)
                chunk[:ch.n] = req.context[ch.start:ch.start + ch.n]
                t0 = time.perf_counter()
                with tr.span("prefill.chunk", "stage", TID_ENGINE,
                             ({"rid": req.rid, "slot": ch.slot,
                               "start": ch.start, "n": ch.n,
                               "modeled_s":
                               ch.n * self._modeled_prefill_tok_s}
                              if tr.enabled else None)):
                    # the table row routes the paged attn writes, the
                    # slot a mixed stack's rings and states
                    bt = ({"block_table": self._dev(
                        self.kv.block_tables[ch.slot])} if self.paged
                        else {})
                    logits, self.kv.cache = lm.prefill_into_slot(
                        self.params, self.cfg, self._dev(chunk),
                        self.kv.cache, ch.start, slot=ch.slot, valid=ch.n,
                        dtype=self.act_dtype, **bt)
                self._c_pref_mod.value += ch.n * self._modeled_prefill_tok_s
                self._c_pref_meas.value += time.perf_counter() - t0
                self.model_calls += 1
                self.prefill_calls += 1
                req.filled += ch.n
                self.kv.advance(ch.slot, ch.n)
                if self.proposer is not None:
                    self.proposer.prefill_chunk(ch.slot, chunk, ch.start,
                                                ch.n)
                if req.filled == len(req.context):
                    # a fresh request's first token comes straight off the
                    # prefill logits; a recompute resume emits nothing
                    self._finish_prefill(req, lambda: self._sample(
                        logits[None], [req.slot])[0])
                did = True

            decoding = [r is not None and r.state == DECODE
                        for r in self.slots]
            if any(decoding):
                if self.spec is None:
                    self._plain_decode(decoding)
                elif self.spec.tree:
                    self._tree_spec_decode(np.asarray(decoding))
                else:
                    self._spec_decode(np.asarray(decoding))
                did = True
        if did:
            self.ticks += 1
            self._h_tick.record(time.perf_counter() - t_tick)

    def _plain_decode(self, decoding) -> None:
        """One single-token batched decode step over all slots; rows that
        are not decoding ride along with their writes parked."""
        # under over-commit a dry pool preempts a victim here and clears
        # its row
        decoding = self._ensure_room(decoding)
        if not decoding.any():
            return
        tr = self.tel.tracer
        t0 = time.perf_counter()
        where = ({"block_table": self._dev(self.kv.block_tables)}
                 if self.paged else {})
        with tr.span("decode.step", "stage", TID_ENGINE,
                     ({"rows": int(decoding.sum()),
                       "modeled_s": self._modeled_decode_s}
                      if tr.enabled else None)):
            logits, self.kv.cache = lm.decode_step(
                self.params, self.cfg, self._dev(self.cur_tok),
                self.kv.cache, self._dev(self.kv.lengths),
                active=self._dev(decoding), dtype=self.act_dtype, **where)
        self._c_dec_mod.value += self._modeled_decode_s
        self._c_dec_meas.value += time.perf_counter() - t0
        self.model_calls += 1
        sampled = self._sample(logits, slice(None))
        self.kv.advance_mask(decoding)
        now = time.monotonic()
        for b, req in enumerate(self.slots):
            if req is not None and req.state == DECODE and decoding[b]:
                self._emit(req, int(sampled[b]), now)

    def _tick_replay(self) -> None:
        """The reference's replay tick: one batched decode step over every
        seated slot, prefilling or decoding.  A prefilling row feeds its
        next context token (teacher forcing) and its prompt's last step
        emits its first token; rows past their prompt decode.  One model
        call per prompt token, none through the chunk path."""
        t_tick = time.perf_counter()
        tr = self.tel.tracer
        with tr.span("tick", "engine"):
            with tr.span("admit"):
                self._admit()
            occupied = self._ensure_room([s is not None for s in self.slots])
            if not occupied.any():
                return
            t0 = time.perf_counter()
            where = ({"block_table": self._dev(self.kv.block_tables)}
                     if self.paged else {})
            with tr.span("decode.step", "stage", TID_ENGINE,
                         ({"rows": int(occupied.sum()), "replay": True}
                          if tr.enabled else None)):
                logits, self.kv.cache = lm.decode_step(
                    self.params, self.cfg, self._dev(self.cur_tok),
                    self.kv.cache, self._dev(self.kv.lengths),
                    active=self._dev(occupied), dtype=self.act_dtype,
                    **where)
            self._c_dec_mod.value += self._modeled_decode_s
            self._c_dec_meas.value += time.perf_counter() - t0
            self.model_calls += 1
            sampled = self._sample(logits, slice(None))
            lengths_h = self.kv.lengths.copy()
            # every slot that was occupied when the step ran advances (a
            # slot freed this tick is reset at its next alloc)
            self.kv.advance_mask(occupied)
            now = time.monotonic()
            for b, req in enumerate(self.slots):
                if req is None or not occupied[b]:
                    continue
                if req.state == DECODE:
                    self._emit(req, int(sampled[b]), now)
                    continue
                ctx = req.context
                pos = int(lengths_h[b]) + 1  # cached after this step
                if pos < len(ctx):
                    req.filled = pos
                    self.cur_tok[b, 0] = ctx[pos]
                else:
                    req.filled = len(ctx)
                    self._finish_prefill(req, lambda b=b: int(sampled[b]))
        self.ticks += 1
        self._h_tick.record(time.perf_counter() - t_tick)

    def _count_verify(self, mask: np.ndarray, lengths: np.ndarray,
                      written: np.ndarray) -> None:
        if not self.paged:
            return
        live = -(-(lengths + written) // self.kv.page_size)
        self.verify_touched_positions += int(
            (live[mask] * self.kv.page_size).sum())
        self.verify_dense_positions += 2 * int(mask.sum()) * self.max_seq

    def _tables(self) -> Optional[torch.Tensor]:
        """The block tables on the device, or None on the stacked layout."""
        return self._dev(self.kv.block_tables) if self.paged else None

    def _accept_args(self):
        return (self.gen, self._dev(self._temp), self._dev(self._topk),
                self._dev(self._topp))

    def _spec_decode(self, decoding: np.ndarray) -> None:
        """One chain-speculative decode tick: propose per slot, verify
        every slot's draft in ONE chunked forward call, emit 1..k+1
        tokens.

        A decoding slot with cache length L verifies ``[cur_tok, d_1 ..
        d_c]`` at positions ``L .. L+c`` (c capped by the request's
        remaining budget and the cache, so writes stay inside the
        admission-time reservation); other rows are parked at ``max_seq``
        (their writes land on the null page or are dropped, their logits go
        unused).
        The accepted prefix commits through ``kv.rewind(slot, L+m+1)``,
        which also releases pages grown for rejected positions."""
        B, k = self.B, self.spec.k
        tr = self.tel.tracer
        lengths_h = self.kv.lengths.copy()
        caps = speculative.draft_caps(self.slots, lengths_h, decoding, k,
                                      self.seq_ceiling,
                                      adaptive=self.adaptive)
        with tr.span("spec.propose", "spec"):
            draft, counts = self.proposer.propose(
                self.slots, self.cur_tok, lengths_h, decoding, caps)
        if not counts.any():
            # accepting zero drafts IS plain sampling from position 0:
            # the plain step emits the same stream for 1/(k+1) the width
            self._plain_decode(list(decoding))
            return
        # room for the verify's writes before vlen is derived: an
        # over-committed pool may preempt one of the decoding rows itself
        decoding = self._ensure_room(decoding, counts + 1)
        if not decoding.any():
            return
        toks = np.zeros((B, k + 1), np.int64)
        toks[:, 0] = self.cur_tok[:, 0]
        toks[:, 1:] = draft
        vlen = np.where(decoding, lengths_h, self.max_seq).astype(np.int32)
        store = self._state_store
        t0 = time.perf_counter()
        with tr.span("spec.verify", "spec", TID_ENGINE,
                     ({"rows": int(decoding.sum()),
                       "proposed": int(counts.sum()),
                       "modeled_s": self._modeled_decode_s}
                      if tr.enabled else None)):
            self._count_verify(decoding, lengths_h, counts + 1)
            if store is None:
                logits, self.kv.cache = lm.verify_chunk(
                    self.params, self.cfg, self._dev(toks), self.kv.cache,
                    self._dev(vlen), block_tables=self._tables(),
                    dtype=self.act_dtype)
            else:
                # rings and states: per-row valids bound the writes (0
                # parks a row), and the slots the verify will overwrite
                # are copied first, on the device; on the paged layout
                # the tables route the attn writes beside them
                valids = self._dev(np.where(decoding, counts + 1, 0)
                                   .astype(np.int32))
                lens = self._dev(vlen)
                snap = store.snapshot(self.kv.cache, lens, chunk=k + 1)
                logits, self.kv.cache, traj = lm.verify_chunk(
                    self.params, self.cfg, self._dev(toks), self.kv.cache,
                    lens, block_tables=self._tables(), valids=valids,
                    with_traj=True, dtype=self.act_dtype)
        self._c_dec_mod.value += self._modeled_decode_s
        self._c_dec_meas.value += time.perf_counter() - t0
        self.model_calls += 1
        self.spec_ticks += 1
        with tr.span("spec.accept", "spec"):
            n_acc, next_tok = samplers.spec_accept_batch(
                logits, self._dev(draft), self._dev(counts),
                *self._accept_args())
        if store is not None:
            # keep cur_tok and the accepted drafts of each decoding row:
            # rejected ring writes go back, states come off the trajectory
            with tr.span("spec.commit", "spec"):
                commit = torch.where(self._dev(decoding), n_acc + 1, 0)
                self.kv.cache = store.commit(
                    snap, self.kv.cache, traj, lens, commit, valids,
                    chunk=k + 1)
        n_acc, next_tok = n_acc.tolist(), next_tok.tolist()
        now = time.monotonic()
        for b in range(B):
            req = self.slots[b]
            if not decoding[b] or req is None:
                continue
            m = int(n_acc[b])
            self._h_accept.record(m)
            self.spec_proposed += int(counts[b])
            self.spec_accepted += m
            if self.adaptive is not None:
                self.adaptive.observe(b, int(counts[b]), m)
            L = int(lengths_h[b])
            self._emit_spec(req, [int(t) for t in draft[b, :m]]
                            + [int(next_tok[b])], L + m + 1, now)

    def _emit_spec(self, req, tokens: List[int], new_len: int,
                   now: float) -> None:
        """Emit one verify's tokens for a request; if it lives on, commit
        ``new_len`` cache positions (the current token and the accepted
        drafts; the last emitted token becomes the current one)."""
        for tok in tokens:
            self._emit(req, tok, now)
            self.spec_emitted += 1
            if req.done:
                return
        self.kv.rewind(req.slot, new_len)
        self.proposer.commit(req.slot, req.prompt + req.out, new_len)

    def _tree_spec_decode(self, decoding: np.ndarray) -> None:
        """One tree-speculative decode tick: propose a token tree per
        slot, verify every node in ONE ancestor-masked chunked call, and
        emit the longest accepted root-to-leaf path plus a corrective
        token.

        The chunk holds ``[cur_tok, node_1 .. node_n]`` in DFS order; node
        ``j`` attends its root path only and takes the position embedding
        of ``L + depth_j`` while its K/V land at flat position ``L + j``.
        After :func:`~repro_torch.serving.sampler.spec_accept_tree` picks
        the path, its K/V move to ``L+1 .. L+m``
        (:func:`~repro_torch.models.lm.compact_accepted_path`, through the
        block tables as they were at verify time), then ``kv.rewind``
        drops the rejected branches."""
        B, k = self.B, self.spec.k
        C = k + 1
        tr = self.tel.tracer
        lengths_h = self.kv.lengths.copy()
        caps = speculative.draft_caps(self.slots, lengths_h, decoding, k,
                                      self.seq_ceiling,
                                      adaptive=self.adaptive)
        with tr.span("spec.propose", "spec"):
            trees = self.proposer.propose_tree(
                self.slots, self.cur_tok, lengths_h, decoding, caps,
                branch=self.spec.branch)
        tokens_a, parents, n_nodes, anc, depths = speculative.tree_arrays(
            trees, k, C)
        if not n_nodes.any():
            self._plain_decode(list(decoding))
            return
        decoding = self._ensure_room(decoding, n_nodes + 1)
        if not decoding.any():
            return
        toks = np.zeros((B, C), np.int64)
        toks[:, 0] = self.cur_tok[:, 0]
        toks[:, 1:] = tokens_a
        vlen = np.where(decoding, lengths_h, self.max_seq).astype(np.int32)
        t0 = time.perf_counter()
        with tr.span("spec.verify", "spec", TID_ENGINE,
                     ({"rows": int(decoding.sum()),
                       "proposed": int(n_nodes.sum()), "tree": True,
                       "modeled_s": self._modeled_decode_s}
                      if tr.enabled else None)):
            self._count_verify(decoding, lengths_h, n_nodes + 1)
            logits, self.kv.cache = lm.verify_chunk(
                self.params, self.cfg, self._dev(toks), self.kv.cache,
                self._dev(vlen), block_tables=self._tables(),
                anc=self._dev(anc.astype(np.int32)), depths=self._dev(depths),
                dtype=self.act_dtype)
        self._c_dec_mod.value += self._modeled_decode_s
        self._c_dec_meas.value += time.perf_counter() - t0
        self.model_calls += 1
        self.spec_ticks += 1
        with tr.span("spec.accept", "spec"):
            _, acc, next_tok = samplers.spec_accept_tree(
                logits, self._dev(tokens_a), self._dev(parents),
                self._dev(n_nodes), *self._accept_args())
            acc, next_tok = acc.cpu().numpy(), next_tok.tolist()
        # accepted path per row in depth order (DFS layout: a parent's
        # position precedes its children's, so ascending is root-to-leaf)
        paths = [np.flatnonzero(acc[b, 1:]) + 1 if decoding[b]
                 else np.zeros(0, np.int64) for b in range(B)]
        src = np.full((B, k), self.max_seq, np.int64)
        dst = np.full((B, k), self.max_seq, np.int64)
        for b in range(B):
            m = len(paths[b])
            src[b, :m] = lengths_h[b] + paths[b]
            dst[b, :m] = lengths_h[b] + 1 + np.arange(m)
        if (src != dst).any():
            # before any rewind, with the tables as they were at verify
            # time; the indices are resolved on the host
            with tr.span("spec.compact", "spec"):
                self.kv.cache = lm.compact_accepted_path(
                    self.cfg, self.kv.cache, torch.from_numpy(src),
                    torch.from_numpy(dst),
                    block_tables=(torch.from_numpy(self.kv.block_tables)
                                  if self.paged else None))
        now = time.monotonic()
        for b in range(B):
            req = self.slots[b]
            if not decoding[b] or req is None:
                continue
            m = len(paths[b])
            self._h_accept.record(m)
            self.spec_proposed += int(n_nodes[b])
            self.spec_accepted += m
            if self.adaptive is not None:
                self.adaptive.observe_tree(b, int(n_nodes[b]), m)
            L = int(lengths_h[b])
            self._emit_spec(req, [int(toks[b, j]) for j in paths[b]]
                            + [int(next_tok[b])], L + m + 1, now)

    # ------------------------------------------------------------------
    def run(self, max_ticks: int = 10_000, *,
            on_stall: str = "raise") -> List[Request]:
        """Tick until drained; see :func:`drain_engine` for stalls."""
        return drain_engine(self, max_ticks, on_stall)

    def dump_trace(self, path: str) -> str:
        return self.tel.dump_trace(path)

    def stats(self) -> Dict[str, float]:
        """Exactly the keys of ``telemetry.STATS_KEYS_ENGINE``, or with
        speculation of ``STATS_KEYS_ENGINE_SPEC`` (plus the adaptive
        sizer's two with ``adaptive=True``); a stacked engine reports the
        slot pool's three keys in place of the page pool's six."""
        out = latency_stats(self)
        emitted = sum(len(r.out) for r in self.finished) + sum(
            len(r.out) for r in self.slots if r is not None)
        out.update({
            "ticks": self.ticks,
            "model_calls": self.model_calls,
            "prefill_calls": self.prefill_calls,
            "stalled": self.stalled,
            "stalled_queued": len(self.stalled_detail["queued"]),
            "stalled_in_flight": len(self.stalled_detail["in_flight"]),
            "tokens_per_model_call": emitted / max(self.model_calls, 1),
            "mdk_mp_reuse": self.mdk_stats.reuse_factor().get("mp", 0),
            "tick_p50_ms": self._h_tick.quantile(0.5) * 1e3,
            "tick_p99_ms": self._h_tick.quantile(0.99) * 1e3,
            "decode_modeled_s": self._c_dec_mod.value,
            "decode_measured_s": self._c_dec_meas.value,
            "prefill_modeled_s": self._c_pref_mod.value,
            "prefill_measured_s": self._c_pref_meas.value,
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
                # draft-model forwards (0 for the n-gram proposer): the
                # cost side that tokens_per_model_call leaves out
                "draft_calls": getattr(self.proposer, "draft_calls", 0),
                "verify_touched_positions": self.verify_touched_positions,
                "verify_dense_positions": self.verify_dense_positions,
                "spec_accept_len_p50": self._h_accept.quantile(0.5),
                "spec_accept_len_p99": self._h_accept.quantile(0.99),
            })
            if self.adaptive is not None:
                out.update(self.adaptive.stats())
        out.update(self.kv.stats())
        return out
