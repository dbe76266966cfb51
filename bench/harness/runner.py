"""One run of one cell: set-up, the measured window, the check, the
metrics.

Set-up makes the weights on the device from the seed, builds the
program's engine (its kernels, SmoothQuant calibration and page pool),
then runs the cell's traffic until every client has had a first token:
that ramp warms every shape the cell uses (the decode step at the cell's
slots, the prefill chunk, the samplers) and is set-up the traffic needs.
The window opens there and lasts ``seconds`` of ticking.  An untraced
run measures the whole window on the host's clock; where the cell's
end-to-end metrics read the device (``source`` ``device_trace``), it
ticks in parts of at most ``DEVICE_PART_S`` under a profiler that records
the device's activities only, and adds up their busy time between the
parts, so that no part outgrows the tracer's buffers.  A traced run
records the model calls (``harness.probes``) and measures the host for
the first part of the window; then it installs the benchmark's kernel
ranges and measures the device under ``torch.profiler`` for the last few
seconds, so neither the profiler's cost nor the ranges' colour the
host's numbers.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Sequence

import torch

from harness import check, probes as probes_mod, trace as trace_mod
from harness import weights as weights_mod

#: the profiled part of a traced window: a quarter, from 2 to 6 seconds
PROFILE_SHARE, PROFILE_MIN_S, PROFILE_MAX_S = 0.25, 2.0, 6.0
#: the longest part of an untraced window under the device's tracer
DEVICE_PART_S = 5.0


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    d: Dict  # engine counters over the window
    requests: List[Dict]
    tick_s: float  # wall seconds spent ticking (the window's length)
    busy_s: Optional[float] = None  # device busy seconds, where traced
    parts: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.tick_s


@dataclasses.dataclass
class RunData:
    """What the metric readers (``bench/metrics/*.py``) read."""

    cell: object
    setup_s: float
    host: Window
    calls: List[Dict]  # model calls in the host window (traced runs)
    prof: Optional[Dict]  # profiled part of a traced run
    prof_calls: List[Dict]
    prof_kernels: List[Dict]

    @property
    def model(self) -> Dict:
        return self.cell.config["model"]

    @property
    def serving(self) -> Dict:
        return self.cell.config["serving"]


def model_config(model: Dict):
    from repro_torch.configs.base import ModelConfig

    fields = dict(model)
    if "block_pattern" in fields:
        fields["block_pattern"] = tuple(fields["block_pattern"])
    return ModelConfig(**fields)


def _counters(eng, loop) -> Dict:
    reg = eng.tel.registry
    return {"time": time.monotonic(), "ticks": eng.ticks,
            "model_calls": eng.model_calls,
            "prefill_calls": eng.prefill_calls,
            "decode_measured_s": reg.counter("decode_measured_s").value,
            "prefill_measured_s": reg.counter("prefill_measured_s").value,
            "emitted": loop.emitted()}


def _request_records(eng, loop) -> List[Dict]:
    reqs = list(eng.finished) + [r for r in eng.slots if r is not None] \
        + list(eng.queue)
    return [{"rid": r.rid, "client": loop.client_of[r.rid],
             "prompt": list(r.prompt), "out": list(r.out),
             "max_new": loop.max_new[r.rid], "n_out": len(r.out),
             "t_submit": r.t_submit, "t_first": r.t_first,
             "t_done": r.t_done} for r in reqs]


def _tick_for(loop, seconds: float) -> float:
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        loop.tick()
    return time.monotonic()


def _ticking(loop, seconds: float, device_trace: bool) -> Dict:
    """Tick for ``seconds``.  Returns the wall seconds spent ticking; with
    ``device_trace``, also the device's busy seconds, summed over parts of
    at most ``DEVICE_PART_S`` each traced by a profiler of the device's
    activities alone (a part's trace is read between parts, outside the
    ticking time), and each part's reading."""
    n = max(1, -(-int(seconds * 1000) // int(DEVICE_PART_S * 1000))) \
        if device_trace else 1
    out = {"tick_s": 0.0, "busy_s": None, "parts": []}
    for i in range(n):
        part = seconds * (i + 1) / n - out["tick_s"]
        if part <= 0:
            break
        if device_trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                t1 = _tick_for(loop, part)
            busy = trace_mod.device_busy(prof)
            busy["wall_s"] = t1 - t0
            trace_mod.check_covered(busy)
            out["parts"].append(busy)
            out["busy_s"] = (out["busy_s"] or 0.0) + busy["busy_s"]
        else:
            t0 = time.monotonic()
            t1 = _tick_for(loop, part)
        out["tick_s"] += t1 - t0
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, controls: Sequence[str] = ()) -> Dict:
    """Run ``cell`` once on ``device``; ``controls`` are read beside the
    check (``harness.check``).  Returns ``data`` (the ``RunData`` the
    metric readers take), ``checks`` ({name: (value, limit)}), ``gaps``,
    ``sampled`` and ``sampled_tokens`` (the check's sample),
    ``memory_peak_bytes`` (read before the check), ``attempted`` (the
    requests sent by the window's end) and ``failed`` (those finished in
    the window off their drawn length)."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.telemetry import Telemetry

    device = torch.device(device)
    model, serving = cell.config["model"], cell.config["serving"]
    device_trace = (not trace and device.type == "cuda" and any(
        m["source"] == "device_trace" for m in cell.end_to_end))
    cfg = model_config(model)
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.library()
        torch.cuda.reset_peak_memory_stats()
    w = weights_mod.make(model, serving["max_seq"], seed, device)
    calib = check.calibration(serving, seed, model["vocab_size"])
    eng = ServeEngine(
        cfg, w, batch_slots=int(cell.workload["slots"]),
        max_seq=int(serving["max_seq"]), eos_id=-1,
        quantized=bool(serving["quantized"]), calibration_batches=calib,
        seed=int(seed) % (1 << 63), chunk_size=int(serving["chunk_size"]),
        kv_layout=serving["kv_layout"], page_size=int(serving["page_size"]),
        telemetry=Telemetry(trace=True, annotate=True) if trace else None,
        device=device)
    del w  # the float masters of the quantized linears go with it
    gen = cell.generator()
    loop = gen.ClosedLoop(eng, gen.requests(cell.traffic, seed,
                                            model["vocab_size"]))
    pr = probes_mod.Probes(eng).install() if trace else None
    try:
        loop.start()
        while not loop.all_started():
            loop.tick()
        a = _counters(eng, loop)
        setup_s = a["time"] - t_start
        prof_s = 0.0
        if trace:
            prof_s = min(PROFILE_MAX_S, max(PROFILE_MIN_S,
                                            PROFILE_SHARE * seconds))
            pr.phase = "host"
        ticked = _ticking(loop, seconds - prof_s, device_trace)
        b = _counters(eng, loop)
        summary, pc = None, None
        if trace:
            pr.phase = "profiled"
            pr.install_ranges()
            summary, pc = _profiled(eng, loop, prof_s)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        records = _request_records(eng, loop)
        t_end = (pc or b)["time"]
    finally:
        if pr is not None:
            pr.remove()
    calls = [c for c in (pr.calls if pr else []) if c["phase"] == "host"]
    prof_calls = [c for c in (pr.calls if pr else [])
                  if c["phase"] == "profiled"]
    prof_kernels = [k for k in (pr.kernels if pr else [])
                    if k["phase"] == "profiled"]
    if summary is not None:
        summary["model_calls"] = pc["model_calls"] - b["model_calls"]
    del eng, loop, pr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    host = Window(a["time"], b["time"], _delta(a, b), records, **ticked)
    done = [r for r in records
            if r["t_done"] is not None and a["time"] < r["t_done"] <= t_end]
    wl = cell.workload["check"]
    size = {k: int(wl.get(k, v)) for k, v in check.SAMPLE.items()}
    picked = check.sample(done, seed, **size)
    short = sum(1 for r in done if r["n_out"] != r["max_new"])
    gaps = (check.compare(cell, seed, picked, device, controls=controls)
            if picked else {})
    checks = {name: (gaps.get(name), float(lim))
              for name, lim in wl["limits"].items()}
    checks.update(unsampled=(0 if picked else 1, 0),
                  short_outputs=(short, 0))
    sent_by_end = [r for r in records if r["t_submit"] <= t_end]
    return {"data": RunData(cell, setup_s, host, calls, summary, prof_calls,
                            prof_kernels),
            "checks": checks, "gaps": gaps, "sampled": len(picked),
            "sampled_tokens": sum(len(r["out"]) for r in picked),
            "memory_peak_bytes": int(memory_peak),
            "attempted": len(sent_by_end), "failed": short}


def _delta(a: Dict, b: Dict) -> Dict:
    return {k: b[k] - a[k] for k in a if k != "time"}


def _profiled(eng, loop, seconds: float):
    """Tick under ``torch.profiler`` for ``seconds``; returns the trace's
    summary (``harness.trace.read`` plus ``window_s``) and the counters
    at its end."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        t1 = _tick_for(loop, seconds)
    c = _counters(eng, loop)
    summary = trace_mod.read(prof)
    summary["window_s"] = t1 - t0
    return summary, c
