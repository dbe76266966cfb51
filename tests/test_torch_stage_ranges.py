"""The port's stage ranges on the CPU: the spans that model, sampler and
engine code open through ``telemetry.stage`` and the engine's tracer,
each a ``torch.profiler`` range when the tracer annotates.

  * one tick of a tiny W8A8 GPT-2 engine holds each range as many times
    as the model's layers say (``model.norm`` 2L + 1, ``model.quant_act``
    6L, ``model.attn`` L, ``model.mlp_act`` L, ``model.head`` 1 a model
    call) and ``engine.sample`` and ``engine.sync`` as often as the
    engine samples and waits (``SYNCS``), in the profile and in the host
    trace alike;
  * a range around ``ops.quant_matmul``, as the benchmark's probes put
    one, stays the innermost range of every operator the call runs;
  * a span's start, moved to the profiler's clock through the tracer's
    anchor, lies on its range's start.
"""
import collections
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.telemetry import Telemetry, Tracer

#: the host's waits for the device in one engine call (PERF.md, "Stage
#: ranges"): a decode step copies the block tables, tokens, lengths and
#: decoding mask to the device (4), then samples (3 parameter copies, the
#: greedy check's read, the tokens' copy back: 5); a prefill chunk copies
#: its block-table row and tokens (2), and its prompt's last chunk samples
#: the first token too (5)
SYNCS = {"decode": 4 + 5, "chunk": 2, "last_chunk": 2 + 5}

STAGES = ("model.norm", "model.quant_act", "model.attn", "model.mlp_act",
          "model.head", "engine.sample", "engine.sync")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w8a8():
    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=64,
                     device="cpu")
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    qparams = ServeEngine(cfg, params, batch_slots=2, max_seq=64,
                          quantized=True, calibration_batches=calib,
                          device="cpu").params
    return cfg, qparams


def _engine(cfg, qparams, telemetry):
    return ServeEngine(cfg, qparams, batch_slots=2, max_seq=64, eos_id=-1,
                       act_dtype=torch.float32, chunk_size=8, page_size=8,
                       telemetry=telemetry, device="cpu")


def _annotations(prof):
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _expected(L, calls):
    """Ranges of one tick whose model calls are ``calls`` (kinds of
    ``SYNCS``)."""
    n = len(calls)
    return {"model.norm": (2 * L + 1) * n, "model.quant_act": 6 * L * n,
            "model.attn": L * n, "model.mlp_act": L * n, "model.head": n,
            "engine.sample": sum(c != "chunk" for c in calls),
            "engine.sync": sum(SYNCS[c] for c in calls)}


@pytest.mark.parametrize("tick,calls", [
    (0, ("chunk",)), (2, ("last_chunk", "decode")), (3, ("decode",))],
    ids=["prefill_chunk", "last_chunk_and_decode", "decode"])
def test_a_tick_holds_each_stage_range_as_often_as_its_calls(w8a8, tick,
                                                             calls):
    """One request of 19 prompt tokens in chunks of 8: ticks 0 and 1 are a
    prefill chunk each, tick 2 its last chunk (which samples the first
    token) and the first decode step, tick 3 a decode step alone."""
    cfg, qparams = w8a8
    eng = _engine(cfg, qparams, Telemetry(trace=True, annotate=True))
    eng.submit(list(range(1, 20)), max_new=6)
    for _ in range(tick):
        eng.tick()
    eng.tel.tracer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.tick()
    ranges = collections.Counter(n for _, _, n in _annotations(prof))
    spans = collections.Counter(e[1] for e in eng.tel.tracer.events
                                if e[0] == "X")
    want = _expected(cfg.n_layers, calls)
    assert {n: ranges[n] for n in STAGES} == want
    assert {n: spans[n] for n in STAGES} == want
    assert ranges == spans


def test_a_kernel_range_stays_innermost_over_its_operators(w8a8,
                                                           monkeypatch):
    """``ops.quant_matmul`` wrapped in a ``bench.quant_matmul`` range, as
    ``bench/harness/probes.py`` wraps it: every operator the call runs
    has that range as its innermost one, no program range opens inside
    it, and the activation quantization's operators lie innermost in
    ``model.quant_act``."""
    import functools

    orig = ops.quant_matmul

    @functools.wraps(orig)
    def ranged(*a, **kw):
        with torch.profiler.record_function("bench.quant_matmul"):
            return orig(*a, **kw)

    monkeypatch.setattr(ops, "quant_matmul", ranged)
    cfg, qparams = w8a8
    eng = _engine(cfg, qparams, Telemetry(trace=True, annotate=True))
    eng.submit(list(range(1, 12)), max_new=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.tick()
    ann = _annotations(prof)
    opers = [(e.start_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if not e.is_user_annotation() and e.name().startswith("aten::")]

    def innermost(t):
        holding = [r for r in ann if r[0] <= t <= r[1]]
        return max(holding, key=lambda r: r[0])[2] if holding else None

    kernel = [r for r in ann if r[2] == "bench.quant_matmul"]
    # two chunks and two decode steps: six linears a layer each
    assert len(kernel) == 4 * 6 * cfg.n_layers
    for a, b, _ in kernel:
        assert not [r for r in ann if a < r[0] <= b], \
            "a range opened inside the kernel's"
    inside = [(t, n) for t, n in opers
              if any(a <= t <= b for a, b, _ in kernel)]
    assert inside and all(innermost(t) == "bench.quant_matmul"
                          for t, _ in inside)
    quant = {n for t, n in opers if innermost(t) == "model.quant_act"}
    assert {"aten::mul", "aten::round"} <= quant


def test_a_span_starts_where_its_range_starts():
    """A span's start, on the profiler's clock through the tracer's
    anchor, against its range's ``start_ns()``: within 100 us at the
    median of 20 spans, after a warm-up range (the first range of a
    process pays the profiler's set-up)."""
    tr = Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("warm-up"):
            pass
        for _ in range(20):
            with tr.span("probe"):
                torch.ones(4).add_(1)
            time.sleep(0.001)
    ranges = sorted(a for a, _, n in _annotations(prof) if n == "probe")
    spans = sorted(e[4] for e in tr.events if e[1] == "probe")
    assert len(ranges) == len(spans) == 20
    gaps = [abs(s - r) for s, r in zip(spans, ranges)]
    assert statistics.median(gaps) <= 100_000, gaps
    chrome = [e["ts"] for e in tr.to_chrome()["traceEvents"]
              if e["name"] == "probe"]
    assert abs(sorted(chrome)[0] * 1e3 - ranges[0]) <= max(gaps) + 1e3
