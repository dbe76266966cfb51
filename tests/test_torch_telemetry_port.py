"""The port's telemetry on the CPU against the JAX package's: the
reference's ``tests/test_telemetry.py`` cases that touch no engine
(histograms, the registry and its snapshot, span nesting and the
misnesting error, Chrome export and its validator, modeled-vs-measured,
the zero-allocation disabled path, the artifact writer), the artifact
file byte for byte against the reference's writer, and the profiler
ranges of ``annotate=True``: on the CPU engine they leave streams and
stats as they were, and a ``torch.profiler`` trace holds one range per
annotated host span, under its name.
"""
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from repro.serving import telemetry as jtel
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import telemetry as tel
from repro_torch.serving.distributed import DistributedServeEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import (
    BENCH_SCHEMA_VERSION, NULL_TRACER, Histogram, MetricsRegistry, Telemetry,
    Tracer, config_fingerprint, linear_edges, modeled_vs_measured,
    profile_ranges, registry_counter, validate_chrome_trace,
    write_bench_artifact)

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in parallel worker processes; a pool of intra-op
    threads in each oversubscribes the cores, and these small shapes run
    as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's annotated dispatch sites
ANNOTATED = ("prefill.chunk", "decode.step", "spec.verify", "prefill.round",
             "wave.consume", "wave.dispatch")


# ---------------------------------------------------------------------------
# histograms and the registry


def test_histogram_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-4.0, sigma=1.2, size=5000)
    h = Histogram()
    for v in vals:
        h.record(float(v))
    assert h.count == len(vals)
    assert np.isclose(h.mean(), vals.mean(), rtol=1e-12)
    for q in (0.1, 0.5, 0.9, 0.99):
        exact = float(np.quantile(vals, q))
        assert abs(h.quantile(q) - exact) / exact < 0.16, q
    assert h.quantile(1.0) == float(vals.max())
    jh = jtel.Histogram()
    for v in vals:
        jh.record(float(v))
    assert h.summary() == jh.summary()


def test_histogram_empty_single_and_reset():
    h = Histogram(edges=linear_edges(0.0, 10.0, 10))
    assert h.quantile(0.5) == 0.0 and h.mean() == 0.0
    assert h.summary() == {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                           "max": 0.0}
    h.record(3.0)
    assert h.quantile(0.5) == 3.0 == h.quantile(0.99)
    for v in (1.0, 2.0, 4.0, 5.0):
        h.record(v)
    assert 0.0 < h.quantile(0.5) <= 5.0
    edges = list(h.edges)
    h.reset()
    assert h.count == 0 and h.quantile(0.99) == 0.0 and h.edges == edges


def test_registry_snapshot_and_reset():
    reg, jreg = MetricsRegistry(), jtel.MetricsRegistry()
    for r, mod in ((reg, tel), (jreg, jtel)):
        r.counter("ticks").inc(3)
        r.counter("ticks").inc()
        r.gauge("pool").set(5)
        r.gauge("pool").set(2)  # the peak survives the lower sample
        r.histogram("lat", edges=mod.linear_edges(0.0, 1.0, 4)).record(0.5)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert snap["ticks"] == 4 and snap["pool"] == 2 and snap["pool_peak"] == 5
    assert snap["lat_count"] == 1 and snap["lat_mean"] == 0.5
    h = reg.histogram("lat")
    assert reg.histogram("lat", edges=linear_edges(0.0, 9.0, 3)) is h
    reg.reset()
    snap = reg.snapshot()
    assert snap["ticks"] == 0 and snap["pool_peak"] == 0
    assert snap["lat_count"] == 0
    assert reg.histogram("lat").edges == linear_edges(0.0, 1.0, 4)


def test_registry_counter_descriptor():
    class Obj:
        ticks = registry_counter("ticks")

        def __init__(self):
            self.tel = Telemetry()

    o = Obj()
    o.ticks += 2
    o.ticks += 1
    assert o.ticks == 3 == o.tel.registry.counter("ticks").value
    o.tel.reset()
    assert o.ticks == 0


# ---------------------------------------------------------------------------
# the tracer


def test_span_nesting_and_ordering():
    tr = Tracer()
    with tr.span("tick", "engine"):
        with tr.span("admit"):
            pass
        with tr.span("decode.step", args={"rows": 2}):
            pass
    evs = tr.events
    assert [e[1] for e in evs] == ["admit", "decode.step", "tick"]
    by = {e[1]: e for e in evs}
    for child in ("admit", "decode.step"):
        ts, dur = by[child][4:6]
        pts, pdur = by["tick"][4:6]
        assert pts <= ts and ts + dur <= pts + pdur + 1e-6
    a, d = by["admit"], by["decode.step"]
    assert a[4] + a[5] <= d[4] + 1e-6
    assert by["decode.step"][6] == {"rows": 2}


def test_span_misnesting_raises():
    """Closing a span while one opened inside it is still open raises, as
    the reference's tracer does."""
    for mod in (tel, jtel):
        tr = mod.Tracer()
        outer = tr.span("outer")
        inner = tr.span("inner")
        outer.__enter__()
        inner.__enter__()
        with pytest.raises(AssertionError, match="nesting"):
            outer.__exit__(None, None, None)


def test_spans_on_other_tracks_close_independently():
    tr = Tracer()
    a = tr.span("a", tid=0)
    b = tr.span("b", tid=1)
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)  # b is on another track
    b.__exit__(None, None, None)
    assert [e[1] for e in tr.events] == ["a", "b"]


def test_chrome_export_is_valid_and_labelled(tmp_path):
    tr = Tracer()
    with tr.span("tick", "engine"):
        tr.instant("req.queued", "request", args={"rid": 0})
        tr.async_begin("request", 0)
    tr.transfer("decode.logits", 0.0, 64, True, "drain", "fetch")
    tr.transfer("chunk.tokens", 0.0, 128, False, "prefill", "stage")
    tr.async_end("request", 0)
    trace = tr.to_chrome()
    counts = validate_chrome_trace(trace)
    assert counts == jtel.validate_chrome_trace(trace)
    assert counts["X"] == 3 and counts["i"] == 1
    assert counts["b"] == 1 and counts["e"] == 1 and counts["M"] == 3
    evs = trace["traceEvents"]
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == \
        {"engine", "transfers", "requests"}
    cats = {e["cat"] for e in evs if e["ph"] == "X"}
    assert {"engine", "transfer.hidden", "transfer.exposed"} <= cats
    inst = next(e for e in evs if e["ph"] == "i")
    assert inst["s"] == "t" and inst["args"] == {"rid": 0}
    p = tmp_path / "t.json"
    tr.dump(str(p))
    with open(p) as f:
        validate_chrome_trace(json.load(f))


@pytest.mark.parametrize("trace,match", [
    ({}, "traceEvents"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "name": "a"}]}, "missing 'ts'"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "ts": 1.0,
                       "name": "a"}]}, "without dur"),
    ({"traceEvents": [{"ph": "b", "pid": 0, "tid": 0, "ts": 0.0,
                       "cat": "request", "id": 1, "name": "r"}]},
     "unbalanced"),
], ids=["empty", "no_ts", "no_dur", "unbalanced"])
def test_validate_rejects_malformed_traces(trace, match):
    for fn in (validate_chrome_trace, jtel.validate_chrome_trace):
        with pytest.raises(ValueError, match=match):
            fn(trace)


def test_modeled_vs_measured_aggregation():
    trace = {"traceEvents": [
        {"ph": "X", "name": "decode.step", "cat": "stage", "pid": 0,
         "tid": 0, "ts": 0.0, "dur": 2e6, "args": {"modeled_s": 1.0}},
        {"ph": "X", "name": "decode.step", "cat": "stage", "pid": 0,
         "tid": 0, "ts": 3e6, "dur": 4e6, "args": {"modeled_s": 1.0}},
        {"ph": "X", "name": "admit", "cat": "stage", "pid": 0,
         "tid": 0, "ts": 0.0, "dur": 1.0},
    ]}
    out = modeled_vs_measured(trace)
    assert out == jtel.modeled_vs_measured(trace)
    d = out["decode.step"]
    assert set(out) == {"decode.step"}
    assert d["spans"] == 2 and d["modeled_s"] == 2.0
    assert np.isclose(d["measured_s"], 6.0) and np.isclose(d["ratio"], 3.0)


def test_null_tracer_zero_allocations():
    """The disabled tracer's hot-path methods, annotation included,
    allocate nothing."""
    tel_file = NULL_TRACER.span.__func__.__code__.co_filename
    off = Tracer(annotate=False)

    def burst(n):
        for i in range(n):
            with NULL_TRACER.span("tick", "engine"):
                with NULL_TRACER.span("decode.step", "stage", 0, None):
                    NULL_TRACER.instant("req.queued", "request")
                NULL_TRACER.transfer("logits", 0.0, 64, True, "drain")
            NULL_TRACER.async_begin("request", i)
            NULL_TRACER.async_end("request", i)
            with NULL_TRACER.annotation("decode.step"):
                pass
            with off.annotation("decode.step"):
                pass

    burst(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        burst(500)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, tel_file)]
    diff = after.filter_traces(flt).compare_to(
        before.filter_traces(flt), "lineno")
    grown = [d for d in diff if d.size_diff > 256 or d.count_diff >= 100]
    assert not grown, [(d.traceback, d.size_diff) for d in grown]


def test_annotation_is_a_profiler_range_only_when_asked():
    assert Tracer().annotation("x") is NULL_TRACER.annotation("y")
    rf = Tracer(annotate=True).annotation("decode.step")
    assert isinstance(rf, torch.profiler.record_function)
    t = Telemetry(trace=True, annotate=True)
    assert t.tracing and t.tracer._annotate
    assert not Telemetry().tracing and not Telemetry(annotate=True).tracing


def test_telemetry_dump_requires_tracing():
    t = Telemetry()
    assert t.tracer is NULL_TRACER
    with pytest.raises(ValueError, match="disabled"):
        t.dump_trace("never.json")


# ---------------------------------------------------------------------------
# the artifact writer


def _artifact_args(extra=True):
    kw = dict(bench="x", config={"model": "gpt2-345m", "seed": 0,
                                 "shape": (8, 32), "nested": {"b": 1, "a": 2}},
              metrics={"overlap_ratio": 0.97, "tokens_per_s": 1234.5678,
                       "per_kernel": {"mp": [1, 2.5]}},
              gates={"overlap_ratio_min": 0.85})
    if extra:
        kw["extra"] = {"baseline": {"ticks": 10}, "device": "NVIDIA H100"}
    return kw


@pytest.mark.parametrize("extra", [True, False], ids=["extra", "plain"])
def test_write_bench_artifact_is_byte_identical(tmp_path, extra):
    a = write_bench_artifact(str(tmp_path / "a.json"), **_artifact_args(extra))
    b = jtel.write_bench_artifact(str(tmp_path / "b.json"),
                                  **_artifact_args(extra))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert BENCH_SCHEMA_VERSION == jtel.BENCH_SCHEMA_VERSION


def test_write_bench_artifact_schema(tmp_path):
    cfgd = {"model": "gpt2-345m", "seed": 0}
    assert config_fingerprint(cfgd) == jtel.config_fingerprint(cfgd)
    p = write_bench_artifact(
        str(tmp_path / "BENCH_x.json"), bench="x", config=cfgd,
        metrics={"overlap_ratio": 0.97}, gates={"overlap_ratio_min": 0.85},
        extra={"baseline": {"ticks": 10}})
    with open(p) as f:
        art = json.load(f)
    assert art["schema_version"] == BENCH_SCHEMA_VERSION
    assert art["config_fingerprint"] == config_fingerprint(cfgd)
    assert art["gates"] == {"overlap_ratio_min": 0.85}
    assert art["baseline"] == {"ticks": 10}
    assert config_fingerprint({"model": "gpt2-345m", "seed": 1}) != \
        art["config_fingerprint"]
    with pytest.raises(ValueError, match="collides"):
        write_bench_artifact(str(tmp_path / "y.json"), bench="y", config={},
                             metrics={}, extra={"metrics": {}})


# ---------------------------------------------------------------------------
# profiler ranges


class _Event:
    """A profiler event as ``kineto_results.events()`` yields it: a host
    operator, range or runtime call (CPU), or a device activity."""

    def __init__(self, kind, name, corr, start=0, end=0):
        self.kind, self._name, self.corr = kind, name, corr
        self.start, self.end = start, end

    def device_type(self):
        return (DeviceType.CPU if self.kind in ("op", "range", "runtime")
                else DeviceType.CUDA)

    def is_user_annotation(self):
        return self.kind in ("range", "gpu_range")

    def name(self):
        return self._name

    def correlation_id(self):
        return self.corr

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_profile_ranges_attributes_kernels_by_their_launch_call():
    """Synthetic events: a kernel belongs to the innermost range that
    holds the start of the launch call sharing its correlation id; a
    device activity with no launch call, or launched outside the ranges,
    is outside; host operators, the kernels' own (device) times and the
    device-side copies of the ranges play no part."""
    ev = [
        _Event("range", "other", 1, start=0, end=500),
        _Event("range", "decode.step", 2, start=100, end=150),
        _Event("range", "prefill.chunk", 3, start=10, end=40),
        _Event("op", "aten::mm", 90, start=120, end=121),
        _Event("runtime", "cudaLaunchKernelExC", 90, start=120),
        _Event("runtime", "cuLaunchKernel", 91, start=20),
        _Event("runtime", "cudaLaunchKernel", 92, start=200),
        _Event("runtime", "cudaMemcpyAsync", 93, start=130),
        _Event("kernel", "mp_matmul_kernel", 90, start=9e9),
        _Event("kernel", "verify::split_kernel", 91, start=1),
        _Event("kernel", "gemm", 92, start=125),
        _Event("memcpy", "Memcpy DtoH", 93, start=140),
        _Event("gpu_range", "decode.step", 2, start=121),
    ]
    got = profile_ranges(ev, ("decode.step", "prefill.chunk"))
    assert got == {
        "decode.step": {"ranges": 1, "kernels": {"mp_matmul_kernel": 1}},
        "prefill.chunk": {"ranges": 1,
                          "kernels": {"verify::split_kernel": 1}},
        None: {"ranges": 0, "kernels": {"gemm": 1, "Memcpy DtoH": 1}}}


@pytest.fixture(scope="module")
def gpt2():
    cfg = get_config("gpt2-345m").reduced()
    gen = torch.Generator().manual_seed(0)
    params = lm.init(cfg, gen, max_seq=64, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 19, 11, 27)]
    return cfg, params, prompts


def _serve(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return {r.rid: r.out for r in eng.run()}


_TIMING = ("_s", "_ms")


def _untimed(stats):
    return {k: v for k, v in stats.items()
            if not any(t in k for t in _TIMING)}


def _profiled(make, prompts):
    """Serve ``prompts`` on ``make(Telemetry(trace, annotate))`` under
    ``torch.profiler``; (streams, stats, host trace, profile trace)."""
    from torch.profiler import ProfilerActivity, profile

    eng = make(Telemetry(trace=True, annotate=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        streams = _serve(eng, prompts)
    return streams, eng.stats(), eng.tel.tracer.to_chrome(), prof


@pytest.mark.parametrize("kind", ["paged", "stacked", "spec_chain",
                                  "replay", "distributed"])
def test_annotated_engine_ranges_match_host_spans(gpt2, kind):
    """``annotate=True`` changes no stream and no counted stat against an
    untraced engine, and the profile holds one range per annotated host
    span, under its name."""
    cfg, params, prompts = gpt2
    common = dict(max_seq=64, eos_id=-1, chunk_size=8,
                  act_dtype=torch.float32)
    if kind == "distributed":
        def make(t):
            return DistributedServeEngine(
                cfg, params, mesh=make_serving_mesh(2, ["cpu"] * 2),
                slots_per_shard=2, page_size=8, telemetry=t, **common)
    else:
        kw = {"page_size": 8}
        if kind == "stacked":
            kw = {"kv_layout": "stacked"}
        elif kind == "spec_chain":
            kw["spec"] = SpecConfig(k=3, proposer="ngram")
        elif kind == "replay":
            kw["prefill_mode"] = "replay"

        def make(t):
            return ServeEngine(cfg, params, batch_slots=3, device="cpu",
                               telemetry=t, **common, **kw)
    plain = make(Telemetry())
    want = _serve(plain, prompts)
    streams, stats, host, prof = _profiled(make, prompts)
    assert streams == want
    assert _untimed(stats) == _untimed(plain.stats())
    validate_chrome_trace(host)
    ranges = profile_ranges(prof.profiler.kineto_results.events(),
                            ANNOTATED)
    spans = {}
    for ev in host["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] in ANNOTATED:
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    assert spans, "no annotated span was reached"
    assert {n: r["ranges"] for n, r in ranges.items()
            if n is not None and r["ranges"]} == spans
