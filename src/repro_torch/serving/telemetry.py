"""Telemetry for the serving engine: a metrics registry and a span tracer.

  * :class:`MetricsRegistry` — counters, gauges (with high-water marks)
    and fixed-bucket streaming histograms (no unbounded value lists).
    The engine's schedule counters are plain attributes backed by
    registry counters (:class:`registry_counter`), and its TTFT / TPOT /
    tick-wall aggregates come from histograms.
  * :class:`Tracer` — tick/stage spans and request instants, exported as
    Chrome/Perfetto trace-event JSON.  The default :data:`NULL_TRACER`
    is a no-op whose methods allocate nothing; call sites build span
    arguments only under ``tracer.enabled``.  Spans on one track must
    nest: closing one that is not the innermost open span raises.  Spans
    are host time and never synchronize the device, so on the card a span
    measures dispatch plus host work, not kernel time.
  * Profile alignment: ``Telemetry(trace=True, annotate=True)`` makes
    :meth:`Tracer.annotation` a ``torch.profiler.record_function`` range,
    which the engines wrap around their dispatches, so a profile taken
    with ``torch.profiler`` shows the card's kernels inside ranges named
    as the host spans.
    :func:`profile_ranges` reads such a profile: the ranges of each name
    and the kernels launched inside them.
  * :func:`modeled_vs_measured` aggregates a trace's compute spans
    against the perf model's predicted seconds (``args["modeled_s"]``);
    :func:`validate_chrome_trace` checks a trace's structure.
  * :func:`write_bench_artifact` is the one versioned writer of
    benchmark artifacts: schema version, config fingerprint and the gate
    thresholds beside the metrics they bound.

``STATS_KEYS_ENGINE`` documents exactly what ``ServeEngine.stats()``
returns, and ``STATS_KEYS_ENGINE_SPEC`` what it returns with
speculation (plus ``adaptive_slots`` and ``adaptive_cap_mean`` under
adaptive draft sizing); ``STATS_KEYS_DISTRIBUTED`` what
``DistributedServeEngine.stats()`` returns.  The distributed engine's
transfer meter re-emits each of its events as a span on the
"transfers" track (:meth:`Tracer.transfer`).
"""
from __future__ import annotations

import hashlib
import json
import math
import time
from bisect import bisect_right
from collections import deque
from typing import Dict, List, Optional

#: bumped whenever the benchmark artifact layout changes shape
BENCH_SCHEMA_VERSION = 2

#: Chrome trace-event tracks
TID_ENGINE = 0
TID_TRANSFER = 1
TID_REQUEST = 2
_TID_NAMES = {TID_ENGINE: "engine", TID_TRANSFER: "transfers",
              TID_REQUEST: "requests"}


class Counter:
    """A resettable scalar; ``value`` is a plain attribute so hot paths
    ``+=`` it through :class:`registry_counter`."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A last-value scalar with a high-water mark."""

    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v) -> None:
        self.value = v
        self.peak = max(self.peak, v)

    def reset(self) -> None:
        self.value = 0.0
        self.peak = 0.0


def exponential_edges(lo: float = 1e-6, hi: float = 1e3,
                      per_decade: int = 16) -> List[float]:
    """Bucket edges, ``per_decade`` per decade over [lo, hi]."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


def linear_edges(lo: float, hi: float, n: int) -> List[float]:
    """``n`` equal buckets over [lo, hi] (``n + 1`` edges)."""
    step = (hi - lo) / n
    return [lo + i * step for i in range(n + 1)]


class Histogram:
    """Fixed-bucket streaming histogram: O(len(edges)) memory.  ``mean``
    is exact; quantiles interpolate within the containing bucket,
    clamped to the observed min/max."""

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, edges: Optional[List[float]] = None):
        self.edges = list(edges) if edges is not None \
            else exponential_edges()
        if any(a >= b for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.reset()

    def record(self, v: float) -> None:
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1); 0.0 when empty."""
        if not self.count:
            return 0.0
        if self.count == 1:
            return self.vmin
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else self.vmin
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                lo = min(max(lo, self.vmin), self.vmax)
                hi = min(max(hi, self.vmin), self.vmax)
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return self.vmax

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
            "max": self.vmax if self.count else 0.0,
        }

    def reset(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")


class MetricsRegistry:
    """Named counters/gauges/histograms, created on first use."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  edges: Optional[List[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(edges)
        return h

    def snapshot(self) -> Dict[str, float]:
        """Flat dict of every metric: counters by name, gauges as
        ``name`` and ``name_peak``, histograms as ``name_{count, mean,
        p50, p99, max}``."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
            out[f"{name}_peak"] = g.peak
        for name, h in self._hists.items():
            for k, v in h.summary().items():
                out[f"{name}_{k}"] = v
        return out

    def reset(self) -> None:
        for m in (*self._counters.values(), *self._gauges.values(),
                  *self._hists.values()):
            m.reset()


class registry_counter:
    """Descriptor exposing a registry counter as an engine attribute:
    ``self.ticks += 1`` reads and writes
    ``self.tel.registry.counter("ticks").value``."""

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.tel.registry.counter(self.name).value

    def __set__(self, obj, value) -> None:
        obj.tel.registry.counter(self.name).value = value


class _NullCtx:
    """The shared no-op context every disabled call returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Records one complete ("X") trace event; raises if it closes while
    a span opened inside it on the same track is still open."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "t0")

    def __init__(self, tracer, name, cat, tid, args):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.tid, self.args = tid, args

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.tracer._stack.setdefault(self.tid, []).append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tracer
        top = tr._stack[self.tid].pop()
        if top != self.name:
            raise AssertionError(
                f"span nesting violated: closing {self.name!r} but "
                f"{top!r} is open")
        tr._events.append(("X", self.name, self.cat, self.tid,
                           (self.t0 - tr._t0) * 1e6,
                           (time.perf_counter() - self.t0) * 1e6, self.args))
        return False


class NullTracer:
    """No-op recorder (the default)."""

    enabled = False
    __slots__ = ()

    def span(self, name, cat="stage", tid=TID_ENGINE, args=None):
        return _NULL_CTX

    def instant(self, name, cat="stage", tid=TID_ENGINE, args=None):
        return None

    def async_begin(self, name, id_, cat="request", args=None):
        return None

    def async_end(self, name, id_, cat="request"):
        return None

    def transfer(self, name, t0, nbytes, hidden, phase, kind="stage"):
        return None

    def annotation(self, name):
        return _NULL_CTX

    def reset(self):
        return None


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Recording tracer: a bounded event ring exported as Chrome JSON.

    ``annotate=True`` makes :meth:`annotation` return a
    ``torch.profiler.record_function`` range, so a profile taken with
    ``torch.profiler`` shows each dispatch's kernels inside a range named
    as its host span.  A range costs a few microseconds of host time
    each; with ``annotate`` off :meth:`annotation` hands back the shared
    no-op context."""

    enabled = True
    __slots__ = ("_t0", "_events", "_stack", "_annotate")

    def __init__(self, *, max_events: int = 1_000_000,
                 annotate: bool = False):
        self._annotate = annotate
        self._t0 = time.perf_counter()
        self._events = deque(maxlen=max_events)
        self._stack: Dict[int, List[str]] = {}

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name, cat="stage", tid=TID_ENGINE, args=None):
        return _SpanCtx(self, name, cat, tid, args)

    def instant(self, name, cat="stage", tid=TID_ENGINE, args=None):
        self._events.append(("i", name, cat, tid, self._now_us(), 0.0, args))

    def async_begin(self, name, id_, cat="request", args=None):
        self._events.append(("b", name, cat, id_, self._now_us(), 0.0, args))

    def async_end(self, name, id_, cat="request"):
        self._events.append(("e", name, cat, id_, self._now_us(), 0.0, None))

    def transfer(self, name, t0, nbytes, hidden, phase, kind="stage"):
        """One transfer-meter event as a complete span on the transfers
        track, cat ``transfer.hidden`` or ``transfer.exposed``; ``t0`` is
        its ``time.perf_counter()`` start."""
        t1 = time.perf_counter()
        self._events.append((
            "X", name, "transfer." + ("hidden" if hidden else "exposed"),
            TID_TRANSFER, (t0 - self._t0) * 1e6, (t1 - t0) * 1e6,
            {"bytes": nbytes, "hidden": hidden, "phase": phase,
             "kind": kind}))

    def annotation(self, name):
        if not self._annotate:
            return _NULL_CTX
        import torch

        return torch.profiler.record_function(name)

    def reset(self) -> None:
        """Drop recorded events without disturbing open spans."""
        self._events.clear()

    @property
    def events(self) -> List[tuple]:
        return list(self._events)

    def to_chrome(self) -> Dict:
        out = [{"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                "args": {"name": tname}} for tid, tname in _TID_NAMES.items()]
        for ph, name, cat, tid_or_id, ts, dur, args in self._events:
            ev = {"ph": ph, "name": name, "cat": cat, "pid": 0, "ts": ts}
            if ph == "X":
                ev["tid"], ev["dur"] = tid_or_id, dur
            elif ph in ("b", "e"):
                ev["tid"], ev["id"] = TID_REQUEST, tid_or_id
            else:
                ev["tid"], ev["s"] = tid_or_id, "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        return path


def validate_chrome_trace(trace: Dict) -> Dict[str, int]:
    """Structural validity of a Chrome/Perfetto trace dict: the required
    ``ph``/``ts``/``pid``/``tid``/``name`` fields on every event,
    non-negative durations on complete events, and balanced async
    begin/end pairs.  Returns event counts per phase type; raises
    ``ValueError`` on the first violation."""
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("trace has no traceEvents list")
    counts: Dict[str, int] = {}
    asyncs: Dict[tuple, int] = {}
    for i, ev in enumerate(evs):
        for field in ("ph", "pid", "name"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        counts[ph] = counts.get(ph, 0) + 1
        if ph == "M":
            continue
        for field in ("ts", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if ph == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"complete event {i} without dur: {ev}")
        elif ph in ("b", "e"):
            key = (ev.get("cat"), ev.get("id"), ev["name"])
            asyncs[key] = asyncs.get(key, 0) + (1 if ph == "b" else -1)
    for key, bal in asyncs.items():
        if bal != 0:
            raise ValueError(f"unbalanced async events for {key}: {bal}")
    return counts


def modeled_vs_measured(trace: Dict) -> Dict[str, Dict[str, float]]:
    """Per span name, the perf model's predicted seconds
    (``args.modeled_s``) against the measured host span durations.
    ``ratio`` > 1 means the stage is slower than the FPGA model predicts;
    host spans understate device time on the card, so ratios compare
    runs, not absolute costs."""
    out: Dict[str, Dict[str, float]] = {}
    for ev in trace.get("traceEvents", ()):
        args = ev.get("args") or {}
        if ev.get("ph") != "X" or "modeled_s" not in args:
            continue
        d = out.setdefault(ev["name"], {
            "spans": 0, "modeled_s": 0.0, "measured_s": 0.0})
        d["spans"] += 1
        d["modeled_s"] += float(args["modeled_s"])
        d["measured_s"] += float(ev.get("dur", 0.0)) / 1e6
    for d in out.values():
        d["ratio"] = (d["measured_s"] / d["modeled_s"]
                      if d["modeled_s"] else 0.0)
    return out


def profile_ranges(events, names) -> Dict[str, Dict]:
    """What a ``torch.profiler`` run shows inside the annotated ranges
    named ``names``, from its events (``prof.profiler.kineto_results.
    events()``): per name, the number of ranges and the device kernels
    launched from inside one (``{"ranges": n, "kernels": {kernel name:
    launches}}``), and under ``None`` the device activities launched
    outside every such range (or by no launch call).  A kernel shares its
    correlation id with the host call that launched it
    (``cudaLaunchKernel`` and kin); it belongs to the innermost range
    that holds that call's start.  Ranges and launch calls are both read
    on the profiler's host clock; no device timestamp, and no host span
    of the tracer, is compared with them.  The engines dispatch from one
    thread, so threads are not told apart."""
    from torch.autograd import DeviceType

    names = set(names)
    out: Dict = {n: {"ranges": 0, "kernels": {}} for n in names}
    out[None] = {"ranges": 0, "kernels": {}}
    ranges, launch_at, kernels = [], {}, []
    for ev in events:
        if ev.device_type() == DeviceType.CPU:
            name = ev.name()
            if name in names and ev.is_user_annotation():
                out[name]["ranges"] += 1
                ranges.append((ev.start_ns(), ev.end_ns(), name))
            elif "Launch" in name:
                launch_at[ev.correlation_id()] = ev.start_ns()
        elif not ev.is_user_annotation():  # a device activity
            kernels.append((ev.name(), ev.correlation_id()))
    for name, corr in kernels:
        owner, at = None, launch_at.get(corr)
        if at is not None:
            holding = [r for r in ranges if r[0] <= at <= r[1]]
            if holding:
                owner = min(holding, key=lambda r: r[1] - r[0])[2]
        ks = out[owner]["kernels"]
        ks[name] = ks.get(name, 0) + 1
    return out


class Telemetry:
    """One registry + one tracer (no-op unless ``trace=True``), the
    object the engine hangs off ``self.tel``; ``annotate=True`` adds the
    profiler ranges (:meth:`Tracer.annotation`)."""

    def __init__(self, *, trace: bool = False, annotate: bool = False,
                 max_events: int = 1_000_000):
        self.registry = MetricsRegistry()
        self.tracer = (Tracer(max_events=max_events, annotate=annotate)
                       if trace else NULL_TRACER)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.reset()

    def dump_trace(self, path: str) -> str:
        if not self.tracer.enabled:
            raise ValueError(
                "tracing is disabled on this engine; construct it with "
                "telemetry=Telemetry(trace=True) to record a timeline")
        return self.tracer.dump(path)


def config_fingerprint(config: Dict) -> str:
    """Stable short hash of a benchmark's config dict, so a trajectory
    can tell "the number moved" from "the experiment moved"."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_bench_artifact(path: str, *, bench: str, config: Dict,
                         metrics: Dict, gates: Optional[Dict] = None,
                         extra: Optional[Dict] = None) -> str:
    """The one writer of benchmark artifacts: schema version, config
    fingerprint, and the gate thresholds the benchmark asserts recorded
    beside the metrics they bound."""
    art = {
        "schema_version": BENCH_SCHEMA_VERSION,
        "bench": bench,
        "config": config,
        "config_fingerprint": config_fingerprint(config),
        "gates": dict(gates or {}),
        "metrics": metrics,
    }
    for k, v in (extra or {}).items():
        if k in art:
            raise ValueError(f"extra key {k!r} collides with the "
                             "artifact schema")
        art[k] = v
    with open(path, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


#: every key ``ServeEngine.stats()`` returns on a paged engine without
#: speculation — the JAX package's ``STATS_KEYS_ENGINE`` (a stacked engine
#: reports ``slots_in_use`` / ``slots_in_use_peak`` / ``n_free_slots`` in
#: place of the six page-pool keys, as the reference's does)
STATS_KEYS_ENGINE = frozenset({
    "ticks", "model_calls", "prefill_calls", "stalled",
    "stalled_queued", "stalled_in_flight", "tokens_per_model_call",
    "requests", "mean_ttft_s", "mean_tok_latency_s",
    "p50_ttft_s", "p99_ttft_s", "p50_tpot_s", "p99_tpot_s",
    "tick_p50_ms", "tick_p99_ms",
    "decode_modeled_s", "decode_measured_s",
    "prefill_modeled_s", "prefill_measured_s",
    "mdk_mp_reuse",
    # request lifecycle: preemption / restore / cancel counters and the
    # evicted-bytes footprint
    "preemptions", "preempt_host", "preempt_recompute", "restores",
    "cancelled", "evicted_bytes_total", "evicted_bytes_p99",
    "pages_in_use", "pages_in_use_peak", "pages_allocated_total",
    "prefix_hit_pages", "n_free_pages", "cached_free_pages",
})

#: the keys a ``spec=SpecConfig(...)`` engine reports — the JAX package's
#: ``STATS_KEYS_ENGINE_SPEC``
STATS_KEYS_ENGINE_SPEC = STATS_KEYS_ENGINE | frozenset({
    "spec_ticks", "spec_proposed", "spec_accepted", "spec_emitted",
    "acceptance_rate", "tokens_per_verify_call", "draft_calls",
    "spec_accept_len_p50", "spec_accept_len_p99",
    "verify_touched_positions", "verify_dense_positions",
})

#: every key ``DistributedServeEngine.stats()`` returns (paged, no
#: speculation) once both of its phases, ticks with prefill work and
#: pure-decode ticks, have occurred — the JAX package's
#: ``STATS_KEYS_DISTRIBUTED``
STATS_KEYS_DISTRIBUTED = (
    STATS_KEYS_ENGINE - {"tokens_per_model_call"}) | frozenset({
    "n_shards", "decode_waves", "mean_device_utilization",
    "wave_occupancy_mean", "wave_occupancy_p50", "wave_imbalance",
    "migrations", "migrated_bytes_total",
    "transfers", "transfers_hidden", "transfers_exposed",
    "transfer_bytes", "transfer_bytes_hidden", "transfer_bytes_exposed",
    "max_transfer_bytes", "overlap_ratio", "byte_overlap_ratio",
    "transfers_prefill", "transfers_exposed_prefill",
    "overlap_ratio_prefill",
    "transfers_drain", "transfers_exposed_drain", "overlap_ratio_drain",
})
