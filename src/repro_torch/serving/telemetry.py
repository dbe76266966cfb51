"""Telemetry for the serving engine: a metrics registry and a span tracer.

  * :class:`MetricsRegistry` — counters, gauges (with high-water marks)
    and fixed-bucket streaming histograms (no unbounded value lists).
    The engine's schedule counters are plain attributes backed by
    registry counters (:class:`registry_counter`), and its TTFT / TPOT /
    tick-wall aggregates come from histograms.
  * :class:`Tracer` — tick/stage spans and request instants, exported as
    Chrome/Perfetto trace-event JSON.  The default :data:`NULL_TRACER`
    is a no-op whose methods allocate nothing; call sites build span
    arguments only under ``tracer.enabled``.  Spans are host time and
    never synchronize the device, so on the card a span measures dispatch
    plus host work, not kernel time.

``STATS_KEYS_ENGINE`` documents exactly what ``ServeEngine.stats()``
returns, and ``STATS_KEYS_ENGINE_SPEC`` what it returns with
speculation (plus ``adaptive_slots`` and ``adaptive_cap_mean`` under
adaptive draft sizing).
"""
from __future__ import annotations

import json
import math
import time
from bisect import bisect_right
from collections import deque
from typing import Dict, List, Optional

#: Chrome trace-event tracks
TID_ENGINE = 0
TID_REQUEST = 2
_TID_NAMES = {TID_ENGINE: "engine", TID_REQUEST: "requests"}


class Counter:
    """A resettable scalar; ``value`` is a plain attribute so hot paths
    ``+=`` it through :class:`registry_counter`."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

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
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Records one complete ("X") trace event."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "t0")

    def __init__(self, tracer, name, cat, tid, args):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.tid, self.args = tid, args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tracer
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

    def reset(self):
        return None


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Recording tracer: a bounded event ring exported as Chrome JSON."""

    enabled = True
    __slots__ = ("_t0", "_events")

    def __init__(self, *, max_events: int = 1_000_000):
        self._t0 = time.perf_counter()
        self._events = deque(maxlen=max_events)

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

    def reset(self) -> None:
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


class Telemetry:
    """One registry + one tracer (no-op unless ``trace=True``), the
    object the engine hangs off ``self.tel``."""

    def __init__(self, *, trace: bool = False, max_events: int = 1_000_000):
        self.registry = MetricsRegistry()
        self.tracer = Tracer(max_events=max_events) if trace else NULL_TRACER

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.reset()

    def dump_trace(self, path: str) -> str:
        if not self.tracer.enabled:
            raise ValueError(
                "tracing is disabled on this engine; construct it with "
                "telemetry=Telemetry(trace=True) to record a timeline")
        with open(path, "w") as f:
            json.dump(self.tracer.to_chrome(), f)
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
