"""The closed-loop generator and the window's arithmetic."""
import time
import types

import pytest

import bench_tiny  # noqa: F401  (puts the harness on the path)
from harness import spec, stats

gen = spec.load_module(bench_tiny.ROOT / "bench" / "traffic"
                       / "closed_loop.py")
MIX = {"clients": 3, "per_client": 5, "prompt_len": [8, 64],
       "output_len": [4, 40]}


def test_closed_loop_is_deterministic_per_seed():
    a = gen.requests(MIX, 2 ** 31 + 11, 1000)
    assert a == gen.requests(MIX, 2 ** 31 + 11, 1000)
    assert a != gen.requests(MIX, 2 ** 31 + 12, 1000)


def test_every_seed_serves_the_same_sizes_in_the_same_order():
    def sizes(seed):
        return [(len(p), n) for c in gen.requests(MIX, seed, 1000)
                for p, n in c]

    one = sizes(1)
    assert one == sizes(987654321987)
    lens = [p for p, _ in one]
    assert min(lens) >= 8 and max(lens) <= 64
    assert len(set(lens)) > 5  # log-uniform quantiles, not one length


class FakeEngine:
    """One token per live request a tick, a request per slot."""

    def __init__(self, slots, stall_at=None, stall_s=0.0):
        self.slots = [None] * slots
        self.queue, self.finished = [], []
        self.n, self.ticks = 0, 0
        self.stall_at, self.stall_s = stall_at, stall_s
        self.clock = 0.0

    def submit(self, prompt, max_new):
        r = types.SimpleNamespace(rid=self.n, prompt=prompt, out=[],
                                  max_new=max_new, t_submit=self.clock,
                                  t_first=None, t_done=None)
        self.n += 1
        self.queue.append(r)
        return r.rid

    def tick(self):
        self.ticks += 1
        self.clock += 0.01 + (self.stall_s if self.ticks == self.stall_at
                              else 0.0)
        for i, r in enumerate(self.slots):
            if r is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.out.append(1)
            if r.t_first is None:
                r.t_first = self.clock
            if len(r.out) >= r.max_new:
                r.t_done = self.clock
                self.finished.append(r)
                self.slots[i] = None


def _window(stall_at):
    eng = FakeEngine(3, stall_at=stall_at, stall_s=1.0)
    loop = gen.ClosedLoop(eng, gen.requests(MIX, 5, 1000))
    loop.start()
    while not loop.all_started():
        loop.tick()
    t0, e0 = eng.clock, loop.emitted()
    for _ in range(200):
        loop.tick()
    reqs = [{"t_submit": r.t_submit, "t_first": r.t_first,
             "t_done": r.t_done, "n_out": len(r.out)}
            for r in eng.finished + [r for r in eng.slots if r]]
    w = types.SimpleNamespace(t0=t0, t1=eng.clock, requests=reqs,
                              d={"emitted": loop.emitted() - e0},
                              seconds=eng.clock - t0)
    return types.SimpleNamespace(host=w)


@pytest.mark.parametrize("metric", ["output_tok_s", "tpot_p95_ms"])
def test_a_planted_stall_moves_the_window_metrics(metric):
    read = spec.load_module(bench_tiny.ROOT / "bench" / "metrics"
                            / f"{metric}.py").read
    calm, stalled = read(_window(None)), read(_window(100))
    if metric == "output_tok_s":
        assert stalled < 0.75 * calm
    else:
        assert stalled > 3 * calm


def test_percentiles_take_every_request():
    w = types.SimpleNamespace(t0=0.0, t1=10.0, requests=[
        {"t_submit": 1.0, "t_first": 1.1 + (5.0 if i == 19 else 0.0),
         "t_done": 2.0 + (5.0 if i == 19 else 0.0), "n_out": 11}
        for i in range(20)])
    ttft = stats.ttft_s(w)
    assert len(ttft) == 20
    # 19 at 0.1 s and one at 5.1 s: the 95th percentile lies between them
    assert stats.percentile(ttft, 95) == pytest.approx(0.1 + 0.05 * 5.0)
    assert stats.percentile([], 95) is None


def test_the_device_cost_takes_every_token_of_the_window():
    """The device's cost per token is the window's whole busy time over
    every token it emitted; a window with no device trace reads nothing."""
    read = spec.load_module(bench_tiny.ROOT / "bench" / "metrics"
                            / "device_us_per_token.py").read

    def run(busy_s, tokens):
        return types.SimpleNamespace(host=types.SimpleNamespace(
            d={"emitted": tokens}, busy_s=busy_s))

    assert read(run(2.0, 4000)) == pytest.approx(500.0)
    assert read(run(4.0, 4000)) == pytest.approx(1000.0)
    assert read(run(None, 4000)) is None


def test_a_device_traced_window_ticks_in_parts(monkeypatch):
    """An untraced window whose cell reads the device ticks in parts of at
    most ``DEVICE_PART_S`` under the tracer, and adds up their busy and
    ticking time; a part whose trace spans too little of it
    is refused."""
    import contextlib

    import torch.profiler
    from harness import runner, trace

    parts = []

    @contextlib.contextmanager
    def fake_profile(activities):
        yield types.SimpleNamespace()

    def tick_for(loop, seconds):
        parts.append(seconds)
        return time.monotonic() + seconds

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(runner, "_tick_for", tick_for)
    monkeypatch.setattr(trace, "device_busy", lambda prof: {
        "busy_s": 0.25, "n_device": 10, "span_s": 4.9})
    out = runner._ticking(None, 12.0, True)
    assert len(parts) == 3 and max(parts) <= runner.DEVICE_PART_S
    assert out["busy_s"] == pytest.approx(0.75)
    assert out["tick_s"] == pytest.approx(12.0, abs=0.05)
    assert len(out["parts"]) == 3
    parts.clear()
    assert runner._ticking(None, 12.0, False)["busy_s"] is None
    assert len(parts) == 1
    with pytest.raises(RuntimeError, match="stopped recording"):
        trace.check_covered({"span_s": 1.0, "wall_s": 4.0, "n_device": 3})
