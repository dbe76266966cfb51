"""The readers of the program's stage ranges (``device_share.*``,
``idle_share.quant_act``, ``syncs_per_decode_step``) on a hand-built
summary of a profiled part, as ``harness.trace.read`` makes one: each
reads its value, and nothing where the run was not profiled or the
program opened no such range (a parent without the ranges; the CPU's
tiny cells, whose profile holds no device activity)."""
from types import SimpleNamespace

import pytest

import bench_tiny
from harness.spec import load_module

METRICS = bench_tiny.ROOT / "bench" / "metrics"


def _range(device_s, launches=1):
    return {"device_s": device_s, "launches": launches}


#: a profiled part of 2 s in which the device was busy 0.5 s
PROF = {
    "busy_s": 0.5, "window_s": 2.0, "n_device": 40,
    "ranges": {
        "model.quant_act": _range(0.1), "model.norm": _range(0.05),
        "model.attn": _range(0.02), "model.mlp_act": _range(0.01),
        "model.head": _range(0.04), "engine.sample": _range(0.005),
        "engine.sync": _range(0.001, launches=30),
        "bench.quant_matmul": _range(0.2), "bench.paged_mha_decode":
        _range(0.04), "decode.step": _range(0.015), None: _range(0.015)},
    "idle": {"model.quant_act / aten::mul": 0.3,
             "model.quant_act / no operator": 0.1,
             "model.norm / aten::mean": 0.2,
             "decode.step / no operator": 0.5},
}
CALLS = [{"kind": "decode"}] * 3 + [{"kind": "prefill"}] * 2

#: all device time: the sum of the ranges'
TOTAL = sum(r["device_s"] for r in PROF["ranges"].values())

CASES = {
    "device_share.quant_act": 20.0, "device_share.norm": 10.0,
    "device_share.attn": 4.0, "device_share.mlp_act": 2.0,
    "device_share.head": 8.0, "device_share.sample": 1.0,
    "device_share.unranged": 100.0 * 0.03 / TOTAL,
    "idle_share.quant_act": 20.0, "syncs_per_decode_step": 10.0,
}

#: the range each reader reads, which a run without it lacks
READS = {name: f"model.{name.split('.')[1]}" for name in CASES
         if name.startswith(("device_share.", "idle_share."))}
READS.update({"device_share.sample": "engine.sample",
              "syncs_per_decode_step": "engine.sync"})
del READS["device_share.unranged"]


def _run(prof, calls=CALLS):
    return SimpleNamespace(prof=prof, prof_calls=calls)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_stage_reader_reads_its_range_and_nothing_without_it(name):
    read = load_module(METRICS / f"{name}.py").read
    assert read(_run(PROF)) == pytest.approx(CASES[name])
    assert read(_run(None)) is None
    if name in READS:
        gone = dict(PROF, ranges={k: v for k, v in PROF["ranges"].items()
                                  if k != READS[name]})
        assert read(_run(gone)) is None
    # a parent's profile: the benchmark's kernel ranges and the engine's
    # dispatch ranges, no stage of the program
    parent = dict(PROF, ranges={k: v for k, v in PROF["ranges"].items()
                                if not k or not k.startswith(
                                    ("model.", "engine."))})
    assert read(_run(parent)) is None
    # the CPU's profile: host events only
    cpu = dict(PROF, busy_s=0.0, n_device=0, ranges={}, idle={})
    assert read(_run(cpu)) is None
    if name == "syncs_per_decode_step":
        assert read(_run(PROF, calls=CALLS[3:])) is None
