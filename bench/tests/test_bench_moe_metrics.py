"""The MoE FFN's readers and rooflines: ``device_share.moe.*``,
``idle_share.moe``, ``moe_ffn_roofline`` and ``step_mfu.moe`` on
hand-built runs, as ``harness.trace.read`` and ``harness.probes`` make
them; ``moe_rows_per_routed`` on the program's counters; the bf16-expert
rooflines against hand counts.  Each reader reads its value, and nothing
where the run was not profiled, the program opened no such range (a
parent without the stages; the CPU's tiny cells, whose profile holds no
device activity) or counted nothing."""
from types import SimpleNamespace

import pytest

import bench_tiny
from harness import peaks, spec

METRICS = bench_tiny.ROOT / "bench" / "metrics"
RF = bench_tiny.ROOT / "bench" / "rooflines"


def metric(name):
    return spec.load_module(METRICS / f"{name}.py").read


def roofline(name):
    return spec.load_module(RF / f"{name}.py")


def _range(device_s, launches=1):
    return {"device_s": device_s, "launches": launches}


#: a profiled part of 2 s in which the device was busy 0.8 s
PROF = {
    "busy_s": 0.8, "window_s": 2.0, "n_device": 90,
    "ranges": {
        "model.moe.route": _range(0.04), "model.moe.dispatch": _range(0.02),
        "model.moe.experts": _range(0.4), "model.moe.combine": _range(0.06),
        "bench.moe_apply": _range(0.08), "model.attn": _range(0.1),
        "bench.quant_matmul": _range(0.1), None: _range(0.0)},
    "idle": {"model.moe.route / aten::topk": 0.1,
             "model.moe.experts / no operator": 0.2,
             "model.attn / no operator": 0.5},
}

MODEL = {"d_model": 8, "n_layers": 2, "vocab_size": 16, "n_heads": 2,
         "n_kv_heads": 2, "head_dim": 4, "d_ff": 4, "n_experts": 8,
         "experts_per_token": 2, "activation": "swiglu", "pos": "rope",
         "tie_embeddings": False}

SHARES = {"device_share.moe.route": 5.0, "device_share.moe.dispatch": 2.5,
          "device_share.moe.experts": 50.0,
          "device_share.moe.combine": 7.5, "idle_share.moe": 15.0}


def _run(prof, kernels=(), calls=(), seconds=2.0):
    cell = SimpleNamespace(roofline=roofline)
    return SimpleNamespace(
        prof=prof, prof_kernels=list(kernels), calls=list(calls), cell=cell,
        model=MODEL, serving={"max_seq": 64, "page_size": 8},
        host=SimpleNamespace(seconds=seconds))


def _without(prof, prefix):
    return dict(prof, ranges={k: v for k, v in prof["ranges"].items()
                              if not k or not k.startswith(prefix)})


#: the CPU's profile: host events only
CPU = dict(PROF, busy_s=0.0, n_device=0, ranges={}, idle={})


@pytest.mark.parametrize("name", sorted(SHARES))
def test_a_moe_stage_reader_reads_its_range_and_nothing_without_it(name):
    read = metric(name)
    assert read(_run(PROF)) == pytest.approx(SHARES[name])
    assert read(_run(None)) is None
    assert read(_run(CPU)) is None
    # a parent's profile: the benchmark's ``bench.moe_apply``, no stage
    assert read(_run(_without(PROF, "model.moe."))) is None
    if name.startswith("device_share."):
        own = "model.moe." + name.rsplit(".", 1)[1]
        gone = dict(PROF, ranges={k: v for k, v in PROF["ranges"].items()
                                  if k != own})
        assert read(_run(gone)) is None


def test_moe_ffn_roofline_sums_its_calls_over_the_ffn_ranges():
    """The calls' least times (``moe_ffn_bf16``) over the device time in
    ``bench.moe_apply`` and every ``model.moe.*`` range nested in it."""
    read = metric("moe_ffn_roofline")
    recs = [{"kernel": "moe_apply", "T": 4, "phase": "profiled"},
            {"kernel": "moe_apply", "T": 1, "phase": "profiled"},
            {"kernel": "quant_matmul", "M": 4, "phase": "profiled"}]
    cost = roofline("moe_ffn_bf16").cost
    bound = sum(peaks.bound_s(c["ops"], c["bytes"])
                for c in (cost(4, 8, 4, 8, 2), cost(1, 8, 4, 8, 2)))
    device_s = 0.04 + 0.02 + 0.4 + 0.06 + 0.08
    assert read(_run(PROF, recs)) == pytest.approx(100.0 * bound / device_s)
    assert read(_run(None, recs)) is None
    assert read(_run(PROF, recs[2:])) is None  # no FFN call recorded
    assert read(_run(_without(PROF, "bench."), recs)) is None
    assert read(_run(CPU, recs)) is None


def test_step_mfu_moe_prices_the_host_window_with_bf16_experts():
    read = metric("step_mfu.moe")
    calls = [{"kind": "decode", "rows": 2, "lengths": [3, 0]},
             {"kind": "prefill", "start": 8, "C": 4, "valid": 4}]
    step = roofline("decoder_step_bf16_experts")
    want = sum(step.bound_s(MODEL, c, max_seq=64, page_size=8)
               for c in calls)
    assert read(_run(PROF, calls=calls, seconds=3.0)) == pytest.approx(
        100.0 * want / 3.0)
    assert read(_run(PROF)) is None


def test_moe_rows_per_routed_reads_the_programs_counters(monkeypatch):
    from repro_torch.serving import telemetry

    read = metric("moe_rows_per_routed")
    monkeypatch.setattr(telemetry, "counted", lambda: {
        "moe.rows_computed": 64 * 256 * 16, "moe.rows_routed": 256 * 16})
    assert read(_run(None)) == 64.0
    monkeypatch.setattr(telemetry, "counted", lambda: {})
    assert read(_run(None)) is None  # untraced, or no MoE: nothing counted
    monkeypatch.delattr(telemetry, "counted")  # a parent without counters
    assert read(_run(None)) is None


def test_moe_ffn_bf16():
    c = roofline("moe_ffn_bf16").cost(2, 2, 3, 4, 1, gated=True)
    assert c["ops"] == {"bf16": 2.0 * 2 * 1 * 2 * 3 * 3,
                        "fp32": 2.0 * 2 * 2 * 4}
    # 4 (1 - 3/4 ** 2) = 1.75 experts touched of 3 banks of 2 x 3 at
    # 2 bytes, the float32 router (2 x 4), tokens in and out at 4
    assert c["bytes"] == pytest.approx(2 * 1.75 * 18 + 4 * 8 + 2 * 4 * 4)
    rf = roofline("moe_ffn_bf16")
    assert rf.touched(1, 64, 8) == pytest.approx(8.0)
    assert rf.touched(32, 64, 8) == pytest.approx(
        64 * (1 - (56 / 64) ** 32))
    plain = rf.cost(3, 4, 5, 6, 2, gated=False, x_bytes=2)
    assert plain["ops"]["bf16"] == 2.0 * 3 * 2 * 4 * 5 * 2
    assert plain["bytes"] == pytest.approx(
        2 * rf.touched(3, 6, 2) * 2 * 20 + 4 * 24 + 2 * 2 * 3 * 4)


@pytest.mark.parametrize("call", [
    {"kind": "decode", "rows": 2, "lengths": [3, 0]},
    {"kind": "prefill", "start": 8, "C": 4, "valid": 4}],
    ids=["decode", "prefill"])
def test_decoder_step_bf16_experts_sums_its_parts(call):
    """The parts by hand (the kernels' own cost functions), their sum, and
    ``decoder_step``'s total with its float32 FFN swapped for the bf16
    one; a dense stack prices as ``decoder_step`` does."""
    step, old = roofline("decoder_step_bf16_experts"), roofline(
        "decoder_step")
    mp = roofline("mp_matmul")
    parts = step.parts(MODEL, call, max_seq=64, page_size=8)
    M = call.get("rows", call.get("C"))
    if call["kind"] == "decode":
        attn = roofline("paged_mha_decode").cost([4, 1], 2, 2, 4, 8)
        head = mp.cost(2, 8, 16)
    else:
        attn = roofline("paged_verify").cost(8, 4, 2, 2, 4, 8)
        head = mp.cost(1, 8, 16)
    ffn = roofline("moe_ffn_bf16").cost(M, 8, 4, 8, 2)
    lin = mp.cost(M, 8, 8)
    assert parts["linears"]["ops"] == {"int8": 2 * 4 * lin["ops"]["int8"]}
    assert parts["linears"]["bytes"] == 2 * 4 * lin["bytes"]
    assert parts["attention"]["bytes"] == 2 * attn["bytes"]
    assert parts["ffn"]["ops"] == {p: 2 * n for p, n in ffn["ops"].items()}
    assert parts["ffn"]["bytes"] == pytest.approx(2 * ffn["bytes"])
    assert parts["head"] == head
    assert parts["embed"] == {"ops": {}, "bytes": 4.0 * M * 8}
    got = step.cost(MODEL, call, max_seq=64, page_size=8)
    for p in ("int8", "bf16", "fp32"):
        assert got["ops"].get(p, 0.0) == pytest.approx(
            sum(x["ops"].get(p, 0.0) for x in parts.values()))
    assert got["bytes"] == pytest.approx(
        sum(x["bytes"] for x in parts.values()))
    f32 = roofline("moe_ffn").cost(M, 8, 4, 8, 2)
    want = old.cost(MODEL, call, max_seq=64, page_size=8)
    assert got["bytes"] == pytest.approx(
        want["bytes"] + 2 * (ffn["bytes"] - f32["bytes"]))
    assert got["ops"]["bf16"] == pytest.approx(
        want["ops"].get("bf16", 0.0) + 2 * ffn["ops"]["bf16"])
    assert step.bound_s(MODEL, call, max_seq=64, page_size=8) == \
        peaks.bound_s(got["ops"], got["bytes"])
    dense = dict(MODEL, n_experts=0, experts_per_token=0, d_ff=16)
    a = step.cost(dense, call, max_seq=64, page_size=8)
    b = old.cost(dense, call, max_seq=64, page_size=8)
    assert a["ops"] == pytest.approx(b["ops"])
    assert a["bytes"] == pytest.approx(b["bytes"])
