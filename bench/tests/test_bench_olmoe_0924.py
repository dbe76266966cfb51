"""A tiny ``olmoe-1b-7b-0924`` cell added to the copy by files and index
entries alone (its published routing and expert precision: top 8 of 64
experts, raw gates, bf16 experts, at a small width), driven through the
whole run on the CPU, and its family's MoE FFN held against the port's.

On the CPU the port's plain attention rounds its probabilities to bf16
and W8A8 re-quantizes every projection's input, so the served logits
part from the reference's by about what int8 experts move them: no
limit on the served tokens tells the ``int8_experts`` control from the
program here (nor on the card at full width, where routing near-ties
move sound runs' mean gap about as far).  So the int8 control is held at
the FFN, where the port's bf16 products equal the family's bit for bit
and the control lies a precision below."""
import json

import pytest
import torch

import bench_tiny
from bench_tiny import run_tiny

CONFIG, CELL = "tiny-olmoe-0924", "tiny-olmoe-0924.tiny"
#: the tiny cell's limit on the widest logit gap.  Read on the CPU over
#: seeds 11-14 and 2**31 + 7: sound 0 to 0.0066, the int4 control 0.92
#: to 1.63, the int8-expert control 0 to 0.024
LIMIT = 0.3
#: the tiny width: the port's ``.reduced()`` attention, 64 experts of 32
SMALL = {"name": CONFIG, "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 512}


#: the accepted metrics whose readers apply to the cell unchanged
SHARED = ("device_us_per_token", "output_tok_s.host", "ttft_p95_s.host",
          "tpot_p95_ms.host", "tick_ms", "decode_rows_mean",
          "host_ms.decode", "host_ms.prefill", "mp_matmul_roofline",
          "paged_mha_decode_roofline", "paged_verify_roofline",
          "device_idle_share", "device_share.quant_act", "device_share.norm",
          "device_share.attn", "device_share.head", "device_share.sample",
          "device_share.unranged", "idle_share.quant_act",
          "syncs_per_decode_step")
#: the MoE FFN's metrics (``bench/metrics``), as an index entry lists them
NEW = tuple((f"device_share.moe.{s}", "%", "lower", "device_trace",
             "MoE FFN") for s in ("route", "dispatch", "experts", "combine")
            ) + (("idle_share.moe", "%", "lower", "device_trace", "MoE FFN"),
                 ("moe_rows_per_routed", "rows", "lower", "program_counter",
                  "MoE FFN"),
                 ("moe_ffn_roofline", "%", "higher", "device_trace",
                  "MoE FFN"),
                 ("step_mfu.moe", "%", "higher", "host_clock",
                  "model step"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = bench_tiny.tiny_copy(tmp_path_factory.mktemp("bench"))
    bench = root / "bench"
    conf = json.loads((bench / "configs" / "olmoe-1b-7b-0924.json")
                      .read_text())
    conf["model"].update(SMALL)
    conf["serving"].update(max_seq=128, calibration={"tokens": 32})
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(conf))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"name": CELL, "slots": 4,
         "check": {"min_tokens": 40, "max_requests": 6,
                   "limits": {"logit_gap": LIMIT}}}))
    index = json.loads((root / "BENCHMARK.json").read_text())
    index["configs"].append({"name": CONFIG, "source": "test",
                             "file": f"bench/configs/{CONFIG}.json",
                             "reduced": [], "why": "CPU tests"})
    index["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU tests"})
    listed = {m["name"]: m for m in index["end_to_end"] + index["per_layer"]}
    for name in SHARED:
        listed[name]["workloads"].append(CELL)
    for name, unit, better, source, layer in NEW:
        if name in listed:  # the full-width cell's entry
            listed[name]["workloads"].append(CELL)
            continue
        index["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "device_us_per_token",
            "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(index))
    return root


def test_reference_agrees_with_the_port_and_the_int4_control_does_not(
        root):
    """The port's paged prefill-then-decode serves tokens the reference
    puts first, to a near-tie; the int4 control reads a gap past the
    limit and three times the program's; the int8-expert control is read
    beside it."""
    c, out = run_tiny(root, CELL, controls=["int8_experts", "int4"])
    g = out["gaps"]
    assert c.config["model"]["expert_dtype"] == "bfloat16"
    assert c.config["model"]["norm_topk_prob"] is False
    assert out["sampled_tokens"] >= 40
    assert g["logit_gap"] <= LIMIT
    assert g["control.logit_gap.int4"] > LIMIT
    assert g["control.logit_gap.int4"] > 3 * g["logit_gap"]
    assert {"control.logit_gap.int8_experts",
            "control.mean_gap.int8_experts"} <= set(g)
    assert all(v <= lim for v, lim in out["checks"].values())


def _family(root):
    import sys

    ref = str(root / "bench" / "reference")
    if ref not in sys.path:
        sys.path.insert(0, ref)
    import olmoe_0924

    return olmoe_0924


def test_the_port_ffn_equals_the_family_and_int8_experts_lie_below(root):
    """On one layer's weights from the seed: the port's ``moe_apply`` on
    the served tree (banks converted once) equals the family's ``moe``
    in the stated bf16, bit for bit; the family asked for float32 (no
    control) takes the stated dtype; its int8 experts lie further from
    float32 experts than bf16 ones do, and its float8 experts further
    than int8 ones, each by more than twice the root mean square."""
    from harness import runner, weights
    from repro_torch.models import moe
    from repro_torch.serving import quantize

    fam = _family(root)
    conf = json.loads((root / "bench" / "configs" / f"{CONFIG}.json")
                      .read_text())
    model = conf["model"]
    cfg = runner.model_config(model)
    w = weights.make(model, 128, 2 ** 31 + 7, "cpu")
    p = w["layers"][0]["moe"]
    h = torch.randn((40, model["d_model"]),
                    generator=torch.Generator().manual_seed(5))
    served = quantize.serve_experts(w, cfg, torch.float32)
    got = moe.moe_apply(served["layers"][0]["moe"], h[None], cfg)[0][0]
    f32 = torch.float32

    def ref(ed):
        return fam.moe(p, h, model, f32, fam.experts_dtype(model, ed, f32))

    assert fam.experts_dtype(model, f32, f32) == torch.bfloat16
    assert torch.equal(got, ref(f32))
    exact = fam.moe(p, h, model, f32, f32)

    def rms(ed):
        return float((ref(ed) - exact).square().mean().sqrt())

    # 2.5-2.8x here over seeds 1-3 and 2**31 + 7; 4.5x at d 2,048
    assert 0 < 2 * rms(f32) < rms(torch.int8)
    # 3.6-4.3x here over seeds 1, 2 and 2**31 + 7; 2.3-2.4x at d 2,048
    assert 2 * rms(torch.int8) < rms(torch.float8_e4m3fn)


def test_a_traced_run_reads_the_moe_metrics_it_can_on_the_cpu(
        root, monkeypatch):
    """The host's metrics and the program's counters read on the CPU
    (``moe_rows_per_routed`` is E, exact capacity's padding); the device
    metrics need the card."""
    from repro_torch.serving import telemetry

    # this run's counts alone, whatever ran before in the process
    monkeypatch.setattr(telemetry, "_counted", {})
    c, out = run_tiny(root, CELL, trace=True)
    line = bench_tiny.result_line(c, out, True)
    got = line["metrics"]
    assert line["correct"] is True
    assert got["moe_rows_per_routed"]["value"] == 64.0
    assert {"step_mfu.moe", "tick_ms", "host_ms.decode"} <= set(got)
    for name in ("device_share.moe.experts", "idle_share.moe",
                 "moe_ffn_roofline"):
        assert name in {m["name"] for m in c.per_layer}
        assert name not in got


def test_the_index_runs_the_configuration_in_its_chat_cell():
    """``BENCHMARK.json`` runs the configuration in its stated form in one
    cell on one chip, with both end-to-end metrics, the MoE FFN's metrics
    and a limit on the widest and on the mean gap; every metric it lists
    there has a reader, and none that prices or reads what the
    configuration lacks (float32 experts, a GELU, a tied head)."""
    from harness import spec

    c = spec.cell("olmoe-1b-7b-0924.chat", root=bench_tiny.ROOT)
    assert c.chips == 1 and c.workload["slots"] == 32
    assert c.config["model"]["expert_dtype"] == "bfloat16"
    assert c.config["model"]["norm_topk_prob"] is False
    assert set(c.config["controls"]) == {"int8_experts", "fp8_experts",
                                         "int4"}
    assert {m["name"] for m in c.end_to_end} == {"device_us_per_token",
                                                 "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert {n for n, *_ in NEW} <= names
    assert not names & {"step_mfu", "device_share.mlp_act",
                        "device_share.head"}
    for n in names:
        assert (c.bench / "metrics" / f"{n}.py").exists()
    assert set(c.workload["check"]["limits"]) == {"logit_gap", "mean_gap"}
