"""Tiny cells driven through the whole run on the CPU: the reference
against the port's eager path, the control and planted faults failing
the check, the result line, and a cell added by files alone."""
import json

import pytest
import torch

import bench_tiny
from bench_tiny import run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-gpt2.tiny", "tiny-olmoe.tiny"])
def test_reference_agrees_with_the_port_and_the_control_does_not(root,
                                                                 cell):
    """The port's CPU eager path serves tokens the reference puts first
    (to a near-tie); the int4 control, put in the program's place, reads
    a gap past the limit and three times the program's.  The bf16
    control (the float path a precision lower) is read beside it."""
    c, out = run_tiny(root, cell, controls=["int4", "bf16"])
    gap, ctl = out["gaps"]["logit_gap"], out["gaps"]["control.logit_gap.int4"]
    assert {"mean_gap", "off_share", "control.mean_gap.bf16",
            "control.off_share.bf16"} <= set(out["gaps"])
    limit = bench_tiny.TINY[cell.split(".")[0]][2]
    assert out["sampled_tokens"] >= 40
    assert gap <= limit
    assert ctl > limit and ctl > 3 * gap
    assert all(v <= lim for v, lim in out["checks"].values())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, trace):
    c, out = run_tiny(root, "tiny-gpt2.tiny", trace=trace)
    line = bench_tiny.result_line(c, out, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    json.dumps(line, allow_nan=False)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    got = set(line["metrics"])
    assert got <= want
    if trace:
        # device metrics need the card; the host's are read on the CPU
        assert {"tick_ms", "decode_rows_mean", "host_ms.decode",
                "step_mfu"} <= got
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    else:
        # a window traced on the device needs the card
        on_card = {m["name"] for m in c.end_to_end
                   if m["source"] == "device_trace"}
        assert got == want - on_card - {"ttft_p95_s", "tpot_p95_ms"} \
            or got == want - on_card
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def _token_fault(monkeypatch):
    from repro_torch.serving import sampler

    orig, calls = sampler.sample_batch, [0]

    def altered(logits, *a, **kw):
        out = orig(logits, *a, **kw)
        calls[0] += 1
        if calls[0] % 5 == 0:
            out = out.clone()
            out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(sampler, "sample_batch", altered)


def _state_fault(monkeypatch):
    from repro_torch.models import attention

    orig = attention.paged_decode_attention

    def unwritten(p, x, cfg, k_pages, v_pages, *a, **kw):
        out, _, _ = orig(p, x, cfg, k_pages.clone(), v_pages.clone(), *a,
                         **kw)
        return out, k_pages, v_pages

    monkeypatch.setattr(attention, "paged_decode_attention", unwritten)


@pytest.mark.parametrize("fault", [_token_fault, _state_fault],
                         ids=["token_altered", "state_unchanged"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    """The harness's look for a chip skipped, the rest of a run driven
    with the timed path broken: a token altered where it is produced, a
    decode step that leaves the cache unchanged."""
    fault(monkeypatch)
    c, out = run_tiny(root, "tiny-gpt2.tiny")
    line = bench_tiny.result_line(c, out, False)
    assert line["correct"] is False
    assert out["checks"]["logit_gap"][0] > bench_tiny.TINY["tiny-gpt2"][2]


def test_a_cell_metric_and_mix_are_added_by_files_alone(root):
    """A new mix, cell and per-layer metric in a copy: files and index
    entries, no edit of an existing file."""
    bench = root / "bench"
    (bench / "traffic" / "tiny2.json").write_text(json.dumps(
        {"generator": "closed_loop", "clients": 2, "per_client": 4,
         "prompt_len": [4, 16], "output_len": [2, 6]}))
    (bench / "workloads" / "tiny-gpt2.tiny2.json").write_text(json.dumps(
        {"name": "tiny-gpt2.tiny2", "slots": 2,
         "check": {"min_tokens": 8, "max_requests": 4,
                   "limits": {"logit_gap": 0.05}}}))
    (bench / "metrics" / "ticks_seen.py").write_text(
        "def read(run):\n    return run.host.d['ticks']\n")
    index = json.loads((root / "BENCHMARK.json").read_text())
    index["workloads"].append({"name": "tiny-gpt2.tiny2",
                               "config": "tiny-gpt2", "traffic": "tiny2",
                               "chips": 1, "why": "added by files"})
    index["per_layer"].append({"name": "ticks_seen", "unit": "ticks",
                               "better": "higher", "source":
                               "program_counter", "layer": "engine tick",
                               "moves": "output_tok_s",
                               "workloads": ["tiny-gpt2.tiny2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(index))
    c, out = run_tiny(root, "tiny-gpt2.tiny2", trace=True)
    line = bench_tiny.result_line(c, out, True)
    assert line["metrics"]["ticks_seen"]["value"] > 0
    assert line["correct"] is True
    assert torch.__version__  # the port ran on the CPU's eager path


def test_the_host_part_of_a_traced_window_runs_without_kernel_ranges(
        root, monkeypatch):
    """The kernel ranges go in when the profiled part starts, after every
    model call of the host part: those calls run the port's own kernels'
    entry points."""
    from harness import probes
    from repro_torch.kernels import ops

    orig_fn, at_install = ops.quant_matmul, []
    saved = probes.Probes.install_ranges

    def install_ranges(self):
        at_install.append((len(self.calls), ops.quant_matmul is orig_fn))
        saved(self)

    monkeypatch.setattr(probes.Probes, "install_ranges", install_ranges)
    c, out = run_tiny(root, "tiny-gpt2.tiny", trace=True)
    host_calls = len(out["data"].calls)
    assert host_calls > 0 and at_install == [(host_calls, True)]
    assert ops.quant_matmul is orig_fn
    assert out["data"].prof_kernels
    assert {k["phase"] for k in out["data"].prof_kernels} == {"profiled"}
