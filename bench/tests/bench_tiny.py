"""A throwaway copy of the benchmark with tiny cells, for the CPU tests.

The copy holds ``BENCHMARK.json`` and ``bench/`` with two more
configurations (the port's ``.reduced()`` GPT-2, and OLMoE's with the
published routing, top 8 of 64 experts, at a small width), a tiny
closed-loop mix and their cells, added as files and index entries only.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT / "bench"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: name -> (configuration, the port's config module, the tiny cell's
#: limit on the widest logit gap).  Read on the CPU over seeds 11-14 and
#: 2**31 + 7: GPT-2 sound 0 to 0.0024, its int4 control 0.12 to 0.27;
#: OLMoE sound 0.15 to 0.34 (routing near-ties: the CPU's plain
#: attention rounds its probabilities to bf16), its int4 control 1.2 to
#: 2.4.
TINY = {"tiny-gpt2": ("gpt2-345m", "gpt2_345m", 0.05),
        "tiny-olmoe": ("olmoe-1b-7b", "olmoe_1b_7b", 0.6)}


def tiny_copy(dest: Path) -> Path:
    """Copy the benchmark under ``dest`` and add the tiny cells."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = dest / "bench"
    index = json.loads((dest / "BENCHMARK.json").read_text())
    from repro_torch.configs import base  # noqa: F401
    import importlib

    for name, (full, module, limit) in TINY.items():
        cfg = importlib.import_module(f"repro_torch.configs.{module}")
        red = dataclasses.asdict(cfg.CONFIG.reduced())
        conf = json.loads((bench / "configs" / f"{full}.json").read_text())
        for k in list(conf["model"]):
            if k in red and k != "name":
                conf["model"][k] = red[k]
        conf["model"]["name"] = name
        if conf["model"].get("n_experts"):
            # the published routing (top 8 of 64) at a small width
            conf["model"].update(n_experts=64, experts_per_token=8,
                                 d_ff=32)
        conf["serving"]["max_seq"] = 128
        conf["serving"]["calibration"] = {"tokens": 32}
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
        cell = f"{name}.tiny"
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"name": cell, "slots": 4,
             "check": {"min_tokens": 40, "max_requests": 6,
                       "limits": {"logit_gap": limit}}}))
        index["configs"].append({"name": name, "source": "test",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
        index["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "CPU tests"})
        for m in index["end_to_end"] + index["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"generator": "closed_loop", "clients": 4, "per_client": 8,
         "prompt_len": [8, 40], "output_len": [4, 12]}))
    (dest / "BENCHMARK.json").write_text(json.dumps(index))
    return dest


def run_tiny(root: Path, cell: str, *, seed: int = 2 ** 31 + 7,
             seconds: float = 0.6, trace: bool = False, controls=()):
    import time

    from harness import runner, spec

    def ticks(loop, seconds):
        # a window of 100 ticks a second, whatever the CPU's load: the
        # tests check what a window holds, not how fast a CPU serves it
        for _ in range(max(1, round(100 * seconds))):
            loop.tick()
        return time.monotonic()

    import torch

    c = spec.cell(cell, root=root)
    saved = runner.PROFILE_MIN_S, runner._tick_for, torch.get_num_threads()
    runner.PROFILE_MIN_S = 0.2  # a short profiled part on the CPU
    runner._tick_for = ticks
    # one intra-op thread: a pool per test worker oversubscribes the cores
    torch.set_num_threads(1)
    try:
        out = runner.run_cell(c, seed, seconds, trace, device="cpu",
                              t_start=time.monotonic(), controls=controls)
    finally:
        runner.PROFILE_MIN_S, runner._tick_for, threads = saved
        torch.set_num_threads(threads)
    return c, out


def result_line(cell, out, trace: bool):
    import importlib.util

    sp = importlib.util.spec_from_file_location("bench_run_main",
                                                ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(run)
    return run.result_line(cell, out, trace, {"platform": "cpu"})
