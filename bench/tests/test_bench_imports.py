"""What the measuring process and the reference load, and how the entry
point refuses to run without a card or without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_tiny

ROOT = bench_tiny.ROOT
FORBIDDEN_RUN = {"jax", "jaxlib", "flax", "repro"}

_RUN = """
import json, sys, time
sys.path[:0] = [{tests!r}, {ref!r}, {bench!r}]
from harness import spec, weights, check
import reference_common, gpt2, olmoe
ref = sorted({{m.split(".")[0] for m in sys.modules}})
import bench_tiny
from pathlib import Path
root = bench_tiny.tiny_copy(Path({tmp!r}))
from harness import probes, trace
import torch.profiler
c, out = bench_tiny.run_tiny(root, "tiny-gpt2.tiny")
bench_tiny.result_line(c, out, False)
run = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"reference": ref, "run": run}}))
"""

def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """Top-level module names loaded in a fresh process: after importing
    the reference (and the harness's weights and check), and after the
    trace's modules and a whole run of a tiny cell on the CPU through the
    harness, the port and the metric readers."""
    code = _RUN.format(tests=str(ROOT / "bench" / "tests"),
                       ref=str(ROOT / "bench" / "reference"),
                       bench=str(ROOT / "bench"),
                       tmp=str(tmp_path_factory.mktemp("imports")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    return {k: set(v) for k, v in out.items()}


def test_the_run_path_loads_no_jax_and_no_jax_package(loaded):
    """No module whose top-level name is jax, jaxlib, flax or the JAX
    package ``repro``; the port, ``repro_torch``, is there."""
    assert not loaded["run"] & FORBIDDEN_RUN
    assert "repro_torch" in loaded["run"]


def test_the_reference_loads_nothing_of_either_package(loaded):
    assert not loaded["reference"] & {"repro", "repro_torch", "jax",
                                      "jaxlib", "flax"}


def test_the_entry_point_refuses_without_a_card(capsys):
    """No card on this machine: a non-zero exit and no result."""
    import importlib.util

    sp = importlib.util.spec_from_file_location("bench_run_refuse",
                                                ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(run)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    rc = run.main(["--workload", "gpt2-345m.longgen", "--seed",
                   str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_entry_point_refuses_without_the_program(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and ``bench/``:
    a non-zero exit and no result on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gpt2-345m.longgen",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=_env(),
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "repro_torch" in p.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an NVIDIA H100 (sm_90)")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gpt2-345m.longgen",
         "--seed", str(2 ** 31 + 9), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=_env(), timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    from harness import spec

    cell = spec.cell("gpt2-345m.longgen", root=ROOT)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
