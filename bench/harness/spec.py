"""The benchmark's index and its data files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, the
configurations and the metrics.  Everything else is a file of its own,
found by the name the index gives it:

  * ``bench/workloads/<cell>.json``: a cell's serving shape (slots) and
    its correctness check (sample size, limits);
  * ``bench/configs/<config>.json``: a configuration's sizes as run, its
    serving settings, its reference family and its control;
  * ``bench/traffic/<mix>.json``: a traffic mix's parameters, read by the
    generator it names, ``bench/traffic/<generator>.py``;
  * ``bench/metrics/<metric>.py``: one metric's reader;
  * ``bench/rooflines/<kernel>.py``: one kernel's operations and bytes;
  * ``bench/reference/<family>.py``: the plain reference of a family.

So a cell, a configuration, a traffic mix or a metric is added by adding
files and index entries, without editing a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import one file as a module of its own (metric, roofline, traffic
    generator or reference files are found by name, not by package)."""
    path = Path(path)
    name = "bench_" + "_".join(
        path.with_suffix("").relative_to(path.parents[1]).parts
    ).replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench: Path

    def metric_module(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py")

    def roofline(self, kernel: str):
        return load_module(self.bench / "rooflines" / f"{kernel}.py")

    def generator(self):
        return load_module(self.bench / "traffic"
                           / f"{self.traffic['generator']}.py")

    def reference(self):
        return load_module(self.bench / "reference"
                           / f"{self.config['reference']}.py")


def _listed(metric: Dict, cell: str, e2e_names: Optional[set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:  # an end-to-end metric without a list: every cell
        return True
    return metric["moves"] in e2e_names


def cell(name: str, *, root: Path = ROOT, bench: Optional[Path] = None
         ) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files under
    ``bench`` (default ``root/bench``).  ``KeyError`` names an unknown
    cell."""
    bench = Path(bench) if bench is not None else Path(root) / "bench"
    index = load_json(Path(root) / "BENCHMARK.json")
    entry = next((w for w in index["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in index["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    e2e = [m for m in index["end_to_end"] if _listed(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in index["per_layer"] if _listed(m, name, names)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        workload=load_json(bench / "workloads" / f"{name}.json"),
        config=load_json(bench / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer, bench=bench)
