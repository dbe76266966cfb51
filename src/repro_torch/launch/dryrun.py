"""Dry run: every (arch x shape) cell's step run on the ``meta`` device
over the production meshes, recording operations, per-device memory and
an operator histogram.  Nothing is allocated and nothing is launched.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single  # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi   # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape decode_32k

Each cell writes ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``;
a cell already written is read back unless ``--force``.  A record holds:

  * ``lower_s``: seconds to run the step on ``meta``;
  * ``flops``: the whole step's operations, from
    ``torch.utils.flop_counter.FlopCounterMode`` (products and attention;
    a backward pass included for ``train``);
  * ``flops_per_device``: ``flops`` over the mesh size.  This assumes an
    even split: the port does not partition the step's compute, so work
    that XLA would repeat on every device is not counted;
  * ``argument_size_in_bytes``, ``output_size_in_bytes`` and
    ``alias_size_in_bytes``: per device, each leaf's bytes over the sizes
    of the axes its partition spec names, summed over the step's
    arguments, its outputs, and its donated arguments (which the step
    returns in place, as XLA aliases them);
  * ``op_histogram``: the aten operators the meta run dispatched, in the
    reference's categories (``fusion`` is always 0 in eager mode, ``while``
    too, since layers run as Python loops).

The reference's XLA-only fields (``bytes_per_device``,
``temp_size_in_bytes``, ``generated_code_size_in_bytes``, ``hlo_lines``,
``collective_bytes``) have no counterpart and are left out.  A failed
cell is recorded with ``status: "error"`` and its traceback, and the run
then exits 1; ``long_500k`` on a full-attention arch is recorded as
skipped.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ASSIGNED_ARCHS, SHAPES, \
    applicable_shapes, get_config
from repro_torch.core import partition
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

#: the reference's op-histogram categories and the aten operators of each
_OP_CATEGORIES = ("fusion", "dot", "scatter", "gather", "while",
                  "custom-call")
_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot", "_int_mm",
        "_scaled_dot_product_attention_math",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_flash_attention", "convolution"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
            "_index_put_impl_", "index_copy", "index_copy_", "index_add",
            "index_add_", "index_reduce", "index_reduce_", "masked_scatter",
            "masked_scatter_"}
_GATHER = {"gather", "index_select", "index", "embedding",
           "take_along_dim", "take"}


class OpHistogram(TorchDispatchMode):
    """Counts the operators dispatched under it into the reference's
    categories."""

    def __init__(self):
        super().__init__()
        self.hist: Dict[str, int] = {k: 0 for k in _OP_CATEGORIES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns not in ("aten", "prim", "prims"):
            self.hist["custom-call"] += 1
        elif name in _DOT:
            self.hist["dot"] += 1
        elif name in _SCATTER:
            self.hist["scatter"] += 1
        elif name in _GATHER:
            self.hist["gather"] += 1
        return func(*args, **(kwargs or {}))


def _bytes_per_device(tree, specs, mesh) -> int:
    """Sum over ``tree``'s tensor leaves of their bytes over the sizes of
    the axes their specs (a tree of the same structure) name."""
    paths, leaves = partition.leaf_paths(tree)
    spaths, sleaves = partition.leaf_paths(specs)
    spec_of = dict(zip(spaths, sleaves))
    if sorted(paths) != sorted(spaths):
        raise ValueError("partition specs do not cover the tree: "
                         f"{sorted(set(paths) ^ set(spaths))[:4]}")
    return sum(t.numel() * t.element_size()
               // partition.shard_size(mesh, spec_of[p])
               for p, t in zip(paths, leaves))


def _run_meta(cell, mesh) -> dict:
    """Run ``cell``'s step on its meta inputs; the record's measured
    fields."""
    t0 = time.monotonic()
    flops = FlopCounterMode(display=False)
    hist = OpHistogram()
    with flops, hist:
        out = cell.step_fn(*cell.abstract_args)
    rec = {"lower_s": round(time.monotonic() - t0, 2)}
    rec["flops"] = float(flops.get_total_flops())
    rec["flops_per_device"] = rec["flops"] / mesh.size
    rec["argument_size_in_bytes"] = _bytes_per_device(
        cell.abstract_args, cell.in_shardings, mesh)
    rec["output_size_in_bytes"] = _bytes_per_device(
        out, cell.out_shardings, mesh)
    rec["alias_size_in_bytes"] = sum(
        _bytes_per_device(cell.abstract_args[i], cell.in_shardings[i], mesh)
        for i in cell.donate_argnums)
    rec["op_histogram"] = hist.hist
    return rec


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             out_dir: str, force: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok"}
    try:
        with torch.no_grad() if SHAPES[shape_name].kind != "train" \
                else torch.enable_grad():
            rec.update(_run_meta(build_cell(arch, shape_name, mesh), mesh))
        print(f"[dryrun] {mesh_name} {arch} {shape_name}: "
              f"meta run {rec['lower_s']}s flops {rec['flops']:.3e} "
              f"args/dev {rec['argument_size_in_bytes']:.3e}B")
    except Exception as e:  # record failures: they are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {mesh_name} {arch} {shape_name}: FAILED {e}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    multi = args.mesh == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    mesh_name = "pod2x16x16" if multi else "pod16x16"
    out_dir = os.path.abspath(args.out or os.path.join(ART_DIR, mesh_name))

    archs = (ASSIGNED_ARCHS + ("gpt2-345m",) if args.arch == "all"
             else (args.arch,))
    results = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = (applicable_shapes(cfg) if args.shape == "all"
                  else (args.shape,))
        for shape_name in shapes:
            results.append(run_cell(arch, shape_name, mesh, mesh_name,
                                    out_dir, force=args.force))
        if args.shape == "all":  # record the skipped shapes
            for shape_name in SHAPES:
                p = os.path.join(out_dir, f"{arch}__{shape_name}.json")
                if shape_name in shapes or os.path.exists(p):
                    continue
                with open(p, "w") as f:
                    json.dump({
                        "arch": arch, "shape": shape_name,
                        "mesh": mesh_name, "status": "skipped",
                        "reason": "full-attention arch: long_500k requires "
                                  "sub-quadratic mixing (DESIGN.md §5)",
                    }, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells ran on {mesh_name} "
          f"({mesh.size} devices)")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
