"""The port's dry run on the CPU: the cells' meta runs and their records,
held against the JAX package's cells where both count the same thing.

* The serving-FSDP decision equals the reference's for every registered
  config on both production meshes (the port's budget is stated for the
  H100, the reference's for its TPU).
* Per-device argument (and donated) bytes of full-width ``gpt2-345m``
  ``decode_32k`` and of a reduced MoE ``train_4k`` cell equal the
  reference's accounting from its ``jax.eval_shape`` leaves and their
  specs: each leaf's bytes over the sizes of the axes its spec names.
  Nothing is compiled.
* Every registered config's reduced cells run on ``meta``, and a record
  holds exactly the fields the port can measure.
* The meta route of the kernel wrappers, the xLSTM cells' meta path (the
  same shapes and operation count as the step loop on the CPU) and the
  trainer's dry-run options.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.launch import cells as jcells
from repro_torch.configs import base
from repro_torch.configs.base import SHAPES
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.training.trainer import TrainConfig

ARCHS = jbase.list_archs()
RECORD_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "flops",
               "flops_per_device", "argument_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes", "op_histogram"}


def _meshes(multi):
    if multi:
        return (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                make_production_mesh(multi_pod=True))
    return (AbstractMesh((16, 16), ("data", "model")),
            make_production_mesh())


def _ref_bytes(args, shardings, mesh):
    """The reference's per-device bytes of ``args``: every
    ``ShapeDtypeStruct`` leaf over the sizes of the axes its
    ``NamedSharding`` names."""
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(args),
                        jax.tree_util.tree_leaves(
                            shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        n = 1
        for ax in sh.spec:
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                n *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_serve_fsdp_decision_equals_reference(multi):
    jmesh, tmesh = _meshes(multi)
    got = {n: cells._serve_fsdp(base.get_config(n), tmesh) for n in ARCHS}
    assert got == {n: jcells._serve_fsdp(jbase.get_config(n), jmesh)
                   for n in ARCHS}
    assert got["kimi-k2-1t-a32b"] and sum(got.values()) == 1


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_gpt2_decode_argument_bytes_equal_reference(multi):
    jmesh, tmesh = _meshes(multi)
    jc = jcells.build_cell("gpt2-345m", "decode_32k", jmesh)
    tc = cells.build_cell("gpt2-345m", "decode_32k", tmesh)
    assert len(tc.abstract_args) == len(jc.abstract_args)
    assert tc.donate_argnums == jc.donate_argnums
    assert dryrun._bytes_per_device(tc.abstract_args, tc.in_shardings,
                                    tmesh) == \
        _ref_bytes(jc.abstract_args, jc.in_shardings, jmesh)
    i = tc.donate_argnums[0]
    assert dryrun._bytes_per_device(tc.abstract_args[i], tc.in_shardings[i],
                                    tmesh) == \
        _ref_bytes(jc.abstract_args[i], jc.in_shardings[i], jmesh)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_train_argument_bytes_equal_reference(name):
    """A reduced MoE ``train_4k`` cell: params TP-sharded, AdamW moments
    also over the data axes, experts over the model axis."""
    jmesh, tmesh = _meshes(False)
    shape = SHAPES["train_4k"]
    jc = jcells._train_cell(jbase.get_config(name).reduced(),
                            jbase.SHAPES["train_4k"], jmesh, True)
    tc = cells._train_cell(base.get_config(name).reduced(), shape, tmesh,
                           True)
    assert dryrun._bytes_per_device(tc.abstract_args, tc.in_shardings,
                                    tmesh) == \
        _ref_bytes(jc.abstract_args, jc.in_shardings, jmesh)


def _reduced_cell(name, shape_name, mesh):
    cfg = base.get_config(name).reduced()
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return cells._train_cell(cfg, shape, mesh, True)
    if shape.kind == "prefill":
        return cells._prefill_cell(cfg, shape, mesh, True)
    return cells._decode_cell(cfg, shape, mesh, True)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_cells_run_on_meta(name):
    """Every applicable shape of every config, reduced, runs its step on
    ``meta`` (nothing allocated: the inputs and outputs are meta; the
    serving steps' W8A8 products through the kernel wrappers' meta
    route) and yields the record's measured fields."""
    _, mesh = _meshes(False)
    for shape_name in base.applicable_shapes(base.get_config(name)):
        cell = _reduced_cell(name, shape_name, mesh)
        grad = SHAPES[shape_name].kind == "train"
        with torch.set_grad_enabled(grad):
            rec = dryrun._run_meta(cell, mesh)
        assert set(rec) == RECORD_KEYS - {"arch", "shape", "mesh",
                                          "status"}, shape_name
        assert rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
        assert rec["flops_per_device"] == rec["flops"] / 256
        assert rec["alias_size_in_bytes"] <= rec["argument_size_in_bytes"]
        assert rec["op_histogram"]["fusion"] == 0
        assert rec["op_histogram"]["dot"] > 0
        assert all(t.is_meta for t in tree_leaves(cell.abstract_args))


def test_run_cell_record_and_rerun(tmp_path):
    """A full-width cell's record: the fields the port measures and none
    of the reference's XLA-only ones; a written cell is read back unless
    forced."""
    mesh = make_production_mesh()
    rec = dryrun.run_cell("gpt2-345m", "decode_32k", mesh, "pod16x16",
                          str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    cfg = base.get_config("gpt2-345m")
    # the linears' operations and the attention over the 32k cache
    dense = 2 * cfg.param_counts()["active"] * 128
    assert rec["flops"] > dense
    with open(tmp_path / "gpt2-345m__decode_32k.json") as f:
        assert json.load(f) == rec
    again = dryrun.run_cell("gpt2-345m", "decode_32k", mesh, "pod16x16",
                            str(tmp_path))
    assert again == rec


def test_main_records_skips_and_fails(tmp_path, monkeypatch):
    """``main``: skipped records for ``long_500k`` on a full-attention
    arch, and exit 1 when a cell fails, its traceback recorded."""
    calls = []

    def fake_run_cell(arch, shape_name, mesh, mesh_name, out_dir,
                      force=False):
        calls.append((arch, shape_name, mesh_name, force))
        return {"status": "ok"}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    dryrun.main(["--arch", "llama3-8b", "--out", str(tmp_path), "--force"])
    assert calls == [("llama3-8b", s, "pod16x16", True)
                     for s in ("train_4k", "prefill_32k", "decode_32k")]
    with open(tmp_path / "llama3-8b__long_500k.json") as f:
        skip = json.load(f)
    assert skip["status"] == "skipped" and "long_500k" in skip["reason"]
    monkeypatch.undo()

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-350m", "--shape", "long_500k",
                     "--mesh", "multi", "--out", str(tmp_path)])
    assert e.value.code == 1
    with open(tmp_path / "xlstm-350m__long_500k.json") as f:
        rec = json.load(f)
    assert rec["status"] == "error" and rec["mesh"] == "pod2x16x16"
    assert "planted" in rec["error"] and "Traceback" in rec["traceback"]


def test_kernel_wrappers_route_meta_to_the_plain_version():
    """A meta tensor takes the plain version, which computes shapes only;
    a CPU tensor still takes it, mixed devices still raise."""
    meta = {"device": "meta"}
    x = torch.empty((8, 64), dtype=torch.int8, **meta)
    w = torch.empty((64, 96), dtype=torch.int8, **meta)
    xs = torch.empty((8, 1), dtype=torch.float32, **meta)
    ws = torch.empty((1, 96), dtype=torch.float32, **meta)
    out = ops.quant_matmul(x, w, xs, ws, None)
    assert out.is_meta and out.shape == (8, 96)
    assert ops._route("t", x, w) is False
    assert ops._route("t", torch.zeros(1)) is False
    with pytest.raises(ValueError, match="several devices"):
        ops._route("t", x, torch.zeros(1))


@pytest.mark.parametrize("seq", [1, 13])
def test_xlstm_meta_path_matches_the_step_loop(seq):
    """On meta the xLSTM cells run a sequence's steps as one call; shapes,
    dtypes and the operation count (forward and backward) equal the step
    loop's on the CPU."""
    cfg = base.get_config("xlstm-350m").reduced()
    got = {}
    for dev in ("cpu", "meta"):
        gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
        params = lm.init(cfg, gen, device=dev)
        for t in tree_leaves(params):
            t.requires_grad_()
        tokens = torch.zeros((2, seq), dtype=torch.int64, device=dev)
        with FlopCounterMode(display=False) as fc:
            loss, _ = lm.loss_fn(params, cfg, {"tokens": torch.zeros(
                (2, seq + 1), dtype=torch.int64, device=dev)})
            loss.backward()
        train = fc.get_total_flops()
        cache = lm.init_cache(cfg, 2, 16, layout="stacked", device=dev)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            logits, cache, _ = lm.batch_prefill(params, cfg, tokens, cache)
        got[dev] = (train, fc.get_total_flops(), tuple(logits.shape),
                    [(tuple(t.shape), t.dtype) for t in tree_leaves(cache)])
    assert got["meta"] == got["cpu"]


def test_train_config_accepts_only_the_per_layer_options():
    tc = TrainConfig(unroll_periods=True, layout="layers")
    assert tc.unroll_periods and tc.layout == "layers"
    with pytest.raises(ValueError, match="unroll_periods"):
        TrainConfig(unroll_periods=False)
    with pytest.raises(ValueError, match="layout"):
        TrainConfig(layout="stacked")


def test_artifact_dir_is_ignored_by_git():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "artifacts/dryrun_torch/" in f.read().split()
    assert os.path.abspath(dryrun.ART_DIR) == os.path.join(
        root, "artifacts", "dryrun_torch")
