"""The port's checkpoint manager (copies of ``tests/test_checkpoint.py``
on trees with float32, int32 and bf16 leaves and no ``ml_dtypes``),
its on-disk format against the JAX package's manager, serving a trained
checkpoint from ``launch/serve.py``, and the port's imports.

* Round trips are bit-identical in value and dtype; a partial
  ``step_<n>.tmp`` and a committed directory without a manifest are
  invisible; GC keeps the last ``keep``; a tree or shape mismatch is
  refused with ``ValueError``.
* An async save is a snapshot: in-place updates made after ``save()``
  returns do not reach it; a failed async write is raised by ``wait()``.
* Each package's manager restores the other's checkpoint bit for bit.
* ``launch/serve.py --ckpt-dir --device cpu`` serves a three-step
  ``Trainer`` checkpoint with the same greedy streams as the in-memory
  params, W8A8 and with ``--no-quant`` (float weights).
* A fresh interpreter imports every ``repro_torch`` module and
  ``chip_smoke.py`` and finds no ``jax``, ``ml_dtypes`` or ``repro``
  module loaded.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import TrainConfig, Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": ({"b": torch.arange(5, dtype=torch.int32)},
                   torch.randn((2, 3), generator=g).to(torch.bfloat16)),
    }


def _like(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _assert_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip_preserves_values_and_dtypes(tmp_path):
    t = _tree()
    m = CheckpointManager(str(tmp_path))
    m.save(3, t)
    got = m.restore(None, _like(t))
    assert tree_leaves(got)[0].device.type == "cpu"
    _assert_equal(got, t)
    # the reference's layout: a uint16 bit pattern named bfloat16
    with np.load(tmp_path / "step_3" / "shard_0.npz") as data:
        assert data["a2"].dtype == np.uint16


def test_atomic_commit_ignores_partial_tmp(tmp_path):
    t = _tree()
    m = CheckpointManager(str(tmp_path))
    m.save(1, t)
    # a crash mid-save at step 2: a tmp dir without a manifest
    os.makedirs(tmp_path / "step_2.tmp")
    (tmp_path / "step_2.tmp" / "shard_0.npz").write_bytes(b"garbage")
    assert m.latest_step() == 1  # partial save invisible
    _assert_equal(m.restore(None, _like(t)), t)


def test_corrupt_committed_dir_without_manifest_skipped(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(5, _tree())
    os.makedirs(tmp_path / "step_9")  # no manifest inside
    assert m.latest_step() == 5


def test_gc_keeps_last_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree())
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_then_wait(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(7, _tree(), blocking=False)
    m.wait()
    assert m.latest_step() == 7


def test_tree_mismatch_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree())
    with pytest.raises(ValueError, match="tree mismatch"):
        m.restore(1, {"different": torch.zeros(3, device="meta")})
    wrong = _like(_tree())
    wrong["a"] = torch.empty((4, 9), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(1, wrong)


def test_async_save_isolated_from_later_updates(tmp_path):
    t = _tree()
    want = tree_map(torch.clone, t)
    m = CheckpointManager(str(tmp_path))
    m.save(4, t, blocking=False)
    for leaf in tree_leaves(t):  # the next step, in place
        leaf.add_(1)
    m.wait()
    _assert_equal(m.restore(4, _like(t)), want)


def test_failed_async_write_raised_by_wait(tmp_path, monkeypatch):
    def savez(*args, **kwargs):
        raise OSError("no space left on device")

    m = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(manager_mod.np, "savez", savez)
    m.save(2, _tree(), blocking=False)
    with pytest.raises(OSError, match="no space"):
        m.wait()
    m.wait()  # raised once
    assert m.latest_step() is None


def test_on_disk_format_shared_with_reference(tmp_path):
    """The reference's manager reads the port's checkpoint and the port's
    reads the reference's, bit for bit (bf16 included)."""
    t = _tree()
    jtree = {"a": jnp.asarray(t["a"].numpy()),
             "nested": ({"b": jnp.arange(5, dtype=jnp.int32)},
                        jnp.asarray(t["nested"][1].float().numpy(),
                                    jnp.bfloat16))}
    CheckpointManager(str(tmp_path / "port")).save(1, t)
    got = JManager(str(tmp_path / "port")).restore(
        None, jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    JManager(str(tmp_path / "ref")).save(1, jtree)
    _assert_equal(CheckpointManager(str(tmp_path / "ref")).restore(
        None, _like(t)), t)


# ---------------------------------------------------------------------------
# serving a trained checkpoint


class _Recorder:
    """Patches ``launch/serve.py``'s engine to keep each run's engine and
    finished requests."""

    def __init__(self, monkeypatch):
        self.runs = []
        rec = self

        class Engine(ServeEngine):
            def run(self, *a, **k):
                done = super().run(*a, **k)
                rec.runs.append((self, [list(r.out) for r in done]))
                return done

        monkeypatch.setattr(serve, "ServeEngine", Engine)


def test_serve_from_trainer_checkpoint(tmp_path, monkeypatch):
    cfg = get_config("gpt2-345m").reduced()
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=3))
    tr = Trainer(cfg, tcfg, SyntheticLM(cfg.vocab_size, 16, 4, seed=0),
                 str(tmp_path), max_seq=64, ckpt_every=3, device="cpu")
    tr.init_or_restore()
    tr.run(3)
    rec = _Recorder(monkeypatch)
    argv = ["--arch", "gpt2-345m", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "6", "--max-seq", "64"]
    for quant in ([], ["--no-quant"]):
        serve.main(argv + quant + ["--ckpt-dir", str(tmp_path)])
        with monkeypatch.context() as mp:  # the in-memory trained params
            mp.setattr(serve.lm, "init", lambda *a, **k: tr.state.params)
            serve.main(argv + quant)
    (e_ck, s_ck), (e_mem, s_mem), (f_ck, fs_ck), (f_mem, fs_mem) = rec.runs
    assert s_ck == s_mem and fs_ck == fs_mem
    assert all(len(s) == 6 for s in s_ck + fs_ck)
    for e in (e_ck, e_mem):
        assert "w_q" in e.params["layers"][0]["attn"]["q"]
    for e in (f_ck, f_mem):
        assert "w" in e.params["layers"][0]["attn"]["q"]
        assert e.act_dtype == torch.bfloat16
    # the served weights are the trained ones, not a fresh init
    for a, b in zip(tree_leaves(f_ck.params), tree_leaves(tr.state.params)):
        assert torch.equal(a, b)


def test_port_imports_no_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "print('MODULES', len(sys.modules), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
