"""The port's ring collectives and ring tensor parallelism
(``repro_torch.core.collectives``, ``repro_torch.core.ring``,
``repro_torch.launch.mesh``) against the JAX package's.

One subprocess runs the reference's ``ring_all_gather``,
``compressed_psum``, ``tp_matmul`` (all four schedules) and
``tp_quant_matmul`` under ``shard_map`` on 4 forced XLA CPU devices, on
inputs drawn from a seeded numpy generator, and writes inputs and outputs
to an npz file; the port runs the same inputs on a mesh of four CPU
entries (``["cpu"] * 4``).  Tolerances: the gather and the W8A8 product
bit-identical; the float ring products within 1e-5 relative; the int8
ring all-reduce within one int8 step of each hop's scale.  That is the
bound that holds, not bit-identity: the port takes the reference's
float32 operations in its order (max, divide, round half to even, clip,
and the reduce-scatter's dequantize-and-add as one fused multiply-add, as
XLA compiles it), and the longer seeded input comes out bit for bit, but
on the shorter one a reduced chunk requantizes one int8 step apart
(XLA's fusion of the unrolled ring is not reproduced operation for
operation).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import collectives, ring
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (DeviceMesh, make_host_mesh,
                                     make_serving_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
MATMUL_SHAPES = ((8, 64, 128),)  # (M, K, N)
QMM_SHAPES = ((8, 64, 128), (40, 128, 256))
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in parallel worker processes, and a pool of
    intra-op threads in each oversubscribes the cores (this module took
    8x as long beside six busy processes, by spinning threads); its small
    shapes run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import compat, ring
from repro.core.collectives import compressed_psum, ring_all_gather
from repro.kernels import ops

out_path = sys.argv[1]
mesh = compat.make_mesh((4,), ("model",))
rng = np.random.default_rng(0)
res = {}

g = rng.normal(size=(4 * 3, 5)).astype(np.float32)
res["gather_in"] = g
f = compat.shard_map(lambda x: ring_all_gather(x, "model"), mesh=mesh,
                     in_specs=P("model", None), out_specs=P("model", None))
res["gather_out"] = np.asarray(f(jnp.asarray(g)))

for i, L in enumerate((64, 1000)):
    xs = (rng.normal(size=(4, L)) * (1 + i)).astype(np.float32)
    res[f"psum_in{i}"] = xs
    f = compat.shard_map(lambda x: compressed_psum(x[0], "model")[None],
                         mesh=mesh, in_specs=P("model", None),
                         out_specs=P("model", None))
    res[f"psum_out{i}"] = np.asarray(f(jnp.asarray(xs)))

for i, (M, K, N) in enumerate(%(mm)r):
    for dt in ("float32", "bfloat16"):
        x = rng.normal(size=(M, K)).astype(np.float32)
        w = rng.normal(size=(K, N)).astype(np.float32)
        res[f"mm_x{i}_{dt}"], res[f"mm_w{i}_{dt}"] = x, w
        xj = jnp.asarray(x, dt)
        wj = jnp.asarray(w, dt)
        for strat in ("ring_ag", "naive_ag", "ring_rs", "naive_rs"):
            y = ring.tp_matmul(xj, wj, mesh, "model", strat)
            res[f"mm_{strat}{i}_{dt}"] = np.asarray(y, np.float32)

for i, (M, K, N) in enumerate(%(qmm)r):
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs_ = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws_ = rng.uniform(0.01, 0.1, (1, N)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    res.update({f"q_x{i}": xq, f"q_w{i}": wq, f"q_xs{i}": xs_,
                f"q_ws{i}": ws_, f"q_b{i}": b})
    for od in ("float32", "bfloat16"):
        y = ring.tp_quant_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                 jnp.asarray(xs_), jnp.asarray(ws_),
                                 jnp.asarray(b), mesh=mesh,
                                 out_dtype=getattr(jnp, od))
        res[f"q_out{i}_{od}"] = np.asarray(y, np.float32)
np.savez(out_path, **res)
print("REFERENCE_OK")
''' % {"mm": MATMUL_SHAPES, "qmm": QMM_SHAPES}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ring") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, path], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "REFERENCE_OK" in out.stdout, out.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(model=N, devices=["cpu"] * N)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def test_meshes():
    m = make_host_mesh(model=2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.axis_devices("model") == [torch.device("cpu")] * 2
    s = make_serving_mesh(3, devices=["cpu"] * 4)
    assert s.axis_names == ("shard",) and s.shape == {"shard": 3}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="n_shards"):
        make_serving_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        DeviceMesh((torch.device("cpu"),) * 3, ("model",), (4,))


def test_mesh_without_card_raises(monkeypatch):
    """Default devices are the cards; with none the mesh refuses rather
    than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(model=1, devices=["cuda:0"])


def test_ring_all_gather_bit_identical(ref):
    blocks = [_t(b) for b in np.split(ref["gather_in"], N)]
    got = collectives.ring_all_gather(blocks)
    want = np.split(ref["gather_out"], N)  # each device's copy
    for i in range(N):
        assert np.array_equal(got[i].numpy(), want[i])
        assert torch.equal(got[i], torch.cat(blocks))


@pytest.mark.parametrize("i", [0, 1])
def test_compressed_psum_matches_reference(ref, i):
    xs = ref[f"psum_in{i}"]
    got = collectives.compressed_psum([_t(x) for x in xs])
    want = ref[f"psum_out{i}"]
    # every hop's scale is at most the largest partial sum over 127; a
    # hop that rounds one int8 step apart moves the sum by one scale
    step = np.abs(xs).sum(axis=0).max() / 127.0
    for d in range(N):
        assert np.abs(got[d].numpy() - want[d]).max() <= N * step, d
        assert torch.equal(got[d], got[0])  # one sum on every device
    # and both within the int8 wire's error of the exact sum
    exact = xs.sum(axis=0)
    assert np.abs(want[0] - exact).max() <= 0.05 * np.abs(exact).max()
    assert np.abs(got[0].numpy() - exact).max() <= 0.05 * np.abs(exact).max()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("strat", ["ring_ag", "naive_ag", "ring_rs",
                                   "naive_rs"])
@pytest.mark.parametrize("i", range(len(MATMUL_SHAPES)))
def test_tp_matmul_matches_reference(ref, mesh, i, strat, dt):
    dtype = getattr(torch, dt)
    x = _t(ref[f"mm_x{i}_{dt}"], dtype)
    w = _t(ref[f"mm_w{i}_{dt}"], dtype)
    got = ring.tp_matmul(x, w, mesh, "model", strat)
    assert got.dtype == dtype and got.shape == (x.shape[0], w.shape[1])
    want = ref[f"mm_{strat}{i}_{dt}"]
    exact = (x.double() @ w.double()).numpy()
    scale = np.abs(exact).max()
    # one output rounding of the dtype, on top of the 1e-5 relative
    tol = REL_TOL * scale + (0 if dt == "float32" else 2 ** -8 * scale)
    assert np.abs(got.float().numpy() - want).max() <= tol
    assert np.abs(got.double().numpy() - exact).max() <= tol


@pytest.mark.parametrize("sched", [ring.ring_ag_matmul, ring.ring_rs_matmul])
def test_ring_schedules_against_one_product(sched):
    """The list-of-shards forms directly: the ring products against one
    float32 product, within 1e-5 relative."""
    rng = np.random.default_rng(3)
    M, K, Nn = 6, 64, 96
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, Nn)).astype(np.float32))
    xs = list(x.chunk(N, dim=1))
    ws = (list(w.chunk(N, dim=1)) if sched is ring.ring_ag_matmul
          else list(w.chunk(N, dim=0)))
    got = torch.cat(sched(xs, ws), dim=1)
    want = x @ w
    assert (got - want).abs().max() <= REL_TOL * want.abs().max()


@pytest.mark.parametrize("od", ["float32", "bfloat16"])
@pytest.mark.parametrize("i", range(len(QMM_SHAPES)))
def test_tp_quant_matmul_bit_identical(ref, mesh, i, od):
    args = [_t(ref[f"q_{k}{i}"]) for k in ("x", "w", "xs", "ws", "b")]
    out_dtype = getattr(torch, od)
    got = ring.tp_quant_matmul(*args, mesh=mesh, out_dtype=out_dtype)
    local = ops.quant_matmul(*args, out_dtype=out_dtype)
    assert torch.equal(got, local)
    assert np.array_equal(got.float().numpy(), ref[f"q_out{i}_{od}"])


@pytest.mark.parametrize("quantized", [True, False])
def test_tp_context_splits_each_weight_once(mesh, quantized):
    """Under ``tp_context(shards=)`` a weight is split on its first call
    only: later calls reuse the same shard tensors, and the output stays
    bit-identical to the uncached call's and, for W8A8, to the local
    product's."""
    from repro_torch.core import quant
    from repro_torch.models import layers

    rng = np.random.default_rng(5)
    K, Nn = 64, 128
    w = torch.from_numpy(rng.normal(size=(K, Nn)).astype(np.float32))
    p = ({"w_q": torch.from_numpy(rng.integers(-127, 128, (K, Nn),
                                               dtype=np.int8)),
          "w_scale": torch.from_numpy(rng.uniform(1e-3, 1e-2, (1, Nn))
                                      .astype(np.float32)),
          "smooth": torch.ones(K), "bias": torch.zeros(Nn)}
         if quantized else {"w": w})
    x = torch.from_numpy(rng.normal(size=(8, K)).astype(np.float32))
    with layers.tp_context(mesh):
        fresh = layers.linear(p, x)
    shards = {}
    with layers.tp_context(mesh, shards=shards):
        first = layers.linear(p, x)
        held = {k: [t.data_ptr() for t in v[1]] for k, v in shards.items()}
        second = layers.linear(p, x)
    assert len(shards) == (3 if quantized else 1)
    assert {k: [t.data_ptr() for t in v[1]]
            for k, v in shards.items()} == held
    assert torch.equal(first, second) and torch.equal(first, fresh)
    if quantized:
        xq, xs = quant.quantize_act(x)
        assert torch.equal(first, ops.quant_matmul(
            xq, p["w_q"], xs, p["w_scale"], p["bias"], out_dtype=x.dtype))
