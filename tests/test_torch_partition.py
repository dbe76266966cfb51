"""The port's sharding rules against the JAX package's: every leaf's
partition spec of every registered config (full width and reduced),
params fp and W8A8, optimizer-moment trees, caches and batches, on both
production meshes (the reference's on a ``jax.sharding.AbstractMesh``,
the port's on its ``meta``-device ``DeviceMesh``), with FSDP on and off
and experts over the data or the model axis; the reference's unit cases
of ``tests/test_partition.py`` and its divisibility property (sampled
from a seeded generator here, since no ``hypothesis`` is needed).
Specs must be equal entry for entry.
"""
import copy
import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.core import partition as jpart
from repro.models import lm as jlm
from repro.serving.quantize import quantize_model_params as jquantize
from repro_torch.configs import base
from repro_torch.core import partition
from repro_torch.core.partition import P
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.serving.quantize import quantize_model_params

ARCHS = jbase.list_archs()
MAX_SEQ = 64


def _meshes(multi):
    if multi:
        return (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                make_production_mesh(multi_pod=True))
    return (AbstractMesh((16, 16), ("data", "model")),
            make_production_mesh())


def _cfgs(name, reduced):
    j, t = jbase.get_config(name), base.get_config(name)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _jpaths(tree):
    """The reference's leaf paths, as its ``param_shardings`` builds
    them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): leaf for path, leaf in flat}


def _canon(spec):
    """A spec with every single axis name as a 1-tuple: JAX's
    ``PartitionSpec`` reports ``("data",)`` as ``"data"`` (the two mean
    the same sharding), the port's keeps what the rule wrote."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in spec)


def _spec_map(specs):
    paths, leaves = partition.leaf_paths(specs)
    return {p: _canon(s) for p, s in zip(paths, leaves)}


def _ref_spec_map(tree, fn):
    """The reference's specs of ``tree``'s leaves, ``fn(path, shape)``
    being its rule (what its ``*_shardings`` wrap in a
    ``NamedSharding``)."""
    return {p: _canon(fn(p, tuple(leaf.shape)))
            for p, leaf in _jpaths(tree).items()}


@functools.lru_cache(maxsize=None)
def _abstract_params(name, reduced, quantized):
    jc, tc = _cfgs(name, reduced)
    if quantized:
        ja = jax.eval_shape(lambda: jquantize(
            jlm.init(jc, jax.random.PRNGKey(0), max_seq=MAX_SEQ,
                     layout="layers"), jc))
        return ja, quantize_model_params(
            lm.init_abstract(tc, max_seq=MAX_SEQ), tc)
    return (jlm.init_abstract(jc, max_seq=MAX_SEQ, layout="layers"),
            lm.init_abstract(tc, max_seq=MAX_SEQ))


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_equal_reference(name, reduced, multi):
    """Every leaf's spec, FSDP on and off, experts over data and model;
    the leaf paths themselves equal the reference's."""
    jc, tc = _cfgs(name, reduced)
    jmesh, tmesh = _meshes(multi)
    ja, ta = _abstract_params(name, reduced, False)
    assert set(_jpaths(ja)) == set(partition.leaf_paths(ta)[0])
    for fsdp in (False, True):
        for ep in ("data", "model"):
            want = _ref_spec_map(ja, functools.partial(
                jpart.param_pspec, cfg=jc, mesh=jmesh, fsdp=fsdp,
                moe_ep=ep))
            got = _spec_map(partition.param_shardings(
                ta, tc, tmesh, fsdp=fsdp, moe_ep=ep))
            assert got == want, (fsdp, ep)


@pytest.mark.parametrize("name", ARCHS)
def test_quantized_param_specs_equal_reference(name):
    """The W8A8 serving tree (``w_q``/``w_scale``/``smooth``/``bias``
    leaves) on both meshes."""
    jc, tc = _cfgs(name, True)
    ja, ta = _abstract_params(name, True, True)
    for multi in (False, True):
        jmesh, tmesh = _meshes(multi)
        for fsdp in (False, True):
            assert _spec_map(partition.param_shardings(
                ta, tc, tmesh, fsdp=fsdp)) == _ref_spec_map(
                ja, functools.partial(jpart.param_pspec, cfg=jc,
                                      mesh=jmesh, fsdp=fsdp))


def _cache_cases(jc):
    if jc.name.endswith("-reduced"):
        return ((32, MAX_SEQ), (3, MAX_SEQ), (1, 48))
    cases = [(128, 32_768)]
    if jc.subquadratic:
        cases.append((1, 524_288))
    return tuple(cases)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_equal_reference(name, reduced):
    """The per-layer cache (the reference's ``layout="layers"``, the
    port's stacked cache on ``meta``) at the decode shapes, and at batches
    the data axes do not divide."""
    jc, tc = _cfgs(name, reduced)
    for B, S in _cache_cases(jc):
        ja = jlm.init_cache_abstract(jc, B, S, layout="layers")
        ta = lm.init_cache(tc, B, S, layout="stacked", device="meta")
        jp = _jpaths(ja)
        tp, tl = partition.leaf_paths(ta)
        assert set(jp) == set(tp)
        for p, leaf in zip(tp, tl):
            assert tuple(leaf.shape) == tuple(jp[p].shape), p
        for multi in (False, True):
            jmesh, tmesh = _meshes(multi)
            assert _spec_map(partition.cache_shardings(
                ta, tc, tmesh, B)) == _ref_spec_map(
                ja, functools.partial(jpart.cache_pspec, cfg=jc,
                                      mesh=jmesh, batch=B)), (B, S, multi)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_batch_specs_and_replicated(multi):
    jmesh, tmesh = _meshes(multi)
    for B, S in ((256, 4096), (1, 1), (48, 8), (512, 16)):
        tb = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                    device="meta"),
              "lengths": torch.empty((B,), dtype=torch.int32, device="meta")}
        jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
              for k, v in tb.items()}
        want = {k: _canon(s.spec) for k, s in
                jpart.batch_shardings(jb, jmesh, B).items()}
        got = partition.batch_shardings(tb, tmesh, B)
        assert {k: _canon(s) for k, s in got.items()} == want
        assert all(s == P(*(None,) * tb[k].dim()) for k, s in
                   partition.replicated(tb, tmesh).items())
        assert got["tokens"] == (P(partition.data_axes(tmesh), None)
                                 if B % (tmesh.size // 16) == 0
                                 else P(None, None))


# ---------------------------------------------------------------------------
# the reference's unit cases


def test_megatron_orientation():
    _, mesh = _meshes(False)
    cfg = base.get_config("llama3-8b")
    assert partition.param_pspec("/periods/0/attn/q/w", (32, 4096, 4096),
                                 cfg, mesh, fsdp=True) == \
        P(None, ("data",), "model")
    assert partition.param_pspec("/periods/0/attn/out/w", (32, 4096, 4096),
                                 cfg, mesh, fsdp=True) == \
        P(None, "model", ("data",))


def test_kv_replication_when_heads_dont_divide():
    _, mesh = _meshes(False)
    spec = partition.param_pspec("/rest/0/attn/k/w", (4096, 1024),
                                 base.get_config("llama3-8b"), mesh,
                                 fsdp=True)
    assert spec[-1] is None  # 8 KV heads < 16: columns replicated
    spec = partition.param_pspec("/rest/0/attn/k/w", (3072, 4096),
                                 base.get_config("gemma-7b"), mesh,
                                 fsdp=True)
    assert spec[-1] == "model"  # head-wise


def test_vocab_sharding_fallback():
    _, mesh = _meshes(False)
    assert partition.param_pspec("/embed/table", (50257, 1024),
                                 base.get_config("gpt2-345m"), mesh,
                                 fsdp=False)[0] is None
    assert partition.param_pspec("/embed/table", (128256, 4096),
                                 base.get_config("llama3-8b"), mesh,
                                 fsdp=False)[0] == "model"


def test_cache_headwise_vs_seq_sharding():
    _, mesh = _meshes(False)
    assert partition.cache_pspec(
        "/periods/0/k", (28, 128, 16, 32768, 256),
        base.get_config("gemma-7b"), mesh, batch=128) == \
        P(None, ("data",), "model", None, None)
    assert partition.cache_pspec(
        "/periods/0/k", (32, 128, 8, 32768, 128),
        base.get_config("llama3-8b"), mesh, batch=128) == \
        P(None, ("data",), None, "model", None)


def test_moe_expert_parallel_spec():
    _, mesh = _meshes(False)
    kimi = base.get_config("kimi-k2-1t-a32b")
    assert partition.param_pspec("/periods/0/moe/w_up",
                                 (61, 384, 7168, 2048), kimi, mesh,
                                 fsdp=True) == \
        P(None, ("data",), None, "model")
    assert partition.param_pspec("/periods/0/moe/w_down",
                                 (61, 384, 2048, 7168), kimi, mesh,
                                 fsdp=True) == \
        P(None, ("data",), "model", None)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_specs_never_violate_divisibility(multi):
    """The reference's property, on 300 seeded (rows, cols) draws: every
    produced spec evenly divides the dims it shards, and equals the
    reference's."""
    jmesh, mesh = _meshes(multi)
    tc, jc = base.get_config("llama3-8b"), jbase.get_config("llama3-8b")
    rng = np.random.default_rng(0)
    dims = np.concatenate([rng.integers(1, 4097, (280, 2)),
                           np.array([[16, 32], [512, 4096], [4096, 48],
                                     [1, 1], [4096, 4096], [256, 256],
                                     [7, 4096], [4096, 7], [32, 32],
                                     [64, 1024], [1024, 64], [16, 16],
                                     [2048, 512], [512, 2048], [4000, 96],
                                     [96, 4000], [8, 16], [16, 8],
                                     [3, 5], [4096, 1]])])
    for rows, cols in dims.tolist():
        for path in ("/x/q/w", "/x/out/w", "/x/up/w", "/embed/table",
                     "/x/lm_head/w", "/x/k/w", "/x/router/w", "/x/q/b"):
            shape = (rows, cols) if not path.endswith("/b") else (cols,)
            spec = partition.param_pspec(path, shape, tc, mesh, fsdp=True)
            assert _canon(spec) == _canon(jpart.param_pspec(
                path, shape, jc, jmesh, fsdp=True)), (path, shape)
            for dim, ax in zip(shape, spec):
                if ax is not None:
                    assert dim % partition._axsize(mesh, ax) == 0


def test_production_mesh_and_spec_type():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert {d.type for d in single.devices + multi.devices} == {"meta"}
    assert partition.data_axes(multi) == ("pod", "data")
    spec = P(None, ("pod", "data"), "model")
    assert spec == (None, ("pod", "data"), "model")
    assert repr(spec) == "PartitionSpec(None, ('pod', 'data'), 'model')"
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(copy.deepcopy(spec)) is P
    assert partition.shard_size(multi, spec) == 512
    assert partition.shard_size(single, P()) == 1
    assert _canon(JP(None, ("data",), "model")) == \
        _canon(P(None, ("data",), "model"))
