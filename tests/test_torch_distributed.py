"""The port's multi-device serving (``repro_torch.serving.distributed``,
``ServeEngine(mesh=)``) against the JAX package and against the port's
single-device engine, on meshes of CPU entries (``["cpu"] * n``).

  * Host classes: the same call sequences through the port's and the
    reference's ``ShardedPageAllocator``, ``ShardedSlotAllocator``,
    ``ShardPlacement``, ``DecodeWaveScheduler`` and ``TransferScheduler``
    give equal slot ids, shards, block tables, lengths, wave assignments,
    stats and overlap counts (exact equality).
  * The engine: ``DistributedServeEngine``'s greedy W8A8 streams are token
    for token the port's ``ServeEngine``'s with ``batch_slots = n_shards
    x slots_per_shard``, with equal accept counters, paged and stacked,
    4 x 1 and 2 x 2, plain, chain and tree (a draft model), and for a
    hybrid stack (reduced ``recurrentgemma-9b``, stacked) and the mixed
    stack (per-kind paged), plain and chain.  The plain paged streams
    also equal the JAX ``ServeEngine``'s (the JAX distributed engine is
    not used: it fails on this jax, ROADMAP C2).
  * Properties: prefix affinity links pages; K/V never leave their shard
    (every cache tensor of shard s on ``mesh.devices[s]``, the largest
    transfer below one page-pool leaf); ``overlap_ratio >= 0.5``; state
    and recompute migration and preempt-resume leave streams equal; and
    ``ServeEngine(mesh=)`` streams equal the unsharded engine's, W8A8 and
    float, token for token.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import admission as jadmission
from repro.serving import telemetry as jtelemetry
from repro.serving.distributed import sharded_kv as jsharded_kv
from repro.serving.distributed import transfer as jtransfer
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.kv_cache import PagePoolExhausted as JExhausted
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
from repro_torch.models import lm
from repro_torch.serving import admission, near_tie, telemetry
from repro_torch.serving.distributed import (DistributedServeEngine,
                                             ShardedPageAllocator,
                                             ShardedSlotAllocator,
                                             TransferScheduler)
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv_cache import PagePoolExhausted
from repro_torch.serving.lifecycle import DECODE
from repro_torch.serving.quantize import calibrate, quantize_model_params
from repro_torch.serving.speculative import SpecConfig
from torch_helpers import ForcedDrafts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEQ, PAGE, CHUNK, MAX_NEW = 64, 8, 8, 8
GEOMETRIES = ((4, 1), (2, 2))  # (n_shards, slots_per_shard)


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


# ---------------------------------------------------------------------------
# host classes: the same call sequences through both packages


def _prompt(rng, n):
    return [int(t) for t in rng.integers(1, 500, int(n))]


def _alloc_trace(mod, cfg):
    """Drive a sharded page allocator of ``mod`` through the reference
    tests' scenarios and a seeded random walk; returns what it said."""
    log = []
    kv = mod.ShardedPageAllocator(cfg, 4, 2, 64, page_size=16)
    rng = np.random.default_rng(0)
    log.append([kv.alloc(_prompt(rng, 5), max_new=4) for _ in range(9)])
    log.append((kv.n_used, kv.n_free))
    # pages never straddle shards; per-shard never-fits
    kv = mod.ShardedPageAllocator(cfg, 2, 2, 64, page_size=16, n_pages=4,
                                  prefix_sharing=False)
    rng = np.random.default_rng(1)
    log.append([kv.alloc(_prompt(rng, 17), max_new=16) for _ in range(3)])
    log.append((kv.available_pages, kv.block_tables_array().tolist()))
    kv.check_shard_locality()
    try:
        mod.ShardedPageAllocator(cfg, 4, 2, 64, page_size=16,
                                 n_pages=3).alloc(_prompt(rng, 33), 8)
        log.append("fits")
    except ValueError as e:
        log.append("no single pool shard" in str(e))
    # prefix affinity: a same-prefix request follows the prefix's shard
    kv = mod.ShardedPageAllocator(cfg, 2, 2, 64, page_size=16)
    rng = np.random.default_rng(4)
    shared = _prompt(rng, 16)
    a = kv.alloc(shared + _prompt(rng, 3), max_new=4)
    kv.advance(a[0], 19)
    log += [a, kv.alloc(_prompt(rng, 30), max_new=4),
            kv.alloc(shared + _prompt(rng, 5), max_new=4),
            kv.alloc(shared + _prompt(rng, 2), max_new=4),
            kv.alloc(_prompt(rng, 5), max_new=4), kv.stats(),
            [m.shared_prefix_pages(shared + [1]) for m in kv.shards]]
    # a seeded walk: alloc / prefill / decode growth / rewind / free, in
    # reservation and over-commit mode
    for oc in (False, True):
        kv = mod.ShardedPageAllocator(cfg, 2, 2, 64, page_size=8,
                                      n_pages=9, overcommit=oc)
        rng = np.random.default_rng(5 + oc)
        live = {}
        for step in range(60):
            op = rng.integers(0, 4)
            if op == 0:
                res = kv.alloc(_prompt(rng, rng.integers(2, 30)),
                               max_new=int(rng.integers(1, 20)))
                log.append(("alloc", res))
                if res is not None:
                    live[res[0]] = res[1]
            elif op == 1 and live:
                slot = sorted(live)[int(rng.integers(len(live)))]
                n = int(rng.integers(1, 4))
                mask = np.zeros(4, bool)
                mask[slot] = True
                try:
                    kv.ensure_decode_room(mask, n)
                    log.append(("room", slot, n))
                    if kv.has_room(slot, n):
                        kv.advance(slot, n)
                except Exception as e:  # noqa: BLE001 — compared below
                    log.append(("exhausted", type(e).__name__,
                                getattr(e, "slot", None)))
            elif op == 2 and live:
                slot = sorted(live)[int(rng.integers(len(live)))]
                kv.free(slot)
                del live[slot]
                log.append(("free", slot))
            log.append((kv.lengths_array().tolist(),
                        kv.block_tables_array().tolist(), kv.stats(),
                        kv.available_pages))
    return log


def test_sharded_page_allocator_matches_reference():
    jcfg, cfg = jget_config("gpt2-345m").reduced(), \
        get_config("gpt2-345m").reduced()
    want = _alloc_trace(jsharded_kv, jcfg)
    got = _alloc_trace(__import__(
        "repro_torch.serving.distributed.sharded_kv", fromlist=["x"]), cfg)
    norm = {"PagePoolExhausted": "PagePoolExhausted"}
    assert [_plain(x, norm) for x in got] == [_plain(x, norm) for x in want]
    assert PagePoolExhausted.__name__ == JExhausted.__name__


def _plain(x, norm):
    if isinstance(x, (list, tuple)):
        return [_plain(v, norm) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v, norm) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return norm.get(x, x) if isinstance(x, str) else x


def _slot_trace(Alloc, cfg):
    kv = Alloc(cfg, 2, 2, 64)
    out = [kv.alloc() for _ in range(5)]
    kv.free(out[2])
    out += [kv.alloc(), kv.alloc(shard=1), kv.n_used, kv.n_free]
    kv.free(out[0])
    out += [kv.alloc(shard=0), kv.stats(), kv.lengths_array().tolist()]
    return out


def test_sharded_slot_allocator_matches_reference():
    assert _slot_trace(ShardedSlotAllocator,
                       get_config("gpt2-345m").reduced()) == _slot_trace(
        jsharded_kv.ShardedSlotAllocator, jget_config("gpt2-345m").reduced())


def _wave_trace(Sched):
    log = []
    ws = Sched(6, n_waves=2)
    rng = np.random.default_rng(2)
    for _ in range(40):
        op = rng.integers(0, 3)
        b = int(rng.integers(0, 6))
        if op == 0:
            ws.assign(sorted(set(rng.integers(0, 6, 3).tolist())))
        elif op == 1:
            ws.release(b)
        else:
            log.append(ws.join(b))
        log.append((ws.wave.tolist(), ws.counts(), ws.imbalance()))
    return log


def test_wave_scheduler_matches_reference():
    assert _wave_trace(admission.DecodeWaveScheduler) == _wave_trace(
        jadmission.DecodeWaveScheduler)


def test_shard_placement_matches_reference():
    """Prefix affinity, then the most available pages, then the lowest id,
    on pools in the same state."""
    jcfg, cfg = jget_config("gpt2-345m").reduced(), \
        get_config("gpt2-345m").reduced()
    out = []
    for mod, c, P in ((jsharded_kv, jcfg, jadmission.ShardPlacement),
                      (None, cfg, admission.ShardPlacement)):
        kv = (mod.ShardedPageAllocator if mod else ShardedPageAllocator)(
            c, 3, 2, 64, page_size=16)
        rng = np.random.default_rng(6)
        shared = _prompt(rng, 32)
        s, _ = kv.alloc(shared + [7], max_new=4)
        kv.advance(s, 33)
        kv.alloc(_prompt(rng, 40), max_new=8)
        out.append([P().order(kv.shards, p, share=sh)
                    for p in (shared + [9], _prompt(rng, 5), None)
                    for sh in (True, False)])
    assert out[0] == out[1]


def _transfer_trace(sched, arr):
    xf = sched()
    log = [xf.overlap_ratio(), xf.stats()]
    xf.set_phase("prefill")
    xf.stage("a", np.zeros((4,), np.int32))
    op = xf.dispatch("compute", arr((2,)))
    xf.set_phase("drain")
    xf.stage("b", np.zeros((4,), np.int32))
    xf.fetch("c", arr((3,)), of=op)
    op1 = xf.dispatch("c1", arr((2,)))
    op2 = xf.dispatch("c2", arr((2,)))
    xf.fetch("d", arr((3,)), of=op1)
    xf.note("note", 100)
    xf.retire(op2)
    xf.stage("e", np.zeros((5,), np.int64))
    log += [(xf.n_hidden, xf.n_exposed), xf.phase_stats(), xf.stats(),
            list(xf.events)]
    xf.sync()
    xf.reset()
    log.append(xf.stats())
    return log


def test_transfer_scheduler_matches_reference():
    want = _transfer_trace(jtransfer.TransferScheduler,
                           lambda s: jnp.ones(s, jnp.float32))
    got = _transfer_trace(TransferScheduler,
                          lambda s: torch.ones(s, dtype=torch.float32))
    assert got == want


def test_stats_keys_match_reference():
    assert telemetry.STATS_KEYS_DISTRIBUTED == \
        jtelemetry.STATS_KEYS_DISTRIBUTED
    assert telemetry.TID_TRANSFER == jtelemetry.TID_TRANSFER


# ---------------------------------------------------------------------------
# the engine


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(list(p), max_new=max_new)
    return {r.rid: r.out for r in eng.run()}


class Gpt2:
    """Reduced gpt2-345m: seeded weights, W8A8-quantized by the port (its
    calibration and quantization are held bit for bit to the
    reference's elsewhere) and stacked back into the reference's layout
    for its engine; a noisy draft; the prompts (a shared-prefix pair and
    runs the n-gram proposer matches)."""

    def __init__(self):
        self.jcfg = jget_config("gpt2-345m").reduced()
        self.cfg = get_config("gpt2-345m").reduced()
        self.fp = lm.init(self.cfg, torch.Generator().manual_seed(0),
                          max_seq=MAX_SEQ)
        rng = np.random.default_rng(1)
        calib = [rng.integers(1, self.cfg.vocab_size, (2, 16))]
        self.tq = quantize_model_params(
            self.fp, self.cfg, calibrate(self.fp, self.cfg, calib))
        self.draft = serve.noisy_copy(self.fp, 11, 0.25)
        run = rng.integers(1, self.cfg.vocab_size, 5).tolist()
        shared = rng.integers(1, self.cfg.vocab_size, 16).tolist()
        self.prompts = ([run * 4, rng.integers(1, 500, 9).tolist()]
                        + [shared + [3, 4], shared + [5]]
                        + [rng.integers(1, 500, n).tolist()
                           for n in (30, 4, 13)])

    @property
    def jq(self):
        """``tq`` in the reference's layout: one pattern position, so the
        layers stack on one leading axis of ``periods[0]``."""
        assert len(self.cfg.block_pattern) == 1

        def jx(t):
            return jnp.asarray(t.numpy())

        def stack(*ts):
            return jnp.asarray(np.stack([t.numpy() for t in ts]))

        out = {k: tree_map(jx, v) for k, v in self.tq.items()
               if k != "layers"}
        out["periods"] = (tree_map(stack, *self.tq["layers"]),)
        out["rest"] = []
        back = bridge.params_from_numpy(jax.device_get(out))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(self.tq)))
        return out

    def spec(self, mode):
        return {"plain": None, "chain": SpecConfig(k=3),
                "tree": SpecConfig(k=4, proposer="model",
                                   draft_cfg=self.cfg,
                                   draft_params=self.draft, tree=True,
                                   branch=2)}[mode]


@pytest.fixture(scope="module")
def g2():
    return Gpt2()


def _engines(cfg, params, D, Bs, **kw):
    common = dict(max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
                  page_size=PAGE, act_dtype=torch.float32, **kw)
    dist = DistributedServeEngine(
        cfg, params, mesh=make_serving_mesh(D, ["cpu"] * D),
        slots_per_shard=Bs, **common)
    single = ServeEngine(cfg, params, batch_slots=D * Bs, device="cpu",
                         **common)
    return dist, single


def _hold(cfg, params, prompts, D, Bs, forced=None, **kw):
    """Distributed vs single-device streams and accept counters;
    ``forced`` (the plain streams) drafts each request's own stream with
    every third token wrong, so verifies accept and reject whatever the
    weights."""
    dist, single = _engines(cfg, params, D, Bs, **kw)
    if forced is not None:
        for e in (dist, single):
            e.proposer = ForcedDrafts(kw["spec"].k, forced, cfg.vocab_size)
    got, want = _serve(dist, prompts), _serve(single, prompts)
    assert got == want
    assert all(len(o) == MAX_NEW for o in got.values())
    ds, ss = dist.stats(), single.stats()
    if kw.get("spec") is not None:
        assert ds["spec_accepted"] == ss["spec_accepted"] > 0
        assert ds["spec_proposed"] == ss["spec_proposed"]
    return dist, got


@pytest.mark.parametrize("mode", ["plain", "chain", "tree"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("layout", ["paged", "stacked"])
def test_distributed_streams_equal_single_device(g2, layout, geom, mode):
    D, Bs = geom
    dist, got = _hold(g2.cfg, g2.tq, g2.prompts, D, Bs, kv_layout=layout,
                      spec=g2.spec(mode))
    assert dist.kv_layout == layout and dist.stats()["n_shards"] == D
    if layout == "paged" and mode == "plain" and geom == (2, 2):
        jeng = JServeEngine(g2.jcfg, g2.jq, batch_slots=D * Bs,
                            max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
                            page_size=PAGE, kv_layout="paged",
                            act_dtype=jnp.float32)
        assert got == _serve(jeng, g2.prompts)


def _hybrid(which):
    cfg = get_config("recurrentgemma-9b").reduced()
    if which == "mixed":
        cfg = dataclasses.replace(cfg, name="hybrid-mixed-reduced",
                                  block_pattern=("attn", "local_attn",
                                                 "rglru"))
    params = lm.init(cfg, torch.Generator().manual_seed(2), max_seq=MAX_SEQ)
    calib = [np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 16))]
    q = quantize_model_params(params, cfg, calibrate(params, cfg, calib))
    rng = np.random.default_rng(7)
    pat = rng.integers(1, cfg.vocab_size, 6).tolist()
    prompts = [pat * 4, rng.integers(1, cfg.vocab_size, 40).tolist(),
               rng.integers(1, cfg.vocab_size, 9).tolist(), pat * 2]
    return cfg, q, prompts


@pytest.mark.parametrize("mode", ["plain", "chain"])
@pytest.mark.parametrize("which", ["hybrid", "mixed"])
def test_hybrid_and_mixed_streams_equal_single_device(which, mode):
    cfg, q, prompts = _hybrid(which)
    layout = "stacked" if which == "hybrid" else "paged"
    forced = None
    if mode == "chain":
        forced = _serve(_engines(cfg, q, 2, 2, kv_layout=layout)[1],
                        prompts)
    dist, _ = _hold(cfg, q, prompts, 2, 2, forced=forced, kv_layout=layout,
                    spec=None if mode == "plain" else SpecConfig(k=3))
    assert dist.kv_layout == layout
    assert dist._state_store is not None


def test_prefix_affinity_locality_and_overlap(g2):
    """The second same-prefix request lands on the first's shard and
    links its page; every cache tensor of shard s stays on its device
    and the block tables resolve in the shard's own pool; the largest
    transfer is below one page-pool leaf; the overlap ratio holds the
    reference's bound; the stats keys are the documented set."""
    mesh = make_serving_mesh(2, ["cpu"] * 2)
    eng = DistributedServeEngine(
        g2.cfg, g2.tq, mesh=mesh, slots_per_shard=2, max_seq=MAX_SEQ,
        eos_id=-1, chunk_size=CHUNK, page_size=PAGE,
        act_dtype=torch.float32)
    for p in g2.prompts:
        eng.submit(p, max_new=MAX_NEW)
    while eng.queue or any(s is not None for s in eng.slots) \
            or any(p is not None for p in eng._pending_wave):
        eng.tick()
        eng.kv.check_shard_locality(eng.caches, mesh)
    eng.xfer.sync()
    done = {r.rid: r for r in eng.finished}
    assert eng.kv.shard_of(done[2].slot)[0] == eng.kv.shard_of(
        done[3].slot)[0]
    s = eng.stats()
    assert s["prefix_hit_pages"] > 0
    leaf = eng.caches[0]["layers"][0]["k"]
    assert 0 < s["max_transfer_bytes"] < leaf.numel() * leaf.element_size()
    assert s["overlap_ratio"] >= 0.5
    assert set(s) == telemetry.STATS_KEYS_DISTRIBUTED
    assert s["pages_in_use"] == 0 and s["requests"] == len(g2.prompts)
    assert {r: o.out for r, o in done.items()} == _serve(
        _engines(g2.cfg, g2.tq, 2, 2)[1], g2.prompts)


@pytest.mark.parametrize("layout,mode", [("stacked", "state"),
                                         ("paged", "recompute")])
def test_migration_keeps_streams(g2, layout, mode):
    """A migrated stream is the unmigrated one token for token, whether
    its cache travels through the host or it re-prefills on the target
    shard."""
    dist, single = _engines(g2.cfg, g2.tq, 2, 2, kv_layout=layout)
    want = _serve(single, g2.prompts)
    for p in g2.prompts:
        dist.submit(p, max_new=MAX_NEW)
    moved = None
    while moved is None:
        dist.tick()
        req = next((r for r in dist.slots if r is not None
                    and r.state == DECODE and len(r.out) >= 2), None)
        if req is not None:
            src = dist.kv.shard_of(req.slot)[0]
            assert dist.migrate(req.rid, 1 - src, mode=mode)
            moved = (req, src)
    got = {r.rid: r.out for r in dist.run()}
    assert got == want
    req, src = moved
    assert req.n_migrations == 1 and dist.kv.shard_of(req.slot)[0] != src
    s = dist.stats()
    assert s["migrations"] == 1
    assert (s["migrated_bytes_total"] > 0) == (mode == "state")


def test_preempt_resume_keeps_streams(g2):
    """Over-commit on per-shard pools too small for every reservation:
    requests are preempted (to host and by recompute) and resume; the
    streams are the uninterrupted ones."""
    want = _serve(_engines(g2.cfg, g2.tq, 2, 2)[1], g2.prompts, 20)
    dist = DistributedServeEngine(
        g2.cfg, g2.tq, mesh=make_serving_mesh(2, ["cpu"] * 2),
        slots_per_shard=2, max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
        page_size=PAGE, n_pages=9, act_dtype=torch.float32,
        admission=admission.OvercommitAdmission(g2.cfg, chunk_size=CHUNK))
    assert _serve(dist, g2.prompts, 20) == want
    s = dist.stats()
    assert s["preempt_host"] > 0 and s["restores"] > 0
    assert s["pages_in_use"] == 0


@pytest.mark.parametrize("weights", ["w8a8", "float"])
def test_ring_tp_engine_streams_equal(g2, weights):
    """``ServeEngine(mesh=)`` runs every linear through the ring: the W8A8
    ones column-split (bit-identical), the float ones through the ring
    all-gather matmul; the streams are the unsharded engine's."""
    params = g2.tq if weights == "w8a8" else g2.fp
    mesh = make_host_mesh(model=4, devices=["cpu"] * 4)
    kw = dict(batch_slots=4, max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
              page_size=PAGE, act_dtype=torch.float32, device="cpu")
    want = _serve(ServeEngine(g2.cfg, params, **kw), g2.prompts)
    assert _serve(ServeEngine(g2.cfg, params, mesh=mesh, **kw),
                  g2.prompts) == want


def test_distributed_refusals(g2):
    kw = dict(mesh=make_serving_mesh(2, ["cpu"] * 2), max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="encoder-decoder"):
        DistributedServeEngine(get_config("whisper-large-v3").reduced(),
                               {}, **kw)
    with pytest.raises(ValueError, match="no 'shard'"):
        DistributedServeEngine(g2.cfg, g2.tq, max_seq=MAX_SEQ,
                               mesh=make_host_mesh(2, ["cpu"] * 2))
    cfg, q, _ = _hybrid("hybrid")
    with pytest.raises(ValueError, match="tree speculation"):
        DistributedServeEngine(cfg, q, spec=SpecConfig(
            k=2, proposer="model", draft_cfg=g2.cfg, draft_params=g2.draft,
            tree=True), **kw)


@pytest.mark.parametrize("layout,spec,migrate", [
    ("paged", True, False), ("stacked", False, True),
    ("paged", False, True)], ids=["paged-chain", "stacked-migrated",
                                  "paged-migrated"])
def test_dist_schedule_probe_recomputes_served_tokens(g2, layout, spec,
                                                      migrate):
    """The near-tie rule (``serving/near_tie.py``) for the distributed runs:
    ``DistScheduleProbe`` records each request's calls across its shards
    (and its migrations, by state and by recompute), and
    ``logits_after`` replaying them in a shard's batch of rows prefers
    every token the run served."""
    eng = DistributedServeEngine(
        g2.cfg, g2.tq, mesh=make_serving_mesh(2, ["cpu"] * 2),
        slots_per_shard=2, max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
        page_size=PAGE, act_dtype=torch.float32, kv_layout=layout,
        spec=SpecConfig(k=3) if spec else None)
    prompts = g2.prompts[:5]
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    with near_tie.DistScheduleProbe(eng) as probe:
        moved = 0
        while migrate and moved < 2:
            eng.tick()
            r = next((r for r in eng.slots if r is not None
                      and r.state == DECODE and len(r.out) >= 3
                      and r.n_migrations == 0 and r.migrate_to is None),
                     None)
            if r is not None:
                assert eng.migrate(r.rid, 1 - eng.kv.shard_of(r.slot)[0],
                                   mode="state" if moved == 0
                                   else "recompute")
                moved += 1
        out = {r.rid: r.out for r in eng.run()}
    assert eng.migrations == (2 if migrate else 0)
    fn = near_tie.served_logits(eng.params, g2.cfg, probe.calls,
                                torch.device("cpu"), max_seq=MAX_SEQ,
                                page=PAGE, chunk=CHUNK, rows=2, layout=layout)
    prefilled = near_tie.Prefilled()
    for rid, o in out.items():
        for i in range(len(o)):
            lg = fn(rid, prompts[rid], o[:i], prefilled=prefilled)
            assert int(lg.argmax()) == o[i]


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.serving.distributed, repro_torch.core.ring\n"
        "import repro_torch.core.collectives, repro_torch.launch.mesh\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
