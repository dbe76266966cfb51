"""The per-kind paged layout of a mixed stack in the port against the JAX
package, on the CPU: the reference test's pattern ``("attn",
"local_attn", "rglru")`` at ``recurrentgemma-9b``'s reduced widths (as
``tests/test_hybrid_serving.py``'s ``mixed_setup``: d 64, 4 heads over
one KV head of 16, window 32), with the weights carried across by the
bridge.  ``attn`` layers take the page pool; the ring and the RG-LRU
state stay slot-resident, one row per slot.

Held against the reference on the same numpy inputs:

* ``init_cache(layout="paged", slots=, slot_seq=)``: every entry's shape
  and dtype, and the ``ValueError`` of a mixed stack without ``slots``
  and of an attention-free stack;
* float32 logits of paged prefill chunks (a ragged one, one crossing the
  window), decode steps with an idle row riding along, a chain verify
  with per-row ``valids`` and its commit, all within ``atol = rtol =
  1e-4`` (the dense family's tolerance), and the cache after them within
  ``1e-5``: every ring and state row, and the pages at each row's live
  positions (above them the reference drops a verify's writes past
  ``valids`` and the port keeps them, both masked by the lengths);
* ``FIFOAdmission.combined_price`` and its over-commit sibling on a grid
  of prompt lengths, generation budgets and shared tokens: equal;
* W8A8 greedy streams of the port's engine (``kv_layout="auto"``, which
  pages the mixed stack) equal to the JAX engine's paged streams, plain
  and with chain speculation.

Within the port: mixed paged equals mixed stacked bit for bit, plain and
with chain speculation on forced drafts that are accepted and rejected;
prefix sharing links two pages, allocates fewer and serves the unshared
streams; preemption to host and by recompute resume to the uninterrupted
streams, and ``StateStore.evict_to_host``/``restore`` round-trip exactly;
``auto`` pages a mixed stack and not an attention-free one; the request
ceiling stays; the bridge carries a mixed paged cache both ways.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import admission as jadmission
from repro.serving import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import admission, speculative
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.lifecycle import DECODE
from test_torch_gpu import ForcedDrafts, _chip_smoke

MAX_SEQ, CHUNK, PS, SLOTS, MAX_NEW = 64, 16, 16, 2, 10
ATOL = RTOL = 1e-4
KV_ATOL = KV_RTOL = 1e-5


def _mixed(get):
    return dataclasses.replace(get("recurrentgemma-9b").reduced(),
                               name="hybrid-mixed-reduced",
                               block_pattern=("attn", "local_attn", "rglru"))


class Mixed:
    """The mixed stack's reference and port objects, made on first use."""

    def __init__(self):
        self.jcfg, self.cfg = _mixed(jget_config), _mixed(get_config)
        self.jparams = jlm.init(self.jcfg, jax.random.PRNGKey(2),
                                max_seq=MAX_SEQ)
        self.tparams = bridge.params_from_numpy(jax.device_get(self.jparams))

    @functools.cached_property
    def jq(self):
        calib = np.random.default_rng(4).integers(1, self.cfg.vocab_size,
                                                  (2, 16))
        stats = jquantize.calibrate(self.jparams, self.jcfg,
                                    [jnp.asarray(calib)])
        return jquantize.quantize_model_params(self.jparams, self.jcfg, stats)

    @functools.cached_property
    def tq(self):
        return bridge.params_from_numpy(jax.device_get(self.jq))

    @functools.cached_property
    def prompts(self):
        """The reference test's mix: a repeated run (drafts accept), a
        random prompt crossing the window (drafts reject), a short one."""
        rng = np.random.default_rng(7)
        pat = rng.integers(1, self.cfg.vocab_size, 6).tolist()
        return [pat * 4, rng.integers(1, self.cfg.vocab_size, 40).tolist(),
                rng.integers(1, self.cfg.vocab_size, 9).tolist()]

    @functools.cached_property
    def plain_stream(self):
        return _serve(self.engine(), self.prompts)

    def engine(self, **kw):
        """A W8A8 engine of the port on the reference-quantized weights."""
        return ServeEngine(self.cfg, self.tq, act_dtype=torch.float32,
                           device="cpu", **_COMMON, **kw)


_COMMON = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
               chunk_size=CHUNK, page_size=PS)


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(list(p), max_new=max_new)
    return {r.rid: r.out for r in eng.run()}


@pytest.fixture(scope="module")
def mixed():
    return Mixed()


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# against the reference


def test_init_cache_matches_reference(mixed):
    """Pages for the ``attn`` layer, ``slots`` rows of ``slot_seq`` (a ring
    of the window) for the others; the refusals of both packages."""
    jc = jlm.init_cache(mixed.jcfg, 9, PS, layout="paged", slots=3,
                        slot_seq=MAX_SEQ)
    tc = lm.init_cache(mixed.cfg, 9, PS, layout="paged", slots=3,
                       slot_seq=MAX_SEQ)
    want = bridge.cache_from_numpy(jax.device_get(jc))
    assert len(tc["layers"]) == len(want["layers"]) == mixed.cfg.n_layers
    for got, ref in zip(tc["layers"], want["layers"]):
        assert got.keys() == ref.keys()
        for k in got:
            assert (got[k].shape, got[k].dtype) == (ref[k].shape,
                                                    ref[k].dtype), k
    assert tc["layers"][0]["k"].shape[0] == 9  # pages
    assert tc["layers"][1]["k"].shape[:3] == (3, 1, mixed.cfg.window)
    for mod, cfg in ((jlm, mixed.jcfg), (lm, mixed.cfg)):
        with pytest.raises(ValueError, match="slots= and slot_seq="):
            mod.init_cache(cfg, 9, PS, layout="paged")
    for mod, get in ((jlm, jget_config), (lm, get_config)):
        with pytest.raises(ValueError, match="global-attention"):
            mod.init_cache(get("recurrentgemma-9b").reduced(), 9, PS,
                           layout="paged", slots=3, slot_seq=MAX_SEQ)


def test_paged_steps_match_reference(mixed):
    """Float32 caches: chunked prefill of two requests into their pages
    and slots (a ragged chunk, a prompt crossing the window), decode steps
    with an idle third row, a chain verify (``valids`` 5, 3 and a parked
    row) with its commit (3 and 1 tokens kept), one more decode step: the
    logits after every call and every cache entry after them."""
    jcfg, cfg, jp, tp = mixed.jcfg, mixed.cfg, mixed.jparams, mixed.tparams
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (11, 40)]
    B, n_pg = 3, MAX_SEQ // PS
    n_pages = 1 + B * n_pg
    bt = np.zeros((B, n_pg), np.int32)
    ids = 1 + np.random.default_rng(2).permutation(n_pages - 1)
    for b in range(len(prompts)):
        bt[b] = ids[b * n_pg:(b + 1) * n_pg]
    kw = dict(layout="paged", slots=B, slot_seq=MAX_SEQ)
    jc = jlm.init_cache(jcfg, n_pages, PS, dtype=jnp.float32, **kw)
    tc = lm.init_cache(cfg, n_pages, PS, dtype=torch.float32, **kw)
    out_j, out_t = [], []
    for b, prompt in enumerate(prompts):
        for off in range(0, len(prompt), CHUNK):
            n = min(CHUNK, len(prompt) - off)
            chunk = np.zeros(CHUNK, np.int32)
            chunk[:n] = prompt[off:off + n]
            lj, jc = jlm.prefill_into_slot(
                jp, jcfg, jnp.asarray(chunk), jc, b, off, valid=n,
                block_table=jnp.asarray(bt[b]), dtype=jnp.float32)
            lt, tc = lm.prefill_into_slot(
                tp, cfg, torch.from_numpy(chunk), tc, off, slot=b, valid=n,
                block_table=torch.from_numpy(bt[b]), dtype=torch.float32)
            out_j.append(np.asarray(lj))
            out_t.append(lt.numpy())
    lengths = np.array([len(p) for p in prompts] + [0], np.int32)
    active = np.array([True, True, False])
    tok = np.array([[p[-1]] for p in prompts] + [[0]], np.int32)

    def step(tok, lengths, jc, tc):
        lj, jc = jlm.decode_step(
            jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(lengths),
            active=jnp.asarray(active), block_table=jnp.asarray(bt),
            dtype=jnp.float32)
        lt, tc = lm.decode_step(
            tp, cfg, torch.from_numpy(tok), tc, torch.from_numpy(lengths),
            active=torch.from_numpy(active),
            block_table=torch.from_numpy(bt), dtype=torch.float32)
        out_j.append(np.asarray(lj)[:-1])
        out_t.append(lt.numpy()[:-1])
        return np.asarray(lj).argmax(-1).astype(np.int32)[:, None], jc, tc

    for _ in range(3):
        tok, jc, tc = step(tok, lengths, jc, tc)
        lengths = lengths + active
    C = 5
    toks = rng.integers(1, cfg.vocab_size, (B, C)).astype(np.int32)
    toks[:, 0] = tok[:, 0]
    vlen = np.where(active, lengths, MAX_SEQ).astype(np.int32)
    valids = np.array([5, 3, 0], np.int32)
    counts = np.array([3, 1, 0], np.int32)
    jprev = jc
    lj, jc, jtraj = jlm.verify_chunk(
        jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(vlen),
        valids=jnp.asarray(valids), block_tables=jnp.asarray(bt),
        with_traj=True, dtype=jnp.float32)
    jc = jlm.commit_verify(jcfg, jprev, jc, jtraj, jnp.asarray(vlen),
                           jnp.asarray(counts), jnp.asarray(valids), chunk=C)
    tvlen = torch.from_numpy(vlen)
    snap = lm.verify_snapshot(cfg, tc, tvlen, chunk=C)
    lt, tc, traj = lm.verify_chunk(
        tp, cfg, torch.from_numpy(toks), tc, tvlen,
        valids=torch.from_numpy(valids), block_tables=torch.from_numpy(bt),
        with_traj=True, dtype=torch.float32)
    tc = lm.commit_verify(cfg, snap, tc, traj, tvlen,
                          torch.from_numpy(counts), torch.from_numpy(valids),
                          chunk=C)
    out_j.append(np.asarray(lj)[:2])
    out_t.append(lt.numpy()[:2])
    lengths = lengths + counts
    tok = toks[np.arange(B), np.maximum(counts - 1, 0)][:, None]
    _, jc, tc = step(tok, lengths, jc, tc)
    assert len(out_t) == 1 + 3 + 3 + 1 + 1
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    # the pages at each row's live positions (above them lie rejected
    # drafts, which the reference drops past ``valids`` and the port
    # writes, both masked), every ring and state row
    lengths = lengths + active
    live = [(bt[b, p // PS], p % PS) for b in range(B)
            for p in range(lengths[b])]
    pg, off = (np.array(x) for x in zip(*live))
    back = bridge.cache_to_numpy(tc, n_per=1, period=3)
    for li, (a, b) in enumerate(zip(jc["periods"], back["periods"])):
        for k in a:
            want, got = np.asarray(a[k], np.float32)[0], b[k][0]
            if li == 0:
                want, got = want[pg, :, off], got[pg, :, off]
            np.testing.assert_allclose(got, want, rtol=KV_RTOL,
                                       atol=KV_ATOL, err_msg=f"{li}/{k}")


@pytest.mark.parametrize("cls", ["FIFOAdmission", "OvercommitAdmission"])
def test_combined_price_matches_reference(mixed, cls):
    """The larger of the page and the slot-resident cost, on the mixed
    stack and on a global-attention one (pages alone)."""
    pairs = [(mixed.jcfg, mixed.cfg),
             (jget_config("gpt2-345m").reduced(),
              get_config("gpt2-345m").reduced())]
    for jcfg, cfg in pairs:
        j = getattr(jadmission, cls)(jcfg, chunk_size=CHUNK)
        t = getattr(admission, cls)(cfg, chunk_size=CHUNK)
        for plen in (1, 15, 16, 17, 40, 63, 200):
            for max_new in (1, 8, 30):
                for shared in (0, 16, 32, 48):
                    kw = dict(page_size=PS, max_seq=MAX_SEQ,
                              shared_tokens=shared)
                    assert t.combined_price(cfg, plen, max_new, **kw) == \
                        j.combined_price(jcfg, plen, max_new, **kw), \
                        (cfg.name, plen, max_new, shared)


@pytest.mark.parametrize("spec", [None, 4], ids=["plain", "chain"])
def test_w8a8_streams_equal_jax_paged(mixed, spec):
    """Greedy W8A8 streams of the port's auto-layout engine (paged) equal
    the JAX engine's on its per-kind paged layout, token for token."""
    sc = {} if spec is None else {"spec": speculative.SpecConfig(k=spec)}
    eng = mixed.engine(**sc)
    assert eng.paged and eng._state_store is not None
    got = _serve(eng, mixed.prompts)
    from repro.serving.speculative import SpecConfig as JSpecConfig
    jsc = {} if spec is None else {"spec": JSpecConfig(k=spec)}
    jeng = JServeEngine(mixed.jcfg, mixed.jq, kv_layout="paged",
                        act_dtype=jnp.float32, **_COMMON, **jsc)
    assert got == _serve(jeng, mixed.prompts)
    if spec is not None:
        assert eng.spec_ticks > 0
    else:
        assert got == mixed.plain_stream


# ---------------------------------------------------------------------------
# within the port


@pytest.mark.parametrize("variant", ["plain", "forced"])
def test_paged_equals_stacked(mixed, variant):
    """Bit for bit: plain decode, and chain speculation (k 4) on drafts of
    the plain stream with every third token wrong, so the page rewind and
    the slot-resident commit both run in one verify."""
    streams = {}
    for layout in ("paged", "stacked"):
        eng = mixed.engine(kv_layout=layout, **(
            {} if variant == "plain"
            else {"spec": speculative.SpecConfig(k=4)}))
        if variant == "forced":
            eng.proposer = ForcedDrafts(4, mixed.plain_stream,
                                        mixed.cfg.vocab_size)
        assert eng.paged == (layout == "paged")
        streams[layout] = _serve(eng, mixed.prompts)
        if variant == "forced":
            assert 0 < eng.spec_accepted < eng.spec_proposed
    assert streams["paged"] == streams["stacked"] == mixed.plain_stream


def test_prefix_sharing_saves_pages(mixed):
    """Two prompts with a shared two-page head: the second links both
    pages (fewer allocated), its slot-resident state is prefilled again
    from position 0, and the streams equal the unshared run's."""
    head = np.random.default_rng(13).integers(1, mixed.cfg.vocab_size,
                                              2 * PS).tolist()
    prompts = [head + [3], head + [4]]
    shared = mixed.engine()
    unshared = mixed.engine(prefix_sharing=False)
    got = _serve(shared, prompts, max_new=4)
    assert got == _serve(unshared, prompts, max_new=4)
    assert shared.kv.prefix_hit_pages == 2
    assert unshared.kv.prefix_hit_pages == 0
    assert (shared.kv.pages_allocated_total
            < unshared.kv.pages_allocated_total)
    assert shared.prefill_calls == unshared.prefill_calls == 2 * (
        -(-(2 * PS + 1) // CHUNK))


@pytest.mark.parametrize("mode", ["host", "recompute"])
def test_preempt_resume_equals_uninterrupted(mixed, mode):
    """The first decoding request with output is preempted once: a host
    restore carries its pages and its ring and state rows, a recompute
    prefills ``prompt + out[:-1]``; both resume to the uninterrupted
    streams and the pool drains."""
    eng = mixed.engine()
    for p in mixed.prompts:
        eng.submit(p, max_new=MAX_NEW)
    for _ in range(40):
        eng.tick()
        victims = [r for r in eng.slots
                   if r is not None and r.state == DECODE and r.out]
        if victims:
            eng._preempt(victims[0], mode)
            break
    assert {r.rid: r.out for r in eng.run()} == mixed.plain_stream
    s = eng.stats()
    assert s["preemptions"] == s["restores"] == s[f"preempt_{mode}"] == 1
    assert (s["evicted_bytes_total"] > 0) == (mode == "host")
    assert s["pages_in_use"] == 0


def test_state_store_round_trip(mixed):
    """``StateStore.evict_to_host`` takes one slot's ring and state rows
    and no page; ``restore`` writes them into another slot exactly, the
    pages untouched; the manager's host blob carries pages and rows."""
    eng = mixed.engine()
    eng.submit(mixed.prompts[1], max_new=3)
    eng.run()
    cache, store = eng.kv.cache, eng.kv.state
    gen = torch.Generator().manual_seed(5)
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = [{k: t.clone() for k, t in layer.items()}
              for layer in cache["layers"]]
    blob = store.evict_to_host(cache, 0)
    assert blob["layers"][0]["k"].shape[0] == 0  # no page of the attn layer
    store.restore(cache, blob, 1)
    for li, (layer, old) in enumerate(zip(cache["layers"], before)):
        for k, t in layer.items():
            if li == 0:
                assert torch.equal(t, old[k])
            else:
                assert torch.equal(t[1], old[k][0])
                assert torch.equal(t[0], old[k][0])
    pages = [3, 1]
    want = lm.gather_request_cache(mixed.cfg, cache, 1, page_ids=pages)
    assert torch.equal(want["layers"][0]["v"], cache["layers"][0]["v"][pages])
    assert torch.equal(want["layers"][2]["h"], cache["layers"][2]["h"][1])


@pytest.mark.parametrize("arch", ["mixed", "recurrentgemma-9b"])
def test_auto_layout(mixed, arch):
    """``auto`` pages a stack with a global-attention layer and serves an
    attention-free one stacked, whose paged layout is refused."""
    if arch == "mixed":
        cfg, params = mixed.cfg, mixed.tparams
    else:
        cfg = get_config(arch).reduced()
        params = lm.init(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, batch_slots=1, max_seq=MAX_SEQ,
                      eos_id=-1, device="cpu")
    assert eng.paged == (arch == "mixed")
    assert (eng.kv.state is not None) and eng._state_store is eng.kv.state
    if arch != "mixed":
        with pytest.raises(ValueError, match="global-attention"):
            ServeEngine(cfg, params, batch_slots=1, max_seq=MAX_SEQ,
                        eos_id=-1, device="cpu", kv_layout="paged")


def test_bounded_mixed_keeps_ceiling(mixed):
    """The ``attn`` layer prices the whole sequence: the ceiling stays on
    the paged layout and an over-long prompt is refused."""
    eng = mixed.engine()
    assert eng.paged and eng.seq_ceiling == MAX_SEQ
    with pytest.raises(ValueError, match="fit the cache"):
        eng.submit(list(range(1, MAX_SEQ + 2)), max_new=4)


def test_bridge_carries_mixed_paged_cache(mixed):
    """A JAX mixed paged cache into the port and back, leaf for leaf."""
    jc = jlm.init_cache(mixed.jcfg, 9, PS, layout="paged", slots=3,
                        slot_seq=MAX_SEQ, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    jc = jax.tree_util.tree_map(
        lambda t: jnp.asarray(rng.standard_normal(t.shape), t.dtype), jc)
    host = jax.device_get(jc)
    back = bridge.cache_to_numpy(bridge.cache_from_numpy(host), n_per=1,
                                 period=3)
    want, got = list(_leaves(host)), list(_leaves(back))
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a))


# ---------------------------------------------------------------------------
# chip_smoke.py's near-tie rule along the served call schedule


def _probed(cs, eng, prompts, *, preempt=None, emit=None):
    """Serve ``prompts`` under ``cs.ScheduleProbe``: ``preempt`` names a
    mode in which the first decoding request with output is preempted
    once; ``emit`` replaces the engine's ``_emit`` (a planted fault).
    Returns (rid -> tokens, rid -> calls)."""
    if emit is not None:
        eng._emit = emit(eng._emit)
    for p in prompts:
        eng.submit(list(p), max_new=MAX_NEW)
    with cs.ScheduleProbe(eng) as probe:
        while preempt is not None:
            eng.tick()
            victims = [r for r in eng.slots
                       if r is not None and r.state == DECODE and r.out]
            if victims:
                eng._preempt(victims[0], preempt)
                preempt = None
        out = {r.rid: r.out for r in eng.run()}
    return out, probe.calls


@pytest.mark.parametrize("case", ["mixed paged plain", "mixed paged forced",
                                  "mixed stacked forced",
                                  "mixed paged recompute",
                                  "gpt2 paged tree", "gpt2 paged replay"])
def test_schedule_replay_recomputes_the_served_logits(mixed, case):
    """``logits_after`` along a request's recorded calls (prefill chunks,
    decode steps, chain verifies with their valid counts and commits, a
    recompute resume's prefill, tree verifies with their compaction, a
    replayed prompt) gives, for every token of the stream, logits whose
    argmax is the token the engine emitted: the recomputation is the
    computation that served it (on the CPU bit for bit)."""
    cs = _chip_smoke()
    arch, layout, variant = case.split()
    kw = {"kv_layout": layout}
    if arch == "mixed":
        cfg, params, prompts = mixed.cfg, mixed.tq, mixed.prompts
        if variant == "forced":
            kw["spec"] = speculative.SpecConfig(k=4)
        eng = mixed.engine(**kw)
        if variant == "forced":
            eng.proposer = ForcedDrafts(4, mixed.plain_stream,
                                        cfg.vocab_size)
    else:
        cfg = get_config("gpt2-345m").reduced()
        params = lm.init(cfg, torch.Generator().manual_seed(0),
                         max_seq=MAX_SEQ)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (7, 30)]
        if variant == "tree":
            # a draft near the target: some accepted paths leave the
            # first children, so the engine compacts them
            kw["spec"] = speculative.SpecConfig(
                k=4, proposer="model", draft_cfg=cfg, tree=True, branch=2,
                draft_params=serve.noisy_copy(params, 11, 0.1))
        else:
            kw["prefill_mode"] = "replay"
        eng = ServeEngine(cfg, params, act_dtype=torch.float32,
                          device="cpu", **_COMMON, **kw)
    out, calls = _probed(cs, eng, prompts, preempt=(
        "recompute" if variant == "recompute" else None))
    kinds = {c["kind"] for cs_ in calls.values() for c in cs_}
    want = {"plain": {"prefill", "step"}, "recompute": {"prefill", "step"},
            "forced": {"prefill", "verify"}, "tree": {"prefill", "verify"},
            "replay": {"step"}}[variant]
    assert want <= kinds <= want | {"step"}
    if variant == "recompute":
        assert eng.stats()["preempt_recompute"] == 1
    if variant == "tree":
        assert any("path" in c and (c["path"] < MAX_SEQ).any()
                   for cs_ in calls.values() for c in cs_)
    for rid, toks in out.items():
        for i, tok in enumerate(toks):
            lg = cs.logits_after(params, cfg, calls[rid], prompts[rid],
                                 toks[:i], torch.device("cpu"),
                                 max_seq=MAX_SEQ, page=PS, chunk=CHUNK,
                                 rows=SLOTS, layout=layout)
            assert int(lg.argmax()) == tok, (rid, i)


def test_near_tie_rule_fails_a_forced_wrong_token(mixed, capsys):
    """A planted fault: one token of one served stream forced wrong (the
    engine's emitted token replaced, the run going on from it).  Held
    against a fault-free run, the streams part there, and the faulty
    side's logits recomputed along its own calls prefer the token its
    computation sampled: a negative margin, which fails the rule.  Two
    fault-free runs (paged plain, paged chain on forced drafts) pass."""
    cs = _chip_smoke()
    shape = dict(max_seq=MAX_SEQ, page=PS, chunk=CHUNK, rows=SLOTS)
    cpu = torch.device("cpu")
    plain, plain_calls = _probed(cs, mixed.engine(), mixed.prompts)
    eng = mixed.engine(spec=speculative.SpecConfig(k=4))
    eng.proposer = ForcedDrafts(4, mixed.plain_stream, mixed.cfg.vocab_size)
    chain, chain_calls = _probed(cs, eng, mixed.prompts)
    fns = [cs.served_logits(mixed.tq, mixed.cfg, c, cpu, **shape)
           for c in (chain_calls, plain_calls)]
    assert cs.hold_streams("fault-free", (chain, plain), mixed.prompts, fns,
                           MAX_NEW) == 1.0

    def wrong_fifth_token_of_request_1(emit):
        def emit_(req, tok, now):
            if req.rid == 1 and len(req.out) == 4:
                tok = (tok + 1) % mixed.cfg.vocab_size
            return emit(req, tok, now)
        return emit_

    faulty, faulty_calls = _probed(cs, mixed.engine(), mixed.prompts,
                                   emit=wrong_fifth_token_of_request_1)
    assert faulty[1][4] != plain[1][4] and faulty[0] == plain[0]
    with pytest.raises(cs.SmokeFailure, match="prefers the other side"):
        cs.hold_streams(
            "planted fault", (faulty, plain), mixed.prompts,
            (cs.served_logits(mixed.tq, mixed.cfg, faulty_calls, cpu,
                              **shape), fns[1]), MAX_NEW)
    assert "request 1 parts at token 4" in capsys.readouterr().out
