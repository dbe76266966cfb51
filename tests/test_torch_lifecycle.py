"""The port's request lifecycle on the CPU against the JAX package's: the
state machine's legality table, priority / deadline admission order, the
victim policy and over-commit pricing (host-side, equal), and the
detours on the engine at float32 activations, where greedy streams are
compared token for token:

* preempt-then-resume, to host and by recompute, on both layouts, plain
  and with chain speculation (n-gram and model drafts), gives the
  uninterrupted stream, and the JAX engine's stream with equal
  ``preemptions`` / ``restores`` / ``preempt_*`` counts (the JAX paged
  speculative path fails on this CPU, ROADMAP C1, so speculation is held
  against the JAX engine on the stacked layout only);
* over-commit admission completes a request that reservation pricing
  refuses, with the reference's stream and preemption count;
* a higher-priority arrival preempts a lower-priority victim as in the
  reference;
* ``cancel`` under churn (queued and seated requests, shared prefixes)
  drains every page refcount to zero.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import admission as jadmission
from repro.serving import lifecycle as jlifecycle
from repro.serving import sampler as jsampler
from repro.serving import speculative as jspec
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serving import admission, lifecycle, sampler, speculative
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.lifecycle import (CANCELLED, DECODE, DONE,
                                           LEGAL_TRANSITIONS, TERMINAL,
                                           IllegalTransition, Request,
                                           admission_key, transition)

MAX_SEQ, SLOTS, CHUNK, MAX_NEW = 64, 3, 8, 8
_LIFECYCLE = ("preemptions", "preempt_host", "preempt_recompute",
              "restores", "cancelled")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    rng = np.random.default_rng(7)
    draft = jax.tree_util.tree_map(
        lambda x: x + 0.25 * jnp.std(x) * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype), params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for n in (3, 17, 5)]
    return dict(
        jcfg=jcfg, cfg=get_config("gpt2-345m").reduced(), jparams=params,
        tparams=bridge.params_from_numpy(jax.device_get(params)),
        jdraft=draft, tdraft=bridge.params_from_numpy(jax.device_get(draft)),
        prompts=prompts)


# ---------------------------------------------------------------------------
# host-side: equal to the reference


def test_transition_table_matches_reference():
    """The same table, and every (current, new) pair either moves the
    request or raises leaving it untouched."""
    assert LEGAL_TRANSITIONS == jlifecycle.LEGAL_TRANSITIONS
    assert TERMINAL == jlifecycle.TERMINAL
    states = list(LEGAL_TRANSITIONS)
    for cur, new in itertools.product(states, states):
        req = Request(rid=0, prompt=[1], max_new=1, state=cur)
        if new in LEGAL_TRANSITIONS[cur] or (new == cur
                                             and cur not in TERMINAL):
            transition(req, new)
            assert req.state == new
        else:
            with pytest.raises(IllegalTransition):
                transition(req, new)
            assert req.state == cur
    with pytest.raises(IllegalTransition, match="unknown lifecycle"):
        transition(Request(rid=1, prompt=[1], max_new=1, state="limbo"),
                   DECODE)


def _reqs(mod_lifecycle, mod_sampler, specs):
    return [mod_lifecycle.Request(
        rid=rid, prompt=[1], max_new=4, state=state,
        sampling=mod_sampler.SamplingParams(priority=prio,
                                            deadline_s=deadline))
        for rid, prio, deadline, state in specs]


def test_admission_order_and_victim_policy_match_reference():
    rng = np.random.default_rng(3)
    states = [lifecycle.QUEUED, lifecycle.PREEMPTED_HOST,
              lifecycle.PREEMPTED_RECOMPUTE, lifecycle.MIGRATING]
    specs = [(int(rid), int(rng.integers(-1, 2)),
              None if rng.random() < 0.5 else float(rng.integers(0, 3)),
              states[int(rng.integers(0, 4))])
             for rid in rng.permutation(12)]
    tr = _reqs(lifecycle, sampler, specs)
    jr = _reqs(jlifecycle, jsampler, specs)
    assert [r.rid for r in sorted(tr, key=admission_key)] == \
        [r.rid for r in sorted(jr, key=jlifecycle.admission_key)]
    pages = {rid: int(rng.integers(0, 4)) for rid, *_ in specs}
    assert [r.rid for r in admission.victim_order(
        tr, lambda r: pages[r.rid])] == [r.rid for r in jadmission.
                                         victim_order(jr, lambda r: pages[
                                             r.rid])]
    assert [r.rid for r in sorted(_reqs(lifecycle, sampler, [
        (r, 0, None, lifecycle.QUEUED) for r in (5, 2, 9)]),
        key=admission_key)] == [2, 5, 9]


def test_overcommit_pricing_matches_reference(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="watermark"):
            admission.OvercommitAdmission(cfg, watermark=bad)
    oc = admission.OvercommitAdmission(cfg, chunk_size=8, watermark=0.5)
    joc = jadmission.OvercommitAdmission(jcfg, chunk_size=8, watermark=0.5)
    assert oc.overcommit and oc.watermark == joc.watermark
    for plen, new, shared in ((20, 30, 0), (20, 1000, 0), (33, 1, 32)):
        kw = dict(page_size=16, max_seq=64, shared_tokens=shared)
        assert oc.page_price(plen, new, **kw) == \
            joc.page_price(plen, new, **kw)
    assert oc.budget_tokens == joc.budget_tokens


# ---------------------------------------------------------------------------
# the engine


def _spec(setup, kind, jax_side):
    if kind is None:
        return None
    if kind == "ngram":
        return (jspec if jax_side else speculative).SpecConfig(k=3)
    mod = jspec if jax_side else speculative
    return mod.SpecConfig(
        k=3, proposer="model",
        draft_cfg=setup["jcfg"] if jax_side else setup["cfg"],
        draft_params=setup["jdraft"] if jax_side else setup["tdraft"])


def _engine(setup, jax_side, spec=None, **kw):
    common = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
                  chunk_size=CHUNK, spec=_spec(setup, spec, jax_side))
    common.update(kw)
    if jax_side:
        return JServeEngine(setup["jcfg"], setup["jparams"],
                            act_dtype=jnp.float32, **common)
    return ServeEngine(setup["cfg"], setup["tparams"],
                       act_dtype=torch.float32, device="cpu", **common)


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return {r.rid: r.out for r in eng.run()}


def _preempted_run(eng, prompts, mode):
    """Serve ``prompts``, preempting the first decoding request with
    output once, in ``mode``; returns the streams."""
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    for _ in range(30):
        eng.tick()
        victims = [r for r in eng.slots
                   if r is not None and r.state == DECODE and r.out]
        if victims:
            eng._preempt(victims[0], mode)
            break
    assert eng.preemptions == 1, "no decoding request to preempt"
    return {r.rid: r.out for r in eng.run()}


@pytest.mark.parametrize("layout,mode,spec", [
    ("paged", "host", None), ("paged", "recompute", None),
    ("stacked", "host", None), ("stacked", "recompute", None),
    ("paged", "host", "ngram"), ("stacked", "host", "ngram"),
    ("stacked", "recompute", "ngram"), ("stacked", "host", "model"),
])
def test_preempt_resume_matches_uninterrupted_and_reference(setup, layout,
                                                             mode, spec):
    """The victim resumes to its uninterrupted stream: a host restore
    scatters its cache back verbatim, a recompute prefills ``prompt +
    out[:-1]`` and emits nothing from it; with speculation the victim's
    n-gram table or draft-model cache is rebuilt on resume."""
    prompts = setup["prompts"]
    want = _serve(_engine(setup, False, spec, kv_layout=layout), prompts)
    te = _engine(setup, False, spec, kv_layout=layout)
    got = _preempted_run(te, prompts, mode)
    assert got == want
    ts = te.stats()
    assert ts["restores"] == 1 and ts[f"preempt_{mode}"] == 1
    assert (ts["evicted_bytes_total"] > 0) == (mode == "host")
    if layout == "paged":
        assert ts["pages_in_use"] == 0
    else:
        assert ts["slots_in_use"] == 0
    if spec is not None:
        assert ts["spec_accepted"] > 0
    if layout == "stacked" or spec is None:
        je = _engine(setup, True, spec, kv_layout=layout)
        assert _preempted_run(je, prompts, mode) == got
        js = je.stats()
        for key in _LIFECYCLE + ("ticks", "model_calls", "prefill_calls"):
            assert ts[key] == js[key], key


def test_overcommit_completes_where_reservation_refuses(setup):
    """10 prompt + 39 new tokens price 4 pages of 16 under reservation
    but hold at most 48 positions (3 pages): a 4-page pool (3 usable)
    refuses them under reservation; over-commit admits them, preempts
    when the pool runs dry, and finishes the uninterrupted streams, as
    the reference does."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, setup["cfg"].vocab_size, 10).tolist()
               for _ in range(3)]
    kw = dict(kv_layout="paged", page_size=16)
    want = _serve(_engine(setup, False, **kw), prompts, max_new=39)
    reserve = _engine(setup, False, n_pages=4, **kw)
    reserve.submit(prompts[0], max_new=39)
    with pytest.raises(ValueError, match="can never be admitted"):
        reserve.run()
    outs, stats = [], []
    for jax_side in (False, True):
        mod = jadmission if jax_side else admission
        cfg = setup["jcfg"] if jax_side else setup["cfg"]
        eng = _engine(setup, jax_side, n_pages=4, prefix_sharing=False,
                      admission=mod.OvercommitAdmission(cfg, chunk_size=8),
                      **kw)
        outs.append(_serve(eng, prompts, max_new=39))
        stats.append(eng.stats())
    assert outs[0] == want == outs[1]
    assert stats[0]["preemptions"] >= 1 and stats[0]["pages_in_use"] == 0
    for key in _LIFECYCLE + ("ticks", "model_calls", "pages_in_use_peak"):
        assert stats[0][key] == stats[1][key], key


def test_priority_arrival_preempts_a_lower_priority_victim(setup):
    """With every slot busy, a priority-1 arrival preempts the
    lowest-priority, largest, newest seated request and is admitted
    ahead of the queue; every stream is the uninterrupted one."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, setup["cfg"].vocab_size, n).tolist()
               for n in (12, 20, 7, 15)]
    want = _serve(_engine(setup, False, batch_slots=4), prompts)
    runs = []
    for jax_side in (False, True):
        eng = _engine(setup, jax_side)
        smod = jsampler if jax_side else sampler
        for p in prompts[:3]:
            eng.submit(p, max_new=MAX_NEW)
        for _ in range(4):
            eng.tick()
        eng.submit(prompts[3], max_new=MAX_NEW,
                   sampling=smod.SamplingParams(priority=1))
        done = eng.run()
        runs.append(({r.rid: r.out for r in done}, eng.stats(),
                     [r.rid for r in done]))
    (got, ts, order), (jgot, js, jorder) = runs
    assert got == want == jgot and order == jorder
    assert ts["preemptions"] >= 1
    for key in _LIFECYCLE:
        assert ts[key] == js[key], key


def test_cancel_under_churn_drains_refcounts(setup):
    """Cancelling a queued and a seated request (shared prefixes) frees
    every page; the survivors finish with their uninterrupted streams."""
    rng = np.random.default_rng(4)
    base = [rng.integers(1, setup["cfg"].vocab_size, 16).tolist()
            for _ in range(2)]
    prompts = [base[0], base[0] + [7, 8, 9], base[1], base[1] + [1, 2]]
    eng = _engine(setup, False, batch_slots=2, kv_layout="paged",
                  page_size=16)
    rids = [eng.submit(p, max_new=6) for p in prompts]
    assert eng.cancel(rids[3])
    for _ in range(3):
        eng.tick()
    seated = [r for r in eng.slots if r is not None]
    assert seated and eng.cancel(seated[0].rid)
    assert seated[0].state == CANCELLED
    assert not eng.cancel(rids[3]) and not eng.cancel(999)
    done = eng.run()
    st = eng.stats()
    assert st["cancelled"] == 2 and len(done) == 2
    assert all(r.state == DONE for r in done)
    assert {r.state for r in eng.cancelled_reqs} == {CANCELLED}
    assert st["pages_in_use"] == 0
    assert all(eng.kv.refcount(p) == 0 for p in range(eng.kv.n_pages))
    keep = {r.rid for r in done}
    want = _serve(_engine(setup, False, batch_slots=2, kv_layout="paged",
                          page_size=16), [prompts[i] for i in sorted(keep)],
                  max_new=6)
    assert [r.out for r in sorted(done, key=lambda r: r.rid)] == \
        [want[i] for i in sorted(want)]
