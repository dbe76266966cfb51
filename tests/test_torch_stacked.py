"""The port's stacked target layout on the CPU against the JAX package's.

``kv_layout="stacked"`` gives each request one contiguous ``max_seq``
region of the cache (``SlotCacheManager``); decode runs the contiguous
decode kernel's plain version (``ops.mha_decode``), chunks attend in
plain PyTorch, causal or tree-masked, as in the reference.

Held against the reference on the same numpy inputs:

* the slot manager's bookkeeping (the heap free list's lowest-first
  order, lengths, mask-only rewind, host round trip), ``slot_price`` and
  the engine's request ceiling: equal;
* ``verify_chunk`` and ``compact_accepted_path`` on the stacked cache,
  chain and tree: logits ``atol = rtol = 1e-4`` at float32 activations,
  the written K/V within one bf16 ulp (``rtol = 2**-7``, ``atol = 1e-6``);
* the engine at float32 activations: the stacked greedy streams equal
  the port's paged streams and the JAX stacked engine's, token for token,
  plainly, with chain speculation and with tree speculation (n-gram and
  model drafts), with the same schedule and spec counters and the same
  ``stats()`` keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import admission as jadmission
from repro.serving import kv_cache as jkv_cache
from repro.serving import speculative as jspec
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import admission, kv_cache, speculative
from repro_torch.serving.engine import ServeEngine

MAX_SEQ, PAGE, SLOTS, CHUNK, MAX_NEW = 64, 8, 2, 8, 8
ATOL = RTOL = 1e-4
KV_RTOL, KV_ATOL = 2 ** -7, 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    # a draft that is the target plus 0.25 std of seeded noise, so that
    # drafts are both accepted and rejected
    rng = np.random.default_rng(7)
    draft = jax.tree_util.tree_map(
        lambda x: x + 0.25 * jnp.std(x) * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype), params)
    # prompts that repeat short runs (the n-gram proposer drafts) and
    # start with distinct tokens
    rng = np.random.default_rng(3)
    firsts = rng.permutation(np.arange(1, jcfg.vocab_size))
    prompts = []
    for first, n in zip(firsts, (6, 19, 11, 27)):
        run = rng.integers(1, jcfg.vocab_size, int(rng.integers(2, 5)))
        prompts.append([int(first)] + (run.tolist() * n)[:n - 1])
    return dict(
        jcfg=jcfg, cfg=get_config("gpt2-345m").reduced(), jparams=params,
        tparams=bridge.params_from_numpy(jax.device_get(params)),
        jdraft=draft, tdraft=bridge.params_from_numpy(jax.device_get(draft)),
        prompts=prompts)


# ---------------------------------------------------------------------------
# host-side bookkeeping: equal to the reference


def test_slot_manager_matches_reference(setup):
    """One scripted sequence of claims, frees, advances and rewinds on
    both managers: the heap free list hands out the lowest slot first,
    and lengths, errors and stats agree."""
    jm = jkv_cache.SlotCacheManager(setup["jcfg"], 4, 16)
    tm = kv_cache.SlotCacheManager(setup["cfg"], 4, 16)
    assert [tm.alloc() for _ in range(4)] == [jm.alloc() for _ in range(4)] \
        == [0, 1, 2, 3]
    assert tm.alloc() is None and jm.alloc() is None
    for m in (jm, tm):
        m.free(2)
        m.free(0)
        m.free(3)
        m.advance(1, 7)
        m.advance_mask([False, True, False, False])
        m.rewind(1, 12)
    assert [tm.alloc() for _ in range(3)] == [jm.alloc() for _ in range(3)] \
        == [0, 2, 3]
    np.testing.assert_array_equal(tm.lengths, jm.lengths)
    assert tm.stats() == jm.stats()
    assert tm.pages_held(1) == jm.pages_held(1) == 12
    assert tm.has_room(1, 4) == jm.has_room(1, 4)
    assert tm.has_room(1, 5) == jm.has_room(1, 5)
    with pytest.raises(ValueError, match="outside the cache"):
        tm.rewind(1, 17)
    tm.free(2)
    with pytest.raises(ValueError, match="unallocated"):
        tm.rewind(2, 1)


def test_slot_price_and_ceiling_match_reference(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    ja = jadmission.FIFOAdmission(jcfg, chunk_size=CHUNK)
    ta = admission.FIFOAdmission(cfg, chunk_size=CHUNK)
    for plen, new, cap in ((3, 5, 64), (60, 10, 64), (65, 0, 65), (1, 1, 8)):
        assert ta.slot_price(cfg, plen, new, max_seq=cap) == \
            ja.slot_price(jcfg, plen, new, max_seq=cap)
    te = ServeEngine(cfg, setup["tparams"], max_seq=MAX_SEQ,
                     kv_layout="stacked", device="cpu")
    assert te.seq_ceiling == MAX_SEQ and te.kv_layout == "stacked"


def test_kv_layout_choice(setup):
    """``auto`` pages when the page size divides ``max_seq`` and stacks
    otherwise; an explicit paged layout with a non-divisor raises."""
    cfg, tp = setup["cfg"], setup["tparams"]

    def layout(**kw):
        return ServeEngine(cfg, tp, device="cpu", **kw).kv_layout

    assert layout(max_seq=64, page_size=16) == "paged"
    assert layout(max_seq=60, page_size=16) == "stacked"
    with pytest.raises(ValueError, match="must divide"):
        layout(max_seq=60, page_size=16, kv_layout="paged")
    with pytest.raises(ValueError, match="kv_layout"):
        layout(kv_layout="mixed")


def test_request_cache_round_trip(setup):
    """``gather_request_cache`` copies a request's slot (or pages) to
    host memory, untouched by later writes; ``scatter_request_cache``
    writes it back into another slot (or other pages)."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(5)
    for layout, kw_src, kw_dst in (("stacked", {}, {}),
                                   ("paged", {"page_ids": [3, 1]},
                                    {"page_ids": [2, 4]})):
        cache = lm.init_cache(cfg, 5, 8, layout=layout)
        for c in cache["layers"]:
            for t in c.values():
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
        src = [[t[kw_src.get("page_ids", 1)].clone() for t in c.values()]
               for c in cache["layers"]]
        blob = lm.gather_request_cache(cfg, cache, 1, **kw_src)
        for c in cache["layers"]:
            for t in c.values():
                t.zero_()
        lm.scatter_request_cache(cfg, cache, blob, 4, **kw_dst)
        for c, want in zip(cache["layers"], src):
            for t, w in zip(c.values(), want):
                assert torch.equal(t[kw_dst.get("page_ids", 4)], w)
        assert kv_cache.blob_nbytes({"kv": blob}) == sum(
            w.numel() * w.element_size() for ws in src for w in ws)


# ---------------------------------------------------------------------------
# the model on the stacked cache


def _prefilled(setup, prompts):
    """A JAX stacked cache with each prompt prefilled into its slot."""
    jcfg, jp = setup["jcfg"], setup["jparams"]
    cache = jlm.init_cache(jcfg, len(prompts), MAX_SEQ)
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), CHUNK):
            piece = prompt[off:off + CHUNK]
            chunk = np.zeros(CHUNK, np.int32)
            chunk[:len(piece)] = piece
            _, cache = jlm.prefill_into_slot(
                jp, jcfg, jnp.asarray(chunk), cache, slot, off,
                valid=len(piece), dtype=jnp.float32)
    return cache


def _np_cache(cache, jax_side: bool):
    """float32 numpy (L, 2, B, Hkv, S, hd) of either package's cache."""
    c = bridge.cache_from_numpy(jax.device_get(cache)) if jax_side else cache
    return np.asarray([[t.float().numpy() for t in (l["k"], l["v"])]
                       for l in c["layers"]])


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_stacked_verify_chunk_and_compaction_match_reference(setup, mode):
    """Two live rows and a row parked at ``max_seq``: logits, the K/V
    written at the flat chunk positions, and the accepted paths compacted
    to contiguous positions (one target past the cache, dropped)."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (9, 22)]
    jcache = _prefilled(setup, prompts + [[1]])
    tcache = bridge.cache_from_numpy(jax.device_get(jcache))
    lengths = np.array([9, 22, MAX_SEQ], np.int32)
    k, B = 5, 3
    C = k + 1
    toks = rng.integers(1, cfg.vocab_size, (B, C)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        trees = []
        for n in (5, 3, 0):
            t = speculative.TokenTree()
            for _ in range(n):
                t.add(int(rng.integers(1, 50)), int(rng.integers(0, t.n + 1)))
            trees.append(t if t.n else None)
        _, _, _, anc, depths = speculative.tree_arrays(trees, k, C)
        assert not (anc == np.tril(np.ones((C, C), bool))).all()
        kw_j = dict(anc=jnp.asarray(anc), depths=jnp.asarray(depths))
        kw_t = dict(anc=torch.from_numpy(anc),
                    depths=torch.from_numpy(depths))
    jl, jc = jlm.verify_chunk(setup["jparams"], jcfg, jnp.asarray(toks),
                              jcache, jnp.asarray(lengths),
                              dtype=jnp.float32, **kw_j)
    tl, tc = lm.verify_chunk(setup["tparams"], cfg, torch.from_numpy(toks),
                             tcache, torch.from_numpy(lengths),
                             dtype=torch.float32, **kw_t)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np_cache(tc, False), _np_cache(jc, True),
                               rtol=KV_RTOL, atol=KV_ATOL)
    src = np.full((B, k), MAX_SEQ, np.int32)
    dst = np.full((B, k), MAX_SEQ, np.int32)
    src[0, :3], dst[0, :3] = 9 + np.array([2, 4, 5]), 9 + np.array([1, 2, 3])
    src[1, :2], dst[1, :2] = 22 + np.array([1, 3]), [23, MAX_SEQ + 1]
    jc = jlm.compact_accepted_path(jcfg, jc, jnp.asarray(src),
                                   jnp.asarray(dst))
    tc = lm.compact_accepted_path(cfg, tc, torch.from_numpy(src),
                                  torch.from_numpy(dst))
    np.testing.assert_allclose(_np_cache(tc, False), _np_cache(jc, True),
                               rtol=KV_RTOL, atol=KV_ATOL)


# ---------------------------------------------------------------------------
# the engine


_VARIANTS = {
    "plain": None,
    "chain-ngram": dict(k=4),
    "tree-ngram": dict(k=4, tree=True, branch=2),
    "tree-model": dict(k=5, proposer="model", tree=True, branch=3),
}
_COUNTERS = ("ticks", "model_calls", "prefill_calls", "spec_ticks",
             "spec_proposed", "spec_accepted", "spec_emitted", "draft_calls",
             "slots_in_use_peak")


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run()}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_stacked_streams_match_paged_and_reference(setup, variant):
    kw = _VARIANTS[variant]
    jspec_cfg = tspec_cfg = None
    if kw is not None:
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("proposer") == "model":
            jkw.update(draft_cfg=setup["jcfg"], draft_params=setup["jdraft"])
            tkw.update(draft_cfg=setup["cfg"], draft_params=setup["tdraft"])
        jspec_cfg = jspec.SpecConfig(**jkw)
        tspec_cfg = speculative.SpecConfig(**tkw)
    common = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
                  chunk_size=CHUNK, page_size=PAGE)
    je = JServeEngine(setup["jcfg"], setup["jparams"], kv_layout="stacked",
                      act_dtype=jnp.float32, spec=jspec_cfg, **common)
    outs = {"jax": _serve(je, setup["prompts"])}
    engines = {}
    for layout in ("stacked", "paged"):
        engines[layout] = ServeEngine(
            setup["cfg"], setup["tparams"], kv_layout=layout,
            act_dtype=torch.float32, spec=tspec_cfg, device="cpu", **common)
        outs[layout] = _serve(engines[layout], setup["prompts"])
    assert outs["stacked"] == outs["paged"] == outs["jax"]
    assert all(len(o) == MAX_NEW for o in outs["stacked"].values())
    js, ts = je.stats(), engines["stacked"].stats()
    assert set(ts) == set(js)
    for key in _COUNTERS:
        if key in js:
            assert ts[key] == js[key], key
    if kw is not None:
        assert ts["spec_ticks"] > 0 and ts["spec_accepted"] > 0
        assert ts["spec_accepted"] < ts["spec_proposed"]
    assert ts["slots_in_use"] == 0 and ts["n_free_slots"] == SLOTS
    assert engines["paged"].stats()["pages_in_use"] == 0
