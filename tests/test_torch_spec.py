"""The port's speculative decoding on the CPU against the JAX package's.

Held against the reference on the same numpy inputs:

* host-side code, which must be equal: ``TokenTree``, ``tree_arrays``,
  ``draft_caps``, ``AdaptiveDraft``, ``NgramProposer`` and the page
  manager's ``rewind`` bookkeeping;
* the accept rules: greedy rows equal; stochastic rows draw from a
  ``torch.Generator`` (other numbers than ``jax.random``), so they are
  held to the target distribution by frequency over 20,000 draws, within
  0.015 (about five standard deviations at p = 0.25);
* ``verify_chunk`` and ``compact_accepted_path`` on the paged cache
  (chain and tree) against the reference's on the **stacked** cache (the
  reference's paged spec path fails on this CPU, ROADMAP C1): logits
  ``atol = rtol = 1e-4`` at float32 activations, written K/V within one
  bf16 ulp (``rtol = 2**-7``, ``atol = 1e-6``);
* the stacked cache the draft model runs on: ``decode_step`` and
  ``prefill_into_slot`` logits within 1e-4, caches within one ulp;
* the engine: at float32 activations the greedy streams of every spec
  variant (chain/tree x n-gram/model draft, adaptive on/off) equal the
  port's plain decode and the JAX stacked spec engine's, with the same
  spec counters (the prompts share no prefix); W8A8 spec streams equal
  the port's W8A8 plain streams; page refcounts drain to zero.
"""
import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import kv_cache as jkv_cache
from repro.serving import sampler as jsampler
from repro.serving import speculative as jspec
from repro.serving import telemetry as jtelemetry
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.serving import kv_cache, sampler, speculative, telemetry
from repro_torch.serving.engine import ServeEngine

MAX_SEQ, PAGE, SLOTS, CHUNK, MAX_NEW = 64, 8, 2, 8, 10
ATOL = RTOL = 1e-4
#: one bf16 ulp of the K/V written in bf16 by both frameworks
KV_RTOL, KV_ATOL = 2 ** -7, 1e-6
#: frequency bound over 20,000 draws
FREQ_ATOL, DRAWS = 0.015, 20_000


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    # the draft: the target with 0.25 std of seeded noise per tensor (as
    # the reference's tree-spec bench builds it), so that drafts are both
    # accepted and rejected
    rng = np.random.default_rng(7)
    draft = jax.tree_util.tree_map(
        lambda x: x + 0.25 * jnp.std(x) * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype), params)
    return dict(
        jcfg=jcfg, cfg=get_config("gpt2-345m").reduced(), jparams=params,
        tparams=bridge.params_from_numpy(jax.device_get(params)),
        jdraft=draft, tdraft=bridge.params_from_numpy(jax.device_get(draft)))


def _repetitive_prompts(vocab, lengths=(6, 19, 11, 27), seed=0):
    """Prompts that repeat short runs (the n-gram proposer finds matches)
    and start with distinct tokens (no two share a prefix page)."""
    rng = np.random.default_rng(seed)
    firsts = rng.permutation(np.arange(1, vocab))[:len(lengths)]
    out = []
    for first, n in zip(firsts, lengths):
        run = rng.integers(1, vocab, int(rng.integers(2, 5))).tolist()
        body = (run * n)[:n - 1]
        out.append([int(first)] + [int(t) for t in body])
    return out


@dataclasses.dataclass
class _Req:
    prompt: List[int]
    max_new: int = 8
    out: List[int] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# host-side code: equal to the reference


def _random_tree(cls, rng, n):
    t = cls()
    for _ in range(n):
        t.add(int(rng.integers(0, 50)), int(rng.integers(0, t.n + 1)))
    return t


def test_token_tree_and_tree_arrays_match_reference():
    rng = np.random.default_rng(0)
    k, C = 6, 7
    jtrees, ttrees = [], []
    for n in (0, 1, 3, 6):
        seed = int(rng.integers(1 << 30))
        jt = _random_tree(jspec.TokenTree, np.random.default_rng(seed), n)
        tt = _random_tree(speculative.TokenTree, np.random.default_rng(seed),
                          n)
        assert (tt.tokens, tt.parents, tt.depths) == \
            (jt.tokens, jt.parents, jt.depths)
        np.testing.assert_array_equal(tt.ancestor_mask(C),
                                      jt.ancestor_mask(C))
        np.testing.assert_array_equal(tt.padded_depths(C),
                                      jt.padded_depths(C))
        jtrees.append(jt if n else None)
        ttrees.append(tt if n else None)
    chain = speculative.TokenTree.chain([4, 5, 6])
    assert chain.parents == jspec.TokenTree.chain([4, 5, 6]).parents
    with pytest.raises(ValueError, match="fit"):
        chain.ancestor_mask(3)
    for a, b in zip(speculative.tree_arrays(ttrees, k, C),
                    jspec.tree_arrays(jtrees, k, C)):
        np.testing.assert_array_equal(a, b)


def test_draft_caps_and_adaptive_match_reference():
    rng = np.random.default_rng(1)
    mk = dict(k=6, k_min=1, decay=0.5)
    ja, ta = jspec.AdaptiveDraft(**mk), speculative.AdaptiveDraft(**mk)
    for slot in range(4):
        ja.alloc(slot)
        ta.alloc(slot)
    for _ in range(30):
        slot = int(rng.integers(0, 4))
        proposed = int(rng.integers(0, 7))
        accepted = int(rng.integers(0, proposed + 1))
        if rng.random() < 0.5:
            ja.observe(slot, proposed, accepted)
            ta.observe(slot, proposed, accepted)
        else:
            ja.observe_tree(slot, proposed, accepted)
            ta.observe_tree(slot, proposed, accepted)
        assert [ta.cap(b) for b in range(4)] == [ja.cap(b) for b in range(4)]
        assert ta.stats() == ja.stats()
        slots = [None if rng.random() < 0.2 else
                 _Req([1] * 3, int(rng.integers(1, 9)),
                      [2] * int(rng.integers(0, 4))) for _ in range(4)]
        lengths = rng.integers(0, 64, 4).astype(np.int32)
        active = rng.random(4) < 0.8
        for adaptive, jadaptive in ((None, None), (ta, ja)):
            np.testing.assert_array_equal(
                speculative.draft_caps(slots, lengths, active, 6, 64,
                                       adaptive=adaptive),
                jspec.draft_caps(slots, lengths, active, 6, 64,
                                 adaptive=jadaptive))
    ja.free(2)
    ta.free(2)
    assert ta.stats() == ja.stats()
    with pytest.raises(ValueError):
        speculative.AdaptiveDraft(3, k_min=4)


def test_ngram_proposer_matches_reference():
    rng = np.random.default_rng(2)
    jp, tp = jspec.NgramProposer(5, 3, 1), speculative.NgramProposer(5, 3, 1)
    reqs = []
    for slot in range(3):
        run = rng.integers(1, 9, 3).tolist()
        reqs.append(_Req((run * 6)[:int(rng.integers(4, 17))], 20))
        jp.alloc(slot, reqs[-1].prompt, 0)
        tp.alloc(slot, reqs[-1].prompt, 0)
    active = np.array([True, True, False])
    for step in range(6):
        caps = rng.integers(0, 6, 3).astype(np.int32)
        cur = np.zeros((3, 1), np.int32)
        lengths = np.array([len(r.prompt) + len(r.out) for r in reqs],
                           np.int32)
        jd, jc = jp.propose(reqs, cur, lengths, active, caps)
        td, tc = tp.propose(reqs, cur, lengths, active, caps)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tc, jc)
        for branch in (1, 2, 3):
            jt = jp.propose_tree(reqs, cur, lengths, active, caps, branch)
            tt = tp.propose_tree(reqs, cur, lengths, active, caps, branch)
            assert [None if t is None else (t.tokens, t.parents, t.depths)
                    for t in tt] == \
                [None if t is None else (t.tokens, t.parents, t.depths)
                 for t in jt]
        for r in reqs:  # grow the contexts as decode would
            r.out.append(int(rng.integers(1, 9)))
    tp.free(0)
    assert 0 not in tp._tables


def test_rewind_bookkeeping_matches_reference(setup):
    """A scripted sequence of admissions, per-row decode growth, verify
    rewinds (releasing pages back to the reservation) and frees leaves
    both managers in the same state after every step; rewinding below
    the prompt, or past the allocated pages, raises in both."""
    mk = dict(page_size=4, n_pages=16)
    jm = jkv_cache.PagedCacheManager(setup["jcfg"], 3, 32, with_cache=False,
                                     **mk)
    tm = kv_cache.PagedCacheManager(setup["cfg"], 3, 32, **mk)
    a = list(range(1, 8))

    def same():
        np.testing.assert_array_equal(tm.block_tables, jm.block_tables)
        np.testing.assert_array_equal(tm.lengths, jm.lengths)
        assert tm.stats() == jm.stats()
        assert [tm.refcount(p) for p in range(16)] == \
            [jm.refcount(p) for p in range(16)]
        assert tm.available_pages == jm.available_pages

    steps = [
        lambda m: m.alloc(a, 12),
        lambda m: m.advance(0, 7),
        lambda m: m.alloc([9] * 5, 9),
        lambda m: m.advance(1, 5),
        lambda m: m.ensure_decode_room([True, True, False],
                                       np.array([6, 2, 0])),
        lambda m: m.rewind(0, 9),
        lambda m: m.rewind(1, 6),
        lambda m: m.ensure_decode_room([True, False, False], 4),
        lambda m: m.rewind(0, 13),
        lambda m: m.free(1),
        lambda m: m.alloc(a + [50], 3),
    ]
    for step in steps:
        assert step(tm) == step(jm)
        same()
    for bad, err in ((lambda m: m.rewind(0, 6), ValueError),
                     (lambda m: m.rewind(0, 33), ValueError),
                     (lambda m: m.rewind(0, 30), RuntimeError),
                     (lambda m: m.rewind(2, 5), ValueError)):
        for m in (jm, tm):
            with pytest.raises(err):
                bad(m)
        same()


# ---------------------------------------------------------------------------
# accept rules


def _jax_accept(fn, *args, temp, topk, topp):
    return jax.device_get(fn(*[jnp.asarray(a) for a in args],
                             jax.random.PRNGKey(0), jnp.asarray(temp),
                             jnp.asarray(topk), jnp.asarray(topp)))


def test_spec_accept_batch_greedy_rows_match_reference():
    """Greedy rows (beside stochastic ones in the same batch): drafts that
    follow the argmax chain for a random number of steps, counts from 0
    to k."""
    rng = np.random.default_rng(3)
    B, k, V = 8, 4, 12
    lg = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    chain = lg.argmax(-1)
    draft = rng.integers(0, V, (B, k)).astype(np.int32)
    for b in range(B):
        m = int(rng.integers(0, k + 1))
        draft[b, :m] = chain[b, :m]
    n_draft = np.array([4, 4, 3, 0, 2, 4, 1, 4], np.int32)
    temp = np.array([0, 0, 0, 0, 0, 1.0, 0.7, 0], np.float32)
    topk = np.array([0, 0, 0, 0, 0, 0, 3, 0], np.int32)
    topp = np.ones(B, np.float32)
    jn, jt = _jax_accept(jsampler.spec_accept_batch, lg, draft, n_draft,
                         temp=temp, topk=topk, topp=topp)
    tn, tt = sampler.spec_accept_batch(
        torch.from_numpy(lg), torch.from_numpy(draft),
        torch.from_numpy(n_draft), torch.Generator().manual_seed(0),
        torch.from_numpy(temp), torch.from_numpy(topk),
        torch.from_numpy(topp))
    g = temp <= 0
    np.testing.assert_array_equal(tn.numpy()[g], jn[g])
    np.testing.assert_array_equal(tt.numpy()[g], jt[g])
    # an all-greedy batch draws nothing from the generator
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    z = torch.zeros(B)
    n, t = sampler.spec_accept_batch(
        torch.from_numpy(lg), torch.from_numpy(draft),
        torch.from_numpy(n_draft), gen, z, z.long(), torch.ones(B))
    np.testing.assert_array_equal(n.numpy()[g], jn[g])
    assert torch.equal(gen.get_state(), state)


def _greedy_trees(rng, lg, k, branch):
    """Trees whose nodes are drawn from their parent position's top
    candidates, so greedy acceptance goes several levels deep."""
    B = lg.shape[0]
    trees = []
    for b in range(B):
        t = speculative.TokenTree()
        frontier = [0]
        while frontier and t.n < k:
            par = frontier.pop(0)
            order = np.argsort(-lg[b, par], kind="stable")
            for tok in order[:branch]:
                if t.n >= k:
                    break
                pos = t.add(int(tok) if rng.random() < 0.8
                            else int(rng.integers(0, lg.shape[2])), par)
                frontier.append(pos)
        trees.append(t if b % 4 else None)
    return trees


def test_spec_accept_tree_greedy_rows_match_reference():
    rng = np.random.default_rng(4)
    B, k, V = 8, 6, 10
    C = k + 1
    lg = rng.standard_normal((B, C, V)).astype(np.float32)
    trees = _greedy_trees(rng, lg, k, 2)
    tokens, parents, n_nodes, _, _ = speculative.tree_arrays(trees, k, C)
    temp = np.array([0, 0, 0, 1.0, 0, 0, 0.5, 0], np.float32)
    topk = np.zeros(B, np.int32)
    topp = np.ones(B, np.float32)
    jn, ja, jt = _jax_accept(jsampler.spec_accept_tree, lg, tokens,
                             parents, n_nodes, temp=temp, topk=topk,
                             topp=topp)
    tn, ta, tt = sampler.spec_accept_tree(
        torch.from_numpy(lg), torch.from_numpy(tokens),
        torch.from_numpy(parents), torch.from_numpy(n_nodes),
        torch.Generator().manual_seed(0), torch.from_numpy(temp),
        torch.from_numpy(topk), torch.from_numpy(topp))
    g = temp <= 0
    np.testing.assert_array_equal(tn.numpy()[g], jn[g])
    np.testing.assert_array_equal(ta.numpy()[g], np.asarray(ja)[g])
    np.testing.assert_array_equal(tt.numpy()[g], jt[g])
    assert tn.numpy()[g].max() >= 2  # some greedy path went deep


@pytest.mark.parametrize("temp,topk", [(1.0, 0), (0.7, 3)])
def test_spec_accept_batch_keeps_the_target_distribution(temp, topk):
    """Identical target logits at every chunk position: every emitted
    token, the first and the second (given two were emitted), must follow
    the filtered target distribution, and a rejected draft token is never
    the corrective token."""
    V, k = 5, 2
    p = np.array([0.35, 0.3, 0.2, 0.1, 0.05])
    lg = torch.from_numpy(np.broadcast_to(
        np.log(p), (DRAWS, k + 1, V)).astype(np.float32).copy())
    t = torch.full((DRAWS,), temp)
    want = torch.softmax(sampler._filter_logits(
        lg[:1, 0], t[:1], torch.tensor([topk]), torch.ones(1)), -1)[0]
    draft = torch.tensor([[1, 3]]).repeat(DRAWS, 1)
    n_acc, nxt = sampler.spec_accept_batch(
        lg, draft, torch.full((DRAWS,), k), torch.Generator().manual_seed(1),
        t, torch.full((DRAWS,), topk), torch.ones(DRAWS))
    first = torch.where(n_acc >= 1, 1, nxt).numpy()
    np.testing.assert_allclose(np.bincount(first, minlength=V) / DRAWS,
                               want.numpy(), atol=FREQ_ATOL)
    two = n_acc >= 1
    second = torch.where(n_acc >= 2, 3, nxt)[two].numpy()
    np.testing.assert_allclose(np.bincount(second, minlength=V) / len(second),
                               want.numpy(), atol=FREQ_ATOL)
    assert not bool((nxt[n_acc == 0] == 1).any())
    assert not bool((nxt[n_acc == 1] == 3).any())


def test_spec_accept_tree_keeps_the_target_distribution():
    """Three siblings off the root tried without replacement, one
    grandchild: the first emitted token follows the target."""
    V = 8
    rng = np.random.default_rng(5)
    lg1 = rng.standard_normal((1, 5, V)).astype(np.float32) * 1.5
    target = torch.softmax(torch.from_numpy(lg1[0, 0]), -1).numpy()
    lg = torch.from_numpy(lg1).repeat(DRAWS, 1, 1)
    tokens = torch.tensor([[1, 2, 5, 3]]).repeat(DRAWS, 1)
    parents = torch.tensor([[0, 0, 1, 0]]).repeat(DRAWS, 1)
    ones = torch.ones(DRAWS)
    n_acc, acc, nxt = sampler.spec_accept_tree(
        lg, tokens, parents, torch.full((DRAWS,), 4),
        torch.Generator().manual_seed(2), ones, torch.zeros(DRAWS).long(),
        ones)
    root_kids = acc[:, 1:] & (parents == 0)
    has = root_kids.any(dim=1)
    child = torch.gather(tokens, 1, root_kids.long().argmax(dim=1,
                                                            keepdim=True))
    first = torch.where(has, child[:, 0], nxt).numpy()
    np.testing.assert_allclose(np.bincount(first, minlength=V) / DRAWS,
                               target, atol=FREQ_ATOL)
    # accepted positions form a root path: the grandchild only under 1
    assert not bool((acc[:, 3] & ~acc[:, 1]).any())
    assert bool((n_acc == acc[:, 1:].sum(1)).all())


# ---------------------------------------------------------------------------
# model: verify_chunk / compact_accepted_path / the stacked cache


def _prefilled(setup, prompts, dtype=jnp.bfloat16):
    """A JAX stacked cache with each prompt prefilled into its slot."""
    jcfg, jp = setup["jcfg"], setup["jparams"]
    cache = jlm.init_cache(jcfg, len(prompts), MAX_SEQ, dtype=dtype)
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), CHUNK):
            piece = prompt[off:off + CHUNK]
            chunk = np.zeros(CHUNK, np.int32)
            chunk[:len(piece)] = piece
            _, cache = jlm.prefill_into_slot(
                jp, jcfg, jnp.asarray(chunk), cache, slot, off,
                valid=len(piece), dtype=jnp.float32)
    return cache


def _paged_from_stacked(jcache, cfg, bt):
    """The port's page pools holding the stacked cache's rows through
    block tables ``bt`` (B, n_pg); unused pages stay zero."""
    stacked = bridge.cache_from_numpy(jax.device_get(jcache))
    B, n_pg = bt.shape
    pools = {"layers": []}
    for c in stacked["layers"]:
        layer = {}
        for name, t in c.items():
            pool = torch.zeros((1 + B * n_pg, cfg.n_kv_heads, PAGE,
                                cfg.head_dim), dtype=t.dtype)
            pages = t.reshape(B, cfg.n_kv_heads, n_pg, PAGE, cfg.head_dim)
            for b in range(B):
                pool[torch.from_numpy(bt[b]).long()] = \
                    pages[b].permute(1, 0, 2, 3)
            layer[name] = pool
        pools["layers"].append(layer)
    return pools


def _stacked_from_paged(tcache, bt):
    """Each row's positions gathered back out of the page pools, as
    float32 numpy (L, 2, B, Hkv, S, hd)."""
    bt = torch.from_numpy(bt)
    return np.asarray([[ref.paged_gather_ref(c[n], bt).float().numpy()
                        for n in ("k", "v")] for c in tcache["layers"]])


def _jstacked(jcache):
    """float32 numpy (L, 2, B, Hkv, S, hd) of a JAX stacked cache."""
    c = bridge.cache_from_numpy(jax.device_get(jcache))
    return np.asarray([[t.float().numpy() for t in (l["k"], l["v"])]
                       for l in c["layers"]])


@pytest.fixture(scope="module")
def verify_case(setup):
    """Two live rows (lengths 11 and 20) and a row parked at max_seq."""
    rng = np.random.default_rng(6)
    cfg = setup["cfg"]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (11, 20)]
    jcache = _prefilled(setup, prompts + [[1]])
    n_pg = MAX_SEQ // PAGE
    bt = (1 + rng.permutation(3 * n_pg)).reshape(3, n_pg).astype(np.int32)
    lengths = np.array([11, 20, MAX_SEQ], np.int32)
    return jcache, bt, lengths


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_verify_chunk_and_compaction_match_stacked_reference(setup,
                                                             verify_case,
                                                             mode):
    """Paged verify (chain, or a tree with branching and depths) against
    the reference's stacked verify: per-position logits, the K/V written
    at the flat chunk positions, and then the accepted paths compacted
    to contiguous positions in both."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jcache, bt, lengths = verify_case
    rng = np.random.default_rng(7)
    k = 6
    C = k + 1
    B = 3
    toks = rng.integers(1, cfg.vocab_size, (B, C)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        trees = [_random_tree(speculative.TokenTree, rng, n)
                 for n in (6, 4, 0)]
        _, _, _, anc, depths = speculative.tree_arrays(
            [t if t.n else None for t in trees], k, C)
        assert not (anc == np.tril(np.ones((C, C), bool))).all()
        kw_j = dict(anc=jnp.asarray(anc), depths=jnp.asarray(depths))
        kw_t = dict(anc=torch.from_numpy(anc),
                    depths=torch.from_numpy(depths))
    tcache = _paged_from_stacked(jcache, cfg, bt)
    jl, jc = jlm.verify_chunk(setup["jparams"], jcfg, jnp.asarray(toks),
                              jcache, jnp.asarray(lengths),
                              dtype=jnp.float32, **kw_j)
    tl, tc = lm.verify_chunk(setup["tparams"], cfg, torch.from_numpy(toks),
                             tcache, torch.from_numpy(lengths),
                             block_tables=torch.from_numpy(bt),
                             dtype=torch.float32, **kw_t)
    assert tl.shape == (B, C, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=ATOL, rtol=RTOL)
    want, got = _jstacked(jc), _stacked_from_paged(tc, bt)
    for b in range(2):
        np.testing.assert_allclose(got[:, :, b], want[:, :, b],
                                   rtol=KV_RTOL, atol=KV_ATOL)
    # compaction: row 0 keeps positions 2 and 4 of its chunk, row 1 its
    # first two (a self-copy), row 2 nothing (dst past the cache: dropped)
    src = np.full((B, k), MAX_SEQ, np.int32)
    dst = np.full((B, k), MAX_SEQ, np.int32)
    src[0, :2], dst[0, :2] = lengths[0] + np.array([2, 4]), lengths[0] + [1, 2]
    src[1, :2], dst[1, :2] = lengths[1] + np.array([1, 2]), lengths[1] + [1, 2]
    jc = jlm.compact_accepted_path(jcfg, jc, jnp.asarray(src),
                                   jnp.asarray(dst))
    before = [t.clone() for c in tc["layers"] for t in c.values()]
    tc = lm.compact_accepted_path(cfg, tc, torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  block_tables=torch.from_numpy(bt))
    want, got = _jstacked(jc), _stacked_from_paged(tc, bt)
    for b in range(2):
        np.testing.assert_allclose(got[:, :, b], want[:, :, b],
                                   rtol=KV_RTOL, atol=KV_ATOL)
    after = [t for c in tc["layers"] for t in c.values()]
    for a, b_ in zip(after, before):  # the null page was not touched
        assert torch.equal(a[0], b_[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_prefill_and_decode_match_reference(setup, dtype):
    """The draft model's cache: chunked prefill into two slots (a ragged
    chunk, and a last chunk hanging past max_seq whose overhang is
    dropped), then batched decode steps, against the reference."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp, tp = setup["jparams"], setup["tparams"]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(8)
    jc = jlm.init_cache(jcfg, 2, MAX_SEQ, dtype=jdt)
    tc = lm.init_cache(cfg, 2, MAX_SEQ, layout="stacked", dtype=tdt)
    assert tc["layers"][0]["k"].shape == (2, cfg.n_kv_heads, MAX_SEQ,
                                          cfg.head_dim)
    calls = [(0, 0, 8), (0, 8, 5), (1, 0, 8), (1, MAX_SEQ - 3, 3)]
    for slot, off, n in calls:
        chunk = np.zeros(CHUNK, np.int32)
        chunk[:n] = rng.integers(1, cfg.vocab_size, n)
        lj, jc = jlm.prefill_into_slot(jp, jcfg, jnp.asarray(chunk), jc,
                                       slot, off, valid=n,
                                       dtype=jnp.float32)
        lt, tc = lm.prefill_into_slot(tp, cfg, torch.from_numpy(chunk), tc,
                                      off, slot=slot, valid=n,
                                      dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=RTOL)
    lengths = np.array([13, 20], np.int32)
    tok = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
    for _ in range(3):
        lj, jc = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                 jnp.asarray(lengths), dtype=jnp.float32)
        lt, tc = lm.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(lengths),
                                dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=RTOL)
        tok = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + 1
    back = bridge.cache_to_numpy(tc, n_per=cfg.n_layers)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                   rtol=KV_RTOL, atol=KV_ATOL)


# ---------------------------------------------------------------------------
# the engine


_VARIANTS = {
    "chain-ngram": dict(k=4),
    "tree-ngram": dict(k=4, tree=True, branch=2),
    "chain-model": dict(k=3, proposer="model"),
    "tree-model": dict(k=5, proposer="model", tree=True, branch=3),
    "chain-ngram-adaptive": dict(k=4, adaptive=True),
    "tree-model-adaptive": dict(k=5, proposer="model", tree=True, branch=2,
                                adaptive=True),
}
_COUNTERS = ("spec_ticks", "spec_proposed", "spec_accepted", "spec_emitted",
             "draft_calls", "model_calls", "prefill_calls", "ticks")


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return {r.rid: r.out for r in eng.run()}


def _port_engine(setup, spec=None, **kw):
    kw.setdefault("act_dtype", torch.float32)
    return ServeEngine(setup["cfg"], setup["tparams"], batch_slots=SLOTS,
                       max_seq=MAX_SEQ, eos_id=-1, page_size=PAGE,
                       chunk_size=CHUNK, device="cpu", spec=spec, **kw)


def _port_spec(setup, variant):
    kw = dict(_VARIANTS[variant])
    if kw.get("proposer") == "model":
        kw.update(draft_cfg=setup["cfg"], draft_params=setup["tdraft"])
    return speculative.SpecConfig(**kw)


def _drained(eng):
    s = eng.stats()
    return (s["pages_in_use"] == 0
            and all(eng.kv.refcount(p) == 0 for p in range(eng.kv.n_pages))
            and not eng.kv.block_tables.any())


@pytest.fixture(scope="module")
def prompts(setup):
    return _repetitive_prompts(setup["cfg"].vocab_size)


@pytest.fixture(scope="module")
def plain_streams(setup, prompts):
    return _serve(_port_engine(setup), prompts)


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_spec_engine_greedy_streams_match_plain_and_reference(
        setup, prompts, plain_streams, variant):
    kw = dict(_VARIANTS[variant])
    if kw.get("proposer") == "model":
        kw.update(draft_cfg=setup["jcfg"], draft_params=setup["jdraft"])
    je = JServeEngine(setup["jcfg"], setup["jparams"], batch_slots=SLOTS,
                      max_seq=MAX_SEQ, eos_id=-1, chunk_size=CHUNK,
                      kv_layout="stacked", act_dtype=jnp.float32,
                      spec=jspec.SpecConfig(**kw))
    jout = _serve(je, prompts)
    te = _port_engine(setup, _port_spec(setup, variant))
    tout = _serve(te, prompts)
    assert tout == plain_streams
    assert tout == jout
    js, ts = je.stats(), te.stats()
    for key in _COUNTERS:
        assert ts[key] == js[key], key
    assert ts["spec_ticks"] > 0 and ts["spec_accepted"] > 0
    assert ts["spec_accepted"] < ts["spec_proposed"]  # rejections too
    keys = telemetry.STATS_KEYS_ENGINE_SPEC
    if kw.get("adaptive"):
        keys = keys | {"adaptive_slots", "adaptive_cap_mean"}
    assert set(ts) == keys
    assert _drained(te)


def test_spec_stats_keys_are_the_reference_subset():
    assert telemetry.STATS_KEYS_ENGINE < telemetry.STATS_KEYS_ENGINE_SPEC
    assert telemetry.STATS_KEYS_ENGINE_SPEC == \
        jtelemetry.STATS_KEYS_ENGINE_SPEC
    assert telemetry.linear_edges(0.0, 6.0, 6) == \
        jtelemetry.linear_edges(0.0, 6.0, 6)


def test_spec_zero_draft_ticks_fall_back_to_plain_decode(setup):
    """Prompts with no repeated token give the n-gram proposer nothing to
    draft on the first ticks: those ticks run the plain decode step (no
    verify), and the stream is unchanged."""
    rng = np.random.default_rng(9)
    prompts = [rng.permutation(np.arange(1, 200))[:n].tolist()
               for n in (5, 9)]
    plain = _serve(_port_engine(setup), prompts, max_new=4)
    eng = _port_engine(setup, speculative.SpecConfig(k=3))
    ops.reset_launch_counts()
    assert _serve(eng, prompts, max_new=4) == plain
    s = eng.stats()
    decode_ticks = s["model_calls"] - s["prefill_calls"]
    assert s["spec_ticks"] < decode_ticks  # some ticks decoded plainly


@pytest.mark.parametrize("variant", ["chain-ngram", "tree-model"])
def test_w8a8_spec_streams_match_w8a8_plain(setup, prompts, variant):
    calib = [np.random.default_rng(10).integers(1, setup["cfg"].vocab_size,
                                                (1, 16))]
    kw = dict(quantized=True, calibration_batches=calib, act_dtype=None)
    plain = _serve(_port_engine(setup, **kw), prompts)
    eng = _port_engine(setup, _port_spec(setup, variant), **kw)
    assert eng.act_dtype == torch.float32
    assert _serve(eng, prompts) == plain
    assert eng.stats()["spec_accepted"] > 0
    assert _drained(eng)


def test_sampled_spec_requests_complete_with_accounting(setup, prompts):
    """Stochastic rows beside greedy ones: every request gets its tokens,
    the counters add up, and the greedy request's stream is unchanged."""
    eng = _port_engine(setup, _port_spec(setup, "tree-model"))
    hot = sampler.SamplingParams(temperature=0.9, top_k=20)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=MAX_NEW, sampling=None if i == 0 else hot)
    done = {r.rid: r.out for r in eng.run()}
    plain = _serve(_port_engine(setup), prompts[:1])
    assert done[0] == plain[0]
    assert all(len(o) == MAX_NEW for o in done.values())
    s = eng.stats()
    # each verified row emits its accepted drafts plus one token
    assert s["spec_accepted"] <= s["spec_proposed"]
    assert s["spec_accepted"] < s["spec_emitted"]
    assert s["spec_emitted"] <= sum(len(o) for o in done.values()) \
        - len(prompts)  # the first tokens come off the prefill logits
    assert _drained(eng)


def test_model_draft_refuses_unported_stacks(setup):
    """A draft model must be a global-attention stack: a recurrent one is
    refused with the reference's ``ValueError``, as is a model proposer
    without a draft and ``k = 0``."""
    cfg = dataclasses.replace(setup["cfg"], block_pattern=("rglru",))
    with pytest.raises(ValueError, match="global-attention draft"):
        speculative.ModelDraft(cfg, setup["tparams"], 2, MAX_SEQ, 3)
    with pytest.raises(ValueError, match="draft_cfg"):
        speculative.make_proposer(speculative.SpecConfig(proposer="model"),
                                  2, MAX_SEQ)
    with pytest.raises(ValueError, match="k=0"):
        _port_engine(setup, speculative.SpecConfig(k=0))
