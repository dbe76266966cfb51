"""The MoE decoders (``olmoe-1b-7b``, ``kimi-k2-1t-a32b``, each
``.reduced()``: 8 experts, top-2) in the port against the JAX package,
with the weights carried across by the bridge.  Every check is one test
parametrised over the two configs.

Held against the reference on the same numpy inputs:

* ``moe_apply``: the router's expert choices and every choice's rank and
  slot equal; float32 outputs within ``atol = rtol = 1e-5``, bf16 outputs
  within one bf16 ulp of the output's largest magnitude; the aux loss
  within ``1e-6``; at exact capacity and at a capacity factor of 1.25,
  where choices drop;
* the config copies; the bridge's layouts (``(E, d, f)`` expert banks
  under the stacked ``periods`` axis, a float32 router);
* the stage program, the FPGA model's figures, admission prices and the
  engine's request ceiling, for the full configs too: equal;
* float32 logits of the full forward and of paged prefill and decode
  steps (float32 pools): ``atol = rtol = 1e-4``, as the dense family;
* W8A8 weights bit-identical given the reference's calibration stats,
  the router and the expert banks left as they were; calibration stats
  as the dense family holds them;
* greedy streams of the port's paged and stacked engines, W8A8 and bf16,
  equal to the JAX *stacked* engine's (its paged speculative path fails
  on this CPU); chain and tree speculation equal plain decode, and a
  lower-triangular tree mask equals the causal chunk on both layouts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import perfmodel as jperfmodel
from repro.core import scheduler as jscheduler
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import admission as jadmission
from repro.serving import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.core import perfmodel, scheduler
from repro_torch.models import lm, moe
from repro_torch.serving import admission, quantize, speculative
from repro_torch.serving.engine import ServeEngine

ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
MAX_SEQ, PS, SLOTS, CHUNK, MAX_NEW = 64, 8, 2, 8, 8
ATOL = RTOL = 1e-4
MOE_ATOL = MOE_RTOL = 1e-5
AUX_ATOL = 1e-6
KV_RTOL = KV_ATOL = 1e-5
STATS_RTOL = 2 ** -6


class Family:
    """One config's reference and port objects, each made on first use."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        self.jlayers = jlm.init(self.jcfg, jax.random.PRNGKey(0),
                                layout="layers")
        self.jparams = dict(self.jlayers, rest=[], periods=(
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *self.jlayers["rest"]),))
        self.tparams = bridge.params_from_numpy(
            jax.device_get(self.jlayers))

    @functools.cached_property
    def calib(self):
        return np.random.default_rng(4).integers(1, self.cfg.vocab_size,
                                                 (2, 16))

    @functools.cached_property
    def jstats(self):
        return jquantize.calibrate(self.jlayers, self.jcfg,
                                   [jnp.asarray(self.calib)])

    @functools.cached_property
    def jq(self):
        return jquantize.quantize_model_params(self.jparams, self.jcfg,
                                               self.jstats)

    @functools.cached_property
    def tq(self):
        return bridge.params_from_numpy(jax.device_get(self.jq))

    @functools.cached_property
    def tdraft(self):
        """The target plus 0.25 std of seeded noise: drafts are both
        accepted and rejected."""
        rng = np.random.default_rng(7)
        return bridge.params_from_numpy(jax.device_get(
            jax.tree_util.tree_map(
                lambda x: x + 0.25 * jnp.std(x) * jnp.asarray(
                    rng.standard_normal(x.shape), x.dtype), self.jparams)))

    @functools.cached_property
    def prompts(self):
        """Prompts that repeat short runs (the n-gram proposer drafts),
        each starting with its own token."""
        rng = np.random.default_rng(3)
        firsts = rng.permutation(np.arange(1, self.cfg.vocab_size))
        out = []
        for first, n in zip(firsts, (6, 19, 11, 27)):
            run = rng.integers(1, self.cfg.vocab_size, int(rng.integers(2, 5)))
            out.append([int(first)] + (run.tolist() * n)[:n - 1])
        return out

    @functools.cached_property
    def jax_stream(self):
        """The JAX stacked engine's greedy W8A8 streams."""
        eng = JServeEngine(self.jcfg, self.jq, kv_layout="stacked",
                           act_dtype=jnp.float32, **_COMMON)
        return _serve(eng, self.prompts)

    @functools.cached_property
    def paged_stream(self):
        return _serve(self.engine(), self.prompts)

    def engine(self, **kw):
        """A W8A8 engine of the port on the reference-quantized weights."""
        return ServeEngine(self.cfg, self.tq, act_dtype=torch.float32,
                           device="cpu", **_COMMON, **kw)


_COMMON = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
               chunk_size=CHUNK, page_size=PS)


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run()}


@pytest.fixture(scope="module")
def family():
    return functools.cache(Family)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _jax_route(p, x, cfg, capacity_factor):
    """The reference's router and slot assignment
    (``repro/models/moe.py``, ``moe_apply`` up to the scatter), step by
    step: (expert_idx (T, k), rank (T * k,), slot (T * k,), C)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax(jnp.dot(xt.astype(jnp.float32), p["router"]["w"]),
                           axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    C = T * k if capacity_factor is None else max(
        1, int(capacity_factor * k * T / E))
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(E))
    rank_sorted = jnp.arange(T * k) - seg_start[sorted_e]
    rank = jnp.zeros_like(rank_sorted).at[order].set(rank_sorted)
    return (np.asarray(expert_idx), np.asarray(rank),
            np.asarray(jnp.where(rank < C, rank, C)), C)


# ---------------------------------------------------------------------------
# the MoE FFN alone


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype, capacity_factor):
    """Expert choices, ranks and slots equal; outputs within the stated
    tolerance; aux loss within 1e-6.  At 1.25 choices drop: 21 tokens'
    42 choices over 8 experts, C = int(1.25 * 42 / 8) = 6 slots each."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    tp = {k: v for k, v in bridge.params_from_numpy(
        dict(jax.device_get(jp), periods=(), rest=[])).items()
        if k != "layers"}
    x = np.random.default_rng(0).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)

    want_e, want_rank, want_slot, C = _jax_route(jp, jx, jcfg,
                                                 capacity_factor)
    gates, experts, slots, tC, _ = moe.route(tp, tx.reshape(-1, cfg.d_model),
                                             cfg, capacity_factor)
    assert tC == C == moe.capacity(cfg, 21, capacity_factor)
    np.testing.assert_array_equal(experts.numpy(), want_e)
    np.testing.assert_array_equal(slots.numpy(), want_slot)
    dropped = int((want_rank >= C).sum())
    if capacity_factor is None:
        assert dropped == 0 and C == 21 * cfg.experts_per_token
        # top-k picks k distinct experts a token, so no rank reaches T:
        # C = T would give the same slots
        assert int(slots.max()) < 21
    else:
        assert dropped > 0
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    jo, jaux = jmoe.moe_apply(jp, jx, jcfg, capacity_factor=capacity_factor)
    to, taux = moe.moe_apply(tp, tx, cfg, capacity_factor=capacity_factor)
    assert to.dtype == tdt and to.shape == tx.shape
    want = np.asarray(jo.astype(jnp.float32))
    got = to.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=MOE_ATOL, rtol=MOE_RTOL)
    else:
        mag = np.abs(want).max()
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert np.abs(got - want).max() <= ulp
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL


# ---------------------------------------------------------------------------
# configs, bridge, host-side planning


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    j, t = jget_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert arch in list_archs()
    lm.check_supported(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_layouts(family, arch):
    """A MoE layer carries ``router {"w": (d, E)}`` in float32 and the
    ``(E, d, f)`` / ``(E, f, d)`` banks; the same weights stacked on the
    reference's ``periods`` axis (``(L, E, d, f)`` leaves, its default
    layout) unstack to the per-layer tensors; ``lm.init`` draws the same
    tree."""
    f = family(arch)
    cfg, tp = f.cfg, f.tparams
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    for layer in tp["layers"]:
        assert "mlp" not in layer
        m = layer["moe"]
        assert m["router"]["w"].shape == (d, E)
        assert m["router"]["w"].dtype == torch.float32
        assert m["w_up"].shape == m["w_gate"].shape == (E, d, ff)
        assert m["w_down"].shape == (E, ff, d)
    stacked = jlm.init(f.jcfg, jax.random.PRNGKey(0))  # the default
    assert stacked["periods"][0]["moe"]["w_up"].shape == (cfg.n_layers, E,
                                                          d, ff)
    assert f.jparams["periods"][0]["moe"]["w_down"].shape == (
        cfg.n_layers, E, ff, d)
    from_stacked = bridge.params_from_numpy(jax.device_get(f.jparams))
    a, b = dict(_leaves(from_stacked)), dict(_leaves(tp))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert torch.equal(t, b[path]), path
    mine = lm.init(cfg, torch.Generator().manual_seed(0))
    assert [(p, a.shape, a.dtype) for p, a in _leaves(mine)] == \
        [(p, a.shape, a.dtype) for p, a in _leaves(tp)]


@pytest.mark.parametrize("arch", ARCHS)
def test_planning_matches_reference(family, arch):
    """The stage program (names, kinds and (K, N): the router, ``moe_up``
    at k x the gated up-projection, ``moe_down`` at K = d_ff x k), the
    FPGA model's figures, the admission budget and prices, and the
    engine's request ceiling; full configs included, since nothing here
    allocates."""
    f = family(arch)
    for j, t in ((jget_config(arch), get_config(arch)), (f.jcfg, f.cfg)):
        prog = scheduler.model_program(t)
        assert [dataclasses.astuple(s) for s in prog] \
            == [dataclasses.astuple(s) for s in jscheduler.model_program(j)]
        k = t.experts_per_token
        assert ("l0.moe_up", "mp", t.d_model, 2 * t.d_ff * k) in \
            [dataclasses.astuple(s) for s in prog]
        ts, js = scheduler.mdk_stats(t), jscheduler.mdk_stats(j)
        assert ts.activations == js.activations
        assert ts.reuse_factor() == js.reuse_factor()
        assert perfmodel.FPGAPerfModel(t).token_latency(777) == \
            jperfmodel.FPGAPerfModel(j).token_latency(777)
        assert perfmodel.FPGAPerfModel(t).prefill_token_latency() == \
            jperfmodel.FPGAPerfModel(j).prefill_token_latency()
        ja = jadmission.FIFOAdmission(j, chunk_size=32)
        ta = admission.FIFOAdmission(t, chunk_size=32)
        assert ta.budget_tokens == ja.budget_tokens
        for plen, new in ((3, 5), (500, 600), (1000, 100)):
            assert ta.slot_price(t, plen, new, max_seq=1024) == \
                ja.slot_price(j, plen, new, max_seq=1024)
            assert ta.page_price(plen, new, page_size=16, max_seq=1024) == \
                ja.page_price(plen, new, page_size=16, max_seq=1024)
    je = JServeEngine(f.jcfg, f.jparams, **_COMMON)
    te = ServeEngine(f.cfg, f.tparams, device="cpu", **_COMMON)
    assert te.seq_ceiling == je.seq_ceiling == MAX_SEQ


# ---------------------------------------------------------------------------
# the model, float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(family, arch):
    f = family(arch)
    tokens = np.random.default_rng(0).integers(1, f.cfg.vocab_size, (2, 23))
    want = jlm.forward(f.jparams, f.jcfg, jnp.asarray(tokens),
                       dtype=jnp.float32, moe_cf=None)[0]
    got = lm.forward(f.tparams, f.cfg, torch.from_numpy(tokens),
                     dtype=torch.float32, moe_cf=None)
    assert got.shape == (2, 23, f.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_reference(family, arch):
    """Chunked prefill into each row's float32 pages (a ragged last chunk,
    a chunk crossing pages), then batched decode steps with an idle row
    riding along: the logits after every call and the K/V left in every
    page."""
    f = family(arch)
    jcfg, cfg = f.jcfg, f.cfg
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (11, 19)]
    n_pg = MAX_SEQ // PS
    B = len(prompts) + 1
    n_pages = 1 + B * n_pg
    bt = np.zeros((B, n_pg), np.int32)
    ids = 1 + np.random.default_rng(2).permutation(n_pages - 1)
    for b in range(len(prompts)):
        bt[b] = ids[b * n_pg:(b + 1) * n_pg]
    jc = jlm.init_cache(jcfg, n_pages, PS, layout="paged", dtype=jnp.float32)
    tc = lm.init_cache(cfg, n_pages, PS, dtype=torch.float32)
    out_j, out_t = [], []
    for b, prompt in enumerate(prompts):
        for off in range(0, len(prompt), CHUNK):
            n = min(CHUNK, len(prompt) - off)
            chunk = np.zeros(CHUNK, np.int32)
            chunk[:n] = prompt[off:off + n]
            lj, jc = jlm.prefill_into_slot(
                f.jparams, jcfg, jnp.asarray(chunk), jc, 0, off, valid=n,
                block_table=jnp.asarray(bt[b]), dtype=jnp.float32)
            lt, tc = lm.prefill_into_slot(
                f.tparams, cfg, torch.from_numpy(chunk), tc, off, valid=n,
                block_table=torch.from_numpy(bt[b]), dtype=torch.float32)
            out_j.append(np.asarray(lj))
            out_t.append(lt.numpy())
    lengths = np.array([len(p) for p in prompts] + [0], np.int32)
    active = np.array([True] * len(prompts) + [False])
    tok = np.array([[p[-1]] for p in prompts] + [[0]], np.int32)
    for _ in range(4):
        lj, jc = jlm.decode_step(
            f.jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(lengths),
            active=jnp.asarray(active), block_table=jnp.asarray(bt),
            dtype=jnp.float32)
        lt, tc = lm.decode_step(
            f.tparams, cfg, torch.from_numpy(tok), tc,
            torch.from_numpy(lengths), active=torch.from_numpy(active),
            block_table=torch.from_numpy(bt), dtype=torch.float32)
        out_j.append(np.asarray(lj)[:-1])
        out_t.append(lt.numpy()[:-1])
        tok = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + active
    assert len(out_t) == 2 + 3 + 4
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    back = bridge.cache_to_numpy(tc, n_per=cfg.n_layers)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(b[1:], np.asarray(a, np.float32)[1:],
                                   rtol=KV_RTOL, atol=KV_ATOL)


@pytest.mark.parametrize("layout", ["paged", "stacked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tril_tree_mask_equals_causal_chunk(family, arch, layout):
    """A verify chunk whose tree is a chain (lower-triangular ``anc``,
    ``depths = arange(C)``) gives logits and K/V bit-identical to the
    causal chunk: the MoE FFN routes the same rows the same way."""
    f = family(arch)
    cfg = f.cfg
    rng = np.random.default_rng(9)
    B, C = 3, 5
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, C)))
    lengths = torch.tensor([0, 17, MAX_SEQ - C], dtype=torch.int32)
    anc = torch.tril(torch.ones((B, C, C), dtype=torch.int32))
    depths = torch.arange(C)[None].expand(B, C)
    kw = {}
    if layout == "paged":
        n_pg = MAX_SEQ // PS
        kw["block_tables"] = torch.arange(1, 1 + B * n_pg,
                                          dtype=torch.int32).reshape(B, n_pg)
        cache = lm.init_cache(cfg, 1 + B * n_pg, PS)
    else:
        cache = lm.init_cache(cfg, B, MAX_SEQ, layout="stacked")
    for c in cache["layers"]:
        for t in c.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    twin = {"layers": [{k: t.clone() for k, t in c.items()}
                       for c in cache["layers"]]}
    a, cache = lm.verify_chunk(f.tparams, cfg, toks, cache, lengths,
                               dtype=torch.float32, **kw)
    b, twin = lm.verify_chunk(f.tparams, cfg, toks, twin, lengths, anc=anc,
                              depths=depths, dtype=torch.float32, **kw)
    assert torch.equal(a, b)
    for x, y in zip(cache["layers"], twin["layers"]):
        assert torch.equal(x["k"], y["k"]) and torch.equal(x["v"], y["v"])


# ---------------------------------------------------------------------------
# W8A8


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_model_params_bitexact_given_reference_stats(family, arch):
    """The reference's stats quantize q, k, v, out and the untied
    ``lm_head`` to bit-identical ``w_q``, ``w_scale`` and ``smooth``; the
    router and the expert banks stay the float32 tensors they were."""
    f = family(arch)
    want = dict(_leaves(f.tq))
    got = dict(_leaves(quantize.quantize_model_params(
        f.tparams, f.cfg, {k: torch.from_numpy(np.array(v))
                           for k, v in f.jstats.items()})))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    before = dict(_leaves(f.tparams))
    moe_paths = [p for p in got if "/moe/" in p]
    assert len(moe_paths) == 4 * f.cfg.n_layers
    for path in moe_paths:
        assert got[path].dtype == torch.float32
        assert torch.equal(got[path], before[path]), path
    n_q = sum(p.endswith("/w_q") for p in got)
    assert n_q == 4 * f.cfg.n_layers + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_stats_match_reference(family, arch):
    """The port's bf16 calibration forward (exact capacity, as the
    reference's) records the reference's per-layer stats: bit-identical
    at layer 0's q, k and v inputs, within ``STATS_RTOL`` elsewhere; the
    router and experts record none."""
    f = family(arch)
    tstats = quantize.calibrate(f.tparams, f.cfg, [f.calib])
    want = {k.replace("r", "l", 1): np.asarray(v)
            for k, v in f.jstats.items()}
    assert tstats.keys() == want.keys()
    assert not any("moe" in k for k in tstats)
    for name in ("l0.attn.q", "l0.attn.k", "l0.attn.v"):
        np.testing.assert_array_equal(tstats[name].numpy(), want[name])
    for name, v in tstats.items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=STATS_RTOL,
                                   atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_streams_match_jax_stacked_engine(family, arch):
    """Greedy W8A8 streams (the reference-quantized weights, float32
    activations, float32 experts) of the port's paged and stacked engines
    equal the JAX stacked engine's, token for token."""
    f = family(arch)
    stacked = _serve(f.engine(kv_layout="stacked"), f.prompts)
    assert f.paged_stream == stacked == f.jax_stream
    assert all(len(o) == MAX_NEW for o in stacked.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_streams_match_jax_stacked_engine(family, arch):
    """The unquantized engines (bf16 activations and experts: the gates'
    bf16 product and the sum over k round where the reference's do):
    paged and stacked greedy streams equal the JAX stacked engine's."""
    f = family(arch)
    jeng = JServeEngine(f.jcfg, f.jparams, kv_layout="stacked", **_COMMON)
    want = _serve(jeng, f.prompts)
    for layout in ("paged", "stacked"):
        eng = ServeEngine(f.cfg, f.tparams, device="cpu", kv_layout=layout,
                          **_COMMON)
        assert eng.act_dtype == torch.bfloat16
        assert _serve(eng, f.prompts) == want, layout


@pytest.mark.parametrize("variant", ["chain-ngram", "tree-model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_spec_streams_equal_plain(family, arch, variant):
    """Chain speculation with the n-gram proposer and tree speculation
    with a model draft of the same config give the plain engine's greedy
    streams on the paged layout; drafts are accepted and rejected.  A
    verify routes (k + 1) x slots tokens at their own exact capacity."""
    f = family(arch)
    if variant == "chain-ngram":
        spec = speculative.SpecConfig(k=4)
    else:
        spec = speculative.SpecConfig(k=5, proposer="model",
                                      draft_cfg=f.cfg,
                                      draft_params=f.tdraft, tree=True,
                                      branch=3)
    eng = f.engine(spec=spec)
    assert _serve(eng, f.prompts) == f.paged_stream
    s = eng.stats()
    assert 0 < s["spec_accepted"] < s["spec_proposed"]
    assert s["pages_in_use"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_without_card_raises(family, arch, monkeypatch):
    """The default device is the card; with none present a MoE engine
    refuses instead of running its plain versions on the CPU."""
    f = family(arch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(f.cfg, f.tq, **_COMMON)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it runs nothing on import)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_near_tie_rule_rejects_a_planted_fault(arch, monkeypatch,
                                                       capsys):
    """``chip_smoke.py``'s near-tie rule with its routing branch, on the
    CPU: two engines on the same W8A8 weights, one whose decode drops
    each row's newest key, must not pass as parted at near-ties (the
    routers' first split is too far apart to be a routing near-tie);
    nor must one whose decode drops the newest key in one head only,
    where the first split is a routing near-tie and only the logits
    with the routers pinned to the other side's choices show the fault;
    the same rule passes two fault-free runs."""
    from repro_torch.kernels import ops
    from repro_torch.serving.quantize import calibrate

    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(2)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    q = quantize.quantize_model_params(params, cfg, calibrate(
        params, cfg, [rng.integers(1, cfg.vocab_size, (2, 32))]))
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in (3, 17, 33, 60, 9, 25)]
    cpu = torch.device("cpu")
    good = ops.paged_mha_decode

    def dropped_key(q_, kp, vp, lengths, bt, **kw):
        return good(q_, kp, vp, (lengths - 1).clamp_min(1), bt, **kw)

    # on these weights, the head whose fault first splits the routers at
    # a routing near-tie
    head = {"olmoe-1b-7b": 0, "kimi-k2-1t-a32b": -1}[arch]

    def one_head_dropped_key(q_, kp, vp, lengths, bt, **kw):
        out = good(q_, kp, vp, lengths, bt, **kw).clone()
        out[:, head] = dropped_key(q_, kp, vp, lengths, bt, **kw)[:, head]
        return out

    schedules = {}

    def serve(decode):
        monkeypatch.setattr(ops, "paged_mha_decode", decode)
        eng = ServeEngine(cfg, q, batch_slots=4, max_seq=128, eos_id=-1,
                          act_dtype=torch.float32, chunk_size=16,
                          page_size=16, device=cpu)
        for p in prompts:
            eng.submit(p, max_new=16)
        with cs.ScheduleProbe(eng) as probe:
            out = {r.rid: r.out for r in eng.run()}
        schedules[decode] = probe.calls
        return out

    def logits(decode):
        def fn(rid, prompt, history):
            monkeypatch.setattr(ops, "paged_mha_decode", decode)
            return cs.logits_after(q, cfg, schedules[decode][rid], prompt,
                                   history, cpu, rows=4)
        return fn

    plain = serve(good)
    assert cs.hold_streams("fault-free", (plain, serve(good)), prompts,
                           (logits(good), logits(good)), 16,
                           moe_cfg=cfg) == 1.0
    with pytest.raises(cs.SmokeFailure, match="logits err"):
        cs.hold_streams("planted fault", (plain, serve(dropped_key)),
                        prompts, (logits(good), logits(dropped_key)), 16,
                        moe_cfg=cfg)
    assert "NOT a routing near-tie" in capsys.readouterr().out
    faulty = serve(one_head_dropped_key)
    with pytest.raises(cs.SmokeFailure, match="logits err"):
        # request 0, whose routers first split at a routing near-tie
        cs.hold_streams("one head's fault", ({0: plain[0]}, {0: faulty[0]}),
                        prompts, (logits(good), logits(one_head_dropped_key)),
                        16, moe_cfg=cfg)
    out = capsys.readouterr().out
    assert ": a routing near-tie" in out and "NOT a" not in out
    assert "pinned to the second's choices" in out
