"""The RoPE dense decoder family (``tinyllama-1.1b``, ``llama3-8b``,
``minitron-4b``, ``gemma-7b``, each ``.reduced()``) in the port against the
JAX package, with the weights carried across by the bridge.  Every check
is one test parametrised over the four configs.

Held against the reference on the same numpy inputs:

* the config copies, field by field; the bridge's layouts (no position
  table, an untied ``lm_head`` or the tied embedding, GQA caches);
* the stage program, the FPGA model's figures, admission prices and the
  engine's request ceiling: equal;
* float32 logits of the full forward and of paged prefill and decode
  steps: ``atol = rtol = 1e-4`` (rotary cos/sin differ by an ulp here and
  there, ``tests/test_torch_rope.py``).  The steps run on float32 page
  pools, whose K/V agree to ``atol = rtol = 1e-5``: on bf16 pools a
  rotary ulp may round a cached K one bf16 ulp apart, which moves the
  logits past 1e-4 (2.8e-4 at tinyllama's decode); the engines' bf16
  pools are held by the stream tests below;
* W8A8 weights: bit-identical given the reference's calibration stats;
* calibration stats (a bf16 forward): bit-identical at layer 0's q, k and
  v inputs, which come before any rotary phase; everywhere else within
  ``STATS_RTOL`` (two bf16 ulps, where a rotary ulp moved a rounding: one
  channel of minitron's 64-wide stats is two ulps off, the reading);
* W8A8 greedy streams of the port's paged and stacked engines equal to
  the JAX *stacked* engine's (its paged speculative path fails on this
  CPU); in the port, chain (n-gram) and tree (model draft) speculation
  equal plain decode, and a lower-triangular tree mask equals the causal
  chunk bit for bit on both layouts.
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
from repro.serving import admission as jadmission
from repro.serving import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import perfmodel, scheduler
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serving import admission, quantize, speculative
from repro_torch.serving.engine import ServeEngine

ARCHS = ("tinyllama-1.1b", "llama3-8b", "minitron-4b", "gemma-7b")
MAX_SEQ, PS, SLOTS, CHUNK, MAX_NEW = 64, 8, 2, 8, 8
ATOL = RTOL = 1e-4
KV_RTOL = KV_ATOL = 1e-5
STATS_RTOL = 2 ** -6


class Family:
    """One config's reference and port objects, each made on first use."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        # one param subtree per layer, so calibration names each layer;
        # the same weights stacked on the period axis for everything else
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


# ---------------------------------------------------------------------------
# configs, bridge, host-side planning


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    j, t = jget_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)
    lm.check_supported(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_layouts(family, arch):
    """No position table; an untied ``lm_head`` (d, V) or the tied
    embedding; GQA caches (Hkv of them, the reference's shapes) on both
    layouts; ``lm.init`` draws the same tree."""
    f = family(arch)
    cfg, tp = f.cfg, f.tparams
    assert "pos_embed" not in tp and len(tp["layers"]) == cfg.n_layers
    if cfg.tie_embeddings:
        assert "lm_head" not in tp
    else:
        assert tp["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size)
    mine = lm.init(cfg, torch.Generator().manual_seed(0))
    assert [(p, a.shape) for p, a in _leaves(mine)] == \
        [(p, a.shape) for p, a in _leaves(tp)]
    assert get_config(arch).n_kv_heads < get_config(arch).n_heads \
        or arch == "gemma-7b"
    for layout, n in (("paged", 5), ("stacked", 3)):
        jc = jlm.init_cache(f.jcfg, n, PS, layout=layout)
        tc = bridge.cache_from_numpy(jax.device_get(jc))
        mine = lm.init_cache(cfg, n, PS, layout=layout)
        want = (n, cfg.n_kv_heads, PS, cfg.head_dim)
        assert len(tc["layers"]) == len(mine["layers"]) == cfg.n_layers
        for a, b in zip(tc["layers"], mine["layers"]):
            assert a["k"].shape == b["k"].shape == want
            assert a["v"].dtype == b["v"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_planning_matches_reference(family, arch):
    """The stage program (each ``mp`` stage's K and N: the gated FFN's
    doubled up-projection, GQA's narrow qkv, the vocab-wide ``lm_head``),
    the FPGA model's figures, the admission budget and prices, and the
    engine's request ceiling (a rotary stack has no position table, yet
    every global-attention layer pins ``max_seq`` positions)."""
    f = family(arch)
    for j, t in ((jget_config(arch), get_config(arch)), (f.jcfg, f.cfg)):
        assert [dataclasses.astuple(s) for s in scheduler.model_program(t)] \
            == [dataclasses.astuple(s) for s in jscheduler.model_program(j)]
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
                       dtype=jnp.float32)[0]
    got = lm.forward(f.tparams, f.cfg, torch.from_numpy(tokens),
                     dtype=torch.float32)
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
    ``depths = arange(C)``, so each node turns to its flat position) gives
    logits and K/V bit-identical to the causal chunk."""
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
    """The reference's stats quantize every linear group, ``gate`` and the
    untied ``lm_head`` included, to bit-identical ``w_q``, ``w_scale`` and
    ``smooth``; norms and embeddings stay fp."""
    f = family(arch)
    want = dict(_leaves(f.tq))
    got = dict(_leaves(quantize.quantize_model_params(
        f.tparams, f.cfg, {k: torch.from_numpy(np.array(v))
                           for k, v in f.jstats.items()})))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    gated = f.cfg.activation in ("swiglu", "geglu")
    n_q = sum(p.endswith("/w_q") for p in got)
    assert n_q == (6 + gated) * f.cfg.n_layers + (not f.cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_stats_match_reference(family, arch):
    """The port's bf16 calibration forward records the reference's
    per-layer stats: bit-identical at layer 0's q, k and v inputs (the
    normed embedding, before any rotary phase), within ``STATS_RTOL``
    elsewhere."""
    f = family(arch)
    tstats = quantize.calibrate(f.tparams, f.cfg, [f.calib])
    want = {k.replace("r", "l", 1): np.asarray(v)
            for k, v in f.jstats.items()}
    assert tstats.keys() == want.keys()
    for name in ("l0.attn.q", "l0.attn.k", "l0.attn.v"):
        np.testing.assert_array_equal(tstats[name].numpy(), want[name])
    for name, v in tstats.items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=STATS_RTOL,
                                   atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_streams_match_jax_stacked_engine(family, arch):
    """Greedy W8A8 streams (the reference-quantized weights, float32
    activations) of the port's paged and stacked engines equal the JAX
    stacked engine's, token for token."""
    f = family(arch)
    stacked = _serve(f.engine(kv_layout="stacked"), f.prompts)
    assert f.paged_stream == stacked == f.jax_stream
    assert all(len(o) == MAX_NEW for o in stacked.values())


@pytest.mark.parametrize("variant", ["chain-ngram", "tree-model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_spec_streams_equal_plain(family, arch, variant):
    """Chain speculation with the n-gram proposer and tree speculation
    with a model draft of the same config give the plain engine's greedy
    streams on the paged layout; drafts are accepted and rejected."""
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


# ---------------------------------------------------------------------------
# what the port still refuses, and the kernels' geometry at full width


@pytest.mark.parametrize("arch", ARCHS)
def test_check_supported_refuses_other_stacks(arch):
    """Every block kind, an encoder and a frontend pass
    ``check_supported``.  A hybrid stack of the family's widths serves
    stacked, while the paged layout refuses it with the reference's
    ``ValueError`` (no global-attention layer to page); an encoder-decoder
    is refused by the engine with ``ValueError`` (it runs at model
    level); a patch frontend's decoder serves on tokens, as in the
    reference."""
    cfg = get_config(arch).reduced()
    lm.check_supported(dataclasses.replace(cfg, family="moe", n_experts=8,
                                           experts_per_token=2))
    for bad, match in (
            (dict(family="hybrid", block_pattern=("rglru", "rglru",
                                                  "local_attn"),
                  window=32, lru_width=64), "global-attention"),
            (dict(is_encoder_decoder=True, n_encoder_layers=2),
             "encoder-decoder"),
            (dict(frontend="vision_patches", frontend_tokens=8), None)):
        other = dataclasses.replace(cfg, **bad)
        lm.check_supported(other)
        params = lm.init(other, torch.Generator().manual_seed(0))
        if bad.get("family") == "hybrid":
            eng = ServeEngine(other, params, max_seq=64, device="cpu")
            assert eng.kv_layout == "stacked" and eng.seq_ceiling is None
            with pytest.raises(ValueError, match=match):
                ServeEngine(other, params, max_seq=64, kv_layout="paged",
                            device="cpu")
        elif match is not None:
            assert "encoder" in params
            with pytest.raises(ValueError, match=match):
                ServeEngine(other, params, max_seq=64, device="cpu")
        else:
            eng = ServeEngine(other, params, max_seq=64, device="cpu")
            assert eng.kv_layout == "paged"


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_geometry_at_full_width(arch):
    """The three attention kernels take the full config's head dim and
    group at the serving shapes (8 rows, 1,024 positions in pages of 16,
    chunks of 32 and verifies of 5 and 9): the splits tile the table or
    cache once, and shared memory fits, the stacked and draft caches in
    float32 and bf16."""
    cfg = get_config(arch)
    B, S, ps = 8, 1024, 16
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert D in ops._DECODE_HEAD_DIMS and D in ops._VERIFY_HEAD_DIMS
    n_pg = S // ps
    dec = ops._decode_geometry(B, H, Hkv, ps, D, n_pg)
    assert dec.smem <= ops._SMEM_LIMIT
    assert dec.pps * (dec.splits - 1) < n_pg <= dec.pps * dec.splits
    for elem in (2, 4):
        mha = ops._mha_geometry(B, H, Hkv, S, D, elem)
        assert mha.smem <= ops._SMEM_LIMIT
        assert mha.kps * (mha.splits - 1) < S <= mha.kps * mha.splits
    for C in (32, 5, 9):
        ver = ops._verify_geometry(B, C, H, Hkv, ps, D, n_pg)
        assert ver.smem <= ops._SMEM_LIMIT
        assert ver.nq * (H // Hkv) <= ops._VERIFY_ROWS
        assert ver.pps * (ver.splits - 1) < n_pg <= ver.pps * ver.splits
        assert ver.parts == (2 if D > 128 else 1)
