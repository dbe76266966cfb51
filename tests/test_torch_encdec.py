"""Whisper's encoder-decoder in the port against the JAX package, on the
CPU: reduced ``whisper-large-v3`` (2 encoder and 2 decoder layers, d 64,
an ``encoder_seq`` of 16), the weights carried across by the bridge.

Held against the reference on the same numpy inputs:

* the config copies and the stage programs (``model_program``,
  ``mdk_stats``), full and reduced, of whisper and pixtral: equal;
* the bridge: the reference's encoder stacked on a leading axis
  (``layout="stacked"``) or as a list gives the same per-layer params;
  ``lm.init`` draws the same tree;
* float32: ``encode``, ``forward(frames=)``, ``batch_prefill`` and the
  replay ``prefill`` with ragged prompt lengths (the last logits, every
  self and cross cache entry), then 8 greedy ``decode_step(enc_lengths=)``
  steps: logits within ``atol = rtol = 1e-4`` (float32 sums in another
  order, and XLA contracts multiply-adds inside the reference's
  ``lax.scan`` bodies, ROADMAP C9), caches within ``1e-5``, the greedy
  tokens identical;
* W8A8 (SmoothQuant calibrated with ``extras={"frames": ...}``):
  calibration statistics bit-identical, name by name, including the
  reference's quirks (the encoder's attention and the decoder's share the
  ``attn.*`` statistics; the cross sub-blocks' ``cross_attn.*`` groups
  find none, their products being recorded as ``cross.*``); ``w_q``,
  ``w_scale`` and ``smooth`` bit-identical; a 16-token greedy stream
  through ``prefill`` and ``decode_step`` equal to the JAX one;
* the kernels' geometry at full width: ``mha_decode`` over the cross
  cache (8 rows, 20 heads over 20 of 64, 1,500 keys, ragged last tile)
  and the self cache (``max_seq`` 448), and ``mp_matmul`` at the
  encoder's token counts;
* the refusals: ``ServeEngine`` in every prefill mode and
  ``launch/serve.py`` refuse whisper with ``ValueError`` naming
  ``encoder-decoder``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import scheduler as jscheduler
from repro.models import lm as jlm
from repro.serving import quantize as jquantize
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.core import scheduler
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import quantize
from repro_torch.serving.engine import ServeEngine

ARCH = "whisper-large-v3"
B, MAX_SEQ, STEPS, W8A8_NEW = 3, 32, 8, 16
PROMPT_LENS = (5, 9, 2)
ATOL = RTOL = 1e-4
CACHE_ATOL = CACHE_RTOL = 1e-5


class Whisper:
    """The reference's and the port's objects, each made on first use."""

    def __init__(self):
        self.jcfg = jget_config(ARCH).reduced()
        self.cfg = get_config(ARCH).reduced()
        # one param subtree per layer, so calibration names each layer;
        # the same decoder weights stacked on the period axis otherwise
        self.jlayers = jlm.init(self.jcfg, jax.random.PRNGKey(0),
                                max_seq=MAX_SEQ, layout="layers")
        self.jparams = dict(self.jlayers, rest=[], periods=(
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *self.jlayers["rest"]),))
        self.tparams = bridge.params_from_numpy(
            jax.device_get(self.jlayers))
        rng = np.random.default_rng(5)
        self.frames = rng.standard_normal(
            (B, self.cfg.encoder_seq, self.cfg.d_model)).astype(np.float32)
        self.tokens = rng.integers(1, self.cfg.vocab_size,
                                   (B, max(PROMPT_LENS)))
        self.calib = rng.integers(1, self.cfg.vocab_size, (2, 12))
        self.calib_frames = rng.standard_normal(
            (2, self.cfg.encoder_seq, self.cfg.d_model)).astype(np.float32)

    @functools.cached_property
    def jstats(self):
        return jquantize.calibrate(
            self.jlayers, self.jcfg, [jnp.asarray(self.calib)],
            extras={"frames": jnp.asarray(self.calib_frames)})

    @functools.cached_property
    def jq(self):
        return jquantize.quantize_model_params(self.jparams, self.jcfg,
                                               self.jstats)

    @functools.cached_property
    def tq(self):
        return bridge.params_from_numpy(jax.device_get(self.jq))


@pytest.fixture(scope="module")
def w():
    return Whisper()


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _caches_close(tcache, jcache, n_per):
    want = dict(_leaves(jax.device_get(jcache)))
    got = dict(_leaves(bridge.cache_to_numpy(tcache, n_per)))
    assert got.keys() == want.keys() and any("cross" in p for p in got)
    for path, a in got.items():
        np.testing.assert_allclose(a, _np(want[path]), atol=CACHE_ATOL,
                                   rtol=CACHE_RTOL, err_msg=path)


# ---------------------------------------------------------------------------
# configs, planning, bridge


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "pixtral-12b"])
def test_config_and_program_match_reference(arch, reduced):
    j, t = jget_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    got = dataclasses.asdict(t)
    # the port's own fields, at the defaults that keep JAX's arithmetic
    assert got.pop("expert_dtype") == "" and got.pop("norm_topk_prob") is True
    assert got == dataclasses.asdict(j)
    assert arch in list_archs()
    assert [dataclasses.astuple(s) for s in scheduler.model_program(t)] == \
        [dataclasses.astuple(s) for s in jscheduler.model_program(j)]
    ts, js = scheduler.mdk_stats(t), jscheduler.mdk_stats(j)
    assert ts.reuse_factor() == js.reuse_factor()
    assert ts.stages == js.stages


def test_bridge_and_init_layouts(w):
    """The reference's stacked encoder (``layout="stacked"``, which draws
    the encoder from the same keys as ``"layers"``) bridges to the same
    per-layer encoder as its list; ``lm.init`` draws the bridged tree's
    paths, shapes and dtypes."""
    stacked = bridge.params_from_numpy(jax.device_get(jlm.init(
        w.jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)))
    enc = w.tparams["encoder"]
    assert len(enc["layers"]) == w.cfg.n_encoder_layers
    assert enc["pos_embed"].shape == (w.cfg.encoder_seq, w.cfg.d_model)
    for (pa, a), (pb, b) in zip(_leaves(enc), _leaves(stacked["encoder"])):
        assert pa == pb and torch.equal(a, b), pa
    assert all("cross_attn" in lp and "cross_ln" in lp
               for lp in w.tparams["layers"])
    mine = lm.init(w.cfg, torch.Generator().manual_seed(0), max_seq=MAX_SEQ)
    got = [(p, t.shape, t.dtype) for p, t in _leaves(mine)]
    assert got == [(p, t.shape, t.dtype) for p, t in _leaves(w.tparams)]


def test_init_cache_cross_entries(w):
    """A stacked cache carries a static (B, Hkv, encoder_seq, hd) cross
    K/V per decoder layer, as the reference's; the paged layout refuses
    an encoder-decoder with the reference's ``ValueError``."""
    c = lm.init_cache(w.cfg, B, MAX_SEQ, layout="stacked")
    j = jlm.init_cache(w.jcfg, B, MAX_SEQ)
    shape = (B, w.cfg.n_kv_heads, w.cfg.encoder_seq, w.cfg.head_dim)
    assert len(c["cross"]) == w.cfg.n_layers
    assert all(e[k].shape == shape for e in c["cross"] for k in "kv")
    assert j["cross"]["periods"][0]["k"].shape == (w.cfg.n_layers,) + shape
    with pytest.raises(ValueError, match="global-attention"):
        lm.init_cache(w.cfg, 4, 8, layout="paged")


# ---------------------------------------------------------------------------
# float32


def test_encode_matches(w):
    want = jlm.encode(w.jparams, w.jcfg, jnp.asarray(w.frames))
    got = lm.encode(w.tparams, w.cfg, torch.from_numpy(w.frames))
    assert got.shape == (B, w.cfg.encoder_seq, w.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_forward_with_frames_matches(w):
    want = jlm.forward(w.jparams, w.jcfg, jnp.asarray(w.tokens),
                       frames=jnp.asarray(w.frames), dtype=jnp.float32)[0]
    got = lm.forward(w.tparams, w.cfg, torch.from_numpy(w.tokens),
                     frames=torch.from_numpy(w.frames), dtype=torch.float32)
    assert got.shape == (B, w.tokens.shape[1], w.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="frames"):
        lm.forward(w.tparams, w.cfg, torch.from_numpy(w.tokens))


def _greedy(w, jax_side, last, cache, lengths, steps, params=None,
            dtype=None):
    """``steps`` greedy decode steps from a prefill's ``last`` logits on
    either side; returns the tokens (B, steps) and every step's logits."""
    toks, logits = [], []
    enc = np.full((B,), w.cfg.encoder_seq, np.int32)
    for _ in range(steps):
        tok = np.argmax(_np(last), axis=-1)[:, None]
        toks.append(tok[:, 0])
        if jax_side:
            last, cache = jlm.decode_step(
                params or w.jparams, w.jcfg, jnp.asarray(tok, jnp.int32),
                cache, lengths, enc_lengths=jnp.asarray(enc),
                dtype=dtype or jnp.float32)
        else:
            last, cache = lm.decode_step(
                params or w.tparams, w.cfg, torch.from_numpy(tok), cache,
                lengths, enc_lengths=torch.from_numpy(enc),
                dtype=dtype or torch.float32)
        lengths = lengths + 1
        logits.append(_np(last))
    return np.stack(toks, 1), logits, cache


@pytest.mark.parametrize("path", ["batch_prefill", "prefill"])
def test_prefill_and_decode_steps_match(w, path):
    """``batch_prefill`` (uniform prompts) and the replay ``prefill``
    (ragged lengths) into float32 stacked caches: the last logits, every
    self and cross cache entry, the lengths; then ``STEPS`` greedy
    ``decode_step(enc_lengths=)`` steps: logits close, tokens equal."""
    frames = w.frames
    jc = jlm.init_cache(w.jcfg, B, MAX_SEQ, dtype=jnp.float32)
    tc = lm.init_cache(w.cfg, B, MAX_SEQ, layout="stacked",
                       dtype=torch.float32)
    if path == "batch_prefill":
        toks = w.tokens[:, :7]
        jl, jc, jn = jlm.batch_prefill(
            w.jparams, w.jcfg, jnp.asarray(toks), jc,
            frames=jnp.asarray(frames), dtype=jnp.float32)
        tl, tc, tn = lm.batch_prefill(
            w.tparams, w.cfg, torch.from_numpy(toks), tc,
            frames=torch.from_numpy(frames), dtype=torch.float32)
    else:
        plen = np.array(PROMPT_LENS, np.int32)
        toks = w.tokens * (np.arange(w.tokens.shape[1]) < plen[:, None])
        jl, jc, jn = jlm.prefill(
            w.jparams, w.jcfg, jnp.asarray(toks), jnp.asarray(plen), jc,
            frames=jnp.asarray(frames), dtype=jnp.float32)
        tl, tc, tn = lm.prefill(
            w.tparams, w.cfg, torch.from_numpy(toks), torch.from_numpy(plen),
            tc, frames=torch.from_numpy(frames), dtype=torch.float32)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    _caches_close(tc, jc, w.cfg.n_layers)
    assert all(t.is_contiguous() for e in tc["cross"] for t in e.values())
    jt, jlog, jc = _greedy(w, True, jl, jc, jn, STEPS)
    tt, tlog, tc = _greedy(w, False, tl, tc, tn, STEPS)
    np.testing.assert_array_equal(tt, jt)
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    _caches_close(tc, jc, w.cfg.n_layers)


# ---------------------------------------------------------------------------
# W8A8


def test_calibration_stats_match_reference(w):
    """Calibration with ``extras={"frames": ...}`` records the
    reference's statistics under the same names, bit for bit: the
    encoder's ``.attn.*``, each decoder layer's ``l{i}.attn.*``,
    ``l{i}.cross.{q,k,v,out}`` and ``l{i}.mlp.*``, and ``cross.k``,
    ``cross.v`` (the encoder output's cross projections)."""
    tstats = quantize.calibrate(w.tparams, w.cfg, [w.calib],
                                extras={"frames": w.calib_frames})
    want = {("l" + k[1:] if k.startswith("r") else k): np.asarray(v)
            for k, v in w.jstats.items()}
    assert tstats.keys() == want.keys()
    assert {"cross.k", "cross.v", ".attn.q", "l1.cross.q"} <= set(tstats)
    for name, v in tstats.items():
        np.testing.assert_array_equal(v.numpy(), want[name], err_msg=name)
    suffixes = set(quantize._suffix_stats(tstats))
    assert suffixes == {"attn.q", "attn.k", "attn.v", "attn.out", "cross.q",
                        "cross.k", "cross.v", "cross.out", "mlp.up",
                        "mlp.down"}


def test_quantize_model_params_bitexact(w):
    """The port's walk quantizes the encoder's groups and the cross groups
    as the reference's does, bit for bit, from the port's own statistics;
    the cross groups get no smoothing (no ``cross_attn.*`` statistics)."""
    tstats = quantize.calibrate(w.tparams, w.cfg, [w.calib],
                                extras={"frames": w.calib_frames})
    got = dict(_leaves(quantize.quantize_model_params(w.tparams, w.cfg,
                                                      tstats)))
    want = dict(_leaves(w.tq))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    assert "/encoder/layers/0/attn/q/w_q" in got
    smooth = got["/layers/0/cross_attn/k/smooth"]
    assert torch.equal(smooth, torch.ones_like(smooth))


def test_w8a8_greedy_stream_matches(w):
    """The reference-quantized weights at float32 activations: ragged
    replay ``prefill`` and ``W8A8_NEW`` greedy decode steps give the JAX
    stream, token for token."""
    plen = np.array(PROMPT_LENS, np.int32)
    toks = w.tokens * (np.arange(w.tokens.shape[1]) < plen[:, None])
    jl, jc, jn = jlm.prefill(
        w.jq, w.jcfg, jnp.asarray(toks), jnp.asarray(plen),
        jlm.init_cache(w.jcfg, B, MAX_SEQ, dtype=jnp.float32),
        frames=jnp.asarray(w.frames), dtype=jnp.float32)
    tl, tc, tn = lm.prefill(
        w.tq, w.cfg, torch.from_numpy(toks), torch.from_numpy(plen),
        lm.init_cache(w.cfg, B, MAX_SEQ, layout="stacked",
                      dtype=torch.float32),
        frames=torch.from_numpy(w.frames), dtype=torch.float32)
    jt = _greedy(w, True, jl, jc, jn, W8A8_NEW, params=w.jq)[0]
    tt = _greedy(w, False, tl, tc, tn, W8A8_NEW, params=w.tq)[0]
    np.testing.assert_array_equal(tt, jt)
    assert len(set(tt.ravel().tolist())) > 1


# ---------------------------------------------------------------------------
# the kernels' geometry at full width


def test_kernel_geometry_at_whisper_shapes():
    """``mha_decode`` over the cross cache (8 rows of 20 heads over 20 KV
    heads of 64 at 1,500 keys: 93 whole 16-key tiles and a ragged one)
    and the self cache (``max_seq`` 448), bf16 and float32: the splits
    cover the cache once and shared memory fits.  ``mp_matmul`` at the
    encoder's token counts (1,500 per request, ragged 64-token blocks)
    for every (K, N) of a layer: the token blocks cover M once and shared
    memory fits."""
    cfg = get_config(ARCH)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert D in ops._DECODE_HEAD_DIMS
    for rows in (8, 1):
        for S in (cfg.encoder_seq, 448):
            for elem in (2, 4):
                g = ops._mha_geometry(rows, H, Hkv, S, D, elem)
                assert g.smem <= ops._SMEM_LIMIT
                assert g.kps * (g.splits - 1) < S <= g.kps * g.splits
                assert g.kps % ops._DECODE_TILE == 0
    d, ff = cfg.d_model, cfg.d_ff
    for M in (1500, 3000, 8 * 1500 + 7, 12000, 8):
        for K, N in ((d, d), (d, ff), (ff, d), (d, cfg.vocab_size)):
            g = ops._mp_geometry(M, N, K)
            assert g.smem <= ops._SMEM_LIMIT
            assert g.bm * (g.m_blocks - 1) < M <= g.bm * g.m_blocks
            assert g.splits * ops._MP_KT <= -(-K // ops._MP_KT) * ops._MP_KT


# ---------------------------------------------------------------------------
# the refusals


@pytest.mark.parametrize("mode", ["auto", "chunked", "replay"])
def test_engine_refuses_encoder_decoder(w, mode):
    """The reference refuses whisper in chunked mode with this
    ``ValueError`` and fails at the first tick otherwise (ROADMAP C10);
    the port refuses it at construction in every mode."""
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeEngine(w.cfg, w.tparams, max_seq=MAX_SEQ, prefill_mode=mode,
                    device="cpu")


def test_launcher_refuses_encoder_decoder():
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
