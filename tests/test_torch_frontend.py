"""Pixtral's vision-patch frontend (a stub: precomputed patch embeddings
put before the tokens) in the port against the JAX package, on the CPU:
reduced ``pixtral-12b`` (2 layers, d 64, 4 heads over 2 of 16, RoPE,
``frontend_tokens`` 8), the weights carried across by the bridge.

Held against the reference on the same numpy inputs:

* float32 ``forward(patches=)`` (the patch prefix and positions run over
  ``S + frontend_tokens``) and ``batch_prefill(patches=)``: logits within
  ``atol = rtol = 1e-4`` (rotary cos/sin differ by an ulp here and
  there), every cache entry within ``1e-5``, the lengths equal; then
  greedy decode steps from the prefix-shifted positions: logits close,
  tokens equal;
* calibration with ``extras={"patches": ...}``: the same names,
  bit-identical at layer 0's q, k and v inputs (before any rotary phase),
  within ``STATS_RTOL`` (two bf16 ulps, as for the RoPE family)
  elsewhere;
* the engine, which like the reference's takes tokens only: W8A8 greedy
  streams of the port's paged and stacked engines equal to the JAX
  *stacked* engine's (ROADMAP C1 rules out its paged spec path, not its
  plain paged one), and the replay mode's equal to both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import quantize
from repro_torch.serving.engine import ServeEngine

ARCH = "pixtral-12b"
B, S, MAX_SEQ, PS, SLOTS, CHUNK, MAX_NEW, STEPS = 2, 11, 64, 8, 2, 8, 8, 6
ATOL = RTOL = 1e-4
CACHE_ATOL = CACHE_RTOL = 1e-5
STATS_RTOL = 2 ** -6


class Pixtral:
    """The reference's and the port's objects, each made on first use."""

    def __init__(self):
        self.jcfg = jget_config(ARCH).reduced()
        self.cfg = get_config(ARCH).reduced()
        self.jlayers = jlm.init(self.jcfg, jax.random.PRNGKey(0),
                                layout="layers")
        self.jparams = dict(self.jlayers, rest=[], periods=(
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *self.jlayers["rest"]),))
        self.tparams = bridge.params_from_numpy(
            jax.device_get(self.jlayers))
        rng = np.random.default_rng(6)
        P = self.cfg.frontend_tokens
        self.tokens = rng.integers(1, self.cfg.vocab_size, (B, S))
        self.patches = rng.standard_normal(
            (B, P, self.cfg.d_model)).astype(np.float32)
        self.calib = rng.integers(1, self.cfg.vocab_size, (2, 12))
        self.calib_patches = rng.standard_normal(
            (2, P, self.cfg.d_model)).astype(np.float32)
        self.prompts = [rng.integers(1, self.cfg.vocab_size, int(n)).tolist()
                        for n in (5, 19, 9, 30)]

    @functools.cached_property
    def jstats(self):
        return jquantize.calibrate(
            self.jlayers, self.jcfg, [jnp.asarray(self.calib)],
            extras={"patches": jnp.asarray(self.calib_patches)})

    @functools.cached_property
    def jq(self):
        return jquantize.quantize_model_params(self.jparams, self.jcfg,
                                               self.jstats)

    @functools.cached_property
    def tq(self):
        return bridge.params_from_numpy(jax.device_get(self.jq))

    @functools.cached_property
    def jax_stream(self):
        eng = JServeEngine(self.jcfg, self.jq, kv_layout="stacked",
                           act_dtype=jnp.float32, **_COMMON)
        return _serve(eng, self.prompts)


_COMMON = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
               chunk_size=CHUNK, page_size=PS)


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run()}


@pytest.fixture(scope="module")
def px():
    return Pixtral()


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


def test_forward_with_patches_matches(px):
    want = jlm.forward(px.jparams, px.jcfg, jnp.asarray(px.tokens),
                       patches=jnp.asarray(px.patches), dtype=jnp.float32)[0]
    got = lm.forward(px.tparams, px.cfg, torch.from_numpy(px.tokens),
                     patches=torch.from_numpy(px.patches),
                     dtype=torch.float32)
    assert got.shape == (B, px.cfg.frontend_tokens + S, px.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_batch_prefill_with_patches_and_decode_match(px):
    """The patch prefix fills positions 0..P-1 of float32 stacked caches,
    the prompt P..P+S-1 (lengths P + S on both sides); greedy decode
    steps go on from there."""
    jc = jlm.init_cache(px.jcfg, B, MAX_SEQ, dtype=jnp.float32)
    tc = lm.init_cache(px.cfg, B, MAX_SEQ, layout="stacked",
                       dtype=torch.float32)
    jl, jc, jn = jlm.batch_prefill(
        px.jparams, px.jcfg, jnp.asarray(px.tokens), jc,
        patches=jnp.asarray(px.patches), dtype=jnp.float32)
    tl, tc, tn = lm.batch_prefill(
        px.tparams, px.cfg, torch.from_numpy(px.tokens), tc,
        patches=torch.from_numpy(px.patches), dtype=torch.float32)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) == px.cfg.frontend_tokens + S
    for _ in range(STEPS):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        want = dict(_leaves(jax.device_get(jc)))
        got = dict(_leaves(bridge.cache_to_numpy(tc, px.cfg.n_layers)))
        assert got.keys() == want.keys()
        for path, a in got.items():
            np.testing.assert_allclose(a, _np(want[path]), atol=CACHE_ATOL,
                                       rtol=CACHE_RTOL, err_msg=path)
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        np.testing.assert_array_equal(tok[:, 0], tl.argmax(-1).numpy())
        jl, jc = jlm.decode_step(px.jparams, px.jcfg,
                                 jnp.asarray(tok, jnp.int32), jc, jn,
                                 dtype=jnp.float32)
        tl, tc = lm.decode_step(px.tparams, px.cfg, torch.from_numpy(tok),
                                tc, tn, dtype=torch.float32)
        jn, tn = jn + 1, tn + 1


def test_calibration_with_patches_matches(px):
    tstats = quantize.calibrate(px.tparams, px.cfg, [px.calib],
                                extras={"patches": px.calib_patches})
    want = {("l" + k[1:] if k.startswith("r") else k): np.asarray(v)
            for k, v in px.jstats.items()}
    assert tstats.keys() == want.keys()
    for name in ("l0.attn.q", "l0.attn.k", "l0.attn.v"):
        np.testing.assert_array_equal(tstats[name].numpy(), want[name])
    for name, v in tstats.items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=STATS_RTOL,
                                   atol=0, err_msg=name)
    # the patches reach the forward: stats without them differ
    plain = quantize.calibrate(px.tparams, px.cfg, [px.calib])
    assert not torch.equal(plain["l0.attn.q"], tstats["l0.attn.q"])


@pytest.mark.parametrize("mode", ["chunked", "replay"])
@pytest.mark.parametrize("layout", ["paged", "stacked"])
def test_w8a8_engine_streams_match_jax_stacked_engine(px, layout, mode):
    """The engine serves pixtral's decoder on tokens (as the reference's
    engine does): greedy W8A8 streams on both layouts and in both prefill
    modes equal the JAX stacked engine's, token for token."""
    eng = ServeEngine(px.cfg, px.tq, act_dtype=torch.float32, device="cpu",
                      kv_layout=layout, prefill_mode=mode, **_COMMON)
    assert eng.kv_layout == layout and eng.prefill_mode == mode
    got = _serve(eng, px.prompts)
    assert got == px.jax_stream
    assert all(len(o) == MAX_NEW for o in got.values())
