"""The port's GPT-2 model against the JAX package's, with weights carried
across by the bridge: the full-sequence forward, and the paged serving
steps (chunked prefill into a block table, then batched decode with a
tag-along row) on the page pool.

Tolerances, all at float32 activations: logits ``atol = rtol = 1e-4``
(float32 sums in another order; the two frameworks' float32 ``tanh`` and
``rsqrt`` differ by an ulp here and there).  The page pools are bf16, so
a K/V value whose float32 source sits at a rounding boundary may round
one bf16 ulp apart: cache contents agree to ``rtol = 2**-7`` (one ulp)
with ``atol = 1e-6``.
The W8A8 model re-quantizes activations at every linear, where one ulp
upstream can move a value across an int8 rounding step, so its logits are
held to ``atol = 5e-3`` (about 1/127 of the largest activation scale
the reduced model produces) and must pick the same argmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import quantize as jquantize
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm

ATOL = RTOL = 1e-4
PS, MAX_SEQ = 8, 64


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    return (jcfg, get_config("gpt2-345m").reduced(), params,
            bridge.params_from_numpy(jax.device_get(params)))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = jget_config("gpt2-345m"), get_config("gpt2-345m")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)


def test_unsupported_stacks_raise():
    """A mixed stack (global and local attention) initialises and takes a
    stacked cache, and its per-kind paged cache (a ring per slot beside
    the pages) only with ``slots``/``slot_seq`` (``ValueError`` without,
    as the reference); an unknown block kind and an unported layout
    raise.  An encoder-decoder,
    refused before its port, initialises with an encoder and cross
    sub-blocks, and its stacked cache holds a cross K/V per layer."""
    cfg = dataclasses.replace(get_config("gpt2-345m").reduced(),
                              block_pattern=("attn", "local_attn"),
                              window=8)
    lm.init(cfg, torch.Generator().manual_seed(0), max_seq=16)
    ring = lm.init_cache(cfg, 2, 16, layout="stacked")["layers"][1]["k"]
    assert ring.shape[2] == 8  # min(window, max_seq)
    with pytest.raises(ValueError, match="slots= and slot_seq="):
        lm.init_cache(cfg, 4, PS, layout="paged")
    paged = lm.init_cache(cfg, 4, PS, layout="paged", slots=2, slot_seq=16)
    assert paged["layers"][0]["k"].shape[:3] == (4, cfg.n_kv_heads, PS)
    assert paged["layers"][1]["k"].shape[:3] == (2, cfg.n_kv_heads, 8)
    with pytest.raises(NotImplementedError, match="block kinds"):
        lm.init(dataclasses.replace(cfg, block_pattern=("attn", "conv")),
                torch.Generator().manual_seed(0), max_seq=16)
    enc = dataclasses.replace(get_config("gpt2-345m").reduced(),
                              is_encoder_decoder=True, n_encoder_layers=2,
                              encoder_seq=12)
    params = lm.init(enc, torch.Generator().manual_seed(0), max_seq=16)
    assert len(params["encoder"]["layers"]) == 2
    assert all("cross_attn" in lp for lp in params["layers"])
    cache = lm.init_cache(enc, 2, 16, layout="stacked")
    assert [e["k"].shape for e in cache["cross"]] == \
        [(2, enc.n_kv_heads, 12, enc.head_dim)] * enc.n_layers
    with pytest.raises(NotImplementedError, match="layout"):
        lm.init_cache(get_config("gpt2-345m").reduced(), 4, PS,
                      layout="layers")


def test_bridge_params_layout(model):
    jcfg, cfg, params, tparams = model
    assert len(tparams["layers"]) == cfg.n_layers
    assert tparams["pos_embed"].shape == (MAX_SEQ, cfg.d_model)
    assert "lm_head" not in tparams  # tied embeddings
    for li in range(cfg.n_layers):
        np.testing.assert_array_equal(
            tparams["layers"][li]["mlp"]["down"]["w"].numpy(),
            np.asarray(params["periods"][0]["mlp"]["down"]["w"][li]))


def test_init_scales_match_reference(model):
    """``lm.init`` draws from a torch Generator (other numbers than
    ``jax.random``) but with the reference's shapes, dtypes and scales."""
    _, cfg, _, tparams = model
    mine = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=MAX_SEQ)
    assert mine.keys() == tparams.keys()
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(tparams)):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype
        if a.numel() > 1000:
            assert abs(a.std().item() / b.std().item() - 1) < 0.1, pa


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_forward_logits_match(model):
    jcfg, cfg, params, tparams = model
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 23))
    want = jlm.forward(params, jcfg, jnp.asarray(tokens),
                       dtype=jnp.float32)[0]
    got = lm.forward(tparams, cfg, torch.from_numpy(tokens),
                     dtype=torch.float32)
    assert got.shape == (2, 23, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_bridge_cache_roundtrip(model):
    jcfg, cfg, _, _ = model
    jc = jlm.init_cache(jcfg, 5, PS, layout="paged")
    rng = np.random.default_rng(1)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jc)
    tc = bridge.cache_from_numpy(jax.device_get(jc))
    assert len(tc["layers"]) == cfg.n_layers
    assert tc["layers"][0]["k"].shape == (5, cfg.n_kv_heads, PS,
                                          cfg.head_dim)
    assert tc["layers"][0]["k"].dtype == torch.bfloat16
    back = bridge.cache_to_numpy(tc, n_per=cfg.n_layers)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _serve_steps(jcfg, cfg, jparams, tparams, prompts, n_decode):
    """Prefill each prompt into its own pages in chunks of 8, then decode
    ``n_decode`` batched steps with one extra idle row riding along.
    Returns the per-call logits and final caches of both packages."""
    n_pg = MAX_SEQ // PS
    B = len(prompts) + 1  # the last row is an idle tag-along
    n_pages = 1 + B * n_pg
    bt = np.zeros((B, n_pg), np.int32)
    ids = 1 + np.random.default_rng(2).permutation(n_pages - 1)
    for b in range(len(prompts)):
        bt[b] = ids[b * n_pg:(b + 1) * n_pg]
    jc = jlm.init_cache(jcfg, n_pages, PS, layout="paged")
    tc = lm.init_cache(cfg, n_pages, PS)
    out_j, out_t = [], []
    C = 8
    for b, prompt in enumerate(prompts):
        for off in range(0, len(prompt), C):
            n = min(C, len(prompt) - off)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = prompt[off:off + n]
            lj, jc = jlm.prefill_into_slot(
                jparams, jcfg, jnp.asarray(chunk), jc, 0, off, valid=n,
                block_table=jnp.asarray(bt[b]), dtype=jnp.float32)
            lt, tc = lm.prefill_into_slot(
                tparams, cfg, torch.from_numpy(chunk), tc, off, valid=n,
                block_table=torch.from_numpy(bt[b]), dtype=torch.float32)
            out_j.append(np.asarray(lj))
            out_t.append(lt.numpy())
    lengths = np.array([len(p) for p in prompts] + [0], np.int32)
    active = np.array([True] * len(prompts) + [False])
    tok = np.array([[p[-1]] for p in prompts] + [[0]], np.int32)
    for _ in range(n_decode):
        lj, jc = jlm.decode_step(
            jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(lengths),
            active=jnp.asarray(active), block_table=jnp.asarray(bt),
            dtype=jnp.float32)
        lt, tc = lm.decode_step(
            tparams, cfg, torch.from_numpy(tok), tc,
            torch.from_numpy(lengths), active=torch.from_numpy(active),
            block_table=torch.from_numpy(bt), dtype=torch.float32)
        out_j.append(np.asarray(lj)[:-1])
        out_t.append(lt.numpy()[:-1])
        tok = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + active
    return out_j, out_t, jc, tc


def test_paged_prefill_and_decode_match_reference(model):
    """Chunked prefill (a ragged last chunk, a chunk crossing pages) and
    batched decode on the page pool give the reference's logits after
    every call, and leave the same K/V in every page (the idle row's
    writes parked on the null page in both)."""
    jcfg, cfg, params, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (11, 19)]
    out_j, out_t, jc, tc = _serve_steps(jcfg, cfg, params, tparams,
                                        prompts, n_decode=4)
    assert len(out_t) == 2 + 3 + 4
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    back = bridge.cache_to_numpy(tc, n_per=cfg.n_layers)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(b[1:], np.asarray(a, np.float32)[1:],
                                   rtol=2 ** -7, atol=1e-6)


def test_w8a8_paged_steps_match_reference(model):
    """The quantized model (JAX-quantized weights carried across) through
    the same prefill and decode calls."""
    jcfg, cfg, params, _ = model
    calib = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 16))
    qparams = jquantize.quantize_model_params(
        params, jcfg, jquantize.calibrate(params, jcfg, [jnp.asarray(calib)]))
    tq = bridge.params_from_numpy(jax.device_get(qparams))
    assert "w_q" in tq["layers"][0]["attn"]["q"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (9, 14)]
    out_j, out_t, _, _ = _serve_steps(jcfg, cfg, qparams, tq, prompts,
                                      n_decode=3)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=0)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
