"""The port's SmoothQuant W8A8 quantizers against the JAX package's, on the
same numpy inputs.

Tolerance: none.  ``w_q``, ``w_scale``, ``smooth`` and the activation
quantizer's ``x_q``/``scale`` are bit-identical: both frameworks round half
to even, clip to [-127, 127], and the port takes the median of an even
channel count as the mean of the two middle values, as ``jnp.median`` does.
Calibration runs a bf16 forward in both packages; the port's GELU rounds
each step to bf16 as ``jax.nn.gelu`` does, so the recorded absmax are
bit-identical too (``F.gelu`` rounds once, and with it channel maxima
differed by a bf16 ulp and the two engines quantized to different
weights).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import quantize as jquantize
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.serving import quantize


def _same(t: torch.Tensor, a) -> bool:
    return torch.equal(t, bridge.to_tensor(np.asarray(a)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=64)
    tparams = bridge.params_from_numpy(jax.device_get(params))
    calib = np.random.default_rng(5).integers(1, jcfg.vocab_size, (2, 24))
    return jcfg, get_config("gpt2-345m").reduced(), params, tparams, calib


def test_quantize_act_bitexact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40)) * rng.uniform(0.01, 50, (6, 1))
         ).astype(np.float32)
    x[2] = 0.0  # an all-zero token takes the scale floor
    x[3, :4] = [127.5, -127.5, 0.5, -0.5]  # exact halves after scaling
    x[3, 4:] = 0.25
    jq, js = jquant.quantize_act(jnp.asarray(x))
    tq, ts = quant.quantize_act(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert _same(tq, jq) and _same(ts, js)


@pytest.mark.parametrize("dtype,M,K", [
    ("float32", 6, 40), ("float32", 5, 33), ("bfloat16", 6, 40),
    ("bfloat16", 1, 1027)])
def test_quant_act_plain_bitexact(dtype, M, K):
    """``ops.quant_act`` on the CPU (its plain version) is, bit for bit,
    the sequence ``layers.linear`` ran inline before it and the JAX
    package's smoothing multiply and ``quantize_act``: ragged widths, a
    row of zeros, smoothing factors over [1e-3, 1e3]."""
    rng = np.random.default_rng(M + K)
    x = (rng.standard_normal((M, K)) * rng.uniform(0.01, 50, (M, 1))
         ).astype(np.float32)
    x[M // 2] = 0.0
    s = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), K)).astype(np.float32)
    tx, ts = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(s)
    q, sc = ops.quant_act(tx, ts)
    assert q.dtype == torch.int8 and q.shape == (M, K)
    assert sc.dtype == torch.float32 and sc.shape == (M, 1)
    iq, isc = quant.quantize_act(tx.float() * (1.0 / ts)[None, :])
    assert torch.equal(q, iq) and torch.equal(sc, isc)
    xj = jnp.asarray(tx.float().numpy()) * (1.0 / jnp.asarray(s))[None, :]
    jq, jsc = jquant.quantize_act(xj)
    assert _same(q, jq) and _same(sc, jsc)


def test_quant_act_on_meta_gives_shapes():
    """The dry run's ``meta`` tensors take the plain version: shapes and
    dtypes only."""
    q, sc = ops.quant_act(torch.empty((5, 48), device="meta"),
                          torch.empty(48, device="meta"))
    assert q.device.type == sc.device.type == "meta"
    assert q.shape == (5, 48) and q.dtype == torch.int8
    assert sc.shape == (5, 1) and sc.dtype == torch.float32


def test_quantize_weight_bitexact():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((48, 20)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a dead output channel
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = quant.quantize_weight(torch.from_numpy(w))
    assert _same(tq, jq) and _same(ts, js)


@pytest.mark.parametrize("K", [32, 33])
def test_smooth_factors_bitexact(K):
    """Even K exercises the two-middle-values median, odd K the plain one."""
    rng = np.random.default_rng(K)
    amax = np.abs(rng.standard_normal(K) * 4).astype(np.float32)
    amax[0] = 0.0  # clamps to 1e-5
    w = (rng.standard_normal((K, 16)) * 0.02).astype(np.float32)
    want = jquant.smooth_factors(jnp.asarray(amax), jnp.asarray(w))
    got = quant.smooth_factors(torch.from_numpy(amax), torch.from_numpy(w))
    assert _same(got, want)
    if K % 2 == 0:  # torch.median would have taken the lower middle value
        s = got.double().numpy()
        assert np.median(s) != np.sort(s)[K // 2 - 1]


def test_quantize_model_params_bitexact_given_same_stats(model):
    """The same activation stats quantize every linear group of the
    bridged model to bit-identical ``w_q``/``w_scale``/``smooth``; norms,
    positions and the tied embedding stay fp and untouched."""
    jcfg, cfg, params, tparams, calib = model
    jstats = jquantize.calibrate(params, jcfg, [jnp.asarray(calib)])
    want = bridge.params_from_numpy(jax.device_get(
        jquantize.quantize_model_params(params, jcfg, jstats)))
    got = quantize.quantize_model_params(
        tparams, cfg, {k: torch.from_numpy(np.array(v))
                       for k, v in jstats.items()})
    want_leaves = dict(_leaves(want))
    got_leaves = dict(_leaves(got))
    assert want_leaves.keys() == got_leaves.keys()
    n_q = 0
    for path, t in got_leaves.items():
        assert t.dtype == want_leaves[path].dtype, path
        assert torch.equal(t, want_leaves[path]), path
        n_q += path.endswith("/w_q")
    assert n_q == 6 * cfg.n_layers  # q, k, v, out, up, down per layer


def test_quantize_model_params_uncalibrated_is_plain_w8a8(model):
    _, cfg, _, tparams, _ = model
    q = quantize.quantize_model_params(tparams, cfg)
    lin = q["layers"][0]["attn"]["q"]
    assert torch.equal(lin["smooth"], torch.ones(cfg.d_model))
    assert set(q["layers"][0]["ln1"]) == {"w", "b"}  # norms stay fp


def test_calibrate_stats_match_reference(model):
    jcfg, cfg, params, tparams, calib = model
    jstats = jquantize.calibrate(params, jcfg, [jnp.asarray(calib)])
    tstats = quantize.calibrate(tparams, cfg, [calib])
    # per-layer names differ ("p0.attn.q" under the scan, "l0.attn.q"
    # here); the suffixes that quantization reads are the same
    js = jquantize._suffix_stats(jstats)
    ts = quantize._suffix_stats(tstats)
    assert js.keys() == ts.keys() == {
        "attn.q", "attn.k", "attn.v", "attn.out", "mlp.up", "mlp.down"}
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_matches_reference(dtype):
    """bf16: bit-identical.  float32: within two ulps of the output where
    it is large, and 1e-6 where it underflows towards 0 (tanh differs)."""
    x = (np.random.default_rng(0).standard_normal(50000) * 4).astype(
        np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, getattr(jnp, dtype)),
                                  approximate=True).astype(jnp.float32))
    got = layers.gelu_tanh(torch.from_numpy(x).to(getattr(torch, dtype)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=1e-6)


def test_w8a8_linear_bitexact(model):
    """``layers.linear`` on a quantized group (smoothing, per-token int8,
    Fused MP product, f32 epilogue) equals the JAX layer bit for bit."""
    jcfg, _, params, _, _ = model
    w = np.array(params["periods"][0]["mlp"]["up"]["w"][0])
    rng = np.random.default_rng(9)
    amax = np.abs(rng.standard_normal(w.shape[0]) * 3).astype(np.float32)
    jp = jquant.quantize_linear_params(jnp.asarray(w), None,
                                       jnp.asarray(amax))
    tp = quant.quantize_linear_params(torch.from_numpy(w), None,
                                      torch.from_numpy(amax))
    x = rng.standard_normal((2, 3, w.shape[0])).astype(np.float32)
    want = jlayers.linear(jp, jnp.asarray(x))
    got = layers.linear(tp, torch.from_numpy(x))
    assert got.shape == (2, 3, w.shape[1]) and got.dtype == torch.float32
    assert _same(got, want)
