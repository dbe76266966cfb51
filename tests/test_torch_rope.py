"""The port's rotary position embedding (``layers.rope``) against the JAX
package's (``repro.models.layers.rope``), for the head dims and bases of
the four RoPE dense configs, full and reduced.

* The frequency table ``theta ** (-i / half)`` is bit-identical: the port
  rounds the exponent to float32 as JAX does and takes the power in
  float64, rounded once (a float32 ``torch.pow`` differs from XLA's in
  the last place on 0-5 entries of a table).  So are the angles
  ``position * freq``, one float32 product each.
* ``torch.cos``/``sin`` and XLA's differ by an ulp on about 5% of the
  angles, so float32 outputs agree within ``F32_ULPS`` ulps of the larger
  magnitude of their input pair ``(x1, x2)`` (an output near zero may
  lose its leading bits to cancellation, so its own ulp is no yardstick),
  and at most ``F32_SHARE`` of them differ at all.  On this file's inputs
  (12,288-196,608 outputs per config; x86 CPU, jax 0.9.0) 4.87-5.38%
  differ, by at most 4 ulps.
* In bf16 (the calibration forward) at most ``BF16_SHARE`` of the outputs
  differ, each by one bf16 ulp; 0-2 of them differed per config.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.layers import rope as jrope
from repro_torch.models.layers import rope, rope_freqs

ARCHS = ("tinyllama-1.1b", "llama3-8b", "minitron-4b", "gemma-7b")
F32_ULPS, F32_SHARE = 8, 0.07
BF16_SHARE = 1e-4


def _cfg(arch, reduced):
    cfg = jget_config(arch)
    return cfg.reduced() if reduced else cfg


def _inputs(cfg, seed, n=96):
    """x (2, n, 4, head_dim) and positions: one row 0..n-1, one row of
    random positions up to 8,192."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 4, cfg.head_dim)).astype(np.float32)
    pos = np.stack([np.arange(n), rng.integers(0, 8192, n)]).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_rope_freqs_and_angles_bit_identical(arch, reduced):
    cfg = _cfg(arch, reduced)
    half = cfg.head_dim // 2
    want = np.asarray(cfg.rope_theta ** (
        -jnp.arange(0, half, dtype=jnp.float32) / half))
    got = rope_freqs(half, cfg.rope_theta)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.arange(0, 1 << 20, 997, dtype=np.int32)
    np.testing.assert_array_equal(
        (torch.from_numpy(pos)[:, None].float() * got).numpy(),
        np.asarray(jnp.asarray(pos)[:, None].astype(jnp.float32)
                   * jnp.asarray(want)))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_rope_float32_within_stated_ulps(arch, reduced):
    cfg = _cfg(arch, reduced)
    x, pos = _inputs(cfg, seed=cfg.head_dim)
    want = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos),
                            cfg.rope_theta))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos),
               cfg.rope_theta).numpy()
    half = cfg.head_dim // 2
    mag = np.maximum(np.abs(x[..., :half]), np.abs(x[..., half:]))
    ulp = np.spacing(np.concatenate([mag, mag], -1))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert (np.abs(got - want) <= F32_ULPS * ulp).all()
    assert (got != want).mean() <= F32_SHARE


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_rope_bf16_within_one_ulp(arch, reduced):
    cfg = _cfg(arch, reduced)
    x, pos = _inputs(cfg, seed=cfg.head_dim + 1)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jrope(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(pos), cfg.rope_theta).astype(jnp.float32))
    got = rope(xb, torch.from_numpy(pos), cfg.rope_theta)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # a bf16 ulp: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= BF16_SHARE
