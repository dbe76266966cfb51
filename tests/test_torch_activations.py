"""The port's SiLU and SwiGLU MLP against the JAX package's.

``layers.silu`` mirrors ``jax.jit(jax.nn.silu)`` as XLA compiles it on the
CPU, ``x * (1 / (exp(-x) + 1))`` with every result flushed to zero below
2^-126 and, in bf16, rounded to bf16 after each operation.  Tolerances:
in bf16 the two are bit-identical on every finite value with
|x| < 1e4.  In float32 ``torch.exp`` and XLA's ``exp`` differ in the last
place on a few percent of inputs, which the division and the product
carry through: at most ``F32_DIFFER`` of the seeded samples may differ,
by at most ``F32_MAX_ULP`` ulps (jax 0.9.0 on an x86 CPU: 7,283 of the
211,000 differ, 3.45%, by at most 4 ulps).  The form itself is read from
the compiled HLO.  The SwiGLU MLP takes its products in
another order than XLA's, so its outputs agree to ``rtol = 1e-5`` and
1e-5 of the largest output in float32, and to ``2**-6`` (two bf16 ulps)
in bf16.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.models import layers

#: float32: share of samples that may differ from the reference, and by
#: how many ulps at most (just above the readings: 3.45%, 4 ulps)
F32_DIFFER, F32_MAX_ULP = 0.04, 4

#: the arithmetic of the compiled ``jax.nn.silu``, in order; in bf16 each
#: result is converted to bf16 and back to float32 before the next
SILU_OPS = ("negate", "exponential", "add", "divide", "multiply")


def _all_bf16(limit: float = 1e4) -> np.ndarray:
    """Every finite bf16 value with |x| < ``limit``, as bit patterns."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = bits.astype(np.uint32) << 16
    f = vals.view(np.float32)
    return bits[np.isfinite(f) & (np.abs(f) < limit)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_mirrors_the_compiled_reference(dtype):
    """The fused loop XLA compiles for ``jax.nn.silu`` is the form
    ``layers.silu`` mirrors: ``x * (1 / (exp(-x) + 1))``, the addition's
    first operand the exponential and the division's numerator the
    constant 1; in bf16 every intermediate is rounded to bf16."""
    text = jax.jit(jax.nn.silu).lower(
        jnp.zeros((16,), dtype)).compile().as_text()
    body = text[text.index("%fused_computation"):text.index("ENTRY")]
    defs = {name: (op, args.split(", ")) for name, op, args in re.findall(
        r"%([\w.]+) = \w+\[[^\]]*\]\{[^}]*\} (\w+)\(([^)]*)\)", body)}
    names = [op for op, _ in defs.values()
             if op not in ("parameter", "constant", "broadcast")]
    if dtype == "float32":
        assert tuple(names) == SILU_OPS
    else:
        want = ["convert"]
        for op in SILU_OPS:
            want += [op, "convert"] + (["convert"] if op != "multiply"
                                       else [])
        assert names == want

    def source(arg: str) -> str:
        """The op behind an operand, through the bf16 round trips."""
        op, args = defs[arg.lstrip("%")]
        return source(args[0]) if op == "convert" else op

    (_, add), = [d for d in defs.values() if d[0] == "add"]
    (_, div), = [d for d in defs.values() if d[0] == "divide"]
    assert source(add[0]) == "exponential" and source(add[1]) == "broadcast"
    assert source(div[0]) == "broadcast" and source(div[1]) == "add"


def test_silu_bf16_bit_identical_on_every_value():
    bits = _all_bf16()
    assert bits.size == 35_898
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    assert int((x.float().abs() < 2.0 ** -126).sum()) > 0  # subnormals in
    got = layers.silu(x)
    assert got.dtype == torch.bfloat16
    want = jax.jit(jax.nn.silu)(jnp.asarray(bits).view(jnp.bfloat16))
    want_bits = np.asarray(want).view(np.uint16)
    got_bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_bits, want_bits)


def test_silu_float32_within_stated_ulps():
    """Seeded samples over the range a gate sees, with tails that reach
    exp's overflow and results in the subnormal range."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000) * 10,
                        rng.uniform(-100, 100, 100_000),
                        rng.standard_normal(10_000) * 1e-3,
                        -rng.uniform(80, 120, 1_000)]).astype(np.float32)
    got = layers.silu(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(x)))
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert (ulps != 0).mean() <= F32_DIFFER
    assert ulps.max() <= F32_MAX_ULP


def test_swiglu_is_the_repaired_silu():
    assert layers.activation_fn("swiglu") is layers.silu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_mlp_matches_reference(dtype):
    """A reduced SwiGLU MLP (d 64, d_ff 176) on the same weights: the
    port's ``layers.mlp`` against the JAX ``layers.mlp``."""
    d, d_ff = 64, 176
    jp = jlayers.mlp_init(jax.random.PRNGKey(3), d, d_ff, "swiglu")
    rng = np.random.default_rng(4)
    x = (2 * rng.standard_normal((5, 7, d))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jlayers.mlp(jp, jx, "swiglu").astype(jnp.float32))
    tp = {k: {n: bridge.to_tensor(np.asarray(a)) for n, a in v.items()}
          for k, v in jp.items()}
    got = layers.mlp(tp, bridge.to_tensor(np.asarray(jx)), "swiglu")
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
