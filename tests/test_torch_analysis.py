"""The port's analysis layer on the CPU against the JAX package's: the
benchmark shapes and parameter counts of every registered config, the
spatial-kernel comparison, the FPGA and A100 perf models, ``model_flops``,
the roofline terms at the H100's constants, the single-policy samplers,
and the dry run's operation count against the analytic count of a
forward's products.

Tolerances: host-side arithmetic is the same Python in both packages and
must be equal (the perf model's latencies within 1e-12 relative); the
meta forward's operation count within 1% of the analytic one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.core import perfmodel as jperf
from repro.core import scheduler as jsched
from repro.serving import sampler as jsampler
from repro_torch.configs import base
from repro_torch.core import perfmodel, scheduler
from repro_torch.models import lm
from repro_torch.serving import sampler

ARCHS = jbase.list_archs()


def _pair(name, reduced):
    j, t = jbase.get_config(name), base.get_config(name)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


# ---------------------------------------------------------------------------
# configs


def test_shapes_and_assigned_archs_equal():
    assert base.ASSIGNED_ARCHS == jbase.ASSIGNED_ARCHS
    assert base.list_archs() == jbase.list_archs()
    assert {k: tuple(vars(v).values()) for k, v in base.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_and_shape_rules_equal(name, reduced):
    j, t = _pair(name, reduced)
    assert t.param_counts() == j.param_counts()
    assert all(type(v) is float for v in t.param_counts().values())
    assert t.attention_free == j.attention_free
    assert t.subquadratic == j.subquadratic
    assert base.applicable_shapes(t) == jbase.applicable_shapes(j)


@pytest.mark.parametrize("name", ARCHS)
def test_spatial_equivalent_kernels_equal(name):
    j, t = _pair(name, False)
    got = scheduler.spatial_equivalent_kernels(t)
    assert got == jsched.spatial_equivalent_kernels(j)
    assert got == scheduler.mdk_stats(t).reuse_factor()


# ---------------------------------------------------------------------------
# perf models


@pytest.mark.parametrize("kw", [{}, {"fuse_ln_res": False},
                                {"headwise_pipeline": False},
                                {"hide_transmission": False}],
                         ids=["default", "unfused", "serial_heads",
                              "exposed"])
@pytest.mark.parametrize("nodes", [1, 2, 4])
@pytest.mark.parametrize("name", ["gpt2-345m", "llama3-8b",
                                  "recurrentgemma-9b", "olmoe-1b-7b"])
def test_fpga_model_latencies_equal(name, nodes, kw):
    j, t = _pair(name, False)
    jm = jperf.FPGAPerfModel(j, nodes=nodes, **kw)
    tm = perfmodel.FPGAPerfModel(t, nodes=nodes, **kw)
    for ctx in (128, 512, 4096):
        np.testing.assert_allclose(tm.tokens_per_second(ctx),
                                   jm.tokens_per_second(ctx), rtol=1e-12)
    for n_in, n_out in ((128, 32), (512, 512), (32, 128)):
        np.testing.assert_allclose(tm.request_latency(n_in, n_out),
                                   jm.request_latency(n_in, n_out),
                                   rtol=1e-12)


def test_paper_tables_and_a100_model_equal():
    assert perfmodel.POWER_W == jperf.POWER_W
    assert perfmodel.PAPER_TABLE2 == jperf.PAPER_TABLE2
    assert perfmodel.PAPER_BASELINES == jperf.PAPER_BASELINES
    assert perfmodel.PAPER_TABLE3 == jperf.PAPER_TABLE3
    a, b = perfmodel.A100Model(), jperf.A100Model()
    assert (a.t_decode, a.prefill_tok_per_s) == \
        (b.t_decode, b.prefill_tok_per_s)
    for n_in, n_out in ((128, 32), (512, 512), (1024, 1)):
        assert a.request_latency(n_in, n_out) == \
            b.request_latency(n_in, n_out)


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_equal(name):
    j, t = _pair(name, False)
    for shape in jbase.SHAPES.values():
        args = (shape.kind, shape.seq_len, shape.global_batch)
        assert perfmodel.model_flops(t, *args) == jperf.model_flops(j, *args)


@pytest.mark.parametrize("terms", [(1e12, 1e9, 0.0), (1e15, 1e9, 1e8),
                                   (1e9, 1e12, 0.0), (0.0, 0.0, 1e10),
                                   (0.0, 0.0, 0.0)])
def test_roofline_terms_reference_formula_at_h100_constants(terms):
    """The reference's formula and keys, its TPU constants swapped for the
    H100 SXM data sheet's (bf16 dense peak, HBM3, NVLink 4 per
    direction)."""
    f, b, x = terms
    got = perfmodel.roofline_terms(f, b, x)
    assert set(got) == set(jperf.roofline_terms(f, b, x))
    tc, tm, tx = f / 989e12, b / 3.35e12, x / 450e9
    want = {"compute_s": tc, "memory_s": tm, "collective_s": tx,
            "dominant": max((tc, "compute"), (tm, "memory"),
                            (tx, "collective"))[1],
            "bound_s": max(tc, tm, tx),
            "overlap_efficiency": max(tc, tm, tx) / max(tc + tm + tx,
                                                        1e-30)}
    assert got == want
    assert perfmodel.H100_PEAK_OPS == {"int8": 1979e12, "bf16": 989e12,
                                       "f32": 67e12}


# ---------------------------------------------------------------------------
# samplers


def test_samplers_reference_cases():
    """The reference's ``test_samplers`` cases."""
    logits = torch.tensor([[0.0, 5.0, 1.0], [9.0, 0.0, 0.0]])
    assert sampler.greedy(logits).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    assert sampler.temperature(logits, gen, temp=0.01).tolist() == [1, 0]
    assert sampler.top_k(logits, gen, k=1).tolist() == [1, 0]


def test_greedy_equals_reference_and_draws_repeat():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 4, 50)).astype(np.float32)
    got = sampler.greedy(torch.from_numpy(logits))
    want = jsampler.greedy(jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = torch.from_numpy(logits)
    for fn, kw in ((sampler.temperature, {"temp": 1.0}),
                   (sampler.top_k, {"k": 5, "temp": 1.0})):
        a = fn(t, torch.Generator().manual_seed(3), **kw)
        b = fn(t, torch.Generator().manual_seed(3), **kw)
        assert a.shape == (6, 4) and torch.equal(a, b)
    # top_k only ever draws among each row's k largest logits
    top = torch.topk(t, 5, dim=-1).indices
    drawn = sampler.top_k(t, torch.Generator().manual_seed(4), k=5, temp=1.0)
    assert (top == drawn[..., None].long()).any(-1).all()


def test_temperature_follows_the_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0]]).expand(20_000, 3)
    tok = sampler.temperature(logits, torch.Generator().manual_seed(0),
                              temp=1.0)
    freq = torch.bincount(tok.long(), minlength=3).double() / tok.numel()
    want = torch.softmax(torch.tensor([0.0, 1.0, 2.0]), -1).double()
    assert (freq - want).abs().max() < 0.015


# ---------------------------------------------------------------------------
# the meta forward's operation count


def test_meta_forward_flops_match_the_analytic_count():
    """A reduced dense forward on ``meta``: FlopCounterMode's count within
    1% of 2 x tokens x (every linear's weights) plus the attention
    products (QK^T and PV over the full S x S, as computed)."""
    cfg = base.get_config("llama3-8b").reduced()
    B, S = 2, 256
    params = lm.init_abstract(cfg, max_seq=S)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        logits = lm.forward(params, cfg, tokens)
    assert logits.shape == (B, S, cfg.vocab_size)
    d, L = cfg.d_model, cfg.n_layers
    linear = L * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                  + 3 * d * cfg.d_ff) + d * cfg.vocab_size
    attn = L * 2 * 2 * B * S * S * cfg.q_dim
    want = 2 * B * S * linear + attn
    assert abs(fc.get_total_flops() - want) <= 0.01 * want
