"""The port's serving stack on the CPU against the JAX package's: the
engine on one request stream (with prompts that share a prefix), the page
manager, admission, the stage program and its cost model, and sampling.

Tolerances: at float32 activations the greedy streams are identical; with
W8A8 weights calibrated on the same batch the greedy agreement must reach
0.9 (the reference holds its own quantized engine to 0.8 against fp).
Calibration forwards run in bf16, whose rounding differs between the two
frameworks, so the two engines quantize to slightly different weights.
Host-side bookkeeping (block tables, refcounts, budgets, prices, the FPGA
cost model) is pure Python in both and must be equal.  Sampled streams
come from different generators, so they are tested by distribution.
"""
import dataclasses
import json

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
from repro.serving import kv_cache as jkv_cache
from repro.serving import sampler as jsampler
from repro.serving import telemetry as jtelemetry
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import perfmodel, scheduler
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import (admission, kv_cache, sampler, speculative,
                                 telemetry)
from repro_torch.serving.engine import ServeEngine

MAX_SEQ, PAGE, SLOTS, CHUNK, MAX_NEW = 64, 8, 3, 8, 6


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("gpt2-345m").reduced()
    params = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    rng = np.random.default_rng(1)
    shared = rng.integers(1, jcfg.vocab_size, 20).tolist()
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for n in (3, 17, 9, 30)]
    prompts += [shared + [5, 6], shared + [7]]
    calib = rng.integers(1, jcfg.vocab_size, (1, 16))
    return (jcfg, get_config("gpt2-345m").reduced(), params,
            bridge.params_from_numpy(jax.device_get(params)), prompts, calib)


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p, max_new=MAX_NEW)
    return {r.rid: r.out for r in engine.run()}


def _pair(setup, **kw):
    """The same request stream through both engines; returns
    ``(jax_engine, jax_streams, port_engine, port_streams)``."""
    jcfg, cfg, params, tparams, prompts, calib = setup
    common = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
                  page_size=PAGE, chunk_size=CHUNK)
    quantized = kw.get("quantized", False)
    je = JServeEngine(
        jcfg, params, quantized=quantized,
        calibration_batches=[jnp.asarray(calib)] if quantized else None,
        act_dtype=None if quantized else jnp.float32, **common)
    te = ServeEngine(
        cfg, tparams, quantized=quantized,
        calibration_batches=[calib] if quantized else None,
        act_dtype=None if quantized else torch.float32, device="cpu",
        **common)
    return je, _serve(je, prompts), te, _serve(te, prompts)


@pytest.fixture(scope="module")
def fp_pair(setup):
    return _pair(setup)


def test_fp32_greedy_streams_identical(fp_pair):
    je, jout, te, tout = fp_pair
    assert tout == jout
    assert all(len(o) == MAX_NEW for o in tout.values())
    js, ts = je.stats(), te.stats()
    for k in ("ticks", "model_calls", "prefill_calls", "prefix_hit_pages",
              "pages_allocated_total", "pages_in_use_peak",
              "cached_free_pages", "n_free_pages", "mdk_mp_reuse"):
        assert ts[k] == js[k], k
    assert ts["prefix_hit_pages"] > 0  # the shared prompt pages were linked


def test_stats_keys_and_refcounts_drain(fp_pair):
    _, _, te, _ = fp_pair
    s = te.stats()
    assert set(s) == telemetry.STATS_KEYS_ENGINE
    assert telemetry.STATS_KEYS_ENGINE == jtelemetry.STATS_KEYS_ENGINE
    assert s["pages_in_use"] == 0 and s["requests"] == 6
    assert all(te.kv.refcount(p) == 0 for p in range(te.kv.n_pages))
    assert not te.kv.block_tables.any() and not te.kv.lengths.any()


def test_quantized_greedy_agreement(setup):
    ops.reset_launch_counts()
    _, jout, te, tout = _pair(setup, quantized=True)
    agree = sum(a == b for rid in jout for a, b in zip(jout[rid], tout[rid]))
    total = sum(len(o) for o in jout.values())
    assert agree / total >= 0.9, (agree, total)
    assert te.act_dtype == torch.float32
    # on the CPU every wrapper took its plain version: nothing launched
    assert ops.launch_counts() == {
        "mp_matmul": 0, "paged_mha_decode": 0, "paged_verify": 0,
        "paged_verify_tree": 0, "mha_decode": 0, "ln_res": 0}


def test_engine_without_card_raises(setup, monkeypatch):
    """The default device is the card; with none present the engine
    refuses instead of running on the CPU."""
    _, cfg, _, tparams, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, tparams, max_seq=MAX_SEQ)


@pytest.mark.parametrize("kw", [
    # a draft model of a recurrent stack: its cache cannot rewind by
    # length, so it is refused with the reference's ValueError
    {"spec": speculative.SpecConfig(
        proposer="model", draft_params={},
        draft_cfg=dataclasses.replace(get_config("gpt2-345m").reduced(),
                                      block_pattern=("rglru",)))},
    {"prefill_mode": "replay"}, {"mesh": object()},
])
def test_unported_engine_options_raise(setup, kw, fp_pair):
    """Options the port refuses raise; replay prefill, refused before its
    port, now serves the chunked engine's float32 streams."""
    _, cfg, _, tparams, prompts, _ = setup
    if kw.get("prefill_mode") == "replay":
        eng = ServeEngine(cfg, tparams, batch_slots=SLOTS, max_seq=MAX_SEQ,
                          eos_id=-1, page_size=PAGE, chunk_size=CHUNK,
                          act_dtype=torch.float32, device="cpu", **kw)
        assert eng.prefill_mode == "replay"
        assert _serve(eng, prompts) == fp_pair[3]
        assert eng.stats()["prefill_calls"] == 0
        return
    exc, match = ((ValueError, "global-attention draft") if "spec" in kw
                  else (NotImplementedError, "not ported"))
    with pytest.raises(exc, match=match):
        ServeEngine(cfg, tparams, max_seq=MAX_SEQ, device="cpu", **kw)


def test_submit_validation_and_stall(setup):
    _, cfg, _, tparams, _, _ = setup
    eng = ServeEngine(cfg, tparams, batch_slots=1, max_seq=MAX_SEQ,
                      eos_id=-1, device="cpu")
    with pytest.raises(ValueError, match="fit the cache"):
        eng.submit([], max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1, 2], max_new=0)
    for _ in range(3):
        eng.submit([5, 6, 7], max_new=4)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run(max_ticks=2)
    assert len(eng.run()) == 3 and eng.stats()["stalled"] == 0


def test_trace_spans(setup, tmp_path):
    _, cfg, _, tparams, _, _ = setup
    eng = ServeEngine(cfg, tparams, batch_slots=2, max_seq=MAX_SEQ,
                      eos_id=-1, device="cpu",
                      telemetry=telemetry.Telemetry(trace=True))
    eng.submit(list(range(1, 12)), max_new=3)
    eng.run()
    with open(eng.dump_trace(str(tmp_path / "t.json"))) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tick", "prefill.chunk", "decode.step",
            "req.first_token"} <= names


def test_page_manager_matches_reference(setup):
    """One scripted sequence of admissions (two sharing a prefix), prefill
    advances, decode growth and frees (a cached prefix page resurrected)
    leaves both managers in the same state after every step."""
    jcfg, cfg, _, _, _, _ = setup
    mk = dict(page_size=4, n_pages=14)
    jm = jkv_cache.PagedCacheManager(jcfg, 3, 16, with_cache=False, **mk)
    tm = kv_cache.PagedCacheManager(cfg, 3, 16, **mk)
    a = list(range(1, 10))

    def both(fn):
        return fn(jm), fn(tm)

    def same():
        np.testing.assert_array_equal(tm.block_tables, jm.block_tables)
        np.testing.assert_array_equal(tm.lengths, jm.lengths)
        assert tm.stats() == jm.stats()
        assert [tm.refcount(p) for p in range(14)] == \
            [jm.refcount(p) for p in range(14)]

    steps = [
        lambda m: m.alloc(a, 4),
        lambda m: m.probe_pending(a + [50]),
        lambda m: m.advance(0, 9),
        lambda m: m.alloc(a + [50], 2),
        lambda m: m.ensure_decode_room([True, False, False], 1),
        lambda m: m.advance_mask([True, False, False]),
        lambda m: m.alloc([7] * 15, 8),  # does not fit: None
        lambda m: m.free(0),
        lambda m: m.free(1),
        lambda m: m.alloc(a + [60, 61], 3),  # resurrects the cached prefix
        lambda m: m.has_room(0, 6),
    ]
    for step in steps:
        j, t = both(step)
        assert t == j
        same()
    assert tm.stats()["prefix_hit_pages"] == 4


def test_admission_and_cost_model_match_reference(setup):
    jcfg, cfg, _, _, _, _ = setup
    full_j, full_t = jget_config("gpt2-345m"), get_config("gpt2-345m")
    for jc, tc in ((jcfg, cfg), (full_j, full_t)):
        assert [dataclasses.astuple(s) for s in scheduler.model_program(tc)] \
            == [dataclasses.astuple(s) for s in jscheduler.model_program(jc)]
        assert scheduler.mdk_stats(tc).reuse_factor() == \
            jscheduler.mdk_stats(jc).reuse_factor()
        jp, tp = jperfmodel.FPGAPerfModel(jc), perfmodel.FPGAPerfModel(tc)
        assert tp.token_latency() == {
            k: v for k, v in jp.token_latency().items() if k in
            tp.token_latency()}
        assert tp.prefill_token_latency() == jp.prefill_token_latency()
        for chunk in (8, 32):
            ja = jadmission.FIFOAdmission(jc, chunk_size=chunk)
            ta = admission.FIFOAdmission(tc, chunk_size=chunk)
            assert ta.budget_tokens == ja.budget_tokens
            triples = [(0, 70, 0), (2, 5, 0), (1, 300, 64), (3, 9, 9)]
            assert [dataclasses.astuple(c) for c in ta.plan_chunks(triples)] \
                == [dataclasses.astuple(c) for c in ja.plan_chunks(triples)]
            for args in ((10, 20), (100, 500), (3, 1)):
                kw = dict(page_size=16, max_seq=256, shared_tokens=16)
                assert ta.page_price(*args, **kw) == \
                    ja.page_price(*args, **kw)


def test_filter_logits_matches_reference():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((5, 40)).astype(np.float32) * 3
    lg[4, :3] = 9.0  # ties at the top
    temp = np.array([0.0, 1.0, 0.7, 2.0, 1.0], np.float32)
    topk = np.array([0, 5, 0, 1, 0], np.int32)
    topp = np.array([1.0, 1.0, 0.6, 0.9, 0.5], np.float32)
    want = jsampler._filter_logits(jnp.asarray(lg), jnp.asarray(temp),
                                   jnp.asarray(topk), jnp.asarray(topp))
    got = sampler._filter_logits(torch.from_numpy(lg),
                                 torch.from_numpy(temp),
                                 torch.from_numpy(topk),
                                 torch.from_numpy(topp))
    np.testing.assert_array_equal(got.numpy() > -1e29,
                                  np.asarray(want) > -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sampling_follows_the_filtered_distribution():
    """20000 draws per row: the empirical frequencies match the filtered
    softmax within 0.015 (about 4 standard deviations), a greedy row
    always takes its argmax, top-k keeps k tokens, and top-p keeps tokens
    by rank (the two tied at the cut are not both readmitted)."""
    n = 20000
    probs = np.array([[0.1, 0.2, 0.3, 0.4, 1e-9],
                      [0.1, 0.2, 0.3, 0.4, 1e-9],
                      [0.1, 0.2, 0.3, 0.4, 1e-9],
                      [0.4, 0.3, 0.3, 1e-9, 1e-9]], np.float32)
    lg = torch.from_numpy(np.log(probs)).repeat_interleave(n, 0)
    temp = torch.tensor([0.0, 1.0, 1.0, 1.0]).repeat_interleave(n)
    topk = torch.tensor([0, 0, 2, 0]).repeat_interleave(n)
    topp = torch.tensor([1.0, 1.0, 1.0, 0.5]).repeat_interleave(n)
    gen = torch.Generator().manual_seed(0)
    tok = sampler.sample_batch(lg, gen, temp, topk, topp).reshape(4, n)
    freq = np.stack([np.bincount(r, minlength=5) / n for r in tok.numpy()])
    want = np.array([[0, 0, 0, 1, 0],
                     [0.1, 0.2, 0.3, 0.4, 0],
                     [0, 0, 3 / 7, 4 / 7, 0],
                     [4 / 7, 3 / 7, 0, 0, 0]])
    np.testing.assert_allclose(freq, want, atol=0.015)
    assert freq[2, :2].sum() == 0 and freq[3, 2:].sum() == 0


def test_all_greedy_batch_draws_no_randomness():
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    lg = torch.tensor([[1e35, 0.0, -5.0], [0.0, 3.0, 1.0]])
    z = torch.zeros(2)
    tok = sampler.sample_batch(lg, gen, z, z.long(), torch.ones(2))
    assert tok.tolist() == [0, 1] and torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("profile", [False, True])
def test_launcher_serves_on_cpu(capsys, tmp_path, profile):
    argv = ["--reduced", "--device", "cpu", "--requests", "3", "--max-new",
            "4", "--slots", "2", "--chunk-size", "16", "--max-seq", "64"]
    if profile:
        argv += ["--profile", str(tmp_path)]
    stats = serve.main(argv)
    assert stats["requests"] == 3 and stats["pages_in_use"] == 0
    out = capsys.readouterr().out
    assert "gpt2-345m-reduced on cpu: 3 requests, 12 tokens" in out
    if profile:  # a CPU run names no device time
        assert "device busy: not measured (CPU run)" in out
        with open(tmp_path / "serve_trace.json") as f:
            assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("spec", [["--spec", "ngram"],
                                  ["--spec", "model", "--tree-branch", "2"]])
def test_launcher_serves_with_speculation_on_cpu(capsys, spec):
    argv = ["--reduced", "--device", "cpu", "--requests", "3", "--max-new",
            "5", "--slots", "2", "--chunk-size", "16", "--max-seq", "64"]
    stats = serve.main(argv + spec)
    assert stats["requests"] == 3 and stats["pages_in_use"] == 0
    assert stats["spec_ticks"] > 0
    assert (stats["draft_calls"] > 0) == ("model" in spec)


def test_busy_share_counts_overlaps_once():
    assert serve._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
