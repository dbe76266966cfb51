"""The hybrid stacks in the port against the JAX package, on the CPU:
reduced ``recurrentgemma-9b`` (RG-LRU, RG-LRU, local attention; MQA,
window 32), reduced ``xlstm-350m`` (three mLSTM and one sLSTM, no
attention) and a mixed stack (global attention, local attention,
RG-LRU), with the weights carried across by the bridge.

Held against the reference on the same numpy inputs:

* the RG-LRU, mLSTM and sLSTM ``seq``, ``chunk`` and ``step`` paths and
  ``chunk_attention_rotating`` (a window-crossing chunk, padding, a
  parked row, and a chunk wider than the window): outputs, states and
  ring contents within ``atol = rtol = 1e-5`` (float32; the products,
  ``exp``, ``tanh`` and the sigmoids of torch and XLA differ in the last
  place), the ring slots that must stay untouched bit-identical;
* chunk == step: a chunk's state trajectory equals the states of token
  by token decode steps within the same tolerance;
* window-crossing chunked prefill and decode steps with an idle row
  riding along (float32 caches): logits within ``1e-4``, as the dense
  family, every ring slot and state within ``1e-5``, the idle row's
  ring and state bit-identical to before;
* float32 forward logits within ``1e-4``;
* W8A8 weights bit-identical given the reference's calibration stats
  (``w_r``, ``w_i``, the gates, ``rec``, ``conv`` and ``lam`` left
  float); calibration stats bit-identical at layer 0's first linear
  input and within four bf16 ulps (``2^-5`` relative) elsewhere: the
  bf16 products of torch and XLA round apart by an ulp now and then, and
  the RG-LRU stack's GeGLU inputs carry up to three;
* stage programs, the FPGA model, admission prices and the engine's
  request ceiling equal (lifted for the two window-capped stacks, kept
  for the mixed one), the full configs included;
* greedy W8A8 streams of the port's stacked engine equal to the JAX
  stacked engine's, token for token, prompts crossing the window and, on
  the window-capped stacks, the cache; bf16 streams equal up to where
  they part, and each parting a near-tie of the two sides' logits (their
  bf16 matrix products round apart by a few ulps: the logits of a bf16
  prefill differ by up to 0.008 on these stacks, and by 0.006 and 0.033
  on the reduced ``gemma-7b`` and ``llama3-8b``, whose seeded streams
  happen not to part);
* chain speculation equal to plain decode: with the n-gram proposer, and
  with a proposer that drafts the plain stream with every third token
  made wrong, so drafts are accepted and rejected in every verify that
  reaches them (the ring and state rewind's path);
* preemption to host and by recompute equal to the uninterrupted run;
* the refusals: paged on an attention-free stack (the reference's
  ``ValueError``), a mixed stack's paged cache without slots for its
  rings and states (``ValueError``; the per-kind layout itself is held in
  ``tests/test_torch_mixed.py``), tree speculation and a draft model of a
  hybrid stack (``ValueError``), ``k + 1`` past the window.
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
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.serving import admission as jadmission
from repro.serving import quantize as jquantize
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.core import perfmodel, scheduler
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, lm, rglru, xlstm
from repro_torch.serving import admission, quantize, speculative
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv_cache import PagedCacheManager
from repro_torch.serving.lifecycle import DECODE
from torch_helpers import ForcedDrafts

ARCHS = ("recurrentgemma-9b", "xlstm-350m", "mixed")
WINDOW_CAPPED = ("recurrentgemma-9b", "xlstm-350m")
MAX_SEQ, SLOTS, CHUNK, MAX_NEW, PS = 64, 2, 8, 8, 8
ATOL = RTOL = 1e-4
CELL_ATOL = CELL_RTOL = 1e-5
#: calibration stats: four bf16 ulps (each at most 2^-7 relative)
STATS_RTOL = 2 ** -5
#: bf16 streams part only at near-ties: the two sides' logits along the
#: shared history within this share of their range, each side's margin
#: of its own token over the other's within twice their difference
NEAR_TIE_REL = 0.1


def _configs(arch):
    if arch != "mixed":
        return jget_config(arch).reduced(), get_config(arch).reduced()
    return tuple(dataclasses.replace(
        c, name="hybrid-mixed-reduced",
        block_pattern=("attn", "local_attn", "rglru"))
        for c in (jget_config("recurrentgemma-9b").reduced(),
                  get_config("recurrentgemma-9b").reduced()))


class Family:
    """One stack's reference and port objects, each made on first use."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg, self.cfg = _configs(arch)
        self.jparams = jlm.init(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = bridge.params_from_numpy(jax.device_get(self.jparams))

    @functools.cached_property
    def calib(self):
        return np.random.default_rng(4).integers(1, self.cfg.vocab_size,
                                                 (2, 16))

    @functools.cached_property
    def jstats(self):
        return jquantize.calibrate(self.jparams, self.jcfg,
                                   [jnp.asarray(self.calib)])

    @functools.cached_property
    def jq(self):
        return jquantize.quantize_model_params(self.jparams, self.jcfg,
                                               self.jstats)

    @functools.cached_property
    def tq(self):
        return bridge.params_from_numpy(jax.device_get(self.jq))

    @functools.cached_property
    def prompts(self):
        """Prompts that repeat short runs (the n-gram proposer drafts),
        each with its own first token, two crossing the window (32) and,
        on a window-capped stack, one the cache (64)."""
        rng = np.random.default_rng(3)
        firsts = rng.permutation(np.arange(1, self.cfg.vocab_size))
        lens = (6, 41, 11, 70 if self.arch in WINDOW_CAPPED else 37)
        out = []
        for first, n in zip(firsts, lens):
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
    def plain_stream(self):
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, atol=CELL_ATOL, rtol=CELL_RTOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the recurrent cells and the rotating chunk attention alone

_CELLS = {
    "rglru": (jrglru.rglru_init, jrglru.rglru_init_state, jrglru, rglru,
              "recurrentgemma-9b"),
    "mlstm": (jxlstm.mlstm_init, jxlstm.mlstm_init_state, jxlstm, xlstm,
              "xlstm-350m"),
    "slstm": (jxlstm.slstm_init, jxlstm.slstm_init_state, jxlstm, xlstm,
              "xlstm-350m"),
}


def _cell_setup(kind):
    jinit, jstate, jmod, tmod, arch = _CELLS[kind]
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jinit(jax.random.PRNGKey(1), jcfg)
    tp = bridge._map(jax.device_get(jp), bridge.to_tensor)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    # a state some tokens in: the reference's sequence path from zero
    warm = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    _, st = getattr(jmod, f"{kind}_seq")(jp, jnp.asarray(warm), jcfg)
    return jcfg, cfg, jp, tp, x, st, jmod, tmod


@pytest.mark.parametrize("path", ["seq", "chunk", "step"])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_recurrent_cells_match_reference(kind, path):
    """Outputs and states of each path within 1e-5 (float32), the
    chunk's whole trajectory and the step's state included."""
    jcfg, cfg, jp, tp, x, st, jmod, tmod = _cell_setup(kind)
    tst = {k: _t(v) for k, v in jax.device_get(st).items()}
    if path == "seq":
        jo, js = getattr(jmod, f"{kind}_seq")(jp, jnp.asarray(x), jcfg)
        to, ts = getattr(tmod, f"{kind}_seq")(tp, torch.from_numpy(x), cfg)
    elif path == "chunk":
        jo, js = getattr(jmod, f"{kind}_chunk")(jp, jnp.asarray(x), st, jcfg)
        to, ts = getattr(tmod, f"{kind}_chunk")(tp, torch.from_numpy(x),
                                                tst, cfg)
    else:
        jo, js = getattr(jmod, f"{kind}_step")(jp, jnp.asarray(x[:, :1]), st,
                                               jcfg)
        to, ts = getattr(tmod, f"{kind}_step")(tp, torch.from_numpy(x[:, :1]),
                                               tst, cfg)
    assert to.shape == tuple(jo.shape) and to.dtype == torch.float32
    _close(to, jo, what="out")
    assert ts.keys() == dict(js).keys()
    for k in ts:
        assert ts[k].shape == tuple(js[k].shape), k
        _close(ts[k], js[k], what=k)


def test_rglru_associative_scan_matches_reference_bitwise():
    """The port's scan combines the pairs ``jax.lax.associative_scan``
    combines: on the same float32 inputs the outputs are bit-identical,
    at odd and even lengths."""
    rng = np.random.default_rng(5)
    for S in (1, 2, 7, 16, 33):
        a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
        b = rng.standard_normal((2, S, 8)).astype(np.float32)

        def combine(left, right):
            return left[0] * right[0], right[0] * left[1] + right[1]

        ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1)
        ta, tb = rglru.associative_scan(torch.from_numpy(a),
                                        torch.from_numpy(b))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_chunk_trajectory_equals_steps(kind):
    """In the port, a chunk's state after token t equals the state of t +
    1 decode steps from the same entering state, and its outputs the
    steps' (within 1e-5: the chunk's products have more rows)."""
    jcfg, cfg, jp, tp, x, st, jmod, tmod = _cell_setup(kind)
    state = {k: _t(v) for k, v in jax.device_get(st).items()}
    out, traj = getattr(tmod, f"{kind}_chunk")(tp, torch.from_numpy(x),
                                               state, cfg)
    for t in range(x.shape[1]):
        o, state = getattr(tmod, f"{kind}_step")(
            tp, torch.from_numpy(x[:, t:t + 1]), state, cfg)
        _close(o[:, 0], out[:, t], what=f"out {t}")
        for k, v in state.items():
            _close(v, traj[k][:, t], what=f"{k} {t}")


@pytest.mark.parametrize("case", ["crossing", "wider-than-window"])
def test_chunk_attention_rotating_matches_reference(case):
    """A chunk over a ring: row 0 crosses the window, row 1 is padded
    (``limits`` inside the chunk), row 2 is parked (``limits`` at the
    chunk start), row 3 starts at position 0.  Outputs within 1e-5 on the
    rows that write; the ring after the call within 1e-5, and where no
    write lands bit-identical to before.  ``wider-than-window``: window 8
    and a chunk of 13, so positions of one row share ring slots."""
    jcfg, cfg = _configs("recurrentgemma-9b")
    C = 13 if case == "wider-than-window" else 6
    if case == "wider-than-window":
        jcfg = dataclasses.replace(jcfg, window=8)
        cfg = dataclasses.replace(cfg, window=8)
    W = cfg.window
    jp = jattention.attn_init(jax.random.PRNGKey(2), jcfg)
    tp = bridge._map(jax.device_get(jp), bridge.to_tensor)
    rng = np.random.default_rng(1)
    B = 4
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    ring = rng.standard_normal((2, B, cfg.n_kv_heads, W, cfg.head_dim)
                               ).astype(np.float32)
    starts = np.array([W - 3, 2 * W + 1, 40, 0])
    positions = (starts[:, None] + np.arange(C)[None]).astype(np.int32)
    limits = np.array([starts[0] + C, starts[1] + C - 2, starts[2], C - 1],
                      np.int32)
    jo, jk, jv = jattention.chunk_attention_rotating(
        jp, jnp.asarray(x), jcfg, jnp.asarray(ring[0]), jnp.asarray(ring[1]),
        jnp.asarray(positions), jnp.asarray(limits))
    tk, tv = torch.from_numpy(ring[0].copy()), torch.from_numpy(
        ring[1].copy())
    to, tk2, tv2 = attention.chunk_attention_rotating(
        tp, torch.from_numpy(x), cfg, tk, tv, torch.from_numpy(positions),
        torch.from_numpy(limits))
    assert tk2 is tk and tv2 is tv  # in place
    for b in (0, 1, 3):
        _close(to[b], jo[b], what=f"out row {b}")
    for got, want, before in ((tk, jk, ring[0]), (tv, jv, ring[1])):
        _close(got, want, what="ring")
        same = np.asarray(want) == before
        np.testing.assert_array_equal(got.numpy()[same], before[same])
    np.testing.assert_array_equal(tk.numpy()[2], ring[0][2])  # parked


# ---------------------------------------------------------------------------
# configs, bridge, host-side planning


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", WINDOW_CAPPED)
def test_config_copy_matches_reference(arch, reduced):
    j, t = jget_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    got = dataclasses.asdict(t)
    # the port's own fields, at the defaults that keep JAX's arithmetic
    assert got.pop("expert_dtype") == "" and got.pop("norm_topk_prob") is True
    assert got == dataclasses.asdict(j)
    assert arch in list_archs()
    lm.check_supported(t)
    assert blocks.window_capped(t) and not blocks.paged_capable(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_layouts(family, arch):
    """The reference's stacked ``periods`` (and, at full width, ``rest``)
    unstack to one dict per layer; ``lm.init`` draws the same tree; the
    full ``recurrentgemma-9b`` is 12 periods of 3 and 2 ``rest`` layers,
    which the bridge puts in layer order."""
    f = family(arch)
    assert len(f.tparams["layers"]) == f.cfg.n_layers
    for li, layer in enumerate(f.tparams["layers"]):
        kind = f.cfg.block_kind(li)
        assert (kind if kind in blocks.RECURRENT_KINDS else "attn") in layer
    mine = lm.init(f.cfg, torch.Generator().manual_seed(0))
    assert [(p, a.shape, a.dtype) for p, a in _leaves(mine)] == \
        [(p, a.shape, a.dtype) for p, a in _leaves(f.tparams)]
    full = jget_config("recurrentgemma-9b")
    n_per, n_rest = jlm._layer_counts(full)
    assert (n_per, n_rest) == (12, 2)
    # a tree of the full layout's structure, each leaf naming its layer
    periods = tuple({"w": np.arange(n_per) * 3 + i} for i in range(3))
    rest = [{"w": np.array(36 + j)} for j in range(n_rest)]
    got = bridge.params_from_numpy({"periods": periods, "rest": rest})
    assert [int(layer["w"]) for layer in got["layers"]] == list(range(38))


@pytest.mark.parametrize("arch", ARCHS)
def test_planning_matches_reference(family, arch):
    """The stage program (the recurrent kinds' stages, ``local_attn``'s
    MHA stage), the FPGA model's figures, the admission budget and slot
    prices, and the engine's request ceiling: lifted on the window-capped
    stacks, ``max_seq`` on the mixed one; full configs included.  The
    auto layout as the reference's: the mixed stack pages, the others
    serve stacked."""
    f = family(arch)
    pairs = [(f.jcfg, f.cfg)]
    if arch != "mixed":
        pairs.append((jget_config(arch), get_config(arch)))
    for j, t in pairs:
        prog = scheduler.model_program(t)
        assert [dataclasses.astuple(s) for s in prog] \
            == [dataclasses.astuple(s) for s in jscheduler.model_program(j)]
        ts, js = scheduler.mdk_stats(t), jscheduler.mdk_stats(j)
        assert ts.activations == js.activations
        assert ts.reuse_factor() == js.reuse_factor()
        for ctx in (777, 5000):
            assert perfmodel.FPGAPerfModel(t).token_latency(ctx) == \
                jperfmodel.FPGAPerfModel(j).token_latency(ctx)
        assert perfmodel.FPGAPerfModel(t).prefill_token_latency() == \
            jperfmodel.FPGAPerfModel(j).prefill_token_latency()
        ja = jadmission.FIFOAdmission(j, chunk_size=32)
        ta = admission.FIFOAdmission(t, chunk_size=32)
        assert ta.budget_tokens == ja.budget_tokens
        for plen, new in ((3, 5), (20, 40), (500, 600), (3000, 100)):
            for max_seq in (64, 1024, 4097):
                assert ta.slot_price(t, plen, new, max_seq=max_seq) == \
                    ja.slot_price(j, plen, new, max_seq=max_seq)
    je = JServeEngine(f.jcfg, f.jparams, **_COMMON)
    te = ServeEngine(f.cfg, f.tparams, device="cpu", **_COMMON)
    want = None if arch in WINDOW_CAPPED else MAX_SEQ
    assert te.seq_ceiling == je.seq_ceiling == want
    assert te.kv_layout == je.kv_layout == (
        "stacked" if arch in WINDOW_CAPPED else "paged")
    assert te.kv_layout == "paged" or not te.kv.bounded


# ---------------------------------------------------------------------------
# the model, float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(family, arch):
    f = family(arch)
    tokens = np.random.default_rng(0).integers(1, f.cfg.vocab_size, (2, 45))
    want = jlm.forward(f.jparams, f.jcfg, jnp.asarray(tokens),
                       dtype=jnp.float32, moe_cf=None)[0]
    got = lm.forward(f.tparams, f.cfg, torch.from_numpy(tokens),
                     dtype=torch.float32)
    assert got.shape == (2, 45, f.cfg.vocab_size)
    _close(got, want, ATOL, RTOL)


def _jax_slot_prefill(f, jc, prompt, slot, chunk):
    for off in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - off)
        toks = np.zeros(chunk, np.int32)
        toks[:n] = prompt[off:off + n]
        lj, jc = jlm.prefill_into_slot(
            f.jparams, f.jcfg, jnp.asarray(toks), jc, slot, off, valid=n,
            dtype=jnp.float32)
        yield np.asarray(lj), jc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(family, arch):
    """Chunked prefill of a window-crossing prompt (chunks of 16 over a
    ring of 32: the ring wraps inside the prefill, the last chunk is
    padded) into slot 0 of float32 stacked caches, a short prompt into
    slot 1, then decode steps with slot 2 idle: logits within 1e-4, every
    layer's cache within 1e-5 after each call, and slot 2's rings and
    states bit-identical to their entering content (random, not zero)."""
    f = family(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, f.cfg.vocab_size, n).tolist() for n in (45, 9)]
    B, C = 3, 16
    jc = jlm.init_cache(f.jcfg, B, MAX_SEQ, dtype=jnp.float32)
    tc = lm.init_cache(f.cfg, B, MAX_SEQ, layout="stacked",
                       dtype=torch.float32)
    for layer in tc["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    n_per = 1
    jc = jax.tree_util.tree_map(jnp.asarray, bridge.cache_to_numpy(
        tc, n_per=n_per, period=f.cfg.n_layers))
    jc = dict(jc, periods=tuple(jc["periods"]))
    idle = [{k: t[2].clone() for k, t in layer.items()}
            for layer in tc["layers"]]

    def same_cache():
        back = bridge.cache_to_numpy(tc, n_per=n_per, period=f.cfg.n_layers)
        for (p, a), (_, b) in zip(_leaves(jax.device_get(jc)),
                                  _leaves(back)):
            _close(b, a, what=p)

    for b, prompt in enumerate(prompts):
        gen = _jax_slot_prefill(f, jc, prompt, b, C)
        for off in range(0, len(prompt), C):
            n = min(C, len(prompt) - off)
            toks = torch.zeros(C, dtype=torch.int64)
            toks[:n] = torch.tensor(prompt[off:off + n])
            lt, tc = lm.prefill_into_slot(
                f.tparams, f.cfg, toks, tc, off, slot=b, valid=n,
                dtype=torch.float32)
            lj, jc = next(gen)
            _close(lt, lj, ATOL, RTOL)
            same_cache()
    lengths = np.array([len(p) for p in prompts] + [7], np.int32)
    active = np.array([True, True, False])
    tok = np.array([[p[-1]] for p in prompts] + [[3]], np.int32)
    for _ in range(4):
        lj, jc = jlm.decode_step(
            f.jparams, f.jcfg, jnp.asarray(tok), jc, jnp.asarray(lengths),
            active=jnp.asarray(active), dtype=jnp.float32)
        lt, tc = lm.decode_step(
            f.tparams, f.cfg, torch.from_numpy(tok), tc,
            torch.from_numpy(lengths), active=torch.from_numpy(active),
            dtype=torch.float32)
        _close(lt[:2], np.asarray(lj)[:2], ATOL, RTOL)
        same_cache()
        tok = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + active
    for li, (layer, before) in enumerate(zip(tc["layers"], idle)):
        if f.cfg.block_kind(li) == "attn":
            continue  # its write at the idle length stays masked
        for k, t in layer.items():
            assert torch.equal(t[2], before[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_and_commit_match_reference(family, arch):
    """A chain verify of 5 over float32 stacked caches (row 0 crossing
    the window, row 1 short, row 2 parked at ``max_seq`` with ``valids``
    0), then the commit of 3, 1 and 0 tokens: logits within 1e-4 and the
    committed rings and states within 1e-5 of the reference's
    ``verify_chunk(with_traj=True)`` and ``commit_verify``; the
    snapshot holds five ring slots per row, not the ring."""
    f = family(arch)
    rng = np.random.default_rng(6)
    B, C = 3, 5
    tc = lm.init_cache(f.cfg, B, MAX_SEQ, layout="stacked",
                       dtype=torch.float32)
    for layer in tc["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    jc = bridge.cache_to_numpy(tc, n_per=1, period=f.cfg.n_layers)
    jc = jax.tree_util.tree_map(jnp.asarray, dict(jc, periods=tuple(
        jc["periods"])))
    toks = rng.integers(1, f.cfg.vocab_size, (B, C))
    lengths = np.array([30, 9, MAX_SEQ], np.int32)
    valids = np.array([5, 4, 0], np.int32)
    counts = np.array([3, 1, 0], np.int32)
    jl, jnew, jtraj = jlm.verify_chunk(
        f.jparams, f.jcfg, jnp.asarray(toks), jc, jnp.asarray(lengths),
        valids=jnp.asarray(valids), with_traj=True, dtype=jnp.float32)
    jcommit = jlm.commit_verify(f.jcfg, jc, jnew, jtraj, lengths, counts,
                                valids, chunk=C)
    lt_len = torch.from_numpy(lengths)
    snap = lm.verify_snapshot(f.cfg, tc, lt_len, chunk=C)
    for li, s in snap.items():
        assert f.cfg.block_kind(li) == "local_attn"
        assert s["k"].shape == (B, C, f.cfg.n_kv_heads, f.cfg.head_dim)
    lt, tc, ttraj = lm.verify_chunk(
        f.tparams, f.cfg, torch.from_numpy(toks), tc, lt_len,
        valids=torch.from_numpy(valids), with_traj=True,
        dtype=torch.float32)
    _close(lt[:2], np.asarray(jl)[:2], ATOL, RTOL)
    tc = lm.commit_verify(f.cfg, snap, tc, ttraj, lt_len,
                          torch.from_numpy(counts),
                          torch.from_numpy(valids), chunk=C)
    back = bridge.cache_to_numpy(tc, n_per=1, period=f.cfg.n_layers)
    for (p, a), (_, b) in zip(_leaves(jax.device_get(jcommit)),
                              _leaves(back)):
        _close(b, a, what=p)


# ---------------------------------------------------------------------------
# W8A8


_FLOAT_KEYS = ("w_r", "w_i", "gates", "rec", "conv", "lam")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_model_params_bitexact_given_reference_stats(family, arch):
    """The reference's stats quantize every MP linear (``in_proj``,
    ``out_proj``, q/k/v/out, the GeGLU MLP, mLSTM's ``qkv``/``o_gate``/
    ``out``) to bit-identical ``w_q``, ``w_scale`` and ``smooth``; the
    gate projections, sLSTM's ``rec``, the conv and ``lam`` stay the
    float tensors they were."""
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
    kept = [p for p in got if any(f"/{k}" in p for k in _FLOAT_KEYS)]
    assert kept
    for path in kept:
        assert torch.equal(got[path], before[path]), path
    assert any(p.endswith("/w_q") for p in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_stats_match_reference(family, arch):
    """The port's bf16 calibration forward records the reference's stats:
    the same names (mLSTM's ``qkv`` and ``gates`` under their fixed names,
    the RG-LRU gates' under ""), bit-identical at layer 0's first linear
    input, within ``STATS_RTOL`` elsewhere."""
    f = family(arch)
    tstats = quantize.calibrate(f.tparams, f.cfg, [f.calib])
    want = {(k.replace("p", "l", 1) if k.startswith("p") else k):
            np.asarray(v) for k, v in f.jstats.items()}
    assert tstats.keys() == want.keys()
    first = {"recurrentgemma-9b": "l0.rglru.in", "xlstm-350m": "mlstm.qkv",
             "mixed": "l0.attn.q"}[arch]
    if arch != "xlstm-350m":  # mlstm.qkv is every mLSTM layer's maximum
        np.testing.assert_array_equal(tstats[first].numpy(), want[first])
    for name, v in tstats.items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=STATS_RTOL,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_streams_match_jax_stacked_engine(family, arch):
    """Greedy W8A8 streams (the reference-quantized weights, float32
    activations, bf16 rings and tails) of the port's stacked engine equal
    the JAX stacked engine's, token for token."""
    f = family(arch)
    assert f.plain_stream == f.jax_stream
    assert all(len(o) == MAX_NEW for o in f.plain_stream.values())


def _bf16_logits(f, prompt, history, jax_side):
    """Next-token logits after ``prompt`` and ``history`` fed back, bf16,
    through the engine's calls and shapes (prefill chunks of ``CHUNK`` into
    slot 0, then decode steps with slot 1 idle), on either side."""
    B = SLOTS
    lengths = np.zeros(B, np.int32)
    active = np.zeros(B, bool)
    active[0] = True
    if jax_side:
        c = jlm.init_cache(f.jcfg, B, MAX_SEQ)
        pre = jax.jit(lambda p, t, c, o, v: jlm.prefill_into_slot(
            p, f.jcfg, t, c, 0, o, valid=v))
        step = jax.jit(lambda p, t, c, n, a: jlm.decode_step(
            p, f.jcfg, t, c, n, active=a))
    else:
        c = lm.init_cache(f.cfg, B, MAX_SEQ, layout="stacked")
    for off in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - off)
        toks = np.zeros(CHUNK, np.int64)
        toks[:n] = prompt[off:off + n]
        if jax_side:
            lg, c = pre(f.jparams, jnp.asarray(toks, jnp.int32), c, off, n)
        else:
            lg, c = lm.prefill_into_slot(f.tparams, f.cfg,
                                         torch.from_numpy(toks), c, off,
                                         slot=0, valid=n)
    for i, t in enumerate(history):
        tok = np.zeros((B, 1), np.int64)
        tok[0, 0] = t
        lengths[0] = len(prompt) + i
        if jax_side:
            lg, c = step(f.jparams, jnp.asarray(tok, jnp.int32), c,
                         jnp.asarray(lengths), jnp.asarray(active))
        else:
            lg, c = lm.decode_step(f.tparams, f.cfg, torch.from_numpy(tok),
                                   c, torch.from_numpy(lengths),
                                   active=torch.from_numpy(active))
        lg = lg[0]
    return _np(lg)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_streams_match_jax_stacked_engine(family, arch):
    """The unquantized engines (bf16 activations and caches): streams
    equal to the JAX stacked engine's up to where they part, each parting
    a near-tie (``NEAR_TIE_REL``), and most tokens equal."""
    f = family(arch)
    jeng = JServeEngine(f.jcfg, f.jparams, kv_layout="stacked", **_COMMON)
    eng = ServeEngine(f.cfg, f.tparams, device="cpu", **_COMMON)
    assert eng.act_dtype == torch.bfloat16
    got, want = _serve(eng, f.prompts), _serve(jeng, f.prompts)
    assert got.keys() == want.keys()
    same = 0
    for rid, a in got.items():
        b = want[rid]
        assert len(a) == len(b) == MAX_NEW
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        same += MAX_NEW if i is None else i
        if i is None:
            continue
        la = _bf16_logits(f, f.prompts[rid], b[:i], False)
        lb = _bf16_logits(f, f.prompts[rid], b[:i], True)
        err = np.abs(la - lb).max()
        assert err <= NEAR_TIE_REL * (lb.max() - lb.min()), (rid, i, err)
        assert max(la[a[i]] - la[b[i]], lb[b[i]] - lb[a[i]]) <= 2 * err
    assert same >= 0.75 * MAX_NEW * len(got)


@pytest.mark.parametrize("proposer", ["ngram", "forced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chain_spec_equals_plain(family, arch, proposer):
    """Chain speculation (k 4) gives the plain engine's greedy streams,
    with the n-gram proposer and with forced drafts (accepted and
    rejected: rejected ring writes were restored and states rewound);
    every slot drains."""
    f = family(arch)
    eng = f.engine(spec=speculative.SpecConfig(k=4))
    if proposer == "forced":
        eng.proposer = ForcedDrafts(4, f.plain_stream, f.cfg.vocab_size)
    assert _serve(eng, f.prompts) == f.plain_stream
    s = eng.stats()
    assert s["pages_in_use" if eng.paged else "slots_in_use"] == 0
    if proposer == "forced":
        assert 0 < s["spec_accepted"] < s["spec_proposed"]


@pytest.mark.parametrize("mode", ["host", "recompute"])
@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_equals_uninterrupted(family, arch, mode):
    """The first decoding request with output is preempted once: a host
    restore scatters its rings and states back, a recompute prefills
    ``prompt + out[:-1]`` from a fresh state; both resume to the
    uninterrupted stream."""
    f = family(arch)
    eng = f.engine()
    for p in f.prompts:
        eng.submit(p, max_new=MAX_NEW)
    for _ in range(40):
        eng.tick()
        victims = [r for r in eng.slots
                   if r is not None and r.state == DECODE and r.out]
        if victims:
            eng._preempt(victims[0], mode)
            break
    assert eng.preemptions == 1
    assert {r.rid: r.out for r in eng.run()} == f.plain_stream
    s = eng.stats()
    assert s["restores"] == 1 and s[f"preempt_{mode}"] == 1
    assert (s["evicted_bytes_total"] > 0) == (mode == "host")


@pytest.mark.parametrize("arch", ARCHS)
def test_requests_past_max_seq(family, arch):
    """A window-capped stack takes a prompt longer than ``max_seq`` and
    generates past it (the reference's engine the same tokens); the mixed
    stack keeps the ceiling (on the paged layout) and refuses it."""
    f = family(arch)
    prompt = np.random.default_rng(8).integers(
        1, f.cfg.vocab_size, MAX_SEQ + 9).tolist()
    eng = f.engine()
    if arch not in WINDOW_CAPPED:
        with pytest.raises(ValueError, match="fit the cache"):
            eng.submit(prompt, max_new=4)
        assert eng.paged and eng.seq_ceiling == MAX_SEQ
        return
    got = _serve(eng, [prompt])
    assert len(got[0]) == MAX_NEW and eng.kv.length_of(0) == 0
    jeng = JServeEngine(f.jcfg, f.jq, kv_layout="stacked",
                        act_dtype=jnp.float32, **_COMMON)
    assert got == _serve(jeng, [prompt])


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(family, arch):
    """The paged layout: attention-free stacks get the reference's
    ``ValueError`` naming the layers; the mixed stack pages its ``attn``
    layer, and its cache without ``slots`` for the rings and states is the
    reference's ``ValueError``.  Tree speculation and a hybrid draft
    model: ``ValueError``; and ``k + 1`` past a ring's window."""
    f = family(arch)
    if arch in WINDOW_CAPPED:
        with pytest.raises(ValueError, match="global-attention"):
            lm.init_cache(f.cfg, 3, PS, layout="paged")
        with pytest.raises(ValueError, match="global-attention"):
            PagedCacheManager(f.cfg, 2, MAX_SEQ)
        with pytest.raises(ValueError, match="global-attention"):
            f.engine(kv_layout="paged")
    else:
        with pytest.raises(ValueError, match="slots= and slot_seq="):
            lm.init_cache(f.cfg, 3, PS, layout="paged")
        kv = PagedCacheManager(f.cfg, 2, MAX_SEQ)
        assert kv.state is not None
        assert kv.cache["layers"][1]["k"].shape[0] == 2  # a ring per slot
        assert f.engine(kv_layout="paged").paged
    with pytest.raises(ValueError, match="tree speculation"):
        f.engine(spec=speculative.SpecConfig(k=2, tree=True))
    with pytest.raises(ValueError, match="global-attention draft"):
        speculative.ModelDraft(f.cfg, f.tparams, 2, MAX_SEQ, 3)
    if "local_attn" in f.cfg.block_pattern:
        with pytest.raises(ValueError, match="rotating window"):
            f.engine(spec=speculative.SpecConfig(k=f.cfg.window))
    with pytest.raises(ValueError, match="tree ancestor"):
        kind = f.cfg.block_kind(1)
        blocks.block_apply_chunk(
            f.tparams["layers"][1], torch.zeros(1, 2, f.cfg.d_model),
            lm.init_cache(f.cfg, 1, MAX_SEQ, layout="stacked")["layers"][1],
            f.cfg, kind, positions=torch.zeros(1, 2, dtype=torch.long),
            anc=torch.ones(1, 2, 2, dtype=torch.int32))


@pytest.mark.parametrize("arch", WINDOW_CAPPED)
def test_serve_launcher_on_the_cpu(arch, capsys):
    """``launch/serve.py --arch ... --reduced --device cpu`` serves the
    stack on the stacked layout (its slot pool's stats), with chain
    speculation."""
    stats = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "4", "--max-seq",
                        "64", "--spec", "ngram"])
    assert stats["slots_in_use"] == 0 and "pages_in_use" not in stats
    assert "spec_ticks" in stats
    out = capsys.readouterr().out
    assert f"{arch}-reduced on cpu: 3 requests, 12 tokens" in out
