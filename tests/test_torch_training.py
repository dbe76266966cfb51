"""The port's training path against the JAX package, on the reduced
configs, with the weights carried across by the bridge and batches from
the two packages' ``SyntheticLM`` (bit-equal, checked first).

Held against the reference on the same params and batch:

* ``lm.loss_fn`` and every gradient leaf of ``gpt2-345m``,
  ``tinyllama-1.1b``, ``olmoe-1b-7b`` (capacity factor 1.25, with choices
  shown to drop), ``recurrentgemma-9b``, ``xlstm-350m``,
  ``whisper-large-v3`` (frames) and ``pixtral-12b`` (patches).  At
  float32 (each package's forward patched to float32 inside the test):
  the loss within ``1e-5`` relative, the aux loss within ``1e-6``, each
  leaf's gradient within ``1e-4`` of its norm (the readings: 1e-7 on the
  loss, at most 6e-6 on a leaf).  At the bf16 default the two
  frameworks round each product and elementwise step apart: the loss
  within ``1e-3`` relative and each leaf within ``5e-2`` of its norm
  (readings: 7e-5 and 2.7e-2, the worst leaf printed).  For the MoE stack
  at bf16 those roundings flip a few of the 32 tokens' expert choices,
  which moves its aux loss by 1% and its gradients by up to a third: the
  loss within ``1e-2``, the aux within ``2e-2``, each leaf within ``0.5``.
* ``remat=True`` equals ``remat=False`` bit for bit.
* AdamW: ``schedule`` within ``2e-6`` relative at every step (XLA folds
  the divisions into products by reciprocals and its cosine differs by
  ulps; up to 8 float32 ulps read); three ``apply_updates`` (clipping
  off and on) give params, ``m`` and ``v`` within ``1e-6`` of each
  leaf's largest magnitude; ``_compress_decompress`` on trees shaped
  like the params, one int8 scale per reference leaf (which stacks the
  layers of a pattern position): the gradient within two float32 ulps
  (XLA may take ``amax / 127`` as a product by the reciprocal) and the
  residual within ``1e-8``.
* Three ``make_train_step`` steps at float32 (microbatches 1 and 4, and
  int8-compressed gradients) against the reference's jitted step: the
  losses within ``1e-5`` relative, params within ``5e-5`` and the moments
  within ``1e-4`` of each leaf's largest magnitude (readings: 1.2e-5 and
  4e-6; Adam's ``1 / sqrt(v)`` amplifies the gradients' last-place
  differences).
* Copies of ``tests/test_training.py`` for the port's ``Trainer``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tree import (leaves_with_paths, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.data import pipeline
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import lm, moe
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer
from repro_torch.training.trainer import (TrainConfig, Trainer,
                                          init_train_state, make_train_step)

ARCHS = ("gpt2-345m", "tinyllama-1.1b", "olmoe-1b-7b", "recurrentgemma-9b",
         "xlstm-350m", "whisper-large-v3", "pixtral-12b")
MAX_SEQ = 64
F32_LOSS_RTOL, F32_AUX_ATOL, F32_LEAF_TOL = 1e-5, 1e-6, 1e-4
BF16_LOSS_RTOL, BF16_LEAF_TOL = 1e-3, 5e-2
MOE_BF16_LOSS_RTOL, MOE_BF16_AUX_RTOL, MOE_BF16_LEAF_TOL = 1e-2, 2e-2, 0.5
SCHED_RTOL, ADAMW_TOL, DEQ_RTOL, EF_ATOL = 2e-6, 1e-6, 2 ** -22, 1e-8
STEP_LOSS_RTOL, STEP_PARAM_TOL, STEP_MOMENT_TOL = 1e-5, 5e-5, 1e-4


def _data(mod, cfg, seq, batch, seed=1, **kw):
    return mod.SyntheticLM(
        cfg.vocab_size, seq, batch, seed=seed,
        with_frames=cfg.is_encoder_decoder,
        frame_len=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        d_model=cfg.d_model, with_patches=cfg.frontend == "vision_patches",
        patch_tokens=cfg.frontend_tokens, **kw)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jcfg, cfg, JAX params (stacked layout), numpy batch)."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    batch = _data(jpipeline, cfg, 16, 2).batch_at(0)
    return jcfg, cfg, jparams, batch


@pytest.fixture
def f32_forwards(monkeypatch):
    """Both packages' losses run their forwards in float32."""
    monkeypatch.setattr(jlm, "forward",
                        functools.partial(jlm.forward, dtype=jnp.float32))
    monkeypatch.setattr(lm, "_forward",
                        functools.partial(lm._forward, dtype=torch.float32))


def _port_loss_and_grads(params, cfg, batch, **kw):
    paths, leaves = leaves_with_paths(params)
    live_leaves = [p.detach().requires_grad_() for p in leaves]
    live = tree_unflatten(params, live_leaves)
    loss, metrics = lm.loss_fn(live, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, live_leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            paths, grads)


def _leaf_errors(paths, got, want_tree):
    """Each leaf's error norm over the reference leaf's norm."""
    _, want = leaves_with_paths(want_tree)
    return {p: float((g - w).norm() / w.norm().clamp_min(1e-30))
            for p, g, w in zip(paths, got, want)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("host", [0, 1])
def test_pipeline_batches_bit_equal_to_reference(step, host):
    for arch in ("gpt2-345m", "whisper-large-v3", "pixtral-12b"):
        cfg = get_config(arch).reduced()
        kw = dict(host_index=host, host_count=2)
        want = _data(jpipeline, cfg, 16, 8, seed=3, **kw).batch_at(step)
        got = _data(pipeline, cfg, 16, 8, seed=3, **kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_determinism_and_sharding():
    a = SyntheticLM(128, 16, 8, seed=1, host_index=0, host_count=2)
    b = SyntheticLM(128, 16, 8, seed=1, host_index=1, host_count=2)
    a0, a0b = a.batch_at(0), a.batch_at(0)
    np.testing.assert_array_equal(a0["tokens"], a0b["tokens"])
    assert a.batch_at(0)["tokens"].shape == (4, 16)  # global 8 / 2 hosts
    assert not np.array_equal(a0["tokens"], b.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(128, 16, 7, host_count=2)


def test_prefetcher_preserves_order():
    src = ({"i": np.asarray([i])} for i in range(10))
    out = [b["i"][0] for _, b in zip(range(10), Prefetcher(src))]
    assert out == list(range(10))


# ---------------------------------------------------------------------------
# loss and gradients against the reference


def _reference_loss_and_grads(jcfg, jparams, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(jparams, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        bridge.params_from_numpy(jax.device_get(grads))


def _drops(monkeypatch):
    """Record how many MoE choices drop (rank past capacity)."""
    seen = []
    orig = moe.slots_of

    def slots_of(experts, n_experts, C):
        out = orig(experts, n_experts, C)
        seen.append(int((out == C).sum()))
        return out

    monkeypatch.setattr(moe, "slots_of", slots_of)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch, f32_forwards,
                                            monkeypatch):
    jcfg, cfg, jparams, batch = _model(arch)
    jloss, jm, jgrads = _reference_loss_and_grads(jcfg, jparams, batch)
    drops = _drops(monkeypatch)
    params = bridge.params_from_numpy(jax.device_get(jparams))
    loss, metrics, paths, grads = _port_loss_and_grads(
        params, cfg, _torch_batch(batch))
    assert abs(float(loss) - jloss) <= F32_LOSS_RTOL * abs(jloss)
    assert abs(float(metrics["aux"]) - jm["aux"]) <= F32_AUX_ATOL
    if cfg.n_experts:
        assert jm["aux"] > 0 and sum(drops) > 0, drops  # cf 1.25 drops
    errs = _leaf_errors(paths, grads, jgrads)
    worst = max(errs, key=errs.get)
    print(f"{arch} f32: loss {float(loss)} vs {jloss}; worst leaf {worst} "
          f"{errs[worst]:.2e}")
    assert errs[worst] <= F32_LEAF_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    jcfg, cfg, jparams, batch = _model(arch)
    jloss, jm, jgrads = _reference_loss_and_grads(jcfg, jparams, batch)
    params = bridge.params_from_numpy(jax.device_get(jparams))
    loss, metrics, paths, grads = _port_loss_and_grads(
        params, cfg, _torch_batch(batch))
    errs = _leaf_errors(paths, grads, jgrads)
    worst = max(errs, key=errs.get)
    print(f"{arch} bf16: loss {float(loss)} vs {jloss}; worst leaf {worst} "
          f"{errs[worst]:.2e}")
    loss_rtol, leaf_tol = ((MOE_BF16_LOSS_RTOL, MOE_BF16_LEAF_TOL)
                           if cfg.n_experts else
                           (BF16_LOSS_RTOL, BF16_LEAF_TOL))
    assert abs(float(loss) - jloss) <= loss_rtol * abs(jloss)
    if cfg.n_experts:
        assert abs(float(metrics["aux"]) - jm["aux"]) <= \
            MOE_BF16_AUX_RTOL * jm["aux"]
    assert errs[worst] <= leaf_tol, (worst, errs[worst])


@pytest.mark.parametrize("arch", ["gpt2-345m", "whisper-large-v3"])
def test_init_abstract_matches_init(arch):
    """Meta tensors of ``lm.init``'s paths, shapes and dtypes, as many
    elements as the reference's ``init_abstract``; and the abstract train
    state a checkpoint restores into."""
    jcfg, cfg, _, _ = _model(arch)
    abstract = lm.init_abstract(cfg, max_seq=MAX_SEQ)
    real = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=MAX_SEQ)
    (pa, la), (pr, lr) = leaves_with_paths(abstract), leaves_with_paths(real)
    assert pa == pr
    for a, r in zip(la, lr):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (r.shape, r.dtype)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        jlm.init_abstract(jcfg, max_seq=MAX_SEQ)))
    assert sum(a.numel() for a in la) == want
    tcfg = TrainConfig(compress_grads=True)
    state = trainer.init_train_state_abstract(cfg, tcfg, max_seq=MAX_SEQ)
    assert all(t.device.type == "meta" for t in tree_leaves(state))
    assert len(tree_leaves(state)) == 4 * len(la) + 1  # params, m, v, ef


@pytest.mark.parametrize("arch", ["gpt2-345m", "olmoe-1b-7b",
                                  "xlstm-350m"])
def test_remat_bit_identical(arch):
    _, cfg, jparams, batch = _model(arch)
    params = bridge.params_from_numpy(jax.device_get(jparams))
    out = [_port_loss_and_grads(params, cfg, _torch_batch(batch),
                                remat=remat) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][3], out[1][3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 5, 20), (3e-4, 100, 2000)])
def test_schedule_matches_reference(lr, warmup, total):
    jc = jopt.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    tc = opt.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 10, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jopt.schedule(s, jc)))(
        jnp.asarray(steps)))
    got = opt.schedule(torch.from_numpy(steps), tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SCHED_RTOL, atol=0)


def _tree_np(rng, scale=1.0):
    return {"a": (rng.standard_normal((64, 32)) * scale).astype(np.float32),
            "b": [(rng.standard_normal((100,)) * scale).astype(np.float32)]}


def _to_torch(tree):
    return {"a": torch.tensor(tree["a"]), "b": [torch.tensor(tree["b"][0])]}


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("clip_norm", [1.0, 0.01])
def test_apply_updates_matches_reference(clip_norm):
    rng = np.random.default_rng(0)
    p, g = _tree_np(rng), _tree_np(rng, 0.01)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip_norm)
    jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jopt.init_state(jp, jc)
    tp = _to_torch(p)
    tstate = opt.init_state(tp, tc)
    up = jax.jit(lambda a, b, s: jopt.apply_updates(a, b, s, jc))
    for _ in range(3):
        jp, jstate, jm = up(jp, jax.tree_util.tree_map(jnp.asarray, g),
                            jstate)
        tp, tstate, tm = opt.apply_updates(tp, _to_torch(g), tstate, tc)
    assert int(tstate.step) == int(jstate.step) == 3
    clipped = float(tm["grad_norm"]) > clip_norm
    assert clipped == (clip_norm < 0.1)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=ADAMW_TOL)
    for got, want in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
        assert _max_rel(got["a"], want["a"]) <= ADAMW_TOL
        assert _max_rel(got["b"][0], want["b"][0]) <= ADAMW_TOL


@pytest.mark.parametrize("arch", ["gpt2-345m", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_compress_decompress_matches_reference(arch):
    """On trees shaped like the params: one int8 scale per reference leaf,
    which stacks the layers of each pattern position (a remainder layer
    of recurrentgemma's, whisper's encoder layers)."""
    jcfg, cfg, jparams, _ = _model(arch)
    rng = np.random.default_rng(1)
    g, ef = (jax.tree_util.tree_map(lambda p, s=s: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * s), jparams)
        for s in (0.01, 1e-4))
    jg, je = jax.jit(jtrainer._compress_decompress)(g, ef)
    tg, te = trainer._compress_decompress(
        bridge.params_from_numpy(jax.device_get(g)),
        bridge.params_from_numpy(jax.device_get(ef)), cfg)
    want_g = bridge.params_from_numpy(jax.device_get(jg))
    want_e = bridge.params_from_numpy(jax.device_get(je))
    for a, b in zip(tree_leaves(tg), tree_leaves(want_g)):
        torch.testing.assert_close(a, b, rtol=DEQ_RTOL, atol=0)
    for a, b in zip(tree_leaves(te), tree_leaves(want_e)):
        torch.testing.assert_close(a, b, rtol=0, atol=EF_ATOL)


# ---------------------------------------------------------------------------
# train steps against the reference's jitted step


@pytest.mark.parametrize("kw", [{}, {"microbatches": 4},
                                {"compress_grads": True}],
                         ids=["mb1", "mb4", "compressed"])
def test_train_steps_match_reference(kw, f32_forwards):
    jcfg = jget_config("gpt2-345m").reduced()
    cfg = get_config("gpt2-345m").reduced()
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jt = jtrainer.TrainConfig(opt=jopt.AdamWConfig(**okw), **kw)
    tt = TrainConfig(opt=opt.AdamWConfig(**okw), **kw)
    jstate = jtrainer.init_train_state(jcfg, jt, jax.random.PRNGKey(0),
                                       max_seq=MAX_SEQ)
    tstate = bridge.train_state_from_numpy(jax.device_get(jstate))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jt))
    tstep = make_train_step(cfg, tt)
    data = _data(jpipeline, cfg, 16, 8)
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            STEP_LOSS_RTOL * abs(float(jm["loss"]))
    want = bridge.train_state_from_numpy(jax.device_get(jstate))
    assert int(tstate.opt.step) == 3
    for tol, got, ref in ((STEP_PARAM_TOL, tstate.params, want.params),
                          (STEP_MOMENT_TOL, tstate.opt.m, want.opt.m),
                          (STEP_MOMENT_TOL, tstate.opt.v, want.opt.v)):
        for (path, a), b in zip(zip(*leaves_with_paths(got)),
                                tree_leaves(ref)):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= tol, (path, err)


# ---------------------------------------------------------------------------
# the Trainer (copies of tests/test_training.py)


def _cfg():
    return get_config("gpt2-345m").reduced()


def _tcfg(**kw):
    base = dict(opt=opt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                    total_steps=100))
    base.update(kw)
    return TrainConfig(**base)


def _trainer(d, tcfg=None, **kw):
    cfg = _cfg()
    return Trainer(cfg, tcfg or _tcfg(), SyntheticLM(cfg.vocab_size, 16, 4,
                                                     seed=0),
                   str(d), max_seq=32, device="cpu", **kw)


def test_loss_decreases(tmp_path):
    cfg, tcfg = _cfg(), _tcfg()
    tr = _trainer(tmp_path, tcfg, ckpt_every=1000)
    tr.init_or_restore()
    tr.run(3)
    step = make_train_step(cfg, tcfg)
    batch = trainer.batch_to_tensors(
        SyntheticLM(cfg.vocab_size, 16, 4, seed=0).batch_at(999), "cpu")
    # the step updates in place: measure on copies of the state
    _, m0 = step(tree_map(torch.clone, tr.state), batch)
    tr.run(40)
    _, m1 = step(tree_map(torch.clone, tr.state), batch)
    assert float(m1["loss"]) < float(m0["loss"])


def test_microbatch_equivalence():
    """4 microbatches must produce (near-)identical updates to 1 batch."""
    cfg = _cfg()
    data = SyntheticLM(cfg.vocab_size, 16, 8, seed=3)
    batch = trainer.batch_to_tensors(data.batch_at(0), "cpu")
    outs = {}
    for mb in (1, 4):
        tcfg = _tcfg(microbatches=mb)
        gen = torch.Generator().manual_seed(0)
        state = init_train_state(cfg, tcfg, gen, max_seq=32)
        s2, m = make_train_step(cfg, tcfg)(state, batch)
        outs[mb] = (s2.params, float(m["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=1e-3)
    # Adam's 1/sqrt(v) amplifies micro-fp differences on tiny gradients, so
    # compare with an absolute floor of half an update step.
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-4)


def test_grad_compression_converges(tmp_path):
    """int8 error-feedback compression still reaches a similar loss."""
    losses = {}
    for comp in (False, True):
        tr = _trainer(tmp_path / str(comp), _tcfg(compress_grads=comp),
                      ckpt_every=1000)
        tr.init_or_restore()
        losses[comp] = tr.run(30)["loss"]
    assert losses[True] < losses[False] * 1.15, losses


def test_kill_resume_bitexact(tmp_path):
    tr = _trainer(tmp_path / "a", ckpt_every=10)
    tr.init_or_restore()
    tr.run(20)
    tr2 = _trainer(tmp_path / "a", ckpt_every=10)
    assert tr2.init_or_restore() == 20
    m2 = tr2.run(30)
    tr3 = _trainer(tmp_path / "b", ckpt_every=1000)
    tr3.init_or_restore()
    m3 = tr3.run(30)
    assert m2["loss"] == m3["loss"]  # bit-exact resume
    for a, b in zip(tree_leaves(tr2.state), tree_leaves(tr3.state)):
        assert torch.equal(a, b)


def test_injected_failure_then_recovery(tmp_path):
    tr = _trainer(tmp_path, ckpt_every=5, failure_hook=lambda s: s == 15)
    tr.init_or_restore()
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(30)
    assert ("failure", 15) in tr.events
    # a new trainer (a fresh "node") resumes from the last checkpoint
    tr2 = _trainer(tmp_path, ckpt_every=5)
    start = tr2.init_or_restore()
    # the async step-15 save races the crash; the atomic commit lands on
    # a consistent checkpoint either way
    assert start in (10, 15)
    assert ("restore", start) in tr2.events
    m = tr2.run(20)
    assert np.isfinite(m["loss"])
