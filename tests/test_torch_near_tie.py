"""The near-tie rule's own state and its router pinning
(``repro_torch.serving.near_tie``), on the CPU.

* Two holds in one process, over two params trees of one reduced config
  and the same prompts, each recompute their own tree's logits: the
  prefills a hold's replays share end with that hold, and no entry is
  found by another tree.
* A pinned replay that pins nothing is the unpinned replay bit for bit,
  with raw gates (``norm_topk_prob=False``, OLMoE-0924's published form)
  and with gates renormalised over the k, as ``moe.route`` computes them.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import near_tie
from repro_torch.serving.engine import ServeEngine

CPU = torch.device("cpu")
SHAPE = dict(max_seq=64, page=16, chunk=16, rows=2)


def _served(cfg, params, prompts, max_new):
    """Serve ``prompts`` greedily on the CPU under a ``ScheduleProbe``:
    (rid -> tokens, rid -> calls)."""
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                      act_dtype=torch.float32, chunk_size=16, page_size=16,
                      device=CPU)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    with near_tie.ScheduleProbe(eng) as probe:
        out = {r.rid: r.out for r in eng.run()}
    return out, probe.calls


def test_each_hold_recomputes_its_own_trees_logits():
    """Reduced GPT-2 from two seeds, the same prompts (two prefill chunks
    and one): each tree's hold replays every served token to its argmax,
    the first tree freed before the second is made; one ``Prefilled``
    shared by both trees gives each tree's replays bit for bit."""
    cfg = get_config("gpt2-345m").reduced()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (20, 35)]
    shared, firsts = near_tie.Prefilled(), []
    for seed in (0, 1):
        params = lm.init(cfg, torch.Generator().manual_seed(seed), max_seq=64)
        out, calls = _served(cfg, params, prompts, 4)
        fn = near_tie.served_logits(params, cfg, calls, CPU, **SHAPE)
        for rid, toks in out.items():
            for i, tok in enumerate(toks):
                lg = fn(rid, prompts[rid], toks[:i])
                assert int(lg.argmax()) == tok, (seed, rid, i)
                assert torch.equal(
                    fn(rid, prompts[rid], toks[:i], prefilled=shared), lg)
        firsts.append(out[1][0])
        del params, fn, calls
        gc.collect()
    assert firsts[0] != firsts[1]  # the trees serve other streams


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_a_pinned_replay_that_pins_nothing_is_the_unpinned_replay(
        norm_topk_prob):
    """Reduced OLMoE: every token's replay with the routers recorded, and
    again pinned to those records (nothing moves), equals the replay
    without a probe bit for bit."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              norm_topk_prob=norm_topk_prob)
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (9, 21)]
    out, calls = _served(cfg, params, prompts, 3)
    fn = near_tie.served_logits(params, cfg, calls, CPU, **SHAPE)
    for rid, toks in out.items():
        for i in range(len(toks)):
            plain = fn(rid, prompts[rid], toks[:i])
            with near_tie.RouterProbe(cfg) as rec:
                recorded = fn(rid, prompts[rid], toks[:i], router=rec)
            with near_tie.RouterProbe(cfg, pin=rec.rec) as pin:
                pinned = fn(rid, prompts[rid], toks[:i], router=pin)
            assert rec.rec and pin.pinned == 0
            assert torch.equal(recorded, plain), (rid, i)
            assert torch.equal(pinned, plain), (rid, i)
