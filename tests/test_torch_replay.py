"""The engine's replay prefill (``prefill_mode="replay"``: each prompt
fed one token a tick through the batched decode step, the reference's
A/B debug mode and its serving bench's baseline) against the port's
chunked prefill and the JAX package's replay engine, on the CPU.

* reduced GPT-2 at float32 activations and with W8A8 weights (the
  reference's quantization), on the paged and the stacked layout: the
  port's replay streams equal its chunked streams and the JAX replay
  engine's, token for token, and its tick, model-call and prefill-call
  counts equal the JAX replay engine's (mirroring
  ``tests/test_paged_kv.py``'s and ``tests/test_serving.py``'s replay
  tests);
* a reduced hybrid stack (``recurrentgemma-9b``: rings and recurrent
  states, stacked) and an attention-free one (``xlstm-350m``): replay
  equals chunked (mirroring ``tests/test_hybrid_serving.py``'s);
* the launcher's ``--prefill-mode replay``; replay refuses speculation.
"""
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
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import speculative
from repro_torch.serving.engine import ServeEngine

MAX_SEQ, PAGE, SLOTS, CHUNK, MAX_NEW = 64, 8, 2, 8, 5
COUNTS = ("ticks", "model_calls", "prefill_calls")


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(list(p), max_new=MAX_NEW)
    return {r.rid: r.out for r in eng.run(max_ticks=50_000)}


def _common(layout, mode):
    return dict(batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
                page_size=PAGE, chunk_size=CHUNK, kv_layout=layout,
                prefill_mode=mode)


class Stack:
    """One reduced config: the reference's params (fp and W8A8) and the
    port's, and a prompt set whose lengths cross chunk edges."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        self.jparams = jlm.init(self.jcfg, jax.random.PRNGKey(0),
                                max_seq=MAX_SEQ)
        rng = np.random.default_rng(9)
        calib = rng.integers(1, self.cfg.vocab_size, (2, 16))
        self.jq = jquantize.quantize_model_params(
            self.jparams, self.jcfg,
            jquantize.calibrate(self.jparams, self.jcfg,
                                [jnp.asarray(calib)]))
        self.tparams = bridge.params_from_numpy(jax.device_get(self.jparams))
        self.tq = bridge.params_from_numpy(jax.device_get(self.jq))
        self.prompts = [rng.integers(1, self.cfg.vocab_size, int(n)).tolist()
                        for n in (4, 11, 7, 26, 1)]

    def port(self, w8a8, layout, mode, **kw):
        return ServeEngine(self.cfg, self.tq if w8a8 else self.tparams,
                           act_dtype=torch.float32, device="cpu",
                           **_common(layout, mode), **kw)

    def jax(self, w8a8, layout, mode):
        return JServeEngine(self.jcfg, self.jq if w8a8 else self.jparams,
                            act_dtype=jnp.float32, **_common(layout, mode))


@pytest.fixture(scope="module")
def stacks():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Stack(arch)
        return made[arch]
    return get


@pytest.mark.parametrize("w8a8", [False, True], ids=["f32", "w8a8"])
@pytest.mark.parametrize("layout", ["paged", "stacked"])
def test_gpt2_replay_matches_jax_replay_and_chunked(stacks, layout, w8a8):
    s = stacks("gpt2-345m")
    ops.reset_launch_counts()
    eng = s.port(w8a8, layout, "replay")
    assert eng.prefill_mode == "replay" and eng.kv_layout == layout
    replay = _serve(eng, s.prompts)
    jeng = s.jax(w8a8, layout, "replay")
    assert replay == _serve(jeng, s.prompts)
    assert replay == _serve(s.port(w8a8, layout, "chunked"), s.prompts)
    assert all(len(o) == MAX_NEW for o in replay.values())
    got, want = eng.stats(), jeng.stats()
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    # one model call a tick, none through the chunk path
    assert got["prefill_calls"] == 0 and got["model_calls"] == got["ticks"]
    assert got["model_calls"] >= max(map(len, s.prompts)) + MAX_NEW - 1
    if layout == "paged":
        assert got["pages_in_use"] == 0
    assert sum(ops.launch_counts().values()) == 0  # plain versions


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_hybrid_replay_equals_chunked(stacks, arch):
    """Rings and recurrent states written one decode step a token give
    the chunked prefill's streams (W8A8, the stacked layout)."""
    s = stacks(arch)
    replay = _serve(s.port(True, "stacked", "replay"), s.prompts)
    assert replay == _serve(s.port(True, "stacked", "chunked"), s.prompts)
    assert all(len(o) == MAX_NEW for o in replay.values())


def test_replay_refuses_speculation(stacks):
    s = stacks("gpt2-345m")
    with pytest.raises(ValueError, match="chunked prefill"):
        s.port(False, "paged", "replay", spec=speculative.SpecConfig(k=2))
    with pytest.raises(ValueError, match="prefill_mode"):
        s.port(False, "paged", "eager")


def test_launcher_replay_mode(capsys):
    stats = serve.main(["--arch", "pixtral-12b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--max-new", "3",
                        "--prefill-mode", "replay"])
    assert stats["prefill_calls"] == 0 and stats["requests"] == 3
    assert stats["model_calls"] == stats["ticks"] > 0
    assert "pixtral-12b-reduced on cpu" in capsys.readouterr().out
