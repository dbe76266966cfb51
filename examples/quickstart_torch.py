"""Quickstart on the PyTorch port: train a step, then serve W8A8.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        [--arch tinyllama-1.1b]
    PYTHONPATH=src python examples/quickstart_torch.py          # the card

Instantiates a reduced config of any architecture, runs one training
step, quantizes to W8A8 and generates a few tokens through the
continuous-batching engine (decoder stacks; whisper runs at model level).
The sibling of ``examples/quickstart.py``.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.serving.engine import ServeEngine, resolve_device  # noqa
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.trainer import (TrainConfig,  # noqa: E402
                                          batch_to_tensors, init_train_state,
                                          make_train_step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"pattern={cfg.block_pattern}) on {dev}")

    # one training step
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=1e-3))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, tcfg, gen, max_seq=64, device=dev)
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    if cfg.frontend == "vision_patches":
        batch["patches"] = np.zeros((2, cfg.frontend_tokens, cfg.d_model),
                                    np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = np.zeros((2, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    state, metrics = step(state, batch_to_tensors(batch, dev))
    print(f"train_step: loss={float(metrics['loss']):.3f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    # quantize + serve (decoder stacks)
    if cfg.is_encoder_decoder:
        print("(whisper: the engine serves decoder stacks; skipping the "
              "engine demo)")
        return
    eng = ServeEngine(cfg, state.params, batch_slots=2, max_seq=64,
                      eos_id=-1, quantized=True, device=dev)
    for i in range(3):
        eng.submit([i + 1, 2, 3, 4], max_new=8)
    for r in eng.run():
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out}")
    print("engine stats:", eng.stats())


if __name__ == "__main__":
    main()
