"""Training launcher: the JAX package's ``repro/launch/train.py`` on one
NVIDIA H100.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-345m \\
        --steps 20 --seq 512 --global-batch 8 --ckpt-dir ckpt/     # card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 3 --ckpt-dir ckpt/                     # CPU

Initializes (or restores from ``--ckpt-dir``) a train state, trains on
the synthetic pipeline with checkpoints every ``--ckpt-every`` steps,
and prints the last step's metrics.  Kill it and run it again: it
resumes from the last atomic checkpoint, bit for bit.  One process, host
index 0 of 1 (process groups come with multi-GPU support).
``launch/serve.py --ckpt-dir`` serves the trained params.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import TrainConfig, Trainer


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        opt=opt.AdamWConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        remat=args.remat,
    )
    data = SyntheticLM(
        cfg.vocab_size, args.seq, args.global_batch, seed=args.seed,
        host_index=0, host_count=1,
        with_frames=cfg.is_encoder_decoder,
        frame_len=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        d_model=cfg.d_model,
        with_patches=cfg.frontend == "vision_patches",
        patch_tokens=cfg.frontend_tokens,
    )
    tr = Trainer(cfg, tcfg, Prefetcher(iter(data)), args.ckpt_dir,
                 max_seq=args.seq, ckpt_every=args.ckpt_every,
                 seed=args.seed, device=args.device)
    start = tr.init_or_restore()
    print(f"[train] {cfg.name} on {tr.device}: start_step={start} -> "
          f"{args.steps}")
    metrics = tr.run(args.steps)
    print(f"[train] done: {metrics}; events={tr.events[-5:]}")
    return metrics


if __name__ == "__main__":
    main()
