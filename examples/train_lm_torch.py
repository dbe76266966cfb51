"""Training driver on the PyTorch port: a GPT-2 for a few hundred steps
on the synthetic pipeline, with checkpoint/restart and straggler
accounting.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200   # card
    PYTHONPATH=src python examples/train_lm_torch.py --reduced \
        --device cpu --steps 300

The default config is gpt2-345m scaled to 12 layers / d=768 (~100M
params); ``--reduced`` is the CPU tests' tiny one.  Kill the process
mid-run and run it again: it resumes from the last atomic checkpoint.
The sibling of ``examples/train_lm.py``.
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.trainer import TrainConfig, Trainer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args()

    cfg = get_config("gpt2-345m")
    if args.reduced:
        cfg = cfg.reduced()
        args.seq = min(args.seq, 32)
    else:
        cfg = dataclasses.replace(
            cfg, name="gpt2-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=8192)
    print(f"training {cfg.name}: seq={args.seq}, batch={args.batch}")

    tcfg = TrainConfig(
        opt=opt.AdamWConfig(lr=3e-4, warmup_steps=20,
                            total_steps=args.steps),
        microbatches=2,
        compress_grads=args.compress_grads,
    )
    # SyntheticLM restarts from step 0 when iterated anew, so each run()
    # fast-forwards it to where the trainer stands
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    tr = Trainer(cfg, tcfg, data, args.ckpt_dir, max_seq=args.seq,
                 ckpt_every=50, device=args.device)
    start = tr.init_or_restore()
    if start:
        print(f"resumed from checkpoint at step {start}")

    t0 = time.time()
    last_loss = None
    step = start
    while step < args.steps:
        chunk = min(step + 25, args.steps)
        m = tr.run(chunk)
        step = chunk
        tr.start_step = step
        rate = (step - start) / (time.time() - t0)
        print(f"step {step:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
              f"gnorm {m['grad_norm']:.2f}  ({rate:.2f} steps/s)")
        last_loss = m["loss"]
    print(f"done. final loss {last_loss:.4f}; events: {tr.events[-4:]}")


if __name__ == "__main__":
    main()
