"""Serving launcher: a decoder (``--arch``, GPT-2 345M by default),
W8A8 SmoothQuant, paged KV cache, chunked prefill and batched continuous
decode on one NVIDIA H100.

    PYTHONPATH=src python -m repro_torch.launch.serve                # card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --requests 4 --max-new 6                         # CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --device cpu                                        # RoPE
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --reduced --device cpu                                        # MoE
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --reduced --device cpu           # hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
        --reduced --device cpu --prefill-mode replay              # replay
    PYTHONPATH=src python -m repro_torch.launch.serve --profile out/  # trace
    PYTHONPATH=src python -m repro_torch.launch.serve --spec ngram    # spec
    PYTHONPATH=src python -m repro_torch.launch.serve --spec model \
        --spec-k 8 --tree-branch 3                                    # tree
    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir ckpt/ \
        --max-seq 512                             # trained by launch/train

A stack with a global-attention layer serves on the paged layout (a
mixed one keeps its rings and recurrent states slot-resident beside the
pages); an attention-free hybrid one (``recurrentgemma-9b``,
``xlstm-350m``) on the stacked layout, with no request ceiling.
``pixtral-12b`` serves its decoder on tokens alone (the engine takes no
patches, as the reference's); ``whisper-large-v3`` is refused
(encoder-decoder: it runs at model level, see ``chip_smoke.py``).  Draws
random weights from ``--seed``, calibrates SmoothQuant on synthetic
prompts made with numpy from the same seed, serves ``--requests``
requests of mixed prompt lengths greedily, and prints the first four
streams, the engine's stats and the kernels' launch counts.  The
counterpart of the JAX package's ``examples/serve_gpt2.py``.

``--ckpt-dir`` serves the params of the latest checkpoint that
``launch/train.py`` wrote there (trained with ``--seq`` equal to this
``--max-seq`` for a model with learned positions) in place of random
ones; ``--no-quant`` serves the float params (bf16 activations) instead
of W8A8.

``--spec ngram|model`` serves with speculative decoding: k
(``--spec-k``) draft tokens per slot from the n-gram proposer or from a
draft model (the target's fp weights plus 0.25 of each tensor's std of
seeded noise), verified as a chain, or as a token tree with up to
``--tree-branch`` children per node.

``--profile DIR`` runs the serving loop under ``torch.profiler`` and
writes its Chrome trace to ``DIR/serve_trace.json``.  The engine then
records its host timeline too (``Telemetry(trace=True, annotate=True)``),
written beside it to ``DIR/serve_host_trace.json``: every dispatch is a
profiler range named as its host span, so the card's kernels sit inside
``decode.step``, ``prefill.chunk`` or ``spec.verify``.  It prints the
device's busy share of the loop's wall time (the union of the device's
kernel and copy intervals, so overlapping work counts once) and the
heaviest device and host operators.  The profiler's own cost inflates
the host time; read the busy share beside an unprofiled run.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serving.engine import ServeEngine, resolve_device
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import Telemetry
from repro_torch.training.trainer import (TrainConfig,
                                          init_train_state_abstract)


def synthetic_prompts(rng: np.random.Generator, n: int, vocab: int,
                      lo: int, hi: int) -> List[List[int]]:
    """``n`` prompts of lengths drawn uniformly from [lo, hi]."""
    return [rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2-345m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--prefill-mode", default="auto",
                    choices=("auto", "chunked", "replay"),
                    help="auto == chunked for every decoder stack; replay "
                         "feeds prompts one token a tick through decode "
                         "(the A/B baseline)")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="trace the serving loop with torch.profiler")
    ap.add_argument("--spec", choices=("ngram", "model"),
                    help="speculative decoding with this draft proposer")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens (tree nodes) per slot and tick")
    ap.add_argument("--tree-branch", type=int, default=0,
                    help="verify token trees of this branching (0: chains)")
    ap.add_argument("--ckpt-dir",
                    help="serve the params of launch/train.py's latest "
                         "checkpoint in this directory")
    ap.add_argument("--no-quant", action="store_true",
                    help="serve the float params, not W8A8")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is encoder-decoder: this launcher "
                         "serves decoder stacks")
    if args.ckpt_dir:
        like = init_train_state_abstract(cfg, TrainConfig(),
                                         max_seq=args.max_seq)
        params = CheckpointManager(args.ckpt_dir).restore(
            None, like, device=dev).params
        print(f"restored params from {args.ckpt_dir}")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = lm.init(cfg, gen, max_seq=args.max_seq, device=dev)
    rng = np.random.default_rng(args.seed)
    calib = [rng.integers(1, cfg.vocab_size, (2, min(64, args.max_seq)))]
    spec = None
    if args.spec:
        draft = (noisy_copy(params, args.seed + 1)
                 if args.spec == "model" else None)
        spec = SpecConfig(k=args.spec_k, proposer=args.spec,
                          draft_cfg=cfg if draft else None,
                          draft_params=draft, tree=args.tree_branch > 0,
                          branch=max(1, args.tree_branch))
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=args.max_seq, eos_id=-1,
                      quantized=not args.no_quant,
                      calibration_batches=calib, chunk_size=args.chunk_size,
                      prefill_mode=args.prefill_mode, seed=args.seed,
                      spec=spec, device=dev,
                      telemetry=Telemetry(trace=bool(args.profile),
                                          annotate=bool(args.profile)))
    hi = max(2, args.max_seq - args.max_new - 1)
    prompts = synthetic_prompts(rng, args.requests, cfg.vocab_size,
                                min(3, hi), hi)
    # the profiler starts before the requests arrive, so its start-up
    # cost stays out of their latencies
    prof = _profiler(dev) if args.profile else None
    if prof is not None:
        prof.start()
    for p in prompts:
        eng.submit(p, max_new=args.max_new)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        _report_profile(prof, wall, dev, args.profile)
        print("host trace written to " + eng.tel.dump_trace(
            os.path.join(args.profile, "serve_host_trace.json")))
    stats = eng.stats()
    toks = sum(len(r.out) for r in done)
    stats["tokens_per_s"] = toks / wall
    print(f"{cfg.name} on {dev}: {len(done)} requests, {toks} tokens in "
          f"{wall:.3f} s ({toks / wall:.1f} tok/s)")
    for r in done[:4]:
        print(f"req {r.rid}: {len(r.prompt)} prompt -> {r.out}")
    print("kernel launches:", json.dumps(ops.launch_counts()))
    print("engine stats:", json.dumps(stats, sort_keys=True))
    return stats


def noisy_copy(params, seed: int, sigma: float = 0.25):
    """A draft model for ``--spec model``: every tensor of ``params`` plus
    ``sigma`` of its own std of noise from a generator seeded ``seed``."""
    gen = torch.Generator(device=params["embed"]["table"].device)
    gen.manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t + sigma * t.std() * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype)

    return walk(params)


def _profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _report_profile(prof, wall: float, dev: torch.device, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev_iv = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if dev.type == "cuda":
        busy = _busy_us(dev_iv) * 1e-6
        print(f"device busy {busy:.4f} s of {wall:.4f} s wall "
              f"({100 * busy / wall:.2f}%) over {len(dev_iv)} device "
              "operations")
    else:
        print("device busy: not measured (CPU run)")
    sort = ("self_cuda_time_total" if dev.type == "cuda"
            else "self_cpu_time_total")
    print(prof.key_averages().table(sort_by=sort, row_limit=15))
    print(f"trace written to {path}")


if __name__ == "__main__":
    main()
