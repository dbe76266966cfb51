#!/usr/bin/env python3
"""The PyTorch port (``src/repro_torch``) on one NVIDIA H100: the kernels'
timings, full-width serving held to the near-tie rule, full-width training
and a traced full-width serving run.

    python3 chip_smoke.py

Each kernel's correctness against its plain version lives in
``tests/test_torch_gpu.py`` (``pytest -m gpu``); this script makes only
what no card test makes.  Phases, each printed as it runs with the
seconds since the start; any failure exits non-zero and nothing is
caught and continued:

1. Device: the card's name and power limit (``nvidia-smi``) and its
   compute capability, which must be (9, 0).
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together).  The compiler's register and
   shared-memory report goes to ``chiprun_out/ptxas.log``.
3. Kernel timings: each kernel, its plain version and one PyTorch library
   call that computes the same function, timed with CUDA events per
   launch with the 50 MB L2 flushed before each launch (the serving loop
   streams ~300 MB of other weights and pages between two uses of one
   layer's), beside the least time the card could take (bytes over 3.35
   TB/s or operations over the dense peak of the operands' type).  Each
   timed call is held once to its plain version (bit for bit, or per
   output vector for attention) so that the time is that of a right
   answer.  Two yardsticks of the timing itself: an empty kernel (a
   4-byte fill) and, beside each decode-tick ``mp_matmul``, a
   device-to-device copy of the same weight bytes.  The shapes: GPT-2
   345M's serving calls (``mp_matmul``'s layer at M 8 and 32; the paged
   decode; a prefill chunk, a chain verify and a tree verify; the
   contiguous decode on float32 and bf16 caches; ``ln_res`` at 8, 32 and
   256 rows; ``quant_act`` at 127 and 32 rows); the RoPE family's and
   olmoe's heads and linears; recurrentgemma's ring and the hybrid
   stacks' linears; whisper's cross and self decode and its encoder's
   linears; the mixed stack's ``attn`` layers; ``mp_matmul`` on GPT-2's
   column shards of four; the grouped MoE experts at
   ``olmoe-1b-7b-0924``'s widths (and a reduced published-form engine
   that counts its launches).
4. Serving: full-width ``gpt2-345m`` with random weights from a seeded
   generator, W8A8 SmoothQuant calibrated on seeded prompts, paged KV
   cache, chunk 32, 8 slots, ``max_seq`` 1024, 16 greedy requests with
   prompts of 16..512 tokens and 64 new tokens each; launch counts
   against the calls; one prompt prefilled and decoded at full width on
   the card and on the CPU with the same weights, the logits within
   ``LOGIT_REL_TOL`` of their range.
5. MDK program: the 49 ``ln_res`` stages of the stage program through
   ``MDK_REGISTRY["ln_res"]`` at 8 and 32 rows: ``ln_res``'s launches for
   the ``kernels`` line (no model code calls it).
6. Speculative serving at full width: chain speculation (n-gram, k 4) on
   prompts that repeat short runs and tree speculation with a noisy draft
   model (k 8, branch 3), each held against plain decode of the same
   prompts on the card by the near-tie rule (``serving/near_tie.py``:
   each side's logits recomputed along the calls that served its stream,
   in the engine's batch of 8 rows).  Then the stacked layout (plain and
   chain), over-commit with preemption to host and by recompute and two
   cancels, replay prefill, and ``DistributedServeEngine`` on shards of
   the card (2 x 4 plain and chain, 4 x 2 with a shared system prompt, 2
   x 4 stacked with migrations) and ring TP (``ServeEngine(mesh=)``, token
   for token the unsharded engine's), each held by the same rule.
7. Reduced-config agreement: the reduced config served on the card and on
   the CPU with the same W8A8 weights, plain, chain and tree, held by the
   near-tie rule; then with replay prefill.
8. Whisper at model level, full width and depth (32 + 32 layers), the
   kernels against the plain versions on the card (taught the same
   stream); then the RoPE dense family, olmoe and pixtral at full width
   and a quarter of their depth (``FAMILY_LAYERS``; ``FAMILY_RUNS``), the
   hybrid stacks at full width (``HYBRID_LAYERS``, ``HYBRID_MAX_SEQ``:
   rings wrap, requests run past ``max_seq``) and the mixed stack on the
   per-kind paged and the stacked layout (a prefix pair, an over-commit
   run); launches against the calls and every pair held by the near-tie
   rule (for a MoE stack with its routing near-ties).
9. Reduced-config agreement of whisper (model level), the RoPE family,
   the MoE decoders, the hybrid stacks and pixtral, card against CPU; and
   reduced ``recurrentgemma-9b`` through ``DistributedServeEngine`` 2 x 2.
10. Training: full-width ``gpt2-345m`` (float32 masters, bf16
   activations).  One train step at 2 x 64 tokens from the same state on
   the card and on the CPU: loss within 1% and global grad norm within 2%
   (bf16 products round differently on the two devices).  Then 20 AdamW
   steps (lr 1e-3, 5 warmup steps) through ``Trainer`` on
   ``SyntheticLM`` at 8 x 512 tokens, async checkpoints every 10 steps
   into ``chiprun_out/`` (removed at the phase's end), under
   ``torch.use_deterministic_algorithms(True)`` (the script sets
   ``CUBLAS_WORKSPACE_CONFIG`` before torch starts): median step ms,
   tokens/s, peak memory, every loss and grad norm finite, and the loss
   on a held-out batch, which must fall.  A fresh ``Trainer`` restores
   step 20 bit for bit; one resumed from step 10 reaches step 20
   bit-identical to the uninterrupted run.  The restored params and the
   in-memory ones each serve 8 greedy requests of 32 new tokens on a W8A8
   paged engine: launch counts match the calls, the streams are equal,
   and the checkpoint's run's counts join the ``kernels`` line as
   ``trained checkpoint``.
11. Analysis: full-width ``gpt2-345m``, W8A8, paged, the serving settings
   of phase 4, 8 requests of 32 new tokens on seeded prompts of 64-256
   tokens, after a warm-up on an engine of its own.  An untraced run,
   each ``lm.decode_step`` timed by CUDA events, then the same requests
   on an engine with ``Telemetry(trace=True, annotate=True)`` under
   ``torch.profiler`` (CPU and CUDA): the streams equal; the host trace
   valid; each annotated dispatch name with as many profiler ranges as
   host spans; every ``mp_matmul``, ``paged_verify`` and paged decode
   CUDA function launched inside a range, as many as their counters say,
   none outside: ``mp_matmul`` under both the prefill chunks and the
   decode steps, the verify under the prefill chunks alone and the decode
   under the decode steps alone.  The median decode step against
   ``perfmodel.roofline_terms`` of its operations and the bytes it must
   move: the share bound / measured must be in (0, 1.05].  Its counts
   join the ``kernels`` line as ``analysis``.
12. The device time of each CUDA function of the timed calls
   (``torch.profiler``), last of the measuring phases because the
   profiler leaves later launches slower.
13. One ``kernels`` JSON line (eight kernels, each with its launches on its
   own path and per run), the total time, the card's name and power
   limit, then the device JSON line last.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS takes a fixed workspace, set before its first call, so that the
# training phase's deterministic algorithms can run on the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import partition, perfmodel, scheduler  # noqa: E402
from repro_torch.core.mdk import MDK_REGISTRY  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh, make_serving_mesh)
from repro_torch.models import attention, blocks, lm, moe  # noqa: E402
from repro_torch.models.layers import activation_fn, to_device  # noqa: E402
from repro_torch.serving.admission import (  # noqa: E402
    FIFOAdmission, OvercommitAdmission)
from repro_torch.serving.distributed import (  # noqa: E402
    DistributedServeEngine)
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.lifecycle import (  # noqa: E402
    DECODE, PREEMPTED_HOST, PREEMPTED_RECOMPUTE)
from repro_torch.serving.near_tie import (  # noqa: E402
    AGREE_CHUNK, AGREE_MAX_SEQ, AGREE_PAGE, LOGIT_REL_TOL, DistScheduleProbe,
    ScheduleProbe, hold_streams, hold_taught, mp_per_call, served_logits,
    whisper_mp_calls, whisper_run)
from repro_torch.serving.quantize import (calibrate,  # noqa: E402
                                          quantize_model_params)
from repro_torch.serving.speculative import (SpecConfig,  # noqa: E402
                                             TokenTree, tree_arrays)
from repro_torch.serving.telemetry import (  # noqa: E402
    Telemetry, modeled_vs_measured, profile_ranges, validate_chrome_trace)
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    TrainConfig, Trainer, batch_to_tensors, init_train_state,
    make_train_step)

OUT_DIR = os.path.join(ROOT, "chiprun_out")
#: NVIDIA H100 SXM data sheet (``core/perfmodel``'s ``H100_*``): HBM3
#: rate, dense tensor-core peaks, and float32 outside the tensor cores
HBM_BYTES_PER_S = perfmodel.H100_HBM_BW
PEAK_OPS = perfmodel.H100_PEAK_OPS
#: serving shapes of the main path
SLOTS, CHUNK, MAX_SEQ, PAGE = 8, 32, 1024, 16
MP_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))  # (K, N)
MP_PER_LAYER = {(1024, 1024): 4, (1024, 4096): 1, (4096, 1024): 1}
#: per output vector: f32 probabilities (kernel) vs bf16-rounded (plain)
ATTN_REL_TOL = 1e-2
#: speculative serving: chain k, tree k and branch, draft noise (std)
CHAIN_K, TREE_K, TREE_BRANCH, DRAFT_SIGMA = 4, 8, 3, 0.25
SPEC_REQUESTS, SPEC_NEW, SPEC_PROMPT_LENS = 8, 64, (16, 512)
#: the rows' lengths at the timed contiguous decode: spread over the
#: cache, 4,259 keys in all
MHA_TIMED_LENGTHS = (37, 269, 361, 504, 602, 648, 872, 966)
#: ln_res timed at GPT-2's width: a decode tick's rows, a prefill
#: chunk's and a large batch's
LN_TIMED = (8, 32, 256)
#: quant_act timed at a decode tick's and a prefill chunk's rows at
#: GPT-2's two widths
QA_TIMED = ((127, 1024), (127, 4096), (32, 1024), (32, 4096))
#: the RoPE family's head shapes timed beside GPT-2's: groups 4 and 3 at
#: D 128, and D 256
WIDE_ARCHS = ("llama3-8b", "minitron-4b", "gemma-7b", "olmoe-1b-7b")
#: the full-width serving phases: config -> runs (layout, variant), and
#: the depth each config serves at (a quarter of its layers: the hybrid
#: stacks' phases took the time)
FAMILY_LAYERS = {"llama3-8b": 8, "gemma-7b": 7, "olmoe-1b-7b": 4,
                 "pixtral-12b": 4}
FAMILY_RUNS = {"llama3-8b": ("paged plain", "paged chain", "stacked plain"),
               "gemma-7b": ("paged plain", "stacked plain"),
               "olmoe-1b-7b": ("paged plain", "paged chain",
                               "stacked plain"),
               "pixtral-12b": ("paged plain", "stacked plain")}
#: the reduced-config agreement phases after GPT-2's
AGREE_ARCHS = ("llama3-8b", "gemma-7b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
               "recurrentgemma-9b", "xlstm-350m", "pixtral-12b")
#: whisper-large-v3 at model level: requests, new tokens, the decoder's
#: 448 positions; the ragged prompts (replayed through lm.prefill) and
#: the uniform ones' length (lm.batch_prefill), the rest of the requests
WHISPER_REQUESTS, WHISPER_NEW, WHISPER_MAX_SEQ = 8, 64, 448
WHISPER_RAGGED = (4, 11, 19, 32)
WHISPER_UNIFORM = 24
#: mp_matmul timed at the encoder's token counts: one request's frames,
#: eight requests'
WHISPER_MP_M = (1500, 12000)
#: replay prefill on phase 4's GPT-2: requests and their prompt lengths
REPLAY_REQUESTS, REPLAY_PROMPT_LENS = 4, (16, 128)
#: the training phase: full-width gpt2-345m (float32 masters, bf16
#: activations) on the port's SyntheticLM, batches of 8 x 512 tokens, 20
#: AdamW steps (lr 1e-3, 5 warmup steps) checkpointed every 10; the
#: held-out batch's step; one step at 2 x 64 tokens on the card and on
#: the CPU, whose loss and global grad norm must agree within these
#: relative tolerances (bf16 products round differently on the two
#: devices; a wrong gradient moves the norm by far more); the trained
#: checkpoint served: 8 greedy requests of 32 new tokens on prompts of
#: 16-128 tokens from the held-out batch
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = (
    "gpt2-345m", 8, 512, 20, 10)
TRAIN_HELD_OUT_STEP = 10_000
TRAIN_XDEV_SHAPE, TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = (2, 64), 1e-2, 2e-2
TRAIN_SERVE_NEW, TRAIN_SERVE_PROMPT_LENS = 32, (16, 128)
#: the hybrid stacks at full width, stacked plain and chain: config ->
#: max_seq (recurrentgemma's ring is then its published 2,048-token
#: window); six prompts of 16-512 tokens and two of 2,100-2,400, which
#: wrap the rings in prefill and decode and run past max_seq; the depth
#: each serves at (two pattern periods of recurrentgemma's, one of
#: xlstm's: the near-tie rule's replay of every parting along its calls
#: took the time)
HYBRID_MAX_SEQ = {"recurrentgemma-9b": 2048, "xlstm-350m": 1024}
HYBRID_LAYERS = {"recurrentgemma-9b": 6, "xlstm-350m": 4}
HYBRID_LONG = (2100, 2400)
#: the grouped experts kernel at olmoe-1b-7b-0924's widths (d 2,048, f
#: 1,024, 64 bf16 experts, top 8): the cell's 32-slot decode step and a
#: prefill of 256 tokens; its tolerance against the plain version on the
#: card, per output row and as the share of elements that differ (the card
#: tests', where the reason is stated)
MOE_EXPERTS_T = (32, 256)
MOE_REL_TOL, MOE_DIFF_SHARE = 2 ** -7, 0.05
#: the over-commit phase's page pool (pages of 16, the null page included):
#: every prompt fits, the requests' reservations together do not
OVERCOMMIT_PAGES = 97
#: the mixed stack: the reference test's per-kind pattern at
#: recurrentgemma-9b's widths, two periods deep, served with max_seq 4,096
#: (the attn layers' pages hold the long prompts whole); its decode rows'
#: lengths at the timed decode, and the pages of its over-commit pool (the
#: longest prompt fits, with room for two of the short ones)
MIXED_PATTERN, MIXED_LAYERS, MIXED_MAX_SEQ = (
    ("attn", "local_attn", "rglru"), 6, 4096)
MIXED_TIMED_LENGTHS = (80, 179, 278, 377, 476, 576, 2164, 2464)
MIXED_OVERCOMMIT_PAGES = 1 + 160 + 48
#: the analysis phase: requests, new tokens and prompt lengths of its
#: traced run; the engine's annotated dispatch sites; the CUDA function
#: each kernel of the paged W8A8 path launches once a call (the decode's
#: split kernel is its Paged instance, the combines are not counted);
#: the largest share of its roofline bound a decode step may show (a
#: step faster than its bound means a wrong bound or a wrong clock)
ANALYSIS_REQUESTS, ANALYSIS_NEW, ANALYSIS_PROMPT_LENS = 8, 32, (64, 256)
ANNOTATED = ("prefill.chunk", "decode.step", "spec.verify", "prefill.round",
             "wave.consume", "wave.dispatch")
RANGE_KERNELS = {"mp_matmul": ("mp_matmul_kernel",),
                 "paged_verify": ("verify::split_kernel",),
                 "paged_mha_decode": ("decode::split_kernel", "Paged")}
#: the one range each attention kernel launches in (mp_matmul: both)
RANGE_OWNER = {"paged_verify": "prefill.chunk",
               "paged_mha_decode": "decode.step"}
ROOFLINE_SHARE_MAX = 1.05
#: ring TP's shards of the card, and the distributed runs' rows a shard
#: and new tokens
RING_SHARDS = 4
DIST_BS = SLOTS // 2
DIST_NEW = 32


#: the timed calls profiled by CUDA function after the serving phases
#: (``by_kernel_phase``): (label, kernel entry, entry field, call, name
#: keys of its CUDA functions)
PROFILED = []


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


#: the script's start, for the elapsed time each phase header prints
T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} [{time.perf_counter() - T_START:.1f} s]", flush=True)


# ---------------------------------------------------------------------------
# timing


class Timer:
    """CUDA-event time of one call, the L2 flushed before each.  A device
    sleep queued ahead of the start event keeps the card busy while the
    host enqueues the call, so the events time the device work and not
    the Python that launches it."""

    def __init__(self, dev):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clock
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    def by_kernel(self, fn, keys, iters: int = 10) -> str:
        """Device time per call of each CUDA function whose name holds one
        of ``keys``, from ``torch.profiler`` over ``iters`` calls with the
        L2 flushed before each, as a line of text; "not measured" where
        the trace holds no device time."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        parts = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0)
            if us and any(k in e.key for k in keys):
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].replace("void ", "")
                parts.append(f"{name} {us / iters / 1e3:.4f} ms")
        return "by kernel: " + ("; ".join(parts) or "not measured")


def bound_ms(nbytes: float, ops_: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_ / PEAK_OPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# inputs at the serving shapes (numpy, seeded)


def mp_inputs(rng, M, K, N, dev, bias=False):
    x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, N)).astype(np.float32))
    b = (torch.from_numpy(rng.standard_normal(N).astype(np.float32))
         if bias else None)
    return [t if t is None else t.to(dev) for t in (x, w, xs, ws, b)]


def pool_inputs(rng, B, H, D, dev, q_shape, max_seq=MAX_SEQ):
    """A page pool of B rows x ``max_seq`` positions (page 0 null), a
    random block table and a query of ``q_shape``."""
    n_pg = max_seq // PAGE
    P = 1 + B * n_pg
    k = torch.from_numpy(rng.standard_normal((P, H, PAGE, D)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((P, H, PAGE, D)).astype(
        np.float32)).to(torch.bfloat16)
    bt = torch.from_numpy(
        (1 + rng.permutation(B * n_pg)).reshape(B, n_pg).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32))
    return q.to(dev), k.to(dev), v.to(dev), bt.to(dev)


def live_table(bt, npos):
    """Null out block-table entries past each row's live pages."""
    bt = bt.clone()
    for b, n in enumerate(npos):
        bt[b, -(-int(n) // PAGE):] = 0
    return bt


def rel_err(out, want):
    """The largest absolute error, and the largest error of an output
    vector (the last axis) over that vector's largest magnitude."""
    err = (out.float() - want.float()).abs().amax(dim=-1)
    rel = err / want.float().abs().amax(dim=-1).clamp_min(1e-30)
    return err.max().item(), rel.max().item()


# ---------------------------------------------------------------------------
# phases


def device_phase():
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(smi)
    print(f"capability {cap}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    return smi


def build_phase():
    phase("build")
    path, secs, log = build.build(verbose=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(log)
    build.library()
    print(f"built {path.name} from {len(build.sources())} sources in "
          f"{secs:.2f} s")


def verify_geometry(q, kp, bt):
    """The split-KV geometry ``ops.paged_verify`` launches for these
    operands, as a line of text."""
    B, C, H, D = q.shape
    Hkv, ps = kp.shape[1], kp.shape[2]
    g = ops._verify_geometry(B, C, H, Hkv, ps, D, bt.shape[1])
    return (f"geometry: {g.nq} queries x {g.q_tiles} query tiles, "
            f"{g.splits} splits of {g.pps} pages, "
            f"{B * Hkv * g.q_tiles * g.splits * g.parts} blocks, {g.smem} B "
            "shared, "
            f"{4 * g.scratch} B scratch")


def kernel_phase(dev, timer):
    """Phase 3 at GPT-2 345M's serving shapes: each kernel timed beside
    its plain version, a library call and its bound, each timed call held
    once to its plain version.  Returns the kernels' JSON entries (launch
    counts filled in later)."""
    phase("kernel timings (gpt2-345m's serving shapes)")
    rng = np.random.default_rng(0)
    entries = {}

    # -- mp_matmul: every (K, N) of the model at M = slots, chunk
    # yardsticks of the timing itself: an empty kernel (a 4-byte fill) and
    # a device-to-device copy of each weight matrix's bytes
    tiny = torch.zeros(1, device=dev)
    floor_ms = timer.ms(lambda: tiny.zero_())
    print(f"timing floor: a 4-byte fill takes {floor_ms:.4f} ms per call")
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "copy_ms": 0.0}
    prefill = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0}
    layer_args = {SLOTS: [], CHUNK: []}  # one layer's six calls, profiled
    for K, N in MP_SHAPES:
        for M in (SLOTS, CHUNK):
            x, w, xs, ws, _ = mp_inputs(rng, M, K, N, dev)
            layer_args[M] += [(x, w, xs, ws)] * MP_PER_LAYER[(K, N)]
            check(torch.equal(
                ops.quant_matmul(x, w, xs, ws, out_dtype=torch.float32),
                ref.quant_matmul_ref(x, w, xs, ws, out_dtype=torch.float32)),
                f"mp_matmul M={M} K={K} N={N}: not bit-identical")
            t = timer.ms(lambda: ops.quant_matmul(
                x, w, xs, ws, out_dtype=torch.float32))
            tp = timer.ms(lambda: ref.quant_matmul_ref(
                x, w, xs, ws, out_dtype=torch.float32))
            if M > 16:  # torch._int_mm takes M > 16 only
                tl = timer.ms(lambda: (torch._int_mm(x, w).float() * xs)
                              * ws)
                lib = f"{tl:.4f}"
            else:
                lib = "n/a (torch._int_mm needs M > 16)"
            nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
            b, by = bound_ms(nbytes, 2 * M * K * N, "int8")
            g = ops._mp_geometry(M, N, K)
            print(f"mp_matmul M={M} K={K} N={N}: bit-identical, kernel "
                  f"{t:.4f} ms, plain {tp:.4f} ms, library {lib} ms, bound "
                  f"{b:.5f} ms ({by}); clusters of {g.splits} x "
                  f"{g.strips * g.m_blocks} ({g.bm}-token blocks)")
            n = MP_PER_LAYER[(K, N)]
            if M == SLOTS:
                src = torch.empty(K * N, dtype=torch.uint8, device=dev)
                dst = torch.empty_like(src)
                tc = timer.ms(lambda: dst.copy_(src))
                print(f"  a copy of its {K * N} weight bytes: {tc:.4f} ms")
                layer["copy_ms"] += n * tc
                layer["ms"] += n * t
                layer["plain_ms"] += n * tp
                layer["bound_ms"] += n * b
            else:
                prefill["ms"] += n * t
                prefill["plain_ms"] += n * tp
                prefill["bound_ms"] += n * b
                prefill["library_ms"] += n * tl
    for M, label in ((SLOTS, "mp_matmul"), (CHUNK, "mp_matmul prefill")):
        calls = layer_args[M]
        PROFILED.append((label, "mp_matmul",
                         "by_kernel" if M == SLOTS else "prefill_by_kernel",
                         lambda calls=calls: [ops.quant_matmul(
                             *a, out_dtype=torch.float32) for a in calls],
                         ("mp_matmul",)))
    entries["mp_matmul"] = {
        "name": "mp_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/mp_matmul.cu",
        "replaces": "src/repro/kernels/mp_kernel.py:66",
        "max_abs_err": 0.0, "ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "shape": f"one decoder layer's 6 calls at M={SLOTS}",
        "weights_copy_ms": layer["copy_ms"], "floor_ms": floor_ms,
        **{f"prefill_{k}": v for k, v in prefill.items()},
        "prefill_shape": f"one decoder layer's 6 calls at M={CHUNK}; "
                         "library: torch._int_mm and the same epilogue"}
    print(f"mp_matmul one layer at M={SLOTS}: kernel {layer['ms']:.4f} ms, "
          f"plain {layer['plain_ms']:.4f} ms, bound {layer['bound_ms']:.5f} "
          f"ms; a copy of the layer's weight bytes {layer['copy_ms']:.4f} ms")
    print(f"mp_matmul one layer at M={CHUNK}: kernel {prefill['ms']:.4f} ms, "
          f"plain {prefill['plain_ms']:.4f} ms, library "
          f"{prefill['library_ms']:.4f} ms, bound "
          f"{prefill['bound_ms']:.5f} ms")

    # -- paged_mha_decode: B = slots, GPT-2 heads, max_seq 1024
    H, D = 16, 64
    q, kp, vp, bt = pool_inputs(rng, SLOTS, H, D, dev, (SLOTS, H, D))
    lengths_np = np.concatenate([[1, MAX_SEQ], rng.integers(
        2, MAX_SEQ, SLOTS - 2)]).astype(np.int32)
    lengths = torch.from_numpy(lengths_np).to(dev)
    bt = live_table(bt, lengths_np)
    dec_err, rel = rel_err(ops.paged_mha_decode(q, kp, vp, lengths, bt),
                           ref.paged_mha_decode_ref(q, kp, vp, lengths, bt))
    check(rel <= ATTN_REL_TOL, f"paged_mha_decode: rel err {rel}")
    dg = ops._decode_geometry(SLOTS, H, H, PAGE, D, MAX_SEQ // PAGE)
    dgeo = (f"geometry: {dg.splits} splits of {dg.pps} pages, "
            f"{SLOTS * H * dg.h_chunks * dg.splits} blocks, {dg.smem} B "
            f"shared, {4 * dg.scratch} B scratch")
    t = timer.ms(lambda: ops.paged_mha_decode(q, kp, vp, lengths, bt))
    tp = timer.ms(lambda: ref.paged_mha_decode_ref(q, kp, vp, lengths, bt))
    kv = ref.paged_gather_ref(kp, bt).float()
    vv = ref.paged_gather_ref(vp, bt).float()
    mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    tl = timer.ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kv, vv, attn_mask=mask))
    tot = int(lengths_np.sum())
    pages = int(sum(-(-int(n) // PAGE) for n in lengths_np))
    nbytes = (2 * tot * H * D * 2 + 2 * SLOTS * H * D * 4
              + 4 * SLOTS + 4 * pages)
    b, by = bound_ms(nbytes, 4 * tot * H * D, "bf16")
    PROFILED.append(("paged_mha_decode", "paged_mha_decode", "by_kernel",
                     lambda q=q, kp=kp, vp=vp, n=lengths, bt=bt:
                     ops.paged_mha_decode(q, kp, vp, n, bt),
                     ("decode::", "verify::combine")))
    print(f"paged_mha_decode B={SLOTS} H={H} D={D} lengths "
          f"{lengths_np.tolist()}: max abs err {dec_err:.3e} (rel {rel:.3e} "
          f"<= {ATTN_REL_TOL}); kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA "
          f"on the gathered view {tl:.4f} ms, bound {b:.5f} ms ({by}); "
          f"{dgeo}")
    entries["paged_mha_decode"] = {
        "name": "paged_mha_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_mha.cu",
        "replaces": "src/repro/kernels/paged_mha_kernel.py:92",
        "max_abs_err": dec_err, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B={SLOTS} H={H} D={D} ps={PAGE} max_seq={MAX_SEQ}",
        "geometry": dgeo}

    # -- paged_verify: one prefill chunk (B = 1, C = chunk) at base 480
    base0 = 480
    q, kp, vp, bt = pool_inputs(rng, 1, H, D, dev, (1, CHUNK, H, D))
    base = torch.tensor([base0], dtype=torch.int32, device=dev)
    bt = live_table(bt, [base0 + CHUNK])
    ver_err, rel = rel_err(ops.paged_verify(q, kp, vp, base, bt),
                           ref.paged_verify_ref(q, kp, vp, base, bt))
    check(rel <= ATTN_REL_TOL, f"paged_verify prefill chunk: rel err {rel}")
    t = timer.ms(lambda: ops.paged_verify(q, kp, vp, base, bt))
    tp = timer.ms(lambda: ref.paged_verify_ref(q, kp, vp, base, bt))
    kv = ref.paged_gather_ref(kp, bt).float()
    vv = ref.paged_gather_ref(vp, bt).float()
    qpos = base0 + torch.arange(CHUNK, device=dev)
    mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
            <= qpos[:, None])[None, None]
    qh = q.transpose(1, 2)
    tl = timer.ms(lambda: F.scaled_dot_product_attention(
        qh, kv, vv, attn_mask=mask))
    keys = base0 + CHUNK
    pairs = sum(base0 + j + 1 for j in range(CHUNK))
    nbytes = (2 * keys * H * D * 2 + 2 * CHUNK * H * D * 4 + 4
              + 4 * (keys // PAGE))
    b, by = bound_ms(nbytes, 4 * pairs * H * D, "bf16")
    geo = verify_geometry(q, kp, bt)
    PROFILED.append(("paged_verify", "paged_verify", "by_kernel",
                     lambda: ops.paged_verify(q, kp, vp, base, bt),
                     ("verify::",)))
    print(f"paged_verify B=1 C={CHUNK} base={base0}: max abs err "
          f"{ver_err:.3e} (rel {rel:.3e} <= {ATTN_REL_TOL}); kernel {t:.4f} "
          f"ms, plain {tp:.4f} ms, SDPA on the gathered view {tl:.4f} ms, "
          f"bound {b:.5f} ms ({by}); {geo}")
    entries["paged_verify"] = {
        "name": "paged_verify", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_verify.cu",
        "replaces": "src/repro/kernels/paged_verify_kernel.py:173",
        "max_abs_err": ver_err, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B=1 C={CHUNK} H={H} D={D} base={base0}",
        "geometry": geo}
    entries["paged_verify"].update(chain_verify_timing(dev, timer, rng))
    entries["paged_verify_tree"] = tree_verify_phase(dev, timer, rng)
    entries["mha_decode"] = mha_decode_phase(dev, timer, rng)
    entries["ln_res"] = ln_res_phase(dev, timer, rng)
    entries["quant_act"] = quant_act_phase(dev, timer, rng)
    return entries


def token_trees(rng, B, k, branch):
    """One ``TokenTree`` per row, grown breadth first: each node takes up
    to ``branch`` children (random tokens) until the row's node budget,
    drawn from 1..k, is spent."""
    trees = []
    for _ in range(B):
        t, frontier, n = TokenTree(), [0], int(rng.integers(1, k + 1))
        while frontier and t.n < n:
            par = frontier.pop(0)
            for _ in range(branch):
                if t.n >= n:
                    break
                frontier.append(t.add(int(rng.integers(1, 50000)), par))
        trees.append(t)
    return trees


def sdpa_verify(q, kp, vp, bt, mask):
    """The library yardstick: SDPA over the gathered view with an explicit
    (B, 1, C, S) boolean mask."""
    kv = ref.paged_gather_ref(kp, bt).float()
    vv = ref.paged_gather_ref(vp, bt).float()
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qh, kv, vv, attn_mask=mask)


def verify_bytes(B, C, H, D, keys, pages):
    """Live K/V (bf16) read once, float32 queries in and outputs out,
    bases and table entries."""
    return 2 * keys * H * D * 2 + 2 * B * C * H * D * 4 + 4 * B + 4 * pages


def chain_verify_timing(dev, timer, rng):
    """The causal verify at the chain-speculation shape: B = slots rows of
    C = k + 1 queries at bases spread over the cache."""
    H, D, C = 16, 64, CHAIN_K + 1
    q, kp, vp, bt = pool_inputs(rng, SLOTS, H, D, dev, (SLOTS, C, H, D))
    base_np = np.sort(rng.integers(16, MAX_SEQ - C, SLOTS)).astype(np.int32)
    base = torch.from_numpy(base_np).to(dev)
    bt = live_table(bt, base_np + C)
    got = ops.paged_verify(q, kp, vp, base, bt)
    want = ref.paged_verify_ref(q, kp, vp, base, bt)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= ATTN_REL_TOL, f"paged_verify chain shape: rel err {rel}")
    t = timer.ms(lambda: ops.paged_verify(q, kp, vp, base, bt))
    tp = timer.ms(lambda: ref.paged_verify_ref(q, kp, vp, base, bt))
    qpos = base[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(MAX_SEQ, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    tl = timer.ms(sdpa_verify(q, kp, vp, bt, mask))
    keys = int((base_np + C).sum())
    pairs = int(sum(b * C + C * (C + 1) // 2 for b in base_np))
    pages = int(sum(-(-int(b + C) // PAGE) for b in base_np))
    b, by = bound_ms(verify_bytes(SLOTS, C, H, D, keys, pages),
                     4 * pairs * H * D, "bf16")
    geo = verify_geometry(q, kp, bt)
    PROFILED.append(("paged_verify chain", "paged_verify",
                     "chain_by_kernel",
                     lambda: ops.paged_verify(q, kp, vp, base, bt),
                     ("verify::",)))
    print(f"paged_verify chain shape B={SLOTS} C={C} bases "
          f"{base_np.tolist()}: rel err {rel:.3e}; kernel {t:.4f} ms, plain "
          f"{tp:.4f} ms, SDPA on the gathered view {tl:.4f} ms, bound "
          f"{b:.5f} ms ({by}); {geo}")
    return {"chain_shape": f"B={SLOTS} C={C} H={H} D={D}", "chain_ms": t,
            "chain_plain_ms": tp, "chain_bound_ms": b, "chain_library_ms": tl,
            "chain_max_abs_err": err, "chain_geometry": geo}


def tree_verify_phase(dev, timer, rng):
    """The tree-masked verify at the tree run's verify shape (B = slots,
    C = k + 1, ``TokenTree`` trees of branch ``TREE_BRANCH``), held to
    its plain version and timed."""
    H, D, C = 16, 64, TREE_K + 1
    q, kp, vp, bt = pool_inputs(rng, SLOTS, H, D, dev, (SLOTS, C, H, D))
    base_np = np.sort(rng.integers(16, MAX_SEQ - C, SLOTS)).astype(np.int32)
    base = torch.from_numpy(base_np).to(dev)
    bt = live_table(bt, base_np + C)
    anc_np = tree_arrays(token_trees(rng, SLOTS, TREE_K, TREE_BRANCH),
                         TREE_K, C)[3]
    anc = torch.from_numpy(anc_np.astype(np.int32)).to(dev)
    err, rel = rel_err(ops.paged_verify(q, kp, vp, base, bt, anc=anc),
                       ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc))
    check(rel <= ATTN_REL_TOL, f"paged_verify_tree: rel err {rel}")
    t = timer.ms(lambda: ops.paged_verify(q, kp, vp, base, bt, anc=anc))
    tp = timer.ms(lambda: ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc))
    rel_pos = torch.arange(MAX_SEQ, device=dev)[None] - base[:, None]
    bits = torch.gather(anc.bool(), 2, rel_pos.clamp(0, C - 1)[:, None, :]
                        .expand(SLOTS, C, MAX_SEQ))
    mask = ((rel_pos < 0)[:, None, :]
            | (((rel_pos >= 0) & (rel_pos < C))[:, None, :] & bits))[:, None]
    tl = timer.ms(sdpa_verify(q, kp, vp, bt, mask))
    keys = int((base_np + C).sum())
    pairs = int(sum(int(b) * C for b in base_np) + anc_np.sum())
    pages = int(sum(-(-int(b + C) // PAGE) for b in base_np))
    b, by = bound_ms(verify_bytes(SLOTS, C, H, D, keys, pages)
                     + 4 * SLOTS * C * C, 4 * pairs * H * D, "bf16")
    geo = verify_geometry(q, kp, bt)
    PROFILED.append(("paged_verify_tree", "paged_verify_tree", "by_kernel",
                     lambda: ops.paged_verify(q, kp, vp, base, bt, anc=anc),
                     ("verify::",)))
    print(f"paged_verify_tree B={SLOTS} C={C} bases {base_np.tolist()}: "
          f"max abs err {err:.3e} (rel {rel:.3e} <= {ATTN_REL_TOL}); "
          f"kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA on the gathered view "
          f"with the tree mask {tl:.4f} ms, bound {b:.5f} ms ({by}); {geo}")
    return {
        "name": "paged_verify_tree", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_verify.cu",
        "replaces": "src/repro/kernels/paged_verify_kernel.py:101",
        "max_abs_err": err, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B={SLOTS} C={C} H={H} D={D} ps={PAGE} branch "
                 f"{TREE_BRANCH}", "geometry": geo}


def mha_decode_phase(dev, timer, rng):
    """The contiguous decode at the draft model's shape (B = slots,
    float32 cache: a W8A8 engine's activation dtype, in which the draft
    keeps its cache) and at the same shape with a bf16 cache, the element
    type of the stacked target's cache (``SlotCacheManager`` allocates it
    in bf16 whatever the engine's activation dtype); each held to its
    plain version and timed."""
    S, H, D, B = MAX_SEQ, 16, 64, SLOTS
    k32, v32 = (torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).to(dev) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(dev)
    lengths_np = np.array(MHA_TIMED_LENGTHS, np.int32)
    lengths = torch.from_numpy(lengths_np).to(dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    tot = int(lengths_np.sum())
    rows, worst = {}, 0.0
    for kvd in (torch.float32, torch.bfloat16):
        k, v = k32.to(kvd), v32.to(kvd)
        err, rel = rel_err(ops.mha_decode(q, k, v, lengths),
                           ref.mha_decode_ref(q, k, v, lengths))
        check(rel <= ATTN_REL_TOL, f"mha_decode kv={kvd}: rel err {rel}")
        worst = max(worst, err)
        t = timer.ms(lambda: ops.mha_decode(q, k, v, lengths))
        tp = timer.ms(lambda: ref.mha_decode_ref(q, k, v, lengths))
        qs = q[:, :, None].to(kvd)
        tl = timer.ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask))
        b, by = bound_ms(2 * tot * H * D * k.element_size()
                         + 2 * B * H * D * 4 + 4 * B, 4 * tot * H * D, "f32")
        rows[kvd] = (t, tp, tl, b, by)
        geo = ops._mha_geometry(B, H, H, S, D, k.element_size())
        print(f"mha_decode B={B} H={H} D={D} S={S} {kvd} cache, lengths "
              f"{lengths_np.tolist()} ({tot} keys): max abs err {err:.3e} "
              f"(rel {rel:.3e} <= {ATTN_REL_TOL}); kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, SDPA on the contiguous cache {tl:.4f} ms, bound "
              f"{b:.5f} ms ({by}); geometry: "
              f"{geo.splits} splits of {geo.kps} keys, "
              f"{B * H * geo.h_chunks * geo.splits} blocks, {geo.smem} B "
              f"shared, {4 * geo.scratch} B scratch")
        PROFILED.append((f"mha_decode {kvd} cache", "mha_decode",
                         "by_kernel" if kvd == torch.float32
                         else "bf16_by_kernel",
                         lambda k=k, v=v: ops.mha_decode(q, k, v, lengths),
                         ("decode::", "verify::")))
    t, tp, tl, b, by = rows[torch.float32]
    bf = rows[torch.bfloat16]
    return {
        "name": "mha_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/mha_decode.cu",
        "replaces": "src/repro/kernels/mha_kernel.py:89",
        "max_abs_err": worst, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B={B} H={H} D={D} S={S} float32 cache, {tot} keys",
        "bf16_ms": bf[0], "bf16_plain_ms": bf[1], "bf16_library_ms": bf[2],
        "bf16_bound_ms": bf[3]}


def ln_res_inputs(rng, B, D, dtype, dev, mean=0.0):
    x = torch.from_numpy(3 * rng.standard_normal((B, D)).astype(np.float32))
    res = torch.from_numpy((rng.standard_normal((B, D)) + mean).astype(
        np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(D)).astype(np.float32))
    return x.to(dev, dtype), res.to(dev, dtype), w.to(dev), b.to(dev)


def ln_res_bytes(B, D, x_bytes, r_bytes):
    """x and res read once, w and b, then y (bf16), r, y_q, scale."""
    return B * D * (x_bytes + r_bytes) + 8 * D + B * D * (2 + r_bytes + 1) \
        + 4 * B


def ln_res_phase(dev, timer, rng):
    """The Fused LN&Res kernel timed at B 8, 32 and 256 x D 1024 (float32
    x and res), beside ``F.layer_norm`` of the sum (the norm alone: no
    residual output and no quantization); each timed call's new residual
    bit-identical to the plain version's and ``y_q`` within 1."""
    timed = {}
    D = 1024
    for B in LN_TIMED:
        x, res, w, b = ln_res_inputs(rng, B, D, torch.float32, dev)
        got, want = ops.ln_res(x, res, w, b), ref.ln_res_ref(x, res, w, b)
        check(torch.equal(got[1], want[1]) and int(
            (got[2].int() - want[2].int()).abs().max()) <= 1,
            f"ln_res B={B}: r not bit-identical, or y_q beyond 1")
        t = timer.ms(lambda: ops.ln_res(x, res, w, b))
        tp = timer.ms(lambda: ref.ln_res_ref(x, res, w, b))
        tn = timer.ms(lambda: F.layer_norm(x + res, (D,), w, b))
        bnd, by = bound_ms(ln_res_bytes(B, D, 4, 4), 12 * B * D, "f32")
        timed[B] = (t, tp, tn, bnd, by)
        field = "by_kernel" if B == LN_TIMED[0] else f"B{B}_by_kernel"
        PROFILED.append((f"ln_res B={B}", "ln_res", field,
                         lambda x=x, res=res, w=w, b=b: ops.ln_res(
                             x, res, w, b), ("ln_res_kernel",)))
        print(f"ln_res B={B} D={D} float32: r bit-identical, y_q within 1; "
              f"kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, library none (F.layer_norm of the sum, the "
              f"norm alone: {tn:.4f} ms), bound {bnd:.6f} ms ({by}); "
              f"{B} blocks of {ops._LN_THREADS} threads, "
              f"{8 * ops._ln_res_chunks(D)} values a thread")
    (t, tp, tn, bnd, by) = timed[LN_TIMED[0]]
    entry = {
        "name": "ln_res", "route": "cuda",
        "source": "src/repro_torch/csrc/ln_res.cu",
        "replaces": "src/repro/kernels/ln_res_kernel.py:64",
        "max_abs_err": None, "ms": t, "plain_ms": tp, "bound_ms": bnd,
        "bound_by": by, "library_ms": None,
        "shape": f"B={LN_TIMED[0]} D={D} float32 x/res, layernorm",
        "norm_only_ms": tn}
    for B in LN_TIMED[1:]:
        big = timed[B]
        entry.update({f"B{B}_ms": big[0], f"B{B}_plain_ms": big[1],
                      f"B{B}_norm_only_ms": big[2], f"B{B}_bound_ms": big[3]})
    return entry


def quant_act_inputs(rng, M, K, dtype, dev):
    """Rows of mixed magnitudes (one all zeros) and smoothing factors
    spread log-uniformly over [1e-3, 1e3], the range ``smooth_factors``
    clamps to."""
    x = rng.standard_normal((M, K)) * rng.uniform(0.01, 50, (M, 1))
    x[M // 2] = 0.0
    s = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), K))
    return (torch.from_numpy(x.astype(np.float32)).to(dev, dtype),
            torch.from_numpy(s.astype(np.float32)).to(dev))


def quant_act_phase(dev, timer, rng):
    """The activation quantization kernel timed at ``QA_TIMED`` (float32
    x, as the W8A8 engines run) beside the plain version on the card, each
    timed call bit-identical to the plain version run on the CPU (ATen on
    the card may divide by the scalar 127 as a multiply by its
    reciprocal)."""
    cpu = torch.device("cpu")
    rows = []
    for M, K in QA_TIMED:
        x, s = quant_act_inputs(rng, M, K, torch.float32, dev)
        q, sc = ops.quant_act(x, s)
        wq, wsc = ref.quant_act_ref(x.to(cpu), s.to(cpu))
        check(torch.equal(q.cpu(), wq) and torch.equal(sc.cpu(), wsc),
              f"quant_act M={M} K={K}: not bit-identical to the plain "
              "version on the CPU")
        t = timer.ms(lambda: ops.quant_act(x, s))
        tp = timer.ms(lambda: ref.quant_act_ref(x, s))
        bnd, by = bound_ms(4 * M * K + 4 * K + M * K + 4 * M, 6 * M * K,
                           "f32")
        threads, nv = ops._quant_act_geometry(K)
        rows.append({"M": M, "K": K, "ms": t, "plain_ms": tp,
                     "bound_ms": bnd, "bound_by": by})
        field = "by_kernel" if len(rows) == 1 else f"M{M}_K{K}_by_kernel"
        PROFILED.append((f"quant_act M={M} K={K}", "quant_act", field,
                         lambda x=x, s=s: ops.quant_act(x, s),
                         ("quant_act_kernel",)))
        print(f"quant_act M={M} K={K} float32: bit-identical to the plain "
              f"version on the CPU; kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, library none, bound {bnd:.6f} ms ({by}); "
              f"{M} blocks of {threads} threads, {nv} chunks a thread")
    return {
        "name": "quant_act", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_act.cu", "replaces": None,
        "max_abs_err": 0.0, "ms": rows[0]["ms"],
        "plain_ms": rows[0]["plain_ms"], "bound_ms": rows[0]["bound_ms"],
        "bound_by": rows[0]["bound_by"], "library_ms": None,
        "shape": f"M={QA_TIMED[0][0]} K={QA_TIMED[0][1]} float32",
        "timed": rows}


def attn_row(rows, timer, kernel, label, shape, call, plain, lib, nbytes,
             ops_, keys):
    """Hold one attention call to its plain version per output vector
    (``ATTN_REL_TOL``), then time it beside its plain version, SDPA
    (``lib``) and its bound, append the row to ``rows[kernel]`` and queue
    the call for the profiler phase."""
    err, rel = rel_err(call(), plain())
    what = f"{kernel} {label} {shape}"
    check(rel <= ATTN_REL_TOL, f"{what}: rel err {rel}")
    t, tp, tl = timer.ms(call), timer.ms(plain), timer.ms(lib)
    b, by = bound_ms(nbytes, ops_, "bf16" if kernel != "mha_decode"
                     else "f32")
    r = {"model": label, "shape": shape, "max_abs_err": err,
         "max_rel_err": rel, "ms": t, "plain_ms": tp, "library_ms": tl,
         "bound_ms": b, "bound_by": by}
    rows.setdefault(kernel, []).append(r)
    PROFILED.append((f"{kernel} {label} {shape}", r, "by_kernel", call,
                     keys))
    print(f"{what}: max abs err {err:.3e} (rel {rel:.3e} <= "
          f"{ATTN_REL_TOL}); kernel {t:.4f} ms, "
          f"plain {tp:.4f} ms, SDPA {tl:.4f} ms, bound {b:.5f} ms ({by})")


def paged_rows(dev, timer, rng, rows, label, H, Hkv, D, max_seq,
               lengths_np, verifies):
    """``paged_mha_decode`` on ``len(lengths_np)`` rows of those lengths
    and ``paged_verify`` at each ``(kernel, B, C, bases)`` of
    ``verifies`` (``bases`` None: sorted random ones), over pages of
    ``PAGE`` positions in a table of ``max_seq``, through
    :func:`attn_row`."""
    gqa = H != Hkv
    n_pg = max_seq // PAGE
    B = len(lengths_np)
    q, kp, vp, bt = pool_inputs(rng, B, Hkv, D, dev, (B, H, D), max_seq)
    lengths = torch.from_numpy(lengths_np).to(dev)
    bt = live_table(bt, lengths_np)
    kv, vv = (ref.paged_gather_ref(t, bt).float() for t in (kp, vp))
    mask = (torch.arange(max_seq, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    tot = int(lengths_np.sum())
    pages = int(sum(-(-int(n) // PAGE) for n in lengths_np))
    g = ops._decode_geometry(B, H, Hkv, PAGE, D, n_pg)
    attn_row(rows, timer, "paged_mha_decode", label,
             f"B={B} {tot} keys ({g.h_chunks} head chunks of {g.hg}, "
             f"{g.splits} splits of {g.pps} pages)",
             partial(ops.paged_mha_decode, q, kp, vp, lengths, bt),
             partial(ref.paged_mha_decode_ref, q, kp, vp, lengths, bt),
             partial(F.scaled_dot_product_attention, q[:, :, None], kv, vv,
                     attn_mask=mask, enable_gqa=gqa),
             2 * tot * Hkv * D * 2 + 2 * B * H * D * 4 + 4 * B + 4 * pages,
             4 * tot * H * D, ("decode::", "verify::combine"))
    for kernel, B, C, base_np in verifies:
        q, kp, vp, bt = pool_inputs(rng, B, Hkv, D, dev, (B, C, H, D),
                                    max_seq)
        if base_np is None:
            base_np = np.sort(rng.integers(16, max_seq - C, B))
        base_np = np.asarray(base_np, np.int32)
        base = torch.from_numpy(base_np).to(dev)
        bt = live_table(bt, base_np + C)
        anc, pairs = None, int(
            sum(b * C + C * (C + 1) // 2 for b in base_np))
        if kernel == "paged_verify_tree":
            anc_np = tree_arrays(token_trees(rng, B, TREE_K, TREE_BRANCH),
                                 TREE_K, C)[3]
            anc = torch.from_numpy(anc_np.astype(np.int32)).to(dev)
            pairs = int(sum(int(b) * C for b in base_np) + anc_np.sum())
        rel_pos = torch.arange(max_seq, device=dev)[None] - base[:, None]
        if anc is None:
            mask = (rel_pos[:, None, :] <= torch.arange(
                C, device=dev)[None, :, None])[:, None]
        else:
            bits = torch.gather(anc.bool(), 2, rel_pos.clamp(0, C - 1)[
                :, None, :].expand(B, C, max_seq))
            mask = ((rel_pos < 0)[:, None, :]
                    | (((rel_pos >= 0) & (rel_pos < C))[:, None, :]
                       & bits))[:, None]
        kv, vv = (ref.paged_gather_ref(t, bt).float() for t in (kp, vp))
        qh = q.transpose(1, 2)
        keys = int((base_np + C).sum())
        pages = int(sum(-(-int(b + C) // PAGE) for b in base_np))
        nbytes = (2 * keys * Hkv * D * 2 + 2 * B * C * H * D * 4 + 4 * B
                  + 4 * pages + (0 if anc is None else 4 * B * C * C))
        g = ops._verify_geometry(B, C, H, Hkv, PAGE, D, n_pg)
        attn_row(rows, timer, kernel, label,
                 f"B={B} C={C} ({B * Hkv * g.q_tiles * g.splits * g.parts} "
                 f"blocks: {g.nq} queries a tile, {g.splits} splits)",
                 partial(ops.paged_verify, q, kp, vp, base, bt, anc=anc),
                 partial(ref.paged_verify_ref, q, kp, vp, base, bt,
                         anc=anc),
                 partial(F.scaled_dot_product_attention, qh, kv, vv,
                         attn_mask=mask, enable_gqa=gqa),
                 nbytes, 4 * pairs * H * D, ("verify::",))


def wide_heads_phase(dev, timer):
    """The three attention kernels at the RoPE family's and olmoe's heads:
    D 128 with groups 4 (``llama3-8b``: 32 heads over 8), 3
    (``minitron-4b``: 24 over 8, 15 of a verify tile's 16 rows used) and
    1 (``olmoe-1b-7b``: 16 over 16), and D 256 (``gemma-7b``: 16 over 16,
    Q staged in shared memory and P V split over two blocks in the
    verify, a float32 contiguous cache on blocks of 2 warps), each timed
    at its serving shape beside its plain version, SDPA and its bound
    (:func:`attn_row`).  Returns {kernel: [row, ...]}."""
    phase("kernel timings at the RoPE family's and olmoe's heads (D 128 "
          "groups 1, 3 and 4, D 256)")
    rng = np.random.default_rng(6)
    rows = {k: [] for k in ("paged_mha_decode", "paged_verify",
                            "paged_verify_tree", "mha_decode")}
    lengths_np = np.array(MHA_TIMED_LENGTHS, np.int32)
    tot = int(lengths_np.sum())
    for arch in WIDE_ARCHS:
        cfg = get_config(arch)
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        label = f"{arch} (H {H} / Hkv {Hkv}, D {D})"
        gqa = H != Hkv
        # decode over pages: B = slots, the rows spread over the cache;
        # verify: a prefill chunk (B 1, C 32 at base 480), a chain verify
        # (B 8, C 5) and a tree verify (B 8, C 9, branch 3)
        paged_rows(dev, timer, rng, rows, label, H, Hkv, D, MAX_SEQ,
                   lengths_np, (("paged_verify", 1, CHUNK, [480]),
                                ("paged_verify", SLOTS, CHAIN_K + 1, None),
                                ("paged_verify_tree", SLOTS, TREE_K + 1,
                                 None)))
        lengths = torch.from_numpy(lengths_np).to(dev)

        # the contiguous decode at the draft's and stacked target's shape:
        # float32 and bf16 caches
        S = MAX_SEQ
        k32, v32 = (torch.from_numpy(rng.standard_normal(
            (SLOTS, Hkv, S, D)).astype(np.float32)).to(dev)
            for _ in range(2))
        q = torch.from_numpy(rng.standard_normal((SLOTS, H, D)).astype(
            np.float32)).to(dev)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        for kvd in (torch.float32, torch.bfloat16):
            k, v = k32.to(kvd), v32.to(kvd)
            qs = q[:, :, None].to(kvd)
            w = ops._decode_warps(D, k.element_size())
            attn_row(rows, timer, "mha_decode", label,
                     f"B={SLOTS} S={S} {str(kvd).split('.')[-1]} cache, "
                     f"{tot} keys, {w} warps a block",
                     partial(ops.mha_decode, q, k, v, lengths),
                     partial(ref.mha_decode_ref, q, k, v, lengths),
                     partial(F.scaled_dot_product_attention, qs, k, v,
                             attn_mask=mask, enable_gqa=gqa),
                     2 * tot * Hkv * D * k.element_size()
                     + 2 * SLOTS * H * D * 4 + 4 * SLOTS, 4 * tot * H * D,
                     ("decode::", "verify::"))
        del k32, v32
    return rows


def family_mp_phase(dev, timer):
    """``mp_matmul`` at the RoPE family's and olmoe's widths: every (K, N)
    of a decoder layer of ``WIDE_ARCHS`` (olmoe's: q, k, v and out; its
    experts are not quantized) and the untied heads (``llama3-8b``: N
    128,256; ``minitron-4b``: 256,000; ``olmoe-1b-7b``: 50,304): one
    decoder layer's calls and the head timed as :func:`mp_rows` times
    them.  Returns the rows."""
    phase("mp_matmul at the RoPE family's and olmoe's widths")
    rng = np.random.default_rng(8)
    rows = []
    for arch in WIDE_ARCHS:
        cfg = get_config(arch)
        d = cfg.d_model
        gated = cfg.activation in ("swiglu", "geglu")
        layer = [(d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim),
                 (cfg.q_dim, d)]
        if not cfg.n_experts:  # a MoE layer's experts stay float
            layer += [(d, cfg.d_ff)] * (1 + gated) + [(cfg.d_ff, d)]
        head = [] if cfg.tie_embeddings else [(d, cfg.vocab_size)]
        for what, calls in (("one decoder layer", layer), ("head", head)):
            if calls:
                rows += mp_rows(timer, rng, arch, what, calls, dev)
    return rows


def mp_rows(timer, rng, arch, what, calls, dev):
    """``mp_matmul`` at the (K, N) of ``calls`` (one layer's, or a head),
    float32 out as in a W8A8 engine, each shape bit-identical to its plain
    version, all the calls timed together at a decode tick's rows and a
    prefill chunk's (8 and 32; beside ``torch._int_mm`` and the same
    epilogue at 32).  Returns one row per timed M."""
    f32 = torch.float32
    rows = []
    for M in (SLOTS, CHUNK):
        seen = {}
        for K, N in dict.fromkeys(calls):
            x, w, xs, ws, _ = seen[(K, N)] = mp_inputs(rng, M, K, N, dev)
            check(torch.equal(
                ops.quant_matmul(x, w, xs, ws, out_dtype=f32),
                ref.quant_matmul_ref(x, w, xs, ws, out_dtype=f32)),
                f"mp_matmul {arch} M={M} K={K} N={N}: not bit-identical")
        t = tp = b = 0.0
        for K, N in calls:
            x, w, xs, ws, _ = seen[(K, N)]
            t += timer.ms(partial(ops.quant_matmul, x, w, xs, ws,
                                  out_dtype=f32))
            tp += timer.ms(partial(ref.quant_matmul_ref, x, w, xs, ws,
                                   out_dtype=f32))
            b += bound_ms(M * K + K * N + 4 * (M + N) + 4 * M * N,
                          2 * M * K * N, "int8")[0]
        tl = None
        if M > 16:  # torch._int_mm takes M > 16 only
            tl = sum(timer.ms(partial(
                lambda x, w, xs, ws: (torch._int_mm(x, w).float() * xs) * ws,
                *seen[kn][:4])) for kn in calls)
        rows.append({"model": arch, "shape": f"{what}, {len(calls)} calls "
                     f"{sorted(set(calls))} at M={M}", "ms": t,
                     "plain_ms": tp, "library_ms": tl, "bound_ms": b,
                     "bound_by": "bytes"})
        print(f"mp_matmul {arch} {what} ({len(calls)} calls) at M={M}: "
              f"bit-identical; kernel {t:.4f} "
              f"ms, plain {tp:.4f} ms, library "
              f"{'n/a (M <= 16)' if tl is None else f'{tl:.4f}'} ms, bound "
              f"{b:.5f} ms")
    return rows


def moe_experts_phase(dev, timer):
    """The grouped experts kernel (``ops.moe_experts``) at
    olmoe-1b-7b-0924's widths, uniform random top-8 choices of a float32
    stream at ``MOE_EXPERTS_T`` tokens: held to its plain version on the
    card (a per-expert loop of cuBLAS products) within ``MOE_REL_TOL`` per
    output row and ``MOE_DIFF_SHARE`` of elements, then timed beside its
    plain version, the padded path it replaced (zero-filled scatter into
    (E, T k, d), three ``torch.bmm``, ``layers.silu``, the gather: the
    library yardstick) and its bound, the touched experts' banks read
    once.  A reduced published-form engine counts its launches for the
    ``kernels`` line.  Returns ``(entry, launches)``."""
    phase("the grouped MoE experts kernel timed (olmoe-1b-7b-0924's "
          "widths)")
    d, f, E, k = 2048, 1024, 64, 8
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    banks = [(torch.randn(shape, generator=gen, device=dev) * s).to(bf)
             for shape, s in (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5),
                              ((E, f, d), f ** -0.5))]
    silu = activation_fn("swiglu")
    rng = np.random.default_rng(30)
    rows = []
    for T in MOE_EXPERTS_T:
        x = torch.from_numpy(rng.standard_normal((T, d)).astype(
            np.float32)).to(dev)
        experts = torch.from_numpy(np.argsort(
            rng.random((T, E)), axis=1)[:, :k].astype(np.int64)).to(dev)
        C = T * k
        slots, order, offsets = moe.sort_choices(experts, E, C)
        flat_e = experts.reshape(-1)

        def call(x=x, order=order, offsets=offsets):
            return ops.moe_experts(x, order, offsets, *banks, k)

        def plain(x=x, order=order, offsets=offsets):
            return ref.moe_experts_ref(x, order, offsets, *banks, k)

        def padded(x=x, flat_e=flat_e, slots=slots, C=C):
            buf = torch.zeros((E * C, d), dtype=bf, device=dev)
            buf[flat_e * C + slots] = x.to(bf).repeat_interleave(k, dim=0)
            buf = buf.view(E, C, d)
            h = silu(torch.bmm(buf, banks[0])) * torch.bmm(buf, banks[1])
            return torch.bmm(h, banks[2])[flat_e, slots]

        got, want, lib = call(), plain(), padded()
        torch.cuda.synchronize()
        _, rel = rel_err(got, want)
        share = (got != want).float().mean().item()
        pos = order.argsort()
        lib_rel = rel_err(got[pos], lib)[1]
        lib_share = (got[pos] != lib).float().mean().item()
        lib_plain = (want[pos] != lib).float().mean().item()
        check(rel <= MOE_REL_TOL and share <= MOE_DIFF_SHARE,
              f"moe_experts T={T}: rel err {rel}, {share:.4f} of elements "
              "differ from the plain version")
        touched = int((offsets[1:] > offsets[:-1]).sum())
        t, tp, tl = timer.ms(call), timer.ms(plain), timer.ms(padded)
        nbytes = (3 * touched * d * f * 2 + 4 * T * d + 2 * C * d
                  + 2 * 2 * C * f)
        b, by = bound_ms(nbytes, 3 * 2 * C * d * f, "bf16")
        geo = ops._moe_geometry(C, E)
        r = {"T": T, "ms": t, "plain_ms": tp, "library_ms": tl,
             "bound_ms": b, "bound_by": by, "touched_experts": touched,
             "max_rel_err": rel, "share_differing": share,
             "padded_rel_err": lib_rel, "padded_share_differing": lib_share,
             "padded_vs_plain_share_differing": lib_plain, "mt": geo.mt,
             "m_tiles": geo.m_tiles}
        rows.append(r)
        field = "by_kernel" if len(rows) == 1 else f"T{T}_by_kernel"
        PROFILED.append((f"moe_experts T={T}", "moe_experts", field, call,
                         ("experts_kernel",)))
        print(f"moe_experts T={T}: rel err {rel:.3e} (<= {MOE_REL_TOL}), "
              f"{share:.4%} of elements differ, padded path rel err "
              f"{lib_rel:.3e} ({lib_share:.4%} differ; "
              f"padded vs plain {lib_plain:.4%}); kernel {t:.4f} ms, "
              f"plain {tp:.4f} ms, padded bmm + silu {tl:.4f} ms, bound "
              f"{b:.4f} ms ({by}, {touched} experts touched, "
              f"{nbytes / 1e6:.1f} MB); {geo.mt} m16 tiles a block, "
              f"{geo.m_tiles} row tiles")
    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b").reduced(), n_experts=64,
        experts_per_token=8, d_ff=32, expert_dtype="bfloat16",
        norm_topk_prob=False)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                      quantized=True, calibration_batches=calib,
                      chunk_size=16)
    for n in (5, 30, 12):
        eng.submit(([3, 4, 5] * n)[:n], max_new=6)
    ops.reset_launch_counts()
    eng.run()
    n = ops.launch_counts()["moe_experts"]
    print(f"moe_experts: {n} launches in the reduced published-form "
          f"engine's {eng.stats()['model_calls']} model calls")
    first = rows[0]
    return {
        "name": "moe_experts", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_experts.cu", "replaces": None,
        "max_abs_err": None, "max_rel_err": first["max_rel_err"],
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "shape": f"T={first['T']} d={d} f={f} E={E} k={k} float32 x",
        "timed": rows}, {"moe_experts": n}


def hybrid_kernels_phase(dev, timer):
    """The two kernels of the hybrid stacks' path at their shapes.
    ``mha_decode`` on ``recurrentgemma-9b``'s ring: 8 rows of 16 query
    heads (float32, a W8A8 engine's) over one KV head of 256 on a bf16
    ring of W = 2,048 slots, at the lengths the ring decode passes
    (``min(len, W) + 1``: W + 1 once the ring is full) and shorter ones;
    held to its plain version per output vector and timed beside its
    plain version, SDPA and its bound.  ``mp_matmul`` at every quantized
    (K, N) of a ``recurrentgemma-9b`` RG-LRU layer and local-attention
    layer (each with its GeGLU MLP) and of an ``xlstm-350m`` mLSTM layer,
    as ``mp_rows`` holds and times them.  Returns ({"mha_decode": rows,
    "mp_matmul": rows})."""
    phase("kernel timings at the hybrid stacks' shapes (recurrentgemma-9b's "
          "ring, both stacks' linears)")
    rng = np.random.default_rng(12)
    cfg = get_config("recurrentgemma-9b")
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    lengths_np = np.array([W + 1, W + 1, W, 1, 300, 1024, W - 1, 1700],
                          np.int32)
    q = torch.from_numpy(rng.standard_normal((SLOTS, H, D)).astype(
        np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((SLOTS, Hkv, W, D)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    lengths = torch.from_numpy(lengths_np).to(dev)
    call = partial(ops.mha_decode, q, k, v, lengths)
    err, rel = rel_err(call(), ref.mha_decode_ref(q, k, v, lengths))
    label = f"recurrentgemma-9b ring (H {H} / Hkv {Hkv}, D {D})"
    check(rel <= ATTN_REL_TOL, f"mha_decode {label}: rel err {rel}")
    keys = np.minimum(lengths_np, W)
    tot = int(keys.sum())
    mask = (torch.arange(W, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None].to(torch.bfloat16)
    t = timer.ms(call)
    tp = timer.ms(partial(ref.mha_decode_ref, q, k, v, lengths))
    tl = timer.ms(partial(F.scaled_dot_product_attention, qs, k, v,
                          attn_mask=mask, enable_gqa=True))
    b, by = bound_ms(2 * tot * Hkv * D * 2 + 2 * SLOTS * H * D * 4
                     + 4 * SLOTS, 4 * tot * H * D, "f32")
    shape = (f"B={SLOTS} S={W} bf16 ring, lengths {lengths_np.tolist()} "
             f"({tot} keys)")
    ring = {"model": label, "shape": shape, "max_abs_err": err,
            "max_rel_err": rel, "ms": t, "plain_ms": tp, "library_ms": tl,
            "bound_ms": b, "bound_by": by}
    PROFILED.append((f"mha_decode {label}", ring, "by_kernel", call,
                     ("decode::", "verify::")))
    print(f"mha_decode {label} {shape}: max abs err {err:.3e} (rel "
          f"{rel:.3e} <= {ATTN_REL_TOL}); kernel {t:.4f} ms, plain "
          f"{tp:.4f} ms, SDPA {tl:.4f} ms, bound {b:.5f} ms ({by})")
    del k, v
    d, w, ff = cfg.d_model, cfg.lru_width, cfg.d_ff
    mlp = [(d, ff), (d, ff), (ff, d)]
    xcfg = get_config("xlstm-350m")
    xd = xcfg.d_model
    layers = (("recurrentgemma-9b", "one RG-LRU layer",
               [(d, 2 * w), (w, d)] + mlp),
              ("recurrentgemma-9b", "one local-attention layer",
               [(d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim),
                (cfg.q_dim, d)] + mlp),
              ("xlstm-350m", "one mLSTM layer",
               [(xd, xcfg.q_dim + 2 * xcfg.kv_dim), (xd, xcfg.q_dim),
                (xcfg.q_dim, xd)]))
    mp = []
    for arch, what, calls in layers:
        mp += mp_rows(timer, rng, arch, what, calls, dev)
    return {"mha_decode": [ring], "mp_matmul": mp}


def hybrid_serving_phase(dev, arch):
    """Full-width W8A8 serving of a hybrid stack at ``HYBRID_LAYERS`` of
    its layers (``HYBRID_MAX_SEQ``):
    random weights from a seeded generator, SmoothQuant calibrated on 2 x
    128 seeded tokens, 8 slots, chunk 32, 8 requests of 64 new tokens:
    six prompts of 16-512 tokens that repeat short runs and two of
    2,100-2,400, past ``max_seq`` (window-capped stacks take any length).
    Stacked plain and stacked chain speculation (n-gram, k ``CHAIN_K``),
    each with its launch counts zeroed before and read after: the MP
    kernel at the block pattern's count per model call, the contiguous
    decode kernel once per local-attention layer and decode step, no
    paged kernel.  The chain run's streams held to the plain run's under
    the near-tie rule, logits recomputed in each run's batch shapes.  The
    model is freed at the end.  Returns each run's launch counts."""
    cfg = dataclasses.replace(get_config(arch), n_layers=HYBRID_LAYERS[arch])
    max_seq = HYBRID_MAX_SEQ[arch]
    phase(f"serving (full-width {arch} at {cfg.n_layers} layers, W8A8, "
          f"stacked plain and chain, max_seq {max_seq})")
    rng = np.random.default_rng(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    n_params = sum(t.numel() for t in _tensors(params))
    stats = calibrate(params, cfg, [rng.integers(1, cfg.vocab_size,
                                                 (2, 128))])
    qparams = quantize_model_params(params, cfg, stats)
    del params, stats
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = sum(t.numel() * t.element_size() for t in _tensors(qparams))
    kinds = [cfg.block_kind(li) for li in range(cfg.n_layers)]
    n_local = kinds.count("local_attn")
    print(f"{arch}: {cfg.n_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
          f"), d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}, window {cfg.window}, lru width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters drawn in float32 on the card, "
          f"calibrated and quantized in {time.perf_counter() - t0:.2f} s; "
          f"W8A8 model {q_bytes / 2**30:.2f} GiB; peak memory "
          f"{peak / 2**30:.2f} GiB")
    prompts = repetitive_prompts(rng, SPEC_REQUESTS - 2, cfg.vocab_size,
                                 *SPEC_PROMPT_LENS)
    prompts += repetitive_prompts(rng, 2, cfg.vocab_size, *HYBRID_LONG)
    check(max(map(len, prompts)) > max_seq and (
        n_local == 0 or max(map(len, prompts)) > cfg.window),
        f"{arch}: no prompt runs past the cache or the window")
    streams, out, sched = {}, {}, {}
    for run in ("stacked plain", "stacked chain"):
        spec = SpecConfig(k=CHAIN_K) if run.endswith("chain") else None
        eng = ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=max_seq,
                          eos_id=-1, act_dtype=torch.float32,
                          chunk_size=CHUNK, seed=0, device=dev, spec=spec)
        check(eng.kv_layout == "stacked" and eng.seq_ceiling is None,
              f"{arch}: not on the stacked layout without a ceiling")
        got, s, n, _, sched[run] = engine_run(f"{arch} {run}", eng, prompts,
                                              SPEC_NEW)
        check(len(got) == len(prompts) and all(
            0 <= t < cfg.vocab_size for o in got.values() for t in o),
            f"{arch} {run}: a request was not served, or a token lies "
            "outside the vocabulary")
        verifies = s.get("spec_ticks", 0)
        decodes = s["model_calls"] - s["prefill_calls"] - verifies
        if spec is not None:
            print(f"{arch} {run}: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{verifies} verify calls")
        print(f"{arch} {run} stats:", json.dumps(s, sort_keys=True))
        check(n["mp_matmul"] == mp_per_call(cfg) * s["model_calls"]
              and n["mha_decode"] == n_local * decodes
              and (n_local == 0 or decodes > 0)
              and n["paged_mha_decode"] == n["paged_verify"]
              == n["paged_verify_tree"] == 0
              and (spec is None or verifies > 0),
              f"{arch} {run}: launch counts {n} do not match the calls")
        streams[run], out[f"{arch} {run}"] = got, n
        del eng
        torch.cuda.empty_cache()
    shape = dict(max_seq=max_seq, chunk=CHUNK, rows=SLOTS, layout="stacked")
    hold_streams(f"{arch} stacked chain vs stacked plain on the card",
                 (streams["stacked chain"], streams["stacked plain"]),
                 prompts, tuple(served_logits(qparams, cfg, sched[run], dev,
                                              **shape)
                                for run in ("stacked chain",
                                            "stacked plain")), SPEC_NEW)
    del qparams
    torch.cuda.empty_cache()
    print(f"{arch}: freed; memory allocated now "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


def mixed_config():
    """The mixed stack served by :func:`mixed_serving_phase`."""
    return dataclasses.replace(
        get_config("recurrentgemma-9b"), name="recurrentgemma-9b-mixed",
        block_pattern=MIXED_PATTERN, n_layers=MIXED_LAYERS)


def mixed_kernels_phase(dev, timer):
    """The paged attention kernels at the mixed stack's ``attn`` layers:
    16 query heads over one KV head of 256 (group 16: the decode takes two
    head chunks of 8, the verify one query a 16-row tile, C tiles along
    the chunk), in a table of ``MIXED_MAX_SEQ`` positions: the decode of
    8 rows at ``MIXED_TIMED_LENGTHS``, a prefill chunk (B 1, C 32 at base
    2,048) and a chain verify (B 8, C 5), each held and timed as
    :func:`attn_row` does.  Returns {kernel: [row, ...]}."""
    cfg = mixed_config()
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    phase(f"kernel timings at the mixed stack's attn layers (H {H} / Hkv "
          f"{Hkv}, D {D}, max_seq {MIXED_MAX_SEQ})")
    rng = np.random.default_rng(16)
    rows = {}
    paged_rows(dev, timer, rng, rows, f"mixed (H {H} / Hkv {Hkv}, D {D})",
               H, Hkv, D, MIXED_MAX_SEQ,
               np.array(MIXED_TIMED_LENGTHS, np.int32),
               (("paged_verify", 1, CHUNK, [2048]),
                ("paged_verify", SLOTS, CHAIN_K + 1, None)))
    return rows


def mixed_serving_phase(dev):
    """Full-width W8A8 serving of the mixed stack (:func:`mixed_config`:
    two periods of global attention, local attention and RG-LRU at
    ``recurrentgemma-9b``'s widths; 6 of its 38 layers), on the per-kind
    paged layout (the ``attn`` layers' K/V on pages, the rings and states
    one row per slot) and on the stacked one.  Random weights from a
    seeded generator, SmoothQuant calibrated on 2 x 128 seeded tokens, 8
    slots, chunk 32, pages of 16, ``max_seq`` ``MIXED_MAX_SEQ``; 8
    requests of 64 new tokens, six prompts of 16-512 tokens that repeat
    short runs and two of 2,100-2,400 (the ring wraps; the ``attn``
    layers span up to 155 pages).  Runs: paged plain (the auto layout),
    paged chain (n-gram, k ``CHAIN_K``), stacked plain, stacked chain,
    each with its launch counts zeroed before and read after and checked
    against its calls; paged against stacked and chain against plain
    under the near-tie rule along each run's own calls.  Then a prefix
    pair on the paged layout (two prompts sharing a two-page head: the
    pages linked, the prompt prefilled whole) whose streams must equal
    the unshared run's, and an over-commit run on
    ``MIXED_OVERCOMMIT_PAGES`` pages that preempts at least one request
    to host and restores it, held to the paged plain run.  The model is
    freed at the end.  Returns each run's launch counts."""
    cfg = mixed_config()
    phase(f"serving (full-width mixed stack {'/'.join(MIXED_PATTERN)} at "
          f"recurrentgemma-9b's widths, {cfg.n_layers} layers, W8A8, paged "
          "and stacked)")
    rng = np.random.default_rng(9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    stats = calibrate(params, cfg, [rng.integers(1, cfg.vocab_size,
                                                 (2, 128))])
    qparams = quantize_model_params(params, cfg, stats)
    del params, stats
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    kinds = [cfg.block_kind(li) for li in range(cfg.n_layers)]
    n_attn, n_local = kinds.count("attn"), kinds.count("local_attn")
    print(f"mixed stack: {cfg.n_layers} layers ({', '.join(kinds)}), d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV head "
          f"of {cfg.head_dim}, window {cfg.window}, lru width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
          f"calibrated and quantized in {time.perf_counter() - t0:.2f} s; "
          f"peak memory {peak / 2**30:.2f} GiB")
    prompts = repetitive_prompts(rng, SPEC_REQUESTS - 2, cfg.vocab_size,
                                 *SPEC_PROMPT_LENS)
    prompts += repetitive_prompts(rng, 2, cfg.vocab_size, *HYBRID_LONG)
    check(max(map(len, prompts)) > cfg.window,
          "mixed: no prompt wraps the ring")
    shape = dict(max_seq=MIXED_MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)

    def engine(layout, **kw):
        return ServeEngine(cfg, qparams, batch_slots=SLOTS,
                           max_seq=MIXED_MAX_SEQ, eos_id=-1,
                           act_dtype=torch.float32, chunk_size=CHUNK,
                           page_size=PAGE, seed=0, device=dev,
                           kv_layout=layout, **kw)

    streams, out, fns = {}, {}, {}
    for run in ("paged plain", "paged chain", "stacked plain",
                "stacked chain"):
        layout, variant = run.split()
        spec = SpecConfig(k=CHAIN_K) if variant == "chain" else None
        eng = engine("auto" if run == "paged plain" else layout, spec=spec)
        check(eng.kv_layout == layout and eng.seq_ceiling == MIXED_MAX_SEQ,
              f"mixed {run}: layout {eng.kv_layout}, ceiling "
              f"{eng.seq_ceiling}")
        got, s, n, _, sched = engine_run(f"mixed {run}", eng, prompts,
                                         SPEC_NEW)
        check(len(got) == len(prompts) and all(
            0 <= t < cfg.vocab_size for o in got.values() for t in o),
            f"mixed {run}: a request was not served, or a token lies "
            "outside the vocabulary")
        verifies = s.get("spec_ticks", 0)
        decodes = s["model_calls"] - s["prefill_calls"] - verifies
        if spec is not None:
            print(f"mixed {run}: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{verifies} verify calls")
        print(f"mixed {run} stats:", json.dumps(s, sort_keys=True))
        if layout == "paged":
            ok = (n["paged_verify"] == n_attn * (s["prefill_calls"]
                                                 + verifies)
                  and n["paged_mha_decode"] == n_attn * decodes > 0
                  and n["mha_decode"] == n_local * decodes
                  and s["pages_in_use"] == 0)
        else:
            ok = (n["mha_decode"] == (n_attn + n_local) * decodes > 0
                  and n["paged_mha_decode"] == n["paged_verify"] == 0
                  and s["slots_in_use"] == 0)
        check(ok and n["paged_verify_tree"] == 0
              and n["mp_matmul"] == mp_per_call(cfg) * s["model_calls"]
              and (spec is None or verifies > 0),
              f"mixed {run}: launch counts {n} do not match the calls")
        streams[run], out[f"mixed {run}"] = got, n
        fns[run] = served_logits(qparams, cfg, sched, dev, layout=layout,
                                 **shape)
        del eng
        torch.cuda.empty_cache()
    for a, b in (("stacked plain", "paged plain"),
                 ("paged chain", "paged plain"),
                 ("stacked chain", "paged chain")):
        hold_streams(f"mixed {a} vs {b} on the card",
                     (streams[a], streams[b]), prompts, (fns[a], fns[b]),
                     SPEC_NEW)

    # prefix sharing: the pages linked, the slot-resident state prefilled
    # again from position 0, the streams the unshared run's
    head = rng.integers(1, cfg.vocab_size, 2 * PAGE).tolist()
    pair = [head + rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (5, 9)]
    shared = {}
    for sharing in (True, False):
        eng = engine("paged", prefix_sharing=sharing)
        got, s, n, _, _ = engine_run(
            f"mixed prefix pair, sharing {sharing}", eng, pair, SPEC_NEW)
        shared[sharing] = (got, s)
        if sharing:
            out["mixed prefix pair"] = n
        del eng
    (got, s), (want, ws) = shared[True], shared[False]
    print(f"mixed prefix pair: prefix_hit_pages {s['prefix_hit_pages']}, "
          f"pages allocated {s['pages_allocated_total']} (unshared "
          f"{ws['pages_allocated_total']}), prefill calls "
          f"{s['prefill_calls']} ({ws['prefill_calls']}); streams equal: "
          f"{got == want}")
    check(s["prefix_hit_pages"] == 2 and s["pages_allocated_total"]
          < ws["pages_allocated_total"]
          and s["prefill_calls"] == ws["prefill_calls"] and got == want,
          "mixed prefix pair: pages not linked, or the streams differ from "
          "the unshared run's")

    # over-commit: a pool that holds the longest prompt but not every
    # request's growth; one decoding request is preempted to host if the
    # pool has not forced it by then
    eng = engine("paged", n_pages=MIXED_OVERCOMMIT_PAGES,
                 admission=OvercommitAdmission(cfg, chunk_size=CHUNK))
    check(max(-(-len(p) // PAGE) for p in prompts)
          < MIXED_OVERCOMMIT_PAGES - 1 < sum(-(-(len(p) + SPEC_NEW) // PAGE)
                                             for p in prompts),
          "mixed over-commit: the pool does not hold the longest prompt, or "
          "holds every request")

    def drive(e):
        for _ in range(2000):
            if e.preempt_host or not (
                    e.queue or any(r is not None for r in e.slots)):
                return
            e.tick()
            dec = [r for r in e.slots if r is not None and r.state == DECODE
                   and len(r.out) >= 4]
            if dec and not e.preempt_host:
                e._preempt(dec[-1], "host")

    got, s, n, _, sched = engine_run("mixed over-commit", eng, prompts,
                                     SPEC_NEW, drive=drive)
    print(f"mixed over-commit: preemptions {s['preemptions']} (host "
          f"{s['preempt_host']}, recompute {s['preempt_recompute']}), "
          f"restores {s['restores']}, evicted {s['evicted_bytes_total']:,.0f}"
          f" B, pages in use peak {s['pages_in_use_peak']}, now "
          f"{s['pages_in_use']}")
    check(s["preempt_host"] >= 1 and s["restores"] >= 1
          and s["pages_in_use"] == 0 and sorted(got) == list(
              range(len(prompts))),
          "mixed over-commit: no host preemption and restore, pages left, "
          "or a request not served")
    out["mixed over-commit"] = n
    hold_streams("mixed over-commit vs paged plain on the card",
                 (got, streams["paged plain"]), prompts,
                 (served_logits(qparams, cfg, sched, dev, **shape),
                  fns["paged plain"]), SPEC_NEW)
    del eng, qparams, fns
    torch.cuda.empty_cache()
    print(f"mixed stack: freed; memory allocated now "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


def family_serving_phase(dev, arch):
    """Full-width W8A8 serving of a RoPE dense or MoE config (whose router
    and float32 expert banks stay unquantized): random weights from
    a seeded generator, SmoothQuant calibrated on 2 x 128 seeded tokens,
    the engine settings of phase 4, 8 requests of 64 new tokens on prompts
    of 16-512 tokens that repeat short runs.  The runs of
    ``FAMILY_RUNS[arch]`` (paged plain; paged chain speculation, n-gram,
    k ``CHAIN_K``; stacked plain), each with its launch counts zeroed
    before and read after and checked against its calls; every other
    run's streams held to the paged plain run's under the near-tie rule,
    the logits recomputed in the batch shapes of each run.  The model is
    freed at the end.  Depth is cut to ``FAMILY_LAYERS[arch]`` layers;
    every width is the config's.  Returns each run's launch counts."""
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=FAMILY_LAYERS[arch])
    phase(f"serving (full-width {arch} at {cfg.n_layers} layers, W8A8, "
          f"{', '.join(FAMILY_RUNS[arch])})")
    rng = np.random.default_rng(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    extras = ({"patches": rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
        if cfg.frontend_tokens else None)
    stats = calibrate(params, cfg, [rng.integers(1, cfg.vocab_size,
                                                 (2, 128))], extras=extras)
    qparams = quantize_model_params(params, cfg, stats)
    del params, stats
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = sum(t.numel() * t.element_size()
                  for t in _tensors(qparams))
    experts = (f" in each of {cfg.n_experts} experts, top "
               f"{cfg.experts_per_token}" if cfg.n_experts else "")
    print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}{experts} ({cfg.activation}), vocab {cfg.vocab_size}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'} head, rope theta "
          f"{cfg.rope_theta:g}: random float32 weights calibrated and "
          f"quantized in {time.perf_counter() - t0:.2f} s; W8A8 model "
          f"{q_bytes / 2**30:.2f} GiB; peak memory {peak / 2**30:.2f} GiB")
    prompts = repetitive_prompts(rng, SPEC_REQUESTS, cfg.vocab_size,
                                 *SPEC_PROMPT_LENS)
    L = cfg.n_layers
    streams, out, sched = {}, {}, {}
    if cfg.frontend_tokens:
        out[f"{arch} batch_prefill"] = pixtral_prefill_check(qparams, cfg,
                                                             dev, rng)
    for run in FAMILY_RUNS[arch]:
        layout, variant = run.split()
        spec = SpecConfig(k=CHAIN_K) if variant == "chain" else None
        eng = w8a8_engine(cfg, qparams, dev, kv_layout=layout, spec=spec)
        got, s, n, _, sched[run] = engine_run(f"{arch} {run}", eng, prompts,
                                              SPEC_NEW)
        check(len(got) == len(prompts), f"{arch} {run}: a request was not "
              "served")
        check(all(0 <= t < cfg.vocab_size for o in got.values() for t in o),
              f"{arch} {run}: a token outside the vocabulary")
        verifies = s.get("spec_ticks", 0)
        decodes = s["model_calls"] - s["prefill_calls"] - verifies
        if spec is not None:
            print(f"{arch} {run}: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{verifies} verify calls")
        print(f"{arch} {run} stats:", json.dumps(s, sort_keys=True))
        if layout == "paged":
            ok = (n["paged_verify"] == L * (s["prefill_calls"] + verifies)
                  and n["paged_mha_decode"] == L * decodes > 0
                  and n["mha_decode"] == n["paged_verify_tree"] == 0)
        else:
            ok = (n["mha_decode"] == L * decodes > 0
                  and n["paged_mha_decode"] == n["paged_verify"]
                  == n["paged_verify_tree"] == 0)
        check(ok and n["mp_matmul"] == mp_per_call(cfg) * s["model_calls"]
              and (spec is None or verifies > 0),
              f"{arch} {run}: launch counts {n} do not match the calls")
        streams[run], out[f"{arch} {run}"] = got, n
        del eng
        torch.cuda.empty_cache()
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)
    fb = served_logits(qparams, cfg, sched["paged plain"], dev, **shape)
    for run in FAMILY_RUNS[arch][1:]:
        fa = served_logits(qparams, cfg, sched[run], dev,
                           layout=run.split()[0], **shape)
        hold_streams(f"{arch} {run} vs paged plain on the card",
                     (streams[run], streams["paged plain"]), prompts,
                     (fa, fb), SPEC_NEW,
                     moe_cfg=cfg if cfg.n_experts else None)
    del qparams
    torch.cuda.empty_cache()
    print(f"{arch}: freed; memory allocated now "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def by_kernel_phase(dev, entries):
    """The device time of each CUDA function of the profiled calls (one
    layer's six ``mp_matmul`` calls at M 8 and 32, the timed decodes, the
    three timed verify shapes and the timed ``ln_res`` calls), from
    ``torch.profiler``.  It runs
    after every serving phase: once the profiler has run, kernel launches
    in the same process stay slower, which would move the host-bound
    serving numbers (PERF.md)."""
    phase("CUDA functions of the timed calls (torch.profiler)")
    timer = Timer(dev)
    for label, name, field, fn, keys in PROFILED:
        split = timer.by_kernel(fn, keys)
        print(f"{label}: {split}")
        # a kernel's entry by name, or a row of the wide-heads phase
        (name if isinstance(name, dict) else entries[name])[field] = split


def held_out_loss(params, cfg, batch) -> float:
    with torch.no_grad():
        return float(lm.loss_fn(params, cfg, batch)[0])


def same_state(a, b) -> bool:
    """Every leaf of two train states bit-identical."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def train_xdev_check(cfg, tcfg, dev):
    """One train step at full width from the same state on the card and
    on the CPU (plain PyTorch on both): loss and global grad norm."""
    gen = torch.Generator(device=dev).manual_seed(1)
    state = init_train_state(cfg, tcfg, gen, max_seq=MAX_SEQ, device=dev)
    B, S = TRAIN_XDEV_SHAPE
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=5).batch_at(0)
    step = make_train_step(cfg, tcfg)
    # the step updates its state in place: the CPU's copy comes first
    states = {"card": state,
              "CPU": tree_map(lambda t: t.to("cpu", copy=True), state)}
    del state
    out = {}
    for side, d in (("card", dev), ("CPU", torch.device("cpu"))):
        t0 = time.perf_counter()
        _, m = step(states.pop(side), batch_to_tensors(batch, d))
        out[side] = {k: float(v) for k, v in m.items()}
        print(f"one step at {B} x {S} on the {side}: loss "
              f"{out[side]['loss']:.6f}, grad norm "
              f"{out[side]['grad_norm']:.6f} "
              f"({time.perf_counter() - t0:.2f} s)")
    card, cpu = out["card"], out["CPU"]
    for key, tol in (("loss", TRAIN_LOSS_RTOL),
                     ("grad_norm", TRAIN_GNORM_RTOL)):
        rel = abs(card[key] - cpu[key]) / abs(cpu[key])
        check(np.isfinite(card[key]) and rel <= tol,
              f"training card vs CPU: {key} {card[key]} vs {cpu[key]} "
              f"(rel {rel:.3e} > {tol})")
        print(f"card vs CPU {key}: rel {rel:.3e} <= {tol}")


def training_phase(dev):
    """Train full-width GPT-2 345M through ``Trainer``, restore and resume
    its checkpoints bit for bit, and serve the trained checkpoint on the
    W8A8 kernels.  Returns the checkpoint-served run's launch counts."""
    phase(f"training (full-width {TRAIN_ARCH}, float32 masters, bf16 "
          f"activations, {TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens)")
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=TRAIN_STEPS))
    train_xdev_check(cfg, tcfg, dev)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    held = batch_to_tensors(data.batch_at(TRAIN_HELD_OUT_STEP), dev)
    ckpt_dir = os.path.join(OUT_DIR, "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(every):
        return Trainer(cfg, tcfg, data, ckpt_dir, max_seq=MAX_SEQ,
                       ckpt_every=every, device=dev)

    try:
        # the embedding's backward accumulates with atomics on the card;
        # deterministic algorithms make a run repeatable bit for bit
        torch.use_deterministic_algorithms(True)
        tr = trainer(TRAIN_CKPT_EVERY)
        tr.init_or_restore()
        before = held_out_loss(tr.state.params, cfg, held)
        steps = []
        step_fn = tr.step_fn

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            m = {k: float(v) for k, v in m.items()}
            steps.append((time.perf_counter() - t0, m))
            return state, m

        tr.step_fn = timed
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run(TRAIN_STEPS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = held_out_loss(tr.state.params, cfg, held)
        ms = 1e3 * float(np.median([t for t, _ in steps]))
        check(len(steps) == TRAIN_STEPS, f"training: {len(steps)} steps")
        check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                  for _, m in steps), "training: a non-finite loss or grad "
              "norm")
        print(f"{TRAIN_STEPS} steps in {wall:.2f} s (checkpoints included): "
              f"median step {ms:.1f} ms, "
              f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; peak "
              f"memory {peak / 2**30:.2f} GiB")
        print(f"loss at step 1 {steps[0][1]['loss']:.4f}, at step "
              f"{TRAIN_STEPS} {steps[-1][1]['loss']:.4f}; grad norm "
              f"{steps[0][1]['grad_norm']:.3f} -> "
              f"{steps[-1][1]['grad_norm']:.3f}; held-out loss "
              f"{before:.4f} -> {after:.4f}; events {tr.events}")
        check(np.isfinite(after) and after < before,
              f"training: held-out loss did not fall ({before} -> {after})")

        fresh = trainer(10 * TRAIN_STEPS)
        check(fresh.init_or_restore() == TRAIN_STEPS,
              "training: the last checkpoint was not restored")
        check(same_state(fresh.state, tr.state),
              "training: the restored state differs from the trained one")
        restored = fresh.state.params
        del fresh
        print(f"restored step {TRAIN_STEPS}: every leaf bit-identical")
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{TRAIN_STEPS}"))
        resumed = trainer(10 * TRAIN_STEPS)
        check(resumed.init_or_restore() == TRAIN_CKPT_EVERY,
              f"training: step {TRAIN_CKPT_EVERY} was not restored")
        resumed.run(TRAIN_STEPS)
        check(same_state(resumed.state, tr.state),
              f"training: resuming at step {TRAIN_CKPT_EVERY} does not "
              "reproduce the uninterrupted run")
        del resumed
        print(f"resumed at step {TRAIN_CKPT_EVERY} to {TRAIN_STEPS} under "
              "deterministic algorithms: bit-identical to the uninterrupted "
              "run")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the trained checkpoint, served on the W8A8 kernels, against the
    # in-memory trained params
    rng = np.random.default_rng(9)
    calib = [rng.integers(1, cfg.vocab_size, (2, 128))]
    tokens = SyntheticLM(cfg.vocab_size, TRAIN_SERVE_PROMPT_LENS[1], SLOTS,
                         seed=0).batch_at(TRAIN_HELD_OUT_STEP + 1)["tokens"]
    lens = np.linspace(*TRAIN_SERVE_PROMPT_LENS, SLOTS).astype(int)
    prompts = [tokens[i, :n].tolist() for i, n in enumerate(lens)]
    runs = {}
    for label, params in (("trained checkpoint", restored),
                          ("trained in memory", tr.state.params)):
        eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                          eos_id=-1, quantized=True,
                          calibration_batches=calib, chunk_size=CHUNK,
                          page_size=PAGE, seed=0, device=dev)
        streams, s, launches, _, _ = engine_run(
            f"{TRAIN_ARCH} {label}", eng, prompts, TRAIN_SERVE_NEW)
        L = cfg.n_layers
        decode_steps = s["model_calls"] - s["prefill_calls"]
        check(launches["mp_matmul"] == 6 * L * s["model_calls"]
              and launches["paged_verify"] == L * s["prefill_calls"] > 0
              and launches["paged_mha_decode"] == L * decode_steps > 0,
              f"{label}: launch counts {launches} do not match the calls")
        runs[label] = (streams, launches)
        del eng
    (a, launches), (b, _) = runs.values()
    check(a == b, "training: the checkpoint serves other streams than the "
          "in-memory trained params")
    print(f"the checkpoint's {len(a)} streams equal the in-memory params' "
          f"(first: {a[min(a)][:8]}...)")
    return launches


def mdk_program_phase(dev, qparams, cfg):
    """Walk the ``ln_res`` stages of the per-token stage program
    (``l{i}.ln1``, ``l{i}.ln2``, ``final_ln``) through
    ``MDK_REGISTRY["ln_res"]``, with each stage's LayerNorm weight and
    bias from the full-width parameters, at a decode tick's rows and a
    prefill chunk's.  Returns the kernel's launches in this walk: no model
    code calls it."""
    phase("MDK program (ln_res stages through MDK_REGISTRY, full width)")
    stages = [st for st in scheduler.model_program(cfg)
              if st.kernel == "ln_res"]
    check(len(stages) == 2 * cfg.n_layers + 1,
          f"MDK program: {len(stages)} ln_res stages")
    fn = MDK_REGISTRY["ln_res"]
    check(fn is ops.ln_res, "MDK_REGISTRY['ln_res'] is not ops.ln_res")

    def norm_params(name):
        if name == "final_ln":
            return qparams["final_ln"]
        li, which = name[1:].split(".")
        return qparams["layers"][int(li)][which]

    rng = np.random.default_rng(5)
    calls = 0
    ops.reset_launch_counts()
    for rows in (SLOTS, CHUNK):
        for st in stages:
            x, res, _, _ = ln_res_inputs(rng, rows, cfg.d_model,
                                         torch.float32, dev)
            p = norm_params(st.name)
            fn(x, res, p["w"], p.get("b"), kind=cfg.norm)
            calls += 1
    torch.cuda.synchronize()
    launches = ops.launch_counts()["ln_res"]
    check(launches == calls, f"MDK program: {launches} ln_res launches "
          f"for {calls} stage calls")
    print(f"MDK program: {len(stages)} ln_res stages ({stages[0].name} .. "
          f"{stages[-1].name}) x rows ({SLOTS}, {CHUNK}) through "
          f"MDK_REGISTRY['ln_res']: {launches} launches")
    return launches


def serving_phase(dev):
    phase("serving (full-width gpt2-345m, W8A8, paged, chunked prefill)")
    cfg = get_config("gpt2-345m")
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, max_seq=MAX_SEQ, device=dev)
    calib = [rng.integers(1, cfg.vocab_size, (2, 128))]
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                      eos_id=-1, quantized=True, calibration_batches=calib,
                      chunk_size=CHUNK, page_size=PAGE, seed=0, device=dev)
    del params
    print(f"engine built (calibration + quantization) in "
          f"{time.perf_counter() - t0:.2f} s")
    n_req, max_new = 16, 64
    lens = np.linspace(16, 512, n_req).astype(int)
    for n in rng.permutation(lens):
        eng.submit(rng.integers(1, cfg.vocab_size, int(n)).tolist(),
                   max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = eng.stats()
    toks = sum(len(r.out) for r in done)
    check(len(done) == n_req and all(len(r.out) == max_new for r in done),
          "serving: not every request produced its tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "serving: a token outside the vocabulary")
    decode_steps = s["model_calls"] - s["prefill_calls"]
    print(f"served {n_req} requests ({int(lens.sum())} prompt tokens, "
          f"{toks} new) in {wall:.3f} s: {toks / wall:.1f} tok/s; "
          f"{s['prefill_calls']} prefill chunks, {decode_steps} decode steps")
    print(f"TTFT p50 {s['p50_ttft_s'] * 1e3:.1f} ms p99 "
          f"{s['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{s['p50_tpot_s'] * 1e3:.2f} ms p99 {s['p99_tpot_s'] * 1e3:.2f} "
          f"ms; tick p50 {s['tick_p50_ms']:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: {json.dumps(launches)} (per prefill chunk / decode "
          f"step: mp {launches['mp_matmul'] / s['model_calls']:.0f}, verify "
          f"{launches['paged_verify'] / max(s['prefill_calls'], 1):.0f}, "
          f"decode {launches['paged_mha_decode'] / max(decode_steps, 1):.0f})")
    print("engine stats:", json.dumps(s, sort_keys=True))
    for name in ("mp_matmul", "paged_mha_decode", "paged_verify"):
        check(launches[name] > 0, f"serving: kernel {name} was never "
              "launched")
    check(launches["paged_verify_tree"] == launches["mha_decode"] == 0,
          "serving: plain decode launched a speculative path's kernel")
    L = cfg.n_layers
    check(launches["mp_matmul"] == 6 * L * s["model_calls"]
          and launches["paged_verify"] == L * s["prefill_calls"]
          and launches["paged_mha_decode"] == L * decode_steps,
          f"serving: launch counts {launches} do not match the calls")

    # full-width logits, card (kernels) against CPU (plain versions)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, 64))
    logits = []  # [card, CPU]
    for d in (dev, torch.device("cpu")):
        p = eng.params if d == dev else to_device(eng.params, d)
        cache = lm.init_cache(cfg, 1 + MAX_SEQ // PAGE, PAGE, device=d)
        bt = torch.arange(1, 1 + MAX_SEQ // PAGE, dtype=torch.int32,
                          device=d)
        lg0, cache = lm.prefill_into_slot(p, cfg, prompt.to(d), cache, 0,
                                          block_table=bt,
                                          dtype=torch.float32)
        tok = lg0.argmax().reshape(1, 1)
        lg1, _ = lm.decode_step(
            p, cfg, tok, cache, torch.tensor([64], dtype=torch.int32,
                                             device=d),
            block_table=bt[None], dtype=torch.float32)
        logits.append((lg0.float().cpu(), lg1[0].float().cpu()))
    for i, what in enumerate(("prefill", "decode")):
        a, b = logits[0][i], logits[1][i]
        check(a.shape == (cfg.vocab_size,) and bool(torch.isfinite(a).all()),
              f"full-width {what} logits: shape {tuple(a.shape)} or "
              "non-finite")
        err, rel = rel_err(a, b)
        check(rel <= LOGIT_REL_TOL,
              f"full-width {what} logits card vs CPU: rel err {rel}")
        print(f"full-width {what} logits card vs CPU: max abs err "
              f"{err:.3e} (rel {rel:.3e} <= {LOGIT_REL_TOL}); argmax "
              f"{int(a.argmax())} vs {int(b.argmax())}")
    return launches, eng.params, cfg


def repetitive_prompts(rng, n, vocab, lo, hi):
    """Prompts that repeat a short run of tokens (2 to 8 long) after a
    distinct first token, so the n-gram proposer finds matches and no two
    prompts share a prefix page."""
    out = []
    for first, length in zip(rng.permutation(vocab - 1)[:n] + 1,
                              np.linspace(lo, hi, n).astype(int)):
        run = rng.integers(1, vocab, int(rng.integers(2, 9))).tolist()
        out.append([int(first)] + (run * length)[:length - 1])
    return out


def engine_run(label, eng, prompts, max_new, *, drive=None):
    """Submit ``prompts``, zero the launch counters and the peak-memory
    mark, then run the engine to the end (``drive(eng)`` ticks it first,
    for runs that preempt or cancel on the way) under a
    :class:`ScheduleProbe`.  Prints tokens/s, TTFT and TPOT; returns
    (rid -> tokens, stats, launches, peak bytes, rid -> the calls that
    served it)."""
    for p in prompts:
        eng.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    probe_cls = (DistScheduleProbe if isinstance(eng, DistributedServeEngine)
                 else ScheduleProbe)
    with probe_cls(eng) as probe:
        if drive is not None:
            drive(eng)
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = eng.stats()
    toks = sum(len(r.out) for r in done)
    check(all(len(r.out) == max_new for r in done),
          f"{label}: a request did not produce its tokens")
    print(f"{label}: {len(done)} requests ({sum(map(len, prompts))} prompt "
          f"tokens submitted, {toks} new) in {wall:.3f} s: "
          f"{toks / wall:.1f} tok/s; TTFT p50 {s['p50_ttft_s'] * 1e3:.1f} ms "
          f"p99 {s['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{s['p50_tpot_s'] * 1e3:.2f} ms p99 {s['p99_tpot_s'] * 1e3:.2f} "
          f"ms; tokens per model call "
          f"{toks / max(s['model_calls'], 1):.3f}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{label} launches: {json.dumps(launches)}")
    return ({r.rid: r.out for r in done}, s, launches,
            torch.cuda.max_memory_allocated(), probe.calls)


def w8a8_engine(cfg, qparams, dev, **kw):
    """An engine on the W8A8 weights of phase 4, run as a W8A8 engine runs
    them (float32 activations), at the serving shapes."""
    return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=MAX_SEQ,
                       eos_id=-1, act_dtype=torch.float32, chunk_size=CHUNK,
                       page_size=PAGE, seed=0, device=dev, **kw)


def spec_serving_phase(dev, qparams, cfg):
    """Phase 6: full-width speculative serving, chain + n-gram and tree +
    draft model, each held against plain decode of the same prompts on
    the card.  Returns each run's launch counts, and the chain run's
    prompts and (spec, plain) streams."""
    phase("speculative serving (full-width gpt2-345m, W8A8, paged)")
    rng = np.random.default_rng(3)
    n_req, max_new, (lo, hi) = SPEC_REQUESTS, SPEC_NEW, SPEC_PROMPT_LENS
    fp = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                 max_seq=MAX_SEQ, device=dev)
    draft = serve.noisy_copy(fp, 11, DRAFT_SIGMA)
    del fp
    runs = {
        "chain": (SpecConfig(k=CHAIN_K),
                  repetitive_prompts(rng, n_req, cfg.vocab_size, lo, hi)),
        "tree": (SpecConfig(k=TREE_K, proposer="model", draft_cfg=cfg,
                            draft_params=draft, tree=True,
                            branch=TREE_BRANCH),
                 [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                  for n in np.linspace(lo, hi, n_req)]),
    }
    L = cfg.n_layers
    out, kept = {}, {}
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)
    for name, (spec, prompts) in runs.items():
        streams, fns = [], []
        for sp in (spec, None):
            label = f"{name} spec" if sp is not None else f"{name} plain"
            got, s, launches, _, sched = engine_run(
                label, w8a8_engine(cfg, qparams, dev, spec=sp), prompts,
                max_new)
            check(len(got) == n_req, f"{label}: a request was not served")
            streams.append(got)
            fns.append(served_logits(qparams, cfg, sched, dev, **shape))
            if sp is None:
                continue
            print(f"{label}: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{s['spec_ticks']} verify calls, tokens per verify "
                  f"{s['tokens_per_verify_call']:.3f}, draft calls "
                  f"{s['draft_calls']}, tick p50 {s['tick_p50_ms']:.2f} ms")
            print(f"{label} stats:", json.dumps(s, sort_keys=True))
            need = ["mp_matmul", "paged_verify"]
            if spec.tree:
                need += ["paged_verify_tree", "mha_decode"]
            for k in need:
                check(launches[k] > 0, f"spec {name}: kernel {k} was never "
                      "launched")
            verifies = 0 if spec.tree else s["spec_ticks"]
            decodes = s["model_calls"] - s["prefill_calls"] - s["spec_ticks"]
            check(launches["mp_matmul"] == 6 * L * s["model_calls"]
                  and launches["paged_verify"]
                  == L * (s["prefill_calls"] + verifies)
                  and launches["paged_verify_tree"]
                  == (L * s["spec_ticks"] if spec.tree else 0)
                  and launches["paged_mha_decode"] == L * decodes,
                  f"spec {name}: launch counts {launches} do not match "
                  "the calls")
            out[name] = launches
        hold_streams(f"{name} spec vs plain on the card", streams, prompts,
                     fns, max_new)
        kept[name] = (prompts, streams, fns)
    del draft
    return out, kept["chain"]


def stacked_phase(dev, qparams, cfg, prompts, paged_streams, paged_fns):
    """Full-width W8A8 serving on the stacked layout (one contiguous
    ``max_seq`` region per slot; decode through the contiguous decode
    kernel, chunks in plain PyTorch), plainly and with chain speculation
    (n-gram, k ``CHAIN_K``) on phase 6's chain prompts.  Each run's
    streams are held against the paged run of the same prompts and
    variant from phase 6 under the near-tie rule.  Returns each run's
    launch counts."""
    phase("stacked serving (full-width gpt2-345m, W8A8, stacked cache)")
    L, max_new = cfg.n_layers, SPEC_NEW
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)
    out = {}
    for name, spec, paged, fb in (
            ("plain", None, paged_streams[1], paged_fns[1]),
            ("chain", SpecConfig(k=CHAIN_K), paged_streams[0],
             paged_fns[0])):
        eng = w8a8_engine(cfg, qparams, dev, kv_layout="stacked", spec=spec)
        check(eng.kv_layout == "stacked", "stacked: wrong layout")
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in eng.kv.cache["layers"] for t in c.values())
        got, s, launches, peak, sched = engine_run(
            f"stacked {name}", eng, prompts, max_new)
        check(len(got) == len(prompts), f"stacked {name}: a request was "
              "not served")
        decodes = s["model_calls"] - s["prefill_calls"] - s.get(
            "spec_ticks", 0)
        print(f"stacked {name}: target decode steps {decodes}, mha_decode "
              f"launches {launches['mha_decode']}; stacked cache "
              f"{cache_bytes / 2**30:.3f} GiB "
              f"({cache_bytes:,} B) within the peak {peak / 2**30:.3f} GiB")
        check(peak >= cache_bytes, f"stacked {name}: peak below the cache")
        check(launches["mp_matmul"] == 6 * L * s["model_calls"]
              and launches["mha_decode"] == L * decodes
              and (decodes > 0 or spec is not None)
              and launches["paged_mha_decode"] == launches["paged_verify"]
              == launches["paged_verify_tree"] == 0,
              f"stacked {name}: launch counts {launches} do not match the "
              "calls")
        check(s["slots_in_use"] == 0 and s["slots_in_use_peak"] == SLOTS,
              f"stacked {name}: slots in use {s['slots_in_use']}")
        if spec is not None:
            print(f"stacked chain: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{s['spec_ticks']} verify calls")
        print(f"stacked {name} stats:", json.dumps(s, sort_keys=True))
        fa = served_logits(qparams, cfg, sched, dev, layout="stacked",
                           **shape)
        hold_streams(f"stacked {name} vs paged {name} on the card",
                     (got, paged), prompts, (fa, fb), max_new)
        out[f"stacked {name}"] = launches
    return out


def overcommit_phase(dev, qparams, cfg):
    """Full-width W8A8 paged serving under ``OvercommitAdmission`` on a
    pool of ``OVERCOMMIT_PAGES`` pages that holds every prompt but not
    the requests' reservations together.  At least one preemption to host
    and one by recompute happen (forced through ``_preempt`` when the
    policy has not picked that mode by then), one queued and one seated
    request are cancelled, and ``pages_in_use`` drains to 0.  Streams are
    held against an uninterrupted run of the same prompts (reservation
    admission on a full pool): equal up to where a pair parts, each
    parting a near-tie between the uninterrupted computation and the one
    the resumed request took (a recompute prefills ``prompt + out[:-1]``
    in chunks where the uninterrupted run decoded it).  Returns the
    over-commit run's launch counts."""
    phase("over-commit and preemption (full-width gpt2-345m, W8A8, paged)")
    rng = np.random.default_rng(4)
    n_req, max_new = SPEC_REQUESTS, SPEC_NEW
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in np.linspace(*SPEC_PROMPT_LENS, n_req)]
    want, ws, _, _, want_sched = engine_run(
        "uninterrupted (reservation, full pool)",
                                w8a8_engine(cfg, qparams, dev), prompts,
                                max_new)
    reserve = FIFOAdmission(cfg, chunk_size=CHUNK)
    priced = sum(reserve.page_price(len(p), max_new, page_size=PAGE,
                                    max_seq=MAX_SEQ) for p in prompts)
    print(f"reservation prices the {n_req} requests at {priced} pages; the "
          f"over-commit pool has {OVERCOMMIT_PAGES - 1}")
    check(priced > OVERCOMMIT_PAGES - 1, "over-commit: pool not too small")

    eng = w8a8_engine(cfg, qparams, dev, n_pages=OVERCOMMIT_PAGES,
                      admission=OvercommitAdmission(cfg, chunk_size=CHUNK))
    log = []  # (rid, outputs at preemption, mode)
    preempt = eng._preempt

    def logged(req, mode="auto"):
        n = len(req.out)
        preempt(req, mode)
        log.append((req.rid, n, req.state))

    eng._preempt = logged
    cancelled, forced = [], []

    def drive(e):
        cancelled.append(e.queue[-1].rid)  # still queued
        check(e.cancel(cancelled[0]), "over-commit: queued cancel failed")
        last = 0  # tick of the last forced step
        for tick in range(1, 400):
            if not (e.queue or any(r is not None for r in e.slots)):
                break
            e.tick()
            modes = {m for _, _, m in log}
            dec = [r for r in e.slots if r is not None and r.state == DECODE
                   and len(r.out) >= 4]
            if not dec or tick < last + 4:
                continue
            if PREEMPTED_RECOMPUTE not in modes:
                forced.append(dec[0].rid)
                e._preempt(dec[0], "recompute")
            elif PREEMPTED_HOST not in modes:
                forced.append(dec[-1].rid)
                e._preempt(dec[-1], "host")
            elif len(cancelled) == 1:
                cancelled.append(dec[-1].rid)
                check(e.cancel(cancelled[1]), "over-commit: seated cancel "
                      "failed")
            else:
                return
            last = tick

    got, s, launches, _, sched = engine_run("over-commit", eng, prompts,
                                            max_new, drive=drive)
    modes = [m for _, _, m in log]
    print(f"over-commit: preemptions {s['preemptions']} (host "
          f"{s['preempt_host']}, recompute {s['preempt_recompute']}), "
          f"restores {s['restores']}, evicted {s['evicted_bytes_total']:,.0f}"
          f" B, cancelled {s['cancelled']} (rids {cancelled}), pages in use "
          f"peak {s['pages_in_use_peak']}, now {s['pages_in_use']}; "
          f"preempted (rid, outputs, mode): {log}, of which forced "
          f"through _preempt: rids {forced}")
    print("over-commit stats:", json.dumps(s, sort_keys=True))
    check(modes.count(PREEMPTED_HOST) >= 1
          and modes.count(PREEMPTED_RECOMPUTE) >= 1,
          "over-commit: not both preemption modes happened")
    check(s["cancelled"] == 2 and len(cancelled) == 2,
          "over-commit: two cancels expected")
    check(s["pages_in_use"] == 0, "over-commit: pages did not drain")
    check(sorted(got) == sorted(set(range(n_req)) - set(cancelled)),
          "over-commit: the surviving requests were not all served")
    check(launches["mp_matmul"] > 0 and launches["paged_verify"] > 0
          and launches["paged_mha_decode"] > 0,
          "over-commit: a kernel of the paged path was never launched")
    # the computation each surviving request took, recompute resumes and
    # host restores included, is the one its calls recorded
    host = sorted({rid for rid, _, m in log if m == PREEMPTED_HOST}
                  - set(cancelled))
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)
    hold_streams("over-commit vs uninterrupted on the card",
                 (got, {rid: want[rid] for rid in got}), prompts,
                 (served_logits(qparams, cfg, sched, dev, **shape),
                  served_logits(qparams, cfg, want_sched, dev, **shape)),
                 max_new)
    parted = [rid for rid in host if got[rid] != want[rid]]
    print(f"over-commit: host-restored requests {host} equal the "
          f"uninterrupted streams: {not parted}")
    print(f"uninterrupted run beside it: TTFT p50 "
          f"{ws['p50_ttft_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{ws['p50_tpot_s'] * 1e3:.2f} ms, pages in use peak "
          f"{ws['pages_in_use_peak']}")
    return launches


def agreement_phase(dev, arch="gpt2-345m", prefill_mode="chunked"):
    """Free-running greedy streams part for good at the first near-tie
    that the two devices' roundings break differently (the plain attention
    rounds probabilities to bf16, the kernels keep them in float32).  So
    the served streams must be equal up to where they part, and each
    parting must be such a near-tie.  Plain decode, chain speculation and
    tree speculation with a draft model, on ``arch``'s reduced config; a
    hybrid stack (rings, recurrent states) serves on the stacked layout
    and without the tree, which it refuses.  With ``prefill_mode=
    "replay"`` only plain decode runs (replay takes no speculation), each
    prompt fed one token a step."""
    phase(f"reduced-config agreement ({arch}, {prefill_mode} prefill, card "
          "vs CPU, same W8A8 weights)")
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(2)
    params = lm.init(cfg, torch.Generator().manual_seed(0),
                     max_seq=AGREE_MAX_SEQ)
    calib = [rng.integers(1, cfg.vocab_size, (2, 32))]
    qparams = quantize_model_params(params, cfg, calibrate(params, cfg,
                                                           calib))
    draft = serve.noisy_copy(params, 11, DRAFT_SIGMA)
    shared = rng.integers(1, cfg.vocab_size, 40).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in (3, 17, 33, 60, 9, 25)]
    prompts += [shared + [5, 6], shared + [7]]
    cpu_dev = torch.device("cpu")
    qdev = to_device(qparams, dev)
    layout = "paged" if blocks.page_addressable(cfg) else "stacked"
    replay = prefill_mode == "replay"
    shape = dict(rows=4, layout=layout)
    variants = {
        "plain": None,
        "chain": SpecConfig(k=CHAIN_K),
        "tree": SpecConfig(k=5, proposer="model", draft_cfg=cfg,
                           draft_params=draft, tree=True,
                           branch=TREE_BRANCH),
    }
    if layout == "stacked":
        del variants["tree"]
    if replay:
        variants = {"plain": None}
    agree = {}
    for name, spec in variants.items():
        outs, fns = [], []  # [card, CPU]
        for d, qp in ((dev, qdev), (cpu_dev, qparams)):
            eng = ServeEngine(cfg, qparams, batch_slots=4,
                              max_seq=AGREE_MAX_SEQ, eos_id=-1,
                              act_dtype=torch.float32,
                              chunk_size=AGREE_CHUNK, page_size=AGREE_PAGE,
                              prefill_mode=prefill_mode, spec=spec, device=d)
            for p in prompts:
                eng.submit(p, max_new=16)
            with ScheduleProbe(eng) as probe:
                outs.append({r.rid: r.out for r in eng.run()})
            fns.append(served_logits(qp, cfg, probe.calls, d, **shape))
            if spec is not None:
                s = eng.stats()
                print(f"reduced {arch} {name} on {d.type}: acceptance "
                      f"{s['acceptance_rate']:.3f} "
                      f"({s['spec_accepted']}/{s['spec_proposed']}), "
                      f"{s['spec_ticks']} verify calls")
        agree[name] = hold_streams(f"reduced {arch} {name} ({prefill_mode})"
                                   " card vs CPU",
                                   outs, prompts, fns, 16,
                                   moe_cfg=cfg if cfg.n_experts else None)
    return agree


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper), the patch frontend (pixtral) and replay


@contextlib.contextmanager
def plain_kernels():
    """Within the block the model code calls the plain versions on card
    tensors in place of the kernels (``ops.quant_matmul`` and
    ``ops.mha_decode``, the two the model-level whisper and pixtral paths
    reach): the yardstick the kernel runs are held against.  The
    wrappers' launch counts do not move."""
    saved = ops.quant_matmul, ops.mha_decode
    ops.quant_matmul, ops.mha_decode = (ref.quant_matmul_ref,
                                        ref.mha_decode_ref)
    try:
        yield
    finally:
        ops.quant_matmul, ops.mha_decode = saved


def whisper_kernels_phase(dev, timer):
    """The two kernels of whisper's path at its shapes.  ``mha_decode``
    over the cross cache (8 rows, 20 query heads over 20 KV heads of 64,
    1,500 keys: every row's length, 93 whole 16-key tiles and a ragged
    one), on the float32 cross cache the model-level path fills and on a
    bf16 one, and over the self cache (``max_seq`` 448, bf16, the lengths
    of the model-level run's rows after their 64 new tokens); each held
    to its plain version per output vector and timed beside its plain
    version, SDPA and its bound.  ``mp_matmul`` at every (K, N) of a
    whisper layer (1,280 -> 1,280, 1,280 -> 5,120 and 5,120 -> 1,280) at
    the encoder's token counts (one request's 1,500 frames and eight's
    12,000), with bias, each bit-identical to its plain version and timed
    beside it, ``torch._int_mm`` with the same epilogue, and its bound;
    and a decoder layer's eight calls of a decode step as ``mp_rows``
    times them (M 8 and 32).  Returns ({"mha_decode": rows, "mp_matmul":
    rows})."""
    phase("kernel timings at whisper-large-v3's shapes (cross and self "
          "decode, the encoder's linears)")
    rng = np.random.default_rng(14)
    cfg = get_config("whisper-large-v3")
    H, Hkv, D, Se = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.encoder_seq
    B = WHISPER_REQUESTS
    self_lens = [n + WHISPER_NEW for n in WHISPER_RAGGED] + [
        WHISPER_UNIFORM + WHISPER_NEW] * (B - len(WHISPER_RAGGED))
    mha = []
    for what, S, lens, kvd in (
            ("cross", Se, [Se] * B, torch.float32),
            ("cross", Se, [Se] * B, torch.bfloat16),
            ("self", WHISPER_MAX_SEQ, self_lens, torch.bfloat16)):
        q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
            np.float32)).to(dev)
        k, v = (torch.from_numpy(rng.standard_normal(
            (B, Hkv, S, D)).astype(np.float32)).to(dev, kvd)
            for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        call = partial(ops.mha_decode, q, k, v, lengths)
        err, rel = rel_err(call(), ref.mha_decode_ref(q, k, v, lengths))
        kname = "float32" if kvd == torch.float32 else "bf16"
        label = (f"whisper-large-v3 {what} (H {H} / Hkv {Hkv}, D {D}, "
                 f"{kname} cache)")
        check(rel <= ATTN_REL_TOL, f"mha_decode {label}: rel err {rel}")
        tot = int(sum(lens))
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        t = timer.ms(call)
        tp = timer.ms(partial(ref.mha_decode_ref, q, k, v, lengths))
        qs, ks, vs = (x.to(torch.bfloat16) for x in (q[:, :, None], k, v))
        tl = timer.ms(partial(F.scaled_dot_product_attention, qs, ks, vs,
                              attn_mask=mask))
        b, by = bound_ms(2 * tot * Hkv * D * k.element_size()
                         + 2 * B * H * D * 4 + 4 * B, 4 * tot * H * D, "f32")
        geo = ops._mha_geometry(B, H, Hkv, S, D, k.element_size())
        shape = (f"B={B} S={S}, lengths {lens} ({tot} keys); "
                 f"{geo.splits} splits of {geo.kps} keys")
        row = {"model": label, "shape": shape, "max_abs_err": err,
               "max_rel_err": rel, "ms": t, "plain_ms": tp,
               "library_ms": tl, "bound_ms": b, "bound_by": by}
        PROFILED.append((f"mha_decode {label}", row, "by_kernel", call,
                         ("decode::", "verify::")))
        mha.append(row)
        print(f"mha_decode {label} {shape}: max abs err {err:.3e} (rel "
              f"{rel:.3e} <= {ATTN_REL_TOL}); "
              f"kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA {tl:.4f} ms, "
              f"bound {b:.5f} ms ({by})")
        del q, k, v
    d, ff = cfg.d_model, cfg.d_ff
    mp = []
    for K, N in ((d, d), (d, ff), (ff, d)):
        for M in WHISPER_MP_M:
            x, w, xs, ws, bias = mp_inputs(rng, M, K, N, dev, bias=True)
            got = ops.quant_matmul(x, w, xs, ws, bias,
                                   out_dtype=torch.float32)
            want = ref.quant_matmul_ref(x, w, xs, ws, bias,
                                        out_dtype=torch.float32)
            check(torch.equal(got, want),
                  f"mp_matmul whisper M={M} K={K} N={N}: not bit-identical")
            call = partial(ops.quant_matmul, x, w, xs, ws, bias,
                           out_dtype=torch.float32)
            t = timer.ms(call)
            tp = timer.ms(partial(ref.quant_matmul_ref, x, w, xs, ws, bias,
                                  out_dtype=torch.float32))
            tl = timer.ms(partial(
                lambda x, w, xs, ws, bias: (torch._int_mm(x, w).float()
                                            * xs) * ws + bias,
                x, w, xs, ws, bias))
            b, by = bound_ms(M * K + K * N + 4 * (M + 2 * N) + 4 * M * N,
                             2 * M * K * N, "int8")
            geo = ops._mp_geometry(M, N, K)
            row = {"model": "whisper-large-v3",
                   "shape": f"M={M} K={K} N={N}, bias, float32 out "
                            f"({geo.m_blocks} token blocks of {geo.bm}, "
                            f"{geo.splits} K splits)",
                   "ms": t, "plain_ms": tp, "library_ms": tl,
                   "bound_ms": b, "bound_by": by}
            PROFILED.append((f"mp_matmul whisper M={M} K={K} N={N}", row,
                             "by_kernel", call, ("mp_matmul",)))
            mp.append(row)
            print(f"mp_matmul whisper M={M} K={K} N={N}: bit-identical; "
                  f"kernel {t:.4f} ms, plain {tp:.4f} ms, _int_mm + epilogue "
                  f"{tl:.4f} ms, bound {b:.5f} ms ({by})")
            del x, w, got, want
    # a decode step's layer: self q, k, v, out; cross q, out; the MLP
    mp += mp_rows(timer, rng, "whisper-large-v3", "one decoder layer's "
                  "step", [(d, d)] * 6 + [(d, ff), (ff, d)], dev)
    return {"mha_decode": mha, "mp_matmul": mp}


def whisper_phase(dev):
    """Full-width, full-depth ``whisper-large-v3`` (32 encoder and 32
    decoder layers, d 1,280, 20 heads of 64, vocab 51,866, tied), W8A8 at
    model level (the reference's engine cannot serve it, ROADMAP C10):
    seeded random weights calibrated on 2 x (1,500 seeded frames + 64
    tokens); 8 requests, each with its own 1,500 seeded frames, four
    with ragged decoder prompts of 4-32 tokens (``lm.prefill``, a replay
    through decode steps) and four of 24 (``lm.batch_prefill``); 64
    greedy tokens through ``decode_step(enc_lengths=)`` on the stacked
    cache, ``max_seq`` 448.  The launch counts are zeroed just before
    and read just after and must match the calls (two ``mha_decode`` a
    layer a step, self and cross); the stream is held under the near-tie
    rule against the same steps recomputed with the plain versions on
    the card (taught the same stream).  Prints the encode, prefill and
    per-token times and the peak memory.  Returns the launch counts."""
    cfg = get_config("whisper-large-v3")
    phase("whisper-large-v3 (full width and depth, W8A8, model-level "
          "prefill and decode)")
    rng = np.random.default_rng(20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     max_seq=WHISPER_MAX_SEQ, device=dev)
    n_params = sum(t.numel() for t in _tensors(params))
    calib_frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(dev)
    stats = calibrate(params, cfg, [rng.integers(1, cfg.vocab_size,
                                                 (2, 64))],
                      extras={"frames": calib_frames})
    qparams = quantize_model_params(params, cfg, stats)
    del params, stats, calib_frames
    torch.cuda.synchronize()
    q_bytes = sum(t.numel() * t.element_size() for t in _tensors(qparams))
    print(f"whisper-large-v3: {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters drawn in "
          f"float32 on the card, calibrated and quantized in "
          f"{time.perf_counter() - t0:.2f} s; W8A8 model "
          f"{q_bytes / 2**30:.2f} GiB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    B = WHISPER_REQUESTS
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(dev)
    ragged = [rng.integers(1, cfg.vocab_size, n).tolist()
              for n in WHISPER_RAGGED]
    uniform = rng.integers(1, cfg.vocab_size,
                           (B - len(ragged), WHISPER_UNIFORM)).tolist()
    # the encoder alone, and one of its layers and that layer's attention
    # sub-block (its q, k, v and out products included), timed outside
    # the counted path
    lm.encode(qparams, cfg, frames[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_out = lm.encode(qparams, cfg, frames)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    check(enc_out.shape == frames.shape and bool(
        torch.isfinite(enc_out).all()), "whisper encode: shape or "
        "non-finite output")
    layer = qparams["encoder"]["layers"][0]
    timer = Timer(dev)
    t_layer = timer.ms(partial(blocks.block_apply_seq, layer, enc_out, cfg,
                               "attn", causal=False), iters=5, warmup=1)
    t_attn = timer.ms(partial(attention.full_attention, layer["attn"],
                              enc_out, cfg, causal=False), iters=5, warmup=1)
    del enc_out, timer
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, la, times = whisper_run(qparams, cfg, frames, ragged, uniform,
                                  WHISPER_NEW, dev, max_seq=WHISPER_MAX_SEQ)
    n = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = max(WHISPER_RAGGED)
    L = cfg.n_layers
    print(f"whisper-large-v3: encode of {B} x {cfg.encoder_seq} frames "
          f"{enc_s * 1e3:.1f} ms (one encoder layer {t_layer:.3f} ms, its "
          f"attention sub-block {t_attn:.3f} ms, CUDA events); prefill "
          f"(two encodes, cross fills, {steps} replay steps of "
          f"{len(ragged)} rows, one batched prefill of {len(uniform)} x "
          f"{WHISPER_UNIFORM}) "
          f"{times['prefill_s'] * 1e3:.1f} ms; {WHISPER_NEW} decode steps "
          f"of {B} rows {times['decode_s'] * 1e3:.1f} ms, "
          f"{times['decode_s'] * 1e3 / WHISPER_NEW:.2f} ms a step; peak "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"whisper-large-v3 launches: {json.dumps(n)}")
    check(toks.shape == (B, WHISPER_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "whisper: tokens of the wrong shape or outside the vocabulary")
    check(n["mha_decode"] == 2 * L * (steps + WHISPER_NEW)
          and n["mp_matmul"] == whisper_mp_calls(cfg, steps, WHISPER_NEW)
          and n["paged_mha_decode"] == n["paged_verify"]
          == n["paged_verify_tree"] == n["ln_res"] == 0,
          f"whisper: launch counts {n} do not match the calls")
    with plain_kernels():
        _, lb, _ = whisper_run(qparams, cfg, frames, ragged, uniform,
                               WHISPER_NEW, dev, max_seq=WHISPER_MAX_SEQ,
                               forced=toks)
    hold_taught("whisper-large-v3 kernels vs plain versions on the card",
                toks, la, lb)
    del qparams, frames, la, lb
    torch.cuda.empty_cache()
    return {"whisper-large-v3 model-level": n}


def whisper_agreement_phase(dev):
    """Reduced ``whisper-large-v3`` (2 + 2 layers, d 64) on the card and
    on the CPU with the same W8A8 weights (calibrated with frames): the
    model-level loop of :func:`whisper_phase` (two ragged prompts replayed, two
    uniform ones batched, 16 greedy steps), the CPU taught the card's
    stream and held under the near-tie rule."""
    phase("reduced-config agreement (whisper-large-v3, model level, card "
          "vs CPU, same W8A8 weights)")
    cfg = get_config("whisper-large-v3").reduced()
    rng = np.random.default_rng(21)
    params = lm.init(cfg, torch.Generator().manual_seed(0),
                     max_seq=AGREE_MAX_SEQ)
    stats = calibrate(params, cfg, [rng.integers(1, cfg.vocab_size, (2, 32))],
                      extras={"frames": rng.standard_normal(
                          (2, cfg.encoder_seq, cfg.d_model)).astype(
                              np.float32)})
    qparams = quantize_model_params(params, cfg, stats)
    frames = torch.from_numpy(rng.standard_normal(
        (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    ragged = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (3, 11)]
    uniform = rng.integers(1, cfg.vocab_size, (2, 7)).tolist()
    cpu = torch.device("cpu")
    toks, la, _ = whisper_run(to_device(qparams, dev), cfg, frames.to(dev),
                              ragged, uniform, 16, dev,
                              max_seq=AGREE_MAX_SEQ)
    _, lb, _ = whisper_run(qparams, cfg, frames, ragged, uniform, 16, cpu,
                           forced=toks, max_seq=AGREE_MAX_SEQ)
    hold_taught("reduced whisper-large-v3 card vs CPU", toks, la, lb)


def pixtral_prefill_check(qparams, cfg, dev, rng):
    """``lm.batch_prefill`` of 2 requests of ``frontend_tokens`` (256)
    seeded patch embeddings and 32 tokens on a stacked cache, then 4
    greedy decode steps, on the kernels and with the plain versions on
    the card (taught the same stream), held under the near-tie rule; the
    lengths are 256 + 32.  Returns the kernels' launch counts."""
    P, S, B, steps = cfg.frontend_tokens, 32, 2, 4
    patches = torch.from_numpy(rng.standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))).to(dev)

    def run(forced=None):
        cache = lm.init_cache(cfg, B, 2 * (P + S), layout="stacked",
                              device=dev)
        last, cache, lengths = lm.batch_prefill(
            qparams, cfg, tokens, cache, patches=patches,
            dtype=torch.float32)
        check(lengths.tolist() == [P + S] * B, f"pixtral batch_prefill "
              f"lengths {lengths.tolist()}")
        fed, logits = [], [last]
        for i in range(steps):
            tok = (last.argmax(-1) if forced is None
                   else torch.as_tensor(forced[:, i], device=dev))
            fed.append(tok)
            last, cache = lm.decode_step(qparams, cfg, tok[:, None], cache,
                                         lengths, dtype=torch.float32)
            lengths = lengths + 1
            logits.append(last)
        return (torch.stack(fed, 1).cpu().numpy(),
                torch.stack(logits).float().cpu())

    ops.reset_launch_counts()
    toks, la = run()
    torch.cuda.synchronize()
    n = ops.launch_counts()
    check(n["mp_matmul"] == mp_per_call(cfg) * (1 + steps)
          and n["mha_decode"] == cfg.n_layers * steps,
          f"pixtral batch_prefill: launch counts {n} do not match the calls")
    with plain_kernels():
        _, lb = run(forced=toks)
    hold_taught(f"{cfg.name} batch_prefill with {P} patches, kernels vs "
                "plain versions on the card", toks, la, lb)
    return n


def replay_phase(dev, qparams, cfg):
    """Replay prefill (``prefill_mode="replay"``: every prompt token a
    decode step) on phase 4's full-width W8A8 GPT-2, paged, 4 requests of
    64 new tokens on prompts of 16-128 tokens, beside the same requests
    with chunked prefill.  Launch counts zeroed before each run and read
    after: the replay run launches no ``paged_verify``, one
    ``paged_mha_decode`` a layer a model call; the replay streams held to
    the chunked run's under the near-tie rule, logits recomputed through
    each run's calls (decode steps for every prompt token, or chunks) in
    a batch of the engine's 8 rows.  Returns the replay run's launches."""
    phase("replay prefill (full-width gpt2-345m, W8A8, paged)")
    rng = np.random.default_rng(22)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in np.linspace(*REPLAY_PROMPT_LENS,
                                    REPLAY_REQUESTS).astype(int)]
    streams, out, sched = {}, {}, {}
    L = cfg.n_layers
    for mode in ("chunked", "replay"):
        eng = w8a8_engine(cfg, qparams, dev, prefill_mode=mode)
        got, s, n, _, sched[mode] = engine_run(f"gpt2-345m {mode}", eng,
                                               prompts, SPEC_NEW)
        decodes = s["model_calls"] - s["prefill_calls"]
        check(n["mp_matmul"] == 6 * L * s["model_calls"]
              and n["paged_verify"] == L * s["prefill_calls"]
              and n["paged_mha_decode"] == L * decodes > 0
              and (mode == "chunked" or s["prefill_calls"] == 0
                   and s["model_calls"] == s["ticks"]),
              f"gpt2-345m {mode}: launch counts {n} do not match the calls")
        streams[mode], out[f"gpt2-345m {mode}"] = got, n
        del eng
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK, rows=SLOTS)
    hold_streams("gpt2-345m replay vs chunked on the card",
                 (streams["replay"], streams["chunked"]), prompts,
                 tuple(served_logits(qparams, cfg, sched[mode], dev, **shape)
                       for mode in ("replay", "chunked")), SPEC_NEW)
    return {"replay": out["gpt2-345m replay"]}


# ---------------------------------------------------------------------------
# multi-device: ring TP and the distributed engine on
# shards of one card (a mesh that names the card several times)


def column_shard_phase(dev, timer):
    """``mp_matmul`` at the shapes of GPT-2's column shards over
    ``RING_SHARDS`` shards (ring TP, ``ServeEngine(mesh=)``), each
    bit-identical to its plain version and timed as in phase 3 beside its
    plain version, ``torch._int_mm`` (M > 16), the unsharded call and its
    bound.  Returns the timed rows."""
    n = RING_SHARDS
    phase(f"mp_matmul timed on GPT-2's column shards ({n} shards)")
    rng = np.random.default_rng(23)
    rows = []
    for M in (SLOTS, CHUNK):
        for K, N in MP_SHAPES:
            Nl = N // n
            x, w, xs_, ws, _ = mp_inputs(rng, M, K, N, dev)
            wl, wsl = w[:, :Nl].contiguous(), ws[:, :Nl].contiguous()
            f32 = torch.float32
            check(torch.equal(
                ops.quant_matmul(x, wl, xs_, wsl, out_dtype=f32),
                ref.quant_matmul_ref(x, wl, xs_, wsl, out_dtype=f32)),
                f"mp_matmul column shard M={M} K={K} N={Nl}: not "
                "bit-identical to plain")
            t = timer.ms(partial(ops.quant_matmul, x, wl, xs_, wsl,
                                 out_dtype=f32))
            tp = timer.ms(partial(ref.quant_matmul_ref, x, wl, xs_, wsl,
                                  out_dtype=f32))
            tl = (timer.ms(partial(
                lambda x, w, a, b: (torch._int_mm(x, w).float() * a) * b,
                x, wl, xs_, wsl)) if M > 16 else None)
            tfull = timer.ms(partial(ops.quant_matmul, x, w, xs_, ws,
                                     out_dtype=f32))
            b, by = bound_ms(M * K + K * Nl + 4 * (M + Nl) + 4 * M * Nl,
                             2 * M * K * Nl, "int8")
            geo = ops._mp_geometry(M, Nl, K)
            rows.append({"model": "gpt2-345m",
                         "shape": f"column shard 1/{n}: M={M} K={K} N={Nl} "
                                  f"(of {N})",
                         "ms": t, "plain_ms": tp, "library_ms": tl,
                         "bound_ms": b, "bound_by": by, "unsharded_ms": tfull})
            print(f"mp_matmul column shard M={M} K={K} N={Nl} (of {N}; "
                  f"{geo.splits} K splits): bit-identical, kernel "
                  f"{t:.4f} ms, plain "
                  f"{tp:.4f} ms, library "
                  f"{'n/a (M <= 16)' if tl is None else f'{tl:.4f} ms'}, "
                  f"unsharded call {tfull:.4f} ms, bound {b:.5f} ms ({by})")
    return rows


def dist_engine(cfg, qparams, dev, n_shards, slots_per_shard, **kw):
    """A distributed engine on ``n_shards`` shards of the card, at the
    serving shapes, on the W8A8 weights of phase 4."""
    return DistributedServeEngine(
        cfg, qparams, mesh=make_serving_mesh(n_shards, [dev] * n_shards),
        slots_per_shard=slots_per_shard, max_seq=MAX_SEQ, eos_id=-1,
        act_dtype=torch.float32, chunk_size=CHUNK, page_size=PAGE, seed=0,
        **kw)


def dist_report(label, eng, s, launches):
    """Print a distributed run's transfer and shard figures and check its
    launches and that no tick transfer reaches one page-pool leaf (only
    a state migration's blob carries K/V, by design)."""
    leaf = eng.caches[0]["layers"][0]["k"]
    leaf_b = leaf.numel() * leaf.element_size()
    tick_max = max((nb for name, nb, _ in eng.xfer.events
                    if not name.startswith("migrate.")), default=0)
    print(f"{label}: overlap_ratio {s['overlap_ratio']:.3f} (prefill "
          f"{s.get('overlap_ratio_prefill', 1.0):.3f}, drain "
          f"{s.get('overlap_ratio_drain', 1.0):.3f}); "
          f"{s['transfers']} transfers, {s['transfers_exposed']} exposed; "
          f"max_transfer_bytes {s['max_transfer_bytes']:,} (tick transfers "
          f"{tick_max:,}) vs one pool leaf {leaf_b:,} B; utilization "
          f"{np.round(eng.utilization(), 3).tolist()}; migrations "
          f"{s['migrations']} ({s['migrated_bytes_total']:,} B); ticks "
          f"{s['ticks']}, wave occupancy mean "
          f"{s['wave_occupancy_mean']:.2f}")
    check(0 < tick_max < leaf_b, f"{label}: a tick transfer of {tick_max} B "
          f"reaches a page-pool leaf ({leaf_b} B)")
    need = (("mp_matmul", "paged_mha_decode", "paged_verify") if eng.paged
            else ("mp_matmul", "mha_decode"))
    if eng.spec is not None and eng.paged:
        need = ("mp_matmul", "paged_verify")
    for k in need:
        check(launches[k] > 0, f"{label}: kernel {k} was never launched")
    if not eng.paged:
        check(launches["paged_mha_decode"] == launches["paged_verify"] == 0,
              f"{label}: a paged kernel ran on the stacked layout")
    eng.kv.check_shard_locality(eng.caches, eng.mesh)
    print(f"{label} stats:", json.dumps(s, sort_keys=True))


def distributed_phase(dev, qparams, cfg, chain_run):
    """Phase 6, distributed: full-width W8A8 ``gpt2-345m`` on shards of
    the card, the settings of phase 4.  (1) ``DistributedServeEngine`` 2
    x 4, paged, plain, and (2) with chain speculation (n-gram, k
    ``CHAIN_K``), on phase 6's chain prompts with 64 new tokens, held
    against phase 6's single-device plain and chain runs; (3) 4 x 2 paged
    plain, 8
    requests of 32 new tokens of which two share a 4-page system prompt:
    the second must land on the first's shard and link its pages; (4) 2 x
    4 stacked plain with one ``migrate(mode="state")`` and one
    ``migrate(mode="recompute")`` mid-run, held against the same engine
    unmigrated; (5) ``ServeEngine(mesh=make_host_mesh(model=4, devices=
    [card] * 4))`` (ring TP): streams token for token the unsharded
    engine's, no near-tie allowed, and 4x its ``mp_matmul`` launches.
    Pairs are held under the near-tie rule along each run's own calls
    (a distributed run's in its shard's batch of rows).  Each run's
    launches are zeroed before it and read after.  Returns them."""
    phase("distributed serving (full-width gpt2-345m, W8A8, shards of one "
          "card)")
    prompts, (spec_streams, plain_streams), (spec_fn, plain_fn) = chain_run
    shape = dict(max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK)
    out = {}
    for name, spec, want, fb in (
            ("plain", None, plain_streams, plain_fn),
            ("chain", SpecConfig(k=CHAIN_K), spec_streams, spec_fn)):
        label = f"distributed 2x{DIST_BS} paged {name}"
        eng = dist_engine(cfg, qparams, dev, 2, DIST_BS, spec=spec)
        got, s, launches, _, sched = engine_run(label, eng, prompts,
                                                SPEC_NEW)
        dist_report(label, eng, s, launches)
        if spec is not None:
            print(f"{label}: acceptance {s['acceptance_rate']:.3f} "
                  f"({s['spec_accepted']}/{s['spec_proposed']}), "
                  f"{s['spec_ticks']} verify calls, widths "
                  f"{s['verify_width_min']}..{s['verify_width_max']}")
        fa = served_logits(qparams, cfg, sched, dev, rows=DIST_BS, **shape)
        hold_streams(f"{label} vs single-device {name}", (got, want),
                     prompts, (fa, fb), SPEC_NEW)
        out[label] = launches
        del eng

    rng = np.random.default_rng(29)
    V = cfg.vocab_size
    system = rng.integers(1, V, 4 * PAGE).tolist()
    lens = np.linspace(*SPEC_PROMPT_LENS, 6).astype(int)
    prompts3 = ([system + rng.integers(1, V, 20).tolist()]
                + [rng.integers(1, V, int(n)).tolist() for n in lens]
                + [system + rng.integers(1, V, 9).tolist()])
    want3, ws3, wl3, _, wsched3 = engine_run(
        "single-device reference (32 new)", w8a8_engine(cfg, qparams, dev),
        prompts3, DIST_NEW)
    fb3 = served_logits(qparams, cfg, wsched3, dev, rows=SLOTS, **shape)
    label = f"distributed {RING_SHARDS}x2 paged plain (shared system prompt)"
    eng = dist_engine(cfg, qparams, dev, RING_SHARDS, 2)
    got, s, launches, _, sched = engine_run(label, eng, prompts3, DIST_NEW)
    dist_report(label, eng, s, launches)
    by_rid = {r.rid: r for r in eng.finished}
    shards = [eng.kv.shard_of(by_rid[r].slot)[0] for r in (0, 7)]
    check(shards[0] == shards[1] and s["prefix_hit_pages"] > 0,
          f"{label}: the shared-prompt pair on shards {shards}, "
          f"{s['prefix_hit_pages']} prefix-hit pages")
    print(f"{label}: the shared-prompt pair both on shard {shards[0]}, "
          f"{s['prefix_hit_pages']} prefix pages linked")
    hold_streams(f"{label} vs single-device", (got, want3), prompts3,
                 (served_logits(qparams, cfg, sched, dev, rows=2, **shape),
                  fb3), DIST_NEW)
    out[label] = launches
    del eng

    sshape = dict(shape, layout="stacked", rows=DIST_BS)
    label = f"distributed 2x{DIST_BS} stacked plain"
    eng = dist_engine(cfg, qparams, dev, 2, DIST_BS, kv_layout="stacked")
    base, s, launches, _, bsched = engine_run(f"{label} (unmigrated)", eng,
                                              prompts3, DIST_NEW)
    dist_report(f"{label} (unmigrated)", eng, s, launches)
    del eng
    moved = {}

    def drive(e):
        while len(moved) < 2 and (e.queue or any(
                r is not None for r in e.slots)):
            e.tick()
            for r in e.slots:
                if (r is not None and r.state == DECODE and len(r.out) >= 8
                        and r.rid not in moved and r.migrate_to is None):
                    mode = "recompute" if moved else "state"
                    src = e.kv.shard_of(r.slot)[0]
                    check(e.migrate(r.rid, 1 - src, mode=mode),
                          f"{label}: migrate of request {r.rid} refused")
                    moved[r.rid] = (mode, src)
                    break

    eng = dist_engine(cfg, qparams, dev, 2, DIST_BS, kv_layout="stacked")
    got, s, launches, _, sched = engine_run(f"{label} (migrated)", eng,
                                            prompts3, DIST_NEW, drive=drive)
    dist_report(f"{label} (migrated)", eng, s, launches)
    by_rid = {r.rid: r for r in eng.finished}
    for rid, (mode, src) in moved.items():
        dst = eng.kv.shard_of(by_rid[rid].slot)[0]
        check(by_rid[rid].n_migrations == 1 and dst != src,
              f"{label}: request {rid} ({mode}) did not move ({src} -> "
              f"{dst})")
        print(f"{label}: request {rid} migrated by {mode} from shard {src} "
              f"to {dst}; its stream "
              f"{'equals' if got[rid] == base[rid] else 'parts from'} "
              "the unmigrated one")
    check(s["migrations"] == 2 and s["migrated_bytes_total"] > 0,
          f"{label}: migrations {s['migrations']}")
    hold_streams(f"{label}: migrated vs unmigrated", (got, base), prompts3,
                 (served_logits(qparams, cfg, sched, dev, **sshape),
                  served_logits(qparams, cfg, bsched, dev, **sshape)),
                 DIST_NEW)
    out[label] = launches
    del eng

    mesh = make_host_mesh(model=RING_SHARDS, devices=[dev] * RING_SHARDS)
    label = f"ring TP ServeEngine(mesh=) over {RING_SHARDS} shards"
    got, s, launches, _, _ = engine_run(
        label, w8a8_engine(cfg, qparams, dev, mesh=mesh), prompts3, DIST_NEW)
    check(got == want3, f"{label}: streams differ from the unsharded "
          "engine's (every W8A8 product is bit-identical)")
    check(s["model_calls"] == ws3["model_calls"]
          and launches["mp_matmul"] == RING_SHARDS * wl3["mp_matmul"],
          f"{label}: mp_matmul launches {launches['mp_matmul']} are not "
          f"{RING_SHARDS} x the unsharded run's {wl3['mp_matmul']}")
    for k in ("paged_mha_decode", "paged_verify"):
        check(launches[k] == wl3[k], f"{label}: {k} launches differ")
    print(f"{label}: streams token for token the unsharded engine's; "
          f"mp_matmul launches {launches['mp_matmul']} = {RING_SHARDS} x "
          f"{wl3['mp_matmul']} over {s['model_calls']} model calls")
    out[label] = launches
    return out


def dist_agreement_phase(dev):
    """Reduced ``recurrentgemma-9b`` (rings and recurrent states) through
    ``DistributedServeEngine`` 2 x 2, stacked, chain speculation, on two
    shards of the card and on two CPU entries with the same W8A8
    weights: the streams held under the near-tie rule, as phase 7."""
    arch = "recurrentgemma-9b"
    phase(f"reduced-config agreement ({arch}, distributed 2x2 stacked "
          "chain, card vs CPU, same W8A8 weights)")
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(2)
    params = lm.init(cfg, torch.Generator().manual_seed(0),
                     max_seq=AGREE_MAX_SEQ)
    calib = [rng.integers(1, cfg.vocab_size, (2, 32))]
    qparams = quantize_model_params(params, cfg, calibrate(params, cfg,
                                                           calib))
    run = rng.integers(1, cfg.vocab_size, 5).tolist()
    prompts = [run * 6] + [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                           for n in (3, 17, 60, 9)]
    outs, fns = [], []
    for d, qp in ((dev, to_device(qparams, dev)),
                  (torch.device("cpu"), qparams)):
        eng = DistributedServeEngine(
            cfg, qparams, mesh=make_serving_mesh(2, [d] * 2),
            slots_per_shard=2, max_seq=AGREE_MAX_SEQ, eos_id=-1,
            act_dtype=torch.float32, chunk_size=AGREE_CHUNK,
            page_size=AGREE_PAGE, kv_layout="stacked",
            spec=SpecConfig(k=CHAIN_K))
        for p in prompts:
            eng.submit(p, max_new=16)
        with DistScheduleProbe(eng) as probe:
            outs.append({r.rid: r.out for r in eng.run()})
        s = eng.stats()
        print(f"reduced {arch} distributed chain on {d.type}: acceptance "
              f"{s['acceptance_rate']:.3f} "
              f"({s['spec_accepted']}/{s['spec_proposed']}), "
              f"{s['spec_ticks']} verify calls, overlap_ratio "
              f"{s['overlap_ratio']:.3f}")
        fns.append(served_logits(qp, cfg, probe.calls, d, rows=2,
                                 layout="stacked"))
    hold_streams(f"reduced {arch} distributed 2x2 chain card vs CPU", outs,
                 prompts, fns, 16)


# ---------------------------------------------------------------------------
# the analysis layer: profiler ranges and the roofline share


class DecodeStepClock:
    """Times every ``lm.decode_step`` an engine makes with CUDA events
    around the call (no host sync), and keeps each step's host lengths
    and active mask, for the roofline of a measured step."""

    def __init__(self, eng):
        self.eng, self.steps = eng, []

    def __enter__(self):
        self.orig = lm.decode_step

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            lengths = self.eng.kv.lengths.copy()
            e0.record()
            out = self.orig(*args, **kw)
            e1.record()
            self.steps.append((e0, e1, lengths, kw.get("active")))
            return out

        lm.decode_step = timed
        return self

    def __exit__(self, *exc):
        lm.decode_step = self.orig
        return False

    def measured(self):
        """[(device ms, lengths, active rows)] once the run synchronized."""
        return [(a.elapsed_time(b), n, act.cpu().numpy().astype(bool))
                for a, b, n, act in self.steps]


def decode_step_bytes(params, cfg, lengths, active) -> int:
    """The bytes a paged W8A8 decode step of ``cfg`` must move: every
    parameter read once (the tied embedding table whole, for the head;
    the position table's rows of the batch only), the K and V pages of
    each active row read whole (its new position included), one K and V
    position written per active row, and the float32 logits written."""
    B = len(lengths)
    total = 0
    for path, t in zip(*partition.leaf_paths(params)):
        if path.endswith("pos_embed"):
            total += B * t.shape[-1] * t.element_size()
        else:
            total += t.numel() * t.element_size()
    pages = -(-(lengths[active].astype(np.int64) + 1) // PAGE)
    kv_pos = 2 * cfg.n_layers * cfg.kv_dim * 2  # bf16 K and V, all layers
    total += int(pages.sum()) * PAGE * kv_pos + int(active.sum()) * kv_pos
    return total + B * cfg.vocab_size * 4


def served(eng, prompts, max_new):
    """Submit, run to the end, synchronize: (rid -> tokens, wall s)."""
    for p in prompts:
        eng.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    return {r.rid: r.out for r in done}, time.perf_counter() - t0


def analysis_phase(dev):
    """The analysis layer on the card: (a) a traced and annotated run
    under ``torch.profiler``, its ranges and kernels against the host
    spans and launch counts, its streams and tokens/s against an untraced
    run (both after a warm-up); (b) the median decode step of the
    untraced run against its roofline bound.  Returns the traced run's
    launch counts."""
    from torch.profiler import ProfilerActivity, profile

    phase("analysis (full-width gpt2-345m, W8A8, paged: profiler ranges, "
          "the decode step's roofline share)")
    cfg = get_config("gpt2-345m")
    rng = np.random.default_rng(24)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, max_seq=MAX_SEQ, device=dev)
    calib = [rng.integers(1, cfg.vocab_size, (2, 128))]
    lo, hi = ANALYSIS_PROMPT_LENS
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, ANALYSIS_REQUESTS)]
    toks = ANALYSIS_REQUESTS * ANALYSIS_NEW
    qparams = ServeEngine(
        cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ, eos_id=-1,
        quantized=True, calibration_batches=calib, chunk_size=CHUNK,
        page_size=PAGE, seed=0, device=dev).params
    del params
    # a warm-up on an engine of its own (its pages keep their prefixes)
    served(w8a8_engine(cfg, qparams, dev), [prompts[0][::-1]], 8)

    # the untraced run, each decode step timed by CUDA events
    eng = w8a8_engine(cfg, qparams, dev)
    with DecodeStepClock(eng) as clock:
        want, wall0 = served(eng, prompts, ANALYSIS_NEW)
    steps = clock.measured()
    # the same requests traced and annotated under the profiler
    eng = w8a8_engine(cfg, qparams, dev,
                      telemetry=Telemetry(trace=True, annotate=True))
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got, wall1 = served(eng, prompts, ANALYSIS_NEW)
    launches = ops.launch_counts()
    check(got == want, "analysis: the profiled run's streams differ from "
          "the untraced run's")
    print(f"tokens/s untraced {toks / wall0:.1f}, traced and annotated "
          f"under torch.profiler {toks / wall1:.1f} ({wall1 / wall0:.3f}x "
          f"the wall); streams equal ({toks} tokens)")

    host = eng.tel.tracer.to_chrome()
    counts = validate_chrome_trace(host)
    spans = {}
    for ev in host["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] in ANNOTATED:
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    t0 = time.perf_counter()
    ranges = profile_ranges(prof.profiler.kineto_results.events(), ANNOTATED)
    print(f"host trace valid ({json.dumps(counts)}); profile read in "
          f"{time.perf_counter() - t0:.1f} s")
    got_ranges = {n: r["ranges"] for n, r in ranges.items()
                  if n is not None and r["ranges"]}
    print(f"host spans {json.dumps(spans)}; profiler ranges "
          f"{json.dumps(got_ranges)}")
    check(spans and got_ranges == spans, "analysis: the profiler's ranges "
          f"{got_ranges} are not the host spans {spans}")
    for name, keys in RANGE_KERNELS.items():
        inside = {n: sum(c for k, c in r["kernels"].items()
                         if all(x in k for x in keys))
                  for n, r in ranges.items()}
        outside = inside.pop(None)
        print(f"{name}: {json.dumps({n: c for n, c in inside.items() if c})}"
              f" launched inside the ranges, {outside} outside, "
              f"{launches[name]} counted")
        check(outside == 0 and sum(inside.values()) == launches[name] > 0,
              f"analysis: {name}'s CUDA functions inside the ranges "
              f"{inside} (outside {outside}) against {launches[name]} "
              "counted launches")
        # each kernel under the span of the calls that launch it
        check(inside["prefill.chunk"] > 0 and inside["decode.step"] > 0
              if name == "mp_matmul" else
              inside[RANGE_OWNER[name]] == launches[name],
              f"analysis: {name}'s CUDA functions inside the ranges "
              f"{inside}, not under the spans that launch them")
    for name, d in sorted(modeled_vs_measured(host).items()):
        print(f"modeled vs measured {name}: {d['spans']} spans, FPGA model "
              f"{d['modeled_s'] * 1e3:.3f} ms, host spans "
              f"{d['measured_s'] * 1e3:.3f} ms, ratio {d['ratio']:.3f}")

    # (b) the median decode step against its roofline bound
    steps.sort(key=lambda st: st[0])
    ms, lengths, active = steps[len(steps) // 2]
    nbytes = decode_step_bytes(qparams, cfg, lengths, active)
    flops = perfmodel.model_flops(cfg, "decode", int(np.median(
        lengths[active])), SLOTS)
    terms = perfmodel.roofline_terms(flops, nbytes, 0.0)
    share = terms["bound_s"] * 1e3 / ms
    print(f"decode step: median of {len(steps)} {ms:.4f} ms (min "
          f"{steps[0][0]:.4f}, max {steps[-1][0]:.4f}) at {int(active.sum())}"
          f" rows, {int(lengths[active].sum())} cached keys; "
          f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP: bound "
          f"{terms['bound_s'] * 1e3:.5f} ms ({terms['dominant']}), share "
          f"bound/measured {share:.4f}")
    check(0.0 < share <= ROOFLINE_SHARE_MAX, f"analysis: decode-step "
          f"roofline share {share} outside (0, {ROOFLINE_SHARE_MAX}]")

    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = device_phase()
    build_phase()
    timer = Timer(dev)
    entries = kernel_phase(dev, timer)
    for name, rows in wide_heads_phase(dev, timer).items():
        entries[name]["wide_heads"] = rows
    entries["mp_matmul"]["family_widths"] = family_mp_phase(dev, timer)
    for name, rows in hybrid_kernels_phase(dev, timer).items():
        entries[name]["hybrid"] = rows
    for name, rows in whisper_kernels_phase(dev, timer).items():
        entries[name]["whisper"] = rows
    for name, rows in mixed_kernels_phase(dev, timer).items():
        entries[name]["mixed"] = rows
    entries["mp_matmul"]["column_shards"] = column_shard_phase(dev, timer)
    entries["moe_experts"], grouped_launches = moe_experts_phase(dev, timer)
    del timer
    launches, qparams, cfg = serving_phase(dev)
    ln_launches = mdk_program_phase(dev, qparams, cfg)
    spec_launches, chain_run = spec_serving_phase(dev, qparams, cfg)
    stacked_launches = stacked_phase(dev, qparams, cfg, *chain_run)
    oc_launches = overcommit_phase(dev, qparams, cfg)
    replay_launches = replay_phase(dev, qparams, cfg)
    dist_launches = distributed_phase(dev, qparams, cfg, chain_run)
    del qparams
    agreement_phase(dev)
    agreement_phase(dev, prefill_mode="replay")
    family_launches = dict(whisper_phase(dev))
    for arch in FAMILY_RUNS:
        family_launches.update(family_serving_phase(dev, arch))
    for arch in HYBRID_MAX_SEQ:
        family_launches.update(hybrid_serving_phase(dev, arch))
    family_launches.update(mixed_serving_phase(dev))
    whisper_agreement_phase(dev)
    for arch in AGREE_ARCHS:
        agreement_phase(dev, arch)
    dist_agreement_phase(dev)
    train_launches = training_phase(dev)
    analysis_launches = analysis_phase(dev)
    by_kernel_phase(dev, entries)
    phase("kernels")
    by_run = {"plain": launches,
              **{f"{run} spec": n for run, n in spec_launches.items()},
              **stacked_launches, "over-commit": oc_launches,
              **replay_launches, **dist_launches,
              "MDK program": {"ln_res": ln_launches}, **family_launches,
              "trained checkpoint": train_launches,
              "analysis": analysis_launches,
              "published MoE": grouped_launches}
    # each kernel's count from the run of its own path: plain paged
    # serving for the first slice's three, the tree run for the tree
    # verify, the stacked target's decode for mha_decode, the MDK program
    # walk for ln_res
    own = {"paged_verify_tree": "tree spec", "mha_decode": "stacked plain",
           "ln_res": "MDK program", "moe_experts": "published MoE"}
    kernels = []
    for name, e in entries.items():
        e = dict(e)
        e["launches"] = by_run[own.get(name, "plain")][name]
        e["launches_by_run"] = {run: n.get(name, 0)
                                for run, n in by_run.items()}
        check(e["launches"] > 0, f"kernel {name} never launched on its path")
        kernels.append(e)
    check(len(kernels) == 8, f"{len(kernels)} kernels in the line")
    print(f"total {time.perf_counter() - T_START:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
