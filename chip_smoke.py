#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it runs with the seconds since the start; any
failure exits non-zero and nothing is caught and continued:

1. Device: the card's name and power limit (``nvidia-smi``) and its
   compute capability, which must be (9, 0).
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together).  The compiler's register and
   shared-memory report goes to ``chiprun_out/ptxas.log``.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the GPT-2 345M serving shapes, with the tolerance stated (for
   attention, per output vector: each row's, query's and head's error over
   that vector's largest magnitude, so a row of 1,000 keys is held to its
   own scale and not to that of a row with one key).  The tree-masked
   verify runs on trees built with ``TokenTree`` and on a random mask, and
   a lower-triangular mask must give output bit-identical to the causal
   kernel.  Both verify bodies run on rows whose keys end on a key-split
   edge of the split-KV geometry, just past it and a page past it, at
   base 0, at the end of the table and parked, for chunks of 5, 9 and 32,
   and two calls must give bit-identical output (a fixed merge order).
   The contiguous decode kernel (S 1024 and a ragged 1000, all heads, GQA
   and a group of 16 at D 128, float32 and bf16 queries and caches)
   returns zeros for an empty row.  ``mp_matmul`` is also held bit for
   bit at the verifies' token counts (40 and 72), and two calls of it,
   and of both decodes, must give bit-identical output.
   ``ln_res`` (rows 5, 8, 32, 256; widths 1024, 4096, a ragged 1000 and
   256; LayerNorm and RMSNorm; x and res float32 and bf16): the new
   residual
   bit-identical, ``scale`` within 1e-5 relative, ``y`` within one bf16
   ulp, ``y_q`` within 1 and equal on at least 99.9% of elements.
   ``quant_act`` (rows 1, 32, 127, 1,500; widths 1,024 to 24,576 and a
   ragged 1,027; x float32 and bf16, one row of zeros; smoothing factors
   over [1e-3, 1e3]): ``x_q`` and ``scale`` bit-identical to its plain
   version run on the CPU, the yardstick, since ATen on the card may
   divide by the scalar 127 as a multiply by its reciprocal.
4. Timing: each kernel, its plain version and one PyTorch library call
   that computes the same function, timed with CUDA events per launch
   with the 50 MB L2 flushed before each launch (the serving loop streams
   ~300 MB of other weights and pages between two uses of one layer's),
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over the dense peak of the operands' type); the
   ``mp_matmul``, decode and verify timings print their split geometry;
   the contiguous decode is timed on the draft's float32 cache and on a
   bf16 cache, ``ln_res`` at 8, 32 and 256 rows, ``quant_act`` at 127
   and 32 rows of 1,024 and 4,096.
   Two yardsticks of the timing itself: an empty kernel (a 4-byte fill)
   and, beside each decode-tick ``mp_matmul``, a device-to-device copy of
   the same weight bytes.
   No PyTorch call computes ``ln_res``; ``F.layer_norm`` of the sum is
   printed beside it as the norm alone.
   Then the RoPE family's and olmoe's heads: ``paged_mha_decode``,
   ``paged_verify`` (a prefill chunk and a chain verify), its tree body
   and ``mha_decode`` (float32 and bf16 caches) at ``llama3-8b``'s group
   4 and ``minitron-4b``'s group 3 at D 128, ``gemma-7b``'s D 256 and
   ``olmoe-1b-7b``'s 16 heads of 128 (group 1), each held to its plain
   version per output vector, twice bit-identical (a lower-triangular
   mask as the causal kernel), empty decode rows zero, and timed as above
   beside SDPA (``enable_gqa``) and its bound; and ``mp_matmul`` at their
   weight shapes (every quantized (K, N) of a layer: olmoe's q, k, v and
   out, its experts staying float; and the untied heads, N up to
   256,000) bit for bit at M 8, 32 and 40, one layer's calls and the
   head timed at M 8 and 32.
   Then one full-width ``olmoe-1b-7b`` layer's MoE FFN (plain PyTorch,
   as in the reference: router, dispatch, three batched float32 expert
   products at exact capacity, combine) at 8 and 32 tokens: routing equal
   to the CPU's and the output within 1e-4 at 8 tokens; timed whole, its
   router alone and its products alone, beside its bytes bound and the
   padded products' operations bound; one ``moe_ffn`` JSON line.
   Then the grouped experts kernel (``moe_experts``, bf16 experts) at
   ``olmoe-1b-7b-0924``'s widths at 32 and 256 tokens: held to its plain
   version on the card (within 2^-7 of each row's largest magnitude, at
   most 5% of elements apart; it reads equal), two calls bit-identical,
   timed beside its plain version, the padded ``bmm`` + ``layers.silu``
   path it replaced and its bound (the touched experts' banks read once);
   a reduced published-form engine counts two launches a MoE layer.
   Then the hybrid stacks' kernels: ``mha_decode`` on
   ``recurrentgemma-9b``'s ring (8 rows, 16 query heads over one KV head
   of 256, a bf16 ring of 2,048 slots, lengths up to W + 1 as the ring
   decode passes them; a row at W + 1 bit-identical to the same row at
   W), held and timed as above, and ``mp_matmul`` at every quantized
   (K, N) of a recurrentgemma RG-LRU and local-attention layer and an
   ``xlstm-350m`` mLSTM layer; and one full-width W8A8 block of each
   recurrent kind (RG-LRU with its GeGLU MLP, mLSTM, sLSTM) timed as a
   decode step of 8 rows and a prefill chunk of 32 tokens, beside the
   bytes it must move; one ``recurrent_blocks`` JSON line.
   Then whisper-large-v3's shapes: ``mha_decode`` over the cross cache
   (8 rows, 20 heads over 20 of 64, 1,500 keys each, float32 and bf16)
   and the self cache (``max_seq`` 448, bf16), held and timed as above,
   and ``mp_matmul`` at the encoder's token counts (1,500 and 12,000;
   bit for bit also at 3,000 and a ragged 12,007) for 1,280 -> 1,280,
   1,280 -> 5,120 and 5,120 -> 1,280, each timed beside its plain
   version, ``torch._int_mm`` with the same epilogue and its bound.
   Then the mixed stack's ``attn`` layers: ``paged_mha_decode`` (8
   rows) and ``paged_verify`` (a prefill chunk of 32, a chain verify of
   8 x 5) at 16 query heads over one KV head of 256 in a table of 4,096
   positions, held and timed as above.
4b. Ring collectives on four shards of the card
   (``make_host_mesh(model=4, devices=[card] * 4)``: one controller, a
   hop is a copy on the card): ``ring_all_gather`` of the distributed
   tick's logits blocks bit-identical to ``torch.cat``;
   ``compressed_psum`` of four 2^20-float vectors within one int8 step
   per hop of the CPU's; ``ring_ag_matmul`` and ``ring_rs_matmul``
   within 1e-5 relative of one float32 product; ``tp_quant_matmul``
   bit-identical to the unsharded call at GPT-2's weight shapes at M 8,
   32 and 40, and each column shard's ``mp_matmul`` bit-identical to its
   plain version; the attention kernels at a shard's batch of rows (4
   and 2: the split geometry follows B) against their plain versions as
   in phase 3; ``mp_matmul`` at the column-shard shapes held to plain and
   timed beside the unsharded call and its bound (the ``column_shards``
   rows of the ``kernels`` line).
5. Serving: full-width ``gpt2-345m`` with random weights from a seeded
   generator, W8A8 SmoothQuant calibrated on seeded prompts, paged KV
   cache, chunk 32, 8 slots, ``max_seq`` 1024, 16 greedy requests with
   prompts of 16..512 tokens and 64 new tokens each.  The kernels' launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  Then one prompt is prefilled and decoded at full width
   on the card and on the CPU (plain versions) with the same weights, and
   the logits must agree.
6. MDK program: the 49 ``ln_res`` stages of the stage program
   (``l{i}.ln1``, ``l{i}.ln2``, ``final_ln``) through
   ``MDK_REGISTRY["ln_res"]`` with the full-width LayerNorm parameters, at
   8 and 32 rows, each against the plain version; ``ln_res``'s launch
   count is taken from this walk (the port, like the reference, calls it
   from nowhere else).
7. Speculative serving at full width, same engine settings, 8 requests
   of 64 new tokens: (a) chain speculation with the n-gram proposer, k 4,
   on prompts that repeat short token runs; (b) tree speculation with a
   draft model, k 8, branch 3, the draft being the target's fp weights
   plus 0.25 std of seeded noise per tensor (``launch/serve.py``'s
   ``noisy_copy``), on its own contiguous cache.
   Each run's launch counts are zeroed before and read after it; the
   tree run must launch the tree-masked verify and the contiguous decode
   kernel.  Each run's streams are held against plain decode of the same
   prompts on the card under the near-tie rule of phase 10, the two
   computations being decode steps along the shared history and verify
   calls of the run's width over it, each in a batch of the engine's 8
   rows.
8. Stacked serving: the same engine on the stacked layout (a contiguous
   ``max_seq`` region per slot; the contiguous decode kernel as the
   target's decode), plainly and with chain speculation on phase 7's
   chain prompts, each held against phase 7's paged run of the same
   prompts and variant under the near-tie rule.
9. Over-commit and preemption: paged, ``OvercommitAdmission`` on a pool
   too small for the requests' reservations; at least one preemption to
   host and one by recompute, one queued and one seated request
   cancelled; pages drain to 0; streams held against an uninterrupted run
   under the near-tie rule.
9b. Replay prefill: phase 5's engine with ``prefill_mode="replay"``
   (every prompt token a decode step), 4 requests of 64 new tokens on
   prompts of 16-128 tokens, and the same requests chunked; launch
   counts checked (no ``paged_verify`` in the replay run), the replay
   streams held to the chunked ones under the near-tie rule.
9c. Distributed serving at full width on shards of the card (phase 5's
   weights and settings): ``DistributedServeEngine`` 2 x 4 paged plain
   and chain on phase 7's chain prompts, held against phase 7's
   single-device runs; 4 x 2 paged plain whose shared-system-prompt
   pair must land on one shard and link pages; 2 x 4 stacked with a
   state and a recompute migration, held against its unmigrated run;
   ``ServeEngine(mesh=)`` over 4 shards (ring TP), token for token the
   unsharded engine's with 4x its ``mp_matmul`` launches.  Each run
   prints tokens/s, TTFT, TPOT, the overlap ratios, the largest
   transfer against one page-pool leaf, per-shard utilization and
   migrations; launches are checked per layout.
10. Reduced-config agreement: the reduced config served by the engine on
    the card and on the CPU with the same W8A8 weights (batched slots,
    chunked prefill, a shared prefix), plainly, with chain speculation
    and with tree speculation.  The free-running greedy agreement of the
    served streams is printed.  Each pair of streams must be equal up to
    where it parts, and every parting must be a near-tie: each
    computation's logits are recomputed along the calls that served its
    stream (``ScheduleProbe`` records every prefill chunk, decode step and
    verify call of each request while the engine runs; ``logits_after``
    replays them with their tokens, widths and valid counts), each must
    prefer its own token (a negative margin means the recomputation is
    not what served the stream, and fails), the two agree to
    ``LOGIT_REL_TOL`` of their range, and each one's margin of its own
    token over the other's is at most twice their largest logit
    difference, the most that difference can overturn.
    Then the same, plain decode only, with replay prefill.
11. Whisper at model level: full-width, full-depth ``whisper-large-v3``
    (32 encoder and 32 decoder layers, d 1,280, vocab 51,866), W8A8
    calibrated on 2 x (1,500 seeded frames + 64 tokens); 8 requests
    with their own seeded frames, four ragged prompts of 4-32 tokens
    replayed through ``lm.prefill`` and four of 24 through
    ``lm.batch_prefill``, then 64 greedy ``decode_step(enc_lengths=)``
    steps on the stacked cache (``max_seq`` 448).  Launch counts zeroed
    before and read after must match the calls (``mp_matmul`` for every
    linear, two ``mha_decode`` a layer a step); the stream held under the
    near-tie rule against the same steps with the plain versions on the
    card.  Encode, prefill and per-step times and the peak memory.
    The RoPE dense family, the MoE decoder and pixtral at full width, at a
    quarter of their depth (``FAMILY_LAYERS``; ``FAMILY_RUNS``):
    ``llama3-8b`` (8 of 32 layers, d 4096, 32 heads over 8 of 128, vocab
    128,256, an untied head) paged plain, paged chain speculation
    (n-gram, k 4) and stacked plain, then ``gemma-7b`` (7 of 28 layers,
    d 3072, 16 heads of 256, vocab 256,000) paged and stacked plain, then
    ``olmoe-1b-7b`` (4 of 16 layers, d 2048, 16 heads of 128, 64 float32
    experts of d_ff 1024 and top 8 at exact capacity, vocab 50,304, an
    untied head) paged plain, paged chain and stacked plain, then
    ``pixtral-12b`` (4 of 40 layers, d 5,120, 32 heads over 8 of 128,
    vocab 131,072; calibrated with 256 seeded patch embeddings):
    ``lm.batch_prefill`` of 256 patches and 32 tokens and 4 decode steps
    held against the plain versions on the card, then the engine on
    tokens, paged and stacked plain.
    Random weights from a seeded generator, W8A8 SmoothQuant calibrated
    on 2 x 128 seeded tokens, the engine settings of phase 5, 8 requests
    of 64 new tokens on prompts of 16-512 tokens that repeat short runs.
    Each run's launch counts are zeroed before and read after it and must
    match its calls; every run's streams are held to the paged plain
    run's under the near-tie rule (for olmoe with phase 12's routing
    near-ties), logits recomputed in the batch shapes of each run; each
    model is freed before the next, and the peak memory printed.  Then
    the hybrid stacks at full width (``HYBRID_LAYERS``,
    ``HYBRID_MAX_SEQ``): ``recurrentgemma-9b`` (two pattern periods, 6 of
    its 38 layers: 4 RG-LRU of width 4,096 and 2 local attention of 16
    heads over one KV head of 256 on a ring of 2,048 slots, GeGLU 12,288,
    vocab 256,000, tied; ``max_seq`` 2,048) and ``xlstm-350m`` (one
    period, 4 of its 24 layers: 3 mLSTM of 4 heads of 256 and 1 sLSTM,
    d 1024, vocab
    50,304; ``max_seq`` 1,024), each stacked plain and stacked chain, 8
    requests of 64 new tokens on six prompts of 16-512 tokens and two of
    2,100-2,400 (rings wrap in prefill and decode, requests run past
    ``max_seq``: no ceiling); the MP kernel's, the ring decode's and the
    paged kernels' launches checked against the calls; the chain run held
    to the plain one.  Then the mixed stack: the reference test's pattern
    (global attention, local attention, RG-LRU) at ``recurrentgemma-9b``'s
    widths, 6 layers, ``max_seq`` 4,096, on the per-kind paged layout (the
    ``attn`` layers on pages, the rings and states one row per slot) and
    on the stacked one, plain and chain, the same 8 requests; a
    prefix-sharing pair whose streams must equal the unshared run's, and
    an over-commit run that preempts to host and restores; launches
    checked against the calls and the pairs held under the near-tie
    rule.
12. Reduced-config agreement: whisper's model-level loop (the CPU
    taught the card's stream), then (as phase 10) ``llama3-8b``,
    ``gemma-7b``, ``olmoe-1b-7b``, ``kimi-k2-1t-a32b``,
    ``recurrentgemma-9b``, ``xlstm-350m`` and ``pixtral-12b`` (the
    hybrid ones on the
    stacked layout, plain and chain: they refuse the tree).  For a MoE
    stack the near-tie rule also takes a routing near-tie: at a parting,
    the routers' choices along the shared history are recorded on both
    sides, and where they differ the logits may differ by more than
    ``LOGIT_REL_TOL`` of their range if the first differing choice was a
    near-tie of the router (there the two sides' expert probabilities
    agree to ``LOGIT_REL_TOL`` of their range, and each side's gap
    between its k-th and (k+1)-th probability is within twice their
    difference) and, with the first computation's routers pinned to the
    second's choices, the two computations' logits agree to
    ``LOGIT_REL_TOL`` of their range again: only the routing is exempt,
    nothing after it.  The margins are held as before.  Phase 11 holds
    the MoE runs the same way.
12a. Reduced ``recurrentgemma-9b`` through ``DistributedServeEngine``
    2 x 2, stacked, chain, card against CPU (two shards of each), held
    as phase 10.
12b. Training: full-width ``gpt2-345m`` (float32 masters, bf16
    activations) from a seeded generator on the card.  First one train
    step at 2 x 64 tokens from the same state on the card and on the CPU:
    loss within 1% and global grad norm within 2% (bf16 products round
    differently on the two devices).  Then 20 AdamW steps (lr 1e-3, 5
    warmup steps) through ``Trainer`` on the port's ``SyntheticLM`` at 8
    x 512 tokens, async checkpoints every 10 steps into ``chiprun_out/``
    (removed at the phase's end), under
    ``torch.use_deterministic_algorithms(True)`` (the script sets
    ``CUBLAS_WORKSPACE_CONFIG`` before torch starts): median step ms,
    tokens/s, peak memory, losses at steps 1 and 20, every loss and grad
    norm finite, and the loss on a held-out batch, which must fall.  A
    fresh ``Trainer`` restores step 20 bit for bit; one resumed from step
    10 reaches step 20 bit-identical to the uninterrupted run.  The
    restored params and the in-memory ones each serve 8 greedy requests
    of 32 new tokens on a W8A8 paged engine (chunk 32, 8 slots): launch
    counts match the calls, the streams are equal, and the checkpoint's
    run's counts join the ``kernels`` line as ``trained checkpoint``.
    Last, three steps without deterministic algorithms, for their cost.
12c. Analysis: full-width ``gpt2-345m``, W8A8, paged, the serving
    settings of phase 5, 8 requests of 32 new tokens on seeded prompts of
    64-256 tokens, after a warm-up on an engine of its own.  An untraced
    run, each ``lm.decode_step`` timed by CUDA events, then the same
    requests on an engine with ``Telemetry(trace=True, annotate=True)``
    under ``torch.profiler`` (CPU and CUDA): the streams equal, token
    for token; the host trace passes ``validate_chrome_trace``; each
    annotated dispatch name has as many profiler ranges as host spans
    (matched by name and count, never by time); every ``mp_matmul``,
    ``paged_verify`` and paged decode CUDA function is launched from
    inside a range (``telemetry.profile_ranges``: a kernel's launch call
    by correlation id), as many as their counters say, none outside;
    ``modeled_vs_measured`` per span name and the profiler's cost in
    tokens/s printed.  The median decode step against
    ``perfmodel.roofline_terms`` of ``model_flops(cfg, "decode", ctx, 8)``
    and the bytes it must move (the int8 linears, the tied float32 table
    whole, the K and V pages its rows read, the logits written): the
    share bound / measured must be in (0, 1.05].  ``greedy``,
    ``temperature(0.01)`` and ``top_k(1)`` on a CUDA generator equal the
    argmax, and two seeded draws are equal.  Last, the dry run's
    ``run_cell`` on ``meta`` for ``gpt2-345m``'s three cells and
    ``llama3-8b``'s ``decode_32k`` on the single pod mesh: all ``ok``.
13. The device time of each CUDA function of the timed calls
    (``torch.profiler``): one layer's six ``mp_matmul`` calls at M 8 and
    32 (one function), the timed paged and contiguous decodes and the
    three timed verify shapes (the split kernel and the combine each), the
    three timed ``ln_res`` calls and the RoPE family's timed attention
    calls; last of the measuring phases because the profiler leaves later
    launches slower.
14. One ``kernels`` JSON line (six kernels, each with its launches on its
    own path and per run, the trained checkpoint's serving run and the
    analysis run among the runs, the RoPE family's rows under
    ``wide_heads`` and ``family_widths``, the hybrid stacks' under
    ``hybrid``,
    whisper's under ``whisper``, the mixed stack's under ``mixed``), the
    total time, the card's name and power limit, then the device JSON
    line last.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.core import (collectives, partition,  # noqa: E402
                              perfmodel, ring, scheduler)
from repro_torch.core.mdk import MDK_REGISTRY  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh, make_production_mesh, make_serving_mesh)
from repro_torch.models import attention, blocks, lm, moe  # noqa: E402
from repro_torch.models.layers import activation_fn, to_device  # noqa: E402
from repro_torch.serving.admission import (  # noqa: E402
    FIFOAdmission, OvercommitAdmission)
from repro_torch.serving.distributed import (  # noqa: E402
    DistributedServeEngine)
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.lifecycle import (  # noqa: E402
    DECODE, PREEMPTED_HOST, PREEMPTED_RECOMPUTE)
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.speculative import (SpecConfig,  # noqa: E402
                                             TokenTree, tree_arrays)
from repro_torch.serving.telemetry import (  # noqa: E402
    Telemetry, modeled_vs_measured, profile_ranges, validate_chrome_trace)
from repro_torch.serving.quantize import (calibrate,  # noqa: E402
                                          quantize_model_params)
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
#: full-width logits, card vs CPU: both round activations to int8 at every
#: linear, so an ulp of difference upstream can flip one rounding; a broken
#: kernel moves the logits by O(1) of their range
LOGIT_REL_TOL = 0.1
#: the reduced-config agreement phase
AGREE_MAX_SEQ, AGREE_PAGE, AGREE_CHUNK = 128, 16, 16
#: speculative serving: chain k, tree k and branch, draft noise (std)
CHAIN_K, TREE_K, TREE_BRANCH, DRAFT_SIGMA = 4, 8, 3, 0.25
SPEC_REQUESTS, SPEC_NEW, SPEC_PROMPT_LENS = 8, 64, (16, 512)
#: the rows' lengths at the timed contiguous decode: spread over the
#: cache, 4,259 keys in all
MHA_TIMED_LENGTHS = (37, 269, 361, 504, 602, 648, 872, 966)
#: ln_res against its plain version: rows, widths (one ragged, one a warp
#: per row), and the rows timed at GPT-2's width (a decode tick's, a
#: prefill chunk's and a large batch's)
LN_ROWS, LN_WIDTHS = (5, 8, 32, 256), (1024, 4096, 1000, 256)
LN_TIMED = (8, 32, 256)
#: ln_res tolerances: y within one bf16 ulp, scale within 1e-5 relative,
#: y_q within 1 everywhere and equal on this share of elements
LN_SCALE_RTOL, LN_YQ_EQUAL = 1e-5, 0.999
#: quant_act against its plain version on the CPU: rows (a decode tick's,
#: a prefill chunk's, whisper's encoder's) and widths (GPT-2's, whisper's,
#: the RoPE family's and gemma's widest, a ragged one); timed at a decode
#: tick's and a prefill chunk's rows at GPT-2's two widths
QA_ROWS, QA_WIDTHS = (1, 32, 127, 1500), (1024, 1280, 4096, 14336, 24576,
                                          1027)
QA_TIMED = ((127, 1024), (127, 4096), (32, 1024), (32, 4096))
#: the RoPE family's head shapes held and timed beside GPT-2's: groups 4
#: and 3 at D 128, and D 256
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
#: replay prefill on phase 5's GPT-2: requests and their prompt lengths
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
#: xlstm's: the near-tie rule's replay of every parting along its calls,
#: then the training phase, took the time)
HYBRID_MAX_SEQ = {"recurrentgemma-9b": 2048, "xlstm-350m": 1024}
HYBRID_LAYERS = {"recurrentgemma-9b": 6, "xlstm-350m": 4}
HYBRID_LONG = (2100, 2400)
#: the recurrent blocks timed alone: (config, kind), at a decode tick's
#: rows and a prefill chunk's tokens
RECURRENT_BLOCKS = (("recurrentgemma-9b", "rglru"), ("xlstm-350m", "mlstm"),
                    ("xlstm-350m", "slstm"))
#: the MoE FFN timed alone: a decode tick's tokens and a prefill chunk's
MOE_TIMED_T = (SLOTS, CHUNK)
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
#: step faster than its bound means a wrong bound or a wrong clock); the
#: dry run's cells on the single production mesh
ANALYSIS_REQUESTS, ANALYSIS_NEW, ANALYSIS_PROMPT_LENS = 8, 32, (64, 256)
ANNOTATED = ("prefill.chunk", "decode.step", "spec.verify", "prefill.round",
             "wave.consume", "wave.dispatch")
RANGE_KERNELS = {"mp_matmul": ("mp_matmul_kernel",),
                 "paged_verify": ("verify::split_kernel",),
                 "paged_mha_decode": ("decode::split_kernel", "Paged")}
ROOFLINE_SHARE_MAX = 1.05
DRYRUN_CELLS = (("gpt2-345m", "train_4k"), ("gpt2-345m", "prefill_32k"),
                ("gpt2-345m", "decode_32k"), ("llama3-8b", "decode_32k"))


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
    _PREFILLED.clear()
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


def verify_split_edges(dev, rng, B=SLOTS):
    """Both verify bodies at the serving widths on rows whose keys end on
    the last position of key split 0, on the first of split 1 and a page
    past it, at base 0, at the end of the table, mid-table and parked;
    chunks of 5, 9 and 32, q float32 and bf16, in batches of ``B`` rows
    (the split geometry follows B: 8 for the single-device engine, a
    shard's 4 or 2 for the distributed one).  Each case is held to its
    plain version per output vector, and a second call must give
    bit-identical output."""
    H, D, n_pg = 16, 64, MAX_SEQ // PAGE
    worst = 0.0
    for C in (5, 9, 32):
        g = ops._verify_geometry(B, C, H, H, PAGE, D, n_pg)
        edge = g.pps * PAGE
        bases = np.array([edge - C, edge - C + 1, edge - C + 1 + PAGE, 0,
                          MAX_SEQ - C, 2 * edge - C, MAX_SEQ // 2,
                          MAX_SEQ], np.int32)
        for lo in range(0, len(bases), B):
            base_np = bases[lo:lo + B]
            live = torch.from_numpy(base_np < MAX_SEQ).to(dev)
            q, kp, vp, bt = pool_inputs(rng, B, H, D, dev, (B, C, H, D))
            base = torch.from_numpy(base_np).to(dev)
            bt = live_table(bt, np.minimum(base_np + C, MAX_SEQ))
            tree = torch.from_numpy(tree_arrays(
                token_trees(rng, B, C - 1, 2), C - 1, C)[3].astype(
                    np.int32)).to(dev)
            for qd in (torch.float32, torch.bfloat16):
                qq = q.to(qd)
                for anc in (None, tree):
                    what = (f"paged_verify"
                            f"{'_tree' if anc is not None else ''} split "
                            f"edges B={B} C={C} q={qd}")
                    got = ops.paged_verify(qq, kp, vp, base, bt, anc=anc)
                    again = ops.paged_verify(qq, kp, vp, base, bt, anc=anc)
                    want = ref.paged_verify_ref(qq, kp, vp, base, bt,
                                                anc=anc)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got[live], want[live])
                    check(rel <= ATTN_REL_TOL, f"{what}: rel err {rel}")
                    check(bool(torch.isfinite(got).all()),
                          f"{what}: non-finite output")
                    check(torch.equal(got, again),
                          f"{what}: two calls differ")
                    worst = max(worst, rel)
        print(f"paged_verify split edges B={B} C={C} (splits of {g.pps} "
              f"pages) bases {bases.tolist()}: causal and tree, q float32 "
              f"and bf16, within {ATTN_REL_TOL} per vector (worst so far "
              f"{worst:.3e}); two calls bit-identical")


def kernel_phase(dev, timer):
    """Phases 3 and 4: each kernel against its plain version, then timed.
    Returns the kernels' JSON entries (launch counts filled in later)."""
    phase("kernel vs plain")
    rng = np.random.default_rng(0)
    entries = {}

    # -- mp_matmul: every (K, N) of the model at M = 1, slots, chunk
    # yardsticks of the timing itself: an empty kernel (a 4-byte fill) and
    # a device-to-device copy of each weight matrix's bytes
    tiny = torch.zeros(1, device=dev)
    floor_ms = timer.ms(lambda: tiny.zero_())
    print(f"timing floor: a 4-byte fill takes {floor_ms:.4f} ms per call")
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "copy_ms": 0.0}
    prefill = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0}
    mp_err = 0.0
    layer_args = {SLOTS: [], CHUNK: []}  # one layer's six calls, profiled
    for K, N in MP_SHAPES:
        for M in (1, SLOTS, CHUNK):
            x, w, xs, ws, _ = mp_inputs(rng, M, K, N, dev)
            if M in layer_args:
                layer_args[M] += [(x, w, xs, ws)] * MP_PER_LAYER[(K, N)]
            got = ops.quant_matmul(x, w, xs, ws, out_dtype=torch.float32)
            want = ref.quant_matmul_ref(x, w, xs, ws, out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            mp_err = max(mp_err, err)
            check(torch.equal(got, want),
                  f"mp_matmul M={M} K={K} N={N}: not bit-identical "
                  f"(max err {err})")
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
            if M == CHUNK:
                prefill["ms"] += n * t
                prefill["plain_ms"] += n * tp
                prefill["bound_ms"] += n * b
                prefill["library_ms"] += n * tl
    for out_dtype, bias in ((torch.bfloat16, False), (torch.float32, True)):
        x, w, xs, ws, bb = mp_inputs(rng, 5, 1000, 300, dev, bias=bias)
        got = ops.quant_matmul(x, w, xs, ws, bb, out_dtype=out_dtype)
        want = ref.quant_matmul_ref(x, w, xs, ws, bb, out_dtype=out_dtype)
        check(torch.equal(got, want),
              f"mp_matmul ragged {out_dtype} bias={bias}: not bit-identical")
    print("mp_matmul ragged (5, 1000, 300) bf16 out / bias: bit-identical")
    # the verifies' token counts (chain k 4 and tree k 8 over 8 rows), with
    # bias and bf16 out; a second call must be bit-identical
    vrng = np.random.default_rng(2)  # the timed shapes keep their inputs
    for M in (SLOTS * (CHAIN_K + 1), SLOTS * (TREE_K + 1)):
        for K, N in MP_SHAPES:
            x, w, xs, ws, bb = mp_inputs(vrng, M, K, N, dev, bias=True)
            got = ops.quant_matmul(x, w, xs, ws, bb)
            again = ops.quant_matmul(x, w, xs, ws, bb)
            want = ref.quant_matmul_ref(x, w, xs, ws, bb)
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"mp_matmul M={M} K={K} N={N}: not bit-identical")
    print(f"mp_matmul M={SLOTS * (CHAIN_K + 1)} and "
          f"{SLOTS * (TREE_K + 1)} at the three shapes, bias, bf16 out: "
          "bit-identical, two calls equal")
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
        "max_abs_err": mp_err, "ms": layer["ms"],
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
    for window, qd in ((0, torch.float32), (128, torch.float32),
                       (0, torch.bfloat16)):
        qq = q.to(qd)
        got = ops.paged_mha_decode(qq, kp, vp, lengths, bt, window=window)
        want = ref.paged_mha_decode_ref(qq, kp, vp, lengths, bt,
                                        window=window)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= ATTN_REL_TOL,
              f"paged_mha_decode window={window} q={qd}: rel err {rel}")
        print(f"paged_mha_decode window={window} q={qd}: max abs err "
              f"{err:.3e} (rel {rel:.3e} <= {ATTN_REL_TOL})")
        if window == 0 and qd == torch.float32:
            dec_err = err
    # the kernel's zero-denominator clamp: a row with no key returns 0
    got = ops.paged_mha_decode(q, kp, vp, torch.zeros_like(lengths), bt)
    check(bool((got == 0).all()), "paged_mha_decode: empty rows not zero")
    # the splits merge in a fixed order
    check(torch.equal(ops.paged_mha_decode(q, kp, vp, lengths, bt),
                      ops.paged_mha_decode(q, kp, vp, lengths, bt)),
          "paged_mha_decode: two calls differ")
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
          f"{lengths_np.tolist()}: kernel {t:.4f} ms, plain {tp:.4f} ms, "
          f"SDPA on the gathered view {tl:.4f} ms, bound {b:.5f} ms ({by}); "
          f"two calls bit-identical; {dgeo}")
    entries["paged_mha_decode"] = {
        "name": "paged_mha_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_mha.cu",
        "replaces": "src/repro/kernels/paged_mha_kernel.py:92",
        "max_abs_err": dec_err, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B={SLOTS} H={H} D={D} ps={PAGE} max_seq={MAX_SEQ}",
        "geometry": dgeo}

    # -- paged_verify: one prefill chunk (B = 1, C = chunk) at base 480,
    #    plus a row parked past the table and a window
    base0 = 480
    q, kp, vp, bt = pool_inputs(rng, 2, H, D, dev, (2, CHUNK, H, D))
    base = torch.tensor([base0, MAX_SEQ], dtype=torch.int32, device=dev)
    bt = live_table(bt, [base0 + CHUNK, MAX_SEQ])
    for window in (0, 100):
        got = ops.paged_verify(q, kp, vp, base, bt, window=window)
        want = ref.paged_verify_ref(q, kp, vp, base, bt, window=window)
        torch.cuda.synchronize()
        err, rel = rel_err(got[0], want[0])  # row 1 is parked: never read
        check(rel <= ATTN_REL_TOL,
              f"paged_verify window={window}: rel err {rel}")
        check(bool(torch.isfinite(got).all()),
              f"paged_verify window={window}: non-finite output")
        print(f"paged_verify window={window}: max abs err {err:.3e} (rel "
              f"{rel:.3e} <= {ATTN_REL_TOL}); parked row finite")
        if window == 0:
            ver_err = err
    # its own generator: the shapes timed after it keep their inputs
    verify_split_edges(dev, np.random.default_rng(1))
    q1, b1, bt1 = (t[:1].contiguous() for t in (q, base, bt))
    t = timer.ms(lambda: ops.paged_verify(q1, kp, vp, b1, bt1))
    tp = timer.ms(lambda: ref.paged_verify_ref(q1, kp, vp, b1, bt1))
    kv = ref.paged_gather_ref(kp, bt1).float()
    vv = ref.paged_gather_ref(vp, bt1).float()
    qpos = base0 + torch.arange(CHUNK, device=dev)
    mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
            <= qpos[:, None])[None, None]
    qh = q1.transpose(1, 2)
    tl = timer.ms(lambda: F.scaled_dot_product_attention(
        qh, kv, vv, attn_mask=mask))
    keys = base0 + CHUNK
    pairs = sum(base0 + j + 1 for j in range(CHUNK))
    nbytes = (2 * keys * H * D * 2 + 2 * CHUNK * H * D * 4 + 4
              + 4 * (keys // PAGE))
    b, by = bound_ms(nbytes, 4 * pairs * H * D, "bf16")
    geo = verify_geometry(q1, kp, bt1)
    PROFILED.append(("paged_verify", "paged_verify", "by_kernel",
                     lambda: ops.paged_verify(q1, kp, vp, b1, bt1),
                     ("verify::",)))
    print(f"paged_verify B=1 C={CHUNK} base={base0}: kernel {t:.4f} ms, "
          f"plain {tp:.4f} ms, SDPA on the gathered view {tl:.4f} ms, "
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


def verify_bases(rng, B, C):
    """Bases at and beside page edges, mid-cache and at the end of the
    table, with the last row parked at ``MAX_SEQ`` (output never read)."""
    fixed = [0, PAGE - 1, PAGE, 2 * PAGE - 1, MAX_SEQ - C]
    mid = rng.integers(PAGE, MAX_SEQ - C, B - 1 - len(fixed))
    return np.array(fixed + sorted(mid.tolist()) + [MAX_SEQ], np.int32)


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
    """The tree-masked verify against its plain version: TokenTree trees
    (branch 2 and 3) and a random mask that is not triangular, at C 5 and
    9, bases at page edges and a parked row; a lower-triangular mask is
    bit-identical to the causal kernel.  Then timed at the tree run's
    verify shape (B = slots, C = 9)."""
    H, D = 16, 64
    worst = 0.0
    for C in (5, 9):
        q, kp, vp, bt = pool_inputs(rng, SLOTS, H, D, dev, (SLOTS, C, H, D))
        base_np = verify_bases(rng, SLOTS, C)
        base = torch.from_numpy(base_np).to(dev)
        bt = live_table(bt, np.minimum(base_np + C, MAX_SEQ))
        masks = {f"TokenTree branch {br}": tree_arrays(
            token_trees(rng, SLOTS, C - 1, br), C - 1, C)[3]
            for br in (2, 3)}
        masks["random"] = rng.integers(0, 2, (SLOTS, C, C)).astype(bool)
        for what, anc_np in masks.items():
            anc = torch.from_numpy(anc_np.astype(np.int32)).to(dev)
            got = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
            want = ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc)
            torch.cuda.synchronize()
            err, rel = rel_err(got[:-1], want[:-1])
            check(rel <= ATTN_REL_TOL,
                  f"paged_verify_tree C={C} {what}: rel err {rel}")
            check(bool(torch.isfinite(got).all()),
                  f"paged_verify_tree C={C} {what}: non-finite output")
            worst = max(worst, err)
            print(f"paged_verify_tree C={C} {what}: max abs err {err:.3e} "
                  f"(rel {rel:.3e} <= {ATTN_REL_TOL}); parked row finite")
        tril = torch.tril(torch.ones((SLOTS, C, C), dtype=torch.int32,
                                     device=dev))
        for qd in (torch.float32, torch.bfloat16):
            qq = q.to(qd)
            same = torch.equal(ops.paged_verify(qq, kp, vp, base, bt,
                                                anc=tril),
                               ops.paged_verify(qq, kp, vp, base, bt))
            check(same, f"paged_verify_tree C={C} q={qd}: a lower-"
                  "triangular mask is not bit-identical to the causal kernel")
        print(f"paged_verify_tree C={C}: lower-triangular mask bit-identical "
              "to the causal kernel (q float32 and bf16)")

    # timed at the tree run's verify shape
    C = TREE_K + 1
    q, kp, vp, bt = pool_inputs(rng, SLOTS, H, D, dev, (SLOTS, C, H, D))
    base_np = np.sort(rng.integers(16, MAX_SEQ - C, SLOTS)).astype(np.int32)
    base = torch.from_numpy(base_np).to(dev)
    bt = live_table(bt, base_np + C)
    anc_np = tree_arrays(token_trees(rng, SLOTS, TREE_K, TREE_BRANCH),
                         TREE_K, C)[3]
    anc = torch.from_numpy(anc_np.astype(np.int32)).to(dev)
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
          f"kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA on the gathered view "
          f"with the tree mask {tl:.4f} ms, bound {b:.5f} ms ({by}); {geo}")
    return {
        "name": "paged_verify_tree", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_verify.cu",
        "replaces": "src/repro/kernels/paged_verify_kernel.py:101",
        "max_abs_err": worst, "ms": t, "plain_ms": tp, "bound_ms": b,
        "bound_by": by, "library_ms": tl,
        "shape": f"B={SLOTS} C={C} H={H} D={D} ps={PAGE} branch "
                 f"{TREE_BRANCH}", "geometry": geo}


def mha_decode_phase(dev, timer, rng):
    """The contiguous decode kernel against its plain version: S 1024 and
    a ragged 1000, all heads or GQA, lengths from 1 to S, window 0 and 128,
    queries and caches in float32 and bf16; a group of 16 query heads on
    one KV head at D 128 (two head chunks); an empty row returns zeros.
    Then timed at the draft model's shape (B = slots, float32 cache: a
    W8A8 engine's activation dtype, in which the draft keeps its cache)
    and at the same shape with a bf16 cache: the element type of the
    stacked target's cache, which ``SlotCacheManager`` allocates in bf16
    whatever the engine's activation dtype."""
    worst = 0.0
    shapes = [(S, 16, Hkv, 64) for S in (MAX_SEQ, 1000) for Hkv in (16, 4)]
    shapes.append((1000, 16, 1, 128))
    B = SLOTS
    for S, H, Hkv, D in shapes:
        lengths_np = np.linspace(1, S, B).astype(np.int32)
        lengths = torch.from_numpy(lengths_np).to(dev)
        for kvd in (torch.float32, torch.bfloat16):
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Hkv, S, D)).astype(np.float32)).to(dev, kvd)
                for _ in range(2))
            q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
                np.float32)).to(dev)
            for window in (0, 128):
                for qd in (torch.float32, torch.bfloat16):
                    qq = q.to(qd)
                    got = ops.mha_decode(qq, k, v, lengths, window=window)
                    want = ref.mha_decode_ref(qq, k, v, lengths,
                                              window=window)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, want)
                    tag = (f"S={S} H={H} Hkv={Hkv} D={D} kv={kvd} "
                           f"window={window} q={qd}")
                    check(rel <= ATTN_REL_TOL,
                          f"mha_decode {tag}: rel err {rel}")
                    worst = max(worst, err)
                    print(f"mha_decode {tag}: max abs err {err:.3e} "
                          f"(rel {rel:.3e} <= {ATTN_REL_TOL})")
            got = ops.mha_decode(q, k, v, torch.zeros_like(lengths))
            check(bool((got == 0).all()),
                  f"mha_decode S={S} Hkv={Hkv} D={D}: empty rows not zero")
    print("mha_decode: rows with no valid key return zeros")

    S, H, D = MAX_SEQ, 16, 64
    k32, v32 = (torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).to(dev) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(dev)
    lengths_np = np.array(MHA_TIMED_LENGTHS, np.int32)
    lengths = torch.from_numpy(lengths_np).to(dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    tot = int(lengths_np.sum())
    rows = {}
    for kvd in (torch.float32, torch.bfloat16):
        k, v = k32.to(kvd), v32.to(kvd)
        got = ops.mha_decode(q, k, v, lengths)
        want = ref.mha_decode_ref(q, k, v, lengths)
        again = ops.mha_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= ATTN_REL_TOL and torch.equal(got, again),
              f"mha_decode timed shape kv={kvd}: rel err {rel}, or two calls "
              "differ")
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
              f"{lengths_np.tolist()} ({tot} keys): kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, SDPA on the contiguous cache {tl:.4f} ms, bound "
              f"{b:.5f} ms ({by}); two calls bit-identical; geometry: "
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


def bf16_ulp(a):
    """The spacing of bf16 values around float32 ``a``."""
    mag = a.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ln_res_check(got, want):
    """``got`` against ``want`` (ln_res outputs) under the stated
    tolerances: the new residual bit-identical, ``scale`` within
    ``LN_SCALE_RTOL``, ``y`` within one bf16 ulp per element, ``y_q``
    within 1 and equal on ``LN_YQ_EQUAL`` of elements.  Returns (faults,
    largest y error, share of equal y_q)."""
    bad = []
    gy, wy = got[0].float(), want[0].float()
    if [t.dtype for t in got] != [t.dtype for t in want] \
            or [t.shape for t in got] != [t.shape for t in want]:
        bad.append("dtypes or shapes differ")
        return bad, float("inf"), 0.0
    if not torch.equal(got[1], want[1]):
        bad.append("r not bit-identical")
    if not ((got[3] - want[3]).abs() <= LN_SCALE_RTOL * want[3].abs()).all():
        bad.append(f"scale beyond {LN_SCALE_RTOL} relative")
    if not ((gy - wy).abs() <= torch.maximum(bf16_ulp(gy),
                                             bf16_ulp(wy))).all():
        bad.append("y beyond one bf16 ulp")
    dq = (got[2].int() - want[2].int()).abs()
    eq = (dq == 0).float().mean().item()
    if dq.max().item() > 1 or eq < LN_YQ_EQUAL:
        bad.append(f"y_q beyond 1 or equal on < {LN_YQ_EQUAL}")
    return bad, (gy - wy).abs().max().item(), eq


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
    """The Fused LN&Res kernel against its plain version: rows 5, 8, 32
    and 256, widths 1024, 4096, a ragged 1000 and 256 (a block of 256
    threads per row at every width), LayerNorm and RMSNorm,
    x and res in float32 and bf16 (one row block with a large mean).  Then
    timed at B 8, 32 and 256 x D 1024 (float32 x and res), beside
    ``F.layer_norm`` of the sum (the norm alone: no residual output and no
    quantization)."""
    worst, worst_eq = 0.0, 1.0
    for kind in ("layernorm", "rmsnorm"):
        for dtype in (torch.float32, torch.bfloat16):
            for B in LN_ROWS:
                for D in LN_WIDTHS:
                    x, res, w, b = ln_res_inputs(
                        rng, B, D, dtype, dev,
                        mean=3000.0 if B == 32 else 0.0)
                    got = ops.ln_res(x, res, w, b, kind=kind)
                    want = ref.ln_res_ref(x, res, w, b, kind=kind)
                    torch.cuda.synchronize()
                    bad, err, eq = ln_res_check(got, want)
                    check(not bad, f"ln_res {kind} {dtype} B={B} D={D}: "
                          f"{bad}")
                    worst, worst_eq = max(worst, err), min(worst_eq, eq)
            print(f"ln_res {kind} x/res {dtype}: B {LN_ROWS} x D "
                  f"{LN_WIDTHS} within tolerance (r bit-identical, scale "
                  f"<= {LN_SCALE_RTOL} rel, y <= 1 bf16 ulp, y_q <= 1)")
    print(f"ln_res: largest y error {worst:.3e}, smallest share of equal "
          f"y_q {worst_eq:.6f} (>= {LN_YQ_EQUAL})")
    timed = {}
    D = 1024
    for B in LN_TIMED:
        x, res, w, b = ln_res_inputs(rng, B, D, torch.float32, dev)
        t = timer.ms(lambda: ops.ln_res(x, res, w, b))
        tp = timer.ms(lambda: ref.ln_res_ref(x, res, w, b))
        tn = timer.ms(lambda: F.layer_norm(x + res, (D,), w, b))
        bnd, by = bound_ms(ln_res_bytes(B, D, 4, 4), 12 * B * D, "f32")
        timed[B] = (t, tp, tn, bnd, by)
        field = "by_kernel" if B == LN_TIMED[0] else f"B{B}_by_kernel"
        PROFILED.append((f"ln_res B={B}", "ln_res", field,
                         lambda x=x, res=res, w=w, b=b: ops.ln_res(
                             x, res, w, b), ("ln_res_kernel",)))
        print(f"ln_res B={B} D={D} float32: kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, library none (F.layer_norm of the sum, the "
              f"norm alone: {tn:.4f} ms), bound {bnd:.6f} ms ({by}); "
              f"{B} blocks of {ops._LN_THREADS} threads, "
              f"{8 * ops._ln_res_chunks(D)} values a thread")
    (t, tp, tn, bnd, by) = timed[LN_TIMED[0]]
    entry = {
        "name": "ln_res", "route": "cuda",
        "source": "src/repro_torch/csrc/ln_res.cu",
        "replaces": "src/repro/kernels/ln_res_kernel.py:64",
        "max_abs_err": worst, "ms": t, "plain_ms": tp, "bound_ms": bnd,
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
    """The activation quantization kernel against its plain version run
    on the CPU, bit for bit, at ``QA_ROWS`` x ``QA_WIDTHS`` with x in
    float32 and bf16; how many rows' scales the plain version's ATen ops
    on the card put a last place away from the CPU's; then timed at
    ``QA_TIMED`` (float32 x, as the W8A8 engines run) beside the plain
    version on the card."""
    cpu = torch.device("cpu")
    aten_off = aten_rows = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in QA_ROWS:
            for K in QA_WIDTHS:
                x, s = quant_act_inputs(rng, M, K, dtype, dev)
                q, sc = ops.quant_act(x, s)
                wq, wsc = ref.quant_act_ref(x.to(cpu), s.to(cpu))
                check(torch.equal(q.cpu(), wq) and torch.equal(sc.cpu(), wsc),
                      f"quant_act {dtype} M={M} K={K}: not bit-identical "
                      "to the plain version on the CPU")
                _, asc = ref.quant_act_ref(x, s)
                aten_off += int((asc.cpu() != wsc).sum())
                aten_rows += M
        print(f"quant_act x {dtype}: M {QA_ROWS} x K {QA_WIDTHS} "
              "bit-identical to the plain version on the CPU")
    print(f"quant_act: the plain version's ATen ops on the card give "
          f"{aten_off} of {aten_rows} rows another scale than the CPU")
    rows = []
    for M, K in QA_TIMED:
        x, s = quant_act_inputs(rng, M, K, torch.float32, dev)
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
        print(f"quant_act M={M} K={K} float32: kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, library none, bound {bnd:.6f} ms ({by}); "
              f"{M} blocks of {threads} threads, {nv} chunks a thread")
    return {
        "name": "quant_act", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_act.cu", "replaces": None,
        "max_abs_err": 0.0, "ms": rows[0]["ms"],
        "plain_ms": rows[0]["plain_ms"], "bound_ms": rows[0]["bound_ms"],
        "bound_by": rows[0]["bound_by"], "library_ms": None,
        "shape": f"M={QA_TIMED[0][0]} K={QA_TIMED[0][1]} float32",
        "timed": rows, "aten_scale_off": [aten_off, aten_rows]}


def attn_row(rows, timer, kernel, label, shape, call, plain, lib, nbytes,
             ops_, keys, empty_zero=None):
    """Hold one attention call to its plain version per output vector
    (``ATTN_REL_TOL``), a second call bit-identical and, with
    ``empty_zero``, empty decode rows zero; then time it beside its plain
    version, SDPA (``lib``) and its bound, append the row to
    ``rows[kernel]`` and queue the call for the profiler phase."""
    got, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    what = f"{kernel} {label} {shape}"
    check(rel <= ATTN_REL_TOL, f"{what}: rel err {rel}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.equal(got, again), f"{what}: two calls differ")
    if empty_zero is not None:
        check(bool((empty_zero() == 0).all()),
              f"{what}: empty rows not zero")
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
          f"{ATTN_REL_TOL}), two calls bit-identical; kernel {t:.4f} ms, "
          f"plain {tp:.4f} ms, SDPA {tl:.4f} ms, bound {b:.5f} ms ({by})")


def paged_rows(dev, timer, rng, rows, label, H, Hkv, D, max_seq,
               lengths_np, verifies):
    """``paged_mha_decode`` on ``len(lengths_np)`` rows of those lengths
    and ``paged_verify`` at each ``(kernel, B, C, bases)`` of
    ``verifies`` (``bases`` None: sorted random ones), over pages of
    ``PAGE`` positions in a table of ``max_seq``, through
    :func:`attn_row`; a lower-triangular mask must give the causal
    kernel's output bit for bit."""
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
             4 * tot * H * D, ("decode::", "verify::combine"),
             empty_zero=partial(ops.paged_mha_decode, q, kp, vp,
                                torch.zeros_like(lengths), bt))
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
        if anc is None:
            tril = torch.tril(torch.ones((B, C, C), dtype=torch.int32,
                                         device=dev))
            check(torch.equal(ops.paged_verify(q, kp, vp, base, bt,
                                               anc=tril),
                              ops.paged_verify(q, kp, vp, base, bt)),
                  f"paged_verify {label} B={B} C={C}: a lower-"
                  "triangular mask differs from the causal kernel")


def wide_heads_phase(dev, timer):
    """The three attention kernels at the RoPE family's and olmoe's heads:
    D 128 with groups 4 (``llama3-8b``: 32 heads over 8), 3
    (``minitron-4b``: 24 over 8, 15 of a verify tile's 16 rows used) and
    1 (``olmoe-1b-7b``: 16 over 16), and D 256 (``gemma-7b``: 16 over 16,
    Q staged in shared memory and P V split over two blocks in the
    verify, a float32 contiguous cache on blocks of 2 warps).  Each
    call is held to its plain version per output vector, a second call
    must be bit-identical and an empty decode row zero; then each is
    timed at its serving shape beside its plain version, SDPA and its
    bound (:func:`attn_row`).  Returns {kernel: [row, ...]}."""
    phase("kernel vs plain at the RoPE family's and olmoe's heads (D 128 "
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
                     ("decode::", "verify::"),
                     empty_zero=partial(ops.mha_decode, q, k, v,
                                        torch.zeros_like(lengths)))
        del k32, v32
    return rows


def family_mp_phase(dev, timer):
    """``mp_matmul`` at the RoPE family's and olmoe's widths: every (K, N)
    of a decoder layer of ``WIDE_ARCHS`` (olmoe's: q, k, v and out; its
    experts are not quantized) and the untied heads (``llama3-8b``: N
    128,256; ``minitron-4b``: 256,000; ``olmoe-1b-7b``: 50,304),
    bit-identical to its plain version
    at a decode tick's rows, a prefill chunk's and a chain verify's (8,
    32, 40), with bias and bf16 out, two calls equal.  Then one decoder
    layer's calls and the head timed at M 8 and 32 (beside
    ``torch._int_mm`` and the same epilogue at 32), float32 out as in a
    W8A8 engine.  Returns the rows."""
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
    """``mp_matmul`` at the (K, N) of ``calls`` (one layer's, or a head):
    bit-identical to its plain version at a decode tick's rows, a prefill
    chunk's and a chain verify's (8, 32, 40), with bias and bf16 out, two
    calls equal; then all the calls timed together at M 8 and 32 (beside
    ``torch._int_mm`` and the same epilogue at 32), float32 out as in a
    W8A8 engine.  Returns one row per timed M."""
    rows = []
    for M in (SLOTS, CHUNK, SLOTS * (CHAIN_K + 1)):
        seen = {}
        for K, N in calls:
            if (K, N) not in seen:
                args = mp_inputs(rng, M, K, N, dev, bias=True)
                got = ops.quant_matmul(*args)
                again = ops.quant_matmul(*args)
                want = ref.quant_matmul_ref(*args)
                check(torch.equal(got, want) and torch.equal(got, again),
                      f"mp_matmul {arch} M={M} K={K} N={N}: not "
                      "bit-identical")
                seen[(K, N)] = args[:4]
        if M == CHAIN_K * SLOTS + SLOTS:
            continue
        t = tp = b = 0.0
        for K, N in calls:
            x, w, xs, ws = seen[(K, N)]
            # float32 out, as a W8A8 engine's activations
            t += timer.ms(partial(ops.quant_matmul, x, w, xs, ws,
                                  out_dtype=torch.float32))
            tp += timer.ms(partial(ref.quant_matmul_ref, x, w, xs, ws,
                                   out_dtype=torch.float32))
            b += bound_ms(M * K + K * N + 4 * (M + N) + 4 * M * N,
                          2 * M * K * N, "int8")[0]
        tl = None
        if M > 16:  # torch._int_mm takes M > 16 only
            tl = sum(timer.ms(partial(
                lambda x, w, xs, ws: (torch._int_mm(x, w).float() * xs) * ws,
                *seen[kn])) for kn in calls)
        rows.append({"model": arch, "shape": f"{what}, {len(calls)} calls "
                     f"{sorted(set(calls))} at M={M}", "ms": t,
                     "plain_ms": tp, "library_ms": tl, "bound_ms": b,
                     "bound_by": "bytes"})
        print(f"mp_matmul {arch} {what} ({len(calls)} calls) at M={M}: "
              f"bit-identical at M {SLOTS}, {CHUNK} and "
              f"{SLOTS * (CHAIN_K + 1)}, two calls equal; kernel {t:.4f} "
              f"ms, plain {tp:.4f} ms, library "
              f"{'n/a (M <= 16)' if tl is None else f'{tl:.4f}'} ms, bound "
              f"{b:.5f} ms")
    return rows


def moe_ffn_phase(dev, timer):
    """One full-width ``olmoe-1b-7b`` layer's MoE FFN (64 float32 experts
    of 2048 x 1024, top 8, exact capacity) at a decode tick's 8 tokens and
    a prefill chunk's 32: the output finite, and at 8 tokens equal in
    routing to the CPU's and within ``1e-4`` of its largest magnitude;
    then timed whole, its router and slot assignment alone, and its three
    expert products alone (on a buffer of the padded shape), beside the
    bytes bound (the three banks read once) and the operations bound of
    the padded products at the float32 peak.  Not a kernel of the port:
    plain PyTorch, as the reference's ``jnp.einsum``.  Returns the rows."""
    phase("the MoE FFN alone (one full-width olmoe-1b-7b layer, float32 "
          "experts, exact capacity)")
    cfg = get_config("olmoe-1b-7b")
    E, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.experts_per_token
    p = moe.moe_init(torch.Generator(device=dev).manual_seed(5), cfg,
                     device=dev)
    act = activation_fn(cfg.activation)
    rng = np.random.default_rng(10)
    rows = []
    for T in MOE_TIMED_T:
        shape = (T, 1, d) if T == SLOTS else (1, T, d)
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        out, aux = moe.moe_apply(p, x, cfg)
        check(out.shape == x.shape and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(aux)), f"MoE FFN T={T}: shape or "
              "non-finite output")
        if T == SLOTS:
            pc = to_device(p, torch.device("cpu"))
            want, _ = moe.moe_apply(pc, x.cpu(), cfg)
            same = torch.equal(moe.route(p, x.reshape(T, d), cfg, None)[1]
                               .cpu(), moe.route(pc, x.cpu().reshape(T, d),
                                                 cfg, None)[1])
            err, rel = rel_err(out.cpu().reshape(T, d), want.reshape(T, d))
            check(same and rel <= 1e-4, f"MoE FFN T={T} card vs CPU: "
                  f"routing equal {same}, rel err {rel}")
            print(f"MoE FFN T={T} card vs CPU: the same experts, max abs "
                  f"err {err:.3e} (rel {rel:.3e} <= 1e-4)")
            del pc
        C = moe.capacity(cfg, T, None)
        buf = torch.from_numpy(rng.standard_normal((E, C, d)).astype(
            np.float32)).to(dev)

        def products(buf=buf):
            h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
            return torch.bmm(h, p["w_down"])

        t = timer.ms(partial(moe.moe_apply, p, x, cfg))
        t_route = timer.ms(partial(moe.route, p, x.reshape(T, d), cfg, None))
        t_prod = timer.ms(products)
        t_one = timer.ms(partial(torch.bmm, buf, p["w_up"]))
        nbytes = 3 * E * d * f * 4 + d * E * 4 + 2 * T * d * 4
        b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        b_ops = 1e3 * 3 * 2 * E * C * d * f / PEAK_OPS["f32"]
        b_useful = 1e3 * 3 * 2 * T * k * d * f / PEAK_OPS["f32"]
        r = {"T": T, "C": C, "ms": t, "route_ms": t_route,
             "products_ms": t_prod, "one_product_ms": t_one,
             "bytes_bound_ms": b_bytes, "padded_ops_bound_ms": b_ops,
             "useful_ops_bound_ms": b_useful,
             "padded_gflop": 3 * 2 * E * C * d * f / 1e9}
        rows.append(r)
        print(f"MoE FFN T={T} (C {C} slots per expert): {t:.4f} ms whole, "
              f"router and slots {t_route:.4f} ms, the three products "
              f"{t_prod:.4f} ms (one: {t_one:.4f} ms); bounds: bytes "
              f"{b_bytes:.4f} ms ({nbytes / 1e9:.3f} GB), padded products "
              f"{b_ops:.4f} ms ({r['padded_gflop']:.1f} GFLOP at the "
              f"float32 peak), useful products {b_useful:.4f} ms")
        del buf
    print(json.dumps({"moe_ffn": rows}))
    del p
    torch.cuda.empty_cache()
    return rows


def moe_experts_phase(dev, timer):
    """The grouped experts kernel (``ops.moe_experts``) at
    olmoe-1b-7b-0924's widths, uniform random top-8 choices of a float32
    stream at ``MOE_EXPERTS_T`` tokens: held to its plain version on the
    card (a per-expert loop of cuBLAS products) within ``MOE_REL_TOL`` per
    output row and ``MOE_DIFF_SHARE`` of elements, two calls
    bit-identical; then timed beside its plain version, the padded path it
    replaced (zero-filled scatter into (E, T k, d), three ``torch.bmm``,
    ``layers.silu``, the gather: the library yardstick) and its bound, the
    touched experts' banks read once.  A reduced published-form engine
    counts its launches.  Returns ``(entry, launches)``."""
    phase("the grouped MoE experts kernel (olmoe-1b-7b-0924's widths)")
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

        got, again, want = call(), call(), plain()
        lib = padded()
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
        check(torch.equal(got, again), f"moe_experts T={T}: two calls differ")
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
              f"{share:.4%} of elements differ, two calls bit-identical, "
              f"padded path rel err {lib_rel:.3e} ({lib_share:.4%} differ; "
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
    calls = eng.stats()["model_calls"]
    check(n == 2 * cfg.n_layers * calls > 0, f"moe_experts: {n} launches "
          f"for {calls} model calls of {cfg.n_layers} MoE layers")
    print(f"moe_experts: {n} launches in the reduced published-form "
          f"engine's {calls} model calls (two a layer)")
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


def mp_per_call(cfg) -> int:
    """``mp_matmul`` launches of one model call: q, k, v and out of each
    attention layer, in_proj and out_proj of each RG-LRU, qkv, o_gate and
    out of each mLSTM (sLSTM's gates and a MoE's experts stay float), the
    MLP's two or three and an untied head."""
    per_kind = {"attn": 4, "local_attn": 4, "rglru": 2, "mlstm": 3,
                "slstm": 0}
    ffn = 0 if (cfg.n_experts or not cfg.d_ff) else (
        3 if cfg.activation in ("swiglu", "geglu") else 2)
    return sum(per_kind[k] + (ffn if k != "slstm" else 0)
               for k in map(cfg.block_kind, range(cfg.n_layers))) + (
        not cfg.tie_embeddings)


def hybrid_kernels_phase(dev, timer):
    """The two kernels of the hybrid stacks' path at their shapes.
    ``mha_decode`` on ``recurrentgemma-9b``'s ring: 8 rows of 16 query
    heads (float32, a W8A8 engine's) over one KV head of 256 on a bf16
    ring of W = 2,048 slots, at the lengths the ring decode passes
    (``min(len, W) + 1``: W + 1 once the ring is full) and shorter ones;
    held to its plain version per output vector, two calls bit-identical,
    a row at W + 1 bit-identical to the same row at W; timed beside its
    plain version, SDPA and its bound.  ``mp_matmul`` at every quantized
    (K, N) of a ``recurrentgemma-9b`` RG-LRU layer and local-attention
    layer (each with its GeGLU MLP) and of an ``xlstm-350m`` mLSTM layer,
    as ``mp_rows`` holds and times them.  Returns ({"mha_decode": rows,
    "mp_matmul": rows})."""
    phase("kernels at the hybrid stacks' shapes (recurrentgemma-9b's ring, "
          "both stacks' linears)")
    rng = np.random.default_rng(12)
    cfg = get_config("recurrentgemma-9b")
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    lengths_np = np.array([W + 1, W + 1, W, 1, 300, 1024, W - 1, 1700],
                          np.int32)
    q = torch.from_numpy(rng.standard_normal((SLOTS, H, D)).astype(
        np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((SLOTS, Hkv, W, D)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    for t in (q, k, v):
        t[2] = t[1]  # rows 1 and 2: one query and ring, lengths W + 1, W
    lengths = torch.from_numpy(lengths_np).to(dev)
    call = partial(ops.mha_decode, q, k, v, lengths)
    got, again = call(), call()
    want = ref.mha_decode_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    label = f"recurrentgemma-9b ring (H {H} / Hkv {Hkv}, D {D})"
    check(rel <= ATTN_REL_TOL and torch.equal(got, again)
          and torch.equal(got[1], got[2]),
          f"mha_decode {label}: rel err {rel}, two calls differ, or W + 1 "
          "differs from W")
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
          f"{rel:.3e} <= {ATTN_REL_TOL}), two calls bit-identical, W + 1 = "
          f"W; kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA {tl:.4f} ms, "
          f"bound {b:.5f} ms ({by})")
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


def recurrent_block_phase(dev, timer):
    """One full-width W8A8 block of each recurrent kind (RG-LRU of
    ``recurrentgemma-9b`` with its GeGLU MLP; mLSTM and sLSTM of
    ``xlstm-350m``), timed as the engine calls it: a decode step of 8
    rows and a prefill chunk of 32 tokens, beside the bytes the call must
    move (the block's weights, its state read and written, the
    activations in and out).  The recurrences run in plain PyTorch, as
    in the reference; the output must be finite.  Returns the rows."""
    phase("recurrent blocks (full width, W8A8, plain PyTorch recurrences)")
    rows = []
    for arch, kind in RECURRENT_BLOCKS:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(3)
        p = blocks.block_init(gen, cfg, kind, device=dev)
        qp = quantize_model_params({"layers": [p]}, cfg)["layers"][0]
        del p
        w_bytes = sum(t.numel() * t.element_size() for t in _tensors(qp))
        ts = {}
        for T in (SLOTS, CHUNK):
            B, C = (T, 1) if T == SLOTS else (1, T)
            x = torch.randn((B, C, cfg.d_model), generator=gen, device=dev)
            cache = blocks.block_init_cache(cfg, kind, B, MAX_SEQ,
                                            device=dev)
            s_bytes = sum(t.numel() * t.element_size()
                          for t in cache.values())
            if T == SLOTS:
                lengths = torch.arange(1, B + 1, dtype=torch.int32,
                                       device=dev) * 100
                call = partial(blocks.block_apply_step, qp, x, cache,
                               lengths, cfg, kind)
            else:
                pos = 100 + torch.arange(C, device=dev)[None]
                call = partial(blocks.block_apply_chunk, qp, x, cache, cfg,
                               kind, positions=pos)
            out = call()[0]
            check(bool(torch.isfinite(out).all()),
                  f"{kind} block T={T}: non-finite output")
            t = timer.ms(call)
            nbytes = w_bytes + 2 * s_bytes + 2 * x.numel() * 4
            b = 1e3 * nbytes / HBM_BYTES_PER_S
            ts[T] = (t, b)
            rows.append({"model": arch, "kind": kind, "T": T, "ms": t,
                         "bound_ms": b, "bound_by": "bytes",
                         "bytes": nbytes})
        print(f"{kind} block ({arch}, W8A8 weights {w_bytes / 2**20:.1f} "
              f"MiB): T={SLOTS} decode step {ts[SLOTS][0]:.4f} ms against "
              f"a bytes bound of {ts[SLOTS][1]:.5f} ms; T={CHUNK} prefill "
              f"chunk {ts[CHUNK][0]:.4f} ms against {ts[CHUNK][1]:.5f} ms")
        del qp
        torch.cuda.empty_cache()
    print(json.dumps({"recurrent_blocks": rows}))
    return rows


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
    phase(f"kernel vs plain at the mixed stack's attn layers (H {H} / Hkv "
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
    _PREFILLED.clear()
    torch.cuda.empty_cache()
    print(f"mixed stack: freed; memory allocated now "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


def family_serving_phase(dev, arch):
    """Full-width W8A8 serving of a RoPE dense or MoE config (whose router
    and float32 expert banks stay unquantized): random weights from
    a seeded generator, SmoothQuant calibrated on 2 x 128 seeded tokens,
    the engine settings of phase 5, 8 requests of 64 new tokens on prompts
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
            _sync(dev)
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
    # what the deterministic algorithms cost: three more steps without
    state, times = tr.state, []
    for i in range(3):
        batch = batch_to_tensors(data.batch_at(TRAIN_STEPS + i), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    print(f"steps without deterministic algorithms: median "
          f"{1e3 * float(np.median(times)):.1f} ms (with: {ms:.1f} ms)")
    return launches


def mdk_program_phase(dev, qparams, cfg):
    """Walk the ``ln_res`` stages of the per-token stage program
    (``l{i}.ln1``, ``l{i}.ln2``, ``final_ln``) through
    ``MDK_REGISTRY["ln_res"]``, with each stage's LayerNorm weight and
    bias from the full-width parameters, at a decode tick's rows and a
    prefill chunk's; each output against the plain version.  Returns the
    kernel's launches in this walk."""
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
    runs = []
    ops.reset_launch_counts()
    for rows in (SLOTS, CHUNK):
        for st in stages:
            x, res, _, _ = ln_res_inputs(rng, rows, cfg.d_model,
                                         torch.float32, dev)
            p = norm_params(st.name)
            runs.append((st.name, rows, x, res, p,
                         fn(x, res, p["w"], p.get("b"), kind=cfg.norm)))
    torch.cuda.synchronize()
    launches = ops.launch_counts()["ln_res"]
    worst = 0.0
    for name, rows, x, res, p, got in runs:
        want = ref.ln_res_ref(x, res, p["w"], p.get("b"), kind=cfg.norm)
        bad, err, _ = ln_res_check(got, want)
        check(not bad, f"MDK stage {name} rows {rows}: {bad}")
        worst = max(worst, err)
    check(launches == len(runs), f"MDK program: {launches} ln_res launches "
          f"for {len(runs)} stage calls")
    print(f"MDK program: {len(stages)} ln_res stages ({stages[0].name} .. "
          f"{stages[-1].name}) x rows ({SLOTS}, {CHUNK}) through "
          f"MDK_REGISTRY['ln_res']: {launches} launches, each within "
          f"tolerance of the plain version (largest y error {worst:.3e})")
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


class ScheduleProbe:
    """While entered, records the model calls ``eng`` makes for each
    request, by request id, in order: each prefill chunk (its offset,
    tokens and valid count), decode step (the position and the token fed)
    and verify call (its base, the row's tokens, its width, its valid
    count where the engine passed one, a tree's mask and depths, and the
    accepted path a compaction moved), and how many tokens of the stream
    each call emitted.  ``lm``'s serving entry points and the engine's
    ``_emit`` are patched for the run, as :class:`RouterProbe` patches the
    router; calls with other params (a draft model's) pass through
    unrecorded.  The port's modules get no hook: :func:`logits_after`
    replays these calls to recompute what the served stream sampled
    from."""

    def __init__(self, eng):
        self.eng = eng
        self.calls = {}

    @staticmethod
    def _host(t):
        # a copy: on the CPU the engine's tensors share its numpy buffers
        return None if t is None else t.to("cpu", copy=True)

    def _add(self, slot, **call):
        call["emitted"] = 0
        self.calls.setdefault(self.eng.slots[slot].rid, []).append(call)

    def __enter__(self):
        eng = self.eng
        self._saved = saved = (lm.prefill_into_slot, lm.decode_step,
                               lm.verify_chunk, lm.compact_accepted_path)
        prefill, step, verify, compact = saved

        def prefill_(params, cfg, tokens, cache, offset, **kw):
            if params is eng.params:
                self._add(kw["slot"], kind="prefill", pos=int(offset),
                          tokens=self._host(tokens),
                          valid=int(kw["valid"]))
            return prefill(params, cfg, tokens, cache, offset, **kw)

        def step_(params, cfg, token, cache, lengths, **kw):
            if params is eng.params:
                tok, lens = self._host(token), self._host(lengths)
                for b in torch.nonzero(kw["active"].cpu()).flatten().tolist():
                    self._add(b, kind="step", pos=int(lens[b]),
                              tokens=tok[b])
            return step(params, cfg, token, cache, lengths, **kw)

        def verify_(params, cfg, tokens, cache, lengths, **kw):
            if params is eng.params:
                toks, lens = self._host(tokens), self._host(lengths)
                valids = self._host(kw.get("valids"))
                anc = self._host(kw.get("anc"))
                depths = self._host(kw.get("depths"))
                for b, req in enumerate(eng.slots):
                    # a parked row: no valid token, or past the cache
                    if req is None or (int(lens[b]) >= eng.max_seq
                                       if valids is None else
                                       int(valids[b]) == 0):
                        continue
                    self._add(b, kind="verify", pos=int(lens[b]),
                              tokens=toks[b],
                              valid=None if valids is None
                              else int(valids[b]),
                              anc=None if anc is None else anc[b],
                              depths=None if depths is None else depths[b])
            return verify(params, cfg, tokens, cache, lengths, **kw)

        def compact_(cfg, cache, src, dst, **kw):
            if cache is eng.kv.cache:
                for b, req in enumerate(eng.slots):
                    if req is not None and req.rid in self.calls:
                        self.calls[req.rid][-1]["path"] = self._host(src[b])
            return compact(cfg, cache, src, dst, **kw)

        emit = eng._emit

        def emit_(req, tok, now):
            self.calls[req.rid][-1]["emitted"] += 1
            return emit(req, tok, now)

        (lm.prefill_into_slot, lm.decode_step, lm.verify_chunk,
         lm.compact_accepted_path) = prefill_, step_, verify_, compact_
        eng._emit = emit_
        return self

    def __exit__(self, *exc):
        (lm.prefill_into_slot, lm.decode_step, lm.verify_chunk,
         lm.compact_accepted_path) = self._saved
        del self.eng._emit
        self.eng = None


class DistScheduleProbe(ScheduleProbe):
    """:class:`ScheduleProbe` for a ``DistributedServeEngine``: the
    sharded entry points (``lm.sharded_prefill_into_slot``,
    ``sharded_decode_step``, ``sharded_verify_chunk``) are patched, where
    row b of shard s is the engine's global slot ``s * Bs + b``, so each
    request's calls are recorded as a single-device engine's are, for
    :func:`logits_after` to replay with ``rows = Bs``.  The tree's path
    compaction is not recorded: no distributed run here takes the
    tree."""

    def __enter__(self):
        eng = self.eng
        check(eng.spec is None or not eng.spec.tree,
              "DistScheduleProbe: a tree run's compaction is not recorded")
        Bs, host = eng.Bs, self._host
        self._saved = saved = (lm.sharded_prefill_into_slot,
                               lm.sharded_decode_step,
                               lm.sharded_verify_chunk)
        prefill, step, verify = saved

        def prefill_(params, cfg, mesh, tokens, caches, slots, offsets,
                     valids, actives, **kw):
            if params is eng.shard_params:
                for s in range(mesh.size):
                    if actives[s]:
                        self._add(s * Bs + int(slots[s]), kind="prefill",
                                  pos=int(offsets[s]),
                                  tokens=host(tokens[s]),
                                  valid=int(valids[s]))
            return prefill(params, cfg, mesh, tokens, caches, slots,
                           offsets, valids, actives, **kw)

        def step_(params, cfg, mesh, tokens, caches, lengths, **kw):
            if params is eng.shard_params:
                for s in kw["shards"]:
                    tok, lens = host(tokens[s]), host(lengths[s])
                    act = host(kw["actives"][s])
                    for b in torch.nonzero(act).flatten().tolist():
                        self._add(s * Bs + b, kind="step", pos=int(lens[b]),
                                  tokens=tok[b])
            return step(params, cfg, mesh, tokens, caches, lengths, **kw)

        def verify_(params, cfg, mesh, tokens, caches, lengths, **kw):
            if params is eng.shard_params:
                for s in kw["shards"]:
                    toks, lens = host(tokens[s]), host(lengths[s])
                    valids = (None if kw.get("valids") is None
                              else host(kw["valids"][s]))
                    for b in range(Bs):
                        req = eng.slots[s * Bs + b]
                        if req is None or (int(lens[b]) >= eng.max_seq
                                           if valids is None else
                                           int(valids[b]) == 0):
                            continue
                        self._add(s * Bs + b, kind="verify",
                                  pos=int(lens[b]), tokens=toks[b],
                                  valid=None if valids is None
                                  else int(valids[b]), anc=None,
                                  depths=None)
            return verify(params, cfg, mesh, tokens, caches, lengths, **kw)

        emit = eng._emit

        def emit_(req, tok, now):
            self.calls[req.rid][-1]["emitted"] += 1
            return emit(req, tok, now)

        (lm.sharded_prefill_into_slot, lm.sharded_decode_step,
         lm.sharded_verify_chunk) = prefill_, step_, verify_
        eng._emit = emit_
        return self

    def __exit__(self, *exc):
        (lm.sharded_prefill_into_slot, lm.sharded_decode_step,
         lm.sharded_verify_chunk) = self._saved
        del self.eng._emit
        self.eng = None


def _route_at(n, pos0):
    if RouterProbe.active is not None:
        RouterProbe.active.at(n, pos0)


def logits_after(params, cfg, calls, prompt, history, dev, *,
                 max_seq=AGREE_MAX_SEQ, page=AGREE_PAGE, chunk=AGREE_CHUNK,
                 rows=1, layout="paged"):
    """The logits a served stream sampled its token ``len(history)`` from,
    recomputed on ``dev`` along the request's own call schedule ``calls``
    (:class:`ScheduleProbe`): every prefill chunk, decode step and verify
    call up to the one that emitted that token, replayed with the tokens,
    widths and valid counts the engine gave it, a verify's accepted
    prefix committed as the engine commits it (the ring and state rewind,
    an accepted tree path compacted), on the paged or the stacked cache.
    The request is row 0 of a batch of ``rows`` (the others parked), so
    every call has the engine's shapes: the float32 matrix products round
    differently at different row counts.  The tokens fed must be
    ``prompt + history`` (the shared history of the two streams held), or
    the probe is at fault.  A schedule that starts past position 0 (a
    shared prefix) is prefilled below it in chunks of ``chunk`` from 0.
    The cache after the schedule's leading prefill chunks is kept for
    later calls with the same model, chunks and shapes (the near-tie rule
    asks both computations at each parting, whose prefills are often the
    same calls), which start from a copy."""
    full = list(prompt) + list(history)
    n = len(history)
    paged = layout == "paged"
    f32 = torch.float32
    lengths = torch.full((rows,), max_seq, dtype=torch.int32)
    active = torch.zeros(rows, dtype=torch.bool, device=dev)
    active[0] = True
    if paged:
        n_pg = max_seq // page
        bt = torch.arange(1, 1 + n_pg, dtype=torch.int32, device=dev)
        bts = torch.zeros((rows, n_pg), dtype=torch.int32, device=dev)
        bts[0] = bt
        into, step, ver = ({"block_table": bt}, {"block_table": bts},
                           {"block_tables": bts})
    else:
        into, step, ver = {}, {}, {}
    # the call that emitted the token, and which of its emitted tokens
    done = 0
    for last, call in enumerate(calls):
        if done + call["emitted"] > n:
            break
        done += call["emitted"]
    else:
        raise SmokeFailure(f"no recorded call emitted token {n}")
    q = n - done
    lead = next((j for j, c in enumerate(calls) if c["kind"] != "prefill"),
                len(calls))
    lead = min(lead, last + 1)
    below = calls[0]["pos"] if calls[0]["kind"] == "prefill" else 0
    key = (id(params), cfg, str(dev), max_seq, page, chunk, rows, layout,
           tuple(full[:below]), tuple(
               (c["pos"], c["valid"], tuple(c["tokens"].tolist()))
               for c in calls[:lead]))
    hit = lead > 0 and RouterProbe.active is None and key in _PREFILLED
    if hit:
        out, kept = _PREFILLED[key]
        cache = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in kept["layers"]]}
    else:
        cache = (lm.init_cache(cfg, 1 + n_pg, page, slots=rows,
                               slot_seq=max_seq, device=dev) if paged
                 else lm.init_cache(cfg, rows, max_seq, layout="stacked",
                                    device=dev))
        for off in range(0, below, chunk):
            piece = full[off:min(off + chunk, below)]
            toks = torch.zeros(chunk, dtype=torch.int64)
            toks[:len(piece)] = torch.tensor(piece)
            _route_at(len(piece), off)
            lm.prefill_into_slot(params, cfg, toks.to(dev), cache, off,
                                 slot=0, valid=len(piece), dtype=f32, **into)
    for j in range(lead if hit else 0, last + 1):
        c = calls[j]
        pos, toks = c["pos"], c["tokens"]
        # the tokens this call fed that the stream kept
        fed = c["valid"] if c["kind"] == "prefill" else (
            q + 1 if j == last else max(c["emitted"], 1))
        if c["kind"] != "verify" or c["anc"] is None:
            check(toks.reshape(-1)[:fed].tolist() == full[pos:pos + fed],
                  f"logits_after: call {j} ({c['kind']} at {pos}) fed "
                  "tokens other than the history")
        _route_at(fed, pos)
        if c["kind"] == "prefill":
            out, cache = lm.prefill_into_slot(
                params, cfg, toks.to(dev), cache, pos, slot=0,
                valid=c["valid"], dtype=f32, **into)
        elif c["kind"] == "step":
            tok = torch.zeros((rows, 1), dtype=torch.int64)
            tok[0, 0] = toks
            lengths[0] = pos
            lg, cache = lm.decode_step(params, cfg, tok.to(dev), cache,
                                       lengths.to(dev), active=active,
                                       dtype=f32, **step)
            out = lg[0]
        else:
            out, cache = _replay_verify(params, cfg, c, cache, lengths, dev,
                                        q if j == last else None, ver,
                                        max_seq, rows)
        if j == lead - 1 and RouterProbe.active is None:
            while len(_PREFILLED) >= PREFILLED_KEPT:
                del _PREFILLED[next(iter(_PREFILLED))]
            _PREFILLED[key] = (out, {"layers": [
                {k: t.clone() for k, t in layer.items()}
                for layer in cache["layers"]]})
    return out.float().cpu()


def _replay_verify(params, cfg, c, cache, lengths, dev, q, ver, max_seq,
                   rows):
    """One recorded verify call of :func:`logits_after` on row 0: the
    row's tokens at base ``c["pos"]``; a chain with a valid count (rings or
    states) snapshots the ring slots first and commits the tokens the
    call emitted; a tree compacts the accepted path as the engine did.
    Returns (the logits of the ``q``-th token the call emitted, or None
    without ``q``; the cache)."""
    C = c["tokens"].shape[0]
    toks = torch.zeros((rows, C), dtype=torch.int64)
    toks[0] = c["tokens"]
    lengths[0] = c["pos"]
    lens = lengths.to(dev)
    f32 = torch.float32
    if c["anc"] is not None:
        anc = torch.tril(torch.ones((rows, C, C), dtype=torch.int32))
        depths = torch.arange(C).repeat(rows, 1)
        anc[0], depths[0] = c["anc"], c["depths"]
        lgs, cache = lm.verify_chunk(params, cfg, toks.to(dev), cache, lens,
                                     anc=anc.to(dev), depths=depths.to(dev),
                                     dtype=f32, **ver)
        path = c.get("path")
        nodes = (list(range(C)) if path is None else
                 [0] + (path[path < max_seq] - c["pos"]).tolist())
        if path is not None:
            src = torch.full((rows, path.shape[0]), max_seq,
                             dtype=torch.int64)
            src[0] = path
            dst = torch.full_like(src, max_seq)
            m = int((path < max_seq).sum())
            dst[0, :m] = c["pos"] + 1 + torch.arange(m)
            bts = ver.get("block_tables")
            cache = lm.compact_accepted_path(
                cfg, cache, src, dst,
                block_tables=None if bts is None else bts.cpu())
        return (None if q is None else lgs[0, nodes[q]]), cache
    if c["valid"] is None:
        lgs, cache = lm.verify_chunk(params, cfg, toks.to(dev), cache, lens,
                                     dtype=f32, **ver)
        return (None if q is None else lgs[0, q]), cache
    valids = torch.zeros(rows, dtype=torch.int32)
    valids[0] = c["valid"]
    counts = torch.zeros(rows, dtype=torch.int32)
    counts[0] = max(c["emitted"], 1)
    snap = lm.verify_snapshot(cfg, cache, lens, chunk=C)
    lgs, cache, traj = lm.verify_chunk(
        params, cfg, toks.to(dev), cache, lens, valids=valids.to(dev),
        with_traj=True, dtype=f32, **ver)
    cache = lm.commit_verify(cfg, snap, cache, traj, lens, counts.to(dev),
                             valids.to(dev), chunk=C)
    return (None if q is None else lgs[0, q]), cache


#: the latest prefills of ``logits_after`` (key -> (logits, cache)), at
#: most ``PREFILLED_KEPT``, emptied at every phase's start
_PREFILLED = {}
PREFILLED_KEPT = 8


class RouterProbe:
    """While entered, records the router probabilities of row 0's tokens
    at every MoE routing call of :func:`logits_after`, by (layer,
    position): ``logits_after`` names the row's valid tokens and their
    first position before each model call (:meth:`at`).  With ``pin``
    (another probe's records) each of those tokens whose top-k experts
    differ from the ones ``pin`` records at its (layer, position) is
    routed to ``pin``'s instead, with gates from its own probabilities;
    ``pinned`` counts such choices."""

    active = None

    def __init__(self, cfg, pin=None):
        self.L, self.k = cfg.n_layers, cfg.experts_per_token
        self.pin = pin
        self.rec = {}
        self.n = self.pos0 = self.calls = self.pinned = 0

    def at(self, n: int, pos0: int) -> None:
        self.n, self.pos0, self.calls = n, pos0, 0

    def __enter__(self):
        self._route = moe.route

        def route(p, xt, cfg, capacity_factor):
            r = self._route(p, xt, cfg, capacity_factor)
            probs = moe.router_probs(p, xt)
            layer, self.calls = self.calls % self.L, self.calls + 1
            keys = [(layer, self.pos0 + i) for i in range(self.n)]
            self.rec.update(zip(keys, probs[:self.n].cpu()))
            if self.pin is None:
                return r
            chosen = r.experts.cpu()
            for i, key in enumerate(keys):
                if key not in self.pin:
                    continue
                want = self.pin[key].sort(descending=True)[1][:self.k]
                if set(want.tolist()) != set(chosen[i].tolist()):
                    chosen[i] = want
                    self.pinned += 1
            experts = chosen.to(xt.device)
            g = probs.gather(1, experts)
            gates = g / g.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            slots, order, offsets = moe.sort_choices(experts, cfg.n_experts,
                                                     r.C)
            return moe.Routing(gates, experts, slots, r.C, r.probs, order,
                               offsets)

        moe.route, RouterProbe.active = route, self
        return self

    def __exit__(self, *exc):
        moe.route, RouterProbe.active = self._route, None


def routing_split(ra, rb, k):
    """Where two probes' routers chose different top-``k`` experts: the
    count of such (layer, position) choices among the shared ones, and
    the first (by position, then layer: every choice depends only on
    earlier ones in that order) as ``(key, (gap_a, gap_b), diff, span)``:
    each side's gap between its k-th and (k+1)-th probability, the two
    sides' largest probability difference there and the range of ``b``'s
    probabilities.  That first split is a routing near-tie when the two
    sides agree there (``diff <= LOGIT_REL_TOL * span``, as the logits
    must) and both gaps are within ``2 * diff``."""
    keys = sorted(set(ra.rec) & set(rb.rec), key=lambda t: (t[1], t[0]))
    n_diff, first = 0, None
    for key in keys:
        pa, pb = ra.rec[key], rb.rec[key]
        sa, ia = pa.sort(descending=True)
        sb, ib = pb.sort(descending=True)
        if set(ia[:k].tolist()) == set(ib[:k].tolist()):
            continue
        n_diff += 1
        if first is None:
            first = (key, ((sa[k - 1] - sa[k]).item(),
                           (sb[k - 1] - sb[k]).item()),
                     (pa - pb).abs().max().item(), (sb[0] - sb[-1]).item())
    return n_diff, len(keys), first


def hold_streams(what, streams, prompts, logits_fns, n_new, moe_cfg=None):
    """Two computations' served streams (``streams = (a, b)``, rid ->
    tokens; ``prompts`` indexed by rid) must be equal up to where a pair
    parts, and each parting must be a near-tie.  Each computation's
    logits at the parting (``logits_fns = (fa, fb)``, each ``(rid,
    prompt, history) -> logits``) are recomputed along the calls that
    served its stream (:func:`served_logits`), so each must prefer its
    own token: a negative margin (a side's logit for its own token less
    its logit for the other side's) means the recomputation is not the
    computation that served the stream, and fails.  Then the two agree
    to ``LOGIT_REL_TOL`` of their range, and each margin is at most twice
    their largest logit difference.  For a MoE stack (``moe_cfg``) the
    logits may instead
    differ by more where the two computations' routers chose different
    experts along the shared history, if the first such choice was a
    routing near-tie (:func:`routing_split`: there the two sides' router
    probabilities agree to ``LOGIT_REL_TOL`` of their range, and each
    side's gap at the top-k boundary is within twice their difference)
    and only the routing explains the rest: ``fa`` computed again with
    its routers pinned to ``fb``'s choices (:class:`RouterProbe`) agrees
    with ``fb`` to ``LOGIT_REL_TOL`` of their range.  The margins are
    held against the unpinned difference all the same.  Returns the
    free-running agreement."""
    a_out, b_out = streams
    fa, fb = logits_fns
    check(sorted(a_out) == sorted(b_out), f"{what}: a request was not "
          "served by both")
    total = sum(len(o) for o in b_out.values())
    free = sum(x == y for rid, o in b_out.items()
               for x, y in zip(o, a_out[rid]))
    parted = 0
    for rid in sorted(b_out):
        a, b = a_out[rid], b_out[rid]
        check(len(a) == len(b) == n_new, f"{what}: request {rid} length")
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        parted += 1
        routing_tie = False
        if moe_cfg is None:
            la = fa(rid, prompts[rid], b[:i])
            lb = fb(rid, prompts[rid], b[:i])
        else:
            with RouterProbe(moe_cfg) as ra:
                la = fa(rid, prompts[rid], b[:i])
            with RouterProbe(moe_cfg) as rb:
                lb = fb(rid, prompts[rid], b[:i])
            n_diff, n_all, first = routing_split(
                ra, rb, moe_cfg.experts_per_token)
            if first is None:
                print(f"{what}: request {rid}: the routers chose the same "
                      f"experts at all {n_all} (layer, position) choices")
            else:
                (li, pos), gaps, diff, pspan = first
                routing_tie = (max(gaps) <= 2 * diff
                               and diff <= LOGIT_REL_TOL * pspan)
                print(f"{what}: request {rid}: the routers chose different "
                      f"experts at {n_diff} of {n_all} (layer, position) "
                      f"choices; the first, layer {li} position {pos}: "
                      f"top-k boundary gaps {gaps[0]:.3e}, {gaps[1]:.3e} "
                      f"(<= 2 x diff) against a probability difference "
                      f"{diff:.3e} = {diff / pspan:.3e} of their range (<= "
                      f"{LOGIT_REL_TOL}): "
                      f"{'a' if routing_tie else 'NOT a'} routing near-tie")
        err = (la - lb).abs().max().item()
        span = (lb.max() - lb.min()).item()
        m_a = (la[a[i]] - la[b[i]]).item()
        m_b = (lb[b[i]] - lb[a[i]]).item()
        tie = ", or a routing near-tie" if moe_cfg else ""
        print(f"{what}: request {rid} parts at token {i}: {a[i]} vs {b[i]};"
              f" logits max err {err:.3e} = {err / span:.3e} of their range "
              f"(<= {LOGIT_REL_TOL}{tie}); margins {m_a:.3e}, {m_b:.3e} "
              "(>= 0, <= 2 x err)")
        ok = err <= LOGIT_REL_TOL * span
        if not ok and routing_tie:
            with RouterProbe(moe_cfg, pin=rb.rec) as rp:
                lp = fa(rid, prompts[rid], b[:i])
            err_p = (lp - lb).abs().max().item()
            ok = err_p <= LOGIT_REL_TOL * span
            print(f"{what}: request {rid}: with the first's routers pinned "
                  f"to the second's choices ({rp.pinned} (layer, position) "
                  f"choices moved) the logits max err is {err_p:.3e} = "
                  f"{err_p / span:.3e} of their range (<= {LOGIT_REL_TOL})")
        check(ok, f"{what}: request {rid} logits err {err}")
        check(m_a >= 0 and m_b >= 0,
              f"{what}: request {rid} parts at token {i} ({a[i]} vs {b[i]})"
              f" with margins {m_a}, {m_b}: a recomputation prefers the "
              "other side's token, so it is not the computation that "
              "served the stream")
        check(max(m_a, m_b) <= 2 * err,
              f"{what}: request {rid} parts at token {i} with margins "
              f"{m_a}, {m_b} beyond twice the logit difference {err}")
    print(f"{what}: free-running greedy agreement {free}/{total} = "
          f"{free / total:.3f}; {parted} of {len(b_out)} stream pairs part, "
          "each at a near-tie")
    return free / total


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


def served_logits(params, cfg, schedule, dev, **shape):
    """``(rid, prompt, history) -> logits``: :func:`logits_after` along
    request ``rid``'s calls in ``schedule`` (an :func:`engine_run`'s), on
    ``dev``, at the engine's ``shape`` (``max_seq``, ``page``, ``chunk``,
    ``rows``, ``layout``)."""
    return lambda rid, p, h: logits_after(params, cfg, schedule[rid], p, h,
                                          dev, **shape)


def w8a8_engine(cfg, qparams, dev, **kw):
    """An engine on the W8A8 weights of phase 5, run as a W8A8 engine runs
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
    (n-gram, k ``CHAIN_K``) on phase 7's chain prompts.  Each run's
    streams are held against the paged run of the same prompts and
    variant from phase 7 under the near-tie rule.  Returns each run's
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


def whisper_mp_calls(cfg, ragged_steps, n_new):
    """``mp_matmul`` launches of :func:`whisper_run` on the kernels: two
    encodes (q, k, v, out and the MLP's two a layer), two cross-cache
    fills (``cross.k``, ``cross.v`` a decoder layer), ``ragged_steps``
    replay and ``n_new`` decode steps (self q, k, v, out; cross q and out;
    the MLP's two), and one full-sequence decoder forward for the batched
    prefill (self 4, ``cross_kv``'s 2, the cross sub-block's q, k, v and
    out, the MLP's 2).  The head is tied (no MP call)."""
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    return (2 * 6 * Le + 2 * 2 * L + (ragged_steps + n_new) * 8 * L
            + 12 * L)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def whisper_run(params, cfg, frames, ragged, uniform, n_new, dev, *,
                forced=None, max_seq=WHISPER_MAX_SEQ):
    """Whisper at model level, as the reference runs it: the ``ragged``
    prompts (rows ``0..R-1``, with ``frames[:R]``) replay through
    ``lm.prefill`` and the ``uniform`` ones (equal lengths, with
    ``frames[R:]``) through ``lm.batch_prefill``, each group on its own
    stacked cache (bf16 self K/V, ``max_seq`` positions; float32 cross
    K/V); the two caches join into one of all the rows, which then takes
    ``n_new`` greedy ``decode_step(enc_lengths=)`` steps, float32
    activations (a W8A8 engine's).  With ``forced`` (B, n_new) each step
    is fed those tokens instead (teacher forcing).  Returns (the tokens
    fed (B, n_new), the logits after the prefill and after each step on
    the CPU (n_new + 1, B, V), {"prefill_s", "decode_s"})."""
    dt = torch.float32
    R = len(ragged)
    parts = []
    _sync(dev)
    t0 = time.perf_counter()
    if ragged:
        plen = torch.tensor([len(p) for p in ragged], dtype=torch.int32)
        toks = torch.zeros((R, int(plen.max())), dtype=torch.int64)
        for b, p in enumerate(ragged):
            toks[b, :len(p)] = torch.tensor(p)
        c = lm.init_cache(cfg, R, max_seq, layout="stacked", device=dev)
        parts.append(lm.prefill(params, cfg, toks.to(dev), plen.to(dev), c,
                                frames=frames[:R], dtype=dt))
    if uniform:
        c = lm.init_cache(cfg, len(uniform), max_seq, layout="stacked",
                          device=dev)
        parts.append(lm.batch_prefill(
            params, cfg, torch.tensor(uniform, device=dev), c,
            frames=frames[R:], dtype=dt))
    last = torch.cat([p[0] for p in parts])
    lengths = torch.cat([p[2] for p in parts])
    cache = {key: [{k: torch.cat([p[1][key][li][k] for p in parts])
                    for k in ("k", "v")} for li in range(cfg.n_layers)]
             for key in ("layers", "cross")}
    del parts
    _sync(dev)
    t1 = time.perf_counter()
    B = last.shape[0]
    enc = torch.full((B,), cfg.encoder_seq, dtype=torch.int32, device=dev)
    fed, logits = [], [last]
    for i in range(n_new):
        tok = (last.argmax(-1) if forced is None
               else torch.as_tensor(forced[:, i], device=dev))
        fed.append(tok)
        last, cache = lm.decode_step(params, cfg, tok[:, None], cache,
                                     lengths, enc_lengths=enc, dtype=dt)
        lengths = lengths + 1
        logits.append(last)
    _sync(dev)
    t2 = time.perf_counter()
    return (torch.stack(fed, 1).cpu().numpy(),
            torch.stack(logits).float().cpu(),
            {"prefill_s": t1 - t0, "decode_s": t2 - t1})


def hold_taught(what, tokens, la, lb):
    """The near-tie rule for a stream ``tokens`` (B, n) computed with
    logits ``la`` (n + 1, B, V; ``tokens[:, i]`` is the argmax of
    ``la[i]``) against a second computation's logits ``lb`` taught the
    same stream: each row must be the second's greedy stream up to where
    they part, and at a parting each computation prefers its own token
    (both margins at least 0), the two computations' logits agree to
    ``LOGIT_REL_TOL`` of their range and each one's margin of its own
    token over the other's is at most twice their largest difference.
    (Taught the shared history, the second computation's logits up to
    the parting are those of its own free-running stream.)  Returns the
    rows' agreement (tokens before the first parting, over all)."""
    B, n = tokens.shape
    check(la.shape == lb.shape == (n + 1,) + la.shape[1:] and bool(
        torch.isfinite(la).all() and torch.isfinite(lb).all()),
        f"{what}: logits of shape {tuple(la.shape)} / {tuple(lb.shape)} or "
        "non-finite")
    check(np.array_equal(la[:n].argmax(-1).numpy().T, tokens),
          f"{what}: the stream is not its own logits' argmax")
    mine = lb[:n].argmax(-1).numpy().T
    same, parted = 0, 0
    for b in range(B):
        i = next((j for j in range(n) if mine[b, j] != tokens[b, j]), None)
        same += n if i is None else i
        if i is None:
            continue
        parted += 1
        a, o = int(tokens[b, i]), int(mine[b, i])
        x, y = la[i, b], lb[i, b]
        err = (x - y).abs().max().item()
        span = (y.max() - y.min()).item()
        m_a, m_b = (x[a] - x[o]).item(), (y[o] - y[a]).item()
        print(f"{what}: row {b} parts at token {i}: {a} vs {o}; logits max "
              f"err {err:.3e} = {err / span:.3e} of their range (<= "
              f"{LOGIT_REL_TOL}); margins {m_a:.3e}, {m_b:.3e} (>= 0, <= 2 "
              "x err)")
        check(m_a >= 0 and m_b >= 0,
              f"{what}: row {b} parts at token {i} with margins {m_a}, "
              f"{m_b}: a side's logits prefer the other side's token")
        check(err <= LOGIT_REL_TOL * span and max(m_a, m_b) <= 2 * err,
              f"{what}: row {b} parts at token {i} beyond a near-tie")
    err = (la[0] - lb[0]).abs().max().item()
    span = (lb[0].max() - lb[0].min()).item()
    check(err <= LOGIT_REL_TOL * span, f"{what}: prefill logits err {err}")
    print(f"{what}: prefill logits max err {err:.3e} = {err / span:.3e} of "
          f"their range; greedy agreement {same}/{B * n} = "
          f"{same / (B * n):.3f}; {parted} of {B} rows part, each at a "
          "near-tie")
    return same / (B * n)


def whisper_kernels_phase(dev, timer):
    """The two kernels of whisper's path at its shapes.  ``mha_decode``
    over the cross cache (8 rows, 20 query heads over 20 KV heads of 64,
    1,500 keys: every row's length, 93 whole 16-key tiles and a ragged
    one), on the float32 cross cache the model-level path fills and on a
    bf16 one, and over the self cache (``max_seq`` 448, bf16, the lengths
    of phase 11b's rows after their 64 new tokens); each held to its
    plain version per output vector, two calls bit-identical, timed
    beside its plain version, SDPA and its bound.  ``mp_matmul`` at every
    (K, N) of a whisper layer (1,280 -> 1,280, 1,280 -> 5,120 and 5,120
    -> 1,280) at the encoder's token counts (one request's 1,500 frames
    and eight's 12,000), bit for bit with bias also at 3,000 and a ragged
    12,007, and each timed beside its plain version, ``torch._int_mm``
    with the same epilogue, and its bound; and a decoder layer's eight
    calls of a decode step as ``mp_rows`` holds and times them (M 8 and
    32).  Returns ({"mha_decode": rows, "mp_matmul": rows})."""
    phase("kernels at whisper-large-v3's shapes (cross and self decode, "
          "the encoder's linears)")
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
        got, again = call(), call()
        want = ref.mha_decode_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        kname = "float32" if kvd == torch.float32 else "bf16"
        label = (f"whisper-large-v3 {what} (H {H} / Hkv {Hkv}, D {D}, "
                 f"{kname} cache)")
        check(rel <= ATTN_REL_TOL and torch.equal(got, again),
              f"mha_decode {label}: rel err {rel}, or two calls differ")
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
              f"{rel:.3e} <= {ATTN_REL_TOL}), two calls bit-identical; "
              f"kernel {t:.4f} ms, plain {tp:.4f} ms, SDPA {tl:.4f} ms, "
              f"bound {b:.5f} ms ({by})")
        del q, k, v
    d, ff = cfg.d_model, cfg.d_ff
    mp = []
    for K, N in ((d, d), (d, ff), (ff, d)):
        for M in (3000, WHISPER_MP_M[-1] + 7):
            args = mp_inputs(rng, M, K, N, dev, bias=True)
            got, again = ops.quant_matmul(*args), ops.quant_matmul(*args)
            want = ref.quant_matmul_ref(*args)
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"mp_matmul whisper M={M} K={K} N={N}: not bit-identical")
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
            print(f"mp_matmul whisper M={M} K={K} N={N}: bit-identical (and "
                  f"at 3000 and {WHISPER_MP_M[-1] + 7}, two calls equal); "
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
                                  WHISPER_NEW, dev)
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
                               WHISPER_NEW, dev, forced=toks)
    hold_taught("whisper-large-v3 kernels vs plain versions on the card",
                toks, la, lb)
    del qparams, frames, la, lb
    torch.cuda.empty_cache()
    return {"whisper-large-v3 model-level": n}


def whisper_agreement_phase(dev):
    """Reduced ``whisper-large-v3`` (2 + 2 layers, d 64) on the card and
    on the CPU with the same W8A8 weights (calibrated with frames): the
    model-level loop of phase 11b (two ragged prompts replayed, two
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
    decode step) on phase 5's full-width W8A8 GPT-2, paged, 4 requests of
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
# multi-device: ring collectives, ring TP and the distributed engine on
# shards of one card (a mesh that names the card several times)

RING_SHARDS = 4
#: the near-tie recomputation's rows for a shard of the 2 x 4 runs
DIST_BS = SLOTS // 2
DIST_NEW = 32


def ring_phase(dev, timer):
    """Phase 4b: the ring collectives and ring tensor parallelism on
    ``make_host_mesh(model=4, devices=[card] * 4)``.  ``ring_all_gather``
    of the distributed tick's logits blocks bit-identical to
    ``torch.cat``; ``compressed_psum`` of four 2^20-float vectors within
    one int8 step per hop of the same call on the CPU (the CPU test's
    bound); ``ring_ag_matmul`` and ``ring_rs_matmul`` within 1e-5
    relative of one float32 product; ``tp_quant_matmul`` bit-identical to
    the unsharded ``quant_matmul`` at GPT-2's weight shapes at M 8, 32 and
    40, and each column shard's ``mp_matmul`` bit-identical to its plain
    version; :func:`shard_rows_attention`; then ``mp_matmul`` at the
    column-shard shapes, bit-identical to plain, timed as in phase 4
    beside its plain version, ``torch._int_mm`` (M > 16), the unsharded
    call and its bound.  Returns the timed rows."""
    n = RING_SHARDS
    phase(f"ring collectives and ring TP ({n} shards of one card)")
    mesh = make_host_mesh(model=n, devices=[dev] * n)
    rng = np.random.default_rng(23)
    V = get_config("gpt2-345m").vocab_size
    for shape in ((DIST_BS, V), (DIST_BS, CHAIN_K + 1, V)):
        blocks = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(n)]
        outs = collectives.ring_all_gather(blocks)
        want = torch.cat(blocks)
        check(all(torch.equal(o, want) for o in outs),
              f"ring_all_gather {shape}: not bit-identical to torch.cat")
        t = timer.ms(partial(collectives.ring_all_gather, blocks))
        tc = timer.ms(partial(torch.cat, blocks))
        print(f"ring_all_gather of {n} x {shape} float32 blocks: "
              f"bit-identical to torch.cat on every shard; {t:.4f} ms "
              f"({n - 1} hops, {n} copies out) vs one torch.cat {tc:.4f} ms")
    L = 1 << 20
    xs = [rng.standard_normal(L).astype(np.float32) for _ in range(n)]
    got = collectives.compressed_psum(
        [torch.from_numpy(x).to(dev) for x in xs])
    cpu = collectives.compressed_psum([torch.from_numpy(x) for x in xs])[0]
    step = float(np.abs(np.stack(xs)).sum(axis=0).max() / 127.0)
    err = max((g.cpu() - cpu).abs().max().item() for g in got)
    same = min(int((g.cpu() == cpu).sum()) for g in got)
    check(err <= n * step, f"compressed_psum card vs CPU: max err {err} "
          f"beyond {n} int8 steps ({n * step})")
    print(f"compressed_psum of {n} x {L} float32: card vs CPU max err "
          f"{err:.3e} <= {n} x int8 step {step:.3e}; {same}/{L} elements "
          "bit-identical")
    for M, K, N in ((SLOTS, 1024, 4096), (CHUNK, 4096, 1024)):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(
            np.float32)).to(dev)
        want = x @ w
        xs_ = list(x.chunk(n, dim=1))
        for name, fn, ws in (
                ("ring_ag_matmul", ring.ring_ag_matmul, w.chunk(n, dim=1)),
                ("ring_rs_matmul", ring.ring_rs_matmul, w.chunk(n, dim=0))):
            y = torch.cat(fn(xs_, [c.contiguous() for c in ws]), dim=1)
            rel = ((y - want).abs().max() / want.abs().max()).item()
            check(rel <= 1e-5, f"{name} M={M} K={K} N={N}: rel err {rel}")
            print(f"{name} M={M} K={K} N={N} over {n} shards: rel err "
                  f"{rel:.3e} (<= 1e-5) against one float32 product")
    for M in (SLOTS, CHUNK, SLOTS * (CHAIN_K + 1)):
        for K, N in MP_SHAPES:
            x, w, xs_, ws, b = args = mp_inputs(rng, M, K, N, dev, bias=True)
            for od in (torch.float32, torch.bfloat16):
                check(torch.equal(
                    ring.tp_quant_matmul(*args, mesh=mesh, out_dtype=od),
                    ops.quant_matmul(*args, out_dtype=od)),
                    f"tp_quant_matmul M={M} K={K} N={N} {od}: not "
                    "bit-identical to the unsharded call")
                # each column shard the kernel runs, against its plain
                # version on the same inputs
                for wl, sl, bl in zip(*(t.chunk(n, dim=-1)
                                        for t in (w, ws, b))):
                    shard = (x, wl.contiguous(), xs_, sl.contiguous(),
                             bl.contiguous())
                    check(torch.equal(
                        ops.quant_matmul(*shard, out_dtype=od),
                        ref.quant_matmul_ref(*shard, out_dtype=od)),
                        f"mp_matmul column shard M={M} K={K} "
                        f"N={N // n} {od}: not bit-identical to plain")
    print(f"tp_quant_matmul over {n} column shards bit-identical to the "
          f"unsharded quant_matmul at (K, N) {list(MP_SHAPES)}, M {SLOTS}, "
          f"{CHUNK} and {SLOTS * (CHAIN_K + 1)}, float32 and bf16 out; "
          "every column shard's mp_matmul bit-identical to its plain "
          "version")
    shard_rows_attention(dev, rng)
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


def shard_rows_attention(dev, rng):
    """The attention kernels at a shard's batch of rows, GPT-2's widths:
    ``DIST_BS`` (the 2 x 4 runs) and 2 (the 4 x 2 run).  Their split
    geometry follows B (ROADMAP B7), so each is held to its plain version
    as phase 3 holds it at B 8: ``paged_mha_decode`` with lengths 1 and
    ``MAX_SEQ`` among them, window 0 and 128, q float32 and bf16, two
    calls bit-identical; both verify bodies at the split edges
    (:func:`verify_split_edges`); ``mha_decode`` on the float32 cache of
    the stacked W8A8 engine and the draft, and on a bf16 one."""
    H, D, S = 16, 64, MAX_SEQ
    for B in (DIST_BS, 2):
        q, kp, vp, bt = pool_inputs(rng, B, H, D, dev, (B, H, D))
        lengths_np = np.concatenate([[1, MAX_SEQ], rng.integers(
            2, MAX_SEQ, B - 2)]).astype(np.int32)
        lengths = torch.from_numpy(lengths_np).to(dev)
        bt = live_table(bt, lengths_np)
        worst = 0.0
        for window, qd in ((0, torch.float32), (128, torch.float32),
                           (0, torch.bfloat16)):
            qq = q.to(qd)
            got = ops.paged_mha_decode(qq, kp, vp, lengths, bt,
                                       window=window)
            want = ref.paged_mha_decode_ref(qq, kp, vp, lengths, bt,
                                            window=window)
            torch.cuda.synchronize()
            _, rel = rel_err(got, want)
            check(rel <= ATTN_REL_TOL, f"paged_mha_decode B={B} "
                  f"window={window} q={qd}: rel err {rel}")
            worst = max(worst, rel)
        check(torch.equal(ops.paged_mha_decode(q, kp, vp, lengths, bt),
                          ops.paged_mha_decode(q, kp, vp, lengths, bt)),
              f"paged_mha_decode B={B}: two calls differ")
        dg = ops._decode_geometry(B, H, H, PAGE, D, MAX_SEQ // PAGE)
        print(f"paged_mha_decode B={B} lengths {lengths_np.tolist()} "
              f"({dg.splits} splits of {dg.pps} pages): window 0 and 128, "
              f"q float32 and bf16 within {ATTN_REL_TOL} per vector (worst "
              f"{worst:.3e}); two calls bit-identical")
        verify_split_edges(dev, rng, B)
        lengths_np = np.linspace(1, S, B).astype(np.int32)
        lengths = torch.from_numpy(lengths_np).to(dev)
        q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
            np.float32)).to(dev)
        worst = 0.0
        for kvd in (torch.float32, torch.bfloat16):
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, H, S, D)).astype(np.float32)).to(dev, kvd)
                for _ in range(2))
            for window in (0, 128):
                got = ops.mha_decode(q, k, v, lengths, window=window)
                want = ref.mha_decode_ref(q, k, v, lengths, window=window)
                again = ops.mha_decode(q, k, v, lengths, window=window)
                torch.cuda.synchronize()
                _, rel = rel_err(got, want)
                check(rel <= ATTN_REL_TOL and torch.equal(got, again),
                      f"mha_decode B={B} kv={kvd} window={window}: rel err "
                      f"{rel}, or two calls differ")
                worst = max(worst, rel)
        mg = ops._mha_geometry(B, H, H, S, D, 4)
        print(f"mha_decode B={B} S={S} lengths {lengths_np.tolist()} "
              f"({mg.splits} splits of {mg.kps} keys on the float32 "
              f"cache): float32 and bf16 caches, window 0 and 128, within "
              f"{ATTN_REL_TOL} per vector (worst {worst:.3e}); two calls "
              "bit-identical")


def dist_engine(cfg, qparams, dev, n_shards, slots_per_shard, **kw):
    """A distributed engine on ``n_shards`` shards of the card, at the
    serving shapes, on the W8A8 weights of phase 5."""
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
    """Phase 9c: full-width W8A8 ``gpt2-345m`` on shards of the card, the
    settings of phase 5.  (1) ``DistributedServeEngine`` 2 x 4, paged,
    plain, and (2) with chain speculation (n-gram, k ``CHAIN_K``), on
    phase 7's chain prompts with 64 new tokens, held against phase 7's
    single-device plain and chain runs; (3) 4 x 2 paged plain, 8
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
    weights: the streams held under the near-tie rule, as phase 10."""
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
# the analysis layer: profiler ranges, the roofline share, samplers, dry run


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
    untraced run against its roofline bound;
    (c) the single-policy samplers on a CUDA generator; (d) dry-run cells
    on ``meta``.  Returns the traced run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    phase("analysis (full-width gpt2-345m, W8A8, paged: profiler ranges, "
          "the decode step's roofline share, samplers, the dry run)")
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

    # (c) the samplers on a CUDA generator
    logits = torch.randn((SLOTS, cfg.vocab_size), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    arg = logits.argmax(-1).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(7)
    check(torch.equal(sampler.greedy(logits), arg)
          and torch.equal(sampler.temperature(logits, g, temp=0.01), arg)
          and torch.equal(sampler.top_k(logits, g, k=1), arg),
          "analysis: a near-greedy sampler is not the argmax on the card")
    draws = [sampler.top_k(logits, torch.Generator(device=dev).manual_seed(
        9), k=40, temp=1.0) for _ in range(2)]
    check(torch.equal(*draws), "analysis: two draws from one seed differ")
    print("samplers: greedy, temperature 0.01 and top-k 1 equal the argmax;"
          " two seeded top-k draws equal")

    # (d) dry-run cells on meta
    mesh = make_production_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, mesh, "pod16x16", tmp,
                                  force=True)
            check(rec["status"] == "ok", f"dry run {arch} {shape}: "
                  f"{rec.get('error')}")
            print(f"dry run {arch} {shape}: {json.dumps(rec)}")
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
    entries["mp_matmul"]["column_shards"] = ring_phase(dev, timer)
    moe_ffn_phase(dev, timer)
    entries["moe_experts"], grouped_launches = moe_experts_phase(dev, timer)
    recurrent_block_phase(dev, timer)
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
