"""Deterministic synthetic LM data pipeline with host sharding + prefetch,
a copy of the JAX package's ``repro/data/pipeline.py`` (numpy only): the
same seed, step and host give bit-equal batches in both packages.

Real-cluster layout: each data-parallel host pulls only its slice of the
global batch (``host_index`` / ``host_count``), streams are seeded by
(seed, step, host) so restarts are exactly reproducible from a checkpoint
step, and a one-deep prefetch thread overlaps host-side batch synthesis
with device compute (double buffering).

The synthetic distribution is a mixture of Zipfian unigrams and short
repeated motifs — enough structure that a ~100M model's loss visibly
drops, which the train example and convergence tests rely on.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        with_frames: bool = False,
        frame_len: int = 0,
        d_model: int = 0,
        with_patches: bool = False,
        patch_tokens: int = 0,
    ):
        if global_batch % host_count:
            raise ValueError(f"global_batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host = host_index
        self.with_frames = with_frames
        self.frame_len = frame_len
        self.d_model = d_model
        self.with_patches = with_patches
        self.patch_tokens = patch_tokens

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-reproducible)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host])
        )
        B, S, V = self.local_batch, self.seq, self.vocab
        # Zipfian unigrams
        ranks = np.arange(1, V + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(V, size=(B, S), p=probs).astype(np.int32)
        # inject repeated motifs (learnable bigram structure)
        motif = rng.integers(0, V, size=(8,))
        for b in range(B):
            n = rng.integers(1, 4)
            for _ in range(n):
                start = rng.integers(0, max(1, S - 8))
                toks[b, start : start + 8] = motif[: min(8, S - start)]
        out: Dict[str, np.ndarray] = {"tokens": toks}
        if self.with_frames:
            out["frames"] = rng.standard_normal(
                (B, self.frame_len, self.d_model), dtype=np.float32
            )
        if self.with_patches:
            out["patches"] = rng.standard_normal(
                (B, self.patch_tokens, self.d_model), dtype=np.float32
            )
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """One-deep background prefetch (overlap host synthesis with compute)."""

    def __init__(self, source: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = source
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._src:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
