"""Training loop, the JAX package's ``repro/training/trainer.py`` in
PyTorch: the train step (autograd through ``lm.loss_fn``, microbatch
accumulation, int8 error-feedback gradient compression, per-layer
recomputation), and the ``Trainer`` shell around it (checkpoint and
restart, injected failures, SIGTERM-safe snapshots, straggler
accounting).

The step runs eagerly, as the port's engine does, on the device of the
state it is given.  Microbatch gradients accumulate in float32 in the
reference's order (a zero tree plus each microbatch's, then divided by
their count), so one step equals the reference's jitted step up to the
rounding of the products inside the forward and backward.
"""
from __future__ import annotations

import dataclasses
import re
import signal
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import (leaves_with_paths, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.models import lm
from repro_torch.serving.engine import resolve_device
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState
    ef: Any  # error-feedback residual (None unless grad compression is on)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.AdamWConfig = opt.AdamWConfig()
    remat: bool = False
    microbatches: int = 1  # gradient accumulation steps
    compress_grads: bool = False  # int8 accumulation with error feedback
    aux_weight: float = 0.01
    # the reference's dry-run options: this trainer always runs one param
    # dict per layer, each layer its own call, so only these values exist
    unroll_periods: bool = True
    layout: str = "layers"

    def __post_init__(self):
        if not self.unroll_periods or self.layout != "layers":
            raise ValueError(
                "this trainer runs per-layer params layer by layer: only "
                "unroll_periods=True and layout='layers' exist, got "
                f"unroll_periods={self.unroll_periods!r}, "
                f"layout={self.layout!r}")


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     gen: Optional[torch.Generator], max_seq: int = 0,
                     device=None) -> TrainState:
    """Params from ``lm.init`` (drawn from ``gen``, which lives on
    ``device``), zero optimizer moments, and a zero float32 residual per
    param when gradients are compressed."""
    params = lm.init(cfg, gen, max_seq=max_seq, device=device)
    ef = None
    if tcfg.compress_grads:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    return TrainState(params=params, opt=opt.init_state(params, tcfg.opt),
                      ef=ef)


def init_train_state_abstract(cfg: ModelConfig, tcfg: TrainConfig,
                              max_seq: int = 0) -> TrainState:
    """The train state's structure, shapes and dtypes on the meta device:
    nothing is allocated or drawn (what a restore fills)."""
    return init_train_state(cfg, tcfg, None, max_seq=max_seq, device="meta")


def _scale_groups(cfg: ModelConfig, paths: List[str]) -> List[List[int]]:
    """The leaves (indices into ``paths``) that share one int8 scale: the
    ones the reference stacks into a single leaf.  Its params stack the
    first ``n_layers // period * period`` decoder layers per position of
    the block pattern, and every encoder layer, on a leading axis; the
    remainder layers and the rest are leaves of their own."""
    period = len(cfg.block_pattern)
    stacked = cfg.n_layers // period * period
    groups: Dict[Any, List[int]] = {}
    for i, path in enumerate(paths):
        key = path
        m = re.fullmatch(r"(\['encoder'\]/)?\['layers'\]/\[(\d+)\]/(.*)",
                         path)
        if m and m.group(1):
            key = ("encoder", m.group(3))
        elif m and int(m.group(2)) < stacked:
            key = ("layers", int(m.group(2)) % period, m.group(3))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _compress_decompress(g, ef, cfg: ModelConfig):
    """int8-quantize ``g + ef`` with one scale per reference leaf (from
    its largest magnitude; :func:`_scale_groups`); returns
    ``(dequantized, new_ef)``: what survives is the int8-representable
    part, and the residual re-enters the next step.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    paths, gl = leaves_with_paths(g)
    tot = [a.float() + e for a, e in zip(gl, tree_leaves(ef))]
    deq = [None] * len(tot)
    for group in _scale_groups(cfg, paths):
        amax = torch.stack([tot[i].abs().max() for i in group]).max()
        scale = torch.clamp(amax, min=1e-20) / 127.0
        for i in group:
            deq[i] = torch.clamp(torch.round(tot[i] / scale), -127, 127) \
                * scale
    return (tree_unflatten(g, [d.to(a.dtype) for d, a in zip(deq, gl)]),
            tree_unflatten(g, [t - d for t, d in zip(tot, deq)]))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]], Any]:
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients (averaged over ``tcfg.microbatches`` splits of the batch's
    leading axis), compressed if asked, then one AdamW update, in place.
    ``metrics``: ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``, float32
    scalars on the state's device."""

    def grad_fn(params, batch):
        # leaves that share the params' storage and take the gradients,
        # so the state's own tensors never require grad
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        loss, metrics = lm.loss_fn(live, cfg, batch, remat=tcfg.remat,
                                   aux_weight=tcfg.aux_weight)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        mb = tcfg.microbatches
        if mb == 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % mb:
                raise ValueError(f"batch of {B} does not split into {mb} "
                                 "microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(state.params)[0].device)
            ms = []
            for i in range(mb):
                part = {k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l_i, m_i, g_i = grad_fn(state.params, part)
                grads = tree_map(torch.add, grads, g_i)
                lsum = lsum + l_i
                ms.append(m_i)
            grads = tree_map(lambda g: g / mb, grads)
            loss = lsum / mb
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        ef = state.ef
        if tcfg.compress_grads:
            grads, ef = _compress_decompress(grads, ef, cfg)
        params, ostate, om = opt.apply_updates(state.params, grads,
                                               state.opt, tcfg.opt)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return TrainState(params=params, opt=ostate, ef=ef), metrics

    return step


def batch_to_tensors(batch: Dict[str, np.ndarray], device) -> Dict:
    """A data pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# operational shell


class Trainer:
    """Runs the train step over ``data`` (an iterable of numpy batches that
    restarts from step 0 when iterated anew, such as ``SyntheticLM``),
    saving to ``ckpt_dir`` every ``ckpt_every`` steps (asynchronously)
    and on SIGTERM; a new ``Trainer`` on the same directory resumes from
    the latest checkpoint and fast-forwards the data to it, so a killed
    run resumes bit for bit."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        data,
        ckpt_dir: str,
        *,
        max_seq: int = 0,
        ckpt_every: int = 50,
        straggler_factor: float = 3.0,
        failure_hook: Optional[Callable[[int], bool]] = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.failure_hook = failure_hook
        self.seed = seed
        self.step_fn = make_train_step(cfg, tcfg)
        self.state: Optional[TrainState] = None
        self.start_step = 0
        self.events: list = []
        self._ema_dt: Optional[float] = None
        self._sigterm = False

    # -- lifecycle ------------------------------------------------------
    def init_or_restore(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is not None:
            like = init_train_state_abstract(self.cfg, self.tcfg,
                                             max_seq=self.max_seq)
            self.state = self.ckpt.restore(latest, like, device=self.device)
            self.start_step = latest
            self.events.append(("restore", latest))
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.state = init_train_state(self.cfg, self.tcfg, gen,
                                          max_seq=self.max_seq,
                                          device=self.device)
            self.start_step = 0
        return self.start_step

    def _install_sigterm(self):
        def handler(signum, frame):
            self._sigterm = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not in the main thread

    # -- loop -----------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, float]:
        """Train from ``start_step`` up to step ``num_steps``; returns the
        last step's metrics as floats."""
        if self.state is None:
            raise RuntimeError("call init_or_restore() first")
        self._install_sigterm()
        metrics: Dict[str, float] = {}
        step = self.start_step
        data_it = iter(self.data)
        # fast-forward the deterministic stream to the resume point
        for _ in range(self.start_step):
            next(data_it)
        while step < num_steps:
            if self.failure_hook is not None and self.failure_hook(step):
                # simulated node failure: abandon the in-memory state
                self.events.append(("failure", step))
                raise RuntimeError(f"injected failure at step {step}")
            batch = batch_to_tensors(next(data_it), self.device)
            t0 = time.monotonic()
            self.state, m = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in m.items()}  # waits for it
            dt = time.monotonic() - t0
            if self._ema_dt is None:
                self._ema_dt = dt
            elif dt > self.straggler_factor * self._ema_dt:
                self.events.append(("straggler", step, dt))
            self._ema_dt = 0.9 * self._ema_dt + 0.1 * dt
            step += 1
            if step % self.ckpt_every == 0 or self._sigterm:
                self.ckpt.save(step, self.state, blocking=False)
                self.events.append(("checkpoint", step))
                if self._sigterm:
                    self.ckpt.wait()
                    self.events.append(("sigterm_exit", step))
                    break
        self.ckpt.wait()
        return metrics
