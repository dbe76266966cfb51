"""Dry-run cells: for an (arch, shape, mesh) cell, the step
function, its abstract inputs and the partition specs of its inputs and
outputs.

The JAX package's ``repro/launch/cells.py``.  Abstract inputs are
``meta`` tensors (the counterpart of ``jax.ShapeDtypeStruct``): params
from ``lm.init_abstract`` (through ``quantize_model_params`` for
serving), train states from ``init_train_state_abstract``, caches from
``lm.init_cache(..., layout="stacked", device="meta")``, whose per-layer
contiguous regions are the reference's ``layout="layers"`` cache.
Specs come from :mod:`repro_torch.core.partition`.  The reference lowers
and compiles a cell with XLA (``lower_cell``); here
:func:`repro_torch.launch.dryrun.run_cell` runs the step on ``meta`` in
its place, which computes shapes only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, \
    get_config
from repro_torch.core import partition
from repro_torch.core.partition import P
from repro_torch.models import lm
from repro_torch.serving.quantize import quantize_model_params
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as trn

#: serving weights also shard over the data axes when one model-axis shard
#: of int8 weights (about a byte a param) would take more than half of an
#: H100's 80 GB of HBM3, the other half being left to the KV cache and
#: activations
_SERVE_FSDP_BYTES = 0.5 * 80e9


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    step_fn: Callable
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]


def _tokens(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this shape."""
    B = shape.global_batch
    out = {"tokens": _tokens(B, 1 if shape.kind == "decode"
                             else shape.seq_len)}
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        out["patches"] = torch.empty((B, cfg.frontend_tokens, cfg.d_model),
                                     dtype=torch.float32, device="meta")
    if cfg.is_encoder_decoder and shape.kind != "decode":
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.float32, device="meta")
    return out


def _serve_params_abstract(cfg: ModelConfig, max_seq: int):
    return quantize_model_params(lm.init_abstract(cfg, max_seq=max_seq), cfg)


def _serve_fsdp(cfg: ModelConfig, mesh) -> bool:
    per_model_shard = cfg.param_counts()["total"] / mesh.shape["model"]
    return per_model_shard > _SERVE_FSDP_BYTES  # int8 ~ 1 B/param


def _cache_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    return lm.init_cache(cfg, batch, max_seq, layout="stacked",
                         device="meta")


def _batch_spec(mesh, batch: int):
    dpax = partition.data_axes(mesh)
    return dpax if batch % partition._axsize(mesh, dpax) == 0 else None


def build_cell(arch: str, shape_name: str, mesh, *, remat: bool = True,
               serve_quantized: bool = True) -> Cell:
    """The cell of ``arch`` at ``shape_name``.  Layers always run one by
    one over per-layer params (the reference's ``unroll=True``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh, remat)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape, mesh, serve_quantized)
    return _decode_cell(cfg, shape, mesh, serve_quantized)


def _train_cell(cfg, shape, mesh, remat) -> Cell:
    tcfg = trn.TrainConfig(
        opt=opt.AdamWConfig(), remat=remat, microbatches=1,
        compress_grads=False, unroll_periods=True, layout="layers")
    max_seq = shape.seq_len + (cfg.frontend_tokens or 0)
    state_abs = trn.init_train_state_abstract(cfg, tcfg, max_seq=max_seq)
    batch_abs = input_specs(cfg, shape)

    # ZeRO-1: compute weights are TP-sharded and replicated over data;
    # the optimizer moments also shard over the data axes
    state_sh = trn.TrainState(
        params=partition.param_shardings(state_abs.params, cfg, mesh,
                                         fsdp=False, moe_ep="model"),
        opt=opt.AdamWState(
            step=P(),
            m=partition.param_shardings(state_abs.opt.m, cfg, mesh,
                                        fsdp=True, moe_ep="model"),
            v=partition.param_shardings(state_abs.opt.v, cfg, mesh,
                                        fsdp=True, moe_ep="model")),
        ef=None)
    batch_sh = partition.batch_shardings(batch_abs, mesh, shape.global_batch)
    metrics_sh = {k: P() for k in ("ce", "aux", "grad_norm", "lr", "loss")}
    return Cell(
        arch=cfg.name, shape=shape, step_fn=trn.make_train_step(cfg, tcfg),
        abstract_args=(state_abs, batch_abs),
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, metrics_sh),
        donate_argnums=(0,))


def _prefill_cell(cfg, shape, mesh, quantized) -> Cell:
    B = shape.global_batch
    max_seq = shape.seq_len + (cfg.frontend_tokens or 0)
    params_abs = (_serve_params_abstract(cfg, max_seq) if quantized
                  else lm.init_abstract(cfg, max_seq=max_seq))
    cache_abs = _cache_abstract(cfg, B, max_seq)
    batch_abs = input_specs(cfg, shape)

    fsdp = _serve_fsdp(cfg, mesh)
    p_sh = partition.param_shardings(params_abs, cfg, mesh, fsdp=fsdp)
    c_sh = partition.cache_shardings(cache_abs, cfg, mesh, B)
    b_sh = partition.batch_shardings(batch_abs, mesh, B)

    def prefill_step(params, batch, cache):
        # capacity-factor routing at prefill scale: exact capacity would
        # give every expert T * k slots
        return lm.batch_prefill(
            params, cfg, batch["tokens"], cache, frames=batch.get("frames"),
            patches=batch.get("patches"),
            moe_cf=2.0 if cfg.n_experts else None)

    dp = _batch_spec(mesh, B)
    return Cell(
        arch=cfg.name, shape=shape, step_fn=prefill_step,
        abstract_args=(params_abs, batch_abs, cache_abs),
        in_shardings=(p_sh, b_sh, c_sh),
        out_shardings=(P(dp, None), c_sh, P(dp)),
        donate_argnums=(2,))


def _decode_cell(cfg, shape, mesh, quantized) -> Cell:
    B = shape.global_batch
    max_seq = shape.seq_len
    params_abs = (_serve_params_abstract(cfg, max_seq) if quantized
                  else lm.init_abstract(cfg, max_seq=max_seq))
    cache_abs = _cache_abstract(cfg, B, max_seq)
    batch_abs = input_specs(cfg, shape)
    lengths_abs = torch.empty((B,), dtype=torch.int32, device="meta")

    fsdp = _serve_fsdp(cfg, mesh)
    p_sh = partition.param_shardings(params_abs, cfg, mesh, fsdp=fsdp)
    c_sh = partition.cache_shardings(cache_abs, cfg, mesh, B)
    b_sh = partition.batch_shardings(batch_abs, mesh, B)
    l_sh = partition.batch_shardings(lengths_abs, mesh, B)

    if cfg.is_encoder_decoder:

        def serve_step(params, batch, cache, lengths, enc_lengths):
            return lm.decode_step(params, cfg, batch["tokens"], cache,
                                  lengths, enc_lengths=enc_lengths)

        args = (params_abs, batch_abs, cache_abs, lengths_abs, lengths_abs)
        in_sh = (p_sh, b_sh, c_sh, l_sh, l_sh)
    else:

        def serve_step(params, batch, cache, lengths):
            # finite expert capacity at fleet batch (4x the expected load);
            # exact capacity would compute E * C >> routed tokens
            return lm.decode_step(params, cfg, batch["tokens"], cache,
                                  lengths,
                                  moe_cf=4.0 if cfg.n_experts else None)

        args = (params_abs, batch_abs, cache_abs, lengths_abs)
        in_sh = (p_sh, b_sh, c_sh, l_sh)

    return Cell(
        arch=cfg.name, shape=shape, step_fn=serve_step,
        abstract_args=args, in_shardings=in_sh,
        out_shardings=(P(_batch_spec(mesh, B), None), c_sh),
        donate_argnums=(2,))
