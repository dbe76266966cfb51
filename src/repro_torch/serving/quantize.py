"""Model-level SmoothQuant W8A8 conversion (paper §III-E serving path).

``calibrate`` runs forward passes over sample prompts while the
calibration context records per-linear activation absmax;
``quantize_model_params`` rewrites every matrix-processing linear group
``{"w": (K, N)}`` into the Fused-MP form ``{"w_q", "w_scale", "smooth"}``.
Norms and the (tied) embedding stay in floating point, as in the paper.
Whisper's encoder layers and its decoders' cross sub-blocks are walked
like any other group.  As in the reference, statistics are looked up by
the group's last two path keys: the encoder's attention shares the
decoder's ``attn.*`` statistics, and a cross sub-block's ``cross_attn.*``
groups find none (their products were recorded as ``cross.*``), so they
quantize without smoothing.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.models import lm, moe
from repro_torch.models.layers import to_device


@torch.no_grad()
def calibrate(params, cfg: ModelConfig, sample_batches, *,
              extras: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Run forwards (bf16 activations and exact MoE capacity, as the
    reference does); returns
    {linear-name: per-channel activation absmax} on the CPU.  ``extras``
    are passed to every forward (whisper's ``frames``, pixtral's
    ``patches``)."""
    dev = params["embed"]["table"].device
    kw = {k: torch.as_tensor(v, device=dev)
          for k, v in (extras or {}).items()}
    with quant.calibration() as stats:
        for tokens in sample_batches:
            lm.forward(params, cfg, torch.as_tensor(tokens, device=dev),
                       moe_cf=None, **kw)
    return {k: v.cpu() for k, v in stats.items()}


def _suffix_stats(act_stats: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """Collapse stats to path suffixes like 'attn.q' (max over layers)."""
    out: Dict[str, torch.Tensor] = {}
    for name, amax in (act_stats or {}).items():
        suffix = ".".join(name.split(".")[-2:])
        prev = out.get(suffix)
        amax = torch.as_tensor(amax)
        out[suffix] = amax if prev is None else torch.maximum(prev, amax)
    return out


# Only matrix-processing linears are quantized (paper quantizes the MP
# path); norm scales and embeddings stay floating point.
_LINEAR_KEYS = (
    "q", "k", "v", "qkv", "out", "up", "gate", "down", "in_proj",
    "out_proj", "o_gate", "lm_head",
)


@torch.no_grad()
def quantize_model_params(params, cfg: ModelConfig,
                          act_stats: Optional[Dict] = None,
                          alpha: float = 0.5):
    """A new param tree whose linear groups are W8A8; the same model code
    runs them through the Fused MP kernel (``linear`` keys on ``w_q``)."""
    sstats = _suffix_stats(act_stats)

    def walk(node, path):
        if isinstance(node, dict):
            leaf_key = path.rsplit("/", 1)[-1]
            if "w" in node and leaf_key in _LINEAR_KEYS:
                suffix = ".".join(path.split("/")[-2:])
                return quant.quantize_linear_params(
                    node["w"], node.get("b"), sstats.get(suffix), alpha)
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(params, "")


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where it is a view into a larger storage (a
    buffer it shares with other tensors, which would stay alive for it)."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def serve_experts(params, cfg: ModelConfig, act_dtype: torch.dtype):
    """``params`` with every MoE layer's expert banks converted once to the
    experts' dtype (``moe.expert_dtype``: the config's, else
    ``act_dtype``) and its router weight in storage of its own; the same
    tree for a stack without experts."""
    if not cfg.n_experts:
        return params
    ed = moe.expert_dtype(cfg, act_dtype)
    layers = []
    for layer in params["layers"]:
        if "moe" in layer:
            m = dict(layer["moe"])
            for name in ("w_up", "w_gate", "w_down"):
                if name in m:
                    m[name] = m[name].to(ed)
            m["router"] = dict(m["router"], w=_own(m["router"]["w"]))
            layer = dict(layer, moe=m)
        layers.append(layer)
    return dict(params, layers=layers)


def serving_params(params, cfg: ModelConfig, device, *,
                   quantized: bool = False, calibration_batches=None,
                   act_dtype: Optional[torch.dtype] = None):
    """An engine's params on ``device`` and its activation dtype.  With
    ``quantized`` the linears become W8A8 (calibrated on
    ``calibration_batches`` when given), and the stream between the MP
    kernels, which re-quantize their inputs, defaults to float32; else
    bf16.  A MoE stack's expert banks are converted to the experts'
    dtype here, once (:func:`serve_experts`): the tree holds no bank in
    another dtype."""
    act_dtype = act_dtype or (torch.float32 if quantized
                              else torch.bfloat16)
    params = serve_experts(to_device(params, device), cfg, act_dtype)
    if quantized:
        stats = None
        if calibration_batches is not None:
            stats = calibrate(params, cfg, calibration_batches)
        params = quantize_model_params(params, cfg, stats)
    return params, act_dtype
