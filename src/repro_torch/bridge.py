"""Carry weights, caches and train states between the JAX package's
pytrees and this package's dicts, as numpy arrays (this module imports
no JAX).

The JAX ``lm.init`` pytree stacks layers per pattern period:
``{"embed", "periods": (period dicts with a leading n_per axis...),
"rest": [layer dicts...], "final_ln"[, "pos_embed"][, "lm_head"]}`` (a
position table for learned positions only, a head only when untied).  This
package keeps one dict per layer (``{"layers": [...]}``), so layer
``pi * period + i`` is slice ``pi`` of ``periods[i]`` and the ``rest``
layers follow.  The same holds for the cache pytrees of both layouts,
whose leaves are page pools ``(P, Hkv, ps, D)`` (paged) or per-slot
caches ``(B, Hkv, S, D)`` (stacked; Hkv < H under GQA), with a leading
``n_per`` axis under ``periods``; a mixed stack's paged cache holds both
kinds, pools for its ``attn`` layers and per-slot rings and states for
the others, each carried layer by layer.  Leaves may be fp
(``w``/``b``) or quantized (``w_q``/``w_scale``/``smooth``/``bias``)
alike.

A caller turns a JAX pytree into numpy first (``jax.device_get``).  bf16
numpy arrays (``ml_dtypes``) are read by their bit pattern;
:func:`cache_to_numpy` returns bf16 leaves widened to float32, which is
exact.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState
from repro_torch.training.trainer import TrainState


def to_tensor(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(periods, rest) -> List:
    """Per-layer subtrees from a ``periods`` tuple (leading n_per axis on
    every leaf) followed by the ``rest`` list."""
    layers = []
    if periods:
        n_per = np.asarray(_first_leaf(periods[0])).shape[0]
        for pi in range(n_per):
            for per in periods:
                layers.append(_map(per, lambda a, pi=pi: np.asarray(a)[pi]))
    layers.extend(rest)
    return layers


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """This package's params from a JAX ``lm.init`` (or quantized) pytree
    given as numpy arrays.  Whisper's ``encoder["layers"]``, stacked on a
    leading axis (``layout="stacked"``) or a list (``"layers"``), becomes
    a list of per-layer dicts."""
    out = {k: _map(v, lambda a: to_tensor(a, device))
           for k, v in tree.items()
           if k not in ("periods", "rest", "encoder")}
    out["layers"] = [_map(layer, lambda a: to_tensor(a, device))
                     for layer in _unstack(tree["periods"], tree["rest"])]
    if "encoder" in tree:
        enc = dict(tree["encoder"])
        if isinstance(enc["layers"], dict):  # stacked on a leading axis
            enc["layers"] = _unstack((enc["layers"],), [])
        out["encoder"] = _map(enc, lambda a: to_tensor(a, device))
    return out


def train_state_from_numpy(state, device=None):
    """This package's ``TrainState`` from a JAX ``TrainState`` given as
    numpy arrays: ``params``, the AdamW moments ``opt.m`` and ``opt.v``
    and the error-feedback residual ``ef`` (or None) through
    :func:`params_from_numpy`, and the int32 ``opt.step``."""
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamWState(step=to_tensor(state.opt.step, device),
                       m=params_from_numpy(state.opt.m, device),
                       v=params_from_numpy(state.opt.v, device)),
        ef=None if state.ef is None else params_from_numpy(state.ef,
                                                           device))


def cache_from_numpy(tree: Dict, device=None) -> Dict:
    """This package's cache from a JAX cache pytree (paged or stacked)
    given as numpy arrays, whisper's static ``cross`` K/V included."""
    def layers(sub):
        return [_map(layer, lambda a: to_tensor(a, device))
                for layer in _unstack(sub["periods"], sub["rest"])]

    out = {"layers": layers(tree)}
    if "cross" in tree:
        out["cross"] = layers(tree["cross"])
    return out


def cache_to_numpy(cache: Dict, n_per: int, period: int = 1) -> Dict:
    """The JAX cache pytree layout (``periods`` stacked over the first
    ``n_per * period`` layers, ``rest`` for the others; the same for
    whisper's ``cross``) from this package's paged or stacked cache, bf16
    leaves as float32 numpy arrays."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def stack(entries) -> Dict:
        layers = [_map(c, host) for c in entries]
        periods = tuple(
            {k: np.stack([layers[pi * period + i][k] for pi in range(n_per)])
             for k in layers[i]}
            for i in range(period)) if n_per else ()
        return {"periods": periods, "rest": layers[n_per * period:]}

    out = stack(cache["layers"])
    if "cross" in cache:
        out["cross"] = stack(cache["cross"])
    return out
