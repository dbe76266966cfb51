"""Sharding rules: param/optimizer/cache/batch partition specs per mesh.

The JAX package's ``repro/core/partition.py``, rule for rule: Megatron TP
over ``"model"`` plus optional FSDP (ZeRO-3 style) over the data axes for
training; head-wise KV partitioning for decode, falling back to
sequence-sharded KV when ``n_kv_heads`` does not divide the model axis.
Every rule degrades to replication when a dimension is not divisible by
its axes: sharding is never a correctness hazard.

A spec is a :class:`PartitionSpec`, a tuple holding per dimension one
axis name, a tuple of names, or None.  A mesh is anything with
``axis_names`` and a ``shape`` dict (``launch/mesh.DeviceMesh``).  The
rules match leaves by path suffix, and the paths are built to equal the
reference's ``layout="layers"`` tree: this package's per-layer list
``["layers"][i]`` is the reference's ``/rest/i``, a cross cache's
``["cross"][i]`` its ``/cross/rest/i``; every other key is the same.
The port partitions nothing with these specs yet: the dry run
(``launch/dryrun.py``) reads them to account per-device bytes.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from repro_torch.configs.base import ModelConfig

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Per dimension: an axis name, a tuple of axis names, or None
    (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _maybe(mesh, axes, dim: int):
    """``axes`` if they evenly divide ``dim``, else None (replicate)."""
    if axes in (None, ()):
        return None
    if dim % _axsize(mesh, axes) == 0:
        return axes
    return None


def shard_size(mesh, spec: PartitionSpec) -> int:
    """How many pieces ``spec`` cuts a leaf into: the product of the
    sizes of the axes it names."""
    return _axsize(mesh, tuple(a for ax in spec if ax is not None
                               for a in ((ax,) if isinstance(ax, str)
                                         else ax)))


# ---------------------------------------------------------------------------
# parameter rules

# (path suffix, (row axes, column axes) of the last two dims), the axes
# being "model" | "kv_model" | "fsdp" | None; leading dims replicate
_W_RULES = (
    ("/q/w", ("fsdp", "model")),
    ("/k/w", ("fsdp", "kv_model")),  # column-shard only if Hkv divides model
    ("/v/w", ("fsdp", "kv_model")),
    ("/o_gate/w", ("fsdp", "model")),
    ("/out/w", ("model", "fsdp")),
    ("/up/w", ("fsdp", "model")),
    ("/gate/w", ("fsdp", "model")),
    ("/down/w", ("model", "fsdp")),
    ("/gates/w", ("fsdp", "model")),
    ("/in_proj/w", ("fsdp", "model")),
    ("/out_proj/w", ("model", "fsdp")),
    ("/w_r/w", ("model", None)),
    ("/w_i/w", ("model", None)),
    ("/router/w", ("fsdp", None)),
    ("/lm_head/w", ("fsdp", "model")),
)


def _resolve(mesh, cfg, token, dim, fsdp_axes):
    if token is None:
        return None
    if token == "model":
        return _maybe(mesh, MODEL_AXIS, dim)
    if token == "kv_model":
        if cfg.n_kv_heads % _axsize(mesh, MODEL_AXIS) == 0:
            return _maybe(mesh, MODEL_AXIS, dim)
        return None
    if token == "fsdp":
        return _maybe(mesh, fsdp_axes, dim)
    raise ValueError(token)


def param_pspec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
                *, fsdp: bool, moe_ep: str = "data") -> PartitionSpec:
    fsdp_axes = data_axes(mesh) if fsdp else None
    nd = len(shape)
    # MoE expert banks (.., E, d_in, d_out).  Serving (moe_ep="data"):
    # experts shard over the data axes (tokens travel to the expert's
    # owner, weights stay) and each expert is Megatron-split over model.
    # Training (moe_ep="model"): tokens already shard the data axes, so
    # experts shard over model only.
    if path.endswith(("/w_up", "/w_gate", "/w_down")):
        pre = (None,) * (nd - 3)
        if moe_ep == "data":
            e_ax = _maybe(mesh, data_axes(mesh), shape[nd - 3])
            if path.endswith("/w_down"):
                return P(*pre, e_ax,
                         _maybe(mesh, MODEL_AXIS, shape[nd - 2]), None)
            return P(*pre, e_ax, None,
                     _maybe(mesh, MODEL_AXIS, shape[nd - 1]))
        e_ax = _maybe(mesh, MODEL_AXIS, shape[nd - 3])
        row = _maybe(mesh, fsdp_axes, shape[nd - 2])
        return P(*pre, e_ax, row, None)
    if path.endswith("embed/table"):
        v_ax = _maybe(mesh, MODEL_AXIS, shape[0])
        return P(v_ax, _maybe(mesh, fsdp_axes, shape[1]))
    if path.endswith("/conv") or path.endswith("/lam"):
        # per-channel params over the recurrent width (last dim)
        return P(*(None,) * (nd - 1), _maybe(mesh, MODEL_AXIS, shape[-1]))
    if path.endswith("pos_embed"):
        return P(*(None,) * nd)
    for suffix, (row_t, col_t) in _W_RULES:
        if path.endswith(suffix):
            pre = (None,) * (nd - 2)
            row = _resolve(mesh, cfg, row_t, shape[nd - 2], fsdp_axes)
            col = _resolve(mesh, cfg, col_t, shape[nd - 1], fsdp_axes)
            return P(*pre, row, col)
    # biases follow the column sharding of their weight when divisible
    if path.endswith("/b") or path.endswith("/bias"):
        owner = path.rsplit("/", 1)[0]
        for suffix, (_, col_t) in _W_RULES:
            if owner.endswith(suffix[: -len("/w")]):
                col = _resolve(mesh, cfg, col_t, shape[-1], fsdp_axes)
                return P(*(None,) * (nd - 1), col)
        return P(*(None,) * nd)
    # norms, scalars, anything unmatched: replicate
    return P(*(None,) * nd)


def leaf_paths(tree) -> Tuple[List[str], List[Any]]:
    """Every leaf (a tensor, or a :class:`PartitionSpec` of a spec tree)
    of a params, optimizer-moment or cache tree and its path in the
    reference's ``layout="layers"`` tree (``/rest/3/attn/q/w``), in this
    package's traversal order."""
    paths, leaves = [], []

    def walk(node, keys):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + [str(k)])
        elif isinstance(node, (list, tuple)) and \
                not isinstance(node, PartitionSpec):
            for i, v in enumerate(node):
                walk(v, keys + [str(i)])
        else:
            if keys[:1] == ["layers"]:
                keys = ["rest"] + keys[1:]
            elif keys[:1] == ["cross"]:
                keys = ["cross", "rest"] + keys[1:]
            paths.append("/" + "/".join(keys))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _map_paths(fn, tree):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``
    (paths as :func:`leaf_paths` gives them)."""
    paths, leaves = leaf_paths(tree)
    it = iter(fn(p, x) for p, x in zip(paths, leaves))

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and \
                not isinstance(node, PartitionSpec):
            kids = [build(v) for v in node]
            if hasattr(node, "_fields"):
                return type(node)(*kids)
            return type(node)(kids)
        return next(it)

    return build(tree)


def param_shardings(params_abs, cfg: ModelConfig, mesh, *, fsdp: bool,
                    moe_ep: str = "data"):
    """A tree of ``params_abs``'s structure holding each leaf's spec."""
    return _map_paths(
        lambda path, leaf: param_pspec(path, tuple(leaf.shape), cfg, mesh,
                                       fsdp=fsdp, moe_ep=moe_ep),
        params_abs)


# ---------------------------------------------------------------------------
# cache rules


def cache_pspec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
                batch: int) -> PartitionSpec:
    dp = _maybe(mesh, data_axes(mesh), batch)
    nd = len(shape)
    # the batch dim: stacked period leaves carry (n_per, B, ..)
    b_pos = 1 if (nd >= 2 and shape[0] != batch and shape[1] == batch) else 0
    if shape[b_pos] != batch:
        return P(*(None,) * nd)

    def with_b(*rest):
        full = [None] * nd
        full[b_pos] = dp
        for i, ax in enumerate(rest):
            full[b_pos + 1 + i] = ax
        return P(*full)

    last = path.rsplit("/", 1)[-1]
    if last in ("k", "v") and nd - b_pos == 4:  # (B, Hkv, S, hd)
        hkv, S = shape[b_pos + 1], shape[b_pos + 2]
        if hkv % _axsize(mesh, MODEL_AXIS) == 0:
            return with_b(MODEL_AXIS, None, None)  # head-wise
        if S % _axsize(mesh, MODEL_AXIS) == 0:
            return with_b(None, MODEL_AXIS, None)  # sequence-sharded KV
        return with_b(None, None, None)
    if last == "C" and nd - b_pos == 4:  # mLSTM (B, H, hd, hd)
        H, hd = shape[b_pos + 1], shape[b_pos + 2]
        if H % _axsize(mesh, MODEL_AXIS) == 0:
            return with_b(MODEL_AXIS, None, None)
        if hd % _axsize(mesh, MODEL_AXIS) == 0:
            return with_b(None, MODEL_AXIS, None)
        return with_b(None, None, None)
    if last in ("h", "c", "n", "m", "conv_tail"):
        rest = [None] * (nd - b_pos - 1)
        if nd - b_pos >= 2:
            rest[-1] = _maybe(mesh, MODEL_AXIS, shape[-1])
        return with_b(*rest)
    return with_b(*([None] * (nd - b_pos - 1)))


def cache_shardings(cache_abs, cfg: ModelConfig, mesh, batch: int):
    return _map_paths(
        lambda path, leaf: cache_pspec(path, tuple(leaf.shape), cfg, mesh,
                                       batch),
        cache_abs)


# ---------------------------------------------------------------------------
# batch / misc


def batch_shardings(batch_abs, mesh, batch: int):
    """The batch dim over the data axes where it divides; the rest
    replicated."""
    dp = _maybe(mesh, data_axes(mesh), batch)

    def spec(path, leaf):
        nd = leaf.dim()
        if nd >= 1 and leaf.shape[0] == batch:
            return P(dp, *(None,) * (nd - 1))
        return P(*(None,) * nd)

    return _map_paths(spec, batch_abs)


def replicated(tree_abs, mesh):
    return _map_paths(lambda path, leaf: P(*(None,) * leaf.dim()), tree_abs)
