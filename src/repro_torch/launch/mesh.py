"""Device meshes for one controller: an ordered list of devices.

The JAX package builds ``jax.sharding.Mesh`` objects and runs per-device
bodies under ``shard_map``.  Here one Python process drives every device
itself, so a mesh is just the devices in order, with axis names and a
shape (row-major: the last axis varies fastest).  A list may name one
card several times (``["cuda:0"] * 4``): four shards then share that card
and every hop between them is a copy on it, which runs every schedule of
the multi-device path on a machine with one card.  On a host with several
cards the same code makes each hop a peer copy.

``devices=None`` takes every visible card and raises where there is none,
as :func:`repro_torch.serving.engine.resolve_device` does; the CPU is used
only when the caller names it (``devices=["cpu"] * n``, as the tests do).
:func:`make_production_mesh` builds the reference's pod layouts over
``meta`` devices: the dry run (``launch/dryrun.py``) reads its axes to
account per-device bytes, and nothing runs on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in row-major order over ``axis_names`` of ``dims``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axes {self.axis_names} vs dims {self.dims}")
        if math.prod(self.dims) != len(self.devices):
            raise ValueError(f"mesh {self.dims} needs {math.prod(self.dims)}"
                             f" devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        ring a collective over ``axis`` runs on (the reference replicates
        it over the other axes)."""
        a = self.axis_names.index(axis)
        stride = math.prod(self.dims[a + 1:])
        return [self.devices[i * stride] for i in range(self.dims[a])]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "run the plain PyTorch versions on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    for i, d in enumerate(out):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{d} named but no CUDA device is available")
            if d.index is None:  # the index tensors report
                out[i] = torch.device("cuda", torch.cuda.current_device())
    return out


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production layouts: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``,
    each entry a ``meta`` device (no card needed)."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh((torch.device("meta"),) * math.prod(dims), axes, dims)


def make_host_mesh(model: int = 1, devices: Optional[Sequence] = None
                   ) -> DeviceMesh:
    """A ``("data", "model")`` mesh over ``devices`` (default: every
    visible card), ``model`` devices per model ring."""
    devs = _devices(devices)
    if model < 1 or len(devs) % model:
        raise ValueError(f"model={model} does not divide {len(devs)} "
                         "devices")
    return DeviceMesh(tuple(devs), ("data", "model"),
                      (len(devs) // model, model))


def make_serving_mesh(n_shards: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> DeviceMesh:
    """The distributed serving engine's ``("shard",)`` mesh, one KV-pool
    shard per entry.  ``n_shards=None`` takes every device given (or
    every visible card); a smaller ``n_shards`` takes the first ones."""
    devs = _devices(devices)
    if n_shards is None:
        n_shards = len(devs)
    if not 1 <= n_shards <= len(devs):
        raise ValueError(f"n_shards={n_shards} outside 1..{len(devs)}")
    return DeviceMesh(tuple(devs[:n_shards]), ("shard",), (n_shards,))
