"""Distributed serving: the sharded paged-KV engine with overlapped
transfers, driven by one controller over a
:class:`~repro_torch.launch.mesh.DeviceMesh` (the tick pipeline in
:mod:`repro_torch.serving.distributed.engine`, the shard-local pools in
:mod:`repro_torch.serving.distributed.sharded_kv`, the overlap meter in
:mod:`repro_torch.serving.distributed.transfer`).
"""
from repro_torch.serving.distributed.engine import DistributedServeEngine
from repro_torch.serving.distributed.sharded_kv import (
    ShardedPageAllocator, ShardedSlotAllocator)
from repro_torch.serving.distributed.transfer import TransferScheduler

__all__ = [
    "DistributedServeEngine",
    "ShardedPageAllocator",
    "ShardedSlotAllocator",
    "TransferScheduler",
]
