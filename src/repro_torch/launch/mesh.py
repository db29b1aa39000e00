"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group, built lazily by functions so importing this module never touches
the process group.  ``make_rules`` is the reference's.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.sharding import ShardingRules


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, ``cpu`` otherwise
    (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over a process group of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_rules(mesh, *, multi_pod: bool = False, fsdp: bool = True,
               shard_seq: bool = False) -> ShardingRules:
    return ShardingRules(
        mesh=mesh,
        batch_axes=("pod", "data") if multi_pod else ("data",),
        model_axis="model",
        fsdp=fsdp,
        shard_seq=shard_seq,
    )


def make_debug_mesh(n: int, *, axes=("data", "model"), shape=None):
    """A small mesh over the first ``n`` ranks of the current process group
    (gloo on the CPU, NCCL on the card); ``shape`` defaults to (1, n)."""
    if shape is None:
        shape = (1, n)
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))
