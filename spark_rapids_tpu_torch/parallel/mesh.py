"""The device mesh (the JAX package's ``parallel/mesh.py``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``; the
port's mesh is the ordered tuple of the devices its shards live on, in one
process: shard ``i`` of every ``MeshBatch`` lives on ``devices[i]``, and an
exchange between shards is a copy between their devices. A device may
appear more than once (several shards on one card, or the CPU mesh of the
tests, the counterpart of XLA's forced host device count).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The shard devices, in shard order, and the axis name."""
    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class MeshPlacement:
    """Where a mesh operator's batches live: rows partitioned over the
    shards (``replicated`` False), or the same rows on every shard."""
    mesh: Mesh
    replicated: bool = False


def visible_devices(device: torch.device) -> List[torch.device]:
    """The devices a mesh of ``device``'s kind may use: every CUDA device
    for a CUDA session, the CPU for a CPU one."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh of ``num_devices`` shards (default: one per device) over
    ``devices`` (default: the visible CUDA devices); shard ``i`` goes to
    ``devices[i % len(devices)]``."""
    devs = list(devices) if devices is not None else \
        visible_devices(torch.device("cuda"))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = num_devices or len(devs)
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)), axis_name)


def batch_sharding(mesh: Mesh) -> MeshPlacement:
    """Rows partitioned over the shards."""
    return MeshPlacement(mesh, replicated=False)


def replicated(mesh: Mesh) -> MeshPlacement:
    return MeshPlacement(mesh, replicated=True)
