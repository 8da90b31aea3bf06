"""Placement: where an operator's batches live, as a plan property (the
JAX package's ``parallel/placement.py``).

- ``None``: the session's device (every single-device operator);
- a ``torch.device``: one pinned device;
- ``MeshPlacement(mesh)``: rows partitioned over the mesh's shards;
- ``MeshPlacement(mesh, replicated=True)``: the same rows on every shard.

The mesh rewrite (plan/mesh_rewrite.py) sets it when it builds the mesh
operators; ``tree_string`` shows it. Where the JAX package groups devices
by ICI domain, the port groups CUDA devices that reach each other as peers
(``torch.cuda.can_device_access_peer``): a copy between two of them never
goes through host memory. A repeated device, and the CPU, are one group.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.parallel.mesh import MeshPlacement


def placement_label(p: Optional[Any]) -> str:
    """Compact label for plan display."""
    if p is None:
        return "default"
    if isinstance(p, MeshPlacement):
        kind = "replicated" if p.replicated else "P('data',)"
        return f"mesh[{p.mesh.size}]:{kind}"
    return f"device:{p}"


def batch_devices(batch) -> frozenset:
    """Every device holding a buffer of a DeviceBatch."""
    return frozenset(t.device for c in batch.columns
                     for t in (c.data, c.validity, c.lengths)
                     if t is not None)


def assert_unsharded(batches: Sequence, op: str) -> None:
    """Refuse a mesh batch where one device's batch is expected: the
    explicit boundaries are ``MeshGatherExec`` / ``gather_mesh`` and
    ``scatter_device_batch``."""
    from spark_rapids_tpu_torch.parallel.mesh_batch import MeshBatch
    for b in batches:
        if isinstance(b, MeshBatch) or len(batch_devices(b)) > 1:
            raise ValueError(
                f"{op} received a batch over several devices; gather it "
                "explicitly (MeshGatherExec / gather_mesh) or reshard it "
                "(scatter_device_batch)")


def _peers(a: torch.device, b: torch.device) -> bool:
    if a == b:
        return True
    if a.type != "cuda" or b.type != "cuda":
        return False
    return (torch.cuda.can_device_access_peer(a.index, b.index)
            and torch.cuda.can_device_access_peer(b.index, a.index))


def ici_groups(devices: Sequence[torch.device]) -> List[List[torch.device]]:
    """The devices in groups whose members all reach each other as peers,
    order kept within each group (a device joins the first group it fits)."""
    groups: List[List[torch.device]] = []
    for d in devices:
        for g in groups:
            if all(_peers(d, m) for m in g):
                g.append(d)
                break
        else:
            groups.append([d])
    return groups


def largest_ici_group(devices: Sequence[torch.device]
                      ) -> List[torch.device]:
    """The widest set of devices with no host hop between any two."""
    groups = ici_groups(devices)
    return max(groups, key=len) if groups else []
