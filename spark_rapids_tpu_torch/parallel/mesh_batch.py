"""Mesh batches (the JAX package's ``parallel/mesh_batch.py``).

One logical batch over the mesh: shard ``d`` is a ``DeviceBatch`` on
``mesh.devices[d]`` whose live rows are a prefix (the padding invariant of
every device batch, per shard), and ``rows_per_shard`` lists the live row
counts. The JAX package holds the shards in one global array of
``n_dev * local_capacity`` rows; the port holds one tensor per shard, so a
shard keeps its own capacity bucket. A scatter pads every shard to one
shared ``local_capacity``, as the JAX package does.

The shard-major row order (shard 0's rows first) is the batch's row
order: a scatter splits a table into contiguous runs and a gather
concatenates them back in shard order.

``host_hop_bytes`` counts the bytes of device data that cross between
device kinds on the mesh's path (``count_crossing``: every copy between
shards or onto a shard, ``_moved``, ``shuffle/ici.py::_assemble``, and
the bounds of a sampled range repartition); an exchange between shards of
one kind copies device to device and never adds to it. The uploads of a
scan into the mesh (``scatter_host_batch``) are the mesh's input, not a
hop, and are not counted. The network shuffle's payloads cross the host
too and count as they arrive (``count_host_hop``, from
``shuffle/client.py``), as the JAX package counts both in its
``transfer.host_hop_bytes``.
``shard_device_kinds`` lists the device kinds ("cuda", "cpu") of every
shard tensor of every mesh batch made since the last reset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import Schema, bucket_capacity
from spark_rapids_tpu_torch.columnar.host import (HostBatch, HostColumn,
                                                  concat_host_batches)
from spark_rapids_tpu_torch.parallel.mesh import Mesh
from spark_rapids_tpu_torch.utils import metrics as um

_DEVICE_KINDS: set = set()


def counters() -> Dict:
    """The mesh's counters: ``host_hop_bytes`` (the transfer section's
    ``transfer.host_hop_bytes``) and ``shard_device_kinds``."""
    hops = um.TRANSFER_METRICS[um.TRANSFER_HOST_HOP_BYTES].value
    return {"host_hop_bytes": hops,
            "shard_device_kinds": sorted(_DEVICE_KINDS)}


def reset_counters() -> None:
    um.TRANSFER_METRICS[um.TRANSFER_HOST_HOP_BYTES].reset()
    _DEVICE_KINDS.clear()


@dataclass(frozen=True)
class MeshBatch:
    schema: Schema
    #: shard d on mesh.devices[d]
    shards: Tuple[DeviceBatch, ...]
    mesh: Mesh

    def __post_init__(self):
        _DEVICE_KINDS.update(t.device.type for t in self.tensors())

    @property
    def n_dev(self) -> int:
        return self.mesh.size

    @property
    def rows_per_shard(self) -> np.ndarray:
        """int32[n_dev]: live rows per shard."""
        return np.asarray([s.num_rows for s in self.shards], dtype=np.int32)

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    @property
    def local_capacity(self) -> int:
        """The widest shard's capacity (every shard's after a scatter)."""
        return max((s.capacity for s in self.shards), default=0)

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every buffer of every shard."""
        for s in self.shards:
            for c in s.columns:
                for t in (c.data, c.validity, c.lengths):
                    if t is not None:
                        yield t


def slice_host(hb: HostBatch, start: int, stop: int) -> HostBatch:
    """Rows [start, stop) of a host batch (views, no copy)."""
    return HostBatch(hb.schema, tuple(
        HostColumn(c.dtype, c.data[start:stop], c.validity[start:stop],
                   None if c.lengths is None else c.lengths[start:stop])
        for c in hb.columns), stop - start)


def scatter_host_batch(hb: HostBatch, mesh: Mesh, conf=None) -> MeshBatch:
    """Host rows -> mesh batch: contiguous runs of ``ceil(n / n_dev)`` rows
    per shard (shard-major order keeps the table's row order), each shard
    padded to one power-of-two local capacity and uploaded to its device
    (chunked by ``transfer.chunkRows`` when a conf is given)."""
    from spark_rapids_tpu_torch.columnar.transfer import (upload,
                                                          upload_table_conf)
    n, n_dev = hb.num_rows, mesh.size
    per = -(-n // n_dev) if n else 0
    local_cap = max(bucket_capacity(per), 1)
    shards = []
    for d, dev in enumerate(mesh.devices):
        lo = min(d * per, n)
        part = slice_host(hb, lo, min(lo + per, n))
        shards.append(upload(part, dev, local_cap) if conf is None else
                      upload_table_conf(part, dev, conf, capacity=local_cap))
    return MeshBatch(hb.schema, tuple(shards), mesh)


def scatter_arrow(table, mesh: Mesh, string_max_bytes: int,
                  conf=None) -> MeshBatch:
    """Arrow table -> mesh batch (``scatter_host_batch``)."""
    return scatter_host_batch(HostBatch.from_arrow(table, string_max_bytes),
                              mesh, conf)


def count_host_hop(nbytes: int) -> None:
    """Count ``nbytes`` of exchange data that went through the host (from
    any thread: the shuffle client counts on its transports' threads)."""
    um.TRANSFER_METRICS[um.TRANSFER_HOST_HOP_BYTES].add(int(nbytes))


def count_crossing(src: torch.device, dst: torch.device,
                   nbytes: int) -> None:
    """Count ``nbytes`` copied from ``src`` to ``dst`` as a host hop when
    the two are of different kinds (a card and the host)."""
    if src.type != dst.type:
        count_host_hop(nbytes)


def scatter_device_batch(db: DeviceBatch, mesh: Mesh) -> MeshBatch:
    """One device's batch -> mesh batch (the explicit reshard): the same
    contiguous runs as ``scatter_host_batch``, each copied from the batch's
    device to its shard's (peer to peer between cards; a copy between
    device kinds counts in ``host_hop_bytes``)."""
    from spark_rapids_tpu_torch.shuffle.ici import copy_rows
    n, n_dev = db.num_rows, mesh.size
    per = -(-n // n_dev) if n else 0
    local_cap = max(bucket_capacity(per), 1)
    shards = []
    for d, dev in enumerate(mesh.devices):
        lo = min(d * per, n)
        hi = min(lo + per, n)
        shards.append(copy_rows(db, [(lo, hi - lo)], dev, local_cap))
    return MeshBatch(db.schema, tuple(shards), mesh)


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` are one device."""
    def canon(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return canon(a) == canon(b)


def _moved(batch: DeviceBatch, device: torch.device) -> DeviceBatch:
    if same_device(batch.device, device):
        return batch
    count_crossing(batch.device, device, batch.device_size_bytes)
    return DeviceBatch(batch.schema, tuple(
        DeviceColumn(c.dtype, c.data.to(device, non_blocking=True),
                     c.validity.to(device, non_blocking=True),
                     None if c.lengths is None else
                     c.lengths.to(device, non_blocking=True))
        for c in batch.columns), batch.num_rows)


def gather_mesh(mb: MeshBatch, device: Optional[torch.device] = None
                ) -> DeviceBatch:
    """Mesh batch -> one compacted batch on ``device`` (default: shard 0's),
    in shard-major row order; every shard's live rows copy device to
    device."""
    from spark_rapids_tpu_torch.execs.tpu_execs import concat_device_batches
    device = device if device is not None else mb.mesh.devices[0]
    parts = [_moved(s, device) for s in mb.shards if s.num_rows]
    return concat_device_batches(parts, mb.schema, device)


def replicate_device_batch(db: DeviceBatch, mesh: Mesh
                           ) -> Tuple[DeviceBatch, ...]:
    """One batch on every shard's device (one copy per distinct device):
    the broadcast of a build side."""
    copies: Dict[torch.device, DeviceBatch] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _moved(db, dev)
    return tuple(copies[dev] for dev in mesh.devices)


def host_batches_of(child, ctx) -> HostBatch:
    """Every partition's host batches of ``child``, concatenated."""
    parts = []
    for p in range(child.num_partitions):
        parts.extend(child.execute(ctx.for_partition(p,
                                                     child.num_partitions)))
    return parts[0] if len(parts) == 1 else \
        concat_host_batches(parts, child.output)
