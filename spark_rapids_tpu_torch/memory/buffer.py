"""Spillable buffer handles.

A buffer is one materialized ``DeviceBatch`` in one storage tier: DEVICE
(tensors on the session's device), HOST (CPU tensors, pinned when the device
is a GPU, so the copy back runs asynchronously) or DISK (an npz file whose
crc32 is checked before it is read back). The payload moves as the flat
column list (data, validity, [lengths] per column) plus the schema, so any
tier can rebuild the batch. The port's counterpart of the JAX package's
``memory/buffer.py``; the DOUBLE ``bits`` sibling does not exist here
(float64 is native on the GPU).
"""
from __future__ import annotations

import enum
import io
import os
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.utils.arm import Retainable


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillCorruptionError(RuntimeError):
    """A disk-tier spill file failed its crc32 check on unspill: the bytes
    on disk are not the bytes written. Raised instead of handing a garbage
    batch back up the tiers."""

    def __init__(self, path: str, expected: int, actual: int):
        super().__init__(
            f"spill file {path!r} is corrupt: crc32 {actual:#010x} != "
            f"stamped {expected:#010x}; refusing to unspill it")
        self.path = path
        self.expected = expected
        self.actual = actual


@dataclass(frozen=True, order=True)
class BufferId:
    """Unique buffer identity; ``table_id`` groups shuffle partitions."""
    table_id: int
    part_id: int = 0

    def __post_init__(self):
        if not (0 <= self.part_id < (1 << 20)) or self.table_id < 0:
            raise ValueError(f"BufferId out of range: table_id={self.table_id} "
                             f"part_id={self.part_id} (part_id < 2^20)")

    @property
    def key(self) -> int:
        return (self.table_id << 20) | self.part_id


def _flatten(batch: DeviceBatch) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for c in batch.columns:
        out += [c.data, c.validity]
        if c.lengths is not None:
            out.append(c.lengths)
    return out


def _rebuild(schema: Schema, arrays: List[torch.Tensor],
             num_rows: int) -> DeviceBatch:
    cols, i = [], 0
    for f in schema:
        if f.dtype is DType.STRING:
            cols.append(DeviceColumn(f.dtype, *arrays[i:i + 3]))
            i += 3
        else:
            cols.append(DeviceColumn(f.dtype, arrays[i], arrays[i + 1]))
            i += 2
    return DeviceBatch(schema, tuple(cols), num_rows)


def _nbytes(arrays) -> int:
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
               else a.nbytes for a in arrays)


class SpillableBuffer(Retainable):
    """One batch in one tier. Reference counted: the owning store holds one
    reference; acquirers ``retain`` and ``close`` around their use."""

    def __init__(self, buffer_id: BufferId, schema: Schema, num_rows: int,
                 tier: StorageTier, payload, size_bytes: int,
                 spill_priority: float, device: torch.device,
                 disk_crc32: Optional[int] = None):
        super().__init__()
        self.id = buffer_id
        self.schema = schema
        self.num_rows = num_rows
        self.tier = tier
        #: device tensors | host tensors | npz file path
        self.payload = payload
        self.size_bytes = size_bytes
        self.spill_priority = spill_priority
        #: where ``get_batch`` puts the batch back
        self.device = device
        #: crc32 over the npz file's bytes (DISK tier only)
        self.disk_crc32 = disk_crc32
        self.owner_store = None         # set by BufferStore.add_buffer

    @staticmethod
    def from_batch(buffer_id: BufferId, batch: DeviceBatch,
                   spill_priority: float = 0.0) -> "SpillableBuffer":
        arrays = _flatten(batch)
        return SpillableBuffer(buffer_id, batch.schema, batch.num_rows,
                               StorageTier.DEVICE, arrays, _nbytes(arrays),
                               spill_priority, batch.device)

    # ---- materialization -------------------------------------------------------
    def get_batch(self) -> DeviceBatch:
        """The batch on its device (copied up from the host or disk tier)."""
        if self.tier == StorageTier.DEVICE:
            arrays = self.payload
        elif self.tier == StorageTier.HOST:
            arrays = [t.to(self.device, non_blocking=True)
                      for t in self.payload]
        else:
            arrays = [torch.from_numpy(a).to(self.device)
                      for a in self._disk_arrays()]
        return _rebuild(self.schema, arrays, self.num_rows)

    def _disk_arrays(self) -> List[np.ndarray]:
        """The npz's arrays, read once and checked against the crc32 that
        ``to_disk`` stamped before np.load parses them."""
        with open(self.payload, "rb") as f:
            data = f.read()
        if self.disk_crc32 is not None:
            actual = zlib.crc32(data)
            if actual != self.disk_crc32:
                raise SpillCorruptionError(self.payload, self.disk_crc32,
                                           actual)
        with np.load(io.BytesIO(data)) as z:
            return [z[f"a{i}"] for i in range(len(z.files))]

    def _host_tensors(self) -> List[torch.Tensor]:
        """The payload as CPU tensors, pinned when the device is a GPU."""
        if self.tier == StorageTier.HOST:
            return self.payload
        src = (self.payload if self.tier == StorageTier.DEVICE
               else [torch.from_numpy(a) for a in self._disk_arrays()])
        pin = self.device.type == "cuda"
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t)
                for t in src]

    # ---- tier movement ---------------------------------------------------------
    def to_host(self) -> "SpillableBuffer":
        arrays = self._host_tensors()
        return SpillableBuffer(self.id, self.schema, self.num_rows,
                               StorageTier.HOST, arrays, _nbytes(arrays),
                               self.spill_priority, self.device)

    def to_disk(self, directory: str) -> "SpillableBuffer":
        if self.tier == StorageTier.DISK:
            arrays = self._disk_arrays()
        else:
            arrays = [t.cpu().numpy() for t in self.payload]
        path = os.path.join(directory,
                            f"buf_{self.id.table_id}_{self.id.part_id}.npz")
        np.savez(path, **{f"a{i}": a for i, a in enumerate(arrays)})
        with open(path, "rb") as f:
            data = f.read()
        return SpillableBuffer(self.id, self.schema, self.num_rows,
                               StorageTier.DISK, path, len(data),
                               self.spill_priority, self.device,
                               disk_crc32=zlib.crc32(data))

    def _on_release(self) -> None:
        if self.tier == StorageTier.DISK and isinstance(self.payload, str):
            try:
                os.unlink(self.payload)
            except FileNotFoundError:
                pass
        self.payload = None
