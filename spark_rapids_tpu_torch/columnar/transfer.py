"""Host <-> device movement of batches.

Uploads go through pinned host buffers and asynchronous copies on the current
stream, straight into zero-padded device buffers of the batch's capacity; on
the CPU they are plain copies. Downloads move only the live rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, bucket_capacity
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn


def to_device(arr: np.ndarray, cap: int, device: torch.device) -> torch.Tensor:
    """One host buffer -> a device tensor of ``cap`` rows, the rows beyond
    ``len(arr)`` zeroed. On CUDA the host side is staged in pinned memory so
    the copy runs asynchronously (the caching host allocator keeps the
    staging buffer alive until the copy has finished)."""
    host = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    n = host.shape[0]
    out = torch.empty((cap,) + tuple(host.shape[1:]), dtype=host.dtype,
                      device=device)
    if cap > n:
        out[n:].zero_()
    if device.type == "cuda":
        out[:n].copy_(host.pin_memory(), non_blocking=True)
    else:
        out[:n].copy_(host)
    return out


def upload(hb: HostBatch, device: torch.device,
           capacity: Optional[int] = None) -> DeviceBatch:
    """HostBatch -> DeviceBatch at ``capacity`` (default: the row count's
    power-of-two bucket)."""
    cap = capacity or bucket_capacity(hb.num_rows)
    cols = []
    for f, c in zip(hb.schema, hb.columns):
        n = hb.num_rows
        data = to_device(c.data[:n], cap, device)
        validity = to_device(c.validity[:n].astype(np.bool_, copy=False),
                             cap, device)
        lengths = (to_device(c.lengths[:n].astype(np.int32, copy=False), cap,
                             device) if f.dtype is DType.STRING else None)
        cols.append(DeviceColumn(f.dtype, data, validity, lengths))
    return DeviceBatch(hb.schema, tuple(cols), hb.num_rows)


def download(batch: DeviceBatch) -> HostBatch:
    """DeviceBatch -> HostBatch of the live rows."""
    n = batch.num_rows
    cols = []
    for c in batch.columns:
        lengths = c.lengths[:n].cpu().numpy() if c.lengths is not None else None
        cols.append(HostColumn(c.dtype, c.data[:n].cpu().numpy(),
                               c.validity[:n].cpu().numpy(), lengths))
    return HostBatch(batch.schema, tuple(cols), n)
