"""Carrying batches across from the JAX package's layout.

The data is what the two engines share, as weights are what two ports of a
model share: a test downloads a JAX ``DeviceBatch`` buffer by buffer with
``np.asarray`` and hands the same arrays to both engines. ``batch_from_numpy``
builds the port's ``DeviceBatch`` from them at the same capacity and padding.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema, bucket_capacity
from spark_rapids_tpu_torch.columnar.transfer import to_device

Buffers = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def batch_from_numpy(schema: Schema, columns: Sequence[Buffers], num_rows: int,
                     device: torch.device) -> DeviceBatch:
    """``columns`` holds one ``(data, validity, lengths_or_None)`` triple per
    field. Arrays already at a power-of-two capacity (a downloaded device
    batch) keep it; shorter ones are zero-padded to the row count's bucket."""
    if len(columns) != len(schema):
        raise ValueError(f"{len(columns)} columns for {len(schema)} fields")
    rows = max((len(d) for d, _, _ in columns), default=num_rows)
    cap = bucket_capacity(max(rows, num_rows))
    cols = []
    for f, (data, validity, lengths) in zip(schema, columns):
        data = np.asarray(data)
        if data.dtype != f.dtype.np_dtype():
            raise TypeError(f"{f.name}: {data.dtype} data for {f.dtype}")
        if (f.dtype is DType.STRING) != (lengths is not None):
            raise ValueError(f"{f.name}: lengths go with string columns only")
        cols.append(DeviceColumn(
            f.dtype, to_device(data, cap, device),
            to_device(np.asarray(validity, dtype=np.bool_), cap, device),
            None if lengths is None
            else to_device(np.asarray(lengths, dtype=np.int32), cap, device)))
    return DeviceBatch(schema, tuple(cols), num_rows)
