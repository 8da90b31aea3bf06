"""Device batch: columns padded to one power-of-two capacity, with the live
row count kept on the host (the JAX package's ``DeviceBatch`` layout)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Schema,
                                                    bucket_capacity)


@dataclass(frozen=True)
class DeviceBatch:
    schema: Schema
    columns: Tuple[DeviceColumn, ...]
    num_rows: int

    def __post_init__(self):
        caps = {c.capacity for c in self.columns}
        if len(caps) > 1:
            raise ValueError(f"mixed capacities in batch: {caps}")

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

    def column_by_name(self, name: str) -> DeviceColumn:
        return self.columns[self.schema.index_of(name)]

    @staticmethod
    def empty(schema: Schema, device: torch.device,
              string_width: int = 8) -> "DeviceBatch":
        cap = bucket_capacity(0)
        cols = []
        for f in schema:
            validity = torch.zeros(cap, dtype=torch.bool, device=device)
            if f.dtype is DType.STRING:
                cols.append(DeviceColumn(
                    f.dtype, torch.zeros((cap, string_width), dtype=torch.uint8,
                                         device=device),
                    validity, torch.zeros(cap, dtype=torch.int32, device=device)))
            else:
                cols.append(DeviceColumn(
                    f.dtype, torch.zeros(cap, dtype=f.dtype.torch_dtype(),
                                         device=device), validity))
        return DeviceBatch(schema, tuple(cols), 0)


def pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-pad (or cut) a tensor's leading dimension to ``cap`` rows."""
    n = t.shape[0]
    if n == cap:
        return t
    if n > cap:
        return t[:cap]
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:n] = t
    return out
