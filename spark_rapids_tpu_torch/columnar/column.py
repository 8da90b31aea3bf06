"""Device column: torch tensors in the JAX package's layout.

- every buffer has a power-of-two bucketed row capacity (dtypes.bucket_capacity);
- validity is a ``bool[capacity]`` tensor;
- strings are a ``uint8[capacity, width]`` matrix plus an ``int32[capacity]``
  length vector;
- padding rows (index >= num_rows) are invalid, with length 0 and zeroed data.

The JAX package's DOUBLE ``bits`` sibling does not exist here: float64 is
native on the GPU, so ``data.view(torch.uint8)`` gives a double's bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType


@dataclass(frozen=True)
class DeviceColumn:
    dtype: DType
    data: torch.Tensor                     # [capacity] or [capacity, width]
    validity: torch.Tensor                 # bool[capacity]
    lengths: Optional[torch.Tensor] = None  # int32[capacity], strings only

    def __post_init__(self):
        if self.dtype is DType.STRING and self.lengths is None:
            raise ValueError("string column requires lengths vector")

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])
