"""Literal expressions: Python values as 0-d tensors on the batch's device."""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType, string_width_bucket
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression

_EPOCH = datetime.date(1970, 1, 1)


def infer_literal_dtype(value: Any) -> DType:
    if isinstance(value, bool):
        return DType.BOOLEAN
    if isinstance(value, int):
        return DType.INT if -(2**31) <= value < 2**31 else DType.LONG
    if isinstance(value, float):
        return DType.DOUBLE
    if isinstance(value, str):
        return DType.STRING
    if isinstance(value, datetime.datetime):
        return DType.TIMESTAMP
    if isinstance(value, datetime.date):
        return DType.DATE
    if value is None:
        return DType.NULL
    raise TypeError(f"cannot infer literal type for {value!r}")


def _to_physical(value: Any, dtype: DType) -> Any:
    """Python value -> Catalyst physical representation."""
    if dtype is DType.TIMESTAMP and isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=datetime.timezone.utc)
        return int(value.timestamp() * 1_000_000)
    if dtype is DType.DATE and isinstance(value, datetime.date):
        return (value - _EPOCH).days
    return value


@dataclass(frozen=True)
class Literal(Expression):
    value: Any
    lit_dtype: Optional[DType] = None

    @staticmethod
    def of(value: Any, dtype: Optional[DType] = None) -> "Literal":
        return Literal(value, dtype or infer_literal_dtype(value))

    def dtype(self) -> DType:
        return self.lit_dtype or infer_literal_dtype(self.value)

    def nullable(self) -> bool:
        return self.value is None

    def eval(self, ctx: EvalCtx) -> ColV:
        dt = self.dtype()
        phys = _to_physical(self.value, dt)
        valid = torch.tensor(phys is not None, device=ctx.device)
        if dt is DType.STRING:
            raw = (phys or "").encode("utf-8")
            if len(raw) > ctx.string_max_bytes:
                raise ValueError(f"string literal longer than device width "
                                 f"{ctx.string_max_bytes}")
            buf = np.zeros(string_width_bucket(len(raw), ctx.string_max_bytes),
                           dtype=np.uint8)
            buf[:len(raw)] = bytearray(raw)
            return ColV(dt, torch.from_numpy(buf).to(ctx.device), valid,
                        torch.tensor(len(raw), dtype=torch.int32,
                                     device=ctx.device), is_scalar=True)
        data = torch.tensor(phys if phys is not None else 0,
                            dtype=dt.torch_dtype(), device=ctx.device)
        return ColV(dt, data, valid, is_scalar=True)

    def __str__(self) -> str:
        return repr(self.value)
