"""Predicate expressions. Comparisons are null-intolerant; float comparisons
follow Spark's NaN semantics (NaN = NaN, NaN greater than every value)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import BinaryExpression, ColV, Expression


@dataclass(frozen=True)
class LessThanOrEqual(BinaryExpression):
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def do_columnar(self, l: ColV, r: ColV):
        if l.dtype is DType.STRING:
            raise NotImplementedError("string comparison is not ported yet")
        a, b = l.data, r.data
        if l.dtype.is_floating:
            return torch.isnan(b) | (a <= b)
        return a <= b
