"""Null handling: ``Coalesce``, which the USING form of a full outer join
needs for its key columns (the rest of the JAX package's ``exprs/nulls.py``
is not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (ColV, EvalCtx, Expression,
                                               cast_operand)
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths


@dataclass(frozen=True)
class Coalesce(Expression):
    """The first non-null of its arguments, row by row."""
    exprs: Tuple[Expression, ...]

    def dtype(self) -> DType:
        out = self.exprs[0].dtype()
        for e in self.exprs[1:]:
            out = DType.common_type(out, e.dtype())
        return out

    def eval(self, ctx: EvalCtx) -> ColV:
        dt = self.dtype()
        out = None
        for e in self.exprs:
            v = bk.as_column(cast_operand(e.eval(ctx), dt), ctx.capacity)
            if out is None:
                out = v
                continue
            take = ~out.validity & v.validity
            if dt is DType.STRING:
                vd, od = align_widths(v.data, out.data)
                data = torch.where(take[:, None], vd, od)
                lengths = torch.where(take, v.lengths, out.lengths)
            else:
                data, lengths = torch.where(take, v.data, out.data), None
            out = ColV(dt, data, out.validity | v.validity, lengths)
        return out

    def __str__(self) -> str:
        return "coalesce(" + ", ".join(str(e) for e in self.exprs) + ")"
