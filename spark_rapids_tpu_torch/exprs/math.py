"""Math expressions: ``Round`` (the part of the JAX package's
``exprs/math.py`` the TPCx-BB queries use)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


@dataclass(frozen=True)
class Round(Expression):
    """round(x, scale), HALF_UP as Spark's BigDecimal rounding: a .5 goes
    away from zero. An integral input with scale >= 0 passes through; any
    other input is scaled in double, rounded and scaled back, then cast to
    its own type (a float back to float32)."""
    c: Expression
    scale: int = 0

    def dtype(self) -> DType:
        return self.c.dtype()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        if v.dtype.is_integral and self.scale >= 0:
            return v
        factor = float(10 ** self.scale)
        scaled = v.data.to(torch.float64) * factor
        rounded = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
        data = (rounded / factor).to(v.dtype.torch_dtype())
        return ColV(v.dtype, data, v.validity, is_scalar=v.is_scalar)
