"""Cast between numeric, boolean, date and timestamp types (the JAX
package's ``exprs/cast.py`` without its string casts), with Spark's non-ANSI
semantics:

- integral -> narrower integral wraps (Java narrowing);
- float -> integral goes through Scala's ``.toInt``/``.toLong``: NaN -> 0,
  saturated at the int/long bounds, truncated toward zero; narrower targets
  then wrap from the saturated int;
- numeric -> boolean is ``!= 0``; boolean -> numeric is 1/0;
- date -> timestamp multiplies by the microseconds of a day (UTC),
  timestamp -> date floor-divides; date -> numeric is the day number.

The planner's join-key coercion is its main user.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression

MICROS_PER_DAY = 86_400_000_000

_INT_BOUNDS = {DType.INT: (-(2 ** 31), 2 ** 31 - 1),
               DType.LONG: (-(2 ** 63), 2 ** 63 - 1)}


@dataclass(frozen=True)
class Cast(Expression):
    c: Expression
    to: DType

    def dtype(self) -> DType:
        return self.to

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        src, to = v.dtype, self.to
        if src == to:
            return v
        return ColV(to, _cast_data(v.data, src, to), v.validity,
                    is_scalar=v.is_scalar)


def _cast_data(d: torch.Tensor, src: DType, to: DType) -> torch.Tensor:
    if src is DType.STRING or to is DType.STRING:
        raise NotImplementedError(f"cast {src.value} -> {to.value} is not "
                                  f"ported yet")
    if to is DType.BOOLEAN:
        return d != 0
    if src is DType.DATE and to is DType.TIMESTAMP:
        return d.to(torch.int64) * MICROS_PER_DAY
    if src is DType.TIMESTAMP and to is DType.DATE:
        return torch.div(d, MICROS_PER_DAY, rounding_mode="floor") \
            .to(torch.int32)
    if src.is_floating and to.is_integral:
        return _float_to_integral(d, to)
    if (src.is_numeric or src in (DType.BOOLEAN, DType.DATE)) \
            and to.is_numeric:
        return d.to(to.torch_dtype())
    raise NotImplementedError(f"cast {src.value} -> {to.value} has no device "
                              f"form")


def _float_to_integral(d: torch.Tensor, to: DType) -> torch.Tensor:
    """NaN -> 0, saturate to int/long, then wrap to byte/short."""
    wide = DType.LONG if to is DType.LONG else DType.INT
    lo, hi = _INT_BOUNDS[wide]
    d = d.to(torch.float64)
    out = torch.where(torch.isnan(d), 0.0, d.clamp(float(lo), float(hi))) \
        .to(wide.torch_dtype())
    # float(hi) rounds up past hi for long: clamp the ends exactly
    out = torch.where(d >= float(hi), hi, out)
    out = torch.where(d <= float(lo), lo, out)
    return out.to(to.torch_dtype())
