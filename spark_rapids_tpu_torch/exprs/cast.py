"""Cast (the JAX package's ``exprs/cast.py``), the pairs its ``Cast.eval``
computes, with Spark's non-ANSI semantics:

- integral -> narrower integral wraps (Java narrowing);
- float -> integral goes through Scala's ``.toInt``/``.toLong``: NaN -> 0,
  saturated at the int/long bounds, truncated toward zero; narrower targets
  then wrap from the saturated int;
- numeric -> boolean is ``!= 0``; boolean -> numeric is 1/0;
- date -> timestamp multiplies by the microseconds of a day (UTC),
  timestamp -> date floor-divides; date -> integral is the day number;
- timestamp -> long is the floor of the seconds, integral -> timestamp
  multiplies the seconds to microseconds;
- integral and boolean -> string write the decimal digits and
  ``true``/``false`` (``ops/strings.py::int_to_string``,
  ``bool_to_string``);
- a NULL source is a null of the target type.

Every other pair (float -> string, string -> anything) raises with the
JAX package's message: it has no device form there either.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.ops import strings as sk

MICROS_PER_DAY = 86_400_000_000
MICROS_PER_SECOND = 1_000_000

_INT_BOUNDS = {
    DType.BYTE: (-(2 ** 7), 2 ** 7 - 1),
    DType.SHORT: (-(2 ** 15), 2 ** 15 - 1),
    DType.INT: (-(2 ** 31), 2 ** 31 - 1),
    DType.LONG: (-(2 ** 63), 2 ** 63 - 1),
}


def can_cast_on_device(src: DType, to: DType) -> bool:
    """The cast pairs the JAX package's plan layer lets onto the device
    (its ``can_cast_on_device``); the others run on the CPU engine."""
    if src == to:
        return True
    numericish = src.is_numeric or src is DType.BOOLEAN
    if numericish and (to.is_numeric or to is DType.BOOLEAN):
        return True
    if src in (DType.DATE, DType.TIMESTAMP) and \
            to in (DType.DATE, DType.TIMESTAMP):
        return True
    if src is DType.TIMESTAMP and to in (DType.LONG,):
        return True
    if src.is_integral and to is DType.TIMESTAMP:
        return True
    if src is DType.DATE and to.is_integral:
        return True
    if (src.is_integral or src is DType.BOOLEAN) and to is DType.STRING:
        return True
    return False


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
        if src is DType.NULL:
            from spark_rapids_tpu_torch.exprs.literals import Literal
            return Literal(None, to).eval(ctx)
        if to is DType.STRING:
            if src.is_integral:
                kernel = sk.int_to_string
            elif src is DType.BOOLEAN:
                kernel = sk.bool_to_string
            else:
                raise NotImplementedError(
                    f"cast {src} -> string has no device kernel")
            data, lengths = kernel(v.data.reshape(-1), ctx.string_max_bytes)
            if v.is_scalar:
                return ColV(to, data[0], v.validity, lengths[0],
                            is_scalar=True)
            return ColV(to, data, v.validity, lengths)
        data = None if src is DType.STRING else _cast_data(v.data, src, to)
        if data is None:
            raise NotImplementedError(
                f"cast {src} -> {to} has no device kernel")
        return ColV(to, data, v.validity, is_scalar=v.is_scalar)


def _cast_data(d: torch.Tensor, src: DType, to: DType):
    """The cast of a non-string source's data, in the JAX package's order
    of cases; None for a pair it has no form for."""
    if to is DType.BOOLEAN:
        return d != 0
    if src is DType.BOOLEAN:
        return d.to(to.torch_dtype())
    if src is DType.DATE and to is DType.TIMESTAMP:
        return d.to(torch.int64) * MICROS_PER_DAY
    if src is DType.TIMESTAMP and to is DType.DATE:
        return torch.div(d, MICROS_PER_DAY, rounding_mode="floor") \
            .to(torch.int32)
    if src is DType.TIMESTAMP and to is DType.LONG:
        return torch.div(d, MICROS_PER_SECOND, rounding_mode="floor")
    if src.is_integral and to is DType.TIMESTAMP:
        return d.to(torch.int64) * MICROS_PER_SECOND
    if src is DType.DATE and to.is_integral:
        return d.to(to.torch_dtype())
    if src.is_floating and to.is_integral:
        return _float_to_integral(d, to)
    if src.is_numeric and to.is_numeric:
        return d.to(to.torch_dtype())
    return None


def _saturate(d: torch.Tensor, to: DType) -> torch.Tensor:
    """Floats -> integral type ``to``, NaN -> 0 and saturated at its
    bounds, truncated toward zero (the JAX device path's conversion)."""
    lo, hi = _INT_BOUNDS[to]
    d = d.to(torch.float64)
    out = torch.where(torch.isnan(d), 0.0, d.clamp(float(lo), float(hi))) \
        .to(to.torch_dtype())
    # float(hi) rounds up past hi for long: clamp the ends exactly
    out = torch.where(d >= float(hi), hi, out)
    return torch.where(d <= float(lo), lo, out)


def _float_to_integral(d: torch.Tensor, to: DType) -> torch.Tensor:
    """NaN -> 0, saturate to int/long, then wrap to byte/short."""
    wide = DType.LONG if to is DType.LONG else DType.INT
    return _saturate(d, wide).to(to.torch_dtype())
