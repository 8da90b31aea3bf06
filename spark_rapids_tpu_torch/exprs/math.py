"""Math expressions: ``Round``, ``Floor``, ``Ceil``, ``Sqrt`` and ``Pow``
(the part of the JAX package's ``exprs/math.py`` the query suites and the
SQL planner's function table use). ``Sqrt`` and ``Pow`` work in double;
``Floor`` and ``Ceil`` take a float to ``LONG`` and return an integral
input as it is."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV,
                                               EvalCtx, Expression)


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


class _FloorCeil(Expression):
    def dtype(self) -> DType:
        dt = self.c.dtype()
        return DType.LONG if dt.is_floating else dt

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        if not v.dtype.is_floating:
            return v
        return ColV(DType.LONG, self.fn(v.data).to(torch.int64), v.validity,
                    is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Floor(_FloorCeil):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return torch.floor(d)


@dataclass(frozen=True)
class Ceil(_FloorCeil):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return torch.ceil(d)


@dataclass(frozen=True)
class Sqrt(Expression):
    """sqrt in double; a negative input gives NaN and stays valid. As the
    JAX package computes it: ``sqrt(|x|)`` times NaN or 1, so ``sqrt(-0.0)``
    is 0.0."""
    c: Expression

    def dtype(self) -> DType:
        return DType.DOUBLE

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        d = v.data.to(torch.float64)
        return ColV(DType.DOUBLE, _sqrt(d.abs()) * torch.where(
            d < 0, float("nan"), 1.0), v.validity, is_scalar=v.is_scalar)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt (correctly rounded) of non-negative doubles. CUDA's is;
    torch's vectorized CPU sqrt is off by one ulp on some inputs (0.5
    among them), while its complex sqrt of a non-negative real takes the
    exact scalar path."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.complex128)).real.contiguous()
    return torch.sqrt(x)


@dataclass(frozen=True)
class Pow(BinaryExpression):
    l: Expression
    r: Expression

    def operand_dtype(self) -> DType:
        return DType.DOUBLE

    def dtype(self) -> DType:
        return DType.DOUBLE

    def do_columnar(self, l: ColV, r: ColV):
        return torch.pow(l.data, r.data)
