"""Math expressions (the JAX package's ``exprs/math.py``), with Spark's
semantics as its device path gives them: the unary functions work in
double; ``log``, ``log2`` and ``log10`` are null for inputs <= 0 (NaN
too) and ``log1p`` for inputs <= -1; ``sqrt`` of a negative is NaN and
stays valid; ``log(base, x)`` is null where either is <= 0. ``Floor`` and
``Ceil`` take a float to ``LONG`` and return an integral input as it is;
the conversion saturates and takes NaN to 0, as the JAX device path and
CUDA convert (``exprs/cast.py::_float_to_integral``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.cast import _float_to_integral, _saturate
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV,
                                               EvalCtx, Expression)


@dataclass(frozen=True)
class Round(Expression):
    """round(x, scale), HALF_UP as Spark's BigDecimal rounding: a .5 goes
    away from zero. An integral input with scale >= 0 passes through; any
    other input is scaled in double, rounded and scaled back, then
    converted to its own type: a float to float32, an integral saturating
    at its type's bounds (the JAX device path's conversion)."""
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
        data = rounded / factor
        data = (_saturate(data, v.dtype) if v.dtype.is_integral
                else data.to(v.dtype.torch_dtype()))
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
        return ColV(DType.LONG, _float_to_integral(self.fn(v.data),
                                                   DType.LONG),
                    v.validity, is_scalar=v.is_scalar)


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


class _DoubleUnary(Expression):
    """A unary function evaluated in double: ``fn`` gives the data,
    ``domain`` (where set) the inputs with a result; the rest are null."""
    domain: Optional[Callable] = None

    def dtype(self) -> DType:
        return DType.DOUBLE

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        d = v.data.to(torch.float64)
        valid = v.validity if self.domain is None \
            else v.validity & self.domain(d)
        return ColV(DType.DOUBLE, self.fn(d), valid, is_scalar=v.is_scalar)


def _double_unary(name: str, fn, domain=None):
    cls = dataclass(frozen=True)(type(name, (_DoubleUnary,), {
        "__annotations__": {"c": Expression}, "fn": staticmethod(fn),
        "domain": None if domain is None else staticmethod(domain),
        "__module__": __name__, "__qualname__": name}))
    return cls


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt (correctly rounded) of non-negative doubles. CUDA's is;
    torch's vectorized CPU sqrt is off by one ulp on some inputs (0.5
    among them), while its complex sqrt of a non-negative real takes the
    exact scalar path."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.complex128)).real.contiguous()
    return torch.sqrt(x)


def _cbrt(d: torch.Tensor) -> torch.Tensor:
    """Cube root with the input's sign, ``pow(|x|, 1/3)``: torch has no
    cbrt, and the JAX device path computes it so (within an ulp of it)."""
    return torch.copysign(torch.pow(d.abs(), 1.0 / 3.0), d)


#: past this magnitude torch's sinh and cosh overflow while the true value
#: (about e^|x| / 2, finite up to |x| = 710.47) does not
_HYPERBOLIC_BIG = 709.0


def _sinh(d: torch.Tensor) -> torch.Tensor:
    big = torch.copysign(torch.exp(d.abs() + math.log(0.5)), d)
    return torch.where(d.abs() < _HYPERBOLIC_BIG, torch.sinh(d), big)


def _cosh(d: torch.Tensor) -> torch.Tensor:
    big = torch.exp(d.abs() + math.log(0.5))
    return torch.where(d.abs() < _HYPERBOLIC_BIG, torch.cosh(d), big)


def _positive_log(fn):
    return lambda d: fn(torch.where(d <= 0, 1.0, d))


Sqrt = _double_unary(
    "Sqrt", lambda d: _sqrt(d.abs()) * torch.where(d < 0, math.nan, 1.0))
Cbrt = _double_unary("Cbrt", _cbrt)
Exp = _double_unary("Exp", torch.exp)
Expm1 = _double_unary("Expm1", torch.expm1)
Log = _double_unary("Log", _positive_log(torch.log), lambda d: d > 0)
Log2 = _double_unary("Log2", _positive_log(torch.log2), lambda d: d > 0)
Log10 = _double_unary("Log10", _positive_log(torch.log10), lambda d: d > 0)
Log1p = _double_unary("Log1p",
                      lambda d: torch.log1p(torch.where(d <= -1, 0.0, d)),
                      lambda d: d > -1)
Sin = _double_unary("Sin", torch.sin)
Cos = _double_unary("Cos", torch.cos)
Tan = _double_unary("Tan", torch.tan)
Asin = _double_unary("Asin", torch.asin)
Acos = _double_unary("Acos", torch.acos)
Atan = _double_unary("Atan", torch.atan)
Sinh = _double_unary("Sinh", _sinh)
Cosh = _double_unary("Cosh", _cosh)
Tanh = _double_unary("Tanh", torch.tanh)
ToDegrees = _double_unary("ToDegrees", lambda d: d * (180.0 / math.pi))
ToRadians = _double_unary("ToRadians", lambda d: d * (math.pi / 180.0))
#: sign(x): -0.0 and NaN pass through, as jnp.sign gives them (torch's sign
#: takes both to 0.0)
Signum = _double_unary("Signum", lambda d: torch.where(
    d > 0, 1.0, torch.where(d < 0, -1.0, d)))
#: rint: round half to even, staying a double (Java's Math.rint)
Rint = _double_unary("Rint", torch.round)
Cot = _double_unary("Cot", lambda d: 1.0 / torch.tan(d))
Asinh = _double_unary("Asinh", torch.asinh)
Acosh = _double_unary("Acosh", torch.acosh)
Atanh = _double_unary("Atanh", torch.atanh)


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


@dataclass(frozen=True)
class Atan2(BinaryExpression):
    l: Expression
    r: Expression

    def operand_dtype(self) -> DType:
        return DType.DOUBLE

    def dtype(self) -> DType:
        return DType.DOUBLE

    def do_columnar(self, l: ColV, r: ColV):
        return torch.atan2(l.data, r.data)


@dataclass(frozen=True)
class Logarithm(Expression):
    """log(base, x) = ln(x) / ln(base), null where x <= 0 or base <= 0."""
    b: Expression
    c: Expression

    def dtype(self) -> DType:
        return DType.DOUBLE

    def eval(self, ctx: EvalCtx) -> ColV:
        lb, lv = self.b.eval(ctx), self.c.eval(ctx)
        base, v = lb.data.to(torch.float64), lv.data.to(torch.float64)
        data = torch.log(torch.where(v > 0, v, 1.0)) \
            / torch.log(torch.where(base > 0, base, 1.0))
        valid = lb.validity & lv.validity & (base > 0) & (v > 0)
        return ColV(DType.DOUBLE, data, valid,
                    is_scalar=lb.is_scalar and lv.is_scalar)
