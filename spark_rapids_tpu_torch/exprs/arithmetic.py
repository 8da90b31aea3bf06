"""Arithmetic expressions (Spark non-ANSI semantics: integral add, subtract,
multiply, negation and ``abs`` wrap like Java two's complement, as torch's
do, so ``-Long.MinValue`` and ``abs(Long.MinValue)`` stay
``Long.MinValue``; ``Divide`` is always a double; ``div`` is a LONG
truncated toward zero; ``%`` takes the dividend's sign; ``Divide``,
``div``, ``%`` and ``Pmod`` are null on a zero divisor; ``Least`` and
``Greatest`` skip nulls and order NaN above every other value)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV, EvalCtx,
                                               Expression, and_validity,
                                               cast_operand, widen)


class _Arith(BinaryExpression):
    def dtype(self) -> DType:
        return self.operand_dtype()


@dataclass(frozen=True)
class Add(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data + r.data


@dataclass(frozen=True)
class Subtract(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data - r.data


@dataclass(frozen=True)
class Multiply(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data * r.data


class _DivisorNullingBinary(BinaryExpression):
    """An op that is null where its divisor is zero: both operands in the
    operand type, the zero divisors replaced by one before ``do_div``."""

    def eval(self, ctx: EvalCtx) -> ColV:
        to = self.operand_dtype()
        l = cast_operand(self.left.eval(ctx), to)
        r = cast_operand(self.right.eval(ctx), to)
        zero = r.data == 0
        safe = torch.where(zero, 1, r.data).to(r.data.dtype)
        return ColV(self.dtype(), self.do_div(l.data, safe),
                    and_validity(l, r) & ~zero,
                    is_scalar=l.is_scalar and r.is_scalar)

    def do_div(self, l: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclass(frozen=True)
class Divide(_DivisorNullingBinary):
    """``/``: a double result, and null where the divisor is 0 (Spark's
    Divide never yields an infinity from a zero divisor, even for
    doubles)."""
    l: Expression
    r: Expression

    def operand_dtype(self) -> DType:
        return DType.DOUBLE

    def dtype(self) -> DType:
        return DType.DOUBLE

    def do_div(self, l, safe):
        return l / safe


@dataclass(frozen=True)
class IntegralDivide(_DivisorNullingBinary):
    """``div``: both operands as LONG, the quotient truncated toward zero
    (Java's ``/``). A divisor of -1 negates, so Long.MIN div -1 wraps to
    Long.MIN, as Java and the JAX device path give it, and never reaches
    the hardware's division trap."""
    l: Expression
    r: Expression

    def operand_dtype(self) -> DType:
        return DType.LONG

    def dtype(self) -> DType:
        return DType.LONG

    def do_div(self, l, safe):
        minus_one = safe == -1
        q = torch.div(l, torch.where(minus_one, 1, safe).to(safe.dtype),
                      rounding_mode="trunc")
        return torch.where(minus_one, -l, q)


@dataclass(frozen=True)
class Remainder(_DivisorNullingBinary):
    """``%``: the remainder with the dividend's sign (Java's ``%``, C's
    ``fmod`` for floats), in the operands' common type. A divisor of -1
    gives 0 for every dividend and is taken as 1, which keeps Long.MIN %
    -1 off the hardware's division trap."""
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return self.operand_dtype()

    def do_div(self, l, safe):
        if not l.is_floating_point():
            safe = torch.where(safe == -1, 1, safe).to(safe.dtype)
        return torch.fmod(l, safe)


@dataclass(frozen=True)
class Pmod(_DivisorNullingBinary):
    """pmod(a, b): the remainder with the divisor's sign, in the operands'
    common type. Integers take the floor remainder twice, as the JAX
    package's ``mod(mod(a, b) + b, b)``; a divisor of -1 gives 0 for every
    dividend and is taken as 1, which keeps the integer minimum's
    remainder off the hardware's division trap. Floats take ``fmod`` and
    add the divisor back to a negative remainder."""
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return self.operand_dtype()

    def do_div(self, l, safe):
        if l.is_floating_point():
            m = torch.fmod(l, safe)
            return torch.where(m < 0, torch.fmod(m + safe, safe), m)
        safe = torch.where(safe == -1, 1, safe).to(safe.dtype)
        return torch.remainder(torch.remainder(l, safe) + safe, safe)


class _Unary(Expression):
    """A null-intolerant op on one operand, in the operand's type."""

    def dtype(self) -> DType:
        return self.c.dtype()

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(v.dtype, self.fn(v.data), v.validity,
                    is_scalar=v.is_scalar)


@dataclass(frozen=True)
class UnaryMinus(_Unary):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return -d


@dataclass(frozen=True)
class UnaryPositive(_Unary):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return d


@dataclass(frozen=True)
class Abs(_Unary):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return d.abs()


class _LeastGreatest(Expression):
    """least/greatest(...) over numbers or dates in their common type: nulls
    are skipped (null only where every input is), NaN is greater than any
    other value. Each input in turn replaces the running pick where it is
    valid and better, or the pick is null, as in the JAX package."""
    greatest = False

    def dtype(self) -> DType:
        return DType.common_type_all([e.dtype() for e in self.exprs])

    def eval(self, ctx: EvalCtx) -> ColV:
        dt = self.dtype()
        if dt is DType.STRING:
            raise NotImplementedError(
                f"{type(self).__name__.lower()} over strings is not ported "
                f"yet")
        vals = [widen(e.eval(ctx), dt, ctx) for e in self.exprs]
        data, valid = vals[0].data, vals[0].validity
        for v in vals[1:]:
            better = (_nan_gt(v.data, data) if self.greatest
                      else _nan_gt(data, v.data))
            take = v.validity & (better | ~valid)
            data = torch.where(take, v.data, data)
            valid = valid | v.validity
        return ColV(dt, data, valid, is_scalar=all(v.is_scalar for v in vals))


def _nan_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a > b with NaN above everything (Spark's ordering)."""
    if not a.is_floating_point():
        return a > b
    a_nan, b_nan = torch.isnan(a), torch.isnan(b)
    return (a_nan & ~b_nan) | (~b_nan & (a > b))


@dataclass(frozen=True)
class Least(_LeastGreatest):
    exprs: tuple


@dataclass(frozen=True)
class Greatest(_LeastGreatest):
    exprs: tuple
    greatest = True
