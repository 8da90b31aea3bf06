"""Arithmetic expressions (Spark non-ANSI semantics: integral add, subtract
and multiply wrap like Java two's complement, as torch's do; ``Divide`` is
always a double, and ``Divide`` and ``Pmod`` are null on a zero divisor).
The JAX package's ``IntegralDivide`` and ``Remainder`` are not ported
yet."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV, EvalCtx,
                                               Expression, and_validity,
                                               cast_operand)


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
