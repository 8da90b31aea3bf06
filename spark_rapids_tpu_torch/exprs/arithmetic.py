"""Arithmetic expressions (Spark non-ANSI semantics: integral add, subtract
and multiply wrap like Java two's complement, as torch's do; ``Divide`` is
always a double and null on a zero divisor). The JAX package's
``IntegralDivide``, ``Remainder`` and ``Pmod`` are not ported yet."""
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


@dataclass(frozen=True)
class Divide(BinaryExpression):
    """``/``: a double result, and null where the divisor is 0 (Spark's
    Divide never yields an infinity from a zero divisor, even for
    doubles)."""
    l: Expression
    r: Expression

    def operand_dtype(self) -> DType:
        return DType.DOUBLE

    def dtype(self) -> DType:
        return DType.DOUBLE

    def eval(self, ctx: EvalCtx) -> ColV:
        l = cast_operand(self.left.eval(ctx), DType.DOUBLE)
        r = cast_operand(self.right.eval(ctx), DType.DOUBLE)
        zero = r.data == 0
        data = l.data / torch.where(zero, 1.0, r.data)
        return ColV(DType.DOUBLE, data, and_validity(l, r) & ~zero,
                    is_scalar=l.is_scalar and r.is_scalar)
