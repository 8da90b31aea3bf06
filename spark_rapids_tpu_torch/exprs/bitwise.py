"""Bitwise expressions (the JAX package's ``exprs/bitwise.py``), Java's
semantics: and, or, xor and not in the operands' common integral type; a
shift keeps the left operand's type and masks the amount by its width
(``x << 33 == x << 1`` for an int); ``>>`` extends the sign and ``>>>``
fills with zeros."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.arithmetic import _Unary
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV,
                                               EvalCtx, Expression)


class _Bitwise(BinaryExpression):
    def dtype(self) -> DType:
        return self.operand_dtype()


@dataclass(frozen=True)
class BitwiseAnd(_Bitwise):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data & r.data


@dataclass(frozen=True)
class BitwiseOr(_Bitwise):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data | r.data


@dataclass(frozen=True)
class BitwiseXor(_Bitwise):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data ^ r.data


@dataclass(frozen=True)
class BitwiseNot(_Unary):
    c: Expression

    def fn(self, d: torch.Tensor) -> torch.Tensor:
        return ~d


class _Shift(Expression):
    def dtype(self) -> DType:
        return self.l.dtype()

    def nullable(self) -> bool:
        return self.l.nullable() or self.r.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v, s = self.l.eval(ctx), self.r.eval(ctx)
        width = v.data.element_size() * 8
        amount = (s.data & (width - 1)).to(v.data.dtype)
        return ColV(v.dtype, self.shift(v.data, amount, width),
                    v.validity & s.validity,
                    is_scalar=v.is_scalar and s.is_scalar)


@dataclass(frozen=True)
class ShiftLeft(_Shift):
    l: Expression
    r: Expression

    def shift(self, d, amount, width):
        return d << amount


@dataclass(frozen=True)
class ShiftRight(_Shift):
    """Arithmetic (sign-extending) right shift."""
    l: Expression
    r: Expression

    def shift(self, d, amount, width):
        return d >> amount


@dataclass(frozen=True)
class ShiftRightUnsigned(_Shift):
    """Logical right shift (Java's ``>>>``): zero-fill. torch has no
    unsigned 32/64-bit shift, so the sign-extended shift's top ``amount``
    bits are cleared with a mask."""
    l: Expression
    r: Expression

    def shift(self, d, amount, width):
        ones = torch.full_like(d, -1)
        keep = ~((ones << (width - 1 - amount)) << 1)
        return (d >> amount) & keep
