"""Predicate expressions (the JAX package's ``exprs/predicates.py`` up to
``In``). Comparisons are null-intolerant; float comparisons follow Spark's
NaN semantics (NaN = NaN, NaN greater than every other value); strings
compare by their bytes; ``And`` and ``Or`` use Kleene three-valued logic
(false AND null = false, true OR null = true)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (BinaryExpression, ColV,
                                               EvalCtx, Expression,
                                               cast_operand)
from spark_rapids_tpu_torch.ops import strings as sk

_OPS = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


class _Comparison(BinaryExpression):
    op: str = ""

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def do_columnar(self, l: ColV, r: ColV):
        if l.dtype is DType.STRING:
            return sk.string_compare(self.op, l.data, l.lengths, r.data,
                                     r.lengths)
        if l.dtype.is_floating:
            return _float_compare(self.op, l.data, r.data)
        return _OPS[self.op](l.data, r.data)


def _float_compare(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark double ordering: NaN == NaN; NaN greater than everything."""
    an, bn = torch.isnan(a), torch.isnan(b)
    if op in ("eq", "ne"):
        eq = (an & bn) | (a == b)
        return eq if op == "eq" else ~eq
    if op == "lt":
        return (~an & bn) | (a < b)
    if op == "le":
        return bn | (a <= b)
    if op == "gt":
        return (an & ~bn) | (a > b)
    if op == "ge":
        return an | (a >= b)
    raise ValueError(op)


@dataclass(frozen=True)
class EqualTo(_Comparison):
    l: Expression
    r: Expression
    op = "eq"


@dataclass(frozen=True)
class NotEqual(_Comparison):
    l: Expression
    r: Expression
    op = "ne"


@dataclass(frozen=True)
class LessThan(_Comparison):
    l: Expression
    r: Expression
    op = "lt"


@dataclass(frozen=True)
class LessThanOrEqual(_Comparison):
    l: Expression
    r: Expression
    op = "le"


@dataclass(frozen=True)
class GreaterThan(_Comparison):
    l: Expression
    r: Expression
    op = "gt"


@dataclass(frozen=True)
class GreaterThanOrEqual(_Comparison):
    l: Expression
    r: Expression
    op = "ge"


@dataclass(frozen=True)
class EqualNullSafe(BinaryExpression):
    """<=> : nulls compare equal; never returns null."""
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        to = self.operand_dtype()
        l = cast_operand(self.left.eval(ctx), to)
        r = cast_operand(self.right.eval(ctx), to)
        if l.dtype is DType.STRING:
            eq = sk.string_eq(l.data, l.lengths, r.data, r.lengths)
        elif l.dtype.is_floating:
            eq = _float_compare("eq", l.data, r.data)
        else:
            eq = l.data == r.data
        data = (~l.validity & ~r.validity) | (l.validity & r.validity & eq)
        return ColV(DType.BOOLEAN, data, torch.ones_like(data),
                    is_scalar=l.is_scalar and r.is_scalar)


@dataclass(frozen=True)
class Not(Expression):
    c: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(DType.BOOLEAN, ~v.data, v.validity, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class And(Expression):
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def eval(self, ctx: EvalCtx) -> ColV:
        l, r = self.l.eval(ctx), self.r.eval(ctx)
        res_false = (l.validity & ~l.data) | (r.validity & ~r.data)
        valid = (l.validity & r.validity) | res_false
        return ColV(DType.BOOLEAN, l.data & r.data & ~res_false, valid,
                    is_scalar=l.is_scalar and r.is_scalar)


@dataclass(frozen=True)
class Or(Expression):
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def eval(self, ctx: EvalCtx) -> ColV:
        l, r = self.l.eval(ctx), self.r.eval(ctx)
        res_true = (l.validity & l.data) | (r.validity & r.data)
        valid = (l.validity & r.validity) | res_true
        return ColV(DType.BOOLEAN, l.data | r.data, valid,
                    is_scalar=l.is_scalar and r.is_scalar)
