"""Predicate expressions (the JAX package's ``exprs/predicates.py``).
Comparisons are null-intolerant; float comparisons follow Spark's
NaN semantics (NaN = NaN, NaN greater than every other value); strings
compare by their bytes; ``And`` and ``Or`` use Kleene three-valued logic
(false AND null = false, true OR null = true); ``In`` and ``InSet`` follow
Spark's rule for a list: null when nothing matched and the value or an item
is null."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
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


@dataclass(frozen=True)
class In(Expression):
    """value IN (literals...): one equality per item (strings through
    ``string_eq``, floats with NaN = NaN), numerics compared in the wider
    of the two types."""
    value: Expression
    items: Tuple[Expression, ...]      # Literals

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.value.eval(ctx)
        found = None
        has_null_item = False
        for lit in self.items:
            if lit.value is None:
                has_null_item = True
                continue
            lv, vc = lit.eval(ctx), v
            if v.dtype != lv.dtype and v.dtype.is_numeric \
                    and lv.dtype.is_numeric:
                common = DType.common_numeric(v.dtype, lv.dtype)
                vc, lv = cast_operand(v, common), cast_operand(lv, common)
            if v.dtype is DType.STRING:
                eq = sk.string_eq(v.data, v.lengths, lv.data, lv.lengths)
            elif v.dtype.is_floating:
                eq = _float_compare("eq", vc.data, lv.data)
            else:
                eq = vc.data == lv.data
            found = eq if found is None else found | eq
        if found is None:
            found = torch.zeros_like(v.validity)
        valid = v.validity & (found | (not has_null_item))
        return ColV(DType.BOOLEAN, found, valid, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class InSet(Expression):
    """value IN (a large numeric literal set): one ``searchsorted`` probe
    of the sorted set per row instead of one equality per item, in the
    wider domain (a double column against an int set, or float items
    against an int column, compare as doubles)."""
    value: Expression
    values: Tuple      # python scalars, no nulls
    has_null: bool = False

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.value.eval(ctx)
        as_float = v.dtype.is_floating or any(isinstance(x, float)
                                              for x in self.values)
        td = torch.float64 if as_float else v.data.dtype
        table = torch.from_numpy(np.sort(np.asarray(
            list(self.values), np.float64 if as_float
            else v.dtype.np_dtype()))).to(ctx.device)
        d = v.data.to(td)
        idx = torch.searchsorted(table, d)
        hit = table[idx.clamp(0, table.shape[0] - 1)] == d
        found = (idx < table.shape[0]) & hit
        validity = v.validity & found if self.has_null else v.validity
        return ColV(DType.BOOLEAN, found, validity, is_scalar=v.is_scalar)
