"""Column: the user-facing expression builder (pyspark-style)."""
from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs import (Add, Alias, And, BitwiseAnd,
                                          BitwiseOr, BitwiseXor, Cast,
                                          Contains, Divide,
                                          EndsWith, EqualNullSafe, EqualTo,
                                          Expression, GreaterThan,
                                          GreaterThanOrEqual, In, InSet,
                                          IsNan, IsNotNull, IsNull, LessThan,
                                          LessThanOrEqual, Like, Literal,
                                          Multiply, Not, NotEqual, Or,
                                          Remainder, RLike, SortOrder,
                                          StartsWith, Subtract, UnaryMinus)
from spark_rapids_tpu_torch.exprs.strings import GetArrayItem
from spark_rapids_tpu_torch.exprs.windows import WindowExpression


def _expr(v: Any) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal.of(v)


class Column:
    def __init__(self, expr: Expression):
        self.expr = expr

    def __add__(self, o): return Column(Add(self.expr, _expr(o)))
    def __radd__(self, o): return Column(Add(_expr(o), self.expr))
    def __sub__(self, o): return Column(Subtract(self.expr, _expr(o)))
    def __rsub__(self, o): return Column(Subtract(_expr(o), self.expr))
    def __mul__(self, o): return Column(Multiply(self.expr, _expr(o)))
    def __rmul__(self, o): return Column(Multiply(_expr(o), self.expr))
    def __truediv__(self, o): return Column(Divide(self.expr, _expr(o)))
    def __rtruediv__(self, o): return Column(Divide(_expr(o), self.expr))
    def __mod__(self, o): return Column(Remainder(self.expr, _expr(o)))
    def __neg__(self): return Column(UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, o): return Column(EqualTo(self.expr, _expr(o)))  # type: ignore[override]
    def __ne__(self, o): return Column(NotEqual(self.expr, _expr(o)))  # type: ignore[override]
    def __lt__(self, o): return Column(LessThan(self.expr, _expr(o)))
    def __le__(self, o): return Column(LessThanOrEqual(self.expr, _expr(o)))
    def __gt__(self, o): return Column(GreaterThan(self.expr, _expr(o)))
    def __ge__(self, o): return Column(GreaterThanOrEqual(self.expr, _expr(o)))
    def eqNullSafe(self, o): return Column(EqualNullSafe(self.expr, _expr(o)))

    # boolean logic
    def __and__(self, o): return Column(And(self.expr, _expr(o)))
    def __or__(self, o): return Column(Or(self.expr, _expr(o)))
    def __invert__(self): return Column(Not(self.expr))

    # bitwise
    def bitwiseAND(self, o): return Column(BitwiseAnd(self.expr, _expr(o)))
    def bitwiseOR(self, o): return Column(BitwiseOr(self.expr, _expr(o)))
    def bitwiseXOR(self, o): return Column(BitwiseXor(self.expr, _expr(o)))

    # nulls and membership
    def isNull(self): return Column(IsNull(self.expr))
    def isNotNull(self): return Column(IsNotNull(self.expr))
    def isNaN(self): return Column(IsNan(self.expr))

    def isin(self, *vals):
        """More than 16 numeric items take ``InSet`` (one sorted-set probe
        per row), as in the JAX package; else ``In``, one equality per
        item."""
        non_null = [v for v in vals if v is not None]
        if len(non_null) > 16 and all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in non_null):
            return Column(InSet(self.expr, tuple(sorted(non_null)),
                                has_null=len(non_null) < len(vals)))
        return Column(In(self.expr, tuple(Literal.of(v) for v in vals)))

    # strings (constant patterns)
    def startswith(self, p): return Column(StartsWith(self.expr, _expr(p)))
    def endswith(self, p): return Column(EndsWith(self.expr, _expr(p)))
    def contains(self, p): return Column(Contains(self.expr, _expr(p)))
    def like(self, p): return Column(Like(self.expr, _expr(p)))
    def rlike(self, p): return Column(RLike(self.expr, _expr(p)))

    # arrays: an item of array(...) or of split(...)
    def getItem(self, i: int) -> "Column":
        return Column(GetArrayItem(self.expr, int(i)))

    def __getitem__(self, i: int) -> "Column":
        return self.getItem(i)

    # ordering (ascending, nulls first, is a sort's default)
    def asc(self): return Column(SortOrder(self.expr, True, True))
    def asc_nulls_last(self): return Column(SortOrder(self.expr, True, False))
    def desc(self): return Column(SortOrder(self.expr, False, False))
    def desc_nulls_first(self): return Column(SortOrder(self.expr, False, True))

    # windowing
    def over(self, spec) -> "Column":
        return Column(WindowExpression(self.expr, spec._part, spec._orders,
                                       spec._frame))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def cast(self, to: Union[str, DType]) -> "Column":
        """A cast to a type given by name (``"int"``, ``"double"``, ...) or
        as a ``DType``."""
        return Column(Cast(self.expr, DType(to) if isinstance(to, str)
                           else to))

    def __repr__(self):
        return f"Column<{self.expr}>"

    __hash__ = None  # type: ignore[assignment]
