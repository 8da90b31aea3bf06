"""Column: the user-facing expression builder (pyspark-style)."""
from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.exprs import (Add, Alias, And, Contains, Divide,
                                          EndsWith, EqualNullSafe, EqualTo,
                                          Expression, GreaterThan,
                                          GreaterThanOrEqual, In, InSet,
                                          IsNan, IsNotNull, IsNull, LessThan,
                                          LessThanOrEqual, Like, Literal,
                                          Multiply, Not, NotEqual, Or,
                                          SortOrder, StartsWith, Subtract)


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

    # ordering (ascending, nulls first, is a sort's default)
    def desc(self): return Column(SortOrder(self.expr, False, False))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def __repr__(self):
        return f"Column<{self.expr}>"

    __hash__ = None  # type: ignore[assignment]
