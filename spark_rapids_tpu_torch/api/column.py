"""Column: the user-facing expression builder (pyspark-style)."""
from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.exprs import (Add, Alias, And, EqualNullSafe,
                                          EqualTo, Expression, GreaterThan,
                                          GreaterThanOrEqual, LessThan,
                                          LessThanOrEqual, Literal, Multiply,
                                          Not, NotEqual, Or, SortOrder,
                                          Subtract)


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

    # ordering (ascending, nulls first, is a sort's default)
    def desc(self): return Column(SortOrder(self.expr, False, False))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def __repr__(self):
        return f"Column<{self.expr}>"

    __hash__ = None  # type: ignore[assignment]
