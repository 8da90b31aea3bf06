"""Column: the user-facing expression builder (pyspark-style)."""
from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.exprs import (Add, Alias, Expression,
                                          LessThanOrEqual, Literal, Multiply,
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
    def __le__(self, o): return Column(LessThanOrEqual(self.expr, _expr(o)))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def __repr__(self):
        return f"Column<{self.expr}>"

    __hash__ = None  # type: ignore[assignment]
