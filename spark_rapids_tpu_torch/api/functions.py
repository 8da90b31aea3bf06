"""Column functions (pyspark.sql.functions-style): the ones TPC-H Q1 uses."""
from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.exprs import (Average, Count, Literal, Sum,
                                          UnresolvedAttribute)


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(value: Any) -> Column:
    return Column(Literal.of(value))


def _c(c: Union[str, Column]):
    return col(c).expr if isinstance(c, str) else c.expr


def count(c: Union[str, Column] = "*") -> Column:
    if isinstance(c, str):
        return Column(Count(Literal.of(1) if c == "*" else col(c).expr))
    if isinstance(c.expr, Literal):
        return Column(Count(Literal.of(1)))
    return Column(Count(c.expr))


def sum(c: Union[str, Column]) -> Column:  # noqa: A001 - mirrors pyspark
    return Column(Sum(_c(c)))


def avg(c: Union[str, Column]) -> Column:
    return Column(Average(_c(c)))

