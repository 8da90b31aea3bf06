"""Column functions (pyspark.sql.functions-style): the ones the 22 TPC-H
queries use."""
from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.api.column import Column, _expr
from spark_rapids_tpu_torch.exprs import (Average, CaseWhen, Count,
                                          DayOfMonth, Literal, Max, Min,
                                          Month, Substring, Sum,
                                          UnresolvedAttribute, Year)


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



def min(c: Union[str, Column]) -> Column:  # noqa: A001 - mirrors pyspark
    return Column(Min(_c(c)))


def max(c: Union[str, Column]) -> Column:  # noqa: A001 - mirrors pyspark
    return Column(Max(_c(c)))


# conditionals
class _WhenColumn(Column):
    def __init__(self, branches):
        self._branches = branches
        super().__init__(CaseWhen(tuple(branches), None))

    def when(self, cond: Column, value: Any) -> "_WhenColumn":
        return _WhenColumn(self._branches + [(cond.expr, _expr(value))])

    def otherwise(self, value: Any) -> Column:
        return Column(CaseWhen(tuple(self._branches), _expr(value)))


def when(cond: Column, value: Any) -> _WhenColumn:
    return _WhenColumn([(cond.expr, _expr(value))])


# strings and dates
def substring(c: Union[str, Column], pos: int, length: int) -> Column:
    return Column(Substring(_c(c), Literal.of(pos), Literal.of(length)))


def year(c: Union[str, Column]) -> Column:
    return Column(Year(_c(c)))


def month(c: Union[str, Column]) -> Column:
    return Column(Month(_c(c)))


def dayofmonth(c: Union[str, Column]) -> Column:
    return Column(DayOfMonth(_c(c)))
