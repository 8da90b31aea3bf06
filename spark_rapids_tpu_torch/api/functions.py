"""Column functions (pyspark.sql.functions-style): the ones the 22 TPC-H
queries, the TPC-DS bench subset and TPCx-BB q5 use."""
from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.api.column import Column, _expr
from spark_rapids_tpu_torch.exprs import (Average, CaseWhen, Coalesce, Count,
                                          DayOfMonth, DistinctAgg, First,
                                          Last, Literal, Max, Min, Month,
                                          Substring, Sum,
                                          UnresolvedAttribute, Year)
from spark_rapids_tpu_torch.exprs.windows import DenseRank, Rank, RowNumber


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


def first(c: Union[str, Column], ignorenulls: bool = False) -> Column:
    return Column(First(_c(c), ignorenulls))


def last(c: Union[str, Column], ignorenulls: bool = False) -> Column:
    return Column(Last(_c(c), ignorenulls))


def countDistinct(c: Union[str, Column]) -> Column:
    return Column(DistinctAgg(count(c).expr))


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


def coalesce(*cols: Column) -> Column:
    return Column(Coalesce(tuple(_expr(c) for c in cols)))


# strings and dates
def substring(c: Union[str, Column], pos: int, length: int) -> Column:
    return Column(Substring(_c(c), Literal.of(pos), Literal.of(length)))


def year(c: Union[str, Column]) -> Column:
    return Column(Year(_c(c)))


def month(c: Union[str, Column]) -> Column:
    return Column(Month(_c(c)))


def dayofmonth(c: Union[str, Column]) -> Column:
    return Column(DayOfMonth(_c(c)))


# window functions
def row_number() -> Column:
    return Column(RowNumber())


def rank() -> Column:
    return Column(Rank())


def dense_rank() -> Column:
    return Column(DenseRank())
