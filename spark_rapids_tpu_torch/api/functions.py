"""Column functions (pyspark.sql.functions-style): the ones the 22 TPC-H
queries, the 99 TPC-DS queries, the 30 TPCx-BB queries and the SQL
planner's function table use."""
from __future__ import annotations

from typing import Any, Optional, Union

from spark_rapids_tpu_torch.api.column import Column, _expr
from spark_rapids_tpu_torch.exprs import (Abs, Average, CaseWhen, Ceil,
                                          Coalesce, Concat, Corr, Count,
                                          CovarPop, CovarSamp, DateAdd,
                                          DateDiff, DateSub, DayOfMonth,
                                          DistinctAgg, First, Floor,
                                          Greatest, Last, Least, Length,
                                          Literal, Lower, Max, Min,
                                          MonotonicallyIncreasingID, Month,
                                          NaNvl, Pmod, Pow, Round, Sqrt,
                                          StddevPop, StddevSamp,
                                          StringLocate, StringLPad,
                                          StringReplace, StringRPad,
                                          StringSplit, StringTrim,
                                          StringTrimLeft, StringTrimRight,
                                          Substring, SubstringIndex, Sum,
                                          UnresolvedAttribute, Upper,
                                          VariancePop, VarianceSamp, WeekDay,
                                          Year)
from spark_rapids_tpu_torch.exprs.generators import CreateArray, Explode
from spark_rapids_tpu_torch.exprs.misc import Rand
from spark_rapids_tpu_torch.exprs.windows import (DenseRank, Lag, Lead, NTile,
                                                  Rank, RowNumber)


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(value: Any) -> Column:
    return Column(Literal.of(value))


def rand(seed: int = 0) -> Column:
    return Column(Rand(seed))


def monotonically_increasing_id() -> Column:
    return Column(MonotonicallyIncreasingID())


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


def sumDistinct(c: Union[str, Column]) -> Column:
    return Column(DistinctAgg(Sum(_c(c))))


def stddev(c: Union[str, Column]) -> Column:
    return Column(StddevSamp(_c(c)))



def stddev_pop(c: Union[str, Column]) -> Column:
    return Column(StddevPop(_c(c)))


def variance(c: Union[str, Column]) -> Column:
    return Column(VarianceSamp(_c(c)))



def var_pop(c: Union[str, Column]) -> Column:
    return Column(VariancePop(_c(c)))


def corr(a: Union[str, Column], b: Union[str, Column]) -> Column:
    return Column(Corr(_c(a), _c(b)))


def covar_samp(a: Union[str, Column], b: Union[str, Column]) -> Column:
    return Column(CovarSamp(_c(a), _c(b)))


def covar_pop(a: Union[str, Column], b: Union[str, Column]) -> Column:
    return Column(CovarPop(_c(a), _c(b)))


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


def nanvl(a: Column, b: Column) -> Column:
    return Column(NaNvl(_expr(a), _expr(b)))


def greatest(*cols) -> Column:
    return Column(Greatest(tuple(_expr(c) for c in cols)))


def least(*cols) -> Column:
    return Column(Least(tuple(_expr(c) for c in cols)))


# math
def _unary(cls):
    def f(c: Union[str, Column]) -> Column:
        return Column(cls(_c(c)))
    return f


abs = _unary(Abs)  # noqa: A001 - mirrors pyspark
sqrt = _unary(Sqrt)
floor = _unary(Floor)
ceil = _unary(Ceil)


def pow(a, b) -> Column:  # noqa: A001 - mirrors pyspark
    return Column(Pow(_expr(a), _expr(b)))


def pmod(a, b) -> Column:
    return Column(Pmod(_expr(a), _expr(b)))


def round(c: Union[str, Column], scale: int = 0) -> Column:  # noqa: A001
    return Column(Round(_c(c), scale))


# strings and dates
upper = _unary(Upper)
lower = _unary(Lower)
length = _unary(Length)
trim = _unary(StringTrim)


def concat(*cols) -> Column:
    return Column(Concat(tuple(_c(c) for c in cols)))


def ltrim(c: Union[str, Column], trim_chars: Optional[str] = None) -> Column:
    t = None if trim_chars is None else Literal.of(trim_chars)
    return Column(StringTrimLeft(_c(c), t))


def rtrim(c: Union[str, Column], trim_chars: Optional[str] = None) -> Column:
    t = None if trim_chars is None else Literal.of(trim_chars)
    return Column(StringTrimRight(_c(c), t))


def locate(substr: str, c: Union[str, Column], pos: int = 1) -> Column:
    return Column(StringLocate(Literal.of(substr), _c(c), Literal.of(pos)))


def instr(c: Union[str, Column], substr: str) -> Column:
    return Column(StringLocate(Literal.of(substr), _c(c), Literal.of(1)))


def lpad(c: Union[str, Column], length_: int, pad: str) -> Column:
    return Column(StringLPad(_c(c), Literal.of(length_), Literal.of(pad)))


def rpad(c: Union[str, Column], length_: int, pad: str) -> Column:
    return Column(StringRPad(_c(c), Literal.of(length_), Literal.of(pad)))


def replace(c: Union[str, Column], search: str,
            replacement: str = "") -> Column:
    return Column(StringReplace(_c(c), Literal.of(search),
                                Literal.of(replacement)))


def date_add(c, days) -> Column:
    return Column(DateAdd(_c(c) if isinstance(c, str) else c.expr,
                          _expr(days)))


def date_sub(c, days) -> Column:
    return Column(DateSub(_c(c) if isinstance(c, str) else c.expr,
                          _expr(days)))


def weekday(c: Union[str, Column]) -> Column:
    return Column(WeekDay(_c(c)))


def substring(c: Union[str, Column], pos: int, length: int) -> Column:
    return Column(Substring(_c(c), Literal.of(pos), Literal.of(length)))


def substring_index(c: Union[str, Column], delim: str, count_: int) -> Column:
    return Column(SubstringIndex(_c(c), Literal.of(delim),
                                 Literal.of(count_)))


def split(c: Union[str, Column], pattern: str, limit: int = -1) -> Column:
    """split(str, regex), read through ``[i]``/``getItem(i)`` (an array is
    not a column type; the item fuses into one split-field pass). Only
    limit -1, a split at every match."""
    if limit != -1:
        raise NotImplementedError(
            "split() with a positive limit is not supported (only -1)")
    return Column(StringSplit(_c(c), Literal.of(pattern), limit))


def datediff(end, start) -> Column:
    return Column(DateDiff(_expr(end), _expr(start)))


def year(c: Union[str, Column]) -> Column:
    return Column(Year(_c(c)))


def month(c: Union[str, Column]) -> Column:
    return Column(Month(_c(c)))


def dayofmonth(c: Union[str, Column]) -> Column:
    return Column(DayOfMonth(_c(c)))


# arrays and generators
def array(*cols: Union[str, Column]) -> Column:
    """A per-row array of scalar columns, read only by ``explode`` or
    ``[i]``."""
    return Column(CreateArray(tuple(_c(c) for c in cols)))


def _as_created_array(c) -> CreateArray:
    if isinstance(c, (list, tuple)):
        return CreateArray(tuple(Literal.of(v) for v in c))
    e = c.expr if isinstance(c, Column) else None
    if not isinstance(e, CreateArray):
        raise ValueError("explode/posexplode requires array(...) or a "
                         "Python list literal (ARRAY is not a column type)")
    return e


def explode(c) -> Column:
    return Column(Explode(_as_created_array(c)))


def posexplode(c) -> Column:
    return Column(Explode(_as_created_array(c), with_position=True))


# window functions
def lead(c: Union[str, Column], offset: int = 1, default=None) -> Column:
    d = None if default is None else Literal.of(default)
    return Column(Lead(_c(c), offset, d))


def lag(c: Union[str, Column], offset: int = 1, default=None) -> Column:
    d = None if default is None else Literal.of(default)
    return Column(Lag(_c(c), offset, d))


def row_number() -> Column:
    return Column(RowNumber())


def rank() -> Column:
    return Column(Rank())


def dense_rank() -> Column:
    return Column(DenseRank())


def ntile(n: int) -> Column:
    return Column(NTile(n))
