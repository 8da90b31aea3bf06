"""Column functions (pyspark.sql.functions-style): the JAX package's
``api/functions.py``."""
from __future__ import annotations

from typing import Any, Optional, Union

from spark_rapids_tpu_torch.api.column import Column, _expr
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs import (
    Abs, Acos, Acosh, Asin, Asinh, Atan, Atan2, Atanh, Average, CaseWhen,
    Cbrt, Ceil, Coalesce, Concat, Corr, Cos, Cosh, Cot, Count, CovarPop,
    CovarSamp, DateAdd, DateDiff, DateSub, DayOfMonth, DayOfWeek, DayOfYear,
    DistinctAgg, Exp, Expm1, First, Floor, FromUnixTime, Greatest, Hour,
    InitCap, Last, LastDay, Least, Length, Literal, Log, Log1p, Log2, Log10,
    Logarithm, Lower, Max, Min, Minute, MonotonicallyIncreasingID, Month,
    NaNvl, Pmod, Pow, Quarter, RegExpReplace, Rint, Round, Second, Signum,
    Sin, Sinh, SparkPartitionID, Sqrt, StddevPop, StddevSamp, StringLocate,
    StringLPad, StringReplace, StringRPad, StringSplit, StringTrim,
    StringTrimLeft, StringTrimRight, Substring, SubstringIndex, Sum, Tan,
    Tanh, ToDegrees, ToRadians, ToUnixTimestamp, UnixTimestamp,
    UnresolvedAttribute, Upper, VariancePop, VarianceSamp, WeekDay, Year)
from spark_rapids_tpu_torch.exprs.generators import CreateArray, Explode
from spark_rapids_tpu_torch.exprs.misc import Rand
from spark_rapids_tpu_torch.exprs.windows import (CumeDist, DenseRank, Lag,
                                                  Lead, NTile, PercentRank,
                                                  Rank, RowNumber)


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(value: Any) -> Column:
    return Column(Literal.of(value))


def rand(seed: int = 0) -> Column:
    return Column(Rand(seed))


def monotonically_increasing_id() -> Column:
    return Column(MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    return Column(SparkPartitionID())


def input_file_name() -> Column:
    """Path of the file the row was read from; the scan's hidden metadata
    columns carry it per batch."""
    from spark_rapids_tpu_torch.exprs.misc import InputFileName
    return Column(InputFileName())


def input_file_block_start() -> Column:
    from spark_rapids_tpu_torch.exprs.misc import InputFileBlockStart
    return Column(InputFileBlockStart())


def input_file_block_length() -> Column:
    from spark_rapids_tpu_torch.exprs.misc import InputFileBlockLength
    return Column(InputFileBlockLength())


def _c(c: Union[str, Column]):
    return col(c).expr if isinstance(c, str) else c.expr


def udf(f=None, returnType: Union[str, DType] = DType.DOUBLE):
    """Row UDF wrapper (pyspark.sql.functions.udf). The returned callable
    makes a PythonUDF expression: row at a time on the CPU engine by
    default; with spark.rapids.tpu.sql.udfCompiler.enabled the planner
    compiles the function's bytecode into an expression tree that runs on
    the device. ``@udf("int")`` names the return type positionally."""
    from spark_rapids_tpu_torch.udf import PythonUDF
    if isinstance(f, (str, DType)):
        f, returnType = None, f
    ret = DType(returnType) if isinstance(returnType, str) else returnType

    def make(fn):
        def wrapper(*cols: Union[str, Column]) -> Column:
            return Column(PythonUDF(fn, ret, tuple(_c(c) for c in cols)))
        wrapper.__name__ = getattr(fn, "__name__", "udf")
        return wrapper
    return make if f is None else make(f)


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


mean = avg


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


count_distinct = countDistinct


def sumDistinct(c: Union[str, Column]) -> Column:
    return Column(DistinctAgg(Sum(_c(c))))


sum_distinct = sumDistinct


def stddev(c: Union[str, Column]) -> Column:
    return Column(StddevSamp(_c(c)))


stddev_samp = stddev


def stddev_pop(c: Union[str, Column]) -> Column:
    return Column(StddevPop(_c(c)))


def variance(c: Union[str, Column]) -> Column:
    return Column(VarianceSamp(_c(c)))


var_samp = variance


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
cbrt = _unary(Cbrt)
exp = _unary(Exp)
expm1 = _unary(Expm1)
log = _unary(Log)
log2 = _unary(Log2)
log10 = _unary(Log10)
log1p = _unary(Log1p)
sin = _unary(Sin)
cos = _unary(Cos)
tan = _unary(Tan)
cot = _unary(Cot)
asin = _unary(Asin)
acos = _unary(Acos)
atan = _unary(Atan)
sinh = _unary(Sinh)
cosh = _unary(Cosh)
tanh = _unary(Tanh)
asinh = _unary(Asinh)
acosh = _unary(Acosh)
atanh = _unary(Atanh)
degrees = _unary(ToDegrees)
radians = _unary(ToRadians)
signum = _unary(Signum)
floor = _unary(Floor)
ceil = _unary(Ceil)
rint = _unary(Rint)


def atan2(a, b) -> Column:
    return Column(Atan2(_expr(a), _expr(b)))


def log_base(base: float, c: Union[str, Column]) -> Column:
    return Column(Logarithm(Literal.of(float(base)), _c(c)))


def pow(a, b) -> Column:  # noqa: A001 - mirrors pyspark
    return Column(Pow(_expr(a), _expr(b)))


def pmod(a, b) -> Column:
    return Column(Pmod(_expr(a), _expr(b)))


def round(c: Union[str, Column], scale: int = 0) -> Column:  # noqa: A001
    return Column(Round(_c(c), scale))


# strings and dates
upper = _unary(Upper)
lower = _unary(Lower)
initcap = _unary(InitCap)
length = _unary(Length)
trim = _unary(StringTrim)
year = _unary(Year)
month = _unary(Month)
dayofmonth = _unary(DayOfMonth)
dayofweek = _unary(DayOfWeek)
dayofyear = _unary(DayOfYear)
quarter = _unary(Quarter)
hour = _unary(Hour)
minute = _unary(Minute)
second = _unary(Second)
last_day = _unary(LastDay)
weekday = _unary(WeekDay)
unix_timestamp = _unary(UnixTimestamp)
to_unix_timestamp = _unary(ToUnixTimestamp)
from_unixtime = _unary(FromUnixTime)


def regexp_replace(c: Union[str, Column], pattern: str,
                   replacement: str = "") -> Column:
    return Column(RegExpReplace(_c(c), Literal.of(pattern),
                                Literal.of(replacement)))


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


def percent_rank() -> Column:
    return Column(PercentRank())


def cume_dist() -> Column:
    return Column(CumeDist())


def ntile(n: int) -> Column:
    return Column(NTile(n))
