"""Date parts, ``Year``, ``Month``, ``DayOfMonth`` and ``WeekDay``, and
``DateDiff``, ``DateAdd`` and ``DateSub`` (the part of the JAX package's
``exprs/datetime.py`` the query suites and the SQL planner's function table
need). Timestamps are UTC
microseconds; the calendar comes from Howard Hinnant's civil-from-days,
integer arithmetic only. torch's ``//`` on int64 floors, as numpy's does,
so the era of a day before 1970 is the plain floor quotient."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.cast import MICROS_PER_DAY
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month in [1, 12], day in [1, 31]),
    each int32."""
    z = z.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097                                    # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)           # [0, 365]
    mp = (5 * doy + 2) // 153                                 # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                         # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                      # [1, 12]
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _days_of(v: ColV) -> torch.Tensor:
    """A DATE column's days, or a TIMESTAMP column's (floor, UTC)."""
    if v.dtype is DType.DATE:
        return v.data.to(torch.int64)
    return torch.div(v.data, MICROS_PER_DAY, rounding_mode="floor")


class _DatePart(Expression):
    part: str = ""

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.children[0].eval(ctx)
        y, m, d = civil_from_days(_days_of(v))
        data = {"year": y, "month": m, "day": d}[self.part]
        return ColV(DType.INT, data, v.validity, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Year(_DatePart):
    c: Expression
    part = "year"


@dataclass(frozen=True)
class Month(_DatePart):
    c: Expression
    part = "month"


@dataclass(frozen=True)
class DayOfMonth(_DatePart):
    c: Expression
    part = "day"


@dataclass(frozen=True)
class DateDiff(Expression):
    """datediff(end, start): the days from start to end, an INT."""
    end: Expression
    start: Expression

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        e, s = self.end.eval(ctx), self.start.eval(ctx)
        return ColV(DType.INT, e.data.to(torch.int32) - s.data.to(torch.int32),
                    e.validity & s.validity,
                    is_scalar=e.is_scalar and s.is_scalar)


class _DateShift(Expression):
    """date_add/date_sub(date, days): the day number plus or minus the days
    as int32, null where either is."""
    sign = 1

    def dtype(self) -> DType:
        return DType.DATE

    def eval(self, ctx: EvalCtx) -> ColV:
        v, n = self.c.eval(ctx), self.n.eval(ctx)
        days = n.data.to(torch.int32)
        data = (v.data + days if self.sign > 0 else v.data - days) \
            .to(torch.int32)
        return ColV(DType.DATE, data, v.validity & n.validity,
                    is_scalar=v.is_scalar and n.is_scalar)


@dataclass(frozen=True)
class DateAdd(_DateShift):
    c: Expression
    n: Expression


@dataclass(frozen=True)
class DateSub(_DateShift):
    c: Expression
    n: Expression
    sign = -1


@dataclass(frozen=True)
class WeekDay(Expression):
    """weekday(date): 0 = Monday ... 6 = Sunday (1970-01-01 was a
    Thursday, weekday 3)."""
    c: Expression

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        data = torch.remainder(_days_of(v) + 3, 7).to(torch.int32)
        return ColV(DType.INT, data, v.validity, is_scalar=v.is_scalar)
