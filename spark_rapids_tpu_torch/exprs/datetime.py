"""Date and time expressions (the JAX package's ``exprs/datetime.py``):
the date parts, the day of the week and of the year, the quarter, the
month's last day, the time parts, date arithmetic and the unix-time
conversions (UTC, the default format only). Timestamps are UTC
microseconds; the calendar comes from Howard Hinnant's civil-from-days,
integer arithmetic only. torch's ``//`` on int64 floors, as numpy's does,
so the era of a day before 1970 is the plain floor quotient."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.cast import (MICROS_PER_DAY,
                                               MICROS_PER_SECOND)
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


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days since the epoch, int64; the inverse of
    ``civil_from_days``."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    mp = m.to(torch.int64) + torch.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + d.to(torch.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


class _DayFn(Expression):
    """A function of a date's (or a timestamp's UTC) day number."""
    out = DType.INT

    def dtype(self) -> DType:
        return self.out

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return ColV(self.out, self.of_days(_days_of(v)), v.validity,
                    is_scalar=v.is_scalar)


@dataclass(frozen=True)
class DayOfWeek(_DayFn):
    """1 = Sunday ... 7 = Saturday (1970-01-01 was a Thursday)."""
    c: Expression

    def of_days(self, days):
        return (torch.remainder(days + 4, 7) + 1).to(torch.int32)


@dataclass(frozen=True)
class DayOfYear(_DayFn):
    c: Expression

    def of_days(self, days):
        y, _, _ = civil_from_days(days)
        one = torch.ones_like(y)
        return (days - days_from_civil(y, one, one) + 1).to(torch.int32)


@dataclass(frozen=True)
class Quarter(_DayFn):
    c: Expression

    def of_days(self, days):
        _, m, _ = civil_from_days(days)
        return (torch.div(m - 1, 3, rounding_mode="floor") + 1) \
            .to(torch.int32)


@dataclass(frozen=True)
class LastDay(_DayFn):
    """The last day of the date's month, a DATE."""
    c: Expression
    out = DType.DATE

    def of_days(self, days):
        y, m, _ = civil_from_days(days)
        first_next = days_from_civil(torch.where(m == 12, y + 1, y),
                                     torch.where(m == 12, 1, m + 1),
                                     torch.ones_like(m))
        return (first_next - 1).to(torch.int32)


class _TimePart(Expression):
    """hour/minute/second of a timestamp (UTC): the microseconds into the
    day divided by ``divisor``, modulo ``modulus``. A DATE is taken at its
    midnight, Spark's cast, so every part is 0; the JAX device path reads
    a date's day number as microseconds there (ROADMAP, divergences)."""
    divisor = 1
    modulus = 1

    def dtype(self) -> DType:
        return DType.INT

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        micros = (v.data.to(torch.int64) * MICROS_PER_DAY
                  if v.dtype is DType.DATE else v.data)
        tod = torch.remainder(micros, MICROS_PER_DAY)
        data = torch.remainder(torch.div(tod, self.divisor,
                                         rounding_mode="floor"),
                               self.modulus).to(torch.int32)
        return ColV(DType.INT, data, v.validity, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class Hour(_TimePart):
    c: Expression
    divisor = 3_600_000_000
    modulus = 24


@dataclass(frozen=True)
class Minute(_TimePart):
    c: Expression
    divisor = 60_000_000
    modulus = 60


@dataclass(frozen=True)
class Second(_TimePart):
    c: Expression
    divisor = 1_000_000
    modulus = 60


@dataclass(frozen=True)
class ToUnixTimestamp(Expression):
    """to_unix_timestamp(ts or date): the UTC epoch seconds, a LONG (the
    default format only, as the JAX package)."""
    c: Expression

    def dtype(self) -> DType:
        return DType.LONG

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        if v.dtype is DType.DATE:
            secs = v.data.to(torch.int64) * 86_400
        elif v.dtype is DType.TIMESTAMP:
            secs = torch.div(v.data, MICROS_PER_SECOND, rounding_mode="floor")
        else:
            raise TypeError(f"{type(self).__name__} takes a date or a "
                            f"timestamp, not {v.dtype.value}")
        return ColV(DType.LONG, secs, v.validity, is_scalar=v.is_scalar)


@dataclass(frozen=True)
class UnixTimestamp(ToUnixTimestamp):
    """unix_timestamp(col): Spark's other name for ``to_unix_timestamp``."""
    c: Expression


@dataclass(frozen=True)
class FromUnixTime(Expression):
    """from_unixtime(seconds) -> 'yyyy-MM-dd HH:mm:ss' in UTC (the default
    format only): 19 bytes, the year's last four digits."""
    c: Expression

    def dtype(self) -> DType:
        return DType.STRING

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        secs = v.data.to(torch.int64)
        days = secs // 86_400
        tod = secs - days * 86_400
        y, m, d = civil_from_days(days)
        y, m, d = y.to(torch.int64), m.to(torch.int64), d.to(torch.int64)
        fields = [(y, 1000), (y, 100), (y, 10), (y, 1), 45, (m, 10), (m, 1),
                  45, (d, 10), (d, 1), 32, (tod // 3600, 10),
                  (tod // 3600, 1), 58, ((tod % 3600) // 60, 10),
                  ((tod % 3600) // 60, 1), 58, (tod % 60, 10), (tod % 60, 1)]
        cols = [torch.full_like(secs, f) if isinstance(f, int)
                else (f[0] // f[1]) % 10 + 48 for f in fields]
        data = torch.stack(cols, dim=-1).to(torch.uint8)
        lengths = torch.full(secs.shape, 19, dtype=torch.int32,
                             device=secs.device)
        return ColV(DType.STRING, data, v.validity, lengths,
                    is_scalar=v.is_scalar)
