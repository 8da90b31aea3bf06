"""Aggregate functions as declarative buffers.

An aggregate declares buffer specs (a projection of the input row plus a
reduction kind); the aggregate exec evaluates the projections, reduces each
buffer per group and calls ``evaluate`` on the reduced buffers. Sum, Count
and Average reduce ``sum`` buffers; Min and Max reduce ``min`` and ``max``
buffers (a null input is projected to the reduction's neutral value; a
string buffer keeps its rows and reduces by byte order). First and Last
reduce ``first`` and ``last`` buffers: the value of the group's first or
last row, or of its first or last valid row with ``ignore_nulls``.
The moments (variance, stddev, corr, covar) reduce sum-of-powers
buffers, so every mode and both devices reduce them as they reduce a sum
(on the GPU a float sum adds in a fixed order, ``segment_sum``).
``DistinctAgg`` marks an aggregate over distinct values; the DataFrame API
rewrites it away before planning.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


@dataclass(frozen=True)
class BufferSpec:
    """One buffer: its dtype and reduction kind. ``ignore_nulls`` matters
    only to first/last: the first/last valid row instead of the first/last
    row outright (which may be null)."""
    dtype: DType
    kind: str  # sum | min | max | first | last
    ignore_nulls: bool = False


class AggregateFunction(Expression):
    """Base for declarative aggregate functions. Not row-evaluable."""

    @property
    def child(self) -> Expression:
        return self.children[0] if self.children else None

    def eval(self, ctx: EvalCtx) -> ColV:
        raise TypeError(f"{type(self).__name__} must be evaluated by an "
                        f"aggregate exec")

    def buffer_specs(self) -> List[BufferSpec]:
        raise NotImplementedError

    def project(self, ctx: EvalCtx) -> List[ColV]:
        """Input rows -> per-buffer update values (before reduction)."""
        raise NotImplementedError

    def evaluate(self, buffers: List[ColV]) -> ColV:
        """Reduced buffers -> the final result column."""
        raise NotImplementedError


def _sum_dtype(dt: DType) -> DType:
    if dt.is_floating:
        return DType.DOUBLE
    if dt.is_integral:
        return DType.LONG
    raise TypeError(f"sum of {dt}")


def _broadcast(t: torch.Tensor, ctx: EvalCtx) -> torch.Tensor:
    return t.expand(ctx.capacity) if t.dim() == 0 else t


@dataclass(frozen=True)
class Sum(AggregateFunction):
    c: Expression

    def dtype(self) -> DType:
        return _sum_dtype(self.c.dtype())

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(self.dtype(), "sum")]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        v = self.c.eval(ctx)
        dt = self.dtype()
        data = torch.where(v.validity, v.data, 0).to(dt.torch_dtype())
        return [ColV(dt, _broadcast(data, ctx), _broadcast(v.validity, ctx))]

    def evaluate(self, buffers: List[ColV]) -> ColV:
        return buffers[0]


@dataclass(frozen=True)
class Count(AggregateFunction):
    """count(expr): the non-null count; count(*) has a literal child."""
    c: Expression

    def dtype(self) -> DType:
        return DType.LONG

    def nullable(self) -> bool:
        return False

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(DType.LONG, "sum")]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        ones = _broadcast(self.c.eval(ctx).validity.to(torch.int64), ctx)
        return [ColV(DType.LONG, ones, torch.ones_like(ones, dtype=torch.bool))]

    def evaluate(self, buffers: List[ColV]) -> ColV:
        b = buffers[0]
        # count is 0, not null, for a group without valid inputs
        return ColV(DType.LONG, b.data, torch.ones_like(b.validity))


class _MinMax(AggregateFunction):
    kind = ""

    def dtype(self) -> DType:
        return self.c.dtype()

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(self.dtype(), self.kind)]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        v = self.c.eval(ctx)
        if v.dtype is DType.STRING:
            return [v]
        data = torch.where(v.validity, v.data,
                           _reduce_neutral(self.kind, v.dtype))
        return [ColV(v.dtype, data.to(v.data.dtype), v.validity,
                     is_scalar=v.is_scalar)]

    def evaluate(self, buffers: List[ColV]) -> ColV:
        return buffers[0]


@dataclass(frozen=True)
class Min(_MinMax):
    c: Expression
    kind = "min"


@dataclass(frozen=True)
class Max(_MinMax):
    c: Expression
    kind = "max"


class _FirstLast(AggregateFunction):
    kind = ""

    def dtype(self) -> DType:
        return self.c.dtype()

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(self.dtype(), self.kind, self.ignore_nulls)]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        return [self.c.eval(ctx)]

    def evaluate(self, buffers: List[ColV]) -> ColV:
        return buffers[0]


@dataclass(frozen=True)
class First(_FirstLast):
    c: Expression
    ignore_nulls: bool = False
    kind = "first"


@dataclass(frozen=True)
class Last(_FirstLast):
    c: Expression
    ignore_nulls: bool = False
    kind = "last"


class _MomentBase(AggregateFunction):
    """variance and stddev: the buffers (count, sum, sum of squares), all
    sums, so any grouping mode reduces them (the JAX package's
    sum-of-powers form of Spark's central-moment buffer)."""

    def dtype(self) -> DType:
        return DType.DOUBLE

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(DType.LONG, "sum"), BufferSpec(DType.DOUBLE, "sum"),
                BufferSpec(DType.DOUBLE, "sum")]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        v = self.c.eval(ctx)
        x = _broadcast(torch.where(v.validity, v.data, 0).to(torch.float64),
                       ctx)
        valid = _broadcast(v.validity, ctx)
        n = valid.to(torch.int64)
        return [ColV(DType.LONG, n, torch.ones_like(valid)),
                ColV(DType.DOUBLE, x, valid),
                ColV(DType.DOUBLE, x * x, valid)]

    @staticmethod
    def _moments(buffers: List[ColV]):
        n = buffers[0].data.to(torch.float64)
        s, ss = buffers[1].data, buffers[2].data
        # the clamp takes off catastrophic cancellation's negative residue
        m2 = (ss - s * s / torch.where(n == 0, 1.0, n)).clamp(min=0.0)
        return n, m2


@dataclass(frozen=True)
class VarianceSamp(_MomentBase):
    c: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, m2 = self._moments(buffers)
        return ColV(DType.DOUBLE, m2 / torch.where(n < 2, 1.0, n - 1.0),
                    n >= 2)


@dataclass(frozen=True)
class VariancePop(_MomentBase):
    c: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, m2 = self._moments(buffers)
        return ColV(DType.DOUBLE, m2 / torch.where(n == 0, 1.0, n), n >= 1)


@dataclass(frozen=True)
class StddevSamp(_MomentBase):
    c: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, m2 = self._moments(buffers)
        return ColV(DType.DOUBLE,
                    torch.sqrt(m2 / torch.where(n < 2, 1.0, n - 1.0)),
                    n >= 2)


@dataclass(frozen=True)
class StddevPop(_MomentBase):
    c: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, m2 = self._moments(buffers)
        return ColV(DType.DOUBLE, torch.sqrt(m2 / torch.where(n == 0, 1.0, n)),
                    n >= 1)


class _BivariateBase(AggregateFunction):
    """corr and covar: the buffers (n, sum x, sum y, sum xy[, sum x^2,
    sum y^2]); a row takes part only where both sides are valid (Spark's
    pairwise deletion)."""
    with_squares = False

    @property
    def x(self) -> Expression:
        return self.children[0]

    @property
    def y(self) -> Expression:
        return self.children[1]

    def dtype(self) -> DType:
        return DType.DOUBLE

    def buffer_specs(self) -> List[BufferSpec]:
        return ([BufferSpec(DType.LONG, "sum")]
                + [BufferSpec(DType.DOUBLE, "sum")]
                * (5 if self.with_squares else 3))

    def project(self, ctx: EvalCtx) -> List[ColV]:
        xv, yv = self.x.eval(ctx), self.y.eval(ctx)
        both = _broadcast(xv.validity & yv.validity, ctx)
        x = _broadcast(xv.data.to(torch.float64), ctx)
        y = _broadcast(yv.data.to(torch.float64), ctx)
        x, y = torch.where(both, x, 0.0), torch.where(both, y, 0.0)
        cols = [ColV(DType.LONG, both.to(torch.int64), torch.ones_like(both)),
                ColV(DType.DOUBLE, x, both), ColV(DType.DOUBLE, y, both),
                ColV(DType.DOUBLE, x * y, both)]
        if self.with_squares:
            cols += [ColV(DType.DOUBLE, x * x, both),
                     ColV(DType.DOUBLE, y * y, both)]
        return cols

    @staticmethod
    def _cov(buffers: List[ColV]):
        n = buffers[0].data.to(torch.float64)
        sx, sy, sxy = (b.data for b in buffers[1:4])
        return n, sxy - sx * sy / torch.where(n == 0, 1.0, n)


@dataclass(frozen=True)
class Corr(_BivariateBase):
    """Pearson's correlation; null below two rows or at zero variance."""
    cx: Expression
    cy: Expression
    with_squares = True

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, cov = self._cov(buffers)
        sx, sy, _, sxx, syy = (b.data for b in buffers[1:])
        safe_n = torch.where(n == 0, 1.0, n)
        vx = (sxx - sx * sx / safe_n).clamp(min=0.0)
        vy = (syy - sy * sy / safe_n).clamp(min=0.0)
        denom = torch.sqrt(vx * vy)
        return ColV(DType.DOUBLE, cov / torch.where(denom == 0, 1.0, denom),
                    (n >= 2) & (denom > 0))


@dataclass(frozen=True)
class CovarSamp(_BivariateBase):
    cx: Expression
    cy: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, cov = self._cov(buffers)
        return ColV(DType.DOUBLE, cov / torch.where(n < 2, 1.0, n - 1.0),
                    n >= 2)


@dataclass(frozen=True)
class CovarPop(_BivariateBase):
    cx: Expression
    cy: Expression

    def evaluate(self, buffers: List[ColV]) -> ColV:
        n, cov = self._cov(buffers)
        return ColV(DType.DOUBLE, cov / torch.where(n == 0, 1.0, n), n >= 1)


@dataclass(frozen=True)
class DistinctAgg(AggregateFunction):
    """Marker wrapping an aggregate over the DISTINCT values of its child.
    Never executed: ``GroupedData.agg`` rewrites an aggregation holding one
    into dedup-then-aggregate subplans joined on the grouping keys."""
    inner: AggregateFunction

    def dtype(self) -> DType:
        return self.inner.dtype()

    def nullable(self) -> bool:
        return self.inner.nullable()

    @property
    def name_hint(self) -> str:
        return f"{self.inner.name_hint}_distinct"


def _reduce_neutral(kind: str, dt: DType):
    """The neutral value a null input is projected to before a reduction:
    the integral bounds for integers and dates (never a float infinity),
    the infinities for floats."""
    if kind == "sum":
        return 0
    if dt.is_floating:
        return float("inf") if kind == "min" else float("-inf")
    if dt is DType.BOOLEAN:
        return kind == "min"
    info = torch.iinfo(dt.torch_dtype())
    if kind == "min":
        return info.max
    if kind == "max":
        return info.min
    raise ValueError(kind)


@dataclass(frozen=True)
class Average(AggregateFunction):
    c: Expression

    def dtype(self) -> DType:
        return DType.DOUBLE

    def buffer_specs(self) -> List[BufferSpec]:
        return [BufferSpec(DType.DOUBLE, "sum"), BufferSpec(DType.LONG, "sum")]

    def project(self, ctx: EvalCtx) -> List[ColV]:
        v = self.c.eval(ctx)
        s = _broadcast(torch.where(v.validity, v.data, 0).to(torch.float64), ctx)
        n = _broadcast(v.validity.to(torch.int64), ctx)
        return [ColV(DType.DOUBLE, s, _broadcast(v.validity, ctx)),
                ColV(DType.LONG, n, torch.ones_like(n, dtype=torch.bool))]

    def evaluate(self, buffers: List[ColV]) -> ColV:
        s, n = buffers
        cnt = n.data
        return ColV(DType.DOUBLE, s.data / torch.where(cnt == 0, 1, cnt),
                    cnt > 0)
