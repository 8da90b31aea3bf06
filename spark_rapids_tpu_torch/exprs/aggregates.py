"""Aggregate functions as declarative buffers.

An aggregate declares buffer specs (a projection of the input row plus a
reduction kind); the aggregate exec evaluates the projections, reduces each
buffer per group and calls ``evaluate`` on the reduced buffers. Only the
``sum`` kind is needed by Sum, Count and Average.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


@dataclass(frozen=True)
class BufferSpec:
    dtype: DType
    kind: str  # sum


class AggregateFunction(Expression):
    """Base for declarative aggregate functions. Not row-evaluable."""

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
