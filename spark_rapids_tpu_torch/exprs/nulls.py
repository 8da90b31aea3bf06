"""Null handling (the JAX package's ``exprs/nulls.py``): ``IsNull``,
``IsNotNull``, ``IsNan``, ``Coalesce``, ``NaNvl`` and ``AtLeastNNonNulls``.
The predicates here never return null."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (ColV, EvalCtx, Expression,
                                               widen)
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths


def _never_null(data: torch.Tensor, is_scalar: bool) -> ColV:
    return ColV(DType.BOOLEAN, data, torch.ones_like(data, dtype=torch.bool),
                is_scalar=is_scalar)


@dataclass(frozen=True)
class IsNull(Expression):
    c: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return _never_null(~v.validity, v.is_scalar)


@dataclass(frozen=True)
class IsNotNull(Expression):
    c: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return _never_null(v.validity.clone(), v.is_scalar)


@dataclass(frozen=True)
class IsNan(Expression):
    """Spark: isnan(null) is false, never null."""
    c: Expression

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        return _never_null(torch.isnan(v.data) & v.validity, v.is_scalar)


@dataclass(frozen=True)
class Coalesce(Expression):
    """The first non-null of its arguments, row by row."""
    exprs: Tuple[Expression, ...]

    def dtype(self) -> DType:
        return DType.common_type_all([e.dtype() for e in self.exprs])

    def eval(self, ctx: EvalCtx) -> ColV:
        dt = self.dtype()
        out = None
        for e in self.exprs:
            v = bk.as_column(widen(e.eval(ctx), dt, ctx), ctx.capacity)
            if out is None:
                out = v
                continue
            take = ~out.validity & v.validity
            if dt is DType.STRING:
                vd, od = align_widths(v.data, out.data)
                data = torch.where(take[:, None], vd, od)
                lengths = torch.where(take, v.lengths, out.lengths)
            else:
                data, lengths = torch.where(take, v.data, out.data), None
            out = ColV(dt, data, out.validity | v.validity, lengths)
        return out

    def __str__(self) -> str:
        return "coalesce(" + ", ".join(str(e) for e in self.exprs) + ")"


@dataclass(frozen=True)
class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN, else a. A null ``a`` stays null (its
    slot's data may hold a NaN that must not pick ``b``)."""
    l: Expression
    r: Expression

    def dtype(self) -> DType:
        return DType.common_numeric(self.l.dtype(), self.r.dtype())

    def eval(self, ctx: EvalCtx) -> ColV:
        td = self.dtype().torch_dtype()
        a, b = self.l.eval(ctx), self.r.eval(ctx)
        ad, bd = a.data.to(td), b.data.to(td)
        use_b = torch.isnan(ad)
        valid = a.validity & torch.where(use_b, b.validity, True)
        return ColV(self.dtype(), torch.where(use_b, bd, ad), valid,
                    is_scalar=a.is_scalar and b.is_scalar)


@dataclass(frozen=True)
class AtLeastNNonNulls(Expression):
    """dropna's predicate: at least ``n`` children are non-null (and, for
    floats, not NaN); never null."""
    n: int
    exprs: Tuple[Expression, ...]

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        count = None
        for e in self.exprs:
            v = e.eval(ctx)
            ok = v.validity
            if v.dtype.is_floating:
                ok = ok & ~torch.isnan(v.data)
            c = ok.to(torch.int32)
            count = c if count is None else count + c
        return _never_null(count >= self.n, False)
