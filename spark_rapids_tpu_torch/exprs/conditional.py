"""Conditional expressions: ``If`` and ``CaseWhen`` (the JAX package's
``exprs/conditional.py``), a chain of ``torch.where`` selections. A null
predicate takes the else branch."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import (ColV, EvalCtx, Expression,
                                               widen)
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths


def _select(ctx: EvalCtx, cond: torch.Tensor, t: ColV, f: ColV,
            dt: DType) -> ColV:
    """cond ? t : f, validity included; ``cond`` is a plain bool tensor."""
    t, f = widen(t, dt, ctx), widen(f, dt, ctx)
    scalar = cond.dim() == 0 and t.is_scalar and f.is_scalar
    if dt is DType.STRING:
        if cond.dim() != 0:             # a column-shaped condition
            t = bk.as_column(t, ctx.capacity)
            f = bk.as_column(f, ctx.capacity)
        td, fd = align_widths(t.data, f.data)
        cnd = cond[..., None] if td.dim() == 2 else cond
        return ColV(dt, torch.where(cnd, td, fd),
                    torch.where(cond, t.validity, f.validity),
                    torch.where(cond, t.lengths, f.lengths),
                    is_scalar=scalar)
    return ColV(dt, torch.where(cond, t.data, f.data),
                torch.where(cond, t.validity, f.validity), is_scalar=scalar)


@dataclass(frozen=True)
class If(Expression):
    pred: Expression
    t: Expression
    f: Expression

    def dtype(self) -> DType:
        return DType.common_type(self.t.dtype(), self.f.dtype())

    def eval(self, ctx: EvalCtx) -> ColV:
        p = self.pred.eval(ctx)
        return _select(ctx, p.data & p.validity, self.t.eval(ctx),
                       self.f.eval(ctx), self.dtype())


@dataclass(frozen=True)
class CaseWhen(Expression):
    """branches ((cond, value), ...); the else value is null when absent.
    Earlier branches win."""
    branches: Tuple[Tuple[Expression, Expression], ...]
    else_value: Optional[Expression] = None

    def dtype(self) -> DType:
        dtypes = [v.dtype() for _, v in self.branches]
        if self.else_value is not None:
            dtypes.append(self.else_value.dtype())
        return DType.common_type_all(dtypes)

    @property
    def children(self) -> Tuple[Expression, ...]:
        out = [e for branch in self.branches for e in branch]
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)

    def map_children(self, fn) -> "CaseWhen":
        branches = tuple((fn(c), fn(v)) for c, v in self.branches)
        ev = fn(self.else_value) if self.else_value is not None else None
        return CaseWhen(branches, ev)

    def eval(self, ctx: EvalCtx) -> ColV:
        dt = self.dtype()
        else_expr = self.else_value or Literal(None, dt)
        out = widen(else_expr.eval(ctx), dt, ctx)
        for cond_e, val_e in reversed(self.branches):
            p = cond_e.eval(ctx)
            out = _select(ctx, p.data & p.validity, val_e.eval(ctx), out, dt)
        return out

    def __str__(self) -> str:
        parts = " ".join(f"WHEN {c} THEN {v}" for c, v in self.branches)
        tail = f" ELSE {self.else_value}" if self.else_value is not None \
            else ""
        return f"CASE {parts}{tail} END"
