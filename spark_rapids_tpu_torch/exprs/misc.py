"""Named expressions and sort ordering."""
from __future__ import annotations

from dataclasses import dataclass

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


@dataclass(frozen=True)
class Alias(Expression):
    c: Expression
    name: str

    def dtype(self) -> DType:
        return self.c.dtype()

    def nullable(self) -> bool:
        return self.c.nullable()

    @property
    def name_hint(self) -> str:
        return self.name

    def eval(self, ctx: EvalCtx) -> ColV:
        return self.c.eval(ctx)

    def __str__(self) -> str:
        return f"{self.c} AS {self.name}"


@dataclass(frozen=True)
class SortOrder(Expression):
    """Sort key spec: direction + null ordering (consumed by the sort exec)."""
    child: Expression
    ascending: bool = True
    nulls_first: bool = True

    def dtype(self) -> DType:
        return self.child.dtype()

    def eval(self, ctx: EvalCtx) -> ColV:
        return self.child.eval(ctx)
