"""Expand physical operator (the JAX package's ``execs/expand_execs.py``):
each input batch yields one output batch per projection list, for
rollup, cube and grouping sets. A typed-null slot (a rolled-up key) is
pinned to the slot's resolved type so every projection aligns; the
aggregate above concatenates the batches."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.execs.tpu_execs import batch_of, eval_ctx
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.misc import Alias
from spark_rapids_tpu_torch.ops import batch_kernels as bk


def _aligned(projections: Tuple[Tuple[Expression, ...], ...],
             output: Schema) -> Tuple[Tuple[Expression, ...], ...]:
    """Name every slot and pin typed nulls to the slot's resolved type."""
    out = []
    for plist in projections:
        row = []
        for e, f in zip(plist, output):
            if isinstance(e, Alias):
                e = e.c
            if isinstance(e, Literal) and e.dtype() is DType.NULL:
                e = Literal(None, f.dtype)
            row.append(Alias(e, f.name))
        out.append(tuple(row))
    return tuple(out)


class TpuExpandExec(PhysicalExec):
    def __init__(self, projections: Tuple[Tuple[Expression, ...], ...],
                 child: PhysicalExec, output: Schema):
        super().__init__((child,), output)
        self.projections = _aligned(projections, output)

    def size_estimate(self) -> Optional[int]:
        # every input row emits one row per projection list
        child_sz = self.children[0].size_estimate()
        return None if child_sz is None else \
            child_sz * len(self.projections)

    def execute(self, ctx: ExecContext) -> Iterator:
        for batch in self.children[0].execute(ctx):
            ectx = eval_ctx(batch, ctx)
            for plist in self.projections:
                yield batch_of(self.output,
                               [bk.as_column(e.eval(ectx), batch.capacity)
                                for e in plist], batch.num_rows)


class CpuExpandExec(CpuEngineExec):
    """The CPU engine's expand (execs/cpu_execs.py)."""

    def __init__(self, projections: Tuple[Tuple[Expression, ...], ...],
                 child: PhysicalExec, output: Schema):
        self.projections = projections
        self._output = output
        super().__init__((child,))

    def device_twin(self, children):
        return TpuExpandExec(self.projections, children[0], self._output)
