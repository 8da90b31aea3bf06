"""Generate physical operator (the JAX package's
``execs/generate_execs.py``): explode of a created array runs as an
Expand. Input row i emits one row per array element j, projected as
(child columns, [pos = j], element j); each input batch gives exactly
``len(elements)`` output batches, so every shape is known from the
plan."""
from __future__ import annotations

from typing import Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.execs.expand_execs import (CpuExpandExec,
                                                       TpuExpandExec)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import BoundReference, Expression
from spark_rapids_tpu_torch.exprs.literals import Literal


def generate_projections(child_schema: Schema,
                         elements: Tuple[Expression, ...], pos: bool,
                         output: Schema) -> Tuple[Tuple[Expression, ...], ...]:
    """One projection list per element: the child's columns, [pos j],
    element j cast to the output column's type."""
    col_type = output.fields[-1].dtype
    projections = []
    for j, e in enumerate(elements):
        row: list = [BoundReference(i, f.dtype, f.nullable, f.name)
                     for i, f in enumerate(child_schema)]
        if pos:
            row.append(Literal(j, DType.INT))
        if e.dtype() is DType.NULL:
            e = Literal(None, col_type)
        elif e.dtype() is not col_type:
            e = Cast(e, col_type)
        row.append(e)
        projections.append(tuple(row))
    return tuple(projections)


class TpuGenerateExec(TpuExpandExec):
    """The Expand exec over ``generate_projections``."""


class CpuGenerateExec(CpuExpandExec):
    """The CPU engine's generate (execs/cpu_execs.py)."""

    def device_twin(self, children):
        return TpuGenerateExec(self.projections, children[0], self._output)
