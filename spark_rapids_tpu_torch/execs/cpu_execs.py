"""Host-side leaf: an in-memory table (the JAX package's CpuLocalScanExec
role; the port has no CPU engine, so this is its only host operator)."""
from __future__ import annotations

from typing import Iterator, Optional

from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.base import (ExecContext, LeafExec,
                                               PhysicalExec)

#: nominal bytes per value of each type (the JAX package's size estimates)
_DTYPE_WIDTH = {DType.BOOLEAN: 1, DType.BYTE: 1, DType.SHORT: 2,
                DType.INT: 4, DType.FLOAT: 4, DType.DATE: 4, DType.LONG: 8,
                DType.DOUBLE: 8, DType.TIMESTAMP: 8, DType.STRING: 20,
                DType.NULL: 1}


def _row_width(schema: Schema) -> int:
    """Nominal bytes per row: what a stage's statistics charge a row."""
    return sum(_DTYPE_WIDTH.get(f.dtype, 8) for f in schema)


def width_scaled_estimate(child: PhysicalExec,
                          out_schema: Schema) -> Optional[int]:
    """The child's estimate scaled by the output/input nominal row widths
    (projections, aggregates as an upper bound); None propagates."""
    child_sz = child.size_estimate()
    if child_sz is None:
        return None
    return int(child_sz * _row_width(out_schema)
               / max(_row_width(child.output), 1))


def limit_size_estimate(child: PhysicalExec, out_schema: Schema,
                        n: int) -> Optional[int]:
    """n rows at the nominal width, or the child's estimate if smaller."""
    cap = n * _row_width(out_schema)
    child_sz = child.size_estimate()
    return cap if child_sz is None else min(cap, child_sz)


class CpuLocalScanExec(LeafExec):
    is_device = False

    def __init__(self, batch: HostBatch):
        super().__init__(batch.schema)
        self.batch = batch

    def size_estimate(self) -> int:
        return self.batch.nbytes

    def execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        if ctx.partition_id == 0:
            yield self.batch
