"""Host-side leaf: an in-memory table (the JAX package's CpuLocalScanExec
role; the port has no CPU engine, so this is its only host operator)."""
from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec


class CpuLocalScanExec(LeafExec):
    def __init__(self, batch: HostBatch):
        super().__init__(batch.schema)
        self.batch = batch

    def execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        if ctx.partition_id == 0:
            yield self.batch
