"""The cached-table scan (Spark's InMemoryTableScanExec role): a cached
DataFrame's batches served from the spillable store, as the device tier
holds them or uploaded again from the host or disk tier.

It reads through the DeviceManager's catalog with the acquire/close
reference count, so a concurrent spill cannot delete a disk file under a
reader. ``CpuCachedScanExec`` is the CPU engine's form: the same buffers,
brought to the host. A batch the device form yields may be the device
tier's own tensors: no operator writes into an input."""
from __future__ import annotations

from typing import Iterator, Optional

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec


class TpuCachedScanExec(LeafExec):
    """One cached buffer per partition."""

    def __init__(self, entry, output: Schema):
        super().__init__(output)
        self.entry = entry

    @property
    def num_partitions(self) -> int:
        return max(1, len(self.entry.buffer_ids or ()))

    def size_estimate(self) -> Optional[int]:
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        ids = self.entry.buffer_ids
        dm = DeviceManager.peek()
        if not ids or dm is None:
            return None
        total = 0
        for bid in ids:
            buf = dm.catalog.acquire(bid)
            if buf is None:
                return None
            try:
                total += buf.size_bytes
            finally:
                buf.close()
        return total

    def _acquire(self, ctx: ExecContext, partition_id: int):
        ids = self.entry.buffer_ids
        if ids is None:
            raise RuntimeError(
                "cached plan not materialized: cached scans run through "
                "CacheManager.prepare()")
        if partition_id >= len(ids):
            return None
        dm = ctx.device_manager
        if dm is None:
            from spark_rapids_tpu_torch.memory.device_manager import \
                DeviceManager
            dm = DeviceManager.peek()
        buf = dm.catalog.acquire(ids[partition_id]) if dm else None
        if buf is None:
            raise RuntimeError(
                f"cached buffer {ids[partition_id]} missing from the catalog "
                "(unpersisted concurrently?)")
        return buf

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        buf = self._acquire(ctx, ctx.partition_id)
        if buf is None:
            return
        try:
            batch = buf.get_batch()
        finally:
            buf.close()
        yield batch


class CpuCachedScanExec(CpuEngineExec):
    """The cached buffers for the CPU engine: read in the session's
    context, downloaded to the host."""

    def __init__(self, entry, output: Schema):
        self.entry = entry
        self._output = output
        super().__init__(())

    def device_twin(self, children):
        return TpuCachedScanExec(self.entry, self._output)

    def execute(self, ctx: ExecContext) -> Iterator:
        from spark_rapids_tpu_torch.columnar.transfer import download
        from spark_rapids_tpu_torch.execs.cpu_execs import engine_batch
        for db in self.device_form().execute(ctx.on_session()):
            hb = download(db)
            yield engine_batch(hb) if ctx.host_engine else hb
