"""The file-write command (the JAX package's ``io/write_exec.py``).

Reference analog: GpuDataWritingCommandExec wrapping
GpuFileFormatWriter.write: the command drains its child per task, writes
part files through the commit protocol (io/writer.py, a byte-equal copy of
the reference's) and the job commits after the last task. pyarrow is the
encoder, so ``TpuWriteFilesExec`` downloads each device batch in arrow's
layout, made on the device (``columnar/transfer.py::download_arrow``:
bitmaps packed and strings compacted there, the buffers copied pinned and
asynchronously on CUDA), and hands the table to the task's writer; a
column that arrived encoded downloads its decoded values. ``CpuWriteFilesExec`` is the CPU
engine's form, which the plan layer keeps for the CSV write (the
reference has no accelerated CSV writer) and for a codec the device
writer does not take. The command registers its rule with
plan/overrides.py when this module is imported.

The files are those of the JAX writers, row for row, but they are encoded
side by side: each format's ``OutputWriter`` in ``WRITER_CLASSES`` is
wrapped (``_LaneWriter``) so that, inside a write job, every part file's
writes and close run in order on one of the job's host threads
(``_Lanes``, one per CPU; pyarrow's encoders release the GIL), while the
task goes on downloading and splitting. At most two tables a thread wait
for their encoder, so a task that outruns the encoders waits for them.
The job waits for every file before it commits, and removes its staging
directory if any write failed. Outside a job the wrapped writers write
in the caller's thread, as the reference's do.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.io.writer import (WRITER_CLASSES,
                                              DynamicPartitionDataWriter,
                                              FileCommitProtocol,
                                              OutputWriter,
                                              SingleDirectoryDataWriter,
                                              WriteStats, resolve_save_mode)


@dataclass(frozen=True)
class WriteSpec:
    fmt: str                       # parquet | orc | csv
    path: str
    mode: str = "error"            # error | overwrite | append | ignore
    partition_by: Tuple[str, ...] = ()
    options: Tuple[Tuple[str, str], ...] = ()
    max_records_per_file: int = 0

    @property
    def options_dict(self) -> Dict[str, str]:
        return dict(self.options)


class _Lanes:
    """A job's host threads, each writing the files given to it in the
    order their writes came; a file's writes all go to one thread. A
    write waits while ``2 * n`` tables wait for their thread."""

    def __init__(self, n: int):
        n = max(1, n)
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix="file-write")
                       for _ in range(n)]
        self._room = threading.BoundedSemaphore(2 * n)
        self._next = 0
        self._futures: List = []

    def lane(self) -> ThreadPoolExecutor:
        pool = self._pools[self._next % len(self._pools)]
        self._next += 1
        return pool

    def submit(self, pool: ThreadPoolExecutor, fn, *args) -> None:
        self._room.acquire()
        try:
            future = pool.submit(fn, *args)
        except BaseException:
            self._room.release()
            raise
        future.add_done_callback(lambda _: self._room.release())
        self._futures.append(future)

    def finish(self) -> None:
        """Wait for every write; raise the first that failed."""
        futures, self._futures = self._futures, []
        errors = [f.exception() for f in futures]
        for pool in self._pools:
            pool.shutdown(wait=True)
        for e in errors:
            if e is not None:
                raise e


#: host threads a write job encodes its part files on (0: each file is
#: encoded in the task's thread, as the reference does)
ENCODE_THREADS = os.cpu_count() or 1

#: the lanes of the write job running in this context (None: no job)
_JOB_LANES: ContextVar[Optional[_Lanes]] = ContextVar("file_write_lanes",
                                                      default=None)


class _LaneWriter(OutputWriter):
    """A format's writer (``inner``) whose writes and close run on one
    lane of the job in the context, in order; outside a job they run in
    the caller's thread. The row count moves at once, as the rollover to
    the next file reads it."""

    inner: type = OutputWriter

    def __init__(self, path: str, schema: Schema, options: Dict[str, str]):
        super().__init__(path, schema, options)
        self._file = self.inner(path, schema, options)
        self._lanes = _JOB_LANES.get()
        self._pool = None if self._lanes is None else self._lanes.lane()

    def _run(self, fn, *args) -> None:
        if self._lanes is None:
            fn(*args)
        else:
            self._lanes.submit(self._pool, fn, *args)

    def write(self, table) -> None:
        self.rows_written += table.num_rows
        self._run(self._file.write, table)

    def close(self) -> None:
        self._run(self._file.close)


for _fmt, _cls in list(WRITER_CLASSES.items()):
    if not issubclass(_cls, _LaneWriter):
        WRITER_CLASSES[_fmt] = type(_cls.__name__, (_LaneWriter,), {
            "inner": _cls, "SUPPORTED_CODECS": _cls.SUPPORTED_CODECS})


class _EscapedPartitionWriter(DynamicPartitionDataWriter):
    """The partition writer of io/writer.py (a byte-equal copy of the
    reference's, which names a directory by ``str(value)``) with each
    string partition value escaped first, as Spark names its directories
    (``io/datasource.py::escape_path_name``): the data files drop the
    partition columns, so only the directory names change."""

    def write(self, table) -> None:
        import pyarrow as pa
        import pyarrow.compute as pc
        from spark_rapids_tpu_torch.io.datasource import escape_path_name
        for name in self.partition_cols:
            i = table.schema.get_field_index(name)
            col = table.column(i)
            if not pa.types.is_string(col.type) or table.num_rows == 0:
                continue
            values = pc.unique(col).drop_null()
            escaped = pa.array([escape_path_name(v)
                                for v in values.to_pylist()], pa.string())
            table = table.set_column(i, name, escaped.take(
                pc.index_in(col, value_set=values)))
        super().write(table)


def make_task_writer(spec: WriteSpec, child_schema: Schema,
                     committer: FileCommitProtocol, task_id: int):
    """One writer per task: single-directory, or split into hive-style
    ``k=v/`` directories by the partition columns."""
    if spec.partition_by:
        return _EscapedPartitionWriter(
            spec.fmt, child_schema, spec.partition_by, committer, task_id,
            spec.options_dict, spec.max_records_per_file)
    return SingleDirectoryDataWriter(
        spec.fmt, child_schema, committer, task_id, spec.options_dict,
        spec.max_records_per_file)


def total_output_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs
               if not f.startswith("_"))


class TpuWriteFilesExec(PhysicalExec):
    """The write command over device batches: produces no rows;
    ``stats`` holds the job's ``WriteStats`` once the last task
    committed."""

    def size_estimate(self):
        return 0          # a write command produces no rows

    def __init__(self, spec: WriteSpec, child: PhysicalExec):
        super().__init__((child,), Schema([]))
        self.spec = spec
        self.stats = WriteStats()
        self._committer: Optional[FileCommitProtocol] = None
        self._lanes: Optional[_Lanes] = None
        self._skipped = False

    def _batch_table(self, batch):
        from spark_rapids_tpu_torch.columnar.transfer import download_arrow
        return download_arrow(batch)

    def execute(self, ctx: ExecContext) -> Iterator:
        t0 = time.perf_counter()
        if ctx.partition_id == 0:
            self.stats = WriteStats()
            self._skipped = resolve_save_mode(
                self.spec.path, self.spec.mode) is None
            if not self._skipped:
                self._committer = FileCommitProtocol(self.spec.path)
                self._committer.setup_job()
                self._lanes = (_Lanes(ENCODE_THREADS) if ENCODE_THREADS
                               else None)
        if self._skipped:
            return
        writer = make_task_writer(self.spec, self.children[0].output,
                                  self._committer, ctx.partition_id)
        lanes = _JOB_LANES.set(self._lanes)
        try:
            for batch in self.children[0].execute(ctx):
                writer.write(self._batch_table(batch))
            writer.close()
            if ctx.partition_id == ctx.num_partitions - 1 \
                    and self._lanes is not None:
                self._lanes.finish()
        except BaseException:
            try:
                if self._lanes is not None:
                    self._lanes.finish()
            except BaseException:  # noqa: BLE001 - the first error is raised
                pass
            self._committer.abort_job()
            raise
        finally:
            _JOB_LANES.reset(lanes)
        self.stats.num_files += writer.files_written
        self.stats.num_rows += writer.rows_written
        if isinstance(writer, DynamicPartitionDataWriter):
            self.stats.num_partitions += len(writer.partitions_seen)
        if ctx.partition_id == ctx.num_partitions - 1:
            self._committer.commit_job()
            self.stats.num_bytes = total_output_bytes(self.spec.path)
        self.stats.write_time_s += time.perf_counter() - t0
        return
        yield  # pragma: no cover - makes this a generator


class CpuWriteFilesExec(CpuEngineExec):
    """The CPU engine's write command: the device command run on the host
    (its child's batches are CPU tensors there)."""

    def __init__(self, spec: WriteSpec, child: PhysicalExec):
        self.spec = spec
        super().__init__((child,))

    def device_twin(self, children):
        return TpuWriteFilesExec(self.spec, children[0])

    @property
    def stats(self) -> WriteStats:
        return self.device_form().stats


def _convert_write(meta, children) -> TpuWriteFilesExec:
    return TpuWriteFilesExec(meta.exec.spec, children[0])


def _tag_write(meta) -> None:
    """GpuParquetFileFormat.tagGpuSupport / GpuOrcFileFormat analog: the
    per-format write conf and the supported compression codecs. CSV has no
    accelerated writer in the reference, so it always stays on the CPU
    engine."""
    from spark_rapids_tpu_torch import config as cfg
    spec = meta.exec.spec
    if spec.fmt == "csv":
        meta.will_not_work("CSV writing does not run on TPU (no accelerated "
                           "CSV writer in the reference either)")
        return
    enabled = {"parquet": (cfg.PARQUET_ENABLED, cfg.PARQUET_WRITE_ENABLED),
               "orc": (cfg.ORC_ENABLED, cfg.ORC_WRITE_ENABLED)}[spec.fmt]
    if not all(meta.conf.get(k) for k in enabled):
        meta.will_not_work(
            f"{spec.fmt} writing disabled "
            f"(spark.rapids.tpu.sql.format.{spec.fmt}.write.enabled)")
    codec = spec.options_dict.get("compression", "snappy").lower()
    if codec not in WRITER_CLASSES[spec.fmt].SUPPORTED_CODECS:
        meta.will_not_work(f"compression codec {codec!r} is not supported "
                           f"for {spec.fmt} on TPU")


def _register_rule() -> None:
    from spark_rapids_tpu_torch.plan.overrides import (ExecRule,
                                                       register_exec_rule)
    register_exec_rule(ExecRule(CpuWriteFilesExec, "file write command",
                                _convert_write, tag=_tag_write))


_register_rule()
