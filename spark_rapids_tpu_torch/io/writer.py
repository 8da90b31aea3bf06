"""Columnar file-writing framework.

Reference analogs:
- ColumnarOutputWriter.scala:62 (writeBatch:143) — ``OutputWriter`` subclasses
  stream batches into one open file per writer.
- GpuFileFormatWriter.scala:338 — job orchestration over Spark's
  FileCommitProtocol: tasks write into a staging directory, the driver commits
  renames into the final location; here ``FileCommitProtocol`` +
  ``run_write_job``.
- GpuFileFormatDataWriter.scala:417 — ``SingleDirectoryDataWriter`` and
  ``DynamicPartitionDataWriter`` (hive-style ``k=v`` output dirs, partition
  columns dropped from file data, maxRecordsPerFile rollover).
- BasicColumnarWriteStatsTracker.scala:168 — ``WriteStats``.
- GpuInsertIntoHadoopFsRelationCommand.scala — save-mode handling in
  ``run_write_job`` (overwrite/append/error/ignore).
"""
from __future__ import annotations

import datetime
import os
import shutil
import uuid
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.io.datasource import HIVE_DEFAULT_PARTITION


@dataclass
class WriteStats:
    """Job-level write statistics (BasicColumnarWriteStatsTracker analog)."""
    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    num_partitions: int = 0
    write_time_s: float = 0.0


# ------------------------------------------------------------------ writers
class OutputWriter:
    """One open output file accepting a stream of batches
    (ColumnarOutputWriter analog)."""

    def __init__(self, path: str, schema: Schema, options: Dict[str, str]):
        self.path = path
        self.schema = schema
        self.options = options
        self.rows_written = 0

    def write(self, table: pa.Table) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class ParquetOutputWriter(OutputWriter):
    """Chunked parquet writes (GpuParquetWriter / Table.writeParquetChunked
    analog, GpuParquetFileFormat.scala:212,243)."""

    SUPPORTED_CODECS = ("snappy", "none", "uncompressed", "zstd", "gzip")

    def __init__(self, path: str, schema: Schema, options: Dict[str, str]):
        super().__init__(path, schema, options)
        import pyarrow.parquet as pq
        codec = options.get("compression", "snappy").lower()
        if codec == "uncompressed":
            codec = "none"
        self._writer = pq.ParquetWriter(path, schema.to_pa(), compression=codec)

    def write(self, table: pa.Table) -> None:
        self._writer.write_table(table)
        self.rows_written += table.num_rows

    def close(self) -> None:
        self._writer.close()


class OrcOutputWriter(OutputWriter):
    """ORC writes (GpuOrcFileFormat analog, 164 LoC)."""

    SUPPORTED_CODECS = ("snappy", "none", "uncompressed", "zlib", "zstd")

    def __init__(self, path: str, schema: Schema, options: Dict[str, str]):
        super().__init__(path, schema, options)
        from pyarrow import orc
        codec = options.get("compression", "snappy").lower()
        codec = {"none": "uncompressed", "zlib": "zlib"}.get(codec, codec)
        self._writer = orc.ORCWriter(path, compression=codec)

    def write(self, table: pa.Table) -> None:
        self._writer.write(table.cast(self.schema.to_pa()))
        self.rows_written += table.num_rows

    def close(self) -> None:
        self._writer.close()


class CsvOutputWriter(OutputWriter):
    """CSV writes. The reference has no GPU CSV writer — this runs on the CPU
    engine only (the write exec falls back, mirroring that gap)."""

    SUPPORTED_CODECS = ("none",)

    def __init__(self, path: str, schema: Schema, options: Dict[str, str]):
        super().__init__(path, schema, options)
        import pyarrow.csv as pacsv
        header = options.get("header", "false").lower() in ("true", "1")
        sep = options.get("sep", options.get("delimiter", ","))
        self._writer = pacsv.CSVWriter(
            path, schema.to_pa(),
            write_options=pacsv.WriteOptions(include_header=header,
                                             delimiter=sep))

    def write(self, table: pa.Table) -> None:
        self._writer.write_table(table)
        self.rows_written += table.num_rows

    def close(self) -> None:
        self._writer.close()


WRITER_CLASSES = {"parquet": ParquetOutputWriter, "orc": OrcOutputWriter,
                  "csv": CsvOutputWriter}
_EXTENSIONS = {"parquet": ".parquet", "orc": ".orc", "csv": ".csv"}


# ------------------------------------------------------------------ commit
class FileCommitProtocol:
    """Staging-directory commit protocol (the role Spark's FileCommitProtocol
    plays for GpuFileFormatWriter.scala:338): tasks write under
    ``_temporary/<job>/``, job commit moves everything into the final
    directory atomically-enough and drops a ``_SUCCESS`` marker."""

    def __init__(self, output_path: str):
        self.output_path = output_path
        self.job_id = uuid.uuid4().hex[:12]
        self.staging = os.path.join(output_path, "_temporary", self.job_id)

    def setup_job(self) -> None:
        os.makedirs(self.staging, exist_ok=True)

    def new_task_file(self, task_id: int, file_seq: int,
                      partition_dir: str, ext: str) -> str:
        """Returns the staging path for one task output file; its final name
        follows Spark's part-file convention."""
        name = f"part-{task_id:05d}-{self.job_id}-{file_seq:04d}{ext}"
        d = os.path.join(self.staging, partition_dir)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def commit_job(self) -> None:
        for dirpath, _, filenames in os.walk(self.staging):
            rel = os.path.relpath(dirpath, self.staging)
            dest_dir = (self.output_path if rel == "."
                        else os.path.join(self.output_path, rel))
            os.makedirs(dest_dir, exist_ok=True)
            for fn in filenames:
                os.replace(os.path.join(dirpath, fn),
                           os.path.join(dest_dir, fn))
        shutil.rmtree(os.path.join(self.output_path, "_temporary"),
                      ignore_errors=True)
        with open(os.path.join(self.output_path, "_SUCCESS"), "w"):
            pass

    def abort_job(self) -> None:
        shutil.rmtree(os.path.join(self.output_path, "_temporary"),
                      ignore_errors=True)


# ------------------------------------------------------------------ task writers
def _partition_dir_value(v) -> str:
    if v is None:
        return HIVE_DEFAULT_PARTITION
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, datetime.date):
        return v.isoformat()
    return str(v)


class SingleDirectoryDataWriter:
    """All of one task's rows go to part files in the root output directory
    (GpuFileFormatDataWriter.scala SingleDirectoryDataWriter analog)."""

    def __init__(self, fmt: str, schema: Schema, committer: FileCommitProtocol,
                 task_id: int, options: Dict[str, str],
                 max_records_per_file: int = 0, partition_dir: str = ""):
        self.fmt = fmt
        self.schema = schema
        self.committer = committer
        self.task_id = task_id
        self.options = options
        self.max_records = max_records_per_file
        self.partition_dir = partition_dir
        self._writer: Optional[OutputWriter] = None
        self._file_seq = 0
        self.files_written = 0
        self.rows_written = 0

    def _open(self) -> OutputWriter:
        path = self.committer.new_task_file(
            self.task_id, self._file_seq, self.partition_dir,
            _EXTENSIONS[self.fmt])
        self._file_seq += 1
        self.files_written += 1
        return WRITER_CLASSES[self.fmt](path, self.schema, self.options)

    def write(self, table: pa.Table) -> None:
        while table.num_rows > 0:
            if self._writer is None:
                self._writer = self._open()
            if self.max_records > 0:
                room = self.max_records - self._writer.rows_written
                if room <= 0:
                    self._writer.close()
                    self._writer = None
                    continue
                chunk, table = table.slice(0, room), table.slice(room)
            else:
                chunk, table = table, table.slice(table.num_rows)
            self._writer.write(chunk)
            self.rows_written += chunk.num_rows

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class DynamicPartitionDataWriter:
    """Splits every batch by its partition-column values and streams each
    group to a hive-style ``k=v/`` directory, dropping the partition columns
    from the file data (DynamicPartitionDataWriter analog)."""

    def __init__(self, fmt: str, schema: Schema, partition_cols: Sequence[str],
                 committer: FileCommitProtocol, task_id: int,
                 options: Dict[str, str], max_records_per_file: int = 0):
        self.fmt = fmt
        self.partition_cols = list(partition_cols)
        data_fields = [f for f in schema if f.name not in self.partition_cols]
        self.data_schema = Schema(data_fields)
        self.committer = committer
        self.task_id = task_id
        self.options = options
        self.max_records = max_records_per_file
        self._writers: Dict[str, SingleDirectoryDataWriter] = {}
        self.files_written = 0
        self.rows_written = 0
        self.partitions_seen: set = set()

    def _writer_for(self, part_dir: str) -> "SingleDirectoryDataWriter":
        w = self._writers.get(part_dir)
        if w is None:
            w = SingleDirectoryDataWriter(
                self.fmt, self.data_schema, self.committer, self.task_id,
                self.options, self.max_records, partition_dir=part_dir)
            self._writers[part_dir] = w
            self.partitions_seen.add(part_dir)
        return w

    def write(self, table: pa.Table) -> None:
        if table.num_rows == 0:
            return
        # native group-by over the partition columns; only per-GROUP work
        # happens in Python (the reference's cudf Table.groupBy split plays
        # the same role)
        keyed = table.append_column(
            "__row__", pa.array(range(table.num_rows), type=pa.int64()))
        groups = (keyed.select(self.partition_cols + ["__row__"])
                  .group_by(self.partition_cols, use_threads=False)
                  .aggregate([("__row__", "list")]))
        data = table.drop_columns(self.partition_cols)
        for g in range(groups.num_rows):
            values = [groups.column(c)[g].as_py()
                      for c in self.partition_cols]
            d = os.path.join(*(f"{c}={_partition_dir_value(v)}"
                               for c, v in zip(self.partition_cols, values)))
            idx = groups.column("__row___list")[g].values
            self._writer_for(d).write(data.take(idx))

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        self.files_written = sum(w.files_written for w in self._writers.values())
        self.rows_written = sum(w.rows_written for w in self._writers.values())


def resolve_save_mode(path: str, mode: str) -> Optional[str]:
    """Save-mode handling (GpuInsertIntoHadoopFsRelationCommand analog).
    Returns None when the write should be skipped (ignore mode)."""
    if os.path.isdir(path):
        exists = bool(os.listdir(path))
    else:
        exists = os.path.exists(path)
    if exists:
        if mode in ("error", "errorifexists"):
            raise FileExistsError(
                f"path {path} already exists (SaveMode.ErrorIfExists)")
        if mode == "ignore":
            return None
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
    os.makedirs(path, exist_ok=True)
    return path
