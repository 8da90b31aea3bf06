"""CSV scan on the device (the JAX package's ``io/csv.py``).

pyarrow's CSV reader parses each file on the host; ``TpuCsvScanExec``
uploads every parsed table with ``columnar/transfer.py::upload_arrow``
(numpy staging, chunked into pinned slabs on CUDA), the same way the
parquet scan does. The options are gated as strictly as the reference's
(GpuCSVScan.tagSupport): an option outside ``SUPPORTED_OPTIONS`` leaves the
scan on the CPU engine, where ``CpuCsvScanExec`` runs the same read on the
host. The scan registers its rule with plan/overrides.py when this module
is imported, as the parquet scan does.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import pyarrow as pa
import pyarrow.csv as pacsv

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.columnar.host import _arrow_type
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.io.datasource import (append_partition_columns,
                                                  assigned_files,
                                                  fill_file_meta)

SUPPORTED_OPTIONS = {"header", "sep", "delimiter", "nullValue"}


def _read_options(options: Dict[str, str]):
    header = options.get("header", "false").lower() in ("true", "1")
    sep = options.get("sep", options.get("delimiter", ","))
    read = pacsv.ReadOptions(autogenerate_column_names=not header)
    parse = pacsv.ParseOptions(delimiter=sep)
    # Spark's: ``nullValue`` (the empty field by default) is the only null
    # token, and a quoted empty string is an empty string (the JAX package
    # also takes "" and "null" as null, and a quoted "" too)
    convert = pacsv.ConvertOptions(
        null_values=[options.get("nullValue", "")], strings_can_be_null=True,
        quoted_strings_can_be_null=False)
    return read, parse, convert


def infer_csv_schema(path: str, options: Dict[str, str]) -> Schema:
    """Schema from the first parsed block only, not the whole file. A
    column with no value there is a STRING, as Spark infers it (pyarrow
    types it null, which no batch can hold)."""
    from spark_rapids_tpu_torch.io.parquet import schema_of_arrow
    read, parse, convert = _read_options(options)
    with pacsv.open_csv(path, read_options=read, parse_options=parse,
                        convert_options=convert) as reader:
        schema = reader.schema
    return schema_of_arrow(pa.schema(
        [pa.field(f.name, pa.string()) if pa.types.is_null(f.type) else f
         for f in schema]))


def _read_table(path: str, schema: Schema, options: Dict[str, str]
                ) -> pa.Table:
    read, parse, convert = _read_options(options)
    if read.autogenerate_column_names:
        # no header: the schema names the columns by position, as in
        # Spark (the JAX package casts f0, f1, ... to the schema's names
        # and fails)
        read = pacsv.ReadOptions(column_names=schema.names())
    convert = pacsv.ConvertOptions(
        null_values=convert.null_values, strings_can_be_null=True,
        quoted_strings_can_be_null=False, column_types={f.name: _arrow_type(f.dtype) for f in schema},
        include_columns=schema.names())
    t = pacsv.read_csv(path, read_options=read, parse_options=parse,
                       convert_options=convert)
    return t.cast(schema.to_pa())


class TpuCsvScanExec(LeafExec):
    """A CSV scan whose batches land on the context's device: each assigned
    file parsed on the host, its partition values and the hidden
    input-file columns appended, then uploaded."""

    is_device = True
    #: a file-list leaf: a source for the pipeline and the fold
    is_file_scan = True
    #: scan tasks splitting the file list (1: the whole scan in partition 0)
    scan_partitions = 1

    def __init__(self, files, schema: Schema, options: Dict[str, str],
                 partition_schema: Schema = Schema([])):
        from spark_rapids_tpu_torch.io.datasource import scan_data_schema
        super().__init__(schema)
        self.files = tuple(files)
        self.options = options
        self.partition_schema = partition_schema
        self.data_schema = scan_data_schema(schema, partition_schema)

    def size_estimate(self):
        from spark_rapids_tpu_torch.io.datasource import \
            file_scan_size_estimate
        return file_scan_size_estimate(self.files)

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(f.path for f in self.files)

    @property
    def num_partitions(self) -> int:
        return self.scan_partitions

    def file_row_counts(self):
        """CSV has no row-count metadata."""
        return None

    def iter_tables_for_files(self, files) -> Iterator[pa.Table]:
        for pf in files:
            t = _read_table(pf.path, self.data_schema, self.options)
            t = append_partition_columns(t, self.partition_schema,
                                         pf.partition_values)
            yield fill_file_meta(t, pf, self.output)

    def _iter_arrow(self, ctx: ExecContext) -> Iterator[pa.Table]:
        if ctx.partition_id >= self.scan_partitions:
            return
        yield from self.iter_tables_for_files(
            assigned_files(self.files, ctx.partition_id,
                           self.scan_partitions))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.columnar.transfer import \
            upload_arrow_conf
        for t in self._iter_arrow(ctx):
            yield upload_arrow_conf(t, ctx.device, ctx.conf)


class CpuCsvScanExec(CpuEngineExec):
    """The CPU engine's CSV scan: the device scan run on the host."""

    def __init__(self, files, schema: Schema, options: Dict[str, str],
                 partition_schema: Schema = Schema([])):
        self.files = tuple(files)
        self.options = options
        self.partition_schema = partition_schema
        self._schema = schema
        super().__init__(())

    def device_twin(self, children):
        return TpuCsvScanExec(self.files, self._schema, self.options,
                              self.partition_schema)


def _convert_csv(meta, children) -> TpuCsvScanExec:
    e = meta.exec
    return TpuCsvScanExec(e.files, e.output, e.options, e.partition_schema)


def _tag_csv(meta) -> None:
    from spark_rapids_tpu_torch import config as cfg
    if not (meta.conf.get(cfg.CSV_ENABLED)
            and meta.conf.get(cfg.CSV_READ_ENABLED)):
        meta.will_not_work("CSV scanning disabled "
                           "(spark.rapids.tpu.sql.format.csv.read.enabled)")
    for k in meta.exec.options:
        if k not in SUPPORTED_OPTIONS:
            meta.will_not_work(f"CSV option {k!r} is not supported on TPU")


def _register_rule() -> None:
    from spark_rapids_tpu_torch.plan.overrides import (ExecRule,
                                                       register_exec_rule)
    register_exec_rule(ExecRule(CpuCsvScanExec, "csv scan", _convert_csv,
                                tag=_tag_csv))


_register_rule()
