"""Parquet scan on the device (the JAX package's ``io/parquet.py``).

pyarrow reads the footers and clips row groups by their statistics
(``clip_row_groups``, one footer parse per file state and filter set,
``clipped_groups``), then reads each surviving row group into host arrow
memory; ``TpuParquetScanExec`` uploads each batch with
``columnar/transfer.py::upload_arrow``. Batches honour
``sql.reader.batchSizeRows`` and ``sql.reader.batchSizeBytes``; schema
evolution fills missing columns with nulls; hive partition values are
appended per batch; a legacy-calendar file's dates and timestamps are
rebased on the host.

With ``io.parquet.deviceDictDecode.enabled`` (the default) fixed-width
columns come straight off the page bytes in the file's own encoding
(io/parquet_pages.py, run side by side in worker processes by
io/page_pool.py): narrow indices and the small dictionary, or for an
RLE-dominant chunk its runs (``io.parquet.deviceRleExpand.enabled``),
cross the link and decode on the device. Strings ride pyarrow's
``read_dictionary``. A mixed-encoding chunk splits the row group where its
dictionary prefix ends; only the PLAIN tail decodes on the host. Every
dictionary of one scan is remapped into a per-column unified dictionary
(``DictionaryUnifier``) whose token lets the batches concatenate encoded.

With ``io.scan.prefetchBatches`` > 0 a producer thread reads, decodes and
uploads that many batches ahead of the consumer (the page decode is numpy;
the upload stages through the numpy staging pool), with the abortable put
and the drain and join on early exit of ``execs/pipeline.py``.

The planner plans ``CpuParquetScanExec``, the CPU engine's form (the
same read, run on the host); the plan layer converts it to the device scan
unless ``sql.format.parquet.read.enabled`` is off. The scan registers its
rule with plan/overrides.py when this module is imported, since the main
path imports no pyarrow. Only an in-memory scan goes through the scan
cache; a file scan reads its files every time.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.io.datasource import (ColumnStats,
                                                  PartitionedFile,
                                                  append_partition_columns,
                                                  assigned_files,
                                                  evolve_schema,
                                                  fill_file_meta,
                                                  stats_may_contain)


def schema_of_arrow(schema: pa.Schema) -> Schema:
    """The port's schema of an arrow schema (encoded types map to their
    value types)."""
    from spark_rapids_tpu_torch.columnar.host import _dtype_from_arrow
    return Schema([Field(f.name, _dtype_from_arrow(f.type), f.nullable)
                   for f in schema])


def _row_group_stats(md, rg_index: int) -> dict:
    """Column min/max/null stats for one row group from footer metadata."""
    rg = md.row_group(rg_index)
    out = {}
    for i in range(rg.num_columns):
        col = rg.column(i)
        name = col.path_in_schema
        st = col.statistics
        if st is None:
            out[name] = ColumnStats()
            continue
        out[name] = ColumnStats(
            min=st.min if st.has_min_max else None,
            max=st.max if st.has_min_max else None,
            null_count=st.null_count if st.has_null_count else None,
            num_values=rg.num_rows)
    return out


def clip_row_groups(pf: pq.ParquetFile,
                    filters: Sequence[Expression]) -> List[int]:
    """Row groups whose statistics say they may contain matching rows
    (clipBlocks analog)."""
    md = pf.metadata
    if not filters:
        return list(range(md.num_row_groups))
    kept = []
    for i in range(md.num_row_groups):
        stats = _row_group_stats(md, i)
        if all(stats_may_contain(f, stats) for f in filters):
            kept.append(i)
    return kept


@lru_cache(maxsize=512)
def _clipped_groups_cached(path: str, mtime_ns: int, size: int,
                           filters: Tuple[Expression, ...]):
    """One footer parse per (file state, filters): the pruned row-group
    list, its exact row count and the per-group row counts, so a file's
    metadata is not parsed again for every scan of it."""
    pf = pq.ParquetFile(path)
    groups = clip_row_groups(pf, filters)
    group_rows = tuple(pf.metadata.row_group(i).num_rows for i in groups)
    return tuple(groups), sum(group_rows), group_rows


def clipped_groups(path: str, filters: Tuple[Expression, ...]):
    st = os.stat(path)
    return _clipped_groups_cached(path, st.st_mtime_ns, st.st_size,
                                  tuple(filters))


def _iter_file_tables(f: PartitionedFile, data_schema: Schema,
                      partition_schema: Schema,
                      filters: Sequence[Expression],
                      max_rows: int, max_bytes: int,
                      device_dict: bool = False, device_rle: bool = False,
                      unifier=None,
                      groups: Optional[Sequence[int]] = None
                      ) -> Iterator[pa.Table]:
    pf = pq.ParquetFile(f.path)
    if groups is None:
        groups = list(clipped_groups(f.path, tuple(filters))[0])
    else:
        # caller-restricted read (a mesh shard's plan-time assignment):
        # the units are already statistics-clipped at plan time
        groups = list(groups)
    if not groups:
        return
    md = pf.metadata
    # rows-per-batch from the byte budget using the file's average row width
    # (populateCurrentBlockChunk's size accounting)
    total_rows = max(1, md.num_rows)
    total_bytes = sum(md.row_group(i).total_byte_size
                      for i in range(md.num_row_groups)) or total_rows
    rows_by_bytes = max(1, int(max_bytes * total_rows / total_bytes))
    batch_rows = min(max_rows, rows_by_bytes)
    file_cols = set(md.schema.names)
    want = [f2.name for f2 in data_schema if f2.name in file_cols]
    # legacy-calendar detection from the writer's file metadata
    # (RebaseHelper.scala:82, GpuParquetScan.scala:216): Spark < 3 /
    # LEGACY-mode files store hybrid-Julian day counts — rebase them
    from spark_rapids_tpu_torch.io.rebase import file_rebase_mode
    needs_rebase = file_rebase_mode(md.metadata) == "legacy"
    if device_dict and not needs_rebase:
        # fixed-width columns come straight off the PAGE BYTES as the
        # file's own encoding (io/parquet_pages.py): narrow indices + the
        # small dictionary — or, for RLE-dominant chunks, the run form
        # itself — cross the host link and decode with an on-device
        # gather/expansion, the GpuParquetScan.scala:576 device-decode
        # role. Mixed-encoding chunks keep their dictionary prefix encoded
        # and host-decode only the PLAIN tail; strings read through
        # pyarrow's still-encoded dictionary read.
        yield from _iter_dict_tables(pf, f, groups, want, data_schema,
                                     partition_schema, batch_rows,
                                     device_rle, unifier)
        return
    for rb in pf.iter_batches(batch_size=batch_rows, row_groups=groups,
                              columns=want):
        t = evolve_schema(pa.Table.from_batches([rb]), data_schema)
        if needs_rebase:
            t = _rebase_legacy_datetimes(t)
        yield append_partition_columns(t, partition_schema,
                                       f.partition_values)


def _iter_dict_tables(pf: pq.ParquetFile, f: PartitionedFile,
                      groups, want, data_schema: Schema,
                      partition_schema: Schema, batch_rows: int,
                      device_rle: bool = False,
                      unifier=None) -> Iterator[pa.Table]:
    """Per-row-group read keeping fixed-width columns encoded from the raw
    page bytes (dictionary indices, or the run form for RLE-dominant
    chunks); pyarrow reads the rest. Yields batch_rows-bounded slices
    (dictionary and run-end-encoded arrays slice zero-copy).

    Every dictionary column is remapped through the scan's
    DictionaryUnifier so all batches of one scan share a prefix-compatible
    dictionary identified by a token in the field metadata — that is what
    lets concat_device_batches carry the encoding across batches and the
    encoded-domain operators run on stable indices. Mixed-encoding chunks
    split the row group at the dictionary-prefix/PLAIN-tail boundary:
    prefix segments stay encoded, tail segments carry the host-decoded
    values."""
    from spark_rapids_tpu_torch.columnar.encoding import DictionaryUnifier
    from spark_rapids_tpu_torch.io.page_pool import read_dict_columns
    if unifier is None:
        unifier = DictionaryUnifier()
    md = pf.metadata
    names = list(md.schema.names)
    arrow_schema = pf.schema_arrow
    # strings ride pyarrow's own still-encoded read (read_dictionary is
    # BYTE_ARRAY-only); the upload gathers their byte-matrix rows on device
    str_cols = [f2.name for f2 in data_schema
                if f2.dtype is DType.STRING and f2.name in names]
    pf_str = (pq.ParquetFile(f.path, read_dictionary=str_cols)
              if str_cols else pf)
    # the fixed-width chunks go through the page reader in the decode
    # processes, taken in order (io/page_pool.py)
    fixed = [(f2.name, names.index(f2.name),
              arrow_schema.field(f2.name).type) for f2 in data_schema
             if f2.dtype is not DType.STRING and f2.name in names]
    reads = read_dict_columns(f.path, md, [(rg, ci, at) for rg in groups
                                           for _, ci, at in fixed],
                              device_rle)
    try:
        yield from _dict_tables(pf_str, f, groups, want, data_schema,
                                partition_schema, batch_rows, unifier,
                                md, fixed, reads)
    finally:
        reads.close()


def _dict_tables(pf_str, f, groups, want, data_schema, partition_schema,
                 batch_rows, unifier, md, fixed, reads):
    """``_iter_dict_tables``'s loop over the row groups, the fixed-width
    chunks taken from ``reads`` in order."""
    from spark_rapids_tpu_torch.columnar.encoding import with_dict_tokens
    for rg in groups:
        encoded = {}
        for name, _, _ in fixed:
            r = next(reads)
            if r is not None:
                encoded[name] = r
        rest = [n for n in want if n not in encoded]
        plain = (pf_str.read_row_group(rg, columns=rest) if rest else None)
        nrows = md.row_group(rg).num_rows
        cols = {}       # name -> (prefix_or_whole, tail_or_None, split_row)
        tokens = {}
        for n in want:
            if n in encoded:
                r = encoded[n]
                prefix = r.prefix
                # a chunk whose values are all null has an empty dictionary:
                # nothing to unify (the JAX package fails here), the upload
                # decodes it on the host
                if isinstance(prefix, pa.DictionaryArray) and \
                        len(prefix.dictionary):
                    prefix, tokens[n] = unifier.unify(n, prefix)
                cols[n] = (prefix, r.tail, len(prefix))
            else:
                c = plain.column(n)
                if isinstance(c, pa.ChunkedArray):
                    # combine_chunks on a ChunkedArray yields an Array
                    # (also for the 0-chunk empty-file case)
                    c = (c.chunk(0) if c.num_chunks == 1
                         else c.combine_chunks())
                if isinstance(c, pa.DictionaryArray) and len(c.dictionary):
                    c, tokens[n] = unifier.unify(n, c)
                cols[n] = (c, None, nrows)
        # segment boundaries: a mixed-encoding column splits the row group
        # where its dictionary prefix ends (only the tail is decoded)
        bounds = sorted({0, nrows} | {sr for _, tail, sr in cols.values()
                                      if tail is not None})
        for s, e in zip(bounds, bounds[1:]):
            seg_cols, fields = [], []
            for n in want:
                prefix, tail, split = cols[n]
                a = (prefix.slice(s, e - s) if e <= split
                     else tail.slice(s - split, e - s))
                seg_cols.append(a)
                fields.append(pa.field(n, a.type))
            table = pa.table(seg_cols, schema=pa.schema(fields))
            table = with_dict_tokens(table, tokens)
            for start in range(0, e - s, batch_rows):
                t = table.slice(start, min(batch_rows, e - s - start))
                t = evolve_schema(t, data_schema)
                yield append_partition_columns(t, partition_schema,
                                               f.partition_values)


def _rebase_legacy_datetimes(t: pa.Table) -> pa.Table:
    """Julian->Gregorian correction for every date/timestamp column of a
    legacy-calendar file's batch (host-side, before any upload)."""
    import numpy as np

    from spark_rapids_tpu_torch.io.rebase import (julian_to_gregorian_days,
                                            julian_to_gregorian_micros)
    for i, field in enumerate(t.schema):
        typ = field.type
        if pa.types.is_date32(typ):
            rebase, vt, width = julian_to_gregorian_days, pa.int32(), np.int32
            col = t.column(i).combine_chunks()
        elif pa.types.is_timestamp(typ):
            rebase, vt, width = julian_to_gregorian_micros, pa.int64(), \
                np.int64
            # normalize to micros (Spark's storage unit) before the math
            col = t.column(i).combine_chunks().cast(
                pa.timestamp("us", typ.tz))
        else:
            continue
        raw = col.cast(vt)
        # fill nulls BEFORE to_numpy: a nullable int column converts to
        # float64 otherwise, silently rounding |micros| > 2^53 (any
        # pre-1582 timestamp) before the rebase ever runs
        ints = raw.fill_null(0).to_numpy(zero_copy_only=False)
        fixed = rebase(ints).astype(width)
        new = pa.Array.from_pandas(fixed, mask=np.asarray(col.is_null()),
                                   type=vt).cast(col.type).cast(typ)
        t = t.set_column(i, field, new)
    return t


class TpuParquetScanExec(LeafExec):
    """A parquet scan whose batches land on the context's device: the
    statistics-clipped row groups of the assigned files, read on the host
    (serially, or ahead of the consumer on a producer thread), uploaded
    with the encoded upload. ``output`` is the full read schema, partition
    columns and the hidden input-file columns included."""

    is_device = True
    #: a file-list leaf: a source for the pipeline, the fold and the
    #: encoded-domain pass
    is_file_scan = True
    #: scan tasks splitting the file list (1: the whole scan in partition 0)
    scan_partitions = 1

    def __init__(self, files: Tuple[PartitionedFile, ...], schema: Schema,
                 partition_schema: Schema = Schema([]),
                 filters: Tuple[Expression, ...] = (),
                 max_batch_rows: int = 1 << 20,
                 max_batch_bytes: int = 1 << 31):
        from spark_rapids_tpu_torch.io.datasource import scan_data_schema
        super().__init__(schema)
        self.files = files
        self.partition_schema = partition_schema
        self.data_schema = scan_data_schema(schema, partition_schema)
        self.filters = filters
        self.max_batch_rows = max_batch_rows
        self.max_batch_bytes = max_batch_bytes
        #: set from the conf when the scan runs
        self.device_dict = False
        self.device_rle = False
        #: batches and rows uploaded by the last execution
        self.batches_read = 0
        self.rows_read = 0

    def size_estimate(self):
        from spark_rapids_tpu_torch.io.datasource import \
            file_scan_size_estimate
        return file_scan_size_estimate(self.files)

    @property
    def num_partitions(self) -> int:
        return self.scan_partitions

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(f.path for f in self.files)

    def file_row_counts(self) -> List[int]:
        """Exact per-file row counts after the row-group pruning, from the
        footers alone: the mesh's shard-local read sizes its shards by
        them."""
        return [clipped_groups(f.path, tuple(self.filters))[1]
                for f in self.files]

    def row_group_units(self) -> List[Tuple[int, int, int]]:
        """(file index, row group, exact rows) of every statistics-clipped
        row group, from the footers alone: the units the mesh rewrite
        balances over the shards at plan time."""
        units: List[Tuple[int, int, int]] = []
        for fi, f in enumerate(self.files):
            groups, _, group_rows = clipped_groups(f.path,
                                                   tuple(self.filters))
            units.extend((fi, rg, rows)
                         for rg, rows in zip(groups, group_rows))
        return units

    def iter_tables_for_units(self, units: Sequence[Tuple[int, int]]
                              ) -> Iterator[pa.Table]:
        """Only the given (file index, row group) units, one shard's part
        of the plan-time assignment, in file order and group order."""
        by_file: dict = {}
        for fi, rg in units:
            by_file.setdefault(fi, []).append(rg)
        for fi in sorted(by_file):
            f = self.files[fi]
            for t in _iter_file_tables(
                    f, self.data_schema, self.partition_schema, self.filters,
                    self.max_batch_rows, self.max_batch_bytes,
                    groups=sorted(by_file[fi])):
                yield fill_file_meta(t, f, self.output)

    def iter_tables_for_files(self, files: Sequence[PartitionedFile]
                              ) -> Iterator[pa.Table]:
        # one dictionary unifier per scan pass: every row group's
        # dictionaries remap into one prefix-compatible dictionary per
        # column, so batch concatenation keeps the encoded form
        unifier = None
        if self.device_dict:
            from spark_rapids_tpu_torch.columnar.encoding import \
                DictionaryUnifier
            unifier = DictionaryUnifier()
        for f in files:
            for t in _iter_file_tables(
                    f, self.data_schema, self.partition_schema, self.filters,
                    self.max_batch_rows, self.max_batch_bytes,
                    device_dict=self.device_dict,
                    device_rle=self.device_rle, unifier=unifier):
                yield fill_file_meta(t, f, self.output)

    def _iter_arrow(self, ctx: ExecContext) -> Iterator[pa.Table]:
        if ctx.partition_id >= self.scan_partitions:
            return
        yield from self.iter_tables_for_files(
            assigned_files(self.files, ctx.partition_id,
                           self.scan_partitions))

    def _upload(self, t: pa.Table, ctx: ExecContext) -> DeviceBatch:
        from spark_rapids_tpu_torch.columnar.transfer import \
            upload_arrow_conf
        return upload_arrow_conf(t, ctx.device, ctx.conf)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch import config as cfg
        self.device_dict = ctx.conf.get(cfg.PARQUET_DEVICE_DICT)
        self.device_rle = (self.device_dict
                           and ctx.conf.get(cfg.PARQUET_DEVICE_RLE))
        self.batches_read = self.rows_read = 0
        depth = ctx.conf.get(cfg.SCAN_PREFETCH_BATCHES)
        if (os.cpu_count() or 1) < 2:
            depth = 0       # decode-ahead needs a spare core
        source = (self._prefetched(ctx, depth) if depth > 0 else
                  (self._upload(t, ctx) for t in self._iter_arrow(ctx)))
        for b in source:
            self.batches_read += 1
            self.rows_read += b.num_rows
            yield b

    def _prefetched(self, ctx: ExecContext,
                    depth: int) -> Iterator[DeviceBatch]:
        """Up to ``depth`` batches read, decoded and uploaded ahead on a
        producer thread, which makes the context's device current and joins
        the consuming task's device-admission hold, as a PipelinedExec's
        producer does."""
        import queue
        import threading
        from contextlib import ExitStack

        import torch

        from spark_rapids_tpu_torch.execs.pipeline import (_POLL_S,
                                                           _get_live,
                                                           _put_abortable)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        dm = ctx.device_manager

        def produce() -> None:
            try:
                with ExitStack() as scope:
                    if ctx.device.type == "cuda":
                        scope.enter_context(torch.cuda.device(ctx.device))
                    if dm is not None:
                        scope.enter_context(
                            dm.semaphore.held(task_id=ctx.task_id))
                    for t in self._iter_arrow(ctx):
                        if not _put_abortable(q, ("b", self._upload(t, ctx)),
                                              stop):
                            return  # the consumer left early
            except BaseException as e:  # noqa: BLE001 - re-raised below
                _put_abortable(q, ("e", e), stop)
                return
            _put_abortable(q, ("end", None), stop)

        worker = threading.Thread(target=produce, daemon=True,
                                  name="parquet-scan-prefetch")
        worker.start()
        try:
            while True:
                kind, val = _get_live(q, worker)
                if kind == "end":
                    return
                if kind == "e":
                    raise val
                yield val
        finally:
            # early exit (a limit closing the generator), a consumer error
            # or the end: unblock a producer on a full queue and reap it
            stop.set()
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(_POLL_S)


class CpuParquetScanExec(CpuEngineExec):
    """The CPU engine's parquet scan: the device scan run on the host."""

    def __init__(self, files: Tuple[PartitionedFile, ...], schema: Schema,
                 partition_schema: Schema = Schema([]),
                 filters: Tuple[Expression, ...] = (),
                 max_batch_rows: int = 1 << 20,
                 max_batch_bytes: int = 1 << 31):
        self.files = files
        self.partition_schema = partition_schema
        self.filters = filters
        self.max_batch_rows = max_batch_rows
        self.max_batch_bytes = max_batch_bytes
        self._schema = schema
        super().__init__(())

    def device_twin(self, children):
        return TpuParquetScanExec(self.files, self._schema,
                                  self.partition_schema, self.filters,
                                  self.max_batch_rows, self.max_batch_bytes)


def write_parquet(table: pa.Table, path: str,
                  compression: str = "snappy") -> None:
    """One parquet file of an arrow table (``DataFrame.write_parquet``;
    the GpuParquetWriter analog)."""
    pq.write_table(table, path, compression=compression)


def _convert_parquet(meta, children) -> TpuParquetScanExec:
    e = meta.exec
    return TpuParquetScanExec(e.files, e.output, e.partition_schema,
                              e.filters, e.max_batch_rows, e.max_batch_bytes)


def _tag_parquet(meta) -> None:
    from spark_rapids_tpu_torch import config as cfg
    if not (meta.conf.get(cfg.PARQUET_ENABLED)
            and meta.conf.get(cfg.PARQUET_READ_ENABLED)):
        meta.will_not_work("parquet scanning disabled "
                           "(spark.rapids.tpu.sql.format.parquet.read.enabled)")


def _register_rule() -> None:
    from spark_rapids_tpu_torch.plan.overrides import (ExecRule,
                                                       register_exec_rule)
    register_exec_rule(ExecRule(CpuParquetScanExec, "parquet scan",
                                _convert_parquet, tag=_tag_parquet))


_register_rule()
