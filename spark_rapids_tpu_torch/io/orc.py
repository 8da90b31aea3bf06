"""ORC scan on the device with stripe pruning and chunking (the JAX
package's ``io/orc.py``).

The footer and the per-stripe statistics are parsed on the host
(io/orc_meta.py, a byte-equal copy of the reference's: pyarrow exposes no
stripe statistics), one parse per file state (``_orc_meta``). A stripe
whose statistics rule out a pushed filter is not read (``clip_stripes``,
the OrcFilters SARG clipping analog, with the predicate evaluator the
parquet scan uses); the survivors are read by pyarrow and chunked to the
reader's row and byte budgets (``sql.reader.batchSizeRows``/``Bytes``:
small stripes coalesce into one batch, a large one goes alone), then
``TpuOrcScanExec`` uploads each batch with
``columnar/transfer.py::upload_arrow``. Files are read side by side on
host threads, up to one per CPU ahead of the upload (pyarrow's stripe
reader releases the GIL), each reader at most ``_AHEAD`` batches ahead,
and their batches come in file order.
``CpuOrcScanExec`` is the CPU engine's form. The scan registers its rule
with plan/overrides.py when this module is imported.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from functools import lru_cache
from itertools import islice
from typing import Generator, Iterator, List, Sequence, Tuple

import pyarrow as pa
import pyarrow.orc as po

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.execs.pipeline import (_LIVENESS_S,
                                                   _put_abortable)
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.io.datasource import (PartitionedFile,
                                                  append_partition_columns,
                                                  assigned_files,
                                                  evolve_schema,
                                                  fill_file_meta,
                                                  stats_may_contain)

#: batches each file's reader may hold ready ahead of the upload
_AHEAD = 2


def _orc_meta(path: str):
    """The file's parsed metadata, cached by file state: the sizing pass
    (``file_row_counts``), the stripe clipping and the read share one
    parse."""
    st = os.stat(path)
    return _orc_meta_cached(path, st.st_mtime_ns, st.st_size)


@lru_cache(maxsize=512)
def _orc_meta_cached(path: str, mtime_ns: int, size: int):
    return read_orc_meta_any_codec(path)


#: ORC's CompressionKind of a SNAPPY file
_SNAPPY = 2


def read_orc_meta_any_codec(path: str):
    """``orc_meta.read_orc_meta`` (a byte-equal copy of the reference's,
    which reads NONE and ZLIB footers only) for SNAPPY files too, the
    writer's default: the footer and metadata sections are decompressed
    here, and the copy parses them from an uncompressed tail (metadata,
    footer, a postscript that says NONE) in an unnamed temporary file."""
    import tempfile
    from spark_rapids_tpu_torch.io.orc_meta import pb_fields, read_orc_meta
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        f.seek(max(size - 256, 0))
        tail = f.read()
        ps_len = tail[-1]
        fields = {fno: v for fno, _, v in pb_fields(tail[-1 - ps_len:-1])}
        if fields.get(2, 0) != _SNAPPY:
            return read_orc_meta(path)
        footer_len, meta_len = fields.get(1, 0), fields.get(5, 0)
        f.seek(size - 1 - ps_len - footer_len - meta_len)
        raw = f.read(meta_len + footer_len)
    meta = _snappy_sections(raw[:meta_len])
    footer = _snappy_sections(raw[meta_len:])
    # postscript fields 1 (footer length), 2 (compression: NONE) and 5
    # (metadata length)
    ps = (bytes([0x08]) + _varint_bytes(len(footer)) + bytes([0x10, 0])
          + bytes([0x28]) + _varint_bytes(len(meta)))
    with tempfile.TemporaryFile() as tf:
        tf.write(meta + footer + ps + bytes([len(ps)]))
        tf.flush()
        return read_orc_meta(os.dup(tf.fileno()))


def _snappy_sections(section: bytes) -> bytes:
    """An ORC stream's chunks (3-byte headers, ``(len << 1) | original``)
    with the SNAPPY ones decompressed by pyarrow's codec."""
    from spark_rapids_tpu_torch.io.orc_meta import _varint
    codec = pa.Codec("snappy")
    out = bytearray()
    i = 0
    while i + 3 <= len(section):
        hdr = section[i] | (section[i + 1] << 8) | (section[i + 2] << 16)
        i += 3
        chunk = section[i:i + (hdr >> 1)]
        i += hdr >> 1
        if hdr & 1:
            out.extend(chunk)
        else:
            # a snappy block starts with its decompressed length
            n = _varint(chunk, 0)[0]
            out.extend(codec.decompress(chunk, decompressed_size=n)
                       .to_pybytes())
    return bytes(out)


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _next_item(q: "queue.Queue", reader: Future):
    """A file reader's next item. The reader puts its end or its error
    before it returns, so a reader that is done with its queue empty is a
    fault: it raises here instead of blocking the scan."""
    while True:
        try:
            return q.get(timeout=_LIVENESS_S)
        except queue.Empty:
            if not reader.done():
                continue
            try:
                return q.get_nowait()
            except queue.Empty:
                reader.result()
                raise RuntimeError("an ORC file's reader ended without its "
                                   "result") from None


def clip_stripes(path: str, filters: Sequence[Expression],
                 nstripes: int, meta=None) -> List[int]:
    """The stripes whose statistics say they may hold matching rows. No
    statistics or no filters keeps them all."""
    if not filters:
        return list(range(nstripes))
    if meta is None:
        try:
            meta = _orc_meta(path)
        except Exception:
            return list(range(nstripes))
    if len(meta.stripe_stats) != nstripes:
        return list(range(nstripes))
    return [i for i, stats in enumerate(meta.stripe_stats)
            if all(stats_may_contain(flt, stats) for flt in filters)]


class TpuOrcScanExec(LeafExec):
    """An ORC scan whose batches land on the context's device: the
    statistics-clipped stripes of the assigned files, read on the host and
    uploaded. ``output`` is the full read schema, partition columns and
    the hidden input-file columns included."""

    is_device = True
    #: a file-list leaf: a source for the pipeline and the fold
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
        #: stripes read and stripes present in the last execution's files
        self.stripes_read = 0
        self.stripes_total = 0
        #: batches uploaded by the last execution
        self.batches_read = 0

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
        """Exact per-file row counts after the stripe pruning, from the
        metadata alone (no data read, one parse per file state)."""
        counts = []
        for pf in self.files:
            try:
                meta = _orc_meta(pf.path)
            except Exception:
                return None
            ns = len(meta.stripes)
            if ns == 0:
                if meta.num_rows:
                    return None  # the stripe list did not parse
                counts.append(0)
                continue
            stripes = clip_stripes(pf.path, self.filters, ns, meta=meta)
            counts.append(sum(meta.stripes[i].num_rows for i in stripes))
        return counts

    def _file_tables(self, pf: PartitionedFile
                     ) -> Generator[pa.Table, None, Tuple[int, int]]:
        """One file's batches as its stripes are read; returns (stripes
        read, stripes present)."""
        f = po.ORCFile(pf.path)
        file_cols = set(f.schema.names)
        want = [fl.name for fl in self.data_schema if fl.name in file_cols]
        try:
            meta = _orc_meta(pf.path)
        except Exception:
            meta = None
        stripes = clip_stripes(pf.path, self.filters, f.nstripes, meta=meta)
        # chunk the stripes to the row and byte budgets: small stripes
        # coalesce into one batch, a large one goes alone
        pending: List[pa.RecordBatch] = []
        rows = 0
        for i in stripes:
            rb = f.read_stripe(i, columns=want)
            pending.append(rb)
            rows += rb.num_rows
            nbytes = sum(b.nbytes for b in pending)
            if rows >= self.max_batch_rows or \
                    nbytes >= self.max_batch_bytes:
                yield self._emit(pending, pf)
                pending, rows = [], 0
        if pending:
            yield self._emit(pending, pf)
        return len(stripes), f.nstripes

    def _count(self, stripes: Tuple[int, int]) -> None:
        self.stripes_read += stripes[0]
        self.stripes_total += stripes[1]

    def iter_tables_for_files(self, files) -> Iterator[pa.Table]:
        files = list(files)
        width = min(len(files), os.cpu_count() or 1)
        if width < 2:
            for pf in files:
                self._count((yield from self._file_tables(pf)))
            return
        stop = threading.Event()
        pool = ThreadPoolExecutor(width, thread_name_prefix="orc-read")

        def read(pf: PartitionedFile, q: "queue.Queue") -> None:
            try:
                tables = self._file_tables(pf)
                while True:
                    try:
                        t = next(tables)
                    except StopIteration as end:
                        _put_abortable(q, ("end", end.value), stop)
                        return
                    if not _put_abortable(q, ("t", t), stop):
                        return
            except BaseException as e:  # noqa: BLE001 - raised by the scan
                _put_abortable(q, ("e", e), stop)

        def start(pf: PartitionedFile):
            q: "queue.Queue" = queue.Queue(maxsize=_AHEAD)
            return q, pool.submit(read, pf, q)
        try:
            todo = iter(files)
            ahead = deque(start(pf) for pf in islice(todo, width))
            while ahead:
                kind, val = _next_item(*ahead[0])
                if kind == "t":
                    yield val
                    continue
                if kind == "e":
                    raise val
                self._count(val)
                ahead.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    ahead.append(start(nxt))
        finally:
            # an early exit (a limit closing the generator) or an error:
            # the readers stop at their next batch, the files not started
            # are dropped
            stop.set()
            pool.shutdown(wait=True, cancel_futures=True)

    def _emit(self, batches: List[pa.RecordBatch],
              pf: PartitionedFile) -> pa.Table:
        t = evolve_schema(pa.Table.from_batches(batches), self.data_schema)
        t = append_partition_columns(t, self.partition_schema,
                                     pf.partition_values)
        return fill_file_meta(t, pf, self.output)

    def _iter_arrow(self, ctx: ExecContext) -> Iterator[pa.Table]:
        if ctx.partition_id >= self.scan_partitions:
            return
        yield from self.iter_tables_for_files(
            assigned_files(self.files, ctx.partition_id,
                           self.scan_partitions))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.columnar.transfer import \
            upload_arrow_conf
        self.stripes_read = self.stripes_total = self.batches_read = 0
        for t in self._iter_arrow(ctx):
            self.batches_read += 1
            yield upload_arrow_conf(t, ctx.device, ctx.conf)


class CpuOrcScanExec(CpuEngineExec):
    """The CPU engine's ORC scan: the device scan run on the host."""

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
        return TpuOrcScanExec(self.files, self._schema,
                              self.partition_schema, self.filters,
                              self.max_batch_rows, self.max_batch_bytes)


def _convert_orc(meta, children) -> TpuOrcScanExec:
    e = meta.exec
    return TpuOrcScanExec(e.files, e.output, e.partition_schema, e.filters,
                          e.max_batch_rows, e.max_batch_bytes)


def _tag_orc(meta) -> None:
    from spark_rapids_tpu_torch import config as cfg
    if not (meta.conf.get(cfg.ORC_ENABLED)
            and meta.conf.get(cfg.ORC_READ_ENABLED)):
        meta.will_not_work("ORC scanning disabled "
                           "(spark.rapids.tpu.sql.format.orc.read.enabled)")


def _register_rule() -> None:
    from spark_rapids_tpu_torch.plan.overrides import (ExecRule,
                                                       register_exec_rule)
    register_exec_rule(ExecRule(CpuOrcScanExec, "orc scan", _convert_orc,
                                tag=_tag_orc))


_register_rule()
