"""Shared file-datasource machinery of the scans (the JAX package's
``io/datasource.py``, over the port's expressions).

Reference analogs:
- hive-style partition discovery + partition-value columns appended per batch:
  ColumnarPartitionReaderWithPartitionValues.scala (96 LoC) — here
  ``discover_partitioned_files`` + ``append_partition_columns``.
- schema evolution on read (GpuParquetScan.scala:520 evolveSchemaIfNeededAndClose):
  ``evolve_schema`` adds missing columns as nulls, reorders, and casts.
- predicate-pushdown row-group clipping (GpuParquetScan.scala:688 clipBlocks):
  ``split_conjuncts`` + ``stats_may_contain`` evaluate simple predicates against
  min/max statistics so non-matching row groups are never read.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import _arrow_type
from spark_rapids_tpu_torch.exprs import literals as li
from spark_rapids_tpu_torch.exprs import nulls as nu
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs.core import Expression, UnresolvedAttribute

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"

_FORMAT_EXTENSIONS = {"parquet": (".parquet",), "orc": (".orc",),
                      "csv": (".csv",)}


@dataclass(frozen=True)
class PartitionedFile:
    """One input file plus its directory-derived partition values (aligned with
    the scan's partition schema)."""
    path: str
    partition_values: Tuple = ()


#: the characters Spark's ``ExternalCatalogUtils.escapePathName`` writes
#: as ``%XX`` in a partition directory's name
_PATH_ESCAPED = frozenset([chr(c) for c in range(1, 0x20)] + [
    '"', "#", "%", "'", "*", "/", ":", "=", "?", "\\", "\x7f", "{", "[",
    "]", "^"])


def escape_path_name(v: str) -> str:
    """A partition value as its directory name: Spark's
    ``escapePathName``, the empty string as the default partition."""
    if v == "":
        return HIVE_DEFAULT_PARTITION
    return "".join(f"%{ord(c):02X}" if c in _PATH_ESCAPED else c for c in v)


def unescape_path_name(raw: str) -> str:
    """Spark's ``unescapePathName``: each ``%XX`` of two hex digits back
    to its character."""
    out, i = [], 0
    while i < len(raw):
        h = raw[i + 1:i + 3]
        if raw[i] == "%" and len(h) == 2 and all(
                c in "0123456789abcdefABCDEF" for c in h):
            out.append(chr(int(h, 16)))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return "".join(out)


def _parse_partition_value(raw: str):
    if raw == HIVE_DEFAULT_PARTITION:
        return None
    raw = unescape_path_name(raw)
    for conv in (int, float):
        try:
            return conv(raw)
        except ValueError:
            pass
    try:
        return datetime.date.fromisoformat(raw)
    except ValueError:
        return raw


def _value_dtype(values: Sequence) -> DType:
    non_null = [v for v in values if v is not None]
    if not non_null:
        return DType.STRING
    if all(isinstance(v, bool) for v in non_null):
        return DType.BOOLEAN
    if all(isinstance(v, int) for v in non_null):
        return DType.INT
    if all(isinstance(v, (int, float)) for v in non_null):
        return DType.DOUBLE
    if all(isinstance(v, datetime.date) for v in non_null):
        return DType.DATE
    return DType.STRING


def _coerce_partition_value(v, dtype: DType):
    if v is None:
        return None
    if dtype is DType.STRING:
        return _partition_raw_string(v)
    if dtype is DType.DOUBLE:
        return float(v)
    return v


def _partition_raw_string(v) -> str:
    if isinstance(v, bool):
        return str(v).lower()
    return v.isoformat() if isinstance(v, datetime.date) else str(v)


def discover_partitioned_files(
        paths: Sequence[str], fmt: str
) -> Tuple[Tuple[PartitionedFile, ...], Schema]:
    """Expand directories into data files, parsing hive-style ``key=value``
    path segments into a partition schema (PartitioningUtils role)."""
    entries: List[Tuple[str, Dict[str, str]]] = []
    for root in paths:
        if os.path.isfile(root):
            entries.append((root, {}))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
            rel = os.path.relpath(dirpath, root)
            raw: Dict[str, str] = {}
            if rel != ".":
                for seg in rel.split(os.sep):
                    if "=" in seg:
                        k, _, v = seg.partition("=")
                        raw[k] = v
            for fn in sorted(filenames):
                if fn.startswith(("_", ".")):
                    continue
                exts = _FORMAT_EXTENSIONS.get(fmt, ())
                if exts and not fn.endswith(exts) and "." in fn:
                    continue
                entries.append((os.path.join(dirpath, fn), raw))
    part_names: List[str] = []
    for _, raw in entries:
        for k in raw:
            if k not in part_names:
                part_names.append(k)
    if not part_names:
        return tuple(PartitionedFile(p) for p, _ in entries), Schema([])
    columns = {k: [_parse_partition_value(raw[k]) if k in raw else None
                   for _, raw in entries] for k in part_names}
    pschema = Schema([Field(k, _value_dtype(columns[k]),
                            any(v is None for v in columns[k]))
                      for k in part_names])
    # coerce every value to the column-wide inferred type (a mixed k=1 / k=foo
    # column infers STRING; the k=1 entry must become "1", not int 1)
    for f in pschema:
        columns[f.name] = [_coerce_partition_value(v, f.dtype)
                           for v in columns[f.name]]
    files = tuple(
        PartitionedFile(p, tuple(columns[k][i] for k in part_names))
        for i, (p, _) in enumerate(entries))
    return files, pschema


def append_partition_columns(table: pa.Table, partition_schema: Schema,
                             values: Sequence) -> pa.Table:
    """Append constant partition-value columns to a data batch
    (ColumnarPartitionReaderWithPartitionValues analog)."""
    n = table.num_rows
    for f, v in zip(partition_schema, values):
        arr = pa.nulls(n, _arrow_type(f.dtype)) if v is None else pa.array(
            [v] * n, type=_arrow_type(f.dtype))
        table = table.append_column(pa.field(f.name, _arrow_type(f.dtype),
                                             f.nullable), arr)
    return table


def evolve_schema(table: pa.Table, want: Schema) -> pa.Table:
    """Reorder/cast/null-fill the file's columns to the requested read schema
    (evolveSchemaIfNeededAndClose analog, GpuParquetScan.scala:520).
    Dictionary- and run-end-encoded columns whose VALUE type already matches
    stay encoded — the device upload path decodes them with an on-device
    gather/expansion (the point of shipping the encoded form). Field
    metadata (the dictionary token, columnar/encoding.DICT_TOKEN_META)
    survives for kept-encoded columns."""
    cols = []
    fields = []
    for f in want:
        idx = table.schema.get_field_index(f.name)
        wt = _arrow_type(f.dtype)
        if idx < 0:
            cols.append(pa.nulls(table.num_rows, wt))
            fields.append(pa.field(f.name, wt, f.nullable))
            continue
        col = table.column(idx)
        if pa.types.is_dictionary(col.type):
            if col.type.value_type.equals(wt):
                cols.append(col)
                fields.append(pa.field(f.name, col.type, f.nullable,
                                       table.schema.field(idx).metadata))
                continue
            col = col.cast(col.type.value_type)   # value-type drift: decode
        elif pa.types.is_run_end_encoded(col.type):
            if col.type.value_type.equals(wt):
                cols.append(col)
                fields.append(pa.field(f.name, col.type, f.nullable))
                continue
            col = _decode_ree(col)                # value-type drift: decode
        cols.append(col.cast(wt) if not col.type.equals(wt) else col)
        fields.append(pa.field(f.name, wt, f.nullable))
    return pa.table(cols, schema=pa.schema(fields))


def _decode_ree(col):
    """Host-expand a run-end-encoded column (type-drift fallback only; the
    normal path keeps REE through to the device expansion)."""
    from spark_rapids_tpu_torch.columnar.encoding import ree_to_plain
    if isinstance(col, pa.ChunkedArray):
        if col.num_chunks == 0:
            return pa.chunked_array([], type=col.type.value_type)
        return pa.chunked_array([ree_to_plain(c) for c in col.chunks])
    return ree_to_plain(col)


# ---------------------------------------------------------------- pushdown
def split_conjuncts(condition: Expression) -> List[Expression]:
    """Flatten a boolean AND tree into its conjuncts."""
    if isinstance(condition, pr.And):
        out = []
        for c in condition.children:
            out.extend(split_conjuncts(c))
        return out
    return [condition]


def _attr_literal(e: Expression) -> Optional[Tuple[str, object, bool]]:
    """Match ``col OP lit`` / ``lit OP col``; returns (name, value, flipped)."""
    l, r = e.children
    if isinstance(l, UnresolvedAttribute) and isinstance(r, li.Literal):
        return l.name, r.value, False
    if isinstance(r, UnresolvedAttribute) and isinstance(l, li.Literal):
        return r.name, l.value, True
    return None


def is_pushable(e: Expression) -> bool:
    """True when ``stats_may_contain`` understands the predicate."""
    if isinstance(e, (pr.And, pr.Or)):
        return all(is_pushable(c) for c in e.children)
    if isinstance(e, (nu.IsNull, nu.IsNotNull)):
        return isinstance(e.children[0], UnresolvedAttribute)
    if isinstance(e, (pr.EqualTo, pr.LessThan, pr.LessThanOrEqual,
                      pr.GreaterThan, pr.GreaterThanOrEqual)):
        m = _attr_literal(e)
        return m is not None and m[1] is not None
    return False


@dataclass
class ColumnStats:
    """Min/max/null stats for one column of one row group / stripe."""
    min: object = None
    max: object = None
    null_count: Optional[int] = None
    num_values: Optional[int] = None


def stats_may_contain(e: Expression, stats: Dict[str, ColumnStats]) -> bool:
    """Conservative evaluation of a pushable predicate against row-group
    statistics: False means NO row in the group can match (safe to skip).
    Missing stats for a referenced column always returns True."""
    if isinstance(e, pr.And):
        return all(stats_may_contain(c, stats) for c in e.children)
    if isinstance(e, pr.Or):
        return any(stats_may_contain(c, stats) for c in e.children)
    if isinstance(e, nu.IsNull):
        s = stats.get(e.children[0].name)
        return s is None or s.null_count is None or s.null_count > 0
    if isinstance(e, nu.IsNotNull):
        s = stats.get(e.children[0].name)
        if s is None or s.null_count is None or s.num_values is None:
            return True
        return s.null_count < s.num_values
    m = _attr_literal(e)
    if m is None:
        return True
    name, value, flipped = m
    s = stats.get(name)
    if s is None or s.min is None or s.max is None:
        return True
    op = type(e)
    if flipped:  # lit OP col  ->  col FLIP(OP) lit
        op = {pr.LessThan: pr.GreaterThan, pr.GreaterThan: pr.LessThan,
              pr.LessThanOrEqual: pr.GreaterThanOrEqual,
              pr.GreaterThanOrEqual: pr.LessThanOrEqual}.get(op, op)
    try:
        if op is pr.EqualTo:
            return s.min <= value <= s.max
        if op is pr.LessThan:
            return s.min < value
        if op is pr.LessThanOrEqual:
            return s.min <= value
        if op is pr.GreaterThan:
            return s.max > value
        if op is pr.GreaterThanOrEqual:
            return s.max >= value
    except TypeError:
        return True
    return True


def assigned_files(files: Sequence[PartitionedFile], partition_id: int,
                   num_scan_partitions: int) -> List[PartitionedFile]:
    """Static file-to-task assignment (FilePartition planning role): files are
    round-robined over the scan's partitions."""
    return [f for i, f in enumerate(files)
            if i % num_scan_partitions == partition_id]


def _meta_names():
    from spark_rapids_tpu_torch.exprs.misc import (INPUT_FILE_LENGTH_COL,
                                             INPUT_FILE_NAME_COL,
                                             INPUT_FILE_START_COL)
    return (INPUT_FILE_NAME_COL, INPUT_FILE_START_COL, INPUT_FILE_LENGTH_COL)


def scan_data_schema(schema, partition_schema):
    """The columns a scan actually READS: the output schema minus partition
    columns (appended from directory values) and minus the hidden input-file
    metadata columns (appended per file). One rule for every format."""
    skip = {f.name for f in partition_schema} | set(_meta_names())
    return Schema([f for f in schema if f.name not in skip])


def fill_file_meta(table: pa.Table, pf: "PartitionedFile",
                   output_schema) -> pa.Table:
    """Append the scan's hidden input-file metadata columns when the exec's
    output asks for them: path, block start (0: splits are whole files),
    block length (file size). GpuInputFileBlock.scala's InputFileBlockHolder
    role — the values ride the batch instead of a thread-local."""
    name_col, start_col, len_col = _meta_names()
    if name_col not in output_schema.names():
        return table
    import numpy as np
    n = table.num_rows
    # one stat syscall per batch — cheap, and never stale when a file at the
    # same path is rewritten between queries
    size = os.path.getsize(pf.path)
    table = table.append_column(
        pa.field(name_col, pa.string(), nullable=False),
        pa.DictionaryArray.from_arrays(
            np.zeros(n, dtype=np.int32),
            pa.array([pf.path])).cast(pa.string()))
    for col, val in ((start_col, 0), (len_col, size)):
        table = table.append_column(
            pa.field(col, pa.int64(), nullable=False),
            pa.array(np.full(n, val, dtype=np.int64)))
    return table


def file_scan_size_estimate(files) -> "int | None":
    """Sum of on-disk file sizes — the size_estimate every file-scan leaf
    reports (parquet/orc/csv share it); None when any file is unstat-able
    (remote path, raced delete)."""
    import os
    try:
        return sum(os.path.getsize(f.path) for f in files)
    except OSError:
        return None
