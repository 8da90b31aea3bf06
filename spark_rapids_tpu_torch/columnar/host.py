"""Host-side batch in the device layout, backed by numpy.

This is the port's host representation: the engine takes and returns
``HostBatch``es, so nothing on its path needs pyarrow. ``from_arrow`` and
``to_arrow`` convert at the edge and import pyarrow inside the function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import (DType, Field, Schema,
                                                    string_width_bucket)


@dataclass(frozen=True)
class HostColumn:
    dtype: DType
    data: np.ndarray                  # [rows] or [rows, width] uint8 strings
    validity: np.ndarray              # bool[rows]
    lengths: Optional[np.ndarray] = None   # int32[rows], strings only


@dataclass(frozen=True)
class HostBatch:
    schema: Schema
    columns: Tuple[HostColumn, ...]
    num_rows: int

    def column_by_name(self, name: str) -> HostColumn:
        return self.columns[self.schema.index_of(name)]

    def select(self, names) -> "HostBatch":
        """The named columns, in the order given (no copy)."""
        idx = [self.schema.index_of(n) for n in names]
        return HostBatch(Schema([self.schema[i] for i in idx]),
                         tuple(self.columns[i] for i in idx), self.num_rows)

    @property
    def nbytes(self) -> int:
        """The bytes of the same table in arrow's layout, as pyarrow's
        ``Table.nbytes`` counts them (the JAX package's scan size estimate):
        a validity bitmap where a column has nulls, fixed-width values, and
        for strings 4 offset bytes per row plus the string bytes."""
        n = self.num_rows
        total = 0
        for f, c in zip(self.schema, self.columns):
            if not c.validity[:n].all():
                total += (n + 7) // 8
            if f.dtype is DType.STRING:
                total += 4 * n + int(c.lengths[:n].sum())
            elif f.dtype is DType.BOOLEAN:
                total += (n + 7) // 8
            else:
                total += n * f.dtype.np_dtype().itemsize
        return total

    @staticmethod
    def from_arrow(table, string_max_bytes: int = 256) -> "HostBatch":
        """Arrow table -> HostBatch (pyarrow is imported here only)."""
        import pyarrow as pa
        table = table.combine_chunks()
        fields, cols = [], []
        for f, chunked in zip(table.schema, table.columns):
            arr = (chunked.chunk(0) if chunked.num_chunks == 1
                   else pa.concat_arrays(chunked.chunks))
            dt = _dtype_from_arrow(f.type)
            fields.append(Field(f.name, dt, f.nullable))
            validity = (np.ones(len(arr), np.bool_) if arr.null_count == 0
                        else np.asarray(arr.is_valid()).astype(np.bool_))
            if dt is DType.STRING:
                mat, lengths = _strings_to_matrix(arr, string_max_bytes)
                cols.append(HostColumn(dt, mat, validity, lengths))
                continue
            if dt is DType.TIMESTAMP:
                arr = arr.cast(pa.int64())
            elif dt is DType.DATE:
                arr = arr.cast(pa.int32())
            fill = False if dt is DType.BOOLEAN else 0
            data = np.asarray(arr.fill_null(fill)).astype(dt.np_dtype(),
                                                          copy=False)
            cols.append(HostColumn(dt, data, validity))
        return HostBatch(Schema(fields), tuple(cols), table.num_rows)

    def to_arrow(self):
        """HostBatch -> arrow table (pyarrow is imported here only)."""
        import pyarrow as pa
        arrays = [_column_to_arrow(f.dtype, c, self.num_rows)
                  for f, c in zip(self.schema, self.columns)]
        schema = pa.schema([pa.field(f.name, _arrow_type(f.dtype), f.nullable)
                            for f in self.schema])
        return pa.Table.from_arrays(arrays, schema=schema)


def concat_host_batches(batches: List[HostBatch], schema: Schema) -> HostBatch:
    """Row-concatenate host batches of one schema (strings padded to the
    widest matrix)."""
    cols = []
    for ci, f in enumerate(schema):
        parts = [b.columns[ci] for b in batches]
        validity = np.concatenate([p.validity for p in parts])
        if f.dtype is DType.STRING:
            width = max((p.data.shape[1] for p in parts), default=8)
            data = np.concatenate(
                [np.pad(p.data, ((0, 0), (0, width - p.data.shape[1])))
                 for p in parts]) if parts else np.zeros((0, width), np.uint8)
            lengths = np.concatenate([p.lengths for p in parts])
            cols.append(HostColumn(f.dtype, data, validity, lengths))
        else:
            data = (np.concatenate([p.data for p in parts]) if parts
                    else np.zeros(0, f.dtype.np_dtype()))
            cols.append(HostColumn(f.dtype, data, validity))
    return HostBatch(schema, tuple(cols), sum(b.num_rows for b in batches))


def _dtype_from_arrow(t) -> DType:
    import pyarrow as pa
    if pa.types.is_timestamp(t):
        return DType.TIMESTAMP
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return DType.STRING
    for dt in DType:
        if dt not in (DType.STRING, DType.TIMESTAMP) and _arrow_type(dt).equals(t):
            return dt
    raise TypeError(f"unsupported arrow type {t}")


def _arrow_type(dt: DType):
    import pyarrow as pa
    return {
        DType.BOOLEAN: pa.bool_(), DType.BYTE: pa.int8(),
        DType.SHORT: pa.int16(), DType.INT: pa.int32(),
        DType.LONG: pa.int64(), DType.FLOAT: pa.float32(),
        DType.DOUBLE: pa.float64(), DType.STRING: pa.string(),
        DType.DATE: pa.date32(), DType.TIMESTAMP: pa.timestamp("us", tz="UTC"),
        DType.NULL: pa.null(),
    }[dt]


def _strings_to_matrix(arr, max_bytes: int):
    """Arrow (offsets, bytes) -> byte matrix + lengths at the column's width
    bucket (the JAX package's layout)."""
    import pyarrow as pa
    n = len(arr)
    if n == 0:
        return (np.zeros((0, string_width_bucket(0, max_bytes)), np.uint8),
                np.zeros(0, np.int32))
    arr = arr.cast(pa.string()).fill_null("")
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32, count=n + 1,
                            offset=arr.offset * 4)
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    if lengths.max(initial=0) > max_bytes:
        raise ValueError(
            f"string of {lengths.max()} bytes exceeds device string width "
            f"{max_bytes} (spark.rapids.tpu.sql.string.maxBytes)")
    width = string_width_bucket(int(lengths.max(initial=0)), max_bytes)
    buf = arr.buffers()[2]
    payload = (np.frombuffer(buf, dtype=np.uint8,
                             count=int(offsets[-1]) - int(offsets[0]),
                             offset=int(offsets[0]))
               if buf is not None else np.zeros(0, np.uint8))
    mat = np.zeros((n, width), dtype=np.uint8)
    mat[np.arange(width, dtype=np.int32)[None, :] < lengths[:, None]] = payload
    return mat, lengths


def _column_to_arrow(dtype: DType, col: HostColumn, num_rows: int):
    import pyarrow as pa
    data = col.data[:num_rows]
    validity = np.asarray(col.validity[:num_rows], dtype=np.bool_)
    null_count = int((~validity).sum())
    vbuf = (None if null_count == 0
            else pa.py_buffer(np.packbits(validity, bitorder="little").tobytes()))
    if dtype is DType.STRING:
        lengths = col.lengths[:num_rows].astype(np.int32)
        width = int(lengths.max(initial=0))
        sel = np.arange(width)[None, :] < lengths[:, None]
        payload = data[:, :width][sel]
        offsets = np.zeros(num_rows + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        return pa.StringArray.from_buffers(
            num_rows, pa.py_buffer(offsets.tobytes()),
            pa.py_buffer(payload.tobytes()), vbuf, null_count)
    if dtype is DType.BOOLEAN:
        dbuf = pa.py_buffer(np.packbits(data.astype(np.bool_),
                                        bitorder="little").tobytes())
    else:
        dbuf = pa.py_buffer(np.ascontiguousarray(
            data.astype(dtype.np_dtype(), copy=False)).tobytes())
    storage = {DType.TIMESTAMP: pa.int64(), DType.DATE: pa.int32()}.get(
        dtype, _arrow_type(dtype))
    out = pa.Array.from_buffers(storage, num_rows, [vbuf, dbuf], null_count)
    return out.cast(_arrow_type(dtype)) if not storage.equals(
        _arrow_type(dtype)) else out
