"""TableMeta: the description of a batch laid out as one contiguous buffer
(each column's data, validity and lengths at 64-byte-aligned offsets).

The shuffle catalog stores one beside every map output. This is the part of
the JAX package's ``shuffle/table_meta.py`` that the catalog path uses; the
host and device pack and unpack come with the network shuffle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema

ALIGN = 64


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) & ~(a - 1)


@dataclass(frozen=True)
class SubBufferMeta:
    """Offset and length of one sub-buffer inside the contiguous buffer."""
    offset: int
    length: int


@dataclass(frozen=True)
class ColumnMeta:
    """One column's type and sub-buffer locations."""
    name: str
    dtype: DType
    nullable: bool
    string_max_bytes: int                 # 0 for non-strings
    data: SubBufferMeta
    validity: SubBufferMeta
    lengths: SubBufferMeta                # length 0 for non-strings


@dataclass(frozen=True)
class TableMeta:
    """A packed batch's row count, columns and sizes. ``codec`` names the
    compression of the packed buffer ("copy": none); ``checksum`` is a
    crc32 of it (0: not computed)."""
    num_rows: int
    columns: Tuple[ColumnMeta, ...]
    packed_size: int
    uncompressed_size: int
    codec: str = "copy"
    checksum: int = 0

    @property
    def schema(self) -> Schema:
        return Schema([Field(c.name, c.dtype, c.nullable)
                       for c in self.columns])


@dataclass(frozen=True)
class DevicePackLayout:
    """Byte layout of a packed batch, from (schema, capacity, string width)
    alone."""
    schema: Schema
    capacity: int
    string_max_bytes: int
    subs: Tuple[Tuple[SubBufferMeta, SubBufferMeta, SubBufferMeta], ...] = \
        field(default=())
    total_size: int = 0

    @staticmethod
    def for_batch_shape(schema: Schema, capacity: int,
                        string_max_bytes: int) -> "DevicePackLayout":
        pos = 0
        subs = []
        for f in schema:
            if f.dtype is DType.STRING:
                dsize = capacity * string_max_bytes
                lsize = capacity * 4
            else:
                dsize = capacity * f.dtype.np_dtype().itemsize
                lsize = 0
            d = SubBufferMeta(pos, dsize)
            pos = _align(pos + dsize)
            v = SubBufferMeta(pos, capacity)
            pos = _align(pos + capacity)
            if lsize:
                ln = SubBufferMeta(pos, lsize)
                pos = _align(pos + lsize)
            else:
                ln = SubBufferMeta(0, 0)
            subs.append((d, v, ln))
        return DevicePackLayout(schema, capacity, string_max_bytes,
                                tuple(subs), pos)


def uniform_string_batch(batch: DeviceBatch) -> DeviceBatch:
    """Pad every string column to the batch's widest string matrix: a
    layout describes one string width per batch."""
    widths = {int(c.data.shape[1]) for c in batch.columns
              if c.lengths is not None}
    if len(widths) <= 1:
        return batch
    w = max(widths)
    cols = [DeviceColumn(c.dtype, torch.nn.functional.pad(
                c.data, (0, w - c.data.shape[1])), c.validity, c.lengths)
            if c.lengths is not None and c.data.shape[1] != w else c
            for c in batch.columns]
    return DeviceBatch(batch.schema, tuple(cols), batch.num_rows)


def batch_string_max(batch: DeviceBatch) -> int:
    """String matrix width of a batch (0 without string columns)."""
    for c in batch.columns:
        if c.dtype is DType.STRING:
            return int(c.data.shape[1])
    return 0


def layout_to_meta(layout: DevicePackLayout, num_rows: int) -> TableMeta:
    """The TableMeta of a batch packed by ``layout``."""
    cols = []
    for f, (d, v, ln) in zip(layout.schema, layout.subs):
        smax = layout.string_max_bytes if f.dtype is DType.STRING else 0
        cols.append(ColumnMeta(f.name, f.dtype, f.nullable, smax, d, v, ln))
    return TableMeta(num_rows, tuple(cols), layout.total_size,
                     layout.total_size)
