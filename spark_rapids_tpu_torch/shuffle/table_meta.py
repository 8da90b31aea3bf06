"""TableMeta: the description of a batch laid out as one contiguous buffer
(each column's data, validity and lengths at 64-byte-aligned offsets).

The shuffle catalog stores one beside every map output, and the network
shuffle sends one ahead of every packed buffer. Two packs give the same
bytes for the same capacity-sized batch:

- the host pack (``pack_host_batch``): numpy buffers copied into one
  buffer; a spilled map output is packed so, and so is what the cluster
  ships as a broadcast, a cached partition or a result;
- the device pack (``device_pack``): every column viewed as bytes and
  copied into one zeroed buffer on the batch's device, which the server
  then downloads in one copy. ``device_unpack`` views a packed buffer on
  the device as a batch again.

``TableMeta.to_bytes``, the host pack and its crc32 are the JAX package's
wire format byte for byte, so each package reads the other's buffers.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

MAGIC = b"TPUM"
VERSION = 2          # v2: the header carries a crc32 of the packed buffer
ALIGN = 64

_DTYPE_CODES = {dt: i for i, dt in enumerate(DType)}
_CODES_DTYPE = {i: dt for dt, i in _DTYPE_CODES.items()}


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

    # ---- wire format ------------------------------------------------------------
    # header: magic(4s) version(H) codec_len(B) pad(B) num_rows(Q) num_cols(H)
    #         packed_size(Q) uncompressed_size(Q) checksum(I)
    _HDR = struct.Struct("<4sHBxQHQQI")
    # per column: name_len(H) dtype(B) nullable(B) smax(I) 3x(offset Q, length Q)
    _COL = struct.Struct("<HBBIQQQQQQ")

    def to_bytes(self) -> bytes:
        out = bytearray()
        codec_b = self.codec.encode()
        out += self._HDR.pack(MAGIC, VERSION, len(codec_b), self.num_rows,
                              len(self.columns), self.packed_size,
                              self.uncompressed_size, self.checksum)
        out += codec_b
        for c in self.columns:
            nb = c.name.encode()
            out += self._COL.pack(len(nb), _DTYPE_CODES[c.dtype],
                                  1 if c.nullable else 0, c.string_max_bytes,
                                  c.data.offset, c.data.length,
                                  c.validity.offset, c.validity.length,
                                  c.lengths.offset, c.lengths.length)
            out += nb
        return bytes(out)

    @staticmethod
    def from_bytes(b: bytes) -> "TableMeta":
        magic, ver, codec_len, num_rows, ncols, psize, usize, crc = \
            TableMeta._HDR.unpack_from(b, 0)
        if magic != MAGIC:
            raise ValueError(f"bad TableMeta magic {magic!r}")
        if ver != VERSION:
            raise ValueError(f"unsupported TableMeta version {ver}")
        pos = TableMeta._HDR.size
        codec = b[pos:pos + codec_len].decode()
        pos += codec_len
        cols: List[ColumnMeta] = []
        for _ in range(ncols):
            (nlen, dcode, nullable, smax, doff, dlen, voff, vlen, loff,
             llen) = TableMeta._COL.unpack_from(b, pos)
            pos += TableMeta._COL.size
            name = b[pos:pos + nlen].decode()
            pos += nlen
            cols.append(ColumnMeta(name, _CODES_DTYPE[dcode], bool(nullable),
                                   smax, SubBufferMeta(doff, dlen),
                                   SubBufferMeta(voff, vlen),
                                   SubBufferMeta(loff, llen)))
        return TableMeta(num_rows, tuple(cols), psize, usize, codec, crc)

    def with_codec(self, codec: str, packed_size: int) -> "TableMeta":
        # the described bytes change with the codec, so the old crc no
        # longer applies: "not computed" unless stamped again
        return replace(self, codec=codec, packed_size=packed_size,
                       checksum=0)

    def with_checksum(self, checksum: int) -> "TableMeta":
        return replace(self, checksum=checksum)


# ---------------------------------------------------------------------------------
# host pack / unpack
# ---------------------------------------------------------------------------------

def pack_host_batch(batch: HostBatch) -> Tuple[bytes, TableMeta]:
    """Copy every column buffer into one contiguous, 64-byte-aligned
    buffer -> (the buffer, its TableMeta with the buffer's crc32)."""
    chunks: List[Tuple[int, bytes]] = []       # (offset, raw)
    cols: List[ColumnMeta] = []
    pos = 0

    def put(arr: Optional[np.ndarray]) -> SubBufferMeta:
        nonlocal pos
        if arr is None:
            return SubBufferMeta(0, 0)
        raw = np.ascontiguousarray(arr).tobytes()
        off = pos
        chunks.append((off, raw))
        pos = _align(off + len(raw))
        return SubBufferMeta(off, len(raw))

    for f, c in zip(batch.schema, batch.columns):
        smax = int(c.data.shape[1]) if f.dtype is DType.STRING else 0
        cols.append(ColumnMeta(f.name, f.dtype, f.nullable, smax,
                               put(c.data), put(c.validity), put(c.lengths)))
    buf = bytearray(pos)
    for off, raw in chunks:
        buf[off:off + len(raw)] = raw
    data = bytes(buf)
    meta = TableMeta(batch.num_rows, tuple(cols), len(data), len(data),
                     checksum=zlib.crc32(data) & 0xFFFFFFFF)
    return data, meta


class ChecksumError(ValueError):
    """A buffer does not match the checksum its meta promises: corruption
    between pack and unpack (wire, spill or staging). Retryable on fetch
    paths; shuffle.codec re-exports it."""


def _verify(buf, meta: TableMeta) -> None:
    """Refuse a compressed buffer, and one whose crc32 is not the one its
    meta carries (when it carries one)."""
    if meta.codec != "copy":
        raise ValueError(f"buffer still compressed with {meta.codec!r}; "
                         f"decompress first")
    if meta.checksum:
        actual = zlib.crc32(buf) & 0xFFFFFFFF
        if actual != meta.checksum:
            raise ChecksumError(
                f"packed buffer checksum mismatch (expected "
                f"{meta.checksum:#010x}, got {actual:#010x}, {len(buf)} bytes)")


def unpack_host_batch(buf, meta: TableMeta) -> HostBatch:
    """A HostBatch over a packed buffer (the arrays are views of ``buf``:
    writable when ``buf`` is a bytearray). A meta that carries a checksum
    is verified first."""
    _verify(buf, meta)
    mv = memoryview(buf)
    cols: List[HostColumn] = []
    for cm in meta.columns:

        def sub(s: SubBufferMeta, dt, shape=None):
            a = np.frombuffer(mv[s.offset:s.offset + s.length], dtype=dt)
            return a.reshape(shape) if shape is not None else a

        validity = sub(cm.validity, np.bool_)
        n_cap = len(validity)
        if cm.dtype is DType.STRING:
            data = sub(cm.data, np.uint8, (n_cap, cm.string_max_bytes))
            cols.append(HostColumn(cm.dtype, data, validity,
                                   sub(cm.lengths, np.int32)))
        else:
            cols.append(HostColumn(cm.dtype, sub(cm.data,
                                                 cm.dtype.np_dtype()),
                                   validity))
    return HostBatch(meta.schema, tuple(cols), meta.num_rows)


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
                c.data, (0, w - c.data.shape[1])), c.validity, c.lengths,
                c.encoding)
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
    """The TableMeta of a batch packed by ``layout``. The device and host
    packs align capacity-sized buffers alike, so it also describes the
    host pack of the same batch."""
    cols = []
    for f, (d, v, ln) in zip(layout.schema, layout.subs):
        smax = layout.string_max_bytes if f.dtype is DType.STRING else 0
        cols.append(ColumnMeta(f.name, f.dtype, f.nullable, smax, d, v, ln))
    return TableMeta(num_rows, tuple(cols), layout.total_size,
                     layout.total_size)


def host_to_device_batch(hb: HostBatch, device: torch.device) -> DeviceBatch:
    """Upload a capacity-sized HostBatch (an unpacked buffer's) as is."""
    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device)
    return DeviceBatch(hb.schema, tuple(
        DeviceColumn(c.dtype, up(c.data), up(c.validity),
                     None if c.lengths is None else up(c.lengths))
        for c in hb.columns), hb.num_rows)


# ---------------------------------------------------------------------------------
# device pack / unpack
# ---------------------------------------------------------------------------------

def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A column buffer's bytes as a flat uint8 tensor (a view when the
    buffer is contiguous): every dtype, float64 too, on any device."""
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.contiguous().view(torch.uint8).reshape(-1)


def device_pack(batch: DeviceBatch, layout: DevicePackLayout) -> torch.Tensor:
    """DeviceBatch -> one uint8[layout.total_size] tensor on its device,
    zero between the sub-buffers: the host pack's bytes."""
    out = torch.zeros(layout.total_size, dtype=torch.uint8,
                      device=batch.device if batch.columns else "cpu")
    for col, (d, v, ln) in zip(batch.columns, layout.subs):
        out[d.offset:d.offset + d.length] = _as_bytes(col.data)
        out[v.offset:v.offset + v.length] = _as_bytes(col.validity)
        if ln.length:
            out[ln.offset:ln.offset + ln.length] = _as_bytes(col.lengths)
    return out


def _from_bytes(flat: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return flat.view(dtype).reshape(shape)


def _unpack_columns(buf: torch.Tensor, schema: Schema, subs, cap: int,
                    widths) -> Tuple[DeviceColumn, ...]:
    cols = []
    for f, (d, v, ln), w in zip(schema, subs, widths):
        validity = _from_bytes(buf[v.offset:v.offset + v.length], torch.bool,
                               (cap,))
        data = buf[d.offset:d.offset + d.length]
        if f.dtype is DType.STRING:
            cols.append(DeviceColumn(
                f.dtype, data.reshape(cap, w), validity,
                _from_bytes(buf[ln.offset:ln.offset + ln.length],
                            torch.int32, (cap,))))
        else:
            cols.append(DeviceColumn(
                f.dtype, _from_bytes(data, f.dtype.torch_dtype(), (cap,)),
                validity))
    return tuple(cols)


def device_unpack(buf: torch.Tensor, layout: DevicePackLayout,
                  num_rows: int) -> DeviceBatch:
    """A packed uint8 tensor -> DeviceBatch whose columns are views of it
    (its padding rows already invalid)."""
    return DeviceBatch(layout.schema, _unpack_columns(
        buf, layout.schema, layout.subs, layout.capacity,
        [layout.string_max_bytes] * len(layout.schema)), num_rows)


def upload_packed(raw, meta: TableMeta, device: torch.device) -> DeviceBatch:
    """An uncompressed packed buffer -> DeviceBatch on ``device``: checked
    as ``unpack_host_batch`` checks it, copied up whole, then viewed as
    columns by the meta's sub-buffers."""
    _verify(raw, meta)
    host = np.frombuffer(raw, dtype=np.uint8)
    if not host.flags.writeable:       # bytes: torch wants its own copy
        host = host.copy()
    buf = torch.from_numpy(host).to(device)
    cap = (meta.columns[0].validity.length if meta.columns else 0)
    return DeviceBatch(meta.schema, _unpack_columns(
        buf, meta.schema, [(c.data, c.validity, c.lengths)
                           for c in meta.columns], cap,
        [c.string_max_bytes for c in meta.columns]), meta.num_rows)
