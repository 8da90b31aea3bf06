"""ORC file metadata reader: postscript, footer, and per-stripe statistics.

Reference analog: GpuOrcScan.scala + OrcFilters.scala:194 — the reference
gets stripe pruning from orc-core's SearchArgument machinery; pyarrow's ORC
binding exposes no stripe statistics at all, so this module reads them
straight off the file: the postscript locates the (optionally
zlib-compressed) footer and metadata sections, and a minimal protobuf
wire-format walker extracts StripeInformation and per-stripe
ColumnStatistics (min/max/null counts) for the pruning predicate evaluator
shared with the parquet reader (datasource.stats_may_contain)."""
from __future__ import annotations

import datetime
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.io.datasource import ColumnStats

_MAGIC = b"ORC"


# ---------------------------------------------------------------------------
# protobuf wire format (subset: varint, fixed64, length-delimited, fixed32)
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def pb_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples; value is int for
    varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fno, wt, v


def _decompress(section: bytes, kind: int) -> bytes:
    """ORC stream decompression: NONE passes through; ZLIB sections are a
    sequence of chunks with 3-byte headers ((len << 1) | isOriginal)."""
    if kind == 0:
        return section
    if kind != 1:
        raise ValueError(f"unsupported ORC compression kind {kind} "
                         f"(only NONE/ZLIB)")
    out = bytearray()
    i = 0
    while i + 3 <= len(section):
        hdr = section[i] | (section[i + 1] << 8) | (section[i + 2] << 16)
        i += 3
        length = hdr >> 1
        chunk = section[i:i + length]
        i += length
        if hdr & 1:
            out.extend(chunk)
        else:
            out.extend(zlib.decompress(chunk, -15))
    return bytes(out)


# ---------------------------------------------------------------------------
# ORC metadata model
# ---------------------------------------------------------------------------
@dataclass
class StripeInfo:
    offset: int = 0
    index_length: int = 0
    data_length: int = 0
    footer_length: int = 0
    num_rows: int = 0


@dataclass
class OrcMeta:
    num_rows: int = 0
    column_names: List[str] = field(default_factory=list)
    column_kinds: List[int] = field(default_factory=list)  # per type id
    stripes: List[StripeInfo] = field(default_factory=list)
    #: stripe index -> column name -> ColumnStats
    stripe_stats: List[Dict[str, ColumnStats]] = field(default_factory=list)


# TypeKind enum (orc_proto.proto)
_K_DATE = 15
_K_STRING = {7, 16, 17}        # string, varchar, char
_K_INT = {1, 2, 3, 4}          # byte..long (boolean=0 uses bucket stats)
_K_FLOAT = {5, 6}


def _col_stats(buf: bytes, kind: int) -> ColumnStats:
    num_values: Optional[int] = None
    has_null: Optional[bool] = None
    mn = mx = None
    for fno, wt, v in pb_fields(buf):
        if fno == 1:
            num_values = v
        elif fno == 10:
            has_null = bool(v)
        elif fno == 2 and kind in _K_INT:          # IntegerStatistics
            for f2, w2, v2 in pb_fields(v):
                if f2 == 1:
                    mn = _zigzag(v2)
                elif f2 == 2:
                    mx = _zigzag(v2)
        elif fno == 3 and kind in _K_FLOAT:        # DoubleStatistics
            for f2, w2, v2 in pb_fields(v):
                if f2 == 1:
                    mn = struct.unpack("<d", struct.pack("<Q", v2))[0]
                elif f2 == 2:
                    mx = struct.unpack("<d", struct.pack("<Q", v2))[0]
        elif fno == 4 and kind in _K_STRING:       # StringStatistics
            for f2, w2, v2 in pb_fields(v):
                if f2 == 1:
                    mn = v2.decode("utf-8", errors="replace")
                elif f2 == 2:
                    mx = v2.decode("utf-8", errors="replace")
        elif fno == 7 and kind == _K_DATE:         # DateStatistics (days)
            for f2, w2, v2 in pb_fields(v):
                epoch = datetime.date(1970, 1, 1)
                if f2 == 1:
                    mn = epoch + datetime.timedelta(days=_zigzag(v2))
                elif f2 == 2:
                    mx = epoch + datetime.timedelta(days=_zigzag(v2))
    # ORC pre-1.5 writers may omit hasNull; treat unknown as unknown
    null_count = None
    if has_null is False:
        null_count = 0
    elif has_null is True and num_values is not None:
        null_count = 1   # "at least one" — enough for IsNull pruning
    return ColumnStats(min=mn, max=mx, null_count=null_count,
                       num_values=num_values)


def read_orc_meta(path: str) -> OrcMeta:
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        tail_len = min(size, 64 * 1024)
        f.seek(size - tail_len)
        tail = f.read(tail_len)

        ps_len = tail[-1]
        ps = tail[-1 - ps_len:-1]
        footer_len = compression = metadata_len = 0
        for fno, wt, v in pb_fields(ps):
            if fno == 1:
                footer_len = v
            elif fno == 2:
                compression = v
            elif fno == 5:
                metadata_len = v
        need = 1 + ps_len + footer_len + metadata_len
        if need > tail_len:
            f.seek(size - need)
            tail = f.read(need)
        footer_raw = tail[-1 - ps_len - footer_len:-1 - ps_len]
        meta_raw = tail[-1 - ps_len - footer_len - metadata_len:
                        -1 - ps_len - footer_len]

    footer = _decompress(footer_raw, compression)
    meta = OrcMeta()
    types: List[Tuple[int, List[str]]] = []
    for fno, wt, v in pb_fields(footer):
        if fno == 3:                              # StripeInformation
            si = StripeInfo()
            for f2, w2, v2 in pb_fields(v):
                if f2 == 1:
                    si.offset = v2
                elif f2 == 2:
                    si.index_length = v2
                elif f2 == 3:
                    si.data_length = v2
                elif f2 == 4:
                    si.footer_length = v2
                elif f2 == 5:
                    si.num_rows = v2
            meta.stripes.append(si)
        elif fno == 4:                            # Type
            kind = 0
            names: List[str] = []
            for f2, w2, v2 in pb_fields(v):
                if f2 == 1:
                    kind = v2
                elif f2 == 3:
                    names.append(v2.decode())
            types.append((kind, names))
        elif fno == 6:
            meta.num_rows = v
    if types:
        meta.column_kinds = [k for k, _ in types]
        meta.column_names = types[0][1]           # root struct field names

    nested = any(k in (10, 11, 12, 13)     # struct/list/map/union
                 for k in meta.column_kinds[1:])
    if metadata_len and not nested:
        # nested schemas break the flat field->type-id mapping; skip stats
        # (pruning degrades to keep-all, never to wrong attribution)
        md = _decompress(meta_raw, compression)
        for fno, wt, v in pb_fields(md):
            if fno != 1:                          # StripeStatistics
                continue
            per_col: Dict[str, ColumnStats] = {}
            col_bufs = [v2 for f2, w2, v2 in pb_fields(v) if f2 == 1]
            # type id 0 is the root struct; flat schemas map field i -> id i+1
            for i, name in enumerate(meta.column_names):
                tid = i + 1
                if tid < len(col_bufs) and tid < len(meta.column_kinds):
                    per_col[name] = _col_stats(col_bufs[tid],
                                               meta.column_kinds[tid])
            meta.stripe_stats.append(per_col)
    return meta
