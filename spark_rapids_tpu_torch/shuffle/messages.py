"""Shuffle control-plane messages (struct-packed wire format).

Reference analog: the flatbuffer shuffle messages in MetaUtils.scala
ShuffleMetadata:247 + format/*.fbs — MetadataRequest/Response,
TransferRequest/Response. Same message set, struct packing instead of
flatbuffers (no codegen toolchain needed, format versioned by MAGIC/VERSION
in table_meta)."""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.shuffle.catalog import ShuffleBlockId
from spark_rapids_tpu_torch.shuffle.table_meta import TableMeta

REQ_METADATA = "metadata"
REQ_TRANSFER = "transfer"

_BLOCK = struct.Struct("<III")          # shuffle_id, map_id, partition_id
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _pack_block(b: ShuffleBlockId) -> bytes:
    return _BLOCK.pack(b.shuffle_id, b.map_id, b.partition_id)


def _unpack_block(buf: bytes, pos: int) -> Tuple[ShuffleBlockId, int]:
    s, m, p = _BLOCK.unpack_from(buf, pos)
    return ShuffleBlockId(s, m, p), pos + _BLOCK.size


@dataclass(frozen=True)
class MetadataRequest:
    """Reducer asks a peer for the TableMetas of its blocks for one partition."""
    shuffle_id: int
    partition_id: int
    blocks: Tuple[ShuffleBlockId, ...]

    def to_bytes(self) -> bytes:
        out = bytearray(_U32.pack(self.shuffle_id) + _U32.pack(self.partition_id)
                        + _U32.pack(len(self.blocks)))
        for b in self.blocks:
            out += _pack_block(b)
        return bytes(out)

    @staticmethod
    def from_bytes(buf: bytes) -> "MetadataRequest":
        shuffle_id, = _U32.unpack_from(buf, 0)
        partition_id, = _U32.unpack_from(buf, 4)
        n, = _U32.unpack_from(buf, 8)
        pos = 12
        blocks = []
        for _ in range(n):
            b, pos = _unpack_block(buf, pos)
            blocks.append(b)
        return MetadataRequest(shuffle_id, partition_id, tuple(blocks))


@dataclass(frozen=True)
class MetadataResponse:
    """Per requested block: the TableMetas of its cached tables."""
    tables: Tuple[Tuple[ShuffleBlockId, int, TableMeta], ...]  # (block, table_idx, meta)

    def to_bytes(self) -> bytes:
        out = bytearray(_U32.pack(len(self.tables)))
        for block, idx, meta in self.tables:
            mb = meta.to_bytes()
            out += _pack_block(block) + _U32.pack(idx) + _U32.pack(len(mb)) + mb
        return bytes(out)

    @staticmethod
    def from_bytes(buf: bytes) -> "MetadataResponse":
        n, = _U32.unpack_from(buf, 0)
        pos = 4
        tables = []
        for _ in range(n):
            block, pos = _unpack_block(buf, pos)
            idx, = _U32.unpack_from(buf, pos); pos += 4
            mlen, = _U32.unpack_from(buf, pos); pos += 4
            meta = TableMeta.from_bytes(buf[pos:pos + mlen]); pos += mlen
            tables.append((block, idx, meta))
        return MetadataResponse(tuple(tables))


@dataclass(frozen=True)
class TransferRequest:
    """Reducer asks the peer to start sending one table's packed buffer as
    chunked, tag-addressed sends (BufferTransferRequest analog). ``base_tag``
    is the client-chosen tag of chunk 0; chunk i uses base_tag + i."""
    block: ShuffleBlockId
    table_idx: int
    base_tag: int
    chunk_size: int
    codec: str = "copy"

    def to_bytes(self) -> bytes:
        cb = self.codec.encode()
        return (_pack_block(self.block) + _U32.pack(self.table_idx)
                + _U64.pack(self.base_tag) + _U32.pack(self.chunk_size)
                + _U32.pack(len(cb)) + cb)

    @staticmethod
    def from_bytes(buf: bytes) -> "TransferRequest":
        block, pos = _unpack_block(buf, 0)
        idx, = _U32.unpack_from(buf, pos); pos += 4
        tag, = _U64.unpack_from(buf, pos); pos += 8
        chunk, = _U32.unpack_from(buf, pos); pos += 4
        clen, = _U32.unpack_from(buf, pos); pos += 4
        codec = buf[pos:pos + clen].decode()
        return TransferRequest(block, idx, tag, chunk, codec)


@dataclass(frozen=True)
class TransferResponse:
    """Ack carrying the on-wire size (post-compression) + updated meta, so the
    receiver sizes its target buffer and chunk walk before data arrives.
    ``checksum`` is the server's crc32 over the on-wire bytes — the client
    verifies the assembled buffer against it before decompressing, turning
    silent corruption into a retryable error."""
    wire_size: int
    meta: TableMeta
    checksum: int = 0

    def to_bytes(self) -> bytes:
        mb = self.meta.to_bytes()
        return (_U64.pack(self.wire_size) + _U32.pack(self.checksum)
                + _U32.pack(len(mb)) + mb)

    @staticmethod
    def from_bytes(buf: bytes) -> "TransferResponse":
        size, = _U64.unpack_from(buf, 0)
        crc, = _U32.unpack_from(buf, 8)
        mlen, = _U32.unpack_from(buf, 12)
        return TransferResponse(size, TableMeta.from_bytes(buf[16:16 + mlen]),
                                crc)
