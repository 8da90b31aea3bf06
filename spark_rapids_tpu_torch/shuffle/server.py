"""Shuffle server: serves metadata and chunked buffer sends from the cache.

The JAX package's ``shuffle/server.py`` (RapidsShuffleServer's role): the
metadata handler answers a peer's TableMetas from the catalog, and
``BufferSendState`` walks one packed buffer through the send bounce buffers
as tag-addressed chunk sends.

A map output still on the device is packed there (``device_pack``: every
column, float64 too, copied into one buffer on the card) and downloaded in
one copy; a spilled one is packed on the host from its spill arrays. Both
give the same bytes, so the wire format does not depend on the tier.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.memory.buffer import (SpillCorruptionError,
                                                  SpillableBuffer, StorageTier)
from spark_rapids_tpu_torch.shuffle import messages as msg
from spark_rapids_tpu_torch.shuffle.catalog import ShuffleBufferCatalog
from spark_rapids_tpu_torch.shuffle.codec import (checksum_of, compress_batch,
                                                  get_codec)
from spark_rapids_tpu_torch.shuffle.table_meta import (DevicePackLayout,
                                                       batch_string_max,
                                                       device_pack,
                                                       pack_host_batch,
                                                       uniform_string_batch)
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                      ServerConnection,
                                                      ShuffleTransport,
                                                      Transaction,
                                                      TransactionStatus)


def _pack_spillable(buf: SpillableBuffer):
    """Packed host bytes of a cached buffer (a bytes-like object), by its
    tier: on the device a device pack and one download, on the host or
    disk a host pack."""
    if buf.tier == StorageTier.DEVICE:
        batch = uniform_string_batch(buf.get_batch())
        layout = DevicePackLayout.for_batch_shape(
            batch.schema, batch.capacity, batch_string_max(batch))
        packed = device_pack(batch, layout)
        # one download straight into numpy's memory, which the send state
        # holds past this tensor's life
        host = np.empty(packed.numel(), dtype=np.uint8)
        torch.from_numpy(host).copy_(packed)
        return memoryview(host)
    raw, _ = pack_host_batch(buf.get_host_batch())
    return raw


class BufferSendState:
    """Walks one packed buffer through send bounce buffers as tag-addressed
    chunk sends. Window = however many bounce buffers the pool yields; each
    completed chunk re-arms its bounce buffer for the next chunk until the
    buffer is fully sent."""

    def __init__(self, server: "ShuffleServer", peer: str, data: bytes,
                 base_tag: int, chunk_size: int):
        self.server = server
        self.peer = peer
        self.data = data
        self.base_tag = base_tag
        self.chunk_size = chunk_size
        self.num_chunks = max(1, -(-len(data) // chunk_size))
        self._next_chunk = 0
        self._outstanding = 0
        self._lock = threading.Lock()
        self.error: Optional[str] = None
        self.done = threading.Event()

    def start(self) -> None:
        window = min(self.num_chunks, 4)
        bounces = self.server.transport.send_bounce.acquire(window)
        with self._lock:
            for bb in bounces:
                self._arm(bb)

    def _arm(self, bounce) -> None:
        """Stage the next chunk into ``bounce`` and send it. Caller holds lock."""
        i = self._next_chunk
        if i >= self.num_chunks:
            bounce.close()
            if self._outstanding == 0 and not self.done.is_set():
                self.done.set()
            return
        self._next_chunk += 1
        self._outstanding += 1
        start = i * self.chunk_size
        chunk = self.data[start:start + self.chunk_size]
        bounce.buffer[:len(chunk)] = chunk
        alt = AddressLengthTag(bounce.buffer, len(chunk), self.base_tag + i)

        def on_done(tx: Transaction, bounce=bounce):
            with self._lock:
                self._outstanding -= 1
                if tx.status is not TransactionStatus.SUCCESS:
                    self.error = tx.error_message or "send failed"
                    bounce.close()
                    self.done.set()
                    return
                self._arm(bounce)
        self.server.server_conn.send(self.peer, alt, on_done)


class ShuffleServer:
    """Registers the request handlers and owns the send states.

    ``supported_codecs`` restricts which codecs this server applies (None:
    everything the local registry can build). A TransferRequest naming a
    codec outside that set negotiates down to the copy codec instead of
    failing: the response's TableMeta.codec records what was applied."""

    def __init__(self, transport: ShuffleTransport,
                 catalog: ShuffleBufferCatalog, codec_name: str = "none",
                 supported_codecs=None):
        self.transport = transport
        self.server_conn: ServerConnection = transport.server
        self.catalog = catalog
        self.codec_name = codec_name
        self.supported_codecs = (None if supported_codecs is None
                                 else {c.lower() for c in supported_codecs})
        self.server_conn.register_request_handler(msg.REQ_METADATA,
                                                  self.handle_metadata_request)
        self.server_conn.register_request_handler(msg.REQ_TRANSFER,
                                                  self.handle_transfer_request)

    def _negotiate_codec(self, requested: str):
        """The codec applied for a request: the requested one when this
        server supports it, else copy."""
        from spark_rapids_tpu_torch.shuffle.codec import codec_available
        from spark_rapids_tpu_torch.utils import metrics as mt
        name = (requested or "copy").lower()
        if ((self.supported_codecs is not None
             and name not in self.supported_codecs)
                or not codec_available(name)):
            if name not in ("copy", "none"):
                self.transport.metrics[mt.SHUFFLE_CODEC_FALLBACKS].add(1)
            name = "copy"
        return get_codec(name, getattr(self.transport, "conf", None))

    # ---- handlers (run on transport rpc threads) --------------------------------
    def handle_metadata_request(self, peer: str, payload: bytes) -> bytes:
        req = msg.MetadataRequest.from_bytes(payload)
        tables = []
        for block in req.blocks:
            for idx, meta in enumerate(self.catalog.metas(block)):
                tables.append((block, idx, meta))
        return msg.MetadataResponse(tuple(tables)).to_bytes()

    def handle_transfer_request(self, peer: str, payload: bytes) -> bytes:
        req = msg.TransferRequest.from_bytes(payload)
        acquired = self.catalog.acquire_buffers(req.block)
        if req.table_idx >= len(acquired):
            for b, _ in acquired:
                b.close()
            raise KeyError(f"{req.block} has no table {req.table_idx}")
        for i, (b, _) in enumerate(acquired):
            if i != req.table_idx:
                b.close()
        buf, meta = acquired[req.table_idx]
        try:
            raw = _pack_spillable(buf)
        except SpillCorruptionError:
            # a spill file that fails its crc is a lost block, not a
            # transient error: drop the map task's outputs, so the peer's
            # next metadata request reports them missing (the permanent
            # signal that leads to the lineage recompute)
            self.catalog.remove_map_outputs(req.block.shuffle_id,
                                            req.block.map_id)
            raise
        finally:
            buf.close()
        codec = self._negotiate_codec(req.codec)
        wire, wire_meta = compress_batch(raw, meta, codec)
        # crc over the bytes on the wire (after compression): the client
        # checks the assembled buffer against it before decompressing
        crc = checksum_of(wire)
        # chunks are views of the buffer, copied once into the bounce buffers
        state = BufferSendState(self, peer, memoryview(wire), req.base_tag,
                                req.chunk_size)
        state.start()
        return msg.TransferResponse(len(wire), wire_meta.with_checksum(crc),
                                    crc).to_bytes()
