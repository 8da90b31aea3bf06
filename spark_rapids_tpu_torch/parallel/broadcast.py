"""Executor-side broadcast cache for the cluster path.

The JAX package's ``parallel/broadcast.py`` (GpuBroadcastExchangeExec's
once-per-executor batch): the driver builds the broadcast batch once,
serializes it, and pushes the bytes to every executor over the control
plane, once per (broadcast, executor). This process-global registry holds
the bytes; the first task that reads the broadcast unpacks it to a device
(or host) batch under a lock, and later tasks in the same executor process
reuse that batch.

The bytes are the shuffle's packed host buffer behind its TableMeta
(``serialize_batch``), where the JAX package ships arrow IPC: the port's
engine takes host batches, and needs no arrow on this path.
"""
from __future__ import annotations

import itertools
import struct
import threading
from typing import Dict, Tuple

import torch

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.shuffle.table_meta import (TableMeta,
                                                       pack_host_batch,
                                                       unpack_host_batch,
                                                       upload_packed)

#: process-global broadcast-id namespace: schedulers of concurrent
#: sessions share one registry, so ids must never collide
BROADCAST_IDS = itertools.count(1 << 29)

_LEN = struct.Struct("<I")


def capacity_host_batch(db) -> HostBatch:
    """A DeviceBatch's buffers on the host at its full capacity (padding
    rows and all), so what unpacks from them is the same device batch."""
    def host(t):
        return None if t is None else t.cpu().numpy()
    return HostBatch(db.schema, tuple(
        HostColumn(c.dtype, host(c.data), host(c.validity), host(c.lengths))
        for c in db.columns), db.num_rows)


def serialize_batch(hb: HostBatch) -> bytes:
    """One host batch as bytes: its TableMeta's length and bytes, then the
    packed buffer the meta describes."""
    raw, meta = pack_host_batch(hb)
    mb = meta.to_bytes()
    return _LEN.pack(len(mb)) + mb + raw


def _split(blob: bytes) -> Tuple[memoryview, TableMeta]:
    n, = _LEN.unpack_from(blob, 0)
    view = memoryview(blob)
    return view[_LEN.size + n:], TableMeta.from_bytes(
        bytes(view[_LEN.size:_LEN.size + n]))


def deserialize_batch(blob: bytes) -> HostBatch:
    """``serialize_batch``'s bytes -> a HostBatch of writable arrays (its
    checksum verified)."""
    raw, meta = _split(blob)
    return unpack_host_batch(bytearray(raw), meta)


def deserialize_to_device(blob: bytes, device: torch.device):
    """``serialize_batch``'s bytes -> a DeviceBatch on ``device``."""
    raw, meta = _split(blob)
    return upload_packed(raw, meta, device)


class _Entry:
    __slots__ = ("blob", "lock", "batches", "deserialize_count")

    def __init__(self, blob: bytes):
        self.blob = blob
        self.lock = threading.Lock()
        #: (device batch?, string width, device) -> the batch built; in
        #: practice one key, keyed so a drifted conf cannot be served a
        #: batch of another shape
        self.batches: Dict[Tuple[bool, int, str], object] = {}
        #: how many times the bytes were unpacked in this process (one per
        #: consumer shape, not one per task)
        self.deserialize_count = 0


class BroadcastManager:
    """Per-process registry (one per executor process; in-process executors
    share the driver's)."""

    _lock = threading.Lock()
    _entries: Dict[int, _Entry] = {}

    @classmethod
    def put(cls, broadcast_id: int, blob: bytes) -> None:
        with cls._lock:
            cls._entries[broadcast_id] = _Entry(blob)

    @classmethod
    def has(cls, broadcast_id: int) -> bool:
        with cls._lock:
            return broadcast_id in cls._entries

    @classmethod
    def get_batch(cls, broadcast_id: int, device: bool,
                  string_max_bytes: int, torch_device: torch.device):
        """The broadcast as a DeviceBatch on ``torch_device`` (``device``)
        or as a HostBatch."""
        with cls._lock:
            e = cls._entries.get(broadcast_id)
        if e is None:
            raise KeyError(f"broadcast {broadcast_id} not registered in "
                           "this executor")
        key = (device, string_max_bytes, str(torch_device))
        with e.lock:
            batch = e.batches.get(key)
            if batch is None:
                e.deserialize_count += 1
                batch = (deserialize_to_device(e.blob, torch_device)
                         if device else deserialize_batch(e.blob))
                e.batches[key] = batch
        return batch

    @classmethod
    def deserialize_count(cls, broadcast_id: int) -> int:
        with cls._lock:
            e = cls._entries.get(broadcast_id)
        return e.deserialize_count if e is not None else 0

    @classmethod
    def remove(cls, broadcast_id: int) -> None:
        with cls._lock:
            cls._entries.pop(broadcast_id, None)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._entries.clear()
