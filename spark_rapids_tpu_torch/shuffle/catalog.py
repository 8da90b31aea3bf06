"""The shuffle catalogs: (shuffle, map, partition) block ids -> buffers in
the spillable store chain (memory/store.py), so cached map outputs spill
device -> host -> disk under pressure, and the client's catalog of fetched
packed buffers. The port's counterpart of the JAX package's
``shuffle/catalog.py``."""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

from spark_rapids_tpu_torch.memory.buffer import BufferId, SpillableBuffer
from spark_rapids_tpu_torch.memory.store import (SHUFFLE_BUFFER_PRIORITY,
                                                 BufferCatalog,
                                                 DeviceMemoryStore)
from spark_rapids_tpu_torch.shuffle.table_meta import TableMeta


@dataclass(frozen=True, order=True)
class ShuffleBlockId:
    """Address of one map task's output for one reduce partition."""
    shuffle_id: int
    map_id: int
    partition_id: int


class ShuffleBufferCatalog:
    """Maps shuffle block ids to store buffer ids and TableMetas; owns the
    registration and removal of the map-side shuffle cache."""

    _ids = itertools.count(1 << 20)   # table ids apart from other users

    def __init__(self, catalog: BufferCatalog, device_store: DeviceMemoryStore):
        self._catalog = catalog
        self._device_store = device_store
        self._lock = threading.RLock()
        self._blocks: Dict[ShuffleBlockId, List[Tuple[BufferId, TableMeta]]] = {}
        self._by_shuffle: Dict[int, List[ShuffleBlockId]] = {}

    def add_batch(self, block: ShuffleBlockId, batch,
                  meta: TableMeta) -> BufferId:
        """Cache one device batch for ``block`` in the device store."""
        buffer_id = BufferId(next(self._ids), block.partition_id)
        self._device_store.add_batch(buffer_id, batch,
                                     spill_priority=SHUFFLE_BUFFER_PRIORITY)
        with self._lock:
            entries = self._blocks.setdefault(block, [])
            if not entries:
                # one index entry per block: a map task that emits several
                # batches for one (map, partition) adds buffers to the block
                self._by_shuffle.setdefault(block.shuffle_id, []).append(block)
            entries.append((buffer_id, meta))
        return buffer_id

    def blocks_for_partition(self, shuffle_id: int,
                             partition_id: int) -> List[ShuffleBlockId]:
        with self._lock:
            return [b for b in self._by_shuffle.get(shuffle_id, [])
                    if b.partition_id == partition_id]

    def metas(self, block: ShuffleBlockId) -> List[TableMeta]:
        with self._lock:
            return [m for _, m in self._blocks.get(block, [])]

    def acquire_buffers(self, block: ShuffleBlockId
                        ) -> List[Tuple[SpillableBuffer, TableMeta]]:
        """Retain every buffer of a block, fastest tier first; the caller
        closes each one after use."""
        with self._lock:
            entries = list(self._blocks.get(block, []))
        out: List[Tuple[SpillableBuffer, TableMeta]] = []
        buf = None
        try:
            for buffer_id, meta in entries:
                buf = self._catalog.acquire(buffer_id)
                if buf is None:
                    raise KeyError(
                        f"shuffle buffer {buffer_id} vanished for {block}")
                out.append((buf, meta))
                buf = None      # handed off to `out`; the except owns it not
        except BaseException:
            # a later acquire failing must not strand the refcounts the
            # earlier ones already took
            if buf is not None:
                buf.close()
            for b, _m in out:
                b.close()
            raise
        return out

    def _remove_blocks(self, blocks: List[ShuffleBlockId]) -> int:
        removed = 0
        for block in blocks:
            for buffer_id, _ in self._blocks.pop(block, []):
                # the buffer may have spilled: remove it where it lives now
                buf = self._catalog.acquire(buffer_id)
                if buf is not None:
                    owner = buf.owner_store or self._device_store
                    buf.close()
                    owner.remove(buffer_id)
                    removed += 1
        return removed

    def remove_map_outputs(self, shuffle_id: int, map_id: int) -> int:
        """Unregister every block of one map task, so a re-run of the task
        replaces its blocks instead of adding to them."""
        with self._lock:
            keep, victims = [], []
            for block in self._by_shuffle.get(shuffle_id, []):
                (victims if block.map_id == map_id else keep).append(block)
            if not victims:
                return 0
            self._by_shuffle[shuffle_id] = keep
            return self._remove_blocks(victims)

    def remove_shuffle(self, shuffle_id: int) -> int:
        """Unregister a finished shuffle and release its buffers."""
        with self._lock:
            return self._remove_blocks(self._by_shuffle.pop(shuffle_id, []))


class ReceivedBufferCatalog:
    """Client-side catalog of fetched buffers: packed host buffers and
    their metas, held until the reading task takes them."""

    _ids = itertools.count()

    def __init__(self):
        self._lock = threading.Lock()
        self._received: Dict[int, Tuple[bytes, TableMeta]] = {}

    def add(self, buf: bytes, meta: TableMeta) -> int:
        with self._lock:
            rid = next(self._ids)
            self._received[rid] = (buf, meta)
            return rid

    def take(self, rid: int) -> Tuple[bytes, TableMeta]:
        with self._lock:
            return self._received.pop(rid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._received)
