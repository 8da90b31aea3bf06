"""Tiered spillable buffer stores and the catalog over them.

DEVICE -> HOST -> DISK. The device tier enforces a byte budget at admission:
adding a buffer that would exceed it first spills the coldest buffers (lowest
priority, oldest first among equals) down the chain. The host tier accounts
its budget as a first-fit arena, and a buffer that finds no block spills the
coldest host buffers to disk, or goes to disk itself. The port's counterpart
of the JAX package's ``memory/store.py``, with the same spill order, so the
same sequence of adds leaves each buffer on the same tier.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.memory.buffer import (BufferId, SpillableBuffer,
                                                  StorageTier)
from spark_rapids_tpu_torch.native import (PyAddressSpaceAllocator,
                                           PyHashedPriorityQueue)

#: shuffle map outputs are the coldest buffers: they spill first
SHUFFLE_BUFFER_PRIORITY = 0.0


class BufferCatalog:
    """buffer id -> {tier: buffer}; ``acquire`` returns the fastest tier."""

    def __init__(self):
        self._lock = threading.RLock()
        self._buffers: Dict[BufferId, Dict[StorageTier, SpillableBuffer]] = {}

    def register(self, buf: SpillableBuffer) -> None:
        with self._lock:
            self._buffers.setdefault(buf.id, {})[buf.tier] = buf

    def unregister(self, buf: SpillableBuffer) -> None:
        with self._lock:
            tiers = self._buffers.get(buf.id)
            if tiers and tiers.get(buf.tier) is buf:
                del tiers[buf.tier]
                if not tiers:
                    del self._buffers[buf.id]

    def acquire(self, buffer_id: BufferId) -> Optional[SpillableBuffer]:
        """The best-tier buffer, retained for the caller (close() it)."""
        with self._lock:
            tiers = self._buffers.get(buffer_id)
            if not tiers:
                return None
            buf = tiers[min(tiers.keys())]
            buf.retain()
            return buf

    def ids(self) -> List[BufferId]:
        with self._lock:
            return list(self._buffers.keys())

    def remove(self, buffer_id: BufferId) -> None:
        """Delete a buffer on every tier, through its owning store. Loops
        until the id is gone: a spill moving this buffer down holds it
        privately between the source store's pop and the target store's
        add, and its old tier stays registered until then."""
        while True:
            with self._lock:
                tiers = dict(self._buffers.get(buffer_id, {}))
            if not tiers:
                return
            for buf in tiers.values():
                if buf.owner_store is not None:
                    buf.owner_store.remove(buffer_id)
                else:
                    self.unregister(buf)
                    buf.close()
            with self._lock:
                if buffer_id not in self._buffers:
                    return
            time.sleep(0.001)


class BufferStore:
    """One storage tier of spillable buffers, chained to a slower tier."""

    tier: StorageTier

    def __init__(self, catalog: BufferCatalog,
                 budget_bytes: Optional[int] = None):
        self.catalog = catalog
        self.budget_bytes = budget_bytes
        self._lock = threading.RLock()
        self._buffers: Dict[int, SpillableBuffer] = {}      # key -> buffer
        self._spill_queue = PyHashedPriorityQueue()
        self._used = 0
        self.spill_store: Optional["BufferStore"] = None

    # ---- admission -------------------------------------------------------------
    def add_buffer(self, buf: SpillableBuffer) -> None:
        if buf.tier != self.tier:
            raise ValueError(f"a {buf.tier.name} buffer offered to the "
                             f"{self.tier.name} store")
        # make room outside the store lock: the spill cascade copies to the
        # host and writes files, which must not block unrelated traffic
        if self.budget_bytes is not None:
            self.spill_to_size(max(self.budget_bytes - buf.size_bytes, 0))
        with self._lock:
            buf.owner_store = self
            self._buffers[buf.id.key] = buf
            self._spill_queue.offer(buf.id.key, buf.spill_priority)
            self._used += buf.size_bytes
        self.catalog.register(buf)

    def spill_to_size(self, target_bytes: int) -> int:
        """Spill the coldest buffers until used <= target; returns the
        bytes spilled."""
        spilled = 0
        while True:
            with self._lock:
                if self._used <= target_bytes:
                    return spilled
                entry = self._spill_queue.poll()
                if entry is None:
                    return spilled
                buf = self._buffers.pop(entry[0], None)
                if buf is None:
                    continue
                self._used -= buf.size_bytes
            spilled += buf.size_bytes
            self._spill_one(buf)

    def _spill_one(self, buf: SpillableBuffer) -> None:
        if self.spill_store is None:
            self._readmit(buf)
            raise MemoryError(
                f"store tier {self.tier.name} over budget with no spill store")
        try:
            self.spill_store.add_buffer(self._move_down(buf))
        except Exception:
            # failed mid-move (a full disk): the victim stays tracked here
            self._readmit(buf)
            raise
        self.catalog.unregister(buf)
        buf.close()

    def _readmit(self, buf: SpillableBuffer) -> None:
        with self._lock:
            self._buffers[buf.id.key] = buf
            self._spill_queue.offer(buf.id.key, buf.spill_priority)
            self._used += buf.size_bytes

    def _move_down(self, buf: SpillableBuffer) -> SpillableBuffer:
        raise NotImplementedError

    # ---- bookkeeping -----------------------------------------------------------
    def remove(self, buffer_id: BufferId) -> None:
        with self._lock:
            buf = self._buffers.pop(buffer_id.key, None)
            if buf is not None:
                self._spill_queue.remove(buffer_id.key)
                self._used -= buf.size_bytes
        if buf is not None:
            self.catalog.unregister(buf)
            buf.close()

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def __len__(self) -> int:
        with self._lock:
            return len(self._buffers)

    def close(self) -> None:
        with self._lock:
            bufs = list(self._buffers.values())
            self._buffers.clear()
            self._used = 0
        for b in bufs:
            self.catalog.unregister(b)
            b.close()
        self._spill_queue.close()


class DeviceMemoryStore(BufferStore):
    """Device tier, budget-enforced at admission (torch's caching allocator
    owns the memory itself)."""

    tier = StorageTier.DEVICE

    def add_batch(self, buffer_id: BufferId, batch,
                  spill_priority: float = 0.0) -> SpillableBuffer:
        buf = SpillableBuffer.from_batch(buffer_id, batch, spill_priority)
        self.add_buffer(buf)
        return buf

    def _move_down(self, buf: SpillableBuffer) -> SpillableBuffer:
        return buf.to_host()


class HostMemoryStore(BufferStore):
    """Host tier, its budget kept as a first-fit arena of offsets."""

    tier = StorageTier.HOST

    def __init__(self, catalog: BufferCatalog, budget_bytes: int):
        super().__init__(catalog, budget_bytes)
        self.arena = PyAddressSpaceAllocator(budget_bytes)
        self._offsets: Dict[int, int] = {}

    def add_buffer(self, buf: SpillableBuffer) -> None:
        need = max(buf.size_bytes, 1)
        while True:
            with self._lock:
                off = self.arena.allocate(need)
                if off is not None:
                    self._offsets[buf.id.key] = off
                    break
                over = self._used
            # full or fragmented: spill the coldest host buffer to disk and
            # retry until a block fits or nothing is left to spill
            freed = self.spill_to_size(max(over - need, 0)) if over else 0
            if freed == 0:
                # nothing left to evict: the incoming buffer goes straight
                # to the next tier rather than failing the cascade
                if self.spill_store is None:
                    raise MemoryError(
                        f"host spill arena exhausted ({need} bytes needed, "
                        f"largest free block {self.arena.largest_free_block})")
                self.spill_store.add_buffer(self._move_down(buf))
                buf.close()
                return
        super().add_buffer(buf)

    def _release_arena(self, key: int) -> None:
        off = self._offsets.pop(key, None)
        if off is not None:
            self.arena.free(off)

    def _spill_one(self, buf: SpillableBuffer) -> None:
        super()._spill_one(buf)
        with self._lock:
            self._release_arena(buf.id.key)

    def remove(self, buffer_id: BufferId) -> None:
        super().remove(buffer_id)
        with self._lock:
            self._release_arena(buffer_id.key)

    def _move_down(self, buf: SpillableBuffer) -> SpillableBuffer:
        return buf.to_disk(self.spill_store.directory)

    def close(self) -> None:
        super().close()
        self.arena.close()


class DiskStore(BufferStore):
    """Disk tier: npz files in a spill directory, the caller's or else a
    temporary one made at the first spill and removed on close."""

    tier = StorageTier.DISK

    def __init__(self, catalog: BufferCatalog, directory: Optional[str] = None):
        super().__init__(catalog, budget_bytes=None)
        self._given = directory
        self._made: Optional[str] = None

    @property
    def directory(self) -> str:
        if self._given is not None:
            os.makedirs(self._given, exist_ok=True)
            return self._given
        with self._lock:
            if self._made is None:
                self._made = tempfile.mkdtemp(prefix="srtpu_torch_spill_")
            return self._made

    def _move_down(self, buf: SpillableBuffer) -> SpillableBuffer:
        raise MemoryError("disk is the last tier")

    def close(self) -> None:
        super().close()
        if self._made is not None:
            shutil.rmtree(self._made, ignore_errors=True)
            self._made = None


def build_store_chain(catalog: BufferCatalog, device_budget: int,
                      host_budget: int, disk_dir: Optional[str] = None):
    """The DEVICE -> HOST -> DISK chain -> (device, host, disk) stores."""
    disk = DiskStore(catalog, disk_dir)
    host = HostMemoryStore(catalog, host_budget)
    host.spill_store = disk
    device = DeviceMemoryStore(catalog, device_budget)
    device.spill_store = host
    return device, host, disk
