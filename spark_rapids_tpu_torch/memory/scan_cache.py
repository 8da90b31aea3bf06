"""Device-resident cache of scanned in-memory tables (the JAX package's
``memory/scan_cache.py``).

Repeated actions over the same DataFrame re-run the whole physical plan,
including the host-to-device upload of the scanned table. This cache keeps
the uploaded ``DeviceBatch`` alive across actions, keyed by the identity of
the scan's (immutable) ``HostBatch``, the string width and the device, with
LRU eviction over a device-byte budget. The device is part of the key
because one process may run sessions on the CPU and on the GPU over the
same host table; the JAX package has one device per process.

The device store counts the cache's bytes against its budget and shrinks
the cache before it spills anything (memory/store.py).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional, Tuple


class DeviceScanCache:
    """LRU over (table identity, string width, device) -> DeviceBatch.

    Identity is checked with a weakref to the host table: a dead or replaced
    object at the same address never produces a false hit, and a collected
    table's entry leaves the budget at the next eviction sweep. Every
    operation locks: the store's admission path shrinks the cache from
    whatever thread makes room.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        # key -> (weakref to table, DeviceBatch, nbytes)
        self._entries: "OrderedDict[Tuple, tuple]" = OrderedDict()
        #: per-key in-flight upload latch: two actions missing on the same
        #: table at once share one upload
        self._inflight: dict = {}
        #: hits and misses since the cache was made
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(table, smax: int, device) -> Tuple:
        return (id(table), smax, str(device))

    def get_or_put(self, table, smax: int, device, builder,
                   cancel_check=None):
        """Hit -> the cached batch. Miss -> exactly one caller runs
        ``builder`` (the upload) while concurrent missers wait on the key's
        latch and then read the inserted entry. A failing builder's
        exception reaches its caller, and a waiter takes the build over on
        its next loop: no key stays latched."""
        key = self._key(table, smax, device)
        while True:
            mine = False
            with self._lock:
                got = self._get_locked(table, key)
                if got is not None:
                    self.hits += 1
                    return got
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    # released in the mine-branch finally below: the store
                    # and the release correlate through `mine` (set True in
                    # this branch only), one hop beyond what path-
                    # insensitive dataflow can prove
                    self._inflight[key] = ev  # tpu-lint: disable=R008
                    mine = True
                    self.misses += 1
            if mine:
                try:
                    batch = builder()
                    self.put(table, smax, device, batch)
                    return batch
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    ev.set()
            while not ev.wait(0.05):
                if cancel_check is not None:
                    cancel_check()

    def _get_locked(self, table, key):
        entry = self._entries.get(key)
        if entry is None:
            return None
        ref, batch, _ = entry
        if ref() is not table:      # address reused by another table
            del self._entries[key]
            return None
        self._entries.move_to_end(key)
        return batch

    def get(self, table, smax: int, device):
        with self._lock:
            return self._get_locked(table, self._key(table, smax, device))

    def put(self, table, smax: int, device, batch) -> None:
        try:
            ref = weakref.ref(table)
        except TypeError:           # not weakref-able: not cached
            return
        nbytes = batch.device_size_bytes
        if nbytes > self.max_bytes:
            return
        with self._lock:
            self._entries[self._key(table, smax, device)] = (ref, batch,
                                                             nbytes)
            self._evict_locked()

    def _evict(self) -> None:
        with self._lock:
            self._evict_locked()

    def _evict_locked(self) -> None:
        # dead entries first, then LRU until under budget
        for key in [k for k, (r, _, _) in self._entries.items()
                    if r() is None]:
            del self._entries[key]
        while self._entries and self._total() > self.max_bytes:
            self._entries.popitem(last=False)

    def _total(self) -> int:
        return sum(n for _, _, n in self._entries.values())

    def total_bytes(self) -> int:
        """Device bytes held now: the device store counts these toward its
        budget."""
        with self._lock:
            return self._total()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def shrink_by(self, nbytes: int) -> int:
        """Evict LRU entries until at least ``nbytes`` are freed (or the
        cache is empty) -> the bytes freed. Cached scans can be uploaded
        again, so they go before any buffer spills."""
        freed = 0
        with self._lock:
            while self._entries and freed < nbytes:
                _, (_, _, n) = self._entries.popitem(last=False)
                freed += n
        return freed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_cache: Optional[DeviceScanCache] = None
_cache_lock = threading.Lock()


def peek_cache() -> Optional[DeviceScanCache]:
    """The live cache, if any, without making one."""
    return _cache


def get_cache(max_bytes: int) -> DeviceScanCache:
    """The process-wide cache; its budget follows the latest session's
    conf. The eviction sweep runs here too, so dead tables and a smaller
    budget are reclaimed on hit-only workloads."""
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = DeviceScanCache(max_bytes)
        else:
            _cache.max_bytes = max_bytes
            _cache._evict()
        return _cache
