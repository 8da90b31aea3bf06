"""The spill order queue and the host arena's allocator, in pure Python.

The JAX package builds these as a C++ library bound with ctypes and keeps
pure-Python twins for hosts without a toolchain; the port keeps its own copy
of those twins (same semantics: first-fit with coalescing; lowest priority
polls first, first in first out among equals).
"""
from __future__ import annotations

import bisect
import heapq
from typing import Dict, List, Optional, Tuple


class PyAddressSpaceAllocator:
    """First-fit allocator over an abstract address space of ``size`` bytes,
    coalescing neighbouring free blocks."""

    def __init__(self, size: int):
        self.size = size
        self._free: List[Tuple[int, int]] = [(0, size)] if size > 0 else []
        self._allocated: Dict[int, int] = {}     # offset -> length

    def allocate(self, length: int) -> Optional[int]:
        if length <= 0:
            return None
        for i, (off, flen) in enumerate(self._free):
            if flen >= length:
                if flen == length:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + length, flen - length)
                self._allocated[off] = length
                return off
        return None

    def free(self, offset: int) -> int:
        length = self._allocated.pop(offset, None)
        if length is None:
            return 0
        i = bisect.bisect_left(self._free, (offset, 0))
        self._free.insert(i, (offset, length))
        if i + 1 < len(self._free):
            off, flen = self._free[i]
            noff, nlen = self._free[i + 1]
            if off + flen == noff:
                self._free[i] = (off, flen + nlen)
                self._free.pop(i + 1)
        if i > 0:
            poff, plen = self._free[i - 1]
            off, flen = self._free[i]
            if poff + plen == off:
                self._free[i - 1] = (poff, plen + flen)
                self._free.pop(i)
        return length

    @property
    def available(self) -> int:
        return sum(length for _, length in self._free)

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def largest_free_block(self) -> int:
        return max((length for _, length in self._free), default=0)

    def close(self) -> None:
        self._free = []
        self._allocated = {}


class PyHashedPriorityQueue:
    """Keyed min-heap: heapq with lazy deletion and a map of live entries.
    Lowest priority polls first; equal priorities poll in insertion order."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int]] = []   # (priority, seq, key)
        self._live: Dict[int, Tuple[float, int]] = {}
        self._seq = 0

    def offer(self, key: int, priority: float) -> bool:
        self._seq += 1
        self._live[key] = (priority, self._seq)
        heapq.heappush(self._heap, (priority, self._seq, key))
        return True

    def __contains__(self, key: int) -> bool:
        return key in self._live

    def _prune(self):
        while self._heap:
            prio, seq, key = self._heap[0]
            if self._live.get(key) == (prio, seq):
                return self._heap[0]
            heapq.heappop(self._heap)
        return None

    def poll(self) -> Optional[Tuple[int, float]]:
        if self._prune() is None:
            return None
        prio, _seq, key = heapq.heappop(self._heap)
        del self._live[key]
        return key, prio

    def peek(self) -> Optional[Tuple[int, float]]:
        top = self._prune()
        if top is None:
            return None
        prio, _seq, key = top
        return key, prio

    def remove(self, key: int) -> bool:
        return self._live.pop(key, None) is not None

    def __len__(self) -> int:
        return len(self._live)

    def close(self) -> None:
        self._heap = []
        self._live = {}
