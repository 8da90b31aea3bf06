"""The native host runtime: the JAX package's C++ address-space allocator
and spill-ordering priority queue (``src/allocator.cpp``,
``src/priority_queue.cpp``, byte-equal copies), bound over their C ABI with
``ctypes``.

The sources are compiled at first use by ``g++ -O2 -shared -fPIC
-std=c++17`` into the git-ignored ``build/`` beside the CUDA libraries; the
library's name carries a digest of the sources, so an edited source is
rebuilt and a current one loaded as it is. A failed build raises with the
compiler's log: there is no pure-Python degrade (the plain versions in
``native/plain.py`` are the tests' reference). The memory store's spill
order and host arena run on these (``memory/store.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

NULL_OFFSET = 2 ** 64 - 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(SRC_DIR.glob("*.cpp"))


def library_path() -> Path:
    """``build/libsrt_native-<digest>.so``: the digest covers every
    source's name and bytes and the compiler flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrt_native-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the sources unless the library is current -> (library path,
    compiler log; empty when nothing was compiled). The compiler writes a
    file named for this process and thread, renamed into place, so two
    builds never write one file."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native runtime is built from "
                           f"{SRC_DIR} at first use") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on the native runtime (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def get_lib() -> ctypes.CDLL:
    """The native library, built if need be and bound once per process."""
    global _lib
    with _lock:
        if _lib is None:
            # the host runtime, not a kernel library: bound once per
            # process under this module's lock, with no query's build to
            # count
            # tpu-lint: disable=R007
            lib = ctypes.CDLL(str(build()[0]))
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.srt_allocator_create.restype = p
    lib.srt_allocator_create.argtypes = [u64]
    lib.srt_allocator_destroy.argtypes = [p]
    lib.srt_allocator_allocate.restype = u64
    lib.srt_allocator_allocate.argtypes = [p, u64]
    lib.srt_allocator_free.restype = u64
    lib.srt_allocator_free.argtypes = [p, u64]
    lib.srt_allocator_available.restype = u64
    lib.srt_allocator_available.argtypes = [p]
    lib.srt_allocator_allocated_size.restype = u64
    lib.srt_allocator_allocated_size.argtypes = [p, u64]
    lib.srt_allocator_num_free_blocks.restype = u64
    lib.srt_allocator_num_free_blocks.argtypes = [p]
    lib.srt_allocator_largest_free_block.restype = u64
    lib.srt_allocator_largest_free_block.argtypes = [p]

    lib.srt_pq_create.restype = p
    lib.srt_pq_destroy.argtypes = [p]
    lib.srt_pq_offer.restype = ctypes.c_int
    lib.srt_pq_offer.argtypes = [p, i64, ctypes.c_double]
    lib.srt_pq_contains.restype = ctypes.c_int
    lib.srt_pq_contains.argtypes = [p, i64]
    lib.srt_pq_poll.restype = ctypes.c_int
    lib.srt_pq_poll.argtypes = [p, ctypes.POINTER(i64),
                                ctypes.POINTER(ctypes.c_double)]
    lib.srt_pq_peek.restype = ctypes.c_int
    lib.srt_pq_peek.argtypes = [p, ctypes.POINTER(i64),
                                ctypes.POINTER(ctypes.c_double)]
    lib.srt_pq_remove.restype = ctypes.c_int
    lib.srt_pq_remove.argtypes = [p, i64]
    lib.srt_pq_size.restype = u64
    lib.srt_pq_size.argtypes = [p]


class _Native:
    """A Python owner of one C++ object, reached through ``_h()``."""

    _handle = None
    #: the name of the C function that frees the object
    _destroy = ""

    def _h(self):
        """The live C++ handle; a call after close() raises here instead
        of handing NULL to code that dereferences it."""
        if not self._handle:
            raise ValueError(f"{type(self).__name__} is closed")
        return self._handle

    def close(self) -> None:
        if self._handle:
            getattr(self._lib, self._destroy)(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class AddressSpaceAllocator(_Native):
    """First-fit sub-allocator over an abstract address space of ``size``
    bytes, coalescing neighbouring free blocks (C++)."""

    _destroy = "srt_allocator_destroy"

    def __init__(self, size: int):
        self._lib = get_lib()
        self._handle = self._lib.srt_allocator_create(size)
        if not self._handle:
            raise MemoryError("failed to create allocator")
        self.size = size

    def allocate(self, length: int) -> Optional[int]:
        off = self._lib.srt_allocator_allocate(self._h(), length)
        return None if off == NULL_OFFSET else off

    def free(self, offset: int) -> int:
        return self._lib.srt_allocator_free(self._h(), offset)

    @property
    def available(self) -> int:
        return self._lib.srt_allocator_available(self._h())

    def allocated_size(self, offset: int) -> int:
        return self._lib.srt_allocator_allocated_size(self._h(), offset)

    @property
    def num_free_blocks(self) -> int:
        return self._lib.srt_allocator_num_free_blocks(self._h())

    @property
    def largest_free_block(self) -> int:
        return self._lib.srt_allocator_largest_free_block(self._h())


class HashedPriorityQueue(_Native):
    """Min-heap with O(1) contains and keyed priority updates (C++). Lowest
    priority polls first, first in first out among equals: the spill
    order."""

    _destroy = "srt_pq_destroy"

    def __init__(self):
        self._lib = get_lib()
        self._handle = self._lib.srt_pq_create()
        if not self._handle:
            raise MemoryError("failed to create priority queue")

    def offer(self, key: int, priority: float) -> bool:
        """Insert ``key``, or update its priority (it keeps its first
        insertion's place among equal priorities). True when inserted."""
        return bool(self._lib.srt_pq_offer(self._h(), key, priority))

    def __contains__(self, key: int) -> bool:
        return bool(self._lib.srt_pq_contains(self._h(), key))

    def _top(self, fn) -> Optional[Tuple[int, float]]:
        k = ctypes.c_int64()
        pr = ctypes.c_double()
        if not fn(self._h(), ctypes.byref(k), ctypes.byref(pr)):
            return None
        return k.value, pr.value

    def poll(self) -> Optional[Tuple[int, float]]:
        return self._top(self._lib.srt_pq_poll)

    def peek(self) -> Optional[Tuple[int, float]]:
        return self._top(self._lib.srt_pq_peek)

    def remove(self, key: int) -> bool:
        return bool(self._lib.srt_pq_remove(self._h(), key))

    def __len__(self) -> int:
        return self._lib.srt_pq_size(self._h())
