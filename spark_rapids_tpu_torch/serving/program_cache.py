"""Cross-query program cache with an on-disk key index, and plan keys.

The JAX package's cache holds the XLA programs its execs jit, keyed on the
plan's structure, dtypes and shape bucket. The port evaluates eagerly and
has no jitted programs: what it builds once per process and then reuses is
its ``nvcc``-built kernel libraries (``cuda_build.load``). They go through
this cache:

- the key is the library's name (``cuda_build.library_path``): a digest
  of its source, ``NVCC_FLAGS`` and the toolchain identity
  (``shims.get().identity()``);
- a miss runs the builder (``nvcc``, or a load of a library already
  built), and its seconds are the bound query's ``compile_s``;
- a ``disk_hit`` is a miss whose key the on-disk index already holds: an
  earlier process built that library into ``build/``, so this one only
  loads it. The index lives next to the libraries by default
  (``serving.cache.dir``);
- a launch looks its library up here, so a query's ``hits`` count its
  kernel launches.

The per-query counters keep the JAX package's keys (``program_cache``:
hits, misses, disk_hits; ``compile_s``). One in-flight latch per key: when
two queries miss on one key at once, one builds while the other waits, so
``nvcc`` runs once. Hits, misses, disk hits and build time land on
``current_query()`` when a query is bound.

``plan_key`` is also the cluster's lineage replay key (parallel/cluster.py
checks a replayed map stage against the key its first run recorded).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.serving.lifecycle import current_query

_INDEX_FILENAME = "serving-program-index.json"


def stable_key_hash(key: Any) -> str:
    """Process-independent identity of a cache key. Keys are tuples of
    operator names/config scalars, frozen-dataclass expressions, Schema
    objects and capacity buckets — all with deterministic reprs."""
    return hashlib.sha1(repr(key).encode()).hexdigest()


class _Program:
    """A cached program: ``fn`` is what the builder returned (a kernel
    library, or any callable). A callable's first invocation is timed too
    and added to the triggering query's ``compile_s``, as the JAX package
    times a jitted function's first call (an upper bound: it includes the
    first execution)."""

    __slots__ = ("fn", "_cache", "_first_pending", "_lock")

    def __init__(self, fn: Callable, cache: "ProgramCache"):
        self.fn = fn
        self._cache = cache
        self._first_pending = True
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if not self._first_pending:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        with self._lock:
            first, self._first_pending = self._first_pending, False
        if first:
            self._cache._note_compile(dt)
            q = current_query()
            if q is not None:
                q.note_compile(dt)
        return out


class ProgramCache:
    """LRU of compiled programs + the persistent plan-key index."""

    def __init__(self, max_programs: int = 4096,
                 index_path: Optional[str] = None):
        self.max_programs = max_programs
        self._lock = threading.Lock()
        self._programs: "OrderedDict[Any, _Program]" = OrderedDict()
        self._building: Dict[Any, threading.Event] = {}
        self._disk_index: Dict[str, int] = {}
        self._index_path: Optional[str] = None
        self._counters = {"hits": 0, "misses": 0, "disk_hits": 0,
                          "evictions": 0, "compile_s": 0.0}
        self.set_index_path(index_path)

    # ---- the cache ---------------------------------------------------------
    def get_or_build(self, key: Any, builder: Callable[[], Callable]):
        """Return the compiled program for ``key``, building (once, under a
        per-key latch) on miss. ``builder`` returns the callable to cache —
        a kernel library loaded by ``cuda_build``."""
        while True:
            with self._lock:
                prog = self._programs.get(key)
                if prog is not None:
                    self._programs.move_to_end(key)
                    self._counters["hits"] += 1
                else:
                    ev = self._building.get(key)
                    if ev is None:
                        ev = threading.Event()
                        self._building[key] = ev
                        break           # we build
            if prog is not None:
                # per-query attribution OUTSIDE the cache lock: the hit
                # path runs once per batch per operator and must not
                # serialize workers on handle locks
                q = current_query()
                if q is not None:
                    q.count_program(hit=True)
                return prog
            # someone else is building this key: wait, then re-check (on
            # builder failure the waiter becomes the next builder). Poll
            # the bound query's cancel/deadline flag — a build can take
            # minutes, and a cancelled query must
            # not wait out a program it will never run
            waiter_q = current_query()
            while not ev.wait(0.05):
                if waiter_q is not None:
                    waiter_q.check_cancelled()
        try:
            t0 = time.perf_counter()
            fn = builder()
            built_s = time.perf_counter() - t0
            prog = _Program(fn, self)
            khash = stable_key_hash(key)
            with self._lock:
                # a disk hit: an earlier process built this key where the
                # index lives (a library already in the build directory),
                # so this miss only loaded it
                from_disk = (self._index_path is not None
                             and khash in self._disk_index)
                self._counters["misses"] += 1
                self._counters["compile_s"] += built_s
                if from_disk:
                    self._counters["disk_hits"] += 1
                self._programs[key] = prog
                self._disk_index[khash] = self._disk_index.get(khash, 0) + 1
                while len(self._programs) > self.max_programs:
                    self._programs.popitem(last=False)
                    self._counters["evictions"] += 1
        finally:
            with self._lock:
                waiter = self._building.pop(key, None)
            if waiter is not None:
                waiter.set()
        # post-build bookkeeping AFTER the latch releases: waiters of this
        # key must not stay blocked on query attribution or the index
        # file's read-merge-rewrite
        q = current_query()
        if q is not None:
            q.count_program(hit=False, from_disk=from_disk)
            q.note_compile(built_s)
        self._save_index()
        return prog

    def _note_compile(self, seconds: float) -> None:
        with self._lock:
            self._counters["compile_s"] += seconds

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._counters)
            out["compile_s"] = round(out["compile_s"], 4)
            out["programs"] = len(self._programs)
            out["indexed_keys"] = len(self._disk_index)
            total = out["hits"] + out["misses"]
            out["hit_rate"] = round(out["hits"] / total, 4) if total else None
            return out

    def snapshot_counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    # ---- persistence -------------------------------------------------------
    def set_index_path(self, path: Optional[str]) -> None:
        """(Re)wire the on-disk index. ``path`` may be a directory (the
        index file lands inside) or a file path; None falls back to the
        kernel build directory; 'off' disables persistence."""
        if path is None:
            path = _default_index_dir()
        if not path or str(path).lower() == "off":
            with self._lock:
                self._index_path = None
            return
        if not str(path).endswith(".json"):
            path = os.path.join(path, _INDEX_FILENAME)
        loaded = _load_index(path)
        with self._lock:
            self._index_path = path
            for k, v in loaded.items():
                self._disk_index[k] = max(self._disk_index.get(k, 0), v)
        # persist immediately: keys compiled BEFORE the index was wired
        # (e.g. warmup actions preceding scheduler construction) must reach
        # disk even if no further miss ever triggers a save
        self._save_index()

    def _save_index(self) -> None:
        with self._lock:
            path = self._index_path
            if path is None:
                return
            mine = dict(self._disk_index)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # merge-with-current so concurrent server processes sharing one
            # cache directory extend, rather than clobber, the index
            merged = _load_index(path)
            for k, v in mine.items():
                merged[k] = max(merged.get(k, 0), v)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": 1, "keys": merged}, f)
            os.replace(tmp, path)
        except OSError:
            pass                        # the index is an optimization only

    # ---- test / lifecycle hooks -------------------------------------------
    def clear(self, drop_index: bool = False) -> None:
        """Drop the in-memory programs (and the counters). The disk index
        survives unless asked.
        In-flight build latches are NOT touched: clearing them would leave
        their waiters blocked on an Event the builder's finally can no
        longer find and set."""
        with self._lock:
            self._programs.clear()
            if drop_index:
                self._disk_index.clear()
            for k in self._counters:
                self._counters[k] = 0.0 if k == "compile_s" else 0


def _default_index_dir() -> Optional[str]:
    """The kernel build directory: the key index lives next to the
    libraries it describes."""
    from spark_rapids_tpu_torch import cuda_build
    return str(cuda_build.BUILD_DIR)


def _load_index(path: str) -> Dict[str, int]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        keys = data.get("keys", {})
        return {str(k): int(v) for k, v in keys.items()}
    except (OSError, ValueError):
        return {}


_GLOBAL: Optional[ProgramCache] = None
_GLOBAL_LOCK = threading.Lock()


def global_program_cache() -> ProgramCache:
    """The process-wide cache the kernel libraries load through
    (``cuda_build.load``). One per process, like the device itself."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ProgramCache()
        return _GLOBAL


def configure_from_conf(conf) -> ProgramCache:
    """Apply serving.* cache settings (scheduler construction path)."""
    from spark_rapids_tpu_torch import config as cfg
    cache = global_program_cache()
    cache.max_programs = conf.get(cfg.SERVING_CACHE_MAX_PROGRAMS)
    d = conf.get(cfg.SERVING_CACHE_DIR)
    cache.set_index_path(d if d else None)
    return cache


# ---------------------------------------------------------------- plan keys
def plan_key(plan, conf=None) -> str:
    """Canonical signature of a physical plan: operator structure, dtype
    signature and partitioning, with row-count estimates bucketed to
    powers of two (conf ``serving.shapeBuckets``). Two plans of the same
    query shape share one key, whatever their exact row counts."""
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.columnar.dtypes import bucket_capacity
    bucketed = True if conf is None else bool(
        conf.get(cfg.SERVING_SHAPE_BUCKETS))

    def walk(node) -> Tuple:
        est = node.size_estimate()
        if est is not None:
            est = (bucket_capacity(int(est)) if bucketed
                   else max(int(est), 1))
        sig = tuple(f.dtype.value for f in node.output)
        return (node.name, sig, node.num_partitions, est,
                tuple(walk(c) for c in node.children))

    return stable_key_hash(walk(plan))
