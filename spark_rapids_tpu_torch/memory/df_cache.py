"""The user-facing DataFrame cache: ``df.cache()`` / ``persist()`` on the
spillable store (the JAX package's ``memory/df_cache.py``).

Spark's CacheManager owns the cached data and swaps matching logical
subtrees for it at planning time. Here the cache is the tiered store: the
first action over a cached plan materializes its result batches into the
device tier of the DeviceManager's store chain, where they spill device ->
host -> disk under pressure like any spillable buffer, and every later
plan that contains an equal subtree scans those buffers
(execs/cache_execs.py) instead of computing it again.

Matching is structural equality over the logical plan (``same_plan``),
with a scanned table matched by identity: the port's host tables hold
numpy arrays, which have no equality of their own. Materialization is
lazy: ``cache()`` only marks the plan, and the first action whose plan
uses the entry fills it, as Spark's lazy cache does.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from typing import List, Optional

from spark_rapids_tpu_torch.memory.buffer import BufferId
from spark_rapids_tpu_torch.plan import logical as lp

#: table-id namespace apart from the shuffle blocks' (from 1 << 20) and the
#: grace partitions' (from 1 << 29)
_CACHE_IDS = itertools.count(1 << 28)


def same_plan(a, b) -> bool:
    """Structural equality of two logical plans: the same node types with
    equal fields, children compared recursively, scanned tables and cache
    entries by identity."""
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, (lp.LocalRelation, lp.CachedRelation)):
        return False                # distinct objects: identity only
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, lp.LogicalPlan):
            if not same_plan(x, y):
                return False
            continue
        try:
            if not bool(x == y):
                return False
        except (TypeError, ValueError):
            return False
    return True


def _map_logical_children(node: lp.LogicalPlan, fn) -> lp.LogicalPlan:
    """The node with ``fn`` applied to every child field (the children sit
    under child, left or right)."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, lp.LogicalPlan):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
    return dataclasses.replace(node, **changes) if changes else node


class CachedData:
    """One cached logical plan and its materialized buffers (None until the
    first use). The buffers stay in the DeviceManager's catalog until
    ``unpersist()``."""

    def __init__(self, logical: lp.LogicalPlan):
        self.logical = logical
        self.table_id = next(_CACHE_IDS)
        self.buffer_ids: Optional[List[BufferId]] = None
        self.lock = threading.Lock()
        #: set (under ``lock``) once the entry is unpersisted: a later
        #: materialization must not register buffers nobody would free
        self.dropped = False

    @property
    def is_materialized(self) -> bool:
        return self.buffer_ids is not None


def _release_entry(e: CachedData, dm) -> None:
    """Drop an entry's buffers from the catalog, on every tier."""
    ids, e.buffer_ids = e.buffer_ids, None
    if ids and dm is not None:
        for bid in ids:
            dm.catalog.remove(bid)


def _finalize_entries(entries: List[CachedData]) -> None:
    """The session's finalizer: free the cached buffers of a session
    dropped without ``clear_cache()``. It holds only the entries list."""
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    for e in list(entries):
        _release_entry(e, DeviceManager.peek())
    del entries[:]


class CacheManager:
    """A session's registry of cached plans (Spark's CacheManager)."""

    def __init__(self, session):
        self.session = session
        self._entries: List[CachedData] = []
        self._registry_lock = threading.Lock()
        # fires when the session is collected; the entries list is
        # identity-stable (clear() empties it in place)
        self._finalizer = weakref.finalize(session, _finalize_entries,
                                           self._entries)

    # ---- registration -----------------------------------------------------
    def add(self, logical: lp.LogicalPlan) -> CachedData:
        with self._registry_lock:
            e = self._lookup_locked(logical)
            if e is None:
                e = CachedData(logical)
                self._entries.append(e)
            return e

    def _lookup_locked(self, logical) -> Optional[CachedData]:
        for e in self._entries:
            if same_plan(e.logical, logical):
                return e
        return None

    def lookup(self, logical: lp.LogicalPlan) -> Optional[CachedData]:
        with self._registry_lock:
            return self._lookup_locked(logical)

    def remove(self, logical: lp.LogicalPlan) -> None:
        with self._registry_lock:
            e = self._lookup_locked(logical)
            if e is not None:
                self._entries.remove(e)
        if e is not None:
            self._free(e)

    def clear(self) -> None:
        with self._registry_lock:
            entries = list(self._entries)
            del self._entries[:]    # in place: the finalizer holds this list
        for e in entries:
            self._free(e)

    def _free(self, e: CachedData) -> None:
        # serialized with a materialization in flight on the entry's lock,
        # so no buffer it registers is left behind
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        with e.lock:
            e.dropped = True
            if e.buffer_ids:
                _release_entry(e, DeviceManager.peek())

    # ---- planning-time substitution ---------------------------------------
    def substitute(self, logical: lp.LogicalPlan,
                   skip: Optional[CachedData] = None,
                   used: Optional[List[CachedData]] = None) -> lp.LogicalPlan:
        """Every subtree equal to a cached plan replaced by a
        CachedRelation, top-down (the largest cached subtree wins).
        ``skip`` keeps the entry being materialized from matching itself.
        Materializes nothing."""
        with self._registry_lock:
            entries = list(self._entries)
        if not entries:
            return logical

        def walk(node: lp.LogicalPlan) -> lp.LogicalPlan:
            for e in entries:
                if e is not skip and same_plan(e.logical, node):
                    if used is not None and e not in used:
                        used.append(e)
                    return lp.CachedRelation(e)
            return _map_logical_children(node, walk)

        return walk(logical)

    def prepare(self, logical: lp.LogicalPlan) -> lp.LogicalPlan:
        """Substitute the cached subtrees and materialize the entries an
        action is about to scan. Entries whose buffers vanished (the
        DeviceManager was rebuilt between actions) are materialized again,
        as Spark recomputes lost cached partitions."""
        if not self._entries:
            return logical
        used: List[CachedData] = []
        out = self.substitute(logical, used=used)
        for e in used:
            self._ensure_materialized(e)
        return out

    # ---- materialization --------------------------------------------------
    def _ensure_materialized(self, e: CachedData) -> None:
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        # the entry's lock is also its in-flight latch: queries sharing one
        # cached subtree serialize here and one materializes it
        with e.lock:
            if e.dropped:
                raise RuntimeError(
                    "cached DataFrame was unpersisted while a query using "
                    "it was being planned; re-run the action")
            if e.buffer_ids is not None:
                dm = DeviceManager.peek()
                live = set(dm.catalog.ids()) if dm is not None else set()
                if all(bid in live for bid in e.buffer_ids):
                    return
                e.buffer_ids = None     # lost with the manager: recompute
            self._materialize(e)

    def _materialize(self, e: CachedData) -> None:
        from spark_rapids_tpu_torch.execs.base import ExecContext
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        from spark_rapids_tpu_torch.memory.store import CACHE_BUFFER_PRIORITY
        from spark_rapids_tpu_torch.plan.planner import plan_physical
        sess = self.session
        # nested caches compose: materialize with every other entry in
        inner: List[CachedData] = []
        logical = self.substitute(e.logical, skip=e, used=inner)
        for dep in inner:
            self._ensure_materialized(dep)
        from spark_rapids_tpu_torch.execs.tpu_execs import device_root
        final = plan_physical(logical, sess.conf, sess.device)
        # the device batches under the download transition go to the store
        # (a plan on the CPU engine uploads its result)
        root = device_root(final)
        dm = DeviceManager.initialize(sess.conf, sess.device)
        batches, cleanups = [], []
        try:
            with dm.semaphore.held():
                for p in range(final.num_partitions):
                    ctx = ExecContext(sess.conf, sess.device, p,
                                      final.num_partitions, dm, cleanups)
                    batches.extend(root.execute(ctx))
        finally:
            for fn in cleanups:
                fn()
        ids: List[BufferId] = []
        try:
            for i, batch in enumerate(batches):
                bid = BufferId(e.table_id, i)
                dm.device_store.add_batch(bid, batch, CACHE_BUFFER_PRIORITY)
                ids.append(bid)
        except Exception:
            for bid in ids:
                dm.catalog.remove(bid)
            raise
        e.buffer_ids = ids
