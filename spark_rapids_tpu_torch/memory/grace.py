"""Out-of-core grace partitioning for the working-set operators (hash
aggregate, hash joins, sort): the JAX package's ``memory/grace.py`` in
eager PyTorch.

The model
---------

``TpuHashAggregateExec``, ``TpuShuffledHashJoinExec`` (and its broadcast
subclass) and ``TpuSortExec`` concatenate their whole input before one
single pass. ``GraceController`` wraps their input staging:

- **predicted**: the planner's footprint contract (plan/footprint.py)
  annotated ``grace_partitions`` on the node: partition up front;
- **reactive**: while staging, the controller holds the accumulated
  working-set estimate (``working_set_factor`` times the staged bytes)
  against the free device budget, listens to the device store's pressure
  callbacks (a concurrent query forcing spills flips this operator too) and
  runs the deterministic fault probes (memory/faults.py). Any trigger
  switches to the partitioned path mid-stream;
- **partitioned**: every input batch is split on the device by key (a
  depth-salted hash of the grouping or join keys, or sampled range bounds
  over the sort keys) into ``SpillablePartitions``, whose pieces are
  spillable buffers in the device -> host -> disk store; the operator then
  runs once per partition, re-partitioning with a deeper hash when a
  partition still exceeds the budget, bounded by
  ``memory.outOfCore.maxRecursionDepth``.

With ample budget and no pressure the staged batches are handed back as
they came (``inline``): the single pass runs on them as it does with
out of core off.

Correctness: hash partitioning keeps every key group (aggregate groups, the
rows of a join key, null-key outer rows) inside one partition, so the
per-partition results union to the global result; range partitioning keeps
order and ties share a partition, so emitting the partitions in bound order
reproduces the stable single-pass sort bit for bit. ``split_by_pid`` is
stable, so a group's rows keep their input order inside a partition.

Differences from the JAX package, by design: its split carries each
column's float64 bits sibling and dictionary encoding through the reorder
as extra payload columns (``_extended_form``, ``_rebuild_piece``); the
port's float64 is native and it has no encoded domain yet, so its split
moves the columns as they are. The JAX package skips a mesh-sharded
placement; the port runs on one device. Its metrics registry and trace
instants become the plain counters of ``COUNTERS`` and each operator's
``grace_stats``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.memory.buffer import BufferId
from spark_rapids_tpu_torch.memory.faults import plan_for_conf
from spark_rapids_tpu_torch.memory.store import GRACE_PARTITION_PRIORITY
from spark_rapids_tpu_torch.utils import metrics as um

#: table-id namespace for grace partition buffers, apart from the shuffle
#: catalog's (from 1 << 20) and the DataFrame cache's (1 << 28)
_GRACE_IDS = itertools.count(1 << 29)

#: per-batch sample rows contributed toward range bounds (sort path)
_SORT_SAMPLE_ROWS = 512

#: process-wide counters of the degraded path (the JAX package's memory
#: metrics): pressure events, grace partitions made, deepest recursion level
COUNTERS = {"pressure_events": 0, "spill_partitions": 0,
            "recursion_depth_peak": 0}
_COUNTERS_LOCK = threading.Lock()


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        for k in COUNTERS:
            COUNTERS[k] = 0


def counters() -> dict:
    with _COUNTERS_LOCK:
        return dict(COUNTERS)


def _count(key: str, value: int, peak: bool = False) -> None:
    with _COUNTERS_LOCK:
        COUNTERS[key] = (max(COUNTERS[key], value) if peak
                         else COUNTERS[key] + value)
    # the depth also on the action's scope and the running query's handle
    # (the other two events are bumped in the memory section at their
    # sites)
    if key == "recursion_depth_peak":
        from spark_rapids_tpu_torch.serving.lifecycle import current_query
        um.note_recursion_depth(value, current_query())


def _depth_seed(depth: int) -> int:
    """Hash seed for one recursion level: every level mixes with a
    different seed, so key groups colliding mod n at level d spread at
    level d + 1 (identical keys still collocate; the depth bound ends a
    single oversized key group)."""
    return (0x9E3779B9 * (depth + 1)) & 0xFFFFFFFF


def _consume(staged: List[DeviceBatch]) -> Iterator[DeviceBatch]:
    """The staged batches in order, each dropped from the list as it is
    handed out, so a batch already split is not kept alive by the list."""
    while staged:
        yield staged.pop(0)


def device_store_of(ctx) -> Optional[object]:
    """The device store backing this execution, without making a
    DeviceManager (a bare ExecContext stays store-less, so inline-only)."""
    dm = ctx.device_manager
    if dm is None:
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        dm = DeviceManager.peek()
    return dm.device_store if dm is not None else None


class SpillablePartitions:
    """N spillable partition slots. ``add`` registers each piece in the
    device store (budget-enforced admission: over-budget pieces cascade
    down the host and disk tiers); ``take`` materializes one partition back
    (device pieces as they are, spilled ones uploaded again) and frees its
    buffers as they are consumed, so recursion has room. ``close`` drops
    what was not consumed."""

    def __init__(self, store, catalog, n: int, depth: int):
        self.store = store
        self.catalog = catalog
        self.n = n
        self.depth = depth
        self._tids = [next(_GRACE_IDS) for _ in range(n)]
        self._seqs = [0] * n
        self._ids: List[List[BufferId]] = [[] for _ in range(n)]
        self._bytes = [0] * n
        self._fallback: List[List[DeviceBatch]] = [[] for _ in range(n)]

    def add(self, pid: int, piece: DeviceBatch) -> None:
        if self.store is None:          # forced partitioning without a store
            self._fallback[pid].append(piece)
            self._bytes[pid] += piece.device_size_bytes
            return
        bid = BufferId(self._tids[pid], self._seqs[pid])
        self._seqs[pid] += 1
        # earlier partitions are consumed first: keep them warmest, so the
        # spill queue pushes the later ones down the tiers first
        prio = GRACE_PARTITION_PRIORITY + (self.n - pid) / max(self.n, 1)
        buf = self.store.add_batch(bid, piece, prio)
        self._ids[pid].append(bid)
        self._bytes[pid] += buf.size_bytes

    def bytes_of(self, pid: int) -> int:
        return self._bytes[pid]

    def nonempty(self) -> List[int]:
        return [pid for pid in range(self.n)
                if self._ids[pid] or self._fallback[pid]]

    @property
    def degenerate(self) -> bool:
        """A recursive split that landed everything in one partition: the
        keys are indivisible (one giant key group, which every depth's
        salt hashes alike), so deeper recursion cannot help and the
        consumer runs it in one pass."""
        return self.depth > 0 and len(self.nonempty()) <= 1

    def drain(self, pid: int) -> Iterator[DeviceBatch]:
        """Partition ``pid``'s batches one at a time in insertion order
        (each group's row order kept, which keeps per-group float sums
        equal to the single pass), each buffer released before the next
        one materializes. An abandoned generator leaves the tail
        registered, so ``close`` still releases it."""
        if self.store is None:
            while self._fallback[pid]:
                yield self._fallback[pid].pop(0)
            return
        while self._ids[pid]:
            bid = self._ids[pid].pop(0)
            buf = self.catalog.acquire(bid)
            if buf is None:
                continue
            try:
                batch = buf.get_batch()
            finally:
                buf.close()
            self.catalog.remove(bid)
            yield batch

    def take(self, pid: int) -> List[DeviceBatch]:
        """Materialize partition ``pid`` whole and release its buffers."""
        return list(self.drain(pid))

    def close(self) -> None:
        """Release every unconsumed buffer (the error path)."""
        for pid in range(self.n):
            ids, self._ids[pid] = self._ids[pid], []
            for bid in ids:
                self.catalog.remove(bid)
            self._fallback[pid] = []


def _note(exec_node, key: str, value, peak: bool = False) -> None:
    """Per-operator record of the degraded path, read by chip_smoke.py:
    ``grace_stats`` = {"trigger": forced | predicted | reactive,
    "sized_by": force | observed | hint | fanout, "splits": top-level
    splits (one per input side of each stream partition that went out of
    core), "fanout": partitions per top-level split, "partitions": made in
    all, at every depth, "depth": deepest level reached}."""
    stats = exec_node.__dict__.setdefault("grace_stats", {})
    if peak:
        stats[key] = max(stats.get(key, 0), value)
    elif isinstance(value, int) and not isinstance(value, bool):
        stats[key] = stats.get(key, 0) + value
    else:
        stats[key] = value


class GraceController:
    """The out-of-core control of one operator's ``execute``, made by
    ``controller_for``: ``stage``/``stage_two`` watch the input for
    pressure, ``partition`` splits batches into SpillablePartitions and
    ``should_recurse`` bounds the recursion."""

    def __init__(self, exec_node, ctx, kind: str):
        self.exec = exec_node
        self.ctx = ctx
        self.kind = kind                # "agg" | "join" | "sort"
        conf = ctx.conf
        self.fanout = conf.get(cfg.OOC_FANOUT)
        self.max_partitions = conf.get(cfg.OOC_MAX_PARTITIONS)
        self.max_depth = conf.get(cfg.OOC_MAX_DEPTH)
        self.headroom = conf.get(cfg.OOC_HEADROOM)
        self.force = conf.get(cfg.OOC_FORCE_PARTITIONS)
        self.hint = int(getattr(exec_node, "grace_partitions", 0) or 0)
        self.faults = plan_for_conf(conf)
        self.factor = float(getattr(exec_node, "working_set_factor", 3.0))
        self.store = device_store_of(ctx)
        self.catalog = self.store.catalog if self.store is not None else None
        self._pressure = threading.Event()
        self.triggered = False

    # ---- pressure model ---------------------------------------------------
    def threshold_bytes(self, subtract_used: bool = True) -> Optional[int]:
        """Device budget this operator's working set may use, after the
        fault plan's clamp and the headroom fraction; None = unbounded (no
        store or no budget). While staging, the store's current occupancy
        is subtracted; the recursion check skips that, since by then this
        operator's own partitions fill the store."""
        if self.store is None or self.store.budget_bytes is None:
            return None
        budget = self.faults.clamp_budget(self.kind, self.store.budget_bytes)
        if subtract_used:
            budget = max(budget - self.store.used_bytes, 0)
        return int(budget * self.headroom)

    def _over_budget(self, staged_bytes: int,
                     subtract_used: bool = True) -> bool:
        limit = self.threshold_bytes(subtract_used)
        return limit is not None and staged_bytes * self.factor > limit

    def _initial_partitions(self) -> int:
        """Fanout priority: the force conf, then the observed working set
        when the operator's shuffle inputs have run, then the plan-time
        hint, then the configured default."""
        if self.force:
            _note(self.exec, "sized_by", "force")
            return max(2, min(self.force, self.max_partitions))
        obs = self._observed_partitions()
        if obs is not None:
            _note(self.exec, "sized_by", "observed")
            return obs
        if self.hint:
            _note(self.exec, "sized_by", "hint")
            return max(2, min(self.hint, self.max_partitions))
        _note(self.exec, "sized_by", "fanout")
        return max(2, min(self.fanout, self.max_partitions))

    def _observed_partitions(self) -> Optional[int]:
        """Partition count from the observed StageStats of the operator's
        inputs against the same budget ``choose_partitions`` uses at plan
        time; None when an input stage has not run or there is no
        budget."""
        if self.store is None or self.store.budget_bytes is None:
            return None
        from spark_rapids_tpu_torch.plan.footprint import (
            choose_partitions, observed_input_bytes)
        obs = observed_input_bytes(self.exec, self.ctx.partition_id)
        if obs is None:
            return None
        budget = self.faults.clamp_budget(self.kind, self.store.budget_bytes)
        return choose_partitions(int(obs * self.factor), budget,
                                 self.ctx.conf)

    def _observed_fits(self) -> bool:
        """True when this partition's observed working set fits the budget
        with ``choose_partitions``' 2x slack: observed statistics then
        overrule a stale plan-time hint and the monitored staging loop
        runs."""
        limit = self.threshold_bytes()
        if limit is None:
            return False
        from spark_rapids_tpu_torch.plan.footprint import observed_input_bytes
        obs = observed_input_bytes(self.exec, self.ctx.partition_id)
        return obs is not None and 2 * int(obs * self.factor) <= limit

    def _record_pressure(self) -> None:
        _count("pressure_events", 1)
        um.MEMORY_METRICS[um.MEM_PRESSURE_EVENTS].add(1)
        self.triggered = True
        _note(self.exec, "trigger", "reactive")

    # ---- staging ----------------------------------------------------------
    def stage(self, source: Iterator[DeviceBatch], key_exprs,
              orders=None) -> Tuple[str, object]:
        """Drive the operator's input: ``("inline", [batches])`` when
        everything stayed under budget (the caller runs its single pass),
        or ``("partitioned", parts)`` after a plan hint, the force conf or
        pressure flipped to the grace path."""
        if self.force:
            _note(self.exec, "trigger", "forced")
            return self._partition_or_inline([], source, key_exprs, orders)
        if self.hint:
            # prime one batch (an upstream exchange runs its whole map side
            # at the first next()), then let observed statistics overrule
            # the hint when this partition's real input fits
            first = next(iter(source), None)
            primed = [] if first is None else [first]
            if not self._observed_fits():
                _note(self.exec, "trigger", "predicted")
                return self._partition_or_inline(primed, source, key_exprs,
                                                 orders)
            source = itertools.chain(primed, source)
        staged: List[DeviceBatch] = []
        total = 0
        triggered = False
        with self._pressure_listener():
            for batch in source:
                staged.append(batch)
                total += batch.device_size_bytes
                if self._admission_pressure(total):
                    triggered = True
                    break
        # partitioning happens outside the listener: this operator's own
        # partition admissions spill by design
        if triggered:
            self._record_pressure()
            return self._partition_or_inline(staged, source, key_exprs,
                                             orders)
        return "inline", staged

    def _partition_or_inline(self, staged, source, key_exprs, orders
                             ) -> Tuple[str, object]:
        """Partition staged + remaining batches, streaming. A None from the
        sort path means the whole stream had no live rows: inline on the
        (all-empty) staged list, so the operator emits its empty shape."""
        if not staged and not self.force:
            # prime one batch before sizing the fanout, so the observed
            # statistics see the input's real bytes
            first = next(iter(source), None)
            if first is not None:
                staged = [first]
        n = self._initial_partitions()
        parts = self.partition(itertools.chain(_consume(staged), source),
                               key_exprs, depth=0, orders=orders, n=n)
        if parts is None:                   # no live rows anywhere
            return "inline", staged
        return "partitioned", parts

    def stage_two(self, left: Iterator[DeviceBatch],
                  right: Iterator[DeviceBatch], left_keys, right_keys
                  ) -> Tuple[str, object]:
        """Two-sided staging for the join: the working set is both sides,
        so pressure while staging either side partitions both (same n,
        same depth salt: matching keys land in matching partitions)."""
        if self.force or self.hint:
            if not self.force:
                # prime one batch per side before sizing the fanout, so
                # both input stages have run (see stage())
                b = next(iter(left), None)
                left = itertools.chain([] if b is None else [b], left)
                b = next(iter(right), None)
                right = itertools.chain([] if b is None else [b], right)
            if self.force or not self._observed_fits():
                _note(self.exec, "trigger",
                      "forced" if self.force else "predicted")
                n = self._initial_partitions()
                lp = self.partition(left, left_keys, depth=0, n=n)
                rp = self.partition(right, right_keys, depth=0, n=n)
                return "partitioned", (lp, rp)
            # observed statistics overruled the hint: the monitored
            # staging loop below still partitions under pressure
        staged_l: List[DeviceBatch] = []
        staged_r: List[DeviceBatch] = []
        total = 0
        triggered = False
        with self._pressure_listener():
            for staged, source in ((staged_l, left), (staged_r, right)):
                for batch in source:
                    staged.append(batch)
                    total += batch.device_size_bytes
                    if self._admission_pressure(total):
                        triggered = True
                        break
                if triggered:
                    break
        if triggered:
            # partitioning outside the listener (see stage()); the fanout is
            # sized here, where the inputs have materialized
            self._record_pressure()
            n = self._initial_partitions()
            lp = self.partition(itertools.chain(_consume(staged_l), left),
                                left_keys, depth=0, n=n)
            rp = self.partition(itertools.chain(_consume(staged_r), right),
                                right_keys, depth=0, n=n)
            return "partitioned", (lp, rp)
        return "inline", (staged_l, staged_r)

    def _admission_pressure(self, staged_bytes: int) -> bool:
        """One countable admission check per staged batch: the fault probe
        first, then the store's pressure flag, then the working-set
        estimate (host arithmetic, no device sync)."""
        if self.faults.on_admission(self.kind):
            return True
        if self._pressure.is_set():
            return True
        return self._over_budget(staged_bytes)

    @contextlib.contextmanager
    def _pressure_listener(self):
        """Subscribed to the device store's pressure while staging, removed
        before partitioning."""
        store = self.store
        if store is None or not hasattr(store, "add_pressure_listener"):
            yield
            return
        fn = lambda _bytes: self._pressure.set()  # noqa: E731
        store.add_pressure_listener(fn)
        try:
            yield
        finally:
            store.remove_pressure_listener(fn)

    # ---- recursion --------------------------------------------------------
    def should_recurse(self, partition_bytes: int, depth: int) -> bool:
        if depth + 1 >= self.max_depth:
            return False
        return self._over_budget(partition_bytes, subtract_used=False)

    # ---- partitioning -----------------------------------------------------
    #: non-empty batches the sort path pulls ahead to sample range bounds
    #: from (the rest of the stream splits batch by batch; a skewed tail
    #: re-partitions on its own bounds at the next depth)
    _SORT_SAMPLE_BATCHES = 8

    def partition(self, batches: Iterator[DeviceBatch], key_exprs,
                  depth: int, orders=None, n: Optional[int] = None
                  ) -> Optional["SpillablePartitions"]:
        """Split a batch stream into n spillable partitions: by the
        depth-salted hash of ``key_exprs``, or by sampled range bounds over
        ``orders`` for the sort. Batches split as they arrive. Returns None
        when the whole stream had no live rows."""
        n = n or max(2, min(self.fanout, self.max_partitions))
        bounds = None
        if orders is not None:
            batches = iter(batches)
            head: List[DeviceBatch] = []
            for batch in batches:
                head.append(batch)
                live = sum(1 for b in head if b.num_rows > 0)
                if live >= self._SORT_SAMPLE_BATCHES:
                    break
            bounds = _sample_range_bounds(self.ctx, head, orders, n)
            if bounds is None:
                return None         # nothing live anywhere in the stream
            batches = itertools.chain(_consume(head), batches)
        parts = SpillablePartitions(self.store, self.catalog, n, depth)
        _count("spill_partitions", n)
        um.MEMORY_METRICS[um.MEM_SPILL_PARTITIONS].add(n)
        _count("recursion_depth_peak", depth + 1, peak=True)
        _note(self.exec, "partitions", n)
        _note(self.exec, "depth", depth + 1, peak=True)
        if depth == 0:
            _note(self.exec, "splits", 1)
            _note(self.exec, "fanout", n, peak=True)
        try:
            for batch in batches:
                if batch.num_rows == 0:
                    continue
                for pid, piece in split_batch(self.ctx, batch, key_exprs,
                                              n, depth, orders=orders,
                                              bounds=bounds):
                    parts.add(pid, piece)
                # split: let it go before the next batch is made
                batch = piece = None
        except BaseException:
            parts.close()
            raise
        return parts


def controller_for(exec_node, ctx, kind: str, key_exprs,
                   orders=None) -> Optional[GraceController]:
    """A GraceController when this operator can go out of core here, else
    None (the caller keeps its single pass):

    - ``memory.outOfCore.enabled`` is on and the operator runs on the
      device (the CPU engine keeps its working set in host memory);
    - a hash kind has at least one key (a keyless operator cannot split by
      key) and every key is deterministic (partitioning evaluates the keys
      once for routing and the operator again);
    - there is a spillable store to partition into, unless a plan hint or
      the force conf asked for partitioning outright.
    """
    if not ctx.conf.get(cfg.OOC_ENABLED) or ctx.host_engine:
        # the CPU engine keeps its working set in host memory
        return None
    exprs = tuple(key_exprs or ())
    if orders is not None:
        exprs = tuple(o.child for o in orders)
    if not exprs:
        return None
    from spark_rapids_tpu_torch.plan.overrides import _has_nondeterministic
    if any(_has_nondeterministic(e) for e in exprs):
        return None
    c = GraceController(exec_node, ctx, kind)
    if c.store is None and not (c.force or c.hint):
        return None
    return c


# ---------------------------------------------------------------- the split
def split_batch(ctx, batch: DeviceBatch, key_exprs, n: int, depth: int,
                orders=None, bounds=None
                ) -> Iterator[Tuple[int, DeviceBatch]]:
    """The partition ids (the depth-salted hash of the keys, or the range
    bounds over the sort orders), the stable partition-major row order with
    the per-partition counts (``pid_order``, the order ``split_by_pid``
    reorders by), then one gather per non-empty partition. The stable
    order keeps each partition's rows in input order, which keeps
    per-group float sums and the external sort bit-identical to the single
    pass. The pieces equal the JAX package's slices of its reordered batch;
    gathered one at a time, no reordered copy of the whole batch is made,
    so the split holds the batch and one piece beside the pieces already
    given to the store."""
    from spark_rapids_tpu_torch.columnar.dtypes import bucket_capacity
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        hash_partition_ids, pid_order, range_partition_ids)
    from spark_rapids_tpu_torch.execs.tpu_execs import batch_of, eval_ctx
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    cap = batch.capacity
    ectx = eval_ctx(batch, ctx)
    if orders is not None:
        row_keys = [bk.as_column(o.child.eval(ectx), cap) for o in orders]
        pids = range_partition_ids(orders, row_keys, bounds)
    else:
        keys = [e.eval(ectx) for e in key_exprs]
        pids = hash_partition_ids(keys, cap, n, seed=_depth_seed(depth))
    # the degraded path's one host read per batch: the partition sizes
    order, counts = pid_order(pids, batch.num_rows, n)
    del pids, ectx
    start = 0
    for j, cnt in enumerate(counts):
        if cnt:
            rows = order[start:start + cnt]
            yield j, batch_of(batch.schema, [
                bk.take_padded(ColV(c.dtype, c.data, c.validity, c.lengths),
                               rows, bucket_capacity(cnt))
                for c in batch.columns], cnt)
        start += cnt


def _sample_range_bounds(ctx, batches: Sequence[DeviceBatch], orders,
                         n: int) -> Optional[List[ColV]]:
    """Range bounds for the external sort: an evenly spaced sample of each
    batch's order keys, gathered on the device (as the range exchange's
    ``_device_bounds``); only the sampled rows reach the host, and the
    merged sample's quantiles become the n - 1 bounds."""
    from spark_rapids_tpu_torch.execs.exchange_execs import (_sample_bounds,
                                                             _sample_rows)
    from spark_rapids_tpu_torch.execs.tpu_execs import eval_ctx
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    live = [b for b in batches if b.num_rows > 0]
    if not live:
        return None
    per = max(1, min(_SORT_SAMPLE_ROWS, 4096 // len(live)))
    sampled = []
    for db in live:
        ectx = eval_ctx(db, ctx)
        keys = [bk.as_column(o.child.eval(ectx), db.capacity)
                for o in orders]
        sampled.append([ColV(v.dtype, v.data.cpu(), v.validity.cpu(),
                             None if v.lengths is None else v.lengths.cpu())
                        for v in _sample_rows(keys, db.num_rows, per)])
    bounds = _sample_bounds(orders, sampled, n)
    if bounds is None:
        return None
    device = live[0].device
    return [ColV(v.dtype, v.data.to(device), v.validity.to(device),
                 None if v.lengths is None else v.lengths.to(device))
            for v in bounds]
