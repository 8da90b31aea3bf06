"""Adaptive query execution (the JAX package's ``plan/adaptive.py``;
reference: GpuCustomShuffleReaderExec, GpuQueryStagePrepOverrides and
GpuTransitionOverrides.optimizeAdaptiveTransitions).

Spark's adaptive execution runs the shuffle map stages, reads their
MapOutputStatistics and re-plans the rest of the query. The port does the
same with in-process stages: every exchange's map side runs first (its
output stays in the spillable shuffle catalog, or in memory on the CPU
engine), then the plan above it is rewritten with the observed
``StageStats`` (execs/exchange_execs.py: exact rows per reduce partition
and per (map, reduce) pair, KMV distinct sketches):

- **partition coalescing**: contiguous small reduce partitions are grouped
  to the advisory size and read through a custom shuffle reader; a device
  reader over a hash or round-robin exchange gets a TpuCoalesceBatchesExec
  above it, so the operators downstream see few large batches;
- **dynamic broadcast join**: a shuffled hash join whose finished
  build-side shuffle came out under the broadcast threshold becomes a
  broadcast hash join reading all of that shuffle's output once;
- **skew-split joins**: a reduce partition larger than
  skewedPartitionFactor x the median splits into map-id slices; the split
  side reads each slice as its own join partition and the other side
  reads the matching whole partition once per slice, so every matching
  pair of rows still meets exactly once;
- **skew-repartitioned aggregates**: an aggregate cannot split on the map
  axis (a group would aggregate twice), so a skewed aggregate input raises
  the operator's grace-partition hint instead (memory/grace.py);
- **re-fusion**: the rewrite creates fusible device chains (a lone filter
  above a coalesced reader), so the fusion pass runs again;
- **cost-based placement**: with the cost model on, a shuffled join whose
  observed input rows are under costModel.minDeviceRows moves to the CPU
  engine (download, CpuHashJoinExec, upload).

Every decision sets ``adaptive_tag`` on the rewritten node, shown as
``[adaptive: …]`` by ``tree_string``, and adds to its counter in
``utils/metrics.ADAPTIVE_METRICS``, as in the JAX package; ``counters()``
reads the four of them.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple, Union

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec, _row_width
from spark_rapids_tpu_torch.execs.exchange_execs import (
    CpuBroadcastExchangeExec, CpuShuffleExchangeExec, HashPartitioning,
    RoundRobinPartitioning, ShuffleExchangeExecBase, SinglePartitioning,
    TpuBroadcastExchangeExec)
from spark_rapids_tpu_torch.utils import metrics as um

# ------------------------------------------------------------------ counters
#: counter key -> its name in the adaptive section of utils/metrics.py,
#: where the decisions are counted (``session.last_metrics["adaptive"]``)
_METRIC = {"skew_splits": um.ADAPTIVE_SKEW_SPLITS,
           "coalesced_partitions": um.ADAPTIVE_COALESCED_PARTITIONS,
           "broadcast_switches": um.ADAPTIVE_BROADCAST_SWITCHES,
           "refused_stages": um.ADAPTIVE_REFUSED_STAGES}


def reset_counters() -> None:
    for name in _METRIC.values():
        um.ADAPTIVE_METRICS[name].reset()


def counters() -> dict:
    """Decisions since the last reset: skew splits (join partitions split
    plus skewed aggregate partitions), reduce partitions coalesced away,
    broadcast switches and re-fused stages."""
    snap = um.ADAPTIVE_METRICS.snapshot()
    return {key: snap[name] for key, name in _METRIC.items()}


def _is_exchange(node: PhysicalExec) -> bool:
    """A shuffle exchange of either engine (the CPU engine's serves the
    statistics from its host form)."""
    return isinstance(node, (ShuffleExchangeExecBase, CpuShuffleExchangeExec))


# ------------------------------------------------------------------ readers
@dataclass(frozen=True)
class PartialReducerSpec:
    """One map-id slice of a reduce partition (Spark's
    PartialReducerPartitionSpec): reduce partition ``pid`` restricted to
    the output of map tasks ``map_ids``. The slices of one partition are
    disjoint and cover it, so a side split this way still reads every row
    once."""
    pid: int
    slice_index: int
    num_slices: int
    map_ids: Tuple[int, ...]

    def __str__(self) -> str:
        return f"p{self.pid}[{self.slice_index + 1}/{self.num_slices}]"


#: one consumer partition's read set: whole reduce partitions (ints, several
#: when coalesced) or a single map-id slice of one
ReaderSpec = Tuple[Union[int, PartialReducerSpec], ...]


class CustomShuffleReaderExecBase(PhysicalExec):
    """Reads a subset or grouping of an executed exchange's reduce
    partitions: ``specs[i]`` is what consumer partition i reads, exchange
    partition ids (coalesced groups; the all-partition single spec is the
    broadcast build's) or PartialReducerSpec slices (the skew split)."""

    #: set by the skew split on both join inputs: their specs are index
    #: aligned, so the join runs partition-wise and _restore_requirements
    #: must not put single-partition exchanges under it
    aligned_pairwise: bool = False

    def __init__(self, exchange: PhysicalExec,
                 specs: Tuple[ReaderSpec, ...]):
        super().__init__((exchange,), exchange.output)
        self.specs = specs

    def size_estimate(self) -> Optional[int]:
        exchange = self.children[0]
        if exchange.stage_stats() is None:
            # before the stage ran, the exchange's estimate bounds any subset
            return exchange.size_estimate()
        # observed: exactly the partitions (or map slices) the specs cover
        return sum(self.observed_spec_bytes(i) for i in range(len(self.specs)))

    def observed_spec_bytes(self, i: int) -> int:
        """Observed bytes consumer partition ``i`` reads; the exchange's
        stage must have run."""
        exchange = self.children[0]
        stats = exchange.stage_stats()
        rows = 0
        for entry in self.specs[i]:
            if isinstance(entry, PartialReducerSpec):
                rows += sum(exchange._map_part_rows.get((m, entry.pid), 0)
                            for m in entry.map_ids)
            else:
                rows += stats.partition_rows[entry]
        return rows * _row_width(self.output)

    @property
    def num_partitions(self) -> int:
        return len(self.specs)

    def execute(self, ctx: ExecContext) -> Iterator:
        exchange = self.children[0]
        if ctx.partition_id >= len(self.specs):
            # a partition this reader does not have is empty, as for every
            # other operator: a union runs each branch over the widest
            # branch's partitions, and coalescing narrows one branch (the
            # JAX package's reader raises IndexError here)
            return
        for entry in self.specs[ctx.partition_id]:
            pid = entry.pid if isinstance(entry, PartialReducerSpec) else entry
            # for_partition keeps the engine: a CPU reader stays on the
            # host, a device reader on the session's device
            sub = ctx.for_partition(pid, exchange.num_partitions)
            if isinstance(entry, PartialReducerSpec):
                yield from exchange.execute_partial(sub, entry.map_ids)
            else:
                yield from exchange.execute(sub)


class CpuCustomShuffleReaderExec(CustomShuffleReaderExecBase):
    """The reader over a CPU engine exchange: it yields what the exchange
    yields for its context (host batches, or CPU batches inside the
    engine)."""

    is_device = False


class TpuCustomShuffleReaderExec(CustomShuffleReaderExecBase):
    pass


def _reader_for(exchange: PhysicalExec,
                specs: Tuple[ReaderSpec, ...]) -> CustomShuffleReaderExecBase:
    cls = (TpuCustomShuffleReaderExec if exchange.is_device
           else CpuCustomShuffleReaderExec)
    return cls(exchange, specs)


def coalesce_specs(sizes: List[int], target: int
                   ) -> Tuple[Tuple[int, ...], ...]:
    """Group contiguous reduce partitions until each group reaches the
    advisory size (Spark's coalesceShufflePartitions)."""
    specs: List[Tuple[int, ...]] = []
    group: List[int] = []
    acc = 0
    for pid, sz in enumerate(sizes):
        group.append(pid)
        acc += sz
        if acc >= target:
            specs.append(tuple(group))
            group, acc = [], 0
    if group:
        specs.append(tuple(group))
    return tuple(specs) if specs else ((),)


def _expr_fingerprint(e):
    """Structural identity of an expression tree (its type and every
    dataclass field, expressions recursively): two hash partitionings send
    a key value to the same reduce partition exactly when their key
    expressions are structurally identical."""
    from spark_rapids_tpu_torch.exprs.core import Expression
    if not dataclasses.is_dataclass(e):
        return repr(e)
    out: list = [type(e).__name__]
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expression):
            out.append((f.name, _expr_fingerprint(v)))
        elif isinstance(v, tuple):
            out.append((f.name, tuple(
                _expr_fingerprint(x) if isinstance(x, Expression) else repr(x)
                for x in v)))
        else:
            out.append((f.name, repr(v)))
    return tuple(out)


# ------------------------------------------------------------------ the rewrite
def adaptive_rewrite(plan: PhysicalExec, ctx: ExecContext) -> PhysicalExec:
    """Run every shuffle map stage, then re-plan the tree above it with the
    observed statistics. Returns the rewritten plan, which reads the
    executed stages' outputs instead of computing them again."""
    from spark_rapids_tpu_torch.execs import cpu_execs as ce
    from spark_rapids_tpu_torch.execs import tpu_execs as te
    from spark_rapids_tpu_torch.execs.join_execs import (
        CpuHashJoinExec, TpuShuffledHashJoinExec)
    conf = ctx.conf
    threshold = conf.get(cfg.BROADCAST_JOIN_THRESHOLD)
    target = conf.get(cfg.ADAPTIVE_ADVISORY_PARTITION_BYTES)

    def stats(node: PhysicalExec) -> Optional[List[int]]:
        if _is_exchange(node):
            return node.map_output_stats(ctx)
        return None

    def coalesced_child(c: PhysicalExec,
                        specs: Tuple[ReaderSpec, ...]) -> PhysicalExec:
        reader = _reader_for(c, specs)
        tag = f"coalesced {c.num_partitions}→{len(specs)}"
        st = c.stage_stats()
        if st is not None:
            tag += f" rows={st.total_rows}"
            est = c.size_estimate()
            if est is not None:
                tag += f" est~{est // max(_row_width(c.output), 1)}"
        reader.adaptive_tag = tag
        um.ADAPTIVE_METRICS[um.ADAPTIVE_COALESCED_PARTITIONS].add(
            c.num_partitions - len(specs))
        if c.is_device and isinstance(c.partitioning, (HashPartitioning,
                                                       RoundRobinPartitioning)):
            # GpuCoalesceBatches after a shuffle: the group's fragments
            # concatenate toward the advisory size, and re-fusion below
            # gets a device chain to fuse with what sits above the reader
            return te.TpuCoalesceBatchesExec(reader, target_bytes=target)
        return reader

    def fix(node: PhysicalExec) -> PhysicalExec:
        if type(node) in (CpuHashJoinExec, TpuShuffledHashJoinExec):
            # the cost model first: a join too small for the device skips
            # every other device rewrite
            rewritten = _try_cpu_placement(node, stats, conf)
            if rewritten is not None:
                return rewritten
            # the broadcast switch before the generic coalescing, so the
            # build side becomes an all-partition reader
            rewritten = _try_broadcast_switch(node, stats, threshold)
            if rewritten is not None:
                return rewritten
            rewritten = _try_skew_split(node, stats, conf, target)
            if rewritten is not None:
                return rewritten

        if (isinstance(node, (ce.CpuHashAggregateExec,
                              te.TpuHashAggregateExec))
                and getattr(node, "grouping", ())):
            hinted = _try_skew_repartition(node, stats, conf, target)
            if hinted is not None:
                return hinted

        # coalesce small partitions under any other parent. A
        # single-partition exchange reads every child partition anyway, so
        # a reader beneath it would only add a copy (and hide the stage
        # from the broadcast switch's unwrap above)
        if (_is_exchange(node)
                and isinstance(node.partitioning, SinglePartitioning)):
            return node
        new_children = []
        changed = False
        for c in node.children:
            sz = stats(c)
            if sz is not None and c.num_partitions > 1:
                specs = coalesce_specs(sz, target)
                if len(specs) < c.num_partitions:
                    new_children.append(coalesced_child(c, specs))
                    changed = True
                    continue
            new_children.append(c)
        return node.with_children(new_children) if changed else node

    out = plan.transform_up(fix)
    # the root may itself be an exchange (a bare repartition)
    sz = stats(out)
    if sz is not None and out.num_partitions > 1:
        specs = coalesce_specs(sz, target)
        if len(specs) < out.num_partitions:
            out = coalesced_child(out, specs)
    out = _restore_requirements(out)
    if conf.get(cfg.ADAPTIVE_REFUSION_ENABLED):
        out = _refuse_stages(out, conf)
    return out


def _refuse_stages(plan: PhysicalExec, conf) -> PhysicalExec:
    """Re-run the fusion pass over the rewritten tree. The pass leaves
    fused regions as they are, so only chains the rewrite created (a
    reader and its coalesce under a lone project or filter) fuse anew;
    each counts into ``refused_stages`` and is tagged."""
    from spark_rapids_tpu_torch.plan.fusion import fuse_stages, fused_stages

    def sig(n) -> str:
        return f"{type(n).__name__}:{n.fused_ops!r}"

    before = Counter(sig(n) for n in fused_stages(plan))
    refused = fuse_stages(plan, conf)   # a no-op unless sql.fusion.enabled
    after = fused_stages(refused)
    delta = len(after) - sum(before.values())
    if delta > 0:
        seen: Counter = Counter()
        for n in after:
            seen[sig(n)] += 1
            if seen[sig(n)] > before.get(sig(n), 0):
                prior = n.adaptive_tag
                n.adaptive_tag = f"{prior} | re-fused" if prior else "re-fused"
        um.ADAPTIVE_METRICS[um.ADAPTIVE_REFUSED_STAGES].add(delta)
    return refused


def _restore_requirements(plan: PhysicalExec) -> PhysicalExec:
    """Re-establish the distributions the rewrite may have broken (Spark
    re-runs EnsureRequirements per stage): a broadcast-switched join emits
    the stream side's partitioning, but its parents were planned when it
    emitted one partition, so limits, global sorts, aggregates, windows and
    shuffled-join inputs above it get their single-partition input back.
    Skew-split joins keep theirs: their aligned readers are the
    co-partitioning the join needs."""
    from spark_rapids_tpu_torch.execs import cpu_execs as ce
    from spark_rapids_tpu_torch.execs import tpu_execs as te
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        RangePartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.join_execs import (
        CpuHashJoinExec, TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.execs.window_execs import (CpuWindowExec,
                                                           TpuWindowExec)

    def needs_single_children(node: PhysicalExec) -> bool:
        if type(node) in (CpuHashJoinExec, TpuShuffledHashJoinExec):
            return True
        return isinstance(node, (ce.CpuHashAggregateExec,
                                 te.TpuHashAggregateExec,
                                 ce.CpuLimitExec, te.TpuLimitExec,
                                 CpuWindowExec, TpuWindowExec))

    def exchange_cls(child: PhysicalExec):
        return (TpuShuffleExchangeExec if child.is_device
                else CpuShuffleExchangeExec)

    def is_range_distributed(child: PhysicalExec) -> bool:
        """A range exchange, or a reader over one (coalesced groups are
        contiguous, so the partition order survives), already gives a
        global sort the distribution ensure_requirements planned."""
        if isinstance(child, te.TpuCoalesceBatchesExec):
            child = child.children[0]
        if isinstance(child, CustomShuffleReaderExecBase):
            child = child.children[0]
        return (_is_exchange(child)
                and isinstance(child.partitioning, RangePartitioning))

    def fix(node: PhysicalExec) -> PhysicalExec:
        if isinstance(node, (ce.CpuSortExec, te.TpuSortExec)):
            # global sorts keep their parallel range-exchange shape; only a
            # child the rewrite left multi-partition without one is
            # distributed again
            child = node.children[0]
            if child.num_partitions > 1 and not is_range_distributed(child):
                exchange = exchange_cls(child)(
                    RangePartitioning(child.num_partitions, node.orders),
                    child)
                return node.with_children([exchange])
            return node
        if not needs_single_children(node):
            return node
        if (type(node) in (CpuHashJoinExec, TpuShuffledHashJoinExec)
                and len(node.children) == 2
                and all(getattr(c, "aligned_pairwise", False)
                        for c in node.children)
                and node.children[0].num_partitions
                == node.children[1].num_partitions):
            return node
        new_children = [exchange_cls(c)(SinglePartitioning(), c)
                        if c.num_partitions > 1 else c
                        for c in node.children]
        if all(a is b for a, b in zip(new_children, node.children)):
            return node
        return node.with_children(new_children)

    return plan.transform_up(fix)


def _unwrap_single(node: PhysicalExec) -> PhysicalExec:
    """Look through the single-partition exchange ensure_requirements puts
    above each shuffled-join input: the stage (and its statistics) of
    interest is the exchange underneath."""
    if (_is_exchange(node)
            and isinstance(node.partitioning, SinglePartitioning)
            and _is_exchange(node.children[0])):
        return node.children[0]
    return node


def _try_broadcast_switch(join, stats, threshold: int):
    """A finished build-side shuffle under the threshold turns the shuffled
    hash join into the broadcast one: the build is a broadcast exchange
    over an all-partition reader of the executed exchange, and the stream
    side drops its single-partition exchange and stays partitioned (Spark's
    DynamicJoinSelection)."""
    from spark_rapids_tpu_torch.execs.join_execs import (
        CpuBroadcastHashJoinExec, TpuBroadcastHashJoinExec,
        legal_broadcast_sides)
    how = join.how
    for bi in legal_broadcast_sides(how):
        build = _unwrap_single(join.children[bi])
        sz = stats(build)
        if sz is None or sum(sz) > threshold:
            continue
        all_parts = (tuple(range(build.num_partitions)),)
        bcast_reader = _reader_for(build, all_parts)
        bcast = (TpuBroadcastExchangeExec(bcast_reader) if build.is_device
                 else CpuBroadcastExchangeExec(bcast_reader))
        stream = _unwrap_single(join.children[1 - bi])
        new_children = [None, None]
        new_children[bi] = bcast
        new_children[1 - bi] = stream
        cls = (TpuBroadcastHashJoinExec if join.is_device
               else CpuBroadcastHashJoinExec)
        out = cls(new_children[0], new_children[1], how, join.left_keys,
                  join.right_keys, join.output, join.condition,
                  build_side="left" if bi == 0 else "right")
        out.adaptive_tag = f"broadcast-switch build={sum(sz)}B"
        um.ADAPTIVE_METRICS[um.ADAPTIVE_BROADCAST_SWITCHES].add(1)
        return out
    return None


def _try_cpu_placement(join, stats, conf):
    """Cost-based placement from observed rows: a shuffled join whose
    inputs materialized under costModel.minDeviceRows rows in all runs on
    the CPU engine: download the sides, host hash join, upload the result
    (the observed-statistics form of plan/overrides.py
    ``apply_cost_model``)."""
    from spark_rapids_tpu_torch.execs.join_execs import (
        CpuHashJoinExec, TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.execs.tpu_execs import (DeviceToHostExec,
                                                        HostToDeviceExec)
    if not conf.get(cfg.ADAPTIVE_COST_MODEL_ENABLED):
        return None
    if not isinstance(join, TpuShuffledHashJoinExec):
        return None
    rows = 0
    for c in join.children:
        ex = _unwrap_single(c)
        if stats(ex) is None:
            return None
        st = ex.stage_stats()
        if st is None:
            return None
        rows += st.total_rows
    if rows >= conf.get(cfg.ADAPTIVE_COST_MODEL_MIN_DEVICE_ROWS):
        return None
    cpu = CpuHashJoinExec(DeviceToHostExec(join.children[0]),
                          DeviceToHostExec(join.children[1]),
                          join.how, join.left_keys, join.right_keys,
                          join.output, join.condition,
                          build_side=join.build_side)
    cpu.adaptive_tag = f"placement=cpu rows={rows}"
    return HostToDeviceExec(cpu)


def legal_split_sides(how: str) -> List[int]:
    """Side indices that may be skew-split for this join kind: the split
    side's rows spread over the slices (each read once) while the other
    side is read whole per slice, that is replicated, so the other side
    must be a legal broadcast build (``legal_broadcast_sides``)."""
    from spark_rapids_tpu_torch.execs.join_execs import legal_broadcast_sides
    return sorted({1 - bi for bi in legal_broadcast_sides(how)})


def _try_skew_split(join, stats, conf, target: int):
    """OptimizeSkewedJoin: split each skewed reduce partition's skewed side
    into map-id slices and pair every slice with a whole read of the
    matching partition on the other side. Both inputs become index-aligned
    readers and the join runs partition-wise, one giant straggler partition
    replaced by several even slices."""
    if not conf.get(cfg.ADAPTIVE_SKEW_SPLIT_ENABLED):
        return None
    factor = conf.get(cfg.ADAPTIVE_SKEW_FACTOR)
    thresh = conf.get(cfg.ADAPTIVE_SKEW_THRESHOLD_BYTES)
    split_sides = legal_split_sides(join.how)
    if not split_sides:
        return None
    exchanges = [_unwrap_single(c) for c in join.children]
    for ex in exchanges:
        if not (_is_exchange(ex)
                and isinstance(ex.partitioning, HashPartitioning)):
            return None
    n = exchanges[0].num_partitions
    if n <= 1 or exchanges[1].num_partitions != n:
        return None
    # alignment: each side's shuffle partitions by exactly the join keys,
    # and the key types agree across sides (the hash is type-sensitive),
    # or pid i on the left is not pid i on the right
    join_keys = (tuple(join.left_keys), tuple(join.right_keys))
    for side, ex in enumerate(exchanges):
        pk = tuple(ex.partitioning.keys)
        if len(pk) != len(join_keys[side]):
            return None
        if tuple(map(_expr_fingerprint, pk)) != tuple(
                map(_expr_fingerprint, join_keys[side])):
            return None
    try:
        if [k.dtype() for k in join_keys[0]] != \
                [k.dtype() for k in join_keys[1]]:
            return None
    except Exception:
        return None
    sizes = [stats(ex) for ex in exchanges]
    medians = [sorted(sz)[len(sz) // 2] for sz in sizes]

    def skewed(side: int, p: int) -> bool:
        return (sizes[side][p] > factor * medians[side]
                and sizes[side][p] > thresh)

    specs: Tuple[List[ReaderSpec], List[ReaderSpec]] = ([], [])
    split_tags: List[str] = []
    for p in range(n):
        cands = [s for s in split_sides if skewed(s, p)]
        slices: List[Tuple[int, ...]] = []
        s = -1
        if cands:
            s = max(cands, key=lambda c: sizes[c][p])
            want = max(2, -(-sizes[s][p] // max(target, 1)))
            slices = exchanges[s].map_slices(p, want)
        if len(slices) >= 2:
            for i, map_ids in enumerate(slices):
                specs[s].append(
                    (PartialReducerSpec(p, i, len(slices), map_ids),))
                specs[1 - s].append((p,))
            split_tags.append(f"p{p}×{len(slices)}")
        else:
            specs[0].append((p,))
            specs[1].append((p,))
    if not split_tags:
        return None
    readers = []
    for side, ex in enumerate(exchanges):
        r = _reader_for(ex, tuple(specs[side]))
        r.aligned_pairwise = True
        readers.append(r)
    out = join.with_children(readers)
    out.adaptive_tag = "skew-split " + " ".join(split_tags)
    um.ADAPTIVE_METRICS[um.ADAPTIVE_SKEW_SPLITS].add(len(split_tags))
    return out


def _try_skew_repartition(node, stats, conf, target: int):
    """A skewed aggregate input: map-id slices would split a group across
    consumers and aggregate it twice, so the operator's grace-partition
    hint rises instead: the grace machinery (memory/grace.py) partitions
    the input by key hash up front and aggregates each partition."""
    if not conf.get(cfg.ADAPTIVE_SKEW_SPLIT_ENABLED):
        return None
    inner = _unwrap_single(node.children[0])
    if inner is node.children[0] or not isinstance(inner.partitioning,
                                                   HashPartitioning):
        return None
    sz = stats(inner)
    if sz is None or len(sz) <= 1:
        return None
    factor = conf.get(cfg.ADAPTIVE_SKEW_FACTOR)
    thresh = conf.get(cfg.ADAPTIVE_SKEW_THRESHOLD_BYTES)
    median = sorted(sz)[len(sz) // 2]
    n_skewed = sum(1 for s in sz if s > factor * median and s > thresh)
    if not n_skewed:
        return None
    parts = max(2, -(-sum(sz) // max(target, 1)))
    parts = min(parts, conf.get(cfg.OOC_MAX_PARTITIONS))
    if parts <= node.grace_partitions:
        return None
    out = node.with_children(list(node.children))
    out.grace_partitions = parts
    if isinstance(out, CpuEngineExec):
        # the CPU engine runs the host form, whose grace controller reads
        # the hint
        out._form = out.device_form().with_children(out.children)
        out._form.grace_partitions = parts
    out.adaptive_tag = f"skew-repartition×{parts}"
    um.ADAPTIVE_METRICS[um.ADAPTIVE_SKEW_SPLITS].add(n_skewed)
    return out
