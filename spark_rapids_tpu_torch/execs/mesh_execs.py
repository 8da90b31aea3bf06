"""Mesh operators (the JAX package's ``execs/mesh_execs.py``).

A mesh operator yields one ``MeshBatch`` (parallel/mesh_batch.py): shard
``d`` on mesh device ``d``. The JAX package runs each operator as one SPMD
program (``shard_map``) over its mesh; the port runs the single-device
operator's own code on each shard in turn, on that shard's device, with the
shard index as the partition id (``spark_partition_id``, the row id's
partition), and moves rows between shards only where the JAX package runs
a collective:

- a repartition (hash, round robin or sampled range bounds) is the
  exchange of shuffle/ici.py: a stable sort by destination per source,
  each destination receiving the sources' pieces in shard order, device to
  device;
- an aggregate is the Partial mode per shard, then either every partial
  gathered in shard order and merged once (the merged groups sliced
  contiguously over the shards), or, past
  ``sql.mesh.aggRepartitionThreshold`` partial groups, the partials
  repartitioned by key and merged per shard (``merge_aggregate``);
- a shuffled join repartitions both sides by key and joins per shard; a
  broadcast join copies the build batch to every shard device; with
  ``sql.adaptive.enabled`` a shuffled join whose side materializes under
  the broadcast threshold switches to the broadcast form;
- a sort range-repartitions and sorts each shard (shard-major order is the
  global order); a window hash-repartitions by its partition keys; a limit
  is host arithmetic over the row counts; a union concatenates per shard;
  expand and generate run per shard; a write emits one part file per shard.

Every mesh exchange logs its sizes in ``EXCHANGE_STATS``. Operators never
write into an input: two shards on one device, and the scan cache, may
share buffers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Schema,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.tpu_execs import (batch_of, colvs_of,
                                                    concat_device_batches,
                                                    eval_ctx, output_schema)
from spark_rapids_tpu_torch.exprs.core import ColV, Expression
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.parallel.mesh import Mesh, batch_sharding
from spark_rapids_tpu_torch.parallel.mesh_batch import (MeshBatch,
                                                        count_crossing,
                                                        gather_mesh,
                                                        host_batches_of,
                                                        replicate_device_batch,
                                                        scatter_device_batch,
                                                        scatter_host_batch)

_SAMPLE_PER_SHARD = 512

#: per-process log of the mesh exchanges' sizes (the MapOutputStatistics
#: role): op, chunk_cap, out_cap, in_cap, recv_max, recv_min, rows
EXCHANGE_STATS: list = []


def _shard_ctx(ctx: ExecContext, mesh: Mesh, d: int) -> ExecContext:
    """Shard ``d``'s context: its device, and its index as the partition."""
    dev = mesh.devices[d]
    return ExecContext(ctx.conf, dev, d, mesh.size, ctx.device_manager,
                       ctx.cleanups, ctx.task_id, False, dev,
                       query=ctx.query)


class _ShardSource(PhysicalExec):
    """A leaf yielding one shard's batch: the single-device operators run
    over it per shard."""

    size_estimate_none_reason = "one shard's batch, already materialized"

    def __init__(self, batch: DeviceBatch, schema: Schema):
        super().__init__((), schema)
        self.batch = batch

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        yield self.batch


def _run_local(node: PhysicalExec, ctx: ExecContext) -> DeviceBatch:
    """A single-device operator over a shard source, as one batch."""
    return concat_device_batches(list(node.execute(ctx)), node.output,
                                 ctx.device)


class MeshExec(PhysicalExec):
    """Base of the mesh operators: one host-side partition; the
    parallelism lives in the mesh."""

    is_device = True
    is_mesh = True

    #: mesh plans never consume static size estimates: every mesh exchange
    #: and strategy switch counts observed per-shard sizes at run time, and
    #: the out-of-core layer is one device's
    size_estimate_none_reason = ("mesh operators decide from observed "
                                 "per-shard sizes at run time")

    def __init__(self, children, output: Schema, mesh: Mesh):
        super().__init__(children, output)
        self.mesh = mesh
        #: declared output placement: rows partitioned over the shards
        self.placement = batch_sharding(mesh)

    @property
    def num_partitions(self) -> int:
        return 1

    def _one_child_batch(self, ctx: ExecContext, i: int = 0) -> MeshBatch:
        batches = list(self.children[i].execute(ctx))
        assert len(batches) == 1, (
            f"mesh subtree produced {len(batches)} batches")
        return batches[0]

    def _per_shard(self, mb: MeshBatch, ctx: ExecContext, schema: Schema,
                   fn) -> MeshBatch:
        """``fn(shard batch, shard context) -> batch`` on every shard."""
        return MeshBatch(schema, tuple(
            fn(b, _shard_ctx(ctx, self.mesh, d))
            for d, b in enumerate(mb.shards)), self.mesh)


# ------------------------------------------------------------------ transitions
class MeshScatterExec(MeshExec):
    """Host rows -> mesh batch: every partition of the host child, then
    contiguous runs uploaded to the shards (the upload fused with the
    even initial distribution)."""

    def __init__(self, child: PhysicalExec, mesh: Mesh):
        super().__init__((child,), child.output, mesh)

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        hb = host_batches_of(self.children[0], ctx)
        yield scatter_host_batch(hb, self.mesh, ctx.conf)


@dataclass(frozen=True)
class ScanShardAssignment:
    """Plan-time scan split: the (file_index, row_group) units each shard
    reads, with exact per-shard row totals from footer metadata."""

    units: Tuple[Tuple[Tuple[int, int], ...], ...]
    rows: Tuple[int, ...]

    @property
    def num_rows(self) -> int:
        return sum(self.rows)


def _lpt(sizes: Sequence[int], n_dev: int) -> List[List[int]]:
    """Greedy LPT: the largest item to the least-loaded shard; each shard's
    items in their original order."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    loads = [0] * n_dev
    assign: List[List[int]] = [[] for _ in range(n_dev)]
    for i in order:
        d = int(np.argmin(loads))
        assign[d].append(i)
        loads[d] += sizes[i]
    for lst in assign:
        lst.sort()
    return assign


def plan_scan_shards(scan, mesh: Mesh, conf) -> Optional[ScanShardAssignment]:
    """Balance the scan's row-group units over the shards at plan time
    (greedy LPT on exact footer row counts). None when the format has no
    row groups or the conf keeps the whole-file path."""
    from spark_rapids_tpu_torch import config as cfg
    if conf is None or conf.get(cfg.MESH_SCAN_ASSIGNMENT) != "rowgroup":
        return None
    units_fn = getattr(scan, "row_group_units", None)
    if units_fn is None or not getattr(scan, "files", None):
        return None
    try:
        units = units_fn()
    except OSError:
        return None       # an unreadable footer: the run-time path decides
    assign = _lpt([u[2] for u in units], mesh.size)
    return ScanShardAssignment(
        tuple(tuple((units[i][0], units[i][1]) for i in lst)
              for lst in assign),
        tuple(sum(units[i][2] for i in lst) for lst in assign))


class MeshFileScatterExec(MeshExec):
    """Shard-local file scan: each shard reads its own part of the scan
    and uploads it straight to its device; no whole-table host buffer.
    With a plan-time ``ScanShardAssignment`` (parquet row groups) each
    shard reads its units; otherwise files go to shards by their exact
    metadata row counts, and a format without them (CSV) is read whole and
    scattered. The host holds one shard's rows at a time."""

    def __init__(self, scan: PhysicalExec, mesh: Mesh,
                 assignment: Optional[ScanShardAssignment] = None):
        super().__init__((scan,), scan.output, mesh)
        self.assignment = assignment

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.columnar.transfer import \
            upload_arrow_conf
        scan = self.children[0]
        n_dev = self.mesh.size
        if self.assignment is not None:
            tables = [lambda d=d: scan.iter_tables_for_units(
                self.assignment.units[d]) if self.assignment.units[d]
                else iter(()) for d in range(n_dev)]
            expect = list(self.assignment.rows)
        else:
            counts = scan.file_row_counts() if scan.files else None
            if counts is None:
                import pyarrow as pa
                parts = list(scan.iter_tables_for_files(scan.files))
                table = (pa.concat_tables(parts) if parts
                         else self.output.to_pa().empty_table())
                from spark_rapids_tpu_torch.columnar.host import HostBatch
                yield scatter_host_batch(
                    HostBatch.from_arrow(table, ctx.string_max_bytes),
                    self.mesh, ctx.conf)
                return
            assign = _lpt(counts, n_dev)
            tables = [lambda d=d: scan.iter_tables_for_files(
                [scan.files[i] for i in assign[d]]) for d in range(n_dev)]
            expect = [sum(counts[i] for i in lst) for lst in assign]
        shards = []
        for d, dev in enumerate(self.mesh.devices):
            parts = [upload_arrow_conf(t, dev, ctx.conf)
                     for t in tables[d]()]
            db = concat_device_batches(parts, self.output, dev)
            if db.num_rows != expect[d]:
                # the file changed since its metadata was read
                raise RuntimeError(
                    f"shard {d} read {db.num_rows} rows but the metadata "
                    f"said {expect[d]}")
            shards.append(db)
        yield MeshBatch(self.output, tuple(shards), self.mesh)


class MeshFromDeviceExec(MeshExec):
    """One device's batches -> mesh batch: the reshard of a single-device
    intermediate joining a mesh subtree, split on the device (the JAX
    package stages it through the host)."""

    def __init__(self, child: PhysicalExec, mesh: Mesh):
        super().__init__((child,), child.output, mesh)

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        yield scatter_device_batch(_all_partitions(self.children[0], ctx),
                                   self.mesh)


def _all_partitions(child: PhysicalExec, ctx: ExecContext) -> DeviceBatch:
    """Every partition's batches of a single-device child, as one batch."""
    n = child.num_partitions
    return concat_device_batches(
        [b for p in range(n) for b in child.execute(ctx.for_partition(p, n))],
        child.output, ctx.device)


class MeshGatherExec(MeshExec):
    """Mesh batch -> one batch on the context's device, in shard-major
    order: the boundary back to single-device execution."""

    is_mesh = False  # consumers see a plain DeviceBatch

    def __init__(self, child: PhysicalExec, mesh: Mesh):
        super().__init__((child,), child.output, mesh)
        self.placement = None

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for mb in self.children[0].execute(ctx):
            yield gather_mesh(mb, ctx.device)


# ------------------------------------------------------------------ row-parallel
class MeshProjectExec(MeshExec):
    def __init__(self, exprs: Tuple[Expression, ...], child: PhysicalExec,
                 mesh: Mesh):
        super().__init__((child,), output_schema(exprs), mesh)
        self.exprs = exprs

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuProjectExec
        schema = self.children[0].output
        for mb in self.children[0].execute(ctx):
            yield self._per_shard(mb, ctx, self.output, lambda b, c: _run_local(
                TpuProjectExec(self.exprs, _ShardSource(b, schema)), c))


class MeshFilterExec(MeshExec):
    def __init__(self, condition: Expression, child: PhysicalExec,
                 mesh: Mesh):
        super().__init__((child,), child.output, mesh)
        self.condition = condition

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuFilterExec
        for mb in self.children[0].execute(ctx):
            yield _maybe_shrink(self._per_shard(
                mb, ctx, self.output, lambda b, c: _run_local(
                    TpuFilterExec(self.condition,
                                  _ShardSource(b, self.output)), c)))


def _shrunk(b: DeviceBatch, cap: int) -> DeviceBatch:
    return DeviceBatch(b.schema, tuple(
        DeviceColumn(c.dtype, c.data[:cap], c.validity[:cap],
                     None if c.lengths is None else c.lengths[:cap])
        for c in b.columns), b.num_rows)


def _maybe_shrink(mb: MeshBatch) -> MeshBatch:
    """Re-bucket each shard's capacity after a selective operator (views
    of the live prefix, no copy)."""
    shards = tuple(
        _shrunk(b, bucket_capacity(b.num_rows))
        if b.columns and b.capacity > bucket_capacity(b.num_rows) else b
        for b in mb.shards)
    return MeshBatch(mb.schema, shards, mb.mesh)


# ------------------------------------------------------------------ repartition
def _mesh_repartition(mb: MeshBatch, op: str, pid_fn) -> MeshBatch:
    """The exchange of every live row to shard ``pid_fn(shard batch,
    shard index)``, its chunk sized from the counts so no row is clamped;
    the sizes go to ``EXCHANGE_STATS``."""
    from spark_rapids_tpu_torch.shuffle.ici import exchange
    pids = [pid_fn(b, d) for d, b in enumerate(mb.shards)]
    out, overflow, cmat = exchange(mb, pids)
    assert overflow == 0 and out.num_rows == mb.num_rows, (
        f"mesh repartition lost rows: {out.num_rows} != {mb.num_rows}")
    recv = cmat.sum(axis=0)
    EXCHANGE_STATS.append({
        "op": op,
        "chunk_cap": max(bucket_capacity(int(cmat.max(initial=0))), 1),
        "out_cap": max(bucket_capacity(int(recv.max(initial=0))), 1),
        "in_cap": mb.local_capacity, "recv_max": int(recv.max(initial=0)),
        # (the JAX package's ``recv.min(initial=0)`` is always 0)
        "recv_min": int(recv.min()), "rows": int(mb.num_rows)})
    if len(EXCHANGE_STATS) > 256:
        del EXCHANGE_STATS[:128]
    return out


def _hash_pid_fn(keys: Tuple[Expression, ...], n_dev: int, conf):
    from spark_rapids_tpu_torch.execs.exchange_execs import hash_partition_ids
    from spark_rapids_tpu_torch.execs.base import ExecContext as _Ctx

    def pid(b: DeviceBatch, d: int) -> torch.Tensor:
        ectx = eval_ctx(b, _Ctx(conf, b.device, d, n_dev))
        return hash_partition_ids([e.eval(ectx) for e in keys], b.capacity,
                                  n_dev)
    return pid


def _round_robin_pid(b: DeviceBatch, d: int, n_dev: int) -> torch.Tensor:
    return ((torch.arange(b.capacity, device=b.device) + d) % n_dev) \
        .to(torch.int32)


class MeshShuffleExchangeExec(MeshExec):
    """Explicit repartition over the mesh (hash, round robin or range)."""

    def __init__(self, partitioning, child: PhysicalExec, mesh: Mesh):
        super().__init__((child,), child.output, mesh)
        self.partitioning = partitioning

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.exchange_execs import (
            HashPartitioning, RangePartitioning, RoundRobinPartitioning)
        part = self.partitioning
        n_dev = self.mesh.size
        for mb in self.children[0].execute(ctx):
            if isinstance(part, RangePartitioning):
                yield _range_repartition(mb, part.orders, ctx)
                continue
            if isinstance(part, HashPartitioning):
                pid = _hash_pid_fn(part.keys, n_dev, ctx.conf)
            elif isinstance(part, RoundRobinPartitioning):
                def pid(b, d, n_dev=n_dev):
                    return _round_robin_pid(b, d, n_dev)
            else:
                raise NotImplementedError(
                    f"mesh exchange for {type(part).__name__}")
            yield _mesh_repartition(mb, "mexchange", pid)


# ------------------------------------------------------------------ expand
class MeshExpandExec(MeshExec):
    """Expand (rollup, cube, grouping sets) per shard, projection-major
    within a shard; no row moves between shards."""

    def __init__(self, projections, child: PhysicalExec, output: Schema,
                 mesh: Mesh):
        super().__init__((child,), output, mesh)
        self.projections = projections

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.expand_execs import TpuExpandExec
        mb = self._one_child_batch(ctx)
        schema = self.children[0].output
        yield self._per_shard(mb, ctx, self.output, lambda b, c: _run_local(
            TpuExpandExec(self.projections, _ShardSource(b, schema),
                          self.output), c))


class MeshGenerateExec(MeshExpandExec):
    """Explode and posexplode per shard (the generate-as-expand form)."""


# ------------------------------------------------------------------ window
class MeshWindowExec(MeshExec):
    """A window: the rows repartitioned by the window's partition keys, so
    every partition group lands whole on one shard, then the single-device
    window per shard."""

    def __init__(self, wexprs: Tuple[Expression, ...], child: PhysicalExec,
                 mesh: Mesh):
        from spark_rapids_tpu_torch.execs.window_execs import \
            window_output_schema
        super().__init__((child,),
                         window_output_schema(child.output, wexprs), mesh)
        self.wexprs = wexprs

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.window_execs import TpuWindowExec
        mb = self._one_child_batch(ctx)
        first = (self.wexprs[0].c if isinstance(self.wexprs[0], Alias)
                 else self.wexprs[0])
        part_exprs = tuple(first.part_keys)
        assert part_exprs, "an unpartitioned window must gather"
        if mb.n_dev > 1:
            mb = _mesh_repartition(
                mb, "mwindow_part", _hash_pid_fn(part_exprs, mb.n_dev,
                                                 ctx.conf))
        schema = self.children[0].output
        yield self._per_shard(mb, ctx, self.output, lambda b, c: _run_local(
            TpuWindowExec(self.wexprs, _ShardSource(b, schema)), c))


# ------------------------------------------------------------------ writes
class MeshWriteFilesExec(MeshExec):
    """A file write from the mesh: each shard's rows download and encode as
    one writer task (one part file per shard, as one file per Spark task),
    under one commit protocol; no gather."""

    def __init__(self, spec, child: PhysicalExec, mesh: Mesh):
        from spark_rapids_tpu_torch.io.writer import WriteStats
        super().__init__((child,), Schema([]), mesh)
        self.spec = spec
        self.placement = None    # produces no batches
        self.stats = WriteStats()

    def execute(self, ctx: ExecContext):
        import time
        from spark_rapids_tpu_torch.columnar.transfer import download_arrow
        from spark_rapids_tpu_torch.io.write_exec import (make_task_writer,
                                                          total_output_bytes)
        from spark_rapids_tpu_torch.io.writer import (
            DynamicPartitionDataWriter, FileCommitProtocol, WriteStats,
            resolve_save_mode)
        t0 = time.perf_counter()
        self.stats = WriteStats()
        if resolve_save_mode(self.spec.path, self.spec.mode) is None:
            return
        mb = self._one_child_batch(ctx)
        committer = FileCommitProtocol(self.spec.path)
        committer.setup_job()
        partitions_seen: set = set()
        try:
            for d, shard in enumerate(mb.shards):
                writer = make_task_writer(self.spec, self.children[0].output,
                                          committer, d)
                if shard.num_rows:
                    writer.write(download_arrow(shard))
                writer.close()
                self.stats.num_files += writer.files_written
                self.stats.num_rows += writer.rows_written
                if isinstance(writer, DynamicPartitionDataWriter):
                    partitions_seen |= writer.partitions_seen
        except BaseException:
            committer.abort_job()
            raise
        committer.commit_job()
        self.stats.num_partitions = len(partitions_seen)
        self.stats.num_bytes = total_output_bytes(self.spec.path)
        self.stats.write_time_s += time.perf_counter() - t0
        return
        yield  # pragma: no cover - makes this a generator


# ------------------------------------------------------------------ aggregate
class MeshHashAggregateExec(MeshExec):
    """Aggregation over the mesh, mesh in and mesh out:

    1. the Partial mode per shard, with the single-device exec's grouping
       escalation (one-hot, hash, sort) and its folded filter;
    2. the partial group counts pick the merge;
    3a. at most ``sql.mesh.aggRepartitionThreshold`` partial groups: every
        partial gathered in shard order onto shard 0's device, one merge,
        and each shard keeps a contiguous slice of the merged groups;
    3b. more: the partials repartitioned by key hash, each shard merging
        its own keys.
    """

    def __init__(self, grouping: Tuple[Expression, ...],
                 aggregates: Tuple[Expression, ...], child: PhysicalExec,
                 output: Schema, mesh: Mesh,
                 pre_filter: Optional[Expression] = None):
        super().__init__((child,), output, mesh)
        self.grouping = grouping
        self.aggregates = aggregates
        self.pre_filter = pre_filter

    def _fns(self):
        return tuple(a.c if isinstance(a, Alias) else a
                     for a in self.aggregates)

    def _partial(self, b: DeviceBatch, c: ExecContext, fns,
                 pschema: Schema) -> DeviceBatch:
        from spark_rapids_tpu_torch.parallel.distributed import \
            partial_aggregate
        mask = None
        if self.pre_filter is not None:
            p = bk.as_column(self.pre_filter.eval(eval_ctx(b, c)),
                             b.capacity)
            mask = p.data & p.validity
        return partial_aggregate(eval_ctx(b, c), self.grouping, fns,
                                 b.num_rows, b.capacity, pschema, mask)

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch import config as cfg
        from spark_rapids_tpu_torch.parallel.distributed import partial_schema
        mb = self._one_child_batch(ctx)
        fns = self._fns()
        pschema = partial_schema(self.grouping, fns)
        partial = self._per_shard(mb, ctx, pschema, lambda b, c:
                                  self._partial(b, c, fns, pschema))
        total = partial.num_rows
        threshold = ctx.conf.get(cfg.MESH_AGG_REPARTITION_THRESHOLD)
        if self.grouping and total > threshold:
            yield self._merge_repartitioned(partial, fns, ctx)
        else:
            yield self._merge_all_gather(partial, fns, total)

    def _merge_all_gather(self, partial: MeshBatch, fns,
                          total: int) -> MeshBatch:
        from spark_rapids_tpu_torch.parallel.distributed import \
            merge_gathered
        from spark_rapids_tpu_torch.shuffle.ici import copy_rows
        n_dev = partial.n_dev
        # the partial count bounds the merged one: a safe slice stride
        per = -(-total // n_dev) if total else 0
        merged = merge_gathered(partial, len(self.grouping), fns,
                                self.output)
        cap = max(bucket_capacity(per), 1)
        shards = []
        for d, dev in enumerate(self.mesh.devices):
            lo = min(d * per, merged.num_rows)
            n = max(0, min(per, merged.num_rows - d * per))
            shards.append(copy_rows(merged, [(lo, n)], dev, cap))
        return MeshBatch(self.output, tuple(shards), self.mesh)

    def _merge_repartitioned(self, partial: MeshBatch, fns,
                             ctx: ExecContext) -> MeshBatch:
        from spark_rapids_tpu_torch.exprs.core import BoundReference
        from spark_rapids_tpu_torch.ops.aggregate import merge_aggregate
        nk = len(self.grouping)
        key_refs = tuple(BoundReference(i, f.dtype, f.nullable)
                         for i, f in enumerate(partial.schema.fields[:nk]))
        partial = _mesh_repartition(
            partial, "magg_part", _hash_pid_fn(key_refs, partial.n_dev,
                                               ctx.conf))

        def merge(b: DeviceBatch, c: ExecContext) -> DeviceBatch:
            cols = colvs_of(b)
            keys, res, ng = merge_aggregate(cols[:nk], cols[nk:], fns,
                                            b.num_rows, b.capacity)
            return batch_of(self.output, list(keys) + list(res), ng)
        return _maybe_shrink(self._per_shard(partial, ctx, self.output,
                                             merge))


def _to(v: ColV, device: torch.device) -> ColV:
    count_crossing(v.data.device, device, v.data.nbytes + v.validity.nbytes
                   + (0 if v.lengths is None else v.lengths.nbytes))
    return ColV(v.dtype, v.data.to(device, non_blocking=True),
                v.validity.to(device, non_blocking=True),
                None if v.lengths is None else
                v.lengths.to(device, non_blocking=True))


def _mesh_batch_bytes(mb: MeshBatch) -> int:
    """The live rows' data bytes (row width times row count): what the
    adaptive broadcast switch compares with its threshold."""
    row_bytes = 0
    for ci, f in enumerate(mb.schema):
        cols = [s.columns[ci] for s in mb.shards]
        width = max((int(np.prod(c.data.shape[1:])) for c in cols),
                    default=1)
        row_bytes += cols[0].data.element_size() * width + 1
        if f.dtype is DType.STRING:
            row_bytes += 4
    return int(mb.num_rows) * row_bytes


# ------------------------------------------------------------------ joins
class MeshHashJoinBase(MeshExec):
    def __init__(self, left: PhysicalExec, right: PhysicalExec, how: str,
                 left_keys, right_keys, output: Schema, mesh: Mesh,
                 condition: Optional[Expression] = None,
                 build_side: str = "right"):
        super().__init__((left, right), output, mesh)
        self.how = how
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.condition = condition
        self.build_side = build_side

    @property
    def includes_right_columns(self) -> bool:
        return self.how not in ("left_semi", "left_anti")

    def _local_join(self, ctx: ExecContext, lshards: Sequence[DeviceBatch],
                    rshards: Sequence[DeviceBatch]) -> MeshBatch:
        """The single-device join per shard: a replicated side (a
        broadcast build) holds the same rows on every shard, the other
        side's rows each sit on one shard, so the per-shard outputs union
        to the join."""
        from spark_rapids_tpu_torch.execs.join_execs import \
            TpuShuffledHashJoinExec
        local = TpuShuffledHashJoinExec(
            *self.children, self.how, tuple(self.left_keys),
            tuple(self.right_keys), self.output, self.condition,
            self.build_side)
        return _maybe_shrink(MeshBatch(self.output, tuple(
            local._single_pass(_shard_ctx(ctx, self.mesh, d), [lb], [rb])
            for d, (lb, rb) in enumerate(zip(lshards, rshards))),
            self.mesh))

    def _broadcast_join(self, ctx: ExecContext, stream: MeshBatch,
                        db: DeviceBatch, bi: int) -> MeshBatch:
        """The build batch ``db`` (side ``bi``) on every shard device,
        joined with the sharded stream."""
        rep = replicate_device_batch(db, self.mesh)
        if bi == 1:
            return self._local_join(ctx, stream.shards, rep)
        return self._local_join(ctx, rep, stream.shards)


class MeshShuffledHashJoinExec(MeshHashJoinBase):
    """Equi-join with both sides repartitioned by key hash, then joined
    per shard. With ``sql.adaptive.enabled`` a legal build side whose
    materialized rows fall under ``broadcastJoinThreshold`` switches the
    join to the broadcast form (no stream movement)."""

    #: set by execute() when adaptive execution switched it to broadcast
    adapted_broadcast = False

    def _adaptive_broadcast(self, ctx: ExecContext, lb: MeshBatch,
                            rb: MeshBatch) -> Optional[MeshBatch]:
        from spark_rapids_tpu_torch import config as cfg
        from spark_rapids_tpu_torch.execs.join_execs import \
            legal_broadcast_sides
        if not ctx.conf.get(cfg.ADAPTIVE_ENABLED):
            return None
        threshold = ctx.conf.get(cfg.BROADCAST_JOIN_THRESHOLD)
        for bi in legal_broadcast_sides(self.how):
            bb = (lb, rb)[bi]
            if _mesh_batch_bytes(bb) > threshold:
                continue
            out = self._broadcast_join(ctx, (lb, rb)[1 - bi],
                                       gather_mesh(bb), bi)
            self.adapted_broadcast = True
            return out
        return None

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        n_dev = self.mesh.size
        lb = self._one_child_batch(ctx, 0)
        rb = self._one_child_batch(ctx, 1)
        adapted = self._adaptive_broadcast(ctx, lb, rb)
        if adapted is not None:
            yield adapted
            return
        lb = _mesh_repartition(lb, "mjoin_lpart", _hash_pid_fn(
            tuple(self.left_keys), n_dev, ctx.conf))
        rb = _mesh_repartition(rb, "mjoin_rpart", _hash_pid_fn(
            tuple(self.right_keys), n_dev, ctx.conf))
        yield self._local_join(ctx, lb.shards, rb.shards)


class MeshBroadcastHashJoinExec(MeshHashJoinBase):
    """Broadcast equi-join: the build side (one batch from its broadcast
    exchange) copied to every shard device, the stream side unmoved."""

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        bi = 0 if self.build_side == "left" else 1
        stream = self._one_child_batch(ctx, 1 - bi)
        db = _all_partitions(self.children[bi], ctx)
        yield self._broadcast_join(ctx, stream, db, bi)


# ------------------------------------------------------------------ sort
class MeshSortExec(MeshExec):
    """Global sort: a sampled range repartition (ascending shard index =
    ascending key range), then one stable sort per shard; shard-major
    order is the global order."""

    def __init__(self, orders: Tuple[SortOrder, ...], child: PhysicalExec,
                 mesh: Mesh, pre_partitioned: bool = False):
        super().__init__((child,), child.output, mesh)
        self.orders = orders
        #: the child is already range-partitioned on these orders
        self.pre_partitioned = pre_partitioned

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuSortExec
        mb = self._one_child_batch(ctx)
        if not self.pre_partitioned:
            mb = _range_repartition(mb, self.orders, ctx)
        sorter = TpuSortExec(self.orders, self.children[0])
        yield self._per_shard(mb, ctx, self.output, lambda b, c: next(
            sorter._single_pass(c, [b])))


def _mesh_sampled_bounds(mb: MeshBatch, orders, ctx: ExecContext):
    """The order keys of evenly spaced sample rows of every shard (the same
    positions in each shard's ``local_capacity``, the live ones kept),
    merged in shard order on shard 0's device into ``n_dev - 1`` range
    bounds."""
    from spark_rapids_tpu_torch.execs.exchange_execs import _sample_bounds
    cap = mb.local_capacity
    k = min(_SAMPLE_PER_SHARD, cap)
    pos = np.linspace(0, cap - 1, k).astype(np.int32)
    sampled = []
    for d, b in enumerate(mb.shards):
        live = pos[pos < b.num_rows]
        if not live.size:
            continue
        ectx = eval_ctx(b, _shard_ctx(ctx, mb.mesh, d))
        idx = torch.from_numpy(live.astype(np.int64)).to(b.device)
        sampled.append([_to(bk.take_colv(bk.as_column(o.child.eval(ectx),
                                                      b.capacity), idx),
                            mb.mesh.devices[0]) for o in orders])
    if not sampled:
        return None
    return _sample_bounds(orders, sampled, mb.n_dev)


def _range_repartition(mb: MeshBatch, orders, ctx: ExecContext
                       ) -> MeshBatch:
    """Sampled range repartition: ascending shard index = ascending key
    range. Nothing moves on a one-shard mesh or an empty batch."""
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        range_partition_ids
    orders = tuple(orders)
    if not mb.num_rows or mb.n_dev < 2:
        return mb
    bounds = _mesh_sampled_bounds(mb, orders, ctx)
    if bounds is None:
        return mb

    def pid(b: DeviceBatch, d: int) -> torch.Tensor:
        ectx = eval_ctx(b, _shard_ctx(ctx, mb.mesh, d))
        row_keys = [bk.as_column(o.child.eval(ectx), b.capacity)
                    for o in orders]
        return range_partition_ids(orders, row_keys,
                                   [_to(v, b.device) for v in bounds])
    return _mesh_repartition(mb, "msort_part", pid)


# ------------------------------------------------------------------ limit/union
class MeshLimitExec(MeshExec):
    """Global limit over shard-major order: each shard's take is host
    arithmetic over the row counts; no row moves."""

    def __init__(self, n: int, child: PhysicalExec, mesh: Mesh):
        super().__init__((child,), child.output, mesh)
        self.n = n

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        remaining = self.n
        for mb in self.children[0].execute(ctx):
            shards = []
            for b in mb.shards:
                take = min(remaining, b.num_rows)
                remaining -= take
                if take < b.num_rows:
                    alive = bk.alive_mask(b.capacity, take, b.device)
                    b = DeviceBatch(b.schema, tuple(
                        DeviceColumn(c.dtype, c.data, c.validity & alive,
                                     c.lengths) for c in b.columns), take)
                shards.append(b)
            yield _maybe_shrink(MeshBatch(mb.schema, tuple(shards), mb.mesh))
            if remaining <= 0:
                break


class MeshUnionExec(MeshExec):
    """UNION ALL per shard: each shard's left rows, then its right rows."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec, mesh: Mesh):
        super().__init__((left, right), left.output, mesh)

    def execute(self, ctx: ExecContext) -> Iterator[MeshBatch]:
        lb = self._one_child_batch(ctx, 0)
        rb = self._one_child_batch(ctx, 1)
        yield MeshBatch(self.output, tuple(
            concat_device_batches([DeviceBatch(self.output, l.columns,
                                               l.num_rows),
                                   DeviceBatch(self.output, r.columns,
                                               r.num_rows)],
                                  self.output, dev)
            for l, r, dev in zip(lb.shards, rb.shards, self.mesh.devices)),
            self.mesh)

