"""Device physical operators: upload/download transitions, range, project,
filter, hash aggregate, sort, limit, union and the batch coalesce. Each
evaluates its expressions eagerly on the batch's tensors; the live row
count of a result reaches the host once per batch to pick the output's
capacity bucket, as in the JAX package. The aggregate may carry a folded
filter (``pre_filter``) that masks its input rows instead of compacting
them; the upload keeps its batch in the scan cache across actions."""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, pad_rows
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Field, Schema,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.transfer import (download,
                                                      upload_table_conf)
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import (CpuLocalScanExec,
                                                    engine_batch,
                                                    limit_size_estimate,
                                                    width_scaled_estimate)
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.exprs.cse import (add_shared_columns,
                                              common_subexpressions)
from spark_rapids_tpu_torch.exprs import encoded as ed
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.parallel.placement import assert_unsharded
from spark_rapids_tpu_torch.ops.aggregate import (group_aggregate,
                                                  grouping_modes)


def colvs_of(batch: DeviceBatch) -> List[ColV]:
    return [ColV(c.dtype, c.data, c.validity, c.lengths)
            for c in batch.columns]


def eval_ctx(batch: DeviceBatch, ctx: ExecContext,
             row_offset: int = 0) -> EvalCtx:
    return EvalCtx(colvs_of(batch), batch.capacity, batch.device,
                   ctx.string_max_bytes, getattr(ctx, "partition_id", 0),
                   row_offset, getattr(ctx, "host_engine", False),
                   batch.num_rows)


def batch_of(schema: Schema, colvs, num_rows: int) -> DeviceBatch:
    return DeviceBatch(schema, tuple(
        DeviceColumn(f.dtype, v.data, v.validity, v.lengths)
        for f, v in zip(schema, colvs)), num_rows)


def concat_device_batches(batches: List[DeviceBatch], schema: Schema,
                          device: torch.device) -> DeviceBatch:
    """Concatenate the live rows of batches into one batch of the total's
    capacity bucket (string matrices padded to the widest). A column keeps
    its dictionary encoding when every contributor carries one from the
    same dictionary stream (one DictionaryUnifier token): the dictionaries
    are then prefix-compatible, so the concatenated indices stay valid
    against the largest contributor's dictionary."""
    batches = [b for b in batches if b.num_rows > 0]
    if not batches:
        return DeviceBatch.empty(schema, device)
    if len(batches) == 1:
        return batches[0]
    assert_unsharded(batches, "concat_device_batches")
    total = sum(b.num_rows for b in batches)
    cap = bucket_capacity(total)
    cols = []
    for ci, f in enumerate(schema):
        parts = [b.columns[ci] for b in batches]
        datas = [c.data[:b.num_rows] for c, b in zip(parts, batches)]
        if f.dtype is DType.STRING:
            width = max(d.shape[1] for d in datas)
            datas = [torch.nn.functional.pad(d, (0, width - d.shape[1]))
                     for d in datas]
        data = pad_rows(torch.cat(datas), cap)
        validity = pad_rows(torch.cat([c.validity[:b.num_rows]
                                       for c, b in zip(parts, batches)]), cap)
        lengths = None
        if f.dtype is DType.STRING:
            lengths = pad_rows(torch.cat([c.lengths[:b.num_rows]
                                          for c, b in zip(parts, batches)]),
                               cap)
        cols.append(DeviceColumn(f.dtype, data, validity, lengths,
                                 _carried_encoding(parts, batches, cap)))
    return DeviceBatch(schema, tuple(cols), total)


def _carried_encoding(parts: List[DeviceColumn], batches: List[DeviceBatch],
                      cap: int):
    """The concatenation's encoding, or None when the contributors do not
    all share one token."""
    encs = [c.encoding for c in parts]
    if not all(e is not None and e.token is not None for e in encs) or \
            len({e.token for e in encs}) != 1:
        return None
    from spark_rapids_tpu_torch.columnar.encoding import DictEncoding
    indices = pad_rows(torch.cat([e.indices[:b.num_rows]
                                  for e, b in zip(encs, batches)]), cap)
    big = max(encs, key=lambda e: e.k)
    return DictEncoding(indices, big.values, big.lengths, big.token)


def _count_encoded_op() -> None:
    from spark_rapids_tpu_torch.columnar import encoding as cenc
    cenc.count("encoded_domain_ops")


# ---------------------------------------------------------------- transitions
class HostToDeviceExec(PhysicalExec):
    """Upload transition: each host batch goes to the context's device, in
    chunks of ``transfer.chunkRows`` rows. Directly over an in-memory scan,
    with ``sql.scanCache.enabled``, the uploaded batch is cached across
    actions (memory/scan_cache.py), so a repeated query over the same table
    skips the upload."""

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        child = self.children[0]
        if (isinstance(child, CpuLocalScanExec)
                and ctx.conf.get(cfg.SCAN_CACHE_ENABLED)):
            if ctx.partition_id != 0:
                return
            from spark_rapids_tpu_torch.memory.scan_cache import get_cache
            cache = get_cache(ctx.conf.get(cfg.SCAN_CACHE_BYTES))
            # per-key latch: actions missing on the same table at once
            # share one upload
            yield cache.get_or_put(
                child.batch, ctx.string_max_bytes, ctx.device,
                lambda: upload_table_conf(child.batch, ctx.device, ctx.conf),
                cancel_check=ctx.check_cancelled)
            return
        for hb in child.execute(ctx):
            ctx.check_cancelled()   # before each upload: the costliest step
            yield upload_table_conf(hb, ctx.device, ctx.conf)


class DeviceToHostExec(PhysicalExec):
    """Download transition: live rows back to host numpy buffers. Under a
    CPU engine operator (``ctx.host_engine``) the device subtree runs in
    the session's context and each batch reaches the engine as CPU
    tensors."""

    is_device = False

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        if ctx.host_engine:
            for db in self.children[0].execute(ctx.on_session()):
                yield engine_batch(download(db))
            return
        for db in self.children[0].execute(ctx):
            ctx.check_cancelled()   # before each download
            yield download(db)


def device_root(final: PhysicalExec) -> PhysicalExec:
    """The executed plan with its trailing download cut, so it yields
    device batches; a plan whose root is on the CPU engine gets an upload
    instead (the JAX package's ``ml._device_plan``)."""
    if isinstance(final, DeviceToHostExec):
        return final.children[0]
    if not final.is_device:
        return HostToDeviceExec(final)
    return final


# ---------------------------------------------------------------- operators
def output_schema(exprs: Tuple[Expression, ...]) -> Schema:
    return Schema([Field(e.name_hint, e.dtype(), e.nullable())
                   for e in exprs])


class TpuRangeExec(PhysicalExec):
    """``session.range``: one batch of the LONG ids start, start + step,
    ... below end (GpuRangeExec)."""

    def __init__(self, start: int, end: int, step: int):
        super().__init__((), Schema([Field("id", DType.LONG,
                                           nullable=False)]))
        self.start, self.end, self.step = start, end, step

    def _rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    def size_estimate(self) -> Optional[int]:
        return self._rows() * 9      # 8 bytes of id + a validity byte

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        if ctx.partition_id != 0:
            return
        n = self._rows()
        cap = bucket_capacity(n)
        data = self.start + torch.arange(cap, dtype=torch.int64,
                                         device=ctx.device) * self.step
        validity = torch.arange(cap, device=ctx.device) < n
        yield DeviceBatch(self.output,
                          (DeviceColumn(DType.LONG, data, validity),), n)


class TpuProjectExec(PhysicalExec):
    def __init__(self, exprs: Tuple[Expression, ...], child: PhysicalExec):
        super().__init__((child,), output_schema(exprs))
        self.exprs = exprs

    def size_estimate(self) -> Optional[int]:
        return width_scaled_estimate(self.children[0], self.output)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        # the partition's rows in the batches already projected: the row
        # id's running offset
        offset = 0
        for batch in self.children[0].execute(ctx):
            ectx = eval_ctx(batch, ctx, offset)
            offset += batch.num_rows
            yield batch_of(self.output,
                           [bk.as_column(e.eval(ectx), batch.capacity)
                            for e in self.exprs], batch.num_rows)


def encoded_predicate(pred: Expression, batch: DeviceBatch, ectx: EvalCtx
                      ) -> Expression:
    """``pred`` with its single-encoded-column subtrees rewritten onto the
    batch's dictionaries (exprs/encoded.py); the views it needs go into
    ``ectx``. Unchanged when no column of the batch kept an encoding."""
    from spark_rapids_tpu_torch.columnar import encoding as cenc
    from spark_rapids_tpu_torch.exprs import encoded as ed
    specs = cenc.enc_specs_of(batch)
    if not specs:
        return pred
    pred, used = ed.rewrite_predicate(pred, specs)
    if used:
        ectx.encodings.update(cenc.enc_views(batch, used))
    return pred


class TpuFilterExec(PhysicalExec):
    #: set by plan/encoded.py: the child chain can deliver batches whose
    #: columns kept their dictionary encoding, so single-column predicates
    #: may run over the k dictionary slots and gather
    encoded_domain_ok = False

    def __init__(self, condition: Expression, child: PhysicalExec):
        super().__init__((child,), child.output)
        self.condition = condition
        #: batches of the last execution that ran on dictionary indices
        self.encoded_batches = 0

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()      # an upper bound

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        use_enc = (self.encoded_domain_ok
                   and ctx.conf.get(cfg.ENCODED_DOMAIN))
        self.encoded_batches = 0
        for batch in self.children[0].execute(ctx):
            ectx = eval_ctx(batch, ctx)
            cond = (encoded_predicate(self.condition, batch, ectx)
                    if use_enc else self.condition)
            if ectx.encodings:
                self.encoded_batches += 1
                _count_encoded_op()
            pred = cond.eval(ectx)
            alive = bk.alive_mask(batch.capacity, batch.num_rows, batch.device)
            keep = (pred.data & pred.validity) & alive
            cols, n = bk.compact(keep, colvs_of(batch))
            yield batch_of(self.output, cols, n)


class TpuHashAggregateExec(PhysicalExec):
    """Grouped aggregation over the concatenation of the child's batches.
    The fastest grouping runs first and the next one only when it raised
    its flag: one-hot, then hash, then the exact sort (the JAX package's
    ``tpu_execs.py`` escalation). A folded filter (``pre_filter``, over the
    child's output) masks the input rows in every mode (``group_aggregate``'s
    ``extra_mask``), so the filtered batch never materializes. Under
    memory pressure a grouped aggregate goes out of core
    (memory/grace.py): its input is hash-partitioned on the grouping keys
    and each partition runs this single pass, the folded filter with it."""

    #: peak device bytes per input byte while the aggregation runs (input,
    #: the grouping passes, the compacted output): the footprint contract's
    #: and the pressure check's factor (memory/grace.py)
    working_set_factor = 3.0

    #: set by plan/encoded.py: grouping keys that are plain references to
    #: encoded columns group on the int32 dictionary indices, and decode
    #: only for the surviving groups; the folded filter's single-column
    #: subtrees run over the dictionaries
    encoded_domain_ok = False

    def __init__(self, grouping: Tuple[Expression, ...],
                 aggregates: Tuple[Expression, ...], child: PhysicalExec,
                 output: Schema, pre_filter: Optional[Expression] = None):
        super().__init__((child,), output)
        self.grouping = grouping
        self.aggregates = aggregates
        self.pre_filter = pre_filter
        #: grouping modes run by the last execution, in order
        self.modes_run: List[str] = []
        #: passes of the last execution that ran on dictionary indices
        self.encoded_batches = 0

    def size_estimate(self) -> Optional[int]:
        # groups never outnumber input rows
        return width_scaled_estimate(self.children[0], self.output)

    def working_set_estimate(self) -> Optional[int]:
        sz = self.children[0].size_estimate()
        return None if sz is None else int(sz * self.working_set_factor)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        self.encoded_batches = 0
        return self._aggregate(ctx, self.children[0].execute(ctx))

    def _aggregate(self, ctx: ExecContext,
                   source: Iterator[DeviceBatch]) -> Iterator[DeviceBatch]:
        """The single pass, or, through the grace controller, one pass per
        hash partition of the input."""
        from spark_rapids_tpu_torch.memory import grace
        ooc = (grace.controller_for(self, ctx, "agg", self.grouping)
               if self.grouping else None)
        if ooc is None:
            yield from self._single_pass(ctx, list(source))
            return
        mode, payload = ooc.stage(source, self.grouping)
        if mode == "inline":
            yield from self._single_pass(ctx, payload)
            return
        yield from self._grace_execute(ctx, ooc, payload)

    def _grace_execute(self, ctx: ExecContext, ooc,
                       parts) -> Iterator[DeviceBatch]:
        """Every partition holds whole key groups (hash-routed), so the
        per-partition results union to the global aggregation; a partition
        still over budget re-partitions with a deeper hash salt until it
        fits, the depth bound stops it, or a split proves degenerate (one
        indivisible key group)."""
        try:
            degenerate = parts.degenerate
            for pid in parts.nonempty():
                ctx.check_cancelled()
                if not degenerate and ooc.should_recurse(
                        parts.bytes_of(pid), parts.depth):
                    # drain() feeds the re-split one piece at a time
                    sub = ooc.partition(parts.drain(pid), self.grouping,
                                        depth=parts.depth + 1)
                    yield from self._grace_execute(ctx, ooc, sub)
                else:
                    batches = parts.take(pid)
                    if batches:
                        yield from self._single_pass(ctx, batches)
        finally:
            parts.close()

    def _single_pass(self, ctx: ExecContext,
                     batches: List[DeviceBatch]) -> Iterator[DeviceBatch]:
        batch = concat_device_batches(batches, self.children[0].output,
                                      ctx.device)
        del batches[:]      # the concatenation is all this pass needs
        fns = tuple(a.c if isinstance(a, Alias) else a for a in self.aggregates)
        grouping, pre_filter, subs, views = self._encoded_rewrite(ctx, batch)
        # the subtrees a fold repeated, evaluated once (exprs/cse.py)
        ng = len(grouping)
        shared, roots = common_subexpressions(
            grouping + fns + (pre_filter,), len(batch.columns))
        grouping, fns, pre_filter = roots[:ng], roots[ng:-1], roots[-1]
        base = eval_ctx(batch, ctx)
        base.encodings = views
        add_shared_columns(base, shared)
        mask = None
        if pre_filter is not None:
            p = bk.as_column(pre_filter.eval(base), batch.capacity)
            mask = p.data & p.validity
        self.modes_run = []
        for mode in grouping_modes(grouping, fns):
            self.modes_run.append(mode)
            ectx = eval_ctx(batch, ctx)
            ectx.columns = list(base.columns)
            ectx.encodings = views
            key_cols, res_cols, n, flagged = group_aggregate(
                ectx, grouping, fns, batch.num_rows, batch.capacity,
                grouping=mode, extra_mask=mask)
            if not flagged:
                break
        key_cols = list(key_cols)
        for j, spec in subs.items():
            # late materialization: only the groups' key values decode
            key_cols[j] = ed.materialize_key(base, spec, key_cols[j])
        yield batch_of(self.output, key_cols + list(res_cols), n)

    def _encoded_rewrite(self, ctx: ExecContext, batch: DeviceBatch):
        """(grouping, pre_filter, {key position: EncSpec}, EncViews): the
        grouping keys on encoded columns as index keys and the folded
        filter's single-column subtrees over the dictionaries, when this
        operator may run on the encoded domain and the batch kept an
        encoding; else the operator's own expressions."""
        from spark_rapids_tpu_torch.columnar import encoding as cenc
        grouping, pre = self.grouping, self.pre_filter
        if not (self.encoded_domain_ok
                and ctx.conf.get(cfg.ENCODED_DOMAIN)):
            return grouping, pre, {}, {}
        specs = cenc.enc_specs_of(batch)
        if not specs:
            return grouping, pre, {}, {}
        grouping, subs, used_g = ed.rewrite_grouping(grouping, specs)
        used_p: Tuple = ()
        if pre is not None:
            pre, used_p = ed.rewrite_predicate(pre, specs)
        merged = {s.ordinal: s for s in tuple(used_g) + tuple(used_p)}
        if merged:
            self.encoded_batches += 1
            _count_encoded_op()
        return grouping, pre, subs, cenc.enc_views(batch, merged.values())


class TpuSortExec(PhysicalExec):
    """A stable sort of the concatenated input; under memory pressure an
    external sort by range partitioning (memory/grace.py)."""

    #: input + the sort's key passes + the sorted output
    working_set_factor = 3.0

    def __init__(self, orders: Tuple[SortOrder, ...], child: PhysicalExec):
        super().__init__((child,), child.output)
        self.orders = orders

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()      # a permutation

    def working_set_estimate(self) -> Optional[int]:
        sz = self.children[0].size_estimate()
        return None if sz is None else int(sz * self.working_set_factor)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.memory import grace
        source = self.children[0].execute(ctx)
        ooc = grace.controller_for(self, ctx, "sort", (), orders=self.orders)
        if ooc is None:
            yield from self._single_pass(ctx, list(source))
            return
        mode, payload = ooc.stage(source, (), orders=self.orders)
        if mode == "inline":
            yield from self._single_pass(ctx, payload)
            return
        yield from self._grace_execute(ctx, ooc, payload)

    def _grace_execute(self, ctx: ExecContext, ooc,
                       parts) -> Iterator[DeviceBatch]:
        """External sort by order-preserving range partitioning: sampled
        bounds split the key space, ties share a partition, and the
        per-partition stable sorts emitted in bound order are the merged
        output, bit-identical to the single pass. A skewed partition
        re-partitions on its own resampled bounds until it fits, the depth
        bound stops it, or a split proves degenerate."""
        try:
            degenerate = parts.degenerate
            for pid in parts.nonempty():
                ctx.check_cancelled()
                sub = None
                if not degenerate and ooc.should_recurse(
                        parts.bytes_of(pid), parts.depth):
                    sub = ooc.partition(parts.drain(pid), (),
                                        depth=parts.depth + 1,
                                        orders=self.orders)
                if sub is not None:
                    yield from self._grace_execute(ctx, ooc, sub)
                else:
                    batches = parts.take(pid)
                    if batches:
                        yield from self._single_pass(ctx, batches)
        finally:
            parts.close()

    def _single_pass(self, ctx: ExecContext,
                     batches: List[DeviceBatch]) -> Iterator[DeviceBatch]:
        batch = concat_device_batches(batches, self.output, ctx.device)
        del batches[:]
        if batch.num_rows:
            ectx = eval_ctx(batch, ctx)
            alive = bk.alive_mask(batch.capacity, batch.num_rows, batch.device)
            order = bk.sort_indices(
                [(bk.as_column(o.child.eval(ectx), batch.capacity),
                  o.ascending, o.nulls_first) for o in self.orders], alive)
            batch = batch_of(self.output, [bk.take_colv(v, order)
                                           for v in ectx.columns],
                             batch.num_rows)
        yield batch


class TpuLimitExec(PhysicalExec):
    """The first ``n`` rows: a batch is cut by shrinking its row count and
    invalidating the rows past it; no data moves."""

    def __init__(self, n: int, child: PhysicalExec):
        super().__init__((child,), child.output)
        self.n = n

    def size_estimate(self) -> Optional[int]:
        return limit_size_estimate(self.children[0], self.output, self.n)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        remaining = self.n
        for batch in self.children[0].execute(ctx):
            if remaining <= 0:
                break
            take = min(remaining, batch.num_rows)
            remaining -= take
            if take < batch.num_rows:
                alive = bk.alive_mask(batch.capacity, take, batch.device)
                batch = DeviceBatch(batch.schema, tuple(
                    DeviceColumn(c.dtype, c.data, c.validity & alive,
                                 c.lengths) for c in batch.columns), take)
            yield batch


class TpuUnionExec(PhysicalExec):
    """UNION ALL: each partition yields the left child's batches, then the
    right child's (the children share one schema; the left one names it).
    The port has no file scan, so it has none of the hidden input-file
    columns the JAX planner aligns across a union's branches."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec):
        super().__init__((left, right), left.output)

    def size_estimate(self) -> Optional[int]:
        sizes = [c.size_estimate() for c in self.children]
        return None if any(s is None for s in sizes) else sum(sizes)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for child in self.children:
            for batch in child.execute(ctx):
                yield DeviceBatch(self.output, batch.columns, batch.num_rows)


class TpuCoalesceBatchesExec(PhysicalExec):
    """Concatenate small batches toward a target size (GpuCoalesceBatches'
    TargetSize goal). Adaptive execution puts one above each coalesced
    device shuffle reader (plan/adaptive.py); ``require_single`` makes it
    emit exactly one batch."""

    def __init__(self, child: PhysicalExec, target_bytes: int,
                 require_single: bool = False):
        super().__init__((child,), child.output)
        self.target_bytes = target_bytes
        self.require_single = require_single

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()     # a concat: same rows

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        yield from coalesce_batches(self.children[0].execute(ctx),
                                    self.output, self.target_bytes,
                                    self.require_single, ctx.device)


def coalesce_batches(source: Iterator[DeviceBatch], schema: Schema,
                     target_bytes: int, require_single: bool,
                     device: torch.device) -> Iterator[DeviceBatch]:
    """The accumulate-until-target concat loop, shared by
    TpuCoalesceBatchesExec and the fused stage's coalesce
    (execs/fused_execs.py), so their flush rule is one: a group flushes
    once its device bytes reach the target; the rest flushes at the end,
    and ``require_single`` flushes only there, even when empty."""
    pending: List[DeviceBatch] = []
    pending_bytes = 0
    for batch in source:
        pending.append(batch)
        pending_bytes += batch.device_size_bytes
        if not require_single and pending_bytes >= target_bytes:
            yield concat_device_batches(pending, schema, device)
            pending, pending_bytes = [], 0
    if pending or require_single:
        yield concat_device_batches(pending, schema, device)
