"""Device physical operators: upload/download transitions, project,
filter, hash aggregate, sort and limit. Each evaluates its expressions
eagerly on the batch's tensors; the live row count of a result reaches the
host once per batch to pick the output's capacity bucket, as in the JAX
package."""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, pad_rows
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Field, Schema,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import download, upload
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import (limit_size_estimate,
                                                    width_scaled_estimate)
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.aggregate import (group_aggregate,
                                                  grouping_modes)


def colvs_of(batch: DeviceBatch) -> List[ColV]:
    return [ColV(c.dtype, c.data, c.validity, c.lengths)
            for c in batch.columns]


def eval_ctx(batch: DeviceBatch, ctx: ExecContext) -> EvalCtx:
    return EvalCtx(colvs_of(batch), batch.capacity, batch.device,
                   ctx.string_max_bytes)


def batch_of(schema: Schema, colvs, num_rows: int) -> DeviceBatch:
    return DeviceBatch(schema, tuple(
        DeviceColumn(f.dtype, v.data, v.validity, v.lengths)
        for f, v in zip(schema, colvs)), num_rows)


def concat_device_batches(batches: List[DeviceBatch], schema: Schema,
                          device: torch.device) -> DeviceBatch:
    """Concatenate the live rows of batches into one batch of the total's
    capacity bucket (string matrices padded to the widest)."""
    batches = [b for b in batches if b.num_rows > 0]
    if not batches:
        return DeviceBatch.empty(schema, device)
    if len(batches) == 1:
        return batches[0]
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
        cols.append(DeviceColumn(f.dtype, data, validity, lengths))
    return DeviceBatch(schema, tuple(cols), total)


# ---------------------------------------------------------------- transitions
class HostToDeviceExec(PhysicalExec):
    """Upload transition: each host batch goes to the context's device."""

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for hb in self.children[0].execute(ctx):
            yield upload(hb, ctx.device)


class DeviceToHostExec(PhysicalExec):
    """Download transition: live rows back to host numpy buffers."""

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        for db in self.children[0].execute(ctx):
            yield download(db)


# ---------------------------------------------------------------- operators
def output_schema(exprs: Tuple[Expression, ...]) -> Schema:
    return Schema([Field(e.name_hint, e.dtype(), e.nullable())
                   for e in exprs])


class TpuProjectExec(PhysicalExec):
    def __init__(self, exprs: Tuple[Expression, ...], child: PhysicalExec):
        super().__init__((child,), output_schema(exprs))
        self.exprs = exprs

    def size_estimate(self) -> Optional[int]:
        return width_scaled_estimate(self.children[0], self.output)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for batch in self.children[0].execute(ctx):
            ectx = eval_ctx(batch, ctx)
            yield batch_of(self.output,
                           [bk.as_column(e.eval(ectx), batch.capacity)
                            for e in self.exprs], batch.num_rows)


class TpuFilterExec(PhysicalExec):
    def __init__(self, condition: Expression, child: PhysicalExec):
        super().__init__((child,), child.output)
        self.condition = condition

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()      # an upper bound

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for batch in self.children[0].execute(ctx):
            pred = self.condition.eval(eval_ctx(batch, ctx))
            alive = bk.alive_mask(batch.capacity, batch.num_rows, batch.device)
            keep = (pred.data & pred.validity) & alive
            cols, n = bk.compact(keep, colvs_of(batch))
            yield batch_of(self.output, cols, n)


class TpuHashAggregateExec(PhysicalExec):
    """Grouped aggregation over the concatenation of the child's batches.
    The fastest grouping runs first and the next one only when it raised
    its flag: one-hot, then hash, then the exact sort (the JAX package's
    ``tpu_execs.py`` escalation)."""

    def __init__(self, grouping: Tuple[Expression, ...],
                 aggregates: Tuple[Expression, ...], child: PhysicalExec,
                 output: Schema):
        super().__init__((child,), output)
        self.grouping = grouping
        self.aggregates = aggregates
        #: grouping modes run by the last execution, in order
        self.modes_run: List[str] = []

    def size_estimate(self) -> Optional[int]:
        # groups never outnumber input rows
        return width_scaled_estimate(self.children[0], self.output)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        batch = concat_device_batches(list(self.children[0].execute(ctx)),
                                      self.children[0].output, ctx.device)
        fns = tuple(a.c if isinstance(a, Alias) else a for a in self.aggregates)
        self.modes_run = []
        for mode in grouping_modes(self.grouping):
            self.modes_run.append(mode)
            key_cols, res_cols, n, flagged = group_aggregate(
                eval_ctx(batch, ctx), self.grouping, fns, batch.num_rows,
                batch.capacity, grouping=mode)
            if not flagged:
                break
        yield batch_of(self.output, list(key_cols) + list(res_cols), n)


class TpuSortExec(PhysicalExec):
    def __init__(self, orders: Tuple[SortOrder, ...], child: PhysicalExec):
        super().__init__((child,), child.output)
        self.orders = orders

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()      # a permutation

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        batch = concat_device_batches(list(self.children[0].execute(ctx)),
                                      self.output, ctx.device)
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
