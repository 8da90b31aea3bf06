"""The CPU engine (the JAX package's ``execs/cpu_execs.py``): the operators
the plan layer leaves off the device, and the whole plan under
``sql.enabled=false``.

A CPU engine operator runs the port's own expressions and kernels on torch
CPU tensors, as the JAX package's CPU engine runs its kernel code eagerly
on numpy. Each ``Cpu*Exec`` names the device operator it would become
(``device_twin``; the plan layer's converters build the same one) and runs
that operator on the host: under ``ExecContext.on_host()`` the device is
the CPU, every host operator yields its batches as CPU ``DeviceBatch``es,
and ``EvalCtx.host_engine`` sends the regular expressions, a general LIKE
and a Python UDF down the JAX numpy engine's branches. Called by a device
or host parent outside the engine, a CPU operator yields ``HostBatch``es.

This is not a session with ``device="cpu"``: that session runs the
device path's semantics on the CPU. The CPU engine is what the JAX
package's tagging falls back to.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                  concat_host_batches)
from spark_rapids_tpu_torch.execs.base import (ExecContext, LeafExec,
                                               PhysicalExec)
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.misc import SortOrder

#: nominal bytes per value of each type (the JAX package's size estimates)
_DTYPE_WIDTH = {DType.BOOLEAN: 1, DType.BYTE: 1, DType.SHORT: 2,
                DType.INT: 4, DType.FLOAT: 4, DType.DATE: 4, DType.LONG: 8,
                DType.DOUBLE: 8, DType.TIMESTAMP: 8, DType.STRING: 20,
                DType.NULL: 1}

_CPU = torch.device("cpu")


def _row_width(schema: Schema) -> int:
    """Nominal bytes per row: what a stage's statistics charge a row."""
    return sum(_DTYPE_WIDTH.get(f.dtype, 8) for f in schema)


def width_scaled_estimate(child: PhysicalExec,
                          out_schema: Schema) -> Optional[int]:
    """The child's estimate scaled by the output/input nominal row widths
    (projections, aggregates as an upper bound); None propagates."""
    child_sz = child.size_estimate()
    if child_sz is None:
        return None
    return int(child_sz * _row_width(out_schema)
               / max(_row_width(child.output), 1))


def limit_size_estimate(child: PhysicalExec, out_schema: Schema,
                        n: int) -> Optional[int]:
    """n rows at the nominal width, or the child's estimate if smaller."""
    cap = n * _row_width(out_schema)
    child_sz = child.size_estimate()
    return cap if child_sz is None else min(cap, child_sz)


def engine_batch(hb: HostBatch):
    """A host batch as the CPU engine's batch: a DeviceBatch of CPU
    tensors."""
    from spark_rapids_tpu_torch.columnar.transfer import upload
    return upload(hb, _CPU)


class CpuLocalScanExec(LeafExec):
    """An in-memory table, on the host."""

    is_device = False

    def __init__(self, batch: HostBatch):
        super().__init__(batch.schema)
        self.batch = batch

    def size_estimate(self) -> int:
        return self.batch.nbytes

    def execute(self, ctx: ExecContext) -> Iterator:
        if ctx.partition_id == 0:
            yield engine_batch(self.batch) if ctx.host_engine else self.batch


class CpuEngineExec(PhysicalExec):
    """An operator of the CPU engine: its device twin, run on the host.
    The twin is built over this operator's own children (which yield CPU
    DeviceBatches inside the engine) once per set of children, so state a
    twin keeps across the partitions of one action (an exchange's map
    side, a broadcast's batch) lives as long as the plan node."""

    is_device = False

    def __init__(self, children: Sequence[PhysicalExec]):
        form = self.device_twin(tuple(children))
        super().__init__(children, form.output)
        self._form = form

    def device_twin(self, children: Tuple[PhysicalExec, ...]
                    ) -> PhysicalExec:
        """The device operator this one becomes over ``children``."""
        raise NotImplementedError(self.name)

    def device_form(self) -> PhysicalExec:
        if self._form.children != self.children:
            self._form = self.device_twin(self.children)
        return self._form

    @property
    def num_partitions(self) -> int:
        return self.device_form().num_partitions

    def size_estimate(self) -> Optional[int]:
        return self.device_form().size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator:
        from spark_rapids_tpu_torch.columnar.transfer import download
        if ctx.host_engine:
            yield from self.device_form().execute(ctx)
            return
        for db in self.device_form().execute(ctx.on_host()):
            yield download(db)


class CpuRangeExec(CpuEngineExec):
    """``session.range`` on the host (GpuRangeExec's CPU side)."""

    def __init__(self, start: int, end: int, step: int):
        self.start, self.end, self.step = start, end, step
        super().__init__(())

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuRangeExec
        return TpuRangeExec(self.start, self.end, self.step)


class CpuProjectExec(CpuEngineExec):
    def __init__(self, exprs: Tuple[Expression, ...], child: PhysicalExec):
        self.exprs = exprs
        super().__init__((child,))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuProjectExec
        return TpuProjectExec(self.exprs, children[0])


class CpuFilterExec(CpuEngineExec):
    def __init__(self, condition: Expression, child: PhysicalExec):
        self.condition = condition
        super().__init__((child,))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuFilterExec
        return TpuFilterExec(self.condition, children[0])


class CpuHashAggregateExec(CpuEngineExec):
    """Whole-input aggregation; ``pre_filter`` is a folded filter
    (``fuse_device_ops`` folds CPU chains too)."""

    def __init__(self, grouping: Tuple[Expression, ...],
                 aggregates: Tuple[Expression, ...], child: PhysicalExec,
                 output: Schema, pre_filter: Optional[Expression] = None):
        self.grouping = grouping
        self.aggregates = aggregates
        self.pre_filter = pre_filter
        self._output = output
        super().__init__((child,))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import \
            TpuHashAggregateExec
        return TpuHashAggregateExec(self.grouping, self.aggregates,
                                    children[0], self._output,
                                    pre_filter=self.pre_filter)


class CpuSortExec(CpuEngineExec):
    """A total sort of the partition."""

    def __init__(self, orders: Tuple[SortOrder, ...], child: PhysicalExec):
        self.orders = orders
        super().__init__((child,))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuSortExec
        return TpuSortExec(self.orders, children[0])


class CpuLimitExec(CpuEngineExec):
    def __init__(self, n: int, child: PhysicalExec):
        self.n = n
        super().__init__((child,))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuLimitExec
        return TpuLimitExec(self.n, children[0])


class CpuUnionExec(CpuEngineExec):
    def __init__(self, left: PhysicalExec, right: PhysicalExec):
        super().__init__((left, right))

    def device_twin(self, children):
        from spark_rapids_tpu_torch.execs.tpu_execs import TpuUnionExec
        return TpuUnionExec(children[0], children[1])


class CpuCollectExec(PhysicalExec):
    """A plan root that drains its child's host batches into one."""

    is_device = False

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def collect(self, ctx: ExecContext) -> HostBatch:
        return concat_host_batches(list(self.children[0].execute(ctx)),
                                   self.output)

    def execute(self, ctx: ExecContext) -> Iterator:
        yield from self.children[0].execute(ctx)
