"""Join physical operators: the shuffled and the broadcast hash join, and
the keyless broadcast nested-loop join and cartesian product (the JAX
package's ``execs/join_execs.py`` without its grace and encoded-domain
branches, which wait for those subsystems).

Both run ``ops/join.py``'s two phases over the concatenation of each side's
batches: the size phase, one host read of the output total, the gather at
the total's capacity bucket. A residual condition of an inner join is a
filter over the joined rows. The broadcast join differs only in its plan:
its build child is a broadcast exchange that every stream partition reads.
The keyless joins run the same exec with the ``cross`` kernel and their
condition as the filter.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema, bucket_capacity
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.tpu_execs import (batch_of, colvs_of,
                                                    concat_device_batches)
from spark_rapids_tpu_torch.exprs.core import EvalCtx, Expression
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops import join as jk


def legal_broadcast_sides(how: str) -> List[int]:
    """Child indices (1 = right, tried first; 0 = left) that may be the
    broadcast build side of this join kind: a preserved side of an outer
    join cannot be, or its unmatched rows would be emitted once per stream
    partition (Spark's BuildSide rules)."""
    sides = []
    if how in ("inner", "left", "left_semi", "left_anti", "cross"):
        sides.append(1)
    if how in ("inner", "right", "cross"):
        sides.append(0)
    return sides


class TpuShuffledHashJoinExec(PhysicalExec):
    """Equi-join of the two children's batches of one partition."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec, how: str,
                 left_keys: Tuple[Expression, ...],
                 right_keys: Tuple[Expression, ...], output: Schema,
                 condition: Optional[Expression] = None,
                 build_side: str = "right"):
        super().__init__((left, right), output)
        if how not in jk.JOIN_KINDS:
            raise ValueError(f"unsupported join type {how}")
        if build_side not in ("left", "right"):
            raise ValueError(f"invalid build side {build_side}")
        self.how = how
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.condition = condition
        #: the side materialized as the build table; a broadcast join's
        #: planner wraps that child in a broadcast exchange
        self.build_side = build_side

    @property
    def includes_right_columns(self) -> bool:
        return self.how not in ("left_semi", "left_anti")

    def size_estimate(self) -> Optional[int]:
        # the output's multiplicity is unknown without key statistics
        return None

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        lbatches = list(self.children[0].execute(ctx))
        rbatches = list(self.children[1].execute(ctx))
        yield self._single_pass(ctx, lbatches, rbatches)

    def _single_pass(self, ctx: ExecContext, lbatches,
                     rbatches) -> DeviceBatch:
        lb = concat_device_batches(lbatches, self.children[0].output,
                                   ctx.device)
        rb = concat_device_batches(rbatches, self.children[1].output,
                                   ctx.device)
        S, B = lb.capacity, rb.capacity
        l_cols, r_cols = colvs_of(lb), colvs_of(rb)
        smax = ctx.string_max_bytes

        def keys(cols, cap, exprs):
            ectx = EvalCtx(cols, cap, ctx.device, smax)
            return [bk.as_column(e.eval(ectx), cap) for e in exprs]

        sized = jk.join_size(keys(l_cols, S, self.left_keys),
                             keys(r_cols, B, self.right_keys),
                             bk.alive_mask(S, lb.num_rows, ctx.device),
                             bk.alive_mask(B, rb.num_rows, ctx.device),
                             self.how)
        total = int(sized["total"])            # the one host read
        out_cap = bucket_capacity(total)
        lrow, lvalid, rrow, rvalid, _ = jk.join_gather(sized, S, B, out_cap,
                                                       self.how)
        out_cols = jk.gather_join_output(
            l_cols, r_cols if self.includes_right_columns else [], lrow,
            lvalid, rrow, rvalid)
        n = total
        if self.condition is not None:
            pred = self.condition.eval(EvalCtx(out_cols, out_cap, ctx.device,
                                               smax))
            keep = (pred.data & pred.validity
                    & bk.alive_mask(out_cap, total, ctx.device))
            out_cols, n = bk.compact(keep, out_cols)
        return batch_of(self.output, out_cols, n)


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """The same join with its build side arriving through a broadcast
    exchange: the stream side keeps its partitioning and each of its
    partitions joins against the one cached build batch."""


class _NestedLoopMixin:
    """A keyless inner or cross join: the cross product of the two sides,
    then the condition (if any) as a filter over it."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec, how: str,
                 output: Schema, condition: Optional[Expression] = None,
                 build_side: str = "right"):
        if how not in ("inner", "cross"):
            raise ValueError(f"nested-loop and cartesian joins support "
                             f"inner and cross, not {how}")
        super().__init__(left, right, "cross", (), (), output, condition,
                         build_side)


class TpuBroadcastNestedLoopJoinExec(_NestedLoopMixin,
                                     TpuBroadcastHashJoinExec):
    """The build side arrives through a broadcast exchange; the stream
    side keeps its partitioning."""


class TpuCartesianProductExec(_NestedLoopMixin, TpuShuffledHashJoinExec):
    """Both sides in one partition each."""
