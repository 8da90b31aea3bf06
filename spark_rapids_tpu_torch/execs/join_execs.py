"""Join physical operators: the shuffled and the broadcast hash join, and
the keyless broadcast nested-loop join and cartesian product (the JAX
package's ``execs/join_execs.py``).

Both run ``ops/join.py``'s two phases over the concatenation of each side's
batches: the size phase, one host read of the output total, the gather at
the total's capacity bucket. A residual condition of an inner join is a
filter over the joined rows. The broadcast join differs only in its plan:
its build child is a broadcast exchange that every stream partition reads.
Under memory pressure a keyed join goes out of core (memory/grace.py):
both sides are hash-partitioned on their keys with the same salt and each
pair of partitions runs the single pass. The keyless joins run the same
exec with the ``cross`` kernel and their condition as the filter, always
in one pass (they have no key to split by). The ``Cpu*`` forms at the end
are the CPU engine's (execs/cpu_execs.py); ``CpuSortMergeJoinExec`` comes
only from imported Catalyst plans. An equi-key pair whose two
columns kept their dictionary encodings matches on the int32 indices
(``_encoded_key_pairs``): directly when the sides share a dictionary
stream, through a k_l x k_r remap of the right dictionary otherwise.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema, bucket_capacity
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec
from spark_rapids_tpu_torch.execs.tpu_execs import (batch_of, colvs_of,
                                                    concat_device_batches)
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
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

    #: the output's multiplicity depends on the keys' (size_estimate)
    size_estimate_none_reason = ("join output multiplicity is unknown "
                                 "without key statistics")

    #: both sides resident + the gather output while the join runs: the
    #: footprint contract's and the pressure check's factor
    working_set_factor = 3.0

    #: set by plan/encoded.py: equi-key pairs whose both sides kept their
    #: dictionary encoding match on indices
    encoded_domain_ok = False

    #: different-dictionary remaps above this k_l * k_r stay decoded (the
    #: equality matrix would no longer be small)
    _REMAP_CELLS_CAP = 1 << 22

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
        #: passes of the last execution that matched keys on indices
        self.encoded_batches = 0

    @property
    def includes_right_columns(self) -> bool:
        return self.how not in ("left_semi", "left_anti")

    def size_estimate(self) -> Optional[int]:
        return None             # size_estimate_none_reason

    def working_set_estimate(self) -> Optional[int]:
        sizes = [c.size_estimate() for c in self.children]
        if any(s is None for s in sizes):
            return None
        return int(sum(sizes) * self.working_set_factor)

    def _encoded_key_pairs(self, ctx: ExecContext, lb: DeviceBatch,
                           rb: DeviceBatch):
        """The key pairs that match on dictionary indices: both keys plain
        references to encoded columns of one non-float type, and either one
        dictionary stream or a remap under the cell cap. Float keys stay
        decoded (index identity is finer than float equality)."""
        from spark_rapids_tpu_torch import config as cfg
        from spark_rapids_tpu_torch.columnar import encoding as cenc
        from spark_rapids_tpu_torch.exprs import encoded as ed
        from spark_rapids_tpu_torch.exprs.core import BoundReference
        if not (self.encoded_domain_ok
                and ctx.conf.get(cfg.ENCODED_DOMAIN)):
            return ()
        lspecs = {s.ordinal: s for s in cenc.enc_specs_of(lb)}
        rspecs = {s.ordinal: s for s in cenc.enc_specs_of(rb)}
        pairs = []
        for pos, (lk, rk) in enumerate(zip(self.left_keys,
                                           self.right_keys)):
            if not (isinstance(lk, BoundReference)
                    and isinstance(rk, BoundReference)):
                continue
            ls, rs = lspecs.get(lk.ordinal), rspecs.get(rk.ordinal)
            if ls is None or rs is None or ls.dtype != rs.dtype:
                continue
            if ls.dtype.is_floating:
                continue
            le = lb.columns[lk.ordinal].encoding
            re_ = rb.columns[rk.ordinal].encoding
            same = le.token is not None and le.token == re_.token
            if not same and ls.k * rs.k > self._REMAP_CELLS_CAP:
                continue
            pairs.append(ed.EncJoinKey(pos, ls, rs, same))
        return tuple(pairs)

    def _index_keys(self, pairs, lb: DeviceBatch, rb: DeviceBatch,
                    lkeys: List[ColV], rkeys: List[ColV]) -> None:
        """Replace the paired key columns by their (remapped) indices."""
        from spark_rapids_tpu_torch.columnar.dtypes import DType
        from spark_rapids_tpu_torch.columnar.encoding import EncView
        from spark_rapids_tpu_torch.exprs import encoded as ed
        for p in pairs:
            lv = EncView(p.left, lb.columns[p.left.ordinal].encoding)
            rv = EncView(p.right, rb.columns[p.right.ordinal].encoding)
            r_idx = rv.indices
            if not p.same_token:
                remap = ed.dict_remap(lv.values, rv.values, p.left.k)
                r_idx = remap.index_select(0, rv.indices)
            lkeys[p.pos] = ColV(DType.INT, lv.indices,
                                lkeys[p.pos].validity)
            rkeys[p.pos] = ColV(DType.INT, r_idx, rkeys[p.pos].validity)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.memory import grace
        self.encoded_batches = 0
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        ooc = (grace.controller_for(self, ctx, "join",
                                    self.left_keys + self.right_keys)
               if self.left_keys else None)
        if ooc is None:
            yield self._single_pass(ctx, list(left), list(right))
            return
        mode, payload = ooc.stage_two(left, right, self.left_keys,
                                      self.right_keys)
        if mode == "inline":
            yield self._single_pass(ctx, *payload)
            return
        yield from self._grace_execute(ctx, ooc, *payload)

    def _grace_execute(self, ctx: ExecContext, ooc, lparts,
                       rparts) -> Iterator[DeviceBatch]:
        """Both sides partitioned by the same depth-salted hash of their
        keys, so every key's rows (and the null-key outer rows: nulls hash
        to one constant) meet in exactly one pair of partitions; the
        per-pair joins union to the global result. A pair still over
        budget re-partitions both sides with a deeper salt, unless the
        split proved degenerate (one indivisible key group on both
        sides)."""
        try:
            degenerate = lparts.degenerate and rparts.degenerate
            for pid in range(lparts.n):
                nbytes = lparts.bytes_of(pid) + rparts.bytes_of(pid)
                if nbytes == 0:
                    continue
                if not degenerate and ooc.should_recurse(nbytes,
                                                         lparts.depth):
                    # drain() feeds each side's re-split one piece at a time
                    lsub = ooc.partition(lparts.drain(pid), self.left_keys,
                                         depth=lparts.depth + 1)
                    rsub = ooc.partition(rparts.drain(pid), self.right_keys,
                                         depth=rparts.depth + 1)
                    yield from self._grace_execute(ctx, ooc, lsub, rsub)
                else:
                    lbatches = lparts.take(pid)
                    rbatches = rparts.take(pid)
                    if lbatches or rbatches:
                        yield self._single_pass(ctx, lbatches, rbatches)
        finally:
            lparts.close()
            rparts.close()

    def _single_pass(self, ctx: ExecContext, lbatches,
                     rbatches) -> DeviceBatch:
        lb = concat_device_batches(lbatches, self.children[0].output,
                                   ctx.device)
        rb = concat_device_batches(rbatches, self.children[1].output,
                                   ctx.device)
        # the concatenations are all the pass needs
        del lbatches[:], rbatches[:]
        S, B = lb.capacity, rb.capacity
        l_cols, r_cols = colvs_of(lb), colvs_of(rb)
        smax = ctx.string_max_bytes

        def keys(cols, cap, n, exprs):
            ectx = EvalCtx(cols, cap, ctx.device, smax,
                           host_engine=ctx.host_engine, num_rows=n)
            return [bk.as_column(e.eval(ectx), cap) for e in exprs]

        lkeys = keys(l_cols, S, lb.num_rows, self.left_keys)
        rkeys = keys(r_cols, B, rb.num_rows, self.right_keys)
        pairs = self._encoded_key_pairs(ctx, lb, rb)
        if pairs:
            from spark_rapids_tpu_torch.execs.tpu_execs import \
                _count_encoded_op
            self._index_keys(pairs, lb, rb, lkeys, rkeys)
            self.encoded_batches += 1
            _count_encoded_op()
        sized = jk.join_size(lkeys, rkeys,
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
                                               smax,
                                               host_engine=ctx.host_engine,
                                               num_rows=total))
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


# ------------------------------------------------------------------ CPU engine
class CpuHashJoinExec(CpuEngineExec):
    """The CPU engine's equi-join (the JAX package's ``CpuHashJoinExec``):
    the shuffled hash join run on the host."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec, how: str,
                 left_keys: Tuple[Expression, ...],
                 right_keys: Tuple[Expression, ...], output: Schema,
                 condition: Optional[Expression] = None,
                 build_side: str = "right"):
        self.how = how
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.condition = condition
        self.build_side = build_side
        self._output = output
        super().__init__((left, right))

    #: the device operator the CPU form runs on the host
    _twin_cls = TpuShuffledHashJoinExec

    def device_twin(self, children):
        return self._twin_cls(children[0], children[1], self.how,
                              self.left_keys, self.right_keys, self._output,
                              self.condition, self.build_side)


class CpuSortMergeJoinExec(CpuHashJoinExec):
    """Spark's SortMergeJoinExec, whose children EnsureRequirements sorted
    on the join keys. The port's planner never makes one: it enters through
    imported Catalyst plans (plan/catalyst_import.py). It runs as a hash
    join (the same equi-join result); the plan layer replaces it with the
    device shuffled hash join and drops the join-key sorts
    (GpuSortMergeJoinExec; ``sql.replaceSortMergeJoin.enabled``)."""


class CpuBroadcastHashJoinExec(CpuHashJoinExec):
    """The equi-join whose build child is a broadcast exchange."""

    _twin_cls = TpuBroadcastHashJoinExec


class _CpuNestedLoopMixin:
    """A keyless inner or cross join; ``join_type`` is the join kind asked
    for (the device form runs the ``cross`` kernel and the condition)."""

    def __init__(self, left: PhysicalExec, right: PhysicalExec, how: str,
                 output: Schema, condition: Optional[Expression] = None,
                 build_side: str = "right"):
        if how not in ("inner", "cross"):
            raise ValueError(f"nested-loop and cartesian joins support "
                             f"inner and cross, not {how}")
        self.join_type = how
        super().__init__(left, right, "cross", (), (), output, condition,
                         build_side)

    def device_twin(self, children):
        return self._twin_cls(children[0], children[1], self.join_type,
                              self._output, self.condition, self.build_side)


class CpuNestedLoopJoinExec(_CpuNestedLoopMixin, CpuHashJoinExec):
    """The broadcast nested-loop join: the build child is a broadcast
    exchange, the stream side keeps its partitioning."""

    _twin_cls = TpuBroadcastNestedLoopJoinExec


class CpuCartesianProductExec(_CpuNestedLoopMixin, CpuHashJoinExec):
    """The cartesian product: both sides in one partition each."""

    _twin_cls = TpuCartesianProductExec
