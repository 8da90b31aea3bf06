"""Logical -> physical planning, straight onto the device operators.

The JAX package plans a CPU physical plan and rewrites the supported parts
onto the TPU; the port has no CPU engine, so it plans the device operators
directly, binds expressions to child ordinals, picks each join's strategy
(``_select_join``) and satisfies the operators' distribution requirements
(``ensure_requirements``). An operator it cannot plan raises
``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuLocalScanExec
from spark_rapids_tpu_torch.execs.exchange_execs import (
    HashPartitioning, RangePartitioning, RoundRobinPartitioning,
    SinglePartitioning, TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.execs.join_execs import (
    TpuBroadcastHashJoinExec, TpuBroadcastNestedLoopJoinExec,
    TpuCartesianProductExec, TpuShuffledHashJoinExec, legal_broadcast_sides)
from spark_rapids_tpu_torch.execs.tpu_execs import (
    DeviceToHostExec, HostToDeviceExec, TpuFilterExec, TpuHashAggregateExec,
    TpuLimitExec, TpuProjectExec, TpuSortExec)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction, Average, Sum
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import Expression, bind_expression
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.plan import logical as lp


def plan_physical(plan: lp.LogicalPlan, conf: TpuConf) -> PhysicalExec:
    """Device plan for ``plan``, ending in the download transition."""
    return DeviceToHostExec(ensure_requirements(_plan_node(plan, conf)))


def ensure_requirements(plan: PhysicalExec) -> PhysicalExec:
    """Distribution requirements, as the JAX package's planner sets them:
    a broadcast join's build side gets a broadcast exchange (the stream side
    keeps its partitioning); a sort over a partitioned child gets a range
    exchange and sorts each range; aggregates, limits and shuffled joins
    see all their input in one partition, through a single-partition
    exchange over a partitioned child."""
    def fix(node: PhysicalExec) -> PhysicalExec:
        if isinstance(node, TpuBroadcastHashJoinExec):
            bi = 0 if node.build_side == "left" else 1
            if isinstance(node.children[bi], TpuBroadcastExchangeExec):
                return node
            kids = list(node.children)
            kids[bi] = TpuBroadcastExchangeExec(kids[bi])
            return node.with_children(kids)
        if isinstance(node, TpuSortExec):
            child = node.children[0]
            if child.num_partitions <= 1:
                return node
            return node.with_children([TpuShuffleExchangeExec(
                RangePartitioning(child.num_partitions, node.orders), child)])
        if not isinstance(node, (TpuHashAggregateExec, TpuLimitExec,
                                 TpuShuffledHashJoinExec)):
            return node
        kids = [TpuShuffleExchangeExec(SinglePartitioning(), c)
                if c.num_partitions > 1 else c for c in node.children]
        if all(a is b for a, b in zip(kids, node.children)):
            return node
        return node.with_children(kids)
    return plan.transform_up(fix)


def _check_float_aggs(aggs, conf: TpuConf) -> None:
    """Float sums vary with evaluation order; without
    sql.variableFloatAgg.enabled the JAX package runs them on its CPU
    engine, which the port does not have, so the plan is refused."""
    if conf.get(cfg.ENABLE_FLOAT_AGG):
        return
    for a in aggs:
        fn = a.c if isinstance(a, Alias) else a
        if isinstance(fn, Average) or (isinstance(fn, Sum)
                                       and fn.c.dtype().is_floating):
            raise NotImplementedError(
                f"{type(fn).__name__} over floating input needs "
                f"{cfg.ENABLE_FLOAT_AGG.key}=true")


def _plan_node(plan: lp.LogicalPlan, conf: TpuConf) -> PhysicalExec:
    if isinstance(plan, lp.LocalRelation):
        return HostToDeviceExec(CpuLocalScanExec(plan.batch))
    if isinstance(plan, lp.Join):
        return _plan_join(plan, conf)
    child = _plan_node(plan.child, conf) if plan.children else None
    if isinstance(plan, lp.Project):
        return TpuProjectExec(tuple(_named(bind_expression(e, child.output),
                                           e) for e in plan.exprs), child)
    if isinstance(plan, lp.Filter):
        return TpuFilterExec(bind_expression(plan.condition, child.output),
                             child)
    if isinstance(plan, lp.Aggregate):
        cs = child.output
        grouping = tuple(bind_expression(e, cs) for e in plan.grouping)
        aggs = tuple(_named(bind_expression(e, cs), e) for e in plan.aggregates)
        for a in aggs:
            if not isinstance(a.c, AggregateFunction):
                raise NotImplementedError(
                    f"aggregate expression {a} is not an aggregate function")
        _check_float_aggs(aggs, conf)
        return TpuHashAggregateExec(grouping, aggs, child, plan.schema())
    if isinstance(plan, lp.Sort):
        orders = tuple(SortOrder(bind_expression(o.child, child.output),
                                 o.ascending, o.nulls_first)
                       for o in plan.orders)
        return TpuSortExec(orders, child)
    if isinstance(plan, lp.Limit):
        return TpuLimitExec(plan.n, child)
    if isinstance(plan, lp.Repartition):
        if not plan.keys:
            return TpuShuffleExchangeExec(
                RoundRobinPartitioning(plan.num_partitions), child)
        part = HashPartitioning(
            plan.num_partitions,
            tuple(bind_expression(e, child.output) for e in plan.keys))
        return TpuShuffleExchangeExec(part, child)
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the PyTorch port")


def _plan_join(plan: lp.Join, conf: TpuConf) -> PhysicalExec:
    left = _plan_node(plan.left, conf)
    right = _plan_node(plan.right, conf)
    lkeys = [bind_expression(e, left.output) for e in plan.left_keys]
    rkeys = [bind_expression(e, right.output) for e in plan.right_keys]
    # both keys of a pair share one type, or equal keys could land in
    # different sort groups (Catalyst's coercion)
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        ct = DType.common_type(lk.dtype(), rk.dtype())
        if lk.dtype() != ct:
            lkeys[i] = Cast(lk, ct)
        if rk.dtype() != ct:
            rkeys[i] = Cast(rk, ct)
    out_schema = plan.schema()
    cond = (bind_expression(plan.condition, out_schema)
            if plan.condition is not None else None)
    if cond is not None and plan.how not in ("inner", "cross"):
        # a post-join filter equals a join condition only for inner and
        # cross joins
        raise NotImplementedError(
            f"join conditions are only supported for inner joins, not "
            f"{plan.how}")
    return _select_join(left, right, plan.how, tuple(lkeys), tuple(rkeys),
                        out_schema, cond, conf)


def _select_join(left: PhysicalExec, right: PhysicalExec, how: str,
                 lkeys: Tuple[Expression, ...], rkeys: Tuple[Expression, ...],
                 out_schema: Schema, cond, conf: TpuConf) -> PhysicalExec:
    """Spark's JoinSelection: the broadcast hash join when a legal build
    side's estimated size is at most sql.broadcastJoinThreshold.bytes (the
    right side first), else the shuffled hash join. A join without keys
    becomes the broadcast nested-loop join on the same rule, else the
    cartesian product. The JAX package keeps those two off the device
    unless sql.exec.NestedLoopJoin / sql.exec.CartesianProduct are set; the
    port has no CPU engine and always plans them."""
    threshold = conf.get(cfg.BROADCAST_JOIN_THRESHOLD)

    def broadcastable(side: PhysicalExec) -> bool:
        sz = side.size_estimate()
        return sz is not None and sz <= threshold

    if not lkeys:
        if how not in ("inner", "cross"):
            raise NotImplementedError(
                f"{how} join requires join keys (no nested-loop form)")
        for bi, side in ((1, right), (0, left)):
            if bi in legal_broadcast_sides(how) and broadcastable(side):
                return TpuBroadcastNestedLoopJoinExec(
                    left, right, how, out_schema, cond,
                    build_side="right" if bi == 1 else "left")
        return TpuCartesianProductExec(left, right, how, out_schema, cond)

    for bi, side in ((1, right), (0, left)):
        if bi in legal_broadcast_sides(how) and broadcastable(side):
            return TpuBroadcastHashJoinExec(
                left, right, how, lkeys, rkeys, out_schema, cond,
                build_side="right" if bi == 1 else "left")
    return TpuShuffledHashJoinExec(left, right, how, lkeys, rkeys, out_schema,
                                   cond)


def _named(bound: Expression, original: Expression) -> Alias:
    """Keep the user-facing name through binding."""
    return bound if isinstance(bound, Alias) else Alias(bound,
                                                        original.name_hint)
