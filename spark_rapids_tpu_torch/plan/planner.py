"""Logical -> physical planning, straight onto the device operators.

The JAX package plans a CPU physical plan and rewrites the supported parts
onto the TPU; the port has no CPU engine, so it plans the device operators
directly, binds expressions to child ordinals, and inserts exchanges where an
operator needs one partition (``ensure_requirements``). An operator it cannot
plan raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuLocalScanExec
from spark_rapids_tpu_torch.execs.exchange_execs import (
    HashPartitioning, RoundRobinPartitioning, SinglePartitioning,
    TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.execs.tpu_execs import (
    DeviceToHostExec, HostToDeviceExec, TpuFilterExec, TpuHashAggregateExec,
    TpuSortExec)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction, Average, Sum
from spark_rapids_tpu_torch.exprs.core import Expression, bind_expression
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.plan import logical as lp


def plan_physical(plan: lp.LogicalPlan, conf: TpuConf) -> PhysicalExec:
    """Device plan for ``plan``, ending in the download transition."""
    return DeviceToHostExec(ensure_requirements(_plan_node(plan, conf)))


def ensure_requirements(plan: PhysicalExec) -> PhysicalExec:
    """Aggregates and sorts see all their input in one partition: over a
    partitioned child they get a single-partition exchange."""
    def fix(node: PhysicalExec) -> PhysicalExec:
        if not isinstance(node, (TpuHashAggregateExec, TpuSortExec)):
            return node
        child = node.children[0]
        if child.num_partitions <= 1:
            return node
        return node.with_children(
            [TpuShuffleExchangeExec(SinglePartitioning(), child)])
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
    if isinstance(plan, lp.Filter):
        child = _plan_node(plan.child, conf)
        return TpuFilterExec(bind_expression(plan.condition, child.output),
                             child)
    if isinstance(plan, lp.Aggregate):
        child = _plan_node(plan.child, conf)
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
        child = _plan_node(plan.child, conf)
        orders = tuple(SortOrder(bind_expression(o.child, child.output),
                                 o.ascending, o.nulls_first)
                       for o in plan.orders)
        return TpuSortExec(orders, child)
    if isinstance(plan, lp.Repartition):
        child = _plan_node(plan.child, conf)
        if not plan.keys:
            return TpuShuffleExchangeExec(
                RoundRobinPartitioning(plan.num_partitions), child)
        part = HashPartitioning(
            plan.num_partitions,
            tuple(bind_expression(e, child.output) for e in plan.keys))
        return TpuShuffleExchangeExec(part, child)
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the PyTorch port")


def _named(bound: Expression, original: Expression) -> Alias:
    """Keep the user-facing name through binding."""
    return bound if isinstance(bound, Alias) else Alias(bound,
                                                        original.name_hint)
