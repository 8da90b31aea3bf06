"""Plan rewrites the JAX package's ``plan/overrides.py`` runs after it
converts a plan onto the device, in the same order (``plan/planner.py``
``plan_physical``): whole-stage fusion (plan/fusion.py), then the
filter-into-aggregate fold (``fuse_device_ops``), which runs whether or not
fusion is on, then the pipeline boundaries (``insert_pipeline``), and last
the footprint contract over the final tree
(``plan/footprint.py::annotate_out_of_core``). The port
plans straight onto the device operators, so the rest of that module (the
CPU-to-device conversion and its tagging) has no counterpart here.
"""
from __future__ import annotations

import os

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.exprs.core import BoundReference, Expression


def _substitute_refs(e: Expression, repl) -> Expression:
    if isinstance(e, BoundReference):
        return repl[e.ordinal]
    return e.map_children(lambda c: _substitute_refs(c, repl))


def _has_nondeterministic(e: Expression) -> bool:
    from spark_rapids_tpu_torch.exprs.misc import (MonotonicallyIncreasingID,
                                                   Rand)
    if isinstance(e, (Rand, MonotonicallyIncreasingID)):
        return True
    return any(_has_nondeterministic(c) for c in e.children)


def fold_aggregate_chain(node, filter_cls, project_cls, max_ops=None):
    """The partial-aggregate fold, shared by ``fuse_device_ops`` and the
    whole-stage pass (plan/fusion.py) so both build identical aggregate
    expression trees. Walks the chain below ``node``: filter conditions AND
    into the pre-filter mask and projection expressions substitute into the
    grouping, aggregate and pre-filter expressions. A projection with a
    non-deterministic expression stops the walk. Returns (grouping, aggregates, pre_filter,
    chain child, folded nodes top-down)."""
    from spark_rapids_tpu_torch.exprs.misc import Alias
    from spark_rapids_tpu_torch.exprs.predicates import And

    grouping, aggs, pre = node.grouping, node.aggregates, node.pre_filter
    child = node.children[0]
    folded = []
    while max_ops is None or len(folded) < max_ops:
        if isinstance(child, filter_cls):
            cond = child.condition
            pre = cond if pre is None else And(cond, pre)
        elif isinstance(child, project_cls):
            repl = [a.c if isinstance(a, Alias) else a for a in child.exprs]
            if any(_has_nondeterministic(r) for r in repl):
                break
            grouping = tuple(_substitute_refs(g, repl) for g in grouping)
            aggs = tuple(_substitute_refs(a, repl) for a in aggs)
            if pre is not None:
                pre = _substitute_refs(pre, repl)
        else:
            break
        folded.append(child)
        child = child.children[0]
    return grouping, aggs, pre, child, tuple(folded)


def fuse_device_ops(plan: PhysicalExec) -> PhysicalExec:
    """Fold Filter/Project chains into the aggregate above them: the
    filter's predicate becomes the aggregate's row mask and the projections
    inline into its expressions, so the filtered batch never materializes
    (one compaction and one host read of a row count fewer). The
    whole-stage pass runs first and claims these chains when
    ``sql.fusion.enabled``; this pass covers them when fusion is off."""
    def fix(node: PhysicalExec) -> PhysicalExec:
        if type(node) is not te.TpuHashAggregateExec:
            return node
        grouping, aggs, pre, child, folded = fold_aggregate_chain(
            node, te.TpuFilterExec, te.TpuProjectExec)
        if folded:
            return te.TpuHashAggregateExec(grouping, aggs, child, node.output,
                                           pre_filter=pre)
        return node

    return plan.transform_up(fix)


def insert_pipeline(plan: PhysicalExec, conf: TpuConf) -> PhysicalExec:
    """Wrap the upload or file scan under each device operator in a
    PipelinedExec, so up to ``transfer.pipeline.depth`` batches are in
    flight between the producing source and the consuming stage instead of
    the strict pull-per-batch lockstep. Skipped on a single-core host: the
    producer thread needs a spare core."""
    from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
    depth = conf.get(cfg.TRANSFER_PIPELINE_DEPTH)
    if not conf.get(cfg.TRANSFER_PIPELINE_ENABLED) or depth <= 0:
        return plan
    if (os.cpu_count() or 1) < 2:
        return plan

    def is_source(node: PhysicalExec) -> bool:
        return (isinstance(node, te.HostToDeviceExec)
                or getattr(node, "is_file_scan", False))

    def fix(node: PhysicalExec) -> PhysicalExec:
        if not node.is_device or isinstance(node, PipelinedExec):
            return node
        new_children = [PipelinedExec(c, depth) if is_source(c) else c
                        for c in node.children]
        if all(a is b for a, b in zip(new_children, node.children)):
            return node
        return node.with_children(new_children)

    return plan.transform_up(fix)
