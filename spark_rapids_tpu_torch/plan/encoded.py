"""Planner pass: mark the operators that may run on the encoded domain
(the JAX package's ``plan/encoded.py``).

A scan's batches can arrive with columns that kept their dictionary
encoding (columnar/encoding.py). This pass walks the final device plan and
flags the filters, aggregates, fused stages with a predicate and shuffled
joins whose input chain can deliver such batches, so the runtime rewrite
(exprs/encoded.py) runs only where an encoding can exist, and
``count_encoded_domain`` reports how many operators were planned onto it.

The flag is an upper bound, not a promise: the operator still checks each
batch's columns when it runs (a column whose encoding did not survive the
upload or a concatenation stays decoded).
"""
from __future__ import annotations

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import PhysicalExec


def _preserves_encoding(node: PhysicalExec) -> bool:
    """Whether this subtree can yield batches with surviving dictionary
    encodings. Sources: the device file scan, the upload (an arrow table
    may hold dictionary columns) and the cached scan. Pass-throughs: the
    pipeline, the coalesce (its concatenation keeps an encoding its
    contributors share, ``concat_device_batches``) and a union of
    sources. Every other operator rebuilds its columns, which drops the
    encoded form."""
    from spark_rapids_tpu_torch.execs.cache_execs import TpuCachedScanExec
    from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
    if getattr(node, "is_file_scan", False) and node.is_device:
        return True
    if isinstance(node, (te.HostToDeviceExec, TpuCachedScanExec)):
        return True
    if isinstance(node, (PipelinedExec, te.TpuCoalesceBatchesExec,
                         te.TpuUnionExec)):
        return any(_preserves_encoding(c) for c in node.children)
    return False


def mark_encoded_domain(plan: PhysicalExec, conf: TpuConf) -> PhysicalExec:
    """Set ``encoded_domain_ok`` on every eligible operator and return the
    plan (changed in place: the flag is execution metadata, not plan
    structure). Nothing is marked with sql.encodedDomain.enabled off."""
    if not conf.get(cfg.ENCODED_DOMAIN):
        return plan
    from spark_rapids_tpu_torch.execs.fused_execs import FusedStageExec
    from spark_rapids_tpu_torch.execs.join_execs import (
        TpuShuffledHashJoinExec, _NestedLoopMixin)

    def walk(node: PhysicalExec) -> None:
        for c in node.children:
            walk(c)
        if isinstance(node, (te.TpuFilterExec, te.TpuHashAggregateExec)):
            # the fused aggregate too: it inherits the rewrite of its
            # grouping keys and folded filter
            if _preserves_encoding(node.children[0]):
                node.encoded_domain_ok = True
        elif isinstance(node, FusedStageExec) and node.has_predicate:
            # a fused chain's predicate is over the stage input, so it
            # rewrites onto dictionary indices as a filter's does
            if _preserves_encoding(node.children[0]):
                node.encoded_domain_ok = True
        elif (isinstance(node, TpuShuffledHashJoinExec)
              and not isinstance(node, _NestedLoopMixin)):
            if any(_preserves_encoding(c) for c in node.children):
                node.encoded_domain_ok = True

    walk(plan)
    return plan


def count_encoded_domain(plan: PhysicalExec) -> int:
    """Operators planned onto the encoded domain."""
    return sum(1 for n in plan.walk()
               if getattr(n, "encoded_domain_ok", False))
