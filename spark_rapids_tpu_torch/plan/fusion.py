"""Planner pass: whole-stage fusion of device operator chains (the JAX
package's ``plan/fusion.py``).

Collapses maximal chains of fusable operators between pipeline breakers into
``FusedStageExec`` / ``FusedAggregateStageExec`` (execs/fused_execs.py), so
the chain's interior batches are never built and its filters compact once.

Fusable: TpuProjectExec, TpuFilterExec, TpuExpandExec,
TpuCoalesceBatchesExec and a terminating TpuHashAggregateExec (the
pre-filter/substitution fold, shared with plan/overrides.py
``fuse_device_ops`` so fused and unfused plans build identical aggregate
expression trees); a Generate is an Expand and fuses as one. Everything
else ends a stage: exchanges, sorts, joins, limits, unions, windows and the
transitions.

Chains are normalized by reference substitution into per-variant (output
expressions, predicate) pairs over the stage's input schema: projections
substitute into the expressions above them, filters AND into the stage's
predicate, Expand projection lists multiply the variants, and a
CoalesceBatches moves to the stage's input (the row-wise operators commute
with a concatenation). Operators
with a non-deterministic expression (rand) break the chain: substitution
would duplicate or reorder its draws.

The coalesces come from adaptive execution (plan/adaptive.py puts one
above each coalesced device shuffle reader), whose re-fusion pass runs
this pass again over the rewritten plan.

Gated by ``sql.fusion.enabled`` and bounded by ``sql.fusion.maxOps``.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.execs.expand_execs import TpuExpandExec
from spark_rapids_tpu_torch.execs.fused_execs import (FusedAggregateStageExec,
                                                      FusedStageExec, Variant)
from spark_rapids_tpu_torch.exprs.core import BoundReference, Expression
from spark_rapids_tpu_torch.exprs.misc import Alias
from spark_rapids_tpu_torch.exprs.predicates import And
from spark_rapids_tpu_torch.plan.overrides import (_has_nondeterministic,
                                                   _substitute_refs,
                                                   fold_aggregate_chain)

_CHAIN_TYPES = (te.TpuProjectExec, te.TpuFilterExec, TpuExpandExec,
                te.TpuCoalesceBatchesExec)


def _node_exprs(node: PhysicalExec) -> Tuple[Expression, ...]:
    if isinstance(node, te.TpuProjectExec):
        return tuple(node.exprs)
    if isinstance(node, te.TpuFilterExec):
        return (node.condition,)
    if isinstance(node, TpuExpandExec):
        return tuple(x for p in node.projections for x in p)
    return ()


def _fusable(node: PhysicalExec) -> bool:
    return (isinstance(node, _CHAIN_TYPES) and len(node.children) == 1
            and not any(_has_nondeterministic(e) for e in _node_exprs(node)))


def _identity_exprs(schema) -> Tuple[Expression, ...]:
    return tuple(BoundReference(i, f.dtype, f.nullable, f.name)
                 for i, f in enumerate(schema))


def _strip_alias(exprs) -> List[Expression]:
    return [a.c if isinstance(a, Alias) else a for a in exprs]


def _compose(ops: List[PhysicalExec], child: PhysicalExec, max_variants: int
             ) -> Optional[Tuple[Tuple[Variant, ...],
                                 Optional[Tuple[int, bool]]]]:
    """Normalize a top-down op chain into variants over ``child.output``
    and the fused coalesce's (target_bytes, require_single). None when the
    chain does not compose soundly, or an Expand's fan-out passes
    ``max_variants``."""
    variants: List[Variant] = [(_identity_exprs(child.output), None)]
    coalesce: Optional[Tuple[int, bool]] = None
    seen_real_op = False
    for node in reversed(ops):                      # bottom-up
        if isinstance(node, te.TpuCoalesceBatchesExec):
            if node.require_single and seen_real_op:
                # a require_single coalesce concatenates what reaches it;
                # moved below a filter or project it would concatenate the
                # raw input, the whole unfiltered table in one batch
                return None
            if coalesce is None:
                coalesce = (node.target_bytes, node.require_single)
            else:
                coalesce = (min(coalesce[0], node.target_bytes),
                            coalesce[1] or node.require_single)
            continue
        seen_real_op = True
        new_variants: List[Variant] = []
        for exprs, pred in variants:
            repl = _strip_alias(exprs)
            if isinstance(node, te.TpuProjectExec):
                new_variants.append((
                    tuple(_substitute_refs(e, repl) for e in node.exprs),
                    pred))
            elif isinstance(node, te.TpuFilterExec):
                cond = _substitute_refs(node.condition, repl)
                new_variants.append(
                    (exprs, cond if pred is None else And(pred, cond)))
            else:                                   # TpuExpandExec
                for plist in node.projections:
                    new_variants.append((
                        tuple(_substitute_refs(e, repl) for e in plist),
                        pred))
        variants = new_variants
        if len(variants) > max_variants:
            return None
    if coalesce is not None and len(variants) > 1:
        # a coalesce and an Expand do not compose: unfused, the variants
        # interleave per arriving batch (b1v1, b1v2, b2v1, ...), fused per
        # concatenated input (b12v1, b12v2): the same rows in another order
        return None
    return tuple(variants), coalesce


def _saved_per_input_batch(ops: List[PhysicalExec]) -> int:
    """Intermediate batches the unfused chain would build per stage input
    batch: one per interior operator output other than a coalesce's (an
    Expand multiplies the batches every operator above it sees; a fused
    coalesce's concatenation is still built, as the stage's input)."""
    real = [n for n in ops if not isinstance(n, te.TpuCoalesceBatchesExec)]
    batches, saved = 1, 0
    for i, node in enumerate(reversed(real)):       # bottom-up
        if isinstance(node, TpuExpandExec):
            batches *= max(len(node.projections), 1)
        if i < len(real) - 1:                      # interior op output
            saved += batches
    return saved


def _op_display(ops) -> Tuple[Tuple[str, object], ...]:
    return tuple((type(n).__name__, n.output) for n in ops)


def _fold_aggregate(node: te.TpuHashAggregateExec, max_ops: int
                    ) -> Optional[FusedAggregateStageExec]:
    """The partial-aggregate fold as a fused stage (the substitution
    ``fuse_device_ops`` applies when fusion is off, and a coalesce is
    absorbed: the aggregate concatenates its input anyway)."""
    grouping, aggs, pre, child, folded = fold_aggregate_chain(
        node, te.TpuFilterExec, te.TpuProjectExec,
        coalesce_cls=te.TpuCoalesceBatchesExec, max_ops=max_ops)
    if not folded:
        return None
    return FusedAggregateStageExec(grouping, aggs, child, node.output,
                                   pre_filter=pre,
                                   fused_ops=_op_display(folded))


def fuse_stages(plan: PhysicalExec, conf: TpuConf) -> PhysicalExec:
    """The pass. Runs on the device plan before the pipeline boundaries are
    inserted and before ``fuse_device_ops`` (which then folds the
    aggregates this pass leaves, all of them when fusion is off). Off under
    ``sql.mesh.enabled``: the mesh rewrite matches the single operators."""
    if not conf.get(cfg.FUSION_ENABLED) or conf.get(cfg.MESH_ENABLED):
        return plan
    max_ops = max(2, conf.get(cfg.FUSION_MAX_OPS))

    def rec(node: PhysicalExec) -> PhysicalExec:
        if isinstance(node, te.TpuHashAggregateExec) and \
                not isinstance(node, FusedAggregateStageExec):
            folded = _fold_aggregate(node, max_ops)
            if folded is not None:
                node = folded
        elif _fusable(node):
            ops: List[PhysicalExec] = []
            cur = node
            while _fusable(cur) and len(ops) < max_ops:
                ops.append(cur)
                cur = cur.children[0]
            if len(ops) >= 2:
                composed = _compose(ops, cur, max_ops)
                if composed is not None:
                    variants, coalesce = composed
                    node = FusedStageExec(
                        _op_display(ops), variants, coalesce, cur,
                        ops[0].output,
                        saved_per_batch=_saved_per_input_batch(ops))
        return node.with_children([rec(c) for c in node.children])

    out = rec(plan)
    counter = itertools.count(1)
    for nd in out.walk():
        if isinstance(nd, (FusedStageExec, FusedAggregateStageExec)):
            nd.stage_id = next(counter)             # display only
    return out


# ---------------------------------------------------------------- inspection
def fused_stages(plan: PhysicalExec) -> List[PhysicalExec]:
    return [n for n in plan.walk()
            if isinstance(n, (FusedStageExec, FusedAggregateStageExec))]


def fusion_stats(plan: PhysicalExec) -> dict:
    """Static per-plan fusion accounting."""
    stages = fused_stages(plan)
    ops = [len(s.fused_ops) + (1 if isinstance(s, FusedAggregateStageExec)
                               else 0) for s in stages]
    return {
        "fused_stages": len(stages),
        "fused_ops": sum(ops),
        "ops_per_fused_stage": (round(sum(ops) / len(ops), 3) if ops
                                else 0.0),
    }
