"""Whole-stage-fused physical operators (the JAX package's
``execs/fused_execs.py``; plan/fusion.py builds them).

A maximal chain of Project / Filter / Expand / CoalesceBatches between
pipeline breakers collapses into one operator. The JAX package traces the
chain into one jitted XLA program; here each variant is eager torch over
the stage's input batch. A filter in the chain becomes a mask carried
through the downstream expressions, with one compaction at the stage's end,
so no interior operator's batch is built and the row count reaches the
host once per variant and batch, not once per filter. The subtrees that
the substitution repeats are evaluated once per batch (exprs/cse.py), as
XLA's common-subexpression pass does for the JAX package.

- ``FusedStageExec``: the chain, normalized at plan time into variants,
  each (output expressions, predicate) over the stage's input schema by
  reference substitution (an Expand multiplies the variants, one per
  projection list). A CoalesceBatches in the chain moves to the stage's
  input (``coalesce``): the row-wise operators commute with a
  concatenation.
- ``FusedAggregateStageExec``: a chain ending in a hash aggregate (the
  partial-aggregate fold): the filters ride ``pre_filter`` and the
  projections are substituted into the grouping and aggregate
  expressions. Fusion off builds the same trees (plan/overrides.py
  ``fuse_device_ops``), which keeps fused and unfused runs bit-identical.

Where the input batches kept dictionary encodings (plan/encoded.py marks
``encoded_domain_ok``), each variant's predicate is rewritten per batch onto
the dictionaries (exprs/encoded.py), as a filter's is. Each stage's
metrics carry the JAX package's ``fusedOps`` (the operators collapsed into
it) and ``batchesNotMaterialized`` (the intermediate batches the unfused
chain would have built) beside every exec's output rows and batches.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.cse import (add_shared_columns,
                                              common_subexpressions)
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.utils import tracing as _tracing

#: per-stage metric: operators collapsed into this stage
FUSED_OPS = "fusedOps"
#: per-stage metric: intermediate batches that never materialized (one per
#: interior operator output the unfused chain would have built)
FUSED_BATCHES_SAVED = "batchesNotMaterialized"

#: one variant of a fused stage: (output expressions, optional predicate),
#: both over the stage's input schema. A chain without Expand has exactly
#: one variant; each Expand projection list multiplies them.
Variant = Tuple[Tuple[Expression, ...], Optional[Expression]]


class FusedStageExec(PhysicalExec):
    """A fused streaming chain: every variant's expressions and its filter
    mask evaluate over each input batch, with a single compaction at the
    stage's end; the interior operators' batches never exist."""

    #: 1-based whole-stage id, set by plan/fusion.py after the pass
    #: (display only)
    stage_id = 0

    #: set by plan/encoded.py: the child chain can deliver encoded batches,
    #: so the variants' predicates may run over the dictionaries
    encoded_domain_ok = False

    def __init__(self, fused_ops: Tuple[Tuple[str, Schema], ...],
                 variants: Tuple[Variant, ...],
                 coalesce: Optional[Tuple[int, bool]],
                 child: PhysicalExec, output: Schema,
                 saved_per_batch: int = 0):
        super().__init__((child,), output)
        self.fused_ops = tuple(fused_ops)      # (name, schema), top-down
        self.variants = tuple(variants)
        #: a fused CoalesceBatches' (target_bytes, require_single), applied
        #: to the stage's input batches; None without one
        self.coalesce = coalesce
        self.saved_per_batch = saved_per_batch
        self.metrics[FUSED_OPS].add(len(self.fused_ops))
        # the subtrees the substitution repeated, evaluated once per batch
        flat = [x for exprs, pred in self.variants for x in exprs + (pred,)]
        self._shared, flat = common_subexpressions(flat,
                                                   len(child.output))
        out, i = [], 0
        for exprs, _ in self.variants:
            out.append((flat[i:i + len(exprs)], flat[i + len(exprs)]))
            i += len(exprs) + 1
        self._evaluated = tuple(out)
        #: batches of the last execution whose predicates ran on indices
        self.encoded_batches = 0

    @property
    def has_predicate(self) -> bool:
        return any(pred is not None for _, pred in self.variants)

    def size_estimate(self) -> Optional[int]:
        if len(self.variants) > 1:
            return None     # an Expand multiplies the rows per variant
        # a narrowing chain: the child's estimate is an upper bound
        return self.children[0].size_estimate()

    def tree_string(self, indent: int = 0, analyze: bool = False) -> str:
        # the adaptive tag and the observed stats attach to the stage's
        # head (the fused interior never materializes)
        lines = ["  " * (indent + i) + f"*({self.stage_id}) {name} [{schema}]"
                 + (f" [adaptive: {self.adaptive_tag}]"
                    if self.adaptive_tag and i == 0 else "")
                 + (_tracing.analyze_annotation(self)
                    if analyze and i == 0 else "")
                 for i, (name, schema) in enumerate(self.fused_ops)]
        lines.append(self.children[0].tree_string(
            indent + len(self.fused_ops), analyze=analyze))
        return "\n".join(lines)

    def _coalesced(self, source, ctx: ExecContext):
        """The batch-boundary half of a fused CoalesceBatches: the
        concatenation runs on the raw stage input (every fused operator is
        row-wise, so op(concat(b)) == concat(op(b)) on the live rows;
        plan/fusion.py ``_compose`` refuses the shapes where that is not
        enough: require_single above a real operator, and any coalesce
        with an Expand)."""
        target_bytes, require_single = self.coalesce
        return te.coalesce_batches(source, self.children[0].output,
                                   target_bytes, require_single, ctx.device)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch import config as cfg
        use_enc = (self.encoded_domain_ok
                   and ctx.conf.get(cfg.ENCODED_DOMAIN))
        self.encoded_batches = 0
        source = self.children[0].execute(ctx)
        if self.coalesce is not None:
            source = self._coalesced(source, ctx)
        for batch in source:
            ctx.check_cancelled()
            cap = batch.capacity
            ectx = te.eval_ctx(batch, ctx)
            add_shared_columns(ectx, self._shared)
            evaluated = self._evaluated
            if use_enc:
                evaluated = tuple(
                    (exprs, None if pred is None else
                     te.encoded_predicate(pred, batch, ectx))
                    for exprs, pred in evaluated)
                if ectx.encodings:
                    self.encoded_batches += 1
                    te._count_encoded_op()
            alive = None
            self.metrics[FUSED_BATCHES_SAVED].add(self.saved_per_batch)
            for exprs, pred in evaluated:
                outs = [bk.as_column(e.eval(ectx), cap) for e in exprs]
                if pred is None:
                    yield te.batch_of(self.output, outs, batch.num_rows)
                    continue
                if alive is None:
                    alive = bk.alive_mask(cap, batch.num_rows, batch.device)
                p = bk.as_column(pred.eval(ectx), cap)
                keep = (p.data & p.validity) & alive
                cols, n = bk.compact(keep, outs)
                yield te.batch_of(self.output, cols, n)


class FusedAggregateStageExec(te.TpuHashAggregateExec):
    """A fused stage ending in a hash aggregate: the folded filters ride
    ``pre_filter`` and the folded projections are substituted into the
    grouping and aggregate expressions, so the inherited aggregation is the
    stage's whole work (the same expression trees as the fold with fusion
    off)."""

    stage_id = 0

    def __init__(self, grouping, aggregates, child, output,
                 pre_filter=None,
                 fused_ops: Tuple[Tuple[str, Schema], ...] = ()):
        super().__init__(grouping, aggregates, child, output,
                         pre_filter=pre_filter)
        self.fused_ops = tuple(fused_ops)   # folded ops below the aggregate
        self.metrics[FUSED_OPS].add(len(self.fused_ops) + 1)

    def tree_string(self, indent: int = 0, analyze: bool = False) -> str:
        # the folded ops are not rendered: their expressions live inside the
        # aggregate now
        tag = f" [adaptive: {self.adaptive_tag}]" if self.adaptive_tag else ""
        if analyze:
            tag += _tracing.analyze_annotation(self)
        return "\n".join([
            "  " * indent + f"*({self.stage_id}) TpuHashAggregateExec "
                            f"[{self.output}]{tag}",
            self.children[0].tree_string(indent + 1, analyze=analyze)])

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        counted = _Counted(self.children[0].execute(ctx))
        try:
            yield from self._aggregate(ctx, counted)
        finally:
            # each folded op would have built one batch per input batch
            self.metrics[FUSED_BATCHES_SAVED].add(
                max(counted.n, 1) * len(self.fused_ops))


class _Counted:
    """An iterator that counts what passes through it."""

    def __init__(self, it):
        self._it = it
        self.n = 0

    def __iter__(self):
        for x in self._it:
            self.n += 1
            yield x
