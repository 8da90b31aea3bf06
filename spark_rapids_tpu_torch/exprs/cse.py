"""Common subexpressions of an operator's expression lists, evaluated once.

The fold and whole-stage fusion substitute a projection's expressions into
every expression above it that reads the projected column, and an Expand
copies them into every variant. The JAX package traces the result into one
XLA program, whose common-subexpression pass computes each repeated subtree
once. Eager torch has no such pass, so the fused stage and the aggregate
find the repeated subtrees at plan time: each is evaluated once per batch
into an extra column of the evaluation context, and its occurrences read
that column through a ``BoundReference``. The values are the same tensors
the repeated evaluations would have computed, so results do not change by a
bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.exprs.core import (BoundReference, EvalCtx,
                                               Expression)


def _shareable(e: Expression) -> bool:
    """A subtree that evaluates on its own to a column: not a leaf, not a
    name or an aggregate/window/generator node, and of a column type (an
    array, such as split()'s, only exists under its indexing)."""
    from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
    from spark_rapids_tpu_torch.exprs.generators import Explode
    from spark_rapids_tpu_torch.exprs.literals import Literal
    from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
    from spark_rapids_tpu_torch.exprs.windows import WindowExpression
    if not e.children or isinstance(e, (BoundReference, Literal, Alias,
                                        SortOrder, AggregateFunction,
                                        WindowExpression, Explode)):
        return False
    try:
        e.dtype()
        hash(e)
    except TypeError:
        return False
    return True


def _subtrees(e: Expression):
    for c in e.children:
        yield from _subtrees(c)
    yield e


def common_subexpressions(roots: Sequence[Optional[Expression]],
                          first_ordinal: int
                          ) -> Tuple[Tuple[Expression, ...],
                                     Tuple[Optional[Expression], ...]]:
    """-> (shared, rewritten roots). ``shared[i]`` is every subtree that
    occurs more than once among ``roots``, in an order where each refers
    only to the input columns and earlier entries; its occurrences read
    ``BoundReference(first_ordinal + i)``. None roots pass through."""
    counts: Dict[Expression, int] = {}
    for r in roots:
        if r is None:
            continue
        for t in _subtrees(r):
            if _shareable(t):
                counts[t] = counts.get(t, 0) + 1
    repeated = {t for t, n in counts.items() if n > 1}
    if not repeated:
        return (), tuple(roots)
    shared: List[Expression] = []
    index: Dict[Expression, BoundReference] = {}

    def rewrite(e: Expression) -> Expression:
        known = index.get(e) if _shareable(e) else None
        if known is not None:
            return known
        new = e.map_children(rewrite)
        if known is None and _shareable(e) and e in repeated:
            index[e] = BoundReference(first_ordinal + len(shared), e.dtype(),
                                      e.nullable(), "")
            shared.append(new)
            return index[e]
        return new

    rewritten = tuple(None if r is None else rewrite(r) for r in roots)
    return tuple(shared), rewritten


def add_shared_columns(ectx: EvalCtx, shared: Sequence[Expression]) -> None:
    """Evaluate the shared subtrees in order into extra columns of
    ``ectx``."""
    for e in shared:
        ectx.columns.append(e.eval(ectx))
