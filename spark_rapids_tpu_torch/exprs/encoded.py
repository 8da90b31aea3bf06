"""Encoded-domain expressions: evaluate on dictionary INDICES, not values
(the JAX package's ``exprs/encoded.py``).

A column uploaded dictionary-encoded keeps its encoding on the device
(columnar/encoding.py). These nodes use it:

- ``DictDomainGather``: a boolean predicate over ONE encoded column
  evaluates once per dictionary slot (k rows), then one gather carries the
  verdict to the n rows. For a string predicate this replaces n x width
  byte comparisons with k x width and an int gather.
- ``EncodedKeyRef``: a group-by or join key reads the index vector as an
  int32 column. Distinct indices mean distinct values (the upload checks
  the dictionary is unique), so grouping and equi-join semantics hold, and
  string keys become int keys.
- ``materialize_key``: after the aggregation, the surviving group keys
  (one row per group) gather their decoded values back.

The planner pass is plan/encoded.py; the execs rewrite per batch
(execs/tpu_execs.py, fused_execs.py, join_execs.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Set, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.columnar.encoding import EncSpec, EncView
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression)


@dataclass(frozen=True)
class DictDomainGather(Expression):
    """Evaluate ``pred`` (bound to ordinal 0 of a one-column dictionary
    schema) over the k dictionary values of input column ``ordinal``, then
    gather the per-slot verdict through the index vector."""

    pred: Expression
    ordinal: int
    k: int

    def dtype(self) -> DType:
        return DType.BOOLEAN

    def nullable(self) -> bool:
        return True

    def eval(self, ctx: EvalCtx) -> ColV:
        from spark_rapids_tpu_torch.ops.batch_kernels import as_column
        enc: EncView = ctx.encodings[self.ordinal]
        sub = EvalCtx([enc.values], self.k, ctx.device,
                      ctx.string_max_bytes, ctx.partition_id,
                      host_engine=ctx.host_engine)
        pv = as_column(self.pred.eval(sub), self.k)
        idx = enc.indices
        return ColV(DType.BOOLEAN, pv.data.index_select(0, idx),
                    pv.validity.index_select(0, idx)
                    & ctx.columns[self.ordinal].validity)


@dataclass(frozen=True)
class EncodedKeyRef(Expression):
    """The dictionary-index vector of input column ``ordinal`` as an int32
    key column. Validity is the column's own (null rows stay null keys)."""

    ordinal: int
    k: int
    ref_dtype: DType                 # the value type (for display)
    ref_name: str = ""

    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return True

    @property
    def name_hint(self) -> str:
        return self.ref_name or f"c{self.ordinal}"

    def eval(self, ctx: EvalCtx) -> ColV:
        enc: EncView = ctx.encodings[self.ordinal]
        return ColV(DType.INT, enc.indices,
                    ctx.columns[self.ordinal].validity)


def materialize_key(ctx: EvalCtx, spec: EncSpec, key: ColV) -> ColV:
    """Late materialization: a reduced index-key column (one row per group)
    back to its decoded values with a k-bounded gather. Null and padding
    rows are zeroed, as the decoded aggregation leaves them."""
    enc: EncView = ctx.encodings[spec.ordinal]
    idx = torch.clamp(key.data.to(torch.int64), 0, spec.k - 1)
    valid = key.validity

    def gather(t: torch.Tensor) -> torch.Tensor:
        out = t.index_select(0, idx)
        keep = valid.reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))

    lengths = (gather(enc.values.lengths)
               if enc.values.lengths is not None else None)
    return ColV(spec.dtype, gather(enc.values.data), valid, lengths)


@dataclass(frozen=True)
class EncJoinKey:
    """One equi-join key pair matching on the index domain. With
    ``same_token`` the sides share a prefix-compatible dictionary and
    indices compare directly; otherwise the right dictionary remaps into
    the left one on the device (k_l x k_r work)."""
    pos: int
    left: EncSpec
    right: EncSpec
    same_token: bool


def dict_remap(lvals: ColV, rvals: ColV, k_left: int) -> torch.Tensor:
    """int32[k_right] mapping each right-dictionary slot to the left slot
    holding the same value, or the sentinel ``k_left`` when the value does
    not occur on the left (the sentinel equals no left index, so those rows
    never match, as in the decoded join). One k_l x k_r equality matrix;
    callers cap the cell count. The port's dictionaries have no pad slots,
    so no live-count mask is needed."""
    if lvals.lengths is None:
        eq = lvals.data[:, None] == rvals.data[None, :]
    else:
        from spark_rapids_tpu_torch.ops.strings import align_widths
        L, R = align_widths(lvals.data, rvals.data)
        eq = ((L[:, None, :] == R[None, :, :]).all(dim=-1)
              & (lvals.lengths[:, None] == rvals.lengths[None, :]))
    found = eq.any(dim=0)
    first = torch.argmax(eq.to(torch.int8), dim=0)
    return torch.where(found, first,
                       torch.full_like(first, k_left)).to(torch.int32)


# ---------------------------------------------------------------- rewriting
def _refs(e: Expression, out: Set[int]) -> None:
    if isinstance(e, BoundReference):
        out.add(e.ordinal)
    for c in e.children:
        _refs(c, out)


def _null_intolerant():
    """The classes whose evaluation is the null-intolerant convention: the
    JAX package's Unary/BinaryExpression subclasses that keep the base
    class's ``eval`` (the port has no unary base class, so the set is
    named; a test holds it equal to the JAX package's)."""
    from spark_rapids_tpu_torch.exprs import arithmetic as ar
    from spark_rapids_tpu_torch.exprs import bitwise as bw
    from spark_rapids_tpu_torch.exprs import math as mt
    from spark_rapids_tpu_torch.exprs import misc as mi
    from spark_rapids_tpu_torch.exprs import predicates as pr
    return (ar.Abs, ar.Add, ar.Multiply, ar.Subtract, ar.UnaryMinus,
            ar.UnaryPositive, bw.BitwiseAnd, bw.BitwiseNot, bw.BitwiseOr,
            bw.BitwiseXor, mt.Atan2, mt.Ceil, mt.Floor, mt.Pow,
            mi.KnownFloatingPointNormalized, mi.NormalizeNaNAndZero,
            pr.EqualTo, pr.GreaterThan, pr.GreaterThanOrEqual, pr.LessThan,
            pr.LessThanOrEqual, pr.NotEqual)


def _domain_safe(e: Expression) -> bool:
    """True when evaluating ``e`` once per distinct dictionary value and
    gathering the verdict equals evaluating it per row.

    The gather sees only valid dictionary values and then forces null rows
    to a null verdict, so the rewrite is sound exactly for expressions with
    ``f(NULL) is NULL`` and no positional state. That is a WHITELIST:

    - Literal / BoundReference leaves;
    - the null-intolerant unary and binary expressions (``_null_intolerant``;
      EqualNullSafe, NaNvl and the like are not among them);
    - And / Or / Not / In / InSet, whose three-valued logic still yields a
      null verdict for a null input within a single-column subtree.

    Everything else (IsNull, Coalesce, If, CaseWhen make non-null results
    from null inputs; Rand and the row ids have positional state) stays on
    the decoded path."""
    from spark_rapids_tpu_torch.exprs import predicates as pr
    from spark_rapids_tpu_torch.exprs.literals import Literal
    if isinstance(e, (Literal, BoundReference)):
        return True
    ok = (isinstance(e, (pr.And, pr.Or, pr.Not, pr.In, pr.InSet))
          or type(e) in _null_intolerant())
    return ok and all(_domain_safe(c) for c in e.children)


def _rebind_to_slot0(e: Expression, ordinal: int) -> Expression:
    if isinstance(e, BoundReference):
        assert e.ordinal == ordinal
        return BoundReference(0, e.ref_dtype, e.ref_nullable, e.ref_name)
    return e.map_children(lambda c: _rebind_to_slot0(c, ordinal))


def rewrite_predicate(cond: Expression, specs: Sequence[EncSpec]
                      ) -> Tuple[Expression, Tuple[EncSpec, ...]]:
    """Rewrite every maximal boolean subtree of ``cond`` that references
    exactly one encoded column into a DictDomainGather over that column's
    dictionary. Returns (the rewritten condition, the EncSpecs used); a
    condition with no eligible subtree comes back unchanged."""
    by_ord: Dict[int, EncSpec] = {s.ordinal: s for s in specs}
    used: Dict[int, EncSpec] = {}

    def rec(e: Expression) -> Expression:
        refs: Set[int] = set()
        _refs(e, refs)
        if (len(refs) == 1 and not isinstance(e, BoundReference)
                and e.children):
            (o,) = tuple(refs)
            spec = by_ord.get(o)
            if spec is not None and _domain_safe(e):
                try:
                    is_bool = e.dtype() is DType.BOOLEAN
                except TypeError:
                    is_bool = False
                if is_bool:
                    used[o] = spec
                    return DictDomainGather(_rebind_to_slot0(e, o), o,
                                            spec.k)
        return e.map_children(rec)

    out = rec(cond)
    return out, tuple(sorted(used.values(), key=lambda s: s.ordinal))


def rewrite_grouping(grouping: Sequence[Expression],
                     specs: Sequence[EncSpec]
                     ) -> Tuple[Tuple[Expression, ...], Dict[int, EncSpec],
                                Tuple[EncSpec, ...]]:
    """Substitute the grouping keys that are plain references to encoded
    columns with their index vectors. Returns (the new grouping, {key
    position -> EncSpec} for the materialization, the EncSpecs used)."""
    by_ord: Dict[int, EncSpec] = {s.ordinal: s for s in specs}
    out = []
    subs: Dict[int, EncSpec] = {}
    used: Dict[int, EncSpec] = {}
    for j, g in enumerate(grouping):
        spec = (by_ord.get(g.ordinal)
                if isinstance(g, BoundReference) else None)
        if spec is not None and spec.dtype.is_floating:
            # index identity is FINER than float equality (-0.0 and 0.0 are
            # distinct slots but equal keys): floats stay decoded, through
            # the aggregation's float canonicalization
            spec = None
        if spec is not None:
            out.append(EncodedKeyRef(g.ordinal, spec.k, g.ref_dtype,
                                     g.ref_name))
            subs[j] = spec
            used[spec.ordinal] = spec
        else:
            out.append(g)
    return (tuple(out), subs,
            tuple(sorted(used.values(), key=lambda s: s.ordinal)))
