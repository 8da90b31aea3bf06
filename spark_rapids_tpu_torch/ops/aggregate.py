"""Grouped aggregation over one batch: the one-hot, hash and sort modes of
the JAX package's ``ops/aggregate.py``.

``onehot`` is the sort-free fast path for at most ``ONEHOT_CAP`` groups:
distinct 64-bit key hashes give the group table and ``searchsorted`` gives
each row its group id. The JAX package forms ``[capacity, 64]`` one-hot masks
that XLA fuses away; eager torch would materialise them (cap x 64 x 8 bytes a
buffer, ~34 GB at SF 10), so here every reduction goes by group id instead:
one ``index_add_`` per sum buffer (``scatter_reduce_`` per min or max
buffer; the JAX package's ``masked_min`` would be a ``[rows, 64]`` matrix)
into the sub-bins ``gid * SPREAD + row % SPREAD``, then a reduction over
each group's sub-bins. String min and max need a rank sort and keep the
aggregate off this mode (``onehot_supported``). The
collision/overflow flag is exact, as in the JAX package: every injective key
word of a row must equal its group's first row's.

``hash`` orders rows by the shifted 64-bit key hash (one stable sort
instead of the exact multi-key lexsort) and reduces at the group boundaries
(``_reduce_phase_scan``); it is flagged when two keys collide or when there
are more than ``GROUP_CAP`` groups. Its groups come out in hash order, as
the JAX package's do.

``sort`` orders rows by the exact key passes and reduces segments; it is the
last escalation target. Without keys every mode is the global aggregate:
one group, also over no rows. An aggregate with keys and no functions is a
``distinct``. A string min or max ranks the rows by byte order and reduces
the ranks (``_segment_minmax_string``).

The port has one aggregation stage (its exec sees all its input in one
partition), so the JAX package's partial buffers and ``merge_aggregate``
have no counterpart here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import pad_rows
from spark_rapids_tpu_torch.columnar.dtypes import DType, bucket_capacity
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
from spark_rapids_tpu_torch.ops import batch_kernels as bk

#: group-space bound of the one-hot path; more distinct keys raise the flag
ONEHOT_CAP = 64

#: group-space bound of the hash mode's boundary-scan reduction; more groups
#: raise the flag and the exec re-runs the exact sort
GROUP_CAP = 65536

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

AggResult = Tuple[List[ColV], List[ColV], int, bool]


def onehot_supported(agg_fns: Sequence[AggregateFunction]) -> bool:
    """The one-hot mode covers every reduction but a string min or max
    (those need the rank sort the mode exists to avoid)."""
    return not any(spec.dtype is DType.STRING and spec.kind in ("min", "max")
                   for fn in agg_fns for spec in fn.buffer_specs())


def grouping_modes(keys, agg_fns: Sequence[AggregateFunction]) -> List[str]:
    """Escalation order of the aggregate exec: each mode runs only when the
    one before it raised its collision/overflow flag. The one-hot mode
    needs 1 to 64 keys (one validity bit each in a word) and no string
    min/max."""
    onehot = 0 < len(keys) <= 64 and onehot_supported(agg_fns)
    return (["onehot"] if onehot else []) + ["hash", "sort"]


def group_aggregate(ctx: EvalCtx, key_exprs, agg_fns: Sequence[AggregateFunction],
                    num_rows: int, capacity: int, grouping: str = "sort",
                    extra_mask=None) -> AggResult:
    """Grouped aggregation over one batch -> (key_cols, result_cols,
    num_groups, flagged). Output columns have the group count's capacity
    bucket (the hash mode's at most ``GROUP_CAP`` rows). ``extra_mask``
    excludes rows (a fused filter predicate). ``flagged`` is only ever True
    for ``grouping="onehot"`` or ``"hash"`` with keys: the result may be
    wrong and the caller must re-run with the next mode."""
    if grouping not in ("onehot", "hash", "sort"):
        raise ValueError(f"unknown grouping mode {grouping!r}")
    alive = bk.alive_mask(capacity, num_rows, ctx.device)
    if extra_mask is not None:
        alive = alive & extra_mask
    keys = [bk.as_column(e.eval(ctx), capacity) for e in key_exprs]
    projections: List[List[ColV]] = []
    for fn in agg_fns:
        bufs = [bk.as_column(b, capacity) for b in fn.project(ctx)]
        projections.append([b.with_validity(b.validity & alive) for b in bufs])
    if not keys:
        return _global_aggregate(projections, agg_fns, alive)
    if grouping == "onehot":
        return _onehot_aggregate(keys, projections, agg_fns, alive)
    if grouping == "hash":
        return _hash_aggregate(keys, projections, agg_fns, alive)
    return _sort_aggregate(keys, projections, agg_fns, alive)


def _finish(key_cols, reduced_per_fn, agg_fns, num_groups: int,
            out_cap: int, flagged: bool, device) -> AggResult:
    group_alive = torch.arange(out_cap, device=device) < num_groups
    results = []
    for fn, reduced in zip(agg_fns, reduced_per_fn):
        out = fn.evaluate(reduced)
        results.append(out.with_validity(out.validity & group_alive))
    key_cols = [k.with_validity(k.validity & group_alive) for k in key_cols]
    return key_cols, results, num_groups, flagged


def _onehot_aggregate(keys, projections, agg_fns, alive) -> AggResult:
    G = ONEHOT_CAP
    device = alive.device
    h = bk.hash64_cols(keys)
    # all-ones is reserved for dead rows: a real hash there maps onto
    # all-ones minus one (a clash with a genuine such group is caught by the
    # exact word check below)
    h = torch.where(h == -1, -2, h)
    u = bk.unsigned_order(torch.where(alive, h, -1))
    cand = torch.unique(u)                 # ascending = unsigned hash order
    cand = cand[cand != _I64_MAX]          # the dead-row sentinel
    num_real = int(cand.numel())
    num_groups = min(num_real, G)
    out_cap = bucket_capacity(num_groups)
    if num_groups == 0:
        return _empty_result(keys, projections, agg_fns, out_cap, device)
    cand = cand[:G]
    # dead rows, and live rows past the first G hashes (the flag is raised
    # then), reduce into the spare bin ``num_groups``
    gid = torch.searchsorted(cand, u)
    gid = torch.where(alive & (gid < num_groups), gid, num_groups)
    in_table = gid < num_groups
    row = torch.arange(gid.shape[0], device=device)
    spread = gid * SPREAD + row % SPREAD
    # each group's first row: its key output and the collision check's model;
    # one pass, its atomic mins spread over the same sub-bins as the sums
    rep = torch.full(((num_groups + 1) * SPREAD,), gid.shape[0],
                     dtype=torch.int64, device=device).scatter_reduce_(
        0, spread, row, "amin").view(-1, SPREAD).amin(dim=1)[:num_groups]
    row_rep = rep[gid.clamp(max=num_groups - 1)]
    collided = torch.zeros_like(in_table)
    for w in [bk.validity_word(keys)] + [w for v in keys
                                         for w in bk.key_words(v)]:
        collided |= w != w[row_rep]
    flagged = num_real > G or bool((collided & in_table).any())
    key_cols = [bk.take_padded(v, rep, out_cap) for v in keys]
    reduced_per_fn = [[_group_reduce(b, spec.kind, spread, num_groups,
                                     out_cap)
                       for spec, b in zip(fn.buffer_specs(), bufs)]
                      for fn, bufs in zip(agg_fns, projections)]
    return _finish(key_cols, reduced_per_fn, agg_fns, num_groups, out_cap,
                   flagged, device)


#: sub-bins per group of the one-hot sums: rows add into bin
#: ``gid * SPREAD + row % SPREAD``, so the atomic adds of one group spread over
#: SPREAD addresses instead of piling onto one (on an H100, six groups of
#: 60M rows took ~290 ms in one bin each)
SPREAD = 256


def _group_reduce(b: ColV, kind: str, spread: torch.Tensor, num_groups: int,
                  out_cap: int) -> ColV:
    """One numeric buffer reduced by group id (the JAX package's
    ``_onehot_reduce_buffer``): into the sub-bins ``spread`` (the spare
    group ``num_groups`` holds the rows that are dropped), then over each
    group's sub-bins. A sum adds; a min or max reduces the NaN-free values
    and adds the NaN and valid counts, so Spark's NaN rule applies to the
    whole group. The result is valid when any of the group's rows was."""
    bins = (num_groups + 1) * SPREAD

    def fold(t: torch.Tensor, how: str = "sum") -> torch.Tensor:
        per_group = t.view(-1, SPREAD)
        per_group = {"sum": per_group.sum(dim=1),
                     "min": per_group.amin(dim=1),
                     "max": per_group.amax(dim=1)}[how]
        return pad_rows(per_group[:num_groups], out_cap)

    def add(t: torch.Tensor) -> torch.Tensor:
        return fold(t.new_zeros(bins).index_add_(0, spread, t))

    count = add(b.validity.to(torch.int64))
    if kind == "sum":
        contrib = torch.where(b.validity, b.data, 0).to(b.data.dtype)
        if contrib.is_floating_point() and contrib.device.type != "cpu":
            # in a fixed order per group (``segment_sum``), not by atomics
            gid = torch.div(spread, SPREAD, rounding_mode="floor")
            sums = bk.segment_sum(contrib, gid, num_groups + 1)
            return ColV(b.dtype, pad_rows(sums[:num_groups], out_cap),
                        count > 0)
        return ColV(b.dtype, add(contrib), count > 0)
    res, nan_count = bk.minmax_parts(b.data, b.validity, spread, bins, kind)
    res = fold(res.to(torch.int8) if res.dtype == torch.bool else res, kind)
    if b.data.dtype == torch.bool:
        res = res.to(torch.bool)
    if nan_count is not None:
        nan_count = fold(nan_count)
    return ColV(b.dtype, bk.minmax_finish(res, count, nan_count, kind),
                count > 0)


def _empty_result(keys, projections, agg_fns, out_cap, device) -> AggResult:
    none = torch.zeros(0, dtype=torch.int64, device=device)
    key_cols = [bk.take_padded(v, none, out_cap) for v in keys]
    reduced = [[bk.take_padded(b, none, out_cap) for b in bufs]
               for bufs in projections]
    return _finish(key_cols, reduced, agg_fns, 0, out_cap, False, device)


def _reduce_buffer(b: ColV, kind: str, gids: torch.Tensor,
                   out_cap: int) -> ColV:
    """One buffer reduced per group id (rows in group order: ``gids``
    non-decreasing)."""
    if b.dtype is DType.STRING:
        return _segment_minmax_string(b, gids, out_cap, kind)
    data, valid = bk.segment_reduce(b.data, b.validity, gids, out_cap, kind,
                                    ids_sorted=True)
    return ColV(b.dtype, data, valid)


def _segment_reduce_all(agg_fns, projections, order, gids, out_cap):
    """Every buffer taken in ``order`` and reduced per group id."""
    return [[_reduce_buffer(bk.take_colv(b, order), spec.kind, gids, out_cap)
             for spec, b in zip(fn.buffer_specs(), bufs)]
            for fn, bufs in zip(agg_fns, projections)]


def _string_rank(b: ColV, kind: str):
    """String min/max's preamble: the rows' ranks in byte order, with a
    sentinel no reduction picks over for rows that do not take part
    (null or dead; their validity is already false). -> (order,
    masked_rank, n)."""
    order = bk.sort_indices([(b, True, True)], b.validity)
    n = order.shape[0]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    sentinel = n + 1 if kind == "min" else -1
    return order, torch.where(b.validity, rank, sentinel), n


def _segment_minmax_string(b: ColV, gids: torch.Tensor, out_cap: int,
                           kind: str) -> ColV:
    """min/max over strings: the least or greatest rank per group, then
    that row picked (both sentinels fail the bounds check)."""
    order, masked, n = _string_rank(b, kind)
    seg, _ = bk.segment_reduce(masked, torch.ones_like(b.validity), gids,
                               out_cap, kind)
    has = (seg >= 0) & (seg < n)
    pick = order[seg.clamp(0, n - 1)]
    return ColV(b.dtype, b.data[pick], has & b.validity[pick],
                b.lengths[pick])


def _global_aggregate(projections, agg_fns, alive) -> AggResult:
    """No keys: exactly one group, even over no rows (Spark's global
    aggregate and its empty-input row)."""
    order = torch.arange(alive.shape[0], device=alive.device)
    out_cap = bucket_capacity(1)
    reduced = _segment_reduce_all(agg_fns, projections, order,
                                  torch.zeros_like(order), out_cap)
    return _finish([], reduced, agg_fns, 1, out_cap, False, alive.device)


def _sort_aggregate(keys, projections, agg_fns, alive) -> AggResult:
    order = bk.sort_indices([(k, True, True) for k in keys], alive)
    sorted_keys = [bk.take_colv(k, order) for k in keys]
    starts = bk.starts_from_sorted(sorted_keys, alive[order])
    num_groups = int(starts.sum())
    gids = (torch.cumsum(starts.to(torch.int64), 0) - 1).clamp_(min=0)
    out_cap = bucket_capacity(num_groups)
    first = torch.nonzero(starts).squeeze(1)
    key_cols = [bk.take_padded(k, first, out_cap) for k in sorted_keys]
    return _finish(key_cols,
                   _segment_reduce_all(agg_fns, projections, order, gids,
                                       out_cap),
                   agg_fns, num_groups, out_cap, False, alive.device)


def _hash_aggregate(keys, projections, agg_fns, alive) -> AggResult:
    """Rows in hash order, group boundaries from the exact key compare,
    the flag from a boundary inside a run of one shifted hash (a collision)
    or from more than ``GROUP_CAP`` groups; reductions at the boundaries."""
    order, h = bk.hash_group_order(keys, alive)
    sorted_keys = [bk.take_colv(k, order) for k in keys]
    sorted_alive = alive[order]
    starts = bk.starts_from_sorted(sorted_keys, sorted_alive)
    flagged = bk.detect_hash_collision_sorted(bk._srl(h, 1)[order], starts,
                                              sorted_alive)
    num_groups = int(starts.sum())
    flagged = flagged or num_groups > GROUP_CAP
    gids = (torch.cumsum(starts.to(torch.int64), 0) - 1).clamp_(min=0)
    out_cap = bucket_capacity(min(num_groups, GROUP_CAP))
    sorted_projs = [[bk.take_colv(b, order) for b in bufs]
                    for bufs in projections]
    key_cols, reduced_per_fn = _reduce_phase_scan(
        sorted_keys, agg_fns, sorted_projs, gids, num_groups, out_cap,
        sorted_alive)
    return _finish(key_cols, reduced_per_fn, agg_fns, num_groups, out_cap,
                   flagged, alive.device)


def _reduce_phase_scan(sorted_keys, agg_fns, sorted_projs, gids,
                       num_groups: int, out_cap: int, sorted_alive):
    """Boundary-scan reduction over rows ordered by group (``gids``
    non-decreasing): each group's first and last row come from two
    ``searchsorted`` calls over the gids; keys are gathered at the first
    row; integral sums are differences of one inclusive cumsum at the two
    boundaries (wrapping arithmetic keeps them exact through any overflow).
    Float sums are not: the running sum mixes other groups' values, so a
    group that cancels to exactly 0.0 would keep a residue; they are
    summed by group id instead, the groups past ``out_cap - 1`` folded into
    the last bin as in the JAX package (the flag is raised then), and so
    are min and max."""
    device = gids.device
    cap = gids.shape[0]
    g = torch.arange(out_cap, device=device)
    start = torch.searchsorted(gids, g)
    end = torch.searchsorted(gids, g, right=True) - 1
    # dead rows keep the last group's id: its end is the last live row
    n_alive = int(sorted_alive.sum())
    end = torch.minimum(end, torch.tensor(max(n_alive - 1, 0), device=device))
    has = g < num_groups
    start = start.clamp(0, cap - 1)
    end = end.clamp(0, cap - 1)
    key_cols = []
    for k in sorted_keys:
        kc = bk.take_colv(k, start)
        key_cols.append(kc.with_validity(kc.validity & has))

    def seg_sum(contrib: torch.Tensor) -> torch.Tensor:
        c = torch.cumsum(contrib, 0)
        head = torch.where(start > 0, c[(start - 1).clamp(min=0)], 0)
        return c[end] - head

    gids_b = gids.clamp(max=out_cap - 1)
    reduced_per_fn = []
    for fn, bufs in zip(agg_fns, sorted_projs):
        reduced = []
        for spec, b in zip(fn.buffer_specs(), bufs):
            if spec.kind != "sum" or b.dtype.is_floating:
                reduced.append(_reduce_buffer(b, spec.kind, gids_b, out_cap))
                continue
            data = seg_sum(torch.where(b.validity, b.data, 0)
                           .to(b.data.dtype))
            valid = seg_sum(b.validity.to(torch.int64)) > 0
            reduced.append(ColV(b.dtype, data, valid))
        reduced_per_fn.append(reduced)
    return key_cols, reduced_per_fn
