"""Window positions, frames and framed reductions (the JAX package's
``ops/window.py``).

One sort by (partition keys, order keys) puts every partition's rows in a
contiguous run in order; ``build_frame_ctx`` then gives each row, in that
sorted domain, the first and last row of its partition and of its peer
group (rows equal on every partition and order key; null == null,
NaN == NaN, -0.0 == 0.0, as grouping compares them). The JAX package takes
the group starts with a running ``cummax``; here each row gathers its
group's start by group id, which needs no scan (torch's CUDA ``cummax`` was
the slowest kernel of the port's joins until it was replaced the same way).
With exactly one numeric, date or timestamp order key the context also
holds the direction-normalised key values that RANGE offsets search.

``frame_bounds`` turns a ROWS or RANGE frame into an inclusive row interval
per row: ROWS by index arithmetic clipped to the partition, RANGE offsets
by a per-row binary search over the order values. ``frame_reduce_buffer``
reduces an aggregate's buffer over those intervals by its kind: a sum (so
a sum, a count or an average is framed) as a difference of prefix sums
that restart at each partition, taken in one order on every device
(``segmented_prefix_sum``); min and max by the JAX package's sparse-table
range query; first and last by the frame's ends or, ignoring nulls, a
binary search over the running count of valid rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.ops import batch_kernels as bk

@dataclass
class FrameCtx:
    """Per-row positions in the sorted domain, shared by every window
    function evaluated under one (partition, order) spec."""
    capacity: int
    idx: torch.Tensor         # row index in the sorted domain
    salive: torch.Tensor      # liveness, sorted
    seg_first: torch.Tensor   # first row of the row's partition
    seg_last: torch.Tensor    # its last live row
    peer_first: torch.Tensor  # first row of the row's peer group
    peer_last: torch.Tensor   # its last live row
    # RANGE offsets (set when there is exactly one numeric, date or
    # timestamp order key): the order values, ascending within a
    # partition (int64 keys stay int64, descending ones are bit-inverted;
    # float keys are float64, descending ones negated)
    order_vals: Optional[torch.Tensor] = None
    # rows whose key is null or NaN: their frame is their peer group
    special: Optional[torch.Tensor] = None
    # the partition's searchable (non-special) rows, [dom_lo, dom_hi]
    dom_lo: Optional[torch.Tensor] = None
    dom_hi: Optional[torch.Tensor] = None


def _groups(starts: torch.Tensor, salive: torch.Tensor):
    """Group-start marks over sorted rows -> (group ids, first row, last
    live row) per row. Dead rows sort last and belong to the last group,
    as in the JAX package, and are not its last row."""
    cap = starts.shape[0]
    gids = (torch.cumsum(starts.to(torch.int64), 0) - 1).clamp_(0, cap - 1)
    first_rows = torch.cat([torch.nonzero(starts).squeeze(1),
                            starts.new_zeros(1, dtype=torch.int64)])
    first = first_rows[gids]
    sizes = torch.zeros(cap, dtype=torch.int64, device=starts.device) \
        .index_add_(0, gids, salive.to(torch.int64))
    return gids, first, first + sizes[gids].clamp(min=1) - 1


def build_frame_ctx(part_keys: Sequence[ColV], order_keys, order: torch.Tensor,
                    alive: torch.Tensor, capacity: int) -> FrameCtx:
    """``part_keys`` and ``order_keys`` ((ColV, ascending, nulls_first)
    triples) are the unsorted columns and ``order`` the sort permutation;
    everything returned lives in the sorted domain."""
    idx = torch.arange(capacity, dtype=torch.int64, device=alive.device)
    salive = alive[order]
    gids, seg_first, seg_last = _groups(
        bk.rows_equal_adjacent(part_keys, order, alive), salive)
    peer_first, peer_last = seg_first, seg_last
    if order_keys:
        all_keys = list(part_keys) + [k for k, _, _ in order_keys]
        _, peer_first, peer_last = _groups(
            bk.rows_equal_adjacent(all_keys, order, alive), salive)
    fr = FrameCtx(capacity, idx, salive, seg_first, seg_last, peer_first,
                  peer_last)
    if len(order_keys) == 1:
        v, asc, _ = order_keys[0]
        sv = bk.take_colv(v, order)
        if sv.dtype.is_numeric or sv.dtype in (DType.DATE, DType.TIMESTAMP):
            special = ~sv.validity
            if sv.dtype.is_floating:
                # NaN rows get peer-group frames (offsets on NaN are
                # undefined)
                special = special | torch.isnan(sv.data)
                w = sv.data.to(torch.float64)
                w = w if asc else -w
            else:
                # the native int64 domain: float64 would lose timestamp
                # microseconds above 2^53; ~x descends with no overflow
                w = sv.data.to(torch.int64)
                w = w if asc else ~w
            ok = ~special
            lo_pick, lo_has = bk.segment_pick(ok, gids, capacity, "first",
                                              alive=salive,
                                              ignore_nulls=True)
            hi_pick, _ = bk.segment_pick(ok, gids, capacity, "last",
                                         alive=salive, ignore_nulls=True)
            has = lo_has[gids]
            fr.order_vals = torch.where(special, 0, w).to(w.dtype)
            fr.special = special
            fr.dom_lo = torch.where(has, lo_pick[gids], 1)
            fr.dom_hi = torch.where(has, hi_pick[gids], 0)
    return fr


def _bsearch(vals: torch.Tensor, target: torch.Tensor, lo0: torch.Tensor,
             hi0: torch.Tensor, side: str) -> torch.Tensor:
    """Per-row binary search over a shared array, sorted within each
    row's [lo0, hi0): the first j there with vals[j] >= target ("left")
    or > target ("right"); hi0 when there is none. A fixed number of
    steps, log2 of the capacity."""
    cap = vals.shape[0]
    lo, hi = lo0.to(torch.int64), hi0.to(torch.int64)
    for _ in range(max(1, math.ceil(math.log2(max(cap, 2)))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = vals[mid.clamp(0, cap - 1)]
        pred = v < target if side == "left" else v <= target
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def frame_bounds(fr: FrameCtx, frame_type: str, lower, upper):
    """Each row's inclusive frame [lo, hi] and an empty mask. ``lower`` /
    ``upper``: None is unbounded; for ROWS an int offset (negative
    preceding, 0 the current row); for RANGE a numeric offset on the one
    order key, 0 the current row with its peers."""
    if frame_type == "rows":
        lo = fr.seg_first if lower is None else torch.maximum(
            fr.idx + int(lower), fr.seg_first)
        hi = fr.seg_last if upper is None else torch.minimum(
            fr.idx + int(upper), fr.seg_last)
    else:
        if any(b not in (None, 0) for b in (lower, upper)) \
                and fr.order_vals is None:
            raise ValueError(
                "RANGE window frame with offsets requires exactly one "
                "numeric/date/timestamp ORDER BY key")

        def target(off):
            if fr.order_vals.is_floating_point():
                return fr.order_vals + float(off)
            return fr.order_vals + int(off)

        if lower is None:
            lo = fr.seg_first
        elif lower == 0:
            lo = fr.peer_first
        else:
            found = _bsearch(fr.order_vals, target(lower), fr.dom_lo,
                             fr.dom_hi + 1, "left")
            lo = torch.where(fr.special, fr.peer_first, found)
        if upper is None:
            hi = fr.seg_last
        elif upper == 0:
            hi = fr.peer_last
        else:
            found = _bsearch(fr.order_vals, target(upper), fr.dom_lo,
                             fr.dom_hi + 1, "right") - 1
            hi = torch.where(fr.special, fr.peer_last, found)
    return lo, hi, (lo > hi) | ~fr.salive


def segmented_prefix_sum(a: torch.Tensor,
                         seg_first: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum restarting at each row's ``seg_first``. An
    integer sum is exact in any order: one running sum, less its value
    before the segment. A float sum adds by doubling distances (step d:
    each row adds the row d before it when that row is in its segment):
    the same element-wise additions of the same operands on every device,
    so the CPU and the GPU give the same bits, and a segment's sums never
    carry the rounding of the rows before it."""
    if not a.is_floating_point():
        c = torch.cumsum(a, 0)
        before = torch.where(seg_first > 0,
                             c[(seg_first - 1).clamp(min=0)], 0)
        return c - before.to(c.dtype)
    n = a.shape[0]
    idx = torch.arange(n, device=a.device)
    d = 1
    while d < n:
        take = idx - d >= seg_first
        shifted = torch.nn.functional.pad(a[:-d], (d, 0))
        a = a + torch.where(take, shifted, 0.0).to(a.dtype)
        d *= 2
    return a


def _exclusive_count(flag: torch.Tensor) -> torch.Tensor:
    """c[0] = 0, c[i] = the set flags among the first i (n + 1 values)."""
    return torch.cat([flag.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(flag.to(torch.int64), 0)])


def _rmq_table(data: torch.Tensor, neutral, pick, levels: int):
    """The sparse table of range minima (or maxima) for ``levels`` levels:
    level k holds the pick of the 2^k rows from each row (the neutral value
    past the end)."""
    tables = [data]
    for k in range(1, levels):
        w = 1 << (k - 1)
        t = tables[-1]
        tables.append(pick(t, torch.cat([t[w:], torch.full(
            (w,), neutral, dtype=t.dtype, device=t.device)])))
    return torch.stack(tables)


def rmq_reduce(data: torch.Tensor, neutral, kind: str, lo, hi, empty):
    """Min or max over each row's inclusive [lo, hi], the neutral value
    where the frame is empty: two lookups in a sparse table, as the JAX
    package's ``rmq_reduce``. The table gets only the levels the longest
    frame needs (level k answers every frame of 2^k to 2^(k+1) - 1 rows),
    so a frame of a few rows costs a few copies of the column."""
    cap = data.shape[0]
    pick = _min_pick if kind == "min" else _max_pick
    length = torch.clamp(hi - lo + 1, min=1, max=max(cap, 1))
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    table = _rmq_table(data, neutral, pick, int(k.max()) + 1 if cap else 1)
    a = table[k, lo.clamp(0, cap - 1)]
    b = table[k, (hi - (1 << k) + 1).clamp(0, cap - 1)]
    return torch.where(empty, torch.tensor(neutral, dtype=data.dtype,
                                           device=data.device), pick(a, b))


def _min_pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The smaller, -0.0 below 0.0 (XLA's min, the JAX device path's;
    ``torch.minimum`` returns either zero)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    return torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)


def _max_pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not a.is_floating_point():
        return torch.maximum(a, b)
    return torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)


def frame_reduce_buffer(fr: FrameCtx, buf: ColV, kind: str, lo, hi, empty,
                        ignore_nulls: bool = False) -> ColV:
    """One aggregate buffer reduced over each row's frame [lo, hi] by the
    buffer's reduction kind (the group-by kinds, so an aggregate's
    ``project`` and ``evaluate`` serve windows unchanged), valid where a
    valid row takes part: ``sum`` as a difference of the partition's
    prefix sums (``segmented_prefix_sum``), ``min``/``max`` by the sparse
    table (strings by their rank in byte order), ``first``/``last`` the
    frame's end row, or with ``ignore_nulls`` its first or last valid
    row."""
    participating = buf.validity & fr.salive
    pcount = _exclusive_count(participating)
    lo_c = torch.where(empty, 0, lo)
    hi1 = torch.where(empty, 0, hi + 1)
    any_valid = (pcount[hi1] - pcount[lo_c]) > 0
    if kind == "sum":
        contrib = torch.where(participating, buf.data, 0).to(buf.data.dtype)
        floating = contrib.is_floating_point()
        # a float frame's NaNs and infinities are counted, not summed, so
        # one never reaches a frame that does not hold it
        p = segmented_prefix_sum(
            torch.where(torch.isfinite(contrib), contrib, 0).to(contrib.dtype)
            if floating else contrib, fr.seg_first)
        before = torch.where(lo_c > fr.seg_first, p[(lo_c - 1).clamp(min=0)],
                             0).to(p.dtype)
        data = torch.where(empty, 0, p[(hi1 - 1).clamp(min=0)] - before)
        if floating:
            data = _frame_nonfinite(contrib, lo_c, hi1, data)
        return ColV(buf.dtype, data.to(p.dtype), any_valid)
    if kind in ("min", "max"):
        if buf.dtype is DType.STRING:
            return _frame_minmax_string(fr, buf, kind, lo, hi, empty,
                                        participating, any_valid)
        return _frame_minmax(buf, kind, lo, hi, empty, participating,
                             pcount, lo_c, hi1, any_valid)
    if kind not in ("first", "last"):
        raise ValueError(kind)
    if not ignore_nulls:
        pos = (lo if kind == "first" else hi).clamp(0, fr.capacity - 1)
        valid = ~empty & buf.validity[pos] & fr.salive[pos]
    else:
        cnt_incl = pcount[1:]
        if kind == "first":
            # the first row of the frame past the count before it
            pos = _bsearch(cnt_incl, pcount[lo_c], lo_c, hi1, "right")
        else:
            # the row where the count reaches the frame's total
            pos = _bsearch(cnt_incl, pcount[hi1] - 1, lo_c, hi1, "right")
        pos = pos.clamp(0, fr.capacity - 1)
        valid = any_valid & ~empty
    return bk.take_colv(buf, pos).with_validity(valid)


def _frame_nonfinite(contrib: torch.Tensor, lo_c, hi1,
                     data: torch.Tensor) -> torch.Tensor:
    """Spark's framed float sum, which adds each frame on its own: NaN
    where the frame holds a NaN or both infinities, else the infinity it
    holds, else the sum of its finite values (``data``). The constants
    keep one NaN bit pattern on every device."""
    def held(flag):
        c = _exclusive_count(flag)
        return (c[hi1] - c[lo_c]) > 0
    pos, neg = held(contrib == math.inf), held(contrib == -math.inf)
    nan = held(torch.isnan(contrib)) | (pos & neg)
    out = torch.where(pos, math.inf, torch.where(neg, -math.inf, data))
    return torch.where(nan, math.nan, out).to(data.dtype)


def _frame_minmax(buf: ColV, kind: str, lo, hi, empty, participating,
                  pcount, lo_c, hi1, any_valid) -> ColV:
    """Numeric framed min/max in Spark's order: NaN is above every value,
    so it is taken as +inf for the table and counted; a max that saw a
    NaN is NaN, a min only when every valid value was."""
    from spark_rapids_tpu_torch.exprs.aggregates import _reduce_neutral
    dt = buf.dtype
    d = buf.data
    if dt is DType.BOOLEAN:
        neutral = int(kind == "min")
        contrib = torch.where(participating, d.to(torch.int8), neutral) \
            .to(torch.int8)
        res = rmq_reduce(contrib, neutral, kind, lo, hi, empty)
        return ColV(dt, res.to(torch.bool), any_valid)
    if not dt.is_floating:
        neutral = _reduce_neutral(kind, dt)
        contrib = torch.where(participating, d, neutral).to(d.dtype)
        return ColV(dt, rmq_reduce(contrib, neutral, kind, lo, hi, empty),
                    any_valid)
    nan = torch.isnan(d) & participating
    neutral = math.inf if kind == "min" else -math.inf
    contrib = torch.where(participating, torch.where(nan, math.inf, d),
                          neutral).to(d.dtype)
    res = rmq_reduce(contrib, neutral, kind, lo, hi, empty)
    ncount = _exclusive_count(nan)
    n_nan = ncount[hi1] - ncount[lo_c]
    if kind == "max":
        res = torch.where(n_nan > 0, math.nan, res)
    else:
        vcount = pcount[hi1] - pcount[lo_c]
        res = torch.where((vcount > 0) & (n_nan == vcount), math.nan, res)
    return ColV(dt, res.to(d.dtype), any_valid)


def _frame_minmax_string(fr: FrameCtx, buf: ColV, kind: str, lo, hi, empty,
                         participating, any_valid) -> ColV:
    """Framed min/max of strings: each valid row's rank in byte order (one
    sort), the integer table over the ranks, then the row of the picked
    rank."""
    n = fr.capacity
    order = bk.sort_indices([(buf, True, True)], participating)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    if kind == "min":
        key = torch.where(participating, rank, n + 1)
        res = rmq_reduce(key, n + 1, "min", lo, hi, empty)
        has = res <= n
    else:
        key = torch.where(participating, rank, -1)
        res = rmq_reduce(key, -1, "max", lo, hi, empty)
        has = res >= 0
    pick = order[res.clamp(0, n - 1)]
    out = bk.take_colv(buf, pick)
    return out.with_validity(has & any_valid & out.validity)
