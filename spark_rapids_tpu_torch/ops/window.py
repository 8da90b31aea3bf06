"""Window positions, frames and framed sums (the JAX package's
``ops/window.py``, without the framed min/max, first and last).

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
reduces an aggregate's sum buffer over those intervals (so a sum, a count
or an average is framed): a difference of an exclusive prefix sum at the
two ends. A float prefix sum on the GPU is taken in a fixed order
(``prefix_sum``), so the same rows give the same bits every run. Framed
min and max (the JAX package's sparse-table RMQ), first and last are not
ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.ops import batch_kernels as bk

#: row length of ``prefix_sum``'s fixed-order blocks
_SCAN_BLOCK = 1024


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


def prefix_sum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum. An integer sum is exact in any order and the
    CPU adds in row order; on the GPU a float sum adds in a fixed order:
    within rows of ``_SCAN_BLOCK`` values (torch's per-row scan of a 2-D
    tensor), then the rows' totals the same way. torch's 1-D CUDA scan
    (CUB's decoupled look-back) is not used for floats: which partial sums
    it combines depends on timing, and with them the last bits."""
    if not a.is_floating_point() or a.device.type == "cpu":
        return torch.cumsum(a, 0)
    n = a.shape[0]
    rows = max(2, -(-n // _SCAN_BLOCK))   # two rows keep the 2-D kernel
    blocks = torch.nn.functional.pad(a, (0, rows * _SCAN_BLOCK - n)) \
        .view(rows, _SCAN_BLOCK)
    c = torch.cumsum(blocks, dim=1)
    if n <= _SCAN_BLOCK:
        return c[0, :n]
    carry = prefix_sum(c[:, -1])
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    return (c + carry[:, None]).view(-1)[:n]


def _exclusive_prefix_sum(a: torch.Tensor) -> torch.Tensor:
    """p[0] = 0, p[i] = sum(a[:i]) (n + 1 values)."""
    return torch.cat([a.new_zeros(1), prefix_sum(a)])


def frame_reduce_buffer(fr: FrameCtx, buf: ColV, kind: str, lo, hi,
                        empty) -> ColV:
    """One aggregate's ``sum`` buffer reduced over each row's frame
    [lo, hi] (the group-by reduction kind, so an aggregate's ``project``
    and ``evaluate`` serve windows unchanged); valid where a valid row
    takes part."""
    if kind != "sum":
        raise NotImplementedError(
            f"framed {kind} (the JAX package's RMQ and end picks) is not "
            f"ported yet")
    participating = buf.validity & fr.salive
    pcount = _exclusive_prefix_sum(participating.to(torch.int64))
    lo_c = torch.where(empty, 0, lo)
    hi1 = torch.where(empty, 0, hi + 1)
    p = _exclusive_prefix_sum(torch.where(participating, buf.data, 0)
                              .to(buf.data.dtype))
    return ColV(buf.dtype, p[hi1] - p[lo_c], (pcount[hi1] - pcount[lo_c]) > 0)
