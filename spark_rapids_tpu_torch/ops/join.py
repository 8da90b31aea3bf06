"""Equi-join kernels: the JAX package's ``ops/join.py`` on torch tensors.

Both sides' keys get dense group ids from one shared sort over the union of
the keys; rows join when they share a group id. The output size depends on
the data, so the join runs in two phases:

  size    (``join_size``)   per-emit-group counts, their exclusive scan and
                            the total; the total is read on the host once;
  gather  (``join_gather``) at the total's capacity bucket, the (left row,
                            right row) pair of every output row.

Spark semantics: a null key never matches; NaN keys match each other. Kinds:
inner, left, right, full, left_semi, left_anti, and ``cross`` (no keys:
each live stream row emits every live build row, in build row order; the
nested-loop and cartesian execs' kernel).

Emit groups ``[0, S)`` are the stream (left) rows: each emits its match
count (1 null-padded row when unmatched under left/full, 0 or 1 under
semi/anti); groups ``[S, S + B)`` are the build (right) rows: each emits 1
when unmatched under right/full. One exclusive scan over all S + B groups
gives both halves their output offsets. Offsets and row indices are int64
throughout, so no gather index wraps.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths

JOIN_KINDS = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross")


def _any_null(keys: Sequence[ColV]) -> torch.Tensor:
    out = ~keys[0].validity
    for k in keys[1:]:
        out = out | ~k.validity
    return out


def _concat_colv(a: ColV, b: ColV) -> ColV:
    ad, bd = (align_widths(a.data, b.data) if a.lengths is not None
              else (a.data, b.data))
    return ColV(a.dtype, torch.cat([ad, bd]),
                torch.cat([a.validity, b.validity]),
                torch.cat([a.lengths, b.lengths])
                if a.lengths is not None else None)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def join_size(l_keys: Sequence[ColV], r_keys: Sequence[ColV],
              l_alive: torch.Tensor, r_alive: torch.Tensor,
              how: str) -> Dict[str, torch.Tensor]:
    """Phase 1 -> a dict of tensors: emit_counts [S+B], emit_offsets [S+B],
    total (0-d), border [B] (build rows by group id, dead rows last),
    start_b [S] (per stream row: its group's first position in
    ``border``), sgid [S], matches_l [S]."""
    if how not in JOIN_KINDS:
        raise ValueError(f"unsupported join type {how}")
    S, B = l_alive.shape[0], r_alive.shape[0]
    G = S + B
    device = l_alive.device
    if how == "cross":
        b_count = r_alive.sum()
        matches_l = torch.where(l_alive, b_count, 0)
        emit_counts = torch.cat([matches_l, torch.zeros(
            B, dtype=torch.int64, device=device)])
        return dict(emit_counts=emit_counts,
                    emit_offsets=_exclusive_cumsum(emit_counts),
                    total=emit_counts.sum(),
                    # the live build rows first, in row order
                    border=bk._stable_argsort((~r_alive).to(torch.int8)),
                    start_b=torch.zeros(S, dtype=torch.int64, device=device),
                    sgid=torch.zeros(S, dtype=torch.int64, device=device),
                    matches_l=matches_l)
    l_ok = l_alive & ~_any_null(l_keys)
    r_ok = r_alive & ~_any_null(r_keys)
    keys_all = [_concat_colv(lk, rk) for lk, rk in zip(l_keys, r_keys)]
    alive_all = torch.cat([l_ok, r_ok])
    order = bk.sort_indices([(k, True, True) for k in keys_all], alive_all)
    starts = bk.rows_equal_adjacent(keys_all, order, alive_all)
    gids_sorted = torch.cumsum(starts.to(torch.int64), 0) - 1
    pos = torch.arange(G, device=device)
    inv = torch.empty_like(order)
    inv[order] = pos                       # the inverse permutation
    gid_by_row = torch.where(alive_all, gids_sorted[inv], -1)
    sgid, bgid = gid_by_row[:S], gid_by_row[S:]

    # per-row group counts without scatters: each sorted row's group start
    # and end position, member counts as inclusive-cumsum differences,
    # gathered back through the inverse. The JAX package finds the start
    # and end with cummax/cummin over the start marks; torch's CUDA cummax
    # and cummin took 134 ms each over SF 10 Q3's two joins (NVIDIA H100
    # 80GB HBM3, 700 W, chip_smoke.py --profile), so here two binary
    # searches of each row's group id in the non-decreasing group ids give
    # the same positions (dead rows, sorted last, keep the last group's id:
    # its end is the last row, as with cummin)
    alive_sorted = alive_all[order]
    is_b = (order >= S) & alive_sorted
    is_s = (order < S) & alive_sorted
    csum_b = torch.cumsum(is_b.to(torch.int64), 0)
    csum_s = torch.cumsum(is_s.to(torch.int64), 0)
    st = torch.searchsorted(gids_sorted, gids_sorted)
    en = torch.searchsorted(gids_sorted, gids_sorted, right=True) - 1
    b_at_st = is_b[st].to(torch.int64)
    s_at_st = is_s[st].to(torch.int64)
    cnt_b_row = (csum_b[en] - csum_b[st] + b_at_st)[inv]
    cnt_s_row = (csum_s[en] - csum_s[st] + s_at_st)[inv]
    startb_row = (csum_b[st] - b_at_st)[inv]    # build rows before my group

    matches_l = torch.where(sgid >= 0, cnt_b_row[:S], 0)
    matched_b = (bgid >= 0) & (cnt_s_row[S:] > 0)
    start_b = torch.where(sgid >= 0, startb_row[:S], 0)

    zeros_b = torch.zeros(B, dtype=torch.int64, device=device)
    unmatched_b = (r_alive & ~matched_b).to(torch.int64)
    emit_l = {
        "inner": matches_l,
        "left": torch.where(l_alive, matches_l.clamp(min=1), 0),
        "right": matches_l,
        "full": torch.where(l_alive, matches_l.clamp(min=1), 0),
        "left_semi": (matches_l > 0).to(torch.int64),
        "left_anti": (l_alive & (matches_l == 0)).to(torch.int64),
    }[how]
    emit_r = unmatched_b if how in ("right", "full") else zeros_b
    emit_counts = torch.cat([emit_l, emit_r])
    # build rows ordered by group id, dead rows last
    border = bk._stable_argsort(torch.where(bgid >= 0, bgid, G))
    return dict(emit_counts=emit_counts,
                emit_offsets=_exclusive_cumsum(emit_counts),
                total=emit_counts.sum(), border=border, start_b=start_b,
                sgid=sgid, matches_l=matches_l)


def join_gather(sized: Dict[str, torch.Tensor], S: int, B: int, out_cap: int,
                how: str):
    """Phase 2: output row -> (left_row, left_valid, right_row, right_valid,
    total). The rows are gather indices into the two sides; a False valid
    bit null-pads that side (outer joins) or marks it absent (semi/anti emit
    the left side only)."""
    emit_offsets = sized["emit_offsets"]
    total = sized["total"]
    device = emit_offsets.device
    p = torch.arange(out_cap, device=device)
    in_range = p < total
    g = (_searchsorted_right(emit_offsets, p) - 1).clamp(0, S + B - 1)
    k = p - emit_offsets[g]
    from_stream = g < S
    srow = g.clamp(0, S - 1)
    if how == "cross":
        right_row = sized["border"][k.clamp(0, max(B - 1, 0))]
        valid = in_range & from_stream
        return srow, valid, right_row, valid, total
    if how in ("left_semi", "left_anti"):
        zeros = torch.zeros_like(srow)
        return srow, in_range, zeros, torch.zeros_like(in_range), total
    brow_unmatched = (g - S).clamp(0, max(B - 1, 0))
    has_match = sized["matches_l"][srow] > 0
    bpos = (sized["start_b"][srow] + k).clamp(0, max(B - 1, 0))
    right_from_match = sized["border"][bpos]
    left_row = torch.where(from_stream, srow, 0)
    left_valid = in_range & from_stream
    right_row = torch.where(from_stream, right_from_match, brow_unmatched)
    right_valid = in_range & ((from_stream & has_match) | ~from_stream)
    return left_row, left_valid, right_row, right_valid, total


def gather_join_output(l_cols: Sequence[ColV], r_cols: Sequence[ColV],
                       left_row, left_valid, right_row,
                       right_valid) -> List[ColV]:
    """The output columns from the gather indices; a False side-valid bit
    nulls that side's columns (outer padding)."""
    out: List[ColV] = []
    for v in l_cols:
        g = bk.take_colv(v, left_row)
        out.append(g.with_validity(g.validity & left_valid))
    for v in r_cols:
        g = bk.take_colv(v, right_row)
        out.append(g.with_validity(g.validity & right_valid))
    return out


def _searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(a, v, right=True)
