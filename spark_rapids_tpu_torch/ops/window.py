"""Window positions (the JAX package's ``ops/window.py``, the part the
ranking functions need).

One sort by (partition keys, order keys) puts every partition's rows in a
contiguous run in order; ``build_frame_ctx`` then gives each row, in that
sorted domain, the first row of its partition and of its peer group (rows
equal on every partition and order key; null == null, NaN == NaN, -0.0 ==
0.0, as grouping compares them). The JAX package takes the
group starts with a running ``cummax``; here each row gathers its group's
start by group id, which needs no scan (torch's CUDA ``cummax`` was the
slowest kernel of the port's joins until it was replaced the same way).

The frame bounds and framed reductions (``frame_bounds``,
``frame_reduce_buffer``) and the JAX ``FrameCtx``'s other fields (the
partition and peer ends and sizes, the RANGE-offset domain) come with the
framed aggregates; they are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

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
    peer_first: torch.Tensor  # first row of the row's peer group


def _group_first(starts: torch.Tensor) -> torch.Tensor:
    """Group-start marks over sorted rows -> the first row of each row's
    group. Dead rows sort last and belong to the last group, as in the JAX
    package."""
    cap = starts.shape[0]
    gids = (torch.cumsum(starts.to(torch.int64), 0) - 1).clamp_(0, cap - 1)
    first_rows = torch.cat([torch.nonzero(starts).squeeze(1),
                            starts.new_zeros(1, dtype=torch.int64)])
    return first_rows[gids]


def build_frame_ctx(part_keys: Sequence[ColV], order_keys, order: torch.Tensor,
                    alive: torch.Tensor, capacity: int) -> FrameCtx:
    """``part_keys`` and ``order_keys`` ((ColV, ascending, nulls_first)
    triples) are the unsorted columns and ``order`` the sort permutation;
    everything returned lives in the sorted domain."""
    idx = torch.arange(capacity, dtype=torch.int64, device=alive.device)
    seg_first = _group_first(bk.rows_equal_adjacent(part_keys, order, alive))
    peer_first = seg_first
    if order_keys:
        all_keys = list(part_keys) + [k for k, _, _ in order_keys]
        peer_first = _group_first(bk.rows_equal_adjacent(all_keys, order,
                                                         alive))
    return FrameCtx(capacity, idx, alive[order], seg_first, peer_first)
