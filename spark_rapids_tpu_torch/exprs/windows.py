"""Window expressions (the JAX package's ``exprs/windows.py``): the frame
spec, ``WindowExpression``, the three ranking functions,
``percent_rank``, ``cume_dist``, ``ntile`` and lead/lag.

A ``WindowExpression`` pairs a function (an aggregate function, or a
window function) with its partition keys, order keys and frame. The window
exec sorts once per (partition, order) spec and hands every expression
under it one ``FrameCtx`` (``ops/window.py``): a ranking function reads
its positions, lead and lag gather at an offset inside the partition, and
an aggregate reduces its buffers over each row's frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression, widen
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.misc import SortOrder
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths


@dataclass(frozen=True)
class WindowFrame:
    """Frame spec. ``lower``/``upper``: None = unbounded; ROWS: an int row
    offset (negative = preceding); RANGE: a numeric offset on the single
    order key, 0 = CURRENT ROW (peer-inclusive)."""
    frame_type: str = "range"  # "rows" | "range"
    lower: Optional[Union[int, float]] = None
    upper: Optional[Union[int, float]] = 0


class WindowFunction(Expression):
    """Ranking-style function computed from partition and peer positions."""

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        raise NotImplementedError(type(self).__name__)

    def eval(self, ctx: EvalCtx) -> ColV:
        raise TypeError(f"{type(self).__name__} must be evaluated by a "
                        f"window exec")


@dataclass(frozen=True)
class WindowExpression(Expression):
    """function OVER (PARTITION BY part_keys ORDER BY orders frame)."""
    fn: Expression
    part_keys: Tuple[Expression, ...] = ()
    orders: Tuple[SortOrder, ...] = ()
    frame: Optional[WindowFrame] = None

    def __post_init__(self):
        if isinstance(self.fn, WindowFunction) and not self.orders:
            # Spark's analyzer error for rank/row_number without ORDER BY
            raise ValueError(
                f"window function {type(self.fn).__name__} requires the "
                f"window to be ordered (add orderBy to the window spec)")

    def resolved_frame(self) -> WindowFrame:
        """The frame, or SQL's default: RANGE UNBOUNDED PRECEDING to
        CURRENT ROW with an ORDER BY, the whole partition without."""
        if self.frame is not None:
            return self.frame
        if self.orders:
            return WindowFrame("range", None, 0)
        return WindowFrame("rows", None, None)

    def dtype(self) -> DType:
        return self.fn.dtype()

    def nullable(self) -> bool:
        return self.fn.nullable()

    @property
    def name_hint(self) -> str:
        return self.fn.name_hint

    def eval(self, ctx: EvalCtx) -> ColV:
        raise TypeError("WindowExpression must be evaluated by a window exec")

    def sort_spec_key(self):
        """Window expressions sharing this key share one sort and FrameCtx."""
        return (self.part_keys, self.orders)


def _rank_col(data: torch.Tensor, fr) -> ColV:
    return ColV(DType.INT, data.to(torch.int32), fr.salive)


@dataclass(frozen=True)
class RowNumber(WindowFunction):
    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        return _rank_col(fr.idx - fr.seg_first + 1, fr)


@dataclass(frozen=True)
class Rank(WindowFunction):
    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        return _rank_col(fr.peer_first - fr.seg_first + 1, fr)


@dataclass(frozen=True)
class DenseRank(WindowFunction):
    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        # the count of peer-group starts in (seg_first, idx]
        c = torch.cumsum((fr.peer_first == fr.idx).to(torch.int64), 0)
        return _rank_col(c - c[fr.seg_first.clamp(0, fr.capacity - 1)] + 1,
                         fr)


def _seg_size(fr) -> torch.Tensor:
    """The live rows of each row's partition (at least 1)."""
    return (fr.seg_last - fr.seg_first + 1).to(torch.float64)


@dataclass(frozen=True)
class PercentRank(WindowFunction):
    """(rank - 1) / (rows - 1), 0 in a partition of one row."""

    def dtype(self) -> DType:
        return DType.DOUBLE

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        rank = (fr.peer_first - fr.seg_first).to(torch.float64)
        size = _seg_size(fr)
        return ColV(DType.DOUBLE, torch.where(
            size > 1, rank / (size - 1).clamp(min=1), 0.0), fr.salive)


@dataclass(frozen=True)
class CumeDist(WindowFunction):
    """The share of the partition's rows up to the row's last peer."""

    def dtype(self) -> DType:
        return DType.DOUBLE

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        upto = (fr.peer_last - fr.seg_first + 1).to(torch.float64)
        return ColV(DType.DOUBLE, upto / _seg_size(fr), fr.salive)


@dataclass(frozen=True)
class NTile(WindowFunction):
    """ntile(n), Spark's buckets: the first (rows % n) buckets of a
    partition hold rows / n + 1 rows each, the rest rows / n."""
    n: int = 1

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"ntile() parameter n must be positive, got "
                             f"{self.n}")

    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return False

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        i0 = fr.idx - fr.seg_first
        rows = fr.seg_last - fr.seg_first + 1       # live rows, at least 1
        base = torch.div(rows, self.n, rounding_mode="floor")
        rem = rows - base * self.n
        big = rem * (base + 1)
        bucket_big = torch.div(i0, (base + 1).clamp(min=1),
                               rounding_mode="floor")
        bucket_small = rem + torch.div(i0 - big, base.clamp(min=1),
                                       rounding_mode="floor")
        return _rank_col(torch.where(i0 < big, bucket_big, bucket_small) + 1,
                         fr)


class _LeadLag(WindowFunction):
    """The value ``offset`` rows after (lead) or before (lag) the row in
    its partition, else the default (null when there is none)."""
    sign = 0

    def dtype(self) -> DType:
        return self.c.dtype()

    def window_eval(self, ctx: EvalCtx, fr) -> ColV:
        v = bk.as_column(self.c.eval(ctx), ctx.capacity)
        j = fr.idx + self.sign * int(self.offset)
        in_part = (j >= fr.seg_first) & (j <= fr.seg_last)
        at = bk.take_colv(v, j.clamp(0, fr.capacity - 1))
        default = self.default if self.default is not None \
            else Literal(None, DType.NULL)
        d = widen(default.eval(ctx), v.dtype, ctx)
        valid = torch.where(in_part, at.validity, d.validity) & fr.salive
        if v.dtype is DType.STRING:
            ad, dd = align_widths(at.data, d.data)
            return ColV(v.dtype, torch.where(in_part[:, None], ad, dd), valid,
                        torch.where(in_part, at.lengths, d.lengths))
        return ColV(v.dtype, torch.where(in_part, at.data, d.data), valid)


@dataclass(frozen=True)
class Lead(_LeadLag):
    c: Expression = None  # type: ignore[assignment]
    offset: int = 1
    default: Optional[Expression] = None
    sign = 1


@dataclass(frozen=True)
class Lag(_LeadLag):
    c: Expression = None  # type: ignore[assignment]
    offset: int = 1
    default: Optional[Expression] = None
    sign = -1
