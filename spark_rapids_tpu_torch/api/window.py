"""PySpark-style window specs: ``Window.partitionBy("a")
.orderBy(col("b").desc()).rowsBetween(Window.unboundedPreceding,
Window.currentRow)``, consumed by ``Column.over``."""
from __future__ import annotations

from typing import Optional, Tuple, Union

from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.api.dataframe import _to_expr
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.misc import SortOrder
from spark_rapids_tpu_torch.exprs.windows import WindowFrame

_MIN = -(1 << 63)
_MAX = (1 << 63) - 1


def _bound(v: Union[int, float]) -> Optional[Union[int, float]]:
    """A frame bound, the unbounded sentinels as None."""
    return None if v <= _MIN or v >= _MAX else v


class WindowSpec:
    def __init__(self, part: Tuple[Expression, ...] = (),
                 orders: Tuple[SortOrder, ...] = (),
                 frame: Optional[WindowFrame] = None):
        self._part = part
        self._orders = orders
        self._frame = frame

    def partitionBy(self, *cols: Union[str, Column]) -> "WindowSpec":
        return WindowSpec(tuple(_to_expr(c) for c in cols), self._orders,
                          self._frame)

    def orderBy(self, *cols: Union[str, Column]) -> "WindowSpec":
        orders = []
        for c in cols:
            e = _to_expr(c)
            orders.append(e if isinstance(e, SortOrder)
                          else SortOrder(e, True, True))
        return WindowSpec(self._part, tuple(orders), self._frame)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._part, self._orders,
                          WindowFrame("rows", _bound(start), _bound(end)))

    def rangeBetween(self, start, end) -> "WindowSpec":
        return WindowSpec(self._part, self._orders,
                          WindowFrame("range", _bound(start), _bound(end)))


class Window:
    unboundedPreceding = _MIN
    unboundedFollowing = _MAX
    currentRow = 0

    @staticmethod
    def partitionBy(*cols: Union[str, Column]) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols: Union[str, Column]) -> WindowSpec:
        return WindowSpec().orderBy(*cols)
