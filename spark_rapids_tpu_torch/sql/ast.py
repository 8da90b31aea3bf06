"""SQL AST node types (frozen dataclasses; structural equality is what the
planner uses to match GROUP BY expressions against SELECT/HAVING/ORDER BY
occurrences, the way Catalyst matches semantically-equal expressions)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Node:
    pass


# ---- expressions -----------------------------------------------------------
@dataclass(frozen=True)
class ColRef(Node):
    name: str
    qualifier: Optional[str] = None


@dataclass(frozen=True)
class Lit(Node):
    value: object        # python int/float/str/bool/None/datetime.date


@dataclass(frozen=True)
class Interval(Node):
    n: int
    unit: str            # day | month | year


@dataclass(frozen=True)
class BinOp(Node):
    op: str              # + - * / % = <> < <= > >= and or ||
    left: Node
    right: Node


@dataclass(frozen=True)
class UnaryOp(Node):
    op: str              # not | neg
    child: Node


@dataclass(frozen=True)
class FuncCall(Node):
    name: str            # lowercase
    args: Tuple[Node, ...]
    distinct: bool = False
    star: bool = False   # count(*)


@dataclass(frozen=True)
class CaseWhen(Node):
    branches: Tuple[Tuple[Node, Node], ...]
    otherwise: Optional[Node]


@dataclass(frozen=True)
class Between(Node):
    value: Node
    low: Node
    high: Node
    negated: bool = False


@dataclass(frozen=True)
class InList(Node):
    value: Node
    options: Tuple[Node, ...]
    negated: bool = False


@dataclass(frozen=True)
class LikeOp(Node):
    value: Node
    pattern: str
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Node):
    value: Node
    negated: bool = False


@dataclass(frozen=True)
class CastExpr(Node):
    value: Node
    to: str


@dataclass(frozen=True)
class ExtractExpr(Node):
    part: str            # year | month | day
    value: Node


# ---- subquery expressions --------------------------------------------------
@dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Select"


@dataclass(frozen=True)
class ExistsSubquery(Node):
    query: "Select"
    negated: bool = False


@dataclass(frozen=True)
class InSubquery(Node):
    value: Node
    query: "Select"
    negated: bool = False


# ---- relations / statement -------------------------------------------------
@dataclass(frozen=True)
class TableRef(Node):
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class PivotRef(Node):
    """FROM rel PIVOT (agg [AS a][, ...] FOR col IN (lit [AS a], ...))
    (Spark SQL's PIVOT clause; lowers to GroupedData.pivot with the
    implicit group-by over the untouched columns)."""
    child: Node                   # TableRef | SubqueryRef
    aggs: Tuple                   # ((expr, alias|None), ...)
    pivot_col: "ColRef"
    values: Tuple                 # ((literal value, alias|None), ...)
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef(Node):
    query: "Select"
    alias: str


@dataclass(frozen=True)
class JoinItem(Node):
    """Explicit JOIN ... ON clause attached to the previous FROM item."""
    how: str             # inner | left | right | full | cross | semi | anti
    relation: Node       # TableRef | SubqueryRef
    condition: Optional[Node]


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Node
    ascending: bool = True
    #: None = Spark default (nulls first when ascending, last when not)
    nulls_first: Optional[bool] = None


@dataclass(frozen=True)
class WindowSpecNode(Node):
    """OVER (...) spec: frame bounds use None for UNBOUNDED, ints otherwise
    (negative = preceding, 0 = current row, positive = following)."""
    partition_by: Tuple[Node, ...] = ()
    order_by: Tuple["OrderItem", ...] = ()
    frame_type: Optional[str] = None       # "rows" | "range" | None=default
    frame_lower: Optional[int] = None
    frame_upper: Optional[int] = None


@dataclass(frozen=True)
class WindowFuncCall(Node):
    """fn(...) OVER (spec) — ranking functions, lead/lag, or an aggregate
    evaluated as a window aggregate."""
    func: "FuncCall"
    spec: WindowSpecNode


@dataclass(frozen=True)
class Select(Node):
    items: Tuple[SelectItem, ...]          # empty = SELECT *
    relations: Tuple[Node, ...]            # TableRef/SubqueryRef/JoinItem
    where: Optional[Node]
    group_by: Tuple[Node, ...]
    having: Optional[Node]
    order_by: Tuple[OrderItem, ...]
    limit: Optional[int]
    distinct: bool = False
    select_star: bool = False
    #: groupby | rollup | cube (GROUP BY ROLLUP(...)/CUBE(...))
    group_mode: str = "groupby"
    #: WITH clause: (name, query) in definition order (non-recursive; later
    #: CTEs may reference earlier ones)
    ctes: Tuple[Tuple[str, "Select"], ...] = ()


@dataclass(frozen=True)
class SetOp(Node):
    """UNION [ALL] / INTERSECT / EXCEPT chain (left-folded). Members are
    full SELECTs; ORDER BY/LIMIT written inside a member bind to that
    member."""
    op: str                    # union_all | union | intersect | except
    left: Node                             # Select | SetOp
    right: Node                            # Select
    ctes: Tuple[Tuple[str, "Select"], ...] = ()
