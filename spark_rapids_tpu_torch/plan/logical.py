"""Logical plan nodes produced by the DataFrame API (the subset this port
plans: scan, project, filter, aggregate, sort, limit, join, repartition)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.exprs.core import Expression, bind_expression
from spark_rapids_tpu_torch.exprs.misc import SortOrder


class LogicalPlan:
    @property
    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def schema(self) -> Schema:
        raise NotImplementedError


@dataclass
class LocalRelation(LogicalPlan):
    batch: HostBatch

    def schema(self) -> Schema:
        return self.batch.schema


@dataclass
class Project(LogicalPlan):
    exprs: Tuple[Expression, ...]   # named by Alias or by attribute name
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        cs = self.child.schema()
        fields = []
        for e in self.exprs:
            b = bind_expression(e, cs)
            fields.append(Field(e.name_hint, b.dtype(), b.nullable()))
        return Schema(fields)


@dataclass
class Filter(LogicalPlan):
    condition: Expression
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        return self.child.schema()


@dataclass
class Aggregate(LogicalPlan):
    grouping: Tuple[Expression, ...]
    aggregates: Tuple[Expression, ...]   # Alias(AggregateFunction) entries
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        cs = self.child.schema()
        fields = []
        for e in self.grouping + self.aggregates:
            b = bind_expression(e, cs)
            fields.append(Field(e.name_hint, b.dtype(), b.nullable()))
        return Schema(fields)


@dataclass
class Sort(LogicalPlan):
    orders: Tuple[SortOrder, ...]
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        return self.child.schema()


@dataclass
class Repartition(LogicalPlan):
    num_partitions: int
    child: LogicalPlan
    keys: Tuple[Expression, ...] = ()   # empty = round robin

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        return self.child.schema()


@dataclass
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        return self.child.schema()


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    how: str    # inner | left | right | full | left_semi | left_anti | cross
    left_keys: Tuple[Expression, ...] = ()
    right_keys: Tuple[Expression, ...] = ()
    condition: Optional[Expression] = None

    @property
    def children(self):
        return (self.left, self.right)

    def schema(self) -> Schema:
        """Left fields then right fields (none for semi/anti joins); the
        side an outer join may null-pad becomes nullable; a repeated name
        gets the suffix ``_1``, ``_2``, ..."""
        lf = list(self.left.schema().fields)
        rf = list(self.right.schema().fields)
        if self.how in ("left_semi", "left_anti"):
            return Schema(lf)
        if self.how in ("left", "full"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        if self.how in ("right", "full"):
            lf = [Field(f.name, f.dtype, True) for f in lf]
        names, out = set(), []
        for f in lf + rf:
            name, i = f.name, 0
            while name in names:
                i += 1
                name = f"{f.name}_{i}"
            names.add(name)
            out.append(Field(name, f.dtype, f.nullable))
        return Schema(out)
