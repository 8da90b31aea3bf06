"""Logical plan nodes produced by the DataFrame API (the subset this port
plans: scan, filter, aggregate, sort, repartition)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
