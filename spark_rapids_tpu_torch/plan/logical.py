"""Logical plan nodes produced by the DataFrame API (the subset this port
plans: an in-memory or a file scan, a range, project, filter, aggregate, sort,
limit, join, repartition, union, expand, generate and window, and a cached
subtree)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
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
class Range(LogicalPlan):
    """``session.range``: the LONG column ``id`` from start to end by
    step."""
    start: int
    end: int
    step: int = 1

    def schema(self) -> Schema:
        return Schema([Field("id", DType.LONG, nullable=False)])


@dataclass
class FileScan(LogicalPlan):
    """A scan of parquet, ORC or CSV files."""
    fmt: str
    paths: Tuple[str, ...]
    read_schema: Schema           # the full schema, partition columns too
    options: Tuple[Tuple[str, str], ...] = ()
    filters: Tuple[Expression, ...] = ()   # pushed-down predicates
    #: hive-partition discovery results (io.datasource.PartitionedFile)
    files: Tuple = ()
    partition_schema: Schema = field(default_factory=lambda: Schema([]))
    #: emit the hidden per-file metadata columns (set by the planner when
    #: the query references input_file_name() or the block expressions)
    with_file_meta: bool = False

    def schema(self) -> Schema:
        if not self.with_file_meta:
            return self.read_schema
        from spark_rapids_tpu_torch.exprs.misc import INPUT_FILE_META_SPEC
        return Schema(list(self.read_schema.fields) + [
            Field(name, dtype, False)
            for name, dtype, _default in INPUT_FILE_META_SPEC])


@dataclass
class WriteFiles(LogicalPlan):
    """The write command (GpuDataWritingCommandExec /
    InsertIntoHadoopFsRelation analog). Produces no rows."""
    spec: object                  # io.write_exec.WriteSpec
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        return Schema([])


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


@dataclass
class Union(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan

    @property
    def children(self):
        return (self.left, self.right)

    def schema(self) -> Schema:
        return self.left.schema()


@dataclass
class Expand(LogicalPlan):
    """Each input row becomes one output row per projection list (Spark's
    Expand, under rollup, cube and grouping sets). A slot's type is its
    first non-NULL projection's; it is nullable if any projection is
    nullable or NULL."""
    projections: Tuple[Tuple[Expression, ...], ...]
    names: Tuple[str, ...]
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        cs = self.child.schema()
        fields = []
        for i, name in enumerate(self.names):
            slot = [bind_expression(p[i], cs) for p in self.projections]
            dt = next((b.dtype() for b in slot if b.dtype() is not DType.NULL),
                      DType.NULL)
            nullable = any(b.nullable() or b.dtype() is DType.NULL
                           for b in slot)
            fields.append(Field(name, dt, nullable))
        return Schema(fields)


@dataclass
class Generate(LogicalPlan):
    """Explode (or posexplode) of a created array (Spark's Generate): the
    child's columns, [pos], then the element column; one output row per
    element per input row."""
    elements: Tuple[Expression, ...]
    pos: bool
    col_name: str
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        from spark_rapids_tpu_torch.exprs.generators import element_type
        cs = self.child.schema()
        fields = list(cs.fields)
        if self.pos:
            fields.append(Field("pos", DType.INT, nullable=False))
        bound = tuple(bind_expression(e, cs) for e in self.elements)
        nullable = any(b.nullable() or b.dtype() is DType.NULL
                       for b in bound)
        fields.append(Field(self.col_name, element_type(bound), nullable))
        return Schema(fields)


@dataclass
class Window(LogicalPlan):
    """The child's columns and one window column per expression; every
    expression shares one (partition, order) spec (the API groups them)."""
    wexprs: Tuple[Expression, ...]   # Alias(WindowExpression) entries
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def schema(self) -> Schema:
        cs = self.child.schema()
        fields = list(cs.fields)
        for e in self.wexprs:
            b = bind_expression(e, cs)
            fields.append(Field(e.name_hint, b.dtype(), b.nullable()))
        return Schema(fields)


@dataclass(eq=False)
class CachedRelation(LogicalPlan):
    """A subtree replaced by its cached materialization (Spark's
    InMemoryRelation role): ``entry`` is a memory.df_cache.CachedData, and
    two CachedRelations are the same relation when they reference the same
    entry (identity equality)."""
    entry: object

    def schema(self) -> Schema:
        return self.entry.logical.schema()
