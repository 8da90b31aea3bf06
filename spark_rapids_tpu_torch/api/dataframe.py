"""DataFrame and session frontend.

A DataFrame builds a logical plan; ``collect`` plans the device operators
and runs them on the session's device, returning a ``HostBatch`` (numpy
buffers; ``.to_arrow()`` converts it where pyarrow is installed).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from spark_rapids_tpu_torch import device as device_mod
from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.columnar.host import HostBatch, concat_host_batches
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.exprs import (Alias, Coalesce, SortOrder,
                                          UnresolvedAttribute)
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.planner import plan_physical


def _to_expr(c: Union[str, Column]):
    return UnresolvedAttribute(c) if isinstance(c, str) else c.expr


class DataFrame:
    def __init__(self, logical: lp.LogicalPlan, session: "TpuSession"):
        self._plan = logical
        self.session = session

    def select(self, *cols: Union[str, Column]) -> "DataFrame":
        return DataFrame(lp.Project(tuple(_to_expr(c) for c in cols),
                                    self._plan), self.session)

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        """Add a column, or replace one in place (pyspark semantics)."""
        names = self._plan.schema().names()
        exprs = [Alias(c.expr, name) if n == name else UnresolvedAttribute(n)
                 for n in names]
        if name not in names:
            exprs.append(Alias(c.expr, name))
        return DataFrame(lp.Project(tuple(exprs), self._plan), self.session)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = tuple(Alias(UnresolvedAttribute(n), new) if n == old
                      else UnresolvedAttribute(n)
                      for n in self._plan.schema().names())
        return DataFrame(lp.Project(exprs, self._plan), self.session)

    def filter(self, cond: Column) -> "DataFrame":
        return DataFrame(lp.Filter(cond.expr, self._plan), self.session)

    def groupBy(self, *cols: Union[str, Column]) -> "GroupedData":
        return GroupedData(self, tuple(_to_expr(c) for c in cols))

    def agg(self, *cols: Column) -> "DataFrame":
        return GroupedData(self, ()).agg(*cols)

    def sort(self, *cols: Union[str, Column]) -> "DataFrame":
        orders = []
        for c in cols:
            e = _to_expr(c)
            orders.append(e if isinstance(e, SortOrder) else SortOrder(e))
        return DataFrame(lp.Sort(tuple(orders), self._plan), self.session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(lp.Limit(n, self._plan), self.session)

    def join(self, other: "DataFrame", on: Union[str, List],
             how: str = "inner") -> "DataFrame":
        """USING-style join: the key columns appear once in the output (the
        left side's; the right side's for a right join; coalesced for a full
        join). ``on`` may instead list ``(left_name, right_name)`` pairs for
        keys named differently on each side; both columns of a pair stay in
        the output."""
        how = {"leftsemi": "left_semi", "semi": "left_semi",
               "leftanti": "left_anti", "anti": "left_anti",
               "leftouter": "left", "rightouter": "right",
               "outer": "full", "fullouter": "full"}.get(how, how)
        raw = [on] if isinstance(on, str) else list(on)
        if any(isinstance(k, tuple) for k in raw):
            if not all(isinstance(k, tuple) for k in raw):
                raise ValueError(
                    "join keys must be all strings (USING semantics) or all "
                    "(left, right) pairs; use ('k', 'k') for same-named keys "
                    "in the pair form")
            return DataFrame(lp.Join(
                self._plan, other._plan, how,
                tuple(UnresolvedAttribute(a) for a, _ in raw),
                tuple(UnresolvedAttribute(b) for _, b in raw)), self.session)
        keys = tuple(UnresolvedAttribute(k) for k in raw)
        joined = lp.Join(self._plan, other._plan, how, keys, keys)
        if how in ("left_semi", "left_anti"):
            return DataFrame(joined, self.session)
        out = joined.schema()
        left_n = len(self._plan.schema())
        right_schema = other._plan.schema()
        # the output name of each key's right-side column
        right_out = {k: out[left_n + right_schema.index_of(k)].name
                     for k in raw}
        exprs = []
        for i, f in enumerate(out):
            if i >= left_n:
                if f.name not in right_out.values():
                    exprs.append(UnresolvedAttribute(f.name))
                continue
            if f.name in right_out and how == "full":
                exprs.append(Alias(Coalesce(
                    (UnresolvedAttribute(f.name),
                     UnresolvedAttribute(right_out[f.name]))), f.name))
            elif f.name in right_out and how == "right":
                exprs.append(Alias(UnresolvedAttribute(right_out[f.name]),
                                   f.name))
            else:
                exprs.append(UnresolvedAttribute(f.name))
        return DataFrame(lp.Project(tuple(exprs), joined), self.session)

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(lp.Join(self._plan, other._plan, "cross"),
                         self.session)

    def distinct(self) -> "DataFrame":
        return self.dropDuplicates()

    def dropDuplicates(self, subset: Optional[List[str]] = None
                       ) -> "DataFrame":
        """Distinct rows: a group-by over every column with no aggregate
        function (Spark plans distinct the same way). A ``subset`` keeps one
        arbitrary row per key, which needs ``First``: not ported yet."""
        if subset is not None:
            raise NotImplementedError(
                "dropDuplicates(subset) needs the First aggregate, which "
                "the PyTorch port does not have yet (ROADMAP.md, queue 1)")
        grouping = tuple(UnresolvedAttribute(n)
                         for n in self._plan.schema().names())
        return DataFrame(lp.Aggregate(grouping, (), self._plan),
                         self.session)

    def repartition(self, n: int, *cols: Union[str, Column]) -> "DataFrame":
        return DataFrame(
            lp.Repartition(n, self._plan, tuple(_to_expr(c) for c in cols)),
            self.session)

    def schema(self):
        return self._plan.schema()

    def physical_plan(self) -> PhysicalExec:
        return plan_physical(self._plan, self.session.conf)

    def collect(self) -> HostBatch:
        """Run the query on the session's device -> the result rows. The
        action's cleanups (the exchanges' shuffle removal) run however it
        ends, so it leaves the shuffle catalog empty."""
        final = self.physical_plan()
        self.session.last_plan = final
        dm = DeviceManager.initialize(self.session.conf, self.session.device)
        cleanups: List = []
        out = []
        try:
            for p in range(final.num_partitions):
                ctx = ExecContext(self.session.conf, self.session.device, p,
                                  final.num_partitions, dm, cleanups)
                out.extend(final.execute(ctx))
        finally:
            for fn in cleanups:
                fn()
        return concat_host_batches(out, final.output)


class GroupedData:
    def __init__(self, df: DataFrame, grouping):
        self._df = df
        self._grouping = grouping

    def agg(self, *cols: Column) -> DataFrame:
        aggs = tuple(c.expr if isinstance(c.expr, Alias)
                     else Alias(c.expr, c.expr.name_hint) for c in cols)
        return DataFrame(lp.Aggregate(self._grouping, aggs, self._df._plan),
                         self._df.session)


class TpuSession:
    """Session: the conf (the JAX package's ``spark.rapids.tpu.*`` keys) and
    the device every query runs on. The device is the GPU unless the caller
    passes ``device="cpu"``; without a GPU the default raises."""

    def __init__(self, conf: Optional[Dict[str, Any]] = None,
                 device: device_mod.DeviceLike = None):
        self.conf = TpuConf(conf or {})
        self.device = device_mod.resolve(device)
        #: the physical plan of the last action
        self.last_plan: Optional[PhysicalExec] = None

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a HostBatch, or over an arrow table (converted
        here; pyarrow is needed only for that)."""
        if not isinstance(data, HostBatch):
            data = HostBatch.from_arrow(data, self.conf.string_max_bytes)
        return DataFrame(lp.LocalRelation(data), self)
