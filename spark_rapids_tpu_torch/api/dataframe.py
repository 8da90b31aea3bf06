"""DataFrame and session frontend.

A DataFrame builds a logical plan; ``collect`` plans the CPU physical plan,
lets the plan layer (``TpuOverrides``) move what it can onto the device and
runs the result on the session's device, returning a ``HostBatch`` (numpy
buffers; ``.to_arrow()`` converts it where pyarrow is installed).
``explain`` returns the plan layer's reasons and the final plan.
"""
from __future__ import annotations

import datetime
import threading
import time
from contextlib import ExitStack
from typing import Any, Dict, List, Optional, Union

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import device as device_mod
from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                  concat_host_batches,
                                                  string_batch)
from spark_rapids_tpu_torch.columnar.transfer import (start_download,
                                                      start_download_arrow)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.tpu_execs import DeviceToHostExec
from spark_rapids_tpu_torch.exprs import (Alias, AtLeastNNonNulls, Cast,
                                          Coalesce, DistinctAgg,
                                          First, IsNull, Literal, NaNvl,
                                          SortOrder, UnresolvedAttribute)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.generators import Explode
from spark_rapids_tpu_torch.exprs.windows import WindowExpression
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.planner import plan_with_explain
from spark_rapids_tpu_torch.utils import metrics as um
from spark_rapids_tpu_torch.utils import tracing as _tracing


def _to_expr(c: Union[str, Column]):
    return UnresolvedAttribute(c) if isinstance(c, str) else c.expr


def _extract_generators(exprs, child: lp.LogicalPlan):
    """Pull an explode out of a projection list into a Generate node
    beneath it (Catalyst's ExtractGenerator); the projection reads its
    ``pos`` and element columns by name. At most one per select, as in
    Spark."""
    hits = [i for i, e in enumerate(exprs)
            if isinstance(e.c if isinstance(e, Alias) else e, Explode)]
    if not hits:
        return exprs, child
    if len(hits) > 1:
        raise ValueError("only one generator (explode/posexplode) is "
                         "allowed per select")
    i = hits[0]
    e = exprs[i]
    gen = e.c if isinstance(e, Alias) else e
    col_name = e.name if isinstance(e, Alias) else "col"
    node = lp.Generate(gen.child_array.items, gen.with_position, col_name,
                       child)
    refs = [UnresolvedAttribute(col_name)]
    if gen.with_position:
        refs.insert(0, UnresolvedAttribute("pos"))
    out = list(exprs)
    out[i:i + 1] = refs
    return tuple(out), node


def _extract_windows(exprs, child: lp.LogicalPlan):
    """Pull the window expressions out of a projection list into Window
    nodes beneath it (Catalyst's ExtractWindowExpressions), one node per
    (partition, order) spec; each is referred to by a fresh name."""
    pulled = []
    counter = [0]
    taken = set(child.schema().names())

    def fresh_name() -> str:
        while True:
            name = f"_we{counter[0]}"
            counter[0] += 1
            if name not in taken:
                taken.add(name)
                return name

    def strip(e):
        if isinstance(e, WindowExpression):
            name = fresh_name()
            pulled.append(Alias(e, name))
            return UnresolvedAttribute(name)
        return e.map_children(strip)

    new_exprs = tuple(strip(e) for e in exprs)
    if not pulled:
        return exprs, child
    groups: Dict[Any, List[Alias]] = {}
    for a in pulled:
        groups.setdefault(a.c.sort_spec_key(), []).append(a)
    node = child
    for aliases in groups.values():
        node = lp.Window(tuple(aliases), node)
    return new_exprs, node


def _tree_has(e, cls) -> bool:
    return isinstance(e, cls) or any(_tree_has(c, cls) for c in e.children)


class Row(dict):
    """A collected row: a dict with attribute access (pyspark's Row)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
        return f"Row({inner})"


def _show_cell(v, width: int) -> str:
    s = "null" if v is None else str(v)
    if width and len(s) > width:
        # pyspark: a plain cut below 4 characters, an ellipsis otherwise
        s = s[:width] if width < 4 else s[:width - 3] + "..."
    return s


def _columns_pylist(batch: HostBatch) -> List[List[Any]]:
    return [c.to_pylist(batch.num_rows) for c in batch.columns]


def _null_safe_set_op(left: "DataFrame", right: "DataFrame",
                      mode: str) -> "DataFrame":
    """SQL's INTERSECT and EXCEPT (distinct rows, nulls equal, columns by
    position): tag each side's distinct rows 1 or 2, union them, group by
    every column (grouping takes null == null) and keep the groups by the
    sides that had them."""
    from spark_rapids_tpu_torch.api import functions as F
    names = left.columns
    if len(names) != len(right.columns):
        raise ValueError(f"set operation column-count mismatch: {names} vs "
                         f"{right.columns}")
    la = left.dropDuplicates().withColumn("__setf", F.lit(1))
    rb = right.toDF(*names).dropDuplicates().withColumn("__setf", F.lit(2))
    agg = (la.union(rb).groupBy(*names)
           .agg(F.min("__setf").alias("__mn"), F.max("__setf").alias("__mx")))
    if mode == "intersect":
        agg = agg.filter((F.col("__mn") == 1) & (F.col("__mx") == 2))
    else:
        agg = agg.filter(F.col("__mx") == 1)
    return agg.select(*names)


class DataFrame:
    def __init__(self, logical: lp.LogicalPlan, session: "TpuSession"):
        self._plan = logical
        self.session = session

    def select(self, *cols: Union[str, Column]) -> "DataFrame":
        exprs, child = _extract_generators(tuple(_to_expr(c) for c in cols),
                                           self._plan)
        exprs, child = _extract_windows(exprs, child)
        return DataFrame(lp.Project(exprs, child), self.session)

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        """Add a column, or replace one in place (pyspark semantics)."""
        names = self._plan.schema().names()
        exprs = [Alias(c.expr, name) if n == name else UnresolvedAttribute(n)
                 for n in names]
        if name not in names:
            exprs.append(Alias(c.expr, name))
        exprs, child = _extract_generators(tuple(exprs), self._plan)
        exprs, child = _extract_windows(exprs, child)
        return DataFrame(lp.Project(exprs, child), self.session)

    def drop(self, *names: str) -> "DataFrame":
        keep = [UnresolvedAttribute(n) for n in self._plan.schema().names()
                if n not in names]
        return DataFrame(lp.Project(tuple(keep), self._plan), self.session)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = tuple(Alias(UnresolvedAttribute(n), new) if n == old
                      else UnresolvedAttribute(n)
                      for n in self._plan.schema().names())
        return DataFrame(lp.Project(exprs, self._plan), self.session)

    def filter(self, cond: Column) -> "DataFrame":
        return DataFrame(lp.Filter(cond.expr, self._plan), self.session)

    where = filter

    def groupBy(self, *cols: Union[str, Column]) -> "GroupedData":
        return GroupedData(self, tuple(_to_expr(c) for c in cols))

    def rollup(self, *cols: Union[str, Column]) -> "GroupedData":
        return GroupedData(self, tuple(_to_expr(c) for c in cols), "rollup")

    def cube(self, *cols: Union[str, Column]) -> "GroupedData":
        return GroupedData(self, tuple(_to_expr(c) for c in cols), "cube")

    def agg(self, *cols: Column) -> "DataFrame":
        return GroupedData(self, ()).agg(*cols)

    def sort(self, *cols: Union[str, Column]) -> "DataFrame":
        orders = []
        for c in cols:
            e = _to_expr(c)
            orders.append(e if isinstance(e, SortOrder) else SortOrder(e))
        return DataFrame(lp.Sort(tuple(orders), self._plan), self.session)

    orderBy = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(lp.Limit(n, self._plan), self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position (Spark's ``union``)."""
        return DataFrame(lp.Union(self._plan, other._plan), self.session)

    unionAll = union

    def unionByName(self, other: "DataFrame",
                    allowMissingColumns: bool = False) -> "DataFrame":
        """UNION ALL by column name; with ``allowMissingColumns`` a column
        one side lacks is a typed null there."""
        mine = self._plan.schema().names()
        theirs = other._plan.schema().names()
        if allowMissingColumns:
            all_names = mine + [n for n in theirs if n not in mine]

            def side(df: "DataFrame", have, peer) -> "DataFrame":
                return df.select(*[
                    Column(UnresolvedAttribute(n)) if n in have else
                    Column(Alias(Literal(None, peer[peer.index_of(n)].dtype),
                                 n))
                    for n in all_names])

            return side(self, mine, other.schema()).union(
                side(other, theirs, self.schema()))
        if set(mine) != set(theirs):
            raise ValueError(
                f"unionByName column mismatch: {mine} vs {theirs}")
        return self.union(other.select(*mine))

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
        function (Spark plans distinct the same way). With a ``subset`` the
        other columns keep one row per key (pyspark semantics), taken with
        ``first()``, and the columns keep their order."""
        all_names = self._plan.schema().names()
        names = subset or all_names
        grouping = tuple(UnresolvedAttribute(n) for n in names)
        rest = tuple(Alias(First(UnresolvedAttribute(n), False), n)
                     for n in all_names if n not in names)
        agg = DataFrame(lp.Aggregate(grouping, rest, self._plan),
                        self.session)
        return agg.select(*all_names) if rest else agg

    def repartition(self, n: int, *cols: Union[str, Column]) -> "DataFrame":
        return DataFrame(
            lp.Repartition(n, self._plan, tuple(_to_expr(c) for c in cols)),
            self.session)

    def toDF(self, *names: str) -> "DataFrame":
        cur = self.columns
        if len(names) != len(cur):
            raise ValueError(f"toDF needs {len(cur)} names, got {len(names)}")
        return DataFrame(lp.Project(tuple(
            Alias(UnresolvedAttribute(o), n) for o, n in zip(cur, names)),
            self._plan), self.session)

    def withColumnsRenamed(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame(lp.Project(tuple(
            Alias(UnresolvedAttribute(n), mapping.get(n, n))
            for n in self.columns), self._plan), self.session)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows in both (SQL INTERSECT: nulls compare
        equal)."""
        return _null_safe_set_op(self, other, "intersect")

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows of this one that the other lacks (SQL
        EXCEPT)."""
        return _null_safe_set_op(self, other, "subtract")

    def exceptAll(self, other: "DataFrame") -> "DataFrame":
        raise NotImplementedError(
            "exceptAll (bag semantics) is not supported; use subtract() "
            "for SQL EXCEPT (distinct) semantics")

    def dropna(self, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[List[str]] = None) -> "DataFrame":
        """pyspark's na.drop: a row stays with at least ``thresh`` non-null
        values among ``subset`` (all of them for "any", one for "all"); a
        float NaN counts as null (``AtLeastNNonNulls``)."""
        if how not in ("any", "all"):
            raise ValueError(f"how must be 'any' or 'all', got {how!r}")
        names = subset or self.columns
        need = thresh if thresh is not None else (
            len(names) if how == "any" else 1)
        cond = AtLeastNNonNulls(need, tuple(UnresolvedAttribute(n)
                                            for n in names))
        return DataFrame(lp.Filter(cond, self._plan), self.session)

    def fillna(self, value, subset: Optional[List[str]] = None
               ) -> "DataFrame":
        """pyspark's na.fill: a value (or one per column name) replaces the
        nulls of the columns of a matching type, and NaN in float columns;
        the result keeps the column's type."""
        schema = self.schema()
        names = subset or self.columns
        by_col = value if isinstance(value, dict) else {n: value
                                                        for n in names}
        exprs = []
        for f in schema:
            v = by_col.get(f.name)
            src: Any = UnresolvedAttribute(f.name)
            compatible = v is not None and (
                (f.dtype.is_numeric and isinstance(v, (int, float))
                 and not isinstance(v, bool))
                or (f.dtype is DType.STRING and isinstance(v, str))
                or (f.dtype is DType.BOOLEAN and isinstance(v, bool)))
            if not compatible:
                exprs.append(src)
                continue
            if f.dtype.is_floating:
                src = NaNvl(src, Literal.of(float(v)))
            filled: Any = Coalesce((src, Literal.of(v)))
            if f.dtype.is_numeric and isinstance(v, float):
                # Spark casts back: a double fill never widens the column
                filled = Cast(filled, f.dtype)
            exprs.append(Alias(filled, f.name))
        return DataFrame(lp.Project(tuple(exprs), self._plan), self.session)

    def sample(self, withReplacement=None, fraction=None, seed=None
               ) -> "DataFrame":
        """A Bernoulli sample without replacement, ``rand(seed) <
        fraction``, in both pyspark call forms: ``sample(fraction[,
        seed])`` and ``sample(withReplacement, fraction[, seed])``."""
        from spark_rapids_tpu_torch.api import functions as F
        if not isinstance(withReplacement, bool) and \
                withReplacement is not None:
            withReplacement, fraction, seed = (
                None, withReplacement,
                fraction if fraction is not None else seed)
        if withReplacement:
            raise NotImplementedError(
                "sample(withReplacement=True) is not supported")
        if fraction is None:
            raise TypeError("sample() needs a fraction")
        if seed is None:
            # pyspark draws a fresh seed for every unseeded call
            import random
            seed = random.randint(0, 2**31 - 1)
        return self.filter(F.rand(int(seed)) < float(fraction))

    def count(self) -> int:
        from spark_rapids_tpu_torch.api.functions import count
        res = self.agg(count().alias("count")).collect()
        return int(res.columns[0].data[0])

    def _rows(self) -> List[Row]:
        batch = self.collect()
        names = batch.schema.names()
        return [Row(zip(names, vals))
                for vals in zip(*_columns_pylist(batch))]

    def take(self, n: int) -> List[Row]:
        return self.limit(n)._rows()

    def head(self, n: Optional[int] = None):
        """head() -> the first Row or None; head(n) -> a list of Rows."""
        if n is None:
            rows = self.take(1)
            return rows[0] if rows else None
        return self.take(n)

    def first(self):
        return self.head()

    def show(self, n: int = 20, truncate: Union[bool, int] = True) -> None:
        """Print the first n rows as pyspark formats them."""
        width = 20 if truncate is True else (0 if truncate is False
                                             else int(truncate))
        batch = self.limit(n).collect()
        names = batch.schema.names()
        cols = [[_show_cell(v, width) for v in vals]
                for vals in _columns_pylist(batch)]
        widths = [max([len(nm)] + [len(v) for v in col])
                  for nm, col in zip(names, cols)]
        sep = "+" + "+".join("-" * w for w in widths) + "+"
        print(sep)
        print("|" + "|".join(nm.rjust(w) for nm, w in zip(names, widths))
              + "|")
        print(sep)
        for r in range(batch.num_rows):
            print("|" + "|".join(cols[i][r].rjust(widths[i])
                                 for i in range(len(names))) + "|")
        print(sep)

    def printSchema(self) -> None:
        lines = ["root"]
        for f in self.schema():
            lines.append(f" |-- {f.name}: {f.dtype.value} "
                         f"(nullable = {str(f.nullable).lower()})")
        print("\n".join(lines))

    def describe(self, *cols: str) -> "DataFrame":
        """count, mean, stddev, min and max of each column (the numeric and
        string ones by default) as strings in a ``summary`` table, from one
        aggregation (pyspark's describe)."""
        from spark_rapids_tpu_torch.api import functions as F
        schema = self.schema()
        names = list(cols) or [f.name for f in schema
                               if f.dtype.is_numeric
                               or f.dtype is DType.STRING]
        stat_fns = {"count": F.count, "mean": F.avg, "stddev": F.stddev,
                    "min": F.min, "max": F.max}
        aggs = []
        for nm in names:
            dt = schema[schema.index_of(nm)].dtype
            for stat, fn in stat_fns.items():
                if stat in ("mean", "stddev") and not dt.is_numeric:
                    continue
                aggs.append(fn(nm).alias(f"{stat}__{nm}"))
        out = self.agg(*aggs).collect()
        vals = {f.name: c.to_pylist(1)[0]
                for f, c in zip(out.schema, out.columns)}
        rows = [[stat] + [None if vals.get(f"{stat}__{nm}") is None
                          else str(vals[f"{stat}__{nm}"]) for nm in names]
                for stat in stat_fns]
        return self.session.create_dataframe(string_batch(
            ["summary"] + names, rows, self.session.conf.string_max_bytes))

    def createOrReplaceTempView(self, name: str) -> None:
        """Register this DataFrame for ``session.sql``."""
        self.session.register_view(name, self)

    def schema(self):
        return self._plan.schema()

    @property
    def columns(self) -> List[str]:
        return self._plan.schema().names()

    def physical_plan(self) -> PhysicalExec:
        """The executed plan of this DataFrame, its cached subtrees replaced
        by scans of their buffers (materializing any cache entry it reads
        for the first time); the plan layer's explain text goes to
        ``session.last_explain``."""
        final, text = plan_with_explain(
            self.session.cache_manager.prepare(self._plan),
            self.session.conf, self.session.device)
        self.session.last_explain = text
        return final

    def explain(self, print_out: bool = True) -> str:
        """The plan layer's explain lines (which operators run on the
        device, and why the others cannot), then the final plan. Cached
        subtrees show as the scans of their entries, unmaterialized."""
        logical = self.session.cache_manager.substitute(self._plan)
        final, text = plan_with_explain(logical, self.session.conf,
                                        self.session.device)
        text = text + "\n\nPhysical plan:\n" + final.tree_string()
        if print_out:
            print(text)
        return text

    def cache(self) -> "DataFrame":
        """Mark this DataFrame cached: the first action that reads it
        stores its result batches in the spillable store and later plans
        containing it scan them (memory/df_cache.py)."""
        return self.persist()

    def persist(self, storage_level: Optional[str] = None) -> "DataFrame":
        # one storage level: the tiered store spills as it must
        self.session.cache_manager.add(self._plan)
        return self

    def unpersist(self, blocking: bool = False) -> "DataFrame":
        self.session.cache_manager.remove(self._plan)
        return self

    @property
    def is_cached(self) -> bool:
        return self.session.cache_manager.lookup(self._plan) is not None

    def collect(self) -> HostBatch:
        """Run the query on the session's device -> the result rows. The
        whole action holds the device-admission semaphore
        (``sql.concurrentTpuTasks``). With
        ``transfer.streamingCollect.enabled`` each result batch's download
        starts as soon as the batch exists and the downloads resolve in
        order, at most ``transfer.maxInflight`` outstanding. The action's
        cleanups (the exchanges' shuffle removal) run however it ends, so it
        leaves the shuffle catalog empty. With ``sql.adaptive.enabled`` the
        shuffle map stages run first, under the semaphore, and the plan is
        rewritten from their statistics (plan/adaptive.py);
        ``session.last_plan`` is then the rewritten plan."""
        final, out = self._run_action()
        return concat_host_batches(out, final.output)

    def _run_action(self, start=start_download, query=None, final=None):
        """``collect``'s action: (the executed plan, its results). A
        streamed result batch is ``start(device batch).result()``, any
        other the plan's host batch.

        ``query`` is the serving QueryHandle a scheduler worker drives
        (None for a direct action): the semaphore admits it under its
        tenant and polls its cancel flag while it waits, every batch
        boundary is its cancellation and preemption checkpoint, each
        result batch reaches its stream as its download resolves
        (``emit_batch``), and its handle records the action's counters.
        ``final`` is an already planned physical plan. With
        ``trace.enabled`` the action's spans are recorded
        (utils/tracing.py): ``session.last_trace``, EXPLAIN ANALYZE, and
        the Chrome export at ``trace.export.path``."""
        conf = self.session.conf
        if final is None:
            final = self.physical_plan()
        self.session.last_plan = final
        if conf.get(cfg.CLUSTER_EXECUTORS) >= 1 and \
                not conf.get(cfg.MESH_ENABLED):
            # the stage scheduler runs the plan across the executors
            # (parallel/cluster.py) and coalesces reduce tasks by the
            # observed map-output sizes under sql.adaptive.enabled; it is
            # the only place lineage recomputes run, so their counters are
            # taken around it
            from spark_rapids_tpu_torch.parallel.cluster import \
                cluster_scheduler_for
            before = um.recompute_snapshot()
            if query is not None:
                query.check_cancelled()
            batches = cluster_scheduler_for(self.session).run(final)
            if batches is not None:
                if conf.get(cfg.METRICS_ENABLED):
                    snap = {"shuffle": um.recompute_delta(before)}
                    if query is not None:
                        query.record_exec_metrics(snap)
                    self.session.last_metrics = snap
                if query is not None:
                    for b in batches:
                        query.emit_batch(b)
                return final, batches
            # not stageable (a CPU exchange): the single-process engine
        dm = DeviceManager.initialize(conf, self.session.device)
        trace = conf.get(cfg.TRACE_ENABLED)
        if trace:
            _tracing.TRACER.configure(conf.get(cfg.TRACE_BUFFER_SPANS))
        # stable node ordinals, the key of spans and EXPLAIN ANALYZE
        for i, nd in enumerate(final.walk()):
            nd.plan_id = i
        tenant = query.tenant if query is not None else "default"
        cancel = query.check_cancelled if query is not None else None
        emit = query.emit_batch if query is not None else None
        # the action's scopes (its recursion-depth holder, the tracer's
        # activation), entered before the admission wait so the wait is
        # traced, and closed however the action ends: a stuck activation
        # would leave the process's tracer on for every later query
        scopes = ExitStack()
        depth_holder = scopes.enter_context(um.action_depth_scope())
        if trace:
            scopes.enter_context(_tracing.TRACER.activate())
        trace_mark = _tracing.TRACER.mark()
        memory_before = um.memory_snapshot()
        serving_before = um.serving_snapshot()
        recompute_before = um.recompute_snapshot()
        from spark_rapids_tpu_torch.plan import adaptive
        adaptive_before = adaptive.counters()
        t_wall = time.perf_counter()
        t_admit_ns = time.perf_counter_ns()
        cleanups: List = []
        out: List[HostBatch] = []
        try:
            with dm.semaphore.held(tenant=tenant, cancel_check=cancel), \
                    um.NamedRange("tpu-sql-action", trace=trace):
                waited_ns = time.perf_counter_ns() - t_admit_ns
                _tracing.record("serving.admission_wait", "serving",
                                t_admit_ns, waited_ns, {"tenant": tenant})
                if query is not None:
                    query.note_admission_wait(waited_ns / 1e9)
                # a mesh plan adapts inside its operators (each exchange
                # counts its sizes before it moves a row), and its gathered
                # root is one batch: no stage rewrite, no streamed collect
                on_mesh = any(getattr(nd, "is_mesh", False)
                              for nd in final.walk())
                if conf.get(cfg.ADAPTIVE_ENABLED) and not on_mesh:
                    from spark_rapids_tpu_torch.plan.adaptive import \
                        adaptive_rewrite
                    stage_ctx = ExecContext(conf, self.session.device, 0, 1,
                                            dm, cleanups, query=query)
                    final = adaptive_rewrite(final, stage_ctx)
                    self.session.last_plan = final
                    for i, nd in enumerate(final.walk()):
                        nd.plan_id = i      # the rewritten plan's ordinals
                # decided from the (possibly rewritten) root
                stream = (isinstance(final, DeviceToHostExec)
                          and conf.get(cfg.TRANSFER_STREAMING_COLLECT)
                          and not on_mesh)
                root = final.children[0] if stream else final
                max_inflight = conf.get(cfg.TRANSFER_MAX_INFLIGHT)
                pending: List = []
                for p in range(final.num_partitions):
                    ctx = ExecContext(conf, self.session.device, p,
                                      final.num_partitions, dm, cleanups,
                                      query=query)
                    for b in root.execute(ctx):
                        ctx.check_cancelled()
                        if not stream:
                            out.append(b)
                            if emit is not None:
                                emit(b)
                            continue
                        pending.append(start(b))
                        while len(pending) > max_inflight:
                            out.append(pending.pop(0).result())
                            # a served query's stream gets each batch as
                            # its download resolves, before the last
                            # batch exists
                            if emit is not None:
                                emit(out[-1])
                for pd in pending:
                    out.append(pd.result())
                    if emit is not None:
                        emit(out[-1])
        finally:
            try:
                for fn in cleanups:
                    fn()
            finally:
                self.session.last_action_wall_s = (time.perf_counter()
                                                   - t_wall)
                scopes.close()
            if query is not None and conf.get(cfg.METRICS_ENABLED):
                # the served query's record of the action (the session's
                # last_metrics keeps the cluster action's counters only)
                after = adaptive.counters()
                query.record_exec_metrics({
                    "memory": um.memory_delta(
                        memory_before, recursion_peak=depth_holder.peak),
                    "serving": um.serving_delta(serving_before),
                    "shuffle": um.recompute_delta(recompute_before),
                    "adaptive": {k: after[k] - adaptive_before.get(k, 0)
                                 for k in after}})
            if trace:
                # the action's span window, and its Chrome export (the
                # file is rewritten per action)
                records = _tracing.TRACER.since(trace_mark)
                self.session.last_trace = records
                export = conf.get(cfg.TRACE_EXPORT_PATH)
                if export:
                    _tracing.export_chrome(records, export, metadata={
                        "action_wall_s": round(
                            self.session.last_action_wall_s, 6)})
        return final, out

    def _collect(self, query=None, final: Optional[PhysicalExec] = None
                 ) -> HostBatch:
        """``collect`` with a serving context: ``query`` is the QueryHandle
        a scheduler worker drives, ``final`` an already planned plan."""
        final, out = self._run_action(query=query, final=final)
        return concat_host_batches(out, final.output)

    def _collect_arrow(self):
        """The result rows as one arrow table: each streamed batch's
        arrow layout is made on the device (``download_arrow``'s download,
        the one the writers take), any other batch is converted on the
        host."""
        import pyarrow as pa
        final, out = self._run_action(start_download_arrow)
        tables = [b.to_arrow() if isinstance(b, HostBatch) else b
                  for b in out]
        if not tables:
            return concat_host_batches([], final.output).to_arrow()
        return pa.concat_tables(tables, promote_options="permissive")

    def to_pandas(self):
        """The result rows as a pandas DataFrame (pandas and pyarrow are
        needed only here)."""
        return self._collect_arrow().to_pandas()

    toPandas = to_pandas

    def write_parquet(self, path: str, compression: str = "snappy") -> None:
        """The collected result as one parquet file."""
        from spark_rapids_tpu_torch.io.parquet import write_parquet
        write_parquet(self._collect_arrow(), path, compression)

    @property
    def write(self) -> "DataFrameWriter":
        return DataFrameWriter(self)


class DataFrameWriter:
    """``df.write`` (DataFrameWriter analog): the save mode, the partition
    columns and the options, then ``parquet``/``orc``/``csv(path)`` runs
    the write command (io/write_exec.py) as an action and returns its
    ``WriteStats``."""

    def __init__(self, df: DataFrame):
        self._df = df
        self._mode = "error"
        self._partition_by: List[str] = []
        self._options: Dict[str, str] = {}

    def mode(self, m: str) -> "DataFrameWriter":
        m = {"errorifexists": "error", "default": "error"}.get(m.lower(),
                                                               m.lower())
        if m not in ("error", "overwrite", "append", "ignore"):
            raise ValueError(f"unknown save mode {m!r}")
        self._mode = m
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partition_by = partitionBy

    def option(self, k: str, v) -> "DataFrameWriter":
        """A writer option: ``compression``, ``header``, ``sep``, or
        ``maxRecordsPerFile`` (a part file rolls over after that many
        rows)."""
        self._options[k] = str(v)
        return self

    def _save(self, fmt: str, path: str):
        """The write as an action, like ``collect``: under the device
        semaphore, through the adaptive rewrite when it is on, the shuffle
        catalog emptied however it ends. The ``WriteStats`` of whichever
        engine ran the command."""
        from spark_rapids_tpu_torch.execs.mesh_execs import MeshWriteFilesExec
        from spark_rapids_tpu_torch.io.write_exec import (CpuWriteFilesExec,
                                                          TpuWriteFilesExec,
                                                          WriteSpec)
        max_records = int(self._options.get("maxRecordsPerFile", "0"))
        opts = tuple((k, v) for k, v in self._options.items()
                     if k != "maxRecordsPerFile")
        spec = WriteSpec(fmt, path, self._mode, tuple(self._partition_by),
                         opts, max_records)
        df = DataFrame(lp.WriteFiles(spec, self._df._plan), self._df.session)
        final, _ = df._run_action()
        for node in final.walk():
            if isinstance(node, (CpuWriteFilesExec, TpuWriteFilesExec,
                                 MeshWriteFilesExec)):
                return node.stats
        return None

    def parquet(self, path: str):
        return self._save("parquet", path)

    def orc(self, path: str):
        return self._save("orc", path)

    def csv(self, path: str):
        return self._save("csv", path)


def _null_safe_zero(dt: DType):
    """A valid stand-in value of a key's type for coalescing null keys; the
    paired isnull flag tells the rows apart, so the value is arbitrary."""
    if dt is DType.STRING:
        return ""
    if dt is DType.BOOLEAN:
        return False
    if dt is DType.DATE:
        return datetime.date(1970, 1, 1)
    if dt is DType.TIMESTAMP:
        return datetime.datetime(1970, 1, 1)
    if dt.is_floating:
        return 0.0
    return 0


def _null_safe_key_join(left: DataFrame, right: DataFrame,
                        keynames: List[str]) -> DataFrame:
    """Inner join on keys where null keys match each other (eqNullSafe):
    each key joins as the pair (coalesce(k, zero), isnull(k)). The right
    side's key and helper columns are dropped afterwards."""
    lschema = left.schema()
    pairs, drop_after = [], []
    for j, kn in enumerate(keynames):
        zero = Column(Literal.of(_null_safe_zero(
            lschema[lschema.index_of(kn)].dtype)))
        lv, ln = f"__jl{j}_v", f"__jl{j}_n"
        rv, rn, rk = f"__jr{j}_v", f"__jr{j}_n", f"__jr{j}_k"

        def helpers(df: DataFrame, k: str, v: str, n: str) -> DataFrame:
            key = UnresolvedAttribute(k)
            return (df.withColumn(v, Column(Coalesce((key, zero.expr))))
                    .withColumn(n, Column(IsNull(key))))
        left = helpers(left, kn, lv, ln)
        right = helpers(right.withColumnRenamed(kn, rk), rk, rv, rn)
        pairs += [(lv, rv), (ln, rn)]
        drop_after += [lv, ln, rv, rn, rk]
    return left.join(right, pairs).drop(*drop_after)


class GroupedData:
    def __init__(self, df: DataFrame, grouping, mode: str = "groupby"):
        self._df = df
        self._grouping = grouping
        self._mode = mode
        #: (pivot column, its values) after ``pivot``
        self._pivot: Optional[tuple] = None

    def pivot(self, col_name: str, values: Optional[List] = None
              ) -> "GroupedData":
        """Spark's pivot: one output column per pivot value (and per
        aggregate). Without ``values`` the column's distinct values are
        queried first, sorted, a null first, as Spark does."""
        if self._mode != "groupby":
            raise NotImplementedError("pivot with rollup/cube")
        if values is None:
            batch = self._df.select(col_name).distinct().collect()
            vals = batch.columns[0].to_pylist(batch.num_rows)
            values = sorted([v for v in vals if v is not None],
                            key=lambda v: (str(type(v)), v))
            if any(v is None for v in vals):
                values.insert(0, None)
        g = GroupedData(self._df, self._grouping)
        g._pivot = (col_name, list(values))
        return g

    def _pivot_agg(self, cols) -> DataFrame:
        """Catalyst's single-aggregation pivot: each aggregate becomes one
        conditional aggregate per pivot value, ``agg(when(p == v, input))``
        named ``v`` (one unaliased aggregate) or ``v_<name>``."""
        from spark_rapids_tpu_torch.api import functions as F
        pcol, values = self._pivot
        aggs = []
        for v in values:
            for c in cols:
                e, suffix = c.expr, None
                if isinstance(e, Alias):
                    e, suffix = e.c, e.name
                if not isinstance(e, AggregateFunction):
                    raise NotImplementedError(
                        "pivot aggregates must be plain aggregate "
                        "functions (optionally aliased), e.g. sum(col)")

                def gate(child: Expression, v=v) -> Expression:
                    # a null pivot value matches with isNull (Spark's
                    # 'null' pivot column)
                    match = (F.col(pcol).isNull() if v is None
                             else F.col(pcol) == F.lit(v))
                    return (F.when(match, Column(child))
                            .otherwise(F.lit(None))).expr

                gated = (DistinctAgg(e.inner.map_children(gate))
                         if isinstance(e, DistinctAgg)
                         else e.map_children(gate))
                base = "null" if v is None else str(v)
                name = (base if len(cols) == 1 and suffix is None
                        else f"{base}_{suffix or e.name_hint}")
                aggs.append(Column(Alias(gated, name)))
        return GroupedData(self._df, self._grouping).agg(*aggs)

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.api.functions import count
        return self.agg(count().alias("count"))

    def _simple(self, fname: str, *cols: str) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F
        fn = getattr(F, fname)
        names = cols or [f.name for f in self._df.schema()
                         if f.dtype.is_numeric]
        return self.agg(*[fn(n).alias(f"{fname}({n})") for n in names])

    def sum(self, *cols: str) -> DataFrame:  # noqa: A003 - mirrors pyspark
        return self._simple("sum", *cols)

    def avg(self, *cols: str) -> DataFrame:
        return self._simple("avg", *cols)

    def min(self, *cols: str) -> DataFrame:  # noqa: A003 - mirrors pyspark
        return self._simple("min", *cols)

    def max(self, *cols: str) -> DataFrame:  # noqa: A003 - mirrors pyspark
        return self._simple("max", *cols)

    def agg(self, *cols: Column) -> DataFrame:
        if self._pivot is not None:
            return self._pivot_agg(cols)
        aggs = [c.expr if isinstance(c.expr, Alias)
                else Alias(c.expr, c.expr.name_hint) for c in cols]
        for a in aggs:
            if not isinstance(a.c, DistinctAgg) and _tree_has(a.c,
                                                              DistinctAgg):
                raise NotImplementedError(
                    "distinct aggregate must be a top-level aggregate "
                    "expression (optionally aliased)")
        if any(isinstance(a.c, DistinctAgg) for a in aggs):
            if self._mode != "groupby":
                raise NotImplementedError(
                    "distinct aggregates are not supported with rollup/cube")
            return self._distinct_agg(aggs)
        if self._mode != "groupby":
            return self._grouping_sets_agg(tuple(aggs))
        return DataFrame(lp.Aggregate(self._grouping, tuple(aggs),
                                      self._df._plan), self._df.session)

    def _distinct_agg(self, aggs: List[Alias]) -> DataFrame:
        """An aggregation holding DISTINCT aggregates, rewritten into
        dedup-then-aggregate subplans recombined on the grouping keys (the
        join-based form of Spark's RewriteDistinctAggregates). Each
        distinct aggregate becomes select(keys, child) -> dropDuplicates ->
        groupBy(keys).agg(inner). Every subplan sees every input row, so the
        group sets agree and an inner join on the keys recombines them,
        null-safely, because a key may be null. The subplans name keys and
        outputs ``__gk{i}``/``__da{i}``; the final select restores the
        user's names."""
        df = self._df
        keys = list(self._grouping)
        keynames = [k.name_hint for k in keys]
        out_names = [a.name_hint for a in aggs]
        if len(set(keynames + out_names)) != len(keynames) + len(out_names):
            raise ValueError(
                "duplicate output names in a DISTINCT aggregation: "
                f"{keynames + out_names!r}; alias the colliding columns")
        gk = [f"__gk{i}" for i in range(len(keys))]
        da = [f"__da{i}" for i in range(len(aggs))]
        key_aliases = tuple(Alias(k, g) for k, g in zip(keys, gk))
        regular = [(i, a) for i, a in enumerate(aggs)
                   if not isinstance(a.c, DistinctAgg)]
        parts: List[DataFrame] = []
        if regular:
            parts.append(GroupedData(df, key_aliases).agg(
                *[Column(Alias(a.c, da[i])) for i, a in regular]))
        for i, a in enumerate(aggs):
            if not isinstance(a.c, DistinctAgg):
                continue
            inner = a.c.inner
            vname = f"__dv{i}"
            sel = [Column(ka) for ka in key_aliases]
            sel.append(Column(Alias(inner.child, vname)))
            dd = df.select(*sel).dropDuplicates()
            rebuilt = inner.map_children(
                lambda _e: UnresolvedAttribute(vname))
            grouping = tuple(UnresolvedAttribute(g) for g in gk)
            parts.append(GroupedData(dd, grouping).agg(
                Column(Alias(rebuilt, da[i]))))
        result = parts[0]
        for p in parts[1:]:
            result = (_null_safe_key_join(result, p, gk) if gk
                      else result.crossJoin(p))
        final = [Column(Alias(UnresolvedAttribute(g), kn))
                 for g, kn in zip(gk, keynames)]
        final += [Column(Alias(UnresolvedAttribute(d), on))
                  for d, on in zip(da, out_names)]
        return result.select(*final)

    def _grouping_sets_agg(self, aggs) -> DataFrame:
        """rollup/cube via Expand (Spark's Expand + grouping-id plan): each
        row is repeated once per grouping set with the rolled-up keys
        nulled; grouping by (expanded keys, grouping id) keeps real nulls
        apart from rolled-up ones; a final projection drops the internal
        columns."""
        keys = list(self._grouping)
        n = len(keys)
        if self._mode == "rollup":
            # (all keys), (all but last), ..., (none)
            masks = [[j < n - i for j in range(n)] for i in range(n + 1)]
        else:  # cube: every subset
            masks = [[not ((i >> (n - 1 - j)) & 1) for j in range(n)]
                     for i in range(2 ** n)]
        cs = self._df._plan.schema()
        kn = [f"_gset{i}" for i in range(n)]
        names = tuple(f.name for f in cs) + tuple(kn) + ("_gid",)
        projections = []
        for mask in masks:
            gid = 0
            row = [UnresolvedAttribute(f.name) for f in cs]
            for j, (e, inc) in enumerate(zip(keys, mask)):
                row.append(e if inc else Literal(None, DType.NULL))
                if not inc:
                    gid |= 1 << (n - 1 - j)
            row.append(Literal(gid, DType.INT))
            projections.append(tuple(row))
        expand = lp.Expand(tuple(projections), names, self._df._plan)
        grouping = tuple(UnresolvedAttribute(k) for k in kn) + (
            UnresolvedAttribute("_gid"),)
        agg = lp.Aggregate(grouping, aggs, expand)
        final = tuple(
            Alias(UnresolvedAttribute(k), keys[i].name_hint)
            for i, k in enumerate(kn)
        ) + tuple(UnresolvedAttribute(a.name_hint) for a in aggs)
        return DataFrame(lp.Project(final, agg), self._df.session)


class DataFrameReader:
    """``session.read``: options, then ``parquet``, ``orc`` or ``csv``
    over files or directories (the JAX package's reader)."""

    def __init__(self, session: "TpuSession"):
        self.session = session
        self._options: Dict[str, str] = {}

    def option(self, k: str, v) -> "DataFrameReader":
        self._options[k] = str(v)
        return self

    def _scan(self, fmt: str, paths, infer_schema) -> DataFrame:
        """Hive-style ``key=value`` directories become partition columns
        appended to the data schema of the first file."""
        from spark_rapids_tpu_torch.io.datasource import \
            discover_partitioned_files
        files, pschema = discover_partitioned_files(paths, fmt)
        if not files:
            raise FileNotFoundError(f"no {fmt} files under {paths}")
        data_schema = infer_schema(files[0].path)
        full = Schema(list(data_schema.fields) + list(pschema.fields))
        return DataFrame(lp.FileScan(fmt, tuple(paths), full,
                                     tuple(self._options.items()),
                                     files=files, partition_schema=pschema),
                         self.session)

    def parquet(self, *paths: str) -> DataFrame:
        import pyarrow.parquet as pq

        from spark_rapids_tpu_torch.io.parquet import schema_of_arrow
        return self._scan("parquet", paths,
                          lambda p: schema_of_arrow(pq.read_schema(p)))

    def csv(self, *paths: str, schema: Optional[Schema] = None
            ) -> DataFrame:
        """CSV files; without ``schema`` the types are inferred from the
        first file's first block."""
        from spark_rapids_tpu_torch.io.csv import infer_csv_schema
        return self._scan(
            "csv", paths,
            lambda p: schema or infer_csv_schema(p, self._options))

    def orc(self, *paths: str) -> DataFrame:
        import pyarrow.orc as po

        from spark_rapids_tpu_torch.io.parquet import schema_of_arrow
        return self._scan("orc", paths,
                          lambda p: schema_of_arrow(po.ORCFile(p).schema))


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
        #: the plan layer's explain text of the last action
        self.last_explain: str = ""
        #: the counters of the last action that recorded any (a cluster
        #: action: ``{"shuffle": its lineage-recompute counters}``)
        self.last_metrics: Dict[str, Dict[str, float]] = {}
        #: wall seconds of the last action (EXPLAIN ANALYZE's header)
        self.last_action_wall_s = 0.0
        #: the span window of the last traced action (trace.enabled)
        self.last_trace: list = []
        self._scheduler = None
        self._scheduler_lock = threading.Lock()
        self._views: Dict[str, DataFrame] = {}
        #: guards the view table: views may be registered while another
        #: thread plans SQL that reads them
        self._views_lock = threading.Lock()
        from spark_rapids_tpu_torch.memory.df_cache import CacheManager
        #: the cached DataFrames (``DataFrame.cache``)
        self.cache_manager = CacheManager(self)

    def clear_cache(self) -> None:
        """Unpersist every cached DataFrame of this session."""
        self.cache_manager.clear()

    def explain_analyze(self, print_out: bool = False) -> str:
        """EXPLAIN ANALYZE of the last action: the physical plan with each
        node's observed rows, batches, wall and self time and spills. The
        action must have run with ``trace.enabled``; without it the tree
        renders without them. On a GPU the times are the host's launch
        times (utils/tracing.py)."""
        if self.last_plan is None:
            raise RuntimeError("no action has run yet")
        text = (f"== Physical plan with observed stats "
                f"(action wall {self.last_action_wall_s:.3f}s) ==\n"
                + self.last_plan.tree_string(analyze=True))
        if print_out:
            print(text)
        return text

    # ---- concurrent serving -----------------------------------------------
    @property
    def scheduler(self):
        """The session's query scheduler (serving/scheduler.py), made on
        first use with the session's serving.* conf."""
        with self._scheduler_lock:
            if self._scheduler is None:
                from spark_rapids_tpu_torch.serving.scheduler import \
                    SessionScheduler
                self._scheduler = SessionScheduler(self)
            return self._scheduler

    def submit(self, query, tenant: str = "default",
               timeout: Optional[float] = None, label: Optional[str] = None):
        """Submit a DataFrame or a SQL string for concurrent execution on
        the session's device; returns its QueryHandle at once (QUEUED).
        ``handle.result()`` blocks for the collected rows (a HostBatch, as
        ``collect`` returns); ``handle.cancel()`` asks for cooperative
        cancellation; the query's metrics are ``handle.snapshot()``."""
        return self.scheduler.submit(query, tenant=tenant, timeout=timeout,
                                     label=label)

    @staticmethod
    def builder() -> "TpuSessionBuilder":
        return TpuSessionBuilder()

    def table(self, name: str) -> DataFrame:
        with self._views_lock:
            try:
                return self._views[name.lower()]
            except KeyError:
                raise KeyError(f"table or view not found: {name}") from None

    def register_view(self, name: str, df: DataFrame) -> None:
        with self._views_lock:
            self._views[name.lower()] = df

    def sql(self, query: str) -> DataFrame:
        """A SQL query over the registered temp views, planned into a
        DataFrame on this session's device (the role Catalyst's parser and
        analyzer play for Spark). A function the port lacks raises here,
        at plan time, naming it."""
        from spark_rapids_tpu_torch.sql.parser import parse_sql
        from spark_rapids_tpu_torch.sql.planner import SqlPlanner
        df, _names = SqlPlanner(self).plan(parse_sql(query))
        return df

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1
              ) -> DataFrame:
        """The LONG column ``id`` from ``start`` to ``end`` by ``step``
        (``range(n)`` counts from 0)."""
        if end is None:
            start, end = 0, start
        return DataFrame(lp.Range(start, end, step), self)

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a HostBatch, or over an arrow table (converted
        here; pyarrow is needed only for that)."""
        if not isinstance(data, HostBatch):
            data = HostBatch.from_arrow(data, self.conf.string_max_bytes)
        return DataFrame(lp.LocalRelation(data), self)


class TpuSessionBuilder:
    """``TpuSession.builder().config(k, v).device("cpu").getOrCreate()``."""

    def __init__(self):
        self._conf: Dict[str, Any] = {}
        self._device: device_mod.DeviceLike = None

    def config(self, key: str, value) -> "TpuSessionBuilder":
        self._conf[key] = value
        return self

    def device(self, device: device_mod.DeviceLike) -> "TpuSessionBuilder":
        self._device = device
        return self

    def getOrCreate(self) -> TpuSession:
        return TpuSession(self._conf, device=self._device)
