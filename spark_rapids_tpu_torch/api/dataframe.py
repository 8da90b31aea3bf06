"""DataFrame and session frontend.

A DataFrame builds a logical plan; ``collect`` plans the device operators
and runs them on the session's device, returning a ``HostBatch`` (numpy
buffers; ``.to_arrow()`` converts it where pyarrow is installed).
"""
from __future__ import annotations

import datetime
import threading
from typing import Any, Dict, List, Optional, Union

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import device as device_mod
from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.columnar.host import HostBatch, concat_host_batches
from spark_rapids_tpu_torch.columnar.transfer import (PendingDownload,
                                                      start_download)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.tpu_execs import DeviceToHostExec
from spark_rapids_tpu_torch.exprs import (Alias, Coalesce, DistinctAgg,
                                          First, IsNull, Literal,
                                          SortOrder, UnresolvedAttribute)
from spark_rapids_tpu_torch.exprs.generators import Explode
from spark_rapids_tpu_torch.exprs.windows import WindowExpression
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.planner import plan_physical


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

    def createOrReplaceTempView(self, name: str) -> None:
        """Register this DataFrame for ``session.sql``."""
        self.session.register_view(name, self)

    def schema(self):
        return self._plan.schema()

    @property
    def columns(self) -> List[str]:
        return self._plan.schema().names()

    def physical_plan(self) -> PhysicalExec:
        """The device plan of this DataFrame, its cached subtrees replaced
        by scans of their buffers (materializing any cache entry it reads
        for the first time)."""
        return plan_physical(self.session.cache_manager.prepare(self._plan),
                             self.session.conf, self.session.device)

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
        leaves the shuffle catalog empty."""
        conf = self.session.conf
        final = self.physical_plan()
        self.session.last_plan = final
        dm = DeviceManager.initialize(conf, self.session.device)
        cleanups: List = []
        out: List[HostBatch] = []
        try:
            with dm.semaphore.held():
                stream = (isinstance(final, DeviceToHostExec)
                          and conf.get(cfg.TRANSFER_STREAMING_COLLECT))
                root = final.children[0] if stream else final
                max_inflight = conf.get(cfg.TRANSFER_MAX_INFLIGHT)
                pending: List[PendingDownload] = []
                for p in range(final.num_partitions):
                    ctx = ExecContext(conf, self.session.device, p,
                                      final.num_partitions, dm, cleanups)
                    for b in root.execute(ctx):
                        if not stream:
                            out.append(b)
                            continue
                        pending.append(start_download(b))
                        while len(pending) > max_inflight:
                            out.append(pending.pop(0).result())
                out.extend(pd.result() for pd in pending)
        finally:
            for fn in cleanups:
                fn()
        return concat_host_batches(out, final.output)


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

    def agg(self, *cols: Column) -> DataFrame:
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

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a HostBatch, or over an arrow table (converted
        here; pyarrow is needed only for that)."""
        if not isinstance(data, HostBatch):
            data = HostBatch.from_arrow(data, self.conf.string_max_bytes)
        return DataFrame(lp.LocalRelation(data), self)
