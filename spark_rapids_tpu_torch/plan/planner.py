"""Logical -> CPU physical planning, with expression binding, then the
plan layer (the JAX package's ``plan/planner.py``).

The planner produces the CPU engine's physical plan (Spark's SparkPlanner
role): it binds expressions to child ordinals, picks each join's strategy
(``_select_join``) and satisfies the operators' distribution requirements
(``ensure_requirements``). ``TpuOverrides`` (plan/overrides.py) then tags
it, converts the supported subtrees to device operators and runs the
device rewrites. An operator it cannot plan raises ``NotImplementedError``
naming it.
"""
from __future__ import annotations

from typing import Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import cpu_execs as ce
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.execs.exchange_execs import (
    CpuBroadcastExchangeExec, CpuShuffleExchangeExec, HashPartitioning,
    RangePartitioning, RoundRobinPartitioning, SinglePartitioning)
from spark_rapids_tpu_torch.execs.expand_execs import CpuExpandExec
from spark_rapids_tpu_torch.execs.generate_execs import (CpuGenerateExec,
                                                         generate_projections)
from spark_rapids_tpu_torch.execs.join_execs import (
    CpuBroadcastHashJoinExec, CpuCartesianProductExec, CpuHashJoinExec,
    CpuNestedLoopJoinExec, legal_broadcast_sides)
from spark_rapids_tpu_torch.execs.window_execs import CpuWindowExec
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import Expression, bind_expression
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.plan import logical as lp


def plan_with_explain(plan: lp.LogicalPlan, conf: TpuConf, device=None
                      ) -> Tuple[PhysicalExec, str]:
    """The executed plan of ``plan`` and the plan layer's explain text:
    the Python UDFs compiled where ``sql.udfCompiler.enabled`` asks, the
    input-file columns resolved, the CPU plan with its distribution
    requirements, then ``TpuOverrides`` (``device`` sizes the footprint
    contract's budget when no memory manager exists yet), then, under
    ``sql.mesh.enabled``, the mesh rewrite onto ``device``'s shards."""
    from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
    if conf.get(cfg.UDF_COMPILER_ENABLED):
        from spark_rapids_tpu_torch.udf import compile_plan_udfs
        plan = compile_plan_udfs(plan)
    plan = _prune_file_scans(_resolve_input_file_meta(plan))
    overrides = TpuOverrides(conf, device)
    final = overrides.apply(ensure_requirements(_plan_node(plan, conf)))
    if device is not None and conf.get(cfg.MESH_ENABLED):
        from spark_rapids_tpu_torch.plan.mesh_rewrite import mesh_rewrite
        final = mesh_rewrite(final, conf, device)
    return final, overrides.last_explain


def plan_physical(plan: lp.LogicalPlan, conf: TpuConf,
                  device=None) -> PhysicalExec:
    """The executed plan of ``plan`` (``plan_with_explain``'s)."""
    return plan_with_explain(plan, conf, device)[0]


def _column_names(obj, out: set) -> set:
    """The (lower-cased) names of the columns an expression, or a nest of
    tuples of them, reads."""
    import dataclasses

    from spark_rapids_tpu_torch.exprs.core import UnresolvedAttribute
    if isinstance(obj, UnresolvedAttribute):
        out.add(obj.name.lower())
    elif isinstance(obj, Expression):
        for f in dataclasses.fields(obj):
            _column_names(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _column_names(x, out)
    return out


def _prune_file_scans(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """Column pruning (Spark's ColumnPruning into the file scan's required
    schema; the JAX package reads every column): a file scan under a chain
    of projections, filters, aggregates, sorts, limits and repartitions
    reads only the columns that chain reads, and at least one data column,
    which gives the rows (a count, or only partition columns). Any other
    operator above a scan, and a scan asked for the input-file columns,
    keeps every column."""
    import dataclasses

    def scan(node: lp.FileScan, need) -> lp.FileScan:
        header = dict(node.options).get("header", "false").lower()
        if need is None or node.with_file_meta or (
                node.fmt == "csv" and header not in ("true", "1")):
            return node     # a header-less CSV names its columns by place
        part = set(node.partition_schema.names())
        data = [f for f in node.read_schema if f.name not in part]
        first = data[:1]
        keep = [f for f in node.read_schema if f.name.lower() in need
                or (f in first and not any(
                    g.name.lower() in need for g in data))]
        if len(keep) == len(node.read_schema):
            return node
        names = {f.name for f in keep}
        # each file's partition values are a tuple over the partition
        # schema's columns: keep the values of the kept columns
        kept = [i for i, f in enumerate(node.partition_schema)
                if f.name in names]
        files = tuple(dataclasses.replace(
            pf, partition_values=tuple(pf.partition_values[i] for i in kept))
            for pf in node.files)
        return dataclasses.replace(
            node, read_schema=Schema(keep), files=files,
            partition_schema=Schema(
                [node.partition_schema.fields[i] for i in kept]))

    def prune(node: lp.LogicalPlan, need) -> lp.LogicalPlan:
        """``need``: the child columns the operators above read (None:
        every one)."""
        if isinstance(node, lp.FileScan):
            return scan(node, need)
        if isinstance(node, lp.Project):
            kid = _column_names(node.exprs, set())
        elif isinstance(node, lp.Aggregate):
            kid = _column_names((node.grouping, node.aggregates), set())
        elif isinstance(node, (lp.Filter, lp.Sort, lp.Repartition)):
            own = (node.condition if isinstance(node, lp.Filter) else
                   node.orders if isinstance(node, lp.Sort) else node.keys)
            kid = None if need is None else need | _column_names(own, set())
        elif isinstance(node, lp.Limit):
            kid = need
        else:
            kid = None
        if not dataclasses.is_dataclass(node):
            return node
        reps = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, lp.LogicalPlan):
                new = prune(v, kid)
                if new is not v:
                    reps[f.name] = new
        return dataclasses.replace(node, **reps) if reps else node

    return prune(plan, None)


def _resolve_input_file_meta(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """When an expression references input-file metadata
    (InputFileName/BlockStart/BlockLength), flip every file scan below it
    to emit the hidden per-file columns, thread them through the
    projections in between, give union branches without a file scan
    Spark's defaults ('' / -1), and strip them from the root's output, as
    the JAX planner does. Binding then resolves the markers to the hidden
    columns."""
    import dataclasses

    from spark_rapids_tpu_torch.exprs.core import UnresolvedAttribute
    from spark_rapids_tpu_torch.exprs.literals import Literal
    from spark_rapids_tpu_torch.exprs.misc import (INPUT_FILE_META_SPEC,
                                                   _InputFileMeta)

    def expr_has(e: Expression) -> bool:
        if isinstance(e, _InputFileMeta):
            return True
        return any(expr_has(c) for c in e.children)

    def any_exprs(obj, depth=0) -> bool:
        if isinstance(obj, Expression):
            return expr_has(obj)
        if depth > 3:
            return False
        if isinstance(obj, (tuple, list)):
            return any(any_exprs(x, depth + 1) for x in obj)
        if dataclasses.is_dataclass(obj) and not isinstance(
                obj, (lp.LogicalPlan, type)):
            return any(any_exprs(getattr(obj, f.name), depth + 1)
                       for f in dataclasses.fields(obj))
        return False

    def fields_of(node: lp.LogicalPlan):
        # a plan node that is not a dataclass holds no expression here
        return (dataclasses.fields(node) if dataclasses.is_dataclass(node)
                else ())

    def node_uses_meta(node: lp.LogicalPlan) -> bool:
        for f in fields_of(node):
            v = getattr(node, f.name)
            if isinstance(v, lp.LogicalPlan):
                continue
            if any_exprs(v):
                return True
        return any(node_uses_meta(c) for c in node.children)

    if not node_uses_meta(plan):
        return plan
    meta_cols = tuple(n for n, _d, _v in INPUT_FILE_META_SPEC)

    def with_default_meta(child: lp.LogicalPlan) -> lp.LogicalPlan:
        exprs = [Alias(UnresolvedAttribute(n), n)
                 for n in child.schema().names()]
        exprs.extend(Alias(Literal(default, dtype), name)
                     for name, dtype, default in INPUT_FILE_META_SPEC)
        return lp.Project(tuple(exprs), child)

    def flip(node: lp.LogicalPlan) -> lp.LogicalPlan:
        if isinstance(node, lp.FileScan):
            return dataclasses.replace(node, with_file_meta=True)
        kids = [flip(c) for c in node.children]
        extended = False
        if isinstance(node, lp.Project):
            # thread the hidden columns through the projections in between
            have = set(kids[0].schema().names())
            mine = {e.name_hint for e in node.exprs}
            passthrough = tuple(
                Alias(UnresolvedAttribute(n), n) for n in meta_cols
                if n in have and n not in mine)
            if passthrough:
                node = dataclasses.replace(
                    node, exprs=tuple(node.exprs) + passthrough)
                extended = True
        if isinstance(node, lp.Union):
            # every branch must agree on the hidden columns
            if any(meta_cols[0] in k.schema().names() for k in kids):
                kids = [k if meta_cols[0] in k.schema().names()
                        else with_default_meta(k) for k in kids]
        if not extended and all(
                a is b for a, b in zip(kids, node.children)):
            return node
        reps = {}
        ki = iter(kids)
        for f in fields_of(node):
            v = getattr(node, f.name)
            if isinstance(v, lp.LogicalPlan):
                reps[f.name] = next(ki)
            elif isinstance(v, tuple) and v and all(
                    isinstance(x, lp.LogicalPlan) for x in v):
                reps[f.name] = tuple(next(ki) for _ in v)
        return dataclasses.replace(node, **reps)

    out = flip(plan)
    # the hidden columns never surface in the user-visible output
    root_names = out.schema().names()
    visible = [n for n in root_names if not n.startswith("__input_file_")]
    if len(visible) != len(root_names):
        out = lp.Project(tuple(Alias(UnresolvedAttribute(n), n)
                               for n in visible), out)
    return out


def ensure_requirements(plan: PhysicalExec) -> PhysicalExec:
    """Distribution requirements (Spark's EnsureRequirements role): a
    broadcast join's build side gets a broadcast exchange (the stream side
    keeps its partitioning); a sort over a partitioned child gets a range
    exchange and sorts each range; aggregates, limits, shuffled joins and
    windows see all their input in one partition, through a
    single-partition exchange over a partitioned child."""
    single_required = (ce.CpuHashAggregateExec, ce.CpuLimitExec,
                       CpuHashJoinExec, CpuWindowExec)

    def fix(node: PhysicalExec) -> PhysicalExec:
        if isinstance(node, (CpuBroadcastHashJoinExec, CpuNestedLoopJoinExec)):
            bi = 0 if node.build_side == "left" else 1
            if isinstance(node.children[bi], CpuBroadcastExchangeExec):
                return node
            kids = list(node.children)
            kids[bi] = CpuBroadcastExchangeExec(kids[bi])
            return node.with_children(kids)
        if isinstance(node, ce.CpuSortExec):
            child = node.children[0]
            if child.num_partitions <= 1:
                return node
            return node.with_children([CpuShuffleExchangeExec(
                RangePartitioning(child.num_partitions, node.orders), child)])
        if not isinstance(node, single_required):
            return node
        kids = [CpuShuffleExchangeExec(SinglePartitioning(), c)
                if c.num_partitions > 1 else c for c in node.children]
        if all(a is b for a, b in zip(kids, node.children)):
            return node
        return node.with_children(kids)
    return plan.transform_up(fix)


def _plan_file_scan(plan: lp.FileScan, conf: TpuConf) -> PhysicalExec:
    """The CPU scan of a FileScan in its format (the plan layer converts
    it), its output widened by the hidden input-file columns when the
    planner asked for them."""
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    files = plan.files or tuple(PartitionedFile(p) for p in plan.paths)
    if plan.fmt == "parquet":
        from spark_rapids_tpu_torch.io.parquet import CpuParquetScanExec
        return CpuParquetScanExec(
            files, plan.schema(), plan.partition_schema, plan.filters,
            conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS),
            conf.get(cfg.MAX_READER_BATCH_SIZE_BYTES))
    if plan.fmt == "csv":
        from spark_rapids_tpu_torch.io.csv import CpuCsvScanExec
        return CpuCsvScanExec(files, plan.schema(), dict(plan.options),
                              plan.partition_schema)
    if plan.fmt == "orc":
        from spark_rapids_tpu_torch.io.orc import CpuOrcScanExec
        return CpuOrcScanExec(
            files, plan.schema(), plan.partition_schema, plan.filters,
            conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS),
            conf.get(cfg.MAX_READER_BATCH_SIZE_BYTES))
    raise ValueError(f"unsupported format {plan.fmt}")


def _plan_node(plan: lp.LogicalPlan, conf: TpuConf) -> PhysicalExec:
    if isinstance(plan, lp.LocalRelation):
        return ce.CpuLocalScanExec(plan.batch)
    if isinstance(plan, lp.Range):
        return ce.CpuRangeExec(plan.start, plan.end, plan.step)
    if isinstance(plan, lp.FileScan):
        return _plan_file_scan(plan, conf)
    if isinstance(plan, lp.WriteFiles):
        from spark_rapids_tpu_torch.io.write_exec import CpuWriteFilesExec
        return CpuWriteFilesExec(plan.spec, _plan_node(plan.child, conf))
    if isinstance(plan, lp.Filter) and isinstance(plan.child, lp.FileScan) \
            and plan.child.fmt in ("parquet", "orc"):
        # predicate pushdown: the pushable conjuncts clip parquet row groups
        # and ORC stripes by their statistics; the filter stays as the
        # exact row-level net
        from dataclasses import replace

        from spark_rapids_tpu_torch.io.datasource import (is_pushable,
                                                          split_conjuncts)
        pushed = tuple(c for c in split_conjuncts(plan.condition)
                       if is_pushable(c))
        if pushed:
            plan = lp.Filter(plan.condition, replace(
                plan.child, filters=plan.child.filters + pushed))
    if isinstance(plan, lp.CachedRelation):
        from spark_rapids_tpu_torch.execs.cache_execs import CpuCachedScanExec
        return CpuCachedScanExec(plan.entry, plan.schema())
    if isinstance(plan, lp.Join):
        return _plan_join(plan, conf)
    if isinstance(plan, lp.Union):
        return ce.CpuUnionExec(_plan_node(plan.left, conf),
                               _plan_node(plan.right, conf))
    child = _plan_node(plan.child, conf) if plan.children else None
    if isinstance(plan, lp.Project):
        return ce.CpuProjectExec(tuple(
            _named(bind_expression(e, child.output), e) for e in plan.exprs),
            child)
    if isinstance(plan, lp.Filter):
        return ce.CpuFilterExec(bind_expression(plan.condition, child.output),
                                child)
    if isinstance(plan, lp.Aggregate):
        cs = child.output
        grouping = tuple(bind_expression(e, cs) for e in plan.grouping)
        aggs = tuple(_named(bind_expression(e, cs), e) for e in plan.aggregates)
        for a in aggs:
            if not isinstance(a.c, AggregateFunction):
                raise NotImplementedError(
                    f"aggregate expression {a} is not an aggregate function")
        return ce.CpuHashAggregateExec(grouping, aggs, child, plan.schema())
    if isinstance(plan, lp.Sort):
        orders = tuple(SortOrder(bind_expression(o.child, child.output),
                                 o.ascending, o.nulls_first)
                       for o in plan.orders)
        return ce.CpuSortExec(orders, child)
    if isinstance(plan, lp.Limit):
        return ce.CpuLimitExec(plan.n, child)
    if isinstance(plan, lp.Expand):
        projs = tuple(tuple(bind_expression(e, child.output) for e in p)
                      for p in plan.projections)
        return CpuExpandExec(projs, child, plan.schema())
    if isinstance(plan, lp.Generate):
        elements = tuple(bind_expression(e, child.output)
                         for e in plan.elements)
        out = plan.schema()
        return CpuGenerateExec(generate_projections(
            child.output, elements, plan.pos, out), child, out)
    if isinstance(plan, lp.Window):
        return CpuWindowExec(tuple(_named(bind_expression(e, child.output), e)
                                   for e in plan.wexprs), child)
    if isinstance(plan, lp.Repartition):
        if not plan.keys:
            return CpuShuffleExchangeExec(
                RoundRobinPartitioning(plan.num_partitions), child)
        part = HashPartitioning(
            plan.num_partitions,
            tuple(bind_expression(e, child.output) for e in plan.keys))
        return CpuShuffleExchangeExec(part, child)
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the PyTorch port")


def _plan_join(plan: lp.Join, conf: TpuConf) -> PhysicalExec:
    left = _plan_node(plan.left, conf)
    right = _plan_node(plan.right, conf)
    lkeys = [bind_expression(e, left.output) for e in plan.left_keys]
    rkeys = [bind_expression(e, right.output) for e in plan.right_keys]
    # both keys of a pair share one type, or equal keys could land in
    # different sort groups (Catalyst's coercion)
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        ct = DType.common_type(lk.dtype(), rk.dtype())
        if lk.dtype() != ct:
            lkeys[i] = Cast(lk, ct)
        if rk.dtype() != ct:
            rkeys[i] = Cast(rk, ct)
    out_schema = plan.schema()
    cond = (bind_expression(plan.condition, out_schema)
            if plan.condition is not None else None)
    if cond is not None and plan.how not in ("inner", "cross"):
        # a post-join filter equals a join condition only for inner and
        # cross joins
        raise NotImplementedError(
            f"join conditions are only supported for inner joins, not "
            f"{plan.how}")
    return _select_join(left, right, plan.how, tuple(lkeys), tuple(rkeys),
                        out_schema, cond, conf)


def _select_join(left: PhysicalExec, right: PhysicalExec, how: str,
                 lkeys: Tuple[Expression, ...], rkeys: Tuple[Expression, ...],
                 out_schema: Schema, cond, conf: TpuConf) -> PhysicalExec:
    """Spark's JoinSelection: the broadcast hash join when a legal build
    side's estimated size is at most sql.broadcastJoinThreshold.bytes (the
    right side first), else the shuffled hash join. A join without keys
    becomes the broadcast nested-loop join on the same rule, else the
    cartesian product."""
    threshold = conf.get(cfg.BROADCAST_JOIN_THRESHOLD)

    def broadcastable(side: PhysicalExec) -> bool:
        sz = side.size_estimate()
        return sz is not None and sz <= threshold

    if not lkeys:
        if how not in ("inner", "cross"):
            raise NotImplementedError(
                f"{how} join requires join keys (no nested-loop form)")
        for bi, side in ((1, right), (0, left)):
            if bi in legal_broadcast_sides(how) and broadcastable(side):
                return CpuNestedLoopJoinExec(
                    left, right, how, out_schema, cond,
                    build_side="right" if bi == 1 else "left")
        return CpuCartesianProductExec(left, right, how, out_schema, cond)

    for bi, side in ((1, right), (0, left)):
        if bi in legal_broadcast_sides(how) and broadcastable(side):
            return CpuBroadcastHashJoinExec(
                left, right, how, lkeys, rkeys, out_schema, cond,
                build_side="right" if bi == 1 else "left")
    return CpuHashJoinExec(left, right, how, lkeys, rkeys, out_schema, cond)


def _named(bound: Expression, original: Expression) -> Alias:
    """Keep the user-facing name through binding."""
    return bound if isinstance(bound, Alias) else Alias(bound,
                                                        original.name_hint)
