"""The plan layer's rules and its rewrite pass (the JAX package's
``plan/overrides.py``; reference: GpuOverrides.scala).

``EXPR_RULES`` and ``EXEC_RULES`` are the JAX package's rule tables: each
rule derives a conf key (``spark.rapids.tpu.sql.expression.<Name>`` /
``...sql.exec.<Name>``), may carry an incompat note (gated by
``sql.incompatibleOps.enabled``) and may add tagging checks whose reasons
are the JAX package's, letter for letter. Where the port differs, it says
so at the rule: split() has a device rule (the port explodes a split on
the device), and the nested-loop and cartesian joins are not disabled by
default (the port always ran them on the device).

``TpuOverrides.apply`` wraps the CPU physical plan in a meta tree
(plan/meta.py), tags it, applies the cost model, holds a reused exchange
and its referent to one decision, keeps the explain text,
converts the supported subtrees to device operators, and then runs the
rewrites in the JAX package's order: whole-stage fusion (plan/fusion.py),
the filter-into-aggregate fold (``fuse_device_ops``), the host<->device
transitions (``insert_transitions``), the pipeline boundaries
(``insert_pipeline``), the encoded-domain marks (plan/encoded.py) and last
the footprint contract (plan/footprint.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Type

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import cpu_execs as ce
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.exprs import (aggregates as agg,
                                          arithmetic as ar, bitwise as bw,
                                          cast as ca, conditional as cond,
                                          datetime as dtm, literals as li,
                                          math as ma, misc as mi,
                                          nulls as nu, predicates as pr,
                                          strings as st, windows as wn)
from spark_rapids_tpu_torch.exprs.core import BoundReference, Expression
from spark_rapids_tpu_torch.plan.meta import ExecMeta, ExprMeta


@dataclass
class ExprRule:
    """Replacement rule for one expression class (ExprRule analog,
    GpuOverrides.scala:185)."""
    cls: Type[Expression]
    desc: str
    incompat: Optional[str] = None
    tag: Optional[Callable[[ExprMeta], None]] = None
    #: the node is an array that only its parent reads: no column type
    array_valued: bool = False

    @property
    def conf_key(self) -> str:
        return f"spark.rapids.tpu.sql.expression.{self.cls.__name__}"


@dataclass
class ExecRule:
    """Replacement rule for one exec class (ExecRule analog,
    GpuOverrides.scala:236)."""
    cls: Type[PhysicalExec]
    desc: str
    convert: Callable[[ExecMeta, Sequence[PhysicalExec]], PhysicalExec]
    exprs_of: Callable[[PhysicalExec], Sequence[Expression]] = lambda e: ()
    incompat: Optional[str] = None
    tag: Optional[Callable[[ExecMeta], None]] = None

    @property
    def conf_key(self) -> str:
        name = self.cls.__name__.replace("Cpu", "").replace("Exec", "")
        return f"spark.rapids.tpu.sql.exec.{name}"


# ------------------------------------------------------------------ expr tagging
def _tag_cast(meta: ExprMeta) -> None:
    e: ca.Cast = meta.expr
    try:
        src = e.c.dtype()
    except TypeError:
        return
    if not ca.can_cast_on_device(src, e.to):
        meta.will_not_work(f"cast {src.value} -> {e.to.value} is not supported "
                           f"on TPU")


def _tag_like(meta: ExprMeta) -> None:
    e: st.Like = meta.expr
    lit = e.p
    if not isinstance(lit, li.Literal) or lit.value is None:
        meta.will_not_work("LIKE requires a literal pattern on TPU")
        return
    if st.Like.classify(str(lit.value)) is None:
        # general pattern: the DFA engine handles it, but '_'/'%' consume
        # BYTES — multibyte UTF-8 under wildcards diverges from Spark, the
        # same caveat class as RLike: gate behind incompatibleOps
        if not meta.conf.get(cfg.INCOMPATIBLE_OPS):
            meta.will_not_work(
                f"general LIKE pattern {lit.value!r} uses the byte-level "
                f"device regex engine; enable with "
                f"spark.rapids.tpu.sql.incompatibleOps.enabled")
            return
        from spark_rapids_tpu_torch.ops.regex import like_to_regex
        _tag_regex_pattern(meta, like_to_regex(str(lit.value), e.escape))


def _tag_regex_pattern(meta: ExprMeta, pattern) -> None:
    from spark_rapids_tpu_torch.ops.regex import RegexError, compile_dfa
    try:
        compile_dfa(pattern)
    except RegexError as err:
        meta.will_not_work(f"pattern not supported by the device regex "
                           f"engine: {err}")


def _check_regex_literal(expr, field: str, will_not_work,
                         forbid_empty: bool) -> None:
    """Shared tag body: the named field must be a literal whose pattern the
    device engine compiles (anchors included: '^' is rejected by the parser —
    anchored-search/replace semantics are not implemented on device)."""
    lit = getattr(expr, field)
    if not isinstance(lit, li.Literal) or lit.value is None:
        will_not_work(f"{type(expr).__name__} requires a literal pattern "
                      f"on TPU")
        return
    from spark_rapids_tpu_torch.ops.regex import RegexError, compile_dfa
    try:
        dfa = compile_dfa(str(lit.value))
    except RegexError as err:
        will_not_work(f"pattern not supported by the device regex "
                      f"engine: {err}")
        return
    if forbid_empty and dfa.accept[dfa.start]:
        will_not_work("zero-length-matching patterns are not supported on "
                      "the device regex engine")


def _tag_regex_expr(field: str, forbid_empty: bool = False):
    def tag(meta: ExprMeta) -> None:
        _check_regex_literal(meta.expr, field, meta.will_not_work,
                             forbid_empty)
    return tag


def _tag_get_array_item(meta: ExprMeta) -> None:
    from spark_rapids_tpu_torch.exprs.generators import CreateArray
    e: st.GetArrayItem = meta.expr
    if isinstance(e.child, st.StringSplit):
        _check_regex_literal(e.child, "pattern_e", meta.will_not_work,
                             forbid_empty=True)
        return
    if not isinstance(e.child, CreateArray):
        meta.will_not_work("GetArrayItem supports created arrays and "
                           "split() results only")


def _tag_literal_pattern(meta: ExprMeta) -> None:
    lit = meta.expr.children[1]
    if not isinstance(lit, li.Literal) or lit.value is None:
        meta.will_not_work(f"{type(meta.expr).__name__} requires a non-null "
                           f"literal pattern on TPU")


def _tag_literal_operands(*fields):
    """Gate like the reference's scalar-only doColumnar overloads: the named
    operands must be literals (null literals are fine — the kernels emit the
    matching null/zero columns)."""
    def tag(meta: ExprMeta) -> None:
        for f in fields:
            v = getattr(meta.expr, f, None)
            if v is not None and not isinstance(v, li.Literal):
                meta.will_not_work(
                    f"{type(meta.expr).__name__} requires a literal {f} "
                    f"on TPU (the reference supports only scalar {f})")
                return
    return tag


def _tag_float_agg(meta: ExprMeta) -> None:
    """Float sum/avg results vary with reduction order; gate like the reference's
    spark.rapids.sql.variableFloatAgg.enabled. Checks every argument (corr/covar
    take two)."""
    if meta.conf.get(cfg.ENABLE_FLOAT_AGG):
        return
    for child in meta.expr.children:
        try:
            dt = child.dtype()
        except TypeError:
            continue
        if dt.is_floating:
            meta.will_not_work(
                f"{type(meta.expr).__name__} over floating point can produce "
                f"order-dependent results; enable with "
                f"spark.rapids.tpu.sql.variableFloatAgg.enabled")
            return


def _tag_stat_agg(meta: ExprMeta) -> None:
    """stddev/variance/corr/covar accumulate DOUBLE sum / sum-of-products
    buffers whatever the input type, so their results are order-dependent even
    over INTEGER columns — gate unconditionally, not per-child dtype."""
    if meta.conf.get(cfg.ENABLE_FLOAT_AGG):
        return
    meta.will_not_work(
        f"{type(meta.expr).__name__} accumulates double buffers whose "
        f"reduction order varies; enable with "
        f"spark.rapids.tpu.sql.variableFloatAgg.enabled")


def _tag_window_expr(meta: ExprMeta) -> None:
    """GpuWindowExpression tagging analog: range frames with numeric offsets
    need exactly one orderable numeric/date/timestamp order key."""
    e: wn.WindowExpression = meta.expr
    frame = e.resolved_frame()
    bounded = [b for b in (frame.lower, frame.upper) if b is not None and b != 0]
    if frame.frame_type == "range" and bounded:
        if len(e.orders) != 1:
            meta.will_not_work("RANGE frames with offsets require exactly one "
                               "ORDER BY key")
            return
        try:
            dt = e.orders[0].child.dtype()
        except TypeError:
            return
        if not (dt.is_numeric or dt in (DType.DATE, DType.TIMESTAMP)):
            meta.will_not_work(f"RANGE frame offsets over {dt.value} order key "
                               f"are not supported on TPU")


_EXPR_RULE_LIST: List[ExprRule] = [
    ExprRule(li.Literal, "literal value"),
    ExprRule(BoundReference, "column reference"),
    ExprRule(mi.Alias, "named expression"),
    ExprRule(mi.SortOrder, "sort order spec"),
    ExprRule(mi.SparkPartitionID, "partition id"),
    ExprRule(mi.MonotonicallyIncreasingID, "monotonically increasing id"),
    ExprRule(mi.Rand, "random [0,1)",
             incompat="uses a counter-based PRNG, not Spark's XORShift stream"),
    ExprRule(mi.KnownFloatingPointNormalized, "normalization marker"),
    ExprRule(mi.NormalizeNaNAndZero, "NaN/-0.0 canonicalization"),
    # arithmetic
    ExprRule(ar.Add, "addition"), ExprRule(ar.Subtract, "subtraction"),
    ExprRule(ar.Multiply, "multiplication"), ExprRule(ar.Divide, "double division"),
    ExprRule(ar.IntegralDivide, "integral division"),
    ExprRule(ar.Remainder, "remainder"), ExprRule(ar.Pmod, "positive modulo"),
    ExprRule(ar.UnaryMinus, "negation"), ExprRule(ar.UnaryPositive, "identity"),
    ExprRule(ar.Abs, "absolute value"),
    ExprRule(ar.Least, "least of values"), ExprRule(ar.Greatest, "greatest of values"),
    # predicates
    ExprRule(pr.EqualTo, "equality"), ExprRule(pr.NotEqual, "inequality"),
    ExprRule(pr.LessThan, "less than"), ExprRule(pr.LessThanOrEqual, "at most"),
    ExprRule(pr.GreaterThan, "greater than"),
    ExprRule(pr.GreaterThanOrEqual, "at least"),
    ExprRule(pr.EqualNullSafe, "null-safe equality"),
    ExprRule(pr.And, "logical and"), ExprRule(pr.Or, "logical or"),
    ExprRule(pr.Not, "logical not"), ExprRule(pr.In, "in list"),
    # nulls
    ExprRule(nu.IsNull, "is null"), ExprRule(nu.IsNotNull, "is not null"),
    ExprRule(nu.IsNan, "is NaN"), ExprRule(nu.Coalesce, "first non-null"),
    ExprRule(nu.NaNvl, "NaN replacement"),
    ExprRule(nu.AtLeastNNonNulls, "n non-null check"),
    # conditionals
    ExprRule(cond.If, "if/else"), ExprRule(cond.CaseWhen, "case/when"),
    # math
    ExprRule(ma.Sqrt, "square root"), ExprRule(ma.Cbrt, "cube root"),
    ExprRule(ma.Exp, "e^x"), ExprRule(ma.Expm1, "e^x - 1"),
    ExprRule(ma.Log, "natural log"), ExprRule(ma.Log2, "log base 2"),
    ExprRule(ma.Log10, "log base 10"), ExprRule(ma.Log1p, "log(1+x)"),
    ExprRule(ma.Sin, "sine"), ExprRule(ma.Cos, "cosine"), ExprRule(ma.Tan, "tangent"),
    ExprRule(ma.Asin, "arcsine"), ExprRule(ma.Acos, "arccosine"),
    ExprRule(ma.Atan, "arctangent"), ExprRule(ma.Atan2, "two-arg arctangent"),
    ExprRule(ma.Sinh, "hyperbolic sine"), ExprRule(ma.Cosh, "hyperbolic cosine"),
    ExprRule(ma.Tanh, "hyperbolic tangent"),
    ExprRule(ma.ToDegrees, "radians to degrees"),
    ExprRule(ma.ToRadians, "degrees to radians"),
    ExprRule(ma.Signum, "sign"), ExprRule(ma.Floor, "floor"),
    ExprRule(ma.Ceil, "ceiling"), ExprRule(ma.Rint, "round half even"),
    ExprRule(ma.Pow, "power"), ExprRule(ma.Round, "round half up"),
    # bitwise
    ExprRule(bw.BitwiseAnd, "bitwise and"), ExprRule(bw.BitwiseOr, "bitwise or"),
    ExprRule(bw.BitwiseXor, "bitwise xor"), ExprRule(bw.BitwiseNot, "bitwise not"),
    ExprRule(bw.ShiftLeft, "shift left"), ExprRule(bw.ShiftRight, "shift right"),
    ExprRule(bw.ShiftRightUnsigned, "unsigned shift right"),
    # cast
    ExprRule(ca.Cast, "type cast", tag=_tag_cast),
    # strings
    ExprRule(st.Upper, "uppercase",
             incompat="ASCII-only case mapping on device"),
    ExprRule(st.Lower, "lowercase",
             incompat="ASCII-only case mapping on device"),
    ExprRule(st.Length, "character length"),
    ExprRule(st.StartsWith, "starts with", tag=_tag_literal_pattern),
    ExprRule(st.EndsWith, "ends with", tag=_tag_literal_pattern),
    ExprRule(st.Contains, "contains", tag=_tag_literal_pattern),
    ExprRule(st.Like, "SQL LIKE", tag=_tag_like),
    ExprRule(st.RLike, "regex search (RLIKE)",
             tag=_tag_regex_expr("p"),
             incompat="byte-level regex: '.'/'_' consume one BYTE, so "
                      "multibyte UTF-8 under wildcards diverges from Spark"),
    ExprRule(st.RegExpReplace, "regex replace",
             tag=_tag_regex_expr("pattern_e", forbid_empty=True),
             incompat="DFA leftmost-longest matching; no group "
                      "backreferences; byte-level wildcards"),
    ExprRule(st.GetArrayItem, "array element access",
             tag=_tag_get_array_item),
    # the port only: split() runs on the device, read by GetArrayItem
    # (explode of a split in TPCx-BB q10, q18, q19 and q27)
    ExprRule(st.StringSplit, "split into an array", array_valued=True),
    ExprRule(st.Substring, "substring"),
    ExprRule(st.Concat, "string concatenation"),
    ExprRule(st.StringTrim, "trim spaces",
             tag=_tag_literal_operands("trim")),
    ExprRule(st.StringTrimLeft, "left trim",
             tag=_tag_literal_operands("trim")),
    ExprRule(st.StringTrimRight, "right trim",
             tag=_tag_literal_operands("trim")),
    ExprRule(st.InitCap, "initcap",
             incompat="ASCII-only case mapping on device"),
    ExprRule(st.StringLocate, "substring position",
             tag=_tag_literal_operands("sub", "start")),
    ExprRule(st.StringReplace, "string replace",
             tag=_tag_literal_operands("search", "replace")),
    ExprRule(st.StringLPad, "left pad",
             tag=_tag_literal_operands("length", "pad")),
    ExprRule(st.StringRPad, "right pad",
             tag=_tag_literal_operands("length", "pad")),
    ExprRule(st.SubstringIndex, "substring by delimiter",
             tag=_tag_literal_operands("delim", "count")),
    # datetime
    ExprRule(dtm.Year, "year"), ExprRule(dtm.Month, "month"),
    ExprRule(dtm.DayOfMonth, "day of month"), ExprRule(dtm.DayOfWeek, "day of week"),
    ExprRule(dtm.DayOfYear, "day of year"), ExprRule(dtm.Quarter, "quarter"),
    ExprRule(dtm.Hour, "hour"), ExprRule(dtm.Minute, "minute"),
    ExprRule(dtm.Second, "second"), ExprRule(dtm.DateAdd, "date plus days"),
    ExprRule(dtm.DateSub, "date minus days"), ExprRule(dtm.DateDiff, "day difference"),
    ExprRule(dtm.LastDay, "last day of month"),
    # window
    ExprRule(wn.WindowExpression, "window expression", tag=_tag_window_expr),
    ExprRule(wn.RowNumber, "row number"), ExprRule(wn.Rank, "rank"),
    ExprRule(wn.DenseRank, "dense rank"),
    ExprRule(wn.PercentRank, "percent rank"),
    ExprRule(wn.CumeDist, "cumulative distribution"),
    ExprRule(wn.NTile, "ntile bucketing"),
    ExprRule(wn.Lead, "lead"), ExprRule(wn.Lag, "lag"),
    # aggregates
    ExprRule(agg.Count, "count"),
    ExprRule(pr.InSet, "IN over a large literal set"),
    ExprRule(dtm.WeekDay, "weekday (0=Monday)"),
    ExprRule(dtm.UnixTimestamp, "epoch seconds"),
    ExprRule(dtm.ToUnixTimestamp, "epoch seconds (to_unix_timestamp)"),
    ExprRule(dtm.FromUnixTime, "epoch seconds -> formatted string"),
    ExprRule(ma.Cot, "cotangent"),
    ExprRule(ma.Asinh, "inverse hyperbolic sine"),
    ExprRule(ma.Acosh, "inverse hyperbolic cosine"),
    ExprRule(ma.Atanh, "inverse hyperbolic tangent"),
    ExprRule(ma.Logarithm, "arbitrary-base logarithm"),
    ExprRule(agg.Sum, "sum", tag=_tag_float_agg),
    ExprRule(agg.Average, "average", tag=_tag_float_agg),
    ExprRule(agg.Min, "minimum"), ExprRule(agg.Max, "maximum"),
    ExprRule(agg.First, "first value"), ExprRule(agg.Last, "last value"),
    ExprRule(agg.StddevSamp, "sample standard deviation", tag=_tag_stat_agg),
    ExprRule(agg.StddevPop, "population standard deviation",
             tag=_tag_stat_agg),
    ExprRule(agg.VarianceSamp, "sample variance", tag=_tag_stat_agg),
    ExprRule(agg.VariancePop, "population variance", tag=_tag_stat_agg),
    ExprRule(agg.Corr, "Pearson correlation", tag=_tag_stat_agg),
    ExprRule(agg.CovarSamp, "sample covariance", tag=_tag_stat_agg),
    ExprRule(agg.CovarPop, "population covariance", tag=_tag_stat_agg),
]

EXPR_RULES: Dict[Type[Expression], ExprRule] = {r.cls: r for r in _EXPR_RULE_LIST}


# ------------------------------------------------------------------ exec rules
def _convert_project(meta: ExecMeta, children) -> PhysicalExec:
    return te.TpuProjectExec(meta.exec.exprs, children[0])


def _convert_filter(meta: ExecMeta, children) -> PhysicalExec:
    return te.TpuFilterExec(meta.exec.condition, children[0])


def _convert_agg(meta: ExecMeta, children) -> PhysicalExec:
    e: ce.CpuHashAggregateExec = meta.exec
    return te.TpuHashAggregateExec(e.grouping, e.aggregates, children[0],
                                   e.output, pre_filter=e.pre_filter)


def _tag_agg(meta: ExecMeta) -> None:
    """Float/double GROUPING keys ride the device only when the user asserts
    NaN-free data (the spark.rapids.sql.hasNans gate on GpuHashAggregateExec:
    device NaN key equality differs from Spark's, which groups all NaNs
    together)."""
    e = meta.exec
    for k in e.grouping:
        try:
            dt = k.dtype()
        except TypeError:
            continue
        if dt.is_floating and meta.conf.get(cfg.HAS_NANS):
            meta.will_not_work(
                "floating point grouping keys may hold NaN, whose grouping "
                "differs on TPU; set spark.rapids.tpu.sql.hasNans=false if "
                "the data has none")
            return


def _convert_sort(meta: ExecMeta, children) -> PhysicalExec:
    return te.TpuSortExec(meta.exec.orders, children[0])


def _convert_limit(meta: ExecMeta, children) -> PhysicalExec:
    return te.TpuLimitExec(meta.exec.n, children[0])


def _convert_union(meta: ExecMeta, children) -> PhysicalExec:
    return te.TpuUnionExec(children[0], children[1])


def _convert_range(meta: ExecMeta, children) -> PhysicalExec:
    e: ce.CpuRangeExec = meta.exec
    return te.TpuRangeExec(e.start, e.end, e.step)


def _convert_join(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuShuffledHashJoinExec
    e = meta.exec
    return TpuShuffledHashJoinExec(children[0], children[1], e.how,
                                   e.left_keys, e.right_keys, e.output,
                                   e.condition)


def _tag_join(meta: ExecMeta) -> None:
    """GpuHashJoin.tagJoin analog (shims/spark300/GpuHashJoin.scala:36-50):
    unsupported key types, and float/double keys only when the user asserts
    the data is NaN-free (spark.rapids.sql.hasNans analog — device NaN
    grouping/equality differs from Spark's NaN-normalizing semantics)."""
    e = meta.exec
    for k in list(e.left_keys) + list(e.right_keys):
        try:
            dt = k.dtype()
        except TypeError:
            continue
        if dt not in (set(SUPPORTED_JOIN_KEY_TYPES)):
            meta.will_not_work(f"join key type {dt.value} is not "
                               f"supported on TPU")
        elif dt.is_floating and meta.conf.get(cfg.HAS_NANS):
            meta.will_not_work(
                "floating point join keys may hold NaN, whose join "
                "equality differs on TPU; set "
                "spark.rapids.tpu.sql.hasNans=false if the data has none")


SUPPORTED_JOIN_KEY_TYPES = (DType.BOOLEAN, DType.BYTE, DType.SHORT, DType.INT,
                            DType.LONG, DType.FLOAT, DType.DOUBLE, DType.STRING,
                            DType.DATE, DType.TIMESTAMP)


def _convert_broadcast_join(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuBroadcastHashJoinExec
    e = meta.exec
    return TpuBroadcastHashJoinExec(children[0], children[1], e.how,
                                    e.left_keys, e.right_keys, e.output,
                                    e.condition, e.build_side)


def _nested_loop_converter(tpu_cls_name: str):
    def convert(meta: ExecMeta, children) -> PhysicalExec:
        from spark_rapids_tpu_torch.execs import join_execs
        e = meta.exec
        cls = getattr(join_execs, tpu_cls_name)
        return cls(children[0], children[1], e.join_type, e.output,
                   e.condition, e.build_side)
    return convert


def _join_exprs(e) -> tuple:
    return (tuple(e.left_keys) + tuple(e.right_keys)
            + ((e.condition,) if e.condition is not None else ()))


def _tag_smj(meta: ExecMeta) -> None:
    """GpuSortMergeJoinExec tagging: the device replacement is a shuffled
    hash join, so the sort-merge join moves only when the replacement conf
    allows it (spark.rapids.sql.replaceSortMergeJoin.enabled)."""
    _tag_join(meta)
    if not meta.conf.get(cfg.REPLACE_SORT_MERGE_JOIN):
        meta.will_not_work(
            "sort-merge join replacement is disabled "
            "(spark.rapids.tpu.sql.replaceSortMergeJoin.enabled)")


def _convert_smj(meta: ExecMeta, children) -> PhysicalExec:
    """Sort-merge join -> shuffled hash join, dropping each side's join-key
    sort (the hash join needs no sorted input; the reference strips the
    sorts the same way)."""
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuShuffledHashJoinExec
    e = meta.exec

    def strip(child: PhysicalExec, keys) -> PhysicalExec:
        if isinstance(child, (te.TpuSortExec, ce.CpuSortExec)):
            key_set = {repr(k) for k in keys}
            if all(repr(o.child) in key_set for o in child.orders):
                return child.children[0]
        return child

    return TpuShuffledHashJoinExec(strip(children[0], e.left_keys),
                                   strip(children[1], e.right_keys),
                                   e.how, e.left_keys, e.right_keys,
                                   e.output, e.condition)


def _make_join_rules() -> List[ExecRule]:
    from spark_rapids_tpu_torch.execs.join_execs import (
        CpuBroadcastHashJoinExec, CpuCartesianProductExec, CpuHashJoinExec,
        CpuNestedLoopJoinExec, CpuSortMergeJoinExec)
    # the port only: the nested-loop join and the cartesian product are not
    # disabled by default (the JAX package's rules are); the port has run
    # them on the device since its TPC-H slice
    return [
        ExecRule(CpuHashJoinExec, "shuffled hash join", _convert_join,
                 exprs_of=_join_exprs, tag=_tag_join),
        ExecRule(CpuSortMergeJoinExec, "sort-merge join (replaced by "
                 "shuffled hash join, sorts removed)", _convert_smj,
                 exprs_of=_join_exprs, tag=_tag_smj),
        ExecRule(CpuBroadcastHashJoinExec, "broadcast hash join",
                 _convert_broadcast_join, exprs_of=_join_exprs, tag=_tag_join),
        ExecRule(CpuNestedLoopJoinExec, "broadcast nested-loop join",
                 _nested_loop_converter("TpuBroadcastNestedLoopJoinExec"),
                 exprs_of=_join_exprs),
        ExecRule(CpuCartesianProductExec, "cartesian product",
                 _nested_loop_converter("TpuCartesianProductExec"),
                 exprs_of=_join_exprs),
    ]


def _convert_expand(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.expand_execs import TpuExpandExec
    return TpuExpandExec(meta.exec.projections, children[0], meta.exec.output)


def _convert_generate(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.generate_execs import TpuGenerateExec
    return TpuGenerateExec(meta.exec.projections, children[0],
                           meta.exec.output)


def _make_expand_rules() -> List[ExecRule]:
    from spark_rapids_tpu_torch.execs.expand_execs import CpuExpandExec
    from spark_rapids_tpu_torch.execs.generate_execs import CpuGenerateExec
    proj_exprs = lambda e: tuple(x for p in e.projections for x in p)  # noqa: E731
    return [ExecRule(CpuExpandExec, "expand projections", _convert_expand,
                     exprs_of=proj_exprs),
            ExecRule(CpuGenerateExec, "explode of a created array",
                     _convert_generate, exprs_of=proj_exprs)]


def _convert_window(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.window_execs import TpuWindowExec
    return TpuWindowExec(meta.exec.wexprs, children[0])


def _make_window_rules() -> List[ExecRule]:
    from spark_rapids_tpu_torch.execs.window_execs import CpuWindowExec
    return [ExecRule(CpuWindowExec, "window functions", _convert_window,
                     exprs_of=lambda e: e.wexprs)]


def _convert_exchange(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuShuffleExchangeExec
    return TpuShuffleExchangeExec(meta.exec.partitioning, children[0])


def _convert_broadcast_exchange(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuBroadcastExchangeExec
    return TpuBroadcastExchangeExec(children[0])


def _convert_reused_exchange(meta: ExecMeta, children) -> PhysicalExec:
    # the consistency pass makes the referent convert too; the converted
    # referent arrives as the child (the reuse holds its referent as a
    # regular child, so every plan pass rewrites it)
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuReusedExchangeExec
    return TpuReusedExchangeExec(children[0])


def _convert_query_stage(meta: ExecMeta, children) -> PhysicalExec:
    # adaptive stage wrappers dissolve into the converted plan (the
    # optimizeAdaptiveTransitions role, GpuTransitionOverrides.scala:47)
    return children[0]


def _make_exchange_rules() -> List[ExecRule]:
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        CpuBroadcastExchangeExec, CpuQueryStageExec, CpuReusedExchangeExec,
        CpuShuffleExchangeExec)
    return [ExecRule(CpuShuffleExchangeExec, "shuffle exchange",
                     _convert_exchange,
                     exprs_of=lambda e: e.partitioning.expressions),
            ExecRule(CpuBroadcastExchangeExec, "broadcast exchange",
                     _convert_broadcast_exchange),
            ExecRule(CpuReusedExchangeExec, "reused exchange",
                     _convert_reused_exchange),
            ExecRule(CpuQueryStageExec, "adaptive query stage",
                     _convert_query_stage)]


def _convert_cached_scan(meta: ExecMeta, children) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.cache_execs import TpuCachedScanExec
    return TpuCachedScanExec(meta.exec.entry, meta.exec.output)


def _tag_cached_scan(meta: ExecMeta) -> None:
    if not meta.conf.get(cfg.CACHED_SCAN_ENABLED):
        meta.will_not_work("cached-table scanning on TPU is disabled "
                           "(spark.rapids.tpu.sql.cachedScan.enabled)")


def _make_cache_rules() -> List[ExecRule]:
    from spark_rapids_tpu_torch.execs.cache_execs import CpuCachedScanExec
    return [ExecRule(CpuCachedScanExec, "cached table scan",
                     _convert_cached_scan, tag=_tag_cached_scan)]


_EXEC_RULE_LIST: List[ExecRule] = (_make_join_rules()
                                   + _make_window_rules()
                                   + _make_expand_rules()
                                   + _make_exchange_rules()) + [
    ExecRule(ce.CpuProjectExec, "column projection", _convert_project,
             exprs_of=lambda e: e.exprs),
    ExecRule(ce.CpuFilterExec, "row filter", _convert_filter,
             exprs_of=lambda e: (e.condition,)),
    ExecRule(ce.CpuHashAggregateExec, "hash aggregate", _convert_agg,
             exprs_of=lambda e: tuple(e.grouping) + tuple(e.aggregates),
             tag=_tag_agg),
    ExecRule(ce.CpuSortExec, "sort", _convert_sort,
             exprs_of=lambda e: e.orders),
    ExecRule(ce.CpuLimitExec, "row limit", _convert_limit),
    ExecRule(ce.CpuUnionExec, "union all", _convert_union),
    ExecRule(ce.CpuRangeExec, "sequence generation", _convert_range),
] + _make_cache_rules()

EXEC_RULES: Dict[Type[PhysicalExec], ExecRule] = {r.cls: r for r in _EXEC_RULE_LIST}


def register_exec_rule(rule: ExecRule) -> None:
    """Add the rule of an exec class defined outside the pyarrow-free main
    path (io/parquet.py registers its scan's rule when it is imported, as
    the JAX package's ``_make_scan_rules`` builds it)."""
    EXEC_RULES[rule.cls] = rule


def wrap_expr(expr: Expression, conf: TpuConf) -> ExprMeta:
    rule = EXPR_RULES.get(type(expr))
    return ExprMeta(expr, conf, rule)


def wrap_exec(exec_node: PhysicalExec, conf: TpuConf) -> ExecMeta:
    rule = EXEC_RULES.get(type(exec_node))
    return ExecMeta(exec_node, conf, rule)


def estimated_rows(exec_node: PhysicalExec) -> Optional[int]:
    """Row-count estimate from the size contract: ``size_estimate`` over the
    static row width, the cost model's common currency."""
    est = exec_node.size_estimate()
    if est is None:
        return None
    return est // max(ce._row_width(exec_node.output), 1)


def apply_cost_model(root: "ExecMeta", conf: TpuConf) -> None:
    """Estimate-driven CPU-vs-device placement (the GpuOverrides cost-model
    role; off by default): an operator whose estimated row count is under
    sql.adaptive.costModel.minDeviceRows stays on the CPU engine. Unknown
    estimates never demote (the device is the default placement; only
    positive evidence of a tiny input moves work off it)."""
    if not conf.get(cfg.ADAPTIVE_COST_MODEL_ENABLED):
        return
    min_rows = conf.get(cfg.ADAPTIVE_COST_MODEL_MIN_DEVICE_ROWS)

    def visit(m: "ExecMeta") -> None:
        rows = estimated_rows(m.exec)
        if rows is not None and rows < min_rows:
            m.will_not_work(
                f"cost model: estimated {rows} rows < costModel."
                f"minDeviceRows={min_rows} — host execution avoids device "
                f"dispatch overhead at this scale")
        for c in m.child_metas:
            visit(c)

    visit(root)


# ------------------------------------------------------------------ the pass
class TpuOverrides:
    """The plan-rewrite rule (GpuOverrides apply analog,
    GpuOverrides.scala:1754). ``device`` sizes the footprint contract's
    budget when no memory manager exists yet."""

    def __init__(self, conf: TpuConf, device=None):
        self.conf = conf
        self.device = device
        self.last_explain: str = ""

    def apply(self, plan: PhysicalExec) -> PhysicalExec:
        if not self.conf.sql_enabled:
            return plan
        meta = wrap_exec(plan, self.conf)
        meta.tag_for_tpu()
        apply_cost_model(meta, self.conf)
        _enforce_exchange_reuse(meta)
        lines: List[str] = []
        meta.explain(lines)
        self.last_explain = "\n".join(lines)
        mode = self.conf.explain
        if mode == "ALL":
            print(self.last_explain)
        elif mode == "NOT_ON_TPU":
            for line in lines:
                if "cannot run on TPU" in line or "because" in line:
                    print(line)
        converted = meta.convert_if_needed()
        from spark_rapids_tpu_torch.plan.encoded import mark_encoded_domain
        from spark_rapids_tpu_torch.plan.footprint import annotate_out_of_core
        from spark_rapids_tpu_torch.plan.fusion import fuse_stages
        # whole-stage fusion first (it claims maximal device chains incl.
        # the aggregate fold); fuse_device_ops then covers what remains —
        # the CPU engine's fold, and device aggregates when fusion is off
        plan = fuse_device_ops(fuse_stages(converted, self.conf))
        plan = mark_encoded_domain(
            insert_pipeline(insert_transitions(plan), self.conf), self.conf)
        # footprint contract last, over the final operator tree
        return annotate_out_of_core(plan, self.conf, self.device)


def _enforce_exchange_reuse(root: ExecMeta) -> None:
    """Exchange-reuse consistency (RapidsMeta.scala:443): a reused exchange
    and its referent make the same on/off-device decision, or a device
    original under a host reuse (or the reverse) would change where the
    exchanged data lives. The convertible side of a disagreeing pair stays
    on the CPU."""
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        CpuReusedExchangeExec
    metas: dict = {}
    reused: List[ExecMeta] = []

    def walk(m: ExecMeta) -> None:
        # the same exchange object sits under the main branch and under
        # every reuse, each with a meta of its own: reconcile them all
        metas.setdefault(id(m.exec), []).append(m)
        if isinstance(m.exec, CpuReusedExchangeExec):
            reused.append(m)
        for c in m.child_metas:
            walk(c)

    walk(root)
    for m in reused:
        group = metas.get(id(m.exec.referent), []) + [m]
        if len(group) < 2:
            m.will_not_work("reused exchange's referent is not part of "
                            "this plan")
            continue
        if len({mm.can_replace for mm in group}) > 1:
            for mm in group:
                if mm.can_replace:
                    mm.will_not_work(
                        "exchange reuse consistency: the reused copy and "
                        "its original must make the same TPU decision")


def _substitute_refs(e: Expression, repl) -> Expression:
    if isinstance(e, BoundReference):
        return repl[e.ordinal]
    return e.map_children(lambda c: _substitute_refs(c, repl))


def _has_nondeterministic(e: Expression) -> bool:
    from spark_rapids_tpu_torch.exprs.misc import (MonotonicallyIncreasingID,
                                                   Rand)
    if isinstance(e, (Rand, MonotonicallyIncreasingID)):
        return True
    return any(_has_nondeterministic(c) for c in e.children)


def fold_aggregate_chain(node, filter_cls, project_cls, coalesce_cls=None,
                         max_ops=None):
    """The partial-aggregate fold, shared by ``fuse_device_ops`` and the
    whole-stage pass (plan/fusion.py) so both build identical aggregate
    expression trees. Walks the chain below ``node``: filter conditions AND
    into the pre-filter mask, projection expressions substitute into the
    grouping, aggregate and pre-filter expressions, and (when
    ``coalesce_cls`` is given) coalesces are absorbed: the aggregate
    concatenates its input anyway. A projection with a non-deterministic
    expression stops the walk. Returns (grouping, aggregates, pre_filter,
    chain child, folded nodes top-down)."""
    from spark_rapids_tpu_torch.exprs.misc import Alias
    from spark_rapids_tpu_torch.exprs.predicates import And

    grouping, aggs, pre = node.grouping, node.aggregates, node.pre_filter
    child = node.children[0]
    folded = []
    while max_ops is None or len(folded) < max_ops:
        if isinstance(child, filter_cls):
            cond = child.condition
            pre = cond if pre is None else And(cond, pre)
        elif isinstance(child, project_cls):
            repl = [a.c if isinstance(a, Alias) else a for a in child.exprs]
            if any(_has_nondeterministic(r) for r in repl):
                break
            grouping = tuple(_substitute_refs(g, repl) for g in grouping)
            aggs = tuple(_substitute_refs(a, repl) for a in aggs)
            if pre is not None:
                pre = _substitute_refs(pre, repl)
        elif coalesce_cls is not None and isinstance(child, coalesce_cls):
            pass
        else:
            break
        folded.append(child)
        child = child.children[0]
    return grouping, aggs, pre, child, tuple(folded)


def fuse_device_ops(plan: PhysicalExec) -> PhysicalExec:
    """Fold Filter/Project chains into the aggregate above them: the
    filter's predicate becomes the aggregate's row mask and the projections
    inline into its expressions, so the filtered batch never materializes
    (one compaction and one host read of a row count fewer). The
    whole-stage pass runs first and claims these chains when
    ``sql.fusion.enabled``; this pass covers them when fusion is off, and
    the CPU engine's chains."""
    shapes = {
        te.TpuHashAggregateExec: (te.TpuFilterExec, te.TpuProjectExec),
        ce.CpuHashAggregateExec: (ce.CpuFilterExec, ce.CpuProjectExec),
    }

    def fix(node: PhysicalExec) -> PhysicalExec:
        pair = shapes.get(type(node))
        if pair is None:
            return node
        grouping, aggs, pre, child, folded = fold_aggregate_chain(
            node, *pair)
        if folded:
            return type(node)(grouping, aggs, child, node.output,
                              pre_filter=pre)
        return node

    return plan.transform_up(fix)


def insert_pipeline(plan: PhysicalExec, conf: TpuConf) -> PhysicalExec:
    """Wrap the upload or file scan under each device operator in a
    PipelinedExec, so up to ``transfer.pipeline.depth`` batches are in
    flight between the producing source and the consuming stage instead of
    the strict pull-per-batch lockstep. Skipped on a single-core host: the
    producer thread needs a spare core."""
    from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
    depth = conf.get(cfg.TRANSFER_PIPELINE_DEPTH)
    if not conf.get(cfg.TRANSFER_PIPELINE_ENABLED) or depth <= 0:
        return plan
    if (os.cpu_count() or 1) < 2:
        return plan

    def is_source(node: PhysicalExec) -> bool:
        return (isinstance(node, te.HostToDeviceExec)
                or getattr(node, "is_file_scan", False))

    def fix(node: PhysicalExec) -> PhysicalExec:
        if not node.is_device or isinstance(node, PipelinedExec):
            return node
        new_children = [PipelinedExec(c, depth) if is_source(c) else c
                        for c in node.children]
        if all(a is b for a, b in zip(new_children, node.children)):
            return node
        return node.with_children(new_children)

    return plan.transform_up(fix)


def insert_transitions(plan: PhysicalExec) -> PhysicalExec:
    """Insert host<->device movement at engine boundaries and bring the plan
    root back to host (GpuTransitionOverrides.scala:38 optimizeGpuPlanTransitions
    + GpuBringBackToHost analog)."""
    def fix(node: PhysicalExec) -> PhysicalExec:
        if isinstance(node, (te.HostToDeviceExec, te.DeviceToHostExec)):
            return node
        new_children = []
        changed = False
        for c in node.children:
            want_device = node.is_device
            if want_device and not c.is_device:
                new_children.append(te.HostToDeviceExec(c))
                changed = True
            elif not want_device and c.is_device:
                new_children.append(te.DeviceToHostExec(c))
                changed = True
            else:
                new_children.append(c)
        return node.with_children(new_children) if changed else node

    out = plan.transform_up(fix)
    if out.is_device:
        out = te.DeviceToHostExec(out)
    return out
