"""Import Spark Catalyst physical plans serialized as JSON onto the CPU
physical operators (the JAX package's ``plan/catalyst_import.py``).

The real plugin receives Spark's physical plan through ColumnarRule
injection (Plugin.scala:36-44) and rewrites it with GpuOverrides. This
repo has its own frontend, so the plan layer would never see genuine
Catalyst shapes (EnsureRequirements' sorts, SortMergeJoin, adaptive stage
wrappers, reused exchanges). The importer parses the node convention of
Spark's ``plan.toJSON``, a pre-order array of node objects with ``class``
(the fully qualified Catalyst class name) and ``num-children``, expression
trees serialized the same way inside fields, and builds the equivalent
``Cpu*`` tree with bound references, ready for ``TpuOverrides.apply``.

Supported plan nodes: FileSourceScanExec (the port's CpuParquetScanExec,
with no files: the fixtures are plans, not data), ProjectExec,
FilterExec, HashAggregateExec (Partial/Final, mapped onto the single-phase
aggregate; the partial/final split rides the exchange here), SortExec,
SortMergeJoinExec, ShuffledHashJoinExec, BroadcastHashJoinExec,
ShuffleExchangeExec, BroadcastExchangeExec, ReusedExchangeExec (through a
``reuses`` field holding the plan-array index of the original exchange:
toJSON serializes the referent again inline, which would lose its
identity), AdaptiveSparkPlanExec, ShuffleQueryStageExec,
BroadcastQueryStageExec, GlobalLimitExec, LocalLimitExec, UnionExec.

The importer serves the plan layer's tagging, conversion and explain,
which is what the fixtures under tests/catalyst_fixtures check.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.exprs.core import BoundReference, Expression

_DTYPES = {
    "boolean": DType.BOOLEAN, "byte": DType.BYTE, "short": DType.SHORT,
    "integer": DType.INT, "int": DType.INT, "long": DType.LONG,
    "bigint": DType.LONG, "float": DType.FLOAT, "double": DType.DOUBLE,
    "string": DType.STRING, "date": DType.DATE, "timestamp": DType.TIMESTAMP,
    "null": DType.NULL,
}


class CatalystImportError(ValueError):
    pass


def _cls(node: dict) -> str:
    return node.get("class", "").rsplit(".", 1)[-1]


def _dtype(name: Any) -> DType:
    key = str(name).lower().replace("type", "")
    if key not in _DTYPES:
        raise CatalystImportError(f"unsupported dataType {name!r}")
    return _DTYPES[key]


def _preorder(arr: Sequence[dict]) -> Tuple[dict, List]:
    """Parse one pre-order node array (the toJSON convention) into a
    (node, children) tree."""
    pos = 0

    def rec():
        nonlocal pos
        if pos >= len(arr):
            raise CatalystImportError("truncated node array")
        node = arr[pos]
        pos += 1
        kids = [rec() for _ in range(int(node.get("num-children", 0)))]
        return node, kids

    root = rec()
    if pos != len(arr):
        raise CatalystImportError(f"{len(arr) - pos} trailing nodes")
    return root


# ------------------------------------------------------------------ exprs
def _expr(tree, schema: Schema) -> Expression:
    from spark_rapids_tpu_torch.exprs import arithmetic as ar
    from spark_rapids_tpu_torch.exprs import cast as ca
    from spark_rapids_tpu_torch.exprs import predicates as pr
    from spark_rapids_tpu_torch.exprs import literals as li
    from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder

    node, kids = tree
    name = _cls(node)
    sub = [_expr(k, schema) for k in kids]

    if name == "AttributeReference":
        want = node["name"]
        for i, f in enumerate(schema):
            if f.name == want:
                return BoundReference(i, f.dtype, f.nullable, f.name)
        raise CatalystImportError(
            f"attribute {want!r} not found in {[f.name for f in schema]}")
    if name == "Literal":
        dt = _dtype(node.get("dataType", "null"))
        return li.Literal(node.get("value"), dt)
    if name == "Alias":
        return Alias(sub[0], node["name"])
    if name == "Cast":
        return ca.Cast(sub[0], _dtype(node["dataType"]))
    if name == "SortOrder":
        asc = str(node.get("direction", "Ascending")).lower().startswith("asc")
        nf = "first" in str(node.get("nullOrdering",
                                     "NullsFirst" if asc else "NullsLast")
                            ).lower()
        return SortOrder(sub[0], asc, nf)
    if name == "AggregateExpression":
        return sub[0]      # mode rides the exec; the function is the payload
    _BIN = {"Add": ar.Add, "Subtract": ar.Subtract,
            "Multiply": ar.Multiply, "Divide": ar.Divide,
            "And": pr.And, "Or": pr.Or, "EqualTo": pr.EqualTo,
            "LessThan": pr.LessThan, "GreaterThan": pr.GreaterThan,
            "LessThanOrEqual": pr.LessThanOrEqual,
            "GreaterThanOrEqual": pr.GreaterThanOrEqual}
    if name in _BIN:
        return _BIN[name](sub[0], sub[1])
    from spark_rapids_tpu_torch.exprs import nulls as nu
    _UN = {"Not": pr.Not, "IsNull": nu.IsNull, "IsNotNull": nu.IsNotNull}
    if name in _UN:
        return _UN[name](sub[0])
    from spark_rapids_tpu_torch.exprs import aggregates as ag
    _AGG = {"Sum": ag.Sum, "Count": ag.Count, "Min": ag.Min, "Max": ag.Max,
            "Average": ag.Average}
    if name in _AGG:
        return _AGG[name](sub[0])
    raise CatalystImportError(f"unsupported expression class {name!r}")


def _expr_field(node: dict, key: str, schema: Schema) -> Expression:
    arr = node.get(key)
    if not arr:
        raise CatalystImportError(f"{_cls(node)} is missing {key}")
    return _expr(_preorder(arr), schema)


def _expr_list(node: dict, key: str, schema: Schema) -> Tuple[Expression, ...]:
    return tuple(_expr(_preorder(a), schema) for a in node.get(key, []))


def _named(e: Expression, fallback: str) -> Tuple[str, Expression]:
    from spark_rapids_tpu_torch.exprs.misc import Alias
    if isinstance(e, Alias):
        return e.name, e
    return getattr(e, "name_hint", "") or fallback, e


# ------------------------------------------------------------------ plans
def load_plan(doc) -> PhysicalExec:
    """Build a cpu_execs tree from a toJSON-style plan document (a JSON
    string, a parsed array, or {"plan": [...]})."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    if isinstance(doc, dict):
        doc = doc.get("plan", doc)
    if not isinstance(doc, list):
        raise CatalystImportError("plan document must be a node array")
    # positions: plan-array index of each node in pre-order, for `reuses`
    by_index: Dict[int, PhysicalExec] = {}

    pos = 0

    def rec() -> PhysicalExec:
        nonlocal pos
        idx = pos
        node = doc[pos]
        pos += 1
        kids = [rec() for _ in range(int(node.get("num-children", 0)))]
        built = _plan_node(node, kids, by_index)
        by_index[idx] = built
        return built

    root = rec()
    if pos != len(doc):
        raise CatalystImportError(f"{len(doc) - pos} trailing plan nodes")
    return root


def _plan_node(node: dict, kids: List[PhysicalExec],
               by_index: Dict[int, PhysicalExec]) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs import cpu_execs as ce
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        CpuBroadcastExchangeExec, CpuQueryStageExec, CpuReusedExchangeExec,
        CpuShuffleExchangeExec, HashPartitioning, RoundRobinPartitioning,
        SinglePartitioning)
    from spark_rapids_tpu_torch.execs.join_execs import (CpuBroadcastHashJoinExec,
                                                   CpuHashJoinExec,
                                                   CpuSortMergeJoinExec)

    name = _cls(node)
    if name == "FileSourceScanExec":
        fields = [Field(a["name"], _dtype(a["dataType"]),
                        bool(a.get("nullable", True)))
                  for a in node.get("output", [])]
        if not fields:
            raise CatalystImportError("FileSourceScanExec needs output")
        from spark_rapids_tpu_torch.io.parquet import CpuParquetScanExec
        return CpuParquetScanExec((), Schema(fields))
    if name == "ProjectExec":
        exprs = _expr_list(node, "projectList", kids[0].output)
        named = [_named(e, f"c{i}") for i, e in enumerate(exprs)]
        return ce.CpuProjectExec(tuple(e for _, e in named), kids[0])
    if name == "FilterExec":
        return ce.CpuFilterExec(_expr_field(node, "condition",
                                            kids[0].output), kids[0])
    if name == "HashAggregateExec":
        from spark_rapids_tpu_torch.exprs.misc import Alias
        grouping = _expr_list(node, "groupingExpressions", kids[0].output)
        aggs = _expr_list(node, "aggregateExpressions", kids[0].output)
        named = []
        for i, a in enumerate(aggs):
            if not isinstance(a, Alias):
                a = Alias(a, f"agg{i}")
            named.append(a)
        out = Schema(
            [Field(getattr(g, "name_hint", "") or f"g{i}", g.dtype(),
                   g.nullable()) for i, g in enumerate(grouping)]
            + [Field(a.name, a.dtype(), a.nullable()) for a in named])
        return ce.CpuHashAggregateExec(grouping, tuple(named), kids[0], out)
    if name == "SortExec":
        return ce.CpuSortExec(_expr_list(node, "sortOrder", kids[0].output),
                              kids[0])
    if name in ("SortMergeJoinExec", "ShuffledHashJoinExec",
                "BroadcastHashJoinExec"):
        left, right = kids
        lkeys = _expr_list(node, "leftKeys", left.output)
        rkeys = _expr_list(node, "rightKeys", right.output)
        how = str(node.get("joinType", "Inner")).lower().replace("outer", "") \
            .strip("_ ")
        how = {"leftsemi": "left_semi", "leftanti": "left_anti"}.get(how, how)
        semi = how in ("left_semi", "left_anti")
        # the joined schema is only materialized when legal (Spark keeps
        # duplicate names apart by exprId; this importer needs name-unique
        # fixtures for the non-semi forms)
        joined = (left.output if semi else
                  Schema(list(left.output.fields)
                         + list(right.output.fields)))
        cond = (_expr_field(node, "condition", joined)
                if node.get("condition") else None)
        cls = {"SortMergeJoinExec": CpuSortMergeJoinExec,
               "ShuffledHashJoinExec": CpuHashJoinExec,
               "BroadcastHashJoinExec": CpuBroadcastHashJoinExec}[name]
        build = str(node.get("buildSide", "BuildRight"))
        return cls(left, right, how, lkeys, rkeys, joined, cond,
                   build_side="left" if "Left" in build else "right")
    if name == "ShuffleExchangeExec":
        p = node.get("outputPartitioning", {})
        kind = _cls(p) if isinstance(p, dict) else str(p)
        n = int(p.get("numPartitions", 2)) if isinstance(p, dict) else 2
        if kind in ("HashPartitioning", "hashpartitioning"):
            keys = tuple(_expr(_preorder(a), kids[0].output)
                         for a in p.get("expressions", []))
            part = HashPartitioning(n, keys)
        elif kind in ("SinglePartition", "SinglePartitioning"):
            part = SinglePartitioning(1)
        else:
            part = RoundRobinPartitioning(n)
        return CpuShuffleExchangeExec(part, kids[0])
    if name == "BroadcastExchangeExec":
        return CpuBroadcastExchangeExec(kids[0])
    if name == "ReusedExchangeExec":
        ref_idx = node.get("reuses")
        if ref_idx is None or int(ref_idx) not in by_index:
            raise CatalystImportError(
                "ReusedExchangeExec needs a `reuses` plan-array index of an "
                "already-built exchange")
        return CpuReusedExchangeExec(by_index[int(ref_idx)])
    if name in ("AdaptiveSparkPlanExec", "ShuffleQueryStageExec",
                "BroadcastQueryStageExec"):
        return CpuQueryStageExec(kids[0], int(node.get("id", 0)))
    if name in ("GlobalLimitExec", "LocalLimitExec", "CollectLimitExec"):
        return ce.CpuLimitExec(int(node.get("limit", 0)), kids[0])
    if name == "UnionExec":
        out = kids[0]
        for k in kids[1:]:
            out = ce.CpuUnionExec(out, k)
        return out
    raise CatalystImportError(f"unsupported plan class {name!r}")
