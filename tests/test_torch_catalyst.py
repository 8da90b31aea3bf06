"""The port's Catalyst plan import (plan/catalyst_import.py) and the plan
layer's rules for what only imported plans carry (the sort-merge join, the
reused exchange, the adaptive stage wrappers and the exchange-reuse
consistency pass), against the JAX package, case for case with
tests/test_catalyst_fixtures.py: each golden fixture loads through both
packages' importers and both ``TpuOverrides``, and the converted trees
(class names in pre-order) and the explain texts must be the same, with
the JAX tests' own checks on the port's tree. The importers' refusals
match too. The fixtures are plans: their scans carry no files, so nothing
is executed (neither package executes them)."""
import json
import os

import pytest

from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.plan import catalyst_import as jci
from spark_rapids_tpu.plan.overrides import TpuOverrides as JaxOverrides
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.exchange_execs import (
    CpuReusedExchangeExec, CpuShuffleExchangeExec, TpuReusedExchangeExec,
    TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.execs.join_execs import (CpuSortMergeJoinExec,
                                                     TpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan import catalyst_import as ci
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides

FIXTURES = os.path.join(os.path.dirname(__file__), "catalyst_fixtures")

BASE = {"spark.rapids.tpu.sql.enabled": "true",
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}


def _doc(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def _nodes(plan):
    yield plan
    for c in plan.children:
        yield from _nodes(c)


def _names(plan):
    return [type(n).__name__ for n in _nodes(plan)]


def _apply(name, **conf):
    """(port plan, port overrides) after holding both to the JAX package's
    importer and overrides under the same conf."""
    conf = {**BASE, **conf}
    ov = TpuOverrides(TpuConf(conf))
    out = ov.apply(ci.load_plan(_doc(name)))
    jov = JaxOverrides(JaxConf(conf))
    jout = jov.apply(jci.load_plan(_doc(name)))
    assert _names(out) == _names(jout), (_names(out), _names(jout))
    assert ov.last_explain == jov.last_explain
    return out, ov


ALL = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".json"))


@pytest.mark.parametrize("name", ALL)
def test_imported_tree_matches_jax(name):
    """Every fixture loads to the same Cpu* tree as the JAX importer's."""
    port = ci.load_plan(_doc(name))
    ref = jci.load_plan(_doc(name))
    assert _names(port) == _names(ref)
    assert [str(n.output) for n in _nodes(port)] == \
        [str(n.output) for n in _nodes(ref)]


def test_scan_filter_project_agg_chain_converts():
    out, ov = _apply("scan_filter_project_agg.json")
    names = _names(out)
    for want in ("TpuHashAggregateExec", "TpuShuffleExchangeExec",
                 "TpuParquetScanExec"):
        assert want in names, (want, names)
    aggs = [n for n in names
            if n in ("TpuHashAggregateExec", "FusedAggregateStageExec")]
    assert len(aggs) == 2, names
    assert not any(n.startswith("Cpu") for n in names), names
    assert "will run on TPU" in ov.last_explain


def test_smj_replaced_by_hash_join_sorts_dropped():
    out, _ = _apply("smj_with_sorts.json")
    names = _names(out)
    assert "TpuShuffledHashJoinExec" in names
    assert not any("Sort" in n for n in names), names
    assert "TpuShuffleExchangeExec" in names


def test_smj_stays_cpu_when_replacement_disabled():
    out, ov = _apply(
        "smj_with_sorts.json",
        **{"spark.rapids.tpu.sql.replaceSortMergeJoin.enabled": "false"})
    assert any(isinstance(n, CpuSortMergeJoinExec) for n in _nodes(out))
    assert "sort-merge join replacement is disabled" in ov.last_explain
    assert "TpuShuffleExchangeExec" in _names(out)


def test_smj_left_semi_converts_with_left_only_output():
    out, _ = _apply("smj_left_semi.json")
    joins = [n for n in _nodes(out)
             if isinstance(n, TpuShuffledHashJoinExec)]
    assert len(joins) == 1 and joins[0].how == "left_semi"
    assert [f.name for f in joins[0].output] == ["k", "v"]


def test_broadcast_join_converts_to_tpu_pair():
    out, _ = _apply("broadcast_join.json")
    names = _names(out)
    assert "TpuBroadcastHashJoinExec" in names
    assert "TpuBroadcastExchangeExec" in names


def test_reused_exchange_converts_with_referent():
    out, _ = _apply("reused_exchange.json")
    reused = [n for n in _nodes(out) if isinstance(n, TpuReusedExchangeExec)]
    assert len(reused) == 1
    assert isinstance(reused[0].referent, TpuShuffleExchangeExec)


def test_reused_exchange_referent_gets_transitions():
    """The reused subtree receives the same transitions as the main branch:
    a host-only referent child needs an upload below the device exchange
    on both copies."""
    out, _ = _apply("reused_exchange.json",
                    **{"spark.rapids.tpu.sql.exec.ParquetScan": "false"})
    exchanges = [n for n in _nodes(out)
                 if isinstance(n, TpuShuffleExchangeExec)]
    assert len(exchanges) == 2
    for ex in exchanges:
        child = ex.children[0]
        if type(child).__name__.startswith("PipelinedExec"):
            child = child.children[0]
        assert type(child).__name__ == "HostToDeviceExec", _names(out)


def test_reused_exchange_consistency_forces_pair_to_cpu():
    out, ov = _apply("reused_exchange.json",
                     **{"spark.rapids.tpu.sql.exec.ReusedExchange": "false"})
    assert any(isinstance(n, CpuReusedExchangeExec) for n in _nodes(out))
    assert not any(isinstance(n, TpuShuffleExchangeExec)
                   for n in _nodes(out)), _names(out)
    assert any(isinstance(n, CpuShuffleExchangeExec) for n in _nodes(out))
    assert "exchange reuse consistency" in ov.last_explain


def test_aqe_stage_wrappers_dissolve_and_convert():
    out, _ = _apply("aqe_stage_wrappers.json")
    names = _names(out)
    assert "CpuQueryStageExec" not in names
    assert "TpuShuffleExchangeExec" in names
    assert "TpuHashAggregateExec" in names


def test_disabled_expression_causes_partial_fallback():
    out, ov = _apply("project_mult.json",
                     **{"spark.rapids.tpu.sql.expression.Multiply": "false"})
    names = _names(out)
    assert "CpuProjectExec" in names
    assert "TpuParquetScanExec" in names
    assert "disabled by spark.rapids.tpu.sql.expression.Multiply" \
        in ov.last_explain


def test_union_limit_converts():
    out, _ = _apply("union_limit.json")
    names = _names(out)
    assert "TpuLimitExec" in names
    assert "TpuUnionExec" in names


SCAN = {"class": "x.FileSourceScanExec", "num-children": 0,
        "output": [{"name": "k", "dataType": "long"}]}


@pytest.mark.parametrize("doc,match", [
    ([{"class": "x.y.MysteryExec", "num-children": 0}],
     "unsupported plan class"),
    ([{"class": "x.exchange.ReusedExchangeExec", "num-children": 0}],
     "reuses"),
    ([{"class": "x.FilterExec", "num-children": 1,
       "condition": [{"class": "x.And", "num-children": 2}]}, SCAN],
     "truncated node array"),
    ([SCAN, SCAN], "1 trailing plan nodes"),
    ([{"class": "x.FileSourceScanExec", "num-children": 0}],
     "needs output"),
    ([{"class": "x.FilterExec", "num-children": 1,
       "condition": [{"class": "x.AttributeReference", "num-children": 0,
                      "name": "nope"}]}, SCAN], "not found"),
    ([{"class": "x.ProjectExec", "num-children": 1,
       "projectList": [[{"class": "x.Upper", "num-children": 0}]]}, SCAN],
     "unsupported expression class"),
    ({"plan": 3}, "node array"),
])
def test_importer_rejects_unknown_shapes(doc, match):
    """The port refuses what the JAX importer refuses, with its message."""
    with pytest.raises(ci.CatalystImportError, match=match) as got:
        ci.load_plan(doc)
    with pytest.raises(jci.CatalystImportError) as want:
        jci.load_plan(doc)
    assert str(got.value) == str(want.value)
