"""The port's plan layer (``plan/overrides.py``, ``plan/meta.py``) against
the JAX package's ``TpuOverrides``: for the 22 TPC-H queries at SF 0.002
(under the benchmark conf and under the default conf, both nested-loop
keys on, which the port always treats so) and for one plan per fallback
reason, the same explain text letter for letter (every operator of the
CPU plan with its decision and reasons), the same operators left on the
CPU engine in the executed plan, and equal results (the JAX side's from
its numpy engine, ``sql.enabled=false``; exact columns exact, floats
within 1e-9). The JAX side only plans its device path. The rule tables
are held against the JAX package's too."""
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.benchmarks import tpch_data as jdata
from spark_rapids_tpu.benchmarks import tpch_queries as jq
from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks import tpch_data as tdata
from spark_rapids_tpu_torch.benchmarks import tpch_queries as tq

SCALE, SEED = 0.002, 0
NESTED = {"spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
          "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
CONFS = {"bench": {**BENCH_CONF, **NESTED}, "default": NESTED}
OFF = {"spark.rapids.tpu.sql.enabled": "false"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def cpu_ops(plan):
    """The CPU engine's operators of an executed plan (of either package),
    by class name."""
    return sorted(type(n).__name__ for n in _walk(plan)
                  if type(n).__name__.startswith("Cpu"))


def jax_cpu_ops(plan):
    # the JAX package roots a fallen-back plan in its collect
    return [n for n in cpu_ops(plan) if n != "CpuCollectExec"]


@pytest.fixture(scope="module")
def tpch():
    """The JAX tables, its numpy engine's answers, and per conf its
    planner's explain and CPU operators (planned only)."""
    tables = jdata.gen_all(SCALE, seed=SEED)
    engine = JaxSession({**CONFS["bench"], **OFF})
    answers, plans = {}, {}
    for q, query in jq.QUERIES.items():
        answers[q] = query({k: engine.create_dataframe(v)
                            for k, v in tables.items()}).collect()
        for name, conf in CONFS.items():
            sess = JaxSession(conf)
            plan = query({k: sess.create_dataframe(v)
                          for k, v in tables.items()})._executed_plan()
            plans[q, name] = (sess.last_explain, jax_cpu_ops(plan))
    return answers, plans, tdata.gen_all(SCALE, seed=SEED)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("qnum", sorted(tq.QUERIES))
def test_tpch_tagging_matches_reference(tpch, qnum, conf):
    answers, plans, tables = tpch
    sess = TpuSession(CONFS[conf], device="cpu")
    got = tq.QUERIES[qnum]({k: sess.create_dataframe(v)
                            for k, v in tables.items()}).collect()
    explain, ops = plans[qnum, conf]
    assert sess.last_explain == explain
    assert cpu_ops(sess.last_plan) == ops
    assert_tables_equal(answers[qnum], got.to_arrow(),
                        ignore_order=True, approx_float=1e-9)


# ---------------------------------------------------------------- one plan
# per fallback reason
def _table():
    n = 64
    return pa.table({
        "k": pa.array([i % 5 for i in range(n)], type=pa.int32()),
        "i": pa.array(list(range(n)), type=pa.int64()),
        "f": pa.array([i * 0.37 - 3.0 for i in range(n)]),
        "s": pa.array([("aéc" if i % 3 == 0 else "abc" if i % 3 == 1
                        else "a-" * (i % 7)) for i in range(n)]),
    })


LONG_LIKE = "%" + "a_" * 30 + "%"     # over the DFA's 512 states

#: name -> (conf, build(functions module, DataFrame)); every plan but the
#: two that leave everything on the CPU engine keeps a device operator
#: beside the one that falls back
PLANS = {
    "float_sum": ({}, lambda f, df: df.filter(f.col("k") > 1)
                  .groupBy("k").agg(f.sum("f").alias("x"))),
    "average": ({}, lambda f, df: df.filter(f.col("k") > 1)
                .groupBy("k").agg(f.avg("f").alias("x"))),
    "stddev": ({}, lambda f, df: df.filter(f.col("k") > 1)
               .groupBy("k").agg(f.stddev("i").alias("x"))),
    "rlike": ({}, lambda f, df: df.filter(f.col("s").rlike("a.c"))
              .select("k", "s")),
    "upper": ({}, lambda f, df: df.filter(f.col("k") > 1).select(
        f.upper("s").alias("u"))),
    "rand": ({}, lambda f, df: df.filter(f.col("k") > 1).select(
        "i", f.rand(7).alias("r"))),
    "like_refused": ({"spark.rapids.tpu.sql.incompatibleOps.enabled":
                      "true"},
                     lambda f, df: df.filter(f.col("s").like(LONG_LIKE))
                     .select("i")),
    "exec_key_off": ({"spark.rapids.tpu.sql.exec.Filter": "false"},
                     lambda f, df: df.filter(f.col("k") > 1)
                     .select((f.col("i") + 1).alias("j"))),
    "expression_key_off": ({"spark.rapids.tpu.sql.expression.Add":
                            "false"},
                           lambda f, df: df.filter(f.col("k") > 1)
                           .select((f.col("i") + 1).alias("j"))),
    "sql_disabled": (OFF, lambda f, df: df.filter(f.col("k") > 1)
                     .groupBy("k").agg(f.count().alias("n"))),
    "cost_model": ({"spark.rapids.tpu.sql.adaptive.costModel.enabled":
                    "true",
                    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"},
                   lambda f, df: df.filter(f.col("k") > 1).groupBy("k")
                   .agg(f.sum("f").alias("x"))),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fallback_plan_matches_reference(name):
    conf, build = PLANS[name]
    table = _table()
    jsess = JaxSession(conf)
    jdf = build(JF, jsess.create_dataframe(table))
    jplan = jdf._executed_plan()
    want = build(JF, JaxSession({**conf, **OFF}).create_dataframe(table)) \
        .collect()
    sess = TpuSession(conf, device="cpu")
    got = build(F, sess.create_dataframe(table)).collect()
    assert sess.last_explain == jsess.last_explain
    assert cpu_ops(sess.last_plan) == jax_cpu_ops(jplan)
    assert_tables_equal(want, got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)
    on_cpu = all(type(x).__name__.startswith("Cpu")
                 for x in sess.last_plan.walk())
    if name == "sql_disabled":
        assert sess.last_explain == "" and on_cpu
    elif name == "cost_model":
        # 64 rows are under costModel.minDeviceRows everywhere
        assert "will run on TPU" not in sess.last_explain and on_cpu
    else:
        # the fallback is real: something stays on the device, something
        # does not
        assert "will run on TPU" in sess.last_explain
        assert len(cpu_ops(sess.last_plan)) > 1


def test_explain_modes_print_like_reference(capsys):
    """``sql.explain`` ALL prints the whole text, NOT_ON_TPU only the
    fallback lines; ``DataFrame.explain`` returns them with the plan."""
    conf, build = PLANS["float_sum"]
    table = _table()
    for mode in ("ALL", "NOT_ON_TPU"):
        c = {**conf, "spark.rapids.tpu.sql.explain": mode}
        JaxSession(c)
        build(JF, JaxSession(c).create_dataframe(table))._executed_plan()
        want = capsys.readouterr().out
        sess = TpuSession(c, device="cpu")
        build(F, sess.create_dataframe(table)).physical_plan()
        assert capsys.readouterr().out == want
    sess = TpuSession(conf, device="cpu")
    text = build(F, sess.create_dataframe(table)).explain(print_out=False)
    assert text.startswith("!CpuHashAggregateExec cannot run on TPU")
    assert "\n\nPhysical plan:\n" in text and "CpuHashAggregateExec [" in text


def test_rule_tables_match_reference():
    """Every JAX expression rule has the port's twin with the same conf
    key, description and incompat note, and the exec rules of the ported
    operators likewise; the port adds split() (its device explode of a
    split), no exec rule is disabled by default (the nested-loop and
    cartesian joins always ran on the device in the port), and the CSV
    and ORC scans and the writers wait with their modules; the sort-merge
    join, reused exchange and query stage rules came with the Catalyst
    import that alone makes those operators."""
    import spark_rapids_tpu_torch.io.parquet  # noqa: F401 - its rule
    from spark_rapids_tpu.plan import overrides as jo
    from spark_rapids_tpu_torch.plan import overrides as to
    jexpr = {r.cls.__name__: (r.conf_key, r.desc, r.incompat)
             for r in jo.EXPR_RULES.values()}
    texpr = {r.cls.__name__: (r.conf_key, r.desc, r.incompat)
             for r in to.EXPR_RULES.values()}
    assert set(texpr) - set(jexpr) == {"StringSplit"}
    assert {k: v for k, v in texpr.items() if k in jexpr} == jexpr
    jexec = {r.cls.__name__: (r.conf_key, r.desc)
             for r in jo.EXEC_RULES.values()}
    texec = {r.cls.__name__: (r.conf_key, r.desc)
             for r in to.EXEC_RULES.values()}
    assert set(jexec) - set(texec) == {
        "CpuCsvScanExec", "CpuOrcScanExec", "CpuWriteFilesExec"}
    assert {k: v for k, v in jexec.items() if k in texec} == texec
    assert {r.cls.__name__ for r in jo.EXEC_RULES.values()
            if r.disabled_by_default} == {"CpuNestedLoopJoinExec",
                                          "CpuCartesianProductExec"}


def test_range_matches_reference():
    """``session.range`` plans CpuRangeExec, converted to TpuRangeExec."""
    sess = TpuSession({}, device="cpu")
    got = sess.range(3, 40, 4).filter(F.col("id") > 10).collect()
    js = JaxSession({})
    want = js.range(3, 40, 4).filter(JF.col("id") > 10).collect()
    assert sess.last_explain == js.last_explain
    assert any(type(n).__name__ == "TpuRangeExec"
               for n in sess.last_plan.walk())
    assert_tables_equal(want, got.to_arrow())
    off = TpuSession(OFF, device="cpu")
    assert_tables_equal(want, off.range(3, 40, 4).filter(
        F.col("id") > 10).collect().to_arrow())
