"""Whole-stage fusion and the filter-into-aggregate fold in the PyTorch port
(plan/fusion.py, execs/fused_execs.py, plan/overrides.py), on the CPU.

- The port's plans equal the JAX package's after its ``fuse_stages``, tree
  string for tree string, for TPC-H Q1, Q3 and Q6 and for hand-built
  chains: filter -> project -> filter; project over Expand; a chain longer
  than ``sql.fusion.maxOps`` (split); an Expand wider than it (refused); a
  ``rand()`` project (breaks the chain). Each fused stage's
  op names, variants, predicate and folded aggregate compare too.
- Those cases' results equal the JAX package's device path under
  ``JAX_PLATFORMS=cpu`` (exact columns bitwise, float sums within 1e-9;
  Q3's result is held against it by tests/test_torch_q3.py).
- Fusion on equals fusion off bit for bit, row order included, for the 22
  TPC-H queries, the 14 TPC-DS bench queries and TPCx-BB q5, and the 30
  TPCx-BB queries, at the suite tests' scales with the facts hash 8.
"""
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.benchmarks import tpch_data as jdata
from spark_rapids_tpu.benchmarks import tpch_queries as jq
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.execs import base as jbase
from spark_rapids_tpu.execs import cpu_execs as jcpu
from spark_rapids_tpu.execs import expand_execs as jexpand
from spark_rapids_tpu.execs import tpu_execs as jte
from spark_rapids_tpu.exprs import misc as jmisc
from spark_rapids_tpu.plan import fusion as jfusion
from spark_rapids_tpu.testing import assert_tables_equal

import spark_rapids_tpu_torch.exprs as texprs
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from spark_rapids_tpu_torch.benchmarks import tpch as ttpch
from spark_rapids_tpu_torch.benchmarks import tpch_data as tdata
from spark_rapids_tpu_torch.benchmarks import tpch_queries as tq
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as tbb
from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as tbq
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.host import HostBatch, concat_host_batches
from spark_rapids_tpu_torch.execs import base as tbase
from spark_rapids_tpu_torch.execs import cpu_execs as tcpu
from spark_rapids_tpu_torch.execs import expand_execs as texpand
from spark_rapids_tpu_torch.execs import tpu_execs as tte
from spark_rapids_tpu_torch.execs.fused_execs import (FusedAggregateStageExec,
                                                      FusedStageExec)
from spark_rapids_tpu_torch.exprs import misc as tmisc
from spark_rapids_tpu_torch.plan import fusion as tfusion

REL = 1e-9
CPU = torch.device("cpu")
CONF = {**jtpch.BENCH_CONF,
        "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
        "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
FUSION_OFF = {**CONF, "spark.rapids.tpu.sql.fusion.enabled": "false"}
MAX_OPS_2 = {**CONF, "spark.rapids.tpu.sql.fusion.maxOps": "2"}

#: each engine's classes under one set of names, so one builder makes the
#: same hand-built chain in both
JAX = SimpleNamespace(x=jexprs, misc=jmisc, dt=jdt, te=jte, expand=jexpand,
                      F=JF, fusion=jfusion)
PORT = SimpleNamespace(x=texprs, misc=tmisc, dt=tdt, te=tte, expand=texpand,
                       F=F, fusion=tfusion)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n=300, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n)
    words = np.array(["ab", "", "xyz", "hello", "q"], dtype=object)
    return pa.table({
        "a": pa.array(a, mask=rng.random(n) < 0.1),
        "b": pa.array(rng.standard_normal(n)),
        "s": pa.array(list(words[rng.integers(0, 5, n)]),
                      mask=rng.random(n) < 0.05)})


# ---------------------------------------------------------------- signatures
def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def fused_signature(plan):
    """Every fused stage of a plan of either engine, in walk order: its type,
    op names, variants (expressions and predicate) or folded aggregate
    (pre-filter, grouping, aggregates)."""
    out = []
    for s in _walk(plan):
        name = type(s).__name__
        if name == "FusedStageExec":
            out.append((name, [n for n, _ in s.fused_ops],
                        [([str(e) for e in ex], str(pr))
                         for ex, pr in s.variants]))
        elif name == "FusedAggregateStageExec":
            out.append((name, [n for n, _ in s.fused_ops], str(s.pre_filter),
                        [str(g) for g in s.grouping],
                        [str(a) for a in s.aggregates]))
    return out


def _same_plans(port_plan, jax_plan):
    assert fused_signature(port_plan) == fused_signature(jax_plan)
    assert port_plan.tree_string() == jax_plan.tree_string()


# ---------------------------------------------------------------- TPC-H
def test_q1_plans_a_fused_aggregate_with_the_filter_folded():
    """BENCH_CONF's Q1 folds its filter into the aggregate's pre_filter, and
    no TpuFilterExec is left below it; fusion off keeps the fold on a plain
    aggregate."""
    for conf, cls in ((ttpch.BENCH_CONF, FusedAggregateStageExec),
                      ({**ttpch.BENCH_CONF,
                        "spark.rapids.tpu.sql.fusion.enabled": "false"},
                       tte.TpuHashAggregateExec)):
        sess = TpuSession(conf, device="cpu")
        plan = ttpch.q1(sess.create_dataframe(
            ttpch.gen_lineitem(0.0005, 1))).physical_plan()
        aggs = [n for n in plan.walk()
                if isinstance(n, tte.TpuHashAggregateExec)]
        assert len(aggs) == 1 and type(aggs[0]) is cls
        assert aggs[0].pre_filter is not None
        assert not [n for n in aggs[0].walk()
                    if isinstance(n, tte.TpuFilterExec)]


@pytest.fixture(scope="module")
def tpch_pair():
    """(port tables, JAX tables) of customer, orders and lineitem."""
    gens = (("customer", tdata.gen_customer, jdata.gen_customer),
            ("orders", tdata.gen_orders, jdata.gen_orders),
            ("lineitem", tdata.gen_lineitem_full, jdata.gen_lineitem_full))
    return ({k: t(0.002, 3) for k, t, _ in gens},
            {k: j(0.002, 3) for k, _, j in gens})


def _tpch_query(q):
    """(port build, JAX build) of Q1, Q3 or Q6 over the table dict."""
    if q == "q1":
        return (lambda d: ttpch.q1(d["lineitem"]),
                lambda d: jtpch.q1(d["lineitem"]))
    return (tq.QUERIES[int(q[1:])], jq.QUERIES[int(q[1:])])


@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_tpch_fused_stages_match_reference(tpch_pair, q):
    port_tables, jax_tables = tpch_pair
    tbuild, jbuild = _tpch_query(q)
    tsess, jsess = TpuSession(CONF, device="cpu"), JaxSession(CONF)
    tdf = tbuild({k: tsess.create_dataframe(v)
                  for k, v in port_tables.items()})
    jdf = jbuild({k: jsess.create_dataframe(v)
                  for k, v in jax_tables.items()})
    _same_plans(tdf.physical_plan(), jdf._executed_plan())
    if q == "q3":
        return      # its result: tests/test_torch_q3.py
    assert_tables_equal(jdf.collect(), tdf.collect().to_arrow(),
                        approx_float=REL)


# ---------------------------------------------------------------- chains
def _ref(ns, schema, i):
    f = schema[i]
    return ns.x.BoundReference(i, f.dtype, f.nullable, f.name)


def _lit(ns, v):
    return ns.x.Literal.of(v)


def _project_a1(ns, child):
    """(a + 1 AS a1, b, s) over ``child``."""
    s = child.output
    return ns.te.TpuProjectExec((
        ns.x.Alias(ns.x.Add(_ref(ns, s, 0), _lit(ns, 1)), "a1"),
        ns.x.Alias(_ref(ns, s, 1), "b"), ns.x.Alias(_ref(ns, s, 2), "s")),
        child)


def _expand(ns, child, width):
    """Expand with ``width`` projections: (a + k, b, s, k) for k < width,
    the key nulled in every other one."""
    s = child.output
    out = ns.dt.Schema([ns.dt.Field("a", ns.dt.DType.LONG),
                        ns.dt.Field("b", ns.dt.DType.DOUBLE),
                        ns.dt.Field("s", ns.dt.DType.STRING),
                        ns.dt.Field("k", ns.dt.DType.INT, False)])
    projs = []
    for k in range(width):
        a = (ns.x.Add(_ref(ns, s, 0), _lit(ns, k)) if k % 2 == 0
             else ns.x.Literal(None, ns.dt.DType.NULL))
        projs.append((a, _ref(ns, s, 1), _ref(ns, s, 2),
                      ns.x.Literal(k, ns.dt.DType.INT)))
    return ns.expand.TpuExpandExec(tuple(projs), child, out)


def _chain(ns, name, leaf):
    """The hand-built physical chain ``name`` over ``leaf`` (an upload)."""
    if name == "project_over_expand":
        return _project_a1(ns, _expand(ns, leaf, 3))
    if name == "expand_wider_than_max_ops":
        return _project_a1(ns, _expand(ns, leaf, 3))     # maxOps 2
    raise KeyError(name)


PHYSICAL = {"project_over_expand": CONF,
            "expand_wider_than_max_ops": MAX_OPS_2}


def _run_port(plan, conf):
    root = tte.DeviceToHostExec(plan)
    ctx = tbase.ExecContext(conf, CPU, 0, 1)
    return concat_host_batches(list(root.execute(ctx)), root.output)


def _run_jax(plan, conf):
    root = jte.DeviceToHostExec(plan)
    ctx = jbase.ExecContext(conf)
    return pa.concat_tables([b.to_arrow() for b in root.execute(ctx)])


@pytest.mark.parametrize("name", list(PHYSICAL))
def test_hand_built_chain_matches_reference(name):
    conf = PHYSICAL[name]
    table = _table()
    tconf = TpuSession(conf, device="cpu").conf
    jconf = JaxSession(conf).conf
    tplan = tfusion.fuse_stages(_chain(PORT, name, tte.HostToDeviceExec(
        tcpu.CpuLocalScanExec(HostBatch.from_arrow(table)))), tconf)
    jplan = jfusion.fuse_stages(_chain(JAX, name, jte.HostToDeviceExec(
        jcpu.CpuLocalScanExec(table))), jconf)
    _same_plans(tplan, jplan)
    stages = tfusion.fused_stages(tplan)
    expect = {"project_over_expand": [3], "expand_wider_than_max_ops": []}
    assert [len(s.variants) for s in stages] == expect[name]
    got = _run_port(tplan, tconf)
    assert_tables_equal(_run_jax(jplan, jconf), got.to_arrow())
    unfused = _run_port(_chain(PORT, name, tte.HostToDeviceExec(
        tcpu.CpuLocalScanExec(HostBatch.from_arrow(table)))), tconf)
    assert_same_batch(got, unfused)


def _df_chain(ns, name, df):
    F_ = ns.F
    if name == "filter_project_filter":
        return (df.filter(F_.col("a") > F_.lit(-20))
                .select("s", (F_.col("a") * F_.lit(2)).alias("a2"), "b")
                .filter(F_.col("b") < F_.lit(0.5)))
    if name == "longer_than_max_ops":
        return (df.filter(F_.col("a") > F_.lit(-30))
                .select("a", "b", (F_.col("b") + F_.lit(1.0)).alias("b1"))
                .filter(F_.col("b1") > F_.lit(0.0))
                .select((F_.col("a") + F_.lit(7)).alias("a7"), "b1")
                .filter(F_.col("a7") < F_.lit(40)))
    if name == "rand_breaks_the_chain":
        return (df.withColumn("r", F_.rand(7))
                .filter(F_.col("a") > F_.lit(3))
                .select("a", "s"))
    if name == "grouped_fold":
        return (df.filter(F_.col("b") > F_.lit(-1.0))
                .select(F_.pmod(F_.col("a"), F_.lit(5)).alias("k"), "b")
                .groupBy("k").agg(F_.sum("b").alias("sb"),
                                  F_.count().alias("c")))
    raise KeyError(name)


DF_CHAINS = {"filter_project_filter": (CONF, [1]),
             "longer_than_max_ops": (MAX_OPS_2, [1, 1]),
             "rand_breaks_the_chain": (CONF, [1]),
             "grouped_fold": (CONF, [0])}


@pytest.mark.parametrize("name", list(DF_CHAINS))
def test_dataframe_chain_matches_reference(name):
    conf, variants = DF_CHAINS[name]
    table = _table()
    tsess, jsess = TpuSession(conf, device="cpu"), JaxSession(conf)
    tdf = _df_chain(PORT, name, tsess.create_dataframe(table))
    jdf = _df_chain(JAX, name, jsess.create_dataframe(table))
    _same_plans(tdf.physical_plan(), jdf._executed_plan())
    stages = tfusion.fused_stages(tdf.physical_plan())
    assert [len(getattr(s, "variants", ())) for s in stages] == variants
    got = tdf.collect()
    assert_tables_equal(jdf.collect(), got.to_arrow(), approx_float=REL)
    off = _df_chain(PORT, name, TpuSession(
        {**conf, "spark.rapids.tpu.sql.fusion.enabled": "false"},
        device="cpu").create_dataframe(table)).collect()
    assert_same_batch(got, off)


# ---------------------------------------------------------------- on == off
def assert_same_batch(a: HostBatch, b: HostBatch) -> None:
    """Bit for bit, row order included: every column's validity, lengths
    and the bytes of its values (a string's bytes within its length)."""
    assert a.schema == b.schema
    assert a.num_rows == b.num_rows
    n = a.num_rows
    for f, x, y in zip(a.schema, a.columns, b.columns):
        assert np.array_equal(x.validity[:n], y.validity[:n]), f.name
        if x.lengths is not None:
            assert np.array_equal(x.lengths[:n], y.lengths[:n]), f.name
            w = int(x.lengths[:n].max(initial=0))
            keep = np.arange(w)[None, :] < x.lengths[:n, None]
            assert np.array_equal(np.where(keep, x.data[:n, :w], 0),
                                  np.where(keep, y.data[:n, :w], 0)), f.name
        else:
            assert x.data[:n].tobytes() == y.data[:n].tobytes(), f.name


def _suite_frames(sess, tables, facts):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    for t, key in facts.items():
        if t in dfs:
            dfs[t] = dfs[t].repartition(8, key)
    return dfs


_TPCH_FACTS = {"orders": "o_orderkey", "lineitem": "l_orderkey"}
_DS_FACTS = {"store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
             "web_sales": "ws_item_sk", "web_clickstreams": "wcs_item_sk"}
_BB_FACTS = {"store_sales": "ss_item_sk", "web_sales": "ws_item_sk",
             "web_clickstreams": "wcs_user_sk"}

#: the TPC-DS bench subset (tests/test_torch_tpcds_queries_*.py hold the
#: other queries fused against unfused)
_DS_BENCH = ("q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42",
             "q52", "q55", "q67", "q68", "q96")
SUITE = ([("tpch", q) for q in sorted(tq.QUERIES)]
         + [("tpcds", q) for q in _DS_BENCH]
         + [("tpcds", "bb_q5")]
         + [("tpcxbb", q) for q in sorted(tbq.QUERIES,
                                          key=lambda n: int(n[1:]))])


@pytest.fixture(scope="module")
def suite_tables():
    return {"tpch": tdata.gen_all(0.002, seed=7),
            "tpcds": tds.gen_all(0.01, seed=3),
            "bb": tbb.gen_all(0.01, seed=0)}


def _suite_case(suite_tables, suite, q):
    """(build, tables, facts) of one suite query at its test scale."""
    if suite == "tpch":
        return tq.QUERIES[q], suite_tables["tpch"], _TPCH_FACTS
    if suite == "tpcds" and q != "bb_q5":
        return tdq.QUERIES[q], suite_tables["tpcds"], _DS_FACTS
    if q == "bb_q5":
        return tbq.QUERIES["q5"], suite_tables["bb"], _DS_FACTS
    return tbq.QUERIES[q], suite_tables["bb"], _BB_FACTS


@pytest.mark.parametrize("suite,q", SUITE,
                         ids=[f"{s}-{q}" for s, q in SUITE])
def test_fusion_on_equals_off(suite_tables, suite, q):
    build, tables, facts = _suite_case(suite_tables, suite, q)
    on_sess = TpuSession(CONF, device="cpu")
    off_sess = TpuSession(FUSION_OFF, device="cpu")
    on = build(_suite_frames(on_sess, tables, facts)).collect()
    off = build(_suite_frames(off_sess, tables, facts)).collect()
    assert_same_batch(on, off)
    # the fold runs either way: no aggregate keeps a filter right below it
    for sess in (on_sess, off_sess):
        for node in sess.last_plan.walk():
            if type(node) in (tte.TpuHashAggregateExec,
                              FusedAggregateStageExec):
                assert not isinstance(node.children[0],
                                      (tte.TpuFilterExec, tte.TpuProjectExec))
    assert not tfusion.fused_stages(off_sess.last_plan)
    assert not [n for n in on_sess.last_plan.walk()
                if isinstance(n, FusedStageExec) and len(n.fused_ops) < 2]


# ---------------------------------------------------------------- CSE
def test_common_subexpressions_are_shared_and_give_the_same_values():
    """A subtree the substitution repeats is computed once into an extra
    column; the rewritten expressions give the original values."""
    from spark_rapids_tpu_torch.exprs.core import EvalCtx
    from spark_rapids_tpu_torch.exprs.cse import (add_shared_columns,
                                                  common_subexpressions)
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    hb = HostBatch.from_arrow(_table())
    db = tte.HostToDeviceExec(tcpu.CpuLocalScanExec(hb)).execute(
        tbase.ExecContext(TpuSession(CONF, device="cpu").conf, CPU))
    db = next(iter(db))
    x = texprs
    a = _ref(PORT, db.schema, 0)
    a1 = x.Add(a, x.Literal.of(1))
    roots = (x.Multiply(a1, x.Literal.of(2)), x.GreaterThan(a1, a),
             None, x.Alias(x.Add(a1, a1), "twice"))
    shared, rewritten = common_subexpressions(roots, len(db.columns))
    assert shared == (a1,)
    assert rewritten[2] is None
    ref = x.BoundReference(len(db.columns), a1.dtype(), a1.nullable(), "")
    assert rewritten[0] == x.Multiply(ref, x.Literal.of(2))
    plain = EvalCtx(colvs_of(db), db.capacity, CPU)
    shared_ctx = EvalCtx(colvs_of(db), db.capacity, CPU)
    add_shared_columns(shared_ctx, shared)
    for r, w in zip(roots, rewritten):
        if r is None:
            continue
        want, got = r.eval(plain), w.eval(shared_ctx)
        assert torch.equal(want.data, got.data)
        assert torch.equal(want.validity, got.validity)
    assert common_subexpressions((a1, a), 3) == ((), (a1, a))


def test_exploded_split_is_split_once_per_batch(suite_tables):
    """TPCx-BB q10's fused stage repeats the sentence's split in every CASE
    branch of each of its variants: the stage computes each distinct
    subtree once."""
    sess = TpuSession(CONF, device="cpu")
    plan = tbq.QUERIES["q10"](_suite_frames(sess, suite_tables["bb"],
                                            _BB_FACTS)).physical_plan()
    stage, = [s for s in tfusion.fused_stages(plan)
              if isinstance(s, FusedStageExec)]
    assert len(stage.variants) == 3 and len(stage._shared) >= 3
    assert len(set(stage._shared)) == len(stage._shared)
