"""The port's adaptive execution (plan/adaptive.py) against the JAX
package's, case for case with tests/test_adaptive.py and
tests/test_adaptive_v2.py: the same DataFrame runs through both packages
with adaptive execution on, and the results, the decisions (reader specs,
``[adaptive: …]`` tags) and the counters must agree
(tests/torch_adaptive_common.py). The JAX side is its device path under
``JAX_PLATFORMS=cpu``, except where a case says it runs the JAX CPU
engine: there the XLA compiles of the skewed shapes cost tens of seconds,
and the CPU engine makes the same decisions from the same statistics
(its classes are Cpu*, so the comparison maps the names)."""
import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_tpu.execs.exchange_execs import \
    ShuffleExchangeExecBase as JaxExchange
from spark_rapids_tpu.execs.exchange_execs import _kmv_estimate as jax_kmv_est
from spark_rapids_tpu.execs.exchange_execs import _kmv_merge as jax_kmv_merge
from spark_rapids_tpu.plan import adaptive as jad
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.execs.exchange_execs import (
    ShuffleExchangeExecBase, _kmv_estimate, _kmv_merge)
from spark_rapids_tpu_torch.plan import adaptive as ad
from spark_rapids_tpu_torch.plan.adaptive import (CustomShuffleReaderExecBase,
                                                  PartialReducerSpec,
                                                  coalesce_specs,
                                                  legal_split_sides)

from torch_adaptive_common import (AQE, JAX_CPU_ENGINE, NO_BROADCAST, SKEW,
                                   assert_same_run, dim_table,
                                   one_torch_thread, run_jax, run_port,
                                   skewed_table, sort_all, t7, t13, table,
                                   walk)

#: the JAX CPU engine's class names -> the port device path's
DEVICE_NAMES = {"CpuCustomShuffleReaderExec": "TpuCustomShuffleReaderExec",
                "CpuHashJoinExec": "TpuShuffledHashJoinExec",
                "CpuHashAggregateExec": "TpuHashAggregateExec"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs."""
    import torch
    threads = one_torch_thread()
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ tests/test_adaptive.py
def test_coalesce_specs():
    for sizes, target in (([10, 10, 10, 10], 25), ([30, 30], 25),
                          ([1, 1, 1], 1000), ([], 10), ([0, 0, 50, 0], 25)):
        assert coalesce_specs(sizes, target) == \
            jad.coalesce_specs(sizes, target)
    assert coalesce_specs([0, 0, 50, 0], 25) == ((0, 1, 2), (3,))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 1 << 20), max_size=40),
       st.integers(1, 1 << 21))
def test_coalesce_specs_hypothesis(sizes, target):
    assert coalesce_specs(sizes, target) == jad.coalesce_specs(sizes, target)


def _filtered(n_parts, key="b", cut=10):
    def build(s, f):
        df = s.create_dataframe(table())
        df = df.repartition(n_parts, key) if key else df.repartition(n_parts)
        return df.filter(f.col("a") > cut)
    return build


def test_reader_coalesces_small_partitions():
    port, _ = assert_same_run(AQE, _filtered(6))
    assert "TpuCustomShuffleReaderExec" in port[1].last_plan.tree_string()
    assert port[0].num_rows == 89
    off, s_off, _ = run_port({}, _filtered(6))
    assert "CustomShuffleReader" not in s_off.last_plan.tree_string()
    assert_tables_equal(off.sort_by("a"), port[0].sort_by("a"))


def test_reader_respects_advisory_size():
    conf = {**AQE, "spark.rapids.tpu.sql.adaptive."
                   "advisoryPartitionSizeInBytes": "1"}
    port, _ = assert_same_run(conf, _filtered(4, key=None))
    assert "CustomShuffleReader" not in port[1].last_plan.tree_string()
    assert port[0].num_rows == 89


def _switch_build(s, f):
    rt_t = pa.table({"b": pa.array(np.arange(100) % 7, type=pa.int64()),
                     "n": pa.array(np.arange(100), type=pa.int64())})
    lt = s.create_dataframe(table()).repartition(4, "b")
    rt = (s.create_dataframe(rt_t).filter(f.col("n") < 30)
          .repartition(3, "b"))
    return lt.join(rt, "b").sort("b", "a")


def test_dynamic_broadcast_join_switch():
    threshold = {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1000"}
    port, _ = assert_same_run({**threshold, **AQE}, _switch_build,
                              ordered=True)
    plan = port[1].last_plan.tree_string()
    for want in ("TpuBroadcastHashJoinExec", "TpuBroadcastExchangeExec",
                 "TpuCustomShuffleReaderExec"):
        assert want in plan, plan
    ref, s_ref, _ = run_port(threshold, _switch_build)
    assert "TpuShuffledHashJoinExec" in s_ref.last_plan.tree_string()
    assert_tables_equal(ref, port[0])


def _counted_right(s, f, n=100, agg="count"):
    lt = s.create_dataframe(table(n)).repartition(4, "b")
    rt = s.create_dataframe(table(n)).repartition(3, "b").groupBy("b")
    rt = (rt.agg(f.count().alias("n")) if agg == "count"
          else rt.agg(f.sum("a").alias("sa")))
    return lt, rt


def test_static_broadcast_from_audited_estimates():
    """No adaptive execution: a build side known small at plan time
    broadcasts statically in both packages."""
    def build(s, f):
        lt, rt = _counted_right(s, f)
        return lt.join(rt, "b").sort("b", "a")
    port, ref = assert_same_run({}, build, ordered=True)
    for sess in (port[1], ref[1]):
        assert "TpuBroadcastHashJoinExec" in sess.last_plan.tree_string()
    assert port[0].num_rows == 100


def test_broadcast_switch_respects_threshold():
    def build(s, f):
        lt, rt = _counted_right(s, f, n=500)
        return lt.join(rt, "b").sort("b", "a")
    conf = {**AQE, "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "10"}
    port, _ = assert_same_run(conf, build, ordered=True)
    assert "TpuShuffledHashJoinExec" in port[1].last_plan.tree_string()
    assert port[0].num_rows == 500


def test_aqe_on_cpu_engine():
    """The CPU engine adapts too (CpuCustomShuffleReaderExec)."""
    conf = {**AQE, "spark.rapids.tpu.sql.enabled": "false"}
    port, _ = assert_same_run(conf, _filtered(5))
    assert "CpuCustomShuffleReaderExec" in port[1].last_plan.tree_string()
    assert port[0].num_rows == 89


def _pipeline(s, f):
    lt, rt = _counted_right(s, f, n=300, agg="sum")
    return (lt.join(rt, "b")
            .groupBy("b").agg(f.count().alias("n"), f.max("sa").alias("m"))
            .sort("b"))


def test_aqe_full_query_pipeline():
    port, _ = assert_same_run(AQE, _pipeline, ordered=True)
    off, _, _ = run_port({}, _pipeline)
    assert_tables_equal(off, port[0])


def test_broadcast_switch_restores_limit_semantics():
    """After the switch the join emits the stream side's partitioning; the
    limit planned over one partition must still see one. Which five rows
    a limit keeps is not part of the contract, so only the counts and the
    decisions are compared."""
    def build(s, f):
        lt, rt = _counted_right(s, f)
        return lt.join(rt, "b").limit(5)
    port = run_port(AQE, build)
    ref = run_jax(AQE, build)
    assert port[0].num_rows == ref[0].num_rows == 5
    assert ad.counters() == ref[2]
    assert run_port({}, build)[0].num_rows == 5


def test_broadcast_switch_restores_agg_distribution():
    def build(s, f):
        lt, rt = _counted_right(s, f)
        return (lt.join(rt, "b").groupBy("a").agg(f.count().alias("c"))
                .sort("a"))
    port, _ = assert_same_run(AQE, build, ordered=True)
    assert_tables_equal(run_port({}, build)[0], port[0])


# --------------------------------------------------------- tests/test_adaptive_v2.py
def _stats_of(plan, cls, n_parts=None):
    return [n for n in walk(plan) if isinstance(n, cls)
            and (n_parts is None or n.num_partitions == n_parts)][0]


def test_stage_stats_rows_bytes_ndv():
    t = pa.table({"k": pa.array(np.arange(1000) % 7, type=pa.int64()),
                  "v": pa.array(np.arange(1000), type=pa.int64())})

    def build(s, f):
        return s.create_dataframe(t).repartition(4, "k").filter(
            f.col("v") > 10)
    st = _stats_of(_last_port_plan(build),
                   ShuffleExchangeExecBase).stage_stats()
    ref = run_jax({}, build)
    jst = _stats_of(ref[1].last_plan, JaxExchange).stage_stats()
    assert st is not None and jst is not None
    assert st.partition_rows == jst.partition_rows
    assert st.partition_bytes == jst.partition_bytes
    assert st.key_distinct == jst.key_distinct == (7,)
    assert st.describe() == jst.describe()
    assert st.total_rows == 1000 and "rows=1000" in st.describe()


def _last_port_plan(build, conf=None):
    return run_port(conf or {}, build)[1].last_plan


def test_stage_stats_absent_before_run():
    from spark_rapids_tpu_torch.api import TpuSession
    s = TpuSession({}, device="cpu")
    plan = s.create_dataframe(dim_table()).repartition(3, "k").physical_plan()
    ex = _stats_of(plan, ShuffleExchangeExecBase)
    assert ex.stage_stats() is None


def test_kmv_estimator_skew_resistant():
    """A heavy hitter repeated 10k times must not evict the other distinct
    hashes from the pool; the port's pool and estimate equal the JAX
    package's merge by merge."""
    rng = np.random.default_rng(0)
    small = np.uint32(1)
    others = rng.integers(2, 1 << 32, 200, dtype=np.uint64).astype(np.uint32)
    pool = np.zeros(0, dtype=np.uint32)
    jpool = np.zeros(0, dtype=np.uint32)
    for _ in range(10):
        batch = np.concatenate([np.repeat(small, 10000), others])
        pool = _kmv_merge(pool, batch)
        jpool = jax_kmv_merge(jpool, batch)
        assert np.array_equal(pool, jpool)
    est = _kmv_estimate(pool)
    assert est == jax_kmv_est(jpool)
    true_ndv = len(np.unique(others)) + 1
    assert abs(est - true_ndv) / true_ndv < 0.5, (est, true_ndv)


def _slices_build(s, f):
    return (s.create_dataframe(skewed_table()).repartition(8)
            .repartition(6, "k").filter(f.col("v") >= 0))


def test_map_slices_cover_contributing_maps():
    """The JAX side runs its CPU engine (see the module docstring), with
    adaptive execution on: its CPU engine's last_plan keeps the executed
    exchanges only then. Both run the skew conf, whose advisory size keeps
    the round-robin stage's eight map tasks apart."""
    plan = _last_port_plan(_slices_build, SKEW)
    ref = run_jax({**SKEW, **JAX_CPU_ENGINE}, _slices_build)
    from spark_rapids_tpu.execs.exchange_execs import CpuShuffleExchangeExec
    ex = _stats_of(plan, ShuffleExchangeExecBase, 6)
    jex = _stats_of(ref[1].last_plan, CpuShuffleExchangeExec, 6)
    st, jst = ex.stage_stats(), jex.stage_stats()
    assert st.partition_rows == jst.partition_rows
    assert dict(ex._map_part_rows) == dict(jex._map_part_rows)
    hot = max(range(6), key=lambda p: st.partition_bytes[p])
    for want in (2, 3, 4, 8):
        assert ex.map_slices(hot, want) == jex.map_slices(hot, want)
    slices = ex.map_slices(hot, 4)
    assert len(slices) >= 2
    ids = [m for grp in slices for m in grp]
    assert len(ids) == len(set(ids)) and ids == sorted(ids)


def test_partial_reducer_spec_repr():
    spec = PartialReducerSpec(pid=7, slice_index=0, num_slices=5,
                              map_ids=(0, 1))
    jspec = jad.PartialReducerSpec(pid=7, slice_index=0, num_slices=5,
                                   map_ids=(0, 1))
    assert str(spec) == str(jspec) == "p7[1/5]"
    assert repr(spec) == repr(jspec)


def _skew_join(how):
    def build(s, f):
        lt = (s.create_dataframe(skewed_table()).repartition(8)
              .repartition(6, "k"))
        rt = (s.create_dataframe(dim_table()).repartition(4)
              .repartition(6, "k"))
        return lt.join(rt, "k", how=how)
    return build


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_skew_split_join_bit_identical(how):
    """The JAX side runs its CPU engine (see the module docstring); the
    port runs its device path and its CPU engine, both held to it."""
    conf = {**NO_BROADCAST, **SKEW}
    port, _ = assert_same_run(conf, _skew_join(how),
                              jax_conf={**conf, **JAX_CPU_ENGINE},
                              engine_names=DEVICE_NAMES)
    assert "skew-split" in port[1].last_plan.tree_string()
    assert_same_run({**conf, **JAX_CPU_ENGINE}, _skew_join(how))
    off = run_port(NO_BROADCAST, _skew_join(how))[0]
    assert_tables_equal(sort_all(off), sort_all(port[0]))


def test_skew_split_tag_and_metrics():
    conf = {**NO_BROADCAST, **SKEW}
    port, _ = assert_same_run(conf, _skew_join("inner"),
                              jax_conf={**conf, **JAX_CPU_ENGINE},
                              engine_names=DEVICE_NAMES)
    assert port[0].num_rows > 0
    plan = port[1].last_plan.tree_string()
    assert "[adaptive: skew-split p" in plan, plan
    assert port[2]["skew_splits"] >= 1
    readers = [n for n in walk(port[1].last_plan)
               if isinstance(n, CustomShuffleReaderExecBase)]
    partial = [n for n in readers
               if any(isinstance(e, PartialReducerSpec)
                      for spec in n.specs for e in spec)]
    assert partial, plan
    assert all(r.aligned_pairwise for r in partial)


def test_skew_split_disabled_by_conf():
    conf = {**NO_BROADCAST, **SKEW,
            "spark.rapids.tpu.sql.adaptive.skewSplit.enabled": "false"}
    port, _ = assert_same_run(conf, _skew_join("inner"),
                              jax_conf={**conf, **JAX_CPU_ENGINE},
                              engine_names=DEVICE_NAMES)
    assert "skew-split" not in port[1].last_plan.tree_string()


def test_legal_split_sides():
    for how in ("inner", "left", "left_semi", "left_anti", "right", "full",
                "cross"):
        assert legal_split_sides(how) == jad.legal_split_sides(how)
    assert legal_split_sides("inner") == [0, 1]
    assert legal_split_sides("left") == [0]


def _skewed_groupby(s, f):
    rng = np.random.default_rng(3)
    k = np.where(rng.random(4000) < 0.8, 0, rng.integers(1, 40, 4000))
    t = pa.table({"k": pa.array(k, type=pa.int64()),
                  "v": pa.array(np.arange(4000), type=pa.int64())})
    return (s.create_dataframe(t).repartition(8).repartition(6, "k")
            .groupBy("k").agg(f.count().alias("n"), f.sum("v").alias("sv"))
            .sort("k"))


def test_skewed_groupby_repartition():
    """Aggregates must not slice the reduce axis; they raise the grace
    fan-out instead. The JAX side runs its CPU engine (see the module
    docstring)."""
    port, _ = assert_same_run(SKEW, _skewed_groupby, ordered=True,
                              jax_conf={**SKEW, **JAX_CPU_ENGINE},
                              engine_names=DEVICE_NAMES)
    assert "skew-repartition" in port[1].last_plan.tree_string()
    assert port[2]["skew_splits"] >= 1
    assert_tables_equal(run_port({}, _skewed_groupby)[0], port[0])


def _refusion(s, f):
    return s.create_dataframe(t7()).repartition(6, "k").filter(
        f.col("v") > 10)


def test_refusion_creates_fused_stage():
    """A lone filter above a coalesced device reader is not a fusible
    chain at plan time; the coalesce above the reader makes one, which
    only the re-fusion pass sees. (The JAX package also checks that the
    stage compiled under a program-cache key of its own; the port runs
    eagerly and has no program cache.)"""
    port, _ = assert_same_run(AQE, _refusion)
    assert port[0].num_rows == 3000 - 11
    plan = port[1].last_plan.tree_string()
    assert "*(1)" in plan and "re-fused" in plan, plan
    assert port[2]["refused_stages"] >= 1
    off = {**AQE, "spark.rapids.tpu.sql.adaptive.refusion.enabled": "false"}
    port2, _ = assert_same_run(off, _refusion)
    assert "*(" not in port2[1].last_plan.tree_string()
    assert_tables_equal(port[0].sort_by("v"), port2[0].sort_by("v"))


def test_refusion_pipeline_matches_non_aqe():
    def build(s, f):
        return (s.create_dataframe(t7()).repartition(5, "k")
                .filter(f.col("v") > 100)
                .select("k", (f.col("v") * 2).alias("v2"))
                .groupBy("k").agg(f.sum("v2").alias("s")).sort("k"))
    port, _ = assert_same_run(AQE, build, ordered=True)
    assert_tables_equal(run_port({}, build)[0], port[0])


def test_reader_size_estimate_uses_observed_stats():
    t = pa.table({"k": pa.array(np.arange(20000) % 7, type=pa.int64()),
                  "v": pa.array(np.arange(20000), type=pa.int64())})

    def build(s, f):
        return (s.create_dataframe(t).filter(f.col("v") < 20)
                .repartition(4, "k").filter(f.col("v") >= 0))
    port, ref = assert_same_run(AQE, build)
    readers = [n for n in walk(port[1].last_plan)
               if isinstance(n, CustomShuffleReaderExecBase)]
    jreaders = [n for n in walk(ref[1].last_plan)
                if isinstance(n, jad.CustomShuffleReaderExecBase)]
    assert readers and jreaders
    r = readers[0]
    ex = [n for n in walk(r) if isinstance(n, ShuffleExchangeExecBase)][0]
    assert r.size_estimate() < ex.size_estimate() / 10
    assert r.size_estimate() == jreaders[0].size_estimate()
    plan = port[1].last_plan.tree_string()
    assert "rows=" in plan and "est~" in plan, plan


def test_grace_observed_fanout_bounds_recursion(monkeypatch):
    """Under a tiny budget the fan-out sized from observed input bytes
    never recurses deeper than the estimate-driven run, and both equal the
    JAX package's result bit for bit (integer aggregates)."""
    from spark_rapids_tpu_torch.memory import grace
    from spark_rapids_tpu_torch.plan import footprint as fp
    tiny = {"spark.rapids.tpu.memory.tpu.poolSizeBytes": str(256 << 10),
            "spark.rapids.tpu.memory.host.spillStorageSize": str(256 << 10),
            "spark.rapids.tpu.sql.scanCache.enabled": "false",
            "spark.rapids.tpu.sql.hasNans": "false"}
    rng = np.random.default_rng(0)
    t = pa.table({"k": rng.integers(0, 64, 40000).astype("int64"),
                  "v": rng.integers(0, 1000, 40000).astype("int64")})

    def build(s, f):
        return (s.create_dataframe(t).repartition(4, "k").groupBy("k")
                .agg(f.sum("v").alias("sv"), f.count(f.lit(1)).alias("c")))

    orig = fp.observed_input_bytes
    monkeypatch.setattr(fp, "observed_input_bytes",
                        lambda node, partition_id=None: None)
    grace.reset_counters()
    ref = run_port(tiny, build)[0]
    depth_est = grace.counters()["recursion_depth_peak"]
    assert depth_est >= 1
    fired = []

    def spy(node, partition_id=None):
        r = orig(node, partition_id)
        if r is not None:
            fired.append(r)
        return r

    monkeypatch.setattr(fp, "observed_input_bytes", spy)
    grace.reset_counters()
    got = run_port(tiny, build)[0]
    depth_obs = grace.counters()["recursion_depth_peak"]
    assert fired, "observed-statistics fan-out never engaged"
    assert depth_obs <= depth_est, (depth_obs, depth_est)
    assert_tables_equal(sort_all(ref), sort_all(got))
    want = run_jax(JAX_CPU_ENGINE, build)[0]
    assert_tables_equal(sort_all(want), sort_all(got))


COST = {"spark.rapids.tpu.sql.adaptive.costModel.enabled": "true"}


def test_cost_model_plan_time_placement():
    def small(s, f):
        return s.create_dataframe(t13(50)).filter(f.col("v") > 5)

    def large(s, f):
        return s.create_dataframe(t13(100000)).filter(f.col("v") > 5)
    port, ref = assert_same_run(COST, small, sort_key="v")
    assert "CpuFilterExec" in port[1].last_plan.tree_string()
    assert "CpuFilterExec" in ref[1].last_plan.tree_string()
    assert port[0].num_rows == 44
    out, s2, _ = run_port(COST, large)
    p2 = s2.last_plan.tree_string()
    assert "TpuFilterExec" in p2 or "*(" in p2, p2
    assert out.num_rows == 99994


def test_cost_model_off_by_default():
    def small(s, f):
        return s.create_dataframe(t13(50)).filter(f.col("v") > 5)
    port, _ = assert_same_run({}, small, sort_key="v")
    assert "CpuFilterExec" not in port[1].last_plan.tree_string()


def _cost_join(s, f):
    lt = (s.create_dataframe(t13(20000)).filter(f.col("v") < 20)
          .repartition(4, "k"))
    rt = (s.create_dataframe(t13(20000)).filter(f.col("v") < 10)
          .repartition(3, "k"))
    return lt.join(rt, "k")


def test_cost_model_aqe_observed_placement():
    """The estimates keep the join on the device at plan time; the
    observed exchange rows are tiny, so only the adaptive statistics move
    it to the CPU engine, with the static plan's result."""
    conf = {**COST, **AQE, **NO_BROADCAST,
            "spark.rapids.tpu.sql.adaptive.costModel.minDeviceRows": "1000"}
    port, _ = assert_same_run(conf, _cost_join)
    plan = port[1].last_plan.tree_string()
    assert "CpuHashJoinExec" in plan, plan
    assert "[adaptive: placement=cpu rows=" in plan, plan
    ref, s_ref, _ = run_port(NO_BROADCAST, _cost_join)
    assert "CpuHashJoinExec" not in s_ref.last_plan.tree_string()
    assert_tables_equal(sort_all(ref), sort_all(port[0]))


def test_adaptive_counters_in_session_metrics():
    port, _ = assert_same_run(AQE, _refusion)
    for key in ("skew_splits", "coalesced_partitions", "broadcast_switches",
                "refused_stages"):
        assert key in port[2], port[2]
    assert port[2]["coalesced_partitions"] >= 1


def test_adaptive_counters_in_query_handle():
    """The JAX package reads the counters on a serving QueryHandle; the
    port has no serving layer, so its collect's counters are held against
    the handle's."""
    def build(s, f):
        return _refusion(s, f).select("k")
    port = run_port(AQE, build)
    from spark_rapids_tpu.api import TpuSession as JaxSession
    jsess = JaxSession(AQE)
    h = jsess.submit(build(jsess, __import__(
        "spark_rapids_tpu.api.functions", fromlist=["col"])),
        label="adaptive-metrics")
    h.result(timeout=120)
    want = {k.split(".", 1)[1]: int(v)
            for k, v in h.exec_metrics["adaptive"].items()}
    assert port[2] == want
    assert port[2]["coalesced_partitions"] >= 1


def test_explain_coalesce_tag_format():
    port, _ = assert_same_run(AQE, _refusion)
    plan = port[1].last_plan.tree_string()
    assert "[adaptive: coalesced 6→" in plan, plan
    assert "rows=3000" in plan, plan


SLICE_KEYS = ["sql.adaptive.enabled",
              "sql.adaptive.advisoryPartitionSizeInBytes",
              "sql.adaptive.skewSplit.enabled",
              "sql.adaptive.skewedPartitionFactor",
              "sql.adaptive.skewedPartitionThreshold.bytes",
              "sql.adaptive.refusion.enabled",
              "sql.replaceSortMergeJoin.enabled"]


@pytest.mark.parametrize("key", SLICE_KEYS)
def test_conf_keys_match_reference(key):
    """The slice's keys carry the JAX package's names, types, defaults and
    checks: a value the reference refuses, the port refuses, naming the
    key."""
    from spark_rapids_tpu import config as jcfg
    from spark_rapids_tpu_torch import config as cfg
    full = f"spark.rapids.tpu.{key}"
    mine, ref = cfg._REGISTRY[full], jcfg._REGISTRY[full]
    assert (mine.conf_type, mine.default) == (ref.conf_type, ref.default)
    assert (mine.checker is None) == (ref.checker is None)
    if mine.checker is not None:
        with pytest.raises(ValueError, match=full.replace(".", r"\.")):
            cfg.TpuConf({full: "0"})
        with pytest.raises(ValueError):
            jcfg.TpuConf({full: "0"})


def test_union_of_branches_coalesced_apart():
    """A union runs both branches over the wider branch's partitions; when
    coalescing narrows one branch's reader, its missing partitions read
    nothing and the union equals the run without adaptive execution. The
    JAX package's reader raises IndexError on this plan (a fault of the
    reference the port guards; ROADMAP queue 3)."""
    conf = {**AQE, "spark.rapids.tpu.sql.adaptive."
                   "advisoryPartitionSizeInBytes": "1000"}

    def build(s, f):
        small = s.create_dataframe(table(100)).repartition(6, "b")
        large = s.create_dataframe(table(3000)).repartition(6, "b")
        return small.union(large)
    got, sess, counts = run_port(conf, build)
    readers = [n for n in walk(sess.last_plan)
               if isinstance(n, CustomShuffleReaderExecBase)]
    widths = sorted(r.num_partitions for r in readers)
    assert len(widths) == 2 and widths[0] < widths[1]
    assert sess.last_plan.num_partitions == widths[1]
    want = run_port({}, build)[0]
    assert_tables_equal(sort_all(want), sort_all(got))
    with pytest.raises(IndexError):
        run_jax(conf, build)
