"""More in-process cases of tests/test_cluster.py on the port, beside
``tests/test_torch_cluster.py``: a broadcast built once and shipped to
the executors, a cached scan riding the stages, stage plans that carry no
tensor, the scheduler kept per session and the single-process engine for
a plan with a CPU exchange, and the widened scan's exchange (ROADMAP queue
3 item 12). Each query is held against the JAX package's cluster run and
the port's single-process run, and each test asserts that the cluster
ran it."""
import pickle
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.parallel import cluster as cl
from tests.torch_cluster_common import (  # noqa: F401
    CLUSTER_CONF, assert_cluster_ran, fresh_fabrics,
    fact_dim, fact_dim_query, one_torch_thread, port_session, run_both)


def test_broadcast_built_once_per_executor(monkeypatch):
    """A broadcast exchange becomes a driver-built stage: its build side
    runs once, and the executors unpack the shipped bytes once."""
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuBroadcastExchangeExec
    from spark_rapids_tpu_torch.parallel.broadcast import BroadcastManager
    fact, dim = fact_dim(seed=3)
    conf = {"spark.rapids.tpu.sql.cluster.numExecutors": "2"}

    def build(f):
        return lambda s: (s.create_dataframe(fact).repartition(4, "k")
                          .join(s.create_dataframe(dim), "k")
                          .groupBy("name").agg(f.sum("v").alias("sv"))
                          .sort("name"))
    builds = []
    orig_exec = TpuBroadcastExchangeExec.execute

    def counted(self, ctx):
        builds.append(id(self))
        return orig_exec(self, ctx)
    counts = {}
    orig_remove = BroadcastManager.remove.__func__

    def spy_remove(cls, bid):
        counts[bid] = cls.deserialize_count(bid)
        orig_remove(cls, bid)
    monkeypatch.setattr(TpuBroadcastExchangeExec, "execute", counted)
    monkeypatch.setattr(BroadcastManager, "remove", classmethod(spy_remove))
    got, want, single, shape, jax_shape = run_both(conf, build(F), build(JF))
    assert_tables_equal(want, got)
    assert_tables_equal(single, got)
    assert shape == jax_shape
    assert sum(1 for r, b, _ in shape if b) == 1
    # the cluster run executed the broadcast once, on the driver (executor
    # tasks read the shipped bytes); the single-process run's exchange, a
    # node of its own, follows
    assert builds.count(builds[0]) == 1, builds
    # in-process executors share the driver's registry: one unpack for the
    # four map tasks
    assert counts and all(v == 1 for v in counts.values()), counts


def test_cached_scan_rides_the_stages():
    """df.cache() plans stage and serve from the (shared, in-process)
    catalog instead of falling back."""
    from spark_rapids_tpu_torch.execs.cache_execs import TpuCachedScanExec
    fact, _ = fact_dim(seed=21)
    conf = {"spark.rapids.tpu.sql.cluster.numExecutors": "2"}
    s = port_session(conf)
    cached = s.create_dataframe(fact).cache()
    try:
        out = (cached.repartition(4, "k").groupBy("k")
               .agg(F.sum("v").alias("sv")).sort("k")).collect()
        sched = assert_cluster_ran(s)
        assert any(isinstance(n, TpuCachedScanExec)
                   for st in sched.last_stages for n in st.root.walk())
        # a second action reuses the cached buffers
        again = (cached.repartition(4, "k").groupBy("k")
                 .agg(F.sum("v").alias("sv")).sort("k")).collect()
        cached.unpersist()
        assert not sched._shipped_caches
    finally:
        s._cluster_scheduler.close()
    jax = JaxSession(conf)
    try:
        want = (jax.create_dataframe(fact).cache().repartition(4, "k")
                .groupBy("k").agg(JF.sum("v").alias("sv")).sort("k")
                .collect())
    finally:
        jax._cluster_scheduler.close()
    assert_tables_equal(want, out.to_arrow())
    assert_tables_equal(want, again.to_arrow())


def test_stage_plans_ship_no_tensor(monkeypatch):
    """What the driver pickles for its executors (every stage's plan, and
    the statuses and results the tasks send back) holds host data only:
    no torch.Tensor is pickled along, for the test queries, a broadcast,
    a cached scan and TPC-H Q3."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    seen = []

    class Recording(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor):
                seen.append((tuple(obj.shape), obj.dtype))
            return NotImplemented

    def dumps(obj):
        import io
        buf = io.BytesIO()
        Recording(buf).dump(obj)
        return buf.getvalue()

    monkeypatch.setattr(cl, "pickle", types.SimpleNamespace(
        loads=pickle.loads, dumps=dumps))
    fact, dim = fact_dim(seed=7)
    runs = [
        (CLUSTER_CONF, lambda s: fact_dim_query(s, F, fact, dim)),
        ({"spark.rapids.tpu.sql.cluster.numExecutors": "2"},
         lambda s: (s.create_dataframe(fact).repartition(4, "k")
                    .join(s.create_dataframe(dim), "k").groupBy("name")
                    .agg(F.sum("v").alias("sv")))),
        ({"spark.rapids.tpu.sql.cluster.numExecutors": "2"},
         lambda s: (s.create_dataframe(fact).cache().repartition(4, "k")
                    .groupBy("k").agg(F.count("v").alias("c")))),
        ({**BENCH_CONF, **CLUSTER_CONF},
         lambda s: q3({k: s.create_dataframe(g(0.002, 7)).repartition(2)
                       for k, g in (("customer", td.gen_customer),
                                    ("orders", td.gen_orders),
                                    ("lineitem", td.gen_lineitem_full))})),
    ]
    for conf, build in runs:
        s = port_session(conf)
        try:
            build(s).collect()
            sched = assert_cluster_ran(s)
            # the driver-side stage roots after the run, too (a broadcast
            # stage's root was executed by the driver)
            for st in sched.last_stages:
                dumps(st.root)
        finally:
            s._cluster_scheduler.close()
    assert seen == []


def test_session_reuses_its_scheduler_and_falls_back_on_cpu_exchanges():
    """One scheduler per session across actions; a plan with a CPU
    exchange (sql.enabled false) is not staged and runs single-process,
    as in the JAX package."""
    fact, dim = fact_dim(seed=9)
    s = port_session(CLUSTER_CONF)
    try:
        a = fact_dim_query(s, F, fact, dim).collect()
        sched = s._cluster_scheduler
        b = fact_dim_query(s, F, fact, dim).collect()
        assert s._cluster_scheduler is sched
        assert_tables_equal(a.to_arrow(), b.to_arrow())
    finally:
        s._cluster_scheduler.close()
    cpu = port_session({**CLUSTER_CONF, "spark.rapids.tpu.sql.enabled":
                        "false"})
    try:
        c = fact_dim_query(cpu, F, fact, dim).collect()
        assert getattr(cpu._cluster_scheduler, "last_stages", None) is None
        # the single-process engine ran: its record has the per-exec and
        # transfer sections, the cluster path's only the shuffle section
        assert "transfer" in cpu.last_metrics
    finally:
        cpu._cluster_scheduler.close()
    assert_tables_equal(a.to_arrow(), c.to_arrow())


def test_widened_scan_under_an_aggregate_gets_its_exchange(tmp_path):
    """ROADMAP queue 3 item 12: a multi-file scan straight under an
    aggregate (no exchange between: the plan was made for one scan
    partition) is widened by the cluster. The port gives the aggregate the
    single-partition exchange the planner gives a partitioned child, so
    the scan still fans out and the result equals the single-process
    run's; the JAX package aggregates each scan partition apart and
    returns a group once per partition."""
    rng = np.random.default_rng(41)
    for i in range(6):
        pq.write_table(
            pa.table({"k": rng.integers(0, 7, 500).astype(np.int64),
                      "v": rng.integers(0, 10, 500).astype(np.int64)}),
            str(tmp_path / f"f{i}.parquet"))
    conf = {"spark.rapids.tpu.sql.cluster.numExecutors": "2"}

    def build(f):
        return lambda s: (s.read.parquet(str(tmp_path)).groupBy("k")
                          .agg(f.sum("v").alias("sv")).sort("k"))
    got, want, single, shape, jax_shape = run_both(conf, build(F), build(JF))
    assert_tables_equal(single, got)
    assert got.num_rows == 7
    assert shape[0] == (False, False, 4), shape   # the scan fans out
    assert want.num_rows > got.num_rows, want      # the reference's fault
    assert jax_shape == [(True, False, 4)]


def test_pickle_drops_process_state_and_copy_keeps_it():
    """An exchange, a broadcast and a cached entry drop their lock and run
    state in a pickle (what a stage plan ships) and keep them in
    ``copy.copy`` (the plan rewrites' ``with_children``, which must not
    run an executed map side again)."""
    import copy

    from spark_rapids_tpu_torch.execs.exchange_execs import (
        TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.memory.df_cache import CachedData
    fact, dim = fact_dim(seed=2)
    s = port_session({"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
                      "100000000"})
    s.create_dataframe(fact).repartition(4, "k").join(
        s.create_dataframe(dim), "k").collect()
    ex = next(n for n in s.last_plan.walk()
              if isinstance(n, TpuShuffleExchangeExec))
    bc = next(n for n in s.last_plan.walk()
              if isinstance(n, TpuBroadcastExchangeExec))
    assert ex._map_done and ex._part_rows
    kept = copy.copy(ex)
    assert kept._map_done and kept._part_rows == ex._part_rows
    assert kept._shuffle_id == ex._shuffle_id
    fresh = pickle.loads(pickle.dumps(ex))
    assert not fresh._map_done and fresh._part_rows == {}
    assert fresh._shuffle_id is None and fresh.range_bounds is None
    with fresh._lock:
        pass
    bc._cached = [1, 2, 3]
    assert copy.copy(bc)._cached is bc._cached
    assert pickle.loads(pickle.dumps(bc))._cached is None
    bc._cached = None
    e = CachedData(s.create_dataframe(dim)._plan)
    assert copy.copy(e).lock is e.lock and copy.copy(e).logical is e.logical
    back = pickle.loads(pickle.dumps(e))
    assert back.logical is None and back.table_id == e.table_id
    with back.lock:
        pass
