"""The in-process cases of tests/test_cluster.py on the port (the others
are in ``tests/test_torch_cluster_ship.py``): multi-executor
execution over the shuffle-manager stack (stages cut at the exchanges, map
tasks writing through the caching writer into per-executor catalogs,
reducers reading local blocks and fetching remote ones over the in-process
fabric or TCP). Each query is held against the JAX package's cluster run
of it (exact columns bit for bit, variableFloatAgg sums within 1e-9) and
against the port's single-process run, and each test asserts that the
cluster ran it: every map stage registered its statuses, map work landed
on every executor, and no fallback ran."""
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.parallel import cluster as cl
from tests.torch_cluster_common import (  # noqa: F401
    CLUSTER_CONF, assert_cluster_ran, fresh_fabrics,
    fact_dim, fact_dim_query, one_torch_thread, port_session, run_both,
    transport)


@pytest.mark.parametrize("wire", ["inprocess", "tcp"])
def test_query_matches_reference_cluster_and_single_process(tmp_path, wire):
    fact, dim = fact_dim(seed=11 if wire == "tcp" else 5)

    def conf(pkg):
        c = dict(CLUSTER_CONF)
        if wire == "tcp":
            c["spark.rapids.tpu.shuffle.transport.class"] = transport(pkg,
                                                                      "tcp")
            c["spark.rapids.tpu.shuffle.tcp.registryDir"] = str(
                tmp_path / f"{pkg}-reg")
        return c
    got, want, single, shape, jax_shape = run_both(
        conf("port"), lambda s: fact_dim_query(s, F, fact, dim),
        lambda s: fact_dim_query(s, JF, fact, dim), jax_conf=conf("jax"))
    assert_tables_equal(want, got)
    assert_tables_equal(single, got)
    assert shape == jax_shape
    assert len(shape) >= 3         # repartition, the join's exchange, result


def test_round_robin_and_single_exchanges():
    rng = np.random.default_rng(19)
    t = pa.table({"a": rng.integers(0, 50, 5000).astype(np.int32),
                  "b": rng.standard_normal(5000)})
    conf = {**CLUSTER_CONF,
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}

    def build(f):
        return lambda s: (s.create_dataframe(t).repartition(5)
                          .groupBy("a").agg(f.avg("b").alias("ab")).sort("a"))
    got, want, single, shape, jax_shape = run_both(conf, build(F), build(JF))
    assert_tables_equal(want, got, approx_float=1e-9)
    assert_tables_equal(single, got, approx_float=1e-9)
    assert shape == jax_shape


def test_file_scan_spreads_tasks(tmp_path):
    """Multi-file scans widen to several scan tasks spread across the
    executors, so the map stage fans out."""
    rng = np.random.default_rng(23)
    for i in range(6):
        pq.write_table(
            pa.table({"k": rng.integers(0, 90, 800).astype(np.int64),
                      "v": rng.integers(0, 10, 800).astype(np.int64)}),
            str(tmp_path / f"f{i}.parquet"))

    def build(f):
        return lambda s: (s.read.parquet(str(tmp_path)).repartition(4, "k")
                          .groupBy("k").agg(f.sum("v").alias("sv")).sort("k"))
    got, want, single, shape, jax_shape = run_both(CLUSTER_CONF, build(F),
                                                   build(JF))
    assert_tables_equal(want, got)
    assert_tables_equal(single, got)
    assert shape == jax_shape
    assert shape[0][2] > 1, "the scan stage should fan out"


def test_range_exchange_sort_order():
    """A global sort through the cluster: the range stage runs one task
    (the global sample) and the output comes back in partition order."""
    rng = np.random.default_rng(29)
    t = pa.table({"v": rng.integers(-10000, 10000, 8000).astype(np.int64),
                  "s": pa.array([f"x{i % 97}" for i in range(8000)])})

    def build(s):
        return s.create_dataframe(t).repartition(4).sort("v", "s")
    got, want, single, shape, jax_shape = run_both(CLUSTER_CONF, build,
                                                   build)
    assert_tables_equal(want, got)       # exact order
    assert_tables_equal(single, got)
    assert shape == jax_shape


def test_aqe_coalesces_skewed_reduce_tasks():
    """Adaptive coalescing on the cluster path: a skewed shuffle whose
    observed MapStatus sizes show mostly tiny reduce partitions runs fewer
    reduce tasks than partitions, as many as the JAX package's."""
    rng = np.random.default_rng(31)
    n = 30000
    k = np.where(rng.random(n) < 0.95, 7,
                 rng.integers(0, 4000, n)).astype(np.int64)
    t = pa.table({"k": k, "v": rng.integers(-50, 50, n).astype(np.int64)})
    conf = {**CLUSTER_CONF,
            "spark.rapids.tpu.sql.adaptive.enabled": "true",
            "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes":
            "65536"}

    def build(f):
        return lambda s: (s.create_dataframe(t).repartition(16, "k")
                          .groupBy("k").agg(f.sum("v").alias("sv"),
                                            f.count("v").alias("c"))
                          .sort("k"))
    got, want, single, shape, jax_shape = run_both(conf, build(F), build(JF))
    assert_tables_equal(want, got)
    assert_tables_equal(single, got)
    assert shape == jax_shape
    assert 1 <= shape[1][2] < 16, shape


def test_task_slots_run_concurrently(monkeypatch):
    """With one executor and taskSlots 4, a stage's tasks overlap in time
    inside the executor."""
    active = {"now": 0, "peak": 0}
    lock = threading.Lock()
    orig = cl._run_task

    def traced(env, spec):
        with lock:
            active["now"] += 1
            active["peak"] = max(active["peak"], active["now"])
        try:
            time.sleep(0.05)      # widen the overlap window
            return orig(env, spec)
        finally:
            with lock:
                active["now"] -= 1

    rng = np.random.default_rng(37)
    t = pa.table({"k": rng.integers(0, 500, 20000).astype(np.int64),
                  "v": rng.integers(0, 100, 20000).astype(np.int64)})
    conf = {"spark.rapids.tpu.sql.cluster.numExecutors": "1",
            "spark.rapids.tpu.sql.cluster.taskSlots": "4"}
    s = port_session(conf)
    monkeypatch.setattr(cl, "_run_task", traced)
    try:
        out = (s.create_dataframe(t).repartition(8, "k")
               .groupBy("k").agg(F.sum("v").alias("sv")).sort("k")).collect()
        assert_cluster_ran(s, n_executors=1)
    finally:
        s._cluster_scheduler.close()
    monkeypatch.setattr(cl, "_run_task", orig)
    single = (port_session({}).create_dataframe(t).repartition(8, "k")
              .groupBy("k").agg(F.sum("v").alias("sv")).sort("k")).collect()
    assert_tables_equal(single.to_arrow(), out.to_arrow())
    assert active["peak"] >= 2, active
