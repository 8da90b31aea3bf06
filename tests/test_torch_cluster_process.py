"""Two OS-process executors of the port (``sql.cluster.processExecutors``)
on the CPU: each daemon is ``python -m
spark_rapids_tpu_torch.parallel.executor_daemon``, opens the session's
device (here ``cpu``), serves tasks over its control socket and moves
shuffle data to the other over TCP. The two daemons start once for the
module: every test's session runs on the same scheduler. TPC-H Q3, a
broadcast join and a cached scan each equal the JAX package's cluster
result, both daemons do map work, and neither daemon loads jax or the JAX
package."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.parallel.cluster import (ClusterScheduler,
                                                     ProcessExecutor)
from tests.torch_cluster_common import CPU, one_torch_thread  # noqa: F401

PROCESS_CONF = {
    "spark.rapids.tpu.sql.cluster.numExecutors": "2",
    "spark.rapids.tpu.sql.cluster.processExecutors": "true",
}


@pytest.fixture(scope="module")
def daemons():
    """One scheduler and its two daemons for the whole module."""
    sched = ClusterScheduler(TpuConf(PROCESS_CONF), CPU)
    try:
        yield sched
    finally:
        sched.close()
        for ex in sched.executors:
            assert ex.proc.poll() is not None


def on_daemons(conf, sched):
    """A CPU session whose actions run on the module's daemons."""
    s = TpuSession({**PROCESS_CONF, **conf}, device="cpu")
    s._cluster_scheduler = sched
    return s


def jax_cluster(conf, build):
    """The JAX package's cluster result (two in-process executors)."""
    s = JaxSession({**conf, "spark.rapids.tpu.sql.cluster.numExecutors": "2"})
    try:
        return build(s).collect()
    finally:
        s._cluster_scheduler.close()


def map_executors(sched):
    return {st.executor_id for stage in sched.last_stages
            for st in stage.statuses}


def test_daemons_run_on_the_session_device_without_jax(daemons):
    for ex in daemons.executors:
        assert isinstance(ex, ProcessExecutor)
        pong = ex.probe()
        assert pong["type"] == "pong" and not pong["killed"]
        assert ex.device == pong["device"] == "cpu"
        loaded = set(pong["packages"])
        assert "spark_rapids_tpu_torch" in loaded and "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "spark_rapids_tpu"}, loaded


def test_tpch_q3_across_two_processes(daemons):
    from spark_rapids_tpu.benchmarks import tpch_queries as jq
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_data import gen_all
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    tables = gen_all(0.002, seed=7)
    conf = {**BENCH_CONF,
            "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"}
    s = on_daemons(conf, daemons)
    out = QUERIES[3]({k: s.create_dataframe(v).repartition(2)
                      for k, v in tables.items()}).collect().to_arrow()
    assert map_executors(daemons) == {"exec-0", "exec-1"}
    assert all(st.statuses for st in daemons.last_stages
               if not st.is_result and not st.is_broadcast)
    want = jax_cluster(conf, lambda js: jq.QUERIES[3](
        {k: js.create_dataframe(v.to_arrow()).repartition(2)
         for k, v in tables.items()}))
    assert_tables_equal(want, out, ignore_order=True, approx_float=1e-9)
    # the daemons' splits took the reorder's plain version (CPU tensors):
    # their ping counts kernel launches only, and no peak off the card
    for ex in daemons.executors:
        pong = ex.probe(reset_peak=True)
        assert (pong["reorder_launches"], pong["reorder_kept"],
                pong["compact_launches"], pong["peak_bytes"]) == (0, 0, 0, 0)


def _fact_dim(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    fact = pa.table({"k": rng.integers(0, 400, n).astype(np.int64),
                     "v": rng.integers(-100, 100, n).astype(np.int64),
                     "s": pa.array([f"s{int(x)}"
                                    for x in rng.integers(0, 40, n)])})
    dim = pa.table({"k": np.arange(400, dtype=np.int64),
                    "name": pa.array([f"n{i}" for i in range(400)])})
    return fact, dim


def test_broadcast_join_across_two_processes(daemons):
    """The default threshold broadcasts the dimension: the driver builds it
    once and pushes its bytes to each daemon."""
    fact, dim = _fact_dim(3)

    def build(f):
        return lambda s: (s.create_dataframe(fact).repartition(4, "k")
                          .join(s.create_dataframe(dim), "k")
                          .groupBy("name").agg(f.sum("v").alias("sv"))
                          .sort("name"))
    out = build(F)(on_daemons({}, daemons)).collect().to_arrow()
    assert any(st.is_broadcast for st in daemons.last_stages)
    assert map_executors(daemons) == {"exec-0", "exec-1"}
    assert_tables_equal(jax_cluster({}, build(JF)), out)


def test_cached_scan_ships_once_per_daemon(daemons, monkeypatch):
    """A cached DataFrame's partitions ship once to each daemon and serve
    from its own catalog; a second action does not ship them again, and
    unpersist drops them everywhere."""
    fact, _ = _fact_dim(22)
    pushes = []
    orig = ProcessExecutor.put_cache

    def spy(self, tid, gen, parts):
        pushes.append((self.executor_id, tid, gen))
        orig(self, tid, gen, parts)
    monkeypatch.setattr(ProcessExecutor, "put_cache", spy)
    s = on_daemons({}, daemons)
    cached = s.create_dataframe(fact).cache()

    def q(df, f):
        return (df.repartition(4, "k").groupBy("k")
                .agg(f.sum("v").alias("sv"), f.count("s").alias("c"))
                .sort("k"))
    first = q(cached, F).collect().to_arrow()
    assert len(pushes) == 2, pushes
    second = q(cached, F).collect().to_arrow()
    assert len(pushes) == 2, pushes
    assert map_executors(daemons) == {"exec-0", "exec-1"}
    want = jax_cluster({}, lambda js: q(js.create_dataframe(fact).cache(),
                                        JF))
    assert_tables_equal(want, first)
    assert_tables_equal(want, second)
    cached.unpersist()
    assert not daemons._shipped_caches


def test_cuda_daemon_without_a_gpu_fails_its_start():
    """A daemon asked for cuda on a host without a GPU refuses to start; it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="failed to start"):
        ProcessExecutor("exec-cuda", TpuConf(PROCESS_CONF),
                        torch.device("cuda"))
