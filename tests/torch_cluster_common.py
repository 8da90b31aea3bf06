"""Shared by ``tests/test_torch_shuffle_*.py`` and
``tests/test_torch_cluster*.py``: the same shuffle driven through both
packages (the JAX package's ShuffleEnv on the CPU, the port's with
``device="cpu"``), the inputs both write, and the fixtures that keep each
test's fabric, device managers and torch threads its own."""
import gc
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxDeviceBatch
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu.shuffle import manager as jm
from spark_rapids_tpu.shuffle.inprocess import _Fabric as JaxFabric
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import download, upload
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.shuffle import manager as pm
from spark_rapids_tpu_torch.shuffle.inprocess import _Fabric

CPU = torch.device("cpu")

#: the module prefix of each package's transports
PKG = {"jax": "spark_rapids_tpu", "port": "spark_rapids_tpu_torch"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs (the test run's workers share
    the CPUs); the sessions' reference cycles collected after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.collect()


@pytest.fixture(autouse=True)
def fresh_fabrics():
    """Each test's in-process fabrics (one per package) and device managers
    start empty and are torn down after it."""
    _Fabric.reset()
    JaxFabric.reset()
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()
    yield
    _Fabric.reset()
    JaxFabric.reset()
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()


def sample_table(n=100, seed=0):
    """tests/test_shuffle.py's table: nullable ints, unique normal floats
    (they align rows when sorted), strings with nulls, booleans."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, n)
    mask = rng.random(n) < 0.1
    ints = pa.array([None if m else int(v) for v, m in zip(vals, mask)],
                    pa.int64())
    floats = pa.array(rng.normal(size=n), pa.float64())
    strs = pa.array([None if i % 13 == 0 else f"row-{i}" for i in range(n)],
                    pa.string())
    flags = pa.array([bool(i % 2) for i in range(n)], pa.bool_())
    return pa.table({"i": ints, "f": floats, "s": strs, "b": flags})


def conf_of(pkg: str, values: dict):
    return (JaxConf if pkg == "jax" else TpuConf)(values)


def transport(pkg: str, name: str) -> str:
    """A transport class of ``pkg``: inprocess, tcp or faults."""
    cls = {"inprocess": "inprocess.InProcessTransport",
           "tcp": "tcp.TcpTransport",
           "faults": "faults.FaultInjectingTransport"}[name]
    return f"{PKG[pkg]}.shuffle.{cls}"


def make_env(pkg: str, executor_id: str, conf, disk_dir: str):
    if pkg == "jax":
        return jm.ShuffleEnv(executor_id, conf, disk_dir=disk_dir)
    return pm.ShuffleEnv(executor_id, conf, disk_dir=disk_dir, device=CPU)


def manager(pkg: str):
    return (jm if pkg == "jax" else pm).ShuffleManager()


def cluster(pkg: str, tmp_path, values: dict, n: int = 2, tag: str = ""):
    """(ShuffleManager, env 0, ..., env n-1) of ``pkg`` over ``values``."""
    conf = conf_of(pkg, values)
    envs = [make_env(pkg, f"exec-{i}", conf,
                     str(tmp_path / f"{pkg}{tag}-e{i}")) for i in range(n)]
    return (manager(pkg), *envs)


def two_env_values(pkg: str, codec="none", extra=None) -> dict:
    """tests/test_shuffle.py's ``two_env_cluster`` conf: small bounce
    buffers, so transfers walk the pool in chunks."""
    return {"spark.rapids.tpu.shuffle.compression.codec": codec,
            "spark.rapids.tpu.shuffle.bounceBuffers.size": 4096,
            "spark.rapids.tpu.shuffle.bounceBuffers.count": 8,
            **(extra or {})}


def fault_values(pkg: str, plan="", seed=7, extra=None) -> dict:
    """tests/test_shuffle_faults.py's ``fault_cluster`` conf, the fault
    wrapper around the package's in-process fabric."""
    return {"spark.rapids.tpu.shuffle.transport.class":
            transport(pkg, "faults"),
            "spark.rapids.tpu.shuffle.faults.transport.class":
            transport(pkg, "inprocess"),
            "spark.rapids.tpu.shuffle.faults.plan": plan,
            "spark.rapids.tpu.shuffle.faults.seed": seed,
            "spark.rapids.tpu.shuffle.bounceBuffers.size": 1024,
            "spark.rapids.tpu.shuffle.bounceBuffers.count": 16,
            "spark.rapids.tpu.shuffle.retryBackoffMs": 5,
            "spark.rapids.tpu.shuffle.compression.codec":
            os.environ.get("SHUFFLE_FAULTS_CODEC", "none"),
            **(extra or {})}


def device_batch(pkg: str, table: pa.Table):
    if pkg == "jax":
        return JaxDeviceBatch.from_arrow(table)
    return upload(HostBatch.from_arrow(table), CPU)


def to_arrow(pkg: str, batch) -> pa.Table:
    return batch.to_arrow() if pkg == "jax" else download(batch).to_arrow()


def write_partitioned(pkg, mgr, env, shuffle_id, map_id, table, num_parts):
    """Row i of ``table`` goes to partition i % num_parts."""
    writer = mgr.get_writer(env, shuffle_id, map_id, num_parts)
    parts = []
    n = table.num_rows
    for p in range(num_parts):
        sub = table.take(list(range(p, n, num_parts)))
        parts.append((p, device_batch(pkg, sub)))
    return writer.write(parts)


def collect_partition(pkg, mgr, env, shuffle_id, pid):
    rows = [to_arrow(pkg, b)
            for b in mgr.get_reader(env, shuffle_id, pid).read()]
    return pa.concat_tables(rows) if rows else None


def same_rows(a: pa.Table, b: pa.Table, key: str = "f") -> bool:
    """Equal rows in any order ("f" is unique per row)."""
    return a.sort_by(key).equals(b.sort_by(key))


# ---------------------------------------------------------------- cluster runs
CLUSTER_CONF = {
    "spark.rapids.tpu.sql.cluster.numExecutors": "2",
    "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1",
}


def fact_dim(seed=5):
    rng = np.random.default_rng(seed)
    n = 20000
    fact = pa.table({
        "k": rng.integers(0, 400, n).astype(np.int64),
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "s": pa.array([f"s{int(x)}" for x in rng.integers(0, 40, n)]),
    })
    dim = pa.table({
        "k": np.arange(400, dtype=np.int64),
        "name": pa.array([f"n{i}" for i in range(400)]),
    })
    return fact, dim


def fact_dim_query(s, f, fact, dim):
    return (s.create_dataframe(fact).repartition(4, "k")
            .groupBy("k").agg(f.sum("v").alias("sv"), f.count("s").alias("c"))
            .join(s.create_dataframe(dim), "k")
            .filter(f.col("sv") > -500)
            .sort("sv", "k"))


def port_session(conf):
    return TpuSession(conf, device="cpu")


def stage_shape(sched):
    """Stage count, kinds and tasks per stage."""
    return [(st.is_result, st.is_broadcast, st.num_tasks)
            for st in sched.last_stages]


def assert_cluster_ran(sess, n_executors=2):
    """The stage scheduler ran the action: the result stage produced it,
    every map stage registered one status per task, and a map stage of at
    least as many tasks as executors spread over every executor (no
    fallback to the single-process engine)."""
    sched = sess._cluster_scheduler
    stages = sched.last_stages
    assert stages and stages[-1].is_result
    assert "shuffle" in sess.last_metrics
    maps = [st for st in stages if not st.is_result and not st.is_broadcast]
    assert maps
    for st in maps:
        assert len(st.statuses) == st.num_tasks >= 1, st
    if any(st.num_tasks >= n_executors for st in maps):
        execs = {s.executor_id for st in maps for s in st.statuses}
        assert execs == {f"exec-{i}" for i in range(n_executors)}, execs
    return sched


def run_both(conf, build_port, build_jax, jax_conf=None):
    """(port cluster result, JAX cluster result, port single-process
    result, port stage shape, JAX stage shape)."""
    jax = JaxSession(jax_conf or conf)
    try:
        want = build_jax(jax).collect()
        jax_shape = stage_shape(jax._cluster_scheduler)
    finally:
        jax._cluster_scheduler.close()
    port = port_session(conf)
    try:
        got = build_port(port).collect().to_arrow()
        assert_cluster_ran(port)
        shape = stage_shape(port._cluster_scheduler)
    finally:
        port._cluster_scheduler.close()
    single_conf = {k: v for k, v in conf.items()
                   if "cluster" not in k and "shuffle.transport" not in k
                   and "tcp" not in k}
    single = build_port(port_session(single_conf)).collect().to_arrow()
    return got, want, single, shape, jax_shape
