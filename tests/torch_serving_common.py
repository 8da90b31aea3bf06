"""Shared by ``tests/test_torch_serving*.py``, ``test_torch_tracing.py`` and
``test_torch_fleet.py``: the same served queries built in both packages (the
JAX package on the CPU, the port with ``device="cpu"``) over the same seeded
pyarrow tables, and the fixtures that keep each test's device managers,
schedulers and torch threads its own."""
import gc
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.columnar.dtypes import DType as JaxDType
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

BASE_CONF = {
    "spark.rapids.tpu.sql.string.maxBytes": "16",
    "spark.rapids.tpu.serving.maxConcurrentQueries": "3",
    # float sums stay on the device engine in both packages
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true",
    # no background sampler thread: gauges sample at terminal queries
    "spark.rapids.tpu.serving.stats.sampleIntervalSeconds": "0",
}

#: each package's functions module, DType and device manager
PKGS = {"jax": (JF, JaxDType, JaxDeviceManager),
        "port": (PF, DType, DeviceManager)}

#: every wait in these tests is bounded by this many seconds
WAIT_S = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs (the run's workers share the
    CPUs); the sessions' reference cycles collected after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.collect()


@pytest.fixture
def sessions():
    """``make(pkg, extra_conf) -> session``; every session's scheduler is
    shut down and both device managers reset after the test."""
    made = []
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()

    def make(pkg, extra=None):
        conf = {**BASE_CONF, **(extra or {})}
        s = JaxSession(conf) if pkg == "jax" else TpuSession(conf,
                                                             device="cpu")
        made.append(s)
        return s
    yield make
    for s in made:
        if s._scheduler is not None:
            s._scheduler.shutdown(wait=True, timeout=WAIT_S)
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()


def small_table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 8, n).astype("int64"),
                     "v": rng.random(n)})


def dim_table(seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({"k": np.arange(8, dtype="int64"),
                     "w": rng.integers(0, 100, 8).astype("int64")})


def blocking_df(pkg, sess, started, release, n_rows=2):
    """A DataFrame whose row UDF sets ``started`` and then waits for
    ``release`` (bounded): the controllable slow query."""
    F, DT, _ = PKGS[pkg]

    def slow(x):
        started.set()
        release.wait(WAIT_S)
        return x
    df = sess.create_dataframe(pa.table({"a": list(range(n_rows))}))
    return df.select(F.udf(slow, DT.LONG)(F.col("a")).alias("b"))


def tag_df(pkg, sess, order, name):
    """A one-row query that appends ``name`` to ``order`` when it runs."""
    F, DT, _ = PKGS[pkg]

    def tag(x):
        order.append(name)
        return x
    df = sess.create_dataframe(pa.table({"a": [1]}))
    return df.select(F.udf(tag, DT.LONG)(F.col("a")).alias("b"))


def as_arrow(result):
    """A served result as an arrow table (the port's is a HostBatch)."""
    return result.to_arrow() if hasattr(result, "to_arrow") else result


def wait_until(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def manager(pkg, sess):
    """The package's device manager for ``sess``'s conf."""
    dm = PKGS[pkg][2]
    return (dm.initialize(sess.conf) if pkg == "jax"
            else dm.initialize(sess.conf, sess.device))


def no_leaks(pkg, sess):
    """After a query ended however: no semaphore holder or waiter, and no
    buffer left in the catalog."""
    dm = manager(pkg, sess)
    wait_until(lambda: dm.semaphore.active_holders == 0)
    assert dm.semaphore.waiting == 0
    assert list(dm.catalog.ids()) == []


__all__ = ["BASE_CONF", "PKGS", "WAIT_S", "one_torch_thread", "sessions",
           "small_table", "dim_table", "blocking_df", "tag_df", "as_arrow",
           "wait_until", "manager", "no_leaks", "threading"]
