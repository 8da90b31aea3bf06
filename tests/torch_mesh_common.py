"""Shared by ``tests/test_torch_mesh*.py`` and ``test_torch_tpch_mesh*.py``:
the mesh confs of both packages, the port's 8-shard CPU mesh, and the
plan checks every mesh case makes (the ``Mesh*`` operators in tree order,
every shard tensor on the session's device kind, no host hop)."""
import gc

import pytest
import torch

from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

#: the JAX package's mesh (its 8 forced host devices, tests/conftest.py)
JAX_MESH = {
    "spark.rapids.tpu.sql.mesh.enabled": "true",
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true",
}
#: the port's mesh: 8 shards on the one CPU device
PORT_MESH = {**JAX_MESH, "spark.rapids.tpu.sql.mesh.numDevices": "8"}

#: tests/test_tpch_mesh.py's conf: the benchmark conf, the nested-loop
#: joins on, adaptive execution riding the mesh
SUITE_MESH = {
    **BENCH_CONF,
    "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
    "spark.rapids.tpu.sql.exec.CartesianProduct": "true",
    "spark.rapids.tpu.sql.adaptive.enabled": "true",
}

CPU = torch.device("cpu")


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
def fresh_device_managers():
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()
    yield
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()


def mesh_names(plan) -> list:
    """The plan's Mesh* operator class names in tree (pre-)order."""
    out = []

    def walk(node):
        if type(node).__name__.startswith("Mesh"):
            out.append(type(node).__name__)
        for c in node.children:
            walk(c)
    walk(plan)
    return out


def port_session(conf=None, device="cpu"):
    from spark_rapids_tpu_torch.api import TpuSession
    return TpuSession({**PORT_MESH, **(conf or {})}, device=device)


def jax_session(conf=None):
    from spark_rapids_tpu.api import TpuSession as JaxSession
    return JaxSession({**JAX_MESH, **(conf or {})})


def mesh_run(build, conf=None, device="cpu", on_mesh=True):
    """``build(session)`` collected on the port's mesh -> (arrow result,
    session), after the checks every mesh run makes: the plan holds mesh
    operators (unless ``on_mesh`` is False: a plan the rewrite rightly
    leaves on one device), no host hop, and every shard tensor of every
    mesh batch lies on the session's device kind."""
    from spark_rapids_tpu_torch.execs import mesh_execs as me
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    sess = port_session(conf, device)
    mbm.reset_counters()
    out = build(sess).collect()
    seen = mbm.counters()
    assert bool(mesh_names(sess.last_plan)) == on_mesh, \
        sess.last_plan.tree_string()
    assert seen["host_hop_bytes"] == 0, seen
    assert set(seen["shard_device_kinds"]) <= {sess.device.type}, seen
    return out.to_arrow(), sess
