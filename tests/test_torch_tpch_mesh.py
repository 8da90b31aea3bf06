"""TPC-H on the PyTorch port's mesh (8 CPU shards).

TPC-H Q1, Q3 (with the broadcast threshold at 1 byte, so its joins are
shuffled over the mesh, as ``test_mesh_execs_actually_ran``), Q6, Q13 and
Q18 at SF 0.002 seed 7 against the JAX package's 8-device mesh under
tests/test_tpch_mesh.py's ``MESH_CONF`` (adaptive execution on): equal
results (ties unordered, float sums within 1e-9) and equal ``Mesh*``
plans. Then all 22 queries on the port's mesh against the port's own
single-device run."""
import pytest

from spark_rapids_tpu.benchmarks import tpch_data as jtd
from spark_rapids_tpu.benchmarks import tpch_queries as jtq
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch_data as ttd
from spark_rapids_tpu_torch.benchmarks import tpch_queries as ttq

from torch_mesh_common import SUITE_MESH as MESH_CONF
from torch_mesh_common import (  # noqa: F401 - fixtures
    fresh_device_managers, jax_session, mesh_names, mesh_run,
    one_torch_thread)

SCALE = 0.002
SEED = 7
_TIES = {2, 3, 5, 9, 10, 11, 16, 18, 21}


@pytest.fixture(scope="module")
def jax_tables():
    return jtd.gen_all(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def port_tables():
    return ttd.gen_all(SCALE, seed=SEED)


@pytest.mark.parametrize("qnum,extra", [
    (1, {}), (3, {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"}),
    (6, {}), (13, {}), (18, {})])
def test_tpch_mesh_matches_jax_mesh(qnum, extra, jax_tables):
    conf = {**MESH_CONF, **extra}
    got, sess = mesh_run(lambda s: ttq.QUERIES[qnum](
        {k: s.create_dataframe(v) for k, v in jax_tables.items()}), conf)
    js = jax_session(conf)
    want = jtq.QUERIES[qnum]({k: js.create_dataframe(v)
                              for k, v in jax_tables.items()}).collect()
    assert_tables_equal(want, got, ignore_order=qnum in _TIES,
                        approx_float=1e-9)
    names = mesh_names(sess.last_plan)
    assert names == mesh_names(js.last_plan), (
        sess.last_plan.tree_string(), js.last_plan.tree_string())
    if qnum == 3:
        for e in ("MeshScatterExec", "MeshShuffledHashJoinExec",
                  "MeshHashAggregateExec"):
            assert e in names, names
    assert got.num_rows > 0 or qnum == 18


@pytest.mark.parametrize("qnum", sorted(ttq.QUERIES))
def test_tpch_mesh_matches_single_device(qnum, port_tables):
    def q(s):
        return ttq.QUERIES[qnum]({k: s.create_dataframe(v)
                                  for k, v in port_tables.items()})
    got, _ = mesh_run(q, MESH_CONF)
    want = q(TpuSession(MESH_CONF, device="cpu")).collect().to_arrow()
    assert_tables_equal(want, got, ignore_order=qnum in _TIES,
                        approx_float=1e-9)
    assert got.num_rows > 0 or qnum == 18
