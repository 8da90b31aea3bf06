"""The TPC-DS bench subset (bench.py's 14 ``TPCDS_BENCH_QUERIES``) at SF 0.01
seed 3 and TPCx-BB q5 at SF 0.01 seed 0 on the PyTorch port's mesh (8 CPU
shards, adaptive execution on) against the port's own single-device run:
ties unordered, float sums within 1e-9, every mesh run holding mesh
operators with no host hop."""
import pytest

from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as tbb
from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as tbq

from torch_mesh_common import SUITE_MESH as MESH_CONF
from torch_mesh_common import (  # noqa: F401 - fixtures
    fresh_device_managers, mesh_run, one_torch_thread)

BENCH = ("q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42", "q52",
         "q55", "q67", "q68", "q96")
_TIES = set(BENCH) - {"q96"} | {"bb_q5"}


@pytest.fixture(scope="module")
def ds_tables():
    return tds.gen_all(0.01, seed=3)


@pytest.fixture(scope="module")
def bb_tables():
    return tbb.gen_all(0.01, seed=0)


@pytest.mark.parametrize("q", list(BENCH) + ["bb_q5"])
def test_tpcds_mesh_matches_single_device(q, ds_tables, bb_tables):
    query, tables = ((tbq.QUERIES["q5"], bb_tables) if q == "bb_q5"
                     else (tdq.QUERIES[q], ds_tables))

    def run(s):
        return query({k: s.create_dataframe(v) for k, v in tables.items()})
    got, _ = mesh_run(run, MESH_CONF)
    want = run(TpuSession(MESH_CONF, device="cpu")).collect().to_arrow()
    assert_tables_equal(want, got, ignore_order=q in _TIES,
                        approx_float=1e-9)
    assert got.num_rows > 0 or q == "q4"
