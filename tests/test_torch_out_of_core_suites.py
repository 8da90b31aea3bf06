"""Every TPC-H query (scale 0.002, seed 7) and every TPCx-BB query (0.01,
seed 0) through the PyTorch port's out-of-core path on the CPU: with
``memory.outOfCore.forcePartitions=4`` each equals its default run, the
fact tables hash-repartitioned 8 ways as on the card. Rows compare
unordered (grace emits a grouped result's partitions in turn), float sums
within relative 1e-9 (the variableFloatAgg carve-out)."""
import pytest

from spark_rapids_tpu_torch.benchmarks import tpch_data as thd
from spark_rapids_tpu_torch.benchmarks import tpch_queries as thq
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as tbb
from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as tbq
from torch_ooc_common import (check_forced, fresh_memory_state,  # noqa: F401
                              one_torch_thread)


@pytest.fixture(scope="module")
def tpch_tables():
    return thd.gen_all(0.002, seed=7)


@pytest.fixture(scope="module")
def tpcxbb_tables():
    return tbb.gen_all(0.01, seed=0)


@pytest.mark.parametrize("q", sorted(thq.QUERIES))
def test_tpch_forced_partitions_equal_default(tpch_tables, q):
    check_forced(thq.QUERIES[q], tpch_tables)


@pytest.mark.parametrize("q", sorted(tbq.QUERIES, key=lambda n: int(n[1:])))
def test_tpcxbb_forced_partitions_equal_default(tpcxbb_tables, q):
    check_forced(tbq.QUERIES[q], tpcxbb_tables)
