"""TPC-DS q72 through the PyTorch port on the CPU with the three sales
facts hash-repartitioned 8 ways on their item keys, against the JAX
package's numpy engine and with the JAX TPU planner's join strategies
(scale 0.01, seed 3; tests/test_torch_tpcds_q72.py has its plain run)."""
import pytest

from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from torch_tpcds_common import (DF_SEED, HEAVY, SCALE, check_df_query,
                                df_reference,
                                one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    return df_reference([HEAVY], reps=(True,))


@pytest.fixture(scope="module")
def port_tables():
    return tds.gen_all(SCALE, seed=DF_SEED)


def test_query_matches_reference(reference, port_tables):
    check_df_query(reference, port_tables, HEAVY, True)
