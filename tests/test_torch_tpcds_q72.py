"""TPC-DS q72 through the PyTorch port on the CPU over the plain tables,
and over only its ``COLUMNS``, against the JAX package's numpy engine, as
tests/test_torch_tpcds_queries_a.py holds the other queries (scale 0.01,
seed 3). Its first join pairs each catalog line with the 1,565 inventory
rows of its item, millions of rows at this scale, so it has a file of its
own and its hash-repartitioned run another."""
import pytest

from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from torch_tpcds_common import (DF_SEED, HEAVY, SCALE, check_df_columns,
                                check_df_query, df_reference,
                                one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    return df_reference([HEAVY], reps=(False,))


@pytest.fixture(scope="module")
def port_tables():
    return tds.gen_all(SCALE, seed=DF_SEED)


def test_query_matches_reference(reference, port_tables):
    check_df_query(reference, port_tables, HEAVY, False)


def test_columns_give_the_same_answer(reference, port_tables):
    check_df_columns(reference, port_tables, HEAVY)
