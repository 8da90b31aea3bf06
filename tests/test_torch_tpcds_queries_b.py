"""The TPC-DS queries q50-q99 outside the bench subset (which
tests/test_torch_tpcds.py holds), and q72 hash-repartitioned (its plain
run is in tests/test_torch_tpcds_queries_a.py), through the PyTorch port on the CPU, against the JAX package's numpy engine
(``sql.enabled=false``, the benchmark conf with both nested-loop keys on),
at scale 0.01, seed 3, as tests/test_tpcds.py runs them: over the plain
tables and with the three sales facts hash-repartitioned 8 ways on their
item keys, as on the card. Rows compare unordered where
tests/test_tpcds.py's sort can tie, float sums within relative 1e-9 (the
variableFloatAgg carve-out), each query returns at least that test's row
floor, and the port's join strategies equal the JAX TPU planner's (planned
only, never run). Each query over only its ``COLUMNS`` gives the same
answer, and the same bits with whole-stage fusion on and off. q72 sits in
this file of many tests so that ``--dist loadfile`` schedules it first
(tests/test_torch_tpcds_queries_a.py says why)."""
import pytest

from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from torch_tpcds_common import (BENCH, DF_SEED, HEAVY, SCALE, by_number,
                                check_df_columns, check_df_query,
                                check_fusion_on_equals_off, df_reference,
                                one_torch_thread)  # noqa: F401

QUERIES = [q for q in by_number(tdq.QUERIES)
           if q not in BENCH and q != HEAVY and int(q[1:]) >= 50]


@pytest.fixture(scope="module")
def reference():
    return df_reference(QUERIES)


@pytest.fixture(scope="module")
def port_tables():
    return tds.gen_all(SCALE, seed=DF_SEED)


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["plain", "hash8"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(reference, port_tables, q, repartition):
    check_df_query(reference, port_tables, q, repartition)


@pytest.mark.parametrize("q", QUERIES)
def test_columns_give_the_same_answer(reference, port_tables, q):
    check_df_columns(reference, port_tables, q)


@pytest.mark.parametrize("q", QUERIES)
def test_fusion_on_equals_off(port_tables, q):
    check_fusion_on_equals_off(port_tables, q)


@pytest.fixture(scope="module")
def q72_reference():
    return df_reference([HEAVY], reps=(True,))


def test_q72_hash8_matches_reference(q72_reference, port_tables):
    check_df_query(q72_reference, port_tables, HEAVY, True)
