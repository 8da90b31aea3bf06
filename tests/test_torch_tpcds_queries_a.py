"""The TPC-DS queries q1-q49 outside the bench subset (which
tests/test_torch_tpcds.py holds), and q72 over the plain tables (its
hash-repartitioned run is in tests/test_torch_tpcds_queries_b.py), through the PyTorch port on the CPU, against the JAX package's numpy engine
(``sql.enabled=false``, the benchmark conf with both nested-loop keys on),
at scale 0.01, seed 3, as tests/test_tpcds.py runs them: over the plain
tables and with the three sales facts hash-repartitioned 8 ways on their
item keys, as on the card. Rows compare unordered where
tests/test_tpcds.py's sort can tie, float sums within relative 1e-9 (the
variableFloatAgg carve-out), each query returns at least that test's row
floor, and the port's join strategies equal the JAX TPU planner's (planned
only, never run). Each query over only its ``COLUMNS`` gives the same
answer, and the same bits with whole-stage fusion on and off. q72's first
join pairs each catalog line with the 1,565 inventory rows of its item,
millions of rows at this scale: its two tests sit in this file of many
tests, which pytest-xdist's ``--dist loadfile`` schedules first, and not
in a file of their own, which it would schedule last, at the run's
tail."""
import pytest

from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from torch_tpcds_common import (BENCH, DF_SEED, HEAVY, SCALE, by_number,
                                check_df_columns, check_df_query,
                                check_fusion_on_equals_off, df_reference,
                                one_torch_thread)  # noqa: F401

QUERIES = [q for q in by_number(tdq.QUERIES)
           if q not in BENCH and q != HEAVY and int(q[1:]) < 50]


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
    return df_reference([HEAVY], reps=(False,))


def test_q72_matches_reference(q72_reference, port_tables):
    check_df_query(q72_reference, port_tables, HEAVY, False)


def test_q72_columns_give_the_same_answer(q72_reference, port_tables):
    check_df_columns(q72_reference, port_tables, HEAVY)
