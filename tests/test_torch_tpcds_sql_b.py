"""The TPC-DS SQL texts q50-q99 but q72 (tests/test_torch_tpcds_sql_a.py) through
the PyTorch port's ``TpuSession.sql`` on the CPU, over the 24 tables at
scale 0.01, seed 0, registered as temp views, as tests/test_tpcds_sql.py
runs them. Each result must equal the JAX package's numpy engine's run of
the same text and the port's own DataFrame query: unordered where either
reference test's sort can tie, float sums within relative 1e-9. Also
q72's text against the port's DataFrame query (its run against the JAX
package is in tests/test_torch_tpcds_sql_a.py)."""
import pytest

from spark_rapids_tpu_torch.benchmarks.tpcds_sql import SQL_QUERIES
from torch_tpcds_common import (HEAVY, by_number, check_sql_against_dataframe,
                                check_sql_text, one_torch_thread,  # noqa: F401
                                sql_sessions)

QUERIES = [q for q in by_number(SQL_QUERIES) if q != HEAVY and int(q[1:]) >= 50]


@pytest.fixture(scope="module")
def sessions():
    return sql_sessions()


@pytest.mark.parametrize("q", QUERIES)
def test_sql_matches_reference_and_dataframe(sessions, q):
    jsess, sess, dfs = sessions
    got = check_sql_text(jsess, sess, q)
    check_sql_against_dataframe(sess, dfs, q, got)


def test_q72_sql_matches_dataframe(sessions):
    _, sess, dfs = sessions
    check_sql_against_dataframe(sess, dfs, HEAVY)
