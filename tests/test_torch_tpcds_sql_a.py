"""The TPC-DS SQL texts q1-q49 and q72 through
the PyTorch port's ``TpuSession.sql`` on the CPU, over the 24 tables at
scale 0.01, seed 0, registered as temp views, as tests/test_tpcds_sql.py
runs them. Each result must equal the JAX package's numpy engine's run of
the same text and the port's own DataFrame query: unordered where either
reference test's sort can tie, float sums within relative 1e-9. q72's text
(whose first join emits millions of rows) is held against the JAX package
here and against the port's DataFrame query in
tests/test_torch_tpcds_sql_b.py: files of many tests, which
``--dist loadfile`` schedules first."""
import pytest

from spark_rapids_tpu_torch.benchmarks.tpcds_sql import SQL_QUERIES
from torch_tpcds_common import (HEAVY, by_number, check_sql_against_dataframe,
                                check_sql_text, one_torch_thread,  # noqa: F401
                                sql_sessions)

QUERIES = [q for q in by_number(SQL_QUERIES) if q != HEAVY and int(q[1:]) < 50]


@pytest.fixture(scope="module")
def sessions():
    return sql_sessions()


@pytest.mark.parametrize("q", QUERIES)
def test_sql_matches_reference_and_dataframe(sessions, q):
    jsess, sess, dfs = sessions
    got = check_sql_text(jsess, sess, q)
    check_sql_against_dataframe(sess, dfs, q, got)


def test_q72_sql_matches_reference(sessions):
    jsess, sess, _ = sessions
    check_sql_text(jsess, sess, HEAVY)
