"""TPC-DS q72's SQL text through the PyTorch port's ``TpuSession.sql`` on
the CPU against the JAX package's numpy engine's run of the same text
(scale 0.01, seed 0; tests/test_torch_tpcds_sql_q72_df.py holds it against
the port's DataFrame query). Its first join emits millions of rows at this
scale, so it has files of its own."""
from torch_tpcds_common import (HEAVY, check_sql_text, one_torch_thread,  # noqa: F401
                                sql_sessions)


def test_sql_matches_reference():
    jsess, sess, _ = sql_sessions()
    check_sql_text(jsess, sess, HEAVY)
