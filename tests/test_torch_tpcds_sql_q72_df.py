"""TPC-DS q72's SQL text through the PyTorch port's ``TpuSession.sql`` on
the CPU against the port's own DataFrame query (scale 0.01, seed 0;
tests/test_torch_tpcds_sql_q72.py holds it against the JAX package)."""
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from torch_tpcds_common import (CONF, HEAVY, SCALE, SQL_SEED,
                                check_sql_against_dataframe, frames,
                                one_torch_thread)  # noqa: F401


def test_sql_matches_dataframe():
    sess = TpuSession(CONF, device="cpu")
    dfs = frames(sess, tds.gen_all(SCALE, seed=SQL_SEED))
    for name, df in dfs.items():
        df.createOrReplaceTempView(name)
    check_sql_against_dataframe(sess, dfs, HEAVY)
