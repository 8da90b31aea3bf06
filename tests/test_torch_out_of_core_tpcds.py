"""The 14 TPC-DS bench queries (scale 0.01, seed 3) through the PyTorch
port's out-of-core path on the CPU, each with
``memory.outOfCore.forcePartitions=4`` equal to its default run (the sales
facts hash-repartitioned 8 ways on their item keys, as on the card); and
q72 (0.002, seed 3), whose first join pairs each catalog line with every
inventory row of its item, under a ``budget_clamp`` fault that sends its
largest joins down the reactive path, equal to its default run. Rows
compare unordered, float sums within relative 1e-9."""
import pytest

from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu_torch.memory import grace
from torch_ooc_common import (check_forced, run_query,  # noqa: F401
                              fresh_memory_state, one_torch_thread)

TPCDS_BENCH = ("q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42",
               "q52", "q55", "q67", "q68", "q96")


@pytest.fixture(scope="module")
def tpcds_tables():
    return tds.gen_all(0.01, seed=3)


@pytest.mark.parametrize("q", TPCDS_BENCH)
def test_tpcds_bench_forced_partitions_equal_default(tpcds_tables, q):
    check_forced(tdq.QUERIES[q], tpcds_tables)


def test_tpcds_q72_budget_clamp_equals_default():
    """q72 with the budget clamped to a hundredth: its largest joins
    stage under pressure and go out of core."""
    tables = tds.gen_all(0.002, seed=3, columns=tdq.COLUMNS["q72"],
                         tables=list(tdq.COLUMNS["q72"]))
    want, _ = run_query(BENCH_CONF, tdq.QUERIES["q72"], tables)
    got, sess = run_query({**BENCH_CONF, "spark.rapids.tpu.memory.faults.plan":
                      "budget_clamp:fraction=0.01"},
                     tdq.QUERIES["q72"], tables)
    assert_tables_equal(want, got, ignore_order=True)
    assert want.num_rows > 0
    assert grace.counters()["pressure_events"] >= 2
    triggers = {type(n).__name__: n.grace_stats["trigger"]
                for n in sess.last_plan.walk() if hasattr(n, "grace_stats")}
    assert "reactive" in triggers.values(), triggers
