"""Shared by tests/test_torch_out_of_core_suites.py and
tests/test_torch_out_of_core_tpcds.py: a suite query through the PyTorch
port on the CPU with ``memory.outOfCore.forcePartitions=4`` against its
default run, the fact tables hash-repartitioned 8 ways as on the card."""
import gc

import pytest
import torch

from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu_torch.memory import faults as mfaults
from spark_rapids_tpu_torch.memory import grace
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

FORCE4 = {**BENCH_CONF, "spark.rapids.tpu.memory.outOfCore.forcePartitions":
          "4"}
FACTS = {"orders": "o_orderkey", "lineitem": "l_orderkey",
         "store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
         "web_sales": "ws_item_sk", "web_clickstreams": "wcs_user_sk"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs; after it the garbage
    collector runs here, so the sessions the module made (reference
    cycles) are finalized where no lock is held, not later inside a
    device manager's lock (where the JAX package's waits on itself)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.collect()


@pytest.fixture(autouse=True)
def fresh_memory_state():
    DeviceManager.shutdown()
    mfaults.reset_plans()
    grace.reset_counters()
    yield
    DeviceManager.shutdown()
    mfaults.reset_plans()


def _frames(sess, tables):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    for t, key in FACTS.items():
        if t in dfs:
            dfs[t] = dfs[t].repartition(8, key)
    return dfs


def run_query(conf, query, tables):
    DeviceManager.shutdown()
    sess = TpuSession(conf, device="cpu")
    return query(_frames(sess, tables)).collect().to_arrow(), sess


def _keyed(node) -> bool:
    """An operator that can go out of core: a grouped aggregate, a keyed
    join or a sort."""
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.execs.tpu_execs import (TpuHashAggregateExec,
                                                        TpuSortExec)
    return (isinstance(node, TpuSortExec)
            or (isinstance(node, TpuHashAggregateExec) and node.grouping)
            or (isinstance(node, TpuShuffledHashJoinExec)
                and node.left_keys))


def check_forced(query, tables):
    """The query under forcePartitions=4 equals its default run, and every
    operator that can go out of core did (those that ran)."""
    want, _ = run_query(BENCH_CONF, query, tables)
    got, sess = run_query(FORCE4, query, tables)
    assert_tables_equal(want, got, ignore_order=True, approx_float=1e-9)
    keyed = [n for n in sess.last_plan.walk() if _keyed(n)]
    forced = [n for n in keyed if hasattr(n, "grace_stats")]
    assert all(n.grace_stats["trigger"] == "forced" for n in forced)
    assert bool(forced) == bool(keyed)
    if keyed:
        assert grace.counters()["spill_partitions"] >= 4
