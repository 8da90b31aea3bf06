"""TPC-H Q1 end to end through both engines: the JAX package's session and
the PyTorch port's session (on the CPU), driven by one conf dict, with and
without lineitem hash-repartitioned 8 ways on l_orderkey (the exchange runs
the reference's Pallas kernel in interpreter mode and the port's reorder in
its plain version). Keys and count_order must be exact, sums and averages
within the variableFloatAgg carve-out (relative 1e-9)."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.benchmarks import tpch as ttpch
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.exchange_execs import (
    HashPartitioning, TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.plan import logical as lp
from torch_parquet_common import one_torch_thread  # noqa: F401 - fixture

SCALE = 0.001
SEED = 42


def _conf(mode):
    return {**jtpch.BENCH_CONF,
            "spark.rapids.tpu.shuffle.kernel.mode": mode}


def _hash_exchanges(sess):
    return [e for e in sess.last_plan.walk()
            if isinstance(e, TpuShuffleExchangeExec)
            and isinstance(e.partitioning, HashPartitioning)]


@pytest.mark.parametrize("seed", [0, 42])
def test_gen_lineitem_matches_reference(seed):
    want = HostBatch.from_arrow(jtpch.gen_lineitem(SCALE, seed=seed))
    got = ttpch.gen_lineitem(SCALE, seed=seed)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        assert g.data.tobytes() == w.data.tobytes()
        assert np.array_equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        if g.lengths is not None:
            assert np.array_equal(g.lengths, w.lengths)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's Q1, without and with the 8-way repartition."""
    jdf = JaxSession(_conf("interpret")).create_dataframe(
        jtpch.gen_lineitem(SCALE, SEED))
    return {False: jtpch.q1(jdf).collect(),
            True: jtpch.q1(jdf.repartition(8, "l_orderkey")).collect()}


def _port_q1(mode, repartition):
    sess = TpuSession(_conf(mode), device="cpu")
    df = sess.create_dataframe(ttpch.gen_lineitem(SCALE, SEED))
    if repartition:
        df = df.repartition(8, "l_orderkey")
    return sess, ttpch.q1(df).collect()


@pytest.mark.parametrize("repartition", [False, True])
def test_q1_matches_reference(reference, repartition):
    sess, got = _port_q1("interpret", repartition)
    assert got.num_rows == 6
    assert_tables_equal(reference[repartition], got.to_arrow(),
                        approx_float=1e-9)
    splits = [(e.kernel_splits, e.sort_path_splits)
              for e in _hash_exchanges(sess)]
    assert splits == ([(1, 0)] if repartition else [])


def test_q1_sort_path_matches_reference(reference):
    """shuffle.kernel.mode=off: the port's exchange takes the sort path."""
    sess, got = _port_q1("off", True)
    assert_tables_equal(reference[True], got.to_arrow(), approx_float=1e-9)
    assert [(e.kernel_splits, e.sort_path_splits)
            for e in _hash_exchanges(sess)] == [(0, 1)]


def test_q1_overflowing_exchange_falls_back_to_sort_path():
    """A key that sends every row to one partition overflows the reorder's
    quotas; the batch must take the sort path and stay correct."""
    table = jtpch.gen_lineitem(SCALE, 5)
    table = table.set_column(0, "l_orderkey",
                             pa.array(np.full(table.num_rows, 7, np.int64)))
    conf = _conf("interpret")
    want = jtpch.q1(JaxSession(conf).create_dataframe(table)
                    .repartition(8, "l_orderkey")).collect()
    sess = TpuSession(conf, device="cpu")
    got = ttpch.q1(sess.create_dataframe(table)
                   .repartition(8, "l_orderkey")).collect()
    assert_tables_equal(want, got.to_arrow(), approx_float=1e-9)
    assert [(e.kernel_splits, e.sort_path_splits)
            for e in _hash_exchanges(sess)] == [(0, 1)]


def test_float_aggregates_need_variable_float_agg():
    """Without sql.variableFloatAgg.enabled Q1's float sums and averages
    run on the CPU engine, as the JAX package's tagger sends them, with
    its reason in the explain, and equal its fallback."""
    from spark_rapids_tpu_torch.execs.cpu_execs import CpuHashAggregateExec
    sess = TpuSession({}, device="cpu")
    got = ttpch.q1(sess.create_dataframe(ttpch.gen_lineitem(SCALE, 0))) \
        .collect()
    aggs = [type(e) for e in sess.last_plan.walk()
            if "HashAggregate" in type(e).__name__]
    assert aggs == [CpuHashAggregateExec]
    assert ("because expression Sum: Sum over floating point can produce "
            "order-dependent results; enable with spark.rapids.tpu.sql."
            "variableFloatAgg.enabled") in sess.last_explain
    jsess = JaxSession({})
    want = jtpch.q1(jsess.create_dataframe(jtpch.gen_lineitem(SCALE, 0))) \
        .collect()
    assert "!CpuHashAggregateExec cannot run on TPU" in jsess.last_explain
    assert_tables_equal(want, got.to_arrow(), approx_float=1e-9)


def test_unported_operator_raises_naming_it():
    """A logical operator the port has no physical plan for is refused by
    name (round-robin repartition, refused in the first slice, is planned
    now: tests/test_torch_exchange.py)."""
    class Sample(lp.LogicalPlan):
        def __init__(self, child):
            self.child = child

        def schema(self):
            return self.child.schema()

    sess = TpuSession(ttpch.BENCH_CONF, device="cpu")
    df = sess.create_dataframe(ttpch.gen_lineitem(SCALE, 0))
    with pytest.raises(NotImplementedError, match="no physical plan for "
                                                  "Sample"):
        DataFrame(Sample(df._plan), sess).collect()
