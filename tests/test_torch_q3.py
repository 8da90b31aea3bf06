"""TPC-H Q3 and Q6 end to end at scale 0.002: the PyTorch port's session (on
the CPU) with and without orders and lineitem hash-repartitioned 8 ways on
their order keys, with the broadcast join on (the default threshold) and
off, against the JAX package's answers (one run of its session over the
unpartitioned tables: the answer does not depend on the partitioning) and
its join strategies (its planner, per case, with the same conf dict). Keys
and dates must be exact, revenue sums within the variableFloatAgg
carve-out (relative 1e-9), and the port must pick the JAX package's join
strategies. The port's TPC-H generators must build the JAX
generators' columns byte for byte, with and without ``columns=``."""
import numpy as np
import pytest

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.benchmarks import tpch_data as jdata
from spark_rapids_tpu.benchmarks import tpch_queries as jq
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch_data as tdata
from spark_rapids_tpu_torch.benchmarks import tpch_queries as tq
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.exchange_execs import (
    HashPartitioning, TpuShuffleExchangeExec)

SCALE = 0.002
SEED = 42
GENS = {"customer": (jdata.gen_customer, tdata.gen_customer),
        "orders": (jdata.gen_orders, tdata.gen_orders),
        "lineitem": (jdata.gen_lineitem_full, tdata.gen_lineitem_full)}
NO_BROADCAST = {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "-1"}


@pytest.mark.parametrize("seed", [0, SEED])
@pytest.mark.parametrize("table", list(GENS))
def test_generators_match_reference(table, seed):
    jgen, tgen = GENS[table]
    ref = jgen(SCALE, seed)
    for columns in (None, tq.Q3_COLUMNS[table]):
        want = HostBatch.from_arrow(ref if columns is None
                                    else ref.select(columns))
        got = tgen(SCALE, seed, columns)
        assert got.schema == want.schema
        assert got.num_rows == want.num_rows
        assert got.nbytes == (ref if columns is None
                              else ref.select(columns)).nbytes
        for g, w in zip(got.columns, want.columns):
            assert g.data.shape == w.data.shape
            assert g.data.tobytes() == w.data.tobytes()
            assert np.array_equal(g.validity, w.validity)
            assert (g.lengths is None) == (w.lengths is None)
            if g.lengths is not None:
                assert np.array_equal(g.lengths, w.lengths)


def _strategies(plan):
    """Join exec names, depth first, of a plan of either engine."""
    out = [type(plan).__name__] if "HashJoin" in type(plan).__name__ else []
    for c in plan.children:
        out += _strategies(c)
    return out


def _frames(sess, tables, repartition):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    if repartition:
        dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
        dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
    return dfs


CASES = [(rep, bc) for rep in (False, True) for bc in (True, False)]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's Q3 and Q6 answers, and its join strategies per
    case. Its session runs the queries once, over the unpartitioned tables
    with the default conf; the other cases are only planned, since its jit
    compiles of the partitioned plans take most of a minute on the CPU."""
    tables = {k: jgen(SCALE, SEED) for k, (jgen, _) in GENS.items()}
    dfs = _frames(JaxSession(jtpch.BENCH_CONF), tables, False)
    q3, q6 = jq.q3(dfs).collect(), jtpch.q6(dfs["lineitem"]).collect()
    out = {}
    for rep, bc in CASES:
        sess = JaxSession({**jtpch.BENCH_CONF, **({} if bc else NO_BROADCAST)})
        plan = jq.q3(_frames(sess, tables, rep))._executed_plan()
        out[rep, bc] = (q3, _strategies(plan), q6)
    return out


@pytest.mark.parametrize("repartition,broadcast", CASES)
def test_q3_q6_match_reference(reference, repartition, broadcast):
    want_q3, want_joins, want_q6 = reference[repartition, broadcast]
    tables = {k: tgen(SCALE, SEED) for k, (_, tgen) in GENS.items()}
    sess = TpuSession({**jtpch.BENCH_CONF,
                       **({} if broadcast else NO_BROADCAST)}, device="cpu")
    dfs = _frames(sess, tables, repartition)
    got = tq.q3(dfs).collect()
    assert got.num_rows == 10
    assert_tables_equal(want_q3, got.to_arrow(), approx_float=1e-9)
    joins = _strategies(sess.last_plan)
    assert joins == want_joins
    assert ("TpuBroadcastHashJoinExec" in joins) == broadcast
    hashed = [e for e in sess.last_plan.walk()
              if isinstance(e, TpuShuffleExchangeExec)
              and isinstance(e.partitioning, HashPartitioning)]
    assert [(e.kernel_splits, e.sort_path_splits) for e in hashed] == \
        [(1, 0)] * (2 if repartition else 0)
    got6 = tq.q6(dfs["lineitem"]).collect()
    assert got6.num_rows == 1
    assert_tables_equal(want_q6, got6.to_arrow(), approx_float=1e-9)
