"""All 22 TPC-H queries through the PyTorch port on the CPU at scale 0.002,
seed 7, against the JAX package's numpy engine (``sql.enabled=false``, the
benchmark conf with ``sql.exec.NestedLoopJoin`` and
``sql.exec.CartesianProduct`` on, as ``tests/test_tpch_full.py`` runs
them): over the plain tables and with orders and lineitem hash-repartitioned
8 ways on their order keys, as on the card. Queries whose final sort can tie
compare unordered; float sums within relative 1e-9 (the variableFloatAgg
carve-out); each must return at least ``test_tpch_full.py``'s row count.
The port's join strategies must equal the JAX TPU planner's (planned only,
never run). The five generators the port adds build the JAX generators'
columns byte for byte, with and without ``columns=``."""
import numpy as np
import pytest

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpch_data as jdata
from spark_rapids_tpu.benchmarks import tpch_queries as jq
from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch_data as tdata
from spark_rapids_tpu_torch.benchmarks import tpch_queries as tq
from spark_rapids_tpu_torch.columnar.host import HostBatch
from torch_parquet_common import one_torch_thread  # noqa: F401 - fixture

SCALE = 0.002
SEED = 7
CONF = {**BENCH_CONF,
        "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
        "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
# as in tests/test_tpch_full.py
_TIES = {2, 3, 5, 9, 10, 11, 16, 18, 21}
_MIN_ROWS = {1: 4, 2: 1, 3: 1, 4: 5, 5: 1, 6: 1, 7: 4, 8: 1, 9: 10, 10: 1,
             11: 1, 12: 2, 13: 5, 14: 1, 15: 1, 16: 5, 17: 1, 19: 1, 20: 1,
             21: 1, 22: 1}


def _frames(sess, tables, repartition):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    if repartition:
        dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
        dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
    return dfs


def strategies(plan):
    """The join execs of a plan of either engine, depth first."""
    name = type(plan).__name__
    out = [name] if "Join" in name or "Cartesian" in name else []
    for c in plan.children:
        out += strategies(c)
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX tables, its numpy engine's answers and its TPU planner's
    join strategies (plain and repartitioned), per query."""
    tables = jdata.gen_all(SCALE, seed=SEED)
    numpy_engine = JaxSession({**CONF, "spark.rapids.tpu.sql.enabled":
                               "false"})
    planner = JaxSession(CONF)
    answers, plans = {}, {}
    for q, query in jq.QUERIES.items():
        answers[q] = query(_frames(numpy_engine, tables, False)).collect()
        for rep in (False, True):
            plans[q, rep] = strategies(
                query(_frames(planner, tables, rep))._executed_plan())
    return answers, plans


@pytest.fixture(scope="module")
def port_tables():
    return tdata.gen_all(SCALE, seed=SEED)


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["plain", "hash8"])
@pytest.mark.parametrize("qnum", sorted(tq.QUERIES))
def test_query_matches_reference(reference, port_tables, qnum, repartition):
    answers, plans = reference
    sess = TpuSession(CONF, device="cpu")
    got = tq.QUERIES[qnum](_frames(sess, port_tables, repartition)).collect()
    assert strategies(sess.last_plan) == plans[qnum, repartition]
    assert got.num_rows >= _MIN_ROWS.get(qnum, 0)
    assert_tables_equal(answers[qnum], got.to_arrow(),
                        ignore_order=qnum in _TIES, approx_float=1e-9)


def test_columns_cover_every_query(port_tables):
    """Each query plans over only the tables and columns ``COLUMNS`` lists
    for it (a missing column fails binding)."""
    sess = TpuSession(CONF, device="cpu")
    for q, query in tq.QUERIES.items():
        tables = {t: port_tables[t].select(names)
                  for t, names in tq.COLUMNS[q].items()}
        query(_frames(sess, tables, False)).physical_plan()


GENS = {
    "region": (lambda: jdata.gen_region(),
               lambda s, c: tdata.gen_region(c), tdata.REGION_COLUMNS),
    "nation": (lambda: jdata.gen_nation(),
               lambda s, c: tdata.gen_nation(c), tdata.NATION_COLUMNS),
    "supplier": (lambda: jdata.gen_supplier(SCALE, SEED),
                 lambda s, c: tdata.gen_supplier(s, SEED, c),
                 tdata.SUPPLIER_COLUMNS),
    "part": (lambda: jdata.gen_part(SCALE, SEED),
             lambda s, c: tdata.gen_part(s, SEED, c), tdata.PART_COLUMNS),
    "partsupp": (lambda: jdata.gen_partsupp(SCALE, SEED),
                 lambda s, c: tdata.gen_partsupp(s, SEED, c),
                 tdata.PARTSUPP_COLUMNS),
}


@pytest.mark.parametrize("table", list(GENS))
def test_generators_match_reference(table):
    jgen, tgen, order = GENS[table]
    ref = jgen()
    picks = [None, [order[-1]], [order[0], order[len(order) // 2]]]
    picks += [[c] for c in order[1:-1]]
    for columns in picks:
        sub = ref if columns is None else ref.select(columns)
        want = HostBatch.from_arrow(sub)
        got = tgen(SCALE, columns)
        assert got.schema == want.schema
        assert got.num_rows == want.num_rows
        assert got.nbytes == sub.nbytes
        for g, w in zip(got.columns, want.columns):
            assert g.data.shape == w.data.shape
            assert g.data.tobytes() == w.data.tobytes()
            assert np.array_equal(g.validity, w.validity)
            assert (g.lengths is None) == (w.lengths is None)
            if g.lengths is not None:
                assert np.array_equal(g.lengths, w.lengths)
