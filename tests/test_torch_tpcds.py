"""The TPC-DS bench subset (the 14 queries of ``bench.py``'s
``TPCDS_BENCH_QUERIES``) and TPCx-BB q5 through the PyTorch port on the CPU,
against the JAX package's numpy engine (``sql.enabled=false``, the
benchmark conf with ``sql.exec.NestedLoopJoin`` and
``sql.exec.CartesianProduct`` on): TPC-DS at scale 0.01, seed 3, as
``tests/test_tpcds.py`` runs it, q5 at scale 0.01, seed 0, as
``tests/test_tpcxbb.py`` does; over the plain tables and with the fact
tables hash-repartitioned 8 ways on their item keys, as on the card.
Queries whose final sort can tie compare unordered; float sums within
relative 1e-9 (the variableFloatAgg carve-out); each must return at least
the reference tests' row count. The port's join strategies must equal the
JAX TPU planner's (planned only, never run). The port's generators build
the JAX generators' columns byte for byte, with and without ``columns=``."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpcds_data as jds
from spark_rapids_tpu.benchmarks import tpcds_queries as jdq
from spark_rapids_tpu.benchmarks import tpcxbb_data as jbb
from spark_rapids_tpu.benchmarks import tpcxbb_queries as jbq
from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as tbb
from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as tbq
from spark_rapids_tpu_torch.columnar.host import HostBatch

SCALE = 0.01
DS_SEED = 3
BB_SEED = 0
CONF = {**BENCH_CONF,
        "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
        "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
# as in tests/test_tpcds.py and tests/test_tpcxbb.py
_TIES = {"q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42", "q52",
         "q55", "q67", "q68", "bb_q5"}
_MIN_ROWS = {"q3": 1, "q7": 1, "q14": 1, "q19": 1, "q23": 1, "q27": 10,
             "q34": 1, "q42": 1, "q52": 1, "q55": 1, "q67": 10, "q68": 1,
             "q96": 1, "bb_q5": 10}
#: q4 is in tests/test_tpcds.py's _KNOWN_EMPTY: no row at this scale
_KNOWN_EMPTY = {"q4"}
#: the fact tables and the item keys they are hash-repartitioned on
_FACTS = {"store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
          "web_sales": "ws_item_sk", "web_clickstreams": "wcs_item_sk"}
#: the bench subset (tests/test_torch_tpcds_queries_*.py and the q72 files
#: hold the other 85)
BENCH = ("q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42", "q52",
         "q55", "q67", "q68", "q96")
QUERIES = list(BENCH) + ["bb_q5"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs, and torch's pool of a thread per CPU in every worker
    would oversubscribe them on these small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _suite(q):
    """(JAX query, port query, JAX generator, port generator, seed)."""
    if q == "bb_q5":
        return (jbq.QUERIES["q5"], tbq.QUERIES["q5"], jbb.gen_all,
                tbb.gen_all, BB_SEED)
    return jdq.QUERIES[q], tdq.QUERIES[q], jds.gen_all, tds.gen_all, DS_SEED


def _frames(sess, tables, repartition):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    if repartition:
        for t, key in _FACTS.items():
            if t in dfs:
                dfs[t] = dfs[t].repartition(8, key)
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
    """The JAX numpy engine's answers and the JAX TPU planner's join
    strategies (plain and repartitioned), per query."""
    numpy_engine = JaxSession({**CONF, "spark.rapids.tpu.sql.enabled":
                               "false"})
    planner = JaxSession(CONF)
    tables = {DS_SEED: jds.gen_all(SCALE, seed=DS_SEED),
              BB_SEED: jbb.gen_all(SCALE, seed=BB_SEED)}
    answers, plans = {}, {}
    for q in QUERIES:
        jquery, _, _, _, seed = _suite(q)
        answers[q] = jquery(_frames(numpy_engine, tables[seed],
                                    False)).collect()
        for rep in (False, True):
            plans[q, rep] = strategies(
                jquery(_frames(planner, tables[seed], rep))._executed_plan())
    return answers, plans


@pytest.fixture(scope="module")
def port_tables():
    return {DS_SEED: tds.gen_all(SCALE, seed=DS_SEED),
            BB_SEED: tbb.gen_all(SCALE, seed=BB_SEED)}


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["plain", "hash8"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(reference, port_tables, q, repartition):
    answers, plans = reference
    _, tquery, _, _, seed = _suite(q)
    sess = TpuSession(CONF, device="cpu")
    got = tquery(_frames(sess, port_tables[seed], repartition)).collect()
    assert strategies(sess.last_plan) == plans[q, repartition]
    if q not in _KNOWN_EMPTY:
        assert got.num_rows >= _MIN_ROWS[q]
    assert_tables_equal(answers[q], got.to_arrow(), ignore_order=q in _TIES,
                        approx_float=1e-9)


@pytest.mark.parametrize("q", QUERIES)
def test_columns_give_the_same_answer(reference, port_tables, q):
    """Each query over only the columns ``COLUMNS`` lists for it (and
    nothing else: a missing column fails binding) gives the full tables'
    answer."""
    answers, _ = reference
    _, tquery, _, _, seed = _suite(q)
    columns = (tbq.COLUMNS["q5"] if q == "bb_q5" else tdq.COLUMNS[q])
    tables = {t: port_tables[seed][t].select(names)
              for t, names in columns.items()}
    sess = TpuSession(CONF, device="cpu")
    got = tquery(_frames(sess, tables, False)).collect()
    assert_tables_equal(answers[q], got.to_arrow(), ignore_order=q in _TIES,
                        approx_float=1e-9)


GENS = {
    "date_dim": (lambda sc, s: jds.gen_date_dim(),
                 lambda sc, s, c: tds.gen_date_dim(c), tds.DATE_DIM_COLUMNS),
    "time_dim": (lambda sc, s: jds.gen_time_dim(),
                 lambda sc, s, c: tds.gen_time_dim(c), tds.TIME_DIM_COLUMNS),
    "item": (jds.gen_item, tds.gen_item, tds.ITEM_COLUMNS),
    "customer": (jds.gen_customer, tds.gen_customer, tds.CUSTOMER_COLUMNS),
    "customer_address": (jds.gen_customer_address, tds.gen_customer_address,
                         tds.CUSTOMER_ADDRESS_COLUMNS),
    "customer_demographics": (
        lambda sc, s: jds.gen_customer_demographics(),
        lambda sc, s, c: tds.gen_customer_demographics(c),
        tds.CUSTOMER_DEMOGRAPHICS_COLUMNS),
    "household_demographics": (
        lambda sc, s: jds.gen_household_demographics(),
        lambda sc, s, c: tds.gen_household_demographics(c),
        tds.HOUSEHOLD_DEMOGRAPHICS_COLUMNS),
    "store": (jds.gen_store, tds.gen_store, tds.STORE_COLUMNS),
    "promotion": (jds.gen_promotion, tds.gen_promotion,
                  tds.PROMOTION_COLUMNS),
    "store_sales": (jds.gen_store_sales, tds.gen_store_sales,
                    tds.STORE_SALES_COLUMNS),
    "catalog_sales": (lambda sc, s: jds.gen_all(sc, s)["catalog_sales"],
                      tds.gen_catalog_sales, tds.CATALOG_SALES_COLUMNS),
    "web_sales": (jds.gen_web_sales_ds, tds.gen_web_sales,
                  tds.WEB_SALES_COLUMNS),
    "bb_item": (lambda sc, s: jbb.gen_all(sc, s)["item"], tbb.gen_item,
                tbb.ITEM_COLUMNS),
    "bb_customer": (lambda sc, s: jbb.gen_all(sc, s)["customer"],
                    tbb.gen_customer, tbb.CUSTOMER_COLUMNS),
    "bb_web_clickstreams": (
        lambda sc, s: jbb.gen_all(sc, s)["web_clickstreams"],
        tbb.gen_web_clickstreams, tbb.WEB_CLICKSTREAMS_COLUMNS),
}


@pytest.mark.parametrize("table", list(GENS))
def test_generators_match_reference(table):
    jgen, tgen, order = GENS[table]
    seed = BB_SEED if table.startswith("bb_") else DS_SEED
    ref = jgen(SCALE, seed)
    picks = [None, [order[-1]], [order[0], order[len(order) // 2]]]
    picks += [[c] for c in order[1:-1]]
    for columns in picks:
        sub = ref if columns is None else ref.select(columns)
        want = HostBatch.from_arrow(sub)
        got = tgen(SCALE, seed, columns)
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
