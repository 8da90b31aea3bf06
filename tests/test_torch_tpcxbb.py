"""The 30 TPCx-BB queries through the PyTorch port on the CPU, against the
JAX package's numpy engine (``sql.enabled=false``, the benchmark conf with
``sql.exec.NestedLoopJoin`` and ``sql.exec.CartesianProduct`` on), at
scale 0.01, seed 0, as ``tests/test_tpcxbb.py`` runs them; over the plain
tables and with store_sales and web_sales hash-repartitioned 8 ways on
their item keys and web_clickstreams on ``wcs_user_sk`` (the key its
sessionizing windows partition on), as on the card. Queries whose final
sort can tie compare unordered; float sums within relative 1e-9 (q15's
least-squares slope 1e-6), as ``tests/test_tpcxbb.py`` compares them; each
must return at least that test's row count. The port's join strategies
must equal the JAX TPU planner's (planned only, never run). Each query
over only the columns ``COLUMNS`` lists gives the full tables' answer. The
port's 19 generators build the JAX generators' columns byte for byte, with
and without ``columns=``, and its word lists equal the JAX package's."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpcds_data as jds
from spark_rapids_tpu.benchmarks import tpcxbb_data as jbb
from spark_rapids_tpu.benchmarks import tpcxbb_queries as jbq
from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as tbb
from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as tbq
from spark_rapids_tpu_torch.columnar.host import HostBatch

SCALE = 0.01
SEED = 0
CONF = {**BENCH_CONF,
        "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
        "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
# as in tests/test_tpcxbb.py
_TIES = {"q5", "q7", "q9", "q11", "q14", "q16", "q17", "q21", "q22", "q24"}
_MIN_ROWS = {"q1": 1, "q2": 1, "q3": 1, "q4": 1, "q5": 10, "q6": 1, "q7": 1,
             "q8": 2, "q9": 1, "q10": 10, "q11": 1, "q12": 1,
             "q13": 1, "q14": 1, "q15": 1, "q16": 1, "q17": 1, "q18": 1,
             "q19": 1, "q20": 10, "q21": 1, "q22": 1, "q23": 1, "q24": 1,
             "q25": 10, "q26": 1, "q27": 10, "q28": 10, "q29": 1, "q30": 1}
_APPROX = {"q15": 1e-6}
#: the facts and the keys they are hash-repartitioned on
_FACTS = {"store_sales": "ss_item_sk", "web_sales": "ws_item_sk",
          "web_clickstreams": "wcs_user_sk"}
QUERIES = sorted(tbq.QUERIES, key=lambda n: int(n[1:]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs, and torch's pool of a thread per CPU in every worker
    would oversubscribe them on these small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    tables = jbb.gen_all(SCALE, seed=SEED)
    answers, plans = {}, {}
    for q in QUERIES:
        answers[q] = jbq.QUERIES[q](_frames(numpy_engine, tables,
                                            False)).collect()
        for rep in (False, True):
            plans[q, rep] = strategies(jbq.QUERIES[q](
                _frames(planner, tables, rep))._executed_plan())
    return answers, plans


@pytest.fixture(scope="module")
def port_tables():
    return tbb.gen_all(SCALE, seed=SEED)


def test_query_inventory_covers_all_30():
    assert QUERIES == sorted(jbq.QUERIES, key=lambda n: int(n[1:]))
    assert len(QUERIES) == 30 and tbq.UNSUPPORTED == ()
    assert set(tbq.COLUMNS) == set(QUERIES)


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["plain", "hash8"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(reference, port_tables, q, repartition):
    answers, plans = reference
    sess = TpuSession(CONF, device="cpu")
    got = tbq.QUERIES[q](_frames(sess, port_tables, repartition)).collect()
    assert strategies(sess.last_plan) == plans[q, repartition]
    assert got.num_rows >= _MIN_ROWS[q]
    assert_tables_equal(answers[q], got.to_arrow(), ignore_order=q in _TIES,
                        approx_float=_APPROX.get(q, 1e-9))


@pytest.mark.parametrize("q", QUERIES)
def test_columns_give_the_same_answer(reference, port_tables, q):
    """Each query over only the columns ``COLUMNS`` lists for it (and
    nothing else: a missing column fails binding) gives the full tables'
    answer."""
    answers, _ = reference
    tables = {t: port_tables[t].select(names)
              for t, names in tbq.COLUMNS[q].items()}
    sess = TpuSession(CONF, device="cpu")
    got = tbq.QUERIES[q](_frames(sess, tables, False)).collect()
    assert_tables_equal(answers[q], got.to_arrow(), ignore_order=q in _TIES,
                        approx_float=_APPROX.get(q, 1e-9))


def test_word_lists_equal_the_reference():
    for name in ("POSITIVE_WORDS", "NEGATIVE_WORDS", "COMPETITOR_COMPANIES"):
        assert getattr(tbb, name) == getattr(jbb, name)
    assert tuple(jbb._PAGE_TYPES) == tbb.PAGE_TYPES
    assert tuple(jbb._REVIEW_WORDS) == tbb._REVIEW_WORDS
    assert tuple(jbb._REVIEW_NOUNS) == tbb._REVIEW_NOUNS
    assert tds.STORE_NAMES == jds.STORE_NAMES


_ORDERS = {
    "date_dim": tds.DATE_DIM_COLUMNS, "time_dim": tds.TIME_DIM_COLUMNS,
    "item": tbb.ITEM_COLUMNS, "customer": tbb.CUSTOMER_COLUMNS,
    "customer_address": tds.CUSTOMER_ADDRESS_COLUMNS,
    "customer_demographics": tds.CUSTOMER_DEMOGRAPHICS_COLUMNS,
    "household_demographics": tds.HOUSEHOLD_DEMOGRAPHICS_COLUMNS,
    "store": tds.STORE_COLUMNS, "promotion": tds.PROMOTION_COLUMNS,
    "warehouse": tbb.WAREHOUSE_COLUMNS, "web_page": tbb.WEB_PAGE_COLUMNS,
    "product_reviews": tbb.PRODUCT_REVIEWS_COLUMNS,
    "store_sales": tds.STORE_SALES_COLUMNS,
    "store_returns": tbb.STORE_RETURNS_COLUMNS,
    "web_sales": tbb.WEB_SALES_COLUMNS,
    "web_returns": tbb.WEB_RETURNS_COLUMNS,
    "web_clickstreams": tbb.WEB_CLICKSTREAMS_COLUMNS,
    "inventory": tbb.INVENTORY_COLUMNS,
    "item_marketprices": tbb.ITEM_MARKETPRICES_COLUMNS,
}


@pytest.fixture(scope="module")
def jax_tables():
    return jbb.gen_all(SCALE, seed=SEED)


@pytest.mark.parametrize("table", tbb.TABLES)
def test_generators_match_reference(jax_tables, table):
    ref = jax_tables[table]
    order = _ORDERS[table]
    assert tuple(ref.column_names) == order
    picks = [None, [order[-1]], [order[0], order[len(order) // 2]]]
    picks += [[c] for c in order[1:-1]]
    for columns in picks:
        sub = ref if columns is None else ref.select(columns)
        want = HostBatch.from_arrow(sub)
        got = tbb.gen_all(SCALE, SEED, {table: columns},
                          tables=[table])[table]
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


@pytest.mark.parametrize("table", ["store_returns", "web_sales",
                                   "web_returns", "inventory",
                                   "item_marketprices", "product_reviews"])
def test_standalone_generators_match_gen_all(port_tables, table):
    """Each fact's own generator gives ``gen_all``'s table."""
    gen = getattr(tbb, f"gen_{table}")
    got = gen(SCALE, SEED)
    want = port_tables[table]
    assert got.schema == want.schema and got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        assert g.data.tobytes() == w.data.tobytes()
        assert np.array_equal(g.validity, w.validity)
