"""Shared by the ``tests/test_torch_tpcds_*`` files, which split the 99
TPC-DS queries (as DataFrames and as SQL text) across files so that each
file stays short on one test worker: the reference tests' tie sets and
row floors, the benchmark conf, the DataFrames over a table set (the
three sales facts hash-repartitioned 8 ways on their item keys, as on the
card) and the join strategies of a plan of either engine."""
import gc

import pytest
import torch

from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF
from test_tpcds import _KNOWN_EMPTY, _MIN_ROWS
from test_tpcds import _TIES as DF_TIES
from test_tpcds_sql import _TIES as SQL_TIES

SCALE = 0.01
DF_SEED = 3           # tests/test_tpcds.py's tables
SQL_SEED = 0          # tests/test_tpcds_sql.py's tables
CONF = {**BENCH_CONF,
        "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
        "spark.rapids.tpu.sql.exec.CartesianProduct": "true"}
#: the sales facts and the item keys they are hash-repartitioned on
FACTS = {"store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
         "web_sales": "ws_item_sk"}
#: queries whose final sort can tie, in either reference test: a SQL
#: text's rows compare unordered with them (a DataFrame query's with
#: tests/test_tpcds.py's set alone)
TIES = DF_TIES | SQL_TIES
#: the bench subset, which tests/test_torch_tpcds.py holds
BENCH = {"q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42", "q52",
         "q55", "q67", "q68", "q96"}
#: the one query whose first join emits millions of rows at this scale; it
#: has files of its own
HEAVY = "q72"


def by_number(names):
    return sorted(names, key=lambda n: int(n[1:]))


def row_floor(q: str) -> int:
    """tests/test_tpcds.py's floor: none for a query known to be empty at
    this scale, else its ``_MIN_ROWS`` entry or 1."""
    return 0 if q in _KNOWN_EMPTY else _MIN_ROWS.get(q, 1)


def frames(sess, tables, repartition=False):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    if repartition:
        for t, key in FACTS.items():
            dfs[t] = dfs[t].repartition(8, key)
    return dfs


def strategies(plan):
    """The join execs of a plan of either engine, depth first."""
    name = type(plan).__name__
    out = [name] if "Join" in name or "Cartesian" in name else []
    for c in plan.children:
        out += strategies(c)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs: the test run's workers share
    the CPUs, and torch's pool of a thread per CPU in every worker would
    oversubscribe them.

    After the module, the garbage collector runs here: the sessions it
    made sit in reference cycles, and their finalizers, run at a point
    where no lock is held, do not fire later inside a device manager's
    lock (where the JAX package's waits on itself)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.collect()


def df_reference(queries, reps=(False, True)):
    """The JAX numpy engine's answers (``sql.enabled=false``) and the JAX
    TPU planner's join strategies (planned only, never run), per query and
    per ``repartition`` of ``reps``."""
    from spark_rapids_tpu.api import TpuSession as JaxSession
    from spark_rapids_tpu.benchmarks import tpcds_data as jds
    from spark_rapids_tpu.benchmarks import tpcds_queries as jdq
    numpy_engine = JaxSession({**CONF, "spark.rapids.tpu.sql.enabled":
                               "false"})
    planner = JaxSession(CONF)
    tables = jds.gen_all(SCALE, seed=DF_SEED)
    answers, plans = {}, {}
    for q in queries:
        answers[q] = jdq.QUERIES[q](frames(numpy_engine, tables)).collect()
        for rep in reps:
            plans[q, rep] = strategies(jdq.QUERIES[q](
                frames(planner, tables, rep))._executed_plan())
    return answers, plans


def check_df_query(reference, port_tables, q, repartition):
    """The port's run of query ``q`` on the CPU equals the JAX numpy
    engine's answer (unordered where its sort can tie, float sums within
    relative 1e-9), plans the JAX planner's join strategies and returns
    at least tests/test_tpcds.py's row floor."""
    from spark_rapids_tpu.testing import assert_tables_equal
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
    answers, plans = reference
    sess = TpuSession(CONF, device="cpu")
    got = tdq.QUERIES[q](frames(sess, port_tables, repartition)).collect()
    assert strategies(sess.last_plan) == plans[q, repartition]
    assert got.num_rows >= row_floor(q)
    assert_tables_equal(answers[q], got.to_arrow(),
                        ignore_order=q in DF_TIES, approx_float=1e-9)


def check_df_columns(reference, port_tables, q):
    """Query ``q`` over only the columns ``COLUMNS`` lists for it (a
    missing column fails binding) gives the full tables' answer."""
    from spark_rapids_tpu.testing import assert_tables_equal
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
    answers, _ = reference
    tables = {t: port_tables[t].select(names)
              for t, names in tdq.COLUMNS[q].items()}
    sess = TpuSession(CONF, device="cpu")
    got = tdq.QUERIES[q](frames(sess, tables)).collect()
    assert_tables_equal(answers[q], got.to_arrow(),
                        ignore_order=q in DF_TIES, approx_float=1e-9)


def sql_sessions():
    """(the JAX numpy engine's session and the port's CPU session, each
    with the 24 tables of tests/test_tpcds_sql.py's seed registered as
    temp views, and the port's DataFrames over the same tables)."""
    from spark_rapids_tpu.api import TpuSession as JaxSession
    from spark_rapids_tpu.benchmarks import tpcds_data as jds
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
    jsess = JaxSession({**CONF, "spark.rapids.tpu.sql.enabled": "false"})
    for name, tab in jds.gen_all(SCALE, seed=SQL_SEED).items():
        jsess.create_dataframe(tab).createOrReplaceTempView(name)
    sess = TpuSession(CONF, device="cpu")
    dfs = frames(sess, tds.gen_all(SCALE, seed=SQL_SEED))
    for name, df in dfs.items():
        df.createOrReplaceTempView(name)
    return jsess, sess, dfs


def check_sql_text(jsess, sess, q):
    """The port's ``sql()`` of query ``q``'s text equals the JAX numpy
    engine's run of the same text; returns the port's result."""
    from spark_rapids_tpu.benchmarks.tpcds_sql import SQL_QUERIES as JSQL
    from spark_rapids_tpu.testing import assert_tables_equal
    from spark_rapids_tpu_torch.benchmarks.tpcds_sql import SQL_QUERIES
    got = sess.sql(SQL_QUERIES[q]).collect()
    assert_tables_equal(jsess.sql(JSQL[q]).collect(), got.to_arrow(),
                        ignore_order=q in TIES, approx_float=1e-9)
    return got


def check_sql_against_dataframe(sess, dfs, q, got=None):
    """The port's ``sql()`` of query ``q`` equals its DataFrame query."""
    from spark_rapids_tpu.testing import assert_tables_equal
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
    from spark_rapids_tpu_torch.benchmarks.tpcds_sql import SQL_QUERIES
    if got is None:
        got = sess.sql(SQL_QUERIES[q]).collect()
    want = tdq.QUERIES[q](dfs).collect()
    assert_tables_equal(want.to_arrow(), got.to_arrow(),
                        ignore_order=q in TIES, approx_float=1e-9)


def check_fusion_on_equals_off(port_tables, q):
    """Query ``q`` with the fact tables hash 8 gives the same bits, row
    order included, with whole-stage fusion on (the default) and off."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
    from test_torch_fusion import assert_same_batch
    off_conf = {**CONF, "spark.rapids.tpu.sql.fusion.enabled": "false"}
    on, off = (tdq.QUERIES[q](frames(TpuSession(c, device="cpu"),
                                     port_tables, True)).collect()
               for c in (CONF, off_conf))
    assert_same_batch(on, off)
