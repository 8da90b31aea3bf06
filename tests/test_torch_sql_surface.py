"""The port's SQL and DataFrame surface (``benchmarks/sql_surface.py``
and the DataFrame extras) against the JAX package, at TPC-DS scale 0.01
(seed 0), through the port's ``TpuSession(device="cpu")`` and the JAX
package's ``TpuSession`` on its device path (``JAX_PLATFORMS=cpu``, ``incompatibleOps`` on so that its
byte-level regex and ASCII case mapping run there, as the port's do):

- the queries of ``benchmarks/sql_surface.py`` (``%``, casts to strings,
  ``regexp_replace``, the unix-time conversions, ``percent_rank`` and
  ``cume_dist``, framed ``min``/``max`` and ``first``/``last``, ``initcap``
  and ``rlike``, the day and time parts, the bitwise operators, shifts and
  transcendentals, a PIVOT), every value exact but doubles within the
  1e-9 carve-out;
- the TPC-DS specification's query38 (INTERSECT) and query87 (EXCEPT),
  each equal to its semi/anti-join rewrite in both packages (the JAX
  package's numpy engine there);
- the DataFrame extras: ``intersect``, ``subtract``, ``dropna``,
  ``fillna``, ``count``, ``take``, ``head``, ``first``, ``GroupedData.pivot``
  with and without its values, ``show()`` and ``describe()`` text byte for
  byte, and ``sample(fraction, seed)`` equal to the JAX numpy engine's
  sample (the port's ``rand`` draws that engine's stream); ``exceptAll`` and
  ``sample(withReplacement=True)`` raise in both."""
import datetime
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.testing import assert_tables_equal
import spark_rapids_tpu_torch.exprs as T
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window
from spark_rapids_tpu_torch.benchmarks import sql_surface as S
from spark_rapids_tpu_torch.benchmarks import tpcds_data as td
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF

JCONF = {**BENCH_CONF, "spark.rapids.tpu.sql.incompatibleOps.enabled": "true"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sessions():
    """The port's and the JAX package's sessions over the same TPC-DS
    tables, registered as views, and their DataFrames."""
    tables = td.gen_all(0.01, 0, S.COLUMNS, tables=list(S.COLUMNS))
    sess, jsess = TpuSession(BENCH_CONF, device="cpu"), JaxSession(JCONF)
    jcpu = JaxSession({**JCONF, "spark.rapids.tpu.sql.enabled": "false"})
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    jdfs = {k: jsess.create_dataframe(v.to_arrow())
            for k, v in tables.items()}
    for k, hb in tables.items():
        dfs[k].createOrReplaceTempView(k)
        jdfs[k].createOrReplaceTempView(k)
        jcpu.create_dataframe(hb.to_arrow()).createOrReplaceTempView(k)
    return types.SimpleNamespace(sess=sess, jsess=jsess, jcpu=jcpu, dfs=dfs,
                                 jdfs=jdfs)


def _equal(want, got):
    assert_tables_equal(want, got.to_arrow(), ignore_order=False,
                        approx_float=1e-9)


@pytest.mark.parametrize("name", list(S.SQL))
def test_surface_sql_matches_reference(sessions, name):
    got = sessions.sess.sql(S.SQL[name]).collect()
    assert got.num_rows > 0
    _equal(sessions.jsess.sql(S.SQL[name]).collect(), got)


@pytest.mark.parametrize("name", list(S.DATAFRAME))
def test_surface_dataframe_matches_reference(sessions, name):
    build = S.DATAFRAME[name]
    got = build(sessions.dfs, F, Window, T).collect()
    assert got.num_rows > 0
    _equal(build(sessions.jdfs, JF, JWindow, jexprs).collect(), got)


@pytest.mark.parametrize("q", list(S.SET_OPS))
def test_spec_set_operation_equals_rewrite(sessions, q):
    """The spec's INTERSECT/EXCEPT text equals its semi/anti-join form, in
    both packages (the JAX package's numpy engine: a count, exact in any
    engine, without a dozen jit compiles), and the two packages agree."""
    spec, rewrite = S.SET_OPS[q]
    counts = []
    for s in (sessions.sess, sessions.jcpu):
        a = s.sql(spec).collect()
        b = s.sql(rewrite).collect()
        if isinstance(a, pa.Table):
            a, b = a.column(0).to_pylist(), b.column(0).to_pylist()
        else:
            a, b = a.columns[0].to_pylist(1), b.columns[0].to_pylist(1)
        assert a == b
        counts.append(a)
    assert counts[0] == counts[1]


def _small():
    """Rows with nulls and NaN, duplicates, and every type fillna
    touches."""
    return pa.table({
        "a": pa.array([1, 1, 2, None, 3, 3, None, 7], pa.int64()),
        "b": pa.array(["x", "x", None, "é", "y", "y", None, ""]),
        "c": pa.array([1.5, 1.5, float("nan"), None, 2.0, 2.0, None, -0.0]),
        "d": pa.array([datetime.date(1969, 12, 31), None] * 4),
        "t": pa.array([True, True, None, False] * 2),
        "g": pa.array([0, 0, 1, 1, 2, 2, 3, 3], pa.int32()),
    })


def _other():
    return pa.table({
        "a": pa.array([1, None, 9, 3], pa.int64()),
        "b": pa.array(["x", None, "z", "q"]),
        "c": pa.array([1.5, None, 0.0, 2.0]),
        "d": pa.array([datetime.date(1969, 12, 31), None] * 2),
        "t": pa.array([True, False, None, False]),
        "g": pa.array([0, 3, 5, 2], pa.int32()),
    })


def _both(build):
    """``build(df, other, F)`` in both packages -> (want, got)."""
    jsess = JaxSession(JCONF)
    sess = TpuSession(BENCH_CONF, device="cpu")
    want = build(jsess.create_dataframe(_small()),
                 jsess.create_dataframe(_other()), JF)
    got = build(sess.create_dataframe(_small()),
                sess.create_dataframe(_other()), F)
    return want, got


EXTRAS = {
    "intersect": lambda df, o, f: df.intersect(o).sort("a", "b", "c"),
    "subtract": lambda df, o, f: df.subtract(o).sort("a", "b", "c"),
    "intersect_renamed": lambda df, o, f: df.select("a", "b").intersect(
        o.select(f.col("a").alias("x"), f.col("b").alias("y"))).sort("a"),
    "dropna_any": lambda df, o, f: df.dropna(),
    "dropna_all_subset": lambda df, o, f: df.dropna("all", subset=["a", "c"]),
    "dropna_thresh": lambda df, o, f: df.dropna(thresh=5),
    "fillna_int": lambda df, o, f: df.fillna(0),
    "fillna_float_into_int": lambda df, o, f: df.fillna(2.75),
    "fillna_dict": lambda df, o, f: df.fillna({"b": "none", "t": True,
                                               "c": -1.0}),
    "pivot_values": lambda df, o, f: df.groupBy("g").pivot(
        "b", ["x", "y", None]).agg(f.count("a")).sort("g"),
    "pivot_discovered": lambda df, o, f: df.groupBy("g").pivot("a").agg(
        f.sum("g").alias("s"), f.max("b").alias("m")).sort("g"),
    "grouped_shortcuts": lambda df, o, f: df.groupBy("g").max("a")
    .join(df.groupBy("g").count(), "g").sort("g"),
}


@pytest.mark.parametrize("name", list(EXTRAS))
def test_dataframe_extra_matches_reference(name):
    want, got = _both(EXTRAS[name])
    _equal(want.collect(), got.collect())


def test_row_actions_match_reference():
    """count, take, head and first give the same Python values."""
    want, got = _both(lambda df, o, f: df.sort("g", "a"))
    assert got.count() == want.count() == 8
    assert got.take(3) == want.take(3)
    assert got.head(2) == want.head(2)
    assert got.head() == want.head() == got.first()
    assert got.filter(F.col("g") > 9).head() is None


def test_show_and_describe_text_match_reference(capsys):
    """show() (truncated and not) and describe().show() print the same
    bytes in both packages."""
    def texts(df, f):
        df.show()
        df.show(3, truncate=False)
        df.withColumn("long", f.concat(f.col("b"), f.lit(" " * 30)))\
            .show(4, truncate=5)
        df.select("a", "g", "b").describe().show()
        df.describe("g").show()
        return capsys.readouterr().out
    jsess = JaxSession(JCONF)
    sess = TpuSession(BENCH_CONF, device="cpu")
    want = texts(jsess.create_dataframe(_small()), JF)
    got = texts(sess.create_dataframe(_small()), F)
    assert got == want
    assert "summary" in got


def test_sample_matches_reference_numpy_engine():
    """sample(fraction, seed) keeps the rows the JAX numpy engine keeps:
    the port's rand draws that engine's stream (its device path draws
    threefry)."""
    table = pa.table({"k": pa.array(np.arange(5000, dtype=np.int64))})
    jsess = JaxSession({**JCONF, "spark.rapids.tpu.sql.enabled": "false"})
    sess = TpuSession(BENCH_CONF, device="cpu")
    for args in ((0.1, 7), (False, 0.3, 11)):
        want = jsess.create_dataframe(table).sample(*args).collect()
        got = sess.create_dataframe(table).sample(*args).collect()
        assert 0 < got.num_rows < 5000
        _equal(want, got)


@pytest.mark.parametrize("call", ["exceptAll", "sample_with_replacement"])
def test_refused_extras_raise_as_reference(call):
    for sess in (JaxSession(JCONF), TpuSession(BENCH_CONF, device="cpu")):
        df = sess.create_dataframe(_small())
        with pytest.raises(NotImplementedError):
            if call == "exceptAll":
                df.exceptAll(df)
            else:
                df.sample(True, 0.5, 1)
