"""The expressions this slice ports, against the JAX package's same classes
on its numpy engine (``xp=np``): ``UnaryMinus``, ``Abs``, ``Floor``,
``Ceil``, ``Sqrt``, ``Pow``, ``NaNvl``, ``Greatest``, ``Least`` and a cast
by type name over nulls, the integral minimum and maximum, +-0.0, NaN and
+-inf; ``DateAdd``, ``DateSub`` and ``WeekDay`` over dates before and
after 1970 and timestamps; ``Upper``, ``Lower``, ``Length``, the trims,
``Concat``, the pads, ``StringLocate`` and ``StringReplace`` over empty
strings, strings at the session's width cap and multibyte UTF-8. Every
result must be exact (validity, and the data wherever it is valid) but
``pow``'s, which may differ by two ulps: both sides call a libm pow that
is not correctly rounded. ``Floor`` and ``Ceil`` of a double are held
against the JAX device path (``jax.numpy``): out of the long range and on
NaN the numpy engine's conversion is not Spark's.
``ntile`` and ``sum(distinct)`` equal the JAX device path in every
grouping mode; the row id (``monotonically_increasing_id``) equals it on a
one-batch partition, stays unique and increasing over a partition of
several batches and over eight hash partitions, and breaks a fused
chain."""
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.execs.cpu_execs import _host_colvs
from spark_rapids_tpu.exprs.core import ColV as JColV
from spark_rapids_tpu.exprs.core import EvalCtx as JEvalCtx
from spark_rapids_tpu.exprs.datetime import WeekDay as JWeekDay
from spark_rapids_tpu.testing import assert_tables_equal
import spark_rapids_tpu_torch.exprs as T
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.tpu_execs import (TpuHashAggregateExec,
                                                    TpuProjectExec)
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
from spark_rapids_tpu_torch.plan import fusion as tfusion

#: the JAX package's expression classes under the port's names
J = types.SimpleNamespace(**vars(jexprs), WeekDay=JWeekDay, DType=JDType)
P = types.SimpleNamespace(**vars(T), DType=DType)
N = 240
CAP = 24                                 # the session's string width cap
CPU = torch.device("cpu")
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
_ALPHABET = ["a", "b", "x", " ", ",", "é", "日", "A", "Z"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strings(rng, n):
    """Empty, short and cap-long strings, multibyte ones among them."""
    out = []
    for r in range(n):
        if r % 11 == 0:
            out.append("")
        elif r % 7 == 0:        # exactly CAP bytes, multibyte inside
            s = "é" * (r % 5) + "a" * (CAP - 2 * (r % 5))
            out.append(s)
        else:
            k = rng.integers(0, 14)
            out.append("".join(_ALPHABET[j] for j in
                               rng.integers(0, len(_ALPHABET), k)))
    return out


def _table(seed=5):
    rng = np.random.default_rng(seed)
    null = lambda p=0.12: rng.random(N) < p          # noqa: E731
    i64, i32 = np.iinfo(np.int64), np.iinfo(np.int32)
    lv = rng.integers(-9, 10, N).astype(np.int64)
    lv[:4] = [i64.min, i64.max, i64.min + 1, 0]
    iv = rng.integers(-9, 10, N).astype(np.int32)
    iv[:4] = [i32.min, i32.max, i32.min + 1, 0]
    d = rng.choice([0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -2.5, 1e300,
                    -7.75, 0.5, 3.0, -1e-300], N)
    days = rng.integers(-30000, 40000, N).astype(np.int32)
    return pa.table({
        "l": pa.array(lv, mask=null()),
        "i": pa.array(iv, mask=null()),
        "d": pa.array(d, mask=null()),
        "e": pa.array(rng.choice([0.0, 2.0, -1.5, np.nan, 0.5, 3.0], N),
                      mask=null()),
        "n": pa.array(rng.integers(-400, 400, N).astype(np.int32),
                      mask=null()),
        "dt": pa.array(days, mask=null()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-3 * 10**15, 3 * 10**15, N),
                       mask=null()).cast(pa.timestamp("us", tz="UTC")),
        "s": pa.array(_strings(rng, N), mask=null()),
        "t": pa.array(_strings(rng, N), mask=null()),
    })


@pytest.fixture(scope="module")
def inputs():
    table = _table()
    jb = JHostBatch.from_arrow(table, CAP)
    tb = HostBatch.from_arrow(table, CAP)
    tcols = [ColV(c.dtype, torch.from_numpy(c.data), torch.from_numpy(
        c.validity), None if c.lengths is None else torch.from_numpy(
        c.lengths)) for c in tb.columns]
    return jb, tb, _host_colvs(jb), tcols


def _eval_both(inputs, build, xp=np):
    """The JAX class's value on ``xp`` (its numpy engine, or its device
    path under ``jax.numpy``) and the port's."""
    jb, tb, jcols, tcols = inputs
    je = J.bind_expression(build(J), jb.schema)
    te = T.bind_expression(build(P), tb.schema)
    assert je.dtype().value == te.dtype().value
    if xp is not np:
        jcols = [JColV(c.dtype, xp.asarray(c.data), xp.asarray(c.validity),
                       None if c.lengths is None else xp.asarray(c.lengths))
                 for c in jcols]
    with np.errstate(all="ignore"):
        jv = je.eval(JEvalCtx(xp, jcols, N, CAP))
    tv = te.eval(EvalCtx(tcols, N, CPU, CAP))
    return jv, tv


def _assert_same(jv, tv, ulps=0):
    jvalid = np.broadcast_to(np.asarray(jv.validity), (N,))
    tvalid = np.broadcast_to(tv.validity.numpy(), (N,))
    assert np.array_equal(jvalid, tvalid)
    if jv.lengths is not None:
        jl = np.broadcast_to(np.asarray(jv.lengths), (N,))
        tl = np.broadcast_to(tv.lengths.numpy(), (N,))
        assert np.array_equal(jl[jvalid], tl[jvalid])
        jd, td = np.asarray(jv.data), tv.data.numpy()
        for r in np.nonzero(jvalid)[0]:
            row_j = jd if jd.ndim == 1 else jd[r]
            row_t = td if td.ndim == 1 else td[r]
            assert bytes(row_j[:jl[r]]) == bytes(row_t[:tl[r]]), r
        return
    jd = np.broadcast_to(np.asarray(jv.data), (N,))
    td = np.broadcast_to(tv.data.numpy(), (N,))
    assert jd.dtype == td.dtype
    jd, td = jd[jvalid], td[jvalid]
    if jd.dtype.kind == "f":
        # bit for bit: -0.0 apart from 0.0, every NaN a NaN
        assert np.array_equal(np.isnan(jd), np.isnan(td))
        ok = ~np.isnan(jd)
        if ulps:
            np.testing.assert_array_max_ulp(jd[ok], td[ok], maxulp=ulps)
        else:
            assert jd[ok].tobytes() == td[ok].tobytes()
    else:
        assert np.array_equal(jd, td)


def _c(ns, name):
    return ns.UnresolvedAttribute(name)


def _lit(ns, v):
    return ns.Literal.of(v)


NUMERIC = {
    "neg_long": lambda ns: ns.UnaryMinus(_c(ns, "l")),
    "neg_int": lambda ns: ns.UnaryMinus(_c(ns, "i")),
    "neg_double": lambda ns: ns.UnaryMinus(_c(ns, "d")),
    "neg_literal": lambda ns: ns.UnaryMinus(_lit(ns, 5)),
    "abs_long": lambda ns: ns.Abs(_c(ns, "l")),
    "abs_int": lambda ns: ns.Abs(_c(ns, "i")),
    "abs_double": lambda ns: ns.Abs(_c(ns, "d")),
    "floor_double": lambda ns: ns.Floor(_c(ns, "d")),
    "ceil_double": lambda ns: ns.Ceil(_c(ns, "d")),
    "floor_int": lambda ns: ns.Floor(_c(ns, "i")),
    "ceil_long": lambda ns: ns.Ceil(_c(ns, "l")),
    "sqrt_double": lambda ns: ns.Sqrt(_c(ns, "d")),
    "sqrt_long": lambda ns: ns.Sqrt(_c(ns, "l")),
    "pow": lambda ns: ns.Pow(_c(ns, "d"), _c(ns, "e")),
    "pow_int": lambda ns: ns.Pow(_c(ns, "i"), _lit(ns, 2)),
    "nanvl": lambda ns: ns.NaNvl(_c(ns, "d"), _c(ns, "e")),
    "greatest": lambda ns: ns.Greatest((_c(ns, "d"), _c(ns, "e"),
                                        _lit(ns, 0.25))),
    "least": lambda ns: ns.Least((_c(ns, "d"), _c(ns, "e"))),
    "greatest_ints": lambda ns: ns.Greatest((_c(ns, "i"), _c(ns, "l"))),
    "least_ints": lambda ns: ns.Least((_c(ns, "l"), _c(ns, "n"),
                                       _lit(ns, 3))),
    "cast_long_by_name": lambda ns: ns.Cast(_c(ns, "i"), ns.DType("long")),
    "cast_int_by_name": lambda ns: ns.Cast(_c(ns, "l"), ns.DType("int")),
    "cast_double_by_name": lambda ns: ns.Cast(_c(ns, "n"),
                                              ns.DType("double")),
    "date_add_literal": lambda ns: ns.DateAdd(_c(ns, "dt"), _lit(ns, 45)),
    "date_add_column": lambda ns: ns.DateAdd(_c(ns, "dt"), _c(ns, "n")),
    "date_sub_literal": lambda ns: ns.DateSub(_c(ns, "dt"), _lit(ns, 400)),
    "date_sub_column": lambda ns: ns.DateSub(_c(ns, "dt"), _c(ns, "n")),
    "weekday_date": lambda ns: ns.WeekDay(_c(ns, "dt")),
    "weekday_timestamp": lambda ns: ns.WeekDay(_c(ns, "ts")),
}

STRINGS = {
    "upper": lambda ns: ns.Upper(_c(ns, "s")),
    "lower": lambda ns: ns.Lower(_c(ns, "s")),
    "length": lambda ns: ns.Length(_c(ns, "s")),
    "trim": lambda ns: ns.StringTrim(_c(ns, "s")),
    "ltrim": lambda ns: ns.StringTrimLeft(_c(ns, "s")),
    "rtrim": lambda ns: ns.StringTrimRight(_c(ns, "s")),
    "trim_chars": lambda ns: ns.StringTrim(_c(ns, "s"), _lit(ns, "ax ")),
    "ltrim_chars": lambda ns: ns.StringTrimLeft(_c(ns, "s"),
                                                _lit(ns, "a,")),
    "rtrim_chars": lambda ns: ns.StringTrimRight(_c(ns, "s"),
                                                 _lit(ns, "Zb")),
    "concat": lambda ns: ns.Concat((_c(ns, "s"), _c(ns, "t"))),
    "concat3": lambda ns: ns.Concat((_c(ns, "s"), _lit(ns, "-é-"),
                                     _c(ns, "t"))),
    "lpad": lambda ns: ns.StringLPad(_c(ns, "s"), _lit(ns, 8),
                                     _lit(ns, "*")),
    "lpad_multibyte": lambda ns: ns.StringLPad(_c(ns, "s"), _lit(ns, 20),
                                               _lit(ns, "日é")),
    "rpad_cut": lambda ns: ns.StringRPad(_c(ns, "s"), _lit(ns, 3),
                                         _lit(ns, "-")),
    "rpad_past_cap": lambda ns: ns.StringRPad(_c(ns, "s"), _lit(ns, 30),
                                              _lit(ns, "ab")),
    "lpad_empty_pad": lambda ns: ns.StringLPad(_c(ns, "s"), _lit(ns, 4),
                                               _lit(ns, "")),
    "lpad_null_pad": lambda ns: ns.StringLPad(_c(ns, "s"), _lit(ns, 4),
                                              _lit(ns, None)),
    "instr": lambda ns: ns.StringLocate(_lit(ns, "a"), _c(ns, "s"),
                                        _lit(ns, 1)),
    "locate_multibyte": lambda ns: ns.StringLocate(_lit(ns, "é"),
                                                   _c(ns, "s"),
                                                   _lit(ns, 2)),
    "locate_start0": lambda ns: ns.StringLocate(_lit(ns, "a"), _c(ns, "s"),
                                                _lit(ns, 0)),
    "locate_empty": lambda ns: ns.StringLocate(_lit(ns, ""), _c(ns, "s"),
                                               _lit(ns, 1)),
    "locate_null_needle": lambda ns: ns.StringLocate(
        _lit(ns, None), _c(ns, "s"), _lit(ns, 1)),
    "replace_longer": lambda ns: ns.StringReplace(
        _c(ns, "s"), _lit(ns, "a"), _lit(ns, "日日")),
    "replace_shorter": lambda ns: ns.StringReplace(
        _c(ns, "s"), _lit(ns, "é"), _lit(ns, "e")),
    "replace_delete": lambda ns: ns.StringReplace(
        _c(ns, "s"), _lit(ns, "ab"), _lit(ns, "")),
    "replace_empty_search": lambda ns: ns.StringReplace(
        _c(ns, "s"), _lit(ns, ""), _lit(ns, "x")),
    "upper_literal": lambda ns: ns.Upper(_lit(ns, "héllo")),
    "length_literal": lambda ns: ns.Length(_lit(ns, "日本")),
}


#: pow is a libm call on either side: numpy's SIMD pow and torch's are
#: each within an ulp of the exact power, not correctly rounded, so they
#: may differ by up to two ulps; every other result is bit for bit
_ULPS = {"pow": 2, "pow_int": 2}

#: a float out of the long range (+-inf, 1e300) or NaN under floor/ceil:
#: the JAX numpy engine's conversion gives Long.MIN, not Spark's answer;
#: its device path saturates and takes NaN to 0, so it is the yardstick
_DEVICE_PATH = {"floor_double", "ceil_double"}


@pytest.mark.parametrize("name", list(NUMERIC))
def test_numeric_and_date_expression_matches_reference(inputs, name):
    xp = jnp if name in _DEVICE_PATH else np
    _assert_same(*_eval_both(inputs, NUMERIC[name], xp), _ULPS.get(name, 0))


@pytest.mark.parametrize("name", list(STRINGS))
def test_string_expression_matches_reference(inputs, name):
    _assert_same(*_eval_both(inputs, STRINGS[name]))


def test_greatest_over_strings_is_not_ported():
    e = T.Greatest((T.Literal.of("a"), T.Literal.of("b")))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        e.eval(EvalCtx([], 1, CPU))


# -------------------------------------------- against the JAX device path
def _group_table(n, groups, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "ks": pa.array(np.char.add("g", (k % 997).astype(str)),
                       mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-50, 50, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-3, 4, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "x": pa.array(rng.choice([0.5, -0.0, 0.0, 2.25, -1.5], n),
                      mask=rng.random(n) < 0.1),
    })


def _both(table, build, ignore_order=True):
    jsess = JaxSession(CONF)
    want = build(jsess.create_dataframe(table), JF, JWindow).collect()
    sess = TpuSession(CONF, device="cpu")
    got = build(sess.create_dataframe(table), F, Window).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=ignore_order,
                        approx_float=1e-9)
    return sess, got


@pytest.mark.parametrize("spec", ["part", "no_partition", "string_part",
                                  "one_bucket", "more_buckets_than_rows"])
def test_ntile_matches_reference(spec):
    def build(df, f, win):
        n = {"one_bucket": 1, "more_buckets_than_rows": 500}.get(spec, 4)
        if spec == "no_partition":
            ws = win.orderBy("v", "w")
        elif spec == "string_part":
            ws = win.partitionBy("ks").orderBy(f.col("v").desc(), "w")
        else:
            ws = win.partitionBy("k").orderBy("v", "w")
        return df.select("k", "ks", "v", "w", f.ntile(n).over(ws).alias("nt"))
    _both(_group_table(3000, 30, seed=8), build, ignore_order=False)


@pytest.mark.parametrize("mode,keys,groups,rows", [
    ("global", (), 10, 3000),
    ("onehot", ("k",), 20, 3000),
    ("hash", ("ks",), 3000, 20000),
    ("sort", ("k",), 70000, 210000),
])
def test_sum_distinct_matches_reference(mode, keys, groups, rows):
    """sum(distinct) (the join-based distinct rewrite) beside a regular
    aggregate, over ints and doubles with nulls and -0.0, in each grouping
    mode of its outer aggregate."""
    def build(df, f, _w):
        return df.groupBy(*keys).agg(f.sumDistinct("v").alias("sv"),
                                     f.sumDistinct("x").alias("sx"),
                                     f.count("w").alias("n"))
    sess, got = _both(_group_table(rows, groups, seed=groups), build)
    aggs = [e for e in sess.last_plan.walk()
            if isinstance(e, TpuHashAggregateExec)]
    if mode == "global":
        assert got.num_rows == 1
    else:
        assert any(a.modes_run and a.modes_run[-1] == mode for a in aggs)


# --------------------------------------------------------------- row id
def _ids(hb):
    col = hb.column_by_name("id")
    assert col.validity.all()
    return col.data


def test_row_id_matches_reference_on_one_batch():
    _both(_group_table(2000, 10, seed=9),
          lambda df, f, _w: df.select("k", "v", f.monotonically_increasing_id()
                                      .alias("id")), ignore_order=False)


def test_row_id_is_unique_over_several_batches():
    """A union's partition yields each branch's batch in turn: the ids run
    on across them (the reference, without a running offset, repeats
    them)."""
    table = _group_table(1500, 10, seed=10)
    sess = TpuSession(CONF, device="cpu")
    df = sess.create_dataframe(table)
    out = (df.union(df.filter(F.col("w") > 0)).union(df)
           .withColumn("id", F.monotonically_increasing_id())).collect()
    ids = _ids(out)
    assert out.num_rows == 2 * 1500 + int(np.sum(
        np.nan_to_num(table.column("w").to_numpy(zero_copy_only=False),
                      nan=0) > 0))
    assert np.array_equal(ids, np.arange(out.num_rows))


def test_row_id_is_unique_over_eight_hash_partitions():
    table = _group_table(4000, 50, seed=11)
    sess = TpuSession(CONF, device="cpu")
    df = sess.create_dataframe(table).repartition(8, "k")
    out = df.union(df).withColumn("id", F.monotonically_increasing_id()) \
        .collect()
    ids = _ids(out)
    assert len(np.unique(ids)) == out.num_rows == 8000
    part = ids >> 33
    assert set(part.tolist()) <= set(range(8))
    for p in range(8):
        mine = ids[part == p] - (p << 33)
        assert np.array_equal(mine, np.arange(mine.shape[0]))


def test_row_id_breaks_a_fused_chain():
    """The projection holding the row id stays its own exec, as rand's
    does: the filters around it fuse apart, and no aggregate folds it."""
    table = _group_table(1000, 10, seed=12)
    sess = TpuSession(CONF, device="cpu")
    df = (sess.create_dataframe(table).filter(F.col("v") > 0)
          .withColumn("id", F.monotonically_increasing_id())
          .filter(F.col("w") > 0).select("k", "id"))
    plan = df.physical_plan()
    projects = [e for e in plan.walk() if isinstance(e, TpuProjectExec)
                and any(isinstance(x, T.MonotonicallyIncreasingID)
                        for a in e.exprs for x in _walk(a))]
    assert len(projects) == 1
    for stage in tfusion.fused_stages(plan):
        for variant in getattr(stage, "variants", ()):
            assert not any(isinstance(x, T.MonotonicallyIncreasingID)
                           for e in variant[0] for x in _walk(e))
    grouped = df.groupBy("k").agg(F.max("id").alias("m"))
    agg = [e for e in grouped.physical_plan().walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert not any(isinstance(x, T.MonotonicallyIncreasingID)
                   for a in agg for e in a.aggregates for x in _walk(e))
    got = df.collect()
    keep = (np.nan_to_num(table.column("v").to_numpy(zero_copy_only=False),
                          nan=0) > 0)
    assert np.unique(_ids(got)).shape[0] == got.num_rows
    assert got.num_rows <= int(keep.sum())


def _walk(e):
    yield e
    for c in e.children:
        yield from _walk(c)
