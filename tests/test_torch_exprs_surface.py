"""The expression surface ported last (``div``, ``%``, unary ``+``, the
double functions, ``signum``, ``rint``, ``atan2``, ``log(base, x)``, the
bitwise operators and shifts, the casts to strings and between dates,
timestamps and longs, the day and time parts, the unix-time conversions,
``initcap``, ``rlike``, ``regexp_replace``, the partition id and the float
normalisation) against the JAX package's same classes on its device path
(``jax.numpy`` under ``JAX_PLATFORMS=cpu``), on seeded inputs with nulls,
+-0.0, NaN, +-inf, Long.MIN/MAX, dates before 1970 and empty and multibyte
strings. Exact types are compared bit for bit (validity, and the data
wherever it is valid).

The transcendental functions are held to 2 ulps of the JAX device path,
but ``sinh``, ``cosh``, ``tanh`` and ``atanh``: XLA's CPU versions of
those are themselves 2 to 122 ulps from the correctly rounded value (held
against glibc through Python's ``math``), while torch's are within an ulp
of it. Those four are held to 2 ulps of ``math`` and to 128 ulps of the JAX
device path."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.execs.cpu_execs import _host_colvs
from spark_rapids_tpu.exprs import (arithmetic as jar, bitwise as jbw,
                                    datetime as jdt, math as jma, misc as jmi,
                                    strings as jst, windows as jwn)
from spark_rapids_tpu.exprs.core import ColV as JColV
from spark_rapids_tpu.exprs.core import EvalCtx as JEvalCtx
import spark_rapids_tpu_torch.exprs as T
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx

#: the JAX package's expression classes under the port's names
J = types.SimpleNamespace(**{
    **vars(jexprs), **{k: v for m in (jar, jbw, jdt, jma, jmi, jst)
                       for k, v in vars(m).items() if k[:1].isupper()},
    "DType": JDType})
P = types.SimpleNamespace(**vars(T), DType=DType)
N = 256
CAP = 32
CPU = torch.device("cpu")
I64, I32 = np.iinfo(np.int64), np.iinfo(np.int32)
_WORDS = ["hello", "wORLD", "a", "", "é日本", "x y", " lead", "trail ",
          "MiXeD cAsE", "aaa-bbb", "日 é"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strings(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        out.append(" ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS),
                                                            k))[:CAP])
    return out


def _table(seed=11):
    rng = np.random.default_rng(seed)
    null = lambda p=0.1: rng.random(N) < p          # noqa: E731
    lv = rng.integers(-10**12, 10**12, N).astype(np.int64)
    lv[:6] = [I64.min, I64.max, I64.min + 1, 0, -1, 7]
    iv = rng.integers(-10**6, 10**6, N).astype(np.int32)
    iv[:4] = [I32.min, I32.max, 0, -1]
    kv = rng.integers(-3, 4, N).astype(np.int64)      # divisors: 0 and -1
    kv[:6] = [-1, -1, 3, 0, -1, -2]
    d = rng.standard_normal(N) * 10
    d[:20] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e300, -1e300, 0.5, -0.5,
              2.5, -2.5, 1e-300, 710.0, -745.0, 9.3e18, -9.3e18, 1.5, 3.0,
              -7.75, 20.0]
    e = rng.choice([0.0, -0.0, np.nan, 3.0, -1.5, 0.25, 2.0, -np.inf], N)
    u = rng.uniform(-1, 1, N)
    u[:8] = [1.0, -1.0, 0.0, -0.0, 1.5, -2.0, np.nan, 1e-300]
    return pa.table({
        "l": pa.array(lv, mask=null()),
        "i": pa.array(iv, mask=null()),
        "k": pa.array(kv, mask=null()),
        "sh": pa.array(rng.integers(-5000, 5000, N).astype(np.int16),
                       mask=null()),
        "by": pa.array(rng.integers(-128, 128, N).astype(np.int8),
                       mask=null()),
        "amt": pa.array(rng.integers(-70, 70, N).astype(np.int32),
                        mask=null()),
        "d": pa.array(d, mask=null()),
        "e": pa.array(e, mask=null()),
        "u": pa.array(u, mask=null()),
        "f": pa.array(np.clip(d, -3e38, 3e38).astype(np.float32),
                      mask=null()),
        "bo": pa.array(rng.random(N) < 0.5, mask=null()),
        "dt": pa.array(rng.integers(-40000, 40000, N).astype(np.int32),
                       mask=null()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-3 * 10**15, 3 * 10**15, N),
                       mask=null()).cast(pa.timestamp("us", tz="UTC")),
        "secs": pa.array(rng.integers(-6 * 10**10, 2 * 10**11, N),
                         mask=null()),
        "s": pa.array(_strings(rng, N), mask=null()),
    })


@pytest.fixture(scope="module")
def inputs():
    table = _table()
    jb = JHostBatch.from_arrow(table, CAP)
    tb = HostBatch.from_arrow(table, CAP)
    jcols = [JColV(c.dtype, jnp.asarray(c.data), jnp.asarray(c.validity),
                   None if c.lengths is None else jnp.asarray(c.lengths))
             for c in _host_colvs(jb)]
    tcols = [ColV(c.dtype, torch.from_numpy(c.data),
                  torch.from_numpy(c.validity),
                  None if c.lengths is None else torch.from_numpy(c.lengths))
             for c in tb.columns]
    return jb, tb, jcols, tcols


def _eval_both(inputs, build, partition_id=0):
    """The JAX device path's value and the port's for one expression."""
    jb, tb, jcols, tcols = inputs
    je = J.bind_expression(build(J), jb.schema)
    te = T.bind_expression(build(P), tb.schema)
    assert je.dtype().value == te.dtype().value
    jctx = JEvalCtx(jnp, jcols, N, CAP)
    jctx.partition_id = partition_id
    jv = je.eval(jctx)
    tv = te.eval(EvalCtx(tcols, N, CPU, CAP, partition_id=partition_id))
    return jv, tv


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The ulps between two float64 arrays (sign-magnitude made
    monotone)."""
    ia, ib = a.view(np.int64), b.view(np.int64)
    ia = np.where(ia < 0, I64.min - ia, ia)
    ib = np.where(ib < 0, I64.min - ib, ib)
    return np.abs(ia.astype(np.float64) - ib.astype(np.float64))


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
    if jd.dtype.kind != "f":
        assert np.array_equal(jd, td)
        return
    assert np.array_equal(np.isnan(jd), np.isnan(td))
    ok = ~np.isnan(jd)
    if ulps:
        gap = _ulp_gap(jd[ok].astype(np.float64), td[ok].astype(np.float64))
        assert gap.max(initial=0) <= ulps, gap.max()
    else:
        assert jd[ok].tobytes() == td[ok].tobytes()


def _c(ns, name):
    return ns.UnresolvedAttribute(name)


def _lit(ns, v):
    return ns.Literal.of(v)


EXACT = {
    # arithmetic
    "div": lambda ns: ns.IntegralDivide(_c(ns, "l"), _c(ns, "k")),
    "div_int": lambda ns: ns.IntegralDivide(_c(ns, "i"), _c(ns, "k")),
    "div_min_by_minus_one": lambda ns: ns.IntegralDivide(
        _lit(ns, int(I64.min)), _lit(ns, -1)),
    "div_by_zero": lambda ns: ns.IntegralDivide(_c(ns, "l"), _lit(ns, 0)),
    "rem_long": lambda ns: ns.Remainder(_c(ns, "l"), _c(ns, "k")),
    "rem_int": lambda ns: ns.Remainder(_c(ns, "i"), _c(ns, "amt")),
    "rem_short": lambda ns: ns.Remainder(_c(ns, "sh"), _lit(ns, 7)),
    "rem_min_by_minus_one": lambda ns: ns.Remainder(
        _lit(ns, int(I64.min)), _lit(ns, -1)),
    "rem_double": lambda ns: ns.Remainder(_c(ns, "d"), _c(ns, "e")),
    "rem_float_by_int": lambda ns: ns.Remainder(_c(ns, "f"), _c(ns, "k")),
    "unary_positive": lambda ns: ns.UnaryPositive(_c(ns, "d")),
    # math, exact
    "floor": lambda ns: ns.Floor(_c(ns, "d")),
    "ceil": lambda ns: ns.Ceil(_c(ns, "d")),
    "floor_float": lambda ns: ns.Floor(_c(ns, "f")),
    "round_long_neg": lambda ns: ns.Round(_c(ns, "l"), -2),
    "round_int_neg": lambda ns: ns.Round(_c(ns, "i"), -1),
    "round_byte_neg": lambda ns: ns.Round(_c(ns, "by"), -1),
    "signum": lambda ns: ns.Signum(_c(ns, "d")),
    "signum_long": lambda ns: ns.Signum(_c(ns, "l")),
    "rint": lambda ns: ns.Rint(_c(ns, "d")),
    "sqrt": lambda ns: ns.Sqrt(_c(ns, "d")),
    "degrees": lambda ns: ns.ToDegrees(_c(ns, "d")),
    "radians": lambda ns: ns.ToRadians(_c(ns, "d")),
    # bitwise
    "and": lambda ns: ns.BitwiseAnd(_c(ns, "l"), _c(ns, "i")),
    "or": lambda ns: ns.BitwiseOr(_c(ns, "i"), _lit(ns, 0x0F0F)),
    "xor": lambda ns: ns.BitwiseXor(_c(ns, "l"), _c(ns, "k")),
    "not": lambda ns: ns.BitwiseNot(_c(ns, "l")),
    "not_byte": lambda ns: ns.BitwiseNot(_c(ns, "by")),
    "shl_long": lambda ns: ns.ShiftLeft(_c(ns, "l"), _c(ns, "amt")),
    "shl_int": lambda ns: ns.ShiftLeft(_c(ns, "i"), _c(ns, "amt")),
    "shr_long": lambda ns: ns.ShiftRight(_c(ns, "l"), _c(ns, "amt")),
    "shr_int": lambda ns: ns.ShiftRight(_c(ns, "i"), _lit(ns, 33)),
    "shru_long": lambda ns: ns.ShiftRightUnsigned(_c(ns, "l"),
                                                  _c(ns, "amt")),
    "shru_int": lambda ns: ns.ShiftRightUnsigned(_c(ns, "i"),
                                                 _c(ns, "amt")),
    # casts
    "cast_long_string": lambda ns: ns.Cast(_c(ns, "l"), ns.DType.STRING),
    "cast_int_string": lambda ns: ns.Cast(_c(ns, "i"), ns.DType.STRING),
    "cast_byte_string": lambda ns: ns.Cast(_c(ns, "by"), ns.DType.STRING),
    "cast_bool_string": lambda ns: ns.Cast(_c(ns, "bo"), ns.DType.STRING),
    "cast_literal_string": lambda ns: ns.Cast(_lit(ns, -120),
                                              ns.DType.STRING),
    "cast_ts_long": lambda ns: ns.Cast(_c(ns, "ts"), ns.DType.LONG),
    "cast_long_ts": lambda ns: ns.Cast(_c(ns, "secs"), ns.DType.TIMESTAMP),
    "cast_int_ts": lambda ns: ns.Cast(_c(ns, "i"), ns.DType.TIMESTAMP),
    "cast_date_int": lambda ns: ns.Cast(_c(ns, "dt"), ns.DType.INT),
    "cast_date_long": lambda ns: ns.Cast(_c(ns, "dt"), ns.DType.LONG),
    "cast_date_ts": lambda ns: ns.Cast(_c(ns, "dt"), ns.DType.TIMESTAMP),
    "cast_ts_date": lambda ns: ns.Cast(_c(ns, "ts"), ns.DType.DATE),
    "cast_bool_int": lambda ns: ns.Cast(_c(ns, "bo"), ns.DType.INT),
    "cast_double_byte": lambda ns: ns.Cast(_c(ns, "d"), ns.DType.BYTE),
    "cast_null_string": lambda ns: ns.Cast(_lit(ns, None), ns.DType.STRING),
    "cast_null_long": lambda ns: ns.Cast(_lit(ns, None), ns.DType.LONG),
    # date and time parts, unix time
    "dayofweek": lambda ns: ns.DayOfWeek(_c(ns, "dt")),
    "dayofweek_ts": lambda ns: ns.DayOfWeek(_c(ns, "ts")),
    "dayofyear": lambda ns: ns.DayOfYear(_c(ns, "dt")),
    "dayofyear_ts": lambda ns: ns.DayOfYear(_c(ns, "ts")),
    "quarter": lambda ns: ns.Quarter(_c(ns, "dt")),
    "last_day": lambda ns: ns.LastDay(_c(ns, "dt")),
    "last_day_ts": lambda ns: ns.LastDay(_c(ns, "ts")),
    "hour": lambda ns: ns.Hour(_c(ns, "ts")),
    "minute": lambda ns: ns.Minute(_c(ns, "ts")),
    "second": lambda ns: ns.Second(_c(ns, "ts")),
    "unix_timestamp_date": lambda ns: ns.UnixTimestamp(_c(ns, "dt")),
    "unix_timestamp_ts": lambda ns: ns.UnixTimestamp(_c(ns, "ts")),
    "to_unix_timestamp": lambda ns: ns.ToUnixTimestamp(_c(ns, "ts")),
    "from_unixtime": lambda ns: ns.FromUnixTime(_c(ns, "secs")),
    "from_unixtime_literal": lambda ns: ns.FromUnixTime(_lit(ns, 10**9)),
    # strings
    "initcap": lambda ns: ns.InitCap(_c(ns, "s")),
    "rlike": lambda ns: ns.RLike(_c(ns, "s"), _lit(ns, "l+o")),
    "rlike_class": lambda ns: ns.RLike(_c(ns, "s"), _lit(ns, "[A-Z][a-z]")),
    "rlike_alternation": lambda ns: ns.RLike(_c(ns, "s"),
                                             _lit(ns, "(ab|b)+-")),
    "rlike_multibyte": lambda ns: ns.RLike(_c(ns, "s"), _lit(ns, "é.")),
    "regexp_replace": lambda ns: ns.RegExpReplace(
        _c(ns, "s"), _lit(ns, "[aeiou]+"), _lit(ns, "_")),
    "regexp_replace_longest": lambda ns: ns.RegExpReplace(
        _c(ns, "s"), _lit(ns, "a|aa|aaa"), _lit(ns, "<日>")),
    "regexp_replace_delete": lambda ns: ns.RegExpReplace(
        _c(ns, "s"), _lit(ns, " +"), _lit(ns, "")),
    "regexp_replace_multibyte": lambda ns: ns.RegExpReplace(
        _c(ns, "s"), _lit(ns, "日"), _lit(ns, "ri")),
    "regexp_replace_null": lambda ns: ns.RegExpReplace(
        _c(ns, "s"), _lit(ns, None), _lit(ns, "x")),
    # misc
    "normalize_nan_zero": lambda ns: ns.NormalizeNaNAndZero(_c(ns, "d")),
    "normalize_float": lambda ns: ns.NormalizeNaNAndZero(_c(ns, "f")),
    "known_normalized": lambda ns: ns.KnownFloatingPointNormalized(
        _c(ns, "d")),
}

#: double functions within 2 ulps of the JAX device path (libm calls on
#: either side, each within an ulp of the exact value)
TWO_ULPS = {
    "cbrt": lambda ns: ns.Cbrt(_c(ns, "d")),
    "exp": lambda ns: ns.Exp(_c(ns, "d")),
    "expm1": lambda ns: ns.Expm1(_c(ns, "d")),
    "log": lambda ns: ns.Log(_c(ns, "d")),
    "log_long": lambda ns: ns.Log(_c(ns, "l")),
    "log2": lambda ns: ns.Log2(_c(ns, "d")),
    "log10": lambda ns: ns.Log10(_c(ns, "d")),
    "log1p": lambda ns: ns.Log1p(_c(ns, "d")),
    "sin": lambda ns: ns.Sin(_c(ns, "d")),
    "cos": lambda ns: ns.Cos(_c(ns, "d")),
    "tan": lambda ns: ns.Tan(_c(ns, "d")),
    "cot": lambda ns: ns.Cot(_c(ns, "d")),
    "asin": lambda ns: ns.Asin(_c(ns, "u")),
    "acos": lambda ns: ns.Acos(_c(ns, "u")),
    "atan": lambda ns: ns.Atan(_c(ns, "d")),
    "asinh": lambda ns: ns.Asinh(_c(ns, "d")),
    "acosh": lambda ns: ns.Acosh(_c(ns, "d")),
    "atan2": lambda ns: ns.Atan2(_c(ns, "d"), _c(ns, "e")),
    "atan2_int": lambda ns: ns.Atan2(_c(ns, "i"), _c(ns, "k")),
    "log_base": lambda ns: ns.Logarithm(_lit(ns, 2.0), _c(ns, "d")),
    "log_column_base": lambda ns: ns.Logarithm(_c(ns, "e"), _c(ns, "d")),
}

#: XLA's CPU sinh, cosh, tanh and atanh are 2-122 ulps from the correctly
#: rounded value: these hold to glibc's libm (``math``) instead
LIBM = {
    "sinh": (lambda ns: ns.Sinh(_c(ns, "d")), math.sinh),
    "cosh": (lambda ns: ns.Cosh(_c(ns, "d")), math.cosh),
    "tanh": (lambda ns: ns.Tanh(_c(ns, "d")), math.tanh),
    "atanh": (lambda ns: ns.Atanh(_c(ns, "u")), math.atanh),
}


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_expression_matches_device_path(inputs, name):
    _assert_same(*_eval_both(inputs, EXACT[name]))


@pytest.mark.parametrize("name", list(TWO_ULPS))
def test_transcendental_matches_device_path(inputs, name):
    _assert_same(*_eval_both(inputs, TWO_ULPS[name]), ulps=2)


def _libm(fn, x: float) -> float:
    try:
        return fn(x)
    except OverflowError:
        return math.copysign(math.inf, x) if fn is math.sinh else math.inf
    except ValueError:
        return math.copysign(math.inf, x) if abs(x) == 1 else math.nan


@pytest.mark.parametrize("name", list(LIBM))
def test_hyperbolic_matches_libm(inputs, name):
    build, fn = LIBM[name]
    jv, tv = _eval_both(inputs, build)
    _assert_same(jv, tv, ulps=128)
    valid = tv.validity.numpy()
    src = inputs[1].column_by_name("u" if name == "atanh" else "d").data
    got = tv.data.numpy()[valid]
    want = np.array([_libm(fn, float(v)) for v in src[valid]])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert _ulp_gap(got[ok], want[ok]).max(initial=0) <= 2


def test_spark_partition_id(inputs):
    _assert_same(*_eval_both(inputs, lambda ns: ns.SparkPartitionID(),
                             partition_id=5))


@pytest.mark.parametrize("what,src", [
    ("double", "d"), ("float", "f"), ("date", "dt")])
def test_refused_casts_raise_as_reference(inputs, what, src):
    """A cast the JAX package has no device form for stays refused, with
    its message: a float or a date to a string, a string to a number."""
    jb, tb, jcols, tcols = inputs
    je = J.bind_expression(J.Cast(_c(J, src), JDType.STRING), jb.schema)
    te = T.bind_expression(T.Cast(_c(T, src), DType.STRING), tb.schema)
    with pytest.raises(NotImplementedError) as jerr:
        je.eval(JEvalCtx(jnp, jcols, N, CAP))
    with pytest.raises(NotImplementedError) as terr:
        te.eval(EvalCtx(tcols, N, CPU, CAP))
    assert str(terr.value) == str(jerr.value)


def test_string_to_number_cast_is_refused(inputs):
    _, tb, _, tcols = inputs
    te = T.bind_expression(T.Cast(_c(T, "s"), DType.LONG), tb.schema)
    with pytest.raises(NotImplementedError,
                       match="cast DType.STRING -> DType.LONG has no device "
                             "kernel"):
        te.eval(EvalCtx(tcols, N, CPU, CAP))


def test_time_parts_of_a_date_are_midnight(inputs):
    """hour/minute/second of a DATE read it at midnight (Spark's cast):
    every part is 0. The JAX device path reads the day number as
    microseconds there (a divergence the ROADMAP records)."""
    _, tb, _, tcols = inputs
    for cls in (T.Hour, T.Minute, T.Second):
        te = T.bind_expression(cls(_c(T, "dt")), tb.schema)
        v = te.eval(EvalCtx(tcols, N, CPU, CAP))
        assert not v.data[v.validity].any()


_JAX_MODULES = {"arithmetic": jar, "math": jma, "bitwise": jbw,
                "datetime": jdt, "strings": jst, "windows": jwn}


@pytest.mark.parametrize("module", list(_JAX_MODULES))
def test_every_reference_expression_class_is_ported(module):
    """Every public expression class of the JAX package's ``exprs``
    modules has a port counterpart of the same name."""
    from spark_rapids_tpu.exprs.core import Expression as JExpression
    import importlib
    port = importlib.import_module(f"spark_rapids_tpu_torch.exprs.{module}")
    ref = _JAX_MODULES[module]
    names = [k for k, v in vars(ref).items()
             if isinstance(v, type) and issubclass(v, JExpression)
             and not k.startswith("_") and v.__module__ == ref.__name__]
    assert names
    assert [n for n in names if not hasattr(port, n)] == []
