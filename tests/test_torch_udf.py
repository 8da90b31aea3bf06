"""The port's UDF layer (``spark_rapids_tpu_torch/udf``, ``F.udf``) against
the JAX package's: ``tests/test_udf.py`` case for case, each case's result
on the port's row fallback, on the port's compiled UDF and on the JAX
package's fallback, equal; the compiled tree of every test function equal
to the JAX compiler's node for node; the compiler's text equal to the JAX
file's apart from import lines. The port side runs on the CPU
(``device="cpu"``), the JAX side under ``JAX_PLATFORMS=cpu``."""
import math
from pathlib import Path

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.exprs.core import BoundReference as JRef
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu.udf import compile_udf as j_compile_udf
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import BoundReference
from spark_rapids_tpu_torch.udf import (PythonUDF, UdfCompileError,
                                        compile_udf)

ROOT = Path(__file__).resolve().parents[1]
COMPILE = {"spark.rapids.tpu.sql.udfCompiler.enabled": "true",
           "spark.rapids.tpu.sql.incompatibleOps.enabled": "true"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the UDFs
def f_branches(x, y):
    if x > 0:
        return x + y * 2.0
    return abs(x - 1) if y > 0 else 0.0


def g_bool(a, b):
    return (a > b and a < 8) or a == 10


def h_math(x):
    return math.sqrt(x) + math.log(x) - math.pow(x, 0.5)


def m_minmax(x, y):
    return min(x, y) + max(x, y) + round(x)


def up(s):
    return s.upper() if s is not None else None


def pref(s):
    return s.startswith("B") if s is not None else None


def isin(a):
    return a in (1, 3)


def slen(s):
    return len(s) if s is not None else None


def double_it(a):
    return a * 2


def keep(a):
    return a % 2 == 0


def looped(a):
    total = 0
    for i in range(3):
        total += a
    return total


def nz(x):
    return 0.0 if x is None else x


def charge(price, tax):
    return price * (1.0 + tax)


#: tests/test_udf.py's cases: (name, table, [(udf, return type, args,
#: alias)], float tolerance)
CASES = {
    "arithmetic_and_branches": (
        {"x": pa.array([1.0, -2.5, 0.5, 4.0]),
         "y": pa.array([2.0, 3.0, 1.0, -1.0])},
        [(f_branches, "double", ("x", "y"), "r")], None),
    "boolean_ops_and_comparisons": (
        {"a": pa.array([1, 5, 10], type=pa.int64()),
         "b": pa.array([2, 2, 2], type=pa.int64())},
        [(g_bool, "boolean", ("a", "b"), "r")], None),
    "math_functions": (
        {"x": pa.array([1.0, 4.0, 9.0])},
        [(h_math, "double", ("x",), "r")], 1e-9),
    "min_max_round": (
        {"x": pa.array([1.4, 2.6]), "y": pa.array([2.0, 1.0])},
        [(m_minmax, "double", ("x", "y"), "r")], None),
    "string_methods_and_none_guard": (
        {"s": pa.array(["a", "Bc", None, " d "])},
        [(up, "string", ("s",), "u"), (pref, "boolean", ("s",), "p")], None),
    "in_tuple_and_len": (
        {"a": pa.array([1, 2, 3], type=pa.int64()),
         "s": pa.array(["ab", "c", "defg"])},
        [(isin, "boolean", ("a",), "i"), (slen, "int", ("s",), "n")], None),
    "declared_return_type_cast": (
        {"a": pa.array([1, 2], type=pa.int64())},
        [(double_it, "long", ("a",), "r")], None),
    "is_none_compiles": (
        {"x": pa.array([1.0, None, 3.0])},
        [(nz, "double", ("x",), "r")], None),
}


def _select(sess, funcs, table, udf):
    df = sess.create_dataframe(pa.table(table))
    return df.select(*[udf(fn, ret)(*args).alias(alias)
                       for fn, ret, args, alias in funcs])


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case):
    """tests/test_udf.py's ``run_both``: the fallback's explain names the
    missing implementation, the compiled plan projects on the device, and
    the port's fallback, the port's compiled UDF and the JAX package's
    fallback agree."""
    table, funcs, approx = CASES[case]
    fb = TpuSession({}, device="cpu")
    got_fb = _select(fb, funcs, table, F.udf).collect()
    assert "no TPU implementation" in fb.last_explain
    comp = TpuSession(COMPILE, device="cpu")
    got_c = _select(comp, funcs, table, F.udf).collect()
    assert "TpuProjectExec" in comp.last_plan.tree_string(), comp.last_explain
    jfb = JaxSession({})
    want = _select(jfb, funcs, table, JF.udf).collect()
    assert jfb.last_explain == fb.last_explain
    assert_tables_equal(want, got_fb.to_arrow(), approx_float=approx)
    assert_tables_equal(want, got_c.to_arrow(), approx_float=approx)


def test_udf_in_filter_and_agg_pipeline():
    """The compiled filter UDF folds into the device aggregation; no
    operator runs on the CPU engine."""
    table = pa.table({"a": pa.array([1, 2, 3, 4], type=pa.int64()),
                      "g": pa.array(["x", "y", "x", "y"])})
    s = TpuSession(COMPILE, device="cpu")
    out = (s.create_dataframe(table).filter(F.udf(keep, "boolean")("a"))
           .groupBy("g").agg(F.sum("a").alias("sa")).sort("g").collect())
    assert out.to_arrow().column("g").to_pylist() == ["y"]
    assert out.to_arrow().column("sa").to_pylist() == [6]
    names = [type(n).__name__ for n in s.last_plan.walk()]
    assert not [n for n in names if n.startswith("Cpu")
                and n != "CpuLocalScanExec"], names
    assert any("Aggregate" in n for n in names), names


def test_uncompilable_falls_back():
    """A loop does not compile: the row fallback, still correct, with the
    JAX package's explain."""
    table = pa.table({"a": pa.array([3, 4], type=pa.int64())})
    s = TpuSession(COMPILE, device="cpu")
    out = s.create_dataframe(table).select(
        F.udf(looped, "long")("a").alias("r")).collect()
    assert out.to_arrow().column("r").to_pylist() == [9, 12]
    assert "no TPU implementation" in s.last_explain
    js = JaxSession(COMPILE)
    js.create_dataframe(table).select(
        JF.udf(looped, "long")("a").alias("r")).collect()
    assert js.last_explain == s.last_explain


def test_compile_errors_direct():
    def loop_fn(a):
        total = 0
        for i in (1, 2):
            total += a
        return total

    cols = (BoundReference(0, DType.LONG, True),)
    with pytest.raises(UdfCompileError, match="not supported"):
        compile_udf(loop_fn, cols)
    with pytest.raises(UdfCompileError, match="closures|defaults"):
        y = 3
        compile_udf(lambda a: a + y, cols)
    with pytest.raises(UdfCompileError, match="takes"):
        compile_udf(lambda a, b: a, cols)


def _tree(e):
    """An expression tree as nested (class name, fields) tuples."""
    import dataclasses
    from enum import Enum
    if isinstance(e, tuple):
        return tuple(_tree(x) for x in e)
    if isinstance(e, Enum):
        return e.value
    if dataclasses.is_dataclass(e):
        return (type(e).__name__,) + tuple(
            (f.name, _tree(getattr(e, f.name)))
            for f in dataclasses.fields(e))
    return e


_TREES = {fn.__name__: (fn, dts) for fn, dts in (
    (f_branches, ("DOUBLE", "DOUBLE")), (g_bool, ("LONG", "LONG")),
    (h_math, ("DOUBLE",)), (m_minmax, ("DOUBLE", "DOUBLE")),
    (up, ("STRING",)), (pref, ("STRING",)), (isin, ("LONG",)),
    (slen, ("STRING",)), (double_it, ("LONG",)), (keep, ("LONG",)),
    (nz, ("DOUBLE",)), (charge, ("DOUBLE", "DOUBLE")))}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_compiled_tree_matches_reference(name):
    """The port's compiler builds the JAX compiler's tree, node for node."""
    fn, dts = _TREES[name]
    got = compile_udf(fn, tuple(BoundReference(i, DType[d], True)
                                for i, d in enumerate(dts)))
    want = j_compile_udf(fn, tuple(JRef(i, JDType[d], True)
                                   for i, d in enumerate(dts)))
    assert _tree(got) == _tree(want)


def test_fallback_equals_compiled_q1():
    """bench.py::_bench_udf_q1's query: the row fallback (its aggregate on
    the CPU engine, named in the explain) equals the compiled UDF, whose
    plan holds no PythonUDF, and the built-in expression bit for bit."""
    import datetime

    from spark_rapids_tpu_torch.benchmarks.tpch import (BENCH_CONF,
                                                        gen_lineitem)
    li = gen_lineitem(0.001, 42)

    def q(sess, use_udf=True):
        price, tax = F.col("l_extendedprice"), F.col("l_tax")
        c = (F.udf(charge, DType.DOUBLE)(price, tax) if use_udf
             else price * (F.lit(1.0) + tax))
        return (sess.create_dataframe(li).repartition(8, "l_orderkey")
                .filter(F.col("l_shipdate") <= F.lit(datetime.date(1998, 9,
                                                                   2)))
                .groupBy("l_returnflag", "l_linestatus")
                .agg(F.sum(c).alias("sum_charge"),
                     F.count(F.lit(1)).alias("cnt")))

    on = TpuSession({**BENCH_CONF, **COMPILE}, device="cpu")
    off = TpuSession(BENCH_CONF, device="cpu")
    comp, builtin = q(on).collect(), q(on, False).collect()
    fb = q(off).collect()
    assert "!CpuHashAggregateExec cannot run on TPU" in off.last_explain
    assert "because expression PythonUDF: expression PythonUDF has no TPU " \
           "implementation" in off.last_explain
    from spark_rapids_tpu_torch.testing import assert_tables_equal as teq
    teq(builtin, comp)
    teq(fb, comp, ignore_order=True, approx_float=1e-9)
    # no operator of the compiled plan holds a PythonUDF
    assert not any("PythonUDF" in repr(v) for node in on.last_plan.walk()
                   for v in vars(node).values())
    assert any("PythonUDF" in repr(v) for node in off.last_plan.walk()
               for v in vars(node).values())


def test_compiler_copy_equals_reference_but_imports():
    """udf/compiler.py is the JAX file's text apart from its import lines."""
    def body(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.startswith(("from spark_rapids_tpu",
                                      "import spark_rapids_tpu"))]
    assert body(ROOT / "spark_rapids_tpu_torch/udf/compiler.py") == \
        body(ROOT / "spark_rapids_tpu/udf/compiler.py")


def test_python_udf_raises_on_the_device_path():
    """On the device path (no host engine) a row UDF refuses, as the JAX
    package's does off its numpy engine."""
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    e = PythonUDF(double_it, DType.LONG, (BoundReference(0, DType.LONG),))
    ctx = EvalCtx([ColV(DType.LONG, torch.arange(4), torch.ones(4, dtype=
                                                               torch.bool))],
                  4, torch.device("cpu"))
    with pytest.raises(TypeError, match="cannot run on device"):
        e.eval(ctx)
    ctx.host_engine = True
    assert e.eval(ctx).data.tolist() == [0, 2, 4, 6]
