"""The port's random data generation (datagen.py) and the fuzz cases of
tests/test_fuzz.py run through the port and the JAX package.

``spark_rapids_tpu_torch/datagen.py`` is the reference's text apart from
its import lines, and draws the same tables. Each
fuzz case (random schemas and edge-value-weighted columns through
projection, aggregation, joins, sorts, strings, dates and narrow
integrals, over three seeds) runs through the JAX package's two engines
and the port's two engines on the same table: the port's device path
equals the JAX device path, and the port's CPU engine equals the JAX CPU
engine, with the JAX test's tolerances (floats within 1e-9 only where
the JAX test allows it, for the aggregate's float sums)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu import datagen as jdg
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu.testing import run_with_cpu_and_tpu as jax_both
from spark_rapids_tpu_torch import datagen as dg
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.testing import run_with_cpu_and_tpu as port_both

ROOT = Path(__file__).resolve().parents[1]

FLOAT_AGG = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}

SEEDS = [0, 1, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strip_imports(text: str) -> str:
    return "\n".join(line for line in text.splitlines()
                     if not re.match(r"\s*(import|from) \S", line))


def test_datagen_is_the_reference_text():
    ref = (ROOT / "spark_rapids_tpu" / "datagen.py").read_text()
    port = (ROOT / "spark_rapids_tpu_torch" / "datagen.py").read_text()
    assert _strip_imports(port) == _strip_imports(ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_datagen_draws_the_reference_tables(seed):
    rng, jrng = (np.random.default_rng(seed + 100),
                 np.random.default_rng(seed + 100))
    gens = dg.random_gens(rng, n_cols=8)
    jgens = jdg.random_gens(jrng, n_cols=8)
    assert [type(g).__name__ for g in gens.values()] == \
        [type(g).__name__ for g in jgens.values()]
    assert [g.dtype.value for g in gens.values()] == \
        [g.dtype.value for g in jgens.values()]
    # NaN-safe (arrow's equals holds NaN unequal to itself)
    assert_tables_equal(jdg.gen_table(jgens, 150, seed),
                        dg.gen_table(gens, 150, seed))
    all_gens = {f"g{i}": g() for i, g in enumerate(dg.ALL_GENS)}
    jall = {f"g{i}": g() for i, g in enumerate(jdg.ALL_GENS)}
    assert_tables_equal(jdg.gen_table(jall, 200, seed),
                        dg.gen_table(all_gens, 200, seed))


def check(build, conf=None, ignore_order=False, approx_float=None):
    """``build(session, table_gen_module, functions)`` through both engines
    of both packages: the port's device path against the JAX device path,
    the port's CPU engine against the JAX CPU engine, and the port's two
    engines against each other. Returns the port's device result."""
    jcpu, jtpu, _ = jax_both(lambda s: build(s, jdg, JF), conf)
    pcpu, ptpu, _ = port_both(lambda s: build(s, dg, F), conf, device="cpu")
    pcpu, ptpu = pcpu.to_arrow(), ptpu.to_arrow()
    for want, got in ((jtpu, ptpu), (jcpu, pcpu), (pcpu, ptpu)):
        assert_tables_equal(want, got, ignore_order=ignore_order,
                            approx_float=approx_float)
    return ptpu


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_roundtrip_random_schema(seed):
    def build(s, g, f):
        t = g.gen_table(g.random_gens(np.random.default_rng(seed + 100),
                                      n_cols=5), 150, seed)
        return s.create_dataframe(t).select(*t.column_names)
    assert check(build).num_rows == 150


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_project_arithmetic(seed):
    def build(s, g, f):
        t = g.gen_table({"a": g.DoubleGen(), "b": g.DoubleGen(),
                         "i": g.LongGen(), "j": g.IntegerGen()}, 200, seed)
        return s.create_dataframe(t).select(
            (f.col("a") + f.col("b")).alias("add"),
            (f.col("a") * 2.0).alias("mul"),
            (f.col("a") > f.col("b")).alias("gt"),
            f.coalesce(f.col("a"), f.col("b")).alias("co"),
            (f.col("i") + f.col("j")).alias("iadd"),
            f.abs("j").alias("absj"))
    check(build)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_aggregate(seed):
    def build(s, g, f):
        t = g.gen_table({"k": g.IntegerGen(min_val=0, max_val=6),
                         "v": g.DoubleGen(),
                         "w": g.LongGen(min_val=-10**6, max_val=10**6),
                         "f": g.FloatGen()}, 300, seed)
        return s.create_dataframe(t).groupBy("k").agg(
            f.sum("v").alias("sv"), f.avg("v").alias("av"),
            f.sum("w").alias("sw"), f.count("v").alias("cv"),
            f.min("f").alias("mf"), f.max("f").alias("xf"))
    check(build, conf=FLOAT_AGG, ignore_order=True, approx_float=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_fuzz_join(seed, how):
    def build(s, g, f):
        lt = g.gen_table({"k": g.IntegerGen(min_val=0, max_val=12),
                          "lv": g.DoubleGen()}, 120, seed)
        rt = g.gen_table({"k": g.IntegerGen(min_val=0, max_val=12),
                          "rv": g.StringGen()}, 80, seed + 50)
        return s.create_dataframe(lt).join(s.create_dataframe(rt), "k", how)
    check(build, ignore_order=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_sort(seed):
    def build(s, g, f):
        gens = g.random_gens(np.random.default_rng(seed), n_cols=3,
                             pool=[g.DoubleGen, g.LongGen, g.StringGen,
                                   g.DateGen, g.BooleanGen])
        t = g.gen_table(gens, 150, seed)
        cols = list(t.column_names)
        return s.create_dataframe(t).sort(
            *([f.col(cols[0]).desc()] + cols[1:]))
    check(build)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_strings(seed):
    def build(s, g, f):
        t = g.gen_table({"s": g.StringGen(),
                         "p": g.StringGen(min_len=1, max_len=3)}, 150, seed)
        return s.create_dataframe(t).select(
            f.length("s").alias("len"),
            f.substring("s", 2, 3).alias("sub"),
            f.col("s").contains("a").alias("ca"),
            f.trim("s").alias("tr"),
            f.concat(f.col("s"), f.col("p")).alias("cc"))
    check(build)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_datetime(seed):
    def build(s, g, f):
        t = g.gen_table({"d": g.DateGen(), "ts": g.TimestampGen()}, 150, seed)
        return s.create_dataframe(t).select(
            f.year("d").alias("y"), f.month("d").alias("m"),
            f.dayofmonth("d").alias("dm"), f.quarter("d").alias("q"),
            f.date_add("d", 31).alias("plus"),
            f.year("ts").alias("ty"), f.hour("ts").alias("th"))
    check(build)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_narrow_integrals(seed):
    def build(s, g, f):
        t = g.gen_table({"b": g.ByteGen(), "sh": g.ShortGen()}, 150, seed)
        return s.create_dataframe(t).select(
            (f.col("b") + f.col("sh")).alias("add"),
            f.col("b").cast("int").alias("ci"),
            (f.col("sh") % 7).alias("mod"))
    check(build)
