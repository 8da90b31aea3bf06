"""The slice-6 modules of the PyTorch port against the JAX package's device
path (its TPU session, run by XLA on the CPU): first/last and the
``segment_pick`` under them in every grouping mode (global, one-hot, hash
and, past 65,536 groups, sort), ``dropDuplicates(subset)``,
``countDistinct``, ``union``/``unionByName``, ``rollup``/``cube`` (Expand)
and the ranking windows, on seeded inputs with nulls, -0.0, NaN, ties and
strings. Keys, counts, picks and ranks must be exact; float sums within
relative 1e-9 (the variableFloatAgg carve-out)."""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.ops import batch_kernels as jbk
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window
from spark_rapids_tpu_torch.execs.tpu_execs import TpuHashAggregateExec
from spark_rapids_tpu_torch.ops import batch_kernels as bk

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
_SPECIALS = [0.0, -0.0, float("nan"), 1.5, -2.25]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs, and torch's pool of a thread per CPU in every worker
    would oversubscribe them on these small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _table(n: int, groups: int, seed: int) -> pa.Table:
    """Keys with nulls (an int and a string key over ``groups`` values),
    doubles with nulls, -0.0, NaN and repeats, ints with ties, strings."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    v = rng.choice(np.array(_SPECIALS + list(rng.standard_normal(20))), n)
    w = rng.integers(-3, 4, n).astype(np.int32)
    words = np.array(["", "a", "ab", "b", "ba", "zz", "a longer string"])
    s = words[rng.integers(0, len(words), n)]
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "ks": pa.array(np.char.add("g", (k % 997).astype(str)),
                       mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=rng.random(n) < 0.15),
        "w": pa.array(w, mask=rng.random(n) < 0.1),
        "s": pa.array(s, mask=rng.random(n) < 0.15),
    })


def _both(table, build, ignore_order=True):
    """Run ``build(df, F, Window)`` through both engines -> (port session,
    port result), after holding the two results equal."""
    jsess = JaxSession(CONF)
    want = build(jsess.create_dataframe(table), JF, JWindow).collect()
    sess = TpuSession(CONF, device="cpu")
    got = build(sess.create_dataframe(table), F, Window).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=ignore_order,
                        approx_float=1e-9)
    return sess, got


@pytest.mark.parametrize("kind", ["first", "last"])
@pytest.mark.parametrize("ignore_nulls", [False, True])
def test_segment_pick_matches_reference(kind, ignore_nulls):
    rng = np.random.default_rng(11)
    n, segs = 5000, 97
    validity = rng.random(n) < 0.6
    alive = rng.random(n) < 0.9
    seg = rng.integers(0, segs, n)
    seg[:50] = 3                        # one crowded segment; 96 stays sparse
    want = jbk.segment_pick(jnp, jnp.asarray(validity), jnp.asarray(seg),
                            segs, kind, alive=jnp.asarray(alive),
                            ignore_nulls=ignore_nulls)
    got = bk.segment_pick(torch.from_numpy(validity), torch.from_numpy(seg),
                          segs, kind, alive=torch.from_numpy(alive),
                          ignore_nulls=ignore_nulls)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode,keys,groups,rows", [
    ("global", (), 10, 3000),
    ("onehot", ("k",), 20, 3000),
    ("onehot", ("k", "s"), 5, 3000),
    ("hash", ("ks",), 3000, 20000),
    ("sort", ("k",), 70000, 210000),
])
def test_first_last_matches_reference(mode, keys, groups, rows):
    """first/last, with and without ignorenulls, over doubles, ints and
    strings, in each grouping mode: the picks are the first/last row of
    each group in input order, as the JAX device path picks them."""
    table = _table(rows, groups, seed=groups)

    def build(df, f, _w):
        aggs = [f.first("v").alias("fv"), f.first("v", True).alias("fvn"),
                f.last("v").alias("lv"), f.last("v", True).alias("lvn"),
                f.first("s").alias("fs"), f.last("s", True).alias("lsn"),
                f.last("w").alias("lw"), f.count("v").alias("n")]
        return df.groupBy(*keys).agg(*aggs)

    sess, got = _both(table, build)
    agg = [e for e in sess.last_plan.walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert len(agg) == 1
    if mode == "global":
        assert got.num_rows == 1
    else:
        assert agg[0].modes_run[-1] == mode


@pytest.mark.parametrize("subset", [["k"], ["k", "s"], ["v"]])
def test_drop_duplicates_subset_matches_reference(subset):
    _both(_table(4000, 50, seed=3), lambda df, f, w: df.dropDuplicates(subset))


@pytest.mark.parametrize("case", ["grouped", "with_regular", "global",
                                  "string_keys"])
def test_count_distinct_matches_reference(case):
    """countDistinct (the join-based rewrite; null keys join null-safely
    when a regular aggregate sits beside it)."""
    def build(df, f, w):
        if case == "grouped":
            return df.groupBy("k").agg(f.countDistinct("v").alias("cd"))
        if case == "with_regular":
            return df.groupBy("k", "s").agg(
                f.countDistinct("w").alias("cd"), f.sum("v").alias("sv"),
                f.countDistinct("v").alias("cv"))
        if case == "global":
            return df.agg(f.countDistinct("s").alias("cd"))
        return df.groupBy("s").agg(f.countDistinct("ks").alias("cd"),
                                   f.count("v").alias("n"))
    _both(_table(5000, 40, seed=4), build)


@pytest.mark.parametrize("case", ["union", "union3", "by_name",
                                  "missing_columns"])
def test_union_matches_reference(case):
    def build(df, f, w):
        a = df.filter(f.col("w") > 0)
        b = df.filter(f.col("w") <= 0).select("v", "k", "ks", "w", "s")
        if case == "union":
            return a.union(df.select("k", "ks", "v", "w", "s"))
        if case == "union3":
            return a.union(a).unionAll(df).groupBy("k").agg(
                f.sum("v").alias("sv"), f.count("s").alias("n"))
        if case == "by_name":
            return a.unionByName(b)
        return a.select("k", "v", "s").unionByName(
            b.select("w", "k", "s"), allowMissingColumns=True)
    _both(_table(3000, 30, seed=5), build)


@pytest.mark.parametrize("how", ["rollup", "cube"])
@pytest.mark.parametrize("keys", [("k", "s"), ("ks", "w", "s")])
def test_grouping_sets_match_reference(how, keys):
    """rollup/cube through Expand: real null keys stay apart from the
    rolled-up ones (the grouping id)."""
    def build(df, f, w):
        g = getattr(df, how)(*keys)
        return g.agg(f.sum("v").alias("sv"), f.count("w").alias("n"),
                     f.max("s").alias("ms"), f.first("w").alias("fw"))
    _both(_table(4000, 12, seed=6), build)


@pytest.mark.parametrize("spec", ["part_desc", "string_order", "two_keys",
                                  "no_partition"])
def test_ranking_windows_match_reference(spec):
    """row_number, rank and dense_rank with ties, over -0.0/NaN/null order
    keys and null partition keys, in the JAX window exec's output order."""
    def build(df, f, win):
        if spec == "part_desc":
            ws = win.partitionBy("k").orderBy(f.col("v").desc())
        elif spec == "string_order":
            ws = win.partitionBy("ks").orderBy("s")
        elif spec == "two_keys":
            ws = win.partitionBy("s", "k").orderBy(f.col("w"),
                                                   f.col("v").desc())
        else:
            ws = win.orderBy("w", "v")
        return df.select("k", "ks", "v", "w", "s",
                         f.row_number().over(ws).alias("rn"),
                         f.rank().over(ws).alias("rk"),
                         f.dense_rank().over(ws).alias("dr"))
    _both(_table(3000, 25, seed=7), build, ignore_order=False)


def test_rank_over_rollup_sums_matches_reference():
    """q67's shape: rank over float sums of a rollup, filtered on the
    rank."""
    def build(df, f, win):
        base = df.rollup("k", "s").agg(f.sum(f.coalesce(
            f.col("v") * f.col("w"), f.lit(0.0))).alias("ss"))
        ws = win.partitionBy("k").orderBy(f.col("ss").desc())
        return (base.select("k", "s", "ss", f.rank().over(ws).alias("rk"))
                .filter(f.col("rk") <= 3))
    _both(_table(3000, 15, seed=8), build)
