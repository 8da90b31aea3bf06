"""The framed window reductions ported last, against the JAX package's
device path (its TPU session, run by XLA on the CPU): framed ``min`` and
``max`` over doubles (NaN, -0.0), ints, booleans and strings, ``first``
and ``last`` with and without ``ignorenulls``, ``percent_rank`` and
``cume_dist``, over ROWS and RANGE frames (unbounded, bounded, following,
empty, the peers of the current row, offsets on an int, a descending and a
float order key) with ties in the order keys, and partitioned by nothing,
an int, a string and a float key. Every value must be exact.

The framed float sum restarts its prefix at each partition
(``ops/window.py::segmented_prefix_sum``): it equals ``math.fsum`` of each
frame to within a few roundings at its own partition's running total,
where a difference of whole-column prefix sums carried the rounding of
every row before the partition; it stays within the 1e-9 carve-out of the
JAX device path."""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.execs.window_execs import evaluate_window
from spark_rapids_tpu_torch.exprs import (Alias, BoundReference, SortOrder,
                                          Sum)
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
from spark_rapids_tpu_torch.exprs.windows import WindowExpression, WindowFrame

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
_SPECIALS = [0.0, -0.0, float("nan"), 1.5, -2.25, float("inf")]
_WORDS = ["", "a", "ab", "b", "ba", "zz", "é", "a longer string"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n: int = 1500, groups: int = 9, seed: int = 3) -> pa.Table:
    """Partition keys with nulls (int, string, double), an int order key
    with ties, doubles with NaN, -0.0 and inf, booleans and strings."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    vals = np.array(_SPECIALS + list(np.round(rng.standard_normal(12), 2)))
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "ks": pa.array(np.char.add("g", k.astype(str)),
                       mask=rng.random(n) < 0.05),
        "kf": pa.array(np.where(k % 3 == 0, -0.0, k % 3 * 0.5),
                       mask=rng.random(n) < 0.05),
        "t": pa.array(rng.integers(0, 60, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.choice(vals, n), mask=rng.random(n) < 0.2),
        "w": pa.array(rng.integers(-5, 6, n).astype(np.int64),
                      mask=rng.random(n) < 0.2),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
        "s": pa.array(rng.choice(_WORDS, n), mask=rng.random(n) < 0.2),
    })


def _both(table, build):
    """``build(df, F, Window)`` through both engines, the results equal
    row for row (the window exec's output order)."""
    want = build(JaxSession(CONF).create_dataframe(table), JF,
                 JWindow).collect()
    got = build(TpuSession(CONF, device="cpu").create_dataframe(table), F,
                Window).collect()
    assert got.num_rows == want.num_rows
    assert_tables_equal(want, got.to_arrow(), ignore_order=False)


def _frame(win, spec: str, part):
    base = win.partitionBy(part) if part else win
    return {
        "rows_running": lambda: base.orderBy("t").rowsBetween(
            win.unboundedPreceding, win.currentRow),
        "rows_3_preceding": lambda: base.orderBy("t").rowsBetween(-3, 0),
        "rows_bounded": lambda: base.orderBy("t", "w").rowsBetween(-2, 3),
        "rows_following": lambda: base.orderBy("t").rowsBetween(1, 4),
        "rows_empty": lambda: base.orderBy("t").rowsBetween(3, 1),
        "rows_whole": lambda: base.orderBy("t").rowsBetween(
            win.unboundedPreceding, win.unboundedFollowing),
        "range_peers": lambda: base.orderBy("t"),
        "range_offset": lambda: base.orderBy("t").rangeBetween(-5, 2),
        "range_desc": lambda: base.orderBy(
            JF.col("t").desc() if win is JWindow else F.col("t").desc()
        ).rangeBetween(-3, 0),
        "range_float": lambda: base.orderBy("v").rangeBetween(-1.5, 0.75),
    }[spec]()


def _reductions(f, ws):
    return [f.max("v").over(ws).alias("max_v"),
            f.min("v").over(ws).alias("min_v"),
            f.min("w").over(ws).alias("min_w"),
            f.max("b").over(ws).alias("max_b"),
            f.min("s").over(ws).alias("min_s"),
            f.max("s").over(ws).alias("max_s"),
            f.first("v").over(ws).alias("first_v"),
            f.last("s").over(ws).alias("last_s"),
            f.first("w", True).over(ws).alias("first_w_nn"),
            f.last("v", True).over(ws).alias("last_v_nn")]


FRAMES = ["rows_running", "rows_3_preceding", "rows_bounded",
          "rows_following", "rows_empty", "rows_whole", "range_peers",
          "range_offset", "range_desc", "range_float"]


@pytest.mark.parametrize("spec", FRAMES)
def test_framed_reductions_match_reference(spec):
    def build(df, f, win):
        return df.select("k", "t", "v", "w", "s",
                         *_reductions(f, _frame(win, spec, "k")))
    _both(_table(), build)


@pytest.mark.parametrize("part", [None, "ks", "kf"])
def test_framed_reductions_by_partition_kind(part):
    """The same reductions with no partition and partitioned by a string
    and by a double key (-0.0 and 0.0 one partition)."""
    def build(df, f, win):
        return df.select("k", "t", "v", "w", "s",
                         *_reductions(f, _frame(win, "rows_bounded", part)))
    _both(_table(seed=4), build)


@pytest.mark.parametrize("part,order", [("k", "t"), ("ks", "v"),
                                        (None, "t"), ("k", "s")])
def test_percent_rank_and_cume_dist_match_reference(part, order):
    """With ties in the order key (its peers share a rank) and null and
    NaN keys."""
    def build(df, f, win):
        ws = (win.partitionBy(part) if part else win).orderBy(order)
        return df.select("k", "t", "v", "s",
                         f.percent_rank().over(ws).alias("pr"),
                         f.cume_dist().over(ws).alias("cd"),
                         f.rank().over(ws).alias("rk"))
    _both(_table(seed=5), build)


def _framed_sums(part, order, vals, frame):
    n = len(vals)
    cols = [ColV(DType.LONG, torch.from_numpy(part),
                 torch.ones(n, dtype=torch.bool)),
            ColV(DType.LONG, torch.from_numpy(order),
                 torch.ones(n, dtype=torch.bool)),
            ColV(DType.DOUBLE, torch.from_numpy(vals),
                 torch.ones(n, dtype=torch.bool))]
    refs = [BoundReference(i, c.dtype) for i, c in enumerate(cols)]
    w = WindowExpression(Sum(refs[2]), (refs[0],), (SortOrder(refs[1]),),
                         WindowFrame("rows", *frame))
    out = evaluate_window(EvalCtx(cols, n, torch.device("cpu")),
                          (Alias(w, "s"),), n)
    return [c.data.numpy() for c in out]


@pytest.mark.parametrize("frame", [(None, 0), (-3, 0), (-2, 5)])
def test_framed_float_sum_restarts_per_partition(frame):
    """A partition of huge values sorts before partitions of small ones:
    each small frame's sum stays within a few ulps of its exact
    ``math.fsum``, where a difference of whole-column prefix sums lost
    every digit of it to the huge running total."""
    rng = np.random.default_rng(9)
    n = 3000
    part = np.where(np.arange(n) < 1000, 0, rng.integers(1, 20, n))
    vals = np.where(part == 0, rng.uniform(1e15, 2e15, n),
                    np.round(rng.uniform(0, 1, n), 3))
    order = rng.permutation(n).astype(np.int64)
    p, o, v, s = _framed_sums(part, order, vals, frame)
    lower, upper = frame
    for g in np.unique(p):
        rows = np.nonzero(p == g)[0]
        seg = v[rows]
        # a sum by doubling distances rounds at most log2(n) times per
        # value, at the magnitude of the partition's running total
        bound = 2 * math.ceil(math.log2(len(rows) + 1))
        for j in range(len(rows)):
            lo = 0 if lower is None else max(0, j + lower)
            hi = min(len(rows) - 1, j + upper)
            want = math.fsum(seg[lo:hi + 1])
            assert abs(s[rows[j]] - want) <= bound * np.spacing(
                math.fsum(np.abs(seg[:hi + 1]))), (g, j)


def test_running_float_sum_matches_reference():
    """q51's shape: a running sum per item over dates, within the 1e-9
    carve-out of the JAX device path's."""
    rng = np.random.default_rng(10)
    n = 4000
    table = pa.table({
        "item": pa.array(rng.integers(0, 40, n)),
        "day": pa.array(rng.permutation(n).astype(np.int32)),
        "paid": pa.array(np.round(rng.uniform(0, 300, n), 2),
                         mask=rng.random(n) < 0.05)})

    def build(df, f, win):
        ws = win.partitionBy("item").orderBy("day").rowsBetween(
            win.unboundedPreceding, win.currentRow)
        return df.select("item", "day", f.sum("paid").over(ws).alias("cum"))
    jsess = JaxSession(CONF)
    want = build(jsess.create_dataframe(table), JF, JWindow).collect()
    got = build(TpuSession(CONF, device="cpu").create_dataframe(table), F,
                Window).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=False,
                        approx_float=1e-9)
