"""The PyTorch port's keyless joins and ``distinct`` against the JAX
package: the ``cross`` mode of ``join_size``/``join_gather`` equals the JAX
package's ``ops/join.py`` on its numpy engine (dead rows on both sides,
empty sides); ``crossJoin`` plans the broadcast nested-loop join (either
build side) or the cartesian product exactly where the JAX planner does,
with ``sql.exec.NestedLoopJoin`` and ``sql.exec.CartesianProduct`` on, and
collects the JAX numpy engine's rows; ``distinct`` equals its rows, and
``dropDuplicates(subset)``, which waited for the ``First`` aggregate,
now keeps the JAX device path's first row per key."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar.dtypes import bucket_capacity
from spark_rapids_tpu_torch.execs.exchange_execs import (
    TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.execs.join_execs import (
    TpuBroadcastNestedLoopJoinExec, TpuCartesianProductExec)
from spark_rapids_tpu_torch.ops import join as tjoin
from torch_parquet_common import one_torch_thread  # noqa: F401 - fixture

KEYS_ON = {"spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
           "spark.rapids.tpu.sql.exec.CartesianProduct": "true",
           "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
NUMPY_ENGINE = {"spark.rapids.tpu.sql.enabled": "false"}

KERNEL_CASES = {   # (left cap, left rows, right cap, right rows)
    "both_full": (128, 128, 128, 128),
    "ragged": (256, 200, 128, 37),
    "empty_left": (128, 0, 128, 40),
    "empty_right": (128, 50, 128, 0),
    "one_build_row": (128, 90, 128, 1),
}


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_cross_kernels_equal_reference(case, dead):
    lcap, lrows, rcap, rrows = KERNEL_CASES[case]
    rng = np.random.default_rng(len(case) + 7 * dead)
    l_alive = np.arange(lcap) < lrows
    r_alive = np.arange(rcap) < rrows
    if dead:        # rows a filter killed inside the live range
        l_alive &= rng.random(lcap) < 0.7
        r_alive &= rng.random(rcap) < 0.7
    want = jjoin.join_size(np, [], [], l_alive, r_alive, "cross")
    got = tjoin.join_size([], [], torch.from_numpy(l_alive),
                          torch.from_numpy(r_alive), "cross")
    for name in ("emit_counts", "emit_offsets", "total", "border", "start_b",
                 "sgid", "matches_l"):
        assert np.array_equal(got[name].numpy(),
                              np.asarray(want[name]).astype(np.int64)), name
    total = int(got["total"])
    assert total == l_alive.sum() * r_alive.sum()
    out_cap = bucket_capacity(total)
    jres = jjoin.join_gather(np, want, lcap, rcap, out_cap, "cross")
    tres = tjoin.join_gather(got, lcap, rcap, out_cap, "cross")
    for i in range(4):
        assert np.array_equal(tres[i].numpy(), np.asarray(jres[i])), i


def _tables(n_left, n_right, seed=5):
    rng = np.random.default_rng(seed)
    left = pa.table({
        "a": pa.array(rng.integers(0, 9, n_left), mask=rng.random(n_left)
                      < 0.1),
        "s": pa.array([f"x{v}" for v in rng.integers(0, 5, n_left)]),
    })
    right = pa.table({
        "b": pa.array(rng.standard_normal(n_right)),
        "t": pa.array([f"y{v}" for v in rng.integers(0, 3, n_right)]),
    })
    return left, right


def strategies(plan):
    """The join execs of a plan of either engine, depth first."""
    name = type(plan).__name__
    out = [name] if "Join" in name or "Cartesian" in name else []
    for c in plan.children:
        out += strategies(c)
    return out


# (left rows, right rows, conf, left partitions): the threshold and sizes
# put the build side on the right, on the left, or nowhere (cartesian)
CROSS_CASES = {
    "broadcast_right": (400, 20, {}, 4),
    "broadcast_left": (20, 400, {"spark.rapids.tpu.sql.broadcastJoinThreshold"
                                 ".bytes": "600"}, 1),
    "cartesian": (60, 50, {"spark.rapids.tpu.sql.broadcastJoinThreshold"
                           ".bytes": "-1"}, 3),
}
WANT = {"broadcast_right": ("TpuBroadcastNestedLoopJoinExec", "right"),
        "broadcast_left": ("TpuBroadcastNestedLoopJoinExec", "left"),
        "cartesian": ("TpuCartesianProductExec", "right")}


def _cross_query(sess, left, right, parts):
    lf = sess.create_dataframe(left)
    if parts > 1:
        lf = lf.repartition(parts, "s")
    rf = sess.create_dataframe(right)
    return lf.crossJoin(rf), lf, rf


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_join_strategy_and_rows(case):
    """crossJoin, and crossJoin + filter + aggregate (Q11/Q15/Q22's form),
    against the JAX numpy engine's rows and its TPU planner's strategy."""
    n_left, n_right, conf, parts = CROSS_CASES[case]
    left, right = _tables(n_left, n_right)
    jx = JaxSession({**conf, **KEYS_ON})
    jnp_sess = JaxSession({**conf, **KEYS_ON, **NUMPY_ENGINE})
    ts = TpuSession({**conf, **KEYS_ON}, device="cpu")
    want_plan = _cross_query(jx, left, right, parts)[0]._executed_plan()
    want_rows = _cross_query(jnp_sess, left, right, parts)[0].collect()
    got_df = _cross_query(ts, left, right, parts)[0]
    got_rows = got_df.collect()
    assert strategies(ts.last_plan) == strategies(want_plan)
    name, side = WANT[case]
    joins = [e for e in ts.last_plan.walk() if type(e).__name__ == name]
    assert len(joins) == 1 and joins[0].build_side == side
    if name == "TpuBroadcastNestedLoopJoinExec":
        assert isinstance(joins[0].children[0 if side == "left" else 1],
                          TpuBroadcastExchangeExec)
    else:
        assert all(isinstance(k, TpuShuffleExchangeExec)
                   or k.num_partitions == 1 for k in joins[0].children)
    assert got_rows.num_rows == n_left * n_right
    assert_tables_equal(want_rows, got_rows.to_arrow(), ignore_order=True)

    def agg(sess, fns):
        df, lf, rf = _cross_query(sess, left, right, parts)
        total = rf.agg(fns.avg("b").alias("avg_b"))
        return (lf.crossJoin(total).filter(fns.col("a") > 3)
                .groupBy("s").agg(fns.max("avg_b").alias("m"),
                                  fns.count().alias("n")))
    want = agg(jnp_sess, JF).collect()
    got = agg(ts, F).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)


def test_distinct_equals_reference():
    rng = np.random.default_rng(11)
    n = 500
    table = pa.table({
        "k": pa.array(rng.integers(0, 6, n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"brand#{v}" for v in rng.integers(0, 4, n)],
                      mask=rng.random(n) < 0.05),
        "d": pa.array(rng.choice([0.5, -0.0, 0.0, np.nan, 2.0], n)),
    })
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
    want = JaxSession({**conf, **NUMPY_ENGINE}).create_dataframe(table) \
        .distinct().collect()
    sess = TpuSession(conf, device="cpu")
    for df in (sess.create_dataframe(table),
               sess.create_dataframe(table).repartition(4, "k")):
        got = df.distinct().collect()
        assert got.num_rows == want.num_rows
        assert_tables_equal(want, got.to_arrow(), ignore_order=True)


def test_drop_duplicates_subset_names_the_missing_first():
    table = pa.table({"a": [1, 1, None, 2, None], "b": [2, 3, 4, None, 5],
                      "c": ["x", "y", None, "z", "w"]})
    want = JaxSession({}).create_dataframe(table).dropDuplicates(["a"]) \
        .collect()
    got = TpuSession({}, device="cpu").create_dataframe(table) \
        .dropDuplicates(["a"]).collect()
    assert got.schema.names() == ["a", "b", "c"] and got.num_rows == 3
    assert_tables_equal(want, got.to_arrow(), ignore_order=True)
