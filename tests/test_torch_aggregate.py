"""PyTorch port's grouped aggregation against the JAX package: the one-hot
mode on the Q1 expressions must give ``__graft_entry__.entry_for_batch``'s
groups in the same (hash) order, with exact keys and counts and sums within
the variableFloatAgg carve-out (relative 1e-9: the port reduces in another
order); the sort mode must give the reference's sort-mode groups; and more
than 64 groups must escalate from one-hot to sort and still match."""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import __graft_entry__ as graft
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.benchmarks.tpch import gen_lineitem as jax_lineitem
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxBatch
from spark_rapids_tpu.exprs import core as jcore
from spark_rapids_tpu.ops import aggregate as jagg
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_numpy
from spark_rapids_tpu_torch.execs.tpu_execs import (TpuHashAggregateExec,
                                                    eval_ctx)
from spark_rapids_tpu_torch.exprs import (Average, Count, Literal, Multiply,
                                          Subtract, Sum, UnresolvedAttribute,
                                          bind_expression)
from spark_rapids_tpu_torch.ops.aggregate import GROUP_CAP, group_aggregate

CPU = torch.device("cpu")
REL = 1e-9
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}


class _Ctx:
    """The exec context fields eval_ctx reads."""
    string_max_bytes = 8


def _port_batch(jb):
    schema = tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value),
                                   f.nullable) for f in jb.schema])
    bufs = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    return batch_from_numpy(schema, bufs, jb.num_rows, CPU)


def _q1_port_exprs(schema):
    """The expressions of __graft_entry__._q1_exprs, built with the port."""
    col = UnresolvedAttribute
    b = lambda e: bind_expression(e, schema)   # noqa: E731
    disc_price = Multiply(col("l_extendedprice"),
                          Subtract(Literal.of(1.0), col("l_discount")))
    keys = (b(col("l_returnflag")), b(col("l_linestatus")))
    fns = (Sum(b(col("l_quantity"))), Sum(b(disc_price)),
           Average(b(col("l_quantity"))), Count(b(Literal.of(1))))
    return keys, fns


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.all(np.abs(got - want) <= REL * np.maximum(np.abs(want), 1e-300))


def _assert_matches(port_res, ref_flat, num_groups, exact_float=False):
    key_cols, res_cols, n, flagged = port_res
    assert not flagged
    assert n == num_groups
    flat = []
    for c in list(key_cols) + list(res_cols):
        flat += [c.data.numpy()[:n], c.validity.numpy()[:n]]
    for i, (got, want) in enumerate(zip(flat, ref_flat)):
        want = np.asarray(want)[:n]
        if got.dtype == np.float64 and not exact_float:
            assert _close(got, want), i
        else:
            assert np.array_equal(got, want), i


@pytest.mark.parametrize("scale,seed", [(0.0005, 1), (0.002, 7)])
def test_onehot_equals_graft_entry(scale, seed):
    jb = JaxBatch.from_arrow(jax_lineitem(scale, seed=seed),
                             string_max_bytes=8)
    fn, args = graft.entry_for_batch(jb, 8)
    ref = fn(*args)
    pb = _port_batch(jb)
    keys, fns = _q1_port_exprs(pb.schema)
    res = group_aggregate(eval_ctx(pb, _Ctx()), keys, fns, pb.num_rows,
                          pb.capacity, grouping="onehot")
    assert int(ref[-1]) == 6
    _assert_matches(res, ref[:-1], int(ref[-1]))


def _reference_group_aggregate(jb, key_names, grouping):
    import jax
    schema = jb.schema
    keys = tuple(jcore.bind_expression(jcore.UnresolvedAttribute(k), schema)
                 for k in key_names)
    from spark_rapids_tpu.exprs import Count as JCount, Sum as JSum
    from spark_rapids_tpu.exprs import Literal as JLiteral
    fns = (JSum(jcore.bind_expression(jcore.UnresolvedAttribute("v"), schema)),
           JCount(JLiteral.of(1)))
    flat = []
    for c in jb.columns:
        flat += [c.data, c.validity] + ([c.lengths] if c.lengths is not None
                                        else [])

    def run(num_rows, *flat):
        cols = jcore.unflatten_colvs(schema, flat)
        ectx = jcore.EvalCtx(jnp, cols, jb.capacity, 16)
        out = jagg.group_aggregate(jnp, ectx, keys, fns, num_rows,
                                   jb.capacity, grouping=grouping)
        res = []
        for c in list(out[0]) + list(out[1]):
            res += [c.data, c.validity]
        return tuple(res) + (out[2],) + tuple(out[3:])
    return jax.jit(run)(np.int32(jb.num_rows), *flat)


def _keyed_table(n, groups, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "s": pa.array([f"g{x % 7}" for x in k], mask=rng.random(n) < 0.05),
        "v": pa.array(np.round(rng.standard_normal(n) * 100, 2)),
    })


@pytest.mark.parametrize("mode", ["onehot", "hash", "sort"])
def test_mode_equals_reference_mode_with_null_keys(mode):
    jb = JaxBatch.from_arrow(_keyed_table(3000, 20, seed=4),
                             string_max_bytes=16)
    ref = _reference_group_aggregate(jb, ("k", "s"), mode)
    ng = int(ref[8])
    if mode != "sort":
        assert not bool(ref[9])
    pb = _port_batch(jb)
    col = UnresolvedAttribute
    keys = tuple(bind_expression(col(k), pb.schema) for k in ("k", "s"))
    fns = (Sum(bind_expression(col("v"), pb.schema)), Count(Literal.of(1)))
    res = group_aggregate(eval_ctx(pb, _Ctx()), keys, fns, pb.num_rows,
                          pb.capacity, grouping=mode)
    # string keys compare through their bytes (the lengths ride along)
    _assert_matches(res, ref[:8], ng)


def _agg_query(df, f):
    return df.groupBy("k").agg(f.sum("v").alias("sv"), f.count().alias("c"),
                               f.avg("v").alias("av"))


@pytest.mark.parametrize("groups,modes", [(40, ["onehot"]),
                                          (150, ["onehot", "hash"])])
def test_escalation_matches_reference(groups, modes):
    t = _keyed_table(5000, groups, seed=groups)
    sess = TpuSession(CONF, device="cpu")
    got = _agg_query(sess.create_dataframe(t), F).collect()
    agg = [e for e in sess.last_plan.walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert agg[0].modes_run == modes
    want = _agg_query(JaxSession(CONF).create_dataframe(t), JF).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=True,
                        approx_float=REL)


def _hash_inputs(n, groups, seed):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.permutation(n) % groups
                                   if groups >= n else
                                   rng.integers(0, groups, n)),
                     "s": pa.array([f"g{x % 3}" for x in range(n)]),
                     "v": pa.array(rng.integers(-1000, 1000, n))})


@pytest.mark.parametrize("n,groups", [(3000, 700), (70000, 70000)])
def test_hash_mode_equals_reference_ordered(n, groups):
    """Hash mode against the JAX package's, ordered: keys, sums, counts,
    num_groups and the flag. 70,000 distinct keys overflow GROUP_CAP: both
    flag it, and the first GROUP_CAP groups still agree."""
    jb = JaxBatch.from_arrow(_hash_inputs(n, groups, seed=n),
                             string_max_bytes=16)
    ref = _reference_group_aggregate(jb, ("k", "s"), "hash")
    pb = _port_batch(jb)
    col = UnresolvedAttribute
    keys = tuple(bind_expression(col(k), pb.schema) for k in ("k", "s"))
    fns = (Sum(bind_expression(col("v"), pb.schema)), Count(Literal.of(1)))
    key_cols, res_cols, ng, flagged = group_aggregate(
        eval_ctx(pb, _Ctx()), keys, fns, pb.num_rows, pb.capacity,
        grouping="hash")
    assert ng == int(ref[8])
    assert flagged == bool(ref[9]) == (ng > GROUP_CAP)
    shown = min(ng, GROUP_CAP)
    flat = []
    for c in list(key_cols) + list(res_cols):
        flat += [c.data.numpy()[:shown], c.validity.numpy()[:shown]]
    for i, (got, want) in enumerate(zip(flat, ref[:8])):
        assert np.array_equal(got, np.asarray(want)[:shown]), i


def test_group_by_order_is_the_reference_hash_order():
    """An unsorted groupBy of 200 groups escalates onehot -> hash and its
    rows come out in the JAX package's hash order (the port's aggregate once
    went onehot -> sort and returned them in key order)."""
    rng = np.random.default_rng(0)
    t = pa.table({"k": pa.array(rng.integers(0, 200, 5000)),
                  "v": pa.array(rng.standard_normal(5000))})
    sess = TpuSession(CONF, device="cpu")
    got = sess.create_dataframe(t).groupBy("k").agg(
        F.sum("v").alias("s")).collect()
    want = JaxSession(CONF).create_dataframe(t).groupBy("k").agg(
        JF.sum("v").alias("s")).collect()
    agg = [e for e in sess.last_plan.walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert agg[0].modes_run == ["onehot", "hash"]
    assert_tables_equal(want, got.to_arrow(), approx_float=REL)


def test_overflow_escalates_to_sort():
    """More than GROUP_CAP groups: onehot -> hash -> sort, equal to the JAX
    package's (its sort mode orders the groups by key)."""
    t = _hash_inputs(70000, 70000, seed=1)
    sess = TpuSession(CONF, device="cpu")
    got = sess.create_dataframe(t).groupBy("k").agg(
        F.sum("v").alias("sv"), F.count().alias("c")).collect()
    agg = [e for e in sess.last_plan.walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert agg[0].modes_run == ["onehot", "hash", "sort"]
    want = JaxSession(CONF).create_dataframe(t).groupBy("k").agg(
        JF.sum("v").alias("sv"), JF.count().alias("c")).collect()
    assert_tables_equal(want, got.to_arrow())


def test_global_aggregate_in_every_mode_has_one_row():
    """No keys: one group in every mode, also over no rows."""
    pb = _port_batch(JaxBatch.from_arrow(_hash_inputs(10, 5, seed=2),
                                         string_max_bytes=16))
    fns = (Sum(bind_expression(UnresolvedAttribute("v"), pb.schema)),
           Count(Literal.of(1)))
    for mode in ("onehot", "hash", "sort"):
        for rows in (pb.num_rows, 0):
            _, res, ng, flagged = group_aggregate(
                eval_ctx(pb, _Ctx()), (), fns, rows, pb.capacity,
                grouping=mode)
            assert (ng, flagged) == (1, False)
            assert bool(res[0].validity[0]) == (rows > 0)
            assert int(res[1].data[0]) == rows
