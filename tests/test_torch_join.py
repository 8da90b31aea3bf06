"""The PyTorch port's equi-join against the JAX package's: ``join_size`` and
``join_gather`` (``ops/join.py``, the JAX side on its numpy engine) give the
same emit counts, offsets, build order, group ids and gather rows for every
join kind over int, string, double (NaN keys match, -0.0 == 0.0), null and
composite keys and empty sides; and ``DataFrame.join`` collects the same
rows in the same order as the JAX package's session for every kind, with
the same join strategy, shuffled and broadcast."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.exprs.core import ColV as JColV
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar.dtypes import DType, bucket_capacity
from spark_rapids_tpu_torch.execs.exchange_execs import \
    TpuBroadcastExchangeExec
from spark_rapids_tpu_torch.execs.join_execs import (TpuBroadcastHashJoinExec,
                                                     TpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.ops import join as tjoin

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
_VOCAB = ["", "a", "b", "ab", "ba", "abc", "longer key", "x" * 12]


def _strings(idx, width):
    mat = np.zeros((len(idx), width), np.uint8)
    lengths = np.zeros(len(idx), np.int32)
    for i, j in enumerate(idx):
        raw = _VOCAB[j].encode()
        mat[i, :len(raw)] = bytearray(raw)
        lengths[i] = len(raw)
    return mat, lengths


def _side(kind, cap, num_rows, rng, width):
    """One side's key columns as (dtype, data, validity, lengths) arrays."""
    valid = np.ones(cap, bool)
    if kind in ("int", "nulls", "composite"):
        cols = [(DType.LONG, rng.integers(0, 12, cap).astype(np.int64),
                 valid.copy(), None)]
        if kind == "nulls":
            cols[0][2][rng.random(cap) < 0.25] = False
        if kind == "composite":
            mat, lengths = _strings(rng.integers(0, 4, cap), width)
            cols.append((DType.STRING, mat, valid.copy(), lengths))
    elif kind == "string":
        mat, lengths = _strings(rng.integers(0, len(_VOCAB), cap), width)
        cols = [(DType.STRING, mat, valid.copy(), lengths)]
    else:  # double
        vals = np.array([0.0, -0.0, 1.5, -2.25, np.nan, np.inf, 7.0])
        cols = [(DType.DOUBLE, vals[rng.integers(0, len(vals), cap)],
                 valid.copy(), None)]
    alive = np.arange(cap) < num_rows
    for dt, data, v, lengths in cols:
        v &= alive          # padding rows are invalid, as in a device batch
    return cols, alive


def _jax_cols(cols):
    return [JColV(JDType(dt.value), d, v, ln) for dt, d, v, ln in cols]


def _port_cols(cols):
    return [ColV(dt, torch.from_numpy(d), torch.from_numpy(v),
                 None if ln is None else torch.from_numpy(ln))
            for dt, d, v, ln in cols]


CASES = {
    # kind: (left cap, left rows, right cap, right rows)
    "int": (128, 100, 64, 50),
    "string": (64, 64, 128, 90),
    "double": (128, 120, 32, 32),
    "nulls": (128, 77, 128, 99),
    "composite": (256, 200, 64, 60),
    "empty_left": (128, 0, 64, 40),
    "empty_right": (64, 50, 128, 0),
}


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", list(CASES))
def test_join_kernels_equal_reference(case, how):
    lcap, lrows, rcap, rrows = CASES[case]
    kind = "int" if case.startswith("empty") else case
    rng = np.random.default_rng(len(case) * 31 + HOWS.index(how))
    lcols, lalive = _side(kind, lcap, lrows, rng, 16)
    rcols, ralive = _side(kind, rcap, rrows, rng, 32)
    want = jjoin.join_size(np, _jax_cols(lcols), _jax_cols(rcols), lalive,
                           ralive, how)
    got = tjoin.join_size(_port_cols(lcols), _port_cols(rcols),
                          torch.from_numpy(lalive), torch.from_numpy(ralive),
                          how)
    for name in ("emit_counts", "emit_offsets", "total", "border", "start_b",
                 "sgid", "matches_l"):
        assert np.array_equal(got[name].numpy(),
                              np.asarray(want[name]).astype(np.int64)), name
    total = int(got["total"])
    out_cap = bucket_capacity(total)
    jres = jjoin.join_gather(np, want, lcap, rcap, out_cap, how)
    tres = tjoin.join_gather(got, lcap, rcap, out_cap, how)
    for i in range(4):
        assert np.array_equal(tres[i].numpy(), np.asarray(jres[i])), i
    assert int(tres[4]) == int(jres[4]) == total


def test_cross_join_waits_for_nested_loop_execs():
    """The nested-loop execs' kernel: every live stream row emits every
    live build row, in build row order (test_torch_cross_join.py holds it
    against the JAX package's)."""
    l_alive = torch.tensor([True, False, True, True])
    r_alive = torch.tensor([False, True, True])
    sized = tjoin.join_size([], [], l_alive, r_alive, "cross")
    assert int(sized["total"]) == 6
    lrow, lvalid, rrow, rvalid, _ = tjoin.join_gather(sized, 4, 3, 8, "cross")
    assert lrow[lvalid].tolist() == [0, 0, 2, 2, 3, 3]
    assert rrow[rvalid].tolist() == [1, 2] * 3


def _tables():
    rng = np.random.default_rng(3)
    n, m = 300, 120
    left = pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 9, n)]),
        "lv": pa.array(rng.standard_normal(n)),
    })
    right = pa.table({            # int32 keys: the planner casts them
        "k": pa.array(rng.integers(0, 50, m).astype(np.int32),
                      mask=rng.random(m) < 0.1),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 12, m)]),
        "rv": pa.array(rng.integers(0, 1000, m)),
    })
    return left, right


NO_BROADCAST = {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "-1"}


def join_strategies(plan):
    """The hash join execs of a plan of either engine, depth first."""
    out = ([type(plan).__name__] if "HashJoin" in type(plan).__name__
           else [])
    for c in plan.children:
        out += join_strategies(c)
    return out


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_dataframe_join_equals_reference(how, broadcast):
    """A USING join with the left side repartitioned (inner joins also on
    two keys and in the pair form): the same rows in the same order, the
    same schema (full joins coalesce their keys), the same strategy."""
    conf = {} if broadcast else NO_BROADCAST
    left, right = _tables()
    ons = ["k"] + ([["k", "s"], [("k", "k")]] if how == "inner" else [])
    for on in ons:
        dfs = []
        for sess in (JaxSession(conf), TpuSession(conf, device="cpu")):
            dfs.append(sess.create_dataframe(left).repartition(3, "s").join(
                sess.create_dataframe(right), on, how).collect())
            dfs.append(join_strategies(sess.last_plan))
        want, want_joins, got, got_joins = dfs
        assert got_joins == want_joins
        assert (got_joins[0] == "TpuBroadcastHashJoinExec") == (
            broadcast and how != "full")
        assert_tables_equal(want, got.to_arrow())


def test_broadcast_exchange_builds_once_and_is_released():
    left, right = _tables()
    sess = TpuSession({}, device="cpu")
    df = sess.create_dataframe(left).repartition(4, "s").join(
        sess.create_dataframe(right), "k", "left")
    out = df.collect()
    plan = sess.last_plan
    joins = [e for e in plan.walk() if isinstance(e, TpuShuffledHashJoinExec)]
    assert len(joins) == 1 and isinstance(joins[0], TpuBroadcastHashJoinExec)
    assert joins[0].build_side == "right"
    assert joins[0].num_partitions == 4
    bx = [e for e in plan.walk() if isinstance(e, TpuBroadcastExchangeExec)]
    assert len(bx) == 1 and bx[0]._cached is None     # released by cleanup
    assert out.num_rows >= left.num_rows


_CAST_INPUTS = {
    DType.INT: np.array([0, -1, 7, 2**31 - 1, -2**31], np.int32),
    DType.LONG: np.array([0, -1, 2**40, 2**63 - 1, -2**63], np.int64),
    DType.DOUBLE: np.array([0.5, -1.9, np.nan, 1e30, -1e30], np.float64),
    DType.BOOLEAN: np.array([True, False, True, False, True]),
    DType.DATE: np.array([0, -1, 9000, 20000, 3], np.int32),
}


@pytest.mark.parametrize("src,to", [
    (DType.INT, DType.LONG), (DType.LONG, DType.INT), (DType.INT, DType.DOUBLE),
    (DType.DOUBLE, DType.LONG), (DType.DOUBLE, DType.INT),
    (DType.LONG, DType.BOOLEAN), (DType.BOOLEAN, DType.INT),
    (DType.DATE, DType.TIMESTAMP), (DType.DATE, DType.LONG)])
def test_cast_equals_reference(src, to):
    """The join-key coercion's Cast against the JAX package's on its numpy
    engine: Java narrowing, Scala's saturating float -> integral, NaN -> 0."""
    from spark_rapids_tpu.exprs.cast import Cast as JCast
    from spark_rapids_tpu.exprs.core import (BoundReference as JRef,
                                             EvalCtx as JCtx)
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.exprs.core import BoundReference, EvalCtx
    data = _CAST_INPUTS[src]
    valid = np.array([True, True, False, True, True])
    want = JCast(JRef(0, JDType(src.value)), JDType(to.value)).eval(
        JCtx(np, [JColV(JDType(src.value), data, valid)], 5))
    got = Cast(BoundReference(0, src), to).eval(EvalCtx(
        [ColV(src, torch.from_numpy(data), torch.from_numpy(valid))], 5,
        torch.device("cpu")))
    assert got.dtype is to
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.validity.numpy(), np.asarray(want.validity))
