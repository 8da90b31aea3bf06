"""The PyTorch port's range partitioning against the JAX package's: the
bounds from ``_sample_bounds`` and the partition ids from
``range_partition_ids`` are equal bit for bit over int, double (NaN, -0.0),
string and null keys, ascending and descending, nulls first and last; the
port's one-bound-at-a-time ``_lex_gt_bounds`` equals the JAX package's
matrix form; and a sort over a repartitioned table plans a range exchange
plus a sort per range and collects the JAX package's rows in order."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.exprs.core import ColV as JColV
from spark_rapids_tpu.exprs.misc import SortOrder as JSortOrder
from spark_rapids_tpu.execs import exchange_execs as jx
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.execs import exchange_execs as tx
from spark_rapids_tpu_torch.execs.tpu_execs import TpuSortExec
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.exprs.misc import SortOrder

_VOCAB = [b"", b"a", b"ab", b"b", b"ba", b"zz", b"key-0", b"key-10"]


def _key(kind, n, rng, width=8):
    """(dtype, data, validity, lengths) of n random key values, 10% null."""
    valid = rng.random(n) >= 0.1
    if kind == "int":
        return DType.LONG, rng.integers(-5, 30, n).astype(np.int64), valid, None
    if kind == "double":
        vals = np.array([0.0, -0.0, 2.5, -1.0, np.nan, np.inf, -np.inf, 7.0])
        return DType.DOUBLE, vals[rng.integers(0, len(vals), n)], valid, None
    mat = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, j in enumerate(rng.integers(0, len(_VOCAB), n)):
        mat[i, :len(_VOCAB[j])] = bytearray(_VOCAB[j])
        lengths[i] = len(_VOCAB[j])
    return DType.STRING, mat, valid, lengths


def _jax(k):
    dt, d, v, ln = k
    return JColV(JDType(dt.value), d, v, ln)


def _port(k):
    dt, d, v, ln = k
    return ColV(dt, torch.from_numpy(d), torch.from_numpy(v),
                None if ln is None else torch.from_numpy(ln))


@pytest.mark.parametrize("n", [2, 5, 8])
@pytest.mark.parametrize("kinds,asc,nf", [
    (("int",), True, True), (("double",), True, False),
    (("double",), False, True), (("string",), False, False),
    (("string", "int"), True, True), (("int", "double"), False, False)])
def test_bounds_and_pids_equal_reference(kinds, asc, nf, n):
    rng = np.random.default_rng(len(kinds) * 100 + n + 10 * asc + nf)
    orders = [(asc, nf)] * len(kinds)
    jorders = tuple(JSortOrder(None, a, b) for a, b in orders)
    torders = tuple(SortOrder(None, a, b) for a, b in orders)
    # three batches' samples of different sizes and string widths
    samples = [[_key(kind, m, rng, width) for kind in kinds]
               for m, width in ((40, 8), (1, 16), (25, 8))]
    want = jx._sample_bounds(jorders, [[_jax(k) for k in s] for s in samples],
                             n)
    got = tx._sample_bounds(torders, [[_port(k) for k in s] for s in samples],
                            n)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w.validity), g.validity.numpy())
        wd, gd = np.asarray(w.data), g.data.numpy()
        assert wd.tobytes() == gd.tobytes()
        if w.lengths is not None:
            assert np.array_equal(np.asarray(w.lengths), g.lengths.numpy())
    cap = 512
    rows = [_key(kind, cap, rng, 32) for kind in kinds]
    want_pids = jx.range_partition_ids(np, jorders, [_jax(k) for k in rows],
                                       want, cap)
    got_pids = tx.range_partition_ids(torders, [_port(k) for k in rows], got)
    assert np.array_equal(got_pids.numpy(), want_pids)
    assert got_pids.min() >= 0 and got_pids.max() <= n - 1


def test_sample_rows_are_the_reference_rows():
    k = _key("int", 1000, np.random.default_rng(1))
    want = jx._sample_rows([_jax(k)], 1000, 37)[0]
    got = tx._sample_rows([_port(k)], 1000, 37)[0]
    assert np.array_equal(got.data.numpy(), want.data)


def test_one_bound_at_a_time_equals_the_matrix_form():
    rng = np.random.default_rng(5)
    rows = [torch.from_numpy(rng.integers(0, 4, 3000)),
            torch.from_numpy(rng.standard_normal(3000).round(1))]
    bounds = [torch.sort(torch.from_numpy(rng.integers(0, 4, 7))).values,
              torch.from_numpy(rng.standard_normal(7).round(1))]
    want = jx._lex_gt_bounds(np, [r.numpy() for r in rows],
                             [b.numpy() for b in bounds])
    assert np.array_equal(tx._lex_gt_bounds(rows, bounds).numpy(), want)


def _table():
    rng = np.random.default_rng(11)
    n = 4000
    return pa.table({
        "a": pa.array(rng.integers(0, 60, n), mask=rng.random(n) < 0.05),
        "b": pa.array(rng.standard_normal(n).round(2)),
        "s": pa.array([f"v{x}" for x in rng.integers(0, 300, n)]),
    })


@pytest.mark.parametrize("cols", [("b_desc", "s")])
def test_sort_over_repartition_plans_a_range_exchange(cols):
    t = _table()

    def keys(mod):
        return [mod.col("b").desc() if c == "b_desc" else c for c in cols]

    from spark_rapids_tpu.api import functions as JF
    want = JaxSession({}).create_dataframe(t).repartition(5, "a") \
        .sort(*keys(JF)).collect()
    sess = TpuSession({}, device="cpu")
    got = sess.create_dataframe(t).repartition(5, "a").sort(*keys(F)) \
        .collect()
    assert_tables_equal(want, got.to_arrow())
    nodes = list(sess.last_plan.walk())
    sort = [e for e in nodes if isinstance(e, TpuSortExec)]
    rng_x = [e for e in nodes if isinstance(e, tx.TpuShuffleExchangeExec)
             and isinstance(e.partitioning, tx.RangePartitioning)]
    assert len(sort) == 1 and len(rng_x) == 1
    assert sort[0].children[0] is rng_x[0]
    assert rng_x[0].num_partitions == 5
    assert [len(b.validity) for b in rng_x[0].range_bounds] == [4] * len(cols)
    stats = rng_x[0].stage_stats()
    assert stats.total_rows == t.num_rows
    assert rng_x[0].sort_path_splits == 5 and rng_x[0].kernel_splits == 0
