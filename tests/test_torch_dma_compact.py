"""The PyTorch port's one-launch consolidation (``consolidate_all`` over
``dma_compact``) and its per-partition gather (``consolidate``) against the
JAX package. The JAX package's own compaction runs only on a TPU, so on the
CPU it is held through what that compaction is checked against there: the
shared host index math (``dma_index_plan``, array for array) and the
``consolidate`` gather path (partition by partition, row for row, in
order). On the CPU the port's ``dma_compact`` takes its plain version; the
CUDA kernel is held against that plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py)."""
import datetime

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxBatch
from spark_rapids_tpu.shuffle import partition_kernel as jpk
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_numpy
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk
from torch_parquet_common import one_torch_thread  # noqa: F401 - fixture

CPU = torch.device("cpu")


def _table(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.1
    return pa.table({
        "l": pa.array(rng.integers(-2**62, 2**62, n), mask=mask),
        "d": pa.array(np.round(rng.standard_normal(n) * 1e6, 2)),
        "s": pa.array([f"v{int(x)}" for x in rng.integers(0, 10**6, n)],
                      mask=rng.random(n) < 0.1),
        "b": pa.array(rng.random(n) < 0.5),
        "dt": pa.array([datetime.date(2020, 1, 1)
                        + datetime.timedelta(days=int(x))
                        for x in rng.integers(0, 1000, n)]),
    })


def _both(table):
    jb = JaxBatch.from_arrow(table, string_max_bytes=16)
    schema = tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value),
                                   f.nullable) for f in jb.schema])
    bufs = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    return jb, batch_from_numpy(schema, bufs, jb.num_rows, CPU)


def _pids(cap, n, seed, empty=()):
    """Random partition ids with dead rows; partitions in ``empty`` get no
    row."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, n, cap).astype(np.int32)
    for j in empty:
        moved = pids == j
        pids[moved] = (j + 1 + rng.integers(0, n - 1, int(moved.sum()))) % n
    pids[rng.random(cap) < 0.05] = -1
    return pids


def _geom(groups, n, quota=512):
    return tpk.KernelGeom(groups * 64 * 512, groups, 64, n, 64, quota, 13)


@pytest.mark.parametrize("n", [2, 5, 8, 32])
def test_dma_index_plan_equals_reference(n):
    rng = np.random.default_rng(n)
    groups = 7
    counts = rng.integers(0, 60, (groups, n))
    counts[:, 0] = 0                            # an empty partition
    counts[3, :] = 0                            # an empty group
    counts[5, 1] = 8                            # full blocks only
    counts[6, 1] = 5                            # a remainder only
    geom = _geom(groups, n)
    jgeom = jpk.KernelGeom(geom.cap, groups, geom.G, n, geom.q_w, geom.quota,
                           geom.L)
    got = tpk.dma_index_plan(counts, geom)
    want = jpk.dma_index_plan(counts, jgeom)
    assert got[3:] == want[3:]                   # ri_cap, dst_rows
    for g, w in zip(got[:3], want[:3]):          # prefix8, nb8, ridx
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_rows(b, j):
    """Live rows of a JAX batch, column by column, as host arrays."""
    n = b.num_rows
    return [(np.asarray(c.data)[:n], np.asarray(c.validity)[:n],
             None if c.lengths is None else np.asarray(c.lengths)[:n])
            for c in b.columns]


def _assert_batch_equals_reference(got, want, j):
    assert got.num_rows == want.num_rows, j
    assert got.capacity == want.capacity, j
    n = got.num_rows
    for gc, (wd, wv, wl) in zip(got.columns, _jax_rows(want, j)):
        assert gc.data[:n].numpy().tobytes() == wd.tobytes(), j
        assert np.array_equal(gc.validity[:n].numpy(), wv), j
        if wl is not None:
            assert np.array_equal(gc.lengths[:n].numpy(), wl), j
        # padding rows are zero, as the gather path's pad_rows leaves them
        assert not gc.data[n:].any() and not gc.validity[n:].any(), j


@pytest.mark.parametrize("rows,n,empty", [
    (700, 2, ()), (900, 5, (3,)), (1500, 8, (0, 6)), (1200, 32, (31,)),
    (40000, 4, ()),          # two groups of 64 windows
])
def test_consolidations_give_reference_rows_in_order(rows, n, empty):
    jb, pb = _both(_table(rows, seed=rows + n))
    pids = _pids(jb.capacity, n, seed=n, empty=empty)
    jres = jpk.split_batch_kernel(jb, jnp.asarray(pids), n, interpret=True)
    tres = tpk.split_batch_kernel(pb, torch.from_numpy(pids), n)
    assert jres is not None and tres is not None
    out, stats, spec, geom = tres
    assert np.array_equal(stats[:, :, 0], np.asarray(jres[1])[:, :, 0])
    alls = tpk.consolidate_all(out, stats, spec, pb.schema, geom)
    assert len(alls) == n
    for j in range(n):
        want = jpk.consolidate(*jres[:2], j, jres[2], jb.schema, jres[3])
        one = tpk.consolidate(out, stats, j, spec, pb.schema, geom)
        if want is None:
            assert one is None and alls[j] is None and j in empty
            continue
        _assert_batch_equals_reference(one, want, j)
        _assert_batch_equals_reference(alls[j], want, j)
        # the two port paths agree byte for byte, padding included
        for a, b in zip(alls[j].columns, one.columns):
            assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
            assert torch.equal(a.validity, b.validity)
            assert a.lengths is None or torch.equal(a.lengths, b.lengths)


def test_consolidate_all_with_no_rows_gives_no_batches():
    _jb, pb = _both(_table(300, seed=1))
    pids = np.full(pb.capacity, -1, np.int32)
    out, stats, spec, geom = tpk.split_batch_kernel(
        pb, torch.from_numpy(pids), 4)
    assert tpk.consolidate_all(out, stats, spec, pb.schema, geom) == [None] * 4


def _plan_case(n, L, seed, rows=3000):
    rng = np.random.default_rng(seed)
    geom = tpk.KernelGeom.plan(rows, n, L)
    counts = rng.integers(0, geom.q_w, (geom.groups, n))
    counts[:, n // 2] = 0
    out = torch.from_numpy(rng.integers(0, 256, (n, geom.groups, geom.quota,
                                                 L), dtype=np.uint8))
    return out, tpk.CompactPlan.of(counts, geom), geom, counts


@pytest.mark.parametrize("n,L", [(2, 76), (5, 21), (32, 13)])
def test_dma_compact_plain_lays_out_reference_order(n, L):
    """The plain compaction, from the plan alone, equals the reference
    order built directly from the counts; the zero rows are zero."""
    out, plan, geom, counts = _plan_case(n, L, seed=n * L)
    compact = tpk.dma_compact(out, plan, geom)
    assert compact.shape == (n, plan.dst_rows, L)
    for j in range(n):
        c = counts[:, j]
        full = c // tpk.BLOCK * tpk.BLOCK
        rows = [g * geom.quota + r for g in range(geom.groups)
                for r in range(full[g])]
        rows += [g * geom.quota + full[g] + r for g in range(geom.groups)
                 for r in range(c[g] - full[g])]
        total = int(c.sum())
        want = out[j].reshape(-1, L)[torch.tensor(rows, dtype=torch.long)]
        assert torch.equal(compact[j, :total], want.reshape(total, L))
        assert not compact[j, total:plan.fills[j]].any()


def test_dma_compact_refuses_bad_inputs():
    out, plan, geom, _ = _plan_case(4, 12, seed=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpk.COMPACT_KERNEL(out, plan, geom)
    with pytest.raises(ValueError, match="out must be uint8"):
        tpk.dma_compact(out[:, :, :-1], plan, geom)
    with pytest.raises(ValueError, match="contiguous"):
        tpk.dma_compact(torch.cat([out, out], dim=-1)[..., :geom.L], plan,
                        geom)
