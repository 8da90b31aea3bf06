"""PyTorch port's partition reorder against the JAX package's Pallas kernel
(run in interpreter mode on the CPU, as tests/test_partition_kernel.py runs
it). The same batch goes to both engines: the packed bytes, the per-piece
live counts, the overflow flag and every live staging row must be equal;
``consolidate`` must give each partition the same rows in the same order.
On the CPU the port runs the reorder's plain version; the CUDA kernel is
held against that plain version on the card (the ``cuda`` test below, and
chip_smoke.py)."""
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
from spark_rapids_tpu_torch.columnar.transfer import download
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk
from torch_parquet_common import one_torch_thread  # noqa: F401 - fixture

CPU = torch.device("cpu")


def _table(n, seed=0, nulls=False, wide=0):
    """A batch of every packable type; ``wide`` more string columns of up to
    300 bytes each make the packed rows wide."""
    rng = np.random.default_rng(seed)
    cols = {
        "l": rng.integers(-2**62, 2**62, n),
        "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "d": np.round(rng.standard_normal(n) * 1e6, 2),
        "s": [f"s{int(x)}" for x in rng.integers(0, 1000, n)],
        "b": rng.random(n) < 0.5,
        "dt": [datetime.date(2020, 1, 1) + datetime.timedelta(days=int(x))
               for x in rng.integers(0, 1000, n)],
        "ts": rng.integers(0, 2**45, n),
    }
    for k in range(wide):
        cols[f"w{k}"] = ["x" * int(m) + str(k)
                         for m in rng.integers(0, 300, n)]
    types = {"dt": pa.date32(), "ts": pa.timestamp("us")}
    mask = (lambda: rng.random(n) < 0.1) if nulls else (lambda: None)
    return pa.table({k: pa.array(v, type=types.get(k), mask=mask())
                     for k, v in cols.items()})


def _both(table, string_max_bytes=16):
    jb = JaxBatch.from_arrow(table, string_max_bytes=string_max_bytes)
    schema = tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value),
                                   f.nullable) for f in jb.schema])
    bufs = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    return jb, batch_from_numpy(schema, bufs, jb.num_rows, CPU)


def _reference_reorder(jb, pids, n):
    spec = jpk.PackSpec.for_batch(jb)
    geom = jpk.KernelGeom.plan(jb.capacity, n, spec.lanes)
    fn = jpk.reorder_program(spec, geom, jb.capacity, True)
    out, summary = fn(np.int32(jb.num_rows), jnp.asarray(pids),
                      *jpk._deflate(spec, jb))
    summary = np.asarray(summary)
    return (np.asarray(out), summary[1:-1].reshape(geom.groups, n),
            int(summary[-1]), spec, geom)


def _port_reorder(pb, pids, n):
    spec = tpk.PackSpec.for_batch(pb)
    geom = tpk.KernelGeom.plan(pb.capacity, n, spec.lanes)
    out, stats = tpk.partition_reorder(
        *tpk.kernel_inputs(pb, torch.from_numpy(pids), spec, geom), geom)
    return out.numpy(), stats.numpy(), spec, geom


@pytest.mark.parametrize("nulls", [False, True])
def test_pack_matrix_bytes_equal_reference(nulls):
    jb, pb = _both(_table(500, seed=2, nulls=nulls))
    jspec = jpk.PackSpec.for_batch(jb)
    want, ok = jpk.pack_matrix(jspec, jb.columns,
                               [c.validity for c in jb.columns])
    assert bool(ok)
    assert [p.kind for p in jspec.plans].count("f64bits") == 1
    tspec = tpk.PackSpec.for_batch(pb)
    assert tspec.lanes == jspec.lanes
    assert [(p.lane, p.nbytes) for p in tspec.plans] == \
        [(p.lane, p.nbytes) for p in jspec.plans]
    got = tpk.pack_matrix(tspec, pb.columns).numpy()
    assert got.tobytes() == np.asarray(want).tobytes()
    # and the unpack inverts the pack
    cols = tpk.unpack_columns(tspec, pb.schema, torch.from_numpy(got))
    for a, b in zip(cols, pb.columns):
        assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
        assert torch.equal(a.validity, b.validity)


@pytest.mark.parametrize("rows,n,nulls,wide", [
    (700, 2, False, 0), (700, 4, False, 0), (700, 8, False, 0),
    (700, 8, True, 0),
    (40000, 4, True, 0),     # two groups of 64 windows: carries across windows
    # string columns over 256 bytes wide: rows of ~0.6 KB (fewer rows per
    # tile of the CUDA kernel) and ~1.1 KB (its wide form)
    (700, 8, True, 1), (700, 5, False, 2),
])
def test_plain_reorder_equals_reference_kernel(rows, n, nulls, wide):
    jb, pb = _both(_table(rows, seed=rows + n, nulls=nulls, wide=wide),
                   string_max_bytes=512 if wide else 16)
    if wide:
        assert jb.columns[-1].data.shape[1] > 256
        assert tpk.PackSpec.for_batch(pb).lanes > 256 * wide
    rng = np.random.default_rng(3)
    pids = rng.integers(0, n, jb.capacity).astype(np.int32)
    pids[rng.random(jb.capacity) < 0.05] = -1          # dead rows
    j_out, j_counts, j_ovf, jspec, jgeom = _reference_reorder(jb, pids, n)
    t_out, t_stats, tspec, tgeom = _port_reorder(pb, pids, n)
    assert (tgeom.cap, tgeom.groups, tgeom.G, tgeom.n, tgeom.q_w,
            tgeom.quota, tgeom.L) == (jgeom.cap, jgeom.groups, jgeom.G,
                                      jgeom.n, jgeom.q_w, jgeom.quota,
                                      jgeom.L)
    assert np.array_equal(t_stats[:, :, 0], j_counts)
    assert int(t_stats[:, :, 1].max()) == j_ovf == 0
    assert not t_stats[:, :, 2:].any()
    live = pids[:jb.num_rows]
    assert j_counts.sum() == ((live >= 0) & (live < n)).sum()
    for j in range(n):
        for g in range(jgeom.groups):
            c = j_counts[g, j]
            assert t_out[j, g, :c].tobytes() == j_out[j, g, :c].tobytes(), \
                (j, g)


@pytest.mark.parametrize("L,rows", [
    (13, 512), (76, 256), (300, 64), (700, 32), (1023, 32), (1024, 32),
    (1100, 32), (4000, 32)])
def test_reorder_tile_rows(L, rows):
    """Rows per tile of the CUDA kernel: the most that fit its shared-memory
    budget, and 32 (its wide form) from 1 KB rows on; a tile's bytes stay a
    multiple of 16 for its bulk copies."""
    assert tpk.reorder_tile_rows(L) == rows
    assert rows * L % 16 == 0 and tpk.W % rows == 0


def test_overflow_flag_matches_reference():
    jb, pb = _both(_table(700, seed=5))
    pids = np.zeros(jb.capacity, np.int32)          # every row to partition 0
    _, j_counts, j_ovf, _, _ = _reference_reorder(jb, pids, 8)
    _, t_stats, _, _ = _port_reorder(pb, pids, 8)
    assert j_ovf == 1
    assert (t_stats[:, :, 1] == 1).all()
    assert np.array_equal(t_stats[:, :, 0], j_counts)
    assert jpk.split_batch_kernel(jb, jnp.asarray(pids), 8,
                                  interpret=True) is None
    assert tpk.split_batch_kernel(pb, torch.from_numpy(pids), 8) is None


@pytest.mark.parametrize("n", [1, tpk.MAX_PARTS + 1])
def test_partition_count_refusal_matches_reference(n):
    jb, pb = _both(_table(300, seed=6))
    pids = np.zeros(jb.capacity, np.int32)
    assert tpk.MAX_PARTS == jpk.MAX_PARTS
    assert jpk.split_batch_kernel(jb, jnp.asarray(pids), n,
                                  interpret=True) is None
    assert tpk.split_batch_kernel(pb, torch.from_numpy(pids), n) is None


def _rows(table):
    def norm(v):
        return v.replace(tzinfo=None) if isinstance(v, datetime.datetime) \
            else v
    cols = [[norm(v) for v in table.column(i).to_pylist()]
            for i in range(table.num_columns)]
    return list(zip(*cols))


@pytest.mark.parametrize("n", [4, 8])
def test_consolidate_gives_reference_row_multisets(n):
    """Each partition's rows equal the reference's row for row, in order
    (full 8-row blocks group by group, then the remainders); this once
    compared sorted multisets, which hid an order that differed."""
    # two groups of 64 windows: with one group, group order and the
    # reference's block-then-remainder order coincide
    jb, pb = _both(_table(34000, seed=n, nulls=True))
    pids = np.random.default_rng(n).integers(0, n, jb.capacity).astype(
        np.int32)
    jres = jpk.split_batch_kernel(jb, jnp.asarray(pids), n, interpret=True)
    counts = tpk.REORDER_KERNEL.launches, tpk.REORDER_KERNEL.kept
    tres = tpk.split_batch_kernel(pb, torch.from_numpy(pids), n)
    assert jres is not None and tres is not None
    # the plain version ran (CPU tensors): no launch, no kept output
    assert (tpk.REORDER_KERNEL.launches, tpk.REORDER_KERNEL.kept) == counts
    for j in range(n):
        want = jpk.consolidate(*jres[:2], j, jres[2], jb.schema, jres[3])
        got = tpk.consolidate(*tres[:2], j, tres[2], pb.schema, tres[3])
        if want is None:
            assert got is None
            continue
        assert got.num_rows == want.num_rows
        assert _rows(download(got).to_arrow()) == _rows(want.to_arrow())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel equals the plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, n, L in [(1 << 20, 8, 76), (70001, 5, 21), (300, 32, 13)]:
        geom = tpk.KernelGeom.plan(rows, n, L)
        pids = torch.randint(0, n, (geom.cap,), generator=g, device=dev,
                             dtype=torch.int32)
        pids[rows:] = -1
        data = torch.randint(0, 256, (geom.cap, L), generator=g, device=dev,
                             dtype=torch.uint8)
        args = (pids.view(geom.groups, geom.G, tpk.W),
                data.view(geom.groups, geom.G * tpk.W, L), geom)
        k_out, k_stats = tpk.partition_reorder(*args)
        p_out, p_stats = tpk.partition_reorder_plain(*args)
        assert torch.equal(k_stats, p_stats)
        counts = k_stats[:, :, 0].T
        live = torch.arange(geom.quota, device=dev)[None, None, :] \
            < counts[:, :, None]
        assert not ((k_out != p_out).any(dim=-1) & live).any()
