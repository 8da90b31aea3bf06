"""The PyTorch port's hand-written CUDA kernels on the card, against their
plain PyTorch versions, and the exchange through them. Every test here needs
an NVIDIA GPU: it carries the ``cuda`` marker and skips without one.

This file imports neither jax nor pyarrow, so it also runs where only the
port's dependencies are installed:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
from spark_rapids_tpu_torch.columnar.transfer import upload
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
from spark_rapids_tpu_torch.execs import exchange_execs as tx
from spark_rapids_tpu_torch.exprs.core import (UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    yield torch.device("cuda")
    DeviceManager.shutdown()


def _reorder_case(dev, rows, n, L, dead, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    geom = tpk.KernelGeom.plan(rows, n, L)
    pids = torch.randint(0, n, (geom.cap,), generator=g, device=dev,
                         dtype=torch.int32)
    pids[torch.rand(geom.cap, generator=g, device=dev) < dead] = -1
    pids[rows:] = -1
    data = torch.randint(0, 256, (geom.cap, L), generator=g, device=dev,
                         dtype=torch.uint8)
    return (pids.view(geom.groups, geom.G, tpk.W),
            data.view(geom.groups, geom.G * tpk.W, L), geom)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,L,dead", [
    (1 << 20, 8, 76, 0.0),              # the main path's row width
    (1 << 18, 8, 300, 0.02),            # fewer rows per tile
    (100000, 6, 1100, 0.02),            # the wide form, one piece a tile
    (40000, 4, 2600, 0.1),              # the wide form, several pieces
    (1 << 20, 8, 76, 0.5),              # half the rows dead in every window
    (3 * 32768 + 165, 8, 76, 0.0),      # num_rows ends inside a tile
    (1 << 20, 32, 13, 0.0),             # many partitions, odd width
    (70001, 5, 21, 0.1), (300, 3, 13, 0.2)])
def test_cuda_reorder_kernel_matches_plain_version(cuda, rows, n, L, dead):
    """The CUDA reorder equals the plain version exactly: stats and every
    live staging row, with one call of the entry point."""
    pids, data, geom = _reorder_case(cuda, rows, n, L, dead, seed=rows + L)
    launches = tpk.REORDER_KERNEL.launches
    k_out, k_stats = tpk.partition_reorder(pids, data, geom)
    assert tpk.REORDER_KERNEL.launches == launches + 1
    p_out, p_stats = tpk.partition_reorder_plain(pids, data, geom)
    torch.cuda.synchronize()
    assert torch.equal(k_stats, p_stats)
    assert not k_stats[:, :, 1].any()
    counts = k_stats[:, :, 0].T
    live = torch.arange(geom.quota, device=cuda)[None, None, :] \
        < counts[:, :, None]
    assert not ((k_out != p_out).any(dim=-1) & live).any()


@pytest.mark.cuda
def test_cuda_reorder_kernel_overflow_and_alignment(cuda):
    """One partition overflows: the flag is raised on every stats row and
    the stats equal the plain version's. A data tensor that is not 16-byte
    aligned is refused, never handed to the plain version."""
    pids, data, geom = _reorder_case(cuda, 1 << 18, 8, 76, 0.0)
    pids = torch.zeros_like(pids)
    _, k_stats = tpk.partition_reorder(pids, data, geom)
    _, p_stats = tpk.partition_reorder_plain(pids, data, geom)
    assert torch.equal(k_stats, p_stats)
    assert bool((k_stats[:, :, 1] == 1).all())
    buf = torch.zeros(data.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(data.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpk.partition_reorder(pids, shifted, geom)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,L,empty", [
    (1 << 20, 8, 76, 7), (70001, 5, 21, None), (300, 32, 13, None),
    (200000, 2, 16, None)])
def test_cuda_compact_kernel_matches_plain_version(cuda, rows, n, L, empty):
    """The CUDA compaction equals the plain version exactly on the live and
    zero rows, through the real reorder kernel's output."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    geom = tpk.KernelGeom.plan(rows, n, L)
    pids = torch.randint(0, n, (geom.cap,), generator=g, device=cuda,
                         dtype=torch.int32)
    if empty is not None:             # its rows spread over the others
        spread = torch.randint(1, n, (geom.cap,), generator=g, device=cuda,
                               dtype=torch.int32)
        pids = torch.where(pids == empty, (pids + spread) % n, pids)
    pids[rows:] = -1
    data = torch.randint(0, 256, (geom.cap, L), generator=g, device=cuda,
                         dtype=torch.uint8)
    out, stats = tpk.partition_reorder(
        pids.view(geom.groups, geom.G, tpk.W),
        data.view(geom.groups, geom.G * tpk.W, L), geom)
    assert not stats[:, :, 1].any()
    counts = stats[:, :, 0].cpu().numpy().astype(np.int64)
    plan = tpk.CompactPlan.of(counts, geom)
    launches = tpk.COMPACT_KERNEL.launches
    k = tpk.dma_compact(out, plan, geom)
    assert tpk.COMPACT_KERNEL.launches == launches + 1
    p = tpk.dma_compact_plain(out, plan, geom)
    torch.cuda.synchronize()
    for j in range(n):
        f = int(plan.fills[j])
        assert torch.equal(k[j, :f], p[j, :f]), (rows, n, L, j)
    if empty is not None:
        assert plan.totals[empty] == 0


@pytest.mark.cuda
def test_cuda_exchange_with_and_without_compaction_agree(cuda):
    """Hash and round-robin exchanges through the kernels: the partitions
    read back through the catalog are equal with dmaConsolidate on and off,
    and the compact kernel launches once per map batch when it is on."""
    batch = upload(gen_lineitem(0.05, seed=3), cuda)
    key = bind_expression(UnresolvedAttribute("l_orderkey"), batch.schema)

    class Resident(LeafExec):
        def execute(self, ctx):
            yield batch

    for part in (tx.HashPartitioning(8, (key,)),
                 tx.RoundRobinPartitioning(6)):
        results = []
        for dma in ("false", "true"):
            conf = TpuConf({"spark.rapids.tpu.shuffle.kernel."
                            "dmaConsolidate.enabled": dma})
            dm = DeviceManager.initialize(conf, cuda)
            ex = tx.TpuShuffleExchangeExec(part, Resident(batch.schema))
            cleanups = []
            launches = tpk.COMPACT_KERNEL.launches
            try:
                results.append([
                    list(ex.execute(ExecContext(conf, cuda, p,
                                                ex.num_partitions, dm,
                                                cleanups)))
                    for p in range(ex.num_partitions)])
            finally:
                for fn in cleanups:
                    fn()
            assert dm.is_idle
            assert (ex.kernel_splits, ex.sort_path_splits) == (1, 0)
            assert tpk.COMPACT_KERNEL.launches - launches == \
                (1 if dma == "true" else 0)
            assert ex.stage_stats().total_rows == batch.num_rows
        for off, on in zip(*results):
            assert len(off) == len(on) == 1
            for a, b in zip(off[0].columns, on[0].columns):
                assert torch.equal(a.data, b.data)
                assert torch.equal(a.validity, b.validity)
                assert a.lengths is None or torch.equal(a.lengths, b.lengths)


def _q3_frames(sess, scale, repartition):
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import Q3_COLUMNS
    gens = {"customer": td.gen_customer, "orders": td.gen_orders,
            "lineitem": td.gen_lineitem_full}
    dfs = {k: sess.create_dataframe(g(scale, 7, Q3_COLUMNS[k]))
           for k, g in gens.items()}
    if repartition:
        dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
        dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
    return dfs


def _host_rows(hb):
    return [(c.data.tobytes(), c.validity.tobytes()) for c in hb.columns]


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
def test_cuda_q3_equals_cpu_and_joins_through_the_reorder_kernel(cuda,
                                                                 broadcast):
    """Q3 at scale 0.01 on the GPU equals the same query on the CPU (float
    sums within 1e-9), and each hash exchange of the join path splits its
    one map batch through the reorder kernel, not the sort path."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    conf = {**BENCH_CONF, "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
            str(64 << 20 if broadcast else -1)}
    out = {}
    for dev in ("cpu", "cuda"):
        sess = TpuSession(conf, device=dev)
        launches = tpk.REORDER_KERNEL.launches
        out[dev] = q3(_q3_frames(sess, 0.01, True)).collect()
        hashed = [e for e in sess.last_plan.walk()
                  if isinstance(e, tx.TpuShuffleExchangeExec)
                  and isinstance(e.partitioning, tx.HashPartitioning)]
        assert [(e.kernel_splits, e.sort_path_splits) for e in hashed] == \
            [(1, 0), (1, 0)]
        if dev == "cuda":
            assert tpk.REORDER_KERNEL.launches - launches == 2
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu.num_rows == cpu.num_rows == 10
    for name in ("l_orderkey", "o_orderdate", "o_shippriority"):
        assert np.array_equal(gpu.column_by_name(name).data,
                              cpu.column_by_name(name).data)
    rev_g = gpu.column_by_name("revenue").data
    rev_c = cpu.column_by_name("revenue").data
    assert np.all(np.abs(rev_g - rev_c) <= 1e-9 * np.abs(rev_c))
