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


def _strings_tensor(rng, n, width):
    alphabet = np.frombuffer(b"ab c%x", np.uint8)
    lengths = rng.integers(0, width + 1, n).astype(np.int32)
    data = alphabet[rng.integers(0, len(alphabet), (n, width))]
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return torch.from_numpy(data), torch.from_numpy(lengths)


def _word_strings(rng, n, width):
    """Rows of random words (the LIKE patterns' own among them), cut to
    ``width`` bytes."""
    words = ["special", "requests", "ab", "c", "x", "%", "xyx"]
    pick = rng.integers(0, len(words), (n, 5))
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        raw = " ".join(words[j] for j in pick[i][:rng.integers(1, 6)])
        raw = raw.encode()[:width]
        data[i, :len(raw)] = bytearray(raw)
        lengths[i] = len(raw)
    return torch.from_numpy(data), torch.from_numpy(lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["%a%b%", "%special%requests%", "ab_c%",
                                     "%x_x%"])
def test_cuda_dfa_match_equals_cpu(cuda, pattern):
    """LIKE's byte DFA on the card equals the same scan on the CPU, on rows
    some of which match."""
    from spark_rapids_tpu_torch.ops import regex as rk
    data, lengths = _word_strings(np.random.default_rng(1), 50_000, 32)
    dfa = rk.compile_dfa(rk.like_to_regex(pattern))
    want = rk.dfa_match(dfa, data, lengths)
    got = rk.dfa_match(dfa, data.to(cuda), lengths.to(cuda)).cpu()
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["onehot", "hash", "sort"])
def test_cuda_min_max_equals_cpu(cuda, mode):
    """min and max of ints, doubles with NaNs and strings, grouped by a key
    with nulls, on the card equal the CPU in every grouping mode (the
    string min/max has no one-hot form and is left out there)."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, Max, Min
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops.aggregate import group_aggregate
    rng = np.random.default_rng(2)
    n = 1 << 18
    valid = lambda: torch.from_numpy(rng.random(n) > 0.1)  # noqa: E731
    d = rng.standard_normal(n)
    d[rng.random(n) < 0.01] = np.nan
    s, s_len = _strings_tensor(rng, n, 16)
    cols = [ColV(DType.LONG, torch.from_numpy(rng.integers(0, 40, n)),
                 valid()),
            ColV(DType.INT, torch.from_numpy(
                rng.integers(-9, 9, n).astype(np.int32)), valid()),
            ColV(DType.DOUBLE, torch.from_numpy(d), valid()),
            ColV(DType.STRING, s, valid(), s_len)]
    types = [DType.LONG, DType.INT, DType.DOUBLE, DType.STRING]
    refs = [BoundReference(i, t) for i, t in enumerate(types)]
    fns = [f(r) for r in refs[1:3 if mode == "onehot" else 4]
           for f in (Min, Max)]
    out = {}
    for dev in ("cpu", "cuda"):
        dc = [ColV(c.dtype, c.data.to(dev), c.validity.to(dev),
                   None if c.lengths is None else c.lengths.to(dev))
              for c in cols]
        out[dev] = group_aggregate(EvalCtx(dc, n, torch.device(dev)),
                                   [refs[0]], fns, n, n, grouping=mode)
    (ck, cr, cn, cf), (gk, gr, gn, gf) = out["cpu"], out["cuda"]
    assert not cf and not gf and cn == gn
    for a, b in zip(ck + cr, gk + gr):
        assert torch.equal(a.validity[:cn], b.validity[:cn].cpu())
        va = a.validity[:cn]
        da, db = a.data[:cn][va], b.data[:cn].cpu()[va]
        if da.is_floating_point():
            assert torch.equal(torch.isnan(da), torch.isnan(db))
            da, db = da.nan_to_num(), db.nan_to_num()
        assert torch.equal(da, db)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [("onehot", 6), ("hash", 5000),
                                         ("sort", 100_000)])
def test_cuda_float_sums_repeat_bit_for_bit(cuda, mode, groups):
    """A float sum on the card gives the same bits on every run (Q15 holds
    a sum equal to the max of the same sums from another pass), in every
    grouping mode and in the global aggregate, and equals the CPU's within
    1e-9."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, Sum
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops.aggregate import group_aggregate
    rng = np.random.default_rng(5)
    n = 1 << 21
    key = torch.from_numpy(rng.integers(0, groups, n))
    val = torch.from_numpy(rng.standard_normal(n) * 1e6)
    ones = torch.ones(n, dtype=torch.bool)
    refs = [BoundReference(0, DType.LONG), BoundReference(1, DType.DOUBLE)]
    for keys in ([refs[0]], []):
        out = []
        for dev in ("cuda", "cuda", "cpu"):
            cols = [ColV(DType.LONG, key.to(dev), ones.to(dev)),
                    ColV(DType.DOUBLE, val.to(dev), ones.to(dev))]
            _, res, num, flagged = group_aggregate(
                EvalCtx(cols, n, torch.device(dev)), keys, [Sum(refs[1])], n,
                n, grouping=mode)
            assert not flagged
            out.append(res[0].data[:num].cpu())
        assert torch.equal(out[0], out[1])
        assert torch.allclose(out[0], out[2], rtol=1e-9, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [("onehot", 40), ("hash", 5000),
                                         ("sort", 100_000)])
def test_cuda_first_last_equal_cpu(cuda, mode, groups):
    """``segment_pick`` (a min/max of row indices by ``scatter_reduce_``)
    on the card equals the CPU's picks, and so do first/last with and
    without ignorenulls over doubles and strings in every grouping mode."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, First, Last
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    from spark_rapids_tpu_torch.ops.aggregate import group_aggregate
    rng = np.random.default_rng(9)
    n = 1 << 19
    key = torch.from_numpy(rng.integers(0, groups, n))
    valid = torch.from_numpy(rng.random(n) > 0.3)
    alive = torch.from_numpy(rng.random(n) > 0.05)
    for kind in ("first", "last"):
        for ign in (False, True):
            want = bk.segment_pick(valid, key, groups, kind, alive, ign)
            got = bk.segment_pick(valid.to(cuda), key.to(cuda), groups, kind,
                                  alive.to(cuda), ign)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    s, s_len = _strings_tensor(rng, n, 16)
    cols = [ColV(DType.LONG, key, torch.ones(n, dtype=torch.bool)),
            ColV(DType.DOUBLE, torch.from_numpy(rng.standard_normal(n)),
                 valid),
            ColV(DType.STRING, s, torch.from_numpy(rng.random(n) > 0.3),
                 s_len)]
    refs = [BoundReference(i, c.dtype) for i, c in enumerate(cols)]
    fns = [f(r, ign) for r in refs[1:] for f in (First, Last)
           for ign in (False, True)]
    out = {}
    for dev in ("cpu", "cuda"):
        dc = [ColV(c.dtype, c.data.to(dev), c.validity.to(dev),
                   None if c.lengths is None else c.lengths.to(dev))
              for c in cols]
        out[dev] = group_aggregate(EvalCtx(dc, n, torch.device(dev)),
                                   [refs[0]], fns, n, n, grouping=mode)
    (ck, cr, cn, cf), (gk, gr, gn, gf) = out["cpu"], out["cuda"]
    assert not cf and not gf and cn == gn
    for a, b in zip(ck + cr, gk + gr):
        assert torch.equal(a.validity[:cn], b.validity[:cn].cpu())
        assert torch.equal(a.data[:cn], b.data[:cn].cpu())


@pytest.mark.cuda
def test_cuda_q67_ranks_repeat_bit_for_bit(cuda):
    """TPC-DS q67 on the card: the rollup's float sums feed rank(), so the
    ranks hold only if the sums come out with the same bits every run.
    The cold and the warm run give the same rows bit for bit, and as many
    as the CPU run."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks import tpcds_data, tpcds_queries
    tables = tpcds_data.gen_all(0.1, seed=42,
                                columns=tpcds_queries.COLUMNS["q67"])
    tables = {t: b for t, b in tables.items()
              if t in tpcds_queries.COLUMNS["q67"]}
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        sess = TpuSession(BENCH_CONF, device=dev)
        dfs = {t: sess.create_dataframe(b) for t, b in tables.items()}
        dfs["store_sales"] = dfs["store_sales"].repartition(8, "ss_item_sk")
        out.append(tpcds_queries.QUERIES["q67"](dfs).collect())
    cold, warm, cpu = out
    assert cold.num_rows == warm.num_rows == cpu.num_rows == 100
    for a, b in zip(cold.columns, warm.columns):
        assert np.array_equal(a.validity, b.validity)
        assert a.data.tobytes() == b.data.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [("onehot", 6), ("hash", 5000),
                                         ("sort", 100_000), ("global", 1)])
def test_cuda_moments_repeat_bit_for_bit(cuda, mode, groups):
    """stddev, variance, corr and covar sum double buffers: on the card they
    give the same bits on every run in every grouping mode, and equal the
    CPU's within 1e-9."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import (BoundReference, Corr,
                                              CovarSamp, StddevSamp,
                                              VariancePop)
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops.aggregate import group_aggregate
    rng = np.random.default_rng(6)
    n = 1 << 21
    key = torch.from_numpy(rng.integers(0, groups, n))
    x = torch.from_numpy(rng.standard_normal(n) * 1e3 + 50)
    y = torch.from_numpy(rng.standard_normal(n) * 1e2)
    valid = torch.from_numpy(rng.random(n) > 0.1)
    ones = torch.ones(n, dtype=torch.bool)
    refs = [BoundReference(i, t) for i, t in enumerate(
        (DType.LONG, DType.DOUBLE, DType.DOUBLE))]
    fns = [StddevSamp(refs[1]), VariancePop(refs[2]),
           Corr(refs[1], refs[2]), CovarSamp(refs[2], refs[1])]
    keys = [] if mode == "global" else [refs[0]]
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        cols = [ColV(DType.LONG, key.to(dev), ones.to(dev)),
                ColV(DType.DOUBLE, x.to(dev), valid.to(dev)),
                ColV(DType.DOUBLE, y.to(dev), ones.to(dev))]
        _, res, num, flagged = group_aggregate(
            EvalCtx(cols, n, torch.device(dev)), keys, fns, n, n,
            grouping="sort" if mode == "global" else mode)
        assert not flagged
        out.append([(r.data[:num].cpu(), r.validity[:num].cpu())
                    for r in res])
    for (a, va), (b, vb), (c, vc) in zip(*out):
        assert torch.equal(va, vb) and torch.equal(va, vc)
        assert torch.equal(a[va], b[va])
        assert torch.allclose(a[va], c[va], rtol=1e-9, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [("rows", None, 0), ("rows", -5, 3),
                                   ("range", -20, 10), ("range", None, None)])
def test_cuda_framed_sums_repeat_bit_for_bit(cuda, frame):
    """Framed float sums take their prefix sums in a fixed order on the
    card (``ops/window.py::prefix_sum``): the same bits on every run, and
    the CPU's sums within 1e-9 of the partition's total magnitude."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.execs.window_execs import evaluate_window
    from spark_rapids_tpu_torch.exprs import (Alias, BoundReference, Count,
                                              SortOrder, Sum)
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.exprs.windows import (WindowExpression,
                                                      WindowFrame)
    rng = np.random.default_rng(7)
    n = 1 << 21
    cols = [(DType.LONG, rng.integers(0, 3000, n)),
            (DType.LONG, rng.integers(0, 10_000, n)),
            (DType.DOUBLE, rng.standard_normal(n) * 1e6)]
    refs = [BoundReference(i, t) for i, (t, _) in enumerate(cols)]
    spec = dict(part_keys=(refs[0],), orders=(SortOrder(refs[1]),),
                frame=WindowFrame(*frame))
    wexprs = (Alias(WindowExpression(Sum(refs[2]), **spec), "s"),
              Alias(WindowExpression(Count(refs[2]), **spec), "n"))
    valid = torch.from_numpy(rng.random(n) > 0.05)
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        cv = [ColV(t, torch.from_numpy(a).to(dev), valid.to(dev))
              for t, a in cols]
        res = evaluate_window(EvalCtx(cv, n, torch.device(dev)), wexprs, n)
        out.append([(r.data.cpu(), r.validity.cpu()) for r in res[-2:]])
    (s1, v1), (n1, _) = out[0]
    (s2, v2), (n2, _) = out[1]
    (s3, v3), (n3, _) = out[2]
    assert torch.equal(v1, v2) and torch.equal(v1, v3)
    assert torch.equal(n1, n3) and torch.equal(n1, n2)
    assert torch.equal(s1[v1], s2[v1])
    scale = float(np.abs(cols[2][1]).sum()) / 3000
    assert torch.allclose(s1[v1], s3[v1], rtol=1e-9, atol=1e-9 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("q", ["q23", "q18"])
def test_cuda_tpcxbb_float_filters_repeat_bit_for_bit(cuda, q):
    """q23 keeps items whose stddev/mean >= 1.3, q18 stores whose
    least-squares slope < 0: both filters read the last bits of float
    sums. On the card the cold and warm runs give the same rows bit for
    bit, as many as the CPU run, with the facts hash 8 as on the card's
    main path."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks import (tpcxbb_data,
                                                   tpcxbb_queries)
    cols = dict(tpcxbb_queries.COLUMNS[q])
    if "store_sales" in cols and "ss_item_sk" not in cols["store_sales"]:
        cols["store_sales"] = cols["store_sales"] + ["ss_item_sk"]
    tables = tpcxbb_data.gen_all(1.0, seed=42, columns=cols, tables=cols)
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        sess = TpuSession(BENCH_CONF, device=dev)
        dfs = {t: sess.create_dataframe(b) for t, b in tables.items()}
        if "store_sales" in dfs:
            dfs["store_sales"] = dfs["store_sales"].repartition(8,
                                                                "ss_item_sk")
        out.append(tpcxbb_queries.QUERIES[q](dfs).collect())
    cold, warm, cpu = out
    assert cold.num_rows == warm.num_rows == cpu.num_rows > 0
    for a, b in zip(cold.columns, warm.columns):
        assert np.array_equal(a.validity, b.validity)
        assert a.data.tobytes() == b.data.tobytes()


# ------------------------------------------------- the default execution path
def _same_host_batch(a, b):
    assert a.num_rows == b.num_rows
    for x, y in zip(a.columns, b.columns):
        assert np.array_equal(x.validity, y.validity)
        assert x.data.tobytes() == y.data.tobytes()
        assert x.lengths is None or np.array_equal(x.lengths, y.lengths)


@pytest.mark.cuda
def test_cuda_chunked_upload_equals_single_shot(cuda):
    """Lineitem uploaded in chunks of 7,000 rows, two in flight, equals the
    single-shot upload byte for byte, padding rows included."""
    from spark_rapids_tpu_torch.columnar.transfer import (chunk_bounds,
                                                          upload_table)
    hb = gen_lineitem(0.05, seed=3)
    assert len(chunk_bounds(hb, 7000)) > 10
    one = upload(hb, cuda)
    chunked = upload_table(hb, cuda, chunk_rows=7000, max_inflight=2)
    torch.cuda.synchronize()
    for a, b in zip(chunked.columns, one.columns):
        for x, y in ((a.data, b.data), (a.validity, b.validity),
                     (a.lengths, b.lengths)):
            assert (x is None) == (y is None)
            assert x is None or (x.shape == y.shape and torch.equal(x, y))


@pytest.mark.cuda
def test_cuda_streaming_collect_equals_synchronous_download(cuda):
    """Q1 and an 8-way repartition (eight result batches) collect the same
    bytes with streaming collect on and off."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    hb = gen_lineitem(0.05, seed=5)
    out = []
    for stream in ("true", "false"):
        sess = TpuSession({**BENCH_CONF, "spark.rapids.tpu.transfer."
                           "streamingCollect.enabled": stream}, device="cuda")
        df = sess.create_dataframe(hb)
        out.append((q1(df).collect(),
                    df.repartition(8, "l_orderkey").collect()))
    for a, b in zip(*out):
        _same_host_batch(a, b)


@pytest.mark.cuda
def test_cuda_scan_cache_warm_equals_cold(cuda):
    """Q3 over orders and lineitem hash 8 (two exchanges, an aggregate):
    the warm run reads the scan cache and gives the cold run's bits."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    sess = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql."
                       "broadcastJoinThreshold.bytes": "-1"}, device="cuda")
    frames = _q3_frames(sess, 0.05, True)
    cold = q3(frames).collect()
    hits = peek_cache().hits
    warm = q3(frames).collect()
    assert peek_cache().hits - hits == 3
    assert cold.num_rows == 10
    _same_host_batch(cold, warm)


@pytest.mark.cuda
def test_cuda_fused_q1_and_q15_repeat_bit_for_bit(cuda):
    """Q1 (its filter folded into a fused aggregate) and Q15 (revenues
    against their max) give the same bits on three runs, and equal the run
    with fusion off."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.execs.fused_execs import \
        FusedAggregateStageExec
    tables = td.gen_all(0.1, 42)
    li = gen_lineitem(0.1, seed=42)
    for conf in (BENCH_CONF, {**BENCH_CONF,
                              "spark.rapids.tpu.sql.fusion.enabled": "false"}):
        sess = TpuSession(conf, device="cuda")
        runs = []
        for _ in range(3):
            runs.append((q1(sess.create_dataframe(li)).collect(),
                         QUERIES[15]({k: sess.create_dataframe(v)
                                      for k, v in tables.items()}).collect()))
        if conf is BENCH_CONF:
            assert [n for n in sess.last_plan.walk()
                    if isinstance(n, FusedAggregateStageExec)]
            fused = runs[0]
        for r in runs[1:] + [fused]:
            for a, b in zip(runs[0], r):
                _same_host_batch(a, b)
    assert fused[0].num_rows >= 4 and fused[1].num_rows >= 1


@pytest.mark.cuda
def test_cuda_pipeline_under_one_permit_finishes(cuda):
    """Q3 with its uploads pipelined under sql.concurrentTpuTasks=1: the
    producers join the action's hold and the query finishes."""
    import threading
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
    sess = TpuSession({**BENCH_CONF,
                       "spark.rapids.tpu.sql.concurrentTpuTasks": "1"},
                      device="cuda")
    out = []
    t = threading.Thread(target=lambda: out.append(
        q3(_q3_frames(sess, 0.05, True)).collect()), daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive() and out[0].num_rows == 10
    import os
    assert [n for n in sess.last_plan.walk()
            if isinstance(n, PipelinedExec)] or (os.cpu_count() or 1) < 2
    assert DeviceManager.peek().semaphore.active_holders == 0


def _rows_by_key(hb, keys=1):
    """A host batch's columns with its rows ordered by its first ``keys``
    columns (unique together), as numpy byte strings per column."""
    n = hb.num_rows
    order = np.lexsort([hb.columns[i].data[:n]
                        for i in reversed(range(keys))])
    out = []
    for c in hb.columns:
        if c.lengths is None:
            data = c.data[:n][order].tobytes()
        else:
            data = [bytes(c.data[r, :c.lengths[r]]) for r in order]
        out.append((c.validity[:n][order].tobytes(), data))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["l_linenumber", "l_suppkey", "l_orderkey"])
def test_cuda_forced_partition_float_sums_equal_single_pass(cuda, key):
    """Float sums of an aggregate forced through four grace partitions,
    three times, give the single pass's bits, in the one-hot, hash and
    sort grouping modes: a partition keeps each group's rows in input
    order and the card reduces each group in row order."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.memory import grace
    li = td.gen_all(0.1, 42)["lineitem"]

    def run(conf):
        DeviceManager.shutdown()
        sess = TpuSession(conf, device="cuda")
        res = (sess.create_dataframe(li).groupBy(key)
               .agg(F.sum("l_extendedprice").alias("s"),
                    F.sum("l_discount").alias("d"),
                    F.count(F.lit(1)).alias("n")).collect())
        return _rows_by_key(res), sess
    single, _ = run(BENCH_CONF)
    grace.reset_counters()
    for _ in range(3):
        forced, sess = run({**BENCH_CONF, "spark.rapids.tpu.memory."
                            "outOfCore.forcePartitions": "4"})
        assert forced == single
    assert grace.counters()["spill_partitions"] == 12
    assert [n.grace_stats["partitions"] for n in sess.last_plan.walk()
            if hasattr(n, "grace_stats")] == [4]


@pytest.mark.cuda
def test_cuda_grace_join_through_host_tier_equals_single_pass(cuda):
    """A join forced through grace partitions under a 1 MiB device store:
    its pieces spill to the host tier and come back, and the joined rows
    equal the single pass's byte for byte."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    tables = td.gen_all(0.05, 42)

    def run(conf):
        DeviceManager.shutdown()
        sess = TpuSession(conf, device="cuda")
        res = (sess.create_dataframe(tables["lineitem"])
               .join(sess.create_dataframe(tables["orders"]),
                     [("l_orderkey", "o_orderkey")])
               .select("l_orderkey", "l_linenumber", "o_totalprice",
                       "l_extendedprice", F.col("o_orderpriority"))
               .collect())
        return _rows_by_key(res, keys=2), DeviceManager.peek()
    single, _ = run(BENCH_CONF)
    forced, dm = run({**BENCH_CONF,
                      "spark.rapids.tpu.memory.outOfCore.forcePartitions":
                          "4",
                      "spark.rapids.tpu.memory.tpu.poolSizeBytes":
                          str(1 << 20),
                      "spark.rapids.tpu.sql.scanCache.enabled": "false"})
    assert dm.spilled_bytes()["host"] > 0
    assert forced == single
    assert not dm.catalog.ids()


@pytest.mark.cuda
def test_cuda_floor_ceil_saturate_as_cpu(cuda):
    """floor and ceil of +-inf, 1e300, 9.3e18 and NaN saturate at the long
    bounds and take NaN to 0, on the card as on the CPU."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, Ceil, Floor
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    vals = np.array([np.inf, -np.inf, 1e300, -1e300, 9.3e18, -9.3e18,
                     np.nan, 2.5, -2.5, -0.0])
    i64 = np.iinfo(np.int64)
    want = {Floor: [i64.max, i64.min, i64.max, i64.min, i64.max, i64.min, 0,
                    2, -3, 0],
            Ceil: [i64.max, i64.min, i64.max, i64.min, i64.max, i64.min, 0,
                   3, -2, 0]}
    for cls, expect in want.items():
        for dev in ("cuda", "cpu"):
            col = ColV(DType.DOUBLE, torch.from_numpy(vals).to(dev),
                       torch.ones(len(vals), dtype=torch.bool, device=dev))
            out = cls(BoundReference(0, DType.DOUBLE)).eval(
                EvalCtx([col], len(vals), torch.device(dev)))
            assert out.data.cpu().tolist() == expect, (cls, dev)


def _window_case(dev, n, seed):
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs.core import ColV
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.r_[rng.standard_normal(64) * 1e3,
                            [0.0, -0.0, np.nan, np.inf]], n)
    words = np.zeros((n, 8), np.uint8)
    words[:, :3] = rng.integers(97, 100, (n, 3))
    cols = [(DType.LONG, rng.integers(0, 500, n)),
            (DType.LONG, rng.integers(0, 100_000, n)),
            (DType.DOUBLE, vals)]
    valid = torch.from_numpy(rng.random(n) > 0.1)
    out = [ColV(t, torch.from_numpy(a).to(dev), valid.to(dev))
           for t, a in cols]
    out.append(ColV(DType.STRING, torch.from_numpy(words).to(dev),
                    valid.to(dev),
                    torch.full((n,), 3, dtype=torch.int32, device=dev)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [("rows", -3, 0), ("rows", None, 0),
                                   ("range", -50, 20)])
def test_cuda_framed_min_max_first_last_repeat_and_equal_cpu(cuda, frame):
    """Framed min/max (doubles with NaN and -0.0, strings), first/last
    with and without ignore nulls, percent_rank's and cume_dist's
    divisions and the framed float sum: the card gives the same bits on
    every run, and the CPU's."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.execs.window_execs import evaluate_window
    from spark_rapids_tpu_torch.exprs import (Alias, BoundReference, First,
                                              Last, Max, Min, SortOrder, Sum)
    from spark_rapids_tpu_torch.exprs.core import EvalCtx
    from spark_rapids_tpu_torch.exprs.windows import (CumeDist, PercentRank,
                                                      WindowExpression,
                                                      WindowFrame)
    n = 1 << 20
    refs = [BoundReference(i, t) for i, t in enumerate(
        (DType.LONG, DType.LONG, DType.DOUBLE, DType.STRING))]
    spec = dict(part_keys=(refs[0],), orders=(SortOrder(refs[1]),))
    framed = dict(spec, frame=WindowFrame(*frame))
    fns = [Max(refs[2]), Min(refs[2]), Min(refs[3]), Max(refs[3]),
           First(refs[2]), Last(refs[2], True), Sum(refs[2])]
    wexprs = tuple(Alias(WindowExpression(f, **framed), f"w{i}")
                   for i, f in enumerate(fns))
    ranks = (Alias(WindowExpression(PercentRank(), **spec), "pr"),
             Alias(WindowExpression(CumeDist(), **spec), "cd"))
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        cols = _window_case(dev, n, seed=3)
        ctx = EvalCtx(cols, n, torch.device(dev))
        res = evaluate_window(ctx, wexprs, n)[4:] + \
            evaluate_window(ctx, ranks, n)[4:]
        runs.append([(r.data.cpu(), r.validity.cpu()) for r in res])
    def bits(t):
        return t.view(torch.int64) if t.dtype == torch.float64 else t
    for a, b, c in zip(*runs):
        assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])
        v = a[1]
        assert torch.equal(bits(a[0][v]), bits(b[0][v]))
        assert torch.equal(bits(a[0][v]), bits(c[0][v]))


# ------------------------------------------------------------- slice 12
def _encoded_table():
    """Dictionary columns of every flavor (string, int, double with nulls)
    and a run-end-encoded one, as the parquet scan stages them."""
    import pyarrow as pa
    rng = np.random.default_rng(31)
    n = 50000
    return pa.table({
        "s": pa.array(np.array(["aa", "bbb", "c", "dddd"])[
            rng.integers(0, 4, n)]).dictionary_encode(),
        "k": pa.array(rng.integers(0, 40, n), pa.int64()).dictionary_encode(),
        "d": pa.array([None if v % 13 == 0 else float(v) / 4
                       for v in rng.integers(0, 300, n)],
                      pa.float64()).dictionary_encode(),
        "r": pa.RunEndEncodedArray.from_arrays(
            pa.array([7000, 20000, 20001, n], pa.int32()),
            pa.array([1.5, -0.0, float("nan"), 3.0], pa.float64())),
        "p": pa.array(rng.integers(0, 1 << 40, n), pa.int64())})


def _same_device_columns(a, b):
    n = a.num_rows
    assert n == b.num_rows
    for x, y in zip(a.columns, b.columns):
        for s, t in ((x.data, y.data), (x.validity, y.validity),
                     (x.lengths, y.lengths)):
            assert (s is None) == (t is None)
            if s is not None:
                assert torch.equal(s[:n].cpu().contiguous().view(torch.uint8),
                                   t[:n].cpu().contiguous().view(torch.uint8))
        assert (x.encoding is None) == (y.encoding is None)
        if x.encoding is not None:
            assert torch.equal(x.encoding.indices[:n].cpu(),
                               y.encoding.indices[:n].cpu())
            assert torch.equal(x.encoding.values.cpu(),
                               y.encoding.values.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [0, 7000])
def test_cuda_encoded_upload_and_run_expansion_equal_cpu(cuda, chunk_rows):
    """The encoded upload (dictionary gathers, the searchsorted run
    expansion) gives the CPU upload's bits, chunked or not, and keeps the
    same encodings."""
    from spark_rapids_tpu_torch.columnar.transfer import upload_arrow
    t = _encoded_table()
    on_card = upload_arrow(t, cuda, 16, chunk_rows=chunk_rows)
    torch.cuda.synchronize()
    _same_device_columns(on_card, upload_arrow(t, torch.device("cpu"), 16,
                                               chunk_rows=chunk_rows))
    assert on_card.columns[0].encoding is not None


def _encoded_scan_batch(dev, tmp_path):
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    from spark_rapids_tpu_torch.io.parquet import (TpuParquetScanExec,
                                                   schema_of_arrow)
    t = _encoded_table().drop(["r"])
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)
    scan = TpuParquetScanExec((PartitionedFile(path),),
                              schema_of_arrow(pq.read_schema(path)))
    (batch,) = list(scan.execute(ExecContext(TpuConf({}), dev)))
    return batch


@pytest.mark.cuda
def test_cuda_encoded_split_equals_kernel_split(cuda, tmp_path):
    """One scan batch with token-carrying encodings split 8 ways: the
    encoded split's pieces equal the sort path's bit for bit, in the same
    order, and keep the dictionary; the kernel split's pieces hold the same
    rows (its consolidation takes each group's full 8-row blocks before
    the remainders, the JAX package's order, so rows compare by a unique
    key)."""
    db = _encoded_scan_batch(cuda, tmp_path)
    enc = {ci: c.encoding for ci, c in enumerate(db.columns)
           if c.encoding is not None and c.encoding.token is not None}
    assert enc
    key = db.schema.index_of("p")
    ectx = tx.eval_ctx(db, ExecContext(TpuConf({}), cuda))
    hashes = tx.key_hashes([ectx.columns[key]], db.capacity)
    pids = tx._compute_pids(tx.HashPartitioning(8, ()), db.capacity, 0,
                            hashes, cuda)
    launches, kept = tpk.REORDER_KERNEL.launches, tpk.REORDER_KERNEL.kept
    kernel = tx.TpuShuffleExchangeExec._kernel_split(
        ExecContext(TpuConf({}), cuda), db, pids, 8)
    assert kernel is not None and tpk.REORDER_KERNEL.launches == launches + 1
    assert tpk.REORDER_KERNEL.kept == kept + 1
    encoded = tx._split_encoded(db, pids, 8, enc)
    sorted_cols, counts = tx.split_by_pid(ectx.columns, pids, db.num_rows, 8)
    starts = np.concatenate([[0], np.cumsum(counts)])
    assert [j for j, _ in kernel] == [j for j, _ in encoded]
    for (j, a), (_, b) in zip(kernel, encoded):
        n = b.num_rows
        plain = tx._slice_padded(sorted_cols, db.schema, int(starts[j]), n)
        assert a.num_rows == n
        order = torch.argsort(a.columns[key].data[:n])
        for ci, (x, y, z) in enumerate(zip(a.columns, b.columns,
                                           plain.columns)):
            for u, v in ((y.validity[:n], z.validity[:n]),
                         (y.data[:n], z.data[:n]),
                         (x.data[:n][order], y.data[:n][torch.argsort(
                             b.columns[key].data[:n])])):
                assert torch.equal(u.contiguous().view(torch.uint8),
                                   v.contiguous().view(torch.uint8)), ci
            if ci in enc:
                e = y.encoding
                valid = y.validity[:n]
                assert e.token == enc[ci].token
                assert torch.equal(
                    y.data[:n][valid],
                    e.values.index_select(0, e.indices[:n])[valid])


@pytest.mark.cuda
def test_cuda_encoded_domain_aggregate_repeats_bit_for_bit(cuda, tmp_path):
    """Q1 from parquet on the card (grouping on the string keys' indices,
    the folded filter over the dictionaries) gives the same bits twice and
    the keys-off run's keys and counts."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    path = str(tmp_path / "lineitem.parquet")
    t = gen_lineitem(0.1, seed=7).to_arrow()
    pq.write_table(t, path, row_group_size=t.num_rows // 16)
    conf = {**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.enabled": "false",
            "spark.rapids.tpu.sql.string.maxBytes": "16"}
    sess = TpuSession(conf, device="cuda")
    runs = [q1(sess.read.parquet(path)).collect() for _ in range(2)]
    assert [n for n in sess.last_plan.walk()
            if getattr(n, "encoded_batches", 0)]
    _same_host_batch(*runs)
    off = TpuSession({**conf, "spark.rapids.tpu.sql.encodedDomain.enabled":
                      "false"}, device="cuda")
    dec = q1(off.read.parquet(path)).collect()
    for ci in (0, 1, 9):        # the flags, the statuses, count_order
        a, b = runs[0].columns[ci], dec.columns[ci]
        assert np.array_equal(a.data[:runs[0].num_rows],
                              b.data[:dec.num_rows])


@pytest.mark.cuda
def test_cuda_device_arrays_equal_collect(cuda):
    """``ml.device_arrays`` hands over tensors on cuda, equal to the
    collected result of the same DataFrame, for the mortgage ETL with the
    performance table hash 8 (the reorder kernel launches)."""
    from spark_rapids_tpu_torch import ml
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import mortgage as mg
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    sess = TpuSession(BENCH_CONF, device="cuda")

    def etl():
        perf = sess.create_dataframe(mg.gen_performance(0.5, 42))
        return mg.clean_acquisition_prime(
            perf.repartition(8, "loan_id"),
            sess.create_dataframe(mg.gen_acquisition(0.5, 42)))

    launches = tpk.REORDER_KERNEL.launches
    arrays = ml.device_arrays(etl())
    assert tpk.REORDER_KERNEL.launches > launches
    assert all(t.is_cuda for ts in arrays.values() for t in ts)
    schema = etl().schema()
    n = arrays[schema[0].name][0].shape[0]
    got = HostBatch(schema, tuple(
        HostColumn(f.dtype, *[t.cpu().numpy() for t in arrays[f.name]])
        for f in schema), n)
    want = etl().collect()
    assert got.num_rows == want.num_rows > 0

    def rows(hb):
        # a null's slot may hold any value (a min's identity among them):
        # zero it before converting
        cols = []
        for c in hb.columns:
            valid = c.validity.astype(bool)
            mask = valid if c.data.ndim == 1 else valid[:, None]
            cols.append(HostColumn(c.dtype, np.where(mask, c.data, 0),
                                   valid, c.lengths).to_pylist(hb.num_rows))
        return sorted(zip(*cols), key=repr)
    assert rows(got) == rows(want)


@pytest.mark.cuda
def test_cuda_cpu_engine_between_device_operators(cuda):
    """A CPU engine operator between two device operators (a float sum
    without variableFloatAgg, between the card's filter and sort) returns
    the device plan's result."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    from spark_rapids_tpu_torch.execs.cpu_execs import CpuHashAggregateExec
    li = gen_lineitem(0.05, seed=3)
    mixed = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql."
                        "variableFloatAgg.enabled": "false"}, device="cuda")
    got = q1(mixed.create_dataframe(li).repartition(8, "l_orderkey")) \
        .collect()
    names = [type(n).__name__ for n in mixed.last_plan.walk()]
    i = names.index("CpuHashAggregateExec")
    assert "TpuSortExec" in names[:i] and any(
        n.startswith("Tpu") for n in names[i + 1:]), names
    dev = TpuSession(BENCH_CONF, device="cuda")
    want = q1(dev.create_dataframe(li).repartition(8, "l_orderkey")) \
        .collect()
    assert not any(isinstance(n, CpuHashAggregateExec)
                   for n in dev.last_plan.walk())
    assert got.num_rows == want.num_rows == 6
    for ci in range(len(want.columns)):
        a, b = got.columns[ci], want.columns[ci]
        if a.dtype.is_floating:
            np.testing.assert_allclose(a.data[:6], b.data[:6], rtol=1e-9)
        else:
            assert a.to_pylist(6) == b.to_pylist(6)


# ------------------------------------------------- adaptive execution, coalesce
@pytest.mark.cuda
@pytest.mark.parametrize("require_single", [False, True])
def test_cuda_coalesce_batches_equal_cpu(cuda, require_single):
    """``coalesce_batches`` over the same lineitem pieces on the card and
    on the CPU: the same batch boundaries, every live byte equal."""
    from spark_rapids_tpu_torch.execs.tpu_execs import coalesce_batches
    pieces = [gen_lineitem(0.001 * (i + 1), seed=i) for i in range(5)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        batches = [upload(hb, dev) for hb in pieces]
        target = sum(b.device_size_bytes for b in batches[:2])
        outs.append(list(coalesce_batches(iter(batches), batches[0].schema,
                                          target, require_single, dev)))
    got, want = outs
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    assert len(got) == 1 if require_single else len(got) > 1
    for a, b in zip(got, want):
        _same_device_columns(a, b)


def _skew_frames(sess):
    import pyarrow as pa
    rng = np.random.default_rng(20)
    z = np.minimum(rng.zipf(1.3, 60_000), 1000).astype(np.int64)
    fact = pa.table({"k": z, "v": np.arange(60_000, dtype=np.int64)})
    dims = pa.table({"k": np.arange(1, 1001, dtype=np.int64),
                     "w": rng.integers(0, 100, 1000).astype(np.int64)})
    lt = sess.create_dataframe(fact).repartition(8).repartition(6, "k")
    rt = sess.create_dataframe(dims).repartition(3).repartition(6, "k")
    return lt.join(rt, "k")


@pytest.mark.cuda
def test_cuda_skew_split_join_repeats_and_equals_cpu(cuda):
    """The skew-split join (bench.py's skewed join at its own size) on the
    card twice, bit for bit the same both times, and equal to the CPU's
    run of the same plan."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    conf = {**BENCH_CONF,
            "spark.rapids.tpu.sql.adaptive.enabled": "true",
            "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1",
            "spark.rapids.tpu.sql.adaptive."
            "skewedPartitionThreshold.bytes": "64",
            "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor": "2.0",
            "spark.rapids.tpu.sql.adaptive."
            "advisoryPartitionSizeInBytes": "65536"}

    def rows(hb):
        cols = [c.to_pylist(hb.num_rows) for c in hb.columns]
        return sorted(zip(*cols))

    card = TpuSession(conf, device="cuda")
    first = _skew_frames(card).collect()
    assert "skew-split" in card.last_plan.tree_string()
    second = _skew_frames(card).collect()
    assert rows(first) == rows(second)
    DeviceManager.shutdown()
    host = TpuSession(conf, device="cpu")
    cpu = _skew_frames(host).collect()
    assert "skew-split" in host.last_plan.tree_string()
    assert rows(first) == rows(cpu)
    assert first.num_rows == 60_000     # every capped key has its dim row


@pytest.mark.cuda
def test_cuda_adaptive_tpch_q3_equals_adaptive_off(cuda):
    """TPC-H Q3 (orders and lineitem hash 8) with adaptive execution on
    equals its run with it off: keys, dates and counts exactly, the revenue
    sums within relative 1e-9 (coalesced partitions regroup the partial
    sums)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    tables = {k: g(0.05, 3) for k, g in (
        ("customer", td.gen_customer), ("orders", td.gen_orders),
        ("lineitem", td.gen_lineitem_full))}

    def run(conf):
        sess = TpuSession(conf, device="cuda")
        dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
        dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
        dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
        return q3(dfs).collect(), sess

    on, s_on = run({**BENCH_CONF,
                    "spark.rapids.tpu.sql.adaptive.enabled": "true"})
    assert "[adaptive: " in s_on.last_plan.tree_string()
    off, _ = run(BENCH_CONF)
    assert on.num_rows == off.num_rows == 10
    for a, b in zip(on.columns, off.columns):
        if a.dtype.is_floating:
            np.testing.assert_allclose(a.data[:10], b.data[:10], rtol=1e-9)
        else:
            assert a.to_pylist(10) == b.to_pylist(10)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_cuda_partitioned_write_equals_cpu(cuda, tmp_path, fmt):
    """lineitem hash-repartitioned on the card (the reorder kernel) and
    written partitioned by its flags from device batches: the same files,
    rows per file and rows as the CPU run's write, read back on the card
    equal to the CPU run's read-back, sorted."""
    import os
    import re

    import pyarrow.orc as po
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.io.write_exec import TpuWriteFilesExec
    li = td.gen_lineitem_full(0.05, 11)
    stats, backs = {}, {}
    for dev in ("cpu", "cuda"):
        sess = TpuSession(BENCH_CONF, device=dev)
        out = str(tmp_path / dev)
        launches = tpk.REORDER_KERNEL.launches
        w = (sess.create_dataframe(li).repartition(4, "l_orderkey").write
             .partitionBy("l_returnflag", "l_linestatus")
             .option("maxRecordsPerFile", 20000))
        stats[dev] = getattr(w, fmt)(out)
        assert any(isinstance(n, TpuWriteFilesExec)
                   for n in sess.last_plan.walk())
        if dev == "cuda":
            assert tpk.REORDER_KERNEL.launches > launches
        back = getattr(sess.read, fmt)(out).sort(
            "l_orderkey", "l_linenumber").collect()
        files = {}
        for d, _, fs in os.walk(out):
            for f in fs:
                if f.endswith("." + fmt):
                    p = os.path.join(d, f)
                    files[re.sub(r"-[0-9a-f]{12}-", "-JOB-",
                                 os.path.relpath(p, out))] = (
                        pq.read_metadata(p).num_rows if fmt == "parquet"
                        else po.ORCFile(p).nrows)
        backs[dev] = (back, files)
    a, b = stats["cpu"], stats["cuda"]
    # each of the 4 tasks counts the directories it wrote (the reference's
    # sum over tasks)
    assert (a.num_rows, a.num_files, a.num_partitions) == \
        (b.num_rows, b.num_files, b.num_partitions) == \
        (li.num_rows, a.num_files, 16)
    assert backs["cpu"][1] == backs["cuda"][1]
    _same_host_batch(backs["cpu"][0], backs["cuda"][0])


@pytest.mark.cuda
def test_cuda_write_parquet_equals_cpu(cuda, tmp_path):
    """``write_parquet`` collects through the writers' download (arrow's
    layout made on the card): the file from the card equals the CPU
    run's, strings and nulls included."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    li = td.gen_lineitem_full(0.01, 5)
    tables = {}
    for dev in ("cpu", "cuda"):
        df = TpuSession(BENCH_CONF, device=dev).create_dataframe(li)
        path = str(tmp_path / f"{dev}.parquet")
        df.filter(F.col("l_quantity") > 10).withColumn(
            "c", F.when(F.col("l_discount") > 0.05, F.col("l_comment"))
        ).write_parquet(path)
        tables[dev] = pq.read_table(path)
    assert tables["cpu"].num_rows > 0
    assert tables["cpu"].equals(tables["cuda"])


def _mesh_tpch(device: str, shards: int, qnum: int, extra=None):
    """TPC-H ``qnum`` at SF 0.05 on a mesh of ``shards`` on ``device`` ->
    (result, session, the mesh counters)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    sess = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.mesh.enabled":
                       "true", "spark.rapids.tpu.sql.mesh.numDevices":
                       str(shards), **(extra or {})}, device=device)
    tables = td.gen_all(0.05, 3)
    mbm.reset_counters()
    launches = tpk.REORDER_KERNEL.launches
    out = QUERIES[qnum]({k: sess.create_dataframe(v)
                         for k, v in tables.items()}).collect()
    seen = mbm.counters()
    seen["reorder_launches"] = tpk.REORDER_KERNEL.launches - launches
    return out, sess, seen


def _same_rows(a, b, n_float_rel=1e-9):
    assert a.num_rows == b.num_rows
    for x, y in zip(a.columns, b.columns):
        if x.dtype.is_floating:
            np.testing.assert_allclose(x.data[:a.num_rows],
                                       y.data[:a.num_rows], rtol=n_float_rel)
        else:
            assert x.to_pylist(a.num_rows) == y.to_pylist(b.num_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("qnum,extra", [
    (1, None),
    (3, {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"})])
def test_cuda_mesh_four_shards_equal_cpu_mesh(cuda, qnum, extra):
    """TPC-H Q1 and Q3 (shuffled joins) on a 4-shard mesh on one card equal
    the 4-shard CPU mesh (float sums within 1e-9: the same partials meet in
    the same order, but the card's sums may round differently); every
    shard tensor on the card, no host hop, no reorder launch."""
    got, sess, seen = _mesh_tpch("cuda", 4, qnum, extra)
    want, cpu_sess, _ = _mesh_tpch("cpu", 4, qnum, extra)
    names = [type(n).__name__ for n in sess.last_plan.walk()]
    assert "MeshHashAggregateExec" in names, names
    assert names == [type(n).__name__ for n in cpu_sess.last_plan.walk()]
    if qnum == 3:
        assert "MeshShuffledHashJoinExec" in names, names
    assert seen["shard_device_kinds"] == ["cuda"], seen
    assert seen["host_hop_bytes"] == 0 and seen["reorder_launches"] == 0
    _same_rows(want, got)


@pytest.mark.cuda
def test_cuda_mesh_two_cards_equal_one_card(cuda):
    """A mesh over two cards (shard i on card i mod 2; the exchanges copy
    peer to peer) equals the same mesh on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from spark_rapids_tpu_torch.plan.mesh_rewrite import session_mesh
    from spark_rapids_tpu_torch.config import TpuConf
    mesh = session_mesh(TpuConf({"spark.rapids.tpu.sql.mesh.numDevices":
                                 "4"}), torch.device("cuda"))
    assert len(set(mesh.devices)) >= 2, mesh
    got, sess, seen = _mesh_tpch("cuda", 4, 3, {
        "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"})
    assert seen["host_hop_bytes"] == 0
    want, _, _ = _mesh_tpch("cpu", 4, 3, {
        "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"})
    _same_rows(want, got)


@pytest.mark.cuda
def test_cuda_device_pack_equals_cpu_bytes(cuda):
    """The device pack on the card gives the bytes the CPU's gives (every
    column of lineitem, float64 and strings included), and they unpack on
    the card to the same batch."""
    from spark_rapids_tpu_torch.shuffle import table_meta as tm
    hb = gen_lineitem(0.01, 3)
    packs = {}
    for dev in (cuda, torch.device("cpu")):
        db = tm.uniform_string_batch(upload(hb, dev))
        layout = tm.DevicePackLayout.for_batch_shape(
            db.schema, db.capacity, tm.batch_string_max(db))
        packs[dev.type] = (tm.device_pack(db, layout), layout, db)
    gpu, layout, db = packs["cuda"]
    assert gpu.device.type == "cuda"
    assert gpu.cpu().numpy().tobytes() == \
        packs["cpu"][0].numpy().tobytes()
    back = tm.device_unpack(gpu, layout, db.num_rows)
    for a, b in zip(back.columns, db.columns):
        assert torch.equal(a.validity, b.validity)
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))


def _cluster_q3(device, extra):
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    sess = TpuSession({**BENCH_CONF, **extra,
                       "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
                       "1"}, device=device)
    tables = td.gen_all(0.05, 3)
    try:
        out = QUERIES[3]({k: sess.create_dataframe(v).repartition(2)
                          for k, v in tables.items()}).collect()
        sched = getattr(sess, "_cluster_scheduler", None)
        shape = None if sched is None else (
            {st.executor_id for stage in sched.last_stages
             for st in stage.statuses},
            [getattr(ex, "device", None) for ex in sched.executors],
            [ex.probe() for ex in sched.executors if hasattr(ex, "probe")])
        return out, shape
    finally:
        if getattr(sess, "_cluster_scheduler", None) is not None:
            sess._cluster_scheduler.close()


@pytest.mark.cuda
def test_cuda_cluster_over_tcp_equals_single_device(cuda, tmp_path):
    """TPC-H Q3 on two in-process executors over TCP on the card equals
    the single-device card run (float sums within 1e-9); both executors
    did map work."""
    got, (execs, _, _) = _cluster_q3("cuda", {
        "spark.rapids.tpu.sql.cluster.numExecutors": "2",
        "spark.rapids.tpu.shuffle.transport.class":
        "spark_rapids_tpu_torch.shuffle.tcp.TcpTransport",
        "spark.rapids.tpu.shuffle.tcp.registryDir": str(tmp_path / "reg")})
    assert execs == {"exec-0", "exec-1"}
    want, _ = _cluster_q3("cuda", {})
    _same_rows(want, got)


@pytest.mark.cuda
def test_cuda_executor_daemons_equal_cpu(cuda):
    """Two executor daemons on the card (each opens cuda; the store
    fraction leaves room for both and the driver) equal the CPU run; the
    daemons' round-robin splits launched the reorder kernel in their own
    processes (their ping's counts) and used its output."""
    got, (execs, devices, pongs) = _cluster_q3("cuda", {
        "spark.rapids.tpu.sql.cluster.numExecutors": "2",
        "spark.rapids.tpu.sql.cluster.processExecutors": "true",
        "spark.rapids.tpu.memory.tpu.allocFraction": "0.25"})
    assert execs == {"exec-0", "exec-1"}
    assert all(d.startswith("cuda") for d in devices), devices
    assert sum(p["reorder_launches"] for p in pongs) >= 1, pongs
    assert sum(p["reorder_kept"] for p in pongs) >= 1, pongs
    assert all(p["peak_bytes"] > 0 for p in pongs), pongs
    want, _ = _cluster_q3("cpu", {})
    _same_rows(want, got)


# ---------------------------------------------------------------- serving
def _served_q1_session(extra=None):
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    return TpuSession({**BENCH_CONF, **(extra or {})})


@pytest.mark.cuda
def test_cuda_concurrent_submits_count_their_own_launches(cuda):
    """Eight Q1 submits over lineitem hash 8 from four scheduler workers:
    each result equals the single collect bit for bit, and each query's
    reorder launches (counted on its handle) equal the single run's."""
    from spark_rapids_tpu_torch.benchmarks.tpch import q1
    sess = _served_q1_session(
        {"spark.rapids.tpu.serving.maxConcurrentQueries": "4",
         "spark.rapids.tpu.sql.concurrentTpuTasks": "2"})
    li = sess.create_dataframe(gen_lineitem(0.05, 3)).repartition(
        8, "l_orderkey")
    before = tpk.REORDER_KERNEL.launches
    want = q1(li).collect()
    single = tpk.REORDER_KERNEL.launches - before
    assert single >= 1
    try:
        handles = [sess.submit(q1(li), tenant=f"t{i % 2}")
                   for i in range(8)]
        for h in handles:
            got = h.result(timeout=300)
            assert got.num_rows == want.num_rows
            for a, b in zip(got.columns, want.columns):
                assert np.array_equal(a.data, b.data)
            assert h.metric("reorder_launches") == single
        assert tpk.REORDER_KERNEL.launches - before == 9 * single
        dm = DeviceManager.peek()
        assert dm.semaphore.active_holders == 0
        assert list(dm.catalog.ids()) == []
    finally:
        sess.scheduler.shutdown()


@pytest.mark.cuda
def test_cuda_first_kernel_load_from_two_threads_runs_nvcc_once(
        cuda, tmp_path, monkeypatch):
    """A fresh build directory and a fresh program cache: two threads load
    the compact kernel's library at once, ``nvcc`` runs once, and both
    get the same bound library."""
    import subprocess
    import threading
    from spark_rapids_tpu_torch import cuda_build
    from spark_rapids_tpu_torch.serving import program_cache as ppc
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_PATHS", {})
    monkeypatch.setattr(ppc, "_GLOBAL", ppc.ProgramCache(index_path="off"))
    runs, real = [], subprocess.run

    def counted(cmd, **kw):
        runs.append(cmd)
        return real(cmd, **kw)
    monkeypatch.setattr(cuda_build.subprocess, "run", counted)
    libs = []
    ths = [threading.Thread(
        target=lambda: libs.append(tpk.COMPACT_KERNEL.load()))
        for _ in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(300)
    assert len(runs) == 1 and len(libs) == 2 and libs[0] is libs[1]
    assert libs[0].dma_compact.restype is not None


@pytest.mark.cuda
def test_cuda_preemption_parks_and_admits_the_starved_tenant(cuda):
    """One permit, preemption and parking on: a whale of many batches over
    lineitem hash 8 yields to an interactive tenant's Q6, which finishes
    first; both equal their single runs; nothing is left held."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.benchmarks.tpch import q1
    sess = _served_q1_session(
        {"spark.rapids.tpu.sql.concurrentTpuTasks": "1",
         "spark.rapids.tpu.serving.maxConcurrentQueries": "2",
         "spark.rapids.tpu.serving.preemption.enabled": "true",
         "spark.rapids.tpu.serving.preemption.starvationMs": "5",
         "spark.rapids.tpu.serving.preemption.parkSpillable": "true"})
    li = sess.create_dataframe(gen_lineitem(0.2, 5))
    whale = q1(li.repartition(64).repartition(8, "l_orderkey"))
    inter = li.filter(F.col("l_quantity") < 24).agg(
        F.sum(F.col("l_extendedprice") * F.col("l_discount")).alias("r"))
    want_w, want_i = whale.collect(), inter.collect()
    try:
        import time
        wh = sess.submit(whale, tenant="whale")
        deadline = time.monotonic() + 60
        while (DeviceManager.peek() is None
               or DeviceManager.peek().semaphore.active_holders == 0):
            assert time.monotonic() < deadline, "the whale never ran"
            time.sleep(0.001)
        ih = sess.submit(inter, tenant="interactive")
        got_i = ih.result(timeout=300)
        got_w = wh.result(timeout=300)
        for got, want in ((got_w, want_w), (got_i, want_i)):
            for a, b in zip(got.columns, want.columns):
                assert np.array_equal(a.data, b.data)
        assert wh.snapshot()["preemptions"] >= 1
        assert ih.snapshot()["wall_s"] < wh.snapshot()["wall_s"]
        dm = DeviceManager.peek()
        assert dm.semaphore.active_holders == 0
        assert list(dm.catalog.ids()) == []
    finally:
        sess.scheduler.shutdown()
