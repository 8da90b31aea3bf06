"""The port's batch coalesce (execs/tpu_execs.py ``TpuCoalesceBatchesExec``
and ``coalesce_batches``), its fused form (execs/fused_execs.py,
plan/fusion.py) and the encodings it carries, against the JAX package:
the same seeded batches through both packages' ``coalesce_batches`` give
the same batch boundaries and rows, with and without ``require_single``;
the fusion pass composes a coalesce as the JAX pass does (and refuses the
same shapes); and a coalesce over a parquet scan keeps the dictionary
encodings exactly where the JAX package's does."""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.transfer import upload_table as jax_upload
from spark_rapids_tpu.execs import tpu_execs as jte
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import download, upload
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import ExecContext
from spark_rapids_tpu_torch.execs.fused_execs import (FusedAggregateStageExec,
                                                      FusedStageExec)
from spark_rapids_tpu_torch.plan.encoded import _preserves_encoding
from spark_rapids_tpu_torch.plan.fusion import fuse_stages

from torch_adaptive_common import AQE, assert_same_run, run_port, t7, walk

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(seed=0, sizes=(5, 17, 0, 40, 3, 64, 9)):
    """Small int64/int32 tables (their device bytes count the same in both
    packages: values plus a one-byte validity per row of capacity)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        v = rng.integers(-1000, 1000, n)
        nulls = rng.random(n) < 0.2
        out.append(pa.table({
            "a": pa.array(v.astype(np.int64), mask=nulls),
            "b": pa.array((v % 7).astype(np.int32))}))
    return out


def _port_batches(tables):
    return [upload(HostBatch.from_arrow(t, 256), CPU) for t in tables]


def _jax_batches(tables):
    return [jax_upload(t) for t in tables]


@pytest.mark.parametrize("require_single", [False, True])
@pytest.mark.parametrize("target", [1, 200, 700, 5000, 1 << 31])
def test_coalesce_batches_against_jax(target, require_single):
    tables = _tables()
    pb = _port_batches(tables)
    jb = _jax_batches(tables)
    assert [b.device_size_bytes for b in pb] == \
        [b.device_size_bytes for b in jb]
    schema = pb[0].schema
    got = list(te.coalesce_batches(iter(pb), schema, target,
                                   require_single, CPU))
    want = list(jte.coalesce_batches(iter(jb), jb[0].schema, target,
                                     require_single, 256))
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    # an empty concatenation's capacity is each package's empty-batch
    # bucket (the JAX package's 1, the port's smallest bucket)
    assert [b.capacity for b in got if b.num_rows] == \
        [b.capacity for b in want if b.num_rows]
    if require_single:
        assert len(got) == 1
    for g, w in zip(got, want):
        assert_tables_equal(w.to_arrow(), download(g).to_arrow())


@pytest.mark.parametrize("require_single", [False, True])
def test_coalesce_batches_empty_input(require_single):
    schema = _port_batches(_tables(sizes=(1,)))[0].schema
    got = list(te.coalesce_batches(iter(()), schema, 100, require_single,
                                   CPU))
    jschema = _jax_batches(_tables(sizes=(1,)))[0].schema
    want = list(jte.coalesce_batches(iter(()), jschema, 100,
                                     require_single, 256))
    assert len(got) == len(want) == (1 if require_single else 0)
    assert all(b.num_rows == 0 for b in got)


def test_coalesce_exec_yields_the_concatenation():
    from spark_rapids_tpu_torch.execs.cpu_execs import CpuLocalScanExec
    tables = _tables(seed=4)
    full = pa.concat_tables(tables)
    scan = te.HostToDeviceExec(CpuLocalScanExec(HostBatch.from_arrow(full,
                                                                     256)))
    node = te.TpuCoalesceBatchesExec(scan, target_bytes=1,
                                     require_single=True)
    assert node.size_estimate() == scan.size_estimate()
    out = list(node.execute(ExecContext(TpuConf({}), CPU)))
    assert len(out) == 1
    assert_tables_equal(full, download(out[0]).to_arrow())


# ------------------------------------------------------------ the fused coalesce
def _chain(s, f):
    # a lone filter: fused at plan time it would not be (one operator), so
    # the only fused stage is the one re-fusion makes with the coalesce
    return s.create_dataframe(t7()).repartition(6, "k").filter(
        f.col("v") % 3 == 1)


def test_fused_coalesce_against_jax_and_unfused():
    """Adaptive execution puts a coalesce over the coalesced reader; the
    re-fusion pass fuses it with the filter above. The fused
    stage's ops and coalesce equal the JAX package's, and the result
    equals the unfused run's bit for bit."""
    port, ref = assert_same_run(AQE, _chain)
    stages = [n for n in port[1].last_plan.walk()
              if isinstance(n, FusedStageExec)]
    jstages = [n for n in walk(ref[1].last_plan)
               if type(n).__name__ == "FusedStageExec"]
    assert len(stages) == len(jstages) == 1
    assert [n for n, _ in stages[0].fused_ops] == \
        [n for n, _ in jstages[0].fused_ops]
    assert "TpuCoalesceBatchesExec" in [n for n, _ in stages[0].fused_ops]
    assert stages[0].coalesce == jstages[0].coalesce
    unfused = {**AQE, "spark.rapids.tpu.sql.fusion.enabled": "false"}
    off = run_port(unfused, _chain)
    assert not any(isinstance(n, FusedStageExec)
                   for n in off[1].last_plan.walk())
    assert port[0].sort_by("v").equals(off[0].sort_by("v"))


def _hand_chain(require_single, expand=False):
    """upload -> filter -> coalesce -> project (top), in the port."""
    from spark_rapids_tpu_torch.execs.cpu_execs import CpuLocalScanExec
    from spark_rapids_tpu_torch.execs.expand_execs import TpuExpandExec
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    from spark_rapids_tpu_torch.exprs.literals import Literal
    from spark_rapids_tpu_torch.exprs.misc import Alias
    from spark_rapids_tpu_torch.exprs.predicates import GreaterThan
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    t = pa.concat_tables(_tables(seed=9))
    scan = te.HostToDeviceExec(CpuLocalScanExec(HostBatch.from_arrow(t,
                                                                     256)))
    a = BoundReference(0, DType.LONG, True, "a")
    b = BoundReference(1, DType.INT, False, "b")
    filt = te.TpuFilterExec(GreaterThan(a, Literal(0, DType.LONG)), scan)
    mid = filt
    if expand:
        mid = TpuExpandExec(((a, b), (a, b)), filt, filt.output)
    co = te.TpuCoalesceBatchesExec(mid, target_bytes=300,
                                   require_single=require_single)
    return te.TpuProjectExec((Alias(a, "a"),), co), t


@pytest.mark.parametrize("require_single,expand,fuses", [
    (False, False, True),
    # a require_single coalesce above a real operator would concatenate
    # the raw input; a coalesce with an Expand would reorder the variants
    (True, False, False),
    (False, True, False),
])
def test_fusion_composes_or_refuses_coalesce(require_single, expand, fuses):
    """The shapes the JAX package's ``_compose`` refuses stay unfused in
    the port too; a fused chain's result equals the unfused one."""
    plan, _ = _hand_chain(require_single, expand)
    fused = fuse_stages(plan, TpuConf({}))
    stage = [n for n in fused.walk() if isinstance(n, FusedStageExec)]
    head = stage[0] if stage else None
    if fuses:
        assert head is not None and head.coalesce == (300, False)
        assert head.saved_per_batch == 1
    else:
        assert head is None or "TpuCoalesceBatchesExec" not in \
            [n for n, _ in head.fused_ops]
    ctx = ExecContext(TpuConf({}), CPU)
    got = pa.concat_tables(download(b).to_arrow()
                           for b in fused.execute(ctx))
    want = pa.concat_tables(download(b).to_arrow()
                            for b in plan.execute(ctx))
    assert got.equals(want)


def test_aggregate_fold_absorbs_coalesce():
    """An aggregate over a coalesce over a filter folds both, as the JAX
    package's ``fold_aggregate_chain`` does with ``coalesce_cls``."""
    from spark_rapids_tpu_torch.exprs.aggregates import Sum
    from spark_rapids_tpu_torch.exprs.misc import Alias
    from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema, DType
    plan, t = _hand_chain(False)
    co = plan.children[0]
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    key = BoundReference(1, DType.INT, False, "b")
    val = BoundReference(0, DType.LONG, True, "a")
    agg = te.TpuHashAggregateExec(
        (key,), (Alias(Sum(val), "s"),), co,
        Schema([Field("b", DType.INT, False), Field("s", DType.LONG, True)]))
    fused = fuse_stages(agg, TpuConf({}))
    assert isinstance(fused, FusedAggregateStageExec)
    assert [n for n, _ in fused.fused_ops] == ["TpuCoalesceBatchesExec",
                                              "TpuFilterExec"]
    assert isinstance(fused.children[0], te.HostToDeviceExec)
    ctx = ExecContext(TpuConf({}), CPU)
    got = download(next(iter(fused.execute(ctx)))).to_arrow().sort_by("b")
    filt = t.filter(pa.compute.greater(t["a"], 0))
    want = filt.group_by("b").aggregate([("a", "sum")]).sort_by("b")
    assert got.column("s").to_pylist() == want.column("a_sum").to_pylist()


# ------------------------------------------------------------ encodings
def test_encodings_through_coalesce_over_parquet_scan(tmp_path):
    """A coalesce over a parquet scan is an encoding pass-through in both
    packages' planner pass, and its concatenation keeps a column's
    dictionary encoding exactly when the JAX package's does."""
    from spark_rapids_tpu.io.datasource import PartitionedFile as JaxFile
    from spark_rapids_tpu.io.parquet import TpuParquetScanExec as JaxScan
    from spark_rapids_tpu.plan.encoded import \
        _preserves_encoding as jax_preserves
    from spark_rapids_tpu.execs.base import ExecContext as JaxContext
    from spark_rapids_tpu.config import TpuConf as JaxConf
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    from spark_rapids_tpu_torch.io.parquet import (TpuParquetScanExec,
                                                   schema_of_arrow)
    n = 9000
    rng = np.random.default_rng(3)
    t = pa.table({
        "s": pa.array(np.array(["x", "y", "z", "w"])[rng.integers(0, 4, n)]),
        "k": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "d": pa.array(rng.random(n))})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=3000)
    schema = schema_of_arrow(t.schema)
    scan = TpuParquetScanExec((PartitionedFile(path),), schema)
    jscan = JaxScan((JaxFile(path),), schema_from_jax(t))
    co = te.TpuCoalesceBatchesExec(scan, target_bytes=1 << 31)
    jco = jte.TpuCoalesceBatchesExec(jscan, target_bytes=1 << 31)
    assert _preserves_encoding(co) and jax_preserves(jco)
    got = list(co.execute(ExecContext(TpuConf({}), CPU)))
    want = list(jco.execute(JaxContext(JaxConf({}))))
    assert len(got) == len(want) == 1
    for ci in range(3):
        assert (got[0].columns[ci].encoding is None) == \
            (want[0].columns[ci].encoding is None), ci
    assert got[0].columns[0].encoding is not None
    assert_tables_equal(want[0].to_arrow(), download(got[0]).to_arrow())
    # split by the target: every group keeps its encoding too
    small = te.TpuCoalesceBatchesExec(scan, target_bytes=1)
    jsmall = jte.TpuCoalesceBatchesExec(jscan, target_bytes=1)
    gs = list(small.execute(ExecContext(TpuConf({}), CPU)))
    ws = list(jsmall.execute(JaxContext(JaxConf({}))))
    assert [b.num_rows for b in gs] == [b.num_rows for b in ws]
    assert [[c.encoding is None for c in b.columns] for b in gs] == \
        [[c.encoding is None for c in b.columns] for b in ws]


def schema_from_jax(table):
    from spark_rapids_tpu.columnar.host import HostBatch as JaxHostBatch
    return JaxHostBatch.from_arrow(table.slice(0, 1)).schema
