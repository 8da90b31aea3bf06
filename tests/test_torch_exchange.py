"""The PyTorch port's shuffle exchange against the JAX package's, exec for
exec: the same map batches (made with numpy from a seed) go through
``TpuShuffleExchangeExec`` with hash and round-robin partitioning in both
packages, and every reduce partition's batches must be equal in order, with
the one-launch consolidation on and off and with the sort path; the stage
statistics and map slices must be equal; a device budget small enough to
spill to host and disk must give the same partitions; and an action must
leave the shuffle catalog empty. The JAX side runs its Pallas reorder in
interpreter mode and its ``consolidate`` gather (its compaction runs only
on a TPU); the port runs the plain versions of its kernels.

Then TPC-H Q1 over ``repartition(8, "l_orderkey")`` and ``repartition(8)``
with ``dmaConsolidate.enabled`` through both sessions: keys and counts
exact, sums within the variableFloatAgg carve-out (relative 1e-9)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import config as jcfg
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxBatch
from spark_rapids_tpu.execs import base as jbase
from spark_rapids_tpu.execs import exchange_execs as jx
from spark_rapids_tpu.exprs.core import (UnresolvedAttribute as JAttr,
                                         bind_expression as jbind)
from spark_rapids_tpu.memory.device_manager import DeviceManager as JManager
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch as ttpch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_numpy
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import base as tbase
from spark_rapids_tpu_torch.execs import exchange_execs as tx
from spark_rapids_tpu_torch.exprs.core import (UnresolvedAttribute as TAttr,
                                               bind_expression as tbind)
from spark_rapids_tpu_torch.memory.buffer import StorageTier
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk

CPU = torch.device("cpu")
#: map partition -> batch row counts: a two-batch map task and a one-batch one
MAP_BATCHES = ((1500, 900), (1300,))

MODES = {
    "dma": {"spark.rapids.tpu.shuffle.kernel.mode": "interpret",
            "spark.rapids.tpu.shuffle.kernel.dmaConsolidate.enabled": "true"},
    "gather": {"spark.rapids.tpu.shuffle.kernel.mode": "interpret"},
    "sort": {"spark.rapids.tpu.shuffle.kernel.mode": "off"},
}


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 400, n), mask=rng.random(n) < 0.05),
        "d": pa.array(np.round(rng.standard_normal(n) * 1e3, 3)),
        "s": pa.array([f"c{int(x)}" for x in rng.integers(0, 50, n)],
                      mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
    })


def _both(table):
    jb = JaxBatch.from_arrow(table, string_max_bytes=16)
    schema = tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value),
                                   f.nullable) for f in jb.schema])
    bufs = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    return jb, batch_from_numpy(schema, bufs, jb.num_rows, CPU)


class _JaxLeaf(jbase.LeafExec):
    """A device leaf yielding fixed batches per map partition."""
    is_device = True

    def __init__(self, parts):
        super().__init__(parts[0][0].schema)
        self.parts = parts

    @property
    def num_partitions(self):
        return len(self.parts)

    def execute(self, ctx):
        yield from self.parts[ctx.partition_id]


class _PortLeaf(tbase.LeafExec):
    def __init__(self, parts):
        super().__init__(parts[0][0].schema)
        self.parts = parts

    @property
    def num_partitions(self):
        return len(self.parts)

    def execute(self, ctx):
        yield from self.parts[ctx.partition_id]


def _children(seed):
    jparts, tparts = [], []
    for m, sizes in enumerate(MAP_BATCHES):
        pairs = [_both(_table(n, seed * 10 + m * 3 + b))
                 for b, n in enumerate(sizes)]
        jparts.append([j for j, _ in pairs])
        tparts.append([t for _, t in pairs])
    return _JaxLeaf(jparts), _PortLeaf(tparts)


def _partitionings(kind, jchild, tchild):
    if kind == "hash":
        keys = ("k", "s")
        return (jx.HashPartitioning(8, tuple(jbind(JAttr(k), jchild.output)
                                             for k in keys)),
                tx.HashPartitioning(8, tuple(tbind(TAttr(k), tchild.output)
                                             for k in keys)))
    return jx.RoundRobinPartitioning(5), tx.RoundRobinPartitioning(5)


def _run_jax(part, child, conf):
    JManager.shutdown()
    conf = jcfg.TpuConf(conf)
    dm = JManager.initialize(conf)
    ex = jx.TpuShuffleExchangeExec(part, child)
    cleanups = []
    try:
        parts = [list(ex.execute(jbase.ExecContext(
            conf, partition_id=p, num_partitions=ex.num_partitions,
            device_manager=dm, cleanups=cleanups)))
            for p in range(ex.num_partitions)]
    finally:
        for fn in cleanups:
            fn()
    return ex, parts


def _run_port(part, child, conf):
    conf = TpuConf(conf)
    dm = DeviceManager.initialize(conf, CPU)
    ex = tx.TpuShuffleExchangeExec(part, child)
    cleanups = []
    try:
        parts = [list(ex.execute(tbase.ExecContext(
            conf, CPU, p, ex.num_partitions, dm, cleanups)))
            for p in range(ex.num_partitions)]
        tiers = [len(s) for s in (dm.device_store, dm.host_store,
                                  dm.disk_store)]
    finally:
        for fn in cleanups:
            fn()
    assert dm.catalog.ids() == [] and dm.is_idle
    return ex, parts, tiers


def _assert_partitions_equal(got, want):
    assert len(got) == len(want)
    for p, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws), p
        for g, w in zip(gs, ws):
            assert g.num_rows == w.num_rows and g.capacity == w.capacity, p
            n = g.num_rows
            for gc, wc in zip(g.columns, w.columns):
                assert gc.data[:n].numpy().tobytes() == \
                    np.asarray(wc.data)[:n].tobytes(), p
                assert np.array_equal(gc.validity[:n].numpy(),
                                      np.asarray(wc.validity)[:n]), p
                if wc.lengths is not None:
                    assert np.array_equal(gc.lengths[:n].numpy(),
                                          np.asarray(wc.lengths)[:n]), p


@pytest.fixture(autouse=True)
def _fresh_managers():
    yield
    DeviceManager.shutdown()
    JManager.shutdown()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["hash", "roundrobin"])
def test_exchange_partitions_and_stats_equal_reference(kind, mode):
    jchild, tchild = _children(seed=1 if kind == "hash" else 2)
    jpart, tpart = _partitionings(kind, jchild, tchild)
    jex, want = _run_jax(jpart, jchild, MODES[mode])
    tex, got, _ = _run_port(tpart, tchild, MODES[mode])
    _assert_partitions_equal(got, want)
    # round robin over 5: the 1500-row batch's one group holds 300 rows per
    # partition, past the quota's limit of 272, so in both packages it
    # overflows and takes the sort path
    splits = {"sort": (0, 3), "hash": (3, 0), "roundrobin": (2, 1)}
    assert (tex.kernel_splits, tex.sort_path_splits) == \
        splits["sort" if mode == "sort" else kind]
    ts, js = tex.stage_stats(), jex.stage_stats()
    assert ts.total_rows == sum(sum(s) for s in MAP_BATCHES)
    assert (ts.partition_rows, ts.partition_bytes, ts.key_distinct) == \
        (js.partition_rows, js.partition_bytes, js.key_distinct)
    assert ts.describe() == js.describe()
    assert len(ts.key_distinct) == (2 if kind == "hash" else 0)
    assert tex.map_output_stats(None) == list(js.partition_bytes)
    for p in range(tex.num_partitions):
        for k in (1, 2, 3):
            assert tex.map_slices(p, k) == jex.map_slices(p, k), (p, k)


@pytest.mark.parametrize("dma", [False, True])
def test_spilling_exchange_gives_the_same_partitions(dma):
    """A device budget of about one piece and a host budget of about two
    push the map outputs down to the host and disk tiers; the reduce side
    reads them back equal to the unspilled reference."""
    jchild, tchild = _children(seed=3)
    jpart, tpart = _partitionings("hash", jchild, tchild)
    conf = dict(MODES["dma" if dma else "gather"])
    _, want = _run_jax(jpart, jchild, conf)
    conf.update({"spark.rapids.tpu.memory.tpu.poolSizeBytes": 20000,
                 "spark.rapids.tpu.memory.host.spillStorageSize": 40000})
    _, got, tiers = _run_port(tpart, tchild, conf)
    _assert_partitions_equal(got, want)
    assert tiers[StorageTier.HOST] > 0 and tiers[StorageTier.DISK] > 0
    assert sum(tiers) == sum(1 for p in got for _ in p)


def test_partial_read_takes_only_the_named_map_tasks():
    jchild, tchild = _children(seed=4)
    jpart, tpart = _partitionings("hash", jchild, tchild)
    conf = TpuConf(MODES["gather"])
    ex = tx.TpuShuffleExchangeExec(tpart, tchild)
    cleanups = []
    dm = DeviceManager.initialize(conf, CPU)
    try:
        ctx = tbase.ExecContext(conf, CPU, 3, 8, dm, cleanups)
        whole = list(ex.execute(ctx))
        firsts = list(ex.execute_partial(ctx, (0,)))
        seconds = list(ex.execute_partial(ctx, (1,)))
        rows = ex._map_part_rows
        # map task 0 produced two batches, so its block holds two buffers
        assert len(firsts) == 2 and len(seconds) == 1
        assert sum(b.num_rows for b in firsts) == rows[(0, 3)]
        assert seconds[0].num_rows == rows[(1, 3)]
        assert [b.num_rows for b in whole] == \
            [b.num_rows for b in firsts + seconds]
    finally:
        for fn in cleanups:
            fn()
    assert dm.is_idle


def test_stage_stats_before_the_map_runs():
    _, tchild = _children(seed=5)
    ex = tx.TpuShuffleExchangeExec(tx.RoundRobinPartitioning(3), tchild)
    assert ex.stage_stats() is None
    assert ex.map_slices(0, 2) == []


def test_kmv_sketch_helpers_equal_reference():
    rng = np.random.default_rng(0)
    pool_t = pool_j = np.zeros(0, np.uint32)
    for size in (10, 500, 3, 2000):
        h = rng.integers(0, 2**32, size, dtype=np.uint64).astype(np.uint32)
        h[: size // 2] = h[0]                       # a heavy hitter
        pool_t, pool_j = tx._kmv_merge(pool_t, h), jx._kmv_merge(pool_j, h)
        assert np.array_equal(pool_t, pool_j)
        assert tx._kmv_estimate(pool_t) == jx._kmv_estimate(pool_j)
    assert tx._KMV_K == jx._KMV_K


# ---------------------------------------------------------------- sessions
SCALE = 0.001
SEED = 42


def _q1_conf(extra=None):
    return {**jtpch.BENCH_CONF, **MODES["dma"], **(extra or {})}


@pytest.fixture(scope="module")
def q1_reference():
    JManager.shutdown()
    jdf = JaxSession(_q1_conf()).create_dataframe(
        jtpch.gen_lineitem(SCALE, SEED))
    return {keys: jtpch.q1(jdf.repartition(8, *keys)).collect()
            for keys in ((), ("l_orderkey",))}


@pytest.mark.parametrize("keys", [(), ("l_orderkey",)], ids=["rr", "hash"])
def test_q1_with_dma_consolidation_matches_reference(q1_reference, keys,
                                                     monkeypatch):
    calls = []
    real = tpk.consolidate_all

    def spy(*args):
        calls.append(args[-1].n)
        return real(*args)

    monkeypatch.setattr(tpk, "consolidate_all", spy)
    sess = TpuSession(_q1_conf(), device="cpu")
    got = ttpch.q1(sess.create_dataframe(ttpch.gen_lineitem(SCALE, SEED))
                   .repartition(8, *keys)).collect()
    assert_tables_equal(q1_reference[keys], got.to_arrow(), approx_float=1e-9)
    assert calls == [8]
    exchanges = [e for e in sess.last_plan.walk()
                 if isinstance(e, tx.TpuShuffleExchangeExec)
                 and e.num_partitions == 8]
    assert [(e.kernel_splits, e.sort_path_splits) for e in exchanges] == \
        [(1, 0)]
    assert isinstance(exchanges[0].partitioning,
                      tx.HashPartitioning if keys else
                      tx.RoundRobinPartitioning)
    assert exchanges[0].stage_stats().total_rows == \
        int(6_000_000 * SCALE)
    dm = DeviceManager.peek()
    assert dm.catalog.ids() == [] and dm.is_idle


@pytest.mark.parametrize("n", [3, 8])
def test_round_robin_collect_equals_reference_in_order(n):
    """A bare repartition(n) collects the partitions in order, each in the
    reference's row order."""
    table = _table(2500, seed=6)
    want = JaxSession(MODES["dma"]).create_dataframe(table).repartition(
        n).collect()
    sess = TpuSession(MODES["dma"], device="cpu")
    got = sess.create_dataframe(table).repartition(n).collect().to_arrow()
    assert_tables_equal(want, got)
    assert got.column("i").to_pylist() == want.column("i").to_pylist()


def test_failed_action_still_empties_the_catalog(monkeypatch):
    def boom(*_args, **_kw):
        raise RuntimeError("reduce side failed")

    monkeypatch.setattr(tx.TpuShuffleExchangeExec, "_read_partition", boom)
    sess = TpuSession(MODES["gather"], device="cpu")
    df = sess.create_dataframe(_table(600, seed=7)).repartition(4, "k")
    with pytest.raises(RuntimeError, match="reduce side failed"):
        df.collect()
    monkeypatch.undo()
    sess2 = TpuSession(MODES["gather"], device="cpu")
    ex = tx.TpuShuffleExchangeExec(
        tx.RoundRobinPartitioning(2),
        sess2.create_dataframe(_table(600, seed=7)).physical_plan()
        .children[0])
    dm = DeviceManager.initialize(sess2.conf, CPU)
    cleanups = []
    list(ex.execute(tbase.ExecContext(sess2.conf, CPU, 0, 2, dm, cleanups)))
    assert not dm.is_idle
    for fn in cleanups:
        fn()
    assert dm.is_idle and dm.catalog.ids() == []
