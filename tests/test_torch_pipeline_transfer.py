"""The PyTorch port's default execution path around the operators, on the
CPU: the chunked upload and streaming collect (columnar/transfer.py), the
scan cache (memory/scan_cache.py) and the store's give-way to it
(memory/store.py), the pipeline boundary (execs/pipeline.py), the
device-admission semaphore (memory/semaphore.py) and its fair-share policy
(utils/fair_share.py, a byte-equal copy of the JAX package's), each held
against the JAX package where it has a counterpart."""
import gc
import os
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import transfer as jtransfer
from spark_rapids_tpu.memory.semaphore import TpuSemaphore as JaxSemaphore
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
from spark_rapids_tpu_torch.columnar import transfer as ttransfer
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import tpu_execs as tte
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuLocalScanExec
from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
from spark_rapids_tpu_torch.memory import scan_cache
from spark_rapids_tpu_torch.memory.buffer import BufferId
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.store import (BufferCatalog,
                                                 build_store_chain)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _table(n, batch_rows, seed=0):
    """An arrow table of ``n`` rows in record batches of the given sizes
    (cycled), with nulls, doubles and strings."""
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.standard_normal(n)),
        "s": pa.array([f"w{x}" * (x % 4) for x in rng.integers(0, 50, n)])})
    batches, off, i = [], 0, 0
    while off < n:
        size = min(batch_rows[i % len(batch_rows)], n - off)
        batches.extend(t.slice(off, size).to_batches())
        off += size
        i += 1
    return pa.Table.from_batches(batches, schema=t.schema)


def _tensors(db):
    return [t for c in db.columns for t in (c.data, c.validity, c.lengths)
            if t is not None]


# ---------------------------------------------------------------- upload
@pytest.mark.parametrize("batch_rows", [[100], [7, 300, 2], [1000], [60, 5]])
@pytest.mark.parametrize("chunk_rows", [0, 7, 50, 100, 128, 1000])
def test_chunk_bounds_match_reference(batch_rows, chunk_rows):
    t = _table(1000, batch_rows)
    hb = HostBatch.from_arrow(t)
    assert ttransfer.chunk_bounds(hb, chunk_rows) == \
        jtransfer.chunk_bounds(t, chunk_rows)


@pytest.mark.parametrize("chunk_rows", [7, 1000])
def test_chunked_upload_equals_single_shot(chunk_rows):
    hb = HostBatch.from_arrow(_table(3000, [500, 77]))
    assert len(ttransfer.chunk_bounds(hb, chunk_rows)) > 1
    one = ttransfer.upload(hb, CPU)
    stats = {}
    chunked = ttransfer.upload_table(hb, CPU, chunk_rows=chunk_rows,
                                     max_inflight=2, stats=stats)
    assert stats["chunks"] == len(ttransfer.chunk_bounds(hb, chunk_rows))
    assert 0 < stats["stage_s"] <= stats["wall_s"]
    assert 0.0 <= stats["upload_overlap_efficiency"] <= 1.0
    assert chunked.num_rows == one.num_rows
    for a, b in zip(_tensors(chunked), _tensors(one)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_chunked_upload_stages_on_the_staging_threads(monkeypatch):
    """Each chunk's buffers are copied into the pinned slab by numpy on the
    staging pool's threads, not by torch's CPU copy on the calling thread
    (whose OpenMP regions paid a wake-up each on a pipeline's producer)."""
    hb = HostBatch.from_arrow(_table(3000, [500, 77]))
    seen = []
    real = np.copyto

    def spy(dst, src):
        seen.append(threading.current_thread().name)
        real(dst, src)

    monkeypatch.setattr(np, "copyto", spy)
    chunked = ttransfer.upload_table(hb, CPU, chunk_rows=100, max_inflight=2)
    buffers = len(_tensors(chunked))
    assert len(seen) == buffers * len(ttransfer.chunk_bounds(hb, 100))
    assert all(name.startswith("upload-stage") for name in seen)


def test_failed_chunked_upload_raises_without_a_single_shot(monkeypatch):
    hb = HostBatch.from_arrow(_table(3000, [500, 77]))
    calls = []
    real = np.copyto

    def fail_third(dst, src):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("staging failed")
        real(dst, src)

    def no_single_shot(*a, **k):
        raise AssertionError("retried in a single shot")

    monkeypatch.setattr(np, "copyto", fail_third)
    monkeypatch.setattr(ttransfer, "upload", no_single_shot)
    with pytest.raises(OSError, match="staging failed"):
        ttransfer.upload_table(hb, CPU, chunk_rows=100, max_inflight=2)


def _rows(hb):
    return [(hb.columns[0].validity[i], hb.columns[0].data[i],
             hb.columns[1].data[i]) for i in range(hb.num_rows)]


def test_chunked_and_streaming_collect_equal_the_old_path():
    """A filter and a grouped sum collect the same rows with every
    combination of chunked upload and streaming collect."""
    t = _table(5000, [1000, 333])
    results = []
    for chunk, stream in ((0, False), (7, False), (0, True), (1000, True)):
        sess = TpuSession({**BENCH_CONF,
                           "spark.rapids.tpu.transfer.chunkRows": str(chunk),
                           "spark.rapids.tpu.transfer.streamingCollect."
                           "enabled": str(stream).lower(),
                           "spark.rapids.tpu.sql.scanCache.enabled": "false"},
                          device="cpu")
        df = sess.create_dataframe(t)
        results.append((
            _rows(df.filter(F.col("v") > F.lit(0.0)).collect()),
            _rows(df.groupBy("k").agg(F.sum("v").alias("sv")).collect())))
    for r in results[1:]:
        assert r == results[0]


def test_streaming_collect_keeps_batch_order():
    """A repartitioned collect yields one batch per partition: streamed
    downloads resolve in order."""
    t = _table(2000, [2000])
    out = []
    for stream in ("true", "false"):
        sess = TpuSession({"spark.rapids.tpu.transfer.streamingCollect."
                           "enabled": stream}, device="cpu")
        hb = sess.create_dataframe(t).repartition(5, "k").collect()
        out.append((hb.columns[0].data.tobytes(),
                    hb.columns[1].data.tobytes(),
                    hb.columns[2].lengths.tobytes()))
    assert out[0] == out[1]


def test_pending_download_equals_download():
    hb = HostBatch.from_arrow(_table(300, [300]))
    db = ttransfer.upload(hb, CPU)
    got = ttransfer.start_download(db).result()
    want = ttransfer.download(db)
    for g, w in zip(got.columns, want.columns):
        assert np.array_equal(g.data, w.data)
        assert np.array_equal(g.validity, w.validity)


# ---------------------------------------------------------------- scan cache
@pytest.fixture
def fresh_cache(monkeypatch):
    """A process cache of its own for the test."""
    monkeypatch.setattr(scan_cache, "_cache", None)
    yield
    scan_cache._cache = None


def test_second_action_does_not_reupload(fresh_cache, monkeypatch):
    calls = []
    real = tte.upload_table_conf
    monkeypatch.setattr(tte, "upload_table_conf",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sess = TpuSession(BENCH_CONF, device="cpu")
    df = sess.create_dataframe(_table(500, [500]))
    first = df.filter(F.col("k") > F.lit(3)).collect()
    second = df.filter(F.col("k") > F.lit(3)).collect()
    assert len(calls) == 1
    cache = scan_cache.peek_cache()
    assert (cache.hits, cache.misses) == (1, 1)
    assert _rows(first) == _rows(second)
    off = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.enabled":
                      "false"}, device="cpu")
    # a bare scan has no device operator and stays on the host (the JAX
    # package's plan layer uploads nothing for it): filter to upload
    dfo = off.create_dataframe(_table(500, [500]))
    dfo.filter(F.col("k") > F.lit(3)).collect()
    dfo.filter(F.col("k") > F.lit(3)).collect()
    assert len(calls) == 3


def test_dead_host_batch_never_hits(fresh_cache):
    cache = scan_cache.get_cache(1 << 30)
    a = HostBatch.from_arrow(_table(50, [50]))
    b = HostBatch.from_arrow(_table(50, [50]))
    cache.put(a, 256, CPU, ttransfer.upload(a, CPU))
    assert cache.get(a, 256, CPU) is not None
    key_a = cache._key(a, 256, CPU)
    # b takes a's address after a dies: the weakref tells them apart
    entry = cache._entries.pop(key_a)
    cache._entries[cache._key(b, 256, CPU)] = entry
    del a
    gc.collect()
    assert cache.get(b, 256, CPU) is None
    assert len(cache) == 0
    c = HostBatch.from_arrow(_table(50, [50]))
    cache.put(c, 256, CPU, ttransfer.upload(c, CPU))
    del c
    gc.collect()
    cache._evict()
    assert len(cache) == 0 and cache.total_bytes() == 0


def _same_size_tables(k, rows):
    """``k`` distinct host tables of one content (so one device size)."""
    t = _table(rows, [rows])
    return [HostBatch.from_arrow(t) for _ in range(k)]


def test_lru_evicts_past_max_bytes(fresh_cache):
    tables = _same_size_tables(4, 100)
    batches = [ttransfer.upload(t, CPU) for t in tables]
    size = batches[0].device_size_bytes
    cache = scan_cache.get_cache(3 * size)
    for t, b in zip(tables[:3], batches[:3]):
        cache.put(t, 256, CPU, b)
    assert cache.get(tables[0], 256, CPU) is batches[0]   # now most recent
    cache.put(tables[3], 256, CPU, batches[3])
    assert cache.get(tables[1], 256, CPU) is None          # the LRU one
    for i in (0, 2, 3):
        assert cache.get(tables[i], 256, CPU) is batches[i]
    assert cache.total_bytes() == 3 * size
    assert cache.shrink_by(1) == size and len(cache) == 2
    # the device is part of the key
    assert cache.get(tables[0], 256, torch.device("meta")) is None


def test_store_shrinks_the_cache_before_it_spills(fresh_cache):
    tables = _same_size_tables(3, 200)
    batches = [ttransfer.upload(t, CPU) for t in tables]
    size = batches[0].device_size_bytes
    cache = scan_cache.get_cache(10 * size)
    for t, b in zip(tables, batches):
        cache.put(t, 256, CPU, b)
    catalog = BufferCatalog()
    device, host, disk = build_store_chain(catalog, 4 * size, 1 << 30)
    try:
        # stored + cached + incoming <= 4 batches: nothing moves
        device.add_batch(BufferId(1), batches[0])
        assert (len(device), len(cache), len(host)) == (1, 3, 0)
        # each add past the budget evicts a cached scan, not a buffer
        for i, left in ((2, 2), (3, 1), (4, 0)):
            device.add_batch(BufferId(i), batches[0])
            assert (len(device), len(cache), len(host)) == (i, left, 0)
        # nothing cached is left: now the store spills
        device.add_batch(BufferId(5), batches[0])
        assert (len(device), len(cache), len(host)) == (4, 0, 1)
        cache.put(tables[0], 256, CPU, batches[0])
        assert device.handle_oom(size) == size
        assert (len(device), len(cache), len(host)) == (3, 0, 2)
    finally:
        for s in (device, host, disk):
            s.close()


# ---------------------------------------------------------------- pipeline
class _Source(PhysicalExec):
    """A leaf yielding ``n`` one-row device batches, optionally raising
    after ``fail_after`` of them; counts what it produced."""

    def __init__(self, n, fail_after=None):
        hb = HostBatch.from_arrow(pa.table({"x": pa.array([0])}))
        super().__init__((), hb.schema)
        self.n, self.fail_after = n, fail_after
        self.produced = 0
        self.closed = False
        self._hb = hb

    def execute(self, ctx):
        try:
            for i in range(self.n):
                if self.fail_after is not None and i == self.fail_after:
                    raise ValueError(f"boom at {i}")
                db = ttransfer.upload(self._hb, CPU)
                db.columns[0].data[0] = i
                self.produced += 1
                yield db
        finally:
            self.closed = True


def _ctx(conf=None, dm=None):
    return ExecContext(TpuConf(conf or {}), CPU, 0, 1, dm)


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name == "exec-pipeline"]


def test_pipeline_keeps_batch_order():
    src = _Source(40)
    got = [int(b.columns[0].data[0])
           for b in PipelinedExec(src, 3).execute(_ctx())]
    assert got == list(range(40))


def test_pipeline_reraises_a_producer_error():
    it = PipelinedExec(_Source(10, fail_after=4), 2).execute(_ctx())
    got = []
    with pytest.raises(ValueError, match="boom at 4"):
        for b in it:
            got.append(int(b.columns[0].data[0]))
    assert got == [0, 1, 2, 3]
    deadline = time.monotonic() + 5
    while _pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _pipeline_threads()


def test_early_limit_does_not_leak_the_producer():
    src = _Source(10_000)
    limited = tte.TpuLimitExec(1, PipelinedExec(src, 2))
    out = list(limited.execute(_ctx()))
    assert [b.num_rows for b in out] == [1]
    deadline = time.monotonic() + 5
    while _pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _pipeline_threads()
    assert src.closed and src.produced < 10_000


def test_nested_pipeline_under_one_permit_finishes():
    """Two pipelines nested under a task holding the only permit: the
    producers join the task's hold by its id instead of queueing."""
    conf = TpuConf({"spark.rapids.tpu.sql.concurrentTpuTasks": "1",
                    "spark.rapids.tpu.memory.tpu.poolSizeBytes":
                        str(1 << 30)})
    dm = DeviceManager.initialize(conf, CPU)
    assert dm.semaphore.max_concurrent == 1
    done = []

    def run():
        with dm.semaphore.held():
            ctx = ExecContext(conf, CPU, 0, 1, dm)
            plan = PipelinedExec(PipelinedExec(_Source(25), 2), 2)
            done.append(len(list(plan.execute(ctx))))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive() and done == [25]
    assert dm.semaphore.active_holders == 0


def test_session_with_one_permit_and_pipelines_finishes():
    sess = TpuSession({**BENCH_CONF,
                       "spark.rapids.tpu.sql.concurrentTpuTasks": "1"},
                      device="cpu")
    df = sess.create_dataframe(_table(3000, [3000]))
    res = df.join(df.select(F.col("k").alias("k2"), "s"),
                  [("k", "k2")]).groupBy("k").agg(
                      F.count().alias("c")).collect()
    assert res.num_rows > 0
    # the planner skips the pipeline on a single-core host
    assert [n for n in sess.last_plan.walk()
            if isinstance(n, PipelinedExec)] or (os.cpu_count() or 1) < 2
    assert DeviceManager.peek().semaphore.active_holders == 0


# ---------------------------------------------------------------- semaphore
def _schedule(sem_cls):
    """One permit; the main thread holds it while five waiters of tenants
    A, A, B, C, B queue in that order, each entering only once the one
    before it waits; then the permit is freed. Returns the admission
    order, and the holder counts seen by a task nesting two holds from two
    threads."""
    sem = sem_cls(1)
    order, lock = [], threading.Lock()
    gate = threading.Event()

    def waiter(name, tenant):
        with sem.held(tenant=tenant):
            with lock:
                order.append(name)
            gate.wait(0.01)

    threads = []
    with sem.held(task_id=-1):
        for i, (name, tenant) in enumerate([("a1", "A"), ("a2", "A"),
                                            ("b1", "B"), ("c1", "C"),
                                            ("b2", "B")]):
            t = threading.Thread(target=waiter, args=(name, tenant),
                                 daemon=True)
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 10
            while sem.waiting < i + 1 and time.monotonic() < deadline:
                time.sleep(0.001)
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads), "a waiter never ran"
    nesting = []
    entered = threading.Event()
    leave = threading.Event()

    def sibling():
        with sem.held(task_id=7):
            entered.set()
            leave.wait(10)

    with sem.held(task_id=7):
        nesting.append(sem.active_holders)
        t = threading.Thread(target=sibling, daemon=True)
        t.start()
        assert entered.wait(10), "the sibling never entered"
        nesting.append(sem.active_holders)
    nesting.append(sem.active_holders)      # the sibling still holds
    leave.set()
    t.join(10)
    assert not t.is_alive(), "the sibling never left"
    nesting.append(sem.active_holders)
    return order, nesting


def test_semaphore_schedule_matches_reference():
    got = _schedule(TpuSemaphore)
    assert got == _schedule(JaxSemaphore)
    assert got[1] == [1, 1, 1, 0]


def test_semaphore_timeout_and_weights():
    sem = TpuSemaphore(1)
    assert sem.acquire_if_necessary(task_id=1)
    assert sem.acquire_if_necessary(task_id=1)          # re-entrant
    assert not sem.acquire_if_necessary(task_id=2, timeout=0)
    assert sem.waiting == 0
    sem.release_if_necessary(task_id=1)
    assert sem.active_holders == 0
    with pytest.raises(ValueError):
        sem.set_tenant_weight("x", 0)
    with pytest.raises(ValueError):
        TpuSemaphore(0)


def test_fair_share_is_byte_equal_to_reference():
    port = ROOT / "spark_rapids_tpu_torch" / "utils" / "fair_share.py"
    ref = ROOT / "spark_rapids_tpu" / "utils" / "fair_share.py"
    assert port.read_bytes() == ref.read_bytes()


def test_device_manager_key_includes_the_permits():
    DeviceManager.shutdown()
    one = DeviceManager.initialize(
        TpuConf({"spark.rapids.tpu.sql.concurrentTpuTasks": "1"}), CPU)
    three = DeviceManager.initialize(
        TpuConf({"spark.rapids.tpu.sql.concurrentTpuTasks": "3"}), CPU)
    assert one is not three and three.semaphore.max_concurrent == 3


@pytest.mark.parametrize("key,bad", [
    ("transfer.chunkRows", "-1"), ("transfer.maxInflight", "0"),
    ("transfer.pipeline.depth", "0"), ("sql.concurrentTpuTasks", "0"),
    ("sql.fusion.maxOps", "0")])
def test_bad_conf_values_name_the_key(key, bad):
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        TpuConf({f"spark.rapids.tpu.{key}": bad})


def test_scan_batch_ends_follow_the_record_batches():
    t = _table(100, [30, 30, 40])
    hb = HostBatch.from_arrow(t)
    assert hb.batch_ends == (30, 60)
    assert hb.select(["v"]).batch_ends == (30, 60)
    assert CpuLocalScanExec(hb).batch is hb


def test_consumer_fails_when_its_producer_dies():
    """A producer thread gone without its item, error or end fails the
    consumer's wait (execs/pipeline.py ``_get_live``) instead of hanging
    it."""
    import queue

    from spark_rapids_tpu_torch.execs import pipeline
    q = queue.Queue()
    t = threading.Thread(target=lambda: None, daemon=True, name="gone")
    t.start()
    t.join(10)
    with pytest.raises(RuntimeError, match="gone ended without its result"):
        pipeline._get_live(q, t)
    q.put(("end", None))
    assert pipeline._get_live(q, t) == ("end", None)


def test_page_decode_worker_that_dies_or_stalls_fails_the_scan(monkeypatch):
    """A decode process that dies, or gives no result within its bound
    (it is then killed), fails the read loudly (io/page_pool.py)."""
    from spark_rapids_tpu_torch.io import page_pool
    monkeypatch.setattr(page_pool, "_RESULT_TIMEOUT_S", 0.5)
    stalled = page_pool._Worker()       # sent nothing: it waits on stdin
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ended without a result"):
        stalled.recv()
    assert time.monotonic() - t0 < 30
    stalled.stop()
    dead = page_pool._Worker()
    dead.proc.kill()
    with pytest.raises(RuntimeError, match="ended without a result"):
        dead.recv()
    dead.stop()
