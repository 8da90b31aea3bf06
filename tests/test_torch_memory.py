"""The PyTorch port's spill stores, shuffle catalog and device manager
against the JAX package: batches round-trip bit for bit through every tier,
the same sequence of adds leaves each buffer on the same tier in both
packages, the catalog's metas equal the reference's, removal leaves nothing
behind, and a corrupted spill file is refused."""
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import native as jnative
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxBatch
from spark_rapids_tpu.memory import store as jstore
from spark_rapids_tpu.memory.buffer import BufferId as JBufferId
from spark_rapids_tpu.shuffle import catalog as jcatalog
from spark_rapids_tpu.shuffle import table_meta as jmeta
from spark_rapids_tpu_torch import native as tnative
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_numpy
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.memory import store as tstore
from spark_rapids_tpu_torch.memory.buffer import (BufferId,
                                                  SpillCorruptionError,
                                                  SpillableBuffer,
                                                  StorageTier)
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.shuffle import catalog as tcatalog
from spark_rapids_tpu_torch.shuffle import table_meta as tmeta
from spark_rapids_tpu_torch.utils.arm import (Retainable, close_all,
                                              closing_on_except)

CPU = torch.device("cpu")


def _both(n, seed, nulls=True):
    """The same batch as a JAX DeviceBatch and as the port's."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(n) < 0.2) if nulls else None
    table = pa.table({
        "x": pa.array(rng.integers(-2**40, 2**40, n), mask=mask),
        "s": pa.array([f"row{i}-{int(v)}" for i, v in
                       enumerate(rng.integers(0, 10**6, n))], mask=mask),
        "i": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
    })
    jb = JaxBatch.from_arrow(table, string_max_bytes=32)
    schema = tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value),
                                   f.nullable) for f in jb.schema])
    bufs = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    return jb, batch_from_numpy(schema, bufs, jb.num_rows, CPU)


def _assert_batches_equal(a, b):
    assert a.num_rows == b.num_rows and a.schema == b.schema
    for x, y in zip(a.columns, b.columns):
        assert x.data.dtype == y.data.dtype and x.data.shape == y.data.shape
        assert x.data.numpy().tobytes() == y.data.numpy().tobytes()
        assert torch.equal(x.validity, y.validity)
        assert (x.lengths is None) == (y.lengths is None)
        if x.lengths is not None:
            assert torch.equal(x.lengths, y.lengths)


# ---------------------------------------------------------------- native, arm
def test_allocator_and_queue_follow_the_reference_twins():
    """Same operations, same answers as the JAX package's pure-Python
    allocator and queue (whose C++ twins share their semantics)."""
    rng = np.random.default_rng(0)
    ja, ta = jnative.PyAddressSpaceAllocator(1000), \
        tnative.PyAddressSpaceAllocator(1000)
    live = []
    for _ in range(300):
        if live and rng.random() < 0.4:
            off = live.pop(int(rng.integers(0, len(live))))
            assert ja.free(off) == ta.free(off)
        else:
            size = int(rng.integers(1, 120))
            off = ja.allocate(size)
            assert ta.allocate(size) == off
            if off is not None:
                live.append(off)
        assert (ja.available, ja.largest_free_block, ja.num_free_blocks) == \
            (ta.available, ta.largest_free_block, ta.num_free_blocks)
    jq, tq = jnative.PyHashedPriorityQueue(), tnative.PyHashedPriorityQueue()
    for k in range(50):
        prio = float(rng.integers(0, 4))
        jq.offer(k, prio)
        tq.offer(k, prio)
        if k % 7 == 3:
            assert jq.remove(k - 2) == tq.remove(k - 2)
    assert len(jq) == len(tq)
    while len(jq):
        assert jq.peek() == tq.peek()
        assert jq.poll() == tq.poll()
    assert tq.poll() is None


def test_retainable_refcounts_and_close_helpers():
    released = []

    class Res(Retainable):
        def _on_release(self):
            released.append(self)

    r = Res()
    assert r.retain() is r and r.refcount == 2
    r.close()
    assert not released
    with r:
        pass
    assert released == [r]
    with pytest.raises(ValueError, match="double close"):
        r.close()
    with pytest.raises(ValueError, match="after close"):
        r.retain()
    s = Res()
    with pytest.raises(KeyError):
        with closing_on_except(s):
            raise KeyError("boom")
    assert s.refcount == 0
    a, b = Res(), Res()
    b.close()
    with pytest.raises(ValueError):
        close_all([a, None, b])
    assert a.refcount == 0


# ---------------------------------------------------------------- tiers
@pytest.mark.parametrize("tier", list(StorageTier))
def test_batch_round_trips_every_tier_bit_for_bit(tmp_path, tier):
    _, pb = _both(300, seed=1)
    buf = SpillableBuffer.from_batch(BufferId(5, 2), pb)
    assert buf.size_bytes == sum(
        t.numel() * t.element_size() for c in pb.columns
        for t in (c.data, c.validity, c.lengths) if t is not None)
    moved = buf
    if tier >= StorageTier.HOST:
        moved = moved.to_host()
        assert all(t.device.type == "cpu" for t in moved.payload)
    if tier == StorageTier.DISK:
        moved = moved.to_disk(str(tmp_path))
        assert os.path.exists(moved.payload)
    assert moved.tier == tier
    _assert_batches_equal(moved.get_batch(), pb)
    path = moved.payload
    moved.close()
    if tier == StorageTier.DISK:
        assert not os.path.exists(path)


def test_corrupted_spill_file_is_refused(tmp_path):
    _, pb = _both(200, seed=2)
    disk = SpillableBuffer.from_batch(BufferId(9), pb).to_host().to_disk(
        str(tmp_path))
    with open(disk.payload, "r+b") as f:
        f.seek(os.path.getsize(disk.payload) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(SpillCorruptionError, match="corrupt") as e:
        disk.get_batch()
    assert e.value.expected == disk.disk_crc32
    with pytest.raises(SpillCorruptionError):
        disk.to_host()


@pytest.mark.parametrize("device_batches,host_batches,count", [
    (2.0, 2.0, 5), (1.5, 2.5, 7), (0.5, 1.0, 4), (3.0, 0.5, 6)])
def test_same_adds_leave_buffers_on_the_same_tiers(tmp_path, device_batches,
                                                   host_batches, count):
    """Budgets in units of one batch; priorities repeat so that ties (first
    in, first out) decide part of the order."""
    jcat, tcat = jstore.BufferCatalog(), tstore.BufferCatalog()
    jb0, pb0 = _both(64, seed=0)
    size = jb0.device_size_bytes
    assert size == SpillableBuffer.from_batch(BufferId(0), pb0).size_bytes
    budgets = (int(size * device_batches), int(size * host_batches))
    jchain = jstore.build_store_chain(jcat, *budgets, str(tmp_path / "j"))
    tchain = tstore.build_store_chain(tcat, *budgets, str(tmp_path / "t"))
    for i in range(count):
        jb, pb = _both(64, seed=i)
        prio = float(i % 3)
        jchain[0].add_batch(JBufferId(i), jb, spill_priority=prio)
        tchain[0].add_batch(BufferId(i), pb, spill_priority=prio)
    assert [len(s) for s in tchain] == [len(s) for s in jchain]
    assert sum(len(s) for s in tchain) == count
    for i in range(count):
        jbuf, tbuf = jcat.acquire(JBufferId(i)), tcat.acquire(BufferId(i))
        assert tbuf.tier.name == jbuf.tier.name, i
        assert tbuf.size_bytes == jbuf.size_bytes, i
        _assert_batches_equal(tbuf.get_batch(), _both(64, seed=i)[1])
        jbuf.close()
        tbuf.close()
    for s in tchain + jchain:
        s.close()


def test_device_store_without_spill_store_refuses_overflow():
    _, pb = _both(64, seed=0)
    store = tstore.DeviceMemoryStore(tstore.BufferCatalog(), 10)
    store.add_batch(BufferId(0), pb)
    with pytest.raises(MemoryError, match="no spill store"):
        store.add_batch(BufferId(1), pb)
    assert len(store) == 1


# ---------------------------------------------------------------- catalog
def test_table_meta_layout_equals_reference():
    jb, pb = _both(100, seed=3)
    want = jmeta.layout_to_meta(jmeta.DevicePackLayout.for_batch_shape(
        jb.schema, jb.capacity, jmeta.batch_string_max(jb)), jb.num_rows)
    got = tmeta.layout_to_meta(tmeta.DevicePackLayout.for_batch_shape(
        pb.schema, pb.capacity, tmeta.batch_string_max(pb)), pb.num_rows)
    assert (got.num_rows, got.packed_size, got.uncompressed_size) == \
        (want.num_rows, want.packed_size, want.uncompressed_size)
    for g, w in zip(got.columns, want.columns):
        assert (g.name, g.dtype.value, g.nullable, g.string_max_bytes) == \
            (w.name, w.dtype.value, w.nullable, w.string_max_bytes)
        for a, b in ((g.data, w.data), (g.validity, w.validity),
                     (g.lengths, w.lengths)):
            assert (a.offset, a.length) == (b.offset, b.length)
    assert got.schema == pb.schema


def test_uniform_string_batch_pads_to_the_widest():
    _, pb = _both(50, seed=4)
    narrow = tdt.Schema(list(pb.schema) + [tdt.Field("t", tdt.DType.STRING)])
    col = pb.columns[1]
    cols = pb.columns + (type(col)(col.dtype, col.data[:, :8].contiguous(),
                                   col.validity, col.lengths),)
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    b = DeviceBatch(narrow, cols, pb.num_rows)
    u = tmeta.uniform_string_batch(b)
    assert u.columns[3].data.shape[1] == col.data.shape[1]
    assert torch.equal(u.columns[3].data[:, :8], cols[3].data)
    assert not u.columns[3].data[:, 8:].any()
    assert tmeta.uniform_string_batch(pb) is pb


def _catalogs(tmp_path, device_budget):
    jcat, tcat = jstore.BufferCatalog(), tstore.BufferCatalog()
    jchain = jstore.build_store_chain(jcat, device_budget, 1 << 20,
                                      str(tmp_path / "j"))
    tchain = tstore.build_store_chain(tcat, device_budget, 1 << 20,
                                      str(tmp_path / "t"))
    return (jcatalog.ShuffleBufferCatalog(jcat, jchain[0]), jcat, jchain,
            tcatalog.ShuffleBufferCatalog(tcat, tchain[0]), tcat, tchain)


def test_shuffle_catalog_adds_reads_and_removes(tmp_path):
    size = _both(64, seed=0)[0].device_size_bytes
    jsc, jcat, jchain, tsc, tcat, tchain = _catalogs(tmp_path, 3 * size)
    blocks = [(0, m, p) for m in range(3) for p in range(2)]
    for k, (sid, m, p) in enumerate(blocks):
        jb, pb = _both(64, seed=k)
        layout = jmeta.DevicePackLayout.for_batch_shape(
            jb.schema, jb.capacity, jmeta.batch_string_max(jb))
        jsc.add_batch(jcatalog.ShuffleBlockId(sid, m, p), jb,
                      jmeta.layout_to_meta(layout, jb.num_rows))
        tlayout = tmeta.DevicePackLayout.for_batch_shape(
            pb.schema, pb.capacity, tmeta.batch_string_max(pb))
        tsc.add_batch(tcatalog.ShuffleBlockId(sid, m, p), pb,
                      tmeta.layout_to_meta(tlayout, pb.num_rows))
    assert [len(s) for s in tchain] == [len(s) for s in jchain] == [3, 3, 0]
    tsc.add_batch(tcatalog.ShuffleBlockId(1, 0, 0), _both(64, seed=99)[1],
                  tsc.metas(tcatalog.ShuffleBlockId(0, 0, 0))[0])
    for p in range(2):
        got = tsc.blocks_for_partition(0, p)
        want = jsc.blocks_for_partition(0, p)
        assert [(b.map_id, b.partition_id) for b in got] == \
            [(b.map_id, b.partition_id) for b in want]
        for b in got:
            (buf, meta), = tsc.acquire_buffers(b)
            assert meta.num_rows == 64 and buf.refcount == 2
            k = blocks.index((0, b.map_id, b.partition_id))
            _assert_batches_equal(buf.get_batch(), _both(64, seed=k)[1])
            buf.close()
    assert tsc.remove_map_outputs(0, 1) == 2
    assert tsc.remove_map_outputs(0, 1) == 0
    assert [b.map_id for b in tsc.blocks_for_partition(0, 0)] == [0, 2]
    assert tsc.remove_shuffle(0) == 4
    assert tsc.blocks_for_partition(0, 0) == []
    assert tsc.remove_shuffle(1) == 1
    assert tcat.ids() == [] and [len(s) for s in tchain] == [0, 0, 0]
    assert [s.used_bytes for s in tchain] == [0, 0, 0]
    assert os.listdir(tchain[2].directory) == []
    assert tchain[1].arena.available == 1 << 20
    for s in tchain + jchain:
        s.close()


def test_catalog_acquire_of_a_vanished_buffer_releases_the_others(tmp_path):
    *_, tsc, tcat, tchain = _catalogs(tmp_path, 1 << 30)
    block = tcatalog.ShuffleBlockId(0, 0, 0)
    pb = _both(64, seed=1)[1]
    meta = tmeta.layout_to_meta(tmeta.DevicePackLayout.for_batch_shape(
        pb.schema, pb.capacity, tmeta.batch_string_max(pb)), pb.num_rows)
    first = tsc.add_batch(block, pb, meta)
    second = tsc.add_batch(block, pb, meta)
    tchain[0].remove(second)
    with pytest.raises(KeyError, match="vanished"):
        tsc.acquire_buffers(block)
    buf = tcat.acquire(first)
    assert buf.refcount == 2          # the store's reference and this one
    buf.close()
    for s in tchain:
        s.close()


# ---------------------------------------------------------------- manager
def test_device_manager_budget_and_device_key():
    DeviceManager.shutdown()
    try:
        dm = DeviceManager.initialize(TpuConf({
            "spark.rapids.tpu.memory.tpu.allocFraction": "0.5"}), CPU)
        assert dm.device_budget == 8 << 30          # half of 16 GiB
        assert DeviceManager.initialize(TpuConf({
            "spark.rapids.tpu.memory.tpu.allocFraction": "0.5"}), CPU) is dm
        conf = TpuConf({"spark.rapids.tpu.memory.tpu.poolSizeBytes": 4096,
                        "spark.rapids.tpu.memory.host.spillStorageSize":
                            8192})
        dm2 = DeviceManager.initialize(conf, CPU)       # idle: rebuilt
        assert dm2 is not dm and dm2.device_budget == 4096
        assert dm2.host_store.budget_bytes == 8192
        _, pb = _both(64, seed=0)
        for i in (1, 2, 3):          # ~4.4 KB each: 1 ends on disk, 2 on host
            dm2.device_store.add_batch(BufferId(i), pb)
        spill_dir = dm2.disk_store.directory
        assert [len(dm2.host_store), len(dm2.disk_store)] == [1, 1]
        assert os.listdir(spill_dir)
        dm2.catalog.remove(BufferId(2))
        dm2.catalog.remove(BufferId(3))
        # busy: other settings on the same device keep the manager ...
        assert DeviceManager.initialize(TpuConf(), CPU) is dm2
        # ... but a session on another device is refused
        with pytest.raises(RuntimeError, match="holds buffers on cpu"):
            DeviceManager.initialize(conf, torch.device("meta"))
        dm2.catalog.remove(BufferId(1))
        assert dm2.is_idle and os.listdir(spill_dir) == []
        assert DeviceManager.initialize(conf, torch.device("meta")).device \
            == torch.device("meta")
        assert not os.path.exists(spill_dir)     # removed with its store
    finally:
        DeviceManager.shutdown()
    assert DeviceManager.peek() is None


def test_bad_memory_conf_values_raise_naming_the_key():
    with pytest.raises(ValueError, match="allocFraction"):
        TpuConf({"spark.rapids.tpu.memory.tpu.allocFraction": "1.5"})
    with pytest.raises(ValueError, match="spillStorageSize"):
        TpuConf({"spark.rapids.tpu.memory.host.spillStorageSize": 0})
