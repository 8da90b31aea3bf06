"""``DataFrame.cache()`` / ``persist()`` in the PyTorch port
(memory/df_cache.py, execs/cache_execs.py): cached plans materialize into
the spillable store and later actions scan the buffers instead of
computing them again. The cases of tests/test_df_cache.py that need no CPU
engine, mesh or cluster, each also run through the JAX package (its TPU
session, run by XLA on the CPU) on the same input, whose answer the port's
must equal."""
import gc
import math

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.execs.cache_execs import TpuCachedScanExec
from spark_rapids_tpu_torch.memory.buffer import StorageTier
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_device_manager():
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()
    yield
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()


def _sess():
    return TpuSession(CONF, device="cpu")


def _table(n=1000):
    return pa.table({
        "k": [i % 7 for i in range(n)],
        "v": [float(i) for i in range(n)],
        "s": [f"row{i % 13}" for i in range(n)],
    })


def _scans_cache(sess) -> bool:
    return any(isinstance(n, TpuCachedScanExec)
               for n in sess.last_plan.walk())


def _reference(build):
    """``build(session, functions)``'s result on the JAX package, its
    DataFrames cached as the port's are."""
    return build(JaxSession(CONF), JF).collect()


def test_cache_serves_second_action_from_store():
    sess = _sess()
    df = sess.create_dataframe(_table()).filter(F.col("k") > 2).cache()
    entry = sess.cache_manager.lookup(df._plan)
    assert entry is not None and not entry.is_materialized   # lazy
    first = df.collect()
    assert entry.is_materialized and entry.buffer_ids
    second = df.collect()
    assert _scans_cache(sess)
    assert_tables_equal(first.to_arrow(), second.to_arrow())
    want = _reference(lambda s, f: s.create_dataframe(_table())
                      .filter(f.col("k") > 2).cache())
    assert_tables_equal(want, second.to_arrow(), ignore_order=True)


def test_derived_dataframe_reuses_cached_subtree():
    def build(s, f, cache=True):
        base = s.create_dataframe(_table()).withColumn("v2",
                                                       f.col("v") * 2.0)
        if cache:
            base = base.cache()
            base.collect()                        # materialize
        return base.groupBy("k").agg(f.sum("v2").alias("s2"))
    sess = _sess()
    got = build(sess, F).collect()
    assert _scans_cache(sess)
    plain = build(_sess(), F, cache=False).collect()
    assert_tables_equal(plain.to_arrow(), got.to_arrow(), ignore_order=True)
    assert_tables_equal(_reference(build), got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)


def test_materialization_captures_device_batches():
    """The device batches go to the store as they are: the cached buffers
    start in the device tier."""
    sess = _sess()
    df = sess.create_dataframe(_table()).filter(F.col("k") < 5).cache()
    df.collect()
    entry = sess.cache_manager.lookup(df._plan)
    catalog = DeviceManager.peek().catalog
    for bid in entry.buffer_ids:
        buf = catalog.acquire(bid)
        assert buf.tier == StorageTier.DEVICE
        buf.close()


def test_unpersist_frees_buffers_and_recomputes():
    sess = _sess()
    df = sess.create_dataframe(_table()).cache()
    want = df.collect()
    ids = list(sess.cache_manager.lookup(df._plan).buffer_ids)
    assert df.is_cached
    df.unpersist()
    assert not df.is_cached
    live = set(DeviceManager.peek().catalog.ids())
    assert not any(bid in live for bid in ids)
    got = df.collect()                   # computed again, no cached scan
    assert not _scans_cache(sess)
    assert_tables_equal(want.to_arrow(), got.to_arrow())


def test_cached_buffers_spill_and_still_serve():
    """The cached batches pushed down the tiers: the scan uploads them
    again and the result stays the same."""
    sess = _sess()
    df = sess.create_dataframe(_table(2000)).cache()
    want = df.collect()
    entry = sess.cache_manager.lookup(df._plan)
    dm = DeviceManager.peek()
    dm.device_store.spill_to_size(0)
    for bid in entry.buffer_ids:
        buf = dm.catalog.acquire(bid)
        assert buf is not None and buf.tier != StorageTier.DEVICE
        buf.close()
    got = df.collect()
    assert _scans_cache(sess)
    assert_tables_equal(want.to_arrow(), got.to_arrow())


def test_two_consumers_materialize_once():
    def build(s, f):
        df = s.create_dataframe(_table()).cache()
        return df, df.groupBy("k").agg(f.count(f.lit(1)).alias("n"))
    sess = _sess()
    df, agg = build(sess, F)
    a = agg.collect()
    entry = sess.cache_manager.lookup(df._plan)
    ids = list(entry.buffer_ids)
    b = df.groupBy("k").agg(F.count(F.lit(1)).alias("n")).collect()
    assert list(entry.buffer_ids) == ids
    assert_tables_equal(a.to_arrow(), b.to_arrow(), ignore_order=True)
    assert_tables_equal(_reference(lambda s, f: build(s, f)[1]),
                        b.to_arrow(), ignore_order=True)


def test_cache_with_nulls_and_strings_roundtrip():
    t = pa.table({
        "k": pa.array([1, None, 3, None, 5], type=pa.int64()),
        "s": pa.array(["a", None, "ccc", "", None]),
        "d": pa.array([1.5, None, float("nan"), -0.0, 2.25]),
    })
    sess = _sess()
    df = sess.create_dataframe(t).cache()
    first = df.collect().to_arrow()
    second = df.collect().to_arrow()
    assert _scans_cache(sess)
    for col in first.column_names:
        for x, y in zip(first.column(col).to_pylist(),
                        second.column(col).to_pylist()):
            if isinstance(x, float) and isinstance(y, float) \
                    and math.isnan(x) and math.isnan(y):
                continue
            assert x == y and str(x) == str(y), (col, x, y)   # -0.0 kept
    assert_tables_equal(
        _reference(lambda s, f: s.create_dataframe(t).cache()), second)


def test_clear_cache():
    sess = _sess()
    a = sess.create_dataframe(_table()).cache()
    b = sess.create_dataframe(_table(100)).filter(F.col("k") > 1).cache()
    a.collect()
    b.collect()
    sess.clear_cache()
    assert not a.is_cached and not b.is_cached
    live = set(DeviceManager.peek().catalog.ids())
    assert not live, f"cached buffers leaked: {live}"


def test_cached_aggregate_feeds_join():
    dim_t = pa.table({"k": [0, 1, 2, 3, 4, 5, 6], "name": list("abcdefg")})

    def build(s, f):
        agg = (s.create_dataframe(_table()).groupBy("k")
               .agg(f.avg("v").alias("av")).cache())
        agg.collect()
        return s.create_dataframe(dim_t).join(agg, "k")
    sess = _sess()
    got = build(sess, F).collect()
    assert _scans_cache(sess)
    assert_tables_equal(_reference(build), got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)


def test_sql_over_cached_view():
    """SQL over a view whose DataFrame is cached scans the cache."""
    def build(s, f, text):
        df = s.create_dataframe(_table()).cache()
        df.createOrReplaceTempView("cached_t")
        return s.sql(text)
    sess = _sess()
    text = "select k, sum(v) as sv from cached_t group by k order by k"
    first = build(sess, F, text).collect()
    assert _scans_cache(sess)
    second = sess.sql("select count(*) as n from cached_t").collect()
    assert second.to_arrow().column("n")[0].as_py() == 1000
    assert first.num_rows == 7
    assert_tables_equal(_reference(lambda s, f: build(s, f, text)),
                        first.to_arrow(), approx_float=1e-9)


def test_dropped_session_frees_cached_buffers():
    """A session dropped without clear_cache() frees its cached buffers
    when it is collected."""
    sess = _sess()
    df = sess.create_dataframe(_table()).cache()
    df.collect()
    ids = list(sess.cache_manager.lookup(df._plan).buffer_ids)
    assert any(bid in set(DeviceManager.peek().catalog.ids()) for bid in ids)
    del df, sess
    gc.collect()
    live = set(DeviceManager.peek().catalog.ids())
    assert not any(bid in live for bid in ids)


def test_cached_scan_under_grace():
    """A cached table scanned by an aggregate forced out of core: the
    partitioned pass equals the plain one."""
    sess = TpuSession({**CONF, "spark.rapids.tpu.memory.outOfCore."
                                "forcePartitions": "4"}, device="cpu")
    df = sess.create_dataframe(_table(3000)).cache()
    df.collect()
    got = df.groupBy("s").agg(F.sum("v").alias("sv")).collect()
    assert _scans_cache(sess)
    plain = _sess().create_dataframe(_table(3000)).groupBy("s").agg(
        F.sum("v").alias("sv")).collect()
    assert_tables_equal(plain.to_arrow(), got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)


def test_session_finalizer_inside_the_manager_lock_does_not_wait():
    """The garbage collector may run a dropped session's finalizer on a
    thread that holds the device manager's lock (while ``initialize``
    builds a manager): the finalizer's peek must not wait on that lock,
    or the thread waits on itself forever."""
    import threading
    from types import SimpleNamespace

    from spark_rapids_tpu_torch.memory.df_cache import _finalize_entries
    done = []

    def run():
        with DeviceManager._lock:
            _finalize_entries([SimpleNamespace(buffer_ids=None)])
            done.append(True)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30)
    assert done and not t.is_alive()
