"""tests/test_shuffle.py's and tests/test_shuffle_tcp.py's behaviours on the
port's shuffle stack: the caching writer, the catalogs, the server and
client state machines and the reader, over the in-process fabric and over
TCP sockets, held against the JAX package's stack fed the same map
outputs (every reduce partition's rows equal)."""
import os
import subprocess
import sys
import textwrap
import threading
import time

import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.shuffle.manager import ShuffleFetchFailedError
from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                      BounceBufferManager,
                                                      InflightThrottle,
                                                      TransactionStatus)
from tests.torch_cluster_common import (  # noqa: F401
    cluster, collect_partition, device_batch, fresh_fabrics, one_torch_thread,
    same_rows, sample_table, transport, two_env_values, write_partitioned)

PKGS = ("jax", "port")


def _tcp(pkg, tmp_path):
    return {"spark.rapids.tpu.shuffle.transport.class": transport(pkg, "tcp"),
            "spark.rapids.tpu.shuffle.tcp.registryDir":
            str(tmp_path / f"{pkg}-reg")}


def _round_trip(pkg, tmp_path, codec, extra):
    mgr, e0, e1 = cluster(pkg, tmp_path, two_env_values(pkg, codec, extra))
    try:
        sid, _ = mgr.register_shuffle(2)
        write_partitioned(pkg, mgr, e0, sid, 0, sample_table(120, seed=1), 2)
        write_partitioned(pkg, mgr, e1, sid, 1, sample_table(90, seed=2), 2)
        # a reducer on exec-0 reads partition 0 (local + remote from e1),
        # one on exec-1 partition 1 (remote from e0 + local)
        return (collect_partition(pkg, mgr, e0, sid, 0),
                collect_partition(pkg, mgr, e1, sid, 1),
                e0.metrics.snapshot(), e1.metrics.snapshot())
    finally:
        e0.close()
        e1.close()


@pytest.mark.parametrize("codec", ["none", "copy", "zlib", "lz4", "zstd"])
@pytest.mark.parametrize("wire", ["inprocess", "tcp"])
def test_two_executor_round_trip_equals_reference(tmp_path, codec, wire):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    got = {}
    for pkg in PKGS:
        extra = _tcp(pkg, tmp_path) if wire == "tcp" else {}
        got[pkg] = _round_trip(pkg, tmp_path, codec, extra)
    t0, t1 = sample_table(120, seed=1), sample_table(90, seed=2)
    exp0 = pa.concat_tables([t0.take(list(range(0, 120, 2))),
                             t1.take(list(range(0, 90, 2)))])
    exp1 = pa.concat_tables([t0.take(list(range(1, 120, 2))),
                             t1.take(list(range(1, 90, 2)))])
    p0, p1, *pm = got["port"]
    j0, j1, *jm = got["jax"]
    assert same_rows(p0, exp0) and same_rows(p1, exp1)
    assert same_rows(p0, j0) and same_rows(p1, j1)
    assert pm == jm                     # no retry, eviction or fallback


def test_bounce_buffer_pool_blocks_and_reuses():
    mgr = BounceBufferManager("t", 16, 2)
    a, b = mgr.acquire(2)
    assert mgr.try_acquire(1) is None
    done = []

    def later():
        got = mgr.acquire(1, timeout=5)
        done.append(got[0])
        got[0].close()
    th = threading.Thread(target=later)
    th.start()
    a.close()
    th.join(5)
    assert not th.is_alive()
    assert done and mgr.num_free == 1
    b.close()
    assert mgr.num_free == 2
    with pytest.raises(TimeoutError):
        BounceBufferManager("u", 8, 1).acquire(2, timeout=0.05)


def test_inflight_throttle_fifo():
    th = InflightThrottle(100)
    th.acquire(80)
    order = []

    def want(n, label):
        th.acquire(n, timeout=5)
        order.append(label)
        th.release(n)
    t1 = threading.Thread(target=want, args=(50, "big"))
    t1.start()
    time.sleep(0.05)
    assert order == []                  # 80 + 50 > 100: it waits
    th.release(80)
    t1.join(5)
    assert not t1.is_alive() and order == ["big"]
    # oversized requests clamp rather than deadlock
    th.acquire(10_000)
    th.release(10_000)
    assert th.inflight_bytes == 0


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_spilled_buffers_are_served(tmp_path, tier):
    """A map output spilled off the device (to the host, or on to disk) is
    packed on the host and fetched with the same rows, in both packages."""
    t = sample_table(64, seed=5)
    got = {}
    for pkg in PKGS:
        mgr, e0, e1 = cluster(pkg, tmp_path, two_env_values(pkg))
        sid, _ = mgr.register_shuffle(1)
        write_partitioned(pkg, mgr, e0, sid, 0, t, 1)
        assert e0.device_store.spill_to_size(0) > 0
        if tier == "disk":
            assert e0.host_store.spill_to_size(0) > 0
        got[pkg] = collect_partition(pkg, mgr, e1, sid, 0)
        e0.close()
        e1.close()
    assert same_rows(got["port"], t) and same_rows(got["port"], got["jax"])


def test_multi_chunk_transfer(tmp_path):
    """A buffer larger than one bounce buffer walks the pool in chunks."""
    t = sample_table(2000, seed=11)    # packed size >> 1 KiB
    got = {}
    for pkg in PKGS:
        mgr, e0, e1 = cluster(pkg, tmp_path, {
            "spark.rapids.tpu.shuffle.bounceBuffers.size": 1024,
            "spark.rapids.tpu.shuffle.bounceBuffers.count": 4})
        sid, _ = mgr.register_shuffle(1)
        write_partitioned(pkg, mgr, e0, sid, 0, t, 1)
        got[pkg] = collect_partition(pkg, mgr, e1, sid, 0)
    assert same_rows(got["port"], t) and same_rows(got["port"], got["jax"])


def test_reader_early_close_releases_unyielded_buffers(tmp_path):
    """Closing the reader mid-block (a LIMIT stopping after the first
    batch) releases the not-yet-yielded buffers of the block too."""
    mgr, e0, _e1 = cluster("port", tmp_path, two_env_values("port"))
    sid, _ = mgr.register_shuffle(1)
    t = sample_table(30, seed=5)
    # one map task emitting three batches for one (map, partition) block
    mgr.get_writer(e0, sid, 0, 1).write(
        [(0, device_batch("port", t.slice(i * 10, 10))) for i in range(3)])
    block = mgr.tracker.blocks_by_executor(sid, 0)[e0.executor_id][0]
    probe = e0.shuffle_catalog.acquire_buffers(block)
    assert len(probe) == 3
    bufs = [b for b, _m in probe]
    for b in bufs:
        b.close()
    base = [b.refcount for b in bufs]            # the owner store's refs
    it = mgr.get_reader(e0, sid, 0).read()
    next(it)
    it.close()
    assert [b.refcount for b in bufs] == base


def test_empty_partitions_are_skipped(tmp_path):
    t = sample_table(6, seed=9)
    for pkg in PKGS:
        mgr, e0, e1 = cluster(pkg, tmp_path, two_env_values(pkg), tag="e")
        sid, _ = mgr.register_shuffle(4)
        status = mgr.get_writer(e0, sid, 0, 4).write(
            [(0, device_batch(pkg, t))])      # only partition 0 has data
        assert [s > 0 for s in status.partition_sizes] == [True] + [False] * 3
        assert collect_partition(pkg, mgr, e1, sid, 1) is None
        assert collect_partition(pkg, mgr, e1, sid, 0).num_rows == 6


def test_fetch_failure_surfaces(tmp_path):
    mgr, e0, e1 = cluster("port", tmp_path, two_env_values("port"))
    sid, _ = mgr.register_shuffle(1)
    write_partitioned("port", mgr, e0, sid, 0, sample_table(10), 1)
    # the data is gone from e0 while the tracker still lists it
    e0.shuffle_catalog.remove_shuffle(sid)
    with pytest.raises(ShuffleFetchFailedError, match="lost blocks") as ei:
        collect_partition("port", mgr, e1, sid, 0)
    assert ei.value.executor_id == "exec-0" and ei.value.blocks


def test_unregister_shuffle_frees_buffers(tmp_path):
    mgr, e0, e1 = cluster("port", tmp_path, two_env_values("port"))
    sid, _ = mgr.register_shuffle(2)
    write_partitioned("port", mgr, e0, sid, 0, sample_table(40), 2)
    assert len(e0.device_store) > 0
    mgr.unregister_shuffle(sid, [e0, e1])
    assert len(e0.device_store) == 0
    assert mgr.tracker.blocks_by_executor(sid, 0) == {}


def test_codec_negotiates_down_to_copy(tmp_path):
    """A server that does not support the requested codec sends copy and
    counts the fallback, as the reference's does."""
    from spark_rapids_tpu_torch.shuffle.server import ShuffleServer
    got = {}
    for pkg in PKGS:
        mgr, e0, e1 = cluster(pkg, tmp_path, two_env_values(pkg, "zlib"),
                              tag="neg")
        e0.server = (ShuffleServer if pkg == "port" else type(e0.server))(
            e0.transport, e0.shuffle_catalog, "zlib",
            supported_codecs=("copy",))
        sid, _ = mgr.register_shuffle(1)
        write_partitioned(pkg, mgr, e0, sid, 0, sample_table(50, seed=3), 1)
        got[pkg] = (collect_partition(pkg, mgr, e1, sid, 0),
                    e0.metrics.snapshot())
    assert same_rows(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["shuffleCodecFallbacks"] >= 1


# ---------------------------------------------------------------- TCP
def _tcp_conf(tmp_path):
    return TpuConf({
        "spark.rapids.tpu.shuffle.transport.class": transport("port", "tcp"),
        "spark.rapids.tpu.shuffle.tcp.registryDir": str(tmp_path / "reg"),
        "spark.rapids.tpu.shuffle.bounceBuffers.size": 4096,
        "spark.rapids.tpu.shuffle.bounceBuffers.count": 8,
    })


def test_tcp_rpc_and_tagged_transfer(tmp_path):
    conf = _tcp_conf(tmp_path)
    a = TcpTransport("exec-a", conf)
    b = TcpTransport("exec-b", conf)
    try:
        b.server.register_request_handler(
            "echo", lambda peer, payload: b"from-b:" + payload)
        conn = a.connect("exec-b")
        tx = conn.request("echo", b"hello", lambda t: None).wait(10)
        assert tx.status is TransactionStatus.SUCCESS
        assert tx.response == b"from-b:hello"
        # tag-addressed transfer: b's server sends into a's posted receive
        buf = AddressLengthTag(bytearray(11), 11, tag=0x42)
        rx = conn.receive(buf, lambda t: None)
        sb = AddressLengthTag.for_bytes(b"payload-abc", tag=0x42)
        stx = b.server.send("exec-a", sb, lambda t: None).wait(10)
        assert stx.status is TransactionStatus.SUCCESS
        rx.wait(10)
        assert bytes(buf.buffer) == b"payload-abc"
        # an unknown handler is a transaction error
        err = conn.request("nope", b"", lambda t: None).wait(10)
        assert err.status is TransactionStatus.ERROR
        assert "no handler" in err.error_message
    finally:
        a.shutdown()
        b.shutdown()


def test_tcp_early_send_matches_late_receive(tmp_path):
    conf = _tcp_conf(tmp_path)
    a = TcpTransport("exec-a2", conf)
    b = TcpTransport("exec-b2", conf)
    try:
        conn = a.connect("exec-b2")
        # the client sends before the server posts the receive: the data
        # waits in the early-data table
        conn.send(AddressLengthTag.for_bytes(b"xyzzy", tag=7),
                  lambda t: None).wait(10)
        time.sleep(0.1)
        buf = AddressLengthTag(bytearray(5), 5, tag=7)
        rx = b.connect("exec-a2").receive(buf, lambda t: None).wait(10)
        assert rx.status is TransactionStatus.SUCCESS
        assert bytes(buf.buffer) == b"xyzzy"
    finally:
        a.shutdown()
        b.shutdown()


_PEER_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport
    conf = TpuConf({{"spark.rapids.tpu.shuffle.tcp.registryDir": {reg!r}}})
    t = TcpTransport("exec-remote", conf)
    t.server.register_request_handler(
        "double", lambda peer, payload: payload * 2)
    print("READY", flush=True)
    sys.stdin.readline()     # serve until the test closes our stdin
    t.shutdown()
""")


def test_cross_process_rpc(tmp_path):
    """Two OS processes: the peer registers in the registry directory and
    the local transport resolves it and round-trips an RPC."""
    reg = str(tmp_path / "reg")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _PEER_SCRIPT.format(repo=repo, reg=reg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line == "READY", f"peer failed to start: {line}"
        local = TcpTransport("exec-local", TpuConf({
            "spark.rapids.tpu.shuffle.tcp.registryDir": reg}))
        try:
            conn = local.connect("exec-remote")
            tx = conn.request("double", b"ab", lambda t: None).wait(15)
            assert tx.status is TransactionStatus.SUCCESS
            assert tx.response == b"abab"
        finally:
            local.shutdown()
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_fetch_past_the_throttle_and_the_bounce_pool(tmp_path):
    """ROADMAP queue 3 item 13: a fetch that asks one peer for more bytes
    than ``shuffle.maxReceiveInflightBytes``, or for more tables at once
    than the receive bounce pool holds, completes on the port: the client
    waits on the throttle and the pool off the transport's thread. The
    JAX package waits on them on the TCP reader, which alone delivers the
    chunks that free them: its fetch stalls until the reader's deadline."""
    t = sample_table(600, seed=13)
    got = {}
    for pkg in PKGS:
        mgr, e0, e1 = cluster(pkg, tmp_path, {
            **_tcp(pkg, tmp_path),
            "spark.rapids.tpu.shuffle.bounceBuffers.size": 1024,
            "spark.rapids.tpu.shuffle.bounceBuffers.count": 4,
            "spark.rapids.tpu.shuffle.maxReceiveInflightBytes": 16384,
            "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": 3})
        try:
            sid, _ = mgr.register_shuffle(1)
            # one map task writing its partition in three batches: a block
            # of three tables of ~10 KB, ten chunks each
            mgr.get_writer(e1, sid, 0, 1).write(
                [(0, device_batch(pkg, t.slice(i * 200, 200)))
                 for i in range(3)])
            try:
                got[pkg] = collect_partition(pkg, mgr, e0, sid, 0)
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                got[pkg] = e
        finally:
            e0.close()
            e1.close()
    assert same_rows(got["port"], t)
    assert type(got["jax"]).__name__ == "ShuffleFetchFailedError"
    assert "timed out" in str(got["jax"])
