"""tests/test_shuffle_faults.py's chaos cases on the port: every fault class
driven through the real fetch protocol over FaultInjectingTransport with a
fixed seed, in both packages. Each case ends as the JAX package's does
(the rows recovered, or the same error type naming the same executor and
blocks) with the same fault firings and the same counters."""
import threading
import time

import numpy as np
import pytest

import spark_rapids_tpu.shuffle.faults as jfaults
import spark_rapids_tpu.shuffle.retry as jretry
from spark_rapids_tpu.shuffle.inprocess import _Fabric as JaxFabric
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.shuffle.codec import (ChecksumError, checksum_of,
                                                  verify_checksum)
from spark_rapids_tpu_torch.shuffle.faults import FaultPlan, FaultSpec
from spark_rapids_tpu_torch.shuffle.inprocess import _Fabric
from spark_rapids_tpu_torch.shuffle.manager import (CachingShuffleReader,
                                                    ShuffleFetchFailedError)
from spark_rapids_tpu_torch.shuffle.retry import backoff_ms, backoff_schedule
from spark_rapids_tpu_torch.utils import metrics as mt
from tests.torch_cluster_common import (  # noqa: F401
    cluster, collect_partition, fault_values, fresh_fabrics,
    one_torch_thread, same_rows, sample_table, write_partitioned)

PKGS = ("jax", "port")
FABRIC = {"jax": JaxFabric, "port": _Fabric}


def run_case(pkg, tmp_path, plan="", n=2, extra=None, writes=(),
             before_read=None, reader_env=0, seed=7):
    """One chaos case in ``pkg``: write ``writes`` ((env index, map id,
    table, partitions)), run ``before_read(envs)``, read partition 0 on
    env ``reader_env`` -> (outcome, each env's counters, each env's fired
    faults). The outcome is ("rows", table) or (error type, executor,
    blocks)."""
    mgr, *envs = cluster(pkg, tmp_path,
                         fault_values(pkg, plan, seed, extra), n=n)
    sid, _ = mgr.register_shuffle(1)
    try:
        for i, map_id, table, parts in writes:
            write_partitioned(pkg, mgr, envs[i], sid, map_id, table, parts)
        if before_read is not None:
            before_read(envs)
        try:
            outcome = ("rows", collect_partition(pkg, mgr, envs[reader_env],
                                                 sid, 0))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            outcome = (type(e).__name__, getattr(e, "executor_id", None),
                       tuple(sorted((b.shuffle_id, b.map_id, b.partition_id)
                                    for b in getattr(e, "blocks", ()))),
                       str(e).split(":")[0])
        return (outcome, [e.metrics.snapshot() for e in envs],
                [sorted(e.transport.plan.fired) for e in envs])
    finally:
        for e in envs:
            e.close()


def both(tmp_path, **kw):
    """The case in each package; its counters and firings must agree."""
    got = {}
    for pkg in PKGS:
        FABRIC[pkg].reset()
        got[pkg] = run_case(pkg, tmp_path / pkg, **kw)
    (po, pm, pf), (jo, jm, jf) = got["port"], got["jax"]
    assert pm == jm, (pm, jm)
    assert pf == jf, (pf, jf)
    if po[0] == "rows" and jo[0] == "rows":
        assert same_rows(po[1], jo[1])
    else:
        assert po == jo, (po, jo)
    return po, pm, pf


# ---------------------------------------------------------------- units
def test_backoff_schedule_deterministic_and_the_reference():
    a = backoff_schedule(4, base_ms=50, seed=3, key="transfer:b1")
    assert a == backoff_schedule(4, base_ms=50, seed=3, key="transfer:b1")
    assert a == jretry.backoff_schedule(4, base_ms=50, seed=3,
                                        key="transfer:b1")
    assert a != backoff_schedule(4, 50, seed=4, key="transfer:b1")
    assert a != backoff_schedule(4, 50, seed=3, key="transfer:b2")
    for i, d in enumerate(a):
        assert 50 * (2 ** i) * 0.5 <= d <= 50 * (2 ** i) * 1.5
    assert backoff_ms(30, 50, 0, "k") == 10_000


def test_checksum_roundtrip_and_mismatch():
    buf = np.arange(10_000, dtype=np.int64).tobytes()
    crc = checksum_of(buf)
    verify_checksum(buf, crc)
    verify_checksum(buf, 0)                         # 0 = not computed
    corrupted = bytearray(buf)
    corrupted[1234] ^= 0xFF
    with pytest.raises(ChecksumError, match="checksum mismatch"):
        verify_checksum(bytes(corrupted), crc)


def test_fault_plans_parse_and_fire_as_the_reference():
    text = ("drop_conn:peer=exec-1,after=3;corrupt_frame:after=1,count=2;"
            "fail_request:req_type=metadata;delay_frame:delay_ms=25;"
            "kill_peer:owner=exec-1,req_type=data,after=2")
    plan, ref = FaultPlan.parse(text, seed=9), jfaults.FaultPlan.parse(
        text, seed=9)
    assert [vars(s) for s in plan.specs] == [vars(s) for s in ref.specs]
    assert FaultPlan.parse("").empty
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("meteor_strike")
    spec = FaultSpec("fail_request", after=2, count=2)
    assert [spec.fires(n) for n in (1, 2, 3, 4)] == [False, True, True, False]
    kill, rkill = (FaultPlan.parse("kill_peer:req_type=data,after=3", seed=7),
                   jfaults.FaultPlan.parse("kill_peer:req_type=data,after=3",
                                           seed=7))
    assert [kill.on_kill_frame("p") for _ in range(3)] == \
        [rkill.on_kill_frame("p") for _ in range(3)] == [False, False, True]
    assert not kill.on_kill_request("p", "serve.submit")
    assert kill.fired == rkill.fired == [("kill_peer", "p", 3)]
    data = bytearray(range(256)) * 4
    assert plan.corrupt(bytearray(data)) == ref.corrupt(bytearray(data))


def test_table_meta_carries_checksum():
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.shuffle.table_meta import (TableMeta,
                                                           pack_host_batch)
    buf, meta = pack_host_batch(HostBatch.from_arrow(sample_table(64)))
    assert meta.checksum == checksum_of(buf) != 0
    assert TableMeta.from_bytes(meta.to_bytes()).checksum == meta.checksum


# ---------------------------------------------------------------- chaos
def test_conn_drop_mid_fetch_recovers_via_retry(tmp_path):
    t1, t2 = sample_table(800, seed=1), sample_table(600, seed=2)
    outcome, metrics, fired = both(
        tmp_path, plan="drop_conn:after=2", n=3,
        writes=((1, 0, t1, 2), (2, 1, t2, 2)))
    assert outcome[0] == "rows"
    assert same_rows(outcome[1], __import__("pyarrow").concat_tables(
        [t1.take(list(range(0, 800, 2))), t2.take(list(range(0, 600, 2)))]))
    assert {p for k, p, _ in fired[0] if k == "drop_conn"} == \
        {"exec-1", "exec-2"}
    assert metrics[0][mt.SHUFFLE_FETCH_RETRIES] >= 2
    assert metrics[0][mt.SHUFFLE_PEER_EVICTIONS] >= 2


def test_corrupted_frame_caught_by_checksum_and_retried(tmp_path):
    t = sample_table(700, seed=3)
    outcome, metrics, fired = both(tmp_path, plan="corrupt_frame:after=2",
                                   writes=((1, 0, t, 1),))
    assert outcome[0] == "rows" and same_rows(outcome[1], t)
    assert metrics[0][mt.SHUFFLE_CHECKSUM_FAILURES] >= 1
    assert metrics[0][mt.SHUFFLE_TRANSFER_RETRIES] >= 1
    assert any(k == "corrupt_frame" for k, _, _ in fired[1])


def test_corruption_without_checksum_is_not_caught_by_the_client(tmp_path):
    """The negative control: with the client's check off the flipped byte
    reaches the reader (whose unpack still refuses it, in both packages):
    no checksum failure is counted."""
    t = sample_table(700, seed=3)
    outcome, metrics, _ = both(
        tmp_path, plan="corrupt_frame:after=2", writes=((1, 0, t, 1),),
        extra={"spark.rapids.tpu.shuffle.checksum.enabled": "false",
               "spark.rapids.tpu.shuffle.compression.codec": "none"})
    assert outcome[0] != "rows" or not same_rows(outcome[1], t)
    assert metrics[0][mt.SHUFFLE_CHECKSUM_FAILURES] == 0


def test_failed_request_handler_retried(tmp_path):
    t = sample_table(300, seed=4)
    outcome, metrics, _ = both(
        tmp_path, plan="fail_request:req_type=metadata;"
                       "fail_request:req_type=transfer",
        writes=((1, 0, t, 1),))
    assert outcome[0] == "rows" and same_rows(outcome[1], t)
    assert metrics[0][mt.SHUFFLE_RPC_RETRIES] >= 1
    assert metrics[0][mt.SHUFFLE_TRANSFER_RETRIES] >= 1


def test_slow_peer_and_duplicated_frames_absorbed(tmp_path):
    t = sample_table(700, seed=5)
    outcome, _, fired = both(
        tmp_path, plan="delay_frame:after=1,count=3,delay_ms=40;"
                       "dup_frame:after=2,count=2", writes=((1, 0, t, 1),))
    assert outcome[0] == "rows" and outcome[1].num_rows == t.num_rows
    assert same_rows(outcome[1], t)
    assert {"delay_frame", "dup_frame"} <= {k for k, _, _ in fired[1]}


def test_unrecoverable_fault_names_executor_and_blocks(tmp_path):
    outcome, _, _ = both(
        tmp_path, plan="fail_request:req_type=metadata,count=0",   # always
        extra={"spark.rapids.tpu.shuffle.maxRetries": 1},
        writes=((1, 0, sample_table(50, seed=6), 1),))
    assert outcome[0] == "ShuffleFetchFailedError"
    assert outcome[1] == "exec-1" and outcome[2]


def test_lost_blocks_fail_fast_without_retry(tmp_path):
    def lose(envs):
        envs[1].shuffle_catalog.remove_shuffle(0)   # data gone, tracker not
    outcome, metrics, _ = both(tmp_path, writes=((1, 0, sample_table(40, 12),
                                                  1),), before_read=lose)
    assert outcome[:2] == ("ShuffleFetchFailedError", "exec-1")
    assert outcome[2] and "lost blocks" in outcome[3] + " lost blocks"
    assert metrics[0][mt.SHUFFLE_FETCH_RETRIES] == 0


def test_unreachable_peer_surfaces_scoped_fetch_failure(tmp_path):
    fabrics = iter((JaxFabric, _Fabric))

    def kill(envs):
        next(fabrics).get().kill("exec-1")     # endpoint gone
    outcome, _, _ = both(
        tmp_path, extra={"spark.rapids.tpu.shuffle.maxRetries": 1,
                         "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": 30},
        writes=((1, 0, sample_table(40, seed=10), 1),), before_read=kill)
    assert outcome[:2] == ("ShuffleFetchFailedError", "exec-1")
    assert outcome[2]


def test_reader_timeout_is_overall_deadline(tmp_path):
    """A fetch whose peer never answers times out at the overall deadline,
    not per event."""
    mgr, e0, e1 = cluster("port", tmp_path, fault_values("port"))
    sid, _ = mgr.register_shuffle(1)
    write_partitioned("port", mgr, e1, sid, 0, sample_table(50, seed=8), 1)
    release = threading.Event()

    def black_hole(peer, payload):
        release.wait(30)
        raise ConnectionError("the test is over")
    e1.transport.server.register_request_handler("transfer", black_hole)
    reader = CachingShuffleReader(e0, mgr.tracker, sid, 0, timeout=1.0)
    start = time.monotonic()
    try:
        with pytest.raises(ShuffleFetchFailedError, match="timed out") as ei:
            list(reader.read())
        assert time.monotonic() - start < 10
        assert ei.value.executor_id == "exec-1" and ei.value.blocks
    finally:
        release.set()
        e0.close()
        e1.close()


def test_dead_client_evicted_and_reconnect_possible(tmp_path):
    """The env drops a dead peer's cached client, keeps its per-peer
    connect lock, and a new client connects to a revived executor."""
    mgr, e0, e1 = cluster("port", tmp_path, fault_values("port"))
    c1 = e0.client_for("exec-1")
    assert e0.client_for("exec-1") is c1            # cached
    _Fabric.get().kill("exec-1")
    assert e0.metrics[mt.SHUFFLE_PEER_EVICTIONS].value == 1
    assert "exec-1" not in e0._clients
    assert "exec-1" in e0._connect_locks
    from tests.torch_cluster_common import make_env
    make_env("port", "exec-1", e0.conf, str(tmp_path / "e1b"))
    assert e0.client_for("exec-1") is not c1


# ---------------------------------------------------------------- TCP
def test_peer_loss_scoped_to_failing_peer(tmp_path):
    """Losing one TCP peer fails only its transactions."""
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport
    from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                          TransactionStatus)
    conf = TpuConf({"spark.rapids.tpu.shuffle.tcp.registryDir":
                    str(tmp_path / "reg")})
    a, b, c = (TcpTransport(f"exec-{x}", conf) for x in "abc")
    try:
        conn_b, conn_c = a.connect("exec-b"), a.connect("exec-c")
        lost = []
        a.add_peer_lost_listener(lost.append)
        rb = conn_b.receive(AddressLengthTag(bytearray(5), 5, tag=0x10),
                            lambda t: None)
        alt_c = AddressLengthTag(bytearray(5), 5, tag=0x20)
        rc = conn_c.receive(alt_c, lambda t: None)
        b.shutdown()
        rb.wait(10)
        assert rb.status is TransactionStatus.ERROR
        assert "lost" in rb.error_message
        assert rc.status is TransactionStatus.IN_PROGRESS
        # c's server sends on the socket a opened; its reader registers a
        # once a's hello arrives, which a loaded host may not have done yet
        deadline = time.monotonic() + 10
        while c._peer_by_id("exec-a") is None and time.monotonic() < deadline:
            time.sleep(0.01)
        c.server.send("exec-a", AddressLengthTag.for_bytes(b"hello", 0x20),
                      lambda t: None).wait(10)
        rc.wait(10)
        assert rc.status is TransactionStatus.SUCCESS
        assert bytes(alt_c.buffer) == b"hello" and lost == ["exec-b"]
    finally:
        a.shutdown()
        c.shutdown()


def test_kill_peer_leaves_registry_entry_for_gc(tmp_path):
    import os
    import socket

    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport, scan_registry
    reg = str(tmp_path / "reg")
    t = TcpTransport("exec-victim", TpuConf({
        "spark.rapids.tpu.shuffle.tcp.registryDir": reg}))
    path = os.path.join(reg, "exec-victim")
    assert os.path.exists(path)
    host, port = t.address
    t.kill()
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=2)
    old = time.time() - 120
    os.utime(path, (old, old))
    t.heartbeat()
    assert os.path.getmtime(path) == old, "killed transport heartbeat"
    assert os.path.exists(path)
    assert scan_registry(reg, stale_after_s=5.0) == {}
    assert not os.path.exists(path)


def test_registry_file_removed_on_shutdown(tmp_path):
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport
    reg = tmp_path / "reg"
    conf = TpuConf({"spark.rapids.tpu.shuffle.tcp.registryDir": str(reg),
                    "spark.rapids.tpu.shuffle.maxRetries": 0,
                    "spark.rapids.tpu.shuffle.connectTimeout": 0.2})
    t = TcpTransport("exec-gone", conf)
    assert (reg / "exec-gone").exists()
    t.shutdown()
    assert not (reg / "exec-gone").exists()
    other = TcpTransport("exec-live", conf)
    try:
        with pytest.raises(ConnectionError, match="never registered"):
            other.connect("exec-gone")
    finally:
        other.shutdown()


def test_connect_retries_until_peer_registers(tmp_path):
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport
    conf = TpuConf({
        "spark.rapids.tpu.shuffle.tcp.registryDir": str(tmp_path / "reg"),
        "spark.rapids.tpu.shuffle.connectTimeout": 0.3,
        "spark.rapids.tpu.shuffle.retryBackoffMs": 50})
    a = TcpTransport("exec-early", conf)
    result = {}

    def late_start():
        time.sleep(0.6)                 # past the first connect attempt
        result["b"] = TcpTransport("exec-late", conf)
        result["b"].server.register_request_handler(
            "ping", lambda peer, payload: b"pong")
    th = threading.Thread(target=late_start)
    th.start()
    try:
        conn = a.connect("exec-late")
        tx = conn.request("ping", b"", lambda t: None).wait(10)
        assert tx.response == b"pong"
        assert a.metrics[mt.SHUFFLE_CONNECT_RETRIES].value >= 1
    finally:
        th.join(10)
        a.shutdown()
        if "b" in result:
            result["b"].shutdown()


def test_killed_tcp_transport_leaves_a_dialed_socket_open(tmp_path):
    """ROADMAP queue 3 item 11: when two TCP executors dialed each other,
    the reference's ``kill`` (``shuffle/tcp.py``, kept byte-equal in the
    port) closes only the socket its peer table holds for the other, so a
    receive the other posted on its own connection stays pending until
    the fetch timeout. It still does in the JAX package and in the copy.
    The port's transport (``shuffle/tcp_port.py``) closes every socket it
    holds, and the pending receive fails at once with peer-lost."""
    from spark_rapids_tpu.config import TpuConf as JaxConf
    from spark_rapids_tpu.shuffle.tcp import TcpTransport as JaxTcp
    from spark_rapids_tpu.shuffle.transport import \
        AddressLengthTag as JaxAlt
    from spark_rapids_tpu_torch.shuffle import tcp, tcp_port
    from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                          TransactionStatus)
    for transport, conf, alt in ((JaxTcp, JaxConf, JaxAlt),
                                 (tcp.TcpTransport, TpuConf,
                                  AddressLengthTag),
                                 (tcp_port.TcpTransport, TpuConf,
                                  AddressLengthTag)):
        repaired = transport is tcp_port.TcpTransport
        c = conf({"spark.rapids.tpu.shuffle.tcp.registryDir":
                  str(tmp_path / f"{transport.__module__}")})
        a, b = transport("exec-a", c), transport("exec-b", c)
        try:
            ab = a.connect("exec-b")          # a dials b; b registers a
            deadline = time.monotonic() + 10
            while b._peer_by_id("exec-a") is None and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            b.connect("exec-a")               # b dials a: the entry b keeps
            rx = ab.receive(alt(bytearray(4), 4, tag=9), lambda t: None)
            t0 = time.monotonic()
            b.kill()
            if repaired:
                rx.wait(1.0)
                assert time.monotonic() - t0 < 1.0
                assert rx.status.value == TransactionStatus.ERROR.value
                assert "lost" in rx.error_message
            else:
                with pytest.raises(TimeoutError):
                    rx.wait(1.0)
                assert rx.status.value == \
                    TransactionStatus.IN_PROGRESS.value
        finally:
            a.shutdown()
