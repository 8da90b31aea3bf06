"""The in-process cases of tests/test_recompute.py on the port: a reduce-side
fetch that exhausts its retries makes the stage driver re-run only the
lost map tasks from their recorded lineage on surviving executors, replace
their blocks exactly once and resume the blocked reduce; past
``shuffle.recompute.maxStageAttempts`` the scoped error surfaces. Each
session-level case is held against the JAX package's run under the same
fault plan and seed: the same result (float sums within 1e-9, row arrival
order after a recompute differs) and the same recompute counters. The
scoped error payload and the spill checksums follow."""
import glob

import pyarrow as pa
import pytest

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.shuffle.manager import \
    ShuffleFetchFailedError as JaxFetchFailed
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu.utils import metrics as jmt
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.shuffle.inprocess import _Fabric
from spark_rapids_tpu_torch.shuffle.manager import ShuffleFetchFailedError
from spark_rapids_tpu_torch.utils import metrics as mt
from tests.torch_cluster_common import (  # noqa: F401
    CPU, cluster, collect_partition, device_batch, fault_values,
    fresh_fabrics, one_torch_thread, sample_table, transport,
    write_partitioned)


def _cluster_conf(extra=None):
    """Two in-process executors; tight retry and timeout knobs keep the
    faulted paths fast."""
    return {
        "spark.rapids.tpu.sql.cluster.numExecutors": "2",
        "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1",
        "spark.rapids.tpu.shuffle.retryBackoffMs": "5",
        "spark.rapids.tpu.shuffle.maxRetries": "1",
        "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": "5",
        **(extra or {})}


def _kill_exec1_conf(pkg, extra=None):
    """exec-1 dies on its first outgoing data frame (``owner`` keeps the
    shared plan from killing every executor)."""
    return _cluster_conf({
        "spark.rapids.tpu.shuffle.transport.class": transport(pkg, "faults"),
        "spark.rapids.tpu.shuffle.faults.transport.class":
        transport(pkg, "inprocess"),
        "spark.rapids.tpu.shuffle.faults.plan":
            "kill_peer:owner=exec-1,req_type=data,after=1",
        "spark.rapids.tpu.shuffle.faults.seed": "7",
        **(extra or {})})


def _tables(n=4000):
    fact = pa.table({"k": [i % 8 for i in range(n)],
                     "v": list(range(n)),
                     "f": [i * 0.25 for i in range(n)]})
    dim = pa.table({"k": list(range(8)),
                    "name": [f"n{i}" for i in range(8)]})
    return fact, dim


def _query(s, f, fact, dim):
    return (s.create_dataframe(fact).repartition(4, "k").groupBy("k")
            .agg(f.sum("v").alias("sv"), f.sum("f").alias("sf"))
            .join(s.create_dataframe(dim), "k")
            .filter(f.col("sv") > -500).sort("sv", "k"))


def _killed_run(pkg, fact, dim, extra=None):
    """The query under the kill plan -> (result or the error, recompute
    counter deltas, dead executors, map tasks, the scheduler's lineage
    after the run)."""
    session, f, metrics = ((JaxSession(_kill_exec1_conf(pkg, extra)), JF,
                            jmt) if pkg == "jax" else
                           (TpuSession(_kill_exec1_conf(pkg, extra),
                                       device="cpu"), F, mt))
    try:
        before = metrics.recompute_snapshot()
        try:
            out = _query(session, f, fact, dim).collect()
            out = out if pkg == "jax" else out.to_arrow()
        except (ShuffleFetchFailedError, JaxFetchFailed) as e:
            out = e
        delta = metrics.recompute_delta(before)
        sched = session._cluster_scheduler
        dead = [ex.executor_id for ex in sched.executors
                if not sched._executor_alive(ex)]
        total_maps = sum(st.num_tasks for st in sched.last_stages
                         if not st.is_result)
        return out, delta, dead, total_maps, dict(sched._lineage)
    finally:
        session._cluster_scheduler.close()


def test_kill_peer_mid_reduce_recomputes_only_lost_maps():
    """A peer dying mid-reduce is a bounded re-execution: no error reaches
    the caller, only the dead peer's map tasks run again, and the result
    equals the fault-free run's (float sums within 1e-9), in both
    packages with the same counters."""
    fact, dim = _tables()
    ref_s = TpuSession(_cluster_conf(), device="cpu")
    try:
        ref = _query(ref_s, F, fact, dim).collect().to_arrow()
    finally:
        ref_s._cluster_scheduler.close()
    _Fabric.reset()
    got, delta, dead, total_maps, lineage = _killed_run("port", fact, dim)
    want, jdelta, jdead, jtotal, _ = _killed_run("jax", fact, dim)
    assert delta == jdelta and dead == jdead and total_maps == jtotal
    assert delta["shuffle.recomputes"] >= 1, delta
    assert 1 <= delta["shuffle.recomputed_map_tasks"] < total_maps, delta
    assert delta["shuffle.recompute_escalations"] == 0, delta
    assert dead == ["exec-1"]
    assert lineage == {}        # released with the shuffles
    assert_tables_equal(ref, got, ignore_order=True, approx_float=1e-9)
    assert_tables_equal(want, got, ignore_order=True, approx_float=1e-9)


def test_recompute_disabled_escalates_scoped_error():
    """maxStageAttempts 0 disables recompute: the scoped fetch error
    surfaces and the escalation counter records it, as in the JAX
    package."""
    fact, dim = _tables(800)
    extra = {"spark.rapids.tpu.shuffle.recompute.maxStageAttempts": "0"}
    err, delta, _, _, _ = _killed_run("port", fact, dim, extra)
    jerr, jdelta, _, _, _ = _killed_run("jax", fact, dim, extra)
    assert isinstance(err, ShuffleFetchFailedError)
    assert isinstance(jerr, JaxFetchFailed)
    assert delta == jdelta
    assert delta["shuffle.recompute_escalations"] == 1, delta
    assert delta["shuffle.recomputes"] == 0, delta
    assert err.executor_id == jerr.executor_id == "exec-1"
    assert err.blocks
    assert sorted((b.shuffle_id - min(x.shuffle_id for x in err.blocks),
                   b.map_id, b.partition_id) for b in err.blocks) == \
        sorted((b.shuffle_id - min(x.shuffle_id for x in jerr.blocks),
                b.map_id, b.partition_id) for b in jerr.blocks)


@pytest.mark.slow
def test_tpch_q3_kill_peer_recompute():
    """TPC-H Q3 across two executors with a seeded mid-reduce kill: a
    strict subset of the map tasks runs again and the result equals the
    single-process run's (floats within 1e-9)."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_data import gen_all
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    tables = gen_all(0.002, seed=7)
    single = TpuSession(BENCH_CONF, device="cpu")
    exp = QUERIES[3]({k: single.create_dataframe(v).repartition(2)
                      for k, v in tables.items()}).collect().to_arrow()
    s = TpuSession({**BENCH_CONF, **_kill_exec1_conf("port")}, device="cpu")
    try:
        before = mt.recompute_snapshot()
        out = QUERIES[3]({k: s.create_dataframe(v).repartition(2)
                          for k, v in tables.items()}).collect()
        delta = mt.recompute_delta(before)
        sched = s._cluster_scheduler
        total_maps = sum(st.num_tasks for st in sched.last_stages
                         if not st.is_result)
        assert delta["shuffle.recomputes"] >= 1, delta
        assert delta["shuffle.recomputed_map_tasks"] < total_maps, delta
        assert_tables_equal(exp, out.to_arrow(), ignore_order=True,
                            approx_float=1e-9)
    finally:
        s._cluster_scheduler.close()


# ---------------------------------------------------------------------------
# the scoped error payload: executor_id and blocks through every boundary
# ---------------------------------------------------------------------------

def _fault_cluster(tmp_path, n=2, extra=None):
    return cluster("port", tmp_path, fault_values("port", extra=extra), n=n)


def test_metadata_missing_blocks_reports_all_undelivered(tmp_path):
    """When the metadata response misses some blocks, the scoped error
    names every undelivered block of that peer (the answered blocks'
    transfers never start either)."""
    mgr, e0, e1 = _fault_cluster(tmp_path)
    sid, _ = mgr.register_shuffle(1)
    write_partitioned("port", mgr, e1, sid, 0, sample_table(60, seed=1), 1)
    write_partitioned("port", mgr, e1, sid, 1, sample_table(60, seed=2), 1)
    e1.shuffle_catalog.remove_map_outputs(sid, 1)
    with pytest.raises(ShuffleFetchFailedError, match="lost blocks") as ei:
        collect_partition("port", mgr, e0, sid, 0)
    assert ei.value.executor_id == "exec-1"
    assert {b.map_id for b in ei.value.blocks} == {0, 1}


def test_multi_table_blocks_roundtrip_and_error_scope(tmp_path):
    """A block of several tables delivers each once; lost, it appears in
    the error once per block, not once per table."""
    mgr, e0, e1 = _fault_cluster(tmp_path)
    sid, _ = mgr.register_shuffle(1)
    t = sample_table(80, seed=3)
    write_partitioned("port", mgr, e1, sid, 0, t, 1)
    write_partitioned("port", mgr, e1, sid, 0, t, 1)
    assert len(e1.shuffle_catalog.metas(
        next(iter(e1.shuffle_catalog._by_shuffle[sid])))) == 2
    got = collect_partition("port", mgr, e0, sid, 0)
    assert got.num_rows == 2 * t.num_rows
    assert sorted(got["f"].to_pylist()) == sorted(t["f"].to_pylist() * 2)
    _Fabric.reset()
    mgr2, e0b, e1b = _fault_cluster(tmp_path / "b")
    sid2, _ = mgr2.register_shuffle(1)
    write_partitioned("port", mgr2, e1b, sid2, 0, t, 1)
    write_partitioned("port", mgr2, e1b, sid2, 0, t, 1)
    e1b.shuffle_catalog.remove_shuffle(sid2)
    with pytest.raises(ShuffleFetchFailedError) as ei:
        collect_partition("port", mgr2, e0b, sid2, 0)
    blocks = list(ei.value.blocks)
    assert len(blocks) == len(set(blocks)) == 1, blocks


def test_two_dead_peers_scope_non_overlapping(tmp_path):
    """Two peers failing in one reduce window: the error names one peer
    and carries only that peer's blocks."""
    mgr, e0, e1, e2 = _fault_cluster(
        tmp_path, n=3,
        extra={"spark.rapids.tpu.shuffle.maxRetries": 1,
               "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": 30})
    sid, _ = mgr.register_shuffle(1)
    write_partitioned("port", mgr, e1, sid, 0, sample_table(50, seed=4), 1)
    write_partitioned("port", mgr, e2, sid, 1, sample_table(50, seed=5), 1)
    owner_of = {st.map_id: st.executor_id
                for st in mgr.tracker._shuffles[sid].values()}
    _Fabric.get().kill("exec-1")
    _Fabric.get().kill("exec-2")
    with pytest.raises(ShuffleFetchFailedError) as ei:
        collect_partition("port", mgr, e0, sid, 0)
    err = ei.value
    assert err.executor_id in ("exec-1", "exec-2") and err.blocks
    for b in err.blocks:
        assert owner_of[b.map_id] == err.executor_id


def test_remove_map_outputs_scoped_to_one_map(tmp_path):
    mgr, e0, e1 = _fault_cluster(tmp_path)
    sid, _ = mgr.register_shuffle(1)
    write_partitioned("port", mgr, e1, sid, 0, sample_table(40, seed=6), 1)
    write_partitioned("port", mgr, e1, sid, 1, sample_table(40, seed=7), 1)
    assert e1.shuffle_catalog.remove_map_outputs(sid, 1) >= 1
    assert e1.shuffle_catalog.remove_map_outputs(sid, 1) == 0
    blocks = list(e1.shuffle_catalog._by_shuffle.get(sid, []))
    assert blocks and all(b.map_id == 0 for b in blocks)
    assert e1.shuffle_catalog.metas(blocks[0])


def test_corrupt_shuffle_spill_is_lost_block_recompute_signal(tmp_path):
    """A shuffle buffer whose spill file rots is a lost block: the server
    drops the map task's outputs and the reader's next metadata request
    reports them missing (the scoped error that feeds the recompute), in
    both packages."""
    outcomes = {}
    for pkg in ("jax", "port"):
        mgr, e0, e1 = cluster(pkg, tmp_path, fault_values(
            pkg, extra={"spark.rapids.tpu.shuffle.maxRetries": 1}))
        sid, _ = mgr.register_shuffle(1)
        write_partitioned(pkg, mgr, e1, sid, 0, sample_table(300, seed=10), 1)
        assert e1.device_store.spill_to_size(0) > 0
        e1.host_store.spill_to_size(0)
        files = glob.glob(str(tmp_path / f"{pkg}-e1" / "**" / "*.npz"),
                          recursive=True)
        assert files, "expected on-disk spill files"
        for path in files:
            raw = bytearray(open(path, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            with open(path, "wb") as f:
                f.write(bytes(raw))
        with pytest.raises(Exception) as ei:
            collect_partition(pkg, mgr, e0, sid, 0)
        assert type(ei.value).__name__ == "ShuffleFetchFailedError"
        assert not e1.shuffle_catalog._by_shuffle.get(sid)
        outcomes[pkg] = (ei.value.executor_id,
                         [(b.map_id, b.partition_id) for b in ei.value.blocks],
                         e0.metrics.snapshot())
        e0.close()
        e1.close()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == "exec-1" and outcomes["port"][1]


def test_spill_crc_detects_disk_corruption(tmp_path):
    from spark_rapids_tpu_torch.memory.buffer import (BufferId,
                                                      SpillCorruptionError,
                                                      SpillableBuffer)
    b = device_batch("port", sample_table(128, seed=8))
    disk = SpillableBuffer.from_batch(BufferId(4242), b).to_host().to_disk(
        str(tmp_path))
    assert disk.disk_crc32 is not None
    data = bytearray(open(disk.payload, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(disk.payload, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(SpillCorruptionError) as ei:
        disk.get_batch()
    assert ei.value.path == disk.payload
    assert ei.value.expected != ei.value.actual
    # a clean spill file packs on the host to the device pack's bytes
    from spark_rapids_tpu_torch.shuffle.server import _pack_spillable
    clean = SpillableBuffer.from_batch(BufferId(4243), b)
    (tmp_path / "clean").mkdir()
    on_disk = clean.to_host().to_disk(str(tmp_path / "clean"))
    assert _pack_spillable(on_disk) == _pack_spillable(clean.to_host()) == \
        _pack_spillable(clean)
