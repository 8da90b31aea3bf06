"""The serving layer against the JAX package's: the same DataFrames and SQL
submitted through both packages' ``session.submit`` give equal tables; the
lifecycle (cancel, deadline, drain, overload) ends in the same states with
the same error types; one worker dispatches tenants in the same order;
footprint admission charges the same bytes with the same grace hints; the
semaphore's preemption behaves as the reference's, and a starved tenant is
admitted before the whale finishes; the program cache (hits, misses, the
build latch, the index warm start) is the reference's, and a kernel
library's first load from two threads builds once; kernel launches are
counted per query under concurrency."""
import ctypes
import sys
import threading
import time

import pytest

from spark_rapids_tpu.serving import ProgramCache as JaxProgramCache
from spark_rapids_tpu.serving.lifecycle import (QueryHandle as JaxHandle,
                                                bind_query as jax_bind)
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch import cuda_build
from spark_rapids_tpu_torch.serving import program_cache as ppc
from spark_rapids_tpu_torch.serving.lifecycle import (QueryHandle,
                                                      QueryState, bind_query)
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk
from tests.torch_serving_common import (PKGS, WAIT_S, as_arrow,  # noqa: F401
                                        blocking_df, dim_table, manager,
                                        no_leaks, one_torch_thread,
                                        sessions, small_table, tag_df,
                                        wait_until)

CASES = ("agg", "join_sort", "sql", "repartition")


def build_query(pkg, sess, case):
    F = PKGS[pkg][0]
    t = sess.create_dataframe(small_table(300, seed=4))
    if case == "agg":
        return (t.groupBy("k").agg(F.sum("v").alias("s"),
                                   F.count(F.lit(1)).alias("c")).sort("k"))
    if case == "join_sort":
        d = sess.create_dataframe(dim_table())
        return (t.join(d, "k").select("k", "v", "w")
                .sort(F.col("v").desc()).limit(20))
    if case == "sql":
        t.createOrReplaceTempView("t")
        return ("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t WHERE v > 0.3 "
                "GROUP BY k ORDER BY k")
    return (t.repartition(4, "k").groupBy("k").agg(F.max("v").alias("m"))
            .sort("k"))


@pytest.mark.parametrize("case", CASES)
def test_submitted_queries_equal_between_packages(sessions, case):
    got = {}
    for pkg in ("jax", "port"):
        sess = sessions(pkg)
        handles = [sess.submit(build_query(pkg, sess, case),
                               tenant=f"t{i}") for i in range(2)]
        outs = [as_arrow(h.result(timeout=WAIT_S)) for h in handles]
        assert all(h.state is h.state.__class__.DONE for h in handles)
        assert_tables_equal(outs[0], outs[1])
        snap = handles[0].snapshot()
        assert snap["queue_wait_s"] is not None
        assert snap["rows"] == outs[0].num_rows
        got[pkg] = outs[0]
        no_leaks(pkg, sess)
    assert_tables_equal(got["jax"], got["port"], approx_float=1e-9)


# ------------------------------------------------------------ the lifecycle
def _cancel_queued(pkg, sess):
    started, release = threading.Event(), threading.Event()
    blocker = sess.submit(blocking_df(pkg, sess, started, release))
    assert started.wait(WAIT_S)
    ran = []
    victim = sess.submit(tag_df(pkg, sess, ran, "victim"))
    assert victim.cancel()
    release.set()
    blocker.result(timeout=WAIT_S)
    assert victim.wait(WAIT_S)
    assert ran == []
    return victim


def _cancel_running(pkg, sess):
    F, DT, _ = PKGS[pkg]
    started, release = threading.Event(), threading.Event()

    def slow(x):
        started.set()
        release.wait(WAIT_S)
        return x
    import pyarrow as pa
    # the exchange registers its blocks in the catalog while it runs; the
    # action's cleanups must remove them on the cancelled unwind
    df = (sess.create_dataframe(pa.table({"a": list(range(8))}))
          .select(F.udf(slow, DT.LONG)(F.col("a")).alias("b"))
          .repartition(4, F.col("b")).groupBy("b").count())
    h = sess.submit(df, label="victim")
    assert started.wait(WAIT_S)
    assert h.cancel()
    release.set()
    assert h.wait(WAIT_S)
    return h


def _deadline(pkg, sess):
    started, release = threading.Event(), threading.Event()
    h = sess.submit(blocking_df(pkg, sess, started, release), timeout=0.3)
    assert started.wait(WAIT_S)
    time.sleep(0.4)
    release.set()
    assert h.wait(WAIT_S)
    return h


def _malformed(pkg, sess):
    h = sess.submit("SELECT definitely_not_a_column FROM nowhere")
    assert h.wait(WAIT_S)
    return h


def _draining(pkg, sess):
    sess.scheduler.start_draining()
    return lambda: sess.submit("SELECT 1")


def _overload(pkg, sess):
    started, release = threading.Event(), threading.Event()
    blocker = sess.submit(blocking_df(pkg, sess, started, release),
                          tenant="a")
    assert started.wait(WAIT_S)
    queued = sess.submit(tag_df(pkg, sess, [], "q"), tenant="a")
    try:
        sess.submit(tag_df(pkg, sess, [], "shed"), tenant="a")
    except Exception as e:      # noqa: BLE001 - compared below
        err = e
    else:
        err = None
    release.set()
    blocker.result(timeout=WAIT_S)
    queued.result(timeout=WAIT_S)

    def resubmit():
        if err is not None:
            raise err
    return resubmit


LIFECYCLE = {
    "cancel_queued": (_cancel_queued,
                      {"spark.rapids.tpu.serving.maxConcurrentQueries": "1"}),
    "cancel_running": (_cancel_running, {}),
    "deadline": (_deadline, {}),
    "malformed": (_malformed, {}),
    "draining": (_draining, {}),
    "overload": (_overload,
                 {"spark.rapids.tpu.serving.maxConcurrentQueries": "1",
                  "spark.rapids.tpu.serving.maxQueuedPerTenant": "1"}),
}


def _outcome(res):
    """(terminal state, error type, retry hint) of a handle, or of the
    call that submitted it."""
    if callable(res):
        try:
            res()
        except Exception as e:  # noqa: BLE001 - the rejection compared
            return ("REJECTED", type(e).__name__,
                    getattr(e, "retry_after_s", None))
        return ("ACCEPTED", None, None)
    return (res.state.value, type(res.error).__name__ if res.error else None,
            None)


@pytest.mark.parametrize("case", sorted(LIFECYCLE))
def test_lifecycle_outcomes_equal_between_packages(sessions, case):
    fn, extra = LIFECYCLE[case]
    outcomes = {}
    for pkg in ("jax", "port"):
        sess = sessions(pkg, extra)
        outcomes[pkg] = _outcome(fn(pkg, sess))
        no_leaks(pkg, sess)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == {
        "cancel_queued": "CANCELLED", "cancel_running": "CANCELLED",
        "deadline": "FAILED", "malformed": "FAILED",
        "draining": "REJECTED", "overload": "REJECTED"}[case]


def test_one_worker_dispatches_tenants_in_the_reference_order(sessions):
    orders = {}
    for pkg in ("jax", "port"):
        sess = sessions(pkg, {
            "spark.rapids.tpu.serving.maxConcurrentQueries": "1",
            "spark.rapids.tpu.serving.tenantWeights": "a:3,b:1"})
        started, release = threading.Event(), threading.Event()
        blocker = sess.submit(blocking_df(pkg, sess, started, release),
                              tenant="z")
        assert started.wait(WAIT_S)
        order = []
        hs = [sess.submit(tag_df(pkg, sess, order, f"{t}{i}"), tenant=t)
              for t, n in (("a", 5), ("b", 3), ("c", 1))
              for i in range(n)]
        release.set()
        blocker.result(timeout=WAIT_S)
        for h in hs:
            h.result(timeout=WAIT_S)
        orders[pkg] = order
    assert orders["port"] == orders["jax"]
    assert sorted(orders["port"]) == sorted(
        ["a0", "a1", "a2", "a3", "a4", "b0", "b1", "b2", "c0"])


# ----------------------------------------------------- footprint admission
class _Probe:
    """A handle stand-in for the admission ledger."""

    def __init__(self, qid):
        self.query_id = qid
        self.metrics = {}
        self._admission_rejected_at = None

    def note_metric(self, k, v):
        self.metrics[k] = v


@pytest.mark.parametrize("pool", ["1048576", "65536"])
def test_footprint_admission_charges_equal_between_packages(sessions, pool):
    """The plans' working-set estimates, the bytes each admission charges
    and its grace hint, and which of a queue of queries waits, against a
    1 MiB and a 64 KiB device budget."""
    from spark_rapids_tpu.plan.footprint import \
        plan_working_set_estimate as jax_estimate
    from spark_rapids_tpu.serving.admission import \
        FootprintAdmission as JaxAdmission
    from spark_rapids_tpu_torch.plan.footprint import \
        plan_working_set_estimate
    from spark_rapids_tpu_torch.serving.admission import FootprintAdmission
    seen = {}
    for pkg in ("jax", "port"):
        sess = sessions(pkg, {
            "spark.rapids.tpu.memory.tpu.poolSizeBytes": pool})
        manager(pkg, sess)
        if pkg == "jax":
            adm, est = JaxAdmission(sess.conf), jax_estimate
        else:
            adm, est = FootprintAdmission(sess.conf, sess.device), \
                plan_working_set_estimate
        rows = []
        for i, case in enumerate(("agg", "join_sort", "repartition")):
            q = build_query(pkg, sess, case)
            plan = (q._executed_plan() if pkg == "jax"
                    else q.physical_plan())
            estimate = est(plan)
            probe = _Probe(i)
            admitted = adm.try_admit(probe, estimate)
            rows.append((case, estimate, admitted,
                         probe.metrics.get("admission_grace_hint", False),
                         adm.stats()["charged_bytes"]))
        seen[pkg] = rows
    assert seen["port"] == seen["jax"]
    assert any(r[1] for r in seen["port"])


# ------------------------------------------------------------- preemption
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_semaphore_preemption_matches_the_reference(pkg):
    """A holder sees another tenant's waiter starve, yields its permit,
    the waiter runs, and the holder takes it back: the same steps in both
    semaphores."""
    if pkg == "jax":
        from spark_rapids_tpu.memory.semaphore import TpuSemaphore
    else:
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    sem = TpuSemaphore(1)
    steps = []
    waiter_in = threading.Event()

    def waiter():
        with sem.held(tenant="fast"):
            steps.append("fast admitted")
            waiter_in.set()
    with sem.held(tenant="whale"):
        assert sem.holds_permit()
        assert not sem.yield_to_waiters(task_id=-1, tenant="whale")
        th = threading.Thread(target=waiter)
        th.start()
        wait_until(lambda: sem.waiting == 1)
        assert not sem.has_starved_waiter(exclude_tenant="fast",
                                          min_wait_s=0.0)
        wait_until(lambda: sem.has_starved_waiter(exclude_tenant="whale",
                                                  min_wait_s=0.02))
        assert sem.yield_to_waiters(tenant="whale")
        steps.append("whale back")
        assert waiter_in.is_set() and sem.holds_permit()
        th.join(WAIT_S)
    assert steps == ["fast admitted", "whale back"]
    assert sem.active_holders == 0 and sem.waiting == 0


def test_starved_tenant_admitted_before_the_whale_finishes(sessions):
    """One device permit, preemption on: an interactive tenant's query
    submitted behind a running many-batch whale finishes first, the whale
    yields at least once, both results equal their single runs, and
    nothing is left held or registered."""
    # the pipeline off: the whale's UDF and uploads run on its task thread,
    # whose checkpoints may yield (a producer thread's may not), so it
    # yields between its 16 batches; with the pipeline on its first
    # task-thread checkpoint came after the UDF stage, and the two queries
    # then ended within a millisecond of each other
    sess = sessions("port", {
        "spark.rapids.tpu.sql.concurrentTpuTasks": "1",
        "spark.rapids.tpu.serving.maxConcurrentQueries": "2",
        "spark.rapids.tpu.serving.preemption.enabled": "true",
        "spark.rapids.tpu.serving.preemption.starvationMs": "20",
        "spark.rapids.tpu.transfer.pipeline.enabled": "false"})
    F, DT = PKGS["port"][:2]
    started = threading.Event()
    # the whale's rows wait until the starved query's worker runs it, so
    # the whale's 16 batches of 50 ms are all ahead when it starts waiting
    running = threading.Event()
    running.set()

    def slow(x):
        started.set()
        running.wait(WAIT_S)
        time.sleep(0.05)
        return x
    whale = (sess.create_dataframe(small_table(16, seed=5)).repartition(16)
             .select("k", F.udf(slow, DT.LONG)(F.col("k")).alias("b"))
             .groupBy("k").count().sort("k"))
    inter = (sess.create_dataframe(small_table(64, seed=6)).groupBy("k")
             .agg(F.sum("v").alias("s")).sort("k"))
    want_whale, want_inter = whale.collect(), inter.collect()
    started.clear()
    running.clear()
    wh = sess.submit(whale, tenant="whale")
    assert started.wait(WAIT_S)
    ih = sess.submit(inter, tenant="interactive")
    deadline = time.monotonic() + WAIT_S
    while ih.state.value in ("QUEUED", "ADMITTED") \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    running.set()
    got_inter = ih.result(timeout=WAIT_S)
    assert not wh.done, "the whale finished before the starved tenant"
    got_whale = wh.result(timeout=WAIT_S)
    assert wh.snapshot()["preemptions"] >= 1
    assert_tables_equal(want_whale.to_arrow(), got_whale.to_arrow())
    assert_tables_equal(want_inter.to_arrow(), got_inter.to_arrow())
    no_leaks("port", sess)


# ---------------------------------------------------------- program cache
def _cache_case(cls, case, tmp_path):
    if case == "hits_misses":
        c = cls(index_path="off")
        for key in (("a",), ("b",), ("a",), ("a",), ("b",)):
            c.get_or_build(key, lambda: (lambda x: x))
        return c.stats()
    if case == "latch":
        c = cls(index_path="off")
        builds = []

        def builder():
            builds.append(1)
            time.sleep(0.05)
            return lambda x: x + 1
        ths = [threading.Thread(target=c.get_or_build,
                                args=(("k",), builder)) for _ in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(WAIT_S)
        return len(builds), c.stats()["hits"], c.stats()["misses"]
    if case == "index_warm_start":
        d = str(tmp_path / cls.__module__)
        c1 = cls(index_path=d)
        c1.get_or_build(("plan", 128), lambda: (lambda x: x))
        c2 = cls(index_path=d)
        c2.get_or_build(("plan", 128), lambda: (lambda x: x))
        c2.get_or_build(("other", 1), lambda: (lambda x: x))
        return c1.stats()["disk_hits"], c2.stats()["disk_hits"], \
            c2.stats()["misses"]
    c = cls(max_programs=4, index_path="off")
    for i in range(10):
        c.get_or_build(("k", i), lambda: (lambda x: x))
    st = c.stats()
    return st["programs"], st["evictions"]


@pytest.mark.parametrize("case", ["hits_misses", "latch",
                                  "index_warm_start", "lru"])
def test_program_cache_matches_the_reference(case, tmp_path):
    def strip(v):
        # build seconds differ between the packages by construction
        return {k: x for k, x in v.items() if k != "compile_s"} \
            if isinstance(v, dict) else v
    assert strip(_cache_case(ppc.ProgramCache, case, tmp_path)) == \
        strip(_cache_case(JaxProgramCache, case, tmp_path))


def test_program_cache_counts_on_the_bound_query():
    """A miss and its hits land on the query bound to the thread, as in
    the reference; the port adds the build's seconds to compile_s."""
    got = {}
    for cls, handle, bind in ((ppc.ProgramCache, QueryHandle, bind_query),
                              (JaxProgramCache, JaxHandle, jax_bind)):
        c = cls(index_path="off")
        h = handle(None)
        with bind(h):
            for _ in range(3):
                c.get_or_build(("k",), lambda: (time.sleep(0.01),
                                                (lambda x: x))[1])
        got[cls.__module__] = dict(h.snapshot()["program_cache"])
        if cls is ppc.ProgramCache:
            assert h.snapshot()["compile_s"] >= 0.01
    assert len({tuple(sorted(v.items())) for v in got.values()}) == 1


def test_kernel_library_first_load_from_two_threads_builds_once(
        monkeypatch):
    """Two threads whose first query launches a kernel both load its
    library: ``nvcc`` (here a slow fake) runs once, the ctypes signatures
    are bound once, and both get the same library."""
    builds, binds, libs = [], [], []

    def slow_build(source):
        builds.append(source)
        time.sleep(0.1)
        return cuda_build.BUILD_DIR / "fake.so", ""
    monkeypatch.setattr(cuda_build, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(ppc, "_GLOBAL", ppc.ProgramCache(index_path="off"))
    handles = [QueryHandle(None) for _ in range(2)]

    def first_query(h):
        with bind_query(h):
            libs.append(cuda_build.load("partition_reorder.cu",
                                        binds.append))
    ths = [threading.Thread(target=first_query, args=(h,))
           for h in handles]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WAIT_S)
    assert builds == ["partition_reorder.cu"]
    assert len(binds) == 1 and libs[0] is libs[1]
    pcs = sorted((h.snapshot()["program_cache"]["misses"],
                  h.snapshot()["program_cache"]["hits"]) for h in handles)
    assert pcs == [(0, 1), (1, 0)]


def test_build_names_its_temporary_file_per_thread(monkeypatch, tmp_path):
    outs = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        tmp = cmd[cmd.index("-o") + 1]
        outs.append(tmp)
        time.sleep(0.05)
        open(tmp, "w").close()
        return Done()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_PATHS", {})
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    ths = [threading.Thread(target=cuda_build.build,
                            args=("dma_compact.cu",)) for _ in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WAIT_S)
    assert len(outs) == 2 and outs[0] != outs[1]
    assert cuda_build.library_path("dma_compact.cu").exists()


def test_launch_counts_exact_per_query_under_concurrency():
    """Four threads, each bound to its own query, bump the reorder's and
    the compact's counters: every query reads its own exact counts and
    the process totals are their sums."""
    before = (tpk.REORDER_KERNEL.launches, tpk.REORDER_KERNEL.kept,
              tpk.COMPACT_KERNEL.launches)
    handles = [QueryHandle(None) for _ in range(4)]
    n = [300, 500, 700, 900]

    def run(h, k):
        with bind_query(h):
            for i in range(k):
                tpk.REORDER_KERNEL._bump("launches")
                if i % 2:
                    tpk.REORDER_KERNEL._bump("kept")
                if i % 3 == 0:
                    tpk.COMPACT_KERNEL._bump("launches")
    ths = [threading.Thread(target=run, args=(h, k))
           for h, k in zip(handles, n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads inside each bump
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ths)
    for h, k in zip(handles, n):
        assert h.metric("reorder_launches") == k
        assert h.metric("reorder_kept") == k // 2
        assert h.metric("compact_launches") == (k + 2) // 3
    assert tpk.REORDER_KERNEL.launches - before[0] == sum(n)
    assert tpk.REORDER_KERNEL.kept - before[1] == sum(k // 2 for k in n)
    assert tpk.COMPACT_KERNEL.launches - before[2] == sum(
        (k + 2) // 3 for k in n)


# ---------------------------------------------------------- other entries
def test_served_cluster_query_equals_collect_and_records_recompute(
        sessions):
    sess = sessions("port", {
        "spark.rapids.tpu.sql.cluster.numExecutors": "2"})
    try:
        q = build_query("port", sess, "repartition")
        want = q.collect()
        h = sess.submit(q)
        got = h.result(timeout=WAIT_S)
        assert_tables_equal(want.to_arrow(), got.to_arrow())
        assert h.state is QueryState.DONE
        assert set(h.exec_metrics["shuffle"]) >= {
            "shuffle.recomputes", "shuffle.recomputed_map_tasks"}
        assert h.snapshot()["stream_batches"] >= 1
    finally:
        sched = getattr(sess, "_cluster_scheduler", None)
        if sched is not None:
            sched.close()


def test_builder_makes_a_session_on_the_asked_device():
    from spark_rapids_tpu_torch.api import TpuSession
    s = (TpuSession.builder()
         .config("spark.rapids.tpu.serving.maxConcurrentQueries", "2")
         .device("cpu").getOrCreate())
    assert s.device.type == "cpu"
    assert s.scheduler.max_concurrent == 2
    s.scheduler.shutdown()
