"""The replica fleet against the JAX package's: the autoscaler's pure
``decide`` agrees on a seeded grid of hand-built snapshots, the circuit
breakers probe on the same schedule, ``routing_score`` orders replicas the
same way, and the supervisor drives fake replica processes (restart on
backoff, crash-loop breaker, graceful scale-down) through the same states.
One test starts a real replica process of the port's server on the CPU,
kills it, and reads the same answer from its restart."""
import os
import signal
import time

import numpy as np

import spark_rapids_tpu.serving.controller as jctl
import spark_rapids_tpu.serving.health as jhealth
import spark_rapids_tpu.serving.supervisor as jsup
import spark_rapids_tpu_torch.serving.controller as pctl
import spark_rapids_tpu_torch.serving.health as phealth
import spark_rapids_tpu_torch.serving.supervisor as psup
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.config import TpuConf
from tests.torch_serving_common import (WAIT_S,  # noqa: F401
                                        one_torch_thread)

PKG = {"jax": (jctl, jhealth, jsup, JaxConf),
       "port": (pctl, phealth, psup, TpuConf)}


def _grid(seed=11, ticks=120):
    """Per tick: the replicas' (state, age, queue, budget, p99, open) and
    the active count; every signal and exclusion rule gets visited."""
    rng = np.random.default_rng(seed)
    out, active = [], 2
    for t in range(ticks):
        hot = (t // 15) % 2 == 0
        snaps = []
        for r in range(int(rng.integers(1, 5))):
            snaps.append((
                str(rng.choice(["UP", "UP", "UP", "DRAINING"])),
                None if rng.random() < 0.1 else float(rng.random() * 15),
                int(rng.integers(0, 10 if hot else 2)),
                float(rng.random() * (1.2 if hot else 0.3)),
                float(rng.random() * 3), int(rng.integers(0, 4))))
        active = int(np.clip(active + rng.integers(-1, 2), 0, 5))
        out.append((snaps, active, 100.0 + 2.0 * t))
    return out


def _decisions(pkg):
    ctl = PKG[pkg][0]
    pol = ctl.ScalingPolicy(min_replicas=1, max_replicas=4,
                            up_watermark=0.8, down_watermark=0.25,
                            up_stable_ticks=2, down_stable_ticks=3,
                            up_cooldown_s=5.0, down_cooldown_s=30.0,
                            stale_after_s=10.0, queue_norm=4,
                            p99_objective_s=2.0)
    st = ctl.ControllerState()
    out = []
    for snaps, active, now in _grid():
        rs = [ctl.ReplicaSnapshot(addr=f"r{i}", state=s, age_s=a,
                                  queue_depth=q, budget_fraction=b,
                                  p99_wall_s=p, queries_open=o)
              for i, (s, a, q, b, p, o) in enumerate(snaps)]
        d = ctl.decide(rs, active, st, pol, now=now)
        healthy = ctl.healthy_snapshots(rs, pol)
        target = (ctl.pick_scale_down_target(healthy, pol)
                  if d.action < 0 and healthy else None)
        out.append((d.action, d.pressure, d.healthy, d.reason,
                    getattr(target, "addr", target)))
    return out


def test_decide_agrees_with_the_reference_on_a_seeded_grid():
    port, ref = _decisions("port"), _decisions("jax")
    assert port == ref
    assert {a for a, *_ in port} == {-1, 0, 1}


def _breaker_run(pkg, monkeypatch):
    health = PKG[pkg][1]
    clock = [1000.0]
    monkeypatch.setattr(health.time, "monotonic", lambda: clock[0])
    br = health.CircuitBreaker(threshold=2, backoff_ms=100.0, seed=7,
                               key="r1", trial_timeout_s=5.0)
    trace = []
    for step in ["f", "f", "t+0.05", "t+0.5", "f", "t+0.2", "t+2", "s",
                 "f", "f", "t+1", "t+1", "t+10"]:
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        else:
            clock[0] += float(step[2:])
            trace.append(br.probe_due())
        trace.append((br.state, br.allow_submit(), br.snapshot()["opens"],
                      round(br._probe_at - 1000.0, 6)))
    return trace


def test_breakers_probe_on_the_reference_schedule(monkeypatch):
    assert _breaker_run("port", monkeypatch) == \
        _breaker_run("jax", monkeypatch)


def test_routing_score_orders_replicas_as_the_reference():
    rng = np.random.default_rng(3)
    stats = [None]
    for _ in range(40):
        stats.append({
            "now": {"device_budget_bytes": int(rng.integers(1, 1000)),
                    "device_budget_in_use": int(rng.integers(0, 1000)),
                    "admission_queue_depth": int(rng.integers(0, 6)),
                    "running_by_tenant": {"a": int(rng.integers(0, 3))}},
            "p99_wall_s": float(rng.random() * 5)})
    assert [phealth.routing_score(s) for s in stats] == \
        [jhealth.routing_score(s) for s in stats]


class FakeProc:
    """A replica process double: poll, terminate, kill, and a death on
    command."""

    def __init__(self, addr):
        self.addr = addr
        self._rc = None

    def poll(self):
        return self._rc

    def exit(self, rc=1):
        self._rc = rc

    def terminate(self):
        self._rc = 0

    def kill(self):
        self._rc = -9


SUP_CONF = {
    "spark.rapids.tpu.serving.fleet.superviseIntervalSeconds": "60",
    "spark.rapids.tpu.serving.fleet.restartBackoffMs": "1",
    "spark.rapids.tpu.serving.fleet.crashLoopThreshold": "3",
    "spark.rapids.tpu.serving.fleet.crashLoopWindowSeconds": "10",
}


def _supervisor_run(pkg):
    sup_mod, conf_cls = PKG[pkg][2], PKG[pkg][3]
    spawned = []

    def spawn(slot):
        p = FakeProc(f"127.0.0.1:{9000 + len(spawned)}")
        spawned.append(p)
        return p
    sup = sup_mod.ReplicaSupervisor(conf_cls(SUP_CONF), spawn=spawn)
    trace = []

    def record(label):
        st = sup.fleet_stats()
        trace.append((label, [(s["state"], s["attempt"], s["restarts"],
                               s["recent_deaths"]) for s in st["slots"]],
                      st["active"], st["degraded"]))

    def settle():
        deadline = time.monotonic() + WAIT_S
        for _ in range(3):
            sup.tick()
            time.sleep(0.01)
        while any(s["state"] == "BACKOFF"
                  for s in sup.fleet_stats()["slots"]):
            assert time.monotonic() < deadline
            sup.tick()
            time.sleep(0.005)
    try:
        sup.start(2)
        record("start")
        spawned[0].exit(1)
        settle()
        record("one death")
        for _ in range(3):              # the newest replica dies at once
            [p for p in spawned if p.poll() is None][-1].exit(1)
            settle()
        record("crash loop")
        assert sup.scale_up() is not None
        settle()
        record("scaled up")
        sup.scale_down()
        settle()
        record("scaled down")
    finally:
        sup.stop()
    return trace


def test_supervisor_drives_fake_replicas_as_the_reference():
    port = _supervisor_run("port")
    assert port == _supervisor_run("jax")
    assert port[2][3] == 1              # the crash-looping slot DEGRADED


def test_real_replica_process_on_the_cpu_restarts_after_sigkill(tmp_path):
    """The port's server CLI as a supervised process (``--device cpu``):
    a query through the routing client, a SIGKILL, the restart on its
    backoff, and the same answer from the new process."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    from spark_rapids_tpu_torch.serving.supervisor import ReplicaSupervisor
    conf = TpuConf({
        "spark.rapids.tpu.serving.net.registryDir": str(tmp_path / "reg"),
        "spark.rapids.tpu.serving.fleet.superviseIntervalSeconds": "0.1",
        "spark.rapids.tpu.serving.fleet.restartBackoffMs": "50",
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"})
    sql = ("SELECT l_returnflag, count(*) AS c, sum(l_quantity) AS q "
           "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")
    local = TpuSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                        "true"}, device="cpu")
    local.create_dataframe(gen_lineitem(0.0005, 42)).repartition(2) \
        .createOrReplaceTempView("lineitem")
    want = local.sql(sql).collect().to_arrow()
    sup = ReplicaSupervisor(conf, server_args=[
        "--device", "cpu", "--tpch-lineitem", "0.0005", "--partitions", "2"])
    try:
        sup.start(1)

        def addr():
            deadline = time.monotonic() + WAIT_S
            while True:
                got = sup.addresses()
                if got:
                    return got[0]
                assert time.monotonic() < deadline, sup.fleet_stats()
                time.sleep(0.05)
        first = addr()
        client = QueryServiceClient([first], conf)
        try:
            assert_tables_equal(want, client.submit(sql).result())
        finally:
            client.close()
        pid = sup._slots[0].proc.proc.pid
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + WAIT_S
        while sup.fleet_stats()["slots"][0]["restarts"] < 1 or \
                not sup.addresses():
            assert time.monotonic() < deadline, sup.fleet_stats()
            time.sleep(0.05)
        second = addr()
        assert second != first or sup._slots[0].proc.proc.pid != pid
        client = QueryServiceClient([second], conf)
        try:
            assert_tables_equal(want, client.submit(sql).result())
        finally:
            client.close()
        assert sup.fleet_stats()["slots"][0]["state"] == "UP"
    finally:
        sup.stop(graceful=False)
