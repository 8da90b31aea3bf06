"""Fleet autoscaler: a control loop over aggregated serve.health.

ROADMAP item 5(a): the serving tier can heal itself (supervisor) and
describe itself (serve_stats rolling windows with a staleness stamp) —
this module closes the remaining loop by *sizing* the fleet. The design
splits cleanly in two:

- a **pure decision core** (``decide`` over ``ReplicaSnapshot`` /
  ``ScalingPolicy`` / ``ControllerState``) with no clocks, threads or IO
  — every watermark crossing, hysteresis band, cooldown and clamping
  rule is unit-testable with hand-built snapshots;
- a thin **collection/actuation shell** (``FleetController``) that
  gathers one ``serve.health`` snapshot per supervised replica each
  tick, feeds the core, and acts: scale-up starts a supervised replica
  (``ReplicaSupervisor.scale_up``), scale-down retires the least-loaded
  one through the graceful-drain path (``scale_down`` → SIGTERM → drain
  → registry retraction) so zero in-flight queries drop.

**Pressure** folds the three load signals into one scalar per replica —
footprint pressure (``device_budget_fraction``), queue pressure
(admission queue depth over the replica's concurrency), and optionally
latency pressure (window p99 over ``serving.fleet.p99ObjectiveSeconds``)
— and averages across *healthy* replicas. DEGRADED slots and replicas
whose serve_stats series has gone stale past
``serving.stats.staleAfterSeconds`` are excluded from both the average
and the healthy count: a wedged replica must not dilute the fleet's
pressure reading, and a crash-looping slot is not capacity.

**Hysteresis** keeps the fleet from flapping: pressure must sit past a
watermark for N consecutive ticks (``scaleUp/DownStableTicks``) before
an action fires, an in-band reading resets both streaks, and per-
direction cooldowns (``scaleUp/DownCooldownSeconds``, measured from the
last action in *either* direction) space actions out. Targets clamp to
``serving.fleet.{min,max}Replicas``; a fleet below its floor scales up
regardless of pressure.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.serving import wire
from spark_rapids_tpu_torch.shuffle.transport import TransactionStatus
from spark_rapids_tpu_torch.utils import metrics as um


# ---- the pure decision core -------------------------------------------------

@dataclass(frozen=True)
class ReplicaSnapshot:
    """One replica's load as the controller sees it — built from a
    serve.health payload, or by hand in unit tests."""
    addr: str
    state: str                          # UP | DRAINING (server-reported)
    age_s: Optional[float]              # serve_stats staleness (None: new)
    queue_depth: int = 0
    budget_fraction: float = 0.0
    p99_wall_s: float = 0.0
    queries_open: int = 0

    @staticmethod
    def from_health(addr: str, payload: Dict[str, Any]) -> "ReplicaSnapshot":
        ss = payload.get("serve_stats") or {}
        now = ss.get("now") or {}
        return ReplicaSnapshot(
            addr=addr,
            state=str(payload.get("state", "UP")),
            age_s=ss.get("age_s"),
            queue_depth=int(now.get("admission_queue_depth", 0) or 0),
            budget_fraction=float(now.get("device_budget_fraction", 0.0)
                                  or 0.0),
            p99_wall_s=float(ss.get("p99_wall_s", 0.0) or 0.0),
            queries_open=int(payload.get("queries_open", 0) or 0))


@dataclass(frozen=True)
class ScalingPolicy:
    """The immutable knobs of the control loop (all from conf)."""
    min_replicas: int = 1
    max_replicas: int = 4
    up_watermark: float = 0.8
    down_watermark: float = 0.25
    up_stable_ticks: int = 2
    down_stable_ticks: int = 5
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0
    stale_after_s: float = 10.0
    queue_norm: int = 4                 # queue depth == concurrency → 1.0
    p99_objective_s: float = 0.0        # 0: latency component disabled

    @staticmethod
    def from_conf(conf) -> "ScalingPolicy":
        return ScalingPolicy(
            min_replicas=conf.get(cfg.SERVING_FLEET_MIN_REPLICAS),
            max_replicas=conf.get(cfg.SERVING_FLEET_MAX_REPLICAS),
            up_watermark=conf.get(cfg.SERVING_FLEET_SCALE_UP_WATERMARK),
            down_watermark=conf.get(cfg.SERVING_FLEET_SCALE_DOWN_WATERMARK),
            up_stable_ticks=conf.get(cfg.SERVING_FLEET_SCALE_UP_STABLE_TICKS),
            down_stable_ticks=conf.get(
                cfg.SERVING_FLEET_SCALE_DOWN_STABLE_TICKS),
            up_cooldown_s=conf.get(cfg.SERVING_FLEET_SCALE_UP_COOLDOWN),
            down_cooldown_s=conf.get(cfg.SERVING_FLEET_SCALE_DOWN_COOLDOWN),
            stale_after_s=conf.get(cfg.SERVING_STATS_STALE_AFTER),
            queue_norm=conf.get(cfg.SERVING_MAX_CONCURRENT),
            p99_objective_s=conf.get(cfg.SERVING_FLEET_P99_OBJECTIVE))


@dataclass
class ControllerState:
    """The loop's only mutable memory: hysteresis streaks + the cooldown
    clock. ``last_action_at`` starts at -inf so the first decision is
    never cooldown-suppressed."""
    up_streak: int = 0
    down_streak: int = 0
    last_action_at: float = field(default=float("-inf"))


@dataclass(frozen=True)
class Decision:
    """What one control tick concluded, with its inputs on record."""
    action: int                         # +1 scale up, -1 scale down, 0 hold
    pressure: Optional[float]           # None: no healthy signal this tick
    healthy: int
    reason: str


def replica_pressure(snap: ReplicaSnapshot, policy: ScalingPolicy) -> float:
    """One replica's load scalar: the HOTTEST of its signals (a replica
    whose queue is deep is saturated even with device budget to spare,
    and vice versa). Can exceed 1.0 — a queue past the concurrency bound
    reads as over-saturated, which is exactly right."""
    parts = [snap.budget_fraction,
             snap.queue_depth / max(1, policy.queue_norm)]
    if policy.p99_objective_s > 0:
        parts.append(snap.p99_wall_s / policy.p99_objective_s)
    return max(parts)


def healthy_snapshots(snaps: List[ReplicaSnapshot],
                      policy: ScalingPolicy) -> List[ReplicaSnapshot]:
    """Replicas the controller may trust and count as capacity: state UP
    (a DRAINING replica is already leaving) with a serve_stats series
    that hasn't flat-lined past the staleness bound. ``age_s`` of None
    means the replica just started and hasn't a prior sample — fresh,
    not stale."""
    return [s for s in snaps
            if s.state == "UP"
            and (s.age_s is None or s.age_s <= policy.stale_after_s)]


def decide(snaps: List[ReplicaSnapshot], active_count: int,
           state: ControllerState, policy: ScalingPolicy,
           now: float) -> Decision:
    """One pure control step. ``active_count`` is the supervisor's view
    of slots that are (or are coming back) up — BACKOFF counts, DEGRADED
    does not. Mutates ``state`` (streaks, cooldown clock) in place."""
    # floor/ceiling clamps outrank pressure: a fleet below its floor is
    # under-provisioned by definition (e.g. crash-loop breakers removed
    # slots), and one above its ceiling must shrink
    if active_count < policy.min_replicas:
        state.up_streak = state.down_streak = 0
        state.last_action_at = now
        return Decision(+1, None, len(healthy_snapshots(snaps, policy)),
                        f"below floor: {active_count} active < "
                        f"min {policy.min_replicas}")
    if active_count > policy.max_replicas:
        state.up_streak = state.down_streak = 0
        state.last_action_at = now
        return Decision(-1, None, len(healthy_snapshots(snaps, policy)),
                        f"above ceiling: {active_count} active > "
                        f"max {policy.max_replicas}")
    healthy = healthy_snapshots(snaps, policy)
    if not healthy:
        # every series is stale or draining: no trustworthy signal —
        # hold rather than flap on noise (the supervisor, not the
        # autoscaler, owns dead/wedged replicas)
        state.up_streak = state.down_streak = 0
        return Decision(0, None, 0, "no healthy signal: hold")
    pressure = round(sum(replica_pressure(s, policy)
                         for s in healthy) / len(healthy), 4)
    if pressure >= policy.up_watermark:
        state.up_streak += 1
        state.down_streak = 0
    elif pressure <= policy.down_watermark:
        state.down_streak += 1
        state.up_streak = 0
    else:
        # in-band: hysteresis resets — a single excursion must not be
        # remembered across an interleaved calm reading
        state.up_streak = state.down_streak = 0
        return Decision(0, pressure, len(healthy),
                        f"in band ({policy.down_watermark} < {pressure} "
                        f"< {policy.up_watermark})")
    since_action = now - state.last_action_at
    if state.up_streak >= policy.up_stable_ticks:
        if active_count >= policy.max_replicas:
            return Decision(0, pressure, len(healthy),
                            f"at ceiling {policy.max_replicas}: hold")
        if since_action < policy.up_cooldown_s:
            return Decision(0, pressure, len(healthy),
                            f"up cooldown ({since_action:.1f}s < "
                            f"{policy.up_cooldown_s}s)")
        state.up_streak = state.down_streak = 0
        state.last_action_at = now
        return Decision(+1, pressure, len(healthy),
                        f"pressure {pressure} >= {policy.up_watermark} "
                        f"for {policy.up_stable_ticks} ticks")
    if state.down_streak >= policy.down_stable_ticks:
        if active_count <= policy.min_replicas:
            return Decision(0, pressure, len(healthy),
                            f"at floor {policy.min_replicas}: hold")
        if since_action < policy.down_cooldown_s:
            return Decision(0, pressure, len(healthy),
                            f"down cooldown ({since_action:.1f}s < "
                            f"{policy.down_cooldown_s}s)")
        state.up_streak = state.down_streak = 0
        state.last_action_at = now
        return Decision(-1, pressure, len(healthy),
                        f"pressure {pressure} <= {policy.down_watermark} "
                        f"for {policy.down_stable_ticks} ticks")
    return Decision(0, pressure, len(healthy),
                    f"streak building (up {state.up_streak}/"
                    f"{policy.up_stable_ticks}, down {state.down_streak}/"
                    f"{policy.down_stable_ticks})")


def pick_scale_down_target(healthy: List[ReplicaSnapshot],
                           policy: ScalingPolicy) -> Optional[str]:
    """The replica to retire: the least-loaded healthy one (fewest open
    queries, then lowest pressure) — draining it strands the least work
    and finishes fastest."""
    if not healthy:
        return None
    return min(healthy, key=lambda s: (s.queries_open,
                                       replica_pressure(s, policy))).addr


# ---- the collection/actuation shell ----------------------------------------

class FleetController:
    """Periodic control loop binding the decision core to a supervised
    fleet: collect serve.health per replica, decide, actuate."""

    def __init__(self, conf, supervisor):
        self.conf = conf
        self.supervisor = supervisor
        self.policy = ScalingPolicy.from_conf(conf)
        self._interval = conf.get(cfg.SERVING_FLEET_CONTROL_INTERVAL)
        self._probe_timeout = conf.get(cfg.SERVING_HEALTH_PROBE_TIMEOUT)
        self._transport = None
        self._lock = threading.Lock()
        self.state = ControllerState()
        self.last_decision: Optional[Decision] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- collection --------------------------------------------------------
    def _ensure_transport(self):
        with self._lock:
            if self._transport is None:
                self._transport = wire.make_serving_transport(
                    "fleet-controller", self.conf, listen_port=0)
            return self._transport

    def _health(self, addr: str) -> Optional[Dict[str, Any]]:
        try:
            conn = self._ensure_transport().connect(addr)
            tx = conn.request(wire.REQ_HEALTH, b"", lambda t: None)
            tx.wait(self._probe_timeout)
            if tx.status is not TransactionStatus.SUCCESS:
                return None
            return json.loads(tx.response)
        except (OSError, TimeoutError, ValueError):
            # unreachable/garbled: the supervisor's liveness machinery
            # owns dead replicas; the controller just loses one sample
            return None

    def collect(self) -> List[ReplicaSnapshot]:
        snaps: List[ReplicaSnapshot] = []
        for addr in self.supervisor.addresses():
            payload = self._health(addr)
            if payload is not None:
                snaps.append(ReplicaSnapshot.from_health(addr, payload))
        return snaps

    # ---- actuation ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Decision:
        """One collect→decide→act pass; public so tests and CI drive the
        loop deterministically."""
        now = time.monotonic() if now is None else now
        snaps = self.collect()
        decision = decide(snaps, self.supervisor.active_count(),
                          self.state, self.policy, now)
        if decision.action > 0:
            self.supervisor.scale_up()
            um.SERVING_METRICS[um.SERVING_SCALE_UPS].add(1)
        elif decision.action < 0:
            target = pick_scale_down_target(
                healthy_snapshots(snaps, self.policy), self.policy)
            # scale-down goes through the supervisor's graceful path:
            # terminate == the SIGTERM drain contract, so every running
            # query finishes and the registry entry is retracted
            if self.supervisor.scale_down(target) is not None:
                um.SERVING_METRICS[um.SERVING_SCALE_DOWNS].add(1)
            else:
                decision = replace(decision, action=0,
                                   reason=decision.reason
                                   + " (no retirable replica)")
        self.last_decision = decision
        return decision

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="fleet-controller")
            self._thread.start()

    def _loop(self) -> None:
        # Event.wait is the bounded sleep (R010); collection/actuation IO
        # happens without the controller lock (R006)
        while not self._stop_event.wait(self._interval):
            self.tick()

    def stop(self) -> None:
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            transport, self._transport = self._transport, None
        if transport is not None:
            transport.shutdown()
