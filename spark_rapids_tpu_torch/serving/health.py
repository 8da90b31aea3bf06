"""Replica health: circuit breakers, liveness discovery, routing scores.

The client-side half of fleet resilience. The first routing client was a
bare round-robin over static addresses: a dead replica stayed in rotation
forever (every Nth submission failed), and there was no signal to send
the whale anywhere smarter than "next". This module supplies the three
pieces the router needs:

- **CircuitBreaker** — per-replica failure containment. CLOSED passes
  submissions; ``serving.failover.breakerFailureThreshold`` consecutive
  failures flip it OPEN (counted in ``serving.breaker_opens``): an OPEN
  replica receives ZERO submissions, only health probes on the
  deterministic exponential-backoff schedule (shuffle/retry.py — the
  same jittered schedule every retry layer in this engine uses). A due
  probe moves the breaker HALF_OPEN (one trial): probe success closes
  it, failure re-opens it with a deeper backoff.
- **ReplicaState** — one replica's routing record: address, breaker,
  the latest ``serve.health`` snapshot (the serve_stats
  time-series), its DRAINING flag, and which tables were successfully
  registered there (the deferred re-register ledger).
- **routing_score** — the load-aware routing policy's scalar: free
  device budget after footprint charges (the dominant term — the whale
  must land where it fits), penalized by queue depth + running count
  and by the replica's p99 wall over the stats window.

Liveness itself rides the shuffle registry-dir rendezvous
(``shuffle/tcp.py``): replicas publish ``<dir>/<executor_id>`` and
refresh its mtime as a heartbeat; ``scan_registry`` with the
``serving.health.livenessWindowSeconds`` window skips AND
garbage-collects entries whose heartbeat stopped (a SIGKILL'd replica
cannot retract its own file).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Set

from spark_rapids_tpu_torch.shuffle import retry
from spark_rapids_tpu_torch.utils import metrics as um

#: breaker states (strings so they serialize into stats snapshots as-is)
BREAKER_CLOSED = "CLOSED"
BREAKER_OPEN = "OPEN"
BREAKER_HALF_OPEN = "HALF_OPEN"


class CircuitBreaker:
    """Per-replica circuit breaker: consecutive-failure threshold ->
    OPEN with exponentially backed-off probes -> HALF_OPEN trial."""

    def __init__(self, threshold: int = 3, backoff_ms: float = 200.0,
                 seed: int = 0, key: str = "", trial_timeout_s: float = 30.0):
        self.threshold = max(1, int(threshold))
        self.backoff_ms = float(backoff_ms)
        self.seed = seed
        self.key = key
        #: how long one HALF_OPEN trial owns the probe slot before the
        #: breaker re-offers it (a prober that crashed without reporting
        #: must not wedge the breaker HALF_OPEN forever)
        self.trial_timeout_s = float(trial_timeout_s)
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self._failures = 0          # consecutive, reset by any success
        self._opens = 0             # lifetime opens: the backoff exponent
        self._probe_at = 0.0        # monotonic time the next probe is due
        self._trial_deadline = 0.0  # current HALF_OPEN trial's claim

    def allow_submit(self) -> bool:
        """Only a CLOSED breaker passes submissions — OPEN and HALF_OPEN
        replicas see health probes exclusively until one succeeds."""
        with self._lock:
            return self.state == BREAKER_CLOSED

    def probe_due(self, now: Optional[float] = None) -> bool:
        """True when an OPEN breaker's backoff has elapsed — the call
        moves it HALF_OPEN and the caller owns the ONE probe trial in
        flight. While HALF_OPEN, further callers are refused until the
        trial reports (or its claim times out: a prober that crashed
        without reporting must not wedge the breaker), so concurrent
        submissions cannot pile probes onto one dead replica."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                if now < self._trial_deadline:
                    return False        # a trial is in flight
                self._trial_deadline = now + self.trial_timeout_s
                return True
            if self.state == BREAKER_OPEN and now >= self._probe_at:
                self.state = BREAKER_HALF_OPEN
                self._trial_deadline = now + self.trial_timeout_s
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = BREAKER_CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == BREAKER_HALF_OPEN:
                self._reopen_locked()       # failed trial: deeper backoff
            elif (self.state == BREAKER_CLOSED
                  and self._failures >= self.threshold):
                um.SERVING_METRICS[um.SERVING_BREAKER_OPENS].add(1)
                self._reopen_locked()

    def _reopen_locked(self) -> None:
        self.state = BREAKER_OPEN
        delay_ms = retry.backoff_ms(self._opens, self.backoff_ms,
                                    self.seed, key=f"breaker:{self.key}")
        self._opens += 1
        self._probe_at = time.monotonic() + delay_ms / 1e3

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state, "failures": self._failures,
                    "opens": self._opens}


class ReplicaState:
    """One replica as the routing client sees it."""

    __slots__ = ("addr", "breaker", "stats", "draining", "last_probe",
                 "registered", "discovered", "incarnation")

    def __init__(self, addr: str, breaker: CircuitBreaker,
                 discovered: bool = False):
        self.addr = addr
        self.breaker = breaker
        #: latest serve.health ``serve_stats`` payload (None until probed)
        self.stats: Optional[Dict[str, Any]] = None
        self.draining = False
        self.last_probe = float("-inf")
        #: the replica PROCESS behind this address (its per-process
        #: transport executor id, carried in serve.health): when it
        #: changes, the address was taken over by a restarted process
        #: that has none of the old incarnation's temp views
        self.incarnation: Optional[str] = None
        #: table names successfully registered on THIS replica — the
        #: deferred re-register ledger: a replica that was down (or not
        #: yet discovered) during the broadcast gets the missing views
        #: replayed before the first submission routed to it
        self.registered: Set[str] = set()
        self.discovered = discovered

    @property
    def routable(self) -> bool:
        return self.breaker.allow_submit() and not self.draining


def routing_score(stats: Optional[Dict[str, Any]]) -> float:
    """Load-aware routing score over one replica's serve_stats snapshot
    (higher is better). Free device budget after footprint charges is
    the dominant term — a footprint-saturated replica scores near its
    floor while an idle one scores ~1.0 — with queue depth + running
    count and the window p99 wall as congestion penalties. A replica
    with no snapshot yet scores neutral (0.5): routable, but never
    preferred over a replica known to be free."""
    if not stats:
        return 0.5
    now = stats.get("now") or {}
    budget = now.get("device_budget_bytes") or 0
    in_use = now.get("device_budget_in_use") or 0
    free = 1.0 - min(1.0, in_use / budget) if budget else 0.5
    waiting = (now.get("admission_queue_depth") or 0) + sum(
        (now.get("running_by_tenant") or {}).values())
    p99 = stats.get("p99_wall_s") or 0.0
    return free - 0.5 * waiting - 0.05 * min(p99, 10.0)
