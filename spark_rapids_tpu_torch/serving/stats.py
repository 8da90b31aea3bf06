"""serve.stats: a rolling per-replica time-series of serving gauges.

Load-aware replica routing reads this feed: a router cannot send the
whale to the replica with free budget, or
route interactive queries away from a saturated replica, on the strength
of a point-in-time counter snapshot. ``ServeStatsWindow`` keeps a bounded
rolling window (``serving.stats.windowSeconds``) of:

- **query wall samples** — recorded at every terminal transition; p50/p99
  over the window is the replica's observed latency profile;
- **gauge samples** — device budget in use (footprint-admission charged
  bytes + the device store's resident bytes against the budget), admission
  queue depth, running/queued counts per tenant. A sample is appended at
  every query completion and on every ``serve.stats`` request, so the
  series is dense while traffic flows and costs nothing while idle.

The wire surface: ``QueryServiceClient.stats()`` returns the scheduler
snapshot plus this window under ``"serve_stats"`` — ``now`` (the freshest
sample), ``series`` (the rolling samples, oldest first), and the window's
p50/p99 wall. Everything is computed server-side; the client ships JSON.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.utils.metrics import percentile

#: hard bounds independent of the time window, so a burst cannot grow the
#: deques without limit between trims
_MAX_WALL_SAMPLES = 2048
_MAX_GAUGE_SAMPLES = 512


class ServeStatsWindow:
    """Rolling window of one replica's serving gauges + wall samples."""

    def __init__(self, window_s: float = 300.0):
        self.window_s = max(1.0, float(window_s))
        self._lock = threading.Lock()
        #: (monotonic_t, wall_s) of terminal queries
        self._walls: deque = deque(maxlen=_MAX_WALL_SAMPLES)
        #: gauge sample dicts (see _sample_locked)
        self._samples: deque = deque(maxlen=_MAX_GAUGE_SAMPLES)
        #: monotonic time of the newest appended sample — snapshot() stamps
        #: its age so consumers (the autoscaler above all) can tell a fresh
        #: series from one that flat-lined when the replica wedged
        self._last_sample_t: Optional[float] = None

    # ---- producers ---------------------------------------------------------
    def record_wall(self, wall_s: Optional[float]) -> None:
        if wall_s is None:
            return
        with self._lock:
            self._walls.append((time.monotonic(), float(wall_s)))

    def sample(self, scheduler) -> Dict[str, Any]:
        """Take one gauge sample from the live scheduler state, append it
        to the series, and return it."""
        gauges = self._gauges(scheduler)
        with self._lock:
            self._trim_locked()
            self._samples.append(gauges)
            self._last_sample_t = gauges["t"]
        return gauges

    def age_s(self) -> Optional[float]:
        """Seconds since the newest sample was appended; None before the
        first sample. This is the staleness signal: the periodic sampler
        tick keeps it near the tick interval on a healthy replica, so a
        large age means the sampler (and likely the replica) is wedged."""
        with self._lock:
            if self._last_sample_t is None:
                return None
            return max(0.0, time.monotonic() - self._last_sample_t)

    # ---- gauge collection --------------------------------------------------
    @staticmethod
    def _gauges(scheduler) -> Dict[str, Any]:
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        from spark_rapids_tpu_torch.plan.footprint import device_budget_estimate
        from spark_rapids_tpu_torch.serving.lifecycle import QueryState
        with scheduler._cv:
            queued_by_tenant = {t: len(q)
                                for t, q in scheduler._queues.items() if q}
            running_by_tenant: Dict[str, int] = {}
            for h in scheduler._handles:
                if h.state in (QueryState.ADMITTED, QueryState.RUNNING):
                    running_by_tenant[h.tenant] = \
                        running_by_tenant.get(h.tenant, 0) + 1
            active = scheduler._active
        admission = scheduler.admission.stats()
        budget = device_budget_estimate(scheduler.session.conf,
                                        scheduler.session.device)
        dm = DeviceManager.peek()
        store = dm.device_store if dm is not None else None
        resident = store.used_bytes if store is not None else 0
        charged = admission.get("charged_bytes", 0)
        in_use = max(charged, resident)
        return {
            "t": round(time.monotonic(), 3),
            #: UP | DRAINING — a draining replica keeps reporting a live
            #: series (its running queries still finish here) but routers
            #: must stop sending new submissions
            "state": ("DRAINING" if getattr(scheduler, "draining", False)
                      else "UP"),
            "device_budget_bytes": budget or 0,
            #: budget in use: the admission ledger's charged estimates or
            #: the store's actually-resident bytes, whichever is larger —
            #: charged covers admitted-but-not-yet-resident queries,
            #: resident covers cached/spill-tier occupancy admission never
            #: charged
            "device_budget_in_use": in_use,
            "device_budget_fraction": (round(in_use / budget, 4)
                                       if budget else 0.0),
            "admission_queue_depth": sum(queued_by_tenant.values()),
            "queued_by_tenant": queued_by_tenant,
            "running_by_tenant": running_by_tenant,
            "active_workers": active,
        }

    # ---- consumers ---------------------------------------------------------
    def _trim_locked(self) -> None:
        horizon = time.monotonic() - self.window_s
        while self._walls and self._walls[0][0] < horizon:
            self._walls.popleft()
        while self._samples and self._samples[0]["t"] < horizon:
            self._samples.popleft()

    def snapshot(self, scheduler) -> Dict[str, Any]:
        """The full serve.stats payload: one fresh sample + the rolling
        series + window latency percentiles. ``age_s`` is the staleness of
        the series BEFORE this call's inline sample — a health RPC always
        samples fresh on its way out, so the inline sample's own age says
        nothing about whether the background tick is alive; the pre-call
        age does."""
        pre_age = self.age_s()
        now = self.sample(scheduler)
        with self._lock:
            walls = sorted(w for _, w in self._walls)
            series = list(self._samples)
        return {
            "window_s": self.window_s,
            #: seconds the series had gone without a sample when this
            #: snapshot was requested (None: no sample ever) — the
            #: autoscaler treats ages past serving.stats.staleAfterSeconds
            #: as an unhealthy replica
            "age_s": (round(pre_age, 3) if pre_age is not None else None),
            "now": now,
            "series": series,
            "wall_samples": len(walls),
            "p50_wall_s": round(percentile(walls, 50.0), 6),
            "p99_wall_s": round(percentile(walls, 99.0), 6),
        }
