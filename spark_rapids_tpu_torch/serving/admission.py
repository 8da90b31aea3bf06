"""Footprint admission: admit RUNNING queries against the device budget.

``serving.maxConcurrentQueries`` bounds in-flight queries by COUNT — a
number with no relation to device memory. Theseus's argument (PAPERS.md) is
that an accelerated query platform must admit by data movement / memory:
every device operator declares a ``working_set_estimate`` and the
out-of-core layer honors the budget it is admitted under. This module
closes the loop:

- at worker pickup, the planned query's peak device working set
  (``plan/footprint.plan_working_set_estimate`` — the max over device
  operators) is charged against the device budget
  (``plan/footprint.device_budget_estimate`` on the session's device);
- a query whose estimate does not fit the FREE budget waits (bounded
  poll + its own cancel/deadline check) until running queries release
  their share — it never OOMs a running query;
- a query larger than the WHOLE budget can never fit; it is admitted
  under a **grace hint**, charged the out-of-core HEADROOM share of the
  budget (``memory.outOfCore.headroomFraction``) rather than its
  impossible estimate — the grace/spill tiers complete it by
  partitioning within that share ("fits or spills, always completes").
  Charging the headroom share instead of the full budget deliberately
  leaves the remaining fraction free, so small interactive queries
  still admit alongside a whale and reach the DEVICE semaphore — where
  the preemption governor can see them starve and make the whale yield
  (charging the whole budget would park them here, invisible to
  preemption, for the whale's entire runtime);
- estimates of None (no device operator declares one) admit freely, as
  before the footprint contract existed.

Every wait increments ``serving.admission_rejections_footprint`` once and
stamps the handle (``admission_footprint_wait_s``, ``footprint_est_bytes``,
``admission_grace_hint``), so admission decisions are visible in metrics.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from spark_rapids_tpu_torch.utils import metrics as um

_POLL_S = 0.05


class FootprintAdmission:
    """Device-budget ledger shared by one scheduler's workers."""

    def __init__(self, conf, device=None):
        from spark_rapids_tpu_torch import config as cfg
        self.enabled = conf.get(cfg.SERVING_ADMIT_FOOTPRINT)
        self._conf = conf
        #: the session's device: before the DeviceManager exists, the
        #: budget is derived from this device's memory
        self._device = device
        self._cv = threading.Condition()
        #: query_id -> charged bytes (min(estimate, budget))
        self._holds: Dict[int, int] = {}
        self._used = 0

    def _budget(self) -> Optional[int]:
        """Re-derived per admission: the DeviceManager is created lazily,
        and its configured budget supersedes the conf-derived estimate."""
        from spark_rapids_tpu_torch.plan.footprint import \
            device_budget_estimate
        return device_budget_estimate(self._conf, self._device)

    def try_admit(self, handle, estimate: Optional[int]) -> bool:
        """One non-blocking admission attempt: True charges ``estimate``
        to ``handle`` (or the query is exempt), False means it does not
        fit the free budget RIGHT NOW. The scheduler requeues a rejected
        handle instead of blocking — a worker parked inside admission
        would pin its slot and head-of-line-block small queries that
        would fit (the whole point of footprint admission)."""
        if not self.enabled or estimate is None or estimate <= 0:
            return True
        budget = self._budget()
        if not budget:
            return True
        from spark_rapids_tpu_torch import config as cfg
        handle.note_metric("footprint_est_bytes", int(estimate))
        grace = int(estimate) > budget
        if grace:
            # over-the-whole-budget whale: the OOC layer will partition
            # and spill within the headroom share it is admitted under,
            # so charge THAT — not the impossible estimate and not the
            # full budget (which would park interactive queries here,
            # invisible to the preemption governor, for the whale's
            # whole runtime)
            charged = max(1, int(budget
                                 * self._conf.get(cfg.OOC_HEADROOM)))
            handle.note_metric("admission_grace_hint", True)
        else:
            charged = int(estimate)
        with self._cv:
            if self._used > 0 and self._used + charged > budget:
                if handle._admission_rejected_at is None:
                    handle._admission_rejected_at = time.perf_counter()
                    um.SERVING_METRICS[
                        um.SERVING_ADMISSION_REJECTIONS].add(1)
                return False
            self._holds[handle.query_id] = charged
            self._used += charged
        if handle._admission_rejected_at is not None:
            handle.note_metric("admission_footprint_wait_s", round(
                time.perf_counter() - handle._admission_rejected_at, 6))
        return True

    def admit(self, handle, estimate: Optional[int]) -> None:
        """Blocking form of ``try_admit`` (bounded cancellable poll) for
        callers without a queue to return to; re-raises the handle's
        cancellation/deadline error without charging."""
        while not self.try_admit(handle, estimate):
            with self._cv:
                self._cv.wait(_POLL_S)
            handle.check_cancelled()

    def release(self, handle) -> None:
        with self._cv:
            charged = self._holds.pop(handle.query_id, 0)
            self._used -= charged
            if charged:
                self._cv.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"admitted": len(self._holds),
                    "charged_bytes": self._used}
