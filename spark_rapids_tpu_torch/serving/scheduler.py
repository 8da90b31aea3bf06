"""Session scheduler: N concurrent queries over a shared worker pool.

The admission story has two layers, both fair-share by tenant:

1. SCHEDULER admission — submitted queries wait in per-tenant FIFO queues;
   a shared pool of ``serving.maxConcurrentQueries`` workers picks the
   next query from the tenant with the lowest served/weight deficit
   (weighted deficit round-robin: a tenant with weight 3 is served three
   times as often as a tenant with weight 1, FIFO within each tenant).
   This bounds in-flight queries by conf, so one heavy tenant cannot
   occupy every worker.
2. DEVICE admission — each running query still takes the device-admission
   semaphore (memory/semaphore.py) for its action, with the SAME tenant
   weights, so HBM working sets are fair-shared too (the GpuSemaphore
   role, extended per Theseus's admission-controlled concurrency).

Per-query lifecycle, cancellation, deadlines and metric snapshots live on
the QueryHandle (lifecycle.py); the worker binds the handle thread-locally
so the program cache attributes hits/misses/compile time to it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.serving.admission import FootprintAdmission
from spark_rapids_tpu_torch.serving.lifecycle import (OverloadedError,
                                                QueryCancelledError,
                                                QueryHandle,
                                                QueryTimeoutError,
                                                ResultStream,
                                                SchedulerDrainingError,
                                                bind_query)
from spark_rapids_tpu_torch.serving.program_cache import (configure_from_conf,
                                                    plan_key)
from spark_rapids_tpu_torch.utils.errors import triage_boundary, wire_boundary
from spark_rapids_tpu_torch.utils.fair_share import (activation_reset, pick_tenant,
                                               weight_of)


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """'etl:3,adhoc:1' -> {'etl': 3.0, 'adhoc': 1.0}; malformed entries
    raise (a silently dropped weight would silently unbalance serving)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.rpartition(":")
        if not sep or not name.strip():
            raise ValueError(
                f"serving.tenantWeights entry {part!r} is not tenant:weight")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"serving.tenantWeights entry {part!r}: weight {w!r} is "
                f"not a number") from None
        if weight <= 0:
            raise ValueError(
                f"serving.tenantWeights: weight for {name!r} must be > 0")
        out[name.strip()] = weight
    return out


#: terminal handles kept for introspection; older ones are pruned at
#: submit so a long-running server's handle list (each holding its result
#: table) cannot grow without bound — callers keep their own references
_HANDLE_HISTORY = 4096


class SessionScheduler:
    """Fair-share scheduler over one TpuSession (created lazily by
    ``session.scheduler`` / ``session.submit``)."""

    def __init__(self, session):
        self.session = session
        conf = session.conf
        self.max_concurrent = conf.get(cfg.SERVING_MAX_CONCURRENT)
        self.default_timeout = conf.get(cfg.SERVING_QUERY_TIMEOUT) or None
        self._weights = parse_tenant_weights(
            conf.get(cfg.SERVING_TENANT_WEIGHTS))
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._served: Dict[str, float] = {}
        self._handles: List[QueryHandle] = []
        #: terminal states of handles pruned from the history, so stats()
        #: stays truthful after pruning
        self._pruned_states: Dict[str, int] = {}
        self._active = 0
        self._shutdown = False
        #: graceful drain: set by start_draining() — new submissions are
        #: rejected with the retryable SchedulerDrainingError while
        #: running/queued queries finish normally; serve_stats reports
        #: the state so routers stop sending traffic here
        self._draining = False
        self._workers: List[threading.Thread] = []
        self.program_cache = configure_from_conf(conf)
        #: footprint admission ledger (serving/admission.py): RUNNING
        #: queries are charged their working_set_estimate against the
        #: device budget instead of being bounded by count alone
        self.admission = FootprintAdmission(conf, session.device)
        #: rolling serve.stats window (serving/stats.py): per-replica
        #: gauges + p50/p99 query wall over serving.stats.windowSeconds —
        #: the feed load-aware replica routing consumes
        from spark_rapids_tpu_torch.serving.stats import ServeStatsWindow
        self.serve_stats = ServeStatsWindow(
            conf.get(cfg.SERVING_STATS_WINDOW))
        self._preempt_enabled = conf.get(cfg.SERVING_PREEMPT_ENABLED)
        self._preempt_starve_s = (
            conf.get(cfg.SERVING_PREEMPT_STARVATION_MS) / 1e3)
        self._preempt_park = conf.get(cfg.SERVING_PREEMPT_PARK)
        #: front-door overload shed: one tenant's queue never grows past
        #: this bound — the submission is rejected with the RETRYABLE
        #: OverloadedError instead (0 disables)
        self._max_queued_per_tenant = conf.get(
            cfg.SERVING_MAX_QUEUED_PER_TENANT)
        self._retry_after_base = conf.get(cfg.SERVING_OVERLOAD_RETRY_AFTER)
        #: background gauge-sampler tick (started lazily beside the worker
        #: pool): keeps the serve.stats series fresh on an idle replica so
        #: snapshot age reads sampler liveness, not traffic
        self._sample_interval = conf.get(cfg.SERVING_STATS_SAMPLE_INTERVAL)
        self._sampler_stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        self._push_weights_to_semaphore()

    # ---- configuration -----------------------------------------------------
    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._cv:
            self._weights[tenant] = float(weight)
            self._cv.notify_all()
        self._push_weights_to_semaphore()

    def _push_weights_to_semaphore(self) -> None:
        """Mirror the scheduler's weights into the device-admission
        semaphore so both layers share one fairness policy. The weight
        table is snapshotted under the scheduler cv: set_tenant_weight
        mutates it concurrently and a dict resized mid-iteration raises
        (R012)."""
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        dm = DeviceManager.peek()
        if dm is not None:
            with self._cv:
                weights = dict(self._weights)
            for tenant, w in weights.items():
                dm.semaphore.set_tenant_weight(tenant, w)

    def _weight(self, tenant: str) -> float:
        return weight_of(self._weights, tenant)

    # ---- submission --------------------------------------------------------
    def submit(self, query: Any, tenant: str = "default",
               timeout: Optional[float] = None,
               label: Optional[str] = None,
               stream: Optional[ResultStream] = None) -> QueryHandle:
        """Enqueue a DataFrame or SQL string; returns immediately with the
        query's handle. Planning and execution happen on a worker, so a
        malformed query FAILS its handle instead of raising here.
        ``stream``, when given, receives each result batch as its download
        resolves — before the final batch exists (the wire layer's
        streaming-partial-results path)."""
        handle = QueryHandle(query, tenant=tenant,
                             timeout=(timeout if timeout is not None
                                      else self.default_timeout),
                             label=label, stream=stream)
        handle.preemptible = self._preempt_enabled
        handle.preempt_starvation_s = self._preempt_starve_s
        handle.preempt_park_spillable = self._preempt_park
        shed_depth = None
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            if self._draining:
                raise SchedulerDrainingError(
                    "scheduler is draining: running queries finish, new "
                    "submissions must route to another replica")
            q = self._queues.get(tenant)
            if (self._max_queued_per_tenant
                    and q is not None
                    and len(q) >= self._max_queued_per_tenant):
                # front-door shed: the bound holds BEFORE the handle would
                # queue, so admitted/running queries are untouched and the
                # scheduler's memory stays bounded under a flooding tenant
                shed_depth = len(q)
            if shed_depth is None:
                if not q:
                    # deficit-round-robin activation reset (utils/
                    # fair_share.py): a late joiner cannot monopolize the
                    # workers, and a returning tenant is not starved by
                    # its own history
                    activation_reset(tenant,
                                     (t for t, w in self._queues.items()
                                      if w),
                                     self._served, self._weights)
                self._queues.setdefault(tenant, deque()).append(handle)
                self._handles.append(handle)
                if len(self._handles) > _HANDLE_HISTORY:
                    keep = []
                    excess = len(self._handles) - _HANDLE_HISTORY
                    for h in self._handles:
                        if excess > 0 and h.state.is_terminal:
                            self._pruned_states[h.state.value] = \
                                self._pruned_states.get(h.state.value, 0) + 1
                            excess -= 1
                        else:
                            keep.append(h)
                    self._handles = keep
                self._ensure_workers_locked()
            self._ensure_sampler_locked()
            self._cv.notify_all()
        if shed_depth is not None:
            from spark_rapids_tpu_torch.utils import metrics as um
            um.SERVING_METRICS[um.SERVING_SHEDS].add(1)
            raise OverloadedError(
                f"tenant {tenant!r} queue at its bound "
                f"({shed_depth}/{self._max_queued_per_tenant}): submission "
                f"shed, retry after the hint",
                retry_after_s=self.shed_retry_after(shed_depth))
        return handle

    def shed_retry_after(self, depth: int) -> float:
        """Retry-after hint for a shed submission: the base conf hint
        scaled with how deep the tenant's queue is relative to the worker
        pool — a deeper backlog drains slower, so the hint grows with it
        (deterministic: no jitter here, the CLIENT adds its seeded
        backoff)."""
        scale = 1.0 + depth / max(1, self.max_concurrent)
        return round(self._retry_after_base * scale, 4)

    def _ensure_workers_locked(self) -> None:
        while len(self._workers) < self.max_concurrent:
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"serving-worker-{len(self._workers)}")
            self._workers.append(t)
            t.start()

    def _ensure_sampler_locked(self) -> None:
        """Start the periodic gauge-sampler daemon (once; caller holds
        the cv). Before this tick existed, gauges were sampled only at
        terminal queries and stats requests — an idle or wedged replica
        reported a stale series exactly when the autoscaler most needed
        truth. The tick keeps the series (and its age_s stamp) honest."""
        if (self._sampler is not None or self._shutdown
                or not self._sample_interval):
            return
        t = threading.Thread(target=self._sampler_loop, daemon=True,
                             name="serving-stats-sampler")
        self._sampler = t
        t.start()

    def start_stats_sampler(self) -> None:
        """Public start hook (the wire server calls it at startup so a
        replica reports a fresh series before its first query)."""
        with self._cv:
            self._ensure_sampler_locked()

    def _sampler_loop(self) -> None:
        # Event.wait is the bounded sleep (R010); no scheduler lock is
        # held anywhere in the loop — sample() takes the cv only inside
        # its gauge read (R006)
        while not self._sampler_stop.wait(self._sample_interval):
            self.serve_stats.sample(self)

    # ---- fair-share pick ---------------------------------------------------
    def _next_locked(self) -> Optional[QueryHandle]:
        import time as _time
        now = _time.monotonic()
        # admission-requeued heads sit out their deferral (the worker
        # pool's 0.2 s cv poll re-checks), so a budget-blocked whale
        # cannot head-of-line-block tenants whose queries would fit
        tenant = pick_tenant((t for t, q in self._queues.items()
                              if q and q[0].admit_ready(now)),
                             self._served, self._weights)
        if tenant is None:
            return None
        self._served[tenant] = self._served.get(tenant, 0.0) + 1.0
        return self._queues[tenant].popleft()

    # ---- the worker pool ---------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                handle = self._next_locked()
                while handle is None and not self._shutdown:
                    self._cv.wait(timeout=0.2)
                    handle = self._next_locked()
                if handle is None:      # shutdown with an empty queue
                    return
                self._active += 1
            try:
                self._run_handle(handle)
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def _run_handle(self, handle: QueryHandle) -> None:
        import contextlib
        from spark_rapids_tpu_torch.utils import tracing as _tracing
        # trace the WHOLE handle run (lifecycle transitions, planning,
        # admission) — the action driver's own activation nests inside
        trace_scope = (_tracing.TRACER.activate()
                       if self.session.conf.get(cfg.TRACE_ENABLED)
                       else contextlib.nullcontext())
        try:
            with trace_scope:
                self._run_handle_traced(handle)
        finally:
            # EVERY terminal path — completion, failure, queued-cancel —
            # feeds the serve.stats latency window and takes a gauge
            # sample, so a replica draining cancellations still reports a
            # live series to the router
            self.serve_stats.record_wall(handle.metric("wall_s"))
            self.serve_stats.sample(self)

    # the ladder's cancellation sink AND the serving-wire serialization
    # boundary: exceptions caught here become the handle's terminal state,
    # which the server ships to clients via the utils/errors.py codec —
    # R014 checks arriving types are classified, R015 that they survive
    # the wire
    @triage_boundary
    @wire_boundary
    def _run_handle_traced(self, handle: QueryHandle) -> None:
        if handle.cancel_requested:     # cancelled while QUEUED
            handle.mark_admitted()
            handle.finish_cancelled()
            return
        handle.mark_admitted()
        with self._cv:
            has_weights = bool(self._weights)
        if has_weights:
            # the DeviceManager is created lazily by the first action, so
            # weights pushed at scheduler construction may have found no
            # semaphore yet — re-mirror them on the running path (cheap,
            # idempotent) so device admission is weighted from query one
            from spark_rapids_tpu_torch.memory.device_manager import \
                DeviceManager
            DeviceManager.initialize(self.session.conf, self.session.device)
            self._push_weights_to_semaphore()
        try:
            with bind_query(handle):
                handle.check_cancelled()
                if handle._planned is None:
                    df = self._as_dataframe(handle._work)
                    final = df.physical_plan()
                    handle.note_metric("plan_key",
                                       plan_key(final, self.session.conf))
                    from spark_rapids_tpu_torch.plan.footprint import \
                        plan_working_set_estimate
                    handle._planned = (df, final,
                                       plan_working_set_estimate(final))
                df, final, estimate = handle._planned
                # footprint admission: charge the plan's predicted peak
                # device working set against the budget BEFORE running —
                # a query that does not fit is REQUEUED (plan cached on
                # the handle) so this worker stays free for queries that
                # do fit, instead of OOMing running queries or pinning
                # the slot while it waits
                if not self.admission.try_admit(handle, estimate):
                    if self._requeue_for_admission(handle):
                        return
                    raise QueryCancelledError(
                        f"{handle.label} (id {handle.query_id}) "
                        f"cancelled at shutdown")
                try:
                    handle._planned = None
                    handle.mark_running()
                    result = df._collect(query=handle, final=final)
                    if self.session.conf.get(cfg.TRACE_ENABLED):
                        # render EXPLAIN ANALYZE now: _finish drops the
                        # plan reference (bounded handle memory), so the
                        # text is the surviving record
                        handle._analyze_text = (
                            f"== Physical plan with observed stats "
                            f"(query {handle.query_id}, wall "
                            f"{time.perf_counter() - handle.submitted_at:.3f}"
                            f"s) ==\n"
                            + final.tree_string(analyze=True))
                finally:
                    self.admission.release(handle)
            handle.finish_ok(result)
        except QueryCancelledError as e:
            handle.finish_cancelled(e)
        except QueryTimeoutError as e:
            handle.finish_failed(e)
        except BaseException as e:      # noqa: BLE001 - surfaces in result()
            handle.finish_failed(e)

    def _requeue_for_admission(self, handle: QueryHandle) -> bool:
        """Put a budget-rejected handle back at its tenant's HEAD (FIFO
        preserved) with a short deferral before the next pick. False when
        the scheduler is shutting down — the caller cancels instead."""
        import time as _time
        with self._cv:
            if self._shutdown:
                return False
            handle._admit_not_before = _time.monotonic() + 0.05
            self._queues.setdefault(handle.tenant,
                                    deque()).appendleft(handle)
            self._cv.notify_all()
            return True

    def _as_dataframe(self, work):
        if isinstance(work, str):
            return self.session.sql(work)
        if hasattr(work, "_collect"):
            return work
        raise TypeError(
            f"submit() takes a DataFrame or a SQL string, got {type(work)}")

    # ---- introspection / lifecycle ----------------------------------------
    def handles(self) -> List[QueryHandle]:
        with self._cv:
            return list(self._handles)

    def start_draining(self) -> None:
        """Flip the scheduler to DRAINING: every later submit() raises
        the retryable SchedulerDrainingError while queued and running
        queries finish normally — pair with drain() to wait them out.
        One-way by design: a draining replica is on its way out."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted query reaches a terminal state.
        ``timeout=0`` is a non-blocking poll."""
        import time as _time
        deadline = (_time.perf_counter() + timeout
                    if timeout is not None else None)
        for h in self.handles():
            left = (None if deadline is None
                    else max(0.0, deadline - _time.perf_counter()))
            if not h.wait(left):
                return False
        return True

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            states: Dict[str, int] = dict(self._pruned_states)
            for h in self._handles:
                states[h.state.value] = states.get(h.state.value, 0) + 1
            queued = sum(len(q) for q in self._queues.values())
            out = {"submitted": (len(self._handles)
                                 + sum(self._pruned_states.values())),
                   "queued": queued,
                   "active": self._active, "states": states,
                   "served_by_tenant": dict(self._served),
                   "weights": dict(self._weights)}
        out["program_cache"] = self.program_cache.stats()
        return out

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work; cancel queued queries; optionally wait for
        running ones (cancellation stays cooperative — running queries
        finish or observe their cancel flag at the next checkpoint)."""
        self._sampler_stop.set()
        with self._cv:
            self._shutdown = True
            queued = [h for q in self._queues.values() for h in q]
            for q in self._queues.values():
                q.clear()
            # snapshot under the cv: a submit racing shutdown may still
            # be appending to the worker list (R012)
            workers = list(self._workers)
            self._cv.notify_all()
        for h in queued:
            h.cancel()
            h.finish_cancelled()
        if wait:
            for t in workers:
                t.join(timeout)
