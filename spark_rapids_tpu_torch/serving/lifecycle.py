"""Per-query lifecycle: handle, states, cancellation, deadlines, metrics.

A ``QueryHandle`` is the server-side identity of one submitted query — the
role Spark's jobGroup/SQLExecution id plays for a statement, extended with
the pieces an inference-serving stack needs:

- a state machine QUEUED -> ADMITTED -> RUNNING -> {DONE, FAILED,
  CANCELLED} with monotonic transition timestamps;
- COOPERATIVE cancellation and deadlines: ``cancel()`` only sets a flag;
  the running query observes it at exec boundaries (ExecContext.
  check_cancelled), in the pipeline producer, and while blocked on
  device-semaphore admission, then unwinds through the normal finally
  chain — so a cancelled query releases its semaphore hold and catalog
  buffers exactly like a failed one;
- per-query metric snapshots (queue wait, admission wait, compile time,
  program-cache hits/misses, transfer deltas, rows) replacing the racy
  process-global ``session.last_metrics`` as the source of truth; the
  global survives as a last-action alias.

``current_query()`` is the thread-scoped attribution point: the scheduler
worker (and any producer thread an exec spawns on the query's behalf)
binds the handle so the program cache can attribute hits/misses/compile
time without threading the handle through every call signature.
"""
from __future__ import annotations

import contextlib
import enum
import itertools
import threading
import time
from typing import Any, Dict, Optional

from spark_rapids_tpu_torch.utils import tracing as _tracing


class QueryState(enum.Enum):
    QUEUED = "QUEUED"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    @property
    def is_terminal(self) -> bool:
        return self in (QueryState.DONE, QueryState.FAILED,
                        QueryState.CANCELLED)


class QueryCancelledError(RuntimeError):
    """Raised inside a running query at the next cooperative checkpoint
    after ``cancel()``; surfaces from ``result()`` as the terminal error."""


class QueryTimeoutError(RuntimeError):
    """Raised at a cooperative checkpoint once the query's deadline passed
    (conf ``serving.queryTimeoutSeconds`` or ``submit(timeout=...)``)."""


class SchedulerDrainingError(RuntimeError):
    """Submission rejected because the scheduler/replica is DRAINING.

    This is a RETRYABLE REDIRECT, not a failure: running queries finish
    and streams flush, but no new work is accepted. The wire layer
    carries the type name to the client, which transparently reroutes
    the submission to another replica (the graceful-drain contract —
    zero caller-visible errors during a drain)."""


class OverloadedError(RuntimeError):
    """Submission shed at the front door: the tenant's scheduler queue is
    at its bound (``serving.maxQueuedPerTenant``) — the replica refuses
    to queue more rather than grow without limit. RETRYABLE by taxonomy;
    ``retry_after_s`` is the server's hint for when capacity is likely
    back (scaled with queue depth), which the routing client honors on
    its deterministic backoff before retrying the rotation. Load sheds
    BEFORE it queues, never mid-query: admitted queries are unaffected."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s or 0.0)


class QuotaExceededError(RuntimeError):
    """Submission rejected by the per-client concurrent-query quota
    (``serving.quota.maxConcurrentPerClient``): this wire peer already
    has its full allowance of open queries on the replica. RETRYABLE —
    the client's own queries finishing is what frees quota — but NOT
    reroutable: the quota is per client, so the client surfaces it to
    the caller (after honoring ``retry_after_s``) instead of shopping
    the submission to a peer replica."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s or 0.0)


_QUERY_IDS = itertools.count(1)


class ResultStream:
    """Bounded FIFO of streamed result batches between the scheduler
    worker (producer: ``QueryHandle.emit_batch``) and a consumer — the
    wire layer's serve.next handler, or any in-process subscriber.

    Bounded buffering, never an unbounded queue: a full stream
    backpressures the producer at its next batch boundary (bounded poll +
    the producer query's own cancel check, the R010 idiom). A consumer
    that goes away calls ``abandon()``; the producer then drops batches
    instead of blocking on a reader that will never come back."""

    def __init__(self, depth: int = 4):
        self.depth = max(1, depth)
        self._cv = threading.Condition()
        self._q: list = []
        self._state = "open"            # open | finished | failed
        self._error: Optional[BaseException] = None
        self._abandoned = False

    def put(self, table, cancel_check=None) -> bool:
        """Producer side: enqueue one result batch; blocks (bounded poll)
        while the stream is full. Returns False when the consumer
        abandoned the stream (the batch is dropped)."""
        with self._cv:
            while len(self._q) >= self.depth and not self._abandoned:
                self._cv.wait(0.05)
                if cancel_check is not None:
                    cancel_check()
            if self._abandoned:
                return False
            self._q.append(table)
            self._cv.notify_all()
            return True

    def finish(self) -> None:
        with self._cv:
            if self._state == "open":
                self._state = "finished"
            self._cv.notify_all()

    def fail(self, error: BaseException) -> None:
        with self._cv:
            if self._state == "open":
                self._state = "failed"
                self._error = error
            self._cv.notify_all()

    def abandon(self) -> None:
        """Consumer side: stop consuming; pending batches drop and the
        producer never blocks on this stream again."""
        with self._cv:
            self._abandoned = True
            self._q.clear()
            self._cv.notify_all()

    def next(self, timeout: float):
        """Consumer side: ``("batch", table)`` when one is ready within
        ``timeout`` seconds, ``("done", None)`` / ``("error", exc)`` once
        drained and terminal, else ``("wait", None)`` — the caller
        re-polls (a wire handler answers WAIT and frees its thread)."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cv:
            while True:
                if self._q:
                    batch = self._q.pop(0)
                    self._cv.notify_all()
                    return ("batch", batch)
                if self._state == "finished":
                    return ("done", None)
                if self._state == "failed":
                    return ("error", self._error)
                left = deadline - time.monotonic()
                if left <= 0:
                    return ("wait", None)
                self._cv.wait(left)

#: thread-scoped current query for metric attribution (a thread-local, not
#: a contextvar: exec producer threads rebind explicitly from ctx.query —
#: implicit contextvar inheritance does not cross threading.Thread anyway)
_TLS = threading.local()


def current_query() -> Optional["QueryHandle"]:
    return getattr(_TLS, "query", None)


@contextlib.contextmanager
def bind_query(handle: Optional["QueryHandle"]):
    """Bind ``handle`` as the thread's current query for the scope."""
    prev = getattr(_TLS, "query", None)
    _TLS.query = handle
    try:
        yield handle
    finally:
        _TLS.query = prev


class QueryHandle:
    """One submitted query: state, cancellation, deadline, metrics, result."""

    def __init__(self, query: Any, tenant: str = "default",
                 timeout: Optional[float] = None,
                 label: Optional[str] = None,
                 stream: Optional[ResultStream] = None):
        self.query_id = next(_QUERY_IDS)
        self.tenant = tenant
        self.label = label or f"query-{self.query_id}"
        #: optional streaming sink: each result batch is pushed here as its
        #: async D2H download resolves — BEFORE the final batch exists
        #: (the wire layer's partial-results path); collect() semantics are
        #: unchanged, the handle still carries the assembled result
        self.stream = stream
        #: batch-granularity preemption (scheduler-set from serving.
        #: preemption.* conf): when True, check_preempt yields the device
        #: permit to starved tenants at exec-boundary checkpoints
        self.preemptible = False
        self.preempt_starvation_s = 0.05
        self.preempt_park_spillable = True
        self._next_preempt_check = 0.0
        #: footprint-admission state (serving/admission.py + scheduler):
        #: the planned (df, final, estimate) cached across an admission
        #: requeue, the earliest re-pick time, and the first-rejection
        #: timestamp the admission wait metric is measured from
        self._planned = None
        self._admit_not_before = 0.0
        self._admission_rejected_at: Optional[float] = None
        #: the submitted work: a DataFrame or a SQL string (planned lazily
        #: in the worker so a malformed query FAILS its handle instead of
        #: raising in submit())
        self._work = query
        self._lock = threading.Lock()
        self._done_evt = threading.Event()
        self._cancel_evt = threading.Event()
        self.state = QueryState.QUEUED
        self.submitted_at = time.perf_counter()
        self.deadline = (self.submitted_at + timeout
                         if timeout and timeout > 0 else None)
        self._result = None
        self._error: Optional[BaseException] = None
        #: per-query metric snapshot; keys documented in docs/serving.md
        self.metrics: Dict[str, Any] = {
            "tenant": tenant,
            "queue_wait_s": None,
            "admission_wait_s": 0.0,
            "compile_s": 0.0,
            "program_cache": {"hits": 0, "misses": 0, "disk_hits": 0},
            "rows": None,
            "wall_s": None,
            #: streaming / preemption / admission story of THIS query
            "stream_batches": 0,
            "first_batch_s": None,
            "preemptions": 0,
            "preempt_wait_s": 0.0,
            "footprint_est_bytes": None,
            "admission_footprint_wait_s": 0.0,
            "admission_grace_hint": False,
            #: THIS query's grace-recursion high-water mark (per-handle
            #: attribution — exact under concurrent out-of-core queries,
            #: unlike the process-global lifetime maximum)
            "recursion_depth_peak": 0,
            #: THIS query's adaptive-rewrite decisions, accumulated across
            #: its actions (per-handle attribution of the adaptive.* deltas
            #: record_exec_metrics receives; utils/metrics.py
            #: ADAPTIVE_METRIC_NAMES)
            "adaptive": {},
        }
        #: EXPLAIN ANALYZE text rendered at completion when the query ran
        #: under trace.enabled (the plan itself is dropped at _finish to
        #: bound handle memory, so the rendering is captured eagerly)
        self._analyze_text: Optional[str] = None
        #: per-operator + transfer snapshot of the query's action(s); the
        #: per-handle replacement for session.last_metrics
        self.exec_metrics: Dict[str, Dict] = {}

    def admit_ready(self, now: float) -> bool:
        """Eligible for worker pickup: past any admission-requeue
        deferral (monotonic clock), or cancelled — a cancelled handle
        must be picked promptly so its terminal transition runs."""
        return self._cancel_evt.is_set() or now >= self._admit_not_before

    # ---- cooperative cancellation / deadline -------------------------------
    def cancel(self) -> bool:
        """Request cancellation. Returns True when the request could still
        take effect (query not already terminal). A QUEUED query is
        finished immediately by the scheduler at dequeue; a RUNNING one
        unwinds at its next checkpoint."""
        with self._lock:
            if self.state.is_terminal:
                return False
        self._cancel_evt.set()
        return True

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_evt.is_set()

    def check_cancelled(self) -> None:
        """The cooperative checkpoint: raises when cancellation was
        requested or the deadline passed. Called at exec boundaries
        (ExecContext.check_cancelled), in the pipeline producer, and while
        waiting on device-semaphore admission."""
        if self._cancel_evt.is_set():
            raise QueryCancelledError(
                f"{self.label} (id {self.query_id}) cancelled")
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise QueryTimeoutError(
                f"{self.label} (id {self.query_id}) exceeded its deadline")

    # ---- streaming partial results -----------------------------------------
    def emit_batch(self, table) -> None:
        """One result batch materialized (its async D2H resolved): record
        the streaming metrics and, when a ResultStream is attached, push it
        to the consumer — before the remaining batches exist. Called by the
        action driver (api/dataframe._run_partitions) per result batch."""
        with self._lock:
            self.metrics["stream_batches"] += 1
            if self.metrics["first_batch_s"] is None:
                self.metrics["first_batch_s"] = round(
                    time.perf_counter() - self.submitted_at, 6)
        if self.stream is not None:
            self.stream.put(table, cancel_check=self.check_cancelled)

    # ---- batch-granularity preemption --------------------------------------
    def check_preempt(self, ctx) -> None:
        """Preemption point, called from ExecContext.check_cancelled at
        exec boundaries: when another tenant's admission waiter has starved
        past the threshold, yield the device permit — optionally parking
        spillable device state down the grace/spill tiers first — and
        re-acquire under fair share. Only the thread OWNING the task's
        semaphore hold may yield it (producer threads share the hold and
        must not pull it out from under the consumer)."""
        if not self.preemptible or ctx is None:
            return
        if threading.get_ident() != ctx.task_id:
            return
        dm = ctx.device_manager
        if dm is None:
            return
        now = time.monotonic()
        if now < self._next_preempt_check:   # cheap rate limit per batch
            return
        self._next_preempt_check = now + 0.01
        sem = dm.semaphore
        if not sem.has_starved_waiter(exclude_tenant=self.tenant,
                                      min_wait_s=self.preempt_starvation_s):
            return
        # only an actual permit HOLDER parks and yields: a query passing
        # this checkpoint without a hold (CPU-fallback section, between
        # scoped holds) has nothing to give the starved tenant and must
        # not thrash the holder's device state on its behalf
        if not sem.holds_permit(ctx.task_id):
            return
        from spark_rapids_tpu_torch.utils import metrics as um
        if self.preempt_park_spillable:
            store = dm.device_store
            if store is not None and store.budget_bytes:
                # shed the device tier down to the out-of-core HEADROOM
                # watermark so the admitted tenant has HBM room: the
                # overage is, by the store's spill priorities, this
                # query's grace partitions — the store is shared and
                # ownership-blind, but eviction is coldest-first, so
                # another tenant's hot buffers stay put; anything parked
                # re-admits on its next access
                from spark_rapids_tpu_torch import config as _cfg
                headroom = ctx.conf.get(_cfg.OOC_HEADROOM)
                store.spill_to_size(int(store.budget_bytes * headroom))
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        if not sem.yield_to_waiters(task_id=ctx.task_id, tenant=self.tenant,
                                    cancel_check=self.check_cancelled):
            return
        waited = time.perf_counter() - t0
        _tracing.record("serving.preempt_yield", "serving", t0_ns,
                        time.perf_counter_ns() - t0_ns,
                        {"tenant": self.tenant}, query_id=self.query_id)
        um.SERVING_METRICS[um.SERVING_PREEMPTIONS].add(1)
        with self._lock:
            self.metrics["preemptions"] += 1
            self.metrics["preempt_wait_s"] = round(
                self.metrics["preempt_wait_s"] + waited, 6)

    # ---- state transitions (scheduler-driven) ------------------------------
    def _transition(self, state: QueryState) -> None:
        with self._lock:
            self.state = state
            self.metrics[f"t_{state.value.lower()}"] = (
                time.perf_counter() - self.submitted_at)
        _tracing.record(f"serving.state.{state.value}", "serving",
                        time.perf_counter_ns(), 0,
                        {"tenant": self.tenant, "label": self.label},
                        query_id=self.query_id)

    def mark_admitted(self) -> None:
        self._transition(QueryState.ADMITTED)
        self.note_metric("queue_wait_s", round(
            time.perf_counter() - self.submitted_at, 6))

    def mark_running(self) -> None:
        self._transition(QueryState.RUNNING)

    def _finish(self, state: QueryState,
                error: Optional[BaseException] = None,
                result=None) -> None:
        with self._lock:
            if self.state.is_terminal:
                return
            self.state = state
            self._error = error
            self._result = result
            self._work = None       # free the plan; the result is kept
            wall = self.metrics["wall_s"] = round(
                time.perf_counter() - self.submitted_at, 6)
            if result is not None and hasattr(result, "num_rows"):
                self.metrics["rows"] = result.num_rows
        self._done_evt.set()
        _tracing.record(f"serving.state.{state.value}", "serving",
                        time.perf_counter_ns(), 0,
                        {"tenant": self.tenant, "wall_s": wall},
                        query_id=self.query_id)
        # terminal state drains to the streaming consumer on EVERY path —
        # worker completion, queued-cancel, scheduler shutdown — so a wire
        # client always observes DONE or the error, never a silent stall
        if self.stream is not None:
            if state is QueryState.DONE:
                self.stream.finish()
            else:
                self.stream.fail(self._error)

    def finish_ok(self, result) -> None:
        self._finish(QueryState.DONE, result=result)

    def finish_failed(self, error: BaseException) -> None:
        self._finish(QueryState.FAILED, error=error)

    def finish_cancelled(self, error: Optional[BaseException] = None) -> None:
        self._finish(QueryState.CANCELLED,
                     error=error or QueryCancelledError(
                         f"{self.label} (id {self.query_id}) cancelled"))

    # ---- observability surfaces --------------------------------------------
    def note_recursion_depth(self, depth: int) -> None:
        """Grace layer attribution (utils.metrics.note_recursion_depth):
        this query reached recursion level ``depth``."""
        with self._lock:
            if depth > self.metrics["recursion_depth_peak"]:
                self.metrics["recursion_depth_peak"] = depth

    def explain_analyze(self) -> str:
        """EXPLAIN ANALYZE of this query's executed plan (per-node
        observed rows / batches / wall / self time / spill). Rendered by
        the scheduler worker at completion when the query ran under
        ``trace.enabled``; raises for untraced or still-running queries."""
        if self._analyze_text is None:
            raise RuntimeError(
                f"{self.label} (id {self.query_id}): no analyzed plan — "
                f"the query must COMPLETE under trace.enabled")
        return self._analyze_text

    def export_trace(self, path: str) -> int:
        """Write THIS query's spans (still present in the bounded ring)
        as Chrome trace-event JSON; returns the span count."""
        records = _tracing.TRACER.since(0, query_id=self.query_id)
        _tracing.export_chrome(records, path,
                               metadata={"query_id": self.query_id,
                                         "label": self.label})
        return len(records)

    # ---- metric attribution ------------------------------------------------
    def note_metric(self, key: str, value: Any) -> None:
        """Set one metrics key under the handle lock. The metrics dict is
        read by snapshot()/serve.stats from other threads while the
        owning worker fills it — every writer goes through the lock so a
        concurrent snapshot never iterates a resizing dict (R012)."""
        with self._lock:
            self.metrics[key] = value

    def metric(self, key: str, default: Any = None) -> Any:
        """Read one metrics key under the handle lock (the cross-thread
        read counterpart of note_metric)."""
        with self._lock:
            return self.metrics.get(key, default)

    def note_admission_wait(self, seconds: float) -> None:
        with self._lock:
            self.metrics["admission_wait_s"] = round(
                self.metrics["admission_wait_s"] + seconds, 6)

    def count_program(self, *, hit: bool, from_disk: bool = False) -> None:
        with self._lock:
            pc = self.metrics["program_cache"]
            if hit:
                pc["hits"] += 1
            else:
                pc["misses"] += 1
                if from_disk:
                    pc["disk_hits"] += 1

    def note_compile(self, seconds: float) -> None:
        with self._lock:
            self.metrics["compile_s"] = round(
                self.metrics["compile_s"] + seconds, 6)

    def record_exec_metrics(self, snapshot: Dict[str, Dict]) -> None:
        """Attach one action's per-operator + transfer snapshot. Multi-action
        queries (distinct-agg rewrites, pivots) accumulate keyed by action
        ordinal so nothing is overwritten."""
        with self._lock:
            ordinal = self.metrics.get("actions", 0)
            self.metrics["actions"] = ordinal + 1
            if ordinal == 0:
                self.exec_metrics.update(snapshot)
            else:
                self.exec_metrics.update(
                    {f"a{ordinal}:{k}": v for k, v in snapshot.items()})
            acc = self.metrics["adaptive"]
            for k, v in (snapshot.get("adaptive") or {}).items():
                acc[k] = acc.get(k, 0) + v

    # ---- results -----------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done_evt.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done_evt.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None):
        """Block for the collected arrow table; re-raises the query's error
        for FAILED/CANCELLED handles."""
        if not self._done_evt.wait(timeout):
            raise TimeoutError(
                f"{self.label} (id {self.query_id}) still "
                f"{self.state.value} after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of the handle: state + metrics (the per-query
        replacement for reading session.last_metrics)."""
        with self._lock:
            out = {"query_id": self.query_id, "label": self.label,
                   "tenant": self.tenant, "state": self.state.value}
            out.update({k: v for k, v in self.metrics.items()})
            out["program_cache"] = dict(self.metrics["program_cache"])
            out["adaptive"] = dict(self.metrics["adaptive"])
            return out

    def __repr__(self) -> str:
        return (f"QueryHandle(id={self.query_id}, tenant={self.tenant!r}, "
                f"state={self.state.value})")
