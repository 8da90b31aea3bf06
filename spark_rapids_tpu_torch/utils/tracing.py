"""Structured query tracing: thread-bound spans in a bounded ring buffer
(the JAX package's ``utils/tracing.py``).

Three surfaces read it:

- **EXPLAIN ANALYZE**: ``PhysicalExec.tree_string(analyze=True)``,
  ``TpuSession.explain_analyze()`` and ``QueryHandle.explain_analyze()``
  annotate each plan node with its observed rows, batches, wall and self
  time (and grace spills);
- **the Chrome / Perfetto export**: ``export_chrome()`` writes the span
  window as ``{"traceEvents": [...]}`` JSON;
- **serve.stats**: the serving layer's rolling window rides the same
  per-query attribution.

The contract (the reference's R002):

- timestamps are ``time.perf_counter_ns`` taken at host boundaries that
  exist anyway (an exec's ``__next__``, a state transition, an admission
  wakeup). A span adds no ``torch.cuda.synchronize``, ``.item()`` or
  ``.cpu()``. **On a GPU an exec's span is therefore its launch time on
  the host, not its device time**: a pull returns once its kernels are
  queued, and the device time shows only where the host later waits (a
  download, a count read back). The device's own timeline is
  ``torch.profiler``'s, in which each pull is a named
  ``record_function`` range;
- off, every hook is one bool read (``enabled()``), and ``span()``
  returns a shared no-op without allocating;
- the ring is bounded (``trace.maxBufferedSpans``): a long-running traced
  server overwrites its oldest spans. ``mark()``/``since()`` give an
  action-scoped window; a span carries the query id the serving worker
  bound to its thread (``serving.lifecycle.bind_query``).

Span layers (``cat``): ``exec`` (operator execute boundaries) and
``serving`` (lifecycle transitions, admission and preemption waits, wire
frames); ``transfer``, ``shuffle`` and ``memory`` keep the JAX package's
names, and the port records none yet.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

#: span layer names every consumer agrees on (docs/observability.md)
LAYER_EXEC = "exec"
LAYER_TRANSFER = "transfer"
LAYER_SHUFFLE = "shuffle"
LAYER_MEMORY = "memory"
LAYER_SERVING = "serving"


class SpanRecord:
    """One completed span (or instant event, ``dur_ns == 0``)."""

    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "tid", "query_id",
                 "plan_id", "args", "seq")

    def __init__(self, name: str, cat: str, ts_ns: int, dur_ns: int,
                 tid: int, query_id: Optional[int],
                 plan_id: Optional[int], args: Optional[Dict[str, Any]],
                 seq: int):
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.query_id = query_id
        self.plan_id = plan_id
        self.args = args
        self.seq = seq

    def to_event(self) -> Dict[str, Any]:
        """Chrome trace-event form (``ph: X`` complete events; instants
        use ``ph: i``). Timestamps/durations are microseconds."""
        import os
        ev: Dict[str, Any] = {
            "name": self.name, "cat": self.cat, "pid": os.getpid(),
            "tid": self.tid, "ts": self.ts_ns / 1e3,
        }
        if self.dur_ns > 0:
            ev["ph"] = "X"
            ev["dur"] = self.dur_ns / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        args = dict(self.args or {})
        if self.query_id is not None:
            args["query_id"] = self.query_id
        if self.plan_id is not None:
            args["plan_id"] = self.plan_id
        if args:
            ev["args"] = args
        return ev


class _NullSpan:
    """Shared no-op context manager returned while tracing is off —
    ``span()`` on the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager recording one span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer.record(self._name, self._cat, self._t0,
                            time.perf_counter_ns() - self._t0, self._args)
        return False


def _current_query_id() -> Optional[int]:
    # lazy, cached: only runs while tracing is ON (never on the hot path)
    global _CURRENT_QUERY
    if _CURRENT_QUERY is None:
        from spark_rapids_tpu_torch.serving.lifecycle import current_query
        _CURRENT_QUERY = current_query
    q = _CURRENT_QUERY()
    return q.query_id if q is not None else None


_CURRENT_QUERY = None


class Tracer:
    """Bounded ring buffer of spans with an activation count.

    ``activate()`` scopes (one per traced action / served query) nest; the
    ring survives across scopes so a server can export a window covering
    many queries. ``mark()``/``since()`` give callers an action-scoped
    slice without copying the whole ring.
    """

    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = max(16, capacity)
        self._ring: List[Optional[SpanRecord]] = [None] * self._capacity
        self._seq = 0               # monotonically increasing record count
        self._active = 0
        #: the one-field fast path every disabled hook reads
        self.on = False

    # ---- activation --------------------------------------------------------
    def configure(self, capacity: int) -> None:
        """Resize the ring, PRESERVING the newest min(old, new) records —
        the capacity is effectively process-wide (one tracer, many
        sessions), so a session with a different trace.maxBufferedSpans
        must not wipe a just-finished query's exportable spans. Resizes
        are skipped while an activation is live (a shrink could drop part
        of a running action's window)."""
        with self._lock:
            capacity = max(16, int(capacity))
            if capacity == self._capacity or self._active > 0:
                return
            new_ring: List[Optional[SpanRecord]] = [None] * capacity
            lo = max(0, self._seq - min(self._capacity, capacity))
            for i in range(lo, self._seq):
                new_ring[i % capacity] = self._ring[i % self._capacity]
            self._capacity = capacity
            self._ring = new_ring

    def activate(self):
        """Context manager turning tracing on for the scope (nesting
        counts; ``on`` stays True until the outermost scope exits)."""
        tracer = self

        class _Scope:
            def __enter__(self):
                with tracer._lock:
                    tracer._active += 1
                    tracer.on = True
                return tracer

            def __exit__(self, *exc):
                with tracer._lock:
                    tracer._active -= 1
                    tracer.on = tracer._active > 0
                return False

        return _Scope()

    # ---- recording ---------------------------------------------------------
    def record(self, name: str, cat: str, ts_ns: int, dur_ns: int,
               args: Optional[Dict[str, Any]] = None,
               plan_id: Optional[int] = None,
               query_id: Optional[int] = None) -> None:
        if not self.on:
            return
        if query_id is None:
            query_id = _current_query_id()
        rec = SpanRecord(name, cat, ts_ns, dur_ns, threading.get_ident(),
                         query_id, plan_id, args, 0)
        with self._lock:
            rec.seq = self._seq
            self._ring[self._seq % self._capacity] = rec
            self._seq += 1

    def span(self, name: str, cat: str,
             args: Optional[Dict[str, Any]] = None):
        """Timed scope; the disabled path returns one shared no-op."""
        if not self.on:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args)

    def instant(self, name: str, cat: str,
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.on:
            return
        self.record(name, cat, time.perf_counter_ns(), 0, args)

    # ---- reading -----------------------------------------------------------
    def mark(self) -> int:
        """Current sequence number — pass to ``since()`` for the spans
        recorded after this point (an action-scoped window)."""
        with self._lock:
            return self._seq

    def since(self, mark: int, query_id: Optional[int] = None
              ) -> List[SpanRecord]:
        """Spans recorded at or after ``mark`` (oldest first), optionally
        filtered to one query. Records the ring already overwrote are
        gone — the window is bounded by trace.maxBufferedSpans."""
        with self._lock:
            lo = max(mark, self._seq - self._capacity)
            out = [self._ring[i % self._capacity]
                   for i in range(lo, self._seq)]
        return [r for r in out
                if r is not None
                and (query_id is None or r.query_id == query_id)]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self._capacity
            self._seq = 0


#: the process-wide tracer every layer records into
TRACER = Tracer()


def enabled() -> bool:
    return TRACER.on


def span(name: str, cat: str, args: Optional[Dict[str, Any]] = None):
    return TRACER.span(name, cat, args)


def instant(name: str, cat: str,
            args: Optional[Dict[str, Any]] = None) -> None:
    TRACER.instant(name, cat, args)


def record(name: str, cat: str, ts_ns: int, dur_ns: int,
           args: Optional[Dict[str, Any]] = None,
           plan_id: Optional[int] = None,
           query_id: Optional[int] = None) -> None:
    TRACER.record(name, cat, ts_ns, dur_ns, args, plan_id, query_id)


# ---------------------------------------------------------------- exec spans
#: per-thread currently-recording exec frame, for self-time attribution:
#: a child exec's __next__ time nested inside its parent's subtracts from
#: the parent's SELF time (the classic profiler discipline). Producer
#: threads (PipelinedExec / prefetch) keep their own stack — cross-thread
#: overlap deliberately does not subtract (it is genuine concurrency).
_EXEC_TLS = threading.local()


class _ExecRecorder:
    """Aggregated observation of one exec node across one execute() call."""

    __slots__ = ("node", "wall_ns", "child_ns", "rows", "batches", "bytes",
                 "t_first")

    def __init__(self, node):
        self.node = node
        self.wall_ns = 0
        self.child_ns = 0
        self.rows = 0
        self.batches = 0
        self.bytes = 0
        self.t_first = 0


def observed_of(node) -> Optional[Dict[str, Any]]:
    """The node's accumulated observation dict (None before any traced
    execution). Keys: rows, batches, bytes, wall_ns, self_ns, partitions,
    plus grace_partitions / grace_depth when the out-of-core path ran."""
    return getattr(node, "_observed", None)


def _accumulate(node, rec: _ExecRecorder) -> None:
    obs = getattr(node, "_observed", None)
    with TRACER._lock:
        if obs is None:
            obs = node._observed = {"rows": 0, "batches": 0, "bytes": 0,
                                    "wall_ns": 0, "self_ns": 0,
                                    "partitions": 0}
        obs["rows"] += rec.rows
        obs["batches"] += rec.batches
        obs["bytes"] += rec.bytes
        obs["wall_ns"] += rec.wall_ns
        obs["self_ns"] += max(rec.wall_ns - rec.child_ns, 0)
        obs["partitions"] += 1


def note_exec_spill(node, partitions: int, depth: int) -> None:
    """Grace layer attribution: this node's input was grace-partitioned
    (EXPLAIN ANALYZE renders it as ``spill=nxd``). Cheap dict stores on
    the already-degraded path — recorded even when span tracing is off so
    analyze output stays truthful about spills. Same lock as
    ``_accumulate``: one plan node's partitions can execute on parallel
    task threads (cluster task slots)."""
    with TRACER._lock:
        obs = getattr(node, "_observed", None)
        if obs is None:
            obs = node._observed = {"rows": 0, "batches": 0, "bytes": 0,
                                    "wall_ns": 0, "self_ns": 0,
                                    "partitions": 0}
        obs["grace_partitions"] = obs.get("grace_partitions", 0) + partitions
        obs["grace_depth"] = max(obs.get("grace_depth", 0), depth)


def _profiler_annotation(name: str):
    """The profiler's named range for ``name`` through the version shim
    (``shims.get().record_function``; the per-exec named range
    trace.enabled promises, NvtxWithMetrics' analog): a host-side range
    that never synchronizes the device."""
    from spark_rapids_tpu_torch import shims
    return shims.get().record_function(name)


def trace_exec(node, ctx, raw) -> Iterator:
    """Wrap one exec's ``execute()`` iteration with span recording: each
    ``__next__`` is timed (and shows as a named torch.profiler range), rows/
    batches/bytes are observed from the yielded batches, and ONE span per
    execute() call lands in the ring (ts = first pull, dur = pull window).
    Self time subtracts nested child pulls on the same thread.

    A subclass delegating to ``super().execute()`` (FusedAggregateStage ->
    TpuHashAggregate) must not double-record the node: when the CURRENT
    frame already records this node, the raw iterator passes through."""
    cur = getattr(_EXEC_TLS, "rec", None)
    if cur is not None and cur.node is node:
        yield from raw(node, ctx)
        return
    rec = _ExecRecorder(node)
    qid = _current_query_id()
    range_name = f"{node.name}#{node.plan_id}" if node.plan_id is not None \
        else node.name
    it = iter(raw(node, ctx))
    try:
        while True:
            parent = getattr(_EXEC_TLS, "rec", None)
            _EXEC_TLS.rec = rec
            ann = _profiler_annotation(range_name)
            t0 = time.perf_counter_ns()
            if rec.t_first == 0:
                rec.t_first = t0
            try:
                if ann is not None:
                    with ann:
                        batch = next(it)
                else:
                    batch = next(it)
            except StopIteration:
                return
            finally:
                dt = time.perf_counter_ns() - t0
                rec.wall_ns += dt
                if parent is not None:
                    parent.child_ns += dt
                _EXEC_TLS.rec = parent
            rec.batches += 1
            n = getattr(batch, "num_rows", None)
            if n is not None:
                rec.rows += int(n)
            rec.bytes += int(getattr(batch, "device_size_bytes", 0) or 0)
            yield batch
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
        _accumulate(node, rec)
        if rec.t_first:
            TRACER.record(
                node.name, LAYER_EXEC, rec.t_first,
                time.perf_counter_ns() - rec.t_first,
                {"rows": rec.rows, "batches": rec.batches,
                 "bytes": rec.bytes,
                 "busy_ms": round(rec.wall_ns / 1e6, 3),
                 "self_ms": round(max(rec.wall_ns - rec.child_ns, 0) / 1e6,
                                  3),
                 "partition": ctx.partition_id},
                plan_id=node.plan_id, query_id=qid)


# ---------------------------------------------------------------- rendering
def _fmt_ms(ns: int) -> str:
    return f"{ns / 1e6:.1f}ms"


def analyze_annotation(node) -> str:
    """The EXPLAIN ANALYZE suffix for one plan node, '' when the node was
    never executed under tracing."""
    obs = getattr(node, "_observed", None)
    if obs is None:
        return ""
    parts = [f"rows={obs['rows']}", f"batches={obs['batches']}"]
    if obs.get("wall_ns"):
        parts.append(f"wall={_fmt_ms(obs['wall_ns'])}")
        parts.append(f"self={_fmt_ms(obs['self_ns'])}")
    if obs.get("bytes"):
        parts.append(f"bytes={obs['bytes']}")
    if obs.get("grace_partitions"):
        parts.append(f"spill={obs['grace_partitions']}p"
                     f"x{obs.get('grace_depth', 1)}d")
    return " (" + ", ".join(parts) + ")"


def export_chrome(records: List[SpanRecord], path: str,
                  metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``records`` as Chrome trace-event JSON (loads in Perfetto /
    chrome://tracing). ``metadata`` lands in the top-level ``otherData``."""
    doc = {"traceEvents": [r.to_event() for r in records],
           "displayTimeUnit": "ms"}
    if metadata:
        doc["otherData"] = metadata
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def layer_counts(records: List[SpanRecord]) -> Dict[str, int]:
    """Span count per layer (a one-line check of a traced run)."""
    out: Dict[str, int] = {}
    for r in records:
        out[r.cat] = out.get(r.cat, 0) + 1
    return out
