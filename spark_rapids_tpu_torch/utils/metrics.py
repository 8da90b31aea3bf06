"""Per-operator metric names, the engine's process-global counters, and
named trace ranges (the JAX package's ``utils/metrics.py``).

Analog of the reference's SQLMetrics wiring (GpuExec.scala:28-52
GpuMetricNames) and its NVTX named ranges (NvtxWithMetrics.scala:44). On the
GPU the range is ``torch.profiler.record_function``, which also emits an
NVTX range when the profiler runs under ``emit_nvtx``; it is a host-side
range and never synchronizes the device.

The port bumps the shuffle, recompute and serving counters, and the memory
section's pressure events, grace partitions and recursion depth (from the
grace layer, ``memory/grace.py::_count``). Its transfer path and
spill tiers keep their own counters (``columnar/transfer.py``, the store's
``spilled_bytes``), so the transfer section and the spill-tier bytes stay 0
here; the names keep the JAX package's keys.
"""
from __future__ import annotations

import contextlib as _contextlib
import threading
import time
from typing import Dict, Optional

# Standard metric names (GpuMetricNames analog, GpuExec.scala:28-52)
NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
NUM_INPUT_ROWS = "numInputRows"
NUM_INPUT_BATCHES = "numInputBatches"
TOTAL_TIME = "totalTime"
PEAK_DEVICE_MEMORY = "peakDevMemory"
BUFFER_TIME = "bufferTime"
DECODE_TIME = "tpuDecodeTime"

# Shuffle fault-tolerance counters (one MetricSet per transport, shared by
# the env/client/reader layers — RapidsShuffleInternalManager's
# rapidsShuffle* metrics role, extended with the retry/corruption story)
SHUFFLE_FETCH_RETRIES = "shuffleFetchRetries"        # reader re-fetches a peer
SHUFFLE_TRANSFER_RETRIES = "shuffleTransferRetries"  # per-block re-transfers
SHUFFLE_RPC_RETRIES = "shuffleRpcRetries"            # metadata request retries
SHUFFLE_CONNECT_RETRIES = "shuffleConnectRetries"    # TCP connect re-attempts
SHUFFLE_CHECKSUM_FAILURES = "shuffleChecksumFailures"  # corrupt payloads caught
SHUFFLE_PEER_EVICTIONS = "shufflePeerEvictions"      # dead clients evicted
SHUFFLE_CODEC_FALLBACKS = "shuffleCodecFallbacks"    # negotiated down to copy

SHUFFLE_METRIC_NAMES = (
    SHUFFLE_FETCH_RETRIES, SHUFFLE_TRANSFER_RETRIES, SHUFFLE_RPC_RETRIES,
    SHUFFLE_CONNECT_RETRIES, SHUFFLE_CHECKSUM_FAILURES,
    SHUFFLE_PEER_EVICTIONS, SHUFFLE_CODEC_FALLBACKS)

# Host-link transfer counters (bufferTime/gpuDecodeTime observability role,
# process-global like the link itself: uploads happen inside
# DeviceBatch.from_arrow / the chunked pipeline, far from any operator's
# MetricSet). session.last_metrics exposes the per-action delta plus the
# derived link GB/s.
TRANSFER_UPLOAD_BYTES = "transfer.upload_bytes"
TRANSFER_UPLOAD_SECONDS = "transfer.upload_seconds"
TRANSFER_UPLOAD_CHUNKS = "transfer.upload_chunks"
TRANSFER_DOWNLOAD_BYTES = "transfer.download_bytes"
TRANSFER_DOWNLOAD_SECONDS = "transfer.download_seconds"
TRANSFER_INFLIGHT_PEAK = "transfer.inflight_peak"
# compressed columnar path: bytes actually staged for the link (encoded
# forms: dict indices + dictionary, RLE run ends + run values) vs the bytes
# the decoded columns would have staged — the per-action ratio is the link
# compression the encoded path bought (transfer.compression_ratio in
# session.last_metrics["transfer"]).
TRANSFER_ENCODED_BYTES = "transfer.encoded_bytes"
TRANSFER_DECODED_EQUIV_BYTES = "transfer.decoded_equivalent_bytes"
#: batch programs that ran a filter/group-by/join on the encoded domain
#: (dictionary indices) instead of decoded values (exprs/encoded.py)
TRANSFER_ENCODED_DOMAIN_OPS = "transfer.encoded_domain_ops"
#: bytes of EXCHANGE data that bounced through the host (device -> host ->
#: device) instead of riding an in-mesh collective: the scatter of a
#: single-device intermediate onto the mesh, and TCP shuffle payloads (the
#: DCN path). The in-mesh all_to_all exchange keeps this at EXACTLY 0 —
#: only per-shard row COUNTS sync to the host, never row data.
TRANSFER_HOST_HOP_BYTES = "transfer.host_hop_bytes"
#: shuffle exchanges that carried a column through partition/repack as
#: dictionary indices + shared dictionary instead of decoded values
TRANSFER_EXCHANGE_ENCODED_OPS = "transfer.exchange_encoded_ops"

TRANSFER_METRIC_NAMES = (
    TRANSFER_UPLOAD_BYTES, TRANSFER_UPLOAD_SECONDS, TRANSFER_UPLOAD_CHUNKS,
    TRANSFER_DOWNLOAD_BYTES, TRANSFER_DOWNLOAD_SECONDS,
    TRANSFER_INFLIGHT_PEAK, TRANSFER_ENCODED_BYTES,
    TRANSFER_DECODED_EQUIV_BYTES, TRANSFER_ENCODED_DOMAIN_OPS,
    TRANSFER_HOST_HOP_BYTES, TRANSFER_EXCHANGE_ENCODED_OPS)

# Out-of-core / memory-pressure counters (process-global like the tiered
# store they observe; session.last_metrics["memory"] exposes the per-action
# delta, and per-query handle snapshots carry the same section). The
# degradation story in one glance: how often operators hit pressure, how
# many grace partitions they fanned out, how deep the recursion went, and
# how many bytes each spill tier absorbed.
#: runtime pressure events that forced an operator into the out-of-core
#: path (reactive working-set trigger, store pressure callback, injected
#: allocation failure) — plan-time predicted partitioning does NOT count
MEM_PRESSURE_EVENTS = "memory.pressure_events"
#: spillable grace partitions created by out-of-core operators
MEM_SPILL_PARTITIONS = "memory.spill_partitions"
#: deepest grace recursion level reached (set_max; re-armed per action)
MEM_RECURSION_DEPTH = "memory.recursion_depth_peak"
#: bytes the device tier pushed down to the host tier
MEM_SPILLED_TO_HOST = "memory.bytes_spilled_to_host"
#: bytes the host tier pushed down to the disk tier
MEM_SPILLED_TO_DISK = "memory.bytes_spilled_to_disk"

MEMORY_METRIC_NAMES = (
    MEM_PRESSURE_EVENTS, MEM_SPILL_PARTITIONS, MEM_RECURSION_DEPTH,
    MEM_SPILLED_TO_HOST, MEM_SPILLED_TO_DISK)

# Network-serving counters (process-global like the wire they observe; the
# per-action delta lands in session.last_metrics["serving"], and per-query
# stream/preemption counts additionally ride QueryHandle.metrics).
#: bytes of Arrow-IPC result frames the query server pushed to clients
#: (retransmits of a corrupted frame count again — this is wire traffic)
SERVING_WIRE_BYTES_OUT = "serving.wire_bytes_out"
#: result batches streamed to clients (each counted once, at first send)
SERVING_STREAM_BATCHES = "serving.stream_batches"
#: batch-granularity preemptions: a running query yielded its device
#: permit to a starved tenant at an exec-boundary checkpoint
SERVING_PREEMPTIONS = "serving.preemptions"
#: queries made to WAIT by footprint admission because their
#: working_set_estimate did not fit the free device budget
SERVING_ADMISSION_REJECTIONS = "serving.admission_rejections_footprint"
#: corrupted result frames a client caught by checksum and re-fetched
SERVING_WIRE_RETRIES = "serving.wire_retries"
#: queries resubmitted to another replica after their replica died
#: mid-stream (client-side; each failover counts once per resubmission)
SERVING_FAILOVERS = "serving.failovers"
#: result frames a resumed query re-produced but SKIPPED because the
#: client already held them (dedup by batch sequence number — the
#: exactly-once delivery contract's server-side evidence)
SERVING_RESUMED_BATCHES = "serving.resumed_batches"
#: client-side circuit-breaker CLOSED->OPEN transitions (a replica hit
#: its consecutive-failure threshold and left the routing rotation)
SERVING_BREAKER_OPENS = "serving.breaker_opens"
#: graceful-drain initiations (serve.drain RPC or SIGTERM): the replica
#: flipped to DRAINING, redirecting new submissions while running
#: queries finish and streams flush
SERVING_DRAINS = "serving.drains"
#: supervised replica restarts (supervisor-side: one per respawn of a dead
#: slot, after its deterministic backoff elapsed; crash-loop-halted slots
#: stop counting because they stop restarting)
SERVING_RESTARTS = "serving.restarts"
#: autoscaler scale-up decisions that started a new supervised replica
SERVING_SCALE_UPS = "serving.scale_ups"
#: autoscaler scale-down decisions that retired a replica through the
#: graceful-drain path (zero in-flight queries dropped)
SERVING_SCALE_DOWNS = "serving.scale_downs"
#: submissions shed at the front door with a structured RETRYABLE
#: OverloadedError (per-tenant queue bound serving.maxQueuedPerTenant) —
#: load sheds before it queues, never mid-query
SERVING_SHEDS = "serving.sheds"
#: submissions rejected by the per-client concurrent-query quota
#: (serving.quota.maxConcurrentPerClient) with QuotaExceededError
SERVING_QUOTA_REJECTIONS = "serving.quota_rejections"

SERVING_METRIC_NAMES = (
    SERVING_WIRE_BYTES_OUT, SERVING_STREAM_BATCHES, SERVING_PREEMPTIONS,
    SERVING_ADMISSION_REJECTIONS, SERVING_WIRE_RETRIES, SERVING_FAILOVERS,
    SERVING_RESUMED_BATCHES, SERVING_BREAKER_OPENS, SERVING_DRAINS,
    SERVING_RESTARTS, SERVING_SCALE_UPS, SERVING_SCALE_DOWNS,
    SERVING_SHEDS, SERVING_QUOTA_REJECTIONS)

# Lineage-recompute counters (driver-process-global: the stage driver in
# parallel/cluster.py owns every bump — executors never recompute on their
# own). The escalation ladder in one glance: how often a lost map output
# was repaired by a scoped stage re-execution (instead of a whole-query
# failover), how many map tasks each repair replayed, and how often the
# per-stage attempt budget ran dry and the query escalated to the
# replica failover.
#: scoped stage re-executions triggered by a ShuffleFetchFailedError
#: (one per recompute round, however many map tasks it replays)
SHUFFLE_RECOMPUTES = "shuffle.recomputes"
#: lost map tasks re-executed on surviving peers (the "bounded" in
#: bounded re-execution: fewer than the stage's map tasks)
SHUFFLE_RECOMPUTED_MAP_TASKS = "shuffle.recomputed_map_tasks"
#: recompute rounds abandoned because shuffle.recompute.maxStageAttempts
#: was exhausted — the error re-surfaces and the failover path owns it
SHUFFLE_RECOMPUTE_ESCALATIONS = "shuffle.recompute_escalations"

RECOMPUTE_METRIC_NAMES = (
    SHUFFLE_RECOMPUTES, SHUFFLE_RECOMPUTED_MAP_TASKS,
    SHUFFLE_RECOMPUTE_ESCALATIONS)

# Adaptive-execution counters (driver-process-global: plan/adaptive.py's
# rewrite pass owns every bump — it runs once per action, in the driver,
# after the shuffle map stages materialized their statistics). The
# re-planning story in one glance: how many skewed partitions were split
# into map-id slices (or re-partitioned, for aggregates), how many small
# reduce partitions folded into coalesced reader groups, how often a
# shuffled join switched to broadcast from observed sizes, and how many
# fused stages the post-AQE re-fusion pass created over rewritten regions.
#: skewed reduce partitions split into PartialReducerSpec slices (joins)
#: or re-partitioned by group key (aggregates) — one per skewed partition
ADAPTIVE_SKEW_SPLITS = "adaptive.skew_splits"
#: reduce partitions removed by AQE coalescing (sum of n_before - n_after
#: over every coalesced reader the rewrite inserted)
ADAPTIVE_COALESCED_PARTITIONS = "adaptive.coalesced_partitions"
#: shuffled hash joins switched to broadcast from observed build sizes
ADAPTIVE_BROADCAST_SWITCHES = "adaptive.broadcast_switches"
#: fused stages newly created by the post-AQE re-fusion pass (stages the
#: plan-time fusion pass could not see because the rewrite created them)
ADAPTIVE_REFUSED_STAGES = "adaptive.refused_stages"

ADAPTIVE_METRIC_NAMES = (
    ADAPTIVE_SKEW_SPLITS, ADAPTIVE_COALESCED_PARTITIONS,
    ADAPTIVE_BROADCAST_SWITCHES, ADAPTIVE_REFUSED_STAGES)

# Per-query serving metrics (QueryHandle.metrics keys, serving/lifecycle.py):
# unlike the per-operator MetricSets — which live on per-action plan nodes —
# and the process-global transfer counters, these are scoped to ONE query
# handle, so concurrent queries never interleave in them.
QUERY_QUEUE_WAIT_S = "queue_wait_s"            # submit -> scheduler pickup
QUERY_ADMISSION_WAIT_S = "admission_wait_s"    # device-semaphore wait
QUERY_COMPILE_S = "compile_s"                  # first-call program builds
QUERY_WALL_S = "wall_s"                        # submit -> terminal state
QUERY_ROWS = "rows"                            # collected result rows

QUERY_METRIC_NAMES = (QUERY_QUEUE_WAIT_S, QUERY_ADMISSION_WAIT_S,
                      QUERY_COMPILE_S, QUERY_WALL_S, QUERY_ROWS)


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an ascending list (p50/p99 latency
    reporting for the scheduler's stats)."""
    if not sorted_vals:
        return 0.0
    if q <= 0:
        return float(sorted_vals[0])
    import math
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return float(sorted_vals[min(len(sorted_vals), max(1, rank)) - 1])


class Metric:
    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = "sum"):
        self.name = name
        self.unit = unit
        self._value = 0
        self._lock = threading.Lock()

    def __getstate__(self):
        # plans ship to cluster executors by pickle; the lock is process-local
        return (self.name, self.unit, self._value)

    def __setstate__(self, state):
        self.name, self.unit, self._value = state
        self._lock = threading.Lock()

    def add(self, v: int) -> None:
        with self._lock:
            self._value += v

    def set_max(self, v: int) -> None:
        with self._lock:
            self._value = max(self._value, v)

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def __repr__(self) -> str:
        return f"Metric({self.name}={self.value})"


class MetricSet:
    """Mutable bag of metrics owned by one physical operator instance."""

    def __init__(self, *names: str):
        self._metrics: Dict[str, Metric] = {n: Metric(n) for n in names}

    def metric(self, name: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = Metric(name)
            self._metrics[name] = m
        return m

    def __getitem__(self, name: str) -> Metric:
        return self.metric(name)

    def snapshot(self) -> Dict[str, int]:
        return {n: m.value for n, m in self._metrics.items()}


#: process-global transfer counters (see TRANSFER_METRIC_NAMES above)
TRANSFER_METRICS = MetricSet(*TRANSFER_METRIC_NAMES)

#: process-global memory-pressure counters (see MEMORY_METRIC_NAMES above)
MEMORY_METRICS = MetricSet(*MEMORY_METRIC_NAMES)

#: process-global network-serving counters (see SERVING_METRIC_NAMES above)
SERVING_METRICS = MetricSet(*SERVING_METRIC_NAMES)

#: driver-global lineage-recompute counters (see RECOMPUTE_METRIC_NAMES)
RECOMPUTE_METRICS = MetricSet(*RECOMPUTE_METRIC_NAMES)

#: driver-global adaptive-execution counters (see ADAPTIVE_METRIC_NAMES)
ADAPTIVE_METRICS = MetricSet(*ADAPTIVE_METRIC_NAMES)


def adaptive_snapshot() -> Dict[str, float]:
    """Action-start marker for ``adaptive_delta`` (all counters additive)."""
    return ADAPTIVE_METRICS.snapshot()


def adaptive_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Per-action adaptive stats: counter deltas since ``before``. Like the
    recompute section the counters live in the driver process (the AQE
    rewrite is the only bump site); under concurrent queries a delta can
    still include an overlapping action's rewrite decisions."""
    now = ADAPTIVE_METRICS.snapshot()
    return {name: now[name] - before.get(name, 0)
            for name in ADAPTIVE_METRIC_NAMES}


def recompute_snapshot() -> Dict[str, float]:
    """Action-start marker for ``recompute_delta`` (all counters additive)."""
    return RECOMPUTE_METRICS.snapshot()


def recompute_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Per-action recompute stats: counter deltas since ``before``. The
    counters live in the DRIVER process (the stage driver is the only bump
    site), so unlike the transfer/serving sections there is no executor-side
    aggregation to fold in; under concurrent queries a delta can still
    include an overlapping query's recompute rounds."""
    now = RECOMPUTE_METRICS.snapshot()
    return {name: now[name] - before.get(name, 0)
            for name in RECOMPUTE_METRIC_NAMES}


def serving_snapshot() -> Dict[str, float]:
    """Action-start marker for ``serving_delta`` (all counters additive)."""
    return SERVING_METRICS.snapshot()


def serving_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Per-action serving stats: counter deltas since ``before``. Like the
    transfer section, counters are process-global — under concurrent
    queries an action's delta can include overlapping queries' wire
    traffic and preemptions; per-query exact counts live on the handle."""
    now = SERVING_METRICS.snapshot()
    return {name: now[name] - before.get(name, 0)
            for name in SERVING_METRIC_NAMES}


class _ActionDepth:
    """Per-action recursion-depth high-water mark, bound thread-locally by
    the action driver (``action_depth_scope``). This replaces the old
    re-armed global as the per-action record: the re-arm raced under
    CONCURRENT out-of-core queries (a later action's reset absorbed part
    of an overlapping action's peak). The
    process-global metric keeps its lifetime high-water mark; per-action
    and per-query peaks come from this scope and the query handle."""

    __slots__ = ("peak",)

    def __init__(self):
        self.peak = 0


_DEPTH_TLS = threading.local()


@_contextlib.contextmanager
def action_depth_scope():
    """Context manager binding a fresh per-action depth holder to the
    calling thread (the thread that drives the operators; grace recursion
    runs on it). Yields the holder; read ``holder.peak`` after the
    action."""
    holder = _ActionDepth()
    prev = getattr(_DEPTH_TLS, "holder", None)
    _DEPTH_TLS.holder = holder
    try:
        yield holder
    finally:
        _DEPTH_TLS.holder = prev


def note_recursion_depth(depth: int, query=None) -> None:
    """One grace recursion level reached: attribute the high-water mark to
    (1) the process-lifetime global, (2) the thread-bound ACTION scope —
    the per-action record memory_delta reports — and (3) the owning
    query's handle when one is bound (mirroring per-handle snapshots)."""
    MEMORY_METRICS[MEM_RECURSION_DEPTH].set_max(depth)
    holder = getattr(_DEPTH_TLS, "holder", None)
    if holder is not None and depth > holder.peak:
        holder.peak = depth
    if query is not None:
        query.note_recursion_depth(depth)


def memory_snapshot() -> Dict[str, float]:
    """Action-start marker for ``memory_delta``. (No re-arm: the global
    recursion-depth metric is a process-lifetime high-water mark; the
    per-action peak comes from ``action_depth_scope``.)"""
    return MEMORY_METRICS.snapshot()


def memory_delta(before: Dict[str, float],
                 recursion_peak: Optional[int] = None) -> Dict[str, float]:
    """Per-action out-of-core stats: counter deltas since ``before``.
    ``recursion_peak`` is the action-scoped depth high-water mark from
    ``action_depth_scope`` (exact under concurrency); without it the
    global lifetime maximum is reported only when it ADVANCED during the
    window (conservative fallback for callers outside the action driver)."""
    now = MEMORY_METRICS.snapshot()
    out: Dict[str, float] = {}
    for name in MEMORY_METRIC_NAMES:
        if name == MEM_RECURSION_DEPTH:
            if recursion_peak is not None:
                out[name] = recursion_peak
            else:
                out[name] = (now[name]
                             if now[name] > before.get(name, 0) else 0)
            continue
        out[name] = now[name] - before.get(name, 0)
    return out


def transfer_snapshot() -> Dict[str, float]:
    """Action-start marker for ``transfer_delta``. Re-arms the in-flight
    high-water mark so the delta reports THIS action's peak, not the
    process-lifetime maximum."""
    snap = TRANSFER_METRICS.snapshot()
    TRANSFER_METRICS[TRANSFER_INFLIGHT_PEAK].reset()
    return snap


def transfer_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Per-action transfer stats: counter deltas since ``before`` plus the
    derived link rates (upload_gb_per_sec / download_gb_per_sec)."""
    now = TRANSFER_METRICS.snapshot()
    out: Dict[str, float] = {}
    for name in TRANSFER_METRIC_NAMES:
        if name == TRANSFER_INFLIGHT_PEAK:
            # high-water mark since the matching transfer_snapshot call
            out[name] = now[name]
            continue
        out[name] = now[name] - before.get(name, 0)
    for direction in ("upload", "download"):
        b = out[f"transfer.{direction}_bytes"]
        s = out[f"transfer.{direction}_seconds"]
        out[f"transfer.{direction}_gb_per_sec"] = (
            round(b / s / 1e9, 3) if s > 0 else 0.0)
    # encoded-path link compression for this action: < 1.0 means the upload
    # shipped fewer bytes than the decoded columns would have
    dec = out[TRANSFER_DECODED_EQUIV_BYTES]
    out["transfer.compression_ratio"] = (
        round(out[TRANSFER_ENCODED_BYTES] / dec, 4) if dec > 0 else 1.0)
    return out


class NamedRange:
    """Timed, profiler-visible range tied to a metric (NvtxWithMetrics analog).

    Adds elapsed nanoseconds to ``metric`` on exit and, with ``trace``, opens
    a ``torch.profiler.record_function`` range: a host-side range that a
    profiler run shows and that never synchronizes the device.
    """

    def __init__(self, name: str, metric: Optional[Metric] = None, trace: bool = False):
        self._name = name
        self._metric = metric
        self._trace = trace
        self._ctx = None
        self._t0 = 0

    def __enter__(self) -> "NamedRange":
        if self._trace:
            import torch.profiler
            self._ctx = torch.profiler.record_function(self._name)
            self._ctx.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._metric is not None:
            self._metric.add(time.perf_counter_ns() - self._t0)
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
