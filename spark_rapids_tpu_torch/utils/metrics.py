"""Counters of the network shuffle and of lineage recompute.

The JAX package's ``utils/metrics.py`` holds every counter of its engine;
this is the part the cluster path reads: the fault-tolerance counters of
the shuffle stack (one ``MetricSet`` per transport, shared by the env,
client and reader layers) and the driver's recompute counters. Plain
counters, as the port keeps elsewhere (``grace.counters()``,
``adaptive.counters()``).
"""
from __future__ import annotations

import threading
from typing import Dict

# Shuffle fault-tolerance counters (one MetricSet per transport)
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

# Lineage-recompute counters (driver-global: the stage driver in
# parallel/cluster.py makes every bump; executors never recompute alone)
#: scoped stage re-executions triggered by a ShuffleFetchFailedError (one
#: per recompute round, however many map tasks it replays)
SHUFFLE_RECOMPUTES = "shuffle.recomputes"
#: lost map tasks re-executed on surviving executors
SHUFFLE_RECOMPUTED_MAP_TASKS = "shuffle.recomputed_map_tasks"
#: recompute rounds abandoned because shuffle.recompute.maxStageAttempts
#: ran out: the fetch error surfaces to the caller
SHUFFLE_RECOMPUTE_ESCALATIONS = "shuffle.recompute_escalations"

RECOMPUTE_METRIC_NAMES = (
    SHUFFLE_RECOMPUTES, SHUFFLE_RECOMPUTED_MAP_TASKS,
    SHUFFLE_RECOMPUTE_ESCALATIONS)


class Metric:
    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = "sum"):
        self.name = name
        self.unit = unit
        self._value = 0
        self._lock = threading.Lock()

    def __getstate__(self):
        # plans ship to cluster executors by pickle; the lock is
        # process-local
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
    """A mutable bag of named metrics."""

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


#: driver-global lineage-recompute counters (see RECOMPUTE_METRIC_NAMES)
RECOMPUTE_METRICS = MetricSet(*RECOMPUTE_METRIC_NAMES)


def recompute_snapshot() -> Dict[str, float]:
    """Action-start marker for ``recompute_delta`` (all counters add)."""
    return RECOMPUTE_METRICS.snapshot()


def recompute_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Per-action recompute counters: the deltas since ``before``. They
    live in the driver process (the stage driver makes every bump); under
    concurrent queries a delta can include an overlapping query's
    rounds."""
    now = RECOMPUTE_METRICS.snapshot()
    return {name: now[name] - before.get(name, 0)
            for name in RECOMPUTE_METRIC_NAMES}
