"""Concurrent query serving: scheduler, program cache, lifecycle, wire.

The layer that turns the one-query-at-a-time engine into a multi-tenant
network service (the JAX package's ``serving/``):

- ``lifecycle``: the QueryHandle state machine (QUEUED -> ADMITTED ->
  RUNNING -> {DONE, FAILED, CANCELLED}) with cooperative cancellation,
  deadlines, per-query metrics, streamed results (ResultStream) and
  batch-granularity preemption checkpoints;
- ``program_cache``: the cross-query program cache with its on-disk key
  index; in the port it holds the ``nvcc``-built kernel libraries;
- ``scheduler``: N concurrent queries over a shared worker pool with
  fair-share tenant admission on top of the device semaphore;
- ``admission``: footprint admission, RUNNING queries charged their
  working_set_estimate against the device budget;
- ``stats``: the rolling serve.stats window load-aware routing reads;
- ``wire`` / ``server`` / ``client``: the Arrow-IPC wire protocol over the
  TCP shuffle transport: streamed partial results, checksum re-fetch,
  disconnect-as-cancel, routed replicas with failover;
- ``health``: circuit breakers, registry liveness, the routing score;
- ``supervisor`` / ``controller``: supervised replica processes with
  restart backoff and a crash-loop breaker, and the autoscaling loop.

The names below load on first use: the wire's modules build on pyarrow,
which the engine's main path never loads.
"""
import importlib

_EXPORTS = {
    "FootprintAdmission": "admission",
    "ControllerState": "controller", "Decision": "controller",
    "FleetController": "controller", "ReplicaSnapshot": "controller",
    "ScalingPolicy": "controller", "decide": "controller",
    "CircuitBreaker": "health", "ReplicaState": "health",
    "routing_score": "health",
    "OverloadedError": "lifecycle", "QueryCancelledError": "lifecycle",
    "QueryHandle": "lifecycle", "QueryState": "lifecycle",
    "QueryTimeoutError": "lifecycle", "QuotaExceededError": "lifecycle",
    "ResultStream": "lifecycle", "SchedulerDrainingError": "lifecycle",
    "current_query": "lifecycle",
    "ProgramCache": "program_cache",
    "global_program_cache": "program_cache", "plan_key": "program_cache",
    "SessionScheduler": "scheduler",
    "ReplicaSupervisor": "supervisor", "SlotState": "supervisor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return __all__
