"""Physical operator base classes.

A physical exec yields batches for one partition: ``HostBatch`` for the host
leaf and the download transition, ``DeviceBatch`` for everything between.
"""
from __future__ import annotations

import functools
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.utils import tracing as _tracing
from spark_rapids_tpu_torch.utils.metrics import (MetricSet,
                                                  NUM_OUTPUT_BATCHES,
                                                  NUM_OUTPUT_ROWS, TOTAL_TIME)


def _traced_execute(raw):
    """Span hook around one exec class's ``execute``: with tracing off the
    only cost is one bool read; on, each pull is timed (self against child
    time) and shows as a named ``torch.profiler`` range, and the observed
    rows, batches and bytes accumulate for EXPLAIN ANALYZE. On a GPU the
    times are the host's launch times (utils/tracing.py).

    The hook also counts the exec's output (``numOutputRows``,
    ``numOutputBatches``): every batch its ``execute`` yields, the JAX
    package's ``count_output`` at each of its yields. Only the class's own
    ``execute`` counts: a subclass's that delegates to this one through
    ``super()`` is counted once, by its own hook."""
    @functools.wraps(raw)
    def execute(self, ctx):
        it = (raw(self, ctx) if not _tracing.TRACER.on
              else _tracing.trace_exec(self, ctx, raw))
        if type(self).execute is not execute:
            return it
        return _counted(self, it)
    execute._tpu_trace_hook = True
    return execute


def _counted(node: "PhysicalExec", it) -> Iterator:
    try:
        for b in it:
            node.count_output(b.num_rows)
            yield b
    finally:
        # a consumer that stops early closes this generator; close the
        # inner one now too, so its finally blocks (producer joins,
        # semaphore releases) run at once and not when gc frees it
        close = getattr(it, "close", None)
        if close is not None:
            close()


class ExecContext:
    """Per-execution state handed down the operator tree."""

    def __init__(self, conf: TpuConf, device: torch.device,
                 partition_id: int = 0, num_partitions: int = 1,
                 device_manager=None, cleanups: Optional[List] = None,
                 task_id: Optional[int] = None, host_engine: bool = False,
                 session_device: Optional[torch.device] = None,
                 cluster_shuffle=None, query=None):
        self.conf = conf
        self.device = device
        #: set while a CPU engine operator runs its device form on the
        #: host (execs/cpu_execs.py): ``device`` is then the CPU, host
        #: operators yield CPU DeviceBatches instead of HostBatches, and
        #: expressions take the JAX package's host-engine branches
        self.host_engine = host_engine
        #: the device the session's device operators run on
        self.session_device = session_device if session_device is not None \
            else device
        self.partition_id = partition_id
        self.num_partitions = num_partitions
        #: the process's memory manager (memory/device_manager.py), whose
        #: store chain holds the exchanges' map outputs
        self.device_manager = device_manager
        #: shared by the partitions of one action; the caller runs them when
        #: the action finishes (shuffle removal)
        self.cleanups = cleanups
        #: the owning task's id for the device-admission semaphore: the
        #: thread that starts the task. Threads an exec starts (the
        #: PipelinedExec producer) join this task's hold; their own ident,
        #: or a nested producer's, would take more permits and can
        #: deadlock admission.
        self.task_id = task_id if task_id is not None \
            else threading.get_ident()
        #: a cluster task's shuffle env and dep map statuses
        #: (parallel/cluster.py ``ClusterTaskContext``), which its shuffle
        #: reads fetch through; None outside the cluster
        self.cluster_shuffle = cluster_shuffle
        #: the serving QueryHandle driving this execution (None for a
        #: direct action): its cancellation and deadline, its tenant for
        #: the semaphore, its metrics
        self.query = query

    def check_cancelled(self) -> None:
        """The cooperative checkpoint at batch boundaries: raises
        QueryCancelledError / QueryTimeoutError once the owning query was
        cancelled or passed its deadline (a no-op for a direct action), so
        a cancelled query unwinds through the normal finally chain. The
        same sites are the preemption points: a preemptible query yields
        its permit here to a starved tenant (``QueryHandle.
        check_preempt``, a no-op unless serving.preemption.enabled)."""
        if self.query is not None:
            self.query.check_cancelled()
            self.query.check_preempt(self)

    @property
    def string_max_bytes(self) -> int:
        return self.conf.string_max_bytes

    def for_partition(self, partition_id: int,
                      num_partitions: int) -> "ExecContext":
        return ExecContext(self.conf, self.device, partition_id,
                           num_partitions, self.device_manager, self.cleanups,
                           self.task_id, self.host_engine,
                           self.session_device, self.cluster_shuffle,
                           self.query)

    def on_host(self) -> "ExecContext":
        """This context for the CPU engine: the CPU device, host batches as
        CPU DeviceBatches."""
        return ExecContext(self.conf, torch.device("cpu"), self.partition_id,
                           self.num_partitions, self.device_manager,
                           self.cleanups, self.task_id, True,
                           self.session_device, self.cluster_shuffle,
                           self.query)

    def on_session(self) -> "ExecContext":
        """This context for the session's device operators."""
        return ExecContext(self.conf, self.session_device, self.partition_id,
                           self.num_partitions, self.device_manager,
                           self.cleanups, self.task_id, False,
                           self.session_device, self.cluster_shuffle,
                           self.query)


class PhysicalExec:
    """Base physical operator: ``output`` is the produced schema; ``execute``
    yields the batches of one partition."""

    #: yields DeviceBatches (False for the host leaf and the download)
    is_device = True

    #: the size_estimate contract (tests/test_torch_out_of_core.py audits
    #: it): every exec class defines size_estimate below PhysicalExec, or
    #: says here why None is the only honest answer
    size_estimate_none_reason: Optional[str] = None

    #: plan-time out-of-core hint (plan/footprint.py): when > 0 the
    #: planner predicted this operator's working set over the device
    #: budget, and it grace-partitions its input into this many spillable
    #: partitions up front (memory/grace.py)
    grace_partitions: int = 0

    #: where this operator's batches live (parallel/placement.py): None for
    #: the session's device; the mesh rewrite sets the mesh operators'.
    #: Operators do not read it to run: it is the plan's declared contract,
    #: shown by ``tree_string``
    placement = None

    #: what adaptive execution (plan/adaptive.py) decided for this node
    #: ("coalesced 6→2", "skew-split p3×4", "broadcast-switch",
    #: "placement=cpu", "re-fused"), shown as ``[adaptive: …]`` by
    #: ``tree_string``
    adaptive_tag: str = ""

    #: the node's ordinal within one executed plan (pre-order, stamped by
    #: the action before it runs): the key its spans and EXPLAIN ANALYZE
    #: join on
    plan_id: Optional[int] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        raw = cls.__dict__.get("execute")
        if raw is not None and not getattr(raw, "_tpu_trace_hook", False):
            cls.execute = _traced_execute(raw)

    def __init__(self, children: Sequence["PhysicalExec"], output: Schema):
        self.children: Tuple[PhysicalExec, ...] = tuple(children)
        self.output = output
        self.metrics = MetricSet(NUM_OUTPUT_ROWS, NUM_OUTPUT_BATCHES,
                                 TOTAL_TIME)

    def count_output(self, num_rows: int) -> None:
        self.metrics[NUM_OUTPUT_ROWS].add(num_rows)
        self.metrics[NUM_OUTPUT_BATCHES].add(1)

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def num_partitions(self) -> int:
        """Output partition count; exchanges override."""
        return max((c.num_partitions for c in self.children), default=1)

    def execute(self, ctx: ExecContext) -> Iterator:
        raise NotImplementedError(self.name)

    def size_estimate(self) -> Optional[int]:
        """Estimated output bytes, or None when unknown (the JAX package's
        estimates, which the planner's broadcast choice reads: a side of
        unknown size is never broadcast). Narrowing operators pass their
        child's estimate through as an upper bound."""
        return None

    def working_set_estimate(self) -> Optional[int]:
        """Estimated peak device bytes while this operator runs: the
        footprint contract plan/footprint.py holds against the device
        budget. Streaming operators hold one batch at a time (None); the
        working-set operators (hash aggregate, hash joins, sort) give
        ``working_set_factor`` times the sum of their children's
        estimates."""
        return None

    def tree_string(self, indent: int = 0, analyze: bool = False) -> str:
        """The plan tree. ``analyze=True`` appends each node's observed
        rows, batches, wall and self time and grace spills, collected by
        the span hooks (EXPLAIN ANALYZE: the action must have run with
        trace.enabled)."""
        tag = ""
        if self.placement is not None:
            from spark_rapids_tpu_torch.parallel.placement import \
                placement_label
            tag = f" @{placement_label(self.placement)}"
        if self.adaptive_tag:
            tag += f" [adaptive: {self.adaptive_tag}]"
        if analyze:
            tag += _tracing.analyze_annotation(self)
        lines = ["  " * indent + f"{self.name} [{self.output}]{tag}"]
        lines += [c.tree_string(indent + 1, analyze=analyze)
                  for c in self.children]
        return "\n".join(lines)

    def with_children(self, children: Sequence["PhysicalExec"]
                      ) -> "PhysicalExec":
        import copy
        node = copy.copy(self)
        node.children = tuple(children)
        return node

    def transform_up(self, fn) -> "PhysicalExec":
        kids = [c.transform_up(fn) for c in self.children]
        node = self
        if tuple(kids) != self.children:
            node = self.with_children(kids)
        return fn(node)

    def walk(self) -> Iterator["PhysicalExec"]:
        yield self
        for c in self.children:
            yield from c.walk()


class LeafExec(PhysicalExec):
    def __init__(self, output: Schema):
        super().__init__((), output)
