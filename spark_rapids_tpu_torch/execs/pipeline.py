"""Bounded-async dispatch between operators (the JAX package's
``execs/pipeline.py``).

The exec iterator protocol is strict pull-per-batch lockstep: the consumer
asks for batch N+1 only after it has finished with batch N, so the upload's
host staging, the host link and device compute take turns. ``PipelinedExec``
(planner-inserted over each upload, plan/overrides.py ``insert_pipeline``;
``spark.rapids.tpu.transfer.pipeline.*``) runs its child's iterator on a
producer thread with a bounded queue of ``depth`` batches. The producer
joins the consuming task's device-admission hold (``ctx.task_id``), so
admission still sees one task, and a nested pipeline under one permit does
not deadlock.

On CUDA the producer makes the context's device current in its thread and
issues its copies on that device's current stream, which is the default
stream the consumer's kernels run on too: stream order puts every upload
before the kernels that read it, so the batch needs no event or
``record_stream``.

The contract of the synchronous protocol holds:
- batch order: one FIFO queue, one producer;
- errors: a producer exception re-raises at the consumer's next pull;
- early exit: a consumer that abandons the iterator (a limit) stops the
  producer and closes the child generator instead of leaking the thread.
"""
from __future__ import annotations

import queue
import threading
from contextlib import ExitStack
from typing import Iterator

import torch

from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec

_POLL_S = 0.05
#: how often a consumer waiting for its producer checks that it still runs
_LIVENESS_S = 1.0


def _get_live(q: "queue.Queue", worker: threading.Thread,
              cancel_check=None):
    """The producer's next item. The producer puts an item, an error or
    its end before it returns, so a producer thread that is gone with the
    queue empty is a fault: it raises here instead of blocking the
    consumer forever. ``cancel_check`` runs between polls, so a cancelled
    consumer unwinds even while its producer is wedged."""
    while True:
        try:
            return q.get(timeout=_LIVENESS_S)
        except queue.Empty:
            if cancel_check is not None:
                cancel_check()
            if worker.is_alive():
                continue
            try:
                return q.get_nowait()
            except queue.Empty:
                raise RuntimeError(
                    f"producer thread {worker.name} ended without its "
                    "result") from None


def _put_abortable(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """A bounded put that gives up when the consumer went away: the producer
    never blocks forever on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


class PipelinedExec(PhysicalExec):
    """Keeps up to ``depth`` child batches in flight ahead of the
    consumer."""

    def __init__(self, child: PhysicalExec, depth: int = 2):
        super().__init__((child,), child.output)
        self.depth = depth

    @property
    def name(self) -> str:
        return f"PipelinedExec(depth={self.depth})"

    def size_estimate(self):
        return self.children[0].size_estimate()

    def execute(self, ctx: ExecContext) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        dm = ctx.device_manager

        def produce() -> None:
            from spark_rapids_tpu_torch.serving.lifecycle import bind_query
            query = ctx.query
            src = None
            try:
                with ExitStack() as scope:
                    # the consumer's query on this thread too: the kernel
                    # launches and cache lookups of the producer's work are
                    # attributed to it, and a cancel stops the producer at
                    # its next batch
                    scope.enter_context(bind_query(query))
                    if ctx.device.type == "cuda":
                        scope.enter_context(torch.cuda.device(ctx.device))
                    if dm is not None:
                        # the owning task's hold: the same task id nests
                        # instead of taking a second permit
                        scope.enter_context(dm.semaphore.held(
                            task_id=ctx.task_id,
                            tenant=(query.tenant if query is not None
                                    else "default"),
                            cancel_check=(query.check_cancelled
                                          if query is not None else None)))
                    src = self.children[0].execute(ctx)
                    for b in src:
                        ctx.check_cancelled()
                        if not _put_abortable(q, ("b", b), stop):
                            return
            except BaseException as e:  # noqa: BLE001 - re-raised by consumer
                _put_abortable(q, ("e", e), stop)
                return
            finally:
                close = getattr(src, "close", None)
                if close is not None:
                    close()     # run the child generator's cleanup
            _put_abortable(q, ("end", None), stop)

        worker = threading.Thread(target=produce, daemon=True,
                                  name="exec-pipeline")
        worker.start()
        try:
            while True:
                kind, val = _get_live(q, worker, ctx.check_cancelled)
                if kind == "end":
                    return
                if kind == "e":
                    raise val
                yield val
        finally:
            # normal end, consumer exception or GeneratorExit: stop the
            # producer and drain so that a blocked put wakes up
            stop.set()
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(_POLL_S)
