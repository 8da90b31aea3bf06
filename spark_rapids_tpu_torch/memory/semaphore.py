"""Device-admission semaphore (the JAX package's ``memory/semaphore.py``;
GpuSemaphore in the reference plugin): at most ``sql.concurrentTpuTasks``
tasks hold the device at once. A task is a host thread driving device work,
or the producer threads it starts, which pass its task id and join its
hold. Re-entrant per task: a task that already holds a permit does not take
a second one (acquireIfNecessary semantics).

Waiters queue per tenant, and a freed permit goes to the tenant with the
lowest served/weight deficit, FIFO within a tenant (utils/fair_share.py).
Callers that pass no tenant share the default tenant: plain FIFO. A waiter
may pass ``cancel_check``; it runs periodically while blocked and whatever
it raises unwinds the wait.

Batch-granularity preemption (the serving layer's): a running query polls
``has_starved_waiter`` at its exec-boundary checkpoints and, when another
tenant's head-of-line waiter has starved, ``yield_to_waiters`` hands its
permit over and takes it back under fair share.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Set

from spark_rapids_tpu_torch.utils.fair_share import (activation_reset,
                                                     pick_tenant)

_DEFAULT_TENANT = "default"
_POLL_S = 0.05


class TpuSemaphore:
    def __init__(self, max_concurrent: int):
        if max_concurrent <= 0:
            raise ValueError("max_concurrent must be positive")
        self.max_concurrent = max_concurrent
        self._cond = threading.Condition()
        self._holders: Set[int] = set()
        self._nesting: Dict[int, int] = {}
        #: tasks mid-yield (yield_to_waiters): not holding a permit, but
        #: their nesting ledger stays live so sibling threads entering or
        #: exiting scoped holds during the yield keep it balanced
        self._yielding: Set[int] = set()
        self._seq = 0
        #: tenant -> FIFO of waiting ticket ids
        self._waiters: Dict[str, deque] = {}
        #: ticket -> monotonic enqueue time (starvation detection for the
        #: preemption checkpoints; removed with the ticket)
        self._wait_since: Dict[int, float] = {}
        #: weighted admission counters and weights (fair-share state)
        self._served: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}

    def _task_id(self, task_id: Optional[int]) -> int:
        return task_id if task_id is not None else threading.get_ident()

    # ---- fair-share policy -----------------------------------------------
    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._cond:
            self._weights[tenant] = float(weight)
            self._cond.notify_all()

    def _next_tenant_locked(self) -> Optional[str]:
        return pick_tenant((t for t, q in self._waiters.items() if q),
                           self._served, self._weights)

    def _may_admit_locked(self, ticket: int, tenant: str) -> bool:
        if len(self._holders) >= self.max_concurrent:
            return False
        q = self._waiters.get(tenant)
        if not q or q[0] != ticket:
            return False
        return self._next_tenant_locked() == tenant

    def _enqueue_locked(self, tenant: str) -> int:
        if not self._waiters.get(tenant):
            # deficit round-robin activation reset: a newcomer cannot jump
            # ahead of standing backlogs, nor is a returning tenant starved
            # by its own history
            activation_reset(tenant,
                             (t for t, w in self._waiters.items() if w),
                             self._served, self._weights)
        ticket = self._seq
        self._seq += 1
        self._waiters.setdefault(tenant, deque()).append(ticket)
        self._wait_since[ticket] = time.monotonic()
        return ticket

    def _dequeue_locked(self, ticket: int, tenant: str) -> None:
        q = self._waiters.get(tenant)
        self._wait_since.pop(ticket, None)
        if q is not None:
            try:
                q.remove(ticket)
            except ValueError:
                pass
            if not q:
                del self._waiters[tenant]

    def _wait_turn_locked(self, tid: int, ticket: int, tenant: str,
                          timeout: Optional[float],
                          cancel_check: Optional[Callable[[], None]]) -> bool:
        """Block until this ticket is the fair-share pick (or the task
        already holds a permit through another thread). Runs under the
        condition. False on timeout; re-raises what cancel_check raises."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None

        def ready() -> bool:
            return tid in self._holders or \
                self._may_admit_locked(ticket, tenant)

        while not ready():
            if cancel_check is not None:
                cancel_check()
            wait = _POLL_S if cancel_check is not None else timeout
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                wait = left if wait is None else min(wait, left)
            self._cond.wait(wait)
        return True

    def _admit_locked(self, tid: int, ticket: int, tenant: str) -> None:
        self._dequeue_locked(ticket, tenant)
        if tid not in self._holders:
            self._holders.add(tid)
            self._served[tenant] = self._served.get(tenant, 0.0) + 1.0
        # our departure may unblock another tenant's head of line
        self._cond.notify_all()

    # ---- acquire/release --------------------------------------------------
    def acquire_if_necessary(self, task_id: Optional[int] = None,
                             timeout: Optional[float] = None,
                             tenant: str = _DEFAULT_TENANT,
                             cancel_check: Optional[Callable[[], None]] = None
                             ) -> bool:
        """Idempotent per task; the holder check and the permit take are one
        step under the condition. ``timeout=0`` is a non-blocking try."""
        tid = self._task_id(task_id)
        with self._cond:
            if tid in self._holders:
                return True
            ticket = self._enqueue_locked(tenant)
            try:
                ok = self._wait_turn_locked(tid, ticket, tenant, timeout,
                                            cancel_check)
            except BaseException:
                self._dequeue_locked(ticket, tenant)
                self._cond.notify_all()
                raise
            if not ok:
                self._dequeue_locked(ticket, tenant)
                self._cond.notify_all()
                return False
            self._admit_locked(tid, ticket, tenant)
            return True

    def release_if_necessary(self, task_id: Optional[int] = None) -> None:
        tid = self._task_id(task_id)
        with self._cond:
            if tid in self._holders:
                self._holders.remove(tid)
                self._nesting.pop(tid, None)
                self._cond.notify_all()

    @contextmanager
    def held(self, task_id: Optional[int] = None,
             tenant: str = _DEFAULT_TENANT,
             cancel_check: Optional[Callable[[], None]] = None):
        """Scoped hold with per-task nesting: threads sharing a task id each
        enter and exit, and the permit is released only when the last one
        exits."""
        tid = self._task_id(task_id)
        with self._cond:
            if tid in self._holders or tid in self._yielding:
                # held, or mid-preemption-yield: join the task's live
                # nesting ledger instead of queueing for a permit the
                # task takes back anyway
                self._nesting[tid] = self._nesting.get(tid, 1) + 1
            else:
                ticket = self._enqueue_locked(tenant)
                try:
                    self._wait_turn_locked(tid, ticket, tenant, None,
                                           cancel_check)
                except BaseException:
                    self._dequeue_locked(ticket, tenant)
                    self._cond.notify_all()
                    raise
                self._dequeue_locked(ticket, tenant)
                if tid in self._holders:
                    # a sibling thread of this task was admitted while we
                    # queued: nest (1 covers a sibling that entered through
                    # acquire_if_necessary, which records no nesting)
                    self._nesting[tid] = self._nesting.get(tid, 1) + 1
                else:
                    self._holders.add(tid)
                    self._served[tenant] = self._served.get(tenant, 0.0) + 1.0
                    self._nesting[tid] = 1
                self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                n = self._nesting.get(tid, 0) - 1
                if n <= 0:
                    self._nesting.pop(tid, None)
                    if tid in self._holders:
                        self._holders.remove(tid)
                        self._cond.notify_all()
                else:
                    self._nesting[tid] = n

    # ---- batch-granularity preemption -------------------------------------
    def holds_permit(self, task_id: Optional[int] = None) -> bool:
        """Whether the task holds a permit now: a non-holder has nothing
        to yield (and must not park the device store for other
        holders)."""
        tid = self._task_id(task_id)
        with self._cond:
            return tid in self._holders

    def has_starved_waiter(self, exclude_tenant: str = _DEFAULT_TENANT,
                           min_wait_s: float = 0.05) -> bool:
        """True when another tenant's head-of-line waiter has waited for
        admission at least ``min_wait_s``."""
        now = time.monotonic()
        with self._cond:
            for tenant, q in self._waiters.items():
                if tenant == exclude_tenant or not q:
                    continue
                since = self._wait_since.get(q[0])
                if since is not None and now - since >= min_wait_s:
                    return True
        return False

    def yield_to_waiters(self, task_id: Optional[int] = None,
                         tenant: str = _DEFAULT_TENANT,
                         cancel_check: Optional[Callable[[], None]] = None
                         ) -> bool:
        """Release this task's permit, let fair-share admission hand it to
        the starved head of line, then take it back. The nesting ledger
        stays live through the yield (``_yielding`` marks the task), so
        producer threads sharing the hold may enter or exit their scoped
        holds meanwhile and the last exit still releases once. False when
        the task held no permit. Cancelled mid-yield, the permit is not
        taken back; the unwinding scopes find no hold to release."""
        tid = self._task_id(task_id)
        with self._cond:
            if tid not in self._holders:
                return False
            self._holders.remove(tid)
            self._yielding.add(tid)
            ticket = self._enqueue_locked(tenant)
            self._cond.notify_all()
            try:
                self._wait_turn_locked(tid, ticket, tenant, None,
                                       cancel_check)
            except BaseException:
                self._yielding.discard(tid)
                self._dequeue_locked(ticket, tenant)
                self._cond.notify_all()
                raise
            self._yielding.discard(tid)
            self._dequeue_locked(ticket, tenant)
            if tid not in self._holders:
                # an acquire_if_necessary sibling may have taken the hold
                # back while we queued; otherwise the permit is ours again
                self._holders.add(tid)
                self._served[tenant] = self._served.get(tenant, 0.0) + 1.0
            self._cond.notify_all()
            return True

    @property
    def active_holders(self) -> int:
        with self._cond:
            return len(self._holders)

    @property
    def waiting(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._waiters.values())
