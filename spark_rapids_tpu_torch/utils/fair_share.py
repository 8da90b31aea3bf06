"""Weighted deficit round-robin primitives.

ONE fairness policy shared by the two admission layers — the serving
scheduler's query queues and the device-admission semaphore's waiter
queues — so their semantics cannot drift apart. Both layers keep their
own locking and queue structures; these helpers are pure functions over
(tenants, served-counters, weights).

Semantics:
- the next tenant served is the one with the lowest ``served / weight``
  deficit (a tenant with weight 3 is served three times as often as a
  tenant with weight 1 under contention); ties break deterministically
  by tenant name;
- FIFO within a tenant is the caller's queue discipline;
- on ACTIVATION (a tenant's queue going empty -> non-empty) the tenant's
  deficit resets to the current minimum over the other active tenants: a
  newcomer cannot jump ahead of standing backlogs by arriving with zero
  history, and a returning tenant is not starved while the others "catch
  up" to its long-served past (standard DRR counter reset, adapted to
  weighted deficits). A tenant activating alone resets to zero.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional


def weight_of(weights: Dict[str, float], tenant: str) -> float:
    return weights.get(tenant, 1.0)


def pick_tenant(active: Iterable[str], served: Dict[str, float],
                weights: Dict[str, float]) -> Optional[str]:
    """The active tenant with the lowest weighted deficit (None if no
    tenant is active)."""
    active = list(active)
    if not active:
        return None
    return min(active, key=lambda t: (served.get(t, 0.0)
                                      / weight_of(weights, t), t))


def activation_reset(tenant: str, active_others: Iterable[str],
                     served: Dict[str, float],
                     weights: Dict[str, float]) -> None:
    """Reset ``tenant``'s deficit as it (re)activates: join at the
    minimum deficit of the OTHER currently-active tenants (zero when
    alone). Mutates ``served`` in place; call under the owning lock."""
    others = [t for t in active_others if t != tenant]
    if others:
        floor = min(served.get(t, 0.0) / weight_of(weights, t)
                    for t in others)
    else:
        floor = 0.0
    served[tenant] = floor * weight_of(weights, tenant)
