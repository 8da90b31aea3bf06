"""Deterministic HBM-pressure fault injection for the out-of-core layer.

The chaos harness the grace-degradation paths are proved against, mirroring
``shuffle/faults.py``: a seeded, conf-driven ``MemoryFaultPlan`` describes
WHAT breaks and WHEN — the Nth working-set admission check of a matching
operator fails (``alloc_fail``), or the effective device budget shrinks to a
fraction of its real value (``budget_clamp``) — so every degradation path
(reactive partitioning, recursion, tier cascade) is reproducible in tests
under a fixed seed instead of depending on real HBM exhaustion.

conf::

    spark.rapids.tpu.memory.faults.plan = alloc_fail:op=agg,after=1;\
budget_clamp:fraction=0.25
    spark.rapids.tpu.memory.faults.seed = 7

Plan grammar: ``kind[:key=val[,key=val...]][;spec...]``. Kinds and their
injection points:

- ``alloc_fail``   — the Nth admission check (one per staged input batch in
  ``memory/grace.py``) of a matching operator reports failure, forcing the
  reactive out-of-core path exactly as a real RESOURCE_EXHAUSTED would.
- ``budget_clamp`` — every effective-budget read by a matching operator
  returns ``fraction`` of the real device budget (the shrunken-budget chaos
  mode: operators see a quarter-sized device without reconfiguring jax).

Keys: ``op`` (operator kind: ``agg`` | ``join`` | ``sort``, default ``*``),
``after`` (1-based Nth matching event, default 1), ``count`` (how many
consecutive events fire; ``0`` = every event from ``after`` on — the
default for ``budget_clamp``, whose documented semantics are a SUSTAINED
shrink; ``alloc_fail`` defaults to 1), ``fraction`` (budget_clamp only,
default 0.25). Event counters run PER OPERATOR KIND, so
``alloc_fail:after=2`` fires each kind's second check.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

OP_KINDS = ("agg", "join", "sort")
KINDS = ("alloc_fail", "budget_clamp")


@dataclass
class MemoryFaultSpec:
    """One scheduled fault; events ``after .. after+count-1`` (1-based, per
    operator kind) fire."""
    kind: str
    op: str = "*"
    after: int = 1
    count: int = 1
    fraction: float = 0.25

    def matches(self, op: str) -> bool:
        return self.op in ("*", op)

    def fires(self, event_num: int) -> bool:
        if event_num < self.after:
            return False
        return self.count == 0 or event_num < self.after + self.count

    @staticmethod
    def parse(text: str) -> "MemoryFaultSpec":
        kind, _, rest = text.strip().partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown memory fault kind {kind!r}; "
                             f"known: {KINDS}")
        spec = MemoryFaultSpec(kind)
        if kind == "budget_clamp":
            # a clamp is a sustained condition, not a one-shot event: with
            # no explicit count it applies to EVERY read from `after` on
            spec.count = 0
        if rest:
            for kv in rest.split(","):
                key, _, val = kv.partition("=")
                key = key.strip()
                if key == "op":
                    if val.strip() not in OP_KINDS + ("*",):
                        raise ValueError(f"unknown op {val!r} in {text!r}; "
                                         f"known: {OP_KINDS}")
                    spec.op = val.strip()
                elif key == "after":
                    spec.after = int(val)
                elif key == "count":
                    spec.count = int(val)
                elif key == "fraction":
                    spec.fraction = float(val)
                    if not (0.0 < spec.fraction <= 1.0):
                        raise ValueError(
                            f"fraction must be in (0, 1], got {val}")
                else:
                    raise ValueError(
                        f"unknown memory fault key {key!r} in {text!r}")
        return spec


#: bound on the ``fired`` log: a sustained budget_clamp (count=0) fires on
#: every budget read for the life of a chaos run — the log exists for test
#: assertions on the schedule's HEAD, not as an unbounded event trace
_FIRED_CAP = 4096


class MemoryFaultPlan:
    """The full pressure schedule: specs + per-(spec, op) event counters.
    ``fired`` records injected faults (capped at ``_FIRED_CAP``) for test
    assertions. The schedule is fully deterministic from the spec text;
    ``seed`` is the schedule's IDENTITY — a different seed keys a fresh
    plan (fresh event counters) in the process cache, the same pair
    replays the same run."""

    def __init__(self, specs: Tuple[MemoryFaultSpec, ...] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self._counts: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, int]] = []   # (kind, op, event#)

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "MemoryFaultPlan":
        specs = [MemoryFaultSpec.parse(s) for s in text.split(";")
                 if s.strip()]
        return cls(tuple(specs), seed)

    @property
    def empty(self) -> bool:
        return not self.specs

    def _advance(self, kinds: Tuple[str, ...], op: str
                 ) -> List[MemoryFaultSpec]:
        hits: List[MemoryFaultSpec] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.kind not in kinds or not spec.matches(op):
                    continue
                key = (i, op)
                n = self._counts.get(key, 0) + 1
                self._counts[key] = n
                if spec.fires(n):
                    if len(self.fired) < _FIRED_CAP:
                        self.fired.append((spec.kind, op, n))
                    hits.append(spec)
        return hits

    # ---- probes (each is ONE countable event at its injection point) -------
    def on_admission(self, op: str) -> bool:
        """alloc_fail probe: True when this working-set admission check must
        report failure (one event per staged input batch)."""
        return bool(self._advance(("alloc_fail",), op))

    def clamp_budget(self, op: str, budget: int) -> int:
        """budget_clamp probe: the effective device budget a matching
        operator sees. NOT a countable event — a clamp applies to every
        read in its window, so the window is advanced per read but a
        fraction is applied whenever any matching clamp is live."""
        hits = self._advance(("budget_clamp",), op)
        for spec in hits:
            budget = int(budget * spec.fraction)
        return budget


_PLANS: Dict[Tuple[str, int], MemoryFaultPlan] = {}
_PLANS_LOCK = threading.Lock()


def plan_for_conf(conf) -> MemoryFaultPlan:
    """The process-wide plan for a conf's (plan, seed) pair. One instance
    per pair so event counters span a whole chaos run (queries, operators)
    exactly like a transport-lifetime shuffle FaultPlan; tests start a
    fresh schedule via ``reset_plans()`` or a different seed."""
    from spark_rapids_tpu_torch import config as cfg
    text = conf.get(cfg.MEMORY_FAULTS_PLAN)
    seed = conf.get(cfg.MEMORY_FAULTS_SEED)
    if not text:
        return _EMPTY_PLAN
    key = (text, seed)
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is None:
            plan = MemoryFaultPlan.parse(text, seed)
            _PLANS[key] = plan
        return plan


def reset_plans() -> None:
    """Drop every cached plan (fresh event counters for the next run)."""
    with _PLANS_LOCK:
        _PLANS.clear()


_EMPTY_PLAN = MemoryFaultPlan()
