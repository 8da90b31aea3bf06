"""R013–R015: failure-ladder conformance, machine-checked.

The escalation ladder (transfer retry → stage recompute → replica failover)
only works if its signals actually ARRIVE at the rung that triages them.
These rules consume the may-raise fixpoint (analysis/exceptions.py) and the
declared taxonomy (utils/errors.py) to check three contracts:

R013 swallowed-escalation-signal — an ``except`` clause that catches a
    may-raised ladder signal (ShuffleFetchFailedError, ChecksumError,
    WireQueryError, SpillCorruptionError, QueryCancelledError) and neither
    re-raises it, converts it to another classified type, nor reaches a
    registered ``@triage_boundary`` breaks the ladder silently.  A broad
    ``except Exception`` on a path where a signal may-raise needs an
    isinstance triage (the bare-``raise`` branch makes the re-raise visible
    to the engine) or a justified inline suppression.

R014 classification conformance — exception classes arriving at a declared
    ``@triage_boundary`` must be taxonomy-registered (the boundary routes by
    classification; an unregistered type has none), and converting a
    CANCELLATION-classified exception into a RETRYABLE/ESCALATION_SIGNAL
    type is always a finding: a cancelled query must never be retried into
    life.

R015 wire-boundary serializability — package exception types that may-raise
    into a declared ``@wire_boundary`` (executor-daemon control socket,
    serving wire) must carry a registered wire codec; anything else degrades
    to OpaqueWireError on the far side, losing its classification and its
    structured payload.  Flagged at the raise site, where the fix (register
    the type) belongs.

All three inherit the engine's under-approximation: unresolvable calls
contribute no may-raise facts, so every finding rests on an actual resolved
raise path — the errs-toward-silence discipline of R009–R012.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            register)
from spark_rapids_tpu_torch.analysis.exceptions import (ExceptionFlow, HandlerFlow,
                                                  raises_for)
from spark_rapids_tpu_torch.utils import errors as taxonomy

#: call-graph hops from a handler body to a triage boundary that still count
#: as "reaching" it (the handler delegates the decision, it does not hide it)
_TRIAGE_HOPS = 3


def _boundary_keys(flow: ExceptionFlow, marker: str) -> Set[str]:
    return {info.key for info in flow.decorated(marker)}


def _local_calls(stmts: Sequence[ast.stmt]):
    """Call nodes in the given statements, excluding nested def/lambda/class
    bodies (they do not run on the handler's path)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _reaches_triage(flow: ExceptionFlow, hf: HandlerFlow,
                    triage_keys: Set[str]) -> bool:
    """The handler body calls into a registered triage boundary (directly
    or within a few hops — delegating the routing decision is fine)."""
    targets: List[str] = []
    for call in _local_calls(hf.handler.body):
        targets.extend(flow.graph.resolve_call(hf.func, call))
    if not targets:
        return False
    return bool(flow.graph.reachable(targets, max_depth=_TRIAGE_HOPS)
                & triage_keys)


@register
class SwallowedEscalationSignal(Rule):
    rule_id = "R013"
    title = "except clause swallows a may-raised escalation-ladder signal"
    is_project_rule = True
    help_anchor = "r013"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        flow = raises_for(files)
        signals = set(taxonomy.ladder_signals())
        classified = {s.name for s in taxonomy.TAXONOMY}
        boundary = (_boundary_keys(flow, "triage_boundary")
                    | _boundary_keys(flow, "wire_boundary"))
        triage = _boundary_keys(flow, "triage_boundary")
        findings: List[Finding] = []
        for hf in flow.handler_flows:
            sig = sorted(hf.caught & signals)
            if not sig:
                continue
            if hf.func.key in boundary:
                continue                     # the handler IS the triage
            if hf.raised & (set(sig) | classified):
                continue                     # re-raises or converts
            if _reaches_triage(flow, hf, triage):
                continue                     # delegates the routing
            clause = ", ".join(hf.clause_names)
            findings.append(hf.func.src.finding(
                self.rule_id, hf.handler,
                f"{hf.func.qualname}: except {clause} absorbs "
                f"{', '.join(sig)} — a ladder signal that a higher rung "
                f"must triage (retry/recompute/failover). Re-raise it, "
                f"convert it to a taxonomy-registered type, route it to a "
                f"@triage_boundary function, or add an isinstance triage "
                f"with a bare `raise` for the signal branch; if this "
                f"swallow is genuinely safe, justify it with an inline "
                f"suppression"))
        return findings


@register
class ClassificationConformance(Rule):
    rule_id = "R014"
    title = "unclassified or mis-converted exception at a triage boundary"
    is_project_rule = True
    help_anchor = "r014"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        flow = raises_for(files)
        triage = _boundary_keys(flow, "triage_boundary")
        cancel = {s.name for s in taxonomy.TAXONOMY
                  if s.classification == taxonomy.CANCELLATION}
        retry_like = {s.name for s in taxonomy.TAXONOMY
                      if s.classification in (taxonomy.RETRYABLE,
                                              taxonomy.ESCALATION_SIGNAL)}
        findings: List[Finding] = []

        # (a) cancellation laundering: always a finding, boundary or not
        for conv in flow.conversions:
            cancelled = sorted(conv.caught & cancel)
            if cancelled and conv.to_name in retry_like:
                findings.append(conv.func.src.finding(
                    self.rule_id, conv.node,
                    f"{conv.func.qualname}: handler converts "
                    f"{', '.join(cancelled)} (CANCELLATION) into "
                    f"{conv.to_name} (retryable) — a cancelled query must "
                    f"never be retried into life. Re-raise the "
                    f"cancellation, or narrow the except clause so it "
                    f"never catches one"))

        # (b) package exception classes arriving at a triage boundary must
        #     be taxonomy-registered (the boundary routes by classification)
        flagged: Set[str] = set()
        for hf in flow.handler_flows:
            if hf.func.key not in triage:
                continue
            for cname in sorted(hf.caught):
                if cname in flagged or cname not in flow.graph.classes:
                    continue
                if not flow.hierarchy.is_exception_class(cname):
                    continue
                if taxonomy.spec_by_name(cname) is not None:
                    continue
                flagged.add(cname)
                site = flow.raise_sites.get(cname, [None])[0]
                anchor_src = site.func.src if site else hf.func.src
                anchor = site.node if site else hf.handler
                where = (f"raised in {site.func.qualname}" if site
                         else "raised upstream")
                findings.append(anchor_src.finding(
                    self.rule_id, anchor,
                    f"{cname} ({where}) arrives at triage boundary "
                    f"{hf.func.qualname} but is not registered in the "
                    f"utils/errors.py taxonomy — the boundary cannot "
                    f"classify it as retryable/permanent/cancellation. "
                    f"Register the class with a classification (and wire "
                    f"code if it crosses a process boundary)"))
        return findings


@register
class WireBoundarySerializability(Rule):
    rule_id = "R015"
    title = "exception without a wire codec may-raises across a process boundary"
    is_project_rule = True
    help_anchor = "r015"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        flow = raises_for(files)
        wire = _boundary_keys(flow, "wire_boundary")
        findings: List[Finding] = []
        flagged: Set[Tuple[str, str]] = set()
        for hf in flow.handler_flows:
            if hf.func.key not in wire:
                continue
            for cname in sorted(hf.caught):
                if cname not in flow.graph.classes:
                    continue                 # builtins degrade by design
                if not flow.hierarchy.is_exception_class(cname):
                    continue
                spec = taxonomy.spec_by_name(cname)
                if spec is not None and spec.wire_code:
                    continue
                dedup = (cname, hf.func.key)
                if dedup in flagged:
                    continue
                flagged.add(dedup)
                site = flow.raise_sites.get(cname, [None])[0]
                anchor_src = site.func.src if site else hf.func.src
                anchor = site.node if site else hf.handler
                findings.append(anchor_src.finding(
                    self.rule_id, anchor,
                    f"{cname} may-raises across wire boundary "
                    f"{hf.func.qualname} with no registered wire codec — "
                    f"it degrades to OpaqueWireError (non-retryable, no "
                    f"structured payload) on the far side. Register it in "
                    f"utils/errors.py with a wire code and codec fields, "
                    f"or convert it to a registered type before the "
                    f"boundary"))
        return findings
