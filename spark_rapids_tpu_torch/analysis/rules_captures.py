"""R016–R018: program-cache key soundness over the capture-provenance
engine (``analysis/captures.py``).

The serving tier's correctness claims — cross-query program reuse, the
on-disk cross-process plan-key index, fused-stage bit-identity,
warm-start replicas — all rest on one invariant: a cached XLA program
observes nothing that is not part of its cache key.  These rules
machine-check that invariant the way R012 checks locks and R013–R015
check the failure ladder.

R016  cache-key incompleteness — a builder closure captures a value
      with no sanctioned provenance (not key-derived, not a traced
      argument, not provably constant).  Two call sites with different
      values share one specialization; the second silently serves the
      first's stale program.  Wrong *results*, not wrong performance:
      the highest-severity rule in the catalog.

R017  mutable capture by reference — the trace snapshots a list / dict /
      ndarray / attribute at compile time; in-place write sites
      elsewhere in the package mutate the object behind the snapshot,
      and a repr-recomputed key may not reflect it (ndarray reprs
      truncate).

R018  trace-time side effects — metric bumps, tracer spans,
      ``absorb()``, lock acquisition, host I/O inside a traced body run
      once per *compile*, not per call: the effect silently vanishes on
      every cache hit (lost observability) or, worse, deadlocks the
      compile path.
"""
from typing import List, Sequence

from spark_rapids_tpu_torch.analysis.captures import capture_analysis
from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            register)


@register
class CacheKeyIncompleteRule(Rule):
    rule_id = "R016"
    title = ("cached-program builder captures a value not derivable from "
             "its cache key (stale-specialization wrong-results hazard)")
    is_project_rule = True
    help_anchor = "r016"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        _, sites = capture_analysis(files)
        out: List[Finding] = []
        for site in sites:
            for cap in site.captures:
                if cap.origin is not None:
                    continue
                via = f" ({cap.via})" if cap.via else ""
                out.append(cap.src.finding(
                    self.rule_id, cap.node,
                    f"program cached via {site.route}() at line "
                    f"{site.line} captures '{cap.path}'{via}, which is "
                    "not derivable from the cache key — a stale "
                    "specialization serves wrong results when it "
                    "changes; widen the key, hoist it to a traced "
                    "argument, or pin it as a keyed default"))
        return out


@register
class MutableCaptureRule(Rule):
    rule_id = "R017"
    title = ("traced program captures a mutable object by reference "
             "while the package mutates it in place")
    is_project_rule = True
    help_anchor = "r017"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        analyzer, sites = capture_analysis(files)
        out: List[Finding] = []
        for site in sites:
            for cap, why in analyzer.mutable_hazards(site):
                out.append(cap.src.finding(
                    self.rule_id, cap.node,
                    f"trace built via {site.route}() at line {site.line} "
                    f"captures mutable '{cap.path}' by reference — {why}; "
                    "the compiled program snapshots it at trace time and "
                    "never sees the mutation — key an immutable copy "
                    "(tuple/frozen) or pass it as a traced argument"))
        return out


@register
class TraceTimeEffectRule(Rule):
    rule_id = "R018"
    title = ("side effect inside a traced body runs once per compile, "
             "not per call")
    is_project_rule = True
    help_anchor = "r018"

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        _, sites = capture_analysis(files)
        out: List[Finding] = []
        seen = set()
        for site in sites:
            for eff in site.effects:
                key = (eff.src.display_path, eff.node.lineno, eff.kind)
                if key in seen:         # one site per effect even when
                    continue            # several routes share the body
                seen.add(key)
                out.append(eff.src.finding(
                    self.rule_id, eff.node,
                    f"{eff.desc} inside the traced body of the "
                    f"{site.route}() program at line {site.line} — jit "
                    "replays the traced result and the effect runs once "
                    "per compile, not per call; hoist it out of the "
                    "trace"))
        return out
