"""R011: metric-registry drift — the metrics analog of R004 config drift.

Every dotted ``"section.name"`` counter is declared once in
utils/metrics.py (``NAME = "section.name"``) and listed in its section's
``*_METRIC_NAMES`` registry tuple; the per-action delta surfaces
(``session.last_metrics[section]`` / ``QueryHandle.exec_metrics``) iterate
THE TUPLE, not the bump sites. Two drift modes, both of which ship
silently:

- a counter is bumped somewhere in the package (``X_METRICS[NAME].add``)
  but its name is missing from the registry tuple — the bump happens and
  no snapshot/delta ever reports it: observability that looks wired but
  is invisible;
- a registry entry has NO bump site anywhere — the section reports a
  counter that is always zero, and dashboards trust a dead number.

Scope: dotted lowercase ``section.name`` metrics only (the process-global
MetricSet sections). CamelCase per-operator metric names
(``numOutputRows``) live on per-exec MetricSets with different reporting
paths, and per-query snake_case handle keys are dict literals — both out
of scope. A bump site is ``<...>_METRICS[<key>].add(...)`` or
``.set_max(...)`` where ``<key>`` is a declared constant (by name,
module-qualified or bare) or a dotted string literal.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            register)

#: a metrics name in scope: lowercase dotted section.name
_DOTTED = re.compile(r"^[a-z][a-z0-9_]*\.[a-z0-9_.]+$")

_REGISTRY_SUFFIX = "_METRIC_NAMES"
_BUMP_METHODS = ("add", "set_max")


def _find_metrics_file(files: Sequence[SourceFile]) -> Optional[SourceFile]:
    for f in files:
        p = f.display_path.replace("\\", "/")
        if p.endswith("utils/metrics.py") or p == "metrics.py":
            return f
    return None


def metric_constants(metrics_src: SourceFile) -> Dict[str, str]:
    """constant name -> dotted metric value from top-level
    ``NAME = "section.name"`` assignments in utils/metrics.py."""
    out: Dict[str, str] = {}
    for node in metrics_src.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            continue
        val = node.value.value
        if not _DOTTED.match(val):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                out[target.id] = val
    return out


def registry_entries(metrics_src: SourceFile, consts: Dict[str, str]
                     ) -> Dict[str, Tuple[str, int]]:
    """dotted metric name -> (registry tuple name, lineno) from the
    ``X_METRIC_NAMES = (A, B, ...)`` tuples (dotted members only)."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in metrics_src.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if not (isinstance(target, ast.Name)
                and target.id.endswith(_REGISTRY_SUFFIX)):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            continue
        for elt in node.value.elts:
            name = None
            if isinstance(elt, ast.Name):
                name = consts.get(elt.id)
            elif isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                name = elt.value
            if name is not None and _DOTTED.match(name):
                out[name] = (target.id, elt.lineno)
    return out


def _metric_set_aliases(src: SourceFile) -> Set[str]:
    """Local names bound to a metric set (``m = um.TRANSFER_METRICS``) —
    file-scoped, so the subscript recognizer sees through the common
    hot-loop alias idiom."""
    out: Set[str] = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        vname = v.attr if isinstance(v, ast.Attribute) else (
            v.id if isinstance(v, ast.Name) else "")
        if not vname.endswith("_METRICS"):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _resolve_keys(key: ast.AST, consts: Dict[str, str]
                  ) -> List[Tuple[Optional[str], bool]]:
    """Dotted names a subscript key may evaluate to (an IfExp resolves
    both branches). ``(None, False)`` marks an unresolvable computed key —
    skipped, under-approximate like the call-graph rules."""
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return [(key.value, True)]
    if isinstance(key, ast.Name):
        val = consts.get(key.id)
        return [(val, val is not None)]
    if isinstance(key, ast.Attribute):
        val = consts.get(key.attr)
        return [(val, val is not None)]
    if isinstance(key, ast.IfExp):
        return (_resolve_keys(key.body, consts)
                + _resolve_keys(key.orelse, consts))
    return [(None, False)]


def _bump_keys(node: ast.Call, consts: Dict[str, str], aliases: Set[str]
               ) -> Optional[List[Tuple[Optional[str], bool]]]:
    """The dotted metric names this call bumps, or None when it is not a
    ``<...>_METRICS[key].add/set_max(...)`` bump at all."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr in _BUMP_METHODS):
        return None
    sub = func.value
    if not isinstance(sub, ast.Subscript):
        return None
    base = sub.value
    base_name = base.attr if isinstance(base, ast.Attribute) else (
        base.id if isinstance(base, ast.Name) else "")
    if not (base_name.endswith("_METRICS") or base_name in aliases):
        return None
    return _resolve_keys(sub.slice, consts)


@register
class MetricRegistryDrift(Rule):
    rule_id = "R011"
    title = "metric-registry drift (unregistered bumps or dead entries)"
    is_project_rule = True

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        metrics_src = _find_metrics_file(files)
        if metrics_src is None:
            return []   # analyzing a subtree without the registry module
        consts = metric_constants(metrics_src)
        registered = registry_entries(metrics_src, consts)
        findings: List[Finding] = []
        bumped: Set[str] = set()
        for src in files:
            aliases = _metric_set_aliases(src)
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                resolved = _bump_keys(node, consts, aliases)
                if resolved is None:
                    continue
                for name, ok in resolved:
                    if not ok or not name or not _DOTTED.match(name):
                        continue
                    bumped.add(name)
                    if name not in registered:
                        findings.append(src.finding(
                            self.rule_id, node,
                            f"counter '{name}' is bumped here but missing "
                            f"from its *_METRIC_NAMES registry tuple in "
                            f"utils/metrics.py — the per-action delta "
                            f"iterates the tuple, so this bump is never "
                            f"reported"))
        for name, (tuple_name, lineno) in sorted(registered.items()):
            if name not in bumped:
                findings.append(Finding(
                    self.rule_id, metrics_src.display_path, lineno,
                    f"registry entry '{name}' in {tuple_name} has no "
                    f"bump site (.add/.set_max) anywhere in the package — "
                    f"the section reports a counter that is always zero",
                    metrics_src.line_text(lineno)))
        return findings
