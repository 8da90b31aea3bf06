"""tpu-lint core: findings, rule registry, suppressions, and the driver.

Static-analysis counterpart of the reference's premerge hygiene tooling
(api_validation + the docs/configs.md diff): round-5 showed the engine's
remaining losses come from jit-hygiene and data-movement mistakes that only
surface hours into a benchmark run (the q4 recompile wall, dispatch-bound
queries, the stalled exchange). tpu-lint makes those properties
machine-checkable at premerge time.

Two rule kinds share one registry:

- file rules: ``check(SourceFile) -> findings`` — pure AST checks run per
  module (R001 recompile hazards, R002 hidden host syncs, R003 x64-dtype
  hazards, R006 lock-across-blocking-IO).
- project rules: ``check_project(files) -> findings`` — cross-file
  properties (R004 config drift, R005 Cpu/Tpu exec parity). They run once
  per invocation, only when the analyzed set includes the package itself.

Suppression: ``# tpu-lint: disable=R001`` (or ``disable=R001,R002`` /
``disable=all``) on the flagged line or on a comment line directly above it.
Grandfathered findings live in the baseline file (see baseline.py); every
baseline entry must carry a written justification.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: package-relative path fragments treated as device hot paths (R002 scope)
HOT_PATH_DIRS = ("execs", "ops", "shuffle")

_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([A-Za-z0-9,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One lint result. ``code`` is the stripped source line — the stable
    identity used for baseline matching (line numbers drift, code lines
    rarely do)."""

    rule: str
    path: str
    line: int
    message: str
    code: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        tail = f"\n    {self.code}" if self.code else ""
        return f"{loc}: {self.rule}: {self.message}{tail}"

    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.code)

    def to_dict(self) -> Dict[str, object]:
        """Machine-readable form for ``--format json`` (CI annotations)."""
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "code": self.code}


class Rule:
    """Base lint rule. Subclasses set ``rule_id``/``title`` and implement
    ``check`` (file rule) or ``check_project`` (project rule)."""

    rule_id: str = ""
    title: str = ""
    #: project rules need the whole package file set, not one module
    is_project_rule: bool = False
    #: anchor into docs/static-analysis.md (SARIF helpUri); defaults to the
    #: lowercased rule id — every catalog entry carries a matching anchor
    help_anchor: str = ""

    def help_uri(self) -> str:
        return f"docs/static-analysis.md#{self.help_anchor or self.rule_id.lower()}"

    def check(self, src: "SourceFile") -> List[Finding]:
        return []

    def check_project(self, files: Sequence["SourceFile"]) -> List[Finding]:
        return []


_RULES: Dict[str, Rule] = {}


def register(rule_cls) -> type:
    """Class decorator adding a rule to the global registry."""
    rule = rule_cls()
    if not rule.rule_id:
        raise ValueError(f"{rule_cls.__name__} has no rule_id")
    if rule.rule_id in _RULES:
        raise ValueError(f"duplicate rule id {rule.rule_id}")
    _RULES[rule.rule_id] = rule
    return rule_cls


def all_rules() -> List[Rule]:
    _load_builtin_rules()
    return [_RULES[k] for k in sorted(_RULES)]


def _load_builtin_rules() -> None:
    # import for side effect: each module registers its rules
    from spark_rapids_tpu_torch.analysis import (rules_cancel,      # noqa: F401
                                           rules_captures,    # noqa: F401
                                           rules_dtype,       # noqa: F401
                                           rules_exceptions,  # noqa: F401
                                           rules_lockorder,   # noqa: F401
                                           rules_locks,       # noqa: F401
                                           rules_metrics,     # noqa: F401
                                           rules_project,     # noqa: F401
                                           rules_races,       # noqa: F401
                                           rules_recompile,   # noqa: F401
                                           rules_resource,    # noqa: F401
                                           rules_serving,     # noqa: F401
                                           rules_sync)        # noqa: F401


class SourceFile:
    """One parsed module: AST with parent links, raw lines, and the
    per-line suppression table."""

    def __init__(self, path: str, text: str, display_path: Optional[str] = None):
        self.path = path
        #: path as reported in findings (repo-relative when possible)
        self.display_path = display_path or path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.suppressions = self._scan_suppressions(text)

    # ---- navigation --------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def inside_loop(self, node: ast.AST) -> bool:
        """True when ``node`` sits in a for/while body or a comprehension —
        the contexts where a per-iteration hazard repeats per batch. Stops at
        the enclosing function boundary: a loop *around* a def does not make
        the def's body per-iteration."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
                                ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                return True
        return False

    def is_hot_path(self) -> bool:
        p = self.display_path.replace("\\", "/")
        return any(f"/{d}/" in p or p.startswith(f"{d}/")
                   for d in HOT_PATH_DIRS)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # ---- suppressions ------------------------------------------------------
    @staticmethod
    def _scan_suppressions(text: str) -> Dict[int, Set[str]]:
        """line -> suppressed rule ids, from ``# tpu-lint: disable=...``
        comments. Tokenize (not regex over raw lines) so string literals
        containing the marker don't suppress anything."""
        table: Dict[int, Set[str]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                ids = {s.strip().upper() for s in m.group(1).split(",")
                       if s.strip()}
                table.setdefault(tok.start[0], set()).update(ids)
        except tokenize.TokenError:
            pass
        return table

    def is_suppressed(self, rule_id: str, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            ids = self.suppressions.get(ln)
            if ids and (rule_id.upper() in ids or "ALL" in ids):
                return True
        return False

    # ---- finding helper ----------------------------------------------------
    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(rule_id, self.display_path, lineno, message,
                       self.line_text(lineno))


# ---------------------------------------------------------------- AST helpers
def dotted_name(node: ast.AST) -> str:
    """'jax.jit' for Attribute(Name('jax'), 'jit'); '' when not a plain
    dotted path."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def is_numeric_literal(node: ast.AST) -> bool:
    """A number, or a (nested) list/tuple of numbers — the shapes whose
    default dtype drifts between x32 and x64 modes."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, complex)) and \
            not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub,
                                                              ast.UAdd)):
        return is_numeric_literal(node.operand)
    if isinstance(node, (ast.List, ast.Tuple)):
        return bool(node.elts) and all(is_numeric_literal(e)
                                       for e in node.elts)
    return False


# ------------------------------------------------------------------- driver
@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    errors: List[str] = field(default_factory=list)
    #: per-rule wall seconds (the --profile surface: when the premerge
    #: 30 s guard trips, the three slowest rules name the culprit)
    rule_seconds: Dict[str, float] = field(default_factory=dict)
    #: (path, suppression line, RULE_ID) triples for every inline
    #: suppression that actually absorbed a finding this run — the
    #: staleness check condemns suppression lines absent from this set
    suppressions_hit: Set[Tuple[str, int, str]] = field(default_factory=set)


def load_source(path: str, display_path: Optional[str] = None,
                errors: Optional[List[str]] = None) -> Optional[SourceFile]:
    """Parse one file; on failure return None and, when ``errors`` is given,
    record the reason — a silently skipped file would otherwise make the
    lint gate report clean on code it never saw."""
    try:
        with open(path, encoding="utf-8") as f:
            return SourceFile(path, f.read(), display_path)
    except (OSError, SyntaxError, ValueError) as e:
        if errors is not None:
            errors.append(f"{display_path or path}: {type(e).__name__}: {e}")
        return None


def analyze_files(files: Sequence[SourceFile],
                  rule_ids: Optional[Set[str]] = None,
                  with_project_rules: bool = True,
                  with_file_rules: bool = True) -> AnalysisResult:
    """Run every (selected) rule over ``files``; suppressions applied here so
    rules stay oblivious to them.

    ``--changed-only`` splits one logical run into two calls: file rules
    over the changed subset (``with_project_rules=False``) and project
    rules over the FULL set (``with_file_rules=False``) so interprocedural
    context never shrinks; the CLI merges and filters the findings."""
    import time as _time
    result = AnalysisResult(files_scanned=len(files))
    rules = [r for r in all_rules()
             if rule_ids is None or r.rule_id in rule_ids]
    for rule in rules:
        raw: List[Finding] = []
        t0 = _time.perf_counter()
        if rule.is_project_rule:
            if with_project_rules:
                raw = rule.check_project(files)
        elif with_file_rules:
            for src in files:
                raw.extend(rule.check(src))
        result.rule_seconds[rule.rule_id] = round(
            _time.perf_counter() - t0, 4)
        by_path = {f.display_path: f for f in files}
        for finding in raw:
            src = by_path.get(finding.path)
            if src is not None and src.is_suppressed(finding.rule,
                                                     finding.line):
                rid = finding.rule.upper()
                for ln in (finding.line, finding.line - 1):
                    ids = src.suppressions.get(ln)
                    if ids and (rid in ids or "ALL" in ids):
                        result.suppressions_hit.add((finding.path, ln, rid))
                continue
            result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
