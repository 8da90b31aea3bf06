"""Interprocedural exception-flow analysis for tpu-lint v4.

Computes per-function MAY-RAISE sets — which exception classes can escape a
function — by worklist fixpoint over the package call graph:

  * a ``raise ClassName(...)`` site contributes its class name;
  * a call site contributes its resolved callees' may-raise sets (the call
    graph under-approximates, so unresolvable calls contribute nothing —
    the same errs-toward-silence discipline as R009–R012);
  * a ``try`` subtracts what its ``except`` clauses catch, matched by class
    hierarchy (package ``ClassInfo`` bases joined with a builtin-exception
    table, so ``except OSError`` catches a propagated ``ConnectionError``);
  * handler bodies re-enter the walk with the caught subset bound, so bare
    ``raise`` and ``raise e`` propagate exactly what arrived, and
    ``raise Other(...) [from e]`` records a *conversion* (caught set →
    raised class) for R014's cancellation-laundering check;
  * ``else`` runs unprotected; ``finally`` raises union in (the CFG's
    finally-first routing, seen from the caller's side).

The transfer function is monotone (sets only grow) over a finite universe
(class names that appear at raise sites), so the fixpoint terminates even
through direct/mutual recursion; a visit cap bounds pathological inputs.

A final pass re-evaluates each function at the fixpoint to record
``HandlerFlow`` facts — for every except clause, which may-raised classes
arrive and what the handler body re-raises — plus conversions and a
class → raise-site index.  R013–R015 (rules_exceptions.py) consume these.

Exposed as ``raises_for(files)`` beside ``graph_for()``/``registry_for()``,
with the same single-entry cache so one analysis run builds the flow once.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                 graph_for)
from spark_rapids_tpu_torch.analysis.cfg import walk_local
from spark_rapids_tpu_torch.analysis.core import SourceFile, dotted_name

#: builtin exception ancestry (child -> parent); joined with package classes
#: so hierarchy matching works across the builtin/package seam
_BUILTIN_BASES: Dict[str, str] = {
    "Exception": "BaseException",
    "KeyboardInterrupt": "BaseException",
    "SystemExit": "BaseException",
    "GeneratorExit": "BaseException",
    "ArithmeticError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "FloatingPointError": "ArithmeticError",
    "AssertionError": "Exception",
    "AttributeError": "Exception",
    "BufferError": "Exception",
    "EOFError": "Exception",
    "ImportError": "Exception",
    "ModuleNotFoundError": "ImportError",
    "LookupError": "Exception",
    "IndexError": "LookupError",
    "KeyError": "LookupError",
    "MemoryError": "Exception",
    "NameError": "Exception",
    "UnboundLocalError": "NameError",
    "OSError": "Exception",
    "IOError": "OSError",
    "BlockingIOError": "OSError",
    "ChildProcessError": "OSError",
    "ConnectionError": "OSError",
    "BrokenPipeError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "ConnectionResetError": "ConnectionError",
    "FileExistsError": "OSError",
    "FileNotFoundError": "OSError",
    "InterruptedError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "PermissionError": "OSError",
    "TimeoutError": "OSError",
    "ReferenceError": "Exception",
    "RuntimeError": "Exception",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "StopIteration": "Exception",
    "StopAsyncIteration": "Exception",
    "SyntaxError": "Exception",
    "SystemError": "Exception",
    "TypeError": "Exception",
    "ValueError": "Exception",
    "UnicodeError": "ValueError",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
}

#: fixpoint safety valve: re-evaluations per function before giving up
_MAX_VISITS_PER_FN = 64


class Hierarchy:
    """Exception-class ancestry: package ``ClassInfo`` bases (by name) over
    the builtin table.  Unknown names have no ancestry — they match only
    themselves and catch-all clauses."""

    def __init__(self, classes) -> None:
        self._bases: Dict[str, Tuple[str, ...]] = {
            child: (parent,) for child, parent in _BUILTIN_BASES.items()}
        for name, ci in classes.items():
            self._bases[name] = tuple(ci.bases)
        self._anc_cache: Dict[str, FrozenSet[str]] = {}

    def ancestors(self, name: str) -> FrozenSet[str]:
        """``name`` plus every transitive base (cycle-safe)."""
        got = self._anc_cache.get(name)
        if got is None:
            seen: Set[str] = set()
            stack = [name]
            while stack:
                n = stack.pop()
                if n in seen:
                    continue
                seen.add(n)
                stack.extend(self._bases.get(n, ()))
            got = frozenset(seen)
            self._anc_cache[name] = got
        return got

    def is_subclass(self, name: str, base: str) -> bool:
        return base in self.ancestors(name)

    def catches(self, clause: str, raised: str) -> bool:
        """Does ``except clause`` catch a raised ``raised``?  Exception /
        BaseException are catch-alls (they also catch classes whose
        ancestry the graph cannot see)."""
        if clause in ("Exception", "BaseException"):
            return True
        return self.is_subclass(raised, clause)

    def is_exception_class(self, name: str) -> bool:
        anc = self.ancestors(name)
        return "Exception" in anc or "BaseException" in anc


class RaiseSite(NamedTuple):
    func: FunctionInfo
    node: ast.Raise
    name: str              # leaf class name raised


class HandlerFlow(NamedTuple):
    """One except clause at the fixpoint: what may arrive, what leaves."""
    func: FunctionInfo
    try_node: ast.Try
    handler: ast.ExceptHandler
    clause_names: Tuple[str, ...]   # ("BaseException",) for bare except
    caught: FrozenSet[str]          # may-raised classes this clause absorbs
    raised: FrozenSet[str]          # what the handler body may raise outward


class Conversion(NamedTuple):
    """An explicit ``raise NewClass(...)`` inside an except body — the
    handler converts its caught set into ``to_name``."""
    func: FunctionInfo
    handler: ast.ExceptHandler
    caught: FrozenSet[str]
    to_name: str
    node: ast.Raise


class _HandlerCtx(NamedTuple):
    var: Optional[str]              # ``except ... as var`` binding
    caught: FrozenSet[str]
    handler: ast.ExceptHandler


def _raised_class_name(expr: ast.expr) -> Optional[str]:
    """Leaf class name of an explicit raise expression (``raise X`` /
    ``raise X(...)`` / ``raise mod.X(...)``); None for dynamic raises."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    name = dotted_name(expr)
    if not name:
        return None
    leaf = name.split(".")[-1]
    return leaf if leaf[:1].isupper() else None


def _iter_calls(node: ast.AST):
    """Call nodes within one expression/statement fragment, not descending
    into lambda bodies (they do not run on this path)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Lambda):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


class _Evaluator:
    """One structural evaluation of a function body against the current
    raises map.  With ``sink`` set (final pass), records HandlerFlow /
    Conversion facts into the owning ExceptionFlow."""

    def __init__(self, info: FunctionInfo,
                 call_targets: Dict[int, Tuple[str, ...]],
                 raises_map: Dict[str, FrozenSet[str]],
                 hier: Hierarchy,
                 sink: Optional["ExceptionFlow"] = None) -> None:
        self.info = info
        self.call_targets = call_targets
        self.raises_map = raises_map
        self.hier = hier
        self.sink = sink

    def run(self) -> FrozenSet[str]:
        return frozenset(self.eval_stmts(self.info.node.body, None))

    # ---- expression level --------------------------------------------------
    def _call_raises(self, node: Optional[ast.AST]) -> Set[str]:
        out: Set[str] = set()
        if node is None:
            return out
        for call in _iter_calls(node):
            for key in self.call_targets.get(id(call), ()):
                out |= self.raises_map.get(key, frozenset())
        return out

    # ---- statement level ---------------------------------------------------
    def eval_stmts(self, stmts: Sequence[ast.stmt],
                   ctx: Optional[_HandlerCtx]) -> Set[str]:
        out: Set[str] = set()
        for s in stmts:
            out |= self.eval_stmt(s, ctx)
        return out

    def eval_stmt(self, s: ast.stmt,
                  ctx: Optional[_HandlerCtx]) -> Set[str]:
        if isinstance(s, ast.Raise):
            return self._eval_raise(s, ctx)
        if isinstance(s, ast.Try):
            return self._eval_try(s, ctx)
        if isinstance(s, ast.If):
            return (self._call_raises(s.test)
                    | self.eval_stmts(s.body, ctx)
                    | self.eval_stmts(s.orelse, ctx))
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return (self._call_raises(s.iter)
                    | self.eval_stmts(s.body, ctx)
                    | self.eval_stmts(s.orelse, ctx))
        if isinstance(s, ast.While):
            return (self._call_raises(s.test)
                    | self.eval_stmts(s.body, ctx)
                    | self.eval_stmts(s.orelse, ctx))
        if isinstance(s, (ast.With, ast.AsyncWith)):
            out: Set[str] = set()
            for item in s.items:
                out |= self._call_raises(item.context_expr)
            return out | self.eval_stmts(s.body, ctx)
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            # nested bodies run in their own activation; only decorators
            # and defaults evaluate on this path
            out = set()
            for d in s.decorator_list:
                out |= self._call_raises(d)
            return out
        # simple statement: any call anywhere in it may raise
        out = set()
        for child in ast.iter_child_nodes(s):
            out |= self._call_raises(child)
        return out

    def _eval_raise(self, s: ast.Raise,
                    ctx: Optional[_HandlerCtx]) -> Set[str]:
        out = self._call_raises(s.exc) | self._call_raises(s.cause)
        if s.exc is None:                      # bare raise: re-raise caught
            if ctx is not None:
                out |= ctx.caught
            return out
        name = _raised_class_name(s.exc)
        if name is not None:
            out.add(name)
            if ctx is not None and self.sink is not None:
                self.sink.conversions.append(
                    Conversion(self.info, ctx.handler, ctx.caught, name, s))
        elif (isinstance(s.exc, ast.Name) and ctx is not None
              and s.exc.id == ctx.var):        # raise e: re-raise caught
            out |= ctx.caught
        # other dynamic raises contribute nothing (under-approximate)
        return out

    def _clause(self, handler: ast.ExceptHandler
                ) -> Tuple[Tuple[str, ...], bool]:
        """(clause class names, resolved).  Bare ``except`` is a resolved
        BaseException catch-all; a clause with any non-name element is
        *unresolved* — it subtracts everything (keeps may-raise an
        under-approximation) but is not reported as a handler fact."""
        t = handler.type
        if t is None:
            return ("BaseException",), True
        elts = list(t.elts) if isinstance(t, ast.Tuple) else [t]
        names: List[str] = []
        for e in elts:
            dn = dotted_name(e)
            leaf = dn.split(".")[-1] if dn else ""
            if not leaf or not leaf[:1].isupper():
                return ("BaseException",), False
            names.append(leaf)
        return tuple(names), True

    def _eval_try(self, s: ast.Try,
                  ctx: Optional[_HandlerCtx]) -> Set[str]:
        remaining = set(self.eval_stmts(s.body, ctx))
        out: Set[str] = set()
        for h in s.handlers:
            clause, resolved = self._clause(h)
            caught = {c for c in remaining
                      if any(self.hier.catches(cl, c) for cl in clause)}
            remaining -= caught
            hctx = _HandlerCtx(h.name, frozenset(caught), h)
            h_out = self.eval_stmts(h.body, hctx)
            if self.sink is not None and resolved:
                self.sink.handler_flows.append(HandlerFlow(
                    self.info, s, h, clause,
                    frozenset(caught), frozenset(h_out)))
            out |= h_out
        return (remaining | out
                | self.eval_stmts(s.orelse, ctx)
                | self.eval_stmts(s.finalbody, ctx))


class ExceptionFlow:
    """Package-wide may-raise fixpoint plus the handler/conversion facts
    R013–R015 consume.  Build via ``raises_for(files)``."""

    def __init__(self, files: Sequence[SourceFile]) -> None:
        self.graph: CallGraph = graph_for(files)
        self.hierarchy = Hierarchy(self.graph.classes)
        self.handler_flows: List[HandlerFlow] = []
        self.conversions: List[Conversion] = []
        self.raise_sites: Dict[str, List[RaiseSite]] = {}
        self._raises: Dict[str, FrozenSet[str]] = {}
        self._call_targets: Dict[str, Dict[int, Tuple[str, ...]]] = {}
        self._build()

    # ---- queries -----------------------------------------------------------
    def raises(self, key: str) -> FrozenSet[str]:
        """May-raise set (leaf class names) escaping function ``key``."""
        return self._raises.get(key, frozenset())

    def decorated(self, marker: str) -> List[FunctionInfo]:
        """Functions carrying a decorator whose leaf name is ``marker``
        (e.g. ``triage_boundary`` / ``wire_boundary`` from utils.errors)."""
        out = []
        for info in self.graph.functions.values():
            for d in info.node.decorator_list:
                expr = d.func if isinstance(d, ast.Call) else d
                dn = dotted_name(expr)
                if dn and dn.split(".")[-1] == marker:
                    out.append(info)
                    break
        return out

    # ---- construction ------------------------------------------------------
    def _build(self) -> None:
        graph = self.graph
        for key, info in graph.functions.items():
            targets: Dict[int, Tuple[str, ...]] = {}
            for node in walk_local(info.node):
                if isinstance(node, ast.Call):
                    resolved = tuple(t for t in graph.resolve_call(info, node)
                                     if t != key)
                    if resolved:
                        targets[id(node)] = resolved
                elif isinstance(node, ast.Raise) and node.exc is not None:
                    name = _raised_class_name(node.exc)
                    if name is not None:
                        self.raise_sites.setdefault(name, []).append(
                            RaiseSite(info, node, name))
            self._call_targets[key] = targets
            self._raises[key] = frozenset()

        callers: Dict[str, Set[str]] = {}
        for caller, callees in graph.edges.items():
            for callee in callees:
                callers.setdefault(callee, set()).add(caller)

        worklist = deque(graph.functions)
        queued = set(worklist)
        visits: Dict[str, int] = {}
        while worklist:
            key = worklist.popleft()
            queued.discard(key)
            if visits.get(key, 0) >= _MAX_VISITS_PER_FN:
                continue
            visits[key] = visits.get(key, 0) + 1
            info = graph.functions[key]
            new = _Evaluator(info, self._call_targets[key], self._raises,
                             self.hierarchy).run()
            if new != self._raises[key]:
                self._raises[key] = new
                for caller in callers.get(key, ()):
                    if caller not in queued:
                        queued.add(caller)
                        worklist.append(caller)

        # final pass at the fixpoint: collect handler/conversion facts
        for key, info in graph.functions.items():
            _Evaluator(info, self._call_targets[key], self._raises,
                       self.hierarchy, sink=self).run()


_FLOW_CACHE: Dict[int, ExceptionFlow] = {}


def raises_for(files: Sequence[SourceFile]) -> ExceptionFlow:
    """Build (or reuse) the exception-flow analysis for one run's file set —
    R013/R014/R015 share a single fixpoint, same caching discipline as
    ``graph_for``/``registry_for``."""
    key = hash(tuple(id(f) for f in files))
    got = _FLOW_CACHE.get(key)
    if got is None:
        _FLOW_CACHE.clear()          # one live file set at a time
        got = ExceptionFlow(files)
        _FLOW_CACHE[key] = got
    return got
