"""R009: lock-order inversion across the engine's lock domains.

PR 8 multiplied the lock inventory: the device-admission semaphore's
condition, the buffer catalog + per-tier store locks, the scan-cache and
df-cache locks, the program-cache lock, and the shuffle client/transport
locks all now run under concurrent queries. A cycle in the order those
locks are ACQUIRED — thread 1 takes A then B, thread 2 takes B then A —
is a deadlock that no single file shows, and that strikes only under
contention (i.e. in production, not in tests).

The check builds the package's static lock graph:

- a lock ACQUISITION is ``with <expr>:`` where the expression is a plain
  name/attribute whose name contains ``lock``/``cond``/``mutex``/``cv``
  (the repo's naming convention — R006 relies on the same one);
- lock IDENTITY is (module, owning class, attribute name); ``self._lock``
  in a subclass method resolves to the topmost package base class so one
  hierarchy's lock is one node (the BufferStore tiers share identity —
  also why same-node edges are ignored: re-entrant by design, and an
  A->A "cycle" is not an ordering inversion);
- an EDGE A -> B exists when, lexically inside a ``with A`` body, B is
  acquired — directly, or anywhere within ``max_depth`` call-graph hops
  of a call made while holding A (callgraph.py resolution);
- CYCLES among >= 2 distinct locks are reported once each, with the
  acquisition sites that close them.

A justified inversion (there should be none; a lock handoff protocol
would be one) carries an inline suppression on the inner acquisition.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.callgraph import CallGraph, graph_for
from spark_rapids_tpu_torch.analysis.cfg import iter_functions, walk_local
from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            dotted_name, register)

_LOCK_HINTS = ("lock", "cond", "mutex", "_cv")
#: call-graph hops a held lock's edges extend through
_MAX_DEPTH = 5

LockId = Tuple[str, str, str]          # (module, owner, attr/name)
Site = Tuple[str, int]                 # (module, lineno)


def _is_lock_expr(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    if not name:
        return False
    leaf = name.split(".")[-1].lower()
    return any(h in leaf for h in _LOCK_HINTS)


def _lock_root_class(graph: CallGraph, cls_name: Optional[str]
                     ) -> Optional[str]:
    """Topmost package base class — one lock node per hierarchy."""
    if cls_name is None:
        return None
    seen = set()
    cur = cls_name
    while cur not in seen:
        seen.add(cur)
        ci = graph.classes.get(cur)
        if ci is None or not ci.bases:
            return cur
        nxt = next((b for b in ci.bases if b in graph.classes), None)
        if nxt is None:
            return cur
        cur = nxt
    return cur


def _lock_identity(graph: CallGraph, src: SourceFile, func_qualname: str,
                   expr: ast.AST) -> LockId:
    name = dotted_name(expr)
    parts = name.split(".")
    cls = func_qualname.split(".")[-2] if "." in func_qualname else None
    if parts[0] == "self" and len(parts) == 2:
        owner = _lock_root_class(graph, cls) or (cls or "")
        return (_owner_module(graph, owner) or src.display_path,
                owner, parts[1])
    # non-self receiver (e.lock, plock, module global): scope by module +
    # expression text — distinct objects stay distinct (conservative:
    # may MISS a cycle through an aliased lock, never invents one)
    return (src.display_path, func_qualname, name)


def _owner_module(graph: CallGraph, owner: str) -> Optional[str]:
    ci = graph.classes.get(owner)
    return ci.module if ci is not None else None


class _LockGraph:
    def __init__(self):
        #: edge (A, B) -> sites where it is established
        self.edges: Dict[Tuple[LockId, LockId], List[Site]] = {}
        #: lock acquisitions per function key: (lock, With node, src)
        self.acquisitions: Dict[str, List[Tuple[LockId, ast.With,
                                                SourceFile]]] = {}

    def add_edge(self, a: LockId, b: LockId, site: Site) -> None:
        if a == b:
            return                      # re-entrant / same-hierarchy: not
        self.edges.setdefault((a, b), []).append(site)

    def cycles(self) -> List[List[LockId]]:
        """Elementary cycles via SCC + per-SCC DFS (the graph is tiny)."""
        adj: Dict[LockId, Set[LockId]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        sccs = _tarjan(adj)
        out: List[List[LockId]] = []
        for comp in sccs:
            if len(comp) < 2:
                continue
            comp_sorted = sorted(comp)
            start = comp_sorted[0]
            cycle = _find_cycle(adj, set(comp), start)
            if cycle:
                out.append(cycle)
        return out


def _tarjan(adj: Dict[LockId, Set[LockId]]) -> List[List[LockId]]:
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    onstack: Set[LockId] = set()
    stack: List[LockId] = []
    counter = [0]
    out: List[List[LockId]] = []

    def strong(v: LockId):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in onstack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                onstack.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in list(adj):
        if v not in index:
            strong(v)
    return out


def _find_cycle(adj: Dict[LockId, Set[LockId]], comp: Set[LockId],
                start: LockId) -> Optional[List[LockId]]:
    path = [start]
    seen = {start}

    def dfs(v: LockId) -> Optional[List[LockId]]:
        for w in sorted(adj.get(v, ())):
            if w not in comp:
                continue
            if w == start and len(path) >= 2:
                return list(path)
            if w not in seen:
                seen.add(w)
                path.append(w)
                got = dfs(w)
                if got:
                    return got
                path.pop()
        return None

    return dfs(start)


@register
class LockOrderInversion(Rule):
    rule_id = "R009"
    title = "lock-order inversion (cycle in the static lock graph)"
    is_project_rule = True

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        graph = graph_for(files)
        lg = _LockGraph()
        by_key = {}
        for src in files:
            for qualname, node in iter_functions(src.tree):
                key = f"{src.display_path}::{qualname}"
                acqs: List[Tuple[LockId, ast.With, SourceFile]] = []
                # walk_local: a nested def's acquisitions belong to the
                # nested function (its own iter_functions entry), which may
                # run on a different thread at a different time — counting
                # them as held HERE invents lock-order edges
                for n in walk_local(node):
                    if isinstance(n, (ast.With, ast.AsyncWith)):
                        for item in n.items:
                            if _is_lock_expr(item.context_expr):
                                acqs.append((_lock_identity(
                                    graph, src, qualname,
                                    item.context_expr), n, src))
                lg.acquisitions[key] = acqs
                by_key[key] = (src, qualname, node)

        # locks each function may acquire within _MAX_DEPTH hops
        summary: Dict[str, Set[LockId]] = {}

        def locks_below(key: str) -> Set[LockId]:
            if key in summary:
                return summary[key]
            out: Set[LockId] = set()
            for k in graph.reachable([key], max_depth=_MAX_DEPTH):
                for (lock, _n, _s) in lg.acquisitions.get(k, ()):
                    out.add(lock)
            summary[key] = out
            return out

        for key, (src, qualname, node) in by_key.items():
            for (outer_lock, with_node, _s) in lg.acquisitions.get(key, ()):
                # walk_local again: a closure defined under the lock does
                # not RUN under the lock
                for inner in walk_local(with_node):
                    site = (src.display_path,
                            getattr(inner, "lineno", with_node.lineno))
                    if isinstance(inner, (ast.With, ast.AsyncWith)):
                        for item in inner.items:
                            if _is_lock_expr(item.context_expr):
                                if src.is_suppressed(self.rule_id,
                                                     item.context_expr.lineno
                                                     if hasattr(
                                                         item.context_expr,
                                                         "lineno")
                                                     else inner.lineno):
                                    continue
                                lg.add_edge(outer_lock, _lock_identity(
                                    graph, src, qualname,
                                    item.context_expr), site)
                    elif isinstance(inner, ast.Call):
                        if src.is_suppressed(self.rule_id, inner.lineno):
                            continue
                        info_key = f"{src.display_path}::{qualname}"
                        caller = graph.functions.get(info_key)
                        if caller is None:
                            continue
                        for callee in graph.resolve_call(caller, inner):
                            for lock in locks_below(callee):
                                lg.add_edge(outer_lock, lock, site)

        findings: List[Finding] = []
        for cycle in lg.cycles():
            names = " -> ".join(f"{m}:{o}.{a}" if o else f"{m}:{a}"
                                for (m, o, a) in cycle)
            sites = []
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                for (mod, line) in lg.edges.get((a, b), [])[:1]:
                    sites.append(f"{mod}:{line}")
            fake = ast.Pass()
            fake.lineno = 1
            anchor_mod = sites[0].rsplit(":", 1) if sites else None
            src0 = next((f for f in files
                         if anchor_mod and
                         f.display_path == anchor_mod[0]), files[0])
            if anchor_mod:
                fake.lineno = int(anchor_mod[1])
            findings.append(src0.finding(
                self.rule_id, fake,
                f"lock-order cycle: {names} -> (back to start); "
                f"acquisition sites {', '.join(sites)}: two threads taking "
                f"these locks in opposite orders deadlock under "
                f"contention; impose one global order (acquire the "
                f"first-named lock first everywhere) or restructure so "
                f"one side copies state and releases before calling down"))
        return findings
