"""Package-wide call graph for tpu-lint v2.

The interprocedural rules (R009 lock-order, R010 cancellation-unsafe
waits) need to answer "what can this function reach?" across module
boundaries — a lock acquired three calls below a ``with`` block still
orders after it, and a blocking wait is only a serving hazard when an
execute path can actually arrive there.

Name resolution is deliberately static and conservative, in tiers:

1. ``self.m()`` / ``cls.m()`` — the enclosing class, then its package base
   classes (single- and multiple-inheritance chains resolved by name).
2. bare ``f()`` — nested sibling defs, module-level functions, names
   pulled in by ``from pkg.mod import f``, and module classes (an
   instantiation edges to ``Class.__init__``).
3. ``alias.f()`` — module aliases from ``import pkg.mod as alias`` /
   ``from pkg import mod``.
4. attr-name typing — the package consistently names attributes after
   their type (``self.catalog = BufferCatalog()``); every such assignment
   (and ``x: Class`` annotation) feeds a global attr-name -> classes
   table, so ``dm.catalog.remove()`` resolves through the ``catalog``
   component.
5. unique-method fallback — a method name defined by exactly ONE package
   class resolves to it, unless the name collides with builtin-collection
   vocabulary (``get``/``pop``/``append``/...), where the receiver is far
   more likely a dict or list than the one package class.

Unresolvable calls get no edge: the graph under-approximates, which for
both rules errs toward silence, never toward false findings. Summaries
are bounded: ``reachable()`` BFSes to ``max_depth`` call hops, so a
pathological chain cannot blow up premerge latency, and recursion (direct
or mutual) terminates because visited nodes are never re-expanded.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.cfg import iter_functions, walk_local
from spark_rapids_tpu_torch.analysis.core import SourceFile, dotted_name

#: method names that are overwhelmingly builtin-collection calls; the
#: unique-method fallback refuses these (tier-4 typing may still resolve)
_COMMON_NAMES = frozenset({
    "get", "set", "pop", "add", "append", "extend", "insert", "remove",
    "update", "clear", "copy", "items", "keys", "values", "join", "split",
    "strip", "close", "open", "read", "write", "send", "recv", "put",
    "start", "run", "wait", "acquire", "release", "setdefault", "discard",
    "popitem", "sort", "index", "count", "format", "encode", "decode",
})

#: default call-hop bound for reachability summaries
DEFAULT_DEPTH = 16


def module_name(display_path: str) -> str:
    p = display_path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class FunctionInfo:
    __slots__ = ("key", "module", "qualname", "node", "src", "class_name")

    def __init__(self, module: str, qualname: str, node, src: SourceFile):
        self.module = module                 # display path
        self.qualname = qualname             # Class.method / func / outer.inner
        self.key = f"{module}::{qualname}"
        self.node = node
        self.src = src
        parts = qualname.split(".")
        self.class_name = parts[-2] if len(parts) >= 2 else None


class ClassInfo:
    __slots__ = ("module", "name", "bases", "methods")

    def __init__(self, module: str, name: str):
        self.module = module
        self.name = name
        self.bases: List[str] = []           # base-class NAMES (unresolved)
        self.methods: Dict[str, str] = {}    # method name -> function key


class CallGraph:
    def __init__(self, files: Sequence[SourceFile]):
        self.functions: Dict[str, FunctionInfo] = {}
        self.edges: Dict[str, Set[str]] = {}
        #: calls made inside lambda bodies nested in each function. They are
        #: DEFERRED: the lambda runs in its own activation, possibly long
        #: after (and far from) the enclosing function's paths, so they must
        #: not join ``edges`` — R009's lock-order reachability would otherwise
        #: claim a closure defined under a lock runs under it. The capture
        #: analysis (R016-R018) needs them: a jit builder written as
        #: ``lambda: make(...)`` observes everything ``make`` observes.
        self.deferred_edges: Dict[str, Set[str]] = {}
        #: class name -> ClassInfo (package class names are unique enough;
        #: a collision keeps the first and is logged nowhere — conservative)
        self.classes: Dict[str, ClassInfo] = {}
        #: module display path -> {bare name -> function key}
        self._module_funcs: Dict[str, Dict[str, str]] = {}
        #: module display path -> {alias -> module display path}
        self._module_aliases: Dict[str, Dict[str, str]] = {}
        #: module display path -> {imported name -> (module path, name)}
        self._from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: attr/param name -> class names assigned to it anywhere
        self._attr_types: Dict[str, Set[str]] = {}
        #: method name -> function keys across all classes
        self._methods_by_name: Dict[str, List[str]] = {}
        self._index(files)
        self._link(files)

    # ---- indexing ----------------------------------------------------------
    def _index(self, files: Sequence[SourceFile]) -> None:
        by_modname = {module_name(f.display_path): f.display_path
                      for f in files}
        #: deferred attr-typing candidates: (attr-or-param name, class name)
        typing_candidates: List[Tuple[str, str]] = []
        for src in files:
            mod = src.display_path
            funcs: Dict[str, str] = {}
            for qualname, node in iter_functions(src.tree):
                info = FunctionInfo(mod, qualname, node, src)
                self.functions[info.key] = info
                parts = qualname.split(".")
                # only TOP-LEVEL functions enter the bare-name table: a
                # method's leaf name must not capture bare calls to
                # same-named parameters/locals (tier-5 handles unique
                # method names, WITH the common-name guard)
                if len(parts) == 1:
                    funcs[qualname] = info.key
            self._module_funcs[mod] = funcs

            aliases: Dict[str, str] = {}
            froms: Dict[str, Tuple[str, str]] = {}
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        target = by_modname.get(a.name)
                        if target:
                            aliases[a.asname or a.name.split(".")[-1]] = target
                elif isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        sub = by_modname.get(f"{node.module}.{a.name}")
                        if sub:                      # from pkg import mod
                            aliases[a.asname or a.name] = sub
                            continue
                        target = by_modname.get(node.module)
                        if target:                   # from pkg.mod import f
                            froms[a.asname or a.name] = (target, a.name)
                elif isinstance(node, ast.ClassDef):
                    ci = self.classes.setdefault(node.name,
                                                 ClassInfo(mod, node.name))
                    for b in node.bases:
                        bn = dotted_name(b)
                        if bn:
                            ci.bases.append(bn.split(".")[-1])
                    for stmt in node.body:
                        if isinstance(stmt, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            key = f"{mod}::{node.name}.{stmt.name}"
                            if key in self.functions:
                                ci.methods[stmt.name] = key
                elif isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    cname = dotted_name(node.value.func).split(".")[-1]
                    if cname and cname[:1].isupper():
                        for t in node.targets:
                            if isinstance(t, ast.Attribute):
                                typing_candidates.append((t.attr, cname))
                            elif isinstance(t, ast.Name):
                                typing_candidates.append((t.id, cname))
                elif isinstance(node, ast.AnnAssign) and \
                        node.annotation is not None:
                    cname = dotted_name(node.annotation).split(".")[-1]
                    tgt = node.target
                    if isinstance(tgt, ast.Attribute):
                        typing_candidates.append((tgt.attr, cname))
                    elif isinstance(tgt, ast.Name):
                        typing_candidates.append((tgt.id, cname))
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    for arg in node.args.args + node.args.kwonlyargs:
                        if arg.annotation is None:
                            continue
                        ann = dotted_name(arg.annotation)
                        if not ann and isinstance(arg.annotation,
                                                  ast.Constant):
                            ann = str(arg.annotation.value)
                        if ann:
                            typing_candidates.append(
                                (arg.arg, ann.strip("\"'").split(".")[-1]))
            self._module_aliases[mod] = aliases
            self._from_imports[mod] = froms

        for key, info in self.functions.items():
            if info.class_name:
                name = info.qualname.split(".")[-1]
                self._methods_by_name.setdefault(name, []).append(key)

        # attr-name typing: self.X = ClassName(...) / x: ClassName — the
        # candidates resolve only after every package class is indexed
        for (name, cname) in typing_candidates:
            if cname in self.classes:
                self._attr_types.setdefault(name, set()).add(cname)

    # ---- class-chain lookup ------------------------------------------------
    def _method_in_chain(self, cls_name: str, meth: str,
                         _seen: Optional[Set[str]] = None) -> Optional[str]:
        seen = _seen or set()
        if cls_name in seen:
            return None
        seen.add(cls_name)
        ci = self.classes.get(cls_name)
        if ci is None:
            return None
        if meth in ci.methods:
            return ci.methods[meth]
        for base in ci.bases:
            found = self._method_in_chain(base, meth, seen)
            if found:
                return found
        return None

    # ---- call-site resolution ----------------------------------------------
    def resolve_call(self, caller: FunctionInfo, call: ast.Call
                     ) -> List[str]:
        name = dotted_name(call.func)
        if not name:
            return []
        parts = name.split(".")
        mod = caller.module

        if parts[0] in ("self", "cls") and len(parts) == 2 and \
                caller.class_name:
            found = self._method_in_chain(caller.class_name, parts[1])
            if found:
                return [found]
            return self._fallback(parts[1])

        if len(parts) == 1:
            bare = parts[0]
            # nested sibling: outer.inner defined in this function scope or
            # any enclosing one (a closure two defs deep still sees the
            # helpers of every scope above it)
            scope = caller.qualname
            while scope:
                sibling = f"{mod}::{scope}.{bare}"
                if sibling in self.functions:
                    return [sibling]
                scope = scope.rsplit(".", 1)[0] if "." in scope else ""
            funcs = self._module_funcs.get(mod, {})
            if bare in funcs:
                return [funcs[bare]]
            frm = self._from_imports.get(mod, {}).get(bare)
            if frm:
                target_mod, target_name = frm
                key = f"{target_mod}::{target_name}"
                if key in self.functions:
                    return [key]
                init = self._method_in_chain(target_name, "__init__")
                if init:
                    return [init]
            if bare in self.classes:
                init = self._method_in_chain(bare, "__init__")
                return [init] if init else []
            return []

        # alias.f(...) — module alias from imports
        alias_target = self._module_aliases.get(mod, {}).get(parts[0])
        if alias_target is not None and len(parts) == 2:
            funcs = self._module_funcs.get(alias_target, {})
            if parts[1] in funcs:
                return [funcs[parts[1]]]

        # x.attr_chain.m(...) — attr-name typing on the last receiver part
        meth = parts[-1]
        recv_hint = parts[-2] if len(parts) >= 2 else ""
        hinted = self._attr_types.get(recv_hint, set())
        keys = []
        for cname in hinted:
            found = self._method_in_chain(cname, meth)
            if found:
                keys.append(found)
        if keys:
            return keys
        # self.attr.m through the enclosing class's own annotated attrs is
        # covered by the global table above; last resort:
        return self._fallback(meth)

    def _fallback(self, meth: str) -> List[str]:
        if meth in _COMMON_NAMES:
            return []
        keys = self._methods_by_name.get(meth, [])
        return list(keys) if len(keys) == 1 else []

    # ---- edge construction --------------------------------------------------
    def _link(self, files: Sequence[SourceFile]) -> None:
        for key, info in self.functions.items():
            targets: Set[str] = set()
            deferred: Set[str] = set()
            # calls inside nested defs belong to the nested function; calls
            # inside lambda bodies are collected separately (deferred) — a
            # lambda body has no statements, so ast.walk over it only ever
            # meets expressions and nested lambdas/comprehensions
            for node in walk_local(info.node):
                if isinstance(node, ast.Call):
                    for t in self.resolve_call(info, node):
                        if t != key:
                            targets.add(t)
                elif isinstance(node, ast.Lambda):
                    for sub in ast.walk(node.body):
                        if isinstance(sub, ast.Call):
                            for t in self.resolve_call(info, sub):
                                if t != key:
                                    deferred.add(t)
            self.edges[key] = targets
            self.deferred_edges[key] = deferred

    # ---- queries ------------------------------------------------------------
    def callees(self, key: str) -> Set[str]:
        return self.edges.get(key, set())

    def callees_all(self, key: str) -> Set[str]:
        """Immediate callees INCLUDING calls deferred inside lambda bodies.

        ``callees``/``reachable`` stay lambda-blind on purpose (R009: a
        closure defined under a lock is not running under it); capture
        provenance wants the opposite — whatever a builder lambda calls, the
        compiled program observed."""
        return self.edges.get(key, set()) | self.deferred_edges.get(key, set())

    def reachable(self, roots: Sequence[str],
                  max_depth: int = DEFAULT_DEPTH) -> Set[str]:
        """Functions reachable from ``roots`` within ``max_depth`` call
        hops (roots included). Cycles terminate: a visited key is never
        re-expanded."""
        seen: Set[str] = set(r for r in roots if r in self.functions)
        frontier = deque((r, 0) for r in seen)
        while frontier:
            key, d = frontier.popleft()
            if d >= max_depth:
                continue
            for t in self.edges.get(key, ()):
                if t not in seen:
                    seen.add(t)
                    frontier.append((t, d + 1))
        return seen

    def find(self, module_suffix: str, qualname: str) -> Optional[str]:
        """Function key by module path suffix + qualname (test/rule hook)."""
        for key, info in self.functions.items():
            if info.qualname == qualname and \
                    info.module.endswith(module_suffix):
                return key
        return None


_GRAPH_CACHE: Dict[int, CallGraph] = {}


def graph_for(files: Sequence[SourceFile]) -> CallGraph:
    """Build (or reuse) the call graph for one analysis run's file set —
    R009 and R010 share a single build so the interprocedural pass stays
    inside the premerge runtime budget."""
    key = hash(tuple(id(f) for f in files))
    got = _GRAPH_CACHE.get(key)
    if got is None:
        _GRAPH_CACHE.clear()          # one live file set at a time
        got = CallGraph(files)
        _GRAPH_CACHE[key] = got
    return got
