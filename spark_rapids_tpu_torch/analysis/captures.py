"""Capture-provenance analysis over program-cache builder sites (v5 engine).

Every XLA program the serving tier caches is produced by a *builder*
routed through one of the R007 cache idioms (``_cached_jit`` /
``_shard_jit`` / ``PhysicalExec.cached_program`` /
``ProgramCache.get_or_build``; ``eval_exprs_device`` routes through its
internal ``get_or_build`` and is covered there).  The cache contract is:
a compiled program may observe **nothing** that is not part of its cache
key.  An unkeyed observable means two call sites with different values
share one specialization — the second silently gets the first's program
and serves stale wrong results.  That contract is what this engine
machine-checks.

For each builder site the engine computes the builder closure tree's
observable-value set — free closure reads, ``self.*`` attribute reads,
module globals, default-argument pins — resolved through the PR 9 call
graph.  Unlike ``cfg.walk_local`` this pass sees *through* lambdas and
comprehensions (their scoping handled properly: comprehension targets
are comprehension-local), so ``lambda:``-form builders and listcomps
contribute their captures.  Unresolved references contribute nothing:
the engine under-approximates, it errs toward silence, never invents.

Each capture then gets a provenance against the sanctioned origins:

=============  =========================================================
origin         meaning
=============  =========================================================
``key``        the dotted path appears in (or is a direct component of)
               the cache-key expression — recomputed per lookup, so a
               change reaches the cache as a new key
``derived``    every reaching local assignment computes it exclusively
               from key/const paths (fixpoint) — e.g.
               ``nflat = flat_len(schema)`` with ``schema`` keyed
``const``      provably constant binding: a builtin, an import, a
               module-level def/class, or a module global assigned
               exactly once and never declared ``global`` in a function
``code``       a function defined in an enclosing scope — code, not
               data; its *own* frees are analyzed in its place
``delegated``  a callable parameter of the enclosing function that the
               closure invokes — the wrapper's callers pass the real
               builder and are analyzed at their own sites
``None``       unsanctioned -> R016
=============  =========================================================

Traced runtime arguments (the traced function's own parameters) never
appear as captures — they are bound names, excluded by construction.

The engine also identifies the *traced body* (the callable the builder
returns, unwrapping ``jax.jit``/factory indirection) and scans it for
trace-time side effects (R018), and cross-references captures against
package-wide in-place write sites (R017).
"""
from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                 graph_for)
from spark_rapids_tpu_torch.analysis.core import SourceFile, call_name, dotted_name

#: cache route -> positional indices whose arguments form the cache key.
#: ``_shard_jit`` folds mesh, caller key AND both sharding specs into the
#: inner ``_cached_jit`` key, so all four positions are key positions.
_ROUTE_KEY_ARGS: Dict[str, Tuple[int, ...]] = {
    "_cached_jit": (0,),
    "cached_program": (0,),
    "get_or_build": (0,),
    "_shard_jit": (0, 1, 3, 4),
}
#: cache route -> positional index of the builder argument
_ROUTE_BUILDER_ARG: Dict[str, int] = {
    "_cached_jit": 1,
    "cached_program": 1,
    "get_or_build": 1,
    "_shard_jit": 2,
}
_KEY_KWARGS = frozenset({"key", "in_specs", "out_specs"})
_BUILDER_KWARG = "builder"

_BUILTIN_NAMES = frozenset(dir(builtins))
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: interprocedural recursion bound — deep enough for builder -> factory
#: -> traced-fn chains, shallow enough to stay inside the premerge budget
_MAX_DEPTH = 4

#: in-place mutator vocabulary (the R012 set): a call of one of these on
#: ``x.attr`` / a module global is a write to the *object*, invisible to
#: a repr-recomputed key and to a compile-time trace snapshot
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse", "fill",
})

#: attr-name fragments marking synchronization plumbing (R009 convention)
_LOCK_HINTS = ("lock", "cond", "mutex", "_cv", "sem")


# ---------------------------------------------------------------------------
# scope-aware free-variable extraction (lambdas + comprehensions included)
# ---------------------------------------------------------------------------

def _arg_names(args: ast.arguments) -> List[str]:
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _target_names(target: ast.AST) -> Iterable[str]:
    """Names BOUND by an assignment target (``obj.x = v`` binds nothing)."""
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            yield n.id


def _local_walk(root: ast.AST):
    """Nodes of ``root``'s own scope: nested function/lambda bodies and
    comprehensions are yielded but not entered (their default/decorator
    expressions, which evaluate in this scope, ARE entered)."""
    if isinstance(root, ast.Lambda):
        stack: List[ast.AST] = [root.body]
    elif isinstance(root, _FUNCS):
        stack = list(root.body)
    else:
        stack = [root]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPES):
            if isinstance(node, _FUNCS):
                stack.extend(node.decorator_list)
            a = node.args
            stack.extend(d for d in list(a.defaults) + list(a.kw_defaults)
                         if d is not None)
            continue
        if isinstance(node, _COMPS):
            continue
        stack.extend(ast.iter_child_nodes(node))


def bound_names(fn: ast.AST) -> Set[str]:
    """Every name the scope of ``fn`` binds: params, assignment targets,
    loop/with/except/walrus targets, imports, nested def/class names —
    minus names pierced by ``global``/``nonlocal`` declarations."""
    bound: Set[str] = set(_arg_names(fn.args)) if isinstance(fn, _SCOPES) \
        else set()
    pierced: Set[str] = set()
    for node in _local_walk(fn):
        if isinstance(node, (*_FUNCS, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                bound.update(_target_names(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
            bound.update(_target_names(node.target))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bound.update(_target_names(node.target))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    bound.update(_target_names(item.optional_vars))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler):
            if node.name:
                bound.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            pierced.update(node.names)
    return bound - pierced


def _scan(roots: Sequence[ast.AST], bound: Set[str],
          reads: Dict[str, ast.AST], called: Set[str],
          calls: List[ast.Call]) -> None:
    """Collect free dotted Load paths / invoked paths / call nodes over
    ``roots``, descending through nested scopes with proper shadowing."""

    def add(path: str, node: ast.AST) -> None:
        if path.split(".", 1)[0] not in bound and path not in reads:
            reads[path] = node

    def visit(node: ast.AST) -> None:
        if isinstance(node, _SCOPES):
            a = node.args
            for d in list(a.defaults) + list(a.kw_defaults):
                if d is not None:
                    visit(d)
            if isinstance(node, _FUNCS):
                for d in node.decorator_list:
                    visit(d)
            inner_roots = [node.body] if isinstance(node, ast.Lambda) \
                else list(node.body)
            _scan(inner_roots, bound | bound_names(node), reads, called,
                  calls)
            return
        if isinstance(node, _COMPS):
            comp_bound = set()
            for gen in node.generators:
                comp_bound.update(_target_names(gen.target))
            inner: List[ast.AST] = (
                [node.key, node.value] if isinstance(node, ast.DictComp)
                else [node.elt])
            for gen in node.generators:
                inner.append(gen.iter)
                inner.extend(gen.ifs)
            _scan(inner, bound | comp_bound, reads, called, calls)
            return
        if isinstance(node, ast.Call):
            calls.append(node)
            fpath = dotted_name(node.func)
            if fpath:
                if fpath.split(".", 1)[0] not in bound:
                    called.add(fpath)
                add(fpath, node.func)
                for sub in node.args:
                    visit(sub)
                for kw in node.keywords:
                    visit(kw.value)
                return
        if isinstance(node, ast.Attribute):
            if isinstance(node.ctx, ast.Load):
                path = dotted_name(node)
                if path:
                    add(path, node)
                    return
            else:
                base = dotted_name(node.value)
                if base:                 # obj.x = v observes obj
                    add(base, node)
                    return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                add(node.id, node)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    for r in roots:
        visit(r)


def free_reads(fn: ast.AST) -> Tuple[Dict[str, ast.AST], Set[str],
                                     List[ast.Call]]:
    """(free dotted path -> first reading node, invoked free paths, every
    call node in the closure tree) for a function or lambda.  A nested
    scope's frees bubble out unless an enclosing scope binds them."""
    reads: Dict[str, ast.AST] = {}
    called: Set[str] = set()
    calls: List[ast.Call] = []
    roots = [fn.body] if isinstance(fn, ast.Lambda) else list(fn.body)
    _scan(roots, bound_names(fn), reads, called, calls)
    return reads, called, calls


def free_paths(fn: ast.AST) -> Set[str]:
    """Free dotted paths of a function/lambda (test + engine hook)."""
    return set(free_reads(fn)[0])


def expr_paths(expr: ast.AST) -> Set[str]:
    """Every dotted Load path an expression observes (no scope filter)."""
    reads: Dict[str, ast.AST] = {}
    _scan([expr], set(), reads, set(), [])
    return set(reads)


# ---------------------------------------------------------------------------
# module environment: constant bindings + in-place mutation sites
# ---------------------------------------------------------------------------

class ModuleEnv:
    __slots__ = ("src", "imports", "defs", "classes", "consts",
                 "mut_globals")

    def __init__(self, src: SourceFile):
        self.src = src
        self.imports: Set[str] = set()
        self.defs: Dict[str, ast.AST] = {}
        self.classes: Set[str] = set()
        self.consts: Set[str] = set()
        self.mut_globals: Set[str] = set()
        assigned: Dict[str, int] = {}
        globaled: Set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    self.imports.add((alias.asname or alias.name)
                                     .split(".")[0])
            elif isinstance(node, ast.Global):
                globaled.update(node.names)
        stmts = list(src.tree.body)
        for s in list(stmts):            # one level of top-level if/try
            if isinstance(s, ast.If):
                stmts.extend(s.body)
                stmts.extend(s.orelse)
            elif isinstance(s, ast.Try):
                stmts.extend(s.body)
                for h in s.handlers:
                    stmts.extend(h.body)
        for s in stmts:
            if isinstance(s, _FUNCS):
                self.defs[s.name] = s
            elif isinstance(s, ast.ClassDef):
                self.classes.add(s.name)
            elif isinstance(s, ast.Assign):
                for t in s.targets:
                    for n in _target_names(t):
                        assigned[n] = assigned.get(n, 0) + 1
            elif isinstance(s, ast.AnnAssign) and s.value is not None:
                for n in _target_names(s.target):
                    assigned[n] = assigned.get(n, 0) + 1
        self.consts = {n for n, c in assigned.items()
                       if c == 1 and n not in globaled}
        # in-place writes to module globals anywhere in this module
        module_names = set(assigned)
        for node in ast.walk(src.tree):
            name = _inplace_write_base(node)
            if name and "." not in name and name in module_names:
                self.mut_globals.add(name)


def _inplace_write_base(node: ast.AST) -> str:
    """Dotted path of the object an AST node mutates in place, or ''."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        return dotted_name(node.func.value)
    target = None
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        target = node.targets[0]
    elif isinstance(node, ast.AugAssign):
        target = node.target
    if isinstance(target, ast.Subscript):
        return dotted_name(target.value)
    return ""


def _mutated_attrs(files: Sequence[SourceFile]) -> Set[str]:
    """Attr leaf names with in-place write sites anywhere in the package
    (``recv.X.append(..)`` / ``recv.X[k] = v`` / ``recv.X[k] += v``)."""
    out: Set[str] = set()
    for src in files:
        for node in ast.walk(src.tree):
            base = _inplace_write_base(node)
            if base and "." in base:
                out.add(base.split(".")[-1])
    return out


# ---------------------------------------------------------------------------
# builder-site model
# ---------------------------------------------------------------------------

class Capture:
    """One observable value a cached program's closure tree reads."""
    __slots__ = ("path", "node", "src", "origin", "via")

    def __init__(self, path: str, node: ast.AST, src: SourceFile,
                 via: str = ""):
        self.path = path
        self.node = node
        self.src = src
        self.origin: Optional[str] = None   # key|derived|const|code|delegated
        self.via = via                      # call chain note for messages


class Effect:
    """One trace-time side effect inside a traced body."""
    __slots__ = ("node", "src", "kind", "desc")

    def __init__(self, node: ast.AST, src: SourceFile, kind: str, desc: str):
        self.node = node
        self.src = src
        self.kind = kind
        self.desc = desc


class BuilderSite:
    """One cache-route call with its key paths, captures and effects."""
    __slots__ = ("src", "call", "route", "key_paths", "captures", "effects",
                 "delegated")

    def __init__(self, src: SourceFile, call: ast.Call, route: str):
        self.src = src
        self.call = call
        self.route = route
        self.key_paths: Set[str] = set()
        self.captures: List[Capture] = []
        self.effects: List[Effect] = []
        #: builder is a callable parameter of the enclosing function —
        #: this site is a forwarding wrapper, analyzed at its callers
        self.delegated = False

    @property
    def line(self) -> int:
        return self.call.lineno


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

class _SiteAnalyzer:
    def __init__(self, files: Sequence[SourceFile]):
        self.files = files
        self.graph: CallGraph = graph_for(files)
        self.envs: Dict[str, ModuleEnv] = {
            f.display_path: ModuleEnv(f) for f in files}
        self.mutated_attrs = _mutated_attrs(files)
        self.info_by_node: Dict[int, FunctionInfo] = {
            id(i.node): i for i in self.graph.functions.values()}

    # -- site discovery ------------------------------------------------------
    def sites(self) -> List[BuilderSite]:
        out: List[BuilderSite] = []
        for src in self.files:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                leaf = call_name(node).split(".")[-1]
                if leaf in _ROUTE_BUILDER_ARG:
                    out.append(self._analyze(src, node, leaf))
        return out

    # -- per-site ------------------------------------------------------------
    def _analyze(self, src: SourceFile, call: ast.Call,
                 route: str) -> BuilderSite:
        site = BuilderSite(src, call, route)
        stack = [a for a in src.ancestors(call)
                 if isinstance(a, _FUNCS)][::-1]        # outer -> inner
        assigns = self._stack_assigns(stack)
        local_defs = self._stack_defs(stack)
        stack_params: Set[str] = set()
        for fn in stack:
            stack_params.update(_arg_names(fn.args))
        env = self.envs.get(src.display_path) or ModuleEnv(src)

        key_exprs = [call.args[i] for i in _ROUTE_KEY_ARGS[route]
                     if i < len(call.args)]
        key_exprs += [kw.value for kw in call.keywords
                      if kw.arg in _KEY_KWARGS]
        if not key_exprs:
            return site
        site.key_paths = self._key_paths(key_exprs, assigns)
        if route == "cached_program":
            site.key_paths.add("self.name")     # the implicit key prefix

        builder = None
        if len(call.args) > _ROUTE_BUILDER_ARG[route]:
            builder = call.args[_ROUTE_BUILDER_ARG[route]]
        else:
            for kw in call.keywords:
                if kw.arg == _BUILDER_KWARG:
                    builder = kw.value
        if builder is None:
            return site

        reads: Dict[str, ast.AST] = {}
        called: Set[str] = set()
        calls: List[ast.Call] = []
        pending = self._builder_roots(site, builder, local_defs,
                                      stack_params, env, reads, called,
                                      calls)
        # worklist: a builder like ``lambda: make(a, b)`` delegates to a
        # SIBLING def in the enclosing scope — its body is part of the
        # closure tree, so called local defs become roots themselves
        roots: List[ast.AST] = []
        seen_roots: Set[int] = set()
        while pending:
            root = pending.pop()
            if id(root) in seen_roots:
                continue
            seen_roots.add(id(root))
            roots.append(root)
            r, c, cl = free_reads(root)
            for p, n in r.items():
                reads.setdefault(p, n)
            called |= c
            calls.extend(cl)
            if isinstance(root, _FUNCS):    # pinned-default expressions
                a = root.args
                for d in list(a.defaults) + list(a.kw_defaults):
                    if d is not None:
                        _scan([d], set(), reads, called, calls)
            # any referenced local def is part of the program — a builder
            # that only PASSES ``local_step`` into shard_map still bakes
            # local_step's captures into the compiled program
            for p in set(c) | set(r):
                if "." not in p and p in local_defs:
                    pending.append(local_defs[p])

        captures = {p: Capture(p, n, src) for p, n in reads.items()}
        self._follow_calls(site, calls, stack, captures, depth=0,
                           seen=set())
        sanctioned = self._fixpoint(site.key_paths, assigns, captures,
                                    env, local_defs, stack_params, called)
        for cap in captures.values():
            cap.origin = self._classify(cap, site.key_paths, sanctioned,
                                        env, local_defs, stack_params,
                                        called)
        site.captures = sorted(captures.values(), key=lambda c: c.path)

        for root in roots:
            for traced in self._traced_roots(root, local_defs, env, 0):
                self._effect_scan(site, traced, src)
        return site

    # -- enclosing-scope maps -----------------------------------------------
    def _stack_assigns(self, stack: Sequence[ast.AST]
                       ) -> Dict[str, List[Optional[ast.AST]]]:
        out: Dict[str, List[Optional[ast.AST]]] = {}

        def put(name: str, rhs: Optional[ast.AST]) -> None:
            out.setdefault(name, []).append(rhs)

        for fn in stack:
            for node in _local_walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        # element-wise unpack: ``a, b = x.p, x.q`` binds
                        # a to x.p only, not to the whole RHS tuple
                        if isinstance(t, ast.Tuple) and \
                                isinstance(node.value, ast.Tuple) and \
                                len(t.elts) == len(node.value.elts) and \
                                all(isinstance(e, ast.Name)
                                    for e in t.elts):
                            for e, v in zip(t.elts, node.value.elts):
                                put(e.id, v)
                            continue
                        for n in _target_names(t):
                            put(n, node.value)
                elif isinstance(node, ast.AnnAssign):
                    for n in _target_names(node.target):
                        put(n, node.value)
                elif isinstance(node, ast.AugAssign):
                    for n in _target_names(node.target):
                        put(n, None)
                elif isinstance(node, ast.NamedExpr):
                    for n in _target_names(node.target):
                        put(n, node.value)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    for n in _target_names(node.target):
                        put(n, node.iter)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is not None:
                            for n in _target_names(item.optional_vars):
                                put(n, item.context_expr)
                elif isinstance(node, ast.ExceptHandler):
                    if node.name:
                        put(node.name, None)
        return out

    def _stack_defs(self, stack: Sequence[ast.AST]) -> Dict[str, ast.AST]:
        out: Dict[str, ast.AST] = {}
        for fn in stack:
            for node in _local_walk(fn):
                if isinstance(node, _FUNCS):
                    out[node.name] = node
        return out

    # -- cache-key path extraction ------------------------------------------
    def _key_paths(self, key_exprs: Sequence[ast.AST],
                   assigns: Dict[str, List[Optional[ast.AST]]]) -> Set[str]:
        """Dotted paths the key observes.  Bare names whose value IS the
        key tuple (``key = (...)`` aliases, ``base + (mode,)`` chains)
        expand through their assignments; tuple *components* match
        exactly and never expand — ``cond`` being keyed does not key
        whatever ``cond`` was computed from."""
        paths: Set[str] = set()
        expanding: Set[str] = set()

        def expand_name(name: str, depth: int) -> None:
            if depth > _MAX_DEPTH or name in expanding:
                return
            expanding.add(name)
            for rhs in assigns.get(name, []):
                if rhs is not None:
                    collect(rhs, depth + 1)

        def collect(expr: ast.AST, depth: int) -> None:
            if isinstance(expr, ast.Tuple):
                for el in expr.elts:
                    paths.update(expr_paths(el))
            elif isinstance(expr, ast.BinOp):
                collect(expr.left, depth)
                collect(expr.right, depth)
            elif isinstance(expr, ast.Name):
                paths.add(expr.id)
                expand_name(expr.id, depth)
            elif isinstance(expr, ast.Call) and \
                    call_name(expr).split(".")[-1] == "tuple" and expr.args:
                collect(expr.args[0], depth)
            else:
                paths.update(expr_paths(expr))

        for e in key_exprs:
            collect(e, 0)
        return paths

    # -- builder resolution --------------------------------------------------
    def _builder_roots(self, site: BuilderSite, builder: ast.AST,
                       local_defs: Dict[str, ast.AST],
                       stack_params: Set[str], env: ModuleEnv,
                       reads: Dict[str, ast.AST], called: Set[str],
                       calls: List[ast.Call]) -> List[ast.AST]:
        if isinstance(builder, ast.Lambda):
            return [builder]
        if isinstance(builder, ast.Name):
            if builder.id in local_defs:
                return [local_defs[builder.id]]
            if builder.id in stack_params:
                site.delegated = True       # forwarding wrapper
                return []
            if builder.id in env.defs:
                return [env.defs[builder.id]]
            return []                       # unresolved: contribute nothing
        if isinstance(builder, ast.Call):
            # eager factory: build(mode) — the returned closure pins the
            # argument values; count them as captures at the call site
            for sub in list(builder.args) + [kw.value
                                             for kw in builder.keywords]:
                _scan([sub], set(), reads, called, calls)
            leaf = call_name(builder).split(".")[-1]
            target = local_defs.get(leaf) or env.defs.get(leaf)
            return [target] if target is not None else []
        return []

    # -- interprocedural closure through the call graph ----------------------
    def _follow_calls(self, site: BuilderSite, calls: List[ast.Call],
                      stack: Sequence[ast.AST],
                      captures: Dict[str, Capture], depth: int,
                      seen: Set[str]) -> None:
        if depth >= _MAX_DEPTH or not calls:
            return
        caller = None
        for fn in stack[::-1]:
            caller = self.info_by_node.get(id(fn))
            if caller is not None:
                break
        if caller is None:
            return
        enclosing_q = caller.qualname
        for call in calls:
            targets = self.graph.resolve_call(caller, call)
            if len(targets) != 1:
                continue                    # ambiguous: contribute nothing
            key = targets[0]
            if key in seen:
                continue
            seen.add(key)
            info = self.graph.functions[key]
            if info.module == caller.module and \
                    info.qualname.startswith(enclosing_q + "."):
                continue    # nested sibling: already scanned as closure root
            parts = info.qualname.split(".")
            if len(parts) > 2 or (len(parts) == 2
                                  and parts[0] not in self.graph.classes):
                # a nested def elsewhere: its frees are bound by ITS
                # enclosing closure, not observables of this site — and
                # the unique-name fallback reaching it is over-resolution
                continue
            r, _, inner_calls = free_reads(info.node)
            tenv = self.envs.get(info.module)
            for p, n in r.items():
                base = p.split(".")[0]
                if base in ("self", "cls"):
                    continue                # callee's own instance state
                if self._is_const(p, tenv):
                    continue
                if p not in captures:
                    cap = Capture(p, n, info.src,
                                  via=f"via {info.qualname}()")
                    cap.origin = None       # cross-module, can't be keyed
                    captures[p] = cap
            self._follow_calls(site, inner_calls, [info.node], captures,
                               depth + 1, seen)

    # -- provenance ----------------------------------------------------------
    def _is_const(self, path: str, env: Optional[ModuleEnv]) -> bool:
        base = path.split(".")[0]
        if base in _BUILTIN_NAMES:
            return True
        if env is None:
            return False
        return (base in env.imports or base in env.defs
                or base in env.classes or base in env.consts)

    def _fixpoint(self, key_paths: Set[str],
                  assigns: Dict[str, List[Optional[ast.AST]]],
                  captures: Dict[str, Capture], env: ModuleEnv,
                  local_defs: Dict[str, ast.AST], stack_params: Set[str],
                  called: Set[str]) -> Set[str]:
        """Bare names provably derived from key/const paths: every
        reaching assignment's free paths are sanctioned."""
        sanctioned: Set[str] = set()

        def ok(path: str) -> bool:
            base = path.split(".")[0]
            if base in sanctioned or base in local_defs:
                return True
            if any(path == k or path.startswith(k + ".")
                   for k in key_paths):
                return True
            return self._is_const(path, env)

        changed = True
        while changed:
            changed = False
            for name, rhss in assigns.items():
                if name in sanctioned or not rhss:
                    continue
                if all(rhs is not None
                       and all(ok(p) for p in expr_paths(rhs))
                       for rhs in rhss):
                    sanctioned.add(name)
                    changed = True
        return sanctioned

    def _classify(self, cap: Capture, key_paths: Set[str],
                  sanctioned: Set[str], env: ModuleEnv,
                  local_defs: Dict[str, ast.AST], stack_params: Set[str],
                  called: Set[str]) -> Optional[str]:
        if cap.origin is not None or cap.via:
            return cap.origin               # cross-module: const or None
        p = cap.path
        base = p.split(".")[0]
        # a key path that EXTENDS the capture (capture ``shim``, key
        # ``shim.name``) also sanctions it: the author keyed the
        # identity-bearing attribute — err toward silence
        if any(p == k or p.startswith(k + ".") or k.startswith(p + ".")
               for k in key_paths):
            return "key"
        if base in local_defs:
            return "code"
        if base in stack_params:
            if base not in ("self", "cls") and \
                    (p in called or base in called):
                return "delegated"
            return None
        if base in sanctioned:
            return "derived"
        if self._is_const(p, env):
            return "const"
        return None

    # -- traced-body identification + effect scan ----------------------------
    def _traced_roots(self, root: ast.AST, local_defs: Dict[str, ast.AST],
                      env: ModuleEnv, depth: int) -> List[ast.AST]:
        """The callable(s) a builder returns — what ``jax.jit`` traces."""
        if depth > _MAX_DEPTH:
            return []
        out: List[ast.AST] = []
        nested = {n.name: n for n in _local_walk(root)
                  if isinstance(n, _FUNCS)}

        def from_expr(expr: Optional[ast.AST], depth: int) -> None:
            if expr is None or depth > _MAX_DEPTH:
                return
            if isinstance(expr, ast.Lambda):
                out.append(expr)
                return
            if isinstance(expr, ast.Name):
                target = nested.get(expr.id) or local_defs.get(expr.id)
                if target is not None:
                    out.append(target)
                return
            if isinstance(expr, ast.Call):
                leaf = call_name(expr).split(".")[-1]
                if leaf in ("jit", "shard_map", "pjit") and expr.args:
                    from_expr(expr.args[0], depth + 1)
                    return
                factory = (nested.get(leaf) or local_defs.get(leaf)
                           or env.defs.get(leaf))
                if factory is not None:
                    out.extend(self._traced_roots(factory, local_defs, env,
                                                  depth + 1))

        if isinstance(root, ast.Lambda):
            from_expr(root.body, depth)
        else:
            for node in _local_walk(root):
                if isinstance(node, ast.Return):
                    from_expr(node.value, depth)
        return out

    def _effect_scan(self, site: BuilderSite, traced: ast.AST,
                     src: SourceFile) -> None:
        """Side effects inside a traced body run once per *compile*, not
        per call: the trace replays their result, the effect vanishes."""
        for node in ast.walk(traced):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    name = dotted_name(item.context_expr)
                    if isinstance(item.context_expr, ast.Call):
                        name = call_name(item.context_expr)
                    leaf = name.split(".")[-1].lower()
                    if any(h in leaf for h in _LOCK_HINTS):
                        site.effects.append(Effect(
                            node, src, "lock",
                            f"lock acquisition 'with {name}'"))
                continue
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            parts = name.split(".")
            leaf = parts[-1]
            base = parts[0]
            if leaf in ("print", "open", "input") and len(parts) == 1:
                site.effects.append(Effect(node, src, "host-io",
                                           f"host call '{name}()'"))
            elif base in ("os", "time", "random", "shutil", "socket") and \
                    len(parts) > 1:
                site.effects.append(Effect(node, src, "host-io",
                                           f"host call '{name}()'"))
            elif base in ("log", "logger", "logging") and len(parts) > 1:
                site.effects.append(Effect(node, src, "host-io",
                                           f"logging call '{name}()'"))
            elif leaf == "absorb":
                site.effects.append(Effect(node, src, "absorb",
                                           f"'{name}()' absorbs into "
                                           "host-side state"))
            elif leaf == "acquire":
                site.effects.append(Effect(node, src, "lock",
                                           f"lock acquisition '{name}()'"))
            elif leaf == "count_output":
                site.effects.append(Effect(node, src, "metric",
                                           f"metric bump '{name}()'"))
            elif leaf in ("add", "set_max", "inc", "observe") and \
                    len(parts) > 1:
                recv = ".".join(parts[:-1]).lower()
                sub = node.func.value if isinstance(node.func,
                                                    ast.Attribute) else None
                subscripted = isinstance(sub, ast.Subscript) and \
                    "metric" in dotted_name(sub.value).lower()
                if "metric" in recv or subscripted:
                    site.effects.append(Effect(node, src, "metric",
                                               f"metric bump '{name}()'"))
            elif leaf in ("span", "instant") or "TRACER" in name:
                if "trace" in name.lower():
                    site.effects.append(Effect(node, src, "tracer",
                                               f"tracer call '{name}()'"))

    # -- R017 ----------------------------------------------------------------
    def mutable_hazards(self, site: BuilderSite
                        ) -> List[Tuple[Capture, str]]:
        """Captures whose object identity has in-place write sites: the
        trace snapshots the object at compile time; a repr-recomputed key
        may not reflect the mutation (ndarray reprs truncate), so the
        stale program survives the write."""
        out: List[Tuple[Capture, str]] = []
        for cap in site.captures:
            parts = cap.path.split(".")
            env = self.envs.get(cap.src.display_path)
            if len(parts) == 1 and cap.origin == "const" and env and \
                    cap.path in env.mut_globals:
                out.append((cap, "module global mutated in place in "
                                 f"'{cap.src.display_path}'"))
            elif len(parts) >= 2 and cap.origin == "key" and \
                    parts[-1] in self.mutated_attrs and \
                    parts[0] in ("self", "cls"):
                out.append((cap, f"attribute '{parts[-1]}' has in-place "
                                 "write sites elsewhere in the package"))
        return out


# ---------------------------------------------------------------------------
# cached entry point (rules R016–R018 share one build per file set)
# ---------------------------------------------------------------------------

_SITE_CACHE: Dict[int, Tuple[_SiteAnalyzer, List[BuilderSite]]] = {}


def capture_analysis(files: Sequence[SourceFile]
                     ) -> Tuple[_SiteAnalyzer, List[BuilderSite]]:
    key = hash(tuple(id(f) for f in files))
    got = _SITE_CACHE.get(key)
    if got is None:
        _SITE_CACHE.clear()                 # one live file set at a time
        analyzer = _SiteAnalyzer(files)
        got = (analyzer, analyzer.sites())
        _SITE_CACHE[key] = got
    return got
