"""R012: thread-escape + lockset data-race detection over the serving fleet.

PRs 12 and 14 turned the engine into a multithreaded serving fleet —
scheduler workers, TCP accept/worker pools, heartbeat and probe loops,
pipeline producers — all coordinating through shared mutable state
(breaker state, replica tables, parked frames, stats windows). Every
concurrency bug shipped so far was found by hand or by a lucky stress
test. R012 makes the discipline machine-checkable, in the
Eraser/RacerD lineage (lockset analysis, no annotations required),
built from the v2 engine's existing parts:

1. **thread-root discovery** — concurrent entry points are enumerated
   statically: every function handed to ``threading.Thread(target=...)``
   (names, ``self.method`` bound methods, lambdas, nested defs), every
   handler registered on the transport's worker pool
   (``register_request_handler`` / ``add_peer_lost_listener``), and the
   serving package's public API surface (``submit``/``result``/client
   calls — documented thread-safe, so it is one MULTI root). A root is
   *multi-instance* when many threads can run it at once: a spawn inside
   a loop (worker pools), a spawn in ``__init__`` (one thread per
   instance, many instances), or a pool-registered handler.
2. **escape analysis** — an attribute ``(module, topmost-base-class,
   attr)`` is SHARED when functions reachable from two distinct roots
   (or twice from one multi root) touch it, within ``_MAX_DEPTH``
   call-graph hops (callgraph.py resolution, attr-name typing included).
3. **lockset dataflow** — a MUST-analysis over the PR 9 CFG's
   ``WithEnter``/``WithExit`` markers computes the set of locks (R009's
   ``(module, topmost-base-class, attr)`` identity) held at every load
   and store of a shared attribute; locks held at every call site
   propagate into callees (entry locksets, intersection over callers).
   A write/write or read/write pair whose locksets intersect to the
   empty set is a data race.

Whitelisted idioms (the engine's sanctioned lock-free patterns):

- **inherently thread-safe attrs** — ``queue.Queue``/``Event``/
  ``Condition``/``Lock``/``Semaphore``/``itertools.count`` and friends:
  their method calls are internally synchronized.
- **publish-snapshot** — every write to the attr is a single plain
  ``obj.attr = value`` store (never ``+=``, never ``attr[k] = v``,
  never ``attr.append(...)``, never a store that reads the attr it
  writes): an atomic reference publish of an immutable snapshot, the
  documented ``last_metrics`` pattern. Read-modify-write defeats it.
- **init-before-spawn** — accesses in ``__init__`` that precede the
  first thread spawn / handler registration happen before the object
  is reachable by any other thread.
- **justified suppression** — ``# tpu-lint: disable=R012`` on an access
  line exempts that access; on the ``class`` line it exempts every
  attribute of the class (for types thread-confined by documented
  contract). Both carry a written justification.

Reporting gate (RacerD's): an attribute is only reported when the code
shows threading intent — at least one access to it holds SOME lock, or
its class owns a lock. A fully lock-free class is either confined or a
design problem a lockset cannot arbitrate; the leaked-thread sub-check
below still covers its spawn hygiene.

Sub-check, same registry: a NON-daemon ``threading.Thread`` started on a
serving/shuffle path with no reachable ``join()``/stop-event on the
shutdown path outlives drain and pins interpreter exit (the PR 14
accept-thread bug was this shape).
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.callgraph import CallGraph, graph_for
from spark_rapids_tpu_torch.analysis.cfg import (Cond, Handler, LoopIter, WithEnter,
                                           WithExit, build_cfg, iter_functions,
                                           walk_local)
from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            call_name, dotted_name, register)
from spark_rapids_tpu_torch.analysis.rules_lockorder import (_is_lock_expr,
                                                       _lock_root_class)

#: call-graph hops a thread root's reach extends through
_MAX_DEPTH = 10

#: constructor leaf names whose instances synchronize internally — an
#: attribute assigned one of these is whitelisted wholesale (their method
#: calls are the sanctioned cross-thread channel)
_SAFE_CTORS = frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event",
    "Condition", "Lock", "RLock", "Semaphore", "BoundedSemaphore",
    "Barrier", "local", "count",
})

#: ctors that mark their OWNER class as lock-owning (the reporting gate)
_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})

#: attr-name fragments that mark synchronization plumbing itself — the
#: lock/event/queue objects, not the state they guard
_SKIP_HINTS = ("lock", "cond", "mutex", "_cv", "sem", "event", "_evt",
               "queue", "latch")

#: method names that MUTATE their receiver in place (a store access).
#: Deliberately the builtin-container vocabulary only: ``put`` belongs to
#: queues/streams, which synchronize internally.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
})

#: calls that hand their function argument to a worker-pool/callback
#: thread: (call leaf name, argument index of the handler)
_HANDLER_REGISTRARS = {"register_request_handler": 1,
                       "add_peer_lost_listener": 0}

#: serving public API surface = the MAIN root (documented thread-safe:
#: many user threads may drive one client/scheduler concurrently)
_MAIN_ROOT = "<main>"

LockId = Tuple[str, str, str]          # (module, owner class, attr)
AttrId = Tuple[str, str, str]          # (module, owner class, attr)

#: access kinds; everything except "load" is a write
_LOAD, _STORE, _STORE_AUG, _STORE_SUB, _STORE_MUT, _STORE_RMW = (
    "load", "store", "store-aug", "store-sub", "store-mut", "store-rmw")


class _Access:
    __slots__ = ("attr", "func", "line", "kind", "locks", "src", "roots")

    def __init__(self, attr: AttrId, func: str, line: int, kind: str,
                 locks: FrozenSet[LockId], src: SourceFile,
                 roots: FrozenSet[str]):
        self.attr = attr
        self.func = func
        self.line = line
        self.kind = kind
        self.locks = locks
        self.src = src
        self.roots = roots

    @property
    def is_write(self) -> bool:
        return self.kind != _LOAD


class _ThreadRegistry:
    """Thread roots + reachability + type tables for one file set; built
    once per analysis run and cached alongside the call graph (the
    premerge-latency contract)."""

    def __init__(self, graph: CallGraph, files: Sequence[SourceFile]):
        self.graph = graph
        #: root id -> multi-instance?
        self.roots: Dict[str, bool] = {}
        #: root id -> function keys it enters at
        self.root_funcs: Dict[str, List[str]] = {}
        #: roots that ENTER lock-free (thread targets, pool handlers, the
        #: main surface). A SPAWNER root still runs in its callers'
        #: context, so its entry lockset flows from call sites instead.
        self.entry_free: Set[str] = set()
        #: spawn sites for the leaked-thread sub-check:
        #: (src, call node, enclosing qualname, daemon?, binding name)
        self.spawns: List[Tuple[SourceFile, ast.Call, str, bool,
                                Optional[str]]] = []
        #: per-__init__ first spawn/registration lineno (init-before-spawn)
        self.first_spawn_line: Dict[str, int] = {}
        #: (owner, attr) pairs assigned a thread-safe ctor + global names
        self.safe_attrs: Set[Tuple[str, str]] = set()
        self.safe_names: Set[str] = set()
        #: owner classes that own a lock (the reporting gate)
        self.lock_owners: Set[str] = set()
        #: attrs assigned Lock/RLock/Condition ctors: ``with obj.attr:``
        #: acquires them even when the NAME carries no lock hint (the
        #: BounceBufferManager ``_available`` condition shape)
        self.lock_attrs: Set[Tuple[str, str]] = set()
        self.lock_names: Set[str] = set()
        self._scan(files)
        #: function key -> root ids reaching it (the escape map)
        self.reached: Dict[str, Set[str]] = {}
        for rid, funcs in self.root_funcs.items():
            for key in graph.reachable(funcs, max_depth=_MAX_DEPTH):
                self.reached.setdefault(key, set()).add(rid)

    # ---- scanning -----------------------------------------------------------
    def _scan(self, files: Sequence[SourceFile]) -> None:
        main_funcs: List[str] = []
        for key, info in self.graph.functions.items():
            mod = info.module.replace("\\", "/")
            leaf = info.qualname.split(".")[-1]
            if ("/serving/" in mod or mod.startswith("serving/")) and \
                    info.class_name and not leaf.startswith("_"):
                main_funcs.append(key)
        if main_funcs:
            self.roots[_MAIN_ROOT] = True      # many caller threads
            self.root_funcs[_MAIN_ROOT] = main_funcs
            self.entry_free.update(main_funcs)

        seen_calls: Set[int] = set()
        for src in files:
            for qualname, node in iter_functions(src.tree):
                key = f"{src.display_path}::{qualname}"
                info = self.graph.functions.get(key)
                if info is None:
                    continue
                # walk_local, not ast.walk: a nested def is its own
                # iter_functions entry — scanning it from the outer
                # function too would record every spawn twice
                for n in walk_local(node):
                    if not isinstance(n, ast.Call) or id(n) in seen_calls:
                        continue
                    seen_calls.add(id(n))
                    leaf = call_name(n).split(".")[-1]
                    if leaf == "Thread":
                        self._scan_thread(src, info, qualname, node, n)
                    elif leaf in _HANDLER_REGISTRARS:
                        idx = _HANDLER_REGISTRARS[leaf]
                        expr = self._handler_arg(n, idx)
                        if expr is not None:
                            for t in _resolve_func_expr(self.graph, info,
                                                        expr):
                                self._add_root(t, multi=True)
                        self._note_spawn_line(key, n.lineno)
                        # the registrar races its own handlers from here on
                        self._add_root(key, multi=False, pin_entry=False)
            self._scan_types(src)

    @staticmethod
    def _handler_arg(call: ast.Call, idx: int) -> Optional[ast.AST]:
        if len(call.args) > idx:
            return call.args[idx]
        for kw in call.keywords:
            if kw.arg in ("handler", "listener", "callback", "fn"):
                return kw.value
        return None

    def _scan_thread(self, src: SourceFile, info, qualname: str,
                     func_node, call: ast.Call) -> None:
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and len(call.args) >= 2:
            target = call.args[1]          # Thread(group, target, ...)
        daemon = any(kw.arg == "daemon" and
                     isinstance(kw.value, ast.Constant) and
                     kw.value.value is True for kw in call.keywords)
        binding = _thread_binding(src, call)
        self.spawns.append((src, call, qualname, daemon, binding))
        self._note_spawn_line(f"{src.display_path}::{qualname}",
                              call.lineno)
        # the SPAWNER keeps running concurrently with what it spawned —
        # its post-spawn code (constructor tails included) is a root too,
        # but one whose entry lockset still flows from its callers
        self._add_root(f"{src.display_path}::{qualname}", multi=False,
                       pin_entry=False)
        if target is None:
            return
        multi = src.inside_loop(call) or \
            qualname.split(".")[-1] == "__init__"
        for t in _resolve_func_expr(self.graph, info, target):
            self._add_root(t, multi=multi)

    def _add_root(self, key: str, multi: bool,
                  pin_entry: bool = True) -> None:
        self.roots[key] = self.roots.get(key, False) or multi
        self.root_funcs.setdefault(key, [key])
        if pin_entry:
            self.entry_free.add(key)

    def _note_spawn_line(self, func_key: str, lineno: int) -> None:
        cur = self.first_spawn_line.get(func_key)
        if cur is None or lineno < cur:
            self.first_spawn_line[func_key] = lineno

    def _scan_types(self, src: SourceFile) -> None:
        """Thread-safe attr typing + lock ownership, package-wide: the
        whitelist errs toward silence, so a global name fallback is
        acceptable (an attr NAMED like a synchronized one elsewhere is
        overwhelmingly the same idiom)."""
        for n in ast.walk(src.tree):
            value = None
            targets: List[ast.AST] = []
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                value, targets = n.value, list(n.targets)
            elif isinstance(n, ast.AnnAssign) and \
                    isinstance(n.value, ast.Call) and n.target is not None:
                value, targets = n.value, [n.target]
            if value is None:
                continue
            leaf = call_name(value).split(".")[-1]
            if leaf not in _SAFE_CTORS:
                continue
            for t in targets:
                if isinstance(t, ast.Attribute):
                    owner = self._owner_of(src, t)
                    if owner:
                        self.safe_attrs.add((owner, t.attr))
                        if leaf in _LOCK_CTORS:
                            self.lock_owners.add(owner)
                            self.lock_attrs.add((owner, t.attr))
                    self.safe_names.add(t.attr)
                    if leaf in _LOCK_CTORS:
                        self.lock_names.add(t.attr)
                elif isinstance(t, ast.Name):
                    self.safe_names.add(t.id)
                    if leaf in _LOCK_CTORS:
                        self.lock_names.add(t.id)

    def _owner_of(self, src: SourceFile, attr_node: ast.Attribute
                  ) -> Optional[str]:
        if not (isinstance(attr_node.value, ast.Name) and
                attr_node.value.id == "self"):
            return None
        for anc in src.ancestors(attr_node):
            if isinstance(anc, ast.ClassDef):
                return _lock_root_class(self.graph, anc.name) or anc.name
        return None

    # ---- queries ------------------------------------------------------------
    def concurrent(self, a: FrozenSet[str], b: FrozenSet[str]) -> bool:
        """Can an execution of a function with roots ``a`` overlap one
        with roots ``b``? Distinct roots always can; one shared root can
        only when it is multi-instance."""
        for ra in a:
            for rb in b:
                if ra != rb:
                    return True
                if self.roots.get(ra):
                    return True
        return False


def _thread_binding(src: SourceFile, call: ast.Call) -> Optional[str]:
    """Name/attr the Thread object is bound to (``self.reader = Thread``),
    for the join-reachability check; None when start()ed anonymously."""
    parent = src.parent(call)
    if isinstance(parent, ast.Assign):
        for t in parent.targets:
            name = dotted_name(t)
            if name:
                return name.split(".")[-1]
    # threading.Thread(...).start() — the Attribute receiver is the call
    if isinstance(parent, ast.Attribute) and parent.attr == "start":
        return None
    return None


def _resolve_func_expr(graph: CallGraph, caller, expr: ast.AST) -> List[str]:
    """Resolve a function-valued expression (Thread target / registered
    handler) to function keys: names, self.method, typed-attr methods,
    and the calls inside a lambda body (the lambda runs them on the new
    thread)."""
    if isinstance(expr, ast.Lambda):
        out: List[str] = []
        for n in ast.walk(expr.body):
            if isinstance(n, ast.Call):
                out.extend(graph.resolve_call(caller, n))
        return out
    name = dotted_name(expr)
    if not name:
        return []
    # reuse the call resolver on a synthetic zero-arg call of the target
    fake = ast.Call(func=expr, args=[], keywords=[])
    return graph.resolve_call(caller, fake)


# ---------------------------------------------------------------- locksets
def _expr_nodes(root: ast.AST):
    """Walk an item's expressions without crossing into nested scopes
    (a lambda/def body runs at another time, on another thread even)."""
    stack = [root]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _item_roots(item) -> List[ast.AST]:
    if isinstance(item, Cond):
        return [item.test]
    if isinstance(item, LoopIter):
        return [item.target, item.iter]
    if isinstance(item, WithEnter):
        out: List[ast.AST] = []
        for it in item.items:
            out.append(it.context_expr)
            if it.optional_vars is not None:
                out.append(it.optional_vars)
        return out
    if isinstance(item, (WithExit, Handler)):
        return []
    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [item]


class _FuncPass:
    """One function's R012 pass: local type table, must-lockset dataflow
    over the CFG with-markers, per-item locksets, accesses and call
    sites."""

    def __init__(self, registry: _ThreadRegistry, src: SourceFile,
                 qualname: str, node):
        self.reg = registry
        self.graph = registry.graph
        self.src = src
        self.qualname = qualname
        self.node = node
        self.key = f"{src.display_path}::{qualname}"
        parts = qualname.split(".")
        self.cls = parts[-2] if len(parts) >= 2 else None
        self.local_types = self._local_types()
        self.item_locks: Dict[int, FrozenSet[LockId]] = {}
        #: (callee key, lockset at the call site)
        self.call_sites: List[Tuple[str, FrozenSet[LockId]]] = []
        #: attr accesses with their LOCAL locksets (entry added later)
        self.accesses: List[Tuple[AttrId, int, str,
                                  FrozenSet[LockId]]] = []
        self._run()

    # ---- receiver typing ---------------------------------------------------
    def _local_types(self) -> Dict[str, str]:
        """name -> class for receivers in this function: ``self``, the
        annotated parameters, and locals assigned a package-class
        construction; the global attr-typing table backs the rest."""
        out: Dict[str, str] = {}
        if self.cls:
            out["self"] = self.cls
        args = self.node.args
        for arg in args.args + args.kwonlyargs:
            if arg.annotation is None:
                continue
            ann = dotted_name(arg.annotation)
            if not ann and isinstance(arg.annotation, ast.Constant):
                ann = str(arg.annotation.value)
            leaf = ann.strip("\"'").split(".")[-1] if ann else ""
            if leaf in self.graph.classes:
                out[arg.arg] = leaf
        for n in ast.walk(self.node):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                leaf = call_name(n.value).split(".")[-1]
                if leaf in self.graph.classes:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = leaf
        return out

    def _recv_class(self, name: str) -> Optional[str]:
        got = self.local_types.get(name)
        if got:
            return got
        hinted = self.graph._attr_types.get(name, set())
        if len(hinted) == 1:
            return next(iter(hinted))
        return None

    def _resolve_attr(self, node: ast.Attribute) -> Optional[AttrId]:
        """(module, topmost-base-class, attr) for a two-part receiver
        (``self.x`` / ``sq.x``); deeper chains stay unresolved — the
        engine under-approximates, it never invents."""
        if not isinstance(node.value, ast.Name):
            return None
        cls = self._recv_class(node.value.id)
        if cls is None or cls not in self.graph.classes:
            return None
        owner = _lock_root_class(self.graph, cls) or cls
        ci = self.graph.classes.get(owner)
        mod = ci.module if ci is not None else self.src.display_path
        return (mod, owner, node.attr)

    def _lock_id(self, expr: ast.AST) -> LockId:
        name = dotted_name(expr)
        parts = name.split(".")
        if len(parts) == 2:
            cls = self._recv_class(parts[0])
            if cls is not None:
                owner = _lock_root_class(self.graph, cls) or cls
                ci = self.graph.classes.get(owner)
                mod = ci.module if ci is not None else self.src.display_path
                return (mod, owner, parts[1])
        # unknown receiver / module global: a WILDCARD identity that
        # matches any lock with the same leaf name — over-merging locks
        # only ever SILENCES a finding, never invents one
        return ("", "", parts[-1])

    def _is_lock_with(self, expr: ast.AST) -> bool:
        """Lock acquisition: the R009 naming convention, or an attr the
        registry saw assigned a Lock/RLock/Condition constructor."""
        if _is_lock_expr(expr):
            return True
        name = dotted_name(expr)
        if not name:
            return False
        leaf = name.split(".")[-1]
        if isinstance(expr, ast.Attribute):
            attr = self._resolve_attr(expr)
            if attr is not None:
                return (attr[1], attr[2]) in self.reg.lock_attrs or \
                    leaf in self.reg.lock_names
        return leaf in self.reg.lock_names

    # ---- the must-dataflow -------------------------------------------------
    def _apply(self, item, state: FrozenSet[LockId]) -> FrozenSet[LockId]:
        if isinstance(item, WithEnter):
            add = [self._lock_id(it.context_expr) for it in item.items
                   if self._is_lock_with(it.context_expr)]
            if add:
                return state | frozenset(add)
        elif isinstance(item, WithExit):
            drop = [self._lock_id(it.context_expr) for it in item.items
                    if self._is_lock_with(it.context_expr)]
            if drop:
                return state - frozenset(drop)
        return state

    def _run(self) -> None:
        cfg = build_cfg(self.node)
        in_states: Dict[int, Optional[FrozenSet[LockId]]] = {
            cfg.entry: frozenset()}
        work = deque([cfg.entry])
        visits = 0
        while work:
            visits += 1
            if visits > 20000:
                break
            bid = work.popleft()
            state = in_states.get(bid)
            if state is None:
                continue
            block = cfg.blocks[bid]
            for item in block.items:
                self.item_locks[id(item)] = state
                state = self._apply(item, state)
            for (succ, _lbl) in block.succs:
                prev = in_states.get(succ)
                merged = state if prev is None else (prev & state)
                if prev is None or merged != prev:
                    in_states[succ] = merged
                    work.append(succ)
        # harvest accesses + call sites with the (converged) item locksets
        caller_info = self.graph.functions.get(self.key)
        for block in cfg.blocks.values():
            for item in block.items:
                locks = self.item_locks.get(id(item), frozenset())
                for root in _item_roots(item):
                    self._harvest(root, locks, caller_info)

    def _harvest(self, stmt: ast.AST, locks: FrozenSet[LockId],
                 caller_info) -> None:
        counted: Set[int] = set()

        def note(attr_node: ast.Attribute, kind: str) -> None:
            attr = self._resolve_attr(attr_node)
            if attr is None:
                return
            counted.add(id(attr_node))
            self.accesses.append((attr, attr_node.lineno, kind, locks))

        # store shapes first, so the loads pass can skip counted nodes
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            flat: List[ast.AST] = []
            for t in targets:
                flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
            for t in flat:
                if isinstance(t, ast.Attribute):
                    kind = _STORE
                    if stmt.value is not None:
                        tid = self._resolve_attr(t)
                        if tid is not None and any(
                                isinstance(n, ast.Attribute) and
                                self._resolve_attr(n) == tid
                                for n in _expr_nodes(stmt.value)):
                            kind = _STORE_RMW
                    note(t, kind)
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Attribute):
                    note(t.value, _STORE_SUB)
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Attribute):
                note(stmt.target, _STORE_AUG)
            elif isinstance(stmt.target, ast.Subscript) and \
                    isinstance(stmt.target.value, ast.Attribute):
                note(stmt.target.value, _STORE_SUB)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Attribute):
                    note(t.value, _STORE_SUB)
                elif isinstance(t, ast.Attribute):
                    note(t, _STORE)

        for n in _expr_nodes(stmt):
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _MUTATORS and \
                        isinstance(n.func.value, ast.Attribute):
                    note(n.func.value, _STORE_MUT)
                if caller_info is not None:
                    for callee in self.graph.resolve_call(caller_info, n):
                        self.call_sites.append((callee, locks))
        for n in _expr_nodes(stmt):
            if isinstance(n, ast.Attribute) and id(n) not in counted and \
                    isinstance(n.ctx, ast.Load):
                note(n, _LOAD)


def _locks_match(a: LockId, b: LockId) -> bool:
    if a == b:
        return True
    if a[0] == "" and a[2] == b[2]:
        return True
    if b[0] == "" and b[2] == a[2]:
        return True
    return False


def _locksets_disjoint(a: FrozenSet[LockId], b: FrozenSet[LockId]) -> bool:
    return not any(_locks_match(x, y) for x in a for y in b)


_REG_CACHE: Dict[int, _ThreadRegistry] = {}


def registry_for(files: Sequence[SourceFile]) -> _ThreadRegistry:
    """Build (or reuse) the thread-root/escape registry for one file set;
    cached alongside the call graph so R012 rides the same build the
    other interprocedural rules share."""
    key = hash(tuple(id(f) for f in files))
    got = _REG_CACHE.get(key)
    if got is None:
        _REG_CACHE.clear()
        got = _ThreadRegistry(graph_for(files), files)
        _REG_CACHE[key] = got
    return got


@register
class ThreadLocksetRaces(Rule):
    rule_id = "R012"
    title = "shared-state data race (thread escape + disjoint locksets)"
    is_project_rule = True

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        reg = registry_for(files)
        if not reg.roots:
            return []
        by_path = {f.display_path: f for f in files}
        passes: Dict[str, _FuncPass] = {}
        for key in sorted(reg.reached):
            info = reg.graph.functions.get(key)
            if info is None:
                continue
            src = by_path.get(info.module)
            if src is None:
                continue
            passes[key] = _FuncPass(reg, src, info.qualname, info.node)

        entry = self._entry_locksets(reg, passes)
        accesses = self._collect(reg, passes, entry)
        findings = self._report(reg, accesses, by_path)
        findings.extend(self._check_leaked_threads(reg))
        return findings

    # ---- interprocedural entry locksets ------------------------------------
    @staticmethod
    def _entry_locksets(reg: _ThreadRegistry,
                        passes: Dict[str, _FuncPass]
                        ) -> Dict[str, FrozenSet[LockId]]:
        """Locks held on EVERY analyzed path into each function:
        intersection over call sites of (caller entry ∪ site lockset);
        roots enter lock-free. Monotone decreasing, so the fixpoint is
        cheap."""
        TOP = None
        entry: Dict[str, Optional[FrozenSet[LockId]]] = {
            k: TOP for k in passes}
        for fk in reg.entry_free:
            if fk in entry:
                entry[fk] = frozenset()
        for _ in range(16):
            changed = False
            for caller, fp in passes.items():
                base = entry.get(caller)
                if base is None:
                    continue
                for (callee, site_locks) in fp.call_sites:
                    if callee not in entry:
                        continue
                    contrib = base | site_locks
                    cur = entry[callee]
                    new = contrib if cur is None else (cur & contrib)
                    if new != cur:
                        entry[callee] = new
                        changed = True
            if not changed:
                break
        return {k: (v if v is not None else frozenset())
                for k, v in entry.items()}

    # ---- access collection + whitelists ------------------------------------
    def _collect(self, reg: _ThreadRegistry, passes: Dict[str, _FuncPass],
                 entry: Dict[str, FrozenSet[LockId]]
                 ) -> Dict[AttrId, List[_Access]]:
        out: Dict[AttrId, List[_Access]] = {}
        for key, fp in passes.items():
            roots = frozenset(reg.reached.get(key, ()))
            if not roots:
                continue
            base = entry.get(key, frozenset())
            leaf = fp.qualname.split(".")[-1]
            spawn_line = reg.first_spawn_line.get(key)
            for (attr, line, kind, locks) in fp.accesses:
                mod, owner, name = attr
                if name.startswith("__"):
                    continue
                low = name.lower()
                if any(h in low for h in _SKIP_HINTS):
                    continue
                if (owner, name) in reg.safe_attrs or \
                        name in reg.safe_names:
                    continue
                # init-before-spawn: the object is unreachable by any
                # other thread until its constructor spawns/publishes
                if leaf == "__init__" and fp.cls is not None and \
                        (_lock_root_class(reg.graph, fp.cls) or fp.cls) \
                        == owner and \
                        (spawn_line is None or line < spawn_line):
                    continue
                if fp.src.is_suppressed(self.rule_id, line):
                    continue
                out.setdefault(attr, []).append(_Access(
                    attr, key, line, kind, base | locks, fp.src, roots))
        return out

    # ---- reporting ----------------------------------------------------------
    def _report(self, reg: _ThreadRegistry,
                by_attr: Dict[AttrId, List[_Access]],
                by_path: Dict[str, SourceFile]) -> List[Finding]:
        findings: List[Finding] = []
        class_suppressed: Dict[str, bool] = {}
        for attr in sorted(by_attr):
            accs = by_attr[attr]
            mod, owner, name = attr
            writes = [a for a in accs if a.is_write]
            if not writes:
                continue
            # publish-snapshot: every write a plain whole-attr store that
            # never reads what it overwrites — atomic reference publish
            if all(a.kind == _STORE for a in writes):
                continue
            # reporting gate: some access holds SOME lock, or the class
            # owns one — the code says "this state is meant to be shared"
            if owner not in class_suppressed:
                class_suppressed[owner] = self._is_class_suppressed(
                    reg, by_path, owner)
            if class_suppressed[owner]:
                continue
            gated = any(a.locks for a in accs) or owner in reg.lock_owners
            if not gated:
                continue
            pair = self._find_race(reg, writes, accs)
            if pair is None:
                continue
            w, other = pair
            findings.append(self._render(reg, attr, w, other))
        return findings

    @staticmethod
    def _is_class_suppressed(reg: _ThreadRegistry,
                             by_path: Dict[str, SourceFile],
                             owner: str) -> bool:
        """A ``# tpu-lint: disable=R012`` on (or right above) the class
        statement exempts every attribute of the class — the documented
        thread-confined-by-contract annotation."""
        ci = reg.graph.classes.get(owner)
        if ci is None:
            return False
        target = by_path.get(ci.module)
        if target is None:
            return False
        for n in ast.walk(target.tree):
            if isinstance(n, ast.ClassDef) and n.name == owner:
                return target.is_suppressed("R012", n.lineno)
        return False

    def _find_race(self, reg: _ThreadRegistry, writes: List[_Access],
                   accs: List[_Access]
                   ) -> Optional[Tuple[_Access, _Access]]:
        """The worst conflicting pair: prefer a lock-free write against a
        locked access (the classic forgotten-lock shape), then any
        disjoint-lockset pair."""
        best: Optional[Tuple[_Access, _Access]] = None
        best_score = -1
        for w in writes:
            for a in accs:
                if not reg.concurrent(w.roots, a.roots):
                    continue
                if not _locksets_disjoint(w.locks, a.locks):
                    continue
                score = (2 if a.is_write else 1) + \
                    (2 if not w.locks and a.locks else 0) + \
                    (1 if not w.locks else 0)
                if score > best_score:
                    best, best_score = (w, a), score
        return best

    def _render(self, reg: _ThreadRegistry, attr: AttrId, w: _Access,
                other: _Access) -> Finding:
        mod, owner, name = attr

        def site(a: _Access) -> str:
            fn = a.func.split("::")[-1]
            locks = ", ".join(sorted(
                f"{o}.{la}" if o else la for (_m, o, la) in a.locks)) \
                or "no locks"
            roots = ", ".join(sorted(
                r.split("::")[-1] if "::" in r else r
                for r in a.roots)[:3])
            return (f"{a.src.display_path}:{a.line} in {fn} "
                    f"[{a.kind}, holding {locks}; threads: {roots}]")

        anchor = ast.Pass()
        anchor.lineno = w.line
        kind = "write/write" if other.is_write else "write/read"
        return w.src.finding(
            self.rule_id, anchor,
            f"data race on {owner}.{name}: {kind} with no common lock — "
            f"{site(w)} vs {site(other)}; both sites are reachable from "
            f"concurrent thread roots and their locksets intersect to "
            f"the empty set. Guard both with the attribute's lock, "
            f"publish an immutable snapshot with a single plain store, "
            f"or justify the benign race with an inline "
            f"'# tpu-lint: disable=R012' comment")

    # ---- leaked-thread sub-check -------------------------------------------
    def _check_leaked_threads(self, reg: _ThreadRegistry) -> List[Finding]:
        findings: List[Finding] = []
        for (src, call, qualname, daemon, binding) in reg.spawns:
            p = src.display_path.replace("\\", "/")
            if not any(f"/{d}/" in p or p.startswith(f"{d}/")
                       for d in ("serving", "shuffle")):
                continue
            if daemon:
                continue
            if src.is_suppressed(self.rule_id, call.lineno):
                continue
            if binding is not None and self._joined(src, binding):
                continue
            findings.append(src.finding(
                self.rule_id, call,
                f"{qualname}: non-daemon thread started on a "
                f"serving/shuffle path with no reachable join()/stop "
                f"on the shutdown path — it outlives drain() and pins "
                f"interpreter exit (the accept-thread leak shape); pass "
                f"daemon=True, or keep the Thread and join it from "
                f"shutdown/close/drain"))
        return findings

    @staticmethod
    def _joined(src: SourceFile, binding: str) -> bool:
        """Some call in the module joins the binding the thread was
        stored under — shutdown-path hygiene at file scope. Matching is
        by the binding's leaf name ONLY: a wildcard on generic loop
        variables (``for t in workers: t.join()``) would silence the
        check for every unrelated thread in the file."""
        for n in ast.walk(src.tree):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "join":
                recv = dotted_name(n.func.value)
                if recv.split(".")[-1] == binding:
                    return True
        return False
