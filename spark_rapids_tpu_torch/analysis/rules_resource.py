"""R008: resource leaks — an acquire whose release is skipped on some path.

PR 8's multi-tenant serving contract is built on unwind hygiene: every
device-semaphore hold, every retained catalog buffer, every in-flight
build latch must be released on EVERY path out of the function that took
it — the pre-fix catalog remove-vs-spill leak cost an 8-thread hammer
test to find, exactly the class of bug a premerge gate should catch.

The check runs the forward dataflow (dataflow.py) over each function's
CFG (cfg.py), tracking four acquire kinds:

- **catalog retain** — ``x = <...>catalog.acquire(...)`` / ``x.retain()``
  retains a spillable buffer; released by ``x.close()`` (or
  ``close_all`` containing x). Handing the buffer off — returning or
  yielding it, storing it into an attribute/subscript, appending it to a
  container — transfers ownership and ends tracking.
- **semaphore hold** — ``<recv>.acquire_if_necessary(...)`` paired with
  ``<recv>.release_if_necessary(...)`` on the same receiver (scoped
  ``with sem.held():`` is auto-released and never tracked).
- **admission permit** — bare ``<recv>.acquire(...)`` on a receiver whose
  name contains ``throttle``/``sem``, paired with ``<recv>.release(...)``;
  a nested def in the same function releasing the receiver counts as a
  deferred-release handoff (the shuffle client's ``release_once`` closure).
- **build latch** — ``container[key] = ev`` where ``ev`` was created by
  ``threading.Event()``; released by ``ev.set()`` or by popping/deleting
  from the container (the scan-cache / program-cache latch idiom).
- **connection handle** — ``x = <...transport...>.connect(...)`` dials a
  peer (a socket + reader thread in the TCP transport); released by
  ``x.close()`` or handed off — stored into a cache (the
  manager/client connection-cache idiom), returned, or passed into a
  wrapping constructor (``c = ShuffleClient(transport, conn, ...)``).
  A connect that escapes on an early-exit path leaks the socket AND
  desyncs the peer's hello handshake — the serving wire layer's new
  resource kind.

Branch sensitivity: the edge transfer kills a buffer token on the branch
that proved it None (``if buf is None: return`` leaks nothing), so the
acquire-then-guard idiom stays clean without suppressions.

Explicit paths only: a leak on an implicit exception path (a call that
might raise) is not flagged — wrap real cleanup in try/finally and the
finally path is modeled. ``raise`` statements ARE paths.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.analysis import dataflow
from spark_rapids_tpu_torch.analysis.cfg import (FALSE, TRUE, Block, Cond,
                                           WithEnter, build_cfg,
                                           iter_functions)
from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            call_name, dotted_name, register)

#: token: (kind, key, extra, acquire lineno)
Token = Tuple[str, str, str, int]

_CONSUME_ATTRS = {"append", "add", "put", "insert", "extend", "setdefault"}


def _call_of(stmt) -> Optional[ast.Call]:
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        return stmt.value
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _FuncAnalysis:
    """One function's R008 pass."""

    def __init__(self, src: SourceFile, qualname: str, node):
        self.src = src
        self.qualname = qualname
        self.node = node
        #: vars assigned threading.Event() anywhere in the function
        self.event_vars = self._scan_event_vars()
        #: permit receivers released by a nested def (deferred release)
        self.deferred_releases = self._scan_deferred_releases()
        self.nested = {id(n) for _qn, n in iter_functions(node)}
        #: id(item) -> precomputed (kills, gens) action list; the transfer
        #: runs once per fixpoint visit, so the AST walk must happen once
        #: per STATEMENT, not once per visit
        self._actions: Dict[int, List[Tuple[str, tuple]]] = {}

    def _scan_event_vars(self) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(self.node):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                cname = call_name(n.value)
                if cname.split(".")[-1] == "Event":
                    out.update(t.id for t in n.targets
                               if isinstance(t, ast.Name))
        return out

    def _scan_deferred_releases(self) -> Set[str]:
        out: Set[str] = set()
        for _qn, nested in iter_functions(self.node):
            for n in ast.walk(nested):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in ("release", "release_if_necessary"):
                    out.add(dotted_name(n.func.value))
        return out

    def _in_nested(self, node: ast.AST) -> bool:
        cur = self.src.parent(node)
        while cur is not None and cur is not self.node:
            if id(cur) in self.nested:
                return True
            cur = self.src.parent(cur)
        return False

    # ---- transfer -----------------------------------------------------------
    def _compute_actions(self, item) -> List[Tuple[str, tuple]]:
        """Precomputed ordered action list for one block item: kills and
        handoffs before gens, so `x = y.acquire()` over a previous acquire
        into x reads as a rebind, not a double hold."""
        if not isinstance(item, (ast.Assign, ast.AugAssign, ast.Expr,
                                 ast.Return, ast.Delete, ast.Assert,
                                 ast.Raise)):
            return []
        kills: List[Tuple[str, tuple]] = []
        gens: List[Tuple[str, tuple]] = []
        calls = [n for n in ast.walk(item)
                 if isinstance(n, ast.Call) and not self._in_nested(n)]
        for call in calls:
            if not isinstance(call.func, ast.Attribute):
                fname = call_name(call).split(".")[-1]
                if fname == "close_all" and call.args:
                    names = set()
                    for a in call.args:
                        names |= _names_in(a)
                    kills.append(("kill_buffer_names", (frozenset(names),)))
                continue
            attr = call.func.attr
            recv = dotted_name(call.func.value)
            line = call.lineno
            if attr == "close":
                kills.append(("kill_buffer_names", (frozenset({recv}),)))
            elif attr == "release_if_necessary":
                kills.append(("kill_sem", (recv,)))
            elif attr == "release":
                kills.append(("kill_permit", (recv,)))
            elif attr == "set":
                kills.append(("kill_latch_ev", (recv,)))
            elif attr == "pop":
                kills.append(("kill_latch_cont", (recv,)))
            elif attr == "acquire_if_necessary":
                gens.append(("gen", ("semaphore", recv, "", line)))
            elif attr == "retain":
                gens.append(("gen", ("buffer", recv, "", line)))
            elif attr == "acquire" and "catalog" in recv.lower():
                if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                        and isinstance(item.targets[0], ast.Name) \
                        and item.value is call:
                    gens.append(("gen", ("buffer", item.targets[0].id,
                                         "", line)))
            elif attr == "acquire" and any(
                    h in recv.lower() for h in ("throttle", "sem")):
                if recv not in self.deferred_releases:
                    gens.append(("gen", ("permit", recv, "", line)))
            elif attr == "connect" and "transport" in recv.lower():
                if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                        and isinstance(item.targets[0], ast.Name) \
                        and item.value is call:
                    gens.append(("gen", ("connection", item.targets[0].id,
                                         "", line)))

        # `x = None` drops the binding: whatever x held was released or
        # handed off out-of-band (the explicit-discard idiom)
        if isinstance(item, ast.Assign) and \
                isinstance(item.value, ast.Constant) and \
                item.value.value is None:
            dropped = frozenset(t.id for t in item.targets
                                if isinstance(t, ast.Name))
            if dropped:
                kills.append(("kill_buffer_names", (dropped,)))

        if isinstance(item, ast.Delete):
            for tgt in item.targets:
                if isinstance(tgt, ast.Subscript):
                    kills.append(("kill_latch_cont",
                                  (dotted_name(tgt.value),)))

        # handoffs: return/yield value, store into attribute/subscript,
        # append-style consumption
        handoff_exprs: List[ast.AST] = []
        if isinstance(item, ast.Return) and item.value is not None:
            handoff_exprs.append(item.value)
        for n in ast.walk(item):
            if isinstance(n, (ast.Yield, ast.YieldFrom)) and \
                    n.value is not None:
                handoff_exprs.append(n.value)
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _CONSUME_ATTRS:
                handoff_exprs.extend(n.args)
        if isinstance(item, ast.Assign):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in item.targets):
                handoff_exprs.append(item.value)
        handed: Set[str] = set()
        for expr in handoff_exprs:
            handed |= _names_in(expr)
        if handed:
            kills.append(("kill_buffer_names", (frozenset(handed),)))

        # connection handoff-by-wrapping: a connection passed into a call
        # whose result is BOUND (``c = ShuffleClient(transport, conn, ..)``)
        # transfers ownership to the wrapper — the cached-client idiom.
        # Scoped to the connection kind: buffers used via method calls must
        # still close, only wrapping constructors adopt connections.
        if isinstance(item, ast.Assign) and isinstance(item.value, ast.Call):
            wrapped: Set[str] = set()
            for a in item.value.args:
                wrapped |= _names_in(a)
            if wrapped:
                kills.append(("kill_conn_names", (frozenset(wrapped),)))

        # latch publish: container[key] = ev
        if isinstance(item, ast.Assign) and len(item.targets) == 1 and \
                isinstance(item.targets[0], ast.Subscript) and \
                isinstance(item.value, ast.Name) and \
                item.value.id in self.event_vars:
            recv = dotted_name(item.targets[0].value)
            gens.append(("gen", ("latch", recv, item.value.id,
                                 item.lineno)))
        return kills + gens

    def transfer(self, state: FrozenSet[Token], item, block: Block
                 ) -> FrozenSet[Token]:
        if isinstance(item, WithEnter):
            # with-acquired resources are scoped (auto-released)
            return state
        actions = self._actions.get(id(item))
        if actions is None:
            actions = self._compute_actions(item)
            self._actions[id(item)] = actions
        if not actions:
            return state
        out = set(state)
        for (op, args) in actions:
            if op == "kill_buffer_names":
                # name-keyed kinds share the close/handoff discipline
                names = args[0]
                out = {t for t in out
                       if not (t[0] in ("buffer", "connection")
                               and t[1] in names)}
            elif op == "kill_conn_names":
                names = args[0]
                out = {t for t in out
                       if not (t[0] == "connection" and t[1] in names)}
            elif op == "kill_sem":
                out = {t for t in out
                       if not (t[0] == "semaphore" and t[1] == args[0])}
            elif op == "kill_permit":
                out = {t for t in out
                       if not (t[0] == "permit" and t[1] == args[0])}
            elif op == "kill_latch_ev":
                out = {t for t in out
                       if not (t[0] == "latch" and t[2] == args[0])}
            elif op == "kill_latch_cont":
                out = {t for t in out
                       if not (t[0] == "latch" and t[1] == args[0])}
            elif op == "gen":
                kind, key, extra, line = args
                out = {t for t in out
                       if not (t[0] == kind and t[1] == key)}
                out.add((kind, key, extra, line))
        return frozenset(out)

    # ---- branch-sensitive None kills ---------------------------------------
    @staticmethod
    def edge_transfer(state: FrozenSet[Token], block: Block,
                      label: Optional[str]) -> FrozenSet[Token]:
        if label not in (TRUE, FALSE) or not block.items:
            return state
        last = block.items[-1]
        if not isinstance(last, Cond):
            return state
        none_names = _none_test_names(last.test)
        if not none_names:
            return state
        names, none_on = none_names
        if (none_on == TRUE and label == TRUE) or \
                (none_on == FALSE and label == FALSE):
            return frozenset(t for t in state
                             if not (t[0] in ("buffer", "connection")
                                     and t[1] in names))
        return state


def _none_test_names(test: ast.expr
                     ) -> Optional[Tuple[Set[str], str]]:
    """(names, edge-on-which-they-are-None): ``x is None`` -> True edge,
    ``x is not None`` / bare ``x`` -> False edge, ``not x`` -> True edge."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.left, ast.Name) and \
            isinstance(test.comparators[0], ast.Constant) and \
            test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return {test.left.id}, TRUE
        if isinstance(test.ops[0], ast.IsNot):
            return {test.left.id}, FALSE
    if isinstance(test, ast.Name):
        return {test.id}, FALSE
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) and \
            isinstance(test.operand, ast.Name):
        return {test.operand.id}, TRUE
    return None


_KIND_HINT = {
    "buffer": "retained buffer never close()d",
    "semaphore": "semaphore hold never release_if_necessary()d",
    "permit": "admission permit never release()d",
    "latch": "build latch never set/popped — waiters block forever",
    "connection": "connection handle never close()d or handed off — "
                  "the socket and its reader thread leak",
}


@register
class ResourceLeak(Rule):
    rule_id = "R008"
    title = "acquire escapes the function without release on some path"

    #: attr names whose presence makes a function worth the CFG pass
    _TRIGGERS = frozenset({"acquire", "retain", "acquire_if_necessary",
                           "Event", "connect"})

    def check(self, src: SourceFile) -> List[Finding]:
        # one cheap pre-pass: the dataflow only ever generates tokens from
        # these call shapes, so a function without any of them is clean by
        # construction and skips CFG construction entirely
        interesting: Set[int] = set()
        for n in ast.walk(src.tree):
            name = ""
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute):
                    name = n.func.attr
                else:
                    name = call_name(n).split(".")[-1]
            if name not in self._TRIGGERS:
                continue
            cur = src.parent(n)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    interesting.add(id(cur))
                    break
                cur = src.parent(cur)
        if not interesting:
            return []
        findings: List[Finding] = []
        for qualname, node in iter_functions(src.tree):
            if id(node) in interesting:
                findings.extend(self._check_function(src, qualname, node))
        return findings

    def _check_function(self, src: SourceFile, qualname: str,
                        node) -> List[Finding]:
        fa = _FuncAnalysis(src, qualname, node)
        cfg = build_cfg(node)
        states = dataflow.run_forward(cfg, fa.transfer,
                                      edge_transfer=fa.edge_transfer)
        leaked: Dict[Token, Set[int]] = {}
        for bid, block in cfg.blocks.items():
            if not any(t == cfg.exit for (t, _l) in block.succs):
                continue
            if bid not in states:
                continue                       # unreachable
            out = dataflow.block_out_state(cfg, bid, states, fa.transfer)
            for (t, label) in block.succs:
                if t != cfg.exit:
                    continue
                escaped = fa.edge_transfer(out, block, label)
                for token in escaped:
                    leaked.setdefault(token, set()).add(
                        block.last_lineno() or node.lineno)
        findings: List[Finding] = []
        for token in sorted(leaked, key=lambda t: t[3]):
            kind, key, _extra, line = token
            exits = sorted(leaked[token])
            fake = ast.Pass()
            fake.lineno = line
            findings.append(src.finding(
                self.rule_id, fake,
                f"{qualname}: {_KIND_HINT[kind]} — acquired here "
                f"('{key}'), but a path exiting near line"
                f"{'s' if len(exits) > 1 else ''} "
                f"{', '.join(map(str, exits))} escapes still holding it; "
                f"release in a finally, scope it with a context manager, "
                f"or hand it off explicitly (return/store); a designed "
                f"handoff gets an inline suppression with its "
                f"justification"))
        return findings
