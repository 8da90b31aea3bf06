"""Per-function control-flow graphs for tpu-lint v2.

PR 8 made the engine's correctness rest on cross-statement properties —
"every semaphore hold is released on every unwind path" is a claim about
PATHS, not lines — which the v1 flat AST matchers cannot express. This
module builds a small, honest CFG per function: basic blocks of simple
statements, labeled branch edges (``true``/``false`` off a condition),
loop back-edges, try/except/finally routing, and ``with`` enter/exit
markers. The forward dataflow engine in ``dataflow.py`` runs over it.

Modeling decisions (kept deliberately boring):

- Only EXPLICIT control flow is modeled: ``return``/``raise``/``break``/
  ``continue`` and structured statements. Implicit exceptions from
  arbitrary calls are approximated by edges from every block in a ``try``
  body to its handlers; outside a ``try`` they are not modeled (flagging
  every call as a potential unwind would drown real findings).
- ``finally`` bodies are built once; every exit of the protected body
  routes through them. An abrupt exit (return/break/continue) through a
  finally is routed finally-entry first, with the finally's end edged to
  the abrupt target — paths merge there, a standard may-analysis
  over-approximation.
- ``with`` is transparent to the graph (its body cannot be skipped); the
  block stream carries ``WithEnter``/``WithExit`` markers so rules can
  treat context-managed acquires as auto-released.
- Compound headers are wrapped (``Cond``, ``LoopIter``, ``Handler``) so a
  rule walking a block's items never wanders into a nested body it will
  also see as separate blocks.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

#: edge labels off a condition block
TRUE, FALSE = "true", "false"


class Cond:
    """Block-terminating branch condition (If/While test). Successor edges
    carry ``true``/``false`` labels."""

    __slots__ = ("test", "node")

    def __init__(self, test: ast.expr, node: ast.stmt):
        self.test = test
        self.node = node

    @property
    def lineno(self) -> int:
        return getattr(self.test, "lineno", getattr(self.node, "lineno", 1))


class LoopIter:
    """For-loop header: ``target`` bound from ``iter`` each round; the
    ``true`` edge enters the body, ``false`` exits the loop."""

    __slots__ = ("target", "iter", "node")

    def __init__(self, node: ast.For):
        self.target = node.target
        self.iter = node.iter
        self.node = node

    @property
    def lineno(self) -> int:
        return self.node.lineno


class Handler:
    """An ``except`` clause entry marker (carries the ExceptHandler node)."""

    __slots__ = ("node",)

    def __init__(self, node: ast.ExceptHandler):
        self.node = node

    @property
    def lineno(self) -> int:
        return self.node.lineno


class WithEnter:
    """``with`` statement entry: carries the withitems."""

    __slots__ = ("items", "node")

    def __init__(self, node):
        self.items = node.items
        self.node = node

    @property
    def lineno(self) -> int:
        return self.node.lineno


class WithExit:
    """``with`` statement normal exit (context managers released here on
    the fall-through path; abrupt exits release too — rules must treat
    with-acquired resources as scoped)."""

    __slots__ = ("items", "node")

    def __init__(self, node):
        self.items = node.items
        self.node = node

    @property
    def lineno(self) -> int:
        return self.node.lineno


class Block:
    __slots__ = ("id", "items", "succs")

    def __init__(self, bid: int):
        self.id = bid
        #: simple statements and Cond/LoopIter/Handler/WithEnter/WithExit
        self.items: List[object] = []
        #: (target block id, edge label or None)
        self.succs: List[Tuple[int, Optional[str]]] = []

    def last_lineno(self) -> int:
        for item in reversed(self.items):
            ln = getattr(item, "lineno", None)
            if ln is not None:
                return ln
        return 0


class CFG:
    """One function's control-flow graph. ``entry`` starts the body;
    ``exit`` is the single synthetic sink every return/raise/fall-off
    reaches."""

    def __init__(self):
        self.blocks: Dict[int, Block] = {}
        self.entry: int = -1
        self.exit: int = -1

    def block(self, bid: int) -> Block:
        return self.blocks[bid]

    def predecessors(self, bid: int) -> List[Tuple[int, Optional[str]]]:
        return [(b.id, label) for b in self.blocks.values()
                for (t, label) in b.succs if t == bid]

    def back_edges(self) -> List[Tuple[int, int]]:
        """(src, dst) edges that close a loop (dst discovered before src on
        a DFS from entry) — the loop back-edge test hook."""
        seen: Dict[int, int] = {}
        order = 0
        out: List[Tuple[int, int]] = []
        onpath: List[int] = []

        def dfs(bid: int):
            nonlocal order
            seen[bid] = order
            order += 1
            onpath.append(bid)
            for (t, _lbl) in self.blocks[bid].succs:
                if t not in seen:
                    dfs(t)
                elif t in onpath:
                    out.append((bid, t))
            onpath.pop()

        dfs(self.entry)
        return out


class _FinallyFrame:
    """One pending ``finally`` between a statement and the scopes outside
    it. Abrupt exits enter at ``entry``; once the subgraph is built,
    ``end`` gets an edge to every recorded abrupt target."""

    __slots__ = ("entry", "end", "targets")

    def __init__(self, entry: int):
        self.entry = entry
        self.end: Optional[int] = None
        self.targets: List[int] = []


class _Env:
    __slots__ = ("break_target", "continue_target", "handlers", "finallies")

    def __init__(self, break_target=None, continue_target=None,
                 handlers=(), finallies=()):
        self.break_target = break_target
        self.continue_target = continue_target
        #: handler block ids of the innermost enclosing try
        self.handlers = handlers
        #: innermost-last stack of _FinallyFrame
        self.finallies = finallies

    def child(self, **kw) -> "_Env":
        out = _Env(self.break_target, self.continue_target,
                   self.handlers, self.finallies)
        for k, v in kw.items():
            setattr(out, k, v)
        return out


_SIMPLE = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Pass,
           ast.Assert, ast.Import, ast.ImportFrom, ast.Global, ast.Nonlocal,
           ast.Delete, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


class _Builder:
    def __init__(self):
        self.cfg = CFG()
        self._next = 0
        self.cfg.exit = self.new_block().id

    def new_block(self) -> Block:
        b = Block(self._next)
        self._next += 1
        self.cfg.blocks[b.id] = b
        return b

    def edge(self, src: Block, dst_id: int, label: Optional[str] = None):
        if (dst_id, label) not in src.succs:
            src.succs.append((dst_id, label))

    # ---- abrupt-exit routing ----------------------------------------------
    def _route(self, cur: Block, env: _Env, target: int):
        """Edge ``cur`` toward ``target`` through any pending finallies
        (innermost first); the finally end is wired to ``target`` when the
        enclosing Try finishes building."""
        if env.finallies:
            frame = env.finallies[-1]
            self.edge(cur, frame.entry)
            if target not in frame.targets:
                frame.targets.append(target)
        else:
            self.edge(cur, target)

    # ---- statement sequences ----------------------------------------------
    def seq(self, stmts, cur: Optional[Block], env: _Env) -> Optional[Block]:
        """Build ``stmts`` starting in ``cur``; returns the fall-through
        block, or None when every path terminated."""
        for stmt in stmts:
            if cur is None:         # unreachable tail (after return/raise)
                cur = self.new_block()
            cur = self.stmt(stmt, cur, env)
        return cur

    def stmt(self, node, cur: Block, env: _Env) -> Optional[Block]:
        if isinstance(node, _SIMPLE):
            cur.items.append(node)
            return cur
        if isinstance(node, ast.Return):
            cur.items.append(node)
            self._route(cur, env, self.cfg.exit)
            return None
        if isinstance(node, ast.Raise):
            cur.items.append(node)
            if env.handlers:
                for h in env.handlers:
                    self.edge(cur, h)
            else:
                self._route(cur, env, self.cfg.exit)
            return None
        if isinstance(node, ast.Break):
            if env.break_target is not None:
                self._route(cur, env, env.break_target)
            return None
        if isinstance(node, ast.Continue):
            if env.continue_target is not None:
                self._route(cur, env, env.continue_target)
            return None
        if isinstance(node, ast.If):
            return self._if(node, cur, env)
        if isinstance(node, (ast.While,)):
            return self._while(node, cur, env)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return self._for(node, cur, env)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return self._with(node, cur, env)
        if isinstance(node, ast.Try):
            return self._try(node, cur, env)
        # unknown compound (e.g. Match): keep it opaque but present
        cur.items.append(node)
        return cur

    # ---- structured statements --------------------------------------------
    def _if(self, node: ast.If, cur: Block, env: _Env) -> Optional[Block]:
        cur.items.append(Cond(node.test, node))
        then_b = self.new_block()
        self.edge(cur, then_b.id, TRUE)
        then_end = self.seq(node.body, then_b, env)
        if node.orelse:
            else_b = self.new_block()
            self.edge(cur, else_b.id, FALSE)
            else_end = self.seq(node.orelse, else_b, env)
        else:
            else_end = None
        if then_end is None and node.orelse and else_end is None:
            return None
        join = self.new_block()
        if not node.orelse:
            self.edge(cur, join.id, FALSE)
        if then_end is not None:
            self.edge(then_end, join.id)
        if else_end is not None:
            self.edge(else_end, join.id)
        return join

    def _while(self, node: ast.While, cur: Block, env: _Env) -> Block:
        head = self.new_block()
        self.edge(cur, head.id)
        head.items.append(Cond(node.test, node))
        body = self.new_block()
        after = self.new_block()
        self.edge(head, body.id, TRUE)
        body_end = self.seq(node.body, body,
                            env.child(break_target=after.id,
                                      continue_target=head.id))
        if body_end is not None:
            self.edge(body_end, head.id)       # the loop back-edge
        self._loop_orelse(node, head, after, env)
        return after

    def _for(self, node, cur: Block, env: _Env) -> Block:
        head = self.new_block()
        self.edge(cur, head.id)
        head.items.append(LoopIter(node))
        body = self.new_block()
        after = self.new_block()
        self.edge(head, body.id, TRUE)
        body_end = self.seq(node.body, body,
                            env.child(break_target=after.id,
                                      continue_target=head.id))
        if body_end is not None:
            self.edge(body_end, head.id)       # the loop back-edge
        self._loop_orelse(node, head, after, env)
        return after

    def _loop_orelse(self, node, head: Block, after: Block, env: _Env):
        """Wire the loop's normal (exhausted) exit: through the ``else``
        clause when present — ``break`` jumps straight to ``after`` and
        must NOT execute it."""
        if node.orelse:
            orelse_b = self.new_block()
            self.edge(head, orelse_b.id, FALSE)
            orelse_end = self.seq(node.orelse, orelse_b, env)
            if orelse_end is not None:
                self.edge(orelse_end, after.id)
        else:
            self.edge(head, after.id, FALSE)

    def _with(self, node, cur: Block, env: _Env) -> Optional[Block]:
        cur.items.append(WithEnter(node))
        end = self.seq(node.body, cur, env)
        if end is None:
            return None
        end.items.append(WithExit(node))
        return end

    def _try(self, node: ast.Try, cur: Block, env: _Env) -> Optional[Block]:
        body_entry = self.new_block()
        self.edge(cur, body_entry.id)
        handler_blocks: List[Block] = []
        for h in node.handlers:
            hb = self.new_block()
            hb.items.append(Handler(h))
            handler_blocks.append(hb)
        frame = None
        finallies = env.finallies
        if node.finalbody:
            frame = _FinallyFrame(self.new_block().id)
            finallies = env.finallies + (frame,)

        # this try's handlers CHAIN onto the enclosing ones — an uncaught
        # raise in a nested (or finally-only) try may still land in an
        # outer except, so replacing the set would sever real release paths
        body_env = env.child(handlers=tuple(b.id for b in handler_blocks)
                             + tuple(env.handlers),
                             finallies=finallies)
        body_end = self.seq(node.body, body_entry, body_env)
        # any statement in the try body may raise into any handler
        for bid in range(body_entry.id, self._next):
            blk = self.cfg.blocks.get(bid)
            if blk is None or blk in handler_blocks:
                continue
            for hb in handler_blocks:
                if bid != hb.id:
                    self.edge(blk, hb.id)
        if node.orelse and body_end is not None:
            body_end = self.seq(node.orelse, body_end, body_env)

        handler_env = env.child(finallies=finallies)
        handler_ends = [self.seq(h.body, hb, handler_env)
                        for h, hb in zip(node.handlers, handler_blocks)]

        ends = [e for e in [body_end, *handler_ends] if e is not None]
        if node.finalbody:
            f_entry = self.cfg.blocks[frame.entry]
            for e in ends:
                self.edge(e, f_entry.id)
            implicit_only = not ends and not frame.targets
            if implicit_only:
                # finally reachable only through an implicit unwind the
                # graph does not model; keep it wired from the body entry
                self.edge(body_entry, f_entry.id)
            f_end = self.seq(node.finalbody, f_entry, env)
            frame.end = f_end.id if f_end is not None else None
            if f_end is not None:
                # abrupt targets route through any still-pending OUTER
                # finallies (env here excludes this frame): a return
                # escaping two nested try/finally levels must pass through
                # BOTH finally bodies before reaching exit
                for t in frame.targets:
                    self._route(f_end, env, t)
                if implicit_only:
                    # the unwind RESUMES after the finally — an enclosing
                    # except may catch it, else the function is exited;
                    # it never falls through to the code after the try
                    if env.handlers:
                        for h in env.handlers:
                            self.edge(f_end, h)
                    else:
                        self._route(f_end, env, self.cfg.exit)
            if not ends:
                return None
            after = self.new_block()
            if f_end is not None:
                self.edge(f_end, after.id)
            return after
        if not ends:
            return None
        after = self.new_block()
        for e in ends:
            self.edge(e, after.id)
        return after


def build_cfg(func) -> CFG:
    """CFG for one FunctionDef/AsyncFunctionDef. Nested defs/lambdas are
    opaque single statements (build their CFGs separately)."""
    b = _Builder()
    entry = b.new_block()
    b.cfg.entry = entry.id
    end = b.seq(func.body, entry, _Env())
    if end is not None:
        b.edge(end, b.cfg.exit)        # implicit return at fall-off
    return b.cfg


def walk_local(func: ast.AST):
    """``ast.walk`` limited to one function's own scope: does not descend
    into nested def/class/lambda bodies (their statements run in their own
    activation, not on this function's paths)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def iter_functions(tree: ast.AST):
    """Every (qualname, FunctionDef) in a module, including methods and
    nested defs — qualnames use the ``Class.method`` / ``outer.inner``
    dotted form."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                out.append((qn, child))
                walk(child, f"{qn}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out
