"""R010: cancellation-unsafe blocking waits on execute paths.

PR 8's cancellation contract is COOPERATIVE: ``cancel()`` only sets a
flag, and the running query must observe it at checkpoints — exec
boundaries, semaphore admission, the pipeline producer, cache latches.
One unbounded wait anywhere on the execute path breaks the whole
contract: a cancelled query blocked in ``queue.get()`` with no timeout
sits there until the process dies, still holding its semaphore permit
and catalog buffers.

The check: a blocking primitive reachable (callgraph.py, bounded hops)
from a serving/exec execute root —

- roots: every ``execute`` method in ``execs/``, plus the serving
  scheduler's worker path (``_worker_loop`` / ``_run_handle``), the
  serving wire surface (``serve_forever`` — the server's accept/run
  loop must poll bounded so shutdown and signals land — plus the
  client's ``submit`` / ``batches`` / ``result`` stream drivers) and
  the DataFrame collect entry (``_collect``);
- blocking primitives: ``<queue>.get()`` where the receiver is a
  ``queue.Queue`` (created in the function, assigned to an attr in the
  same module, or named ``*queue*``/``q``), and ``<event-or-cond>.wait()``
  — in BOTH cases only when called with NO timeout: a wait with a
  timeout is the sanctioned poll idiom (``while not ev.wait(0.05):
  cancel_check()``), which every repo latch uses.

A server-side loop that is legitimately outside the per-query contract
(an RPC dispatch thread, a daemon) is not reachable from the roots by
construction; if one ever is, it takes an inline suppression with the
justification, not a baseline entry.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from spark_rapids_tpu_torch.analysis.callgraph import graph_for
from spark_rapids_tpu_torch.analysis.cfg import iter_functions
from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            call_name, dotted_name, register)

#: call-graph hops from an execute root the contract extends through
_MAX_DEPTH = 12

#: receiver-name fragments marking an Event/Condition/latch wait
_WAIT_HINTS = ("ev", "event", "cond", "latch", "done", "ready", "_cv",
               "available", "room")
#: receiver-name fragments marking a queue
_QUEUE_HINTS = ("queue", "_q")


def _is_queue_typed(src: SourceFile, func_node, recv: str) -> bool:
    """Receiver is a queue: assigned ``queue.Queue(...)`` in this function
    or this module, annotated as one, or named like one."""
    leaf = recv.split(".")[-1].lower()
    if recv.lower() == "q" or leaf == "q":
        return True
    if any(h in recv.lower() for h in _QUEUE_HINTS):
        return True
    for n in ast.walk(src.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            vname = call_name(n.value)
            if vname.split(".")[-1] != "Queue":
                continue
            for t in n.targets:
                if dotted_name(t) == recv or (
                        isinstance(t, ast.Attribute) and
                        t.attr == recv.split(".")[-1]):
                    return True
        if isinstance(n, ast.AnnAssign) and n.annotation is not None:
            ann = ""
            if isinstance(n.annotation, ast.Constant):
                ann = str(n.annotation.value)
            else:
                ann = dotted_name(n.annotation)
            if "Queue" in ann and dotted_name(n.target) == recv:
                return True
    return False


def _is_bounded(call: ast.Call, attr: str) -> bool:
    """The call cannot block forever: a real timeout is supplied, or a
    queue ``get`` is non-blocking. Spelling the unbounded default out
    (``q.get(True)`` / ``q.get(block=True)``) does NOT bound it."""
    kws = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    if "timeout" in kws:
        v = kws["timeout"]
        return not (isinstance(v, ast.Constant) and v.value is None)
    if attr == "get":
        if "block" in kws:
            v = kws["block"]
            # block=False is non-blocking; block=True (or dynamic) without
            # a timeout is the unbounded default restated
            return isinstance(v, ast.Constant) and v.value is False
        if call.args:
            if len(call.args) >= 2:
                return True            # get(block, timeout)
            first = call.args[0]
            if isinstance(first, ast.Constant) and first.value is True:
                return False           # get(True): explicitly unbounded
            # get(False) is non-blocking; a dynamic block arg stays silent
            # (the engine errs toward no false findings)
            return True
        return False
    # Event/Condition/latch wait(): the first positional IS the timeout
    return bool(call.args)


@register
class CancellationUnsafeWait(Rule):
    rule_id = "R010"
    title = "unbounded blocking wait reachable from an execute path"
    is_project_rule = True

    def _roots(self, graph) -> List[str]:
        roots: List[str] = []
        for key, info in graph.functions.items():
            mod = info.module.replace("\\", "/")
            name = info.qualname.split(".")[-1]
            if name == "execute" and ("/execs/" in mod or
                                      mod.startswith("execs/")):
                roots.append(key)
            elif ("/serving/" in mod or mod.startswith("serving/")) and \
                    name in ("_worker_loop", "_run_handle", "submit",
                             "drain", "serve_forever", "batches",
                             "result"):
                roots.append(key)
            elif name == "_collect" and mod.endswith("api/dataframe.py"):
                roots.append(key)
        return roots

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        graph = graph_for(files)
        roots = self._roots(graph)
        if not roots:
            return []
        reachable = graph.reachable(roots, max_depth=_MAX_DEPTH)
        findings: List[Finding] = []
        seen: Set[int] = set()
        for key in sorted(reachable):
            info = graph.functions[key]
            nested = {id(n) for _qn, n in iter_functions(info.node)}
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call) or \
                        not isinstance(node.func, ast.Attribute):
                    continue
                if self._inside_other_function(info, node, nested):
                    continue
                attr = node.func.attr
                recv = dotted_name(node.func.value)
                if not recv:
                    continue
                blocking = False
                what = ""
                if attr == "get" and not _is_bounded(node, attr) and \
                        _is_queue_typed(info.src, info.node, recv):
                    blocking = True
                    what = f"{recv}.get()"
                elif attr == "wait" and not _is_bounded(node, attr) and \
                        any(h in recv.lower() for h in _WAIT_HINTS):
                    blocking = True
                    what = f"{recv}.wait()"
                if not blocking:
                    continue
                if id(node) in seen:
                    continue
                seen.add(id(node))
                findings.append(info.src.finding(
                    self.rule_id, node,
                    f"{info.qualname}: {what} blocks with no timeout on a "
                    f"path reachable from a serving/exec execute root "
                    f"(e.g. {graph.functions[roots[0]].qualname}): a "
                    f"cancelled query never observes its flag here and "
                    f"holds its semaphore/buffers forever; poll with a "
                    f"timeout and call the bound query's "
                    f"cancel_check/check_cancelled between polls (the "
                    f"scan-cache latch idiom), or justify with an inline "
                    f"suppression"))
        return findings

    @staticmethod
    def _inside_other_function(info, node, nested) -> bool:
        cur = info.src.parent(node)
        while cur is not None and cur is not info.node:
            if id(cur) in nested:
                return True
            cur = info.src.parent(cur)
        return False
