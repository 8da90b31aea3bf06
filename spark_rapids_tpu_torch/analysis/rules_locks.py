"""R006: locks held across blocking I/O.

The shuffle transport runs reader, progress, worker, and accept threads
against shared peer/tag/client tables. A mutex held across a blocking
socket call or a ``Future.result()`` serializes every peer behind the
slowest socket — and with the fetch timeout at 300 s, a wedged peer shows
up as a cluster-wide stall rather than an error.

The check: inside a ``with <lock>`` body (any context-manager expression
whose name contains "lock" — the repo's naming convention for
``threading.Lock``/``RLock``; Condition variables are named ``_available``
/ ``_room`` and correctly wait while releasing), flag calls to

- socket primitives: ``sendall`` / ``send`` on a socket-named receiver,
  ``recv`` / ``recv_into`` / ``accept`` / ``connect`` /
  ``create_connection``
- ``.result()`` (Future) and ``.join()`` (Thread) — unbounded waits

``.wait()`` is NOT flagged: on a Condition acquired by the same ``with``
it releases the lock while waiting (the correct pattern, used by the
bounce-buffer pool and the inflight throttle).

The one legitimate case — a per-socket writer lock serializing frame
writes (tcp.py ``_send_frame``) — carries an inline suppression with its
justification.
"""
from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            call_name, dotted_name, register)

#: attribute calls that block on the network / another thread
_BLOCKING_ATTRS = {"sendall", "recv", "recv_into", "accept", "connect",
                   "result"}
#: receiver-name fragments that make a bare .send/.recv socket-like
_SOCKET_HINTS = ("sock", "socket", "conn")


def _is_lock_expr(node: ast.AST) -> bool:
    name = dotted_name(node)
    if not name and isinstance(node, ast.Call):
        name = call_name(node)
    return "lock" in name.lower()


def _receiver_name(func: ast.Attribute) -> str:
    return dotted_name(func.value).lower()


@register
class LockAcrossBlockingIO(Rule):
    rule_id = "R006"
    title = "lock held across blocking I/O"

    def check(self, src: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_is_lock_expr(item.context_expr)
                       for item in node.items):
                continue
            for inner in ast.walk(node):
                if not isinstance(inner, ast.Call) or \
                        not isinstance(inner.func, ast.Attribute):
                    continue
                attr = inner.func.attr
                recv = _receiver_name(inner.func)
                blocking = (
                    attr in _BLOCKING_ATTRS
                    or (attr in ("send", "makefile")
                        and any(h in recv for h in _SOCKET_HINTS))
                    or (attr == "join"
                        and any(h in recv for h in ("thread", "proc")))
                    or call_name(inner) == "socket.create_connection")
                if not blocking:
                    continue
                findings.append(src.finding(
                    self.rule_id, inner,
                    f".{attr}() called while holding a lock: a slow or "
                    f"wedged peer stalls every thread contending for it; "
                    f"copy state under the lock, block outside it (or "
                    f"justify a per-socket writer lock with a "
                    f"suppression)"))
        return findings
