"""R002: hidden host<->device syncs in hot paths, in PyTorch's idiom.

A device tensor read by the host stalls the host until every kernel queued
before it has run, so a per-batch loop that reads one serializes the host
and the card. The checks, scoped to the hot-path packages (execs/, ops/,
shuffle/; ``core.HOT_PATH_DIRS``):

- ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` without arguments,
  anywhere: each copies a tensor to the host and waits for it;
- ``torch.cuda.synchronize()`` anywhere: a wait for the whole device;
- ``int()`` / ``float()`` / ``bool()`` of a device value inside a loop: a
  scalar download per iteration. A device value is the result of a
  ``torch.*`` call, a name the same function scope bound from one, a
  subscript of such a name, or a reduction (``.sum()``, ``.max()``,
  ``.any()``, ...) of a device value; a numpy value is not one.

Designed sync points (the one host read of a batch's counts, a row count
that picks the output's capacity) carry an inline
``# tpu-lint: disable=R002`` with the reason, as in the JAX package; a new
one must batch its reads or argue its case the same way.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                                  call_name, register)

#: tensor methods that copy to the host and wait (called without arguments)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: builtins that force a scalar host read when fed a device value
_SCALAR_CASTS = {"int", "float", "bool"}

#: tensor methods whose result stays on the tensor's device
_REDUCTIONS = {"sum", "max", "min", "any", "all", "prod", "mean",
               "count_nonzero", "argmax", "argmin", "amax", "amin"}

#: torch.* calls that return no device tensor
_HOST_TORCH = {"device", "dtype", "Size", "get_num_threads", "is_tensor",
               "promote_types", "iinfo", "finfo"}


def _is_device(node: ast.AST, names: Set[str]) -> bool:
    """Whether ``node`` evaluates to a device tensor: a ``torch.*`` call, a
    device name or a subscript of one, or a reduction of a device value."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id in names
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    if name.startswith("torch.") and not name.startswith("torch.cuda.") \
            and name.rsplit(".", 1)[-1] not in _HOST_TORCH:
        return True
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _REDUCTIONS and _is_device(node.func.value, names)


def _scope_nodes(fn_node: ast.AST):
    """The nodes of one function scope, not descending into nested
    def/lambda bodies."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _device_names(fn_node: ast.AST) -> Set[str]:
    """Names a scope binds from a device call (a later host re-binding of
    the same name clears it)."""
    names: Set[str] = set()
    assigns = sorted((n for n in _scope_nodes(fn_node)
                      if isinstance(n, ast.Assign)), key=lambda n: n.lineno)
    for node in assigns:
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if _is_device(node.value, names):
            names.update(targets)
        else:
            names.difference_update(targets)
    return names


@register
class HiddenHostSyncs(Rule):
    rule_id = "R002"
    title = "hidden host<->device syncs in hot paths"

    def check(self, src: SourceFile) -> List[Finding]:
        if not src.is_hot_path():
            return []
        findings: List[Finding] = []
        scopes: Dict[ast.AST, Set[str]] = {}

        def device_names(node: ast.AST) -> Set[str]:
            fn = src.tree
            for anc in src.ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = anc
                    break
            if fn not in scopes:
                scopes[fn] = _device_names(fn)
            return scopes[fn]

        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and not node.args \
                    and not node.keywords:
                findings.append(src.finding(
                    self.rule_id, node,
                    f".{node.func.attr}() copies to the host and waits for "
                    f"the device; read once per batch, batched with the "
                    f"other reads, or justify the sync point with a "
                    f"suppression"))
                continue
            cname = call_name(node)
            if cname == "torch.cuda.synchronize":
                findings.append(src.finding(
                    self.rule_id, node,
                    "torch.cuda.synchronize() waits for the whole device on "
                    "a hot path; wait on the event of the work the host "
                    "needs instead"))
                continue
            if cname in _SCALAR_CASTS and len(node.args) == 1 and \
                    src.inside_loop(node):
                if _is_device(node.args[0], device_names(node)):
                    findings.append(src.finding(
                        self.rule_id, node,
                        f"{cname}() of a device value inside a loop reads a "
                        f"scalar per iteration, serializing the host and "
                        f"the device; batch the reads or justify the sync "
                        f"point with a suppression"))
        return findings
