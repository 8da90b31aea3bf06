"""R007: a kernel library built or bound outside the program cache.

The port's compiled artifacts are its ``nvcc``-built kernel libraries, and
the serving program cache (serving/program_cache.py) is the one place that
builds and binds them: ``cuda_build.load`` hands it a builder under the
library's key, so one thread per process runs ``nvcc`` and the others wait
on its latch, the build's seconds land on the bound query, and the on-disk
index counts a library an earlier process built. A library built or bound
anywhere else (``cuda_build.build(...)``, ``ctypes.CDLL(...)``) does so
privately: invisible to hit/miss accounting, and two threads launching its
kernel first may both run ``nvcc``. The JAX package's R007 holds its jitted
programs to the same cache.

Allowed: a call inside ``serving/program_cache.py``; a call in the
argument of a cache route (``get_or_build``, ``cached_program``); a call in
a local function that its enclosing function hands to a cache route as the
builder (``cuda_build.load``'s ``builder``). A designed exception carries an
inline ``# tpu-lint: disable=R007`` with its reason.
"""
from __future__ import annotations

import ast
from typing import List, Set

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                                  call_name, register)

#: sanctioned cache entry points
_CACHE_ROUTES = ("cached_program", "get_or_build")

#: calls that build or bind a library
_BUILD_CALLS = ("cuda_build.build", "ctypes.CDLL", "CDLL")

_CACHE_MODULE = "serving/program_cache.py"


def _route(node: ast.Call) -> str:
    """The called name's last part: ``get_or_build`` also for
    ``global_program_cache().get_or_build``."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return node.func.id if isinstance(node.func, ast.Name) else ""


def _is_build(node: ast.Call) -> bool:
    name = call_name(node)
    return name in _BUILD_CALLS or name.endswith(".cuda_build.build")


def _routed_through_cache(src: SourceFile, node: ast.Call) -> bool:
    for anc in src.ancestors(node):
        if isinstance(anc, ast.Call) and _route(anc) in _CACHE_ROUTES:
            return True
    return False


def _routed_builders(fn: ast.AST) -> Set[str]:
    """Names of local functions ``fn`` passes to a cache route as its
    builder (any argument after the key)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _route(node) in _CACHE_ROUTES:
            for arg in list(node.args)[1:] + [kw.value for kw in
                                              node.keywords]:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
    return out


def _in_routed_builder(src: SourceFile, node: ast.Call) -> bool:
    inner = None
    for anc in src.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if inner is not None and inner.name in _routed_builders(anc):
                return True
            inner = anc
    return False


@register
class ProgramCacheBypass(Rule):
    rule_id = "R007"
    title = "kernel library built or bound outside the program cache"

    def check(self, src: SourceFile) -> List[Finding]:
        if src.display_path.replace("\\", "/").endswith(_CACHE_MODULE):
            return []
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not _is_build(node):
                continue
            if _routed_through_cache(src, node) or \
                    _in_routed_builder(src, node):
                continue
            findings.append(src.finding(
                self.rule_id, node,
                f"{call_name(node)}(...) builds or binds a library outside "
                f"the serving program cache: no per-key latch (two threads "
                f"may both build it), no hit/miss accounting; load it "
                f"through cuda_build.load / get_or_build, or justify it "
                f"with a suppression"))
        return findings
