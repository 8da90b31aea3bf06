"""R004/R005: cross-file drift rules.

R004 — config drift. Every tunable is declared once in config.py
(``NAME = _conf("key", ...)``); the engine reads it through the declared
constant (``conf.get(cfg.NAME)``) or, rarely, a registered string literal
(``get_raw("spark.rapids.tpu...")``). Two drift modes, both of which have
shipped silently before:

- a key is registered (and documented in docs/configs.md) but nothing ever
  reads it — users set it and nothing happens;
- a string literal under the conf prefix is read but never registered — a
  typo'd key silently returns the default forever.

A constant counts as read when ANY reference beyond its defining assignment
exists, including config.py's own convenience properties (the property is
the read path). Dynamic per-rule enable keys
(``spark.rapids.tpu.sql.expression.<Name>``, plan/overrides.py) are built
at runtime, never literals, so they don't trip the unregistered check.

R005 — Cpu/Tpu exec constructor parity, the api_validation reflection check
(ApiValidation.scala analog) surfaced as lint findings so premerge reports
every hygiene failure through one tool with one suppression/baseline story.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                            call_name, register)

_CONF_PREFIX = "spark.rapids.tpu"


def _find_config_file(files: Sequence[SourceFile]) -> Optional[SourceFile]:
    for f in files:
        p = f.display_path.replace("\\", "/")
        if p.endswith("spark_rapids_tpu_torch/config.py") or p == "config.py":
            return f
    return None


def registered_keys(config_src: SourceFile) -> Dict[str, Tuple[str, int]]:
    """constant name -> (full key, lineno) from ``NAME = _conf("key", ...)``
    assignments in config.py."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in config_src.tree.body:
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        if call_name(node.value) != "_conf" or not node.value.args:
            continue
        key_node = node.value.args[0]
        if not (isinstance(key_node, ast.Constant)
                and isinstance(key_node.value, str)):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            key = key_node.value
            if not key.startswith(_CONF_PREFIX):
                key = f"{_CONF_PREFIX}.{key}"
            out[target.id] = (key, node.lineno)
    return out


def _identifier_uses(files: Sequence[SourceFile]) -> Dict[str, int]:
    """How often each identifier appears as a Name or attribute access across
    the file set (reads of ``cfg.NAME`` land here as the attribute name)."""
    counts: Dict[str, int] = {}
    for src in files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Name):
                counts[node.id] = counts.get(node.id, 0) + 1
            elif isinstance(node, ast.Attribute):
                counts[node.attr] = counts.get(node.attr, 0) + 1
    return counts


def _string_key_literals(files: Sequence[SourceFile]
                         ) -> List[Tuple[SourceFile, ast.Constant]]:
    out = []
    for src in files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.startswith(_CONF_PREFIX + "."):
                out.append((src, node))
    return out


@register
class ConfigDrift(Rule):
    rule_id = "R004"
    title = "config drift (dead or unregistered keys)"
    is_project_rule = True

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        config_src = _find_config_file(files)
        if config_src is None:
            return []  # analyzing a subtree without the registry
        findings: List[Finding] = []
        keys = registered_keys(config_src)
        uses = _identifier_uses(files)
        for name, (key, lineno) in sorted(keys.items()):
            # one use is the defining assignment itself
            if uses.get(name, 0) <= 1:
                findings.append(Finding(
                    self.rule_id, config_src.display_path, lineno,
                    f"config key {key} ({name}) is registered and "
                    f"documented but never read by the engine; wire it up "
                    f"or remove it", config_src.line_text(lineno)))
        known = {key for key, _ in keys.values()}
        # dynamic per-rule enable keys share the sql.expression/sql.exec
        # namespaces (plan/overrides.py derives them from class names)
        dynamic_ns = (f"{_CONF_PREFIX}.sql.expression.",
                      f"{_CONF_PREFIX}.sql.exec.")
        for src, node in _string_key_literals(files):
            val = node.value
            if val in known or val.startswith(dynamic_ns):
                continue
            # prefix-only literals (env-var mapping, docs) are not key reads
            if val.count(".") <= _CONF_PREFIX.count("."):
                continue
            findings.append(src.finding(
                self.rule_id, node,
                f"conf key literal '{val}' is not registered in config.py; "
                f"a typo here silently returns the default forever"))
        return findings


@register
class ExecParity(Rule):
    rule_id = "R005"
    title = "Cpu/Tpu exec constructor parity"
    is_project_rule = True

    def check_project(self, files: Sequence[SourceFile]) -> List[Finding]:
        paths = {f.display_path.replace("\\", "/") for f in files}
        if not any(p.endswith("api_validation.py") for p in paths):
            return []  # subtree run without the exec modules
        try:
            from spark_rapids_tpu_torch import api_validation
            problems = api_validation.validate()
        except Exception as e:  # noqa: BLE001 - import errors ARE findings
            return [Finding(self.rule_id, "spark_rapids_tpu_torch/api_validation.py",
                            1, f"api_validation failed to run: "
                               f"{type(e).__name__}: {e}")]
        return [Finding(self.rule_id, "spark_rapids_tpu_torch/api_validation.py", 1,
                        f"Cpu/Tpu exec constructor mismatch: {p}")
                for p in problems]
