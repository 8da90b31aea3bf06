"""tpu-lint baseline: grandfathered findings with written justifications.

The baseline is a checked-in JSON file (default ci/tpu-lint-baseline.json)
listing findings that predate a rule and are allowed to stand. Every entry
MUST carry a non-empty ``justification`` — an entry without one fails the
load, so debt can't be grandfathered silently. ``--strict`` (the nightly
mode) ignores the baseline entirely, keeping the debt visible.

Matching is by (rule, path, stripped source line), not line number: code
moves, lines rarely change. ``count`` bounds how many identical findings
one entry absorbs (default 1).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = os.path.join("ci", "tpu-lint-baseline.json")


class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> Dict[Tuple[str, str, str], int]:
    """(rule, path, code) -> allowed count. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("findings", [])
    table: Dict[Tuple[str, str, str], int] = {}
    for i, e in enumerate(entries):
        missing = [k for k in ("rule", "path", "code") if not e.get(k)]
        if missing:
            raise BaselineError(
                f"{path}: entry {i} missing {missing}")
        if not str(e.get("justification", "")).strip():
            raise BaselineError(
                f"{path}: entry {i} ({e['rule']} {e['path']}) has no "
                f"justification; baselined debt requires a written reason")
        key = (e["rule"], e["path"], e["code"])
        table[key] = table.get(key, 0) + int(e.get("count", 1))
    return table


def apply_baseline(findings: List[Finding], path: str
                   ) -> Tuple[List[Finding], int]:
    """(new findings, number absorbed by the baseline)."""
    table = dict(load_baseline(path))
    new: List[Finding] = []
    absorbed = 0
    for f in findings:
        key = f.baseline_key()
        if table.get(key, 0) > 0:
            table[key] -= 1
            absorbed += 1
        else:
            new.append(f)
    return new, absorbed


def stale_entries(path: str, files, root: Optional[str] = None) -> List[str]:
    """Baseline entries whose (rule, path, code) no longer matches ANY
    source line — dead weight that would silently absorb a future
    unrelated finding with the same shape. ``--strict`` (nightly) fails on
    these with a remove-me message, so grandfathered debt disappears from
    the ledger the same PR it disappears from the code.

    An entry for a file OUTSIDE the analyzed set is only stale when the
    file is gone from disk too — ``--strict path/to/one_file.py`` subset
    runs must not condemn live entries for files they never looked at."""
    table = load_baseline(path)
    by_path = {f.display_path: f for f in files}
    out: List[str] = []
    for (rule, fpath, code) in sorted(table):
        src = by_path.get(fpath)
        if src is None:
            on_disk = os.path.join(root, fpath) if root else fpath
            if not os.path.exists(on_disk):
                out.append(
                    f"stale baseline entry: ({rule}, {fpath}) — the file "
                    f"no longer exists; remove me")
            continue
        if not any(line.strip() == code for line in src.lines):
            out.append(
                f"stale baseline entry: ({rule}, {fpath}, {code!r}) no "
                f"longer matches any source line; remove me")
    return out


def write_baseline(findings: List[Finding], path: str) -> None:
    """Serialize current findings as a baseline skeleton. Justifications are
    emitted as empty strings on purpose: the file will not LOAD until a
    human writes one per entry."""
    entries = []
    for f in findings:
        entries.append({"rule": f.rule, "path": f.path, "code": f.code,
                        "count": 1, "justification": "",
                        "message": f.message})
    with open(path, "w", encoding="utf-8") as out:
        json.dump({"version": 1, "findings": entries}, out, indent=2)
        out.write("\n")
