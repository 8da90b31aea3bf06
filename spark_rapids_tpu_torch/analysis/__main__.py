"""tpu-lint CLI.

Usage:
    python -m spark_rapids_tpu_torch.analysis [paths...] [options]

With no paths, lints the spark_rapids_tpu_torch package itself. Exit status is 0
when no non-baselined findings remain, 1 otherwise.

Options:
    --strict            ignore the baseline (nightly mode: grandfathered
                        debt stays visible) AND fail on stale baseline
                        entries — an entry whose (rule, path, code) no
                        longer matches any source line must be removed
    --baseline PATH     baseline file (default
                        spark_rapids_tpu_torch/analysis/baseline.json)
    --write-baseline    write current findings as a baseline skeleton
                        (justifications left empty; the file will not load
                        until they are filled in)
    --rules IDS         comma-separated rule subset, e.g. R008,R009,R010
    --list-rules        print the rule catalog and exit
    --list-suppressions inventory every inline ``# tpu-lint: disable=``
                        with file:line and its justification text
    --format MODE       output format: text (default), json — one
                        machine-readable object for CI annotation — or
                        sarif — a SARIF 2.1.0 log so CI publishes the
                        findings as code annotations
    --profile           per-rule wall-time breakdown, printed to stderr
                        slowest-first
    --changed-only      fast-gate mode: findings restricted to files changed
                        vs the git merge-base (plus untracked files). File
                        rules run only on the changed subset; project rules
                        still see the FULL file set — interprocedural
                        context never shrinks — with their findings filtered
                        afterwards. Baseline- and suppression-staleness
                        gates are skipped (a subset run cannot judge them);
                        nightly's full --strict run keeps that job. Falls
                        back to a full run if no merge-base resolves.
    --base REF          merge-base reference for --changed-only (default:
                        origin/main, then main)
    --check-configs     verify docs/configs-torch.md matches the port's
                        registry (R004 drift runs in the normal lint pass
                        with baseline semantics)

The port's counterpart of ``python -m spark_rapids_tpu.analysis``: the same
engine and rule numbers over ``spark_rapids_tpu_torch``. R001 and R003 have
no counterpart in eager PyTorch (``--list-rules`` says why); R002 and R007
check PyTorch's syncs and the CUDA kernel libraries.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Set

from spark_rapids_tpu_torch.analysis import baseline as bl
from spark_rapids_tpu_torch.analysis import rules_dtype, rules_recompile
from spark_rapids_tpu_torch.analysis.core import (_SUPPRESS_RE,
                                                  AnalysisResult, SourceFile,
                                                  all_rules, analyze_files,
                                                  load_source)

#: the port's baseline (repo-relative); empty while every finding is
#: repaired or suppressed inline with its reason
DEFAULT_BASELINE = os.path.join("spark_rapids_tpu_torch", "analysis",
                                "baseline.json")
#: the port's configuration reference, which --check-configs holds to the
#: registry
CONFIG_DOCS = os.path.join("docs", "configs-torch.md")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def collect_files(paths: List[str], root: str,
                  errors: Optional[List[str]] = None) -> List[SourceFile]:
    files: List[SourceFile] = []
    seen = set()
    for p in paths:
        targets: List[str] = []
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                targets.extend(os.path.join(dirpath, f)
                               for f in sorted(filenames)
                               if f.endswith(".py"))
        elif p.endswith(".py"):
            targets.append(p)
        for t in targets:
            ap = os.path.abspath(t)
            if ap in seen:
                continue
            seen.add(ap)
            rel = os.path.relpath(ap, root)
            display = rel if not rel.startswith("..") else ap
            src = load_source(ap, display.replace(os.sep, "/"), errors)
            if src is not None:
                files.append(src)
    return files


def changed_paths(root: str, base: Optional[str]) -> Optional[Set[str]]:
    """Repo-relative paths of files changed vs the merge-base with ``base``
    (tracked diff + untracked), or None when no merge-base resolves — the
    caller falls back to a full run. Fail OPEN: a broken git state must
    widen the lint, never silently skip findings."""
    def run(*cmd: str):
        return subprocess.run(cmd, cwd=root, capture_output=True, text=True)

    mb = None
    for ref in ([base] if base else ["origin/main", "main"]):
        r = run("git", "merge-base", "HEAD", ref)
        if r.returncode == 0 and r.stdout.strip():
            mb = r.stdout.strip()
            break
    if mb is None:
        return None
    diff = run("git", "diff", "--name-only", "-z", mb)
    if diff.returncode != 0:
        return None
    changed = {p for p in diff.stdout.split("\0") if p}
    untracked = run("git", "ls-files", "--others", "--exclude-standard", "-z")
    if untracked.returncode == 0:
        changed |= {p for p in untracked.stdout.split("\0") if p}
    return changed


def check_configs(root: str) -> int:
    """The docs-sync gate. The R004 drift scan runs in the full lint pass,
    not here, so its findings get the same suppression and baseline
    treatment as every other rule."""
    from spark_rapids_tpu_torch import config
    docs = os.path.join(root, CONFIG_DOCS)
    try:
        with open(docs, encoding="utf-8") as f:
            current = f.read()
    except OSError:
        current = None
    if current != config.generate_docs():
        print(f"{CONFIG_DOCS} is stale: regenerate with "
              f"python -m spark_rapids_tpu_torch.config {CONFIG_DOCS}")
        return 1
    print(f"configs ok: {CONFIG_DOCS} matches the registry")
    return 0


def _suppression_justification(src: SourceFile, lineno: int) -> str:
    """The human text around a ``# tpu-lint: disable=`` directive: the
    comment on the same line with the directive stripped, else the pure
    comment line directly above."""
    def comment_text(line: str) -> str:
        idx = line.find("#")
        if idx < 0:
            return ""
        text = line[idx:]
        text = _SUPPRESS_RE.sub("", text)
        text = re.sub(r"#\s*noqa[^#]*", "", text)
        return text.replace("#", " ").strip(" -—:\t")

    own = comment_text(src.lines[lineno - 1]) \
        if lineno - 1 < len(src.lines) else ""
    # justification blocks conventionally sit in the comment run just above
    # the suppressed statement (possibly a couple of code lines up when the
    # statement wraps): collect the nearest contiguous pure-comment block
    block: List[str] = []
    i = lineno - 2
    skipped = 0
    while i >= 0 and skipped <= 2 and not block:
        line = src.lines[i].strip()
        if line.startswith("#"):
            while i >= 0 and src.lines[i].strip().startswith("#"):
                text = comment_text(src.lines[i])
                if text:
                    block.insert(0, text)
                i -= 1
            break
        if not line:
            break
        skipped += 1
        i -= 1
    pieces = [p for p in (" ".join(block), own) if p]
    return " — ".join(pieces) if len(pieces) > 1 else \
        (pieces[0] if pieces else "")


def _suppression_status(files: List[SourceFile], result: AnalysisResult):
    """Per inline-suppression line: (src, lineno, declared ids, dead ids).

    An id is DEAD when no finding of that rule was absorbed at that line
    this run (``AnalysisResult.suppressions_hit``). A blanket ``ALL`` is
    dead only when the line absorbed nothing at all."""
    hit_by_line: Dict[tuple, set] = {}
    for path, ln, rid in result.suppressions_hit:
        hit_by_line.setdefault((path, ln), set()).add(rid)
    rows = []
    for src in files:
        for lineno in sorted(src.suppressions):
            declared = sorted(src.suppressions[lineno])
            hits = hit_by_line.get((src.display_path, lineno), set())
            if "ALL" in declared:
                dead = [] if hits else ["ALL"]
            else:
                dead = [r for r in declared if r not in hits]
            rows.append((src, lineno, declared, dead))
    return rows


def _covers_package(files: List[SourceFile], root: str) -> bool:
    """True when the analyzed set includes every .py of the package —
    the precondition for suppression staleness: a subset run would not
    re-derive interprocedural findings and would condemn live
    suppressions as stale."""
    pkg = os.path.join(root, "spark_rapids_tpu_torch")
    have = {os.path.abspath(src.path) for src in files}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for f in filenames:
            if f.endswith(".py") and \
                    os.path.abspath(os.path.join(dirpath, f)) not in have:
                return False
    return True


def stale_suppressions(files: List[SourceFile],
                       result: AnalysisResult) -> List[str]:
    msgs = []
    for src, lineno, _declared, dead in _suppression_status(files, result):
        if dead:
            msgs.append(f"STALE SUPPRESSION: {src.display_path}:{lineno}: "
                        f"disable={','.join(dead)} absorbed no finding — "
                        f"remove it")
    return msgs


def list_suppressions(files: List[SourceFile], result: AnalysisResult,
                      fmt: str) -> int:
    entries: List[Dict[str, object]] = []
    for src, lineno, declared, dead in _suppression_status(files, result):
        entries.append({
            "path": src.display_path,
            "line": lineno,
            "rules": declared,
            "stale_rules": dead,
            "status": "stale" if dead else "live",
            "justification": _suppression_justification(src, lineno),
            "code": src.line_text(lineno),
        })
    if fmt == "json":
        print(json.dumps({"suppressions": entries}, indent=2))
        return 0
    for e in entries:
        just = e["justification"] or "(no justification text)"
        mark = "live" if e["status"] == "live" else \
            f"STALE:{','.join(e['stale_rules'])}"
        print(f"{e['path']}:{e['line']}: {','.join(e['rules'])} "
              f"[{mark}] — {just}")
    n_stale = sum(1 for e in entries if e["status"] == "stale")
    print(f"{len(entries)} inline suppression(s) in {len(files)} files"
          f" ({n_stale} stale)" if entries else
          f"0 inline suppression(s) in {len(files)} files")
    return 0


def _sarif_doc(findings, errors, stale, files_scanned: int, absorbed: int,
               rule_seconds) -> Dict[str, object]:
    """SARIF 2.1.0: the interchange format CI systems ingest to render
    findings as inline code annotations on the PR diff."""
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    # plain repo-relative URIs, no uriBaseId: consumers
                    # resolve against the checkout (GitHub code scanning
                    # does; a bogus file:/// base would break the strict
                    # ones that honor originalUriBaseIds)
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line),
                               "snippet": {"text": f.code}},
                },
            }],
        })
    driver = {
        "name": "tpu-lint",
        "informationUri": "docs/static-analysis.md",
        "rules": [{"id": r.rule_id,
                   "shortDescription": {"text": r.title},
                   # per-rule catalog anchor: CI annotations deep-link
                   # straight to the rule's docs section
                   "helpUri": r.help_uri()}
                  for r in all_rules()],
    }
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": driver},
            "results": results,
            "properties": {
                "filesScanned": files_scanned,
                "baselined": absorbed,
                "parseErrors": list(errors),
                "staleBaseline": list(stale),
                "ruleSeconds": dict(rule_seconds or {}),
            },
        }],
    }


def _emit(findings, errors, stale, files_scanned: int, absorbed: int,
          fmt: str, rule_seconds=None) -> None:
    if fmt == "sarif":
        print(json.dumps(_sarif_doc(findings, errors, stale, files_scanned,
                                    absorbed, rule_seconds), indent=2))
        return
    if fmt == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "errors": list(errors),
            "stale_baseline": list(stale),
            "files_scanned": files_scanned,
            "baselined": absorbed,
            "rule_seconds": dict(rule_seconds or {}),
        }, indent=2))
        return
    for f in findings:
        print(f.render())
    for err in errors:
        print(f"PARSE ERROR: {err} (file NOT analyzed)")
    for msg in stale:
        print(msg)
    note = f", {absorbed} baselined" if absorbed else ""
    if findings or errors or stale:
        bits = [f"{len(findings)} finding(s)",
                f"{len(errors)} unparseable file(s)"]
        if stale:
            bits.append(f"{len(stale)} stale baseline/suppression entr"
                        f"{'ies' if len(stale) > 1 else 'y'}")
        print(f"tpu-lint: {', '.join(bits)} in {files_scanned} "
              f"files{note}")
    else:
        print(f"tpu-lint: clean ({files_scanned} files{note})")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spark_rapids_tpu_torch.analysis",
                                 description="tpu-lint static analysis")
    ap.add_argument("paths", nargs="*", help="files or directories "
                    "(default: the spark_rapids_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="ignore the baseline; fail on stale entries")
    ap.add_argument("--baseline", default=None, metavar="PATH")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--rules", default=None, metavar="IDS")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--list-suppressions", action="store_true")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"))
    ap.add_argument("--profile", action="store_true",
                    help="per-rule wall-time breakdown on stderr")
    ap.add_argument("--changed-only", action="store_true",
                    help="restrict findings to files changed vs the git "
                         "merge-base; project rules keep full context")
    ap.add_argument("--base", default=None, metavar="REF",
                    help="merge-base ref for --changed-only "
                         "(default origin/main, then main)")
    ap.add_argument("--check-configs", action="store_true")
    args = ap.parse_args(argv)

    root = _repo_root()
    if args.list_rules:
        for rule in all_rules():
            kind = "project" if rule.is_project_rule else "file"
            print(f"{rule.rule_id}  [{kind}]  {rule.title}")
        for rid, why in sorted({**rules_recompile.NOT_PORTED,
                                **rules_dtype.NOT_PORTED}.items()):
            print(f"{rid}  [not ported]  {why}")
        return 0
    if args.check_configs:
        return check_configs(root)

    paths = args.paths or [os.path.join(root, "spark_rapids_tpu_torch")]
    rule_ids = (set(r.strip().upper() for r in args.rules.split(","))
                if args.rules else None)
    parse_errors: List[str] = []
    files = collect_files(paths, root, parse_errors)
    if args.list_suppressions:
        # run the full rule set so live/stale marking reflects reality
        return list_suppressions(files, analyze_files(files), args.format)
    if not files and not parse_errors:
        print("no python files found under", paths)
        return 1
    changed: Optional[Set[str]] = None
    if args.changed_only:
        changed = changed_paths(root, args.base)
        if changed is None:
            print("tpu-lint: --changed-only found no merge-base; "
                  "falling back to a full run", file=sys.stderr)

    if changed is not None:
        changed_srcs = [f for f in files if f.display_path in changed]
        if changed_srcs:
            # project rules over the FULL set (interprocedural context
            # never shrinks), file rules over the changed subset only;
            # project findings filter to changed files afterwards
            result = analyze_files(files, rule_ids=rule_ids,
                                   with_file_rules=False)
            result.findings = [f for f in result.findings
                               if f.path in changed]
            fres = analyze_files(changed_srcs, rule_ids=rule_ids,
                                 with_project_rules=False)
            result.findings.extend(fres.findings)
            result.suppressions_hit |= fres.suppressions_hit
            for rid, secs in fres.rule_seconds.items():
                result.rule_seconds[rid] = round(
                    result.rule_seconds.get(rid, 0.0) + secs, 4)
            result.files_scanned = len(files)
        else:
            result = AnalysisResult(files_scanned=len(files))
    else:
        result = analyze_files(files, rule_ids=rule_ids)
    result.errors.extend(parse_errors)

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.write_baseline:
        bl.write_baseline(result.findings, baseline_path)
        print(f"wrote {len(result.findings)} entries to {baseline_path}; "
              f"fill in every justification before committing")
        return 0

    findings = result.findings
    absorbed = 0
    stale: List[str] = []
    if not args.strict:
        findings, absorbed = bl.apply_baseline(findings, baseline_path)
    elif args.changed_only:
        # a subset run cannot judge baseline/suppression staleness — the
        # findings it never re-derived would all look dead. Nightly's full
        # --strict run owns that hygiene.
        pass
    else:
        # nightly hygiene: a baseline entry no source line matches anymore
        # is debt pretending to still exist — fail with a remove-me
        stale = bl.stale_entries(baseline_path, files, root)
        # same hygiene for inline suppressions — but only when the whole
        # package (and the whole rule set) was analyzed, else subset runs
        # would condemn suppressions whose findings they never re-derived
        if rule_ids is None and _covers_package(files, root):
            stale = stale + stale_suppressions(files, result)
    _emit(findings, result.errors, stale, result.files_scanned, absorbed,
          args.format, rule_seconds=result.rule_seconds)
    if args.profile:
        # stderr, slowest first: machine formats on stdout stay parseable
        # and the premerge guard can `head -3` the culprits
        for rid, secs in sorted(result.rule_seconds.items(),
                                key=lambda kv: -kv[1]):
            print(f"profile: {rid} {secs:.3f}s", file=sys.stderr)
    return 1 if (findings or result.errors or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
