"""The port's analyzer engine against the JAX package's, and the port linted
by it.

- The engine modules (``core``, ``baseline``, ``cfg``, ``dataflow``,
  ``callgraph``, ``exceptions``, ``captures``) and the engine rules' modules
  are the reference's text after the package name, byte for byte.
- ``tests/test_analysis_engine.py``'s CFG, call-graph, dataflow, exception
  flow and capture tests run against each package: the file's text with
  its imports pointed at the package under test.
- The whole port is linted once, in a module fixture that every assertion
  on it shares: no finding, an empty baseline, every inline suppression
  with its reason, the configuration reference current, and the run
  inside 60 s: twice the 30 s a whole run may take alone (about 21 s
  alone and 25 s beside five busy test workers on a CPU test host), a
  guard against a rule that blows up on the whole package.
"""
import os
import re
import time
import types

import pytest

from spark_rapids_tpu_torch.analysis import analyze_files
from spark_rapids_tpu_torch.analysis import baseline as bl
from spark_rapids_tpu_torch.analysis.__main__ import (
    DEFAULT_BASELINE, _suppression_justification, check_configs,
    collect_files, main)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "spark_rapids_tpu", "analysis")
PORT_DIR = os.path.join(ROOT, "spark_rapids_tpu_torch", "analysis")

#: held byte-equal to the reference after the package name
COPIES = ["core.py", "baseline.py", "cfg.py", "dataflow.py", "callgraph.py",
          "exceptions.py", "captures.py", "rules_cancel.py",
          "rules_captures.py", "rules_exceptions.py", "rules_lockorder.py",
          "rules_locks.py", "rules_metrics.py", "rules_project.py",
          "rules_races.py", "rules_resource.py"]

#: seconds a whole run of every rule over the port may take here
LINT_BUDGET_S = 60.0


def _port(text: str) -> str:
    return re.sub(r"spark_rapids_tpu(?!_torch)", "spark_rapids_tpu_torch",
                  text)


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("name", COPIES)
def test_engine_module_is_the_reference_text(name):
    assert _read(os.path.join(PORT_DIR, name)) == \
        _port(_read(os.path.join(JAX_DIR, name)))


def _engine_tests(pkg: str) -> types.ModuleType:
    text = _read(os.path.join(ROOT, "tests", "test_analysis_engine.py"))
    if pkg == "port":
        text = _port(text)
    mod = types.ModuleType(f"engine_tests_{pkg}")
    exec(compile(text, f"test_analysis_engine[{pkg}]", "exec"),
         mod.__dict__)
    return mod


ENGINE = {pkg: _engine_tests(pkg) for pkg in ("jax", "port")}
ENGINE_CASES = sorted(n for n in vars(ENGINE["jax"])
                      if n.startswith("test_"))


def test_engine_cases_are_all_there():
    assert len(ENGINE_CASES) >= 45
    assert ENGINE_CASES == sorted(n for n in vars(ENGINE["port"])
                                  if n.startswith("test_"))


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_invariant_holds(name, pkg):
    getattr(ENGINE[pkg], name)()


# ------------------------------------------------------- the port linted
@pytest.fixture(scope="module")
def port_lint():
    files = collect_files([os.path.join(ROOT, "spark_rapids_tpu_torch")],
                          ROOT)
    t0 = time.monotonic()
    res = analyze_files(files)
    return files, res, time.monotonic() - t0


def test_port_is_lint_clean(port_lint):
    files, res, _ = port_lint
    assert len(files) > 150
    assert res.errors == []
    assert [f.render() for f in res.findings] == []


def test_port_baseline_is_empty():
    path = os.path.join(ROOT, DEFAULT_BASELINE)
    assert bl.load_baseline(path) == {}


def test_port_suppressions_are_live_and_justified(port_lint):
    files, res, _ = port_lint
    hit = {(p, ln) for p, ln, _rid in res.suppressions_hit}
    seen = 0
    for src in files:
        for lineno in src.suppressions:
            seen += 1
            assert (src.display_path, lineno) in hit, \
                f"{src.display_path}:{lineno}: stale suppression"
            assert _suppression_justification(src, lineno), \
                f"{src.display_path}:{lineno}: suppression without reason"
    assert seen >= 5


def test_port_lint_inside_budget(port_lint):
    _, res, elapsed = port_lint
    assert elapsed < LINT_BUDGET_S, (f"the lint took {elapsed:.1f}s "
                                     f"({res.rule_seconds})")


def test_check_configs_passes_against_the_port_reference(capsys):
    assert check_configs(ROOT) == 0
    assert "docs/configs-torch.md" in capsys.readouterr().out


def test_check_configs_fails_on_a_stale_reference(tmp_path, capsys):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "configs-torch.md").write_text("stale\n")
    assert check_configs(str(tmp_path)) == 1
    assert "stale" in capsys.readouterr().out


def test_strict_cli_on_a_subtree(capsys):
    """The CLI's strict path over a part of the port (the whole package's
    run is the fixture above): clean, and no stale-suppression judgement
    on a subset."""
    assert main([os.path.join(ROOT, "spark_rapids_tpu_torch", "native"),
                 "--strict"]) == 0
    assert "clean" in capsys.readouterr().out
