"""The port's Cpu-vs-Tpu exec constructor parity check
(``spark_rapids_tpu_torch/api_validation.py``) against the JAX package's:
the port's pairs line up, and every pair the JAX package finds (its CSV
and ORC scans and its write command among them), the port finds too."""
import subprocess
import sys
from pathlib import Path

from spark_rapids_tpu import api_validation as jav
from spark_rapids_tpu_torch import api_validation as av

ROOT = Path(__file__).resolve().parents[1]

def _names(pairs):
    return [(c.__name__, t.__name__) for c, t in pairs]


def test_port_pairs_line_up():
    assert av.validate() == []
    assert jav.validate() == []


def test_port_finds_every_jax_pair_it_has_modules_for():
    want = _names(jav.exec_pairs())
    assert _names(av.exec_pairs()) == want
    assert {"CpuCsvScanExec", "CpuOrcScanExec",
            "CpuWriteFilesExec"} <= {c for c, _ in want}
    assert len(want) >= 20


def test_pairs_have_the_same_parameters_as_jax():
    """Each pair's constructor parameters are the JAX pair's, name for
    name (the port's conversion rules build the same fields)."""
    import inspect
    jax_pairs = {c.__name__: (c, t) for c, t in jav.exec_pairs()}
    for cpu_cls, tpu_cls in av.exec_pairs():
        jc, jt = jax_pairs[cpu_cls.__name__]
        for mine, ref in ((cpu_cls, jc), (tpu_cls, jt)):
            got = list(inspect.signature(mine.__init__).parameters)
            exp = list(inspect.signature(ref.__init__).parameters)
            assert got == exp, (mine.__name__, got, exp)


def test_validate_reports_a_mismatch(monkeypatch):
    class CpuProbeExec:
        def __init__(self, a, b):
            pass

    class TpuProbeExec:
        def __init__(self, a, c):
            pass

    monkeypatch.setattr(av, "exec_pairs",
                        lambda: [(CpuProbeExec, TpuProbeExec)])
    problems = av.validate()
    assert len(problems) == 1 and "CpuProbeExec" in problems[0]


def test_cli_entry_point():
    out = subprocess.run([sys.executable, "-m",
                          "spark_rapids_tpu_torch.api_validation"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Cpu/Tpu exec pairs line up" in out.stdout
