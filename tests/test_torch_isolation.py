"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
its main path needs no pyarrow, its entry points refuse to fall back to the
CPU on their own, and its kernel wrapper never answers a non-CPU tensor with
the plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.shuffle import partition_kernel as tpk

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spark_rapids_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")

_CHILD = """
import importlib, pkgutil, sys
import spark_rapids_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, gen_lineitem, q1
sess = TpuSession(BENCH_CONF, device="cpu")
res = q1(sess.create_dataframe(gen_lineitem(0.0005, 1))
         .repartition(8, "l_orderkey")).collect()
assert res.num_rows == 6, res.num_rows
from spark_rapids_tpu_torch.benchmarks import tpch_data as td
from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
dfs = {k: sess.create_dataframe(g(0.002, 1)) for k, g in (
    ("customer", td.gen_customer), ("orders", td.gen_orders),
    ("lineitem", td.gen_lineitem_full))}
dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
res = q3(dfs).collect()
assert res.num_rows == 10, res.num_rows
from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
tables = td.gen_all(0.002, 1)
for q in (13, 22):          # the byte DFA's LIKE; the nested-loop join
    res = QUERIES[q]({k: sess.create_dataframe(v)
                      for k, v in tables.items()}).collect()
    assert res.num_rows > 0, (q, res.num_rows)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu",
                                    "pyarrow"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_and_runs_q1_without_jax_or_pyarrow():
    """Every module imports, and Q1, Q3, Q13 and Q22 run, with no jax,
    nothing of the JAX package and no pyarrow loaded."""
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def _imports(path: Path):
    """(top-level module, is_module_level) of every import in a file."""
    tree = ast.parse(path.read_text(), str(path))
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], id(node) in top


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    mods = list(_imports(path))
    assert not [m for m, _ in mods if m in FORBIDDEN], path
    # pyarrow only inside the functions that convert at the edge
    assert not [m for m, top in mods if m == "pyarrow" and top], path


def test_session_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession(device="cuda")
    assert TpuSession(device="cpu").device.type == "cpu"


def _meta_inputs():
    geom = tpk.KernelGeom.plan(1000, 4, 12)
    pids = torch.zeros((geom.groups, geom.G, tpk.W), dtype=torch.int32,
                       device="meta")
    data = torch.zeros((geom.groups, geom.G * tpk.W, geom.L),
                       dtype=torch.uint8, device="meta")
    return pids, data, geom


def test_kernel_wrapper_never_falls_back_to_plain(monkeypatch):
    def plain(*_):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(tpk, "partition_reorder_plain", plain)
    launches = tpk.REORDER_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpk.partition_reorder(*_meta_inputs())
    assert tpk.REORDER_KERNEL.launches == launches


def test_kernel_refuses_cpu_tensors_and_bad_shapes():
    geom = tpk.KernelGeom.plan(1000, 4, 12)
    pids = torch.zeros((geom.groups, geom.G, tpk.W), dtype=torch.int32)
    data = torch.zeros((geom.groups, geom.G * tpk.W, geom.L),
                       dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpk.REORDER_KERNEL(pids, data, geom)
    with pytest.raises(ValueError, match="pids must be int32"):
        tpk.partition_reorder(pids.to(torch.int64), data, geom)
    with pytest.raises(ValueError, match="data must be uint8"):
        tpk.partition_reorder(pids, data[:, :-1], geom)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
