"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
its main path needs no pyarrow (its file scans do), its entry points refuse
to fall back to the CPU on their own, and its kernel wrapper never answers a
non-CPU tensor with the plain version."""
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
mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                              port.__name__ + ".")]
# the file-scan package, the test-data generator and the serving wire's
# modules (Arrow IPC) read through pyarrow: imported last, below
PA = ("spark_rapids_tpu_torch.io.", "spark_rapids_tpu_torch.datagen",
      "spark_rapids_tpu_torch.serving.wire",
      "spark_rapids_tpu_torch.serving.client",
      "spark_rapids_tpu_torch.serving.server",
      "spark_rapids_tpu_torch.serving.controller")
for m in mods:
    if not m.startswith(PA):
        importlib.import_module(m)
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, gen_lineitem, q1
sess = TpuSession(BENCH_CONF, device="cpu")
res = q1(sess.create_dataframe(gen_lineitem(0.0005, 1))
         .repartition(8, "l_orderkey")).collect()
assert res.num_rows == 6, res.num_rows
# the default path: the fused aggregate, the pipelined upload, the scan
# cache on the second action, the streaming collect
from spark_rapids_tpu_torch.execs.fused_execs import FusedAggregateStageExec
from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
li = sess.create_dataframe(gen_lineitem(0.0005, 2))
first, second = q1(li).collect(), q1(li).collect()
assert first.num_rows == second.num_rows == 6
kinds = {type(n) for n in sess.last_plan.walk()}
import os
assert FusedAggregateStageExec in kinds, kinds
assert PipelinedExec in kinds or (os.cpu_count() or 1) < 2, kinds
assert peek_cache().hits >= 1
# serving in process: two tenants' submits of Q1 through the scheduler
handles = [sess.submit(q1(li), tenant=t) for t in ("a", "b")]
assert [h.result(60).num_rows for h in handles] == [6, 6]
assert all(h.snapshot()["state"] == "DONE" for h in handles)
sess.scheduler.shutdown()
from spark_rapids_tpu_torch.benchmarks import tpch_data as td
from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
dfs = {k: sess.create_dataframe(g(0.002, 1)) for k, g in (
    ("customer", td.gen_customer), ("orders", td.gen_orders),
    ("lineitem", td.gen_lineitem_full))}
dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
res = q3(dfs).collect()
assert res.num_rows == 10, res.num_rows
# the mesh: Q1 and Q3 over 8 shards on the CPU
meshed = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.mesh.enabled": "true",
                     "spark.rapids.tpu.sql.mesh.numDevices": "8"},
                    device="cpu")
assert q1(meshed.create_dataframe(gen_lineitem(0.0005, 1))).collect() \
    .num_rows == 6
assert q3({k: meshed.create_dataframe(g(0.002, 1)) for k, g in (
    ("customer", td.gen_customer), ("orders", td.gen_orders),
    ("lineitem", td.gen_lineitem_full))}).collect().num_rows == 10
assert any(type(n).__name__ == "MeshShuffledHashJoinExec"
           or type(n).__name__ == "MeshBroadcastHashJoinExec"
           for n in meshed.last_plan.walk()), meshed.last_plan.tree_string()
from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
tables = td.gen_all(0.002, 1)
for q in (13, 22):          # the byte DFA's LIKE; the nested-loop join
    res = QUERIES[q]({k: sess.create_dataframe(v)
                      for k, v in tables.items()}).collect()
    assert res.num_rows > 0, (q, res.num_rows)
from spark_rapids_tpu_torch.benchmarks import tpcxbb_data, tpcxbb_queries
bb = tpcxbb_data.gen_all(0.01, 0)
# lag and a framed sum; split, explode and substring_index; stddev;
# round; datediff; pmod
for q in ("q2", "q18", "q23", "q20", "q22", "q28"):
    res = tpcxbb_queries.QUERIES[q]({k: sess.create_dataframe(v)
                                     for k, v in bb.items()}).collect()
    assert res.num_rows > 0, (q, res.num_rows)
# the SQL frontend: TPC-H Q6's text over temp views
import spark_rapids_tpu_torch.sql
from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
for name, hb in td.gen_all(0.0005, 3).items():
    sess.create_dataframe(hb).createOrReplaceTempView(name)
res = sess.sql(SQL_QUERIES[6]).collect()
assert res.num_rows == 1 and res.columns[0].validity[0], res.num_rows
# out of core: Q3 with every keyed operator forced through grace, and a
# cached DataFrame served from the spillable store
from spark_rapids_tpu_torch.execs.cache_execs import TpuCachedScanExec
from spark_rapids_tpu_torch.memory import grace
forced = TpuSession({**BENCH_CONF, "spark.rapids.tpu.memory.outOfCore."
                     "forcePartitions": "4"}, device="cpu")
fdfs = {k: forced.create_dataframe(g(0.002, 1)) for k, g in (
    ("customer", td.gen_customer), ("orders", td.gen_orders),
    ("lineitem", td.gen_lineitem_full))}
assert q3(fdfs).collect().num_rows == 10
assert grace.counters()["spill_partitions"] > 0
cached = forced.create_dataframe(gen_lineitem(0.0005, 4)).cache()
assert q1(cached).collect().num_rows == q1(cached).collect().num_rows == 6
assert any(isinstance(n, TpuCachedScanExec) for n in forced.last_plan.walk())
# the expression and SQL surface: %, casts to strings, regexp_replace,
# percent_rank, a framed max, PIVOT, EXCEPT, and show and describe
from spark_rapids_tpu_torch.benchmarks import sql_surface as ss
from spark_rapids_tpu_torch.benchmarks import tpcds_data as dsd
surf = TpuSession(BENCH_CONF, device="cpu")
for k, v in dsd.gen_all(0.002, 0, ss.COLUMNS,
                        tables=list(ss.COLUMNS)).items():
    surf.create_dataframe(v).createOrReplaceTempView(k)
for name in ("remainder", "cast_string", "regexp_replace",
             "percent_rank_cume_dist", "framed_min_max", "pivot"):
    surf.sql(ss.SQL[name]).collect()
assert surf.sql(ss.Q87_SPEC).collect().num_rows == 1
surf.table("item").select("i_item_sk", "i_brand").describe().show()
# the plan layer's CPU fallback, the UDF compiler and its row fallback,
# the mortgage ETL to the ML handoff, and the CPU engine's comparison
from spark_rapids_tpu_torch import ml
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks import mortgage as mg
from spark_rapids_tpu_torch.testing import assert_tpu_and_cpu_equal
nofloat = TpuSession({}, device="cpu")
assert q1(nofloat.create_dataframe(gen_lineitem(0.0005, 5))).collect() \
    .num_rows == 6
assert "!CpuHashAggregateExec cannot run on TPU" in nofloat.last_explain
charge = F.udf(lambda p, t: p * (1.0 + t), "double")
for on in ("true", "false"):
    u = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.udfCompiler."
                    "enabled": on}, device="cpu")
    u.create_dataframe(gen_lineitem(0.0005, 5)).groupBy("l_returnflag").agg(
        F.sum(charge("l_extendedprice", "l_tax")).alias("c")).collect()
arrays = ml.device_arrays(mg.clean_acquisition_prime(
    sess.create_dataframe(mg.gen_performance(0.02, 0)),
    sess.create_dataframe(mg.gen_acquisition(0.02, 0))))
assert len(arrays) == 25
assert_tpu_and_cpu_equal(lambda s: q1(s.create_dataframe(
    gen_lineitem(0.0005, 5))), BENCH_CONF, approx_float=1e-9, device="cpu")
# the cluster: Q1 over a repartition on two in-process executors over
# TCP, then on two executor daemons (python -m
# spark_rapids_tpu_torch.parallel.executor_daemon), which load neither
import tempfile
with tempfile.TemporaryDirectory() as reg:
    for extra in ({"spark.rapids.tpu.shuffle.transport.class":
                   "spark_rapids_tpu_torch.shuffle.tcp.TcpTransport",
                   "spark.rapids.tpu.shuffle.tcp.registryDir": reg},
                  {"spark.rapids.tpu.sql.cluster.processExecutors": "true"}):
        cs = TpuSession({**BENCH_CONF, **extra,
                         "spark.rapids.tpu.sql.cluster.numExecutors": "2"},
                        device="cpu")
        assert q1(cs.create_dataframe(gen_lineitem(0.0005, 7))
                  .repartition(2)).collect().num_rows == 6
        stages = cs._cluster_scheduler.last_stages
        assert {st.executor_id for stage in stages
                for st in stage.statuses} == {"exec-0", "exec-1"}
        for ex in cs._cluster_scheduler.executors:
            if hasattr(ex, "probe"):
                pkgs = set(ex.probe()["packages"])
                assert not pkgs & {"jax", "jaxlib", "spark_rapids_tpu"}, pkgs
                print("DAEMON", ex.executor_id, "ok")
        cs._cluster_scheduler.close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu",
                                    "pyarrow"))
print("LOADED", bad)
# the file scan's modules and datagen load pyarrow, and nothing else the
# port refuses: Q1 from a parquet file, on the encoded domain
for m in mods:
    importlib.import_module(m)
import tempfile
import pyarrow.parquet as pq
from spark_rapids_tpu_torch.plan.encoded import count_encoded_domain
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "lineitem.parquet")
    pq.write_table(gen_lineitem(0.0005, 6).to_arrow(), path,
                   row_group_size=700)
    assert q1(sess.read.parquet(path)).collect().num_rows == 6
    assert count_encoded_domain(sess.last_plan) > 0
    # the writers and the other two formats: lineitem written as ORC
    # (partitioned) and CSV, Q1 read back from each
    li = sess.create_dataframe(gen_lineitem(0.0005, 6))
    li.write.partitionBy("l_returnflag").orc(os.path.join(d, "orc"))
    li.write.csv(os.path.join(d, "csv"))
    assert q1(sess.read.orc(os.path.join(d, "orc"))).collect().num_rows == 6
    assert q1(sess.read.csv(os.path.join(d, "csv"), schema=li.schema())
              ).collect().num_rows == 6
scan_bad = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu"))
print("SCAN LOADED", scan_bad)
sys.exit(1 if bad or scan_bad else 0)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_and_runs_q1_without_jax_or_pyarrow():
    """Every module imports, and TPC-H Q1 (also through the default path's
    fused aggregate, pipelined upload and scan cache, and submitted by two
    tenants through the session's scheduler), Q3, Q13 and Q22,
    the TPCx-BB queries through the slice-7 modules (q2, q18, q20, q22,
    q23, q28), TPC-H Q6's SQL text through ``TpuSession.sql``, Q3 forced
    out of core (memory/grace.py), Q1 over a cached DataFrame
    (memory/df_cache.py), Q1 and Q3 on the mesh (8 CPU shards), and the
    expression and SQL surface's queries
    (benchmarks/sql_surface.py) with ``show`` and ``describe``, and Q1 on
    two cluster executors in the process over TCP and on two executor
    daemons (neither daemon loading jax or the JAX package) run, with
    no jax, nothing of the JAX package and no pyarrow loaded; the file
    modules (io/: the scans and the writers), the test-data generator
    (datagen.py) and the serving wire's modules (wire, client, server,
    controller), imported after, load pyarrow but neither jax nor the JAX
    package, while Q1 runs from parquet, from partitioned ORC and from CSV
    files the port wrote."""
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "\nLOADED []" in "\n" + res.stdout
    assert "SCAN LOADED []" in res.stdout
    assert res.stdout.count("DAEMON exec-") == 2, res.stdout


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
    # pyarrow only inside the functions that convert at the edge, and in
    # the file-scan package, the test-data generator and the serving
    # wire's modules, which build on it
    wire = {PORT / "serving" / f"{m}.py"
            for m in ("wire", "client", "server", "controller")}
    if PORT / "io" not in path.parents and path != PORT / "datagen.py" \
            and path not in wire:
        assert not [m for m, top in mods if m == "pyarrow" and top], path


@pytest.mark.parametrize("name", ["parquet_pages.py", "rebase.py"])
def test_io_copies_byte_equal_to_the_reference(name):
    """The page reader and the calendar rebase are numpy/pyarrow only, so
    the port keeps byte-equal copies of the JAX package's."""
    assert (PORT / "io" / name).read_bytes() == \
        (ROOT / "spark_rapids_tpu" / "io" / name).read_bytes()


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
