"""The mortgage ETL (``benchmarks/mortgage.py``) and the ML handoff
(``ml.py``) of the port against the JAX package's: the generators byte for
byte; ``clean_acquisition_prime`` and ``simple_aggregates`` at scale 0.02
against the JAX device path (``JAX_PLATFORMS=cpu``), plain and with the
performance table hash 8 on loan_id; ``tests/test_ml.py`` case for case,
the upload of a CPU-engine plan among them; and ``device_arrays`` handing
over the executed batch's own tensors."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import ml as jml
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.benchmarks import mortgage as jm
from spark_rapids_tpu.benchmarks.tpch import BENCH_CONF as JBENCH
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch import ml
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks import mortgage as tm

SCALE = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("scale,seed", [(0.02, 0), (0.5, 42)])
@pytest.mark.parametrize("gen", ["gen_performance", "gen_acquisition"])
def test_generators_match_reference(gen, scale, seed):
    want = getattr(jm, gen)(scale, seed)
    got = getattr(tm, gen)(scale, seed).to_arrow()
    assert got.schema.equals(want.schema)
    assert got.equals(want)


@pytest.fixture(scope="module")
def reference():
    """The JAX device path's answers, plain and hash 8."""
    perf, acq = jm.gen_performance(SCALE, 0), jm.gen_acquisition(SCALE, 0)
    out = {}
    for rep in (False, True):
        sess = JaxSession(JBENCH)
        p = sess.create_dataframe(perf)
        if rep:
            p = p.repartition(8, "loan_id")
        a = sess.create_dataframe(acq)
        for fn in ("clean_acquisition_prime", "simple_aggregates"):
            out[fn, rep] = getattr(jm, fn)(p, a).collect()
    return out


@pytest.mark.parametrize("rep", [False, True], ids=["plain", "hash8"])
@pytest.mark.parametrize("fn", ["clean_acquisition_prime",
                                "simple_aggregates"])
def test_etl_matches_reference(reference, fn, rep):
    """Exact columns exact, float sums within 1e-9; the port's conf keeps
    every operator on the device (its BENCH_CONF asserts NaN-free keys)."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    sess = TpuSession(BENCH_CONF, device="cpu")
    p = sess.create_dataframe(tm.gen_performance(SCALE, 0))
    if rep:
        p = p.repartition(8, "loan_id")
    got = getattr(tm, fn)(p, sess.create_dataframe(
        tm.gen_acquisition(SCALE, 0))).collect()
    assert_tables_equal(reference[fn, rep], got.to_arrow(),
                        ignore_order=fn != "simple_aggregates",
                        approx_float=1e-9)
    host = {type(n).__name__ for n in sess.last_plan.walk()
            if type(n).__name__.startswith("Cpu")}
    assert host == {"CpuLocalScanExec"}, host


def test_etl_cpu_engine_matches_reference(reference):
    """``sql.enabled=false``: the whole ETL on the port's CPU engine."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    sess = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.enabled":
                       "false"}, device="cpu")
    for fn in ("clean_acquisition_prime", "simple_aggregates"):
        got = getattr(tm, fn)(
            sess.create_dataframe(tm.gen_performance(SCALE, 0)),
            sess.create_dataframe(tm.gen_acquisition(SCALE, 0))).collect()
        assert all(type(n).__name__.startswith("Cpu")
                   for n in sess.last_plan.walk())
        assert_tables_equal(reference[fn, False], got.to_arrow(),
                            ignore_order=fn != "simple_aggregates",
                            approx_float=1e-9)


# ---------------------------------------------------------------- ml.py
def table():
    return pa.table({"x": pa.array([1.0, 2.0, 3.0, 4.0]),
                     "y": pa.array([10, None, 30, 40], type=pa.int64()),
                     "s": pa.array(["a", "bb", None, "d"])})


def test_device_batches_cut_boundary():
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(table()).filter(F.col("x") > 1.5)
    batches = list(ml.device_batches(df))
    assert sum(b.num_rows for b in batches) == 3
    # device batches of the session's device, not host buffers
    assert isinstance(batches[0].columns[0].data, torch.Tensor)
    assert batches[0].columns[0].data.device == s.device
    jbatches = list(jml.device_batches(JaxSession().create_dataframe(
        table()).filter(JF.col("x") > 1.5)))
    assert sum(b.num_rows for b in jbatches) == 3


def test_device_arrays_values_and_validity():
    s = TpuSession({}, device="cpu")
    arrs = ml.device_arrays(s.create_dataframe(table()))
    want = jml.device_arrays(JaxSession().create_dataframe(table()))
    assert set(arrs) == set(want)
    for name, ts in arrs.items():
        assert len(ts) == len(want[name])
        for t, w in zip(ts, want[name]):
            assert t.numpy().tolist() == np.asarray(w).tolist()
    assert arrs["y"][1].tolist() == [True, False, True, True]
    assert arrs["s"][2].tolist() == [1, 2, 0, 1]
    assert bytes(arrs["s"][0][1][:2].numpy()) == b"bb"


def test_device_arrays_after_aggregation():
    """A float sum without variableFloatAgg: the aggregate runs on the CPU
    engine and its result is uploaded, as in the JAX package."""
    s = TpuSession({}, device="cpu")
    df = (s.create_dataframe(table())
          .groupBy().agg(F.sum("x").alias("sx"), F.count().alias("n")))
    arrs = ml.device_arrays(df)
    assert arrs["sx"][0].tolist() == [10.0]
    assert arrs["n"][0].tolist() == [4]
    assert "!CpuHashAggregateExec cannot run on TPU" in s.last_explain


def test_cpu_fallback_gets_uploaded():
    """A CPU-only plan still hands back device arrays (the upload)."""
    from spark_rapids_tpu_torch.execs.tpu_execs import HostToDeviceExec
    s = TpuSession({"spark.rapids.tpu.sql.enabled": "false"}, device="cpu")
    df = s.create_dataframe(table()).filter(F.col("x") > 1.5)
    arrs = ml.device_arrays(df)
    assert arrs["x"][0].tolist() == [2.0, 3.0, 4.0]
    assert not s.last_plan.is_device
    from spark_rapids_tpu_torch.execs.tpu_execs import device_root
    assert isinstance(device_root(s.last_plan), HostToDeviceExec)
    js = JaxSession({"spark.rapids.tpu.sql.enabled": "false"})
    want = jml.device_arrays(js.create_dataframe(table()).filter(
        JF.col("x") > 1.5))
    assert np.asarray(want["x"][0]).tolist() == [2.0, 3.0, 4.0]


def test_device_arrays_make_no_copy(monkeypatch):
    """One executed batch is handed over as views of its own tensors."""
    from spark_rapids_tpu_torch.execs import tpu_execs
    seen = []
    real = tpu_execs.TpuFilterExec.execute

    def spy(self, ctx):
        for b in real(self, ctx):
            seen.append(b)
            yield b

    monkeypatch.setattr(tpu_execs.TpuFilterExec, "execute", spy)
    s = TpuSession({"spark.rapids.tpu.sql.fusion.enabled": "false"},
                   device="cpu")
    df = s.create_dataframe(table()).filter(F.col("x") > 1.5)
    arrs = ml.device_arrays(df)
    assert len(seen) == 1
    for f, col in zip(df.schema(), seen[0].columns):
        assert arrs[f.name][0].data_ptr() == col.data.data_ptr()
        assert arrs[f.name][1].data_ptr() == col.validity.data_ptr()
