"""Operator and action metrics: ``session.last_metrics`` of the port against
the JAX package's for TPC-H Q1 and Q3 (orders and lineitem hash 8) at a
small scale, the same seeded tables through both, each table uploaded in
several chunks.

Both records have the same keys: one ``"{i}:{name}"`` entry per exec of the
executed plan in pre-order, then ``transfer``, ``memory``, ``serving``,
``shuffle`` and ``adaptive``. Each exec's output rows and batches are
equal. Each counter of the transfer section is compared by its own rule:

- the device and host bytes and the chunks are non-zero wherever the JAX
  package's are (the byte counts differ by design: the JAX package pads
  every buffer to its bucket capacity and keeps strings in its own
  layout), and the chunk counts are equal;
- ``inflight_peak`` is 1 on the CPU in the port, which has no asynchronous
  copy there (the JAX package's device_put keeps up to
  ``transfer.maxInflight`` in flight);
- the seconds are host walls, only positive;
- the link rates (``*_gb_per_sec``) are each package's own bytes over its
  own seconds, rounded to 3 decimals, so they are held to the port's own
  counters: a slow host rounds the JAX package's small download rate to 0
  while the port's is not;
- every other counter the JAX package leaves at 0 is 0.
"""
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.benchmarks import tpch_data as jdata
from spark_rapids_tpu.benchmarks import tpch_queries as jq
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch as ttpch
from spark_rapids_tpu_torch.benchmarks import tpch_data as tdata
from spark_rapids_tpu_torch.benchmarks import tpch_queries as tq
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.utils import metrics as um

SCALE, SEED = 0.002, 42
#: 1,024-row chunks: every upload of these tables takes several
CONF = {**jtpch.BENCH_CONF, "spark.rapids.tpu.transfer.chunkRows": "1024"}
SECTIONS = ["transfer", "memory", "serving", "shuffle", "adaptive"]
BYTES = ["transfer.upload_bytes", "transfer.download_bytes",
         "transfer.encoded_bytes", "transfer.decoded_equivalent_bytes"]
Q3_GENS = {"customer": (jdata.gen_customer, tdata.gen_customer),
           "orders": (jdata.gen_orders, tdata.gen_orders),
           "lineitem": (jdata.gen_lineitem_full, tdata.gen_lineitem_full)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    DeviceManager.shutdown()


def _q3_frames(sess, tables):
    dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
    dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
    dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
    return dfs


@pytest.fixture(scope="module")
def records():
    """Each package's ``last_metrics`` after Q1 and after Q3, and the
    port's session."""
    out = {}
    js = JaxSession(CONF)
    jtpch.q1(js.create_dataframe(jtpch.gen_lineitem(SCALE, SEED))).collect()
    out["jax", "q1"] = js.last_metrics
    jq.q3(_q3_frames(js, {k: g(SCALE, SEED)
                          for k, (g, _) in Q3_GENS.items()})).collect()
    out["jax", "q3"] = js.last_metrics
    ts = TpuSession(CONF, device="cpu")
    ttpch.q1(ts.create_dataframe(ttpch.gen_lineitem(SCALE, SEED))).collect()
    out["port", "q1"] = ts.last_metrics
    tq.q3(_q3_frames(ts, {k: g(SCALE, SEED)
                          for k, (_, g) in Q3_GENS.items()})).collect()
    out["port", "q3"] = ts.last_metrics
    out["session"] = ts
    return out


def _execs(rec):
    return {k: v for k, v in rec.items() if ":" in k}


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_same_sections_and_exec_names(records, query):
    want, got = records["jax", query], records["port", query]
    assert list(got) == list(want)
    assert list(got)[-5:] == SECTIONS
    for s in SECTIONS:
        assert set(got[s]) == set(want[s]), s


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_exec_output_rows_and_batches_equal(records, query):
    want, got = _execs(records["jax", query]), _execs(records["port", query])
    for key in want:
        for m in ("numOutputRows", "numOutputBatches"):
            assert got[key][m] == want[key][m], (key, m)
    assert len(want) >= (6 if query == "q1" else 20)
    # the root's rows are the query's rows
    assert got["0:DeviceToHostExec"]["numOutputRows"] == \
        (6 if query == "q1" else 10)


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_fused_and_pipeline_metrics_equal(records, query):
    want, got = _execs(records["jax", query]), _execs(records["port", query])
    for key, m in want.items():
        extra = set(m) - {"numOutputRows", "numOutputBatches", "totalTime"}
        assert set(got[key]) == set(m), key
        for name in extra:
            assert got[key][name] == m[name], (key, name)


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_transfer_counters_by_rule(records, query):
    want = records["jax", query]["transfer"]
    got = records["port", query]["transfer"]
    for name in BYTES:
        assert (got[name] > 0) == (want[name] > 0), name
    assert got["transfer.upload_bytes"] > 0
    assert got["transfer.upload_chunks"] == want["transfer.upload_chunks"]
    assert got["transfer.upload_chunks"] > (2 if query == "q1" else 4)
    assert got["transfer.inflight_peak"] == 1
    for name in ("transfer.upload_seconds", "transfer.download_seconds"):
        assert got[name] > 0, name
    rates = {f"transfer.{d}_gb_per_sec" for d in ("upload", "download")}
    for name in rates:
        d = name.split(".")[1].split("_")[0]
        assert got[name] == round(got[f"transfer.{d}_bytes"]
                                  / got[f"transfer.{d}_seconds"] / 1e9, 3)
    for name, v in want.items():
        if v == 0 and name not in rates:
            assert got[name] == 0, name


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_other_sections_equal(records, query):
    for s in ("memory", "serving", "shuffle", "adaptive"):
        assert records["port", query][s] == records["jax", query][s], s


def test_served_query_records_the_same_snapshot(records):
    sess = records["session"]
    lineitem = ttpch.gen_lineitem(SCALE, SEED)
    try:
        h = sess.submit(ttpch.q1(sess.create_dataframe(lineitem)),
                        tenant="t")
        h.result(timeout=60)
        snap = h.exec_metrics
        assert list(snap) == list(sess.last_metrics)
        assert snap["0:DeviceToHostExec"]["numOutputRows"] == 6
        assert snap["transfer"]["transfer.upload_bytes"] > 0
    finally:
        sess.scheduler.shutdown(wait=True, timeout=60)


def test_metrics_off_publishes_nothing():
    sess = TpuSession({**CONF, "spark.rapids.tpu.metrics.enabled": "false"},
                      device="cpu")
    ttpch.q1(sess.create_dataframe(ttpch.gen_lineitem(SCALE, SEED))).collect()
    assert sess.last_metrics == {}


def test_every_dotted_counter_has_a_bump_site_registered():
    """The registries the analyzer's R011 reads: each section's tuple
    names exactly the counters of its MetricSet."""
    for names, ms in ((um.TRANSFER_METRIC_NAMES, um.TRANSFER_METRICS),
                      (um.MEMORY_METRIC_NAMES, um.MEMORY_METRICS),
                      (um.ADAPTIVE_METRIC_NAMES, um.ADAPTIVE_METRICS)):
        assert set(names) <= set(ms.snapshot())
