"""Query tracing against the JAX package's: EXPLAIN ANALYZE's rows and
batches per node equal the reference's where the plans' node names match;
the Chrome export parses and holds a span per executed exec; a served
query's analysis and export come from its handle; tracing off records
nothing; each exec pull is a named ``torch.profiler`` range, and a span
never synchronizes the device."""
import json

import pytest
import torch

from spark_rapids_tpu.utils import tracing as jax_tracing
from spark_rapids_tpu_torch.utils import tracing
from tests.torch_serving_common import (PKGS, WAIT_S,  # noqa: F401
                                        one_torch_thread, sessions,
                                        small_table)

TRACE = {"spark.rapids.tpu.trace.enabled": "true"}


def query(pkg, sess):
    F = PKGS[pkg][0]
    return (sess.create_dataframe(small_table(500, seed=9)).repartition(3)
            .filter(F.col("v") > 0.2).groupBy("k")
            .agg(F.sum("v").alias("s"), F.count(F.lit(1)).alias("c"))
            .sort("k"))


def observed(plan, obs):
    """{node name: [(rows, batches), ...]} in tree order, executed nodes
    only."""
    out = {}

    def walk(n):
        o = obs(n)
        if o is not None:
            out.setdefault(n.name, []).append((o["rows"], o["batches"]))
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def test_explain_analyze_counts_equal_the_reference(sessions):
    seen = {}
    for pkg in ("jax", "port"):
        sess = sessions(pkg, TRACE)
        query(pkg, sess).collect()
        text = sess.explain_analyze()
        assert "rows=" in text and "batches=" in text
        seen[pkg] = observed(sess.last_plan, (jax_tracing if pkg == "jax"
                                              else tracing).observed_of)
    common = [n for n in seen["port"] if n in seen["jax"]
              and len(seen["port"][n]) == len(seen["jax"][n])]
    assert {"TpuShuffleExchangeExec", "TpuSortExec"} <= set(common), seen
    for name in common:
        assert seen["port"][name] == seen["jax"][name], name


def test_chrome_export_holds_a_span_per_exec(sessions, tmp_path):
    path = tmp_path / "trace.json"
    sess = sessions("port", {**TRACE,
                             "spark.rapids.tpu.trace.export.path": str(path)})
    query("port", sess).collect()
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["cat"] == "exec"]
    executed = {n.plan_id: n.name for n in sess.last_plan.walk()
                if tracing.observed_of(n) is not None}
    assert executed
    by_plan = {e["args"]["plan_id"]: e["name"] for e in spans}
    for pid, name in executed.items():
        assert by_plan.get(pid) == name, (pid, name)
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in spans)
    assert doc["otherData"]["action_wall_s"] > 0
    assert any(e["name"] == "serving.admission_wait"
               for e in doc["traceEvents"])


def test_served_query_analysis_and_export_come_from_its_handle(
        sessions, tmp_path):
    sess = sessions("port", TRACE)
    h = sess.submit(query("port", sess), label="traced")
    h.result(timeout=WAIT_S)
    text = h.explain_analyze()
    assert f"query {h.query_id}" in text
    plan_names = [n.name for n in sess.last_plan.walk()]
    for name in set(plan_names) - {"CpuLocalScanExec", "DeviceToHostExec"}:
        assert any(name in line and "rows=" in line
                   for line in text.splitlines()), (name, text)
    n = h.export_trace(str(tmp_path / "q.json"))
    doc = json.loads((tmp_path / "q.json").read_text())
    assert n == len(doc["traceEvents"]) > 0
    assert {e["args"]["query_id"] for e in doc["traceEvents"]} == \
        {h.query_id}
    states = [e["name"] for e in doc["traceEvents"]
              if e["name"].startswith("serving.state.")]
    assert states[-1] == "serving.state.DONE"


def test_tracing_off_records_nothing(sessions):
    sess = sessions("port")
    mark = tracing.TRACER.mark()
    h = sess.submit(query("port", sess))
    h.result(timeout=WAIT_S)
    assert tracing.TRACER.since(mark) == []
    assert all(tracing.observed_of(n) is None for n in sess.last_plan.walk())
    with pytest.raises(RuntimeError, match="trace.enabled"):
        h.explain_analyze()
    assert "rows=" not in sess.explain_analyze()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ring_buffer_bounded_and_windowed(pkg):
    mod = jax_tracing if pkg == "jax" else tracing
    t = mod.Tracer(capacity=16)
    with t.activate():
        for i in range(40):
            t.record(f"s{i}", "exec", i, 1)
        m = t.mark()
        t.record("late", "exec", 99, 1)
    assert [r.name for r in t.since(0)][:2] == ["s25", "s26"]
    assert [r.name for r in t.since(m)] == ["late"]
    assert not t.on


def test_exec_pulls_are_profiler_ranges_and_never_sync(sessions,
                                                       monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a span synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    sess = sessions("port", TRACE)
    df = query("port", sess)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        df.collect()
    names = {e.key for e in prof.key_averages()}
    assert any(k.startswith("TpuSortExec#") for k in names), names
    assert "tpu-sql-action" in names
