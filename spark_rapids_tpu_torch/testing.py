"""Result comparison over the port's sessions (the JAX package's
``testing.py``; reference: the integration tests' ``asserts.py``
``_assert_equal`` and SparkQueryCompareTestSuite's ``runOnCpuAndGpu``).

``run_with_cpu_and_tpu`` runs one DataFrame-building function through a
session whose plan layer is off (``sql.enabled=false``: every operator on
the CPU engine) and one where it is on; ``assert_tables_equal`` compares
two ``HostBatch``es with NaN equal to NaN, optionally unordered and with a
relative float tolerance. Nothing here needs pyarrow or the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.host import HostBatch


def _values_equal(a: Any, b: Any, approx: Optional[float]) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if approx is not None:
            if a == b:
                return True
            denom = max(abs(a), abs(b))
            return denom != 0 and abs(a - b) / denom <= approx
        return a == b
    return a == b


def _row_key(row) -> tuple:
    """A total order over rows with nulls last and NaN after numbers (the
    order arrow's sort gives the JAX package's unordered compare)."""
    out = []
    for v in row:
        if v is None:
            out.append((2, 0))
        elif isinstance(v, float) and math.isnan(v):
            out.append((1, 0))
        else:
            out.append((0, v))
    return tuple(out)


def table_rows(batch: HostBatch) -> List[tuple]:
    """The batch's rows as tuples of Python values."""
    cols = [c.to_pylist(batch.num_rows) for c in batch.columns]
    return list(zip(*cols)) if cols else [()] * batch.num_rows


def run_with_cpu_and_tpu(build_df, conf: Optional[dict] = None,
                         device=None):
    """Run ``build_df(session)`` on a CPU-engine session and on a session
    with the plan layer on; returns (cpu result, device result, device
    session). ``device`` is the sessions' device (the GPU by default)."""
    from spark_rapids_tpu_torch.api import TpuSession
    base = dict(conf or {})
    cpu_sess = TpuSession({**base, "spark.rapids.tpu.sql.enabled": "false"},
                          device=device)
    tpu_sess = TpuSession({**base, "spark.rapids.tpu.sql.enabled": "true"},
                          device=device)
    cpu = build_df(cpu_sess).collect()
    tpu = build_df(tpu_sess).collect()
    return cpu, tpu, tpu_sess


def assert_tpu_and_cpu_equal(build_df, conf: Optional[dict] = None,
                             ignore_order: bool = False,
                             approx_float: Optional[float] = None,
                             expect_tpu_execs: Optional[Sequence[str]] = None,
                             device=None) -> HostBatch:
    """The device run equals the CPU engine's; with ``expect_tpu_execs``,
    each named exec must appear in the device run's plan."""
    cpu, tpu, sess = run_with_cpu_and_tpu(build_df, conf, device)
    assert_tables_equal(cpu, tpu, ignore_order=ignore_order,
                        approx_float=approx_float)
    if expect_tpu_execs:
        plan_str = sess.last_plan.tree_string() if sess.last_plan else ""
        for name in expect_tpu_execs:
            assert name in plan_str, (
                f"expected {name} on the device plan, got:\n{plan_str}\n"
                f"explain:\n{sess.last_explain}")
    return cpu


def assert_tables_equal(expected: HostBatch, actual: HostBatch,
                        ignore_order: bool = False,
                        approx_float: Optional[float] = None) -> None:
    """Deep-compare two results: names and types, row counts, then every
    value (NaN == NaN; floats within ``approx_float`` relative)."""
    e_schema = [(f.name, f.dtype) for f in expected.schema]
    a_schema = [(f.name, f.dtype) for f in actual.schema]
    assert e_schema == a_schema, (
        f"schema mismatch:\nexpected {e_schema}\nactual   {a_schema}")
    assert expected.num_rows == actual.num_rows, (
        f"row count mismatch: expected {expected.num_rows}, "
        f"actual {actual.num_rows}")
    erows, arows = table_rows(expected), table_rows(actual)
    if ignore_order:
        erows.sort(key=_row_key)
        arows.sort(key=_row_key)
    names = [n for n, _ in e_schema]
    for i, (er, ar) in enumerate(zip(erows, arows)):
        for name, e, a in zip(names, er, ar):
            assert _values_equal(e, a, approx_float), (
                f"column {name!r} row {i}: expected {e!r}, actual {a!r}")
