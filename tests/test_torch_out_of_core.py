"""The PyTorch port's out-of-core layer (memory/grace.py, memory/faults.py,
plan/footprint.py, the store's pressure listeners and spill counters)
against the JAX package's, case for case with tests/test_out_of_core.py.

Each query runs through the port (on the CPU) and through the JAX package
(its TPU session, run by XLA on the CPU) on the same seeded input with the
same conf: forced partitions, a tiny budget, ``alloc_fail`` and
``budget_clamp`` each equal the JAX package's output for that conf and the
port's own single pass: keys, counts, integer sums and sorted rows
exactly, float sums within relative 1e-9 (the variableFloatAgg carve-out:
on the CPU the one-hot aggregate spreads a group's rows over sub-bins by
their position in the batch, so a partition's sums may round differently;
on the GPU they reduce in row order and ``tests/test_torch_cuda.py``
holds them bit for bit).
"""
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.memory import faults as jfaults
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.memory import faults as mfaults
from spark_rapids_tpu_torch.memory import grace
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

BASE_CONF = {
    "spark.rapids.tpu.sql.hasNans": "false",
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true",
}
FORCE4 = {"spark.rapids.tpu.memory.outOfCore.forcePartitions": "4"}
TINY_BUDGET = {
    "spark.rapids.tpu.memory.tpu.poolSizeBytes": str(256 << 10),
    "spark.rapids.tpu.memory.host.spillStorageSize": str(256 << 10),
    "spark.rapids.tpu.sql.scanCache.enabled": "false",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_memory_state():
    """Each test gets fresh memory managers (the budgets differ widely),
    fresh fault schedules and zeroed grace counters, in both packages."""
    for reset in (DeviceManager.shutdown, JaxDeviceManager.shutdown,
                  mfaults.reset_plans, jfaults.reset_plans,
                  grace.reset_counters):
        reset()
    yield
    for reset in (DeviceManager.shutdown, JaxDeviceManager.shutdown,
                  mfaults.reset_plans, jfaults.reset_plans):
        reset()


def make_table(n=40000, seed=0, groups=64):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, groups, n).astype("int64"),
        "v": rng.integers(0, 1000, n).astype("int64"),
        "d": np.round(rng.random(n), 6),
    })


def agg_df(sess, table, f):
    return (sess.create_dataframe(table).groupBy("k")
            .agg(f.sum("v").alias("sv"), f.count(f.lit(1)).alias("c"),
                 f.sum("d").alias("sd")))


def port(conf, build, table, *more):
    """(the port's result as arrow, its session) for ``conf``."""
    DeviceManager.shutdown()
    sess = TpuSession(conf, device="cpu")
    return build(sess, table, F, *more).collect().to_arrow(), sess


def reference(conf, build, table, *more):
    JaxDeviceManager.shutdown()
    jfaults.reset_plans()
    return build(JaxSession(conf), table, JF, *more).collect()


def assert_matches(conf, build, table, *more, ordered=False):
    """The port under ``conf`` equals its own single pass and the JAX
    package under ``conf`` (floats to 1e-9; ``ordered``: row for row, and
    the port's two runs bit for bit). Returns the port's session."""
    single, _ = port(BASE_CONF, build, table, *more)
    mfaults.reset_plans()
    grace.reset_counters()
    got, sess = port(conf, build, table, *more)
    if ordered:
        assert single.equals(got)
    else:
        assert_tables_equal(single, got, ignore_order=True,
                            approx_float=1e-9)
    want = reference(conf, build, table, *more)
    assert_tables_equal(want, got, ignore_order=not ordered,
                        approx_float=1e-9)
    return sess


def walk(plan):
    yield from plan.walk()


# --------------------------------------------------- size_estimate audit
def _all_exec_classes():
    from spark_rapids_tpu_torch.execs.base import PhysicalExec
    for pkg in ("execs", "plan", "memory"):
        mod = importlib.import_module(f"spark_rapids_tpu_torch.{pkg}")
        for info in pkgutil.iter_modules(mod.__path__):
            importlib.import_module(
                f"spark_rapids_tpu_torch.{pkg}.{info.name}")

    def subs(cls):
        out = set()
        for sc in cls.__subclasses__():
            out.add(sc)
            out |= subs(sc)
        return out
    return {c for c in subs(PhysicalExec)
            if c.__module__.startswith("spark_rapids_tpu_torch.")}


def test_size_estimate_contract_every_exec_class():
    """Every port exec class defines size_estimate below PhysicalExec or
    carries a non-empty size_estimate_none_reason; LeafExec is the one
    abstract base exempted."""
    from spark_rapids_tpu_torch.execs.base import LeafExec, PhysicalExec
    classes = _all_exec_classes()
    assert len(classes) >= 20
    violations = []
    for cls in classes:
        if cls is LeafExec:
            continue
        defined = any("size_estimate" in k.__dict__
                      for k in cls.__mro__ if k is not PhysicalExec)
        reason = getattr(cls, "size_estimate_none_reason", None)
        if not defined and not (isinstance(reason, str) and reason.strip()):
            violations.append(f"{cls.__module__}.{cls.__name__}")
    assert not violations, violations


def test_size_estimates_sane_on_simple_plan():
    sess = TpuSession(BASE_CONF, device="cpu")
    table = make_table(2000)
    plan = agg_df(sess, table, F).physical_plan()
    est = plan.size_estimate()
    assert est is not None and 0 < est < 10 * table.nbytes
    ws = [n.working_set_estimate() for n in walk(plan)]
    assert any(w is not None and w > 0 for w in ws)
    from spark_rapids_tpu_torch.plan.footprint import \
        plan_working_set_estimate
    assert plan_working_set_estimate(plan) == max(w for w in ws
                                                  if w is not None)


# --------------------------------------------------- forced partitioning
def test_forced_partitions_aggregate_equals_single_pass():
    sess = assert_matches({**BASE_CONF, **FORCE4}, agg_df, make_table())
    c = grace.counters()
    assert c["spill_partitions"] == 4, c
    assert c["recursion_depth_peak"] >= 1, c
    stats = [n.grace_stats for n in walk(sess.last_plan)
             if hasattr(n, "grace_stats")]
    assert stats == [{"trigger": "forced", "sized_by": "force",
                      "partitions": 4, "depth": 1, "splits": 1,
                      "fanout": 4}]


def _join_agg(sess, table, f, right):
    return (sess.create_dataframe(table)
            .join(sess.create_dataframe(right), on="k")
            .groupBy("k").agg(f.count(f.lit(1)).alias("c"),
                              f.sum("w").alias("sw")))


def test_forced_partitions_join_equals_single_pass():
    rng = np.random.default_rng(3)
    right = pa.table({"k": rng.integers(0, 64, 4000).astype("int64"),
                      "w": rng.integers(0, 9, 4000).astype("int64")})
    assert_matches({**BASE_CONF, **FORCE4}, _join_agg,
                   make_table(20000, seed=1), right)
    # the join's two sides and the aggregate above it
    assert grace.counters()["spill_partitions"] >= 8


def _join(sess, table, f, right, how):
    return (sess.create_dataframe(table)
            .join(sess.create_dataframe(right), on="k", how=how))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_forced_partitions_join_types(how):
    """Outer, semi and anti joins: whether a row matches is decided inside
    one partition, because both sides of a key (nulls included) hash to
    the same one."""
    left = pa.table({"k": pa.array([1, 2, 2, None, 5, 6] * 50,
                                   type=pa.int64()),
                     "v": pa.array(list(range(300)), type=pa.int64())})
    right = pa.table({"k": pa.array([2, 3, None, 6] * 30, type=pa.int64()),
                      "w": pa.array(list(range(120)), type=pa.int64())})
    sess = assert_matches({**BASE_CONF, **FORCE4}, _join, left, right, how)
    joins = [n for n in walk(sess.last_plan)
             if type(n).__name__.endswith("HashJoinExec")]
    # one split of 4 per side: 8 partitions in all
    assert joins and all((j.grace_stats["partitions"],
                          j.grace_stats["splits"],
                          j.grace_stats["fanout"]) == (8, 2, 4)
                         for j in joins)


def _sort3(sess, table, f):
    return sess.create_dataframe(table).sort("k", f.col("v").desc(), "d")


def test_forced_partitions_sort_exact_order():
    # strict order: the bound-ordered emission equals the stable single
    # pass bit for bit
    assert_matches({**BASE_CONF, **FORCE4}, _sort3,
                   make_table(30000, seed=2), ordered=True)
    assert grace.counters()["spill_partitions"] >= 4


def _nulls_table():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 50, 5000).astype("float64")
    vals[:7] = [-0.0, 0.0, np.nan, -0.0, np.nan, 0.0, 3.0]
    mask = rng.random(5000) < 0.1
    return pa.table({"k": pa.array(vals, mask=mask),
                     "r": pa.array(list(range(5000)), type=pa.int64())})


def _sort_kr(sess, table, f):
    return sess.create_dataframe(table).sort("k", "r")


def test_forced_partitions_sort_with_nulls():
    assert_matches({**BASE_CONF, **FORCE4}, _sort_kr, _nulls_table(),
                   ordered=True)


def test_forced_partitions_empty_input():
    empty = make_table(0)
    sess = TpuSession({**BASE_CONF, **FORCE4}, device="cpu")
    assert agg_df(sess, empty, F).collect().num_rows == 0
    assert sess.create_dataframe(empty).sort("k").collect().num_rows == 0
    assert (sess.create_dataframe(empty).join(sess.create_dataframe(empty),
                                              on="k").collect().num_rows == 0)


# --------------------------------------------------- predicted (plan hints)
def test_tiny_budget_predicts_partitioning_and_spills():
    sess = assert_matches({**BASE_CONF, **TINY_BUDGET}, agg_df,
                          make_table(60000))
    assert grace.counters()["spill_partitions"] >= 2
    dm = DeviceManager.peek()
    assert dm.spilled_bytes()["host"] > 0, dm.spilled_bytes()
    assert any(n.grace_partitions > 0 for n in walk(sess.last_plan)), \
        "the planner did not annotate grace_partitions under a tiny budget"


def _sort_kvd(sess, table, f):
    return sess.create_dataframe(table).sort("k", "v", "d")


def test_tiny_budget_sort_exact_and_recursion_bounded():
    assert_matches({**BASE_CONF, **TINY_BUDGET,
                    "spark.rapids.tpu.memory.outOfCore.maxRecursionDepth":
                        "3"}, _sort_kvd, make_table(60000, seed=7),
                   ordered=True)
    assert 1 <= grace.counters()["recursion_depth_peak"] <= 3


def test_footprint_pass_no_hints_with_ample_budget():
    sess = TpuSession(BASE_CONF, device="cpu")
    plan = agg_df(sess, make_table(2000), F).physical_plan()
    assert all(n.grace_partitions == 0 for n in walk(plan))


def test_choose_partitions_scales_and_clamps():
    from spark_rapids_tpu.config import TpuConf as JaxConf
    from spark_rapids_tpu.plan.footprint import \
        choose_partitions as jax_choose
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.plan.footprint import choose_partitions
    conf = TpuConf()
    assert choose_partitions(1 << 20, 1 << 30, conf) == 2
    n = choose_partitions(1 << 30, 1 << 24, conf)
    assert n >= 64 and n & (n - 1) == 0          # a power of two
    assert choose_partitions(1 << 40, 1 << 20, conf) == 256  # clamped
    for ws in (1, 1 << 20, 3 << 28, 1 << 33, 1 << 40):
        for budget in (1 << 16, 1 << 24, 80 << 30):
            assert choose_partitions(ws, budget, conf) == \
                jax_choose(ws, budget, JaxConf())


def _one_group(sess, table, f):
    return sess.create_dataframe(table).groupBy("k").agg(
        f.sum("v").alias("sv"))


def test_degenerate_split_stops_recursion():
    """One key group over the budget: no hash depth can split it, so after
    one degenerate probe the partition runs in one pass."""
    n = 60000
    table = pa.table({"k": np.ones(n, dtype="int64"),
                      "v": np.arange(n, dtype="int64")})
    assert_matches({**BASE_CONF, **TINY_BUDGET}, _one_group, table)
    # the first split and at most one degenerate probe level
    assert grace.counters()["recursion_depth_peak"] <= 2


# --------------------------------------------------- fault injection
def test_alloc_fail_forces_reactive_path():
    conf = {**BASE_CONF,
            "spark.rapids.tpu.memory.faults.plan": "alloc_fail:op=agg,after=1"}
    sess = assert_matches(conf, agg_df, make_table())
    c = grace.counters()
    assert c["pressure_events"] >= 1 and c["spill_partitions"] >= 2, c
    assert ("alloc_fail", "agg", 1) in mfaults.plan_for_conf(sess.conf).fired
    agg = [n for n in walk(sess.last_plan) if hasattr(n, "grace_stats")]
    assert agg[0].grace_stats["trigger"] == "reactive"


def _join_count(sess, table, f):
    return (sess.create_dataframe(table)
            .join(sess.create_dataframe(table.slice(0, 2000).select(["k"])),
                  on="k").groupBy("k").agg(f.count(f.lit(1)).alias("count")))


def _sort_kv(sess, table, f):
    return sess.create_dataframe(table).sort("k", "v")


@pytest.mark.parametrize("op,build", [("join", _join_count),
                                      ("sort", _sort_kv)])
def test_alloc_fail_other_operators(op, build):
    conf = {**BASE_CONF,
            "spark.rapids.tpu.memory.faults.plan": f"alloc_fail:op={op},after=1"}
    sess = assert_matches(conf, build, make_table(12000, seed=11),
                          ordered=op == "sort")
    assert any(f[0] == "alloc_fail" and f[1] == op
               for f in mfaults.plan_for_conf(sess.conf).fired)
    assert grace.counters()["pressure_events"] >= 1


def test_budget_clamp_shrinks_effective_budget():
    conf = {**BASE_CONF, "spark.rapids.tpu.sql.scanCache.enabled": "false",
            "spark.rapids.tpu.memory.faults.plan":
                "budget_clamp:fraction=0.0001,count=0"}
    assert_matches(conf, agg_df, make_table(60000))
    assert grace.counters()["pressure_events"] >= 1


def test_fault_plan_deterministic_replay():
    spec_text = "alloc_fail:op=agg,after=2,count=2"
    a = mfaults.MemoryFaultPlan.parse(spec_text, seed=9)
    b = mfaults.MemoryFaultPlan.parse(spec_text, seed=9)
    for plan in (a, b):
        for _ in range(5):
            plan.on_admission("agg")
        plan.on_admission("sort")       # a separate per-op counter
    assert a.fired == b.fired
    assert a.fired == [("alloc_fail", "agg", 2), ("alloc_fail", "agg", 3)]


def test_fault_plan_parse_errors():
    with pytest.raises(ValueError, match="unknown memory fault kind"):
        mfaults.MemoryFaultSpec.parse("explode:op=agg")
    with pytest.raises(ValueError, match="unknown op"):
        mfaults.MemoryFaultSpec.parse("alloc_fail:op=window")
    with pytest.raises(ValueError, match="unknown memory fault key"):
        mfaults.MemoryFaultSpec.parse("alloc_fail:nope=1")
    with pytest.raises(ValueError, match="fraction"):
        mfaults.MemoryFaultSpec.parse("budget_clamp:fraction=1.5")


def test_budget_clamp_probe_math():
    # a bare clamp is sustained (count 0: every read)
    plan = mfaults.MemoryFaultPlan.parse("budget_clamp:fraction=0.25")
    assert plan.clamp_budget("agg", 1 << 20) == 1 << 18
    assert plan.clamp_budget("agg", 1 << 20) == 1 << 18
    plan2 = mfaults.MemoryFaultPlan.parse(
        "budget_clamp:fraction=0.5,after=2,count=1")
    assert plan2.clamp_budget("agg", 100) == 100      # window not open yet
    assert plan2.clamp_budget("agg", 100) == 50
    assert plan2.clamp_budget("agg", 100) == 100      # window closed


def test_faults_copy_is_byte_equal_apart_from_imports():
    ours = (ROOT / "spark_rapids_tpu_torch/memory/faults.py").read_text()
    ref = (ROOT / "spark_rapids_tpu/memory/faults.py").read_text()

    def body(text):
        return [ln for ln in text.splitlines()
                if not ln.lstrip().startswith(("import ", "from "))]
    assert body(ours) == body(ref)
    assert len(ours.splitlines()) == len(ref.splitlines())


# --------------------------------------------------- the split and its salt
def test_split_keeps_float_specials_and_null_bits():
    """The port's split moves the columns as they are (no bits sibling):
    -0.0, NaN and nulls survive bit for bit, every row lands once, and
    each piece keeps its rows in input order."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.execs.base import ExecContext
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    rng = np.random.default_rng(0)
    n = 200
    x = rng.random(n)
    x[:6] = [-0.0, np.nan, 0.0, -np.nan, np.inf, -0.0]
    table = pa.table({"k": rng.integers(0, 8, n).astype("int64"),
                      "x": pa.array(x, mask=rng.random(n) < 0.2),
                      "r": np.arange(n, dtype="int64")})
    batch = upload(HostBatch.from_arrow(table), CPU)
    ctx = ExecContext(TpuConf(), CPU)
    keys = (BoundReference(0, DType.LONG, False),)
    want_bits = batch.columns[1].data[:n].view(torch.int64)
    want_valid = batch.columns[1].validity[:n]
    seen = torch.zeros(n, dtype=torch.int64)
    for _pid, piece in grace.split_batch(ctx, batch, keys, 4, depth=0):
        m = piece.num_rows
        r = piece.columns[2].data[:m]
        assert torch.all(r[1:] > r[:-1])             # input order
        assert torch.equal(piece.columns[1].validity[:m], want_valid[r])
        v = piece.columns[1].validity[:m]
        assert torch.equal(piece.columns[1].data[:m].view(torch.int64)[v],
                           want_bits[r][v])
        seen[r] += 1
    assert torch.equal(seen, torch.ones(n, dtype=torch.int64))


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_split_partition_ids_equal_reference(depth):
    """The depth salt is the reference's: the port's hash partition ids
    equal the JAX package's at every depth, over ints, doubles and
    strings with nulls."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.dtypes import DType as JDType
    from spark_rapids_tpu.execs.exchange_execs import \
        hash_partition_ids as jax_ids
    from spark_rapids_tpu.exprs.core import ColV as JColV
    from spark_rapids_tpu.memory.grace import _depth_seed as jax_seed
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.execs.exchange_execs import hash_partition_ids
    from spark_rapids_tpu_torch.exprs.core import ColV
    assert grace._depth_seed(depth) == jax_seed(depth)
    rng = np.random.default_rng(depth)
    n = 4096
    ints = rng.integers(-1000, 1000, n).astype(np.int64)
    dbl = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5]), n)
    valid = rng.random(n) > 0.1
    want = np.asarray(jax_ids(jnp, [
        JColV(JDType.LONG, jnp.asarray(ints), jnp.asarray(valid)),
        JColV(JDType.DOUBLE, jnp.asarray(dbl), jnp.asarray(valid))],
        n, 8, seed=jax_seed(depth)))
    got = hash_partition_ids([
        ColV(DType.LONG, torch.from_numpy(ints), torch.from_numpy(valid)),
        ColV(DType.DOUBLE, torch.from_numpy(dbl), torch.from_numpy(valid))],
        n, 8, seed=grace._depth_seed(depth)).numpy()
    assert np.array_equal(want, got)


def test_depth_salt_redistributes():
    """Keys that collide mod n at depth 0 spread at depth 1: what makes
    the recursion converge."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.execs.exchange_execs import hash_partition_ids
    from spark_rapids_tpu_torch.exprs.core import ColV
    keys = [ColV(DType.LONG, torch.arange(4096, dtype=torch.int64),
                 torch.ones(4096, dtype=torch.bool))]
    p0 = hash_partition_ids(keys, 4096, 8, seed=grace._depth_seed(0))
    p1 = hash_partition_ids(keys, 4096, 8, seed=grace._depth_seed(1))
    assert len(torch.unique(p1[p0 == 0])) >= 4


# --------------------------------------------------- the store
def _device_batch(rows=4096):
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    return upload(HostBatch.from_arrow(
        pa.table({"x": np.arange(rows, dtype="int64")})), CPU)


def _chain(device_budget, host_budget):
    from spark_rapids_tpu_torch.memory.store import (BufferCatalog,
                                                     build_store_chain)
    catalog = BufferCatalog()
    return (catalog,) + build_store_chain(catalog, device_budget, host_budget)


def test_store_pressure_listener_fires():
    from spark_rapids_tpu_torch.memory.buffer import BufferId
    _, device, host, disk = _chain(64 << 10, 1 << 20)
    events = []
    device.add_pressure_listener(events.append)
    for i in range(4):
        device.add_batch(BufferId(1 << 28, i), _device_batch(), float(i))
    assert events and sum(events) > 0
    device.remove_pressure_listener(events.append)
    n = len(events)
    device.add_batch(BufferId(1 << 28, 99), _device_batch(), 99.0)
    assert len(events) == n          # unsubscribed
    for s in (device, host, disk):
        s.close()


def test_spilled_bytes_by_tier_counters():
    from spark_rapids_tpu_torch.memory.buffer import BufferId, StorageTier
    _, device, host, disk = _chain(48 << 10, 48 << 10)
    for i in range(6):
        device.add_batch(BufferId(1 << 28, i), _device_batch(), float(i))
    assert device.spilled_to[StorageTier.HOST] > 0
    assert host.spilled_to[StorageTier.DISK] > 0
    for s in (device, host, disk):
        s.close()


def test_host_arena_overflow_lands_on_disk():
    """A buffer bigger than the whole host arena overflows to the disk tier
    instead of failing the spill cascade, and is counted there."""
    from spark_rapids_tpu_torch.memory.buffer import BufferId, StorageTier
    catalog, device, host, disk = _chain(16 << 10, 8 << 10)
    ids = [BufferId(1 << 28, i) for i in range(3)]
    for i, bid in enumerate(ids):
        device.add_batch(bid, _device_batch(), float(i))
    assert len(disk) >= 1
    assert host.spilled_to[StorageTier.DISK] > 0
    for bid in ids:
        buf = catalog.acquire(bid)
        assert buf is not None
        try:
            assert buf.get_batch().num_rows == 4096
        finally:
            buf.close()
    for s in (device, host, disk):
        s.close()


def test_grace_pieces_spill_and_come_back():
    """Partitions under a tiny store go down the tiers and drain back in
    insertion order."""
    from spark_rapids_tpu_torch.memory.buffer import StorageTier
    catalog, device, host, disk = _chain(40 << 10, 40 << 10)
    parts = grace.SpillablePartitions(device, catalog, 2, 0)
    batches = [_device_batch(1000 + i) for i in range(6)]
    for i, b in enumerate(batches):
        parts.add(i % 2, b)
    tiers = set()
    for bid in catalog.ids():
        buf = catalog.acquire(bid)
        tiers.add(buf.tier)
        buf.close()
    assert StorageTier.DEVICE in tiers and len(tiers) >= 2
    assert [b.num_rows for b in parts.take(0)] == [1000, 1002, 1004]
    assert [b.num_rows for b in parts.drain(1)] == [1001, 1003, 1005]
    assert not catalog.ids()
    parts.close()
    for s in (device, host, disk):
        s.close()


# --------------------------------------------------- the hot path
def test_hot_path_untouched_with_ample_budget():
    sess = TpuSession(BASE_CONF, device="cpu")
    agg_df(sess, make_table(8000), F).collect()
    assert grace.counters() == {"pressure_events": 0, "spill_partitions": 0,
                                "recursion_depth_peak": 0}
    assert not any(hasattr(n, "grace_stats") for n in walk(sess.last_plan))


def test_no_buffer_leaks_after_out_of_core_query():
    table = make_table(60000)
    sess = TpuSession({**BASE_CONF, **TINY_BUDGET}, device="cpu")
    dm = DeviceManager.initialize(sess.conf, CPU)
    ids_before = set(dm.catalog.ids())
    agg_df(sess, table, F).collect()
    sess.create_dataframe(table).sort("k", "v").collect()
    assert grace.counters()["spill_partitions"] > 0
    assert set(dm.catalog.ids()) == ids_before


def test_pressure_from_another_query_flips_staging():
    """A pressure event on the store while an operator stages its input
    (another query spilling) sends it down the partitioned path."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.execs.base import ExecContext
    dm = DeviceManager.initialize(TpuConf(), CPU)
    ctx = ExecContext(TpuConf(), CPU, device_manager=dm)

    class Node:
        working_set_factor = 3.0
        grace_partitions = 0
        children = ()

    from spark_rapids_tpu_torch.exprs.core import BoundReference
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    keys = (BoundReference(0, DType.LONG, False),)
    ooc = grace.controller_for(Node(), ctx, "agg", keys)

    def source():
        yield _device_batch(100)
        dm.device_store._notify_pressure(1)      # someone else spilled
        yield _device_batch(100)
    mode, parts = ooc.stage(source(), keys)
    assert mode == "partitioned" and ooc.triggered
    assert sum(len(parts.take(p)) for p in range(parts.n)) > 0


# --------------------------------------------------- sums that move with grace
def test_segments_start_aligned_whatever_their_offset():
    """The GPU segment sum's layout (``align_segments``): every segment
    starts on a 32-byte boundary, holds its rows in order and zeros after
    them, so a group's sum no longer depends on where its rows sat in the
    batch (a grace partition moves them)."""
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    rng = np.random.default_rng(4)
    for dtype, step in ((torch.float64, 4), (torch.float32, 8)):
        ids = torch.from_numpy(np.sort(rng.integers(0, 9, 1000)))
        vals = torch.from_numpy(rng.standard_normal(1000)).to(dtype)
        aligned, padded = bk.align_segments(vals, ids, 11)
        lengths = torch.bincount(ids, minlength=11)
        assert torch.equal(padded % step, torch.zeros_like(padded))
        assert torch.all(padded - lengths < step)
        start = 0
        for s in range(11):
            got = aligned[start:start + int(padded[s])]
            assert torch.equal(got[:int(lengths[s])], vals[ids == s])
            assert not got[int(lengths[s]):].any()
            start += int(padded[s])
        sums = torch.segment_reduce(aligned, "sum", lengths=padded,
                                    unsafe=True)
        want = torch.zeros(11, dtype=dtype).index_add_(0, ids, vals)
        assert torch.allclose(sums, want)


@pytest.mark.parametrize("mode", ["onehot", "hash", "sort"])
@pytest.mark.parametrize("keyed", [True, False])
def test_segment_ids_sorted_where_promised(mode, keyed):
    """The GPU's segment sum trusts ``ids_sorted``: every reduction that
    passes it gets non-decreasing segment ids, a folded filter's mask
    (rows dropped anywhere in the batch) and the padding included, in
    every grouping mode and in the global aggregate."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, Sum
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops import aggregate as agg
    rng = np.random.default_rng(9)
    n, cap = 3000, 4096
    key = torch.from_numpy(rng.integers(0, 40, cap))
    val = torch.from_numpy(rng.standard_normal(cap))
    mask = torch.from_numpy(rng.random(cap) < 0.6)
    calls = []
    orig = agg.bk.segment_reduce

    def spy(data, validity, seg_ids, num_segments, kind, ids_sorted=False):
        if ids_sorted:
            calls.append(bool(torch.all(seg_ids[1:] >= seg_ids[:-1])))
        return orig(data, validity, seg_ids, num_segments, kind, ids_sorted)
    refs = [BoundReference(0, DType.LONG), BoundReference(1, DType.DOUBLE)]
    cols = [ColV(DType.LONG, key, torch.arange(cap) < n),
            ColV(DType.DOUBLE, val, torch.arange(cap) < n)]
    agg.bk.segment_reduce = spy
    try:
        agg.group_aggregate(EvalCtx(cols, cap, CPU),
                            [refs[0]] if keyed else [], [Sum(refs[1])], n,
                            cap, grouping=mode, extra_mask=mask)
    finally:
        agg.bk.segment_reduce = orig
    assert all(calls), calls


@pytest.mark.parametrize("mode", ["hash", "sort"])
def test_dead_rows_stay_out_of_the_last_group(mode):
    """The hash and sort modes reduce a batch's dead rows into a spare
    segment, not the last group's: the same live rows at two capacities
    give the same per-group segments."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import BoundReference, Sum
    from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
    from spark_rapids_tpu_torch.ops import aggregate as agg
    rng = np.random.default_rng(8)
    n = 5000
    key = torch.from_numpy(rng.integers(0, 300, n))
    val = torch.from_numpy(rng.standard_normal(n))
    seen = []
    orig = agg.bk.segment_reduce

    def spy(data, validity, seg_ids, num_segments, kind, ids_sorted=False):
        # the rows each group's segment holds, dead ones included
        seen.append(torch.bincount(seg_ids, minlength=num_segments)[:300])
        return orig(data, validity, seg_ids, num_segments, kind, ids_sorted)
    refs = [BoundReference(0, DType.LONG), BoundReference(1, DType.DOUBLE)]
    agg.bk.segment_reduce = spy
    try:
        for cap in (n, 3 * n):
            pad = cap - n
            cols = [ColV(DType.LONG, torch.cat([key, key.new_zeros(pad)]),
                         torch.arange(cap) < n),
                    ColV(DType.DOUBLE, torch.cat([val, val.new_zeros(pad)]),
                         torch.arange(cap) < n)]
            agg.group_aggregate(EvalCtx(cols, cap, CPU), [refs[0]],
                                [Sum(refs[1])], n, cap, grouping=mode)
    finally:
        agg.bk.segment_reduce = orig
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
