"""Shared pieces of the port's adaptive-execution tests
(tests/test_torch_adaptive*.py): the same DataFrame, built from the same
seeded arrow tables, runs through the port on the CPU and through the JAX
package, and the two runs' results and adaptive decisions are compared:
the ``[adaptive: …]`` tags in plan order (with the class of each tagged
node), every custom shuffle reader's specs, and the port's
``plan.adaptive.counters()`` against the JAX
``session.last_metrics["adaptive"]`` deltas."""
import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.plan import adaptive

AQE = {"spark.rapids.tpu.sql.adaptive.enabled": "true"}

#: the JAX tests' skew knobs, scaled to test-size data: a tiny skew
#: threshold so the hot partition trips it, a tiny advisory size so the
#: upstream round-robin exchange keeps several map tasks
SKEW = {**AQE,
        "spark.rapids.tpu.sql.adaptive.skewedPartitionThreshold.bytes": "64",
        "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor": "2.0",
        "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes": "2048"}

NO_BROADCAST = {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"}

#: the JAX CPU engine: the JAX package's adaptive rewrite over its numpy
#: operators, which decides from the same stage statistics as its device
#: path at a fraction of the XLA compile time
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false"}


def table(n=100):
    return pa.table({"a": pa.array(np.arange(n), type=pa.int64()),
                     "b": pa.array(np.arange(n) % 7, type=pa.int64())})


def skewed_table(n=2000, hot=0.8, seed=7):
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < hot, 0, rng.integers(1, 50, n))
    return pa.table({"k": pa.array(k, type=pa.int64()),
                     "v": pa.array(np.arange(n), type=pa.int64())})


def dim_table(m=50):
    return pa.table({"k": pa.array(np.arange(m), type=pa.int64()),
                     "w": pa.array(np.arange(m) * 10, type=pa.int64())})


def t7(n=3000):
    return pa.table({"k": pa.array(np.arange(n) % 7, type=pa.int64()),
                     "v": pa.array(np.arange(n), type=pa.int64())})


def t13(n):
    return pa.table({"k": pa.array(np.arange(n) % 13, type=pa.int64()),
                     "v": pa.array(np.arange(n), type=pa.int64())})


def sort_all(t):
    cols = sorted(t.column_names)
    return t.select(cols).sort_by([(c, "ascending") for c in cols])


def walk(node):
    yield node
    for c in node.children:
        yield from walk(c)


def run_port(conf, build):
    """(result as arrow, session, adaptive counter deltas) of the port on
    the CPU."""
    DeviceManager.shutdown()
    adaptive.reset_counters()
    sess = TpuSession(conf, device="cpu")
    out = build(sess, F).collect().to_arrow()
    return out, sess, adaptive.counters()


def run_jax(conf, build):
    """(result, session, adaptive counter deltas) of the JAX package."""
    JaxDeviceManager.shutdown()
    sess = JaxSession(conf)
    out = build(sess, JF).collect()
    deltas = {k.split(".", 1)[1]: int(v)
              for k, v in sess.last_metrics.get("adaptive", {}).items()}
    return out, sess, deltas


def decisions(plan):
    """The plan's adaptive decisions in pre-order: each tagged node's class
    and tag, and each custom shuffle reader's class, specs and alignment."""
    tags, readers = [], []
    for n in walk(plan):
        if getattr(n, "adaptive_tag", ""):
            tags.append((type(n).__name__, n.adaptive_tag))
        if hasattr(n, "specs") and type(n).__name__.endswith(
                "CustomShuffleReaderExec"):
            readers.append((type(n).__name__, repr(n.specs),
                            bool(getattr(n, "aligned_pairwise", False))))
    return tags, readers


def assert_same_run(conf, build, *, jax_conf=None, ordered=False,
                    sort_key=None, engine_names=None):
    """Run ``build`` through both packages under ``conf`` (the JAX side
    under ``jax_conf`` when given) and hold the port to the JAX package:
    equal results (``sort_key``: both sorted by it; else row order only
    when ``ordered``), the same decisions and the same counters.
    ``engine_names`` maps the JAX side's class names onto the port's where
    the two ran different engines (the JAX CPU engine's Cpu* classes
    against the port's device classes). Returns the two (result, session,
    counters) triples."""
    port = run_port(conf, build)
    ref = run_jax(jax_conf if jax_conf is not None else conf, build)
    got, want = port[0], ref[0]
    if sort_key is not None:
        assert_tables_equal(want.sort_by(sort_key), got.sort_by(sort_key))
    elif ordered:
        assert_tables_equal(want, got)
    else:
        assert_tables_equal(sort_all(want), sort_all(got))
    ptags, preaders = decisions(port[1].last_plan)
    jtags, jreaders = decisions(ref[1].last_plan)
    if engine_names:
        jtags = [(engine_names.get(c, c), t) for c, t in jtags]
        jreaders = [(engine_names.get(c, c), s, a) for c, s, a in jreaders]
    assert ptags == jtags, (ptags, jtags)
    assert preaders == jreaders, (preaders, jreaders)
    assert port[2] == ref[2], (port[2], ref[2])
    return port, ref


def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads
