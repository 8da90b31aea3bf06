"""The serving wire against the JAX package's: the host-only modules are
the reference's text; the port's client against the JAX package's server,
and the JAX package's client against the port's server, stream the same
tables over loopback TCP, also when a corrupted result frame is caught by
its checksum and fetched again; a client that vanishes mid-stream cancels
its query on the port's server and leaves nothing held."""
import ast
import re
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.serving.client import \
    QueryServiceClient as JaxClient
from spark_rapids_tpu.serving.server import QueryServer as JaxServer
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu.utils import metrics as jax_um
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.serving.client import QueryServiceClient
from spark_rapids_tpu_torch.serving.lifecycle import QueryState
from spark_rapids_tpu_torch.serving.server import QueryServer
from spark_rapids_tpu_torch.utils import metrics as um
from tests.torch_serving_common import (WAIT_S, as_arrow,  # noqa: F401
                                        no_leaks, one_torch_thread,
                                        sessions, wait_until)

ROOT = Path(__file__).resolve().parents[1]

#: the modules the port keeps as the reference's text
COPIES = ("lifecycle", "controller", "wire", "health", "client", "supervisor")
#: the phrases of the reference's docstrings that narrate its own history
#: (which of its changes brought what), as the copies word them
HISTORY = ((r"PR \d+'s routing client was a", "The first routing client was a"),
           (r"PR \d+ made replica death", "Failover made replica death"),
           (r"PR \d+ TCP stack", "TCP shuffle stack"),
           (r"the PR \d+ ", "the "),
           (r" PR \d+(?=\n)", ""))

FILTER_SQL = "SELECT k, v FROM t WHERE v > 0.5"
AGG_SQL = "SELECT k, sum(v) AS s, count(*) AS c FROM t GROUP BY k ORDER BY k"


@pytest.mark.parametrize("name", COPIES)
def test_copies_are_the_reference_text(name):
    """Equal to the reference after the package name and the HISTORY
    phrases, which touch only docstrings and comments."""
    ref = (ROOT / "spark_rapids_tpu" / "serving" / f"{name}.py").read_text()
    port = (ROOT / "spark_rapids_tpu_torch" / "serving"
            / f"{name}.py").read_text()
    ref = ref.replace("spark_rapids_tpu", "spark_rapids_tpu_torch")
    code = _code(ref)
    for pattern, phrase in HISTORY:
        ref = re.sub(pattern, phrase, ref)
    assert port == ref
    assert _code(port) == code


def _code(src: str) -> str:
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def table(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 8, n).astype("int64"),
                     "v": rng.random(n)})


def serve(make, pkg, extra=None, partitions=3, n=6000):
    sess = make(pkg, extra)
    df = sess.create_dataframe(table(n))
    if partitions > 1:
        df = df.repartition(partitions)
    df.createOrReplaceTempView("t")
    server = (JaxServer if pkg == "jax" else QueryServer)(sess)
    host, port = server.address
    return sess, server, f"{host}:{port}"


FAULT = {"spark.rapids.tpu.serving.net.faults.plan": "corrupt_frame:after=1",
         "spark.rapids.tpu.serving.net.faults.seed": "7"}


@pytest.mark.parametrize("server_pkg,fault", [
    ("jax", False), ("port", False), ("jax", True), ("port", True)])
def test_clients_and_servers_of_both_packages_agree(sessions, server_pkg,
                                                    fault):
    """The other package's client streams the same tables a server's own
    session collects; with a corrupted frame the client re-fetches it."""
    sess, server, addr = serve(sessions, server_pkg, FAULT if fault else {})
    client = (QueryServiceClient([addr], TpuConf()) if server_pkg == "jax"
              else JaxClient([addr], JaxConf()))
    retries = (jax_um if server_pkg == "port" else um).SERVING_METRICS
    key = um.SERVING_WIRE_RETRIES
    before = retries[key].value
    try:
        for sql in (FILTER_SQL, AGG_SQL):
            h = client.submit(sql)
            got = h.result()
            assert_tables_equal(as_arrow(sess.sql(sql).collect()), got)
        assert h.batches_delivered >= 1
        if fault:
            assert retries[key].value - before >= 1
            assert [f for f in server.transport.plan.fired
                    if f[0] == "corrupt_frame"]
    finally:
        client.close()
        server.shutdown()
    sess.scheduler.drain(timeout=WAIT_S)
    no_leaks(server_pkg, sess)


def test_vanished_client_cancels_its_query_on_the_port_server(sessions):
    sess, server, addr = serve(
        sessions, "port", {"spark.rapids.tpu.serving.net.streamQueueDepth":
                           "1"}, partitions=8, n=40000)
    client = QueryServiceClient([addr], sess.conf)
    try:
        it = client.submit(FILTER_SQL).batches()
        next(it)                        # mid-stream, frames parked
        sq = list(server._queries.values())[0]
        client.close()                  # vanish without a cancel
        wait_until(lambda: not server._queries)
        assert sq.handle.cancel_requested
        assert sess.scheduler.drain(timeout=WAIT_S)
        assert sq.handle.state in (QueryState.CANCELLED, QueryState.DONE)
        assert sq.parked is None and not sq.slices
        no_leaks("port", sess)
    finally:
        server.shutdown()


def test_stats_and_health_rpcs_report_the_port_replica(sessions):
    sess, server, addr = serve(sessions, "port")
    client = QueryServiceClient([addr], sess.conf)
    try:
        client.submit(AGG_SQL).result()
        stats = client.stats()
        assert stats["scheduler"]["states"]["DONE"] >= 1
        assert stats["state"] == "UP"
        now = stats["serve_stats"]["now"]
        assert now["device_budget_bytes"] > 0
        assert stats["serving"][um.SERVING_STREAM_BATCHES] >= 1
    finally:
        client.close()
        server.shutdown()
    deadline = time.monotonic() + WAIT_S
    while sess.scheduler.stats()["active"] and time.monotonic() < deadline:
        time.sleep(0.01)
