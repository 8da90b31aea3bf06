"""Multi-executor query execution over the shuffle-manager stack.

The JAX package's ``parallel/cluster.py``: a physical plan is split into
shuffle stages at its exchanges (Spark's DAGScheduler role), map tasks run
across executors and write each reduce partition's device batches through
the CachingShuffleWriter into that executor's spillable shuffle catalog,
and reduce-side reads serve local blocks from the catalog and fetch remote
blocks through the transport client: the in-process fabric, or TCP sockets
between executors in OS processes of their own.

Every executor runs on the session's device: in-process executors share
the driver's process and device, and each executor daemon opens the device
its ``init`` message names (a CUDA session's daemons run on the GPU, a
``device="cpu"`` session's on the CPU).

What crosses a process boundary is host data only. A stage's plan ships
as a pickle (the exchanges, the broadcast and the cached-data entries drop
their process-local state in ``__getstate__``); a broadcast, a cached
partition and a result batch ship as packed host buffers (the shuffle's
own wire format, ``shuffle/table_meta.py``), where the JAX package ships
arrow IPC.

Range partitioning runs its map stage as ONE task (bounds need a global
sample); the reduce side still fans out across executors.
"""
from __future__ import annotations

import atexit
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec, PhysicalExec
from spark_rapids_tpu_torch.parallel.broadcast import (deserialize_batch,
                                                       serialize_batch)
from spark_rapids_tpu_torch.shuffle.manager import (CachingShuffleReader,
                                                    CachingShuffleWriter,
                                                    MapOutputTracker,
                                                    MapStatus, ShuffleEnv,
                                                    ShuffleFetchFailedError)
from spark_rapids_tpu_torch.utils import errors as uerr
from spark_rapids_tpu_torch.utils import metrics as mt

_TCP_TRANSPORT = "spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport"

#: seconds a daemon has to connect back to its driver
_START_TIMEOUT_S = 60.0

#: seconds this process spent pickling stage plans (the driver) and
#: unpickling them (``_run_task``: in-process executors run it in the
#: driver's process, a daemon in its own)
_COUNTERS: Dict[str, float] = {"plan_pickle_seconds": 0.0,
                               "plan_unpickle_seconds": 0.0}
_COUNTERS_LOCK = threading.Lock()


def _count(name: str, seconds: float) -> None:
    with _COUNTERS_LOCK:
        _COUNTERS[name] += seconds


def counters() -> Dict[str, float]:
    """The plan pickle and unpickle seconds of this process."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0.0


# ------------------------------------------------------------------ plan split
class ClusterShuffleReadExec(LeafExec):
    """Reduce-side leaf standing in for an exchange: reads one partition of a
    parent stage's shuffle through the executor's caching reader."""

    #: map-output sizes exist only at run time (MapStatus); the stage
    #: scheduler's coalescing reads them there, not at plan time
    size_estimate_none_reason = ("remote map-output sizes are known only "
                                 "at run time (MapStatus)")

    def __init__(self, stage_index: int, output: Schema, num_parts: int):
        super().__init__(output)
        self.stage_index = stage_index
        self.num_parts = num_parts
        self.shuffle_id: Optional[int] = None  # driver assigns pre-pickle
        #: adaptive coalescing: when set, consumer partition i reads the
        #: contiguous exchange partitions ``specs[i]``, grouped by the
        #: driver from the observed MapStatus sizes after the map stage ran
        self.specs: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def num_partitions(self) -> int:
        return len(self.specs) if self.specs is not None else self.num_parts

    def execute(self, ctx: ExecContext):
        cs = ctx.cluster_shuffle
        if cs is None:
            raise RuntimeError("cluster shuffle read outside a cluster task")
        tracker = MapOutputTracker()
        tracker.register_shuffle(self.shuffle_id)
        for st in cs.statuses[self.shuffle_id]:
            tracker.register_map_output(self.shuffle_id, st)
        pids = (self.specs[ctx.partition_id] if self.specs is not None
                else (ctx.partition_id,))
        for pid in pids:
            reader = CachingShuffleReader(cs.env, tracker, self.shuffle_id,
                                          pid)
            yield from reader.read()


@dataclass
class _Stage:
    index: int
    #: exchange exec (shuffle stages) or the final plan (result stage); its
    #: subtree may contain ClusterShuffleReadExec leaves for dep stages
    root: PhysicalExec
    is_result: bool
    deps: List[int] = field(default_factory=list)
    shuffle_id: Optional[int] = None
    num_tasks: int = 1
    statuses: List[MapStatus] = field(default_factory=list)
    #: result stage only: the collected batches in partition order
    result_tables: List = field(default_factory=list)
    #: broadcast stages: driver-built, shipped once per executor
    is_broadcast: bool = False
    broadcast_id: Optional[int] = None


def split_stages(final: PhysicalExec) -> Optional[List[_Stage]]:
    """Cut the plan at device shuffle-exchange boundaries. Returns None when
    the plan has exchanges the cluster cannot stage (CPU exchanges), handing
    execution back to the single-process engine."""
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        CpuBroadcastExchangeExec, CpuShuffleExchangeExec, RangePartitioning,
        TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
    stages: List[_Stage] = []

    def walk(node: PhysicalExec, deps: List[int]) -> PhysicalExec:
        if isinstance(node, CpuShuffleExchangeExec):
            raise _Unstageable()
        if isinstance(node, (TpuBroadcastExchangeExec,
                             CpuBroadcastExchangeExec)):
            child_deps: List[int] = []
            new_child = walk(node.children[0], child_deps)
            if any(not stages[d].is_broadcast for d in child_deps):
                # the build side reads dep shuffles: the driver cannot
                # serve executor catalogs, so the exchange stays inline in
                # the parent stage (rebuilt per task)
                deps.extend(child_deps)
                return (node if new_child is node.children[0]
                        else node.with_children([new_child]))
            exchange = (node if new_child is node.children[0]
                        else node.with_children([new_child]))
            idx = len(stages)
            stages.append(_Stage(idx, exchange, is_result=False,
                                 is_broadcast=True, deps=child_deps))
            deps.append(idx)
            return ClusterBroadcastReadExec(idx, exchange.output,
                                            exchange.is_device)
        if isinstance(node, TpuShuffleExchangeExec):
            child_deps = []
            new_child = walk(node.children[0], child_deps)
            exchange = node.with_children([new_child])
            idx = len(stages)
            n_parts = exchange.partitioning.num_partitions
            single_task = isinstance(exchange.partitioning,
                                     RangePartitioning)
            stage = _Stage(idx, exchange, is_result=False, deps=child_deps,
                           num_tasks=(1 if single_task
                                      else max(1, new_child.num_partitions)))
            stages.append(stage)
            deps.append(idx)
            return ClusterShuffleReadExec(idx, exchange.output, n_parts)
        new_kids = [walk(c, deps) for c in node.children]
        if any(a is not b for a, b in zip(new_kids, node.children)):
            return node.with_children(new_kids)
        return node

    class _Unstageable(Exception):
        pass

    try:
        result_deps: List[int] = []
        new_final = walk(final, result_deps)
    except _Unstageable:
        return None
    result = _Stage(len(stages), new_final, is_result=True, deps=result_deps,
                    num_tasks=max(1, new_final.num_partitions))
    stages.append(result)
    return stages


# ------------------------------------------------------------------ tasks
class ClusterBroadcastReadExec(LeafExec):
    """Stand-in for a broadcast exchange on the cluster path: yields the
    driver-built broadcast batch from the executor's BroadcastManager cache
    (built once per executor process, whatever its tasks). The driver
    assigns ``broadcast_id`` before the stage is pickled and ships the
    bytes to every executor before any consuming task runs."""

    num_partitions = 1

    #: the broadcast batch is built by the driver mid-run; its size is a
    #: runtime property of another stage's output
    size_estimate_none_reason = ("broadcast stage output is materialized "
                                 "at run time by the driver")

    def __init__(self, stage_index: int, output: Schema, device: bool):
        super().__init__(output)
        self.stage_index = stage_index
        self.is_device = device
        self.broadcast_id: Optional[int] = None  # driver assigns pre-pickle

    def execute(self, ctx: ExecContext):
        from spark_rapids_tpu_torch.parallel.broadcast import BroadcastManager
        batch = BroadcastManager.get_batch(self.broadcast_id, self.is_device,
                                           ctx.string_max_bytes, ctx.device)
        if not self.is_device and ctx.host_engine:
            from spark_rapids_tpu_torch.execs.cpu_execs import engine_batch
            batch = engine_batch(batch)
        yield batch


@dataclass
class ClusterTaskContext:
    env: ShuffleEnv
    statuses: Dict[int, List[MapStatus]]


@dataclass
class _TaskSpec:
    kind: str                        # "map" | "result"
    plan_blob: bytes                 # pickled stage root
    partitions: Tuple[int, ...]      # partition ids this task runs
    num_source_parts: int
    shuffle_id: Optional[int]
    num_reduce_parts: int
    dep_statuses: Dict[int, List[MapStatus]]
    conf: TpuConf


@dataclass
class _StageLineage:
    """The deterministic replay record of one map stage (Spark's lineage):
    everything needed to re-execute any of the stage's map tasks after its
    outputs are lost. The resolved sub-plan snapshot is an immutable pickle
    (the driver's ``fix`` transform mutates shared tree nodes, so the blob
    is the only stable copy); the plan key is the replay key a re-execution
    is checked against; the source partitions per map id; and the dep
    stages whose live statuses feed the replay (so a replay whose own
    inputs were lost recomputes them first, recursively)."""
    stage_index: int
    plan_blob: bytes
    signature: str
    num_source_parts: int
    num_reduce_parts: int
    dep_stage_indices: Tuple[int, ...]
    #: map_id -> the source partitions its task maps (identity for hash
    #: partitioning; ``{0: (0,)}`` for range: the single task samples and
    #: maps every partition again, as the original run did)
    task_partitions: Dict[int, Tuple[int, ...]]


def _run_task(env: ShuffleEnv, spec: _TaskSpec) -> bytes:
    """Execute one task against this executor's shuffle env, on the env's
    device. Returns pickled [MapStatus...] for map tasks, or pickled
    [(partition id, packed batch)...] for result tasks."""
    import time
    from spark_rapids_tpu_torch.columnar.transfer import download
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    t0 = time.perf_counter()
    root = pickle.loads(spec.plan_blob)
    _count("plan_unpickle_seconds", time.perf_counter() - t0)
    dm = DeviceManager.initialize(spec.conf, env.device)
    cleanups: List = []
    cs = ClusterTaskContext(env, spec.dep_statuses)

    def make_ctx(p: int) -> ExecContext:
        return ExecContext(spec.conf, env.device, p, spec.num_source_parts,
                           dm, cleanups, cluster_shuffle=cs)

    try:
        if spec.kind == "map":
            statuses = [
                _map_one_partition(root, make_ctx(p), p, env,
                                   spec.shuffle_id, spec.num_reduce_parts)
                for p in spec.partitions]
            return pickle.dumps(statuses)
        # result batches keep their partition id, so the driver restores
        # the global partition order (a sorted output depends on it)
        out: List[Tuple[int, bytes]] = []
        for p in spec.partitions:
            for b in root.execute(make_ctx(p)):
                hb = b if isinstance(b, HostBatch) else download(b)
                out.append((p, serialize_batch(hb)))
        return pickle.dumps(out)
    finally:
        for fn in cleanups:
            fn()


def _map_one_partition(exchange, ctx: ExecContext, p: int, env: ShuffleEnv,
                       shuffle_id: int, n_reduce: int) -> MapStatus:
    """The map side of one source partition: the exchange's own map-piece
    protocol (``iter_map_pieces``, shared with the single-process engine),
    cached through the caching writer. A range-partitioned stage runs as
    one task, so it maps every source partition here (the bounds need the
    global sample)."""
    from spark_rapids_tpu_torch.execs.exchange_execs import RangePartitioning
    tracker = MapOutputTracker()  # local; the real one lives on the driver
    tracker.register_shuffle(shuffle_id)
    writer = CachingShuffleWriter(env, tracker, shuffle_id, map_id=p,
                                  num_partitions=n_reduce)
    wanted = (None if isinstance(exchange.partitioning, RangePartitioning)
              else (p,))
    return writer.write(
        (j, sub) for _, j, sub in exchange.iter_map_pieces(ctx, wanted))


# ------------------------------------------------------------------ executors
class InProcessExecutor:
    """One executor inside the driver process: its own shuffle env (stores,
    catalog, transport server) on the session's device; tasks run on the
    scheduler's threads."""

    def __init__(self, executor_id: str, conf: TpuConf, disk_dir: str,
                 device: torch.device):
        self.executor_id = executor_id
        self.env = ShuffleEnv(executor_id, conf, disk_dir=disk_dir,
                              device=device)

    def submit(self, spec: _TaskSpec) -> bytes:
        return _run_task(self.env, spec)

    def alive(self) -> bool:
        """Liveness for recompute scheduling: an executor whose transport
        was killed (chaos kill_peer, a real peer death) serves no tasks and
        is no replay target."""
        t = self.env.transport
        return not (getattr(t, "killed", False) or getattr(t, "_killed",
                                                           False))

    def cleanup_shuffle(self, shuffle_id: int) -> None:
        self.env.shuffle_catalog.remove_shuffle(shuffle_id)

    def cleanup_map_outputs(self, shuffle_id: int, map_id: int) -> None:
        self.env.shuffle_catalog.remove_map_outputs(shuffle_id, map_id)

    def send_broadcast(self, broadcast_id: int, blob: bytes) -> None:
        # in-process executors share the driver's BroadcastManager, which
        # the scheduler already registered: nothing to ship
        pass

    def cleanup_broadcast(self, broadcast_id: int) -> None:
        pass  # the driver-local removal covers the shared registry

    def put_cache(self, table_id: int, generation: int,
                  parts: List[bytes]) -> None:
        pass  # shares the driver's DeviceManager catalog: already there

    def cleanup_cache(self, table_id: int) -> None:
        pass  # CacheManager._free already dropped the shared buffers

    def close(self) -> None:
        self.env.close()


def _send_msg(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj)
    sock.sendall(struct.pack(">I", len(blob)) + blob)


def _recv_msg(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("executor control socket closed")
        hdr += chunk
    n = struct.unpack(">I", hdr)[0]
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("executor control socket closed")
        buf += chunk
    return pickle.loads(bytes(buf))


class ProcessExecutor:
    """One executor in its own OS process: the daemon
    (``parallel/executor_daemon.py``) opens the session's device, builds a
    ShuffleEnv on the TCP transport and serves tasks over a control socket.
    Shuffle data never touches the control plane: it moves between the
    executor processes over the shuffle's own sockets.

    The control protocol is asynchronous: every request carries an id, the
    daemon runs tasks on threads of its own, and a reader thread here routes
    the responses back by id, so several tasks can be in flight per
    executor."""

    def __init__(self, executor_id: str, conf: TpuConf,
                 device: torch.device):
        self.executor_id = executor_id
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        port = listener.getsockname()[1]
        env = dict(os.environ)
        # a daemon first touches pyarrow on two task threads at once (each
        # unpickles a file scan): pyarrow 25's mimalloc pool segfaults on
        # such a start, its system pool does not
        env.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "spark_rapids_tpu_torch.parallel.executor_daemon",
             "--executor-id", executor_id, "--control-port", str(port)],
            env=env)
        try:
            listener.settimeout(_START_TIMEOUT_S)
            self.sock, _ = listener.accept()
        except OSError:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(f"executor {executor_id} did not connect "
                               f"within {_START_TIMEOUT_S} s") from None
        finally:
            listener.close()
        self._send_lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._pending: Dict[int, list] = {}    # id -> [Event, response]
        self._dead = False                     # set when the reader exits
        self._ids = iter(range(1, 1 << 62))
        try:
            self.sock.settimeout(_START_TIMEOUT_S)
            _send_msg(self.sock, {"type": "init", "conf": conf,
                                  "device": str(device)})
            resp = _recv_msg(self.sock)
            self.sock.settimeout(None)
        except (ConnectionError, OSError, EOFError) as e:
            self._stop_process()
            raise RuntimeError(f"executor {executor_id} failed to start: "
                               f"{e}") from None
        if resp.get("type") != "ready":
            self._stop_process()
            raise RuntimeError(f"executor {executor_id} failed to start: "
                               f"{resp}")
        #: the daemon's device, as it opened it
        self.device = resp.get("device")
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"{executor_id}-control-reader")
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                resp = _recv_msg(self.sock)
                with self._pending_lock:
                    slot = self._pending.pop(resp.get("id"), None)
                if slot is not None:
                    slot[1] = resp
                    slot[0].set()
        except (ConnectionError, OSError, EOFError):
            # executor died / socket closed: fail every in-flight request,
            # and every later one (the _dead flag: a send into a
            # half-closed socket can succeed, so a wait would never end)
            with self._pending_lock:
                self._dead = True
                slots = list(self._pending.values())
                self._pending.clear()
            for slot in slots:
                slot[1] = self._lost_response()
                slot[0].set()

    def _lost_response(self) -> dict:
        return {"type": "error",
                "message": f"executor {self.executor_id} connection lost"}

    def _request(self, msg: dict) -> dict:
        rid = next(self._ids)
        slot = [threading.Event(), None]
        with self._pending_lock:
            if self._dead:
                return self._lost_response()
            self._pending[rid] = slot
        try:
            with self._send_lock:
                _send_msg(self.sock, {**msg, "id": rid})
        except (ConnectionError, OSError):
            with self._pending_lock:
                self._pending.pop(rid, None)
            return self._lost_response()
        # a task may run long, so the wait has no deadline of its own; it
        # ends when the daemon answers or its process is gone
        while not slot[0].wait(1.0):
            if self.proc.poll() is not None:
                with self._pending_lock:
                    self._pending.pop(rid, None)
                return self._lost_response()
        return slot[1]

    def submit(self, spec: _TaskSpec) -> bytes:
        resp = self._request({"type": "task", "spec": spec})
        if resp["type"] == "error":
            payload = resp.get("error")
            decoded = (uerr.decode_error(payload) if payload is not None
                       else None)
            if isinstance(decoded, ShuffleFetchFailedError):
                # the daemon's scoped payload survived the control socket
                # through the wire codec (utils/errors.py): the recompute
                # driver keys off executor_id and blocks
                raise ShuffleFetchFailedError(
                    f"task failed on {self.executor_id}: {resp['message']}",
                    executor_id=decoded.executor_id,
                    blocks=decoded.blocks)
            raise RuntimeError(
                f"task failed on {self.executor_id}: {resp['message']}")
        return resp["blob"]

    def alive(self) -> bool:
        """Liveness probe over the control socket: a dead process (reader
        loop exited) or a daemon whose shuffle transport was killed counts
        as gone for recompute scheduling."""
        if self._dead:
            return False
        resp = self._request({"type": "ping"})
        return resp.get("type") == "pong" and not resp.get("killed", False)

    def probe(self, reset_peak: bool = False) -> dict:
        """The daemon's ``ping`` answer: its device, peak device memory
        (reset after reading with ``reset_peak``), fetched shuffle bytes,
        kernel counts and the top-level packages it has loaded."""
        return self._request({"type": "ping", "reset_peak": reset_peak})

    def cleanup_shuffle(self, shuffle_id: int) -> None:
        self._request({"type": "cleanup", "shuffle_id": shuffle_id})

    def cleanup_map_outputs(self, shuffle_id: int, map_id: int) -> None:
        self._request({"type": "cleanup_map", "shuffle_id": shuffle_id,
                       "map_id": map_id})

    def send_broadcast(self, broadcast_id: int, blob: bytes) -> None:
        resp = self._request({"type": "broadcast", "bid": broadcast_id,
                              "blob": blob})
        if resp.get("type") == "error":
            raise RuntimeError(f"broadcast push to {self.executor_id} "
                               f"failed: {resp['message']}")

    def cleanup_broadcast(self, broadcast_id: int) -> None:
        self._request({"type": "cleanup_broadcast", "bid": broadcast_id})

    def put_cache(self, table_id: int, generation: int,
                  parts: List[bytes]) -> None:
        resp = self._request({"type": "cache_put", "tid": table_id,
                              "gen": generation, "parts": parts})
        if resp.get("type") == "error":
            raise RuntimeError(f"cache push to {self.executor_id} failed: "
                               f"{resp['message']}")

    def cleanup_cache(self, table_id: int) -> None:
        self._request({"type": "cache_remove", "tid": table_id})

    def _stop_process(self) -> None:
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def close(self) -> None:
        try:
            with self._send_lock:
                _send_msg(self.sock, {"type": "stop"})
            self.sock.close()
        except OSError:
            pass
        self._stop_process()


def _partition_local(node: PhysicalExec) -> bool:
    """Whether ``node`` works on each input partition alone (its output
    partitions are its input's), so a widened scan under it needs no
    exchange: the projections, filters, fused chains, transitions, unions
    and generators, and the exchanges themselves, which read every source
    partition."""
    from spark_rapids_tpu_torch.execs import cpu_execs as ce
    from spark_rapids_tpu_torch.execs import tpu_execs as te
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        CpuBroadcastExchangeExec, CpuShuffleExchangeExec,
        TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.expand_execs import (CpuExpandExec,
                                                           TpuExpandExec)
    from spark_rapids_tpu_torch.execs.fused_execs import FusedStageExec
    from spark_rapids_tpu_torch.execs.pipeline import PipelinedExec
    return isinstance(node, (
        te.TpuProjectExec, te.TpuFilterExec, te.HostToDeviceExec,
        te.DeviceToHostExec, te.TpuCoalesceBatchesExec, te.TpuUnionExec,
        FusedStageExec, PipelinedExec, TpuExpandExec, ce.CpuProjectExec,
        ce.CpuFilterExec, ce.CpuUnionExec, CpuExpandExec,
        TpuShuffleExchangeExec, CpuShuffleExchangeExec,
        TpuBroadcastExchangeExec, CpuBroadcastExchangeExec))


class _Unpicklable(Exception):
    """A stage subtree cannot ship to executors (e.g. a lambda UDF)."""


# ------------------------------------------------------------------ scheduler
class ClusterScheduler:
    """Stage-by-stage driver (the DAGScheduler role): map stages fan tasks
    across executors and register MapStatus with the driver tracker; the
    result stage's batches return to the caller."""

    def __init__(self, conf: TpuConf, device: torch.device):
        self._owned_dirs: List[str] = []
        self.conf = self._prepare_conf(conf)
        self.n = conf.get(cfg.CLUSTER_EXECUTORS)
        self.device = torch.device(device)
        self._tmp = tempfile.mkdtemp(prefix="spark-rapids-tpu-cluster-")
        self._owned_dirs.append(self._tmp)
        self.executors: List = []
        try:
            if conf.get(cfg.CLUSTER_PROCESS_EXECUTORS):
                self.executors = self._start_daemons()
            else:
                self.executors = [
                    InProcessExecutor(f"exec-{i}", self.conf,
                                      os.path.join(self._tmp, f"exec-{i}"),
                                      self.device)
                    for i in range(self.n)]
        except BaseException:
            self.close()
            raise
        self._next_shuffle = 0
        #: shuffle_id -> replay record, written when a map stage's tasks
        #: are built and read when a reduce-side fetch failure scopes lost
        #: map outputs back to this shuffle
        self._lineage: Dict[int, _StageLineage] = {}
        #: (executor identity, cache table_id) -> shipped generation
        self._shipped_caches: Dict[Tuple[int, int], int] = {}
        atexit.register(self.close)

    def _start_daemons(self) -> List["ProcessExecutor"]:
        """The executor daemons, started side by side (each spends seconds
        importing torch and opening its device); one that fails stops the
        others."""
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(self.n) as pool:
            futures = [pool.submit(ProcessExecutor, f"exec-{i}", self.conf,
                                   self.device) for i in range(self.n)]
            concurrent.futures.wait(futures)
        started = [f.result() for f in futures if f.exception() is None]
        failed = [f.exception() for f in futures if f.exception() is not None]
        if failed:
            for ex in started:
                ex.close()
            raise failed[0]
        return started

    def _prepare_conf(self, conf: TpuConf) -> TpuConf:
        extra = {}
        if conf.get(cfg.CLUSTER_PROCESS_EXECUTORS):
            if not conf.get_raw("spark.rapids.tpu.shuffle.transport.class"):
                extra["spark.rapids.tpu.shuffle.transport.class"] = \
                    _TCP_TRANSPORT
            if not conf.shuffle_tcp_registry:
                reg = tempfile.mkdtemp(prefix="spark-rapids-tpu-registry-")
                self._owned_dirs.append(reg)
                extra["spark.rapids.tpu.shuffle.tcp.registryDir"] = reg
        return conf.with_overrides(extra) if extra else conf

    def _widen_scans(self, plan: PhysicalExec) -> PhysicalExec:
        """File scans default to one scan task; spread multi-file scans
        across the executors (FilePartition planning).

        The plan was made for one scan partition, so an operator that
        needs all its input in one partition (an aggregate, a sort, a
        limit, a join, a window: ``plan/planner.py::ensure_requirements``)
        may sit over the scan with no exchange between. Such an operator
        gets the single-partition exchange over its widened child that
        the planner would have given a partitioned child; the JAX package
        widens under it as it stands, and the operator then runs once per
        scan partition."""
        import copy

        from spark_rapids_tpu_torch.execs.exchange_execs import (
            CpuShuffleExchangeExec, SinglePartitioning,
            TpuShuffleExchangeExec)

        def fix(node: PhysicalExec) -> PhysicalExec:
            kids = [fix(c) for c in node.children]
            files = getattr(node, "files", None)
            if getattr(node, "is_file_scan", False) and files:
                n = min(len(files), 2 * len(self.executors))
                if n > 1 and node.scan_partitions == 1:
                    node = copy.copy(node)
                    node.scan_partitions = n
                return node
            if all(a is b for a, b in zip(kids, node.children)):
                return node
            if not _partition_local(node):
                kids = [k if c.num_partitions > 1 or k.num_partitions <= 1
                        else (TpuShuffleExchangeExec if k.is_device
                              else CpuShuffleExchangeExec)(
                            SinglePartitioning(), k)
                        for k, c in zip(kids, node.children)]
            return node.with_children(kids)
        return fix(plan)

    def run(self, final: PhysicalExec) -> Optional[List[HostBatch]]:
        """Execute the plan across the cluster -> its result batches in
        partition order; None = plan not stageable (the caller falls back
        to the single-process engine)."""
        final = self._widen_scans(final)
        stages = split_stages(final)
        if stages is None:
            return None
        self.last_stages = stages  # introspection for tests and explain
        self._ship_cached_entries(stages)
        shuffle_ids: List[int] = []
        broadcast_ids: List[int] = []
        try:
            for stage in stages:
                if stage.is_broadcast:
                    # the id list tracks the bid the moment it registers, so
                    # a failed executor push still reaches cleanup
                    self._run_broadcast_stage(stage, stages, broadcast_ids)
                    continue
                if not stage.is_result:
                    stage.shuffle_id = self._next_shuffle
                    self._next_shuffle += 1
                    shuffle_ids.append(stage.shuffle_id)
                self._run_stage(stage, stages)
            return stages[-1].result_tables
        except _Unpicklable:
            # an unpicklable plan (e.g. lambda UDFs) cannot ship to
            # executors: fall back to the single-process engine
            return None
        finally:
            from spark_rapids_tpu_torch.parallel.broadcast import \
                BroadcastManager
            for sid in shuffle_ids:
                self._lineage.pop(sid, None)
                for ex in self.executors:
                    try:
                        ex.cleanup_shuffle(sid)
                    except Exception:
                        pass
            for bid in broadcast_ids:
                BroadcastManager.remove(bid)      # driver-local registry
                for ex in self.executors:
                    try:
                        ex.cleanup_broadcast(bid)
                    except Exception:
                        pass

    def _coalesce_stage_reads(self, stage: _Stage, stages: List[_Stage],
                              leaves: List[ClusterShuffleReadExec],
                              root: PhysicalExec) -> None:
        """Adaptive partition coalescing on the cluster path: group
        contiguous small reduce partitions of the stage's dep shuffles into
        single reduce tasks by the observed per-partition MapStatus sizes.
        All read leaves of one stage get the same specs (a co-partitioned
        join's sides stay aligned, and contiguous grouping keeps range
        order)."""
        if not leaves or not self.conf.get(cfg.ADAPTIVE_ENABLED):
            return
        n = leaves[0].num_parts
        if n <= 1 or any(lf.num_parts != n for lf in leaves):
            return
        sizes = [0] * n
        for lf in leaves:
            dep = stages[lf.stage_index]
            if not dep.statuses:
                return
            for st in dep.statuses:
                for j, s in enumerate(st.partition_sizes):
                    sizes[j] += s
        from spark_rapids_tpu_torch.plan.adaptive import coalesce_specs
        specs = coalesce_specs(
            sizes, self.conf.get(cfg.ADAPTIVE_ADVISORY_PARTITION_BYTES))
        if len(specs) >= n:
            return
        for lf in leaves:
            lf.specs = specs
        # a sibling source with more partitions than the coalesced reads
        # (a widened file scan under a union) would make the stage fan past
        # len(specs): coalescing applies only when the reads govern the
        # stage's partitioning
        src = root if stage.is_result else root.children[0]
        if src.num_partitions != len(specs):
            for lf in leaves:
                lf.specs = None

    def _ship_cached_entries(self, stages: List[_Stage]) -> None:
        """df.cache() on the cluster: every cached entry scanned by this
        plan ships once per executor process, by generation, so a
        materialized-again entry ships again and a repeated action does
        not. Executors register the partitions in their own spillable
        catalogs under the BufferIds the scans resolve."""
        from spark_rapids_tpu_torch.execs.cache_execs import (
            CpuCachedScanExec, TpuCachedScanExec)
        entries = {}
        for st in stages:
            for n in st.root.walk():
                if isinstance(n, (TpuCachedScanExec, CpuCachedScanExec)):
                    entries[n.entry.table_id] = n.entry
        for e in entries.values():
            if e.buffer_ids is None:
                raise RuntimeError("cached plan reached the cluster "
                                   "scheduler unmaterialized")
            parts: Optional[List[bytes]] = None   # serialized once, lazily
            for ex in self.executors:
                key = (id(ex), e.table_id)
                if self._shipped_caches.get(key) == e.generation:
                    continue
                if parts is None:
                    parts = self._serialize_cached(e)
                ex.put_cache(e.table_id, e.generation, parts)
                self._shipped_caches[key] = e.generation

    def _serialize_cached(self, e) -> List[bytes]:
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        catalog = DeviceManager.peek().catalog
        parts: List[bytes] = []
        for bid in e.buffer_ids:
            buf = catalog.acquire(bid)
            if buf is None:
                raise RuntimeError(f"cached buffer {bid} vanished while "
                                   "shipping to executors")
            try:
                parts.append(serialize_batch(buf.get_host_batch()))
            finally:
                buf.close()
        return parts

    def cleanup_cache(self, table_id: int) -> None:
        """unpersist(): drop the shipped copies everywhere."""
        for ex in self.executors:
            self._shipped_caches.pop((id(ex), table_id), None)
            try:
                ex.cleanup_cache(table_id)
            except Exception:
                pass

    def _run_broadcast_stage(self, stage: _Stage, stages: List[_Stage],
                             broadcast_ids: List[int]) -> None:
        """Build the broadcast batch once on the driver and ship its packed
        bytes to every executor. Tasks read it through
        ClusterBroadcastReadExec -> BroadcastManager (one unpack per
        executor process, not one per task)."""
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        from spark_rapids_tpu_torch.parallel.broadcast import (
            BROADCAST_IDS, BroadcastManager, capacity_host_batch)

        # nested broadcasts in the build side read the driver-local registry
        root = stage.root.transform_up(lambda n: self._resolve_broadcast(
            n, stages))
        dm = DeviceManager.initialize(self.conf, self.device)
        cleanups: List = []
        ctx = ExecContext(self.conf, self.device, 0, 1, dm, cleanups)
        try:
            batch = next(iter(root.execute(ctx)))
            blob = serialize_batch(batch if isinstance(batch, HostBatch)
                                   else capacity_host_batch(batch))
        finally:
            for fn in cleanups:
                fn()
        stage.broadcast_id = next(BROADCAST_IDS)
        # tracked for cleanup before any push: a failed executor push must
        # not leak the driver entry or the blobs already pushed
        broadcast_ids.append(stage.broadcast_id)
        # driver-local registration first (serves in-process executors and
        # nested driver-side builds), then one push per process executor
        BroadcastManager.put(stage.broadcast_id, blob)
        for ex in self.executors:
            ex.send_broadcast(stage.broadcast_id, blob)

    @staticmethod
    def _resolve_broadcast(node: PhysicalExec,
                           stages: List[_Stage]) -> PhysicalExec:
        if isinstance(node, ClusterBroadcastReadExec):
            node.broadcast_id = stages[node.stage_index].broadcast_id
        return node

    def _run_stage(self, stage: _Stage, stages: List[_Stage]) -> None:
        import time
        from spark_rapids_tpu_torch.execs.exchange_execs import \
            RangePartitioning
        # resolve dep shuffle ids into the read leaves, then pickle
        dep_statuses: Dict[int, List[MapStatus]] = {}
        leaves: List[ClusterShuffleReadExec] = []

        def fix(node: PhysicalExec) -> PhysicalExec:
            if isinstance(node, ClusterShuffleReadExec):
                dep = stages[node.stage_index]
                node.shuffle_id = dep.shuffle_id
                dep_statuses[dep.shuffle_id] = dep.statuses
                leaves.append(node)
            return self._resolve_broadcast(node, stages)

        root = stage.root.transform_up(fix)
        self._coalesce_stage_reads(stage, stages, leaves, root)
        # the task count follows the post-coalesce partitioning (a dep's
        # observed sizes may have shrunk this stage's input partitions)
        if stage.is_result:
            stage.num_tasks = max(1, root.num_partitions)
            num_source = stage.num_tasks
        else:
            num_source = max(1, root.children[0].num_partitions)
            single_task = isinstance(root.partitioning, RangePartitioning)
            stage.num_tasks = 1 if single_task else num_source
        t0 = time.perf_counter()
        try:
            blob = pickle.dumps(root)
        except Exception as e:  # lambda UDFs etc.: back to the local engine
            raise _Unpicklable(str(e)) from e
        _count("plan_pickle_seconds", time.perf_counter() - t0)

        tasks = [_TaskSpec(
            kind="result" if stage.is_result else "map",
            plan_blob=blob, partitions=(p,),
            num_source_parts=num_source,
            shuffle_id=stage.shuffle_id,
            num_reduce_parts=(0 if stage.is_result else
                              stage.root.partitioning.num_partitions),
            dep_statuses=dep_statuses, conf=self.conf)
            for p in range(stage.num_tasks)]

        if not stage.is_result:
            # lineage: the blob is the immutable sub-plan snapshot (fix
            # mutates shared nodes, so pickling again later would drift),
            # and the plan key is the replay key a re-execution is checked
            # against
            from spark_rapids_tpu_torch.serving.program_cache import plan_key
            self._lineage[stage.shuffle_id] = _StageLineage(
                stage_index=stage.index, plan_blob=blob,
                signature=plan_key(root, self.conf),
                num_source_parts=num_source,
                num_reduce_parts=stage.root.partitioning.num_partitions,
                dep_stage_indices=tuple(stage.deps),
                task_partitions={p: t.partitions
                                 for t in tasks for p in t.partitions})

        results = self._run_recomputing(tasks, stages, stage.deps, [0])

        if stage.is_result:
            per_part: List[Tuple[int, bytes]] = []
            for blob_out in results:
                if blob_out:
                    per_part.extend(pickle.loads(blob_out))
            # sorted is stable: a partition's batches keep their order
            stage.result_tables = [
                deserialize_batch(b)
                for _, b in sorted(per_part, key=lambda x: x[0])]
        else:
            statuses: List[MapStatus] = []
            for blob_out in results:
                statuses.extend(pickle.loads(blob_out))
            stage.statuses = statuses

    # -------------------------------------------------------- lineage recompute
    def _executor_alive(self, ex) -> bool:
        try:
            return bool(ex.alive())
        except Exception:
            return False

    @staticmethod
    def _dep_statuses(stages: List[_Stage],
                      dep_indices: Sequence[int]
                      ) -> Dict[int, List[MapStatus]]:
        """Live dep map statuses (broadcast deps have no shuffle): read at
        (re)dispatch time, so a replay sees the replacements a recompute
        round just made."""
        return {stages[d].shuffle_id: stages[d].statuses
                for d in dep_indices if stages[d].shuffle_id is not None}

    # rung 2 of the failure ladder: the lineage-recompute triage loop
    @uerr.triage_boundary
    def _run_recomputing(self, tasks: List[_TaskSpec], stages: List[_Stage],
                         dep_indices: Sequence[int], budget: List[int],
                         exclude: Set[str] = frozenset()
                         ) -> List[Optional[bytes]]:
        """Drive ``tasks`` to completion through the lineage-recompute loop:

        - a task failing because the executor it ran on died is lost work,
          requeued on the survivors (its fetch error, if any, names
          whichever remote it happened to read and must not steer a
          recompute);
        - a ``ShuffleFetchFailedError`` from a live executor is the scoped
          recompute signal: the named peer's lost map tasks run again from
          lineage on surviving executors, dep statuses refresh, and only
          the unfinished tasks are dispatched again;
        - anything else is a real failure and surfaces unchanged.

        ``budget`` is the stage-attempt counter (one mutable cell shared
        with nested replays, so a flapping fault cannot recurse forever);
        past ``shuffle.recompute.maxStageAttempts`` the fetch error
        surfaces."""
        results: List[Optional[bytes]] = [None] * len(tasks)
        work = list(enumerate(tasks))
        while True:
            live = [ex for ex in self.executors if self._executor_alive(ex)]
            targets = ([ex for ex in live if ex.executor_id not in exclude]
                       or live)
            if not targets:
                raise RuntimeError("no live executors remain to run stage "
                                   "tasks")
            errors = self._run_tasks(work, results, targets)
            if not errors:
                return results
            recompute: List[ShuffleFetchFailedError] = []
            only_lost = True
            for ex, e in errors:
                if not self._executor_alive(ex):
                    continue                  # lost work, not a signal
                only_lost = False
                if not isinstance(e, ShuffleFetchFailedError):
                    raise e
                recompute.append(e)
            if not only_lost:
                budget[0] += 1
                max_attempts = self.conf.get(
                    cfg.SHUFFLE_RECOMPUTE_MAX_STAGE_ATTEMPTS)
                if budget[0] > max_attempts:
                    mt.RECOMPUTE_METRICS[
                        mt.SHUFFLE_RECOMPUTE_ESCALATIONS].add(1)
                    raise recompute[0]
                for err in recompute:
                    self._recompute_lost_maps(err, stages, dep_indices,
                                              budget)
            refreshed = self._dep_statuses(stages, dep_indices)
            work = [(i, _dc_replace(tasks[i], dep_statuses=refreshed))
                    for i in range(len(tasks)) if results[i] is None]

    def _recompute_lost_maps(self, err: ShuffleFetchFailedError,
                             stages: List[_Stage],
                             dep_indices: Sequence[int],
                             budget: List[int]) -> None:
        """Scope one fetch failure to the map tasks that must replay. The
        error's blocks are the per-shuffle scope; a dead peer widens it to
        every map id it owned in the dep shuffles, because zero-row blocks
        never register in the catalog (the blocks one reduce partition saw
        can under-count a dead peer's map tasks)."""
        by_shuffle: Dict[int, Set[int]] = {}
        for b in err.blocks:
            by_shuffle.setdefault(b.shuffle_id, set()).add(b.map_id)
        peer = err.executor_id
        peer_ex = next((ex for ex in self.executors
                        if ex.executor_id == peer), None)
        peer_dead = peer_ex is None or not self._executor_alive(peer_ex)
        if peer_dead:
            for d in dep_indices:
                sid = stages[d].shuffle_id
                if sid is None:
                    continue
                owned = {st.map_id for st in stages[d].statuses
                         if st.executor_id == peer}
                if owned:
                    by_shuffle.setdefault(sid, set()).update(owned)
        for sid in sorted(by_shuffle):
            self._replay_map_tasks(sid, sorted(by_shuffle[sid]), {peer},
                                   stages, budget)

    def _replay_map_tasks(self, shuffle_id: int, map_ids: List[int],
                          exclude: Set[str], stages: List[_Stage],
                          budget: List[int]) -> None:
        """Run the lost map tasks of one shuffle again from lineage on
        surviving executors and replace their outputs exactly once: stale
        catalog entries drop first on every live executor (a replay landing
        where the originals still live must not double rows for a later
        reader), then the fresh MapStatus entries replace the lost ones by
        map id in the owning stage's statuses."""
        lin = self._lineage.get(shuffle_id)
        if lin is None:
            raise RuntimeError(
                f"no lineage recorded for shuffle {shuffle_id}; cannot "
                f"recompute map tasks {map_ids}")
        from spark_rapids_tpu_torch.serving.program_cache import plan_key
        root = pickle.loads(lin.plan_blob)
        sig = plan_key(root, self.conf)
        if sig != lin.signature:
            raise RuntimeError(
                f"lineage replay key mismatch for shuffle {shuffle_id}: "
                f"{sig} != {lin.signature}: the replay would not be "
                f"deterministic")
        mt.RECOMPUTE_METRICS[mt.SHUFFLE_RECOMPUTES].add(1)
        mt.RECOMPUTE_METRICS[mt.SHUFFLE_RECOMPUTED_MAP_TASKS].add(
            len(map_ids))
        for ex in self.executors:
            if not self._executor_alive(ex):
                continue
            for m in map_ids:
                try:
                    ex.cleanup_map_outputs(shuffle_id, m)
                except Exception:
                    pass          # best effort: a dying executor's catalog
        specs = [_TaskSpec(
            kind="map", plan_blob=lin.plan_blob,
            partitions=lin.task_partitions[m],
            num_source_parts=lin.num_source_parts,
            shuffle_id=shuffle_id, num_reduce_parts=lin.num_reduce_parts,
            dep_statuses=self._dep_statuses(stages, lin.dep_stage_indices),
            conf=self.conf)
            for m in map_ids]
        # the shared attempt budget rides into the nested run: a replay
        # whose own dep shuffle was lost recomputes it recursively, bounded
        # by the same maxStageAttempts cell
        blobs = self._run_recomputing(specs, stages, lin.dep_stage_indices,
                                      budget, exclude=exclude)
        fresh: List[MapStatus] = []
        for blob in blobs:
            fresh.extend(pickle.loads(blob))
        owner = stages[lin.stage_index]
        replaced = set(map_ids)
        # in place: every dep_statuses dict built earlier references this
        # list object, so readers of the next dispatch see the replacement
        owner.statuses[:] = [st for st in owner.statuses
                             if st.map_id not in replaced] + fresh

    def _run_tasks(self, work: List[Tuple[int, _TaskSpec]],
                   results: List[Optional[bytes]],
                   executors: List) -> List[Tuple[object, Exception]]:
        """Run one round of (index, spec) work items across ``executors``:
        a work queue per executor drained by ``taskSlots`` worker threads,
        so up to executors * taskSlots tasks are in flight. Errors stop the
        round fast (the queued items are abandoned) and return as
        (executor, error) pairs for the recompute loop to triage."""
        import collections
        # tasks pin to executors round robin (an executor's map outputs
        # stay in its own shuffle catalog, so spreading map tasks keeps
        # reduce reads mostly local); each executor drains its queue with
        # `taskSlots` concurrent workers
        n_ex = len(executors)
        queues = [collections.deque() for _ in range(n_ex)]
        for k, item in enumerate(work):
            queues[k % n_ex].append(item)
        qlock = threading.Lock()
        errors: List[Tuple[object, Exception]] = []
        slots = max(1, self.conf.get(cfg.CLUSTER_TASK_SLOTS))

        # the collection point of the recompute triage: every task failure
        # lands in the errors list for _run_recomputing to route
        @uerr.triage_boundary
        def worker(home: int, ex) -> None:
            while not errors:
                with qlock:
                    if not queues[home]:
                        return
                    idx, spec = queues[home].popleft()
                try:
                    results[idx] = ex.submit(spec)
                except Exception as e:       # triaged after join
                    errors.append((ex, e))
                    return

        threads = [threading.Thread(target=worker, args=(i, ex),
                                    name=f"task-slot-{i}-{s}")
                   for i, ex in enumerate(executors)
                   for s in range(min(slots, len(queues[i])))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return errors

    def close(self) -> None:
        import shutil
        for ex in self.executors:
            try:
                ex.close()
            except Exception:
                pass
        self.executors = []
        for d in self._owned_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._owned_dirs = []


def cluster_scheduler_for(session) -> ClusterScheduler:
    """One scheduler (and executor set) per session, made lazily."""
    sched = getattr(session, "_cluster_scheduler", None)
    if sched is None or sched.n != session.conf.get(cfg.CLUSTER_EXECUTORS) \
            or not sched.executors:
        if sched is not None:
            sched.close()
        sched = ClusterScheduler(session.conf, session.device)
        session._cluster_scheduler = sched
    return sched
