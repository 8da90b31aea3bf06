"""Shuffle manager: caching writer/reader + map-output tracking + task iterator.

The JAX package's ``shuffle/manager.py``, after these of the reference:
- RapidsShuffleInternalManagerBase (RapidsShuffleInternalManager.scala:194) —
  registerShuffle → GpuShuffleHandle, getWriter → RapidsCachingWriter,
  getReader → RapidsCachingReader;
- RapidsCachingWriter (same file :73-160) — per-partition batches into the
  device store + ShuffleBufferCatalog, metadata-only MapStatus;
- RapidsCachingReader.scala — local blocks from the catalog, remote via the
  transport client;
- RapidsShuffleIterator.scala:46 — task-facing blocking iterator resolving
  block locations from the MapOutputTracker, semaphore acquire on materialize,
  fetch-failure surfacing;
- GpuShuffleEnv.scala:52-70 — wiring stores/catalogs/transport per executor.

Data stays cached ON DEVICE between map and reduce (spilling host→disk under
pressure); Spark's control plane is replaced by the in-process MapOutputTracker.
Each ``ShuffleEnv`` belongs to one device (the session's): a remote block
arrives as one packed host buffer and goes up to it in one copy.
"""
from __future__ import annotations

import queue
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from spark_rapids_tpu_torch import device as device_mod
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.memory.store import BufferCatalog, build_store_chain
from spark_rapids_tpu_torch.shuffle.catalog import (ReceivedBufferCatalog,
                                              ShuffleBlockId,
                                              ShuffleBufferCatalog)
from spark_rapids_tpu_torch.shuffle.client import ShuffleClient, ShuffleFetchHandler
from spark_rapids_tpu_torch.shuffle.server import ShuffleServer
from spark_rapids_tpu_torch.shuffle.table_meta import (DevicePackLayout,
                                                       batch_string_max,
                                                       layout_to_meta,
                                                       uniform_string_batch,
                                                       upload_packed)
from spark_rapids_tpu_torch.shuffle.transport import make_transport


class ShuffleFetchFailedError(RuntimeError):
    """RapidsShuffleFetchFailedException analog — callers re-run the map stage
    (Spark's lineage recompute is the recovery story, SURVEY.md §5).

    Raised only after the reader's own retries (reconnect + re-fetch under
    spark.rapids.tpu.shuffle.maxRetries) are exhausted. ``executor_id`` and
    ``blocks`` scope the failure so callers can recompute only the affected
    map outputs instead of the whole stage."""

    def __init__(self, message: str, executor_id: Optional[str] = None,
                 blocks: Tuple[ShuffleBlockId, ...] = ()):
        super().__init__(message)
        self.executor_id = executor_id
        self.blocks = tuple(blocks)


@dataclass(frozen=True)
class MapStatus:
    """Metadata-only map-completion record (sizes, no data — the data stays
    cached on the mapper's device)."""
    executor_id: str
    map_id: int
    partition_sizes: Tuple[int, ...]


class MapOutputTracker:
    """Driver-side registry of map outputs (org.apache.spark.MapOutputTracker
    stand-in for the in-process cluster)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shuffles: Dict[int, Dict[int, MapStatus]] = {}

    def register_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.setdefault(shuffle_id, {})

    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None:
        with self._lock:
            self._shuffles[shuffle_id][status.map_id] = status

    def blocks_by_executor(self, shuffle_id: int, partition_id: int
                           ) -> Dict[str, List[ShuffleBlockId]]:
        """Non-empty blocks of one reduce partition, grouped by executor."""
        with self._lock:
            statuses = list(self._shuffles.get(shuffle_id, {}).values())
        out: Dict[str, List[ShuffleBlockId]] = {}
        for st in statuses:
            if st.partition_sizes[partition_id] > 0:
                out.setdefault(st.executor_id, []).append(
                    ShuffleBlockId(shuffle_id, st.map_id, partition_id))
        return out

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)


class ShuffleEnv:
    """Per-executor shuffle wiring (GpuShuffleEnv analog): tiered stores,
    shuffle catalog, transport + server, client cache. ``device`` is where
    the executor's batches live (the GPU unless the caller passes
    ``"cpu"``)."""

    def __init__(self, executor_id: str, conf: Optional[TpuConf] = None,
                 device_budget: int = 1 << 30, host_budget: int = 1 << 30,
                 disk_dir: Optional[str] = None,
                 device: device_mod.DeviceLike = None):
        self.executor_id = executor_id
        self.conf = conf or TpuConf()
        self.device = device_mod.resolve(device)
        self.buffer_catalog = BufferCatalog()
        self.device_store, self.host_store, self.disk_store = build_store_chain(
            self.buffer_catalog, device_budget, host_budget, disk_dir)
        self.shuffle_catalog = ShuffleBufferCatalog(self.buffer_catalog,
                                                    self.device_store)
        self.received_catalog = ReceivedBufferCatalog()
        self.transport = make_transport(executor_id, self.conf)
        self.server = ShuffleServer(self.transport, self.shuffle_catalog,
                                    self.conf.shuffle_codec)
        self.metrics = self.transport.metrics
        self._clients: Dict[str, ShuffleClient] = {}
        self._lock = threading.Lock()
        self._connect_locks: Dict[str, threading.Lock] = {}
        # a dead peer's cached client holds a dead connection; evicting it
        # here makes the next client_for() reconnect instead of failing
        # every future fetch against a corpse socket
        self.transport.add_peer_lost_listener(self.invalidate_client)

    def client_for(self, peer_executor_id: str) -> ShuffleClient:
        # connect() blocks (TCP handshake + registry polling, up to 30 s):
        # holding the client-table lock across it would serialize every
        # fetch in the process behind the slowest peer. A per-peer connect
        # lock serializes only callers of the SAME unconnected peer, so no
        # duplicate connection is ever created (a dropped loser would leak
        # its socket + reader thread and desync the transport peer table).
        with self._lock:
            c = self._clients.get(peer_executor_id)
            if c is not None:
                return c
            plock = self._connect_locks.setdefault(peer_executor_id,
                                                   threading.Lock())
        with plock:
            with self._lock:
                c = self._clients.get(peer_executor_id)
                if c is not None:
                    return c
            # justified block-under-lock: plock guards one peer's connect
            # only; other peers never contend  # tpu-lint: disable=R006
            conn = self.transport.connect(peer_executor_id)
            c = ShuffleClient(self.transport, conn, self.received_catalog,
                              self.conf.shuffle_codec)
            with self._lock:
                self._clients[peer_executor_id] = c
            return c

    def invalidate_client(self, peer_executor_id: str) -> None:
        """Drop the cached client for a peer whose connection died
        (peer-lost listener target), so the next client_for() reconnects.
        The per-peer connect LOCK is kept: replacing it while an in-flight
        connect holds the old one would let a second caller dial a
        duplicate connection (leaked socket + reader thread, desynced peer
        table); the lock is tiny and reusable across reconnects. Safe to
        call for unknown peers."""
        from spark_rapids_tpu_torch.utils import metrics as mt
        with self._lock:
            evicted = self._clients.pop(peer_executor_id, None)
        if evicted is not None:
            self.metrics[mt.SHUFFLE_PEER_EVICTIONS].add(1)

    def close(self) -> None:
        self.transport.shutdown()
        self.device_store.close()
        self.host_store.close()
        self.disk_store.close()


class CachingShuffleWriter:
    """Map-side writer: cache each partition's device batch + register meta
    (RapidsCachingWriter analog)."""

    def __init__(self, env: ShuffleEnv, tracker: MapOutputTracker,
                 shuffle_id: int, map_id: int, num_partitions: int):
        self.env = env
        self.tracker = tracker
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions

    def write(self, partitions: Iterable[Tuple[int, object]]) -> MapStatus:
        """``partitions`` yields (partition_id, DeviceBatch). Batches with zero
        rows are recorded as empty (DegenerateRapidsBuffer analog: size 0)."""
        sizes = [0] * self.num_partitions
        for pid, batch in partitions:
            if batch.num_rows == 0:
                continue
            batch = uniform_string_batch(batch)
            layout = DevicePackLayout.for_batch_shape(
                batch.schema, batch.capacity, batch_string_max(batch))
            meta = layout_to_meta(layout, batch.num_rows)
            block = ShuffleBlockId(self.shuffle_id, self.map_id, pid)
            self.env.shuffle_catalog.add_batch(block, batch, meta)
            sizes[pid] += meta.packed_size
        status = MapStatus(self.env.executor_id, self.map_id, tuple(sizes))
        self.tracker.register_map_output(self.shuffle_id, status)
        return status


class _QueueHandler(ShuffleFetchHandler):
    """Bridges async client callbacks into the iterator's blocking queue."""

    def __init__(self, q: "queue.Queue", peer: str):
        self.q = q
        self.peer = peer

    def start(self, expected_tables: int, tables=()) -> None:
        self.q.put(("start", self.peer, tuple(tables)))

    def batch_received(self, received_id: int, block=None,
                       table_idx: int = 0) -> None:
        self.q.put(("batch", self.peer, (received_id, block, table_idx)))

    def transfer_error(self, message: str, failed_blocks=(),
                       permanent: bool = False) -> None:
        self.q.put(("error", self.peer,
                    (message, tuple(failed_blocks), permanent)))


class _PeerFetch:
    """One peer's fetch-in-progress: the blocks still owed, the tables the
    current attempt will deliver (None until its metadata lands), and how
    many attempts were spent."""

    def __init__(self, blocks):
        self.blocks = list(blocks)
        self.needed = None    # set[(block, table_idx)] of the current attempt
        self.attempts = 0

    def done(self, delivered) -> bool:
        return self.needed is not None and self.needed <= delivered


class CachingShuffleReader:
    """Reduce-side reader (RapidsCachingReader + RapidsShuffleIterator analog):
    local blocks come straight off the catalog (device tier → zero-copy), remote
    blocks are fetched via the transport client, uploaded on arrival.

    Failure handling: when a peer's fetch errors (connection drop, repeated
    corruption, handler failure beyond the client's own retries), the reader
    retries THAT peer — reconnecting through client_for (the dead client was
    evicted by the peer-lost listener) and re-fetching only the blocks the
    error reported undelivered. Tables are deduplicated by (block, table_idx),
    so a retry racing a late delivery (or a duplicated frame) never yields a
    row twice. Only after maxRetries per peer (or immediately for permanent
    failures — lost blocks that only a map recompute brings back) does
    ShuffleFetchFailedError surface, scoped to the failing executor +
    blocks. The fetch timeout is one overall WAIT budget across the whole
    drain — a trickling-but-stuck fetch cannot reset it per event."""

    def __init__(self, env: ShuffleEnv, tracker: MapOutputTracker,
                 shuffle_id: int, partition_id: int, semaphore=None,
                 timeout: Optional[float] = None):
        from spark_rapids_tpu_torch import config as _cfg
        self.env = env
        self.tracker = tracker
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        self.semaphore = semaphore
        self.timeout = (timeout if timeout is not None
                        else float(env.conf.get(_cfg.SHUFFLE_FETCH_TIMEOUT)))
        self.max_retries = env.conf.shuffle_max_retries
        self.backoff_ms = env.conf.shuffle_retry_backoff_ms
        self.retry_seed = env.conf.shuffle_faults_seed

    def read(self):
        """Yields DeviceBatch for this reduce partition."""
        import time as _time

        from spark_rapids_tpu_torch.shuffle import retry as _retry
        from spark_rapids_tpu_torch.utils import metrics as mt
        by_exec = self.tracker.blocks_by_executor(self.shuffle_id,
                                                  self.partition_id)
        local_blocks = by_exec.pop(self.env.executor_id, [])

        # kick off remote fetches first (overlap with local materialization)
        q: "queue.Queue" = queue.Queue()
        peers: Dict[str, _PeerFetch] = {}
        for peer, blocks in by_exec.items():
            peers[peer] = _PeerFetch(blocks)
            self._start_fetch(q, peer, blocks)

        # SCOPED hold (R008 fix): the old bare acquire_if_necessary never
        # released, so a reader driven outside a task's held() scope pinned
        # a device permit for the thread's lifetime. held() nests when the
        # owning task already holds (the normal exec path) and releases at
        # generator close when this reader was the first acquirer.
        hold = (self.semaphore.held() if self.semaphore is not None
                else nullcontext())
        with hold:
            for block in local_blocks:
                # acquire_buffers retains EVERY buffer of the block upfront;
                # an early generator close (LIMIT downstream) must release
                # the not-yet-yielded tail, not just the buffer in hand
                acquired = self.env.shuffle_catalog.acquire_buffers(block)
                try:
                    while acquired:
                        buf, _meta = acquired.pop(0)
                        try:
                            yield buf.get_batch()
                        finally:
                            buf.close()
                finally:
                    for buf, _meta in acquired:
                        buf.close()

            # drain remote results under ONE overall WAIT budget: the
            # timeout counts only time this reader spends blocked on the
            # fetch (queue waits + retry backoffs), never the consumer's
            # compute between yields — a slow join downstream must not fake
            # a fetch failure, while a trickling-but-stuck fetch still
            # exhausts the budget
            wait_budget = self.timeout
            delivered: set = set()  # (block, table_idx) pairs yielded already
            while not all(st.done(delivered) for st in peers.values()):
                if wait_budget <= 0:
                    self._raise_timeout(peers, delivered)
                t0 = _time.monotonic()
                try:
                    kind, peer, value = q.get(timeout=wait_budget)
                except queue.Empty:
                    self._raise_timeout(peers, delivered)
                finally:
                    wait_budget -= _time.monotonic() - t0
                st = peers[peer]
                if kind == "start":
                    st.needed = set(value)
                elif kind == "error":
                    message, failed_blocks, permanent = value
                    st.attempts += 1
                    if permanent or st.attempts > self.max_retries:
                        raise ShuffleFetchFailedError(
                            f"fetch from {peer} failed after {st.attempts} "
                            f"attempts: {message}", executor_id=peer,
                            blocks=tuple(failed_blocks) or tuple(st.blocks))
                    self.env.metrics[mt.SHUFFLE_FETCH_RETRIES].add(1)
                    # bounded pause, then re-fetch only the undelivered
                    # blocks on a fresh client (the dead one was evicted on
                    # peer loss)
                    pause = min(
                        _retry.backoff_ms(st.attempts - 1, self.backoff_ms,
                                          self.retry_seed,
                                          key=f"read:{peer}") / 1e3,
                        max(wait_budget, 0))
                    _time.sleep(pause)
                    wait_budget -= pause
                    if failed_blocks:
                        st.blocks = list(failed_blocks)
                    st.needed = None
                    self._start_fetch(q, peer, st.blocks)
                else:
                    rid, block, table_idx = value
                    raw, meta = self.env.received_catalog.take(rid)
                    if (block, table_idx) in delivered:
                        continue    # duplicate from a retried/duped transfer
                    delivered.add((block, table_idx))
                    yield upload_packed(raw, meta, self.env.device)

    def _start_fetch(self, q: "queue.Queue", peer: str, blocks) -> None:
        """Kick off (or re-kick after an error) one peer's fetch. A connect
        failure — client_for dialing a dead peer past ITS retries — is not
        an unscoped crash: it queues as an error event, so it consumes a
        reader-level attempt like any other transient and surfaces as a
        scoped ShuffleFetchFailedError once those run out."""
        try:
            client = self.env.client_for(peer)
        except (ConnectionError, OSError) as e:
            q.put(("error", peer,
                   (f"connect failed: {e}", tuple(blocks), False)))
            return
        client.fetch(blocks, _QueueHandler(q, peer))

    def _raise_timeout(self, peers: Dict[str, "_PeerFetch"],
                       delivered: set) -> None:
        stuck = {p: [b for b in st.blocks
                     if st.needed is None
                     or any(k not in delivered for k in st.needed
                            if k[0] == b)]
                 for p, st in peers.items() if not st.done(delivered)}
        peer = next(iter(stuck), None)
        raise ShuffleFetchFailedError(
            f"shuffle {self.shuffle_id} partition {self.partition_id}: "
            f"timed out after {self.timeout}s waiting for remote blocks "
            f"from {sorted(stuck)}", executor_id=peer,
            blocks=tuple(stuck.get(peer, ())))


class ShuffleManager:
    """Driver-facing registry (RapidsShuffleInternalManagerBase analog)."""

    def __init__(self, tracker: Optional[MapOutputTracker] = None):
        self.tracker = tracker or MapOutputTracker()
        self._next_shuffle = 0
        self._lock = threading.Lock()

    def register_shuffle(self, num_partitions: int) -> Tuple[int, int]:
        with self._lock:
            sid = self._next_shuffle
            self._next_shuffle += 1
        self.tracker.register_shuffle(sid)
        return sid, num_partitions

    def get_writer(self, env: ShuffleEnv, shuffle_id: int, map_id: int,
                   num_partitions: int) -> CachingShuffleWriter:
        return CachingShuffleWriter(env, self.tracker, shuffle_id, map_id,
                                    num_partitions)

    def get_reader(self, env: ShuffleEnv, shuffle_id: int, partition_id: int,
                   semaphore=None) -> CachingShuffleReader:
        return CachingShuffleReader(env, self.tracker, shuffle_id,
                                    partition_id, semaphore)

    def unregister_shuffle(self, shuffle_id: int,
                           envs: Iterable[ShuffleEnv] = ()) -> None:
        self.tracker.unregister_shuffle(shuffle_id)
        for env in envs:
            env.shuffle_catalog.remove_shuffle(shuffle_id)
