"""Transport-agnostic shuffle data plane.

Reference analog: shuffle/RapidsShuffleTransport.scala (659 LoC) — the trait
family the UCX plugin implements: AddressLengthTag memory descriptors,
Connection/ClientConnection/ServerConnection, Transaction lifecycle with stats,
bounce-buffer pools, and the inflight-bytes throttle. Implementations here:
``inprocess.InProcessTransport`` (threads + queues, the multi-executor-per-host
and test transport) — cross-host DCN/gRPC transports plug in through the same
trait, selected by class name via conf ``spark.rapids.tpu.shuffle.transport.class``
(mirroring the reference's spark.rapids.shuffle.transport.class).
"""
from __future__ import annotations

import enum
import importlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


class TransactionStatus(enum.Enum):
    NOT_STARTED = "not_started"
    IN_PROGRESS = "in_progress"
    SUCCESS = "success"
    ERROR = "error"
    CANCELLED = "cancelled"


@dataclass
class TransactionStats:
    """Per-transaction accounting (TransactionStats analog: tx time,
    send/receive sizes, throughput)."""
    tx_time_ms: float = 0.0
    sent_bytes: int = 0
    received_bytes: int = 0

    @property
    def throughput_mb_s(self) -> float:
        if self.tx_time_ms <= 0:
            return 0.0
        return (self.sent_bytes + self.received_bytes) / 1e6 / (self.tx_time_ms / 1e3)


class Transaction:
    """One async transfer: started by a connection op, completed exactly once;
    the completion callback runs on the transport's progress thread
    (UCXTransaction analog — pending-message accounting + status propagation)."""

    def __init__(self, tag: int = 0):
        self.tag = tag
        self.status = TransactionStatus.NOT_STARTED
        self.error_message: Optional[str] = None
        self.response: bytes = b""      # RPC-style requests park the reply here
        self.stats = TransactionStats()
        self._done = threading.Event()
        self._cb: Optional[Callable[["Transaction"], None]] = None
        self._start = time.perf_counter()

    def start(self, cb: Optional[Callable[["Transaction"], None]]) -> "Transaction":
        self._cb = cb
        self.status = TransactionStatus.IN_PROGRESS
        self._start = time.perf_counter()
        return self

    def complete(self, status: TransactionStatus,
                 error: Optional[str] = None) -> None:
        if self._done.is_set():            # exactly-once; late errors are no-ops
            return
        self.stats.tx_time_ms = (time.perf_counter() - self._start) * 1e3
        self.status = status
        self.error_message = error
        self._done.set()
        if self._cb is not None:
            self._cb(self)

    def wait(self, timeout: Optional[float] = None) -> "Transaction":
        if not self._done.wait(timeout):
            raise TimeoutError(f"transaction tag={self.tag:#x} timed out")
        return self


@dataclass
class AddressLengthTag:
    """Memory descriptor for a tag-addressed transfer (AddressLengthTag analog).
    ``buffer`` is host memory (bytearray/memoryview); device buffers are staged
    through bounce buffers before hitting the wire, as in the reference."""
    buffer: bytearray
    length: int
    tag: int

    @staticmethod
    def for_bytes(data: bytes, tag: int) -> "AddressLengthTag":
        return AddressLengthTag(bytearray(data), len(data), tag)


class BounceBuffer:
    """One slab slot. close() returns it to the pool."""

    def __init__(self, manager: "BounceBufferManager", index: int, size: int):
        self._manager = manager
        self.index = index
        self.buffer = bytearray(size)
        self.size = size

    def close(self) -> None:
        self._manager.release(self)


class BounceBufferManager:
    """Pool of N fixed-size staging buffers (BounceBufferManager.scala analog:
    slab + bitset allocation; here a free-list + condition variable). Transfers
    larger than one buffer walk the pool in chunks — bounding memory used by
    any in-flight fetch regardless of batch size."""

    def __init__(self, name: str, buffer_size: int, num_buffers: int):
        self.name = name
        self.buffer_size = buffer_size
        self._free: List[int] = list(range(num_buffers))
        self._all = [BounceBuffer(self, i, buffer_size) for i in range(num_buffers)]
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)

    def acquire(self, count: int = 1, timeout: float = 30.0) -> List[BounceBuffer]:
        deadline = time.monotonic() + timeout
        with self._available:
            while len(self._free) < count:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._available.wait(remaining):
                    raise TimeoutError(
                        f"{self.name}: no bounce buffers after {timeout}s "
                        f"(want {count}, free {len(self._free)})")
            return [self._all[self._free.pop()] for _ in range(count)]

    def try_acquire(self, count: int = 1) -> Optional[List[BounceBuffer]]:
        with self._available:
            if len(self._free) < count:
                return None
            return [self._all[self._free.pop()] for _ in range(count)]

    def release(self, buf: BounceBuffer) -> None:
        with self._available:
            self._free.append(buf.index)
            self._available.notify_all()

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)


class InflightThrottle:
    """Caps bytes in flight for receives (the reference's queuePending /
    doneBytesInFlight flow, conf maxReceiveInflightBytes). Requests queue until
    headroom frees up; FIFO so one huge fetch cannot starve small ones."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._inflight = 0
        self._lock = threading.Lock()
        self._room = threading.Condition(self._lock)
        self._waiters: List[object] = []

    def acquire(self, nbytes: int, timeout: float = 120.0) -> None:
        nbytes = min(nbytes, self.max_bytes)  # oversized requests pass alone
        deadline = time.monotonic() + timeout
        ticket = object()
        with self._room:
            self._waiters.append(ticket)
            try:
                # head-of-line only: later (small) requests cannot overtake an
                # earlier large one and starve it
                while (self._waiters[0] is not ticket
                       or self._inflight + nbytes > self.max_bytes):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._room.wait(remaining):
                        raise TimeoutError("shuffle inflight throttle timed out")
                self._inflight += nbytes
            finally:
                self._waiters.remove(ticket)
                self._room.notify_all()

    def release(self, nbytes: int) -> None:
        nbytes = min(nbytes, self.max_bytes)
        with self._room:
            self._inflight -= nbytes
            self._room.notify_all()

    @property
    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight


# ---------------------------------------------------------------------------------
# connection traits
# ---------------------------------------------------------------------------------

class Connection:
    """Base connection: tag-addressed send/receive of host buffers."""

    def send(self, alt: AddressLengthTag,
             cb: Callable[[Transaction], None]) -> Transaction:
        raise NotImplementedError

    def receive(self, alt: AddressLengthTag,
                cb: Callable[[Transaction], None]) -> Transaction:
        """Post a receive for ``alt.tag``; completes when a matching send lands."""
        raise NotImplementedError


class ClientConnection(Connection):
    """Executor-to-peer connection used by the shuffle client."""

    peer_executor_id: str = "?"

    def request(self, req_type: str, payload: bytes,
                cb: Callable[[Transaction], None]) -> Transaction:
        """RPC-style request (metadata / transfer-start); response bytes land in
        transaction.response."""
        raise NotImplementedError


class ServerConnection(Connection):
    """Server side: registers handlers for incoming requests."""

    def register_request_handler(
            self, req_type: str,
            handler: Callable[[str, bytes], bytes]) -> None:
        """handler(peer_executor_id, payload) -> response bytes."""
        raise NotImplementedError


class ShuffleTransport:
    """Top-level transport (RapidsShuffleTransport trait analog). Owns the
    bounce pools + throttle; creates client connections and the server."""

    def __init__(self, executor_id: str, conf=None):
        from spark_rapids_tpu_torch.config import TpuConf
        from spark_rapids_tpu_torch.utils.metrics import (SHUFFLE_METRIC_NAMES,
                                                    MetricSet)
        self.executor_id = executor_id
        self.conf = conf or TpuConf()
        bb_size = self.conf.shuffle_bounce_buffer_size
        bb_count = self.conf.shuffle_bounce_buffer_count
        self.send_bounce = BounceBufferManager("send", bb_size, bb_count)
        self.recv_bounce = BounceBufferManager("recv", bb_size, bb_count)
        self.throttle = InflightThrottle(self.conf.shuffle_max_inflight_bytes)
        #: fault-tolerance counters, shared with the env/client/reader layers
        self.metrics = MetricSet(*SHUFFLE_METRIC_NAMES)
        self._peer_lost_listeners: List[Callable[[str], None]] = []
        self._listeners_lock = threading.Lock()

    def add_peer_lost_listener(self, fn: Callable[[str], None]) -> None:
        """``fn(peer_executor_id)`` runs when a peer's connection dies —
        the hook ShuffleEnv uses to evict its cached client so the next
        fetch reconnects instead of reusing a dead socket."""
        with self._listeners_lock:
            self._peer_lost_listeners.append(fn)

    def notify_peer_lost(self, peer_executor_id: str) -> None:
        with self._listeners_lock:
            listeners = list(self._peer_lost_listeners)
        for fn in listeners:
            try:
                fn(peer_executor_id)
            except Exception:  # noqa: BLE001 — one listener must not mute the rest
                import traceback
                traceback.print_exc()

    def connect(self, peer_executor_id: str) -> ClientConnection:
        raise NotImplementedError

    @property
    def server(self) -> ServerConnection:
        raise NotImplementedError

    def heartbeat(self) -> None:
        """Refresh this transport's liveness signal (registry-file mtime
        on the TCP transport; no-op for transports without a registry)."""

    def kill(self) -> None:
        """Simulate abrupt process death for chaos testing: drop every
        peer-visible resource WITHOUT the graceful shutdown() cleanup
        (registry retraction stays undone, exactly like SIGKILL)."""
        self.shutdown()

    def shutdown(self) -> None:
        pass


def make_transport(executor_id: str, conf) -> ShuffleTransport:
    """Load the transport by class name (ShimLoader-style dynamic dispatch off
    conf ``spark.rapids.tpu.shuffle.transport.class``)."""
    cls_name = conf.shuffle_transport_class
    mod_name, _, cls = cls_name.rpartition(".")
    mod = importlib.import_module(mod_name)
    return getattr(mod, cls)(executor_id, conf)
