"""In-process shuffle transport: tag-matched rendezvous over threads + queues.

Reference analog: the UCX transport (shuffle-plugin ucx/UCX.scala) — a
tag-matching transport with a progress thread, connection handshake, and
registered memory. Here executors are threads in one process (the local-cluster
/ multi-executor-per-host topology and the test transport): sends and receives
meet in a shared tag table (UCX tag-matching analog); completions run on a
dedicated progress thread per endpoint pair, matching the reference's
single-progress-thread model (UCX.scala:70-112). A cross-host DCN transport
implements the same traits over sockets/gRPC.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                ClientConnection, Connection,
                                                ServerConnection,
                                                ShuffleTransport, Transaction,
                                                TransactionStatus)


class _TagTable:
    """Shared tag-matching table: whichever of (send, receive) arrives second
    copies the payload and completes both transactions on the progress queue."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending_sends: Dict[Tuple[str, int], Tuple[AddressLengthTag, Transaction]] = {}
        self._pending_recvs: Dict[Tuple[str, int], Tuple[AddressLengthTag, Transaction]] = {}
        self._progress: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, name="shuffle-progress",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._progress.get()
            if fn is None:
                return
            fn()

    def _complete_pair(self, salt: Tuple[AddressLengthTag, Transaction],
                       ralt: Tuple[AddressLengthTag, Transaction]):
        (s_alt, s_tx), (r_alt, r_tx) = salt, ralt

        def do():
            n = min(s_alt.length, r_alt.length)
            r_alt.buffer[:n] = s_alt.buffer[:n]
            s_tx.stats.sent_bytes = n
            r_tx.stats.received_bytes = n
            s_tx.complete(TransactionStatus.SUCCESS)
            r_tx.complete(TransactionStatus.SUCCESS)
        self._progress.put(do)

    def send(self, dest: str, alt: AddressLengthTag, tx: Transaction):
        key = (dest, alt.tag)
        with self._lock:
            recv = self._pending_recvs.pop(key, None)
            if recv is None:
                self._pending_sends[key] = (alt, tx)
                return
        self._complete_pair((alt, tx), recv)

    def receive(self, owner: str, alt: AddressLengthTag, tx: Transaction):
        key = (owner, alt.tag)
        with self._lock:
            send = self._pending_sends.pop(key, None)
            if send is None:
                self._pending_recvs[key] = (alt, tx)
                return
        self._complete_pair(send, (alt, tx))

    def shutdown(self):
        self._progress.put(None)


class _Endpoint:
    """One executor's presence in the in-process fabric."""

    def __init__(self, executor_id: str, fabric: "_Fabric"):
        self.executor_id = executor_id
        self.fabric = fabric
        self.handlers: Dict[str, Callable[[str, bytes], bytes]] = {}
        self._rpc_pool = []
        self._rpc_queue: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        for i in range(2):
            t = threading.Thread(target=self._rpc_run,
                                 name=f"shuffle-server-{executor_id}-{i}",
                                 daemon=True)
            t.start()
            self._rpc_pool.append(t)

    def _rpc_run(self):
        while True:
            fn = self._rpc_queue.get()
            if fn is None:
                return
            fn()

    def submit_rpc(self, fn: Callable[[], None]):
        self._rpc_queue.put(fn)

    def shutdown(self):
        for _ in self._rpc_pool:
            self._rpc_queue.put(None)


class _Fabric:
    """Process-wide registry of endpoints + the shared tag table
    (the 'network')."""

    _instance: Optional["_Fabric"] = None
    _ilock = threading.Lock()

    def __init__(self):
        self.endpoints: Dict[str, _Endpoint] = {}
        self.tags = _TagTable()
        self._lock = threading.Lock()
        self._transports: list = []

    @classmethod
    def get(cls) -> "_Fabric":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = _Fabric()
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._ilock:
            if cls._instance is not None:
                cls._instance.tags.shutdown()
                for ep in cls._instance.endpoints.values():
                    ep.shutdown()
            cls._instance = None

    def register(self, executor_id: str) -> _Endpoint:
        with self._lock:
            ep = self.endpoints.get(executor_id)
            if ep is None:
                ep = _Endpoint(executor_id, self)
                self.endpoints[executor_id] = ep
            return ep

    def endpoint(self, executor_id: str) -> _Endpoint:
        with self._lock:
            ep = self.endpoints.get(executor_id)
        if ep is None:
            raise ConnectionError(f"no executor {executor_id!r} on the fabric")
        return ep

    def attach_transport(self, transport: "InProcessTransport") -> None:
        with self._lock:
            self._transports.append(transport)

    def detach_transport(self, transport: "InProcessTransport") -> None:
        with self._lock:
            if transport in self._transports:
                self._transports.remove(transport)

    def kill(self, executor_id: str) -> None:
        """Simulate an executor dying: deregister its endpoint and fire every
        transport's peer-lost listeners (the in-process analog of a TCP
        reader thread hitting a closed socket) — chaos tests use this to
        exercise the evict-and-reconnect path without real sockets."""
        with self._lock:
            ep = self.endpoints.pop(executor_id, None)
            transports = list(self._transports)
        if ep is not None:
            ep.shutdown()
        for t in transports:
            if t.executor_id != executor_id:
                t._drop_client(executor_id)
                t.notify_peer_lost(executor_id)


class InProcessClientConnection(ClientConnection):
    def __init__(self, local: _Endpoint, peer: _Endpoint):
        self._local = local
        self._peer = peer
        self.peer_executor_id = peer.executor_id

    def request(self, req_type: str, payload: bytes,
                cb: Callable[[Transaction], None]) -> Transaction:
        tx = Transaction().start(cb)
        handler = self._peer.handlers.get(req_type)
        if handler is None:
            tx.complete(TransactionStatus.ERROR,
                        f"peer {self.peer_executor_id} has no handler for "
                        f"{req_type!r}")
            return tx
        local_id = self._local.executor_id

        def run():
            try:
                resp = handler(local_id, payload)
            except Exception as e:  # noqa: BLE001 - propagate as transaction error
                tx.response = b""
                tx.complete(TransactionStatus.ERROR, f"{type(e).__name__}: {e}")
                return
            # handler succeeded; a raising completion callback must not
            # re-complete the transaction as a peer error
            tx.response = resp
            tx.stats.received_bytes = len(resp)
            tx.complete(TransactionStatus.SUCCESS)
        self._peer.submit_rpc(run)
        return tx

    def send(self, alt: AddressLengthTag, cb) -> Transaction:
        tx = Transaction(alt.tag).start(cb)
        self._local.fabric.tags.send(self.peer_executor_id, alt, tx)
        return tx

    def receive(self, alt: AddressLengthTag, cb) -> Transaction:
        tx = Transaction(alt.tag).start(cb)
        self._local.fabric.tags.receive(self._local.executor_id, alt, tx)
        return tx


class InProcessServerConnection(ServerConnection):
    def __init__(self, endpoint: _Endpoint):
        self._endpoint = endpoint

    def register_request_handler(self, req_type: str,
                                 handler: Callable[[str, bytes], bytes]) -> None:
        self._endpoint.handlers[req_type] = handler

    def send(self, peer_executor_id: str, alt: AddressLengthTag,
             cb) -> Transaction:
        """Server sends are addressed to the requesting peer's tag space."""
        tx = Transaction(alt.tag).start(cb)
        self._endpoint.fabric.tags.send(peer_executor_id, alt, tx)
        return tx


class InProcessTransport(ShuffleTransport):
    """Default transport (conf spark.rapids.tpu.shuffle.transport.class)."""

    def __init__(self, executor_id: str, conf=None):
        super().__init__(executor_id, conf)
        self._fabric = _Fabric.get()
        self._endpoint = self._fabric.register(executor_id)
        self._fabric.attach_transport(self)
        self._server = InProcessServerConnection(self._endpoint)
        self._clients: Dict[str, InProcessClientConnection] = {}
        self._lock = threading.Lock()

    def connect(self, peer_executor_id: str) -> InProcessClientConnection:
        with self._lock:
            conn = self._clients.get(peer_executor_id)
            if conn is None:
                conn = InProcessClientConnection(
                    self._endpoint, _Fabric.get().endpoint(peer_executor_id))
                self._clients[peer_executor_id] = conn
            return conn

    def _drop_client(self, peer_executor_id: str) -> None:
        with self._lock:
            self._clients.pop(peer_executor_id, None)

    @property
    def server(self) -> InProcessServerConnection:
        return self._server

    def shutdown(self) -> None:
        # detach so kill() stops notifying this transport and the fabric
        # singleton doesn't pin its bounce pools forever; the ENDPOINT stays
        # registered (peers may still hold live connections to it — the
        # multi-executor-per-host topology shares one fabric for the
        # process lifetime)
        self._fabric.detach_transport(self)
