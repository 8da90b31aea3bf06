"""Cross-host TCP shuffle transport.

Reference analog: the UCX transport (shuffle-plugin ucx/UCX.scala:53) — a
management-port handshake (UCX.scala:113 startManagementPort), a dedicated
progress thread per connection draining completions, and tag-addressed
transfers. This is the DCN-path equivalent over plain sockets: executors in
DIFFERENT PROCESSES (or hosts) exchange shuffle buffers through framed
messages; the in-process transport remains the intra-host fast path, exactly
as the reference keeps host-local optimizations next to UCX.

Wire format (all big-endian):
  frame   := kind(1) tag(8) length(4) payload[length]
  kinds   := H (hello: payload = executor id)
             Q (request: payload = type_len(2) type body; tag = request id)
             P (response: payload = status(1) body; tag = request id)
             D (data: tag-addressed buffer)

Peer discovery uses a registry directory (the management rendezvous): every
transport writes ``<registry>/<executor_id>`` containing ``host:port``;
connect() polls the peer's file. On a cluster this directory is shared
storage or is replaced by the control plane's executor registry.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.shuffle.retry import backoff_ms
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                ClientConnection,
                                                ServerConnection,
                                                ShuffleTransport, Transaction,
                                                TransactionStatus)
from spark_rapids_tpu_torch.utils import metrics as mt

_HDR = struct.Struct(">cQI")


def scan_registry(registry_dir: str,
                  stale_after_s: Optional[float] = None
                  ) -> Dict[str, str]:
    """Scan a registry directory: ``{executor_id: "host:port"}`` of every
    published entry. With ``stale_after_s``, entries whose heartbeat mtime
    is older than the window are SKIPPED and garbage-collected — a
    SIGKILL'd process cannot retract its own file (``shutdown`` never
    ran), so without the GC dead entries would be handed out forever.
    Unlinks race benignly: losing the race to another scanner (or to the
    owner re-publishing) is a no-op."""
    out: Dict[str, str] = {}
    try:
        names = os.listdir(registry_dir)
    except FileNotFoundError:
        return out      # nothing published yet: a genuinely empty fleet
    # any OTHER listdir failure propagates: a transient EACCES/ESTALE on
    # a network FS must read as "registry unreadable right now", never as
    # "every replica is dead" — callers keep their previous view
    now = time.time()
    for name in names:
        if name.endswith(".tmp"):       # half-written publication
            continue
        path = os.path.join(registry_dir, name)
        try:
            if (stale_after_s is not None
                    and now - os.path.getmtime(path) > stale_after_s):
                os.unlink(path)         # dead: heartbeat stopped
                continue
            with open(path) as f:
                addr = f.read().strip()
        except OSError:
            continue
        if ":" in addr:
            out[name] = addr
    return out


def _send_frame(sock: socket.socket, lock: threading.Lock, kind: bytes,
                tag: int, payload: bytes) -> None:
    # justified per-socket writer lock: frames must hit the stream whole
    # (interleaved sendall calls would corrupt the wire format), and the
    # lock covers exactly one socket — contention is bounded to writers of
    # that peer, never the transport's shared state.
    with lock:
        sock.sendall(_HDR.pack(kind, tag, len(payload)) + payload)  # tpu-lint: disable=R006


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class _Peer:
    """One live socket + its writer lock and reader (progress) thread."""

    def __init__(self, transport: "TcpTransport", sock: socket.socket,
                 peer_id: str = "?"):
        self.transport = transport
        self.sock = sock
        self.peer_id = peer_id
        self.wlock = threading.Lock()
        self.reader = threading.Thread(target=self._read_loop,
                                       name=f"tcp-shuffle-reader-{peer_id}",
                                       daemon=True)
        self.reader.start()

    def _read_loop(self) -> None:
        t = self.transport
        try:
            while True:
                hdr = _recv_exact(self.sock, _HDR.size)
                if hdr is None:
                    break
                kind, tag, length = _HDR.unpack(hdr)
                payload = _recv_exact(self.sock, length) if length else b""
                if payload is None and length:
                    break
                if kind == b"H":
                    self.peer_id = payload.decode()
                    t._register_peer(self.peer_id, self)
                elif kind == b"D":
                    t._on_data(tag, payload)
                elif kind == b"P":
                    t._on_response(tag, payload)
                elif kind == b"Q":
                    t._on_request(self, tag, payload)
        except Exception as e:  # noqa: BLE001 - fail pending work, not hang
            t._peer_lost(self, f"{type(e).__name__}: {e}")
            return
        t._peer_lost(self, "connection closed")

    def close(self) -> None:
        # SHUT_RDWR first: a bare close() is deferred by CPython while the
        # reader thread is blocked in recv — no FIN goes out and neither
        # side's reader ever wakes; shutdown() interrupts the recv and
        # notifies the remote immediately
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class TcpClientConnection(ClientConnection):
    def __init__(self, transport: "TcpTransport", peer: _Peer):
        self._t = transport
        self._peer = peer
        self.peer_executor_id = peer.peer_id

    def request(self, req_type: str, payload: bytes,
                cb: Callable[[Transaction], None]) -> Transaction:
        tx = Transaction().start(cb)
        rid = self._t._register_rpc(tx, self._peer)
        body = (struct.pack(">H", len(req_type)) + req_type.encode()
                + payload)
        try:
            _send_frame(self._peer.sock, self._peer.wlock, b"Q", rid, body)
        except OSError as e:
            self._t._drop_rpc(rid)
            tx.complete(TransactionStatus.ERROR, f"send failed: {e}")
        return tx

    def send(self, alt: AddressLengthTag, cb) -> Transaction:
        return self._t._async_send(self._peer, alt, cb)

    def receive(self, alt: AddressLengthTag, cb) -> Transaction:
        tx = Transaction(alt.tag).start(cb)
        self._t._post_receive(alt, tx, self._peer)
        return tx

    def cancel_receive(self, tag: int) -> None:
        """Abandon a posted receive: a timed-out fetch that retries with a
        fresh tag must not pin its frame-sized buffer in the pending table
        (or let a late retransmit scribble an abandoned buffer) for the
        connection's lifetime."""
        self._t._cancel_receive(tag)


class TcpServerConnection(ServerConnection):
    def __init__(self, transport: "TcpTransport"):
        self._t = transport

    def register_request_handler(self, req_type: str,
                                 handler: Callable[[str, bytes], bytes]
                                 ) -> None:
        self._t._handlers[req_type] = handler

    def send(self, peer_executor_id: str, alt: AddressLengthTag,
             cb) -> Transaction:
        """Server-initiated data ride the SAME socket the peer opened (the
        reference's server sends to the client's tag space)."""
        peer = self._t._peer_by_id(peer_executor_id)
        if peer is None:
            tx = Transaction(alt.tag).start(cb)
            self._t._progress_put(lambda: tx.complete(
                TransactionStatus.ERROR,
                f"no connection from {peer_executor_id!r}"))
            return tx
        return self._t._async_send(peer, alt, cb)


class TcpTransport(ShuffleTransport):
    """conf spark.rapids.tpu.shuffle.transport.class =
    spark_rapids_tpu_torch.shuffle.tcp.TcpTransport"""

    def __init__(self, executor_id: str, conf=None):
        super().__init__(executor_id, conf)
        self._handlers: Dict[str, Callable[[str, bytes], bytes]] = {}
        # pending tables track the OWNING peer per transaction, so a lost
        # peer fails only its own transactions (scoped failure domains).
        # _rpc_lock guards the rpc table AND the id counter: caller
        # threads insert while reader threads pop completions and the
        # peer-lost sweep iterates (R012)
        self._pending_rpcs: Dict[int, Tuple[Transaction, "_Peer"]] = {}
        self._rpc_id = 0
        self._rpc_lock = threading.Lock()
        self._tag_lock = threading.Lock()
        self._pending_recvs: Dict[
            int, Tuple[AddressLengthTag, Transaction, "_Peer"]] = {}
        self._early_data: Dict[int, bytes] = {}
        # _peers_lock guards the peer table: reader threads register on
        # hello, the accept loop creates, connect() callers register,
        # peer-lost evicts with a check-then-act that must be atomic
        # (a NEWER peer registered between the check and the pop must
        # survive the old reader's eviction) — R012
        self._peers: Dict[str, _Peer] = {}
        self._peers_lock = threading.Lock()
        self._clients: Dict[str, TcpClientConnection] = {}
        self._clients_lock = threading.Lock()
        self._server_conn = TcpServerConnection(self)
        # init-before-spawn (R012): every attribute the worker/progress/
        # accept/heartbeat threads read exists BEFORE the first spawn
        self._killed = False
        self._registry = self.conf.shuffle_tcp_registry
        # worker pool for request handlers (the server copy-executor role);
        # sized by conf: the shuffle data plane needs few, the serving wire
        # protocol raises it so bounded-poll serve.next handlers from many
        # clients do not head-of-line-block each other
        import queue as _q
        from spark_rapids_tpu_torch import config as _cfg
        self._num_workers = self.conf.get(_cfg.SHUFFLE_TCP_WORKER_THREADS)
        self._work: "_q.Queue[Optional[Callable[[], None]]]" = _q.Queue()
        for i in range(self._num_workers):
            threading.Thread(target=self._work_loop, daemon=True,
                             name=f"tcp-shuffle-server-{executor_id}-{i}"
                             ).start()
        # progress thread: ALL send completions run here, never inline on the
        # caller (the reference's single-progress-thread contract — callers
        # hold their own state locks when issuing sends, UCX.scala:70-112)
        self._progress: "_q.Queue[Optional[Callable[[], None]]]" = _q.Queue()
        threading.Thread(target=self._progress_loop, daemon=True,
                         name=f"tcp-shuffle-progress-{executor_id}").start()
        # management port: listen + registry publication (UCX.scala:113)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", self.conf.shuffle_tcp_port))
        self._listener.listen(16)
        self.address = self._listener.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"tcp-shuffle-accept-{executor_id}").start()
        if self._registry:
            os.makedirs(self._registry, exist_ok=True)
            self._publish_registry()

    def _publish_registry(self) -> None:
        path = os.path.join(self._registry, self.executor_id)
        with open(path + ".tmp", "w") as f:
            f.write(f"{self.address[0]}:{self.address[1]}")
        os.replace(path + ".tmp", path)

    # ---- plumbing ----------------------------------------------------------
    def _progress_loop(self) -> None:
        while True:
            fn = self._progress.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — completions must keep flowing
                import traceback
                traceback.print_exc()

    def _progress_put(self, fn: Callable[[], None]) -> None:
        self._progress.put(fn)

    def _async_send(self, peer: _Peer, alt: AddressLengthTag,
                    cb) -> Transaction:
        tx = Transaction(alt.tag).start(cb)
        data = bytes(alt.buffer[:alt.length])

        def run():
            try:
                _send_frame(peer.sock, peer.wlock, b"D", alt.tag, data)
                tx.stats.sent_bytes = len(data)
                tx.complete(TransactionStatus.SUCCESS)
            except OSError as e:
                tx.complete(TransactionStatus.ERROR, f"send failed: {e}")
        self._progress_put(run)
        return tx

    def _work_loop(self) -> None:
        while True:
            fn = self._work.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a handler error must not
                import traceback  # kill the worker (peers would hang)
                traceback.print_exc()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _Peer(self, sock)

    def _register_peer(self, peer_id: str, peer: _Peer) -> None:
        with self._peers_lock:
            self._peers[peer_id] = peer

    def _peer_lost(self, peer: _Peer, reason: str) -> None:
        """A reader exited: every pending transaction OWNED BY THAT PEER
        fails NOW (a silent hang until the fetch timeout is strictly worse
        than an error — the error drives the reader's reconnect-and-retry,
        then ShuffleFetchFailedError and the stage retry). Transactions of
        healthy peers are untouched: one lost executor must not fail
        fetches that were never routed through it."""
        with self._tag_lock:
            dead_tags = [t for t, (_, _, owner) in self._pending_recvs.items()
                         if owner is peer]
            recvs = [self._pending_recvs.pop(t)[1] for t in dead_tags]
        with self._rpc_lock:
            dead_rids = [r for r, (_, owner) in self._pending_rpcs.items()
                         if owner is peer]
            rpcs = [tx for rid in dead_rids
                    for tx in (self._pending_rpcs.pop(rid, (None,))[0],)
                    if tx is not None]
        # drop the dead peer from the connection tables so the next
        # connect() dials a fresh socket instead of reusing a corpse —
        # guard against a STALE reader (a replaced connection's old socket)
        # evicting the live one. Check-then-act is atomic under the peers
        # lock: a NEWER peer registered between the check and the pop
        # must survive the old reader's eviction (R012).
        with self._peers_lock:
            was_current = self._peers.get(peer.peer_id) is peer
            if was_current:
                self._peers.pop(peer.peer_id, None)
        if was_current:
            with self._clients_lock:
                self._clients.pop(peer.peer_id, None)

        def fail():
            msg = f"peer {peer.peer_id!r} lost: {reason}"
            for tx in recvs:
                tx.complete(TransactionStatus.ERROR, msg)
            for tx in rpcs:
                tx.complete(TransactionStatus.ERROR, msg)
        self._progress_put(fail)
        if was_current and peer.peer_id != "?":
            self.notify_peer_lost(peer.peer_id)

    def _peer_by_id(self, peer_id: str) -> Optional[_Peer]:
        with self._peers_lock:
            return self._peers.get(peer_id)

    def _register_rpc(self, tx: Transaction, peer: _Peer) -> int:
        with self._rpc_lock:
            self._rpc_id += 1
            self._pending_rpcs[self._rpc_id] = (tx, peer)
            return self._rpc_id

    def _drop_rpc(self, rid: int) -> None:
        with self._rpc_lock:
            self._pending_rpcs.pop(rid, None)

    def _post_receive(self, alt: AddressLengthTag, tx: Transaction,
                      peer: _Peer) -> None:
        with self._tag_lock:
            data = self._early_data.pop(alt.tag, None)
            if data is None:
                self._pending_recvs[alt.tag] = (alt, tx, peer)
                return
        # complete on the progress thread, NEVER inline: the poster holds its
        # own state lock (inprocess._TagTable defers the same way)
        self._progress_put(lambda: self._fill(alt, tx, data))

    def _cancel_receive(self, tag: int) -> None:
        with self._tag_lock:
            self._pending_recvs.pop(tag, None)
            self._early_data.pop(tag, None)

    #: bound on frames parked for not-yet-posted receives: legit early
    #: data (a send racing its recv post) is transient and small in
    #: count; an UNBOUNDED table would let orphaned tags (duplicate
    #: frames, retransmits landing after a cancel_receive) accumulate
    #: frame-sized buffers for the connection's lifetime. Evicting the
    #: oldest degrades to a receive timeout + retry, never corruption.
    _EARLY_DATA_CAP = 512

    def _on_data(self, tag: int, payload: bytes) -> None:
        with self._tag_lock:
            pending = self._pending_recvs.pop(tag, None)
            if pending is None:
                self._early_data[tag] = payload   # send raced ahead of recv
                while len(self._early_data) > self._EARLY_DATA_CAP:
                    self._early_data.pop(next(iter(self._early_data)))
                return
        alt, tx, _owner = pending
        self._fill(alt, tx, payload)

    @staticmethod
    def _fill(alt: AddressLengthTag, tx: Transaction, data: bytes) -> None:
        n = min(len(data), alt.length)
        alt.buffer[:n] = data[:n]
        tx.stats.received_bytes = n
        tx.complete(TransactionStatus.SUCCESS)

    def _on_response(self, rid: int, payload: bytes) -> None:
        with self._rpc_lock:
            entry = self._pending_rpcs.pop(rid, None)
        if entry is None:
            return
        tx, _owner = entry
        ok = payload[:1] == b"\x00"
        tx.response = payload[1:]
        tx.stats.received_bytes = len(tx.response)
        if ok:
            tx.complete(TransactionStatus.SUCCESS)
        else:
            tx.complete(TransactionStatus.ERROR,
                        payload[1:].decode(errors="replace"))

    def _on_request(self, peer: _Peer, rid: int, body: bytes) -> None:
        (tlen,) = struct.unpack(">H", body[:2])
        req_type = body[2:2 + tlen].decode()
        payload = body[2 + tlen:]

        def run():
            handler = self._handlers.get(req_type)
            try:
                if handler is None:
                    raise KeyError(f"no handler for {req_type!r}")
                resp = b"\x00" + handler(peer.peer_id, payload)
            except Exception as e:  # noqa: BLE001 - propagated to the peer
                resp = b"\x01" + f"{type(e).__name__}: {e}".encode()
            try:
                _send_frame(peer.sock, peer.wlock, b"P", rid, resp)
            except OSError:
                pass
        self._work.put(run)

    # ---- transport API -----------------------------------------------------
    def connect(self, peer_executor_id: str) -> TcpClientConnection:
        """Dial a peer, retrying transient failures (slow registry, peer
        restarting, connection refused) with exponential backoff + jitter
        under shuffle.maxRetries / .retryBackoffMs; each attempt is bounded
        by shuffle.connectTimeout. On peer loss the cached connection was
        evicted by _peer_lost, so calling connect() again re-dials."""
        with self._clients_lock:
            conn = self._clients.get(peer_executor_id)
            if conn is not None:
                return conn
        timeout = self.conf.shuffle_connect_timeout
        max_retries = self.conf.shuffle_max_retries
        attempt = 0
        while True:
            try:
                host, port = self._resolve(peer_executor_id, timeout)
                sock = socket.create_connection((host, port), timeout=timeout)
                break
            except (OSError, ConnectionError) as e:
                if attempt >= max_retries:
                    raise ConnectionError(
                        f"connect to {peer_executor_id!r} failed after "
                        f"{attempt + 1} attempts: {e}") from e
                self.metrics[mt.SHUFFLE_CONNECT_RETRIES].add(1)
                time.sleep(backoff_ms(
                    attempt, self.conf.shuffle_retry_backoff_ms,
                    self.conf.shuffle_faults_seed,
                    key=f"connect:{peer_executor_id}") / 1e3)
                attempt += 1
        # connectTimeout applies to establishment only; a long-idle but
        # healthy connection must not trip the reader's recv timeout
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        peer = _Peer(self, sock, peer_executor_id)
        self._register_peer(peer_executor_id, peer)
        _send_frame(sock, peer.wlock, b"H", 0, self.executor_id.encode())
        conn = TcpClientConnection(self, peer)
        with self._clients_lock:
            self._clients[peer_executor_id] = conn
        return conn

    def _resolve(self, peer_executor_id: str, timeout: Optional[float] = None
                 ) -> Tuple[str, int]:
        if timeout is None:
            timeout = self.conf.shuffle_connect_timeout
        if ":" in peer_executor_id:          # direct host:port addressing
            host, _, port = peer_executor_id.rpartition(":")
            return host, int(port)
        if not self._registry:
            raise ConnectionError(
                f"cannot resolve {peer_executor_id!r}: no registry dir "
                f"(spark.rapids.tpu.shuffle.tcp.registryDir)")
        path = os.path.join(self._registry, peer_executor_id)
        deadline = time.monotonic() + timeout
        while True:
            try:
                with open(path) as f:
                    host, _, port = f.read().strip().rpartition(":")
                    return host, int(port)
            except (FileNotFoundError, ValueError):
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"executor {peer_executor_id!r} never registered "
                        f"in {self._registry}") from None
                time.sleep(0.05)

    @property
    def server(self) -> TcpServerConnection:
        return self._server_conn

    def heartbeat(self) -> None:
        """Refresh the registry entry's mtime — the liveness signal
        serving-replica discovery reads (``scan_registry`` with a
        staleness window). A killed transport stops heartbeating, so
        its entry ages out exactly like a SIGKILL'd process's would."""
        if not self._registry or self._killed:
            return
        try:
            os.utime(os.path.join(self._registry, self.executor_id))
        except OSError:
            # the entry vanished — a liveness-window GC raced a stall
            # (pause longer than the window, then resume). A LIVE replica
            # must re-enter discovery, not stay ejected forever, so
            # republish instead of silently shrugging.
            try:
                self._publish_registry()
            except OSError:
                pass

    def kill(self) -> None:
        """Simulate abrupt process death (SIGKILL) process-locally: close
        the listener and every peer socket so remotes observe a dead
        replica, stop heartbeating — and deliberately LEAVE the registry
        file behind (a killed process never runs its shutdown), which is
        exactly the stale entry ``scan_registry``'s GC must absorb."""
        self._killed = True
        self._close_listener()
        with self._peers_lock:
            peers = list(self._peers.values())
        for p in peers:
            p.close()

    def _close_listener(self) -> None:
        # SHUT_RDWR first, same discipline as _Peer.close: a bare close()
        # is deferred by CPython while the accept thread is blocked in
        # accept(), leaving the port LIVE — new dials would still land
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def shutdown(self) -> None:
        # retract the registry entry FIRST: a restarted executor re-binds an
        # ephemeral port, and a stale file would hand peers a dead address
        # (or worse, someone else's re-used port) to resolve forever
        if self._registry:
            try:
                os.remove(os.path.join(self._registry, self.executor_id))
            except OSError:
                pass
        self._close_listener()
        with self._peers_lock:
            peers = list(self._peers.values())
        for p in peers:
            p.close()
        for _ in range(self._num_workers):
            self._work.put(None)
        self._progress.put(None)
