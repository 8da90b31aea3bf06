"""Deterministic fault injection for the shuffle stack.

The chaos-testing harness the fault-tolerance layer is proved against:
a seeded, conf-driven ``FaultPlan`` describes WHAT breaks and WHEN
(drop a connection after N frames, corrupt/delay/duplicate a frame, fail a
request once), and ``FaultInjectingTransport`` wraps any real transport
(in-process fabric or TCP) injecting those faults at the connection layer —
so chaos tests assert that queries still return correct results under each
fault class, deterministically under a fixed seed.

conf::

    spark.rapids.tpu.shuffle.transport.class =
        spark_rapids_tpu_torch.shuffle.faults.FaultInjectingTransport
    spark.rapids.tpu.shuffle.faults.transport.class = <wrapped transport>
    spark.rapids.tpu.shuffle.faults.plan  = drop_conn:after=2;corrupt_frame:after=1
    spark.rapids.tpu.shuffle.faults.seed  = 7

Plan grammar: ``kind[:key=val[,key=val...]][;spec...]``. Kinds and their
injection points:

- ``drop_conn``   — the Nth frame RECEIVED from a peer kills the connection:
  that frame and every in-flight receive on the connection fail, the
  connection epoch goes dead (all later ops fail fast), and peer-lost
  listeners fire so ShuffleEnv evicts the cached client. A later connect()
  opens a fresh epoch — exactly a TCP reader thread dying mid-fetch.
- ``corrupt_frame`` — a frame SENT to a peer has one byte flipped (seeded
  choice), exercising the end-to-end checksum → retry path.
- ``delay_frame``  — a sent frame is held back ``delay_ms`` (slow peer).
- ``dup_frame``    — a sent frame is transmitted twice (duplicate delivery;
  the reader's (block, table) dedup must absorb it).
- ``fail_request`` — a client request (``req_type`` filter, default any)
  fails without reaching the peer (lost/failed RPC handler).
- ``kill_peer``    — process-local peer DEATH on this (server) side: the
  Nth matching event kills the whole wrapped transport — listener and
  every peer socket close AND the liveness heartbeat stops (the registry
  entry is deliberately left behind, exactly like SIGKILL) — so remotes
  observe a dead replica and must fail over. Countable events: a handled
  request (``req_type`` filters, e.g. ``serve.submit``) or an outgoing
  data frame (``req_type=data`` — the Nth result frame, mid-stream death).

Keys: ``peer`` (exact executor id, default ``*``), ``after`` (1-based Nth
matching event, default 1), ``count`` (how many consecutive events fire,
default 1, ``0`` = every event from ``after`` on), ``delay_ms``,
``req_type``, ``owner`` (exact executor id of the transport that INJECTS
the fault, default ``*``). Event counters run PER PEER, so
``drop_conn:after=2`` drops each remote peer's connection once.

``owner`` exists because the conf — and therefore the plan — is shared by
every executor in a cluster session: ``kill_peer:req_type=data`` alone
would kill ALL executors on their first data frame. With
``kill_peer:owner=exec-1,req_type=data,after=2`` only exec-1's transport
honors the spec, the deterministic single-executor death the recompute
tests are built on (``peer`` filters the REMOTE side of the event;
``owner`` filters the local, injecting side).
"""
from __future__ import annotations

import importlib
import queue
import random
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.shuffle import retry
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                ClientConnection,
                                                ServerConnection,
                                                ShuffleTransport, Transaction,
                                                TransactionStatus)

KINDS = ("drop_conn", "corrupt_frame", "delay_frame", "dup_frame",
         "fail_request", "kill_peer")
#: spec kinds probed on the server→client data path
_SEND_KINDS = ("corrupt_frame", "delay_frame", "dup_frame")


@dataclass
class FaultSpec:
    """One scheduled fault. ``after``/``count`` select which of the matching
    events fire: events ``after .. after+count-1`` (1-based, per peer)."""
    kind: str
    peer: str = "*"
    after: int = 1
    count: int = 1
    delay_ms: float = 50.0
    req_type: str = "*"
    owner: str = "*"

    def matches(self, peer: str, req_type: str = "*") -> bool:
        return (self.peer in ("*", peer)
                and self.req_type in ("*", req_type))

    def fires(self, event_num: int) -> bool:
        if event_num < self.after:
            return False
        return self.count == 0 or event_num < self.after + self.count

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        kind, _, rest = text.strip().partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; known: {KINDS}")
        spec = FaultSpec(kind)
        if rest:
            for kv in rest.split(","):
                key, _, val = kv.partition("=")
                key = key.strip()
                if key == "peer":
                    spec.peer = val.strip()
                elif key == "after":
                    spec.after = int(val)
                elif key == "count":
                    spec.count = int(val)
                elif key == "delay_ms":
                    spec.delay_ms = float(val)
                elif key == "req_type":
                    spec.req_type = val.strip()
                elif key == "owner":
                    spec.owner = val.strip()
                else:
                    raise ValueError(f"unknown fault key {key!r} in {text!r}")
        return spec


class FaultPlan:
    """The full chaos schedule: specs + per-(spec, peer) event counters +
    one seeded PRNG for the plan's random choices. ``fired`` records every
    injected fault for test assertions."""

    def __init__(self, specs: Tuple[FaultSpec, ...] = (), seed: int = 0,
                 owner: str = "*"):
        self.specs = tuple(specs)
        self.seed = seed
        #: executor id of the transport this plan instance belongs to —
        #: specs with an ``owner`` filter only fire on that transport
        self.owner = owner
        self._rng = random.Random(seed)
        self._counts: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, int]] = []   # (kind, peer, event#)

    @classmethod
    def parse(cls, text: str, seed: int = 0, owner: str = "*") -> "FaultPlan":
        specs = [FaultSpec.parse(s) for s in text.split(";") if s.strip()]
        return cls(tuple(specs), seed, owner)

    @property
    def empty(self) -> bool:
        return not self.specs

    def _advance(self, kinds: Tuple[str, ...], peer: str,
                 req_type: str = "*") -> List[FaultSpec]:
        """Advance the event counter of every matching spec; return those
        whose window covers this event."""
        hits: List[FaultSpec] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.kind not in kinds or not spec.matches(peer, req_type):
                    continue
                if spec.owner not in ("*", self.owner):
                    continue
                key = (i, peer)
                n = self._counts.get(key, 0) + 1
                self._counts[key] = n
                if spec.fires(n):
                    self.fired.append((spec.kind, peer, n))
                    hits.append(spec)
        return hits

    # ---- probes (each is ONE countable event at its injection point) -------
    def on_request(self, peer: str, req_type: str) -> Optional[str]:
        """fail_request probe: error message when a request should fail."""
        if self._advance(("fail_request",), peer, req_type):
            return f"injected request failure ({req_type})"
        return None

    def on_frame_send(self, peer: str) -> List[FaultSpec]:
        """corrupt/delay/dup probe for one outgoing data frame."""
        return self._advance(_SEND_KINDS, peer)

    def on_frame_recv(self, peer: str) -> bool:
        """drop_conn probe for one received data frame."""
        return bool(self._advance(("drop_conn",), peer))

    def on_kill_request(self, peer: str, req_type: str) -> bool:
        """kill_peer probe for one server-handled request (submit/stream/
        drain phase targeting via the ``req_type`` filter)."""
        return bool(self._advance(("kill_peer",), peer, req_type))

    def on_kill_frame(self, peer: str) -> bool:
        """kill_peer probe for one outgoing data frame (``req_type=data``
        specs: the Nth result frame = mid-stream replica death)."""
        return bool(self._advance(("kill_peer",), peer, "data"))

    def corrupt(self, data: bytearray) -> bytearray:
        """Flip one seeded byte (in place) — the minimal corruption a
        checksum must catch."""
        if len(data):
            with self._lock:
                idx = self._rng.randrange(len(data))
            data[idx] ^= 0xFF
        return data


class _FaultyClientConnection(ClientConnection):
    """Client connection epoch: passes traffic through the wrapped
    connection until a drop_conn fault fires, then the epoch is dead —
    every in-flight receive fails (scoped to THIS peer), later ops fail
    fast, and the transport evicts it so connect() starts a new epoch.

    Receives are staged through a private buffer so a stale completion from
    a dropped epoch can never scribble a bounce buffer the retry reuses."""

    def __init__(self, transport: "FaultInjectingTransport", peer: str,
                 inner: ClientConnection):
        self._t = transport
        self._inner = inner
        self.peer_executor_id = peer
        self._lock = threading.Lock()
        self._dead = False
        self._inflight: List[Transaction] = []

    @property
    def dead(self) -> bool:
        with self._lock:
            return self._dead

    def _dead_tx(self, tx: Transaction) -> Transaction:
        self._t._defer(lambda: tx.complete(
            TransactionStatus.ERROR,
            f"peer {self.peer_executor_id!r} lost: injected connection drop"))
        return tx

    def request(self, req_type: str, payload: bytes,
                cb: Callable[[Transaction], None]) -> Transaction:
        if self.dead:
            return self._dead_tx(Transaction().start(cb))
        err = self._t.plan.on_request(self.peer_executor_id, req_type)
        if err is not None:
            tx = Transaction().start(cb)
            self._t._defer(lambda: tx.complete(TransactionStatus.ERROR, err))
            return tx
        return self._inner.request(req_type, payload, cb)

    def send(self, alt: AddressLengthTag, cb) -> Transaction:
        if self.dead:
            return self._dead_tx(Transaction(alt.tag).start(cb))
        return self._inner.send(alt, cb)

    def receive(self, alt: AddressLengthTag, cb) -> Transaction:
        tx = Transaction(alt.tag).start(cb)
        with self._lock:
            if self._dead:
                return self._dead_tx(tx)
            self._inflight.append(tx)
        priv = bytearray(alt.length)
        ialt = AddressLengthTag(priv, alt.length, alt.tag)

        def icb(itx: Transaction):
            with self._lock:
                if tx in self._inflight:
                    self._inflight.remove(tx)
                dead = self._dead
            if dead:
                return                      # tx already failed by the drop
            if itx.status is not TransactionStatus.SUCCESS:
                self._t._defer(lambda: tx.complete(
                    TransactionStatus.ERROR, itx.error_message))
                return
            if self._t.plan.on_frame_recv(self.peer_executor_id):
                self._drop()
                self._dead_tx(tx)           # the triggering frame is lost too
                return
            n = min(len(priv), alt.length)
            alt.buffer[:n] = priv[:n]
            tx.stats.received_bytes = itx.stats.received_bytes

            def ok():
                tx.complete(TransactionStatus.SUCCESS)
            self._t._defer(ok)
        self._inner.receive(ialt, icb)
        return tx

    def cancel_receive(self, tag: int) -> None:
        """Pass-through of the transport's receive abandonment (tcp.py):
        drop the matching staged transaction too, so a late completion of
        a cancelled tag is a no-op instead of a surprise."""
        with self._lock:
            self._inflight = [t for t in self._inflight if t.tag != tag]
        inner = getattr(self._inner, "cancel_receive", None)
        if inner is not None:
            inner(tag)

    def _drop(self) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            victims = list(self._inflight)
            self._inflight.clear()
        msg = (f"peer {self.peer_executor_id!r} lost: "
               f"injected connection drop")

        def fail():
            for v in victims:
                v.complete(TransactionStatus.ERROR, msg)
        self._t._defer(fail)
        self._t._connection_dropped(self)


class _FaultyServerConnection(ServerConnection):
    """Server side: handlers pass through untouched; outgoing data frames
    run the send-side fault probes (corrupt / delay / duplicate)."""

    def __init__(self, transport: "FaultInjectingTransport",
                 inner: ServerConnection):
        self._t = transport
        self._inner = inner

    def register_request_handler(self, req_type: str,
                                 handler: Callable[[str, bytes], bytes]
                                 ) -> None:
        def probed(peer: str, payload: bytes) -> bytes:
            # kill_peer probe at request dispatch: phase-targeted replica
            # death (req_type=serve.submit dies at submit, =serve.drain
            # dies mid-drain); the kill closes every socket, so the error
            # below never reaches the peer — it observes a dead replica
            if self._t.plan.on_kill_request(peer, req_type):
                self._t.kill()
                raise ConnectionError(
                    f"injected peer death handling {req_type}")
            return handler(peer, payload)
        self._inner.register_request_handler(req_type, probed)

    def send(self, peer_executor_id: str, alt: AddressLengthTag,
             cb) -> Transaction:
        if self._t.plan.on_kill_frame(peer_executor_id):
            # mid-stream replica death: the frame is never sent and the
            # whole transport dies (listener + sockets + heartbeat)
            self._t.kill()
            tx = Transaction(alt.tag).start(cb)
            self._t._defer(lambda: tx.complete(
                TransactionStatus.ERROR, "injected peer death (kill_peer)"))
            return tx
        hits = self._t.plan.on_frame_send(peer_executor_id)
        if not hits:
            return self._inner.send(peer_executor_id, alt, cb)
        # a faulted frame always rides a COPY: the caller (BufferSendState)
        # re-stages its bounce buffer on completion, and a duplicated or
        # delayed send must not observe that reuse
        data = bytearray(alt.buffer[:alt.length])
        delay_ms = 0.0
        for spec in hits:
            if spec.kind == "corrupt_frame":
                self._t.plan.corrupt(data)
            elif spec.kind == "dup_frame":
                self._inner.send(
                    peer_executor_id,
                    AddressLengthTag(bytearray(data), len(data), alt.tag),
                    lambda t: None)
            elif spec.kind == "delay_frame":
                delay_ms = max(delay_ms, spec.delay_ms)
        salt = AddressLengthTag(data, len(data), alt.tag)
        if delay_ms <= 0:
            return self._inner.send(peer_executor_id, salt, cb)
        tx = Transaction(alt.tag).start(cb)

        def later():
            def icb(itx: Transaction):
                tx.stats.sent_bytes = itx.stats.sent_bytes
                tx.complete(itx.status, itx.error_message)
            self._inner.send(peer_executor_id, salt, icb)
        retry.call_later(delay_ms, later)
        return tx


class FaultInjectingTransport(ShuffleTransport):
    """conf spark.rapids.tpu.shuffle.transport.class =
    spark_rapids_tpu_torch.shuffle.faults.FaultInjectingTransport

    Wraps the transport named by shuffle.faults.transport.class and injects
    the conf-driven FaultPlan. With an empty plan it is a pass-through (plus
    the private-buffer receive staging), so it can soak in stress runs."""

    def __init__(self, executor_id: str, conf=None):
        super().__init__(executor_id, conf)
        self.killed = False
        cls_name = self.conf.shuffle_faults_transport_class
        mod_name, _, cls = cls_name.rpartition(".")
        self._inner: ShuffleTransport = getattr(
            importlib.import_module(mod_name), cls)(executor_id, self.conf)
        # ONE set of pools/throttle/counters for the pair: retries counted
        # inside the wrapped transport (e.g. TCP connect) must be visible
        # through ShuffleEnv.metrics, and duplicate bounce pools would
        # double the staging memory for no isolation benefit
        self.send_bounce = self._inner.send_bounce
        self.recv_bounce = self._inner.recv_bounce
        self.throttle = self._inner.throttle
        self.metrics = self._inner.metrics
        self.plan = FaultPlan.parse(self.conf.shuffle_faults_plan,
                                    self.conf.shuffle_faults_seed,
                                    owner=executor_id)
        # real peer deaths in the wrapped transport surface through us too
        self._inner.add_peer_lost_listener(self.notify_peer_lost)
        self._conns: Dict[str, _FaultyClientConnection] = {}
        self._conns_lock = threading.Lock()
        self._server = _FaultyServerConnection(self, self._inner.server)
        # completions are deferred to this thread, NEVER run inline on the
        # caller: posters hold their own state locks when issuing ops (the
        # same single-progress-thread contract the real transports honor)
        self._dq: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        threading.Thread(target=self._defer_loop, daemon=True,
                         name=f"fault-transport-{executor_id}").start()

    def _defer_loop(self) -> None:
        while True:
            fn = self._dq.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — completions must keep flowing
                import traceback
                traceback.print_exc()

    def _defer(self, fn: Callable[[], None]) -> None:
        self._dq.put(fn)

    def _connection_dropped(self, conn: _FaultyClientConnection) -> None:
        with self._conns_lock:
            if self._conns.get(conn.peer_executor_id) is conn:
                self._conns.pop(conn.peer_executor_id)
        self.notify_peer_lost(conn.peer_executor_id)

    def connect(self, peer_executor_id: str) -> _FaultyClientConnection:
        with self._conns_lock:
            conn = self._conns.get(peer_executor_id)
            if conn is not None and not conn.dead:
                return conn
        inner = self._inner.connect(peer_executor_id)
        conn = _FaultyClientConnection(self, peer_executor_id, inner)
        with self._conns_lock:
            self._conns[peer_executor_id] = conn
        return conn

    @property
    def server(self) -> _FaultyServerConnection:
        return self._server

    def heartbeat(self) -> None:
        """A killed replica stops heartbeating — its registry entry ages
        out of the liveness window like a real SIGKILL'd process's."""
        if not self.killed:
            self._inner.heartbeat()

    def kill(self) -> None:
        if self.killed:
            return
        self.killed = True
        self._inner.kill()

    def shutdown(self) -> None:
        self._inner.shutdown()
        self._dq.put(None)
