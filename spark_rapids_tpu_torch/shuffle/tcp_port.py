"""The port's TCP transport: ``shuffle/tcp.py`` (the reference's text, kept
byte-equal) with two of its faults repaired around the copy.

- **A killed transport closes every socket it holds.** The copy's ``kill``
  closes the socket its peer table keeps for each peer id. When two
  executors dialed each other, each id has two sockets, and the one the
  table no longer names stays open (as does an accepted socket whose
  hello was not read yet): a receive the remote posted on it waits out
  ``shuffle.fetch.timeoutSeconds`` instead of failing at once with
  peer-lost. This transport keeps every socket it dialed or accepted,
  and ``kill`` and ``shutdown`` close them all.
- **A server send waits for the peer's hello.** A peer that dialed this
  transport is known by id only once its reader has read the hello
  frame. The copy's ``TcpServerConnection.send`` to a peer not yet known
  fails the send at once, and the receive the peer posted on the socket
  it dialed waits out its timeout. Here the send waits, bounded by
  ``shuffle.connectTimeout``, for the hello on the peer's own socket; no
  second socket is dialed.

Select it with ``shuffle.transport.class`` (the cluster's process executors
and the serving wire take it by default).
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Set

from spark_rapids_tpu_torch.shuffle import tcp as _tcp
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                      Transaction,
                                                      TransactionStatus)


class _HelloWaitingServerConnection(_tcp.TcpServerConnection):
    def send(self, peer_executor_id: str, alt: AddressLengthTag,
             cb) -> Transaction:
        peer = self._t._wait_for_peer(peer_executor_id)
        if peer is None:
            tx = Transaction(alt.tag).start(cb)
            self._t._progress_put(lambda: tx.complete(
                TransactionStatus.ERROR,
                f"no connection from {peer_executor_id!r}"))
            return tx
        return self._t._async_send(peer, alt, cb)


class TcpTransport(_tcp.TcpTransport):
    """conf spark.rapids.tpu.shuffle.transport.class =
    spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport"""

    def __init__(self, executor_id: str, conf=None):
        # before the base starts its accept and reader threads, which
        # register peers through the overrides below
        self._all_peers: Set[_tcp._Peer] = set()
        self._hello_cv = threading.Condition()
        #: set once kill or shutdown closed the sockets: a socket accepted
        #: after that (its accept raced the close) is closed at once
        self._closing = False
        super().__init__(executor_id, conf)
        self._server_conn = _HelloWaitingServerConnection(self)

    def _accept_loop(self) -> None:
        # the base loop, keeping each accepted socket from its accept on:
        # a peer killed before its hello was read still has it closed
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(_tcp.socket.IPPROTO_TCP,
                            _tcp.socket.TCP_NODELAY, 1)
            peer = _tcp._Peer(self, sock)
            with self._hello_cv:
                closing = self._closing
                if not closing:
                    self._all_peers.add(peer)
            if closing:
                peer.close()

    def _register_peer(self, peer_id: str, peer: "_tcp._Peer") -> None:
        with self._hello_cv:
            self._all_peers.add(peer)
            super()._register_peer(peer_id, peer)
            self._hello_cv.notify_all()

    def _peer_lost(self, peer: "_tcp._Peer", reason: str) -> None:
        with self._hello_cv:
            self._all_peers.discard(peer)
        super()._peer_lost(peer, reason)

    def _wait_for_peer(self, peer_id: str) -> Optional["_tcp._Peer"]:
        """The live socket of ``peer_id``, waiting up to
        ``shuffle.connectTimeout`` for its hello; None if none came."""
        deadline = time.monotonic() + self.conf.shuffle_connect_timeout
        with self._hello_cv:
            while True:
                peer = self._peer_by_id(peer_id)
                left = deadline - time.monotonic()
                if peer is not None or left <= 0 or self._killed:
                    return peer
                self._hello_cv.wait(left)

    def _close_all_peers(self) -> None:
        with self._hello_cv:
            self._closing = True
            peers = list(self._all_peers)
            self._all_peers.clear()
            self._hello_cv.notify_all()
        with self._clients_lock:
            peers += [c._peer for c in self._clients.values()]
        for p in peers:
            p.close()

    def kill(self) -> None:
        super().kill()
        self._close_all_peers()

    def shutdown(self) -> None:
        super().shutdown()
        self._close_all_peers()
