"""Network query service: the serving stack's front door.

``session.submit()`` serves queries in process only. ``QueryServer`` puts
the scheduler behind the wire protocol (serving/wire.py: Arrow IPC over the
TCP shuffle transport's framing, checksum and retry machinery):

- **streaming partial results**: each result batch rides to the client as
  its async D2H resolves (``QueryHandle.emit_batch`` ->
  ``ResultStream``), before the final batch exists; large batches slice
  into bounded wire frames (``serving.net.maxStreamBatchRows``). The
  port's handles carry HostBatches (what ``collect`` returns); they become
  Arrow tables here, at the wire;
- **bounded server state**: one parked (unacked) frame per query plus a
  depth-bounded stream — a slow client backpressures its own query's
  producer, never the server;
- **cancellation über alles**: client-initiated cancel and client
  disconnect (the transport's peer-lost signal) both release server-side
  resources through the cooperative-cancel chain — semaphore holds,
  catalog buffers, parked frames, stream buffers;
- **N replicas, one cache**: servers sharing ``serving.cache.dir`` share
  the on-disk program-cache index (multi-process-safe by design), so a
  second replica warm-starts compiles behind the client's connection
  routing (client.py).

Handlers run on the transport's worker pool and every wait is bounded
(the R010 discipline): ``serve.next`` polls the stream for at most
``serving.net.nextPollMs`` before answering WAIT and freeing its thread.

CLI (a replica's entry point)::

    python -m spark_rapids_tpu_torch.serving.server --port 0 \
        --conf spark.rapids.tpu.sql.variableFloatAgg.enabled=true \
        --tpch-lineitem 0.01 --partitions 4 --device cuda \
        --store-fraction 0.2

prints ``SERVING <host> <port>`` once the wire transport is bound. The
device is the GPU unless ``--device cpu`` is given; without a GPU the
default raises. ``--store-fraction`` is the share of the card this
replica's store may take (``memory.tpu.allocFraction``): replicas that
share one card must split it between them.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.serving import wire
from spark_rapids_tpu_torch.serving.lifecycle import (OverloadedError,
                                                QuotaExceededError,
                                                ResultStream,
                                                SchedulerDrainingError)
from spark_rapids_tpu_torch.shuffle.codec import checksum_of
from spark_rapids_tpu_torch.shuffle.transport import AddressLengthTag
from spark_rapids_tpu_torch.utils import metrics as um
from spark_rapids_tpu_torch.utils import tracing as _tracing
from spark_rapids_tpu_torch.utils.errors import encode_error, wire_boundary


def _as_arrow(batch):
    """A served result batch as an Arrow table: the port's handles carry
    HostBatches; the wire speaks Arrow IPC."""
    to_arrow = getattr(batch, "to_arrow", None)
    return batch if to_arrow is None else to_arrow()


def _kernel_counts():
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    return {"reorder_launches": pk.REORDER_KERNEL.launches,
            "reorder_kept": pk.REORDER_KERNEL.kept,
            "compact_launches": pk.COMPACT_KERNEL.launches}


def _arrow_schema(result):
    """The Arrow schema of a served result, without converting its rows."""
    to_pa = getattr(result.schema, "to_pa", None)
    return result.schema if to_pa is None else to_pa()


class _ServedQuery:
    """Server-side state of one wire-submitted query: the scheduler
    handle, its result stream, the owning peer, and at most ONE parked
    (sent-but-unacked) wire frame kept for checksum-failure retransmit."""

    __slots__ = ("handle", "stream", "peer", "lock", "next_seq", "parked",
                 "slices", "resume_from")

    def __init__(self, handle, stream: ResultStream, peer: str,
                 resume_from: int = -1):
        self.handle = handle
        self.stream = stream
        self.peer = peer
        # re-entrant: _drop_query guards the parked/slices teardown and
        # is reached both bare (cancel, peer-lost, shutdown) and from
        # under the serve.next poll's hold (R012)
        self.lock = threading.RLock()
        self.next_seq = 0
        #: (seq, wire bytes, crc32) of the frame awaiting the client's ack
        self.parked: Optional[Tuple[int, bytes, int]] = None
        #: row-sliced remainders of an oversized exec batch, served next
        self.slices: List = []
        #: stream-resume failover: frames with seq <= resume_from were
        #: already delivered by the replica that died — the re-run skips
        #: them (dedup by seq, exactly-once delivery to the caller)
        self.resume_from = resume_from


class QueryServer:
    """One serving replica: wire handlers over one TpuSession/scheduler."""

    def __init__(self, session, conf=None, listen_port: Optional[int] = None):
        self.session = session
        base = conf or session.conf
        # serve.next handlers occupy a worker thread for up to nextPollMs;
        # give the serving transport a deeper pool than the shuffle default
        # so concurrent clients' polls do not head-of-line-block RPCs
        self.conf = base.with_overrides({
            cfg.SHUFFLE_TCP_WORKER_THREADS.key:
                max(base.get(cfg.SHUFFLE_TCP_WORKER_THREADS), 8)})
        self._poll_s = self.conf.get(cfg.SERVING_NET_POLL_MS) / 1e3
        self._stream_depth = self.conf.get(cfg.SERVING_NET_STREAM_DEPTH)
        self._max_rows = self.conf.get(cfg.SERVING_NET_MAX_STREAM_ROWS)
        #: per-client concurrent-query quota (0 = unlimited): enforced at
        #: the wire seam where the peer identity lives — the scheduler
        #: only knows tenants, and one tenant can span many clients
        self._quota_max = self.conf.get(cfg.SERVING_QUOTA_MAX_PER_CLIENT)
        self._retry_after_base = self.conf.get(cfg.SERVING_OVERLOAD_RETRY_AFTER)
        self._lock = threading.Lock()
        self._queries: Dict[int, _ServedQuery] = {}
        #: peers whose connection already died — a serve.submit dispatched
        #: just before the drop lands AFTER _on_peer_lost scanned
        #: _queries, so the handler must re-check and cancel immediately
        #: (client executor ids are uuid-unique, so a lost id never
        #: returns; bounded to the newest entries)
        self._lost_peers: "OrderedDict[str, None]" = OrderedDict()
        self._stop_event = threading.Event()
        #: graceful drain: new submits are rejected with a retryable
        #: redirect, running queries finish, streams flush, then
        #: serve_forever returns and the caller deregisters via shutdown
        self._draining = False
        self.transport = wire.make_serving_transport(
            f"query-server-{uuid.uuid4().hex[:8]}", self.conf, listen_port,
            registry_dir=self.conf.get(cfg.SERVING_NET_REGISTRY))
        server = self.transport.server
        server.register_request_handler(wire.REQ_SUBMIT, self._handle_submit)
        server.register_request_handler(wire.REQ_NEXT, self._handle_next)
        server.register_request_handler(wire.REQ_FETCH, self._handle_fetch)
        server.register_request_handler(wire.REQ_CANCEL, self._handle_cancel)
        server.register_request_handler(wire.REQ_REGISTER,
                                        self._handle_register)
        server.register_request_handler(wire.REQ_STATS, self._handle_stats)
        server.register_request_handler(wire.REQ_HEALTH, self._handle_health)
        server.register_request_handler(wire.REQ_DRAIN, self._handle_drain)
        # a vanished client is a cancellation: its queries release their
        # semaphore holds, catalog buffers and parked frames cooperatively
        self.transport.add_peer_lost_listener(self._on_peer_lost)
        # liveness heartbeat: refresh the registry-file mtime so replica
        # discovery (scan_registry + the liveness window) sees this
        # replica as alive; a killed transport stops refreshing and the
        # entry ages out — the SIGKILL story without SIGKILL
        if self.conf.get(cfg.SERVING_NET_REGISTRY):
            self._heartbeat_s = self.conf.get(cfg.SERVING_HEALTH_HEARTBEAT)
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="serving-heartbeat").start()
        # start the periodic gauge-sampler now, not at first submit: an
        # idle replica must report a FRESH serve_stats series (age_s near
        # the tick interval) or the autoscaler would treat it as unhealthy
        session.scheduler.start_stats_sampler()

    @property
    def address(self) -> Tuple[str, int]:
        t = self.transport
        inner = getattr(t, "_inner", None)   # fault wrapper pass-through
        return (inner or t).address

    # ---- handlers (transport worker threads; every wait bounded) -----------
    @staticmethod
    def _rejection(exc) -> bytes:
        """Structured front-door rejection: the taxonomy payload rides the
        SubmitResponse blob (query_id 0 — no handle exists) because the
        transport's exception path is a bare string that cannot carry
        retry_after_s across the wire."""
        return wire.SubmitResponse(0, error_json=json.dumps(
            encode_error(exc), default=str).encode()).to_bytes()

    # serializes taxonomy errors (overload shed / quota) into the
    # SubmitResponse blob — R015's wire seam, like _run_handle_traced
    @wire_boundary
    def _handle_submit(self, peer: str, payload: bytes) -> bytes:
        if self._draining:
            # retryable redirect: the type name rides the wire error and
            # the client reroutes the submission to another replica
            raise SchedulerDrainingError(
                "replica is draining; resubmit to another replica")
        req = wire.SubmitRequest.from_bytes(payload)
        if self._quota_max:
            with self._lock:
                open_for_peer = sum(1 for sq in self._queries.values()
                                    if sq.peer == peer)
            if open_for_peer >= self._quota_max:
                um.SERVING_METRICS[um.SERVING_QUOTA_REJECTIONS].add(1)
                return self._rejection(QuotaExceededError(
                    f"client {peer!r} at its concurrent-query quota "
                    f"({open_for_peer}/{self._quota_max}); retry after "
                    f"your own queries finish",
                    retry_after_s=self._retry_after_base))
        stream = ResultStream(depth=self._stream_depth)
        try:
            handle = self.session.scheduler.submit(
                req.sql, tenant=req.tenant,
                timeout=(req.timeout if req.timeout > 0 else None),
                label=req.label or None, stream=stream)
        except OverloadedError as e:
            # shed at the scheduler's per-tenant bound: ship the
            # structured rejection (code + retry_after_s) to the client
            return self._rejection(e)
        sq = _ServedQuery(handle, stream, peer, resume_from=req.resume_from)
        with self._lock:
            self._queries[handle.query_id] = sq
            # close the submit-vs-disconnect race: if this peer's
            # connection died while the request sat in the worker queue,
            # _on_peer_lost already scanned _queries and missed this
            # entry — cancel it here instead of leaving it to run for a
            # client that is gone
            raced_lost = peer in self._lost_peers
            if raced_lost:
                self._queries.pop(handle.query_id, None)
        if raced_lost:
            handle.cancel()
            stream.abandon()
            raise ConnectionError(f"peer {peer!r} disconnected")
        return wire.SubmitResponse(handle.query_id).to_bytes()

    def _lookup(self, query_id: int, peer: str) -> _ServedQuery:
        with self._lock:
            sq = self._queries.get(query_id)
        if sq is None or sq.peer != peer:
            raise KeyError(f"unknown query id {query_id} for peer {peer!r}")
        return sq

    def _park_locked(self, sq: _ServedQuery, table) -> Optional[bytes]:
        seq = sq.next_seq
        sq.next_seq += 1
        if seq <= sq.resume_from:
            # resumed query: the client already holds this frame from the
            # replica that died — skip it (dedup by seq, never re-sent)
            um.SERVING_METRICS[um.SERVING_RESUMED_BATCHES].add(1)
            return None
        data = wire.table_to_ipc(table)
        sq.parked = (seq, data, checksum_of(data))
        um.SERVING_METRICS[um.SERVING_STREAM_BATCHES].add(1)
        return wire.NextResponse(wire.NEXT_BATCH, seq=seq, nbytes=len(data),
                                 checksum=sq.parked[2]).to_bytes()

    def _serve_slices_locked(self, sq: _ServedQuery) -> Optional[bytes]:
        while sq.slices:
            resp = self._park_locked(sq, sq.slices.pop(0))
            if resp is not None:
                return resp
        return None

    def _slice(self, table) -> List:
        table = _as_arrow(table)
        if self._max_rows <= 0 or table.num_rows <= self._max_rows:
            return [table]
        return [table.slice(off, self._max_rows)
                for off in range(0, table.num_rows, self._max_rows)]

    def _handle_next(self, peer: str, payload: bytes) -> bytes:
        req = wire.NextRequest.from_bytes(payload)
        sq = self._lookup(req.query_id, peer)
        deadline = time.monotonic() + self._poll_s
        with sq.lock:
            if req.ack_seq >= 0 and sq.parked is not None \
                    and sq.parked[0] == req.ack_seq:
                sq.parked = None
            if sq.parked is not None:       # unacked frame: re-offer it
                seq, data, crc = sq.parked
                return wire.NextResponse(
                    wire.NEXT_BATCH, seq=seq, nbytes=len(data),
                    checksum=crc).to_bytes()
            resp = self._serve_slices_locked(sq)
            if resp is not None:
                return resp
        # poll the stream OUTSIDE the query lock, bounded: a dry stream
        # answers WAIT and frees this worker thread for other clients.
        # The loop exists for resumed queries — a batch whose every slice
        # was already delivered (skipped by seq) keeps draining within
        # the same bounded poll budget instead of burning a WAIT per skip
        while True:
            left = max(0.0, deadline - time.monotonic())
            kind, val = sq.stream.next(timeout=left)
            with sq.lock:
                if kind == "batch":
                    sq.slices.extend(self._slice(val))
                    resp = self._serve_slices_locked(sq)
                    if resp is not None:
                        return resp
                elif kind == "done":
                    return self._finish_response(sq)
                elif kind == "error":
                    self._drop_query(sq)
                    # structured codec (utils/errors.py): registered types
                    # survive the wire with their classification and
                    # payload; anything else degrades to OPAQUE
                    return wire.NextResponse(
                        wire.NEXT_ERROR,
                        error=json.dumps(encode_error(val),
                                         default=str)).to_bytes()
                else:
                    return wire.NextResponse(wire.NEXT_WAIT).to_bytes()
            if time.monotonic() >= deadline:
                return wire.NextResponse(wire.NEXT_WAIT).to_bytes()

    def _finish_response(self, sq: _ServedQuery) -> bytes:
        result = sq.handle.result(timeout=5.0)
        snap = sq.handle.snapshot()
        self._drop_query(sq)
        return wire.NextResponse(
            wire.NEXT_DONE, batches=sq.next_seq,
            metrics_json=json.dumps(snap, default=str).encode(),
            schema_ipc=wire.schema_to_ipc(_arrow_schema(result))).to_bytes()

    def _drop_query(self, sq: _ServedQuery) -> None:
        # under sq.lock: a cancel/peer-lost teardown must not clear the
        # slice list out from under a serve.next handler mid-pop (R012)
        with sq.lock:
            sq.parked = None
            sq.slices.clear()
        with self._lock:
            self._queries.pop(sq.handle.query_id, None)

    def _handle_fetch(self, peer: str, payload: bytes) -> bytes:
        req = wire.FetchRequest.from_bytes(payload)
        sq = self._lookup(req.query_id, peer)
        with sq.lock:
            parked = sq.parked
        if parked is None or parked[0] != req.seq:
            raise KeyError(f"no frame {req.seq} parked for query "
                           f"{req.query_id}")
        _seq, data, _crc = parked
        # the data plane: one tag-addressed frame through the shuffle
        # transport's server send path (where the chaos harness probes
        # corrupt/delay/dup — exactly like a shuffle block)
        with _tracing.span("serving.wire_frame", "serving",
                           {"bytes": len(data), "seq": _seq,
                            "query_id": req.query_id}):
            self.transport.server.send(
                peer, AddressLengthTag.for_bytes(data, req.tag),
                lambda tx: None)
        um.SERVING_METRICS[um.SERVING_WIRE_BYTES_OUT].add(len(data))
        return b""

    def _handle_cancel(self, peer: str, payload: bytes) -> bytes:
        """Client-initiated cancel: besides flagging the handle (the
        cooperative chain releases its permit and buffers), the client is
        DONE with this stream — abandon it so the producer never blocks
        on a reader that stopped pulling, and free the parked frame."""
        req = wire.CancelRequest.from_bytes(payload)
        sq = self._lookup(req.query_id, peer)
        sq.handle.cancel()
        sq.stream.abandon()
        self._drop_query(sq)
        return b""

    def _handle_register(self, peer: str, payload: bytes) -> bytes:
        req = wire.RegisterRequest.from_bytes(payload)   # crc-verified
        table = wire.ipc_to_table(req.ipc)
        df = self.session.create_dataframe(table)
        df.createOrReplaceTempView(req.name)
        return b""

    def _queries_open(self) -> int:
        with self._lock:
            return len(self._queries)

    def _handle_stats(self, peer: str, payload: bytes) -> bytes:
        sched = self.session.scheduler
        out = {"scheduler": sched.stats(),
               "serving": um.SERVING_METRICS.snapshot(),
               # lineage-recompute story: how often this replica repaired a
               # lost shuffle block by scoped re-execution instead of
               # failing the query over to another replica
               "shuffle": um.RECOMPUTE_METRICS.snapshot(),
               "queries_open": self._queries_open(),
               "state": "DRAINING" if self._draining else "UP",
               # this process's launches of the hand-written kernels (a
               # replica process is read through this RPC)
               "kernels": _kernel_counts(),
               # the rolling time-series load-aware routing consumes:
               # device budget in use, queue depths, running/queued per
               # tenant, p50/p99 query wall over the window — computed
               # server-side (serving/stats.py), shipped as JSON
               "serve_stats": sched.serve_stats.snapshot(sched)}
        return json.dumps(out, default=str).encode()

    def _handle_health(self, peer: str, payload: bytes) -> bytes:
        """Liveness + load probe: what circuit-breaker probes and
        load-aware routing consume — replica state plus the
        serve_stats rolling time-series (free budget after footprint
        charges, queue depths, p50/p99 wall)."""
        sched = self.session.scheduler
        return json.dumps({
            "state": "DRAINING" if self._draining else "UP",
            #: per-process identity: a restarted replica behind the same
            #: address reports a NEW id, telling clients to replay their
            #: temp-view registrations instead of trusting a stale ledger
            "replica_id": self.transport.executor_id,
            "queries_open": self._queries_open(),
            "serve_stats": sched.serve_stats.snapshot(sched),
        }, default=str).encode()

    def _handle_drain(self, peer: str, payload: bytes) -> bytes:
        self.drain()
        return json.dumps({"state": "DRAINING",
                           "queries_open": self._queries_open()}).encode()

    # ---- lifecycle ---------------------------------------------------------
    def drain(self) -> None:
        """Graceful drain (serve.drain RPC / SIGTERM): flip to DRAINING —
        new submissions are rejected with the retryable redirect, the
        scheduler stops accepting work, running queries finish and their
        streams flush — then serve_forever notices the empty query table
        and returns so the caller deregisters (transport shutdown removes
        the registry entry) and exits."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self.session.scheduler.start_draining()
        um.SERVING_METRICS[um.SERVING_DRAINS].add(1)

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once a DRAINING replica has nothing left to serve: every
        wire stream flushed (its query left ``_queries`` at DONE/ERROR)
        and every scheduler handle is terminal."""
        if not self._draining:
            return False
        with self._lock:
            if self._queries:
                return False
        return self.session.scheduler.drain(timeout=0)

    def _heartbeat_loop(self) -> None:
        while not self._stop_event.wait(self._heartbeat_s):
            self.transport.heartbeat()
    def _on_peer_lost(self, peer_id: str) -> None:
        """A client's connection died mid-stream: cancel its queries (the
        cooperative chain releases device-semaphore holds and catalog
        buffers), abandon their streams so producers never block on a
        reader that is gone, and free every parked frame."""
        with self._lock:
            self._lost_peers[peer_id] = None
            while len(self._lost_peers) > 1024:
                self._lost_peers.popitem(last=False)
            lost = [sq for sq in self._queries.values() if sq.peer == peer_id]
            for sq in lost:
                self._queries.pop(sq.handle.query_id, None)
        for sq in lost:
            sq.handle.cancel()
            sq.stream.abandon()
            with sq.lock:
                sq.parked = None
                sq.slices.clear()

    def serve_forever(self) -> None:
        """Block until shutdown() — or, once drain() flipped the replica
        to DRAINING, until every running query finished and every stream
        flushed. A BOUNDED poll (the R010 accept-loop discipline — an
        unbounded wait here would pin the process through signals and
        shutdown races), interrupt-friendly."""
        while not self._stop_event.wait(0.5):
            if self.drained():
                return

    def shutdown(self) -> None:
        self._stop_event.set()
        with self._lock:
            open_queries = list(self._queries.values())
            self._queries.clear()
        for sq in open_queries:
            sq.handle.cancel()
            sq.stream.abandon()
        self.transport.shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import os
    # pyarrow's mimalloc pool has crashed a process whose first pyarrow use
    # came from two threads at once; a replica's handlers are such threads
    os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
    ap = argparse.ArgumentParser(prog="spark_rapids_tpu_torch.serving.server")
    ap.add_argument("--port", type=int, default=None,
                    help="listen port (default serving.net.listenPort)")
    ap.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--tpch-lineitem", type=float, default=None,
                    metavar="SCALE",
                    help="register a generated TPC-H lineitem view")
    ap.add_argument("--partitions", type=int, default=1,
                    help="repartition registered views (multi-batch "
                         "result streams)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replica's queries run (default cuda; "
                         "with no GPU, cuda raises)")
    ap.add_argument("--store-fraction", type=float, default=None,
                    metavar="F",
                    help="share of the device's memory this replica's "
                         "store may take (memory.tpu.allocFraction); set "
                         "it when replicas share one card")
    args = ap.parse_args(argv)
    conf = {}
    for kv in args.conf:
        key, _, val = kv.partition("=")
        conf[key] = val
    if args.store_fraction is not None:
        conf[cfg.DEVICE_POOL_FRACTION.key] = args.store_fraction
    from spark_rapids_tpu_torch.api.dataframe import TpuSession
    session = TpuSession(conf, device=args.device)
    _ = session.scheduler       # wire the program-cache index first
    if args.tpch_lineitem is not None:
        from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
        df = session.create_dataframe(
            gen_lineitem(scale=args.tpch_lineitem, seed=args.seed))
        if args.partitions > 1:
            df = df.repartition(args.partitions)
        df.createOrReplaceTempView("lineitem")
    server = QueryServer(session, listen_port=args.port)
    host, port = server.address
    print(f"SERVING {host} {port}", flush=True)

    # SIGTERM = graceful drain (the orchestrator's stop signal): running
    # queries finish and streams flush before the process deregisters and
    # exits; a SECOND SIGTERM forces immediate shutdown
    import signal

    def _on_sigterm(signum, frame):
        if server.draining:
            server._stop_event.set()
        else:
            server.drain()
    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass                    # not the main thread (embedded use)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        session.scheduler.shutdown(wait=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
