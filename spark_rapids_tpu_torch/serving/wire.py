"""Serving wire protocol: Arrow IPC over the TCP shuffle machinery.

No new plumbing: the query service speaks through the existing
``ShuffleTransport`` traits — the framed TCP socket layer (shuffle/tcp.py:
kind/tag/length frames, hello handshake, per-peer reader threads,
peer-lost scoped failure), the deterministic retry/backoff schedule
(shuffle/retry.py), the crc32 checksum discipline (shuffle/codec.py) and
the chaos harness (shuffle/faults.py ``FaultInjectingTransport``, selected
by ``serving.net.faults.plan``). Control messages ride ``request()`` RPCs
(struct-packed like shuffle/messages.py); result batches ride
tag-addressed data frames as Arrow IPC streams, verified client-side
against the server's crc32 — corruption is a retryable fetch, exactly the
shuffle TransferResponse contract.

The stream protocol (pull-based, one parked batch per query — bounded
state on both ends):

1. ``serve.submit`` {sql, tenant, timeout, label} -> {query_id}
2. loop ``serve.next`` {query_id, ack_seq} ->
   WAIT (nothing ready inside the bounded server poll; re-ask)
   | BATCH {seq, nbytes, crc32}  (parked server-side until acked)
   | DONE {batches, metrics json, schema ipc}
   | ERROR {message}
3. on BATCH: post a receive for a fresh client tag, ``serve.fetch``
   {query_id, seq, tag} -> the server pushes the Arrow-IPC frame to that
   tag. Checksum mismatch -> backoff + re-fetch (the parked copy
   retransmits); the NEXT ``serve.next`` carries ack_seq, releasing it.
4. ``serve.cancel`` {query_id} / client disconnect both release every
   server-side resource through the cooperative-cancel chain.

``serve.register`` uploads an Arrow-IPC table to register as a temp view
(how tests and the routing client seed every replica identically), and
``serve.stats`` exposes scheduler + program-cache + serving counters —
the two-replica warm-start probe reads its ``disk_hits`` through this.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch.shuffle.codec import checksum_of, verify_checksum

REQ_SUBMIT = "serve.submit"
REQ_NEXT = "serve.next"
REQ_FETCH = "serve.fetch"
REQ_CANCEL = "serve.cancel"
REQ_REGISTER = "serve.register"
REQ_STATS = "serve.stats"
#: liveness + load probe: {"state": "UP"|"DRAINING", "serve_stats": ...}
#: (the rolling time-series) — what circuit-breaker probes and
#: load-aware routing consume; deliberately cheaper than serve.stats
REQ_HEALTH = "serve.health"
#: graceful drain: flip the replica to DRAINING (new submits are
#: rejected with a retryable redirect, running queries finish, streams
#: flush, then the server deregisters and exits)
REQ_DRAIN = "serve.drain"

#: serve.next response kinds
NEXT_WAIT = 0
NEXT_BATCH = 1
NEXT_DONE = 2
NEXT_ERROR = 3

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return _U32.pack(len(b)) + b


def _unpack_str(buf: bytes, pos: int) -> Tuple[str, int]:
    n, = _U32.unpack_from(buf, pos)
    pos += 4
    return buf[pos:pos + n].decode(), pos + n


def _pack_blob(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def _unpack_blob(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, = _U32.unpack_from(buf, pos)
    pos += 4
    return buf[pos:pos + n], pos + n


# ------------------------------------------------------------ Arrow IPC
def table_to_ipc(table: pa.Table) -> bytes:
    """Arrow IPC stream bytes of one result batch (the wire format the
    paper's client surface speaks; deterministic for a given table)."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def ipc_to_table(data: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.BufferReader(data)) as reader:
        return reader.read_all()


def schema_to_ipc(schema: pa.Schema) -> bytes:
    """Schema-only IPC stream (the DONE frame carries it so a zero-batch
    result still assembles to the correctly-typed empty table)."""
    return table_to_ipc(schema.empty_table())


# ------------------------------------------------------------- messages
@dataclass(frozen=True)
class SubmitRequest:
    sql: str
    tenant: str = "default"
    timeout: float = 0.0
    label: str = ""
    #: stream-resume failover: the last batch sequence number the client
    #: already holds from a replica that died mid-stream. The server
    #: re-runs the query and SKIPS frames with seq <= resume_from (dedup
    #: by seq — exactly-once delivery to the caller); -1 is a fresh run.
    resume_from: int = -1

    def to_bytes(self) -> bytes:
        return (_pack_str(self.sql) + _pack_str(self.tenant)
                + _F64.pack(self.timeout) + _pack_str(self.label)
                + _I64.pack(self.resume_from))

    @staticmethod
    def from_bytes(buf: bytes) -> "SubmitRequest":
        sql, pos = _unpack_str(buf, 0)
        tenant, pos = _unpack_str(buf, pos)
        timeout, = _F64.unpack_from(buf, pos)
        pos += 8
        label, pos = _unpack_str(buf, pos)
        resume_from, = _I64.unpack_from(buf, pos)
        return SubmitRequest(sql, tenant, timeout, label, resume_from)


@dataclass(frozen=True)
class SubmitResponse:
    query_id: int
    #: structured front-door rejection (overload shed / quota): an
    #: ``encode_error`` JSON payload — query_id 0, no handle was created.
    #: Empty for accepted submissions. Rides the SUCCESS response path
    #: because the transport's error path is a bare string (type: message)
    #: that cannot carry the taxonomy's structured fields (retry_after_s).
    error_json: bytes = b""

    def to_bytes(self) -> bytes:
        return _U64.pack(self.query_id) + _pack_blob(self.error_json)

    @staticmethod
    def from_bytes(buf: bytes) -> "SubmitResponse":
        qid, = _U64.unpack_from(buf, 0)
        if len(buf) <= 8:       # pre-elasticity peer: no rejection blob
            return SubmitResponse(qid)
        ej, _pos = _unpack_blob(buf, 8)
        return SubmitResponse(qid, error_json=ej)


@dataclass(frozen=True)
class NextRequest:
    query_id: int
    ack_seq: int = -1           # -1: nothing to acknowledge

    def to_bytes(self) -> bytes:
        return _U64.pack(self.query_id) + _I64.pack(self.ack_seq)

    @staticmethod
    def from_bytes(buf: bytes) -> "NextRequest":
        qid, = _U64.unpack_from(buf, 0)
        ack, = _I64.unpack_from(buf, 8)
        return NextRequest(qid, ack)


@dataclass(frozen=True)
class NextResponse:
    kind: int                   # NEXT_WAIT | NEXT_BATCH | NEXT_DONE | NEXT_ERROR
    seq: int = 0                # BATCH
    nbytes: int = 0             # BATCH
    checksum: int = 0           # BATCH (crc32 over the IPC frame)
    batches: int = 0            # DONE: total batches streamed
    metrics_json: bytes = b""   # DONE: the handle's terminal snapshot
    schema_ipc: bytes = b""     # DONE: schema-only IPC stream
    error: str = ""             # ERROR

    def to_bytes(self) -> bytes:
        head = struct.pack("<B", self.kind)
        if self.kind == NEXT_BATCH:
            return head + struct.pack("<III", self.seq, self.nbytes,
                                      self.checksum)
        if self.kind == NEXT_DONE:
            return (head + _U32.pack(self.batches)
                    + _pack_blob(self.metrics_json)
                    + _pack_blob(self.schema_ipc))
        if self.kind == NEXT_ERROR:
            return head + _pack_str(self.error)
        return head

    @staticmethod
    def from_bytes(buf: bytes) -> "NextResponse":
        kind, = struct.unpack_from("<B", buf, 0)
        if kind == NEXT_BATCH:
            seq, nbytes, crc = struct.unpack_from("<III", buf, 1)
            return NextResponse(kind, seq=seq, nbytes=nbytes, checksum=crc)
        if kind == NEXT_DONE:
            batches, = _U32.unpack_from(buf, 1)
            mj, pos = _unpack_blob(buf, 5)
            si, pos = _unpack_blob(buf, pos)
            return NextResponse(kind, batches=batches, metrics_json=mj,
                                schema_ipc=si)
        if kind == NEXT_ERROR:
            err, _pos = _unpack_str(buf, 1)
            return NextResponse(kind, error=err)
        return NextResponse(kind)


@dataclass(frozen=True)
class FetchRequest:
    query_id: int
    seq: int
    tag: int                    # client-chosen tag the frame is pushed to

    def to_bytes(self) -> bytes:
        return _U64.pack(self.query_id) + _U32.pack(self.seq) \
            + _U64.pack(self.tag)

    @staticmethod
    def from_bytes(buf: bytes) -> "FetchRequest":
        qid, = _U64.unpack_from(buf, 0)
        seq, = _U32.unpack_from(buf, 8)
        tag, = _U64.unpack_from(buf, 12)
        return FetchRequest(qid, seq, tag)


@dataclass(frozen=True)
class CancelRequest:
    query_id: int

    def to_bytes(self) -> bytes:
        return _U64.pack(self.query_id)

    @staticmethod
    def from_bytes(buf: bytes) -> "CancelRequest":
        return CancelRequest(_U64.unpack_from(buf, 0)[0])


@dataclass(frozen=True)
class RegisterRequest:
    name: str
    ipc: bytes
    checksum: int = 0

    def to_bytes(self) -> bytes:
        return (_pack_str(self.name) + _pack_blob(self.ipc)
                + _U32.pack(self.checksum or checksum_of(self.ipc)))

    @staticmethod
    def from_bytes(buf: bytes) -> "RegisterRequest":
        name, pos = _unpack_str(buf, 0)
        ipc, pos = _unpack_blob(buf, pos)
        crc, = _U32.unpack_from(buf, pos)
        verify_checksum(ipc, crc, context=f"register {name!r}")
        return RegisterRequest(name, ipc, crc)


# ------------------------------------------------------ transport wiring
def make_serving_transport(executor_id: str, conf, listen_port: Optional[int]
                           = None, registry_dir: str = ""):
    """Build the query service's transport from the serving.net.* conf:
    the configured transport class (TCP by default) bound to the serving
    listen port, wrapped in the FaultInjectingTransport when a wire-chaos
    plan is set — the shuffle chaos harness applied verbatim to the
    serving wire. ``registry_dir`` (servers only: replica discovery +
    liveness heartbeats ride the registry file's mtime) defaults to ""
    so CLIENTS never publish themselves as replicas."""
    import importlib
    from spark_rapids_tpu_torch import config as cfg
    overrides = {
        cfg.SHUFFLE_TCP_PORT.key: (listen_port if listen_port is not None
                                   else conf.get(cfg.SERVING_NET_PORT)),
        cfg.SHUFFLE_TCP_REGISTRY.key: registry_dir,
    }
    plan = conf.get(cfg.SERVING_NET_FAULTS_PLAN)
    cls_name = conf.get(cfg.SERVING_NET_TRANSPORT)
    if plan:
        overrides[cfg.SHUFFLE_FAULTS_TRANSPORT.key] = cls_name
        overrides[cfg.SHUFFLE_FAULTS_PLAN.key] = plan
        overrides[cfg.SHUFFLE_FAULTS_SEED.key] = conf.get(
            cfg.SERVING_NET_FAULTS_SEED)
        cls_name = ("spark_rapids_tpu_torch.shuffle.faults."
                    "FaultInjectingTransport")
    tconf = conf.with_overrides(overrides)
    mod_name, _, cls = cls_name.rpartition(".")
    return getattr(importlib.import_module(mod_name), cls)(executor_id,
                                                           tconf)
