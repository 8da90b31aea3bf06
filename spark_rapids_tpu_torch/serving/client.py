"""Query service client: resilient routing front end + streaming handles.

One ``QueryServiceClient`` speaks to N server replicas (server.py) through
ONE shuffle-transport instance — each replica is a dialed peer of the
TCP shuffle stack, addressed ``host:port``. Replicas come from explicit
addresses, from registry-dir discovery (``serving.net.registryDir``: the
shuffle rendezvous, heartbeat-mtime liveness, stale entries skipped and
garbage-collected), or both.

Routing is health-checked and load-aware (serving/health.py):

- every replica sits behind a **circuit breaker** — consecutive
  probe/submit/stream failures flip it OPEN, after which it receives
  ZERO submissions; only ``serve.health`` probes on the deterministic
  exponential-backoff schedule go there, and one success closes it;
- healthy replicas are scored by their latest ``serve.health`` snapshot
  (free device budget after footprint charges, queue depth, p99 wall)
  under ``serving.routing.policy=loadaware`` — the whale lands on the
  replica with free budget instead of round-robin roulette;
- a DRAINING replica (graceful drain in progress) is rerouted around
  transparently: its rejection is a retryable redirect, never a
  caller-visible error.

``RemoteQueryHandle.batches()`` streams partial results as the server
produces them. Fault handling mirrors the shuffle client: a checksum
mismatch on a result frame is a RETRYABLE fetch (deterministic backoff,
the parked server copy retransmits); a dead REPLICA mid-stream triggers
**failover with stream resume** for idempotent queries (the default for
pure SELECTs): the query is resubmitted to a healthy replica with
``resume_from=<last seq delivered>`` — the new replica re-runs and skips
already-delivered frames (dedup by seq), so ``collect()`` through a
mid-stream replica kill returns bit-identical results (float-agg
carve-out) with zero client-visible error. Non-idempotent or
failover-exhausted queries fail the handle with ``WireQueryError``
carrying ``batches_delivered`` — never a hang (every wait is bounded by
``serving.net.rpcTimeoutSeconds``).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from typing import Dict, List, Optional

import pyarrow as pa

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.serving import wire
from spark_rapids_tpu_torch.serving.health import (CircuitBreaker, ReplicaState,
                                             routing_score)
from spark_rapids_tpu_torch.serving.lifecycle import (OverloadedError,
                                                QuotaExceededError)
from spark_rapids_tpu_torch.shuffle import retry
from spark_rapids_tpu_torch.shuffle.codec import ChecksumError, verify_checksum
from spark_rapids_tpu_torch.shuffle.tcp import scan_registry
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                TransactionStatus)
from spark_rapids_tpu_torch.utils import metrics as um
from spark_rapids_tpu_torch.utils.errors import (OpaqueWireError, absorb,
                                           decode_error, triage_boundary)


class WireQueryError(RuntimeError):
    """A wire query failed (server error, lost connection, exhausted
    retries). ``batches_delivered`` counts result batches that arrived
    intact before the failure — the partial-progress contract.
    ``retryable`` distinguishes replica/transport-level failures (the
    query can fail over to another replica) from query-level ones (the
    SQL itself failed; rerunning elsewhere would fail the same way)."""

    def __init__(self, message: str, batches_delivered: int = 0,
                 retryable: bool = False):
        super().__init__(message)
        self.batches_delivered = batches_delivered
        self.retryable = retryable


def _decode_wire_error(blob) -> BaseException:
    """Rebuild the server-side exception from a NEXT_ERROR payload (the
    utils/errors.py wire codec); anything undecodable — including frames
    from a pre-codec server — degrades to OpaqueWireError."""
    try:
        payload = json.loads(blob)
        if not isinstance(payload, dict):
            raise ValueError(blob)
    except (TypeError, ValueError):
        return OpaqueWireError(str(blob))
    return decode_error(payload)


def _is_draining_error(err: BaseException) -> bool:
    """A DRAINING rejection is a retryable redirect, not a replica
    failure.  Decoded wire errors carry their taxonomy code; errors that
    rode a transport error-message string (the submit path) fall back to
    the type name the server put on the wire."""
    code = getattr(err, "wire_code", None)
    if code is not None:
        return code == "SCHEDULER_DRAINING"
    return "DrainingError" in str(err)


class RemoteQueryHandle:
    """Client-side identity of one wire-submitted query (its server-side
    incarnation may move between replicas across failovers)."""

    def __init__(self, client: "QueryServiceClient", replica: str, conn,
                 query_id: int, label: str, sql: str = "",
                 tenant: str = "default", timeout: float = 0.0,
                 idempotent: bool = True):
        self._client = client
        self._conn = conn
        self.replica = replica
        self.query_id = query_id
        self.label = label
        self.sql = sql
        self.tenant = tenant
        self.timeout_s = timeout
        #: whether a replica death mid-stream may resubmit this query to
        #: another replica (stream-resume failover). Auto-detected for
        #: SQL submissions: pure SELECTs are idempotent by default.
        self.idempotent = idempotent
        self.batches_delivered = 0
        #: completed failovers: each is one resubmission to a new replica
        self.failovers = 0
        #: terminal per-query snapshot from the server's DONE frame
        #: (queue/admission waits, program-cache hits incl. disk_hits,
        #: stream/preemption counts — the QueryHandle.snapshot() keys)
        self.metrics: Dict = {}
        self._tables: List[pa.Table] = []
        self._schema_ipc: bytes = b""
        self._done = False
        self._consumed = False
        #: highest batch seq delivered intact — what a failover resumes
        #: from (the new replica skips frames with seq <= this)
        self._last_seq = -1
        self._ack = -1
        #: True once THIS handle asked the server to cancel — separates
        #: a requested cancellation (terminal) from a server-side
        #: peer-lost/shutdown cancellation (replica loss: may fail over)
        self._cancel_sent = False

    # ---- streaming ---------------------------------------------------------
    def batches(self):
        """Yield result batches as the server streams them (partial
        results: the first batch arrives before the final one exists).
        Batches are NOT retained client-side — streaming consumption is
        memory-bounded; use ``result()`` instead for the assembled table.
        Abandoning the iterator early cancels the server-side query so
        its producer, permits and buffers release promptly."""
        yield from self._drive(retain=False)

    def _drive(self, retain: bool):
        if self._consumed:
            raise RuntimeError("batches() already consumed")
        self._consumed = True
        try:
            while True:
                try:
                    yield from self._stream_once(retain)
                    return
                except WireQueryError as e:
                    # replica death mid-stream: fail over with stream
                    # resume (idempotent queries only) — otherwise the
                    # error surfaces with its batches_delivered count
                    if not self._maybe_failover(e):
                        raise
        finally:
            # abandoned mid-stream (early break / GeneratorExit / error):
            # cancel server-side so the producer, its device permit and
            # the parked frames release now, not at client disconnect
            if not self._done:
                try:
                    self.cancel()
                except WireQueryError as e:
                    # terminal absorption: a cancel that failed while the
                    # stream is already unwinding must not mask the
                    # primary failure — counted, not propagated
                    absorb(e, "serving.client.stream_abandon_cancel")

    def _stream_once(self, retain: bool):
        """Drive the stream against the CURRENT replica until DONE; a
        replica/transport failure raises a retryable WireQueryError the
        failover layer above may absorb."""
        while True:
            resp = self._client._rpc(
                self._conn, wire.REQ_NEXT,
                wire.NextRequest(self.query_id, self._ack).to_bytes(),
                delivered=self.batches_delivered)
            self._ack = -1
            nr = wire.NextResponse.from_bytes(resp)
            if nr.kind == wire.NEXT_WAIT:
                continue
            if nr.kind == wire.NEXT_DONE:
                self.metrics = json.loads(nr.metrics_json or b"{}")
                self._schema_ipc = nr.schema_ipc
                self._done = True
                return
            if nr.kind == wire.NEXT_ERROR:
                # the QUERY failed server-side — rerunning it on another
                # replica would fail identically, so not retryable; the
                # decoded cause's taxonomy code rides along so callers
                # can classify (cancellation vs permanent) without
                # string-sniffing. One carve-out: a cancellation THIS
                # handle never requested is the replica's peer-lost /
                # shutdown cleanup racing the stream (the socket lived
                # just long enough to deliver the error) — that is
                # replica loss, not query failure, so it may fail over
                decoded = _decode_wire_error(nr.error)
                code = getattr(decoded, "wire_code", "OPAQUE")
                err = WireQueryError(
                    str(decoded), self.batches_delivered,
                    retryable=(code == "QUERY_CANCELLED"
                               and not self._cancel_sent))
                err.wire_code = code
                raise err
            table = self._fetch(nr)
            self.batches_delivered += 1
            self._last_seq = nr.seq
            self._ack = nr.seq
            if retain:
                self._tables.append(table)
            yield table

    @triage_boundary
    def _maybe_failover(self, err: WireQueryError) -> bool:
        """Resubmit to a healthy replica with ``resume_from=last seq
        delivered``; True when the stream may continue on a new conn,
        False when the original error should surface. Raises the
        structured rejection instead when the resubmission was shed or
        quota-bounced (retryable with a hint — not a dead fleet)."""
        c = self._client
        if not (err.retryable and self.idempotent and c.failover_enabled):
            return False
        if self.failovers >= c.failover_max_attempts:
            return False
        failed = self.replica
        st = c._replica_state(failed)
        if st is not None and not _is_draining_error(err):
            c._note_replica_failure(st)
        try:
            addr, conn, qid = c._submit_routed(
                self.sql, self.tenant, self.timeout_s, self.label,
                resume_from=self._last_seq, exclude={failed})
        except (OverloadedError, QuotaExceededError):
            # the failover resubmission was rejected at the front door:
            # the fleet is alive, just saturated (or the caller's quota
            # is burned). Surface the structured retryable rejection
            # WITH its retry-after hint — not the stale stream error —
            # so a displaced query rides the caller's normal overload
            # retry loop like any other resubmission
            raise
        except WireQueryError:
            # no healthy replica took it: surface the ORIGINAL stream
            # error with its batches_delivered count
            return False
        self.failovers += 1
        um.SERVING_METRICS[um.SERVING_FAILOVERS].add(1)
        self.replica, self._conn, self.query_id = addr, conn, qid
        self._ack = -1
        return True

    def _fetch(self, nr: wire.NextResponse) -> pa.Table:
        """Pull one parked frame: post a receive on a fresh tag, ask the
        server to push, verify the crc32. Corruption retries with the
        shuffle stack's deterministic backoff — the server retransmits
        its parked copy."""
        c = self._client
        last_err = "fetch failed"
        for attempt in range(c.max_retries + 1):
            tag = next(c._tags)
            buf = bytearray(nr.nbytes)
            rtx = self._conn.receive(
                AddressLengthTag(buf, nr.nbytes, tag), lambda tx: None)
            try:
                c._rpc(self._conn, wire.REQ_FETCH,
                       wire.FetchRequest(self.query_id, nr.seq,
                                         tag).to_bytes(),
                       delivered=self.batches_delivered)
                rtx.wait(c.rpc_timeout)
            except TimeoutError:
                # abandon the posted receive so the stale tag neither pins
                # its frame-sized buffer nor swallows a late retransmit
                self._cancel_receive(tag)
                last_err = (f"result frame seq {nr.seq} timed out after "
                            f"{c.rpc_timeout}s")
                self._backoff(attempt, nr.seq)
                continue
            except WireQueryError:
                self._cancel_receive(tag)
                raise
            if rtx.status is not TransactionStatus.SUCCESS:
                raise WireQueryError(
                    f"result stream lost at seq {nr.seq}: "
                    f"{rtx.error_message}", self.batches_delivered,
                    retryable=True)
            data = bytes(buf[:nr.nbytes])
            try:
                verify_checksum(data, nr.checksum,
                                context=f"query {self.query_id} "
                                        f"seq {nr.seq}")
            except ChecksumError as e:
                last_err = str(e)
                um.SERVING_METRICS[um.SERVING_WIRE_RETRIES].add(1)
                self._cancel_receive(tag)       # drop a straggling dup too
                self._backoff(attempt, nr.seq)
                continue
            # purge any duplicate frame (dup_frame chaos) that already
            # landed for this tag — it would otherwise park in the
            # transport's early-data table until the cap evicts it
            self._cancel_receive(tag)
            return wire.ipc_to_table(data)
        raise WireQueryError(
            f"{last_err} ({c.max_retries + 1} attempts)",
            self.batches_delivered, retryable=True)

    def _cancel_receive(self, tag: int) -> None:
        cancel = getattr(self._conn, "cancel_receive", None)
        if cancel is not None:
            cancel(tag)

    def _backoff(self, attempt: int, seq: int) -> None:
        time.sleep(retry.backoff_ms(
            attempt, self._client.backoff_ms, self._client.retry_seed,
            key=f"serve-fetch:{self.query_id}:{seq}") / 1e3)

    # ---- terminal results --------------------------------------------------
    def result(self) -> pa.Table:
        """Drain the stream and assemble the full table — bit-identical
        to the in-process ``collect()`` (float-agg carve-out per the
        documented contract), including through a mid-stream replica
        failover. A stream consumed via ``batches()`` was deliberately
        not retained; assemble it caller-side instead."""
        if not self._done:
            if self._consumed:
                raise RuntimeError(
                    "stream partially consumed; drain batches() first")
            for _ in self._drive(retain=True):
                pass
        if self._tables:
            return pa.concat_tables(self._tables)
        if self.batches_delivered:
            raise RuntimeError(
                "stream was consumed via batches() (not retained); "
                "assemble the batches caller-side or re-submit")
        return wire.ipc_to_table(self._schema_ipc)

    def cancel(self) -> None:
        self._cancel_sent = True
        self._client._rpc(self._conn, wire.REQ_CANCEL,
                          wire.CancelRequest(self.query_id).to_bytes(),
                          delivered=self.batches_delivered)


class QueryServiceClient:
    """Front end over N replicas: explicit ``["host:port", ...]``
    addresses, registry-dir discovery, or both."""

    def __init__(self, addresses=None, conf=None,
                 registry_dir: Optional[str] = None):
        from spark_rapids_tpu_torch.config import TpuConf
        self.conf = conf or TpuConf()
        if isinstance(addresses, str):
            addresses = [a.strip() for a in addresses.split(",") if a.strip()]
        self.addresses = list(addresses or [])
        self.registry_dir = (registry_dir if registry_dir is not None
                             else self.conf.get(cfg.SERVING_NET_REGISTRY))
        if not self.addresses and not self.registry_dir:
            raise ValueError(
                "QueryServiceClient needs >= 1 server address or a "
                "registry dir (serving.net.registryDir) to discover from")
        self.rpc_timeout = self.conf.get(cfg.SERVING_NET_RPC_TIMEOUT)
        self.max_retries = self.conf.shuffle_max_retries
        self.backoff_ms = self.conf.shuffle_retry_backoff_ms
        self.retry_seed = self.conf.get(cfg.SERVING_NET_FAULTS_SEED)
        self.failover_enabled = self.conf.get(cfg.SERVING_FAILOVER_ENABLED)
        self.failover_max_attempts = self.conf.get(
            cfg.SERVING_FAILOVER_MAX_ATTEMPTS)
        #: extra rotation passes when EVERY replica shed the submission
        #: (OverloadedError): each pass honors the shed retry-after hint,
        #: floored by the deterministic backoff for that attempt
        self.overload_retries = self.conf.get(
            cfg.SERVING_OVERLOAD_CLIENT_RETRIES)
        self.routing_policy = self.conf.get(cfg.SERVING_ROUTING_POLICY)
        self.probe_interval = self.conf.get(cfg.SERVING_HEALTH_PROBE_INTERVAL)
        self.probe_timeout = self.conf.get(cfg.SERVING_HEALTH_PROBE_TIMEOUT)
        self.liveness_window = self.conf.get(
            cfg.SERVING_HEALTH_LIVENESS_WINDOW)
        self._breaker_threshold = self.conf.get(cfg.SERVING_BREAKER_THRESHOLD)
        self._breaker_backoff_ms = self.conf.get(
            cfg.SERVING_BREAKER_BACKOFF_MS)
        # the client never passes a registry dir to its OWN transport —
        # publishing would list the client as a replica
        self._transport = wire.make_serving_transport(
            f"serve-client-{uuid.uuid4().hex[:8]}", self.conf, listen_port=0)
        self._lock = threading.Lock()
        #: addr -> ReplicaState (breaker, latest health snapshot,
        #: deferred-registration ledger); insertion order is the
        #: round-robin rotation
        self._replicas: "Dict[str, ReplicaState]" = {}
        #: registered temp views by name -> wire RegisterRequest bytes,
        #: replayed onto replicas that were down (or undiscovered) at
        #: broadcast time before the first submission routed to them
        self._registered: "Dict[str, bytes]" = {}
        self._last_scan = float("-inf")
        self._rr = itertools.count()
        #: client-chosen receive tags, unique across queries and retries
        self._tags = itertools.count(1 << 32)
        for addr in self.addresses:
            self._add_replica(addr, discovered=False)
        self._refresh_replicas(force=True)

    # ---- replica table -----------------------------------------------------
    def _add_replica(self, addr: str, discovered: bool) -> ReplicaState:
        st = ReplicaState(
            addr, CircuitBreaker(self._breaker_threshold,
                                 self._breaker_backoff_ms,
                                 seed=self.retry_seed, key=addr),
            discovered=discovered)
        self._replicas[addr] = st
        if addr not in self.addresses:
            self.addresses.append(addr)     # stable pin table
        return st

    def _replica_state(self, addr: str) -> Optional[ReplicaState]:
        with self._lock:
            return self._replicas.get(addr)

    def _refresh_replicas(self, force: bool = False) -> None:
        """Re-scan the registry dir (liveness-windowed: stale entries are
        skipped and garbage-collected) and fold the live set into the
        replica table — new replicas join the rotation, discovered ones
        whose entry aged out leave it."""
        if not self.registry_dir:
            return
        now = time.monotonic()
        with self._lock:
            # check-and-set under the lock: two submitting threads must
            # not both decide the scan is due and double-scan (R012)
            if not force and now - self._last_scan < self.probe_interval:
                return
            self._last_scan = now
        try:
            live = scan_registry(self.registry_dir,
                                 stale_after_s=self.liveness_window)
        except OSError:
            return      # registry unreadable RIGHT NOW (transient FS
            # hiccup) — keep the previous view; an empty fleet is only
            # believed when the scan actually succeeded
        addrs = set(live.values())
        with self._lock:
            for addr in sorted(addrs):
                if addr not in self._replicas:
                    self._add_replica(addr, discovered=True)
            for addr, st in list(self._replicas.items()):
                if st.discovered and addr not in addrs:
                    del self._replicas[addr]    # heartbeat stopped: dead

    def replica_states(self) -> List[ReplicaState]:
        with self._lock:
            return list(self._replicas.values())

    # ---- plumbing ----------------------------------------------------------
    def _connection(self, addr: str):
        # the transport caches live connections and EVICTS dead ones
        # (peer-lost handling in tcp.py / the fault wrapper), so asking it
        # each time re-dials a dropped replica; a second cache here would
        # pin a dead socket past its eviction
        return self._transport.connect(addr)

    def _rpc(self, conn, req_type: str, payload: bytes,
             delivered: int = 0, timeout: Optional[float] = None) -> bytes:
        tx = conn.request(req_type, payload, lambda t: None)
        try:
            tx.wait(timeout if timeout is not None else self.rpc_timeout)
        except TimeoutError:
            raise WireQueryError(
                f"{req_type} timed out after {self.rpc_timeout}s",
                delivered, retryable=True) from None
        if tx.status is not TransactionStatus.SUCCESS:
            raise WireQueryError(
                f"{req_type} failed: {tx.error_message}", delivered,
                retryable=True)
        return tx.response

    # ---- health + routing --------------------------------------------------
    @triage_boundary
    def _note_replica_failure(self, st: ReplicaState) -> None:
        """Feed one failure to the replica's breaker; a breaker that just
        OPENED declares the replica dead, so its registration ledger is
        reset — a NEW process behind the same address (restart) has none
        of the old incarnation's temp views and must get them replayed.
        The ledger is a plain set shared by every submitting thread, so
        every mutation takes the client lock (R012)."""
        st.breaker.record_failure()
        if not st.breaker.allow_submit():
            with self._lock:
                st.registered.clear()

    def _probe(self, st: ReplicaState) -> bool:
        """One serve.health probe: refresh the replica's stats/DRAINING
        flag and feed its breaker. Failures are breaker failures."""
        st.last_probe = time.monotonic()
        try:
            payload = self._rpc(self._connection(st.addr), wire.REQ_HEALTH,
                                b"", timeout=self.probe_timeout)
            doc = json.loads(payload)
        except (WireQueryError, ConnectionError, OSError, ValueError):
            st.stats = None
            self._note_replica_failure(st)
            return False
        st.stats = doc.get("serve_stats") or {}
        st.draining = doc.get("state") == "DRAINING"
        incarnation = doc.get("replica_id")
        if incarnation:
            if st.incarnation is not None and st.incarnation != incarnation:
                # a DIFFERENT process answered on this address (restart
                # faster than the breaker threshold could notice): it has
                # none of the old incarnation's temp views — replay them
                with self._lock:
                    st.registered.clear()
            st.incarnation = incarnation
        st.breaker.record_success()
        return True

    def _pick(self, exclude) -> str:
        """Choose the replica for one new submission: probe what's due,
        drop OPEN-breaker and DRAINING replicas, then score the healthy
        set (loadaware) or rotate (roundrobin)."""
        self._refresh_replicas()
        with self._lock:
            states = [s for a, s in self._replicas.items()
                      if a not in exclude]
        if not states:
            raise WireQueryError("no replicas known (every address "
                                 "excluded or discovery found none)")
        now = time.monotonic()
        probed_dead = set()
        for st in states:
            if st.breaker.allow_submit():
                if now - st.last_probe >= self.probe_interval:
                    if not self._probe(st):
                        # the probe JUST failed: even if the breaker is
                        # still CLOSED (under threshold), don't route a
                        # submission into the failed dial we predicted
                        # milliseconds ago
                        probed_dead.add(st.addr)
            elif st.breaker.probe_due(now):
                # OPEN breaker past its backoff: ONE health-probe trial —
                # submissions never route here until a probe succeeds
                self._probe(st)
        candidates = [s for s in states
                      if s.routable and s.addr not in probed_dead]
        if not candidates:
            raise WireQueryError(
                f"no healthy replica ({len(states)} known: all behind an "
                f"OPEN breaker or DRAINING)")
        if self.routing_policy == "loadaware":
            scores = [routing_score(s.stats) for s in candidates]
            best = max(scores)
            tied = [s for s, sc in zip(candidates, scores)
                    if sc >= best - 1e-9]
        else:
            tied = candidates
        return tied[next(self._rr) % len(tied)].addr

    def _route(self, replica: Optional[int]) -> str:
        """Pinned routing (tests / per-replica introspection): index into
        the stable pin table, bypassing health checks."""
        if replica is not None:
            with self._lock:
                # discovery appends to the pin table concurrently (R012)
                addresses = list(self.addresses)
            return addresses[replica % len(addresses)]
        return self._pick(exclude=())

    def _ensure_registered(self, st: ReplicaState, conn) -> None:
        """Replay any temp-view registrations this replica missed (it was
        down, DRAINING, or undiscovered during the broadcast) before
        routing a submission to it — the deferred re-register contract."""
        with self._lock:
            missing = [(n, req) for n, req in self._registered.items()
                       if n not in st.registered]
        for name, req in missing:
            # the RPC stays OUTSIDE the lock (R006); only the ledger
            # mutation itself takes it (R012)
            self._rpc(conn, wire.REQ_REGISTER, req)
            with self._lock:
                st.registered.add(name)

    # ---- API ---------------------------------------------------------------
    @staticmethod
    def _sql_idempotent(sql: str) -> bool:
        """Pure reads are safe to re-run on another replica; anything
        else must opt in explicitly via ``submit(idempotent=True)``."""
        head = sql.lstrip().lstrip("(").lstrip().lower()
        return head.startswith(("select", "with", "values", "show",
                                "describe", "explain"))

    def _submit_routed(self, sql: str, tenant: str, timeout: float,
                       label: str, resume_from: int = -1,
                       replica: Optional[int] = None, exclude=()):
        """Route one submission, rerouting around dead and DRAINING
        replicas; returns ``(addr, conn, query_id)``. Pinned submissions
        (``replica=``) never reroute — tests rely on the pin being
        absolute. When EVERY routable replica SHEDS the submission
        (structured OverloadedError), the rotation retries up to
        ``serving.overload.clientRetries`` more passes, sleeping the shed
        retry-after hint (floored by the deterministic backoff for the
        attempt) between passes, then surfaces the OverloadedError."""
        req = wire.SubmitRequest(sql, tenant, timeout, label,
                                 resume_from).to_bytes()
        shed: Optional[OverloadedError] = None
        for attempt in range(self.overload_retries + 1):
            if shed is not None:
                # every replica shed last pass: honor the server's hint —
                # the whole point of retry-after is that the SERVER knows
                # its drain rate — but never sleep less than the seeded
                # backoff schedule for this attempt (thundering-herd
                # hygiene when many clients got the same hint)
                hint = getattr(shed, "retry_after_s", 0.0) or 0.0
                floor_s = retry.backoff_ms(
                    attempt - 1, self.backoff_ms, self.retry_seed,
                    key=f"serve-overload:{label or sql[:48]}") / 1e3
                time.sleep(max(hint, floor_s))
            try:
                return self._submit_pass(req, replica, set(exclude))
            except OverloadedError as e:
                shed = e
                if replica is not None:
                    raise               # pinned: the pin is the contract
        raise shed

    def _submit_pass(self, req: bytes, replica: Optional[int], exclude):
        """One rotation pass over the routable replicas. Raises
        OverloadedError when nobody accepted and at least one replica
        shed (the caller's retry-after loop owns that — a shed is a live
        replica that will take the query later); QuotaExceededError
        surfaces immediately — the quota is per CLIENT, so shopping the
        submission to another replica just burns its quota there too."""
        with self._lock:
            bound = len(self._replicas) + 1
        last_err: Optional[WireQueryError] = None
        last_shed: Optional[OverloadedError] = None
        for _ in range(max(2, bound)):
            if replica is not None:
                addr = self._route(replica)
            else:
                try:
                    addr = self._pick(exclude)
                except WireQueryError:
                    # routing exhausted: a shed outranks everything — it
                    # proves a LIVE replica that will take the query
                    # later, and it carries the actionable retry-after
                    # hint; a dial/submission error outranks only the
                    # generic no-replica error
                    if last_shed is not None:
                        raise last_shed
                    if last_err is not None:
                        raise last_err
                    raise
            st = self._replica_state(addr)
            try:
                conn = self._connection(addr)
                if st is not None:
                    self._ensure_registered(st, conn)
                resp = wire.SubmitResponse.from_bytes(
                    self._rpc(conn, wire.REQ_SUBMIT, req))
            except (WireQueryError, ConnectionError, OSError) as e:
                err = (e if isinstance(e, WireQueryError)
                       else WireQueryError(str(e), retryable=True))
                if replica is not None:
                    raise err           # pinned: the pin is the contract
                if st is not None:
                    if _is_draining_error(err):
                        # retryable redirect: the replica is healthy but
                        # leaving — reroute without a breaker failure
                        st.draining = True
                    else:
                        self._note_replica_failure(st)
                exclude.add(addr)
                last_err = err
                continue
            if st is not None:
                # any structured answer — accept, shed or quota — is a
                # LIVE replica: the breaker tracks reachability, not load
                st.breaker.record_success()
            if resp.error_json:
                decoded = _decode_wire_error(resp.error_json)
                if isinstance(decoded, QuotaExceededError):
                    raise decoded
                if isinstance(decoded, OverloadedError):
                    if replica is not None:
                        raise decoded
                    exclude.add(addr)
                    last_shed = decoded
                    continue
                raise decoded           # unknown structured rejection
            return addr, conn, resp.query_id
        # a shed outranks a dead-replica error: mixed passes (one replica
        # down, another at its bound) surface the structured retryable
        # signal with its hint, not the opaque dial failure
        if last_shed is not None:
            raise last_shed
        raise last_err or WireQueryError(
            "no replica accepted the submission")

    def submit(self, sql: str, tenant: str = "default",
               timeout: float = 0.0, label: str = "",
               replica: Optional[int] = None,
               idempotent: Optional[bool] = None) -> RemoteQueryHandle:
        """Submit SQL to one replica (health-checked load-aware routing
        unless pinned); returns a streaming handle immediately.
        ``idempotent=None`` auto-detects (pure SELECTs may fail over with
        stream resume; anything else fails the handle on replica death)."""
        if idempotent is None:
            idempotent = self._sql_idempotent(sql)
        addr, conn, query_id = self._submit_routed(
            sql, tenant, timeout, label, replica=replica)
        return RemoteQueryHandle(self, addr, conn, query_id, label,
                                 sql=sql, tenant=tenant, timeout=timeout,
                                 idempotent=idempotent)

    def register_table(self, name: str, table: pa.Table) -> None:
        """Register ``table`` as a temp view on EVERY reachable replica.
        A down replica does NOT brick the client: its registration is
        deferred and replayed on the first successful route to it (see
        ``_ensure_registered``); only zero reachable replicas raise."""
        data = wire.table_to_ipc(table)
        req = wire.RegisterRequest(name, data).to_bytes()
        self._refresh_replicas()
        with self._lock:
            self._registered[name] = req
            states = list(self._replicas.values())
        delivered = 0
        errors: List[str] = []
        for st in states:
            try:
                self._rpc(self._connection(st.addr), wire.REQ_REGISTER, req)
            except (WireQueryError, ConnectionError, OSError) as e:
                self._note_replica_failure(st)
                errors.append(f"{st.addr}: {e}")
                continue
            with self._lock:
                st.registered.add(name)
            st.breaker.record_success()
            delivered += 1
        if states and not delivered:
            raise WireQueryError(
                f"register_table {name!r} reached no replica: "
                f"{'; '.join(errors)}", retryable=True)

    def drain_replica(self, replica: int = 0) -> Dict:
        """Ask one replica to drain gracefully (running queries finish,
        new submissions reroute); returns the server's drain ack."""
        addr = self._route(replica)
        out = json.loads(self._rpc(self._connection(addr),
                                   wire.REQ_DRAIN, b""))
        st = self._replica_state(addr)
        if st is not None:
            st.draining = True
        return out

    def health(self, replica: int = 0) -> Dict:
        """One replica's serve.health payload (state + serve_stats)."""
        addr = self._route(replica)
        return json.loads(self._rpc(self._connection(addr),
                                    wire.REQ_HEALTH, b"",
                                    timeout=self.probe_timeout))

    def stats(self, replica: int = 0) -> Dict:
        """One replica's scheduler/program-cache/serving counters (the
        warm-start probe reads disk_hits here)."""
        addr = self._route(replica)
        return json.loads(self._rpc(self._connection(addr),
                                    wire.REQ_STATS, b""))

    def close(self) -> None:
        self._transport.shutdown()
