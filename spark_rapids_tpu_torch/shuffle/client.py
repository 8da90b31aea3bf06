"""Shuffle client: fetch protocol state machine.

The JAX package's ``shuffle/client.py``; RapidsShuffleClient's role:
metadata request →
TableMetas → PendingTransferRequests → BufferReceiveState:108 walking receive
bounce buffers, consumeBuffers:193 assembling the target buffer, then handing
the received buffer id to the fetch handler. The inflight throttle
(queuePending / maxReceiveInflightBytes) gates how many bytes of transfers are
outstanding per client.

Fault tolerance on top of the reference protocol:

- the metadata RPC and each per-block transfer retry transient failures
  under ``spark.rapids.tpu.shuffle.maxRetries`` / ``.retryBackoffMs``
  (deterministic-jitter exponential backoff; retries re-issue on a timer
  thread, never on the transport's progress thread);
- every assembled buffer is verified against the server's crc32
  (TransferResponse.checksum) before decompression — corruption is a
  retryable error, not a wrong answer;
- a fetch fails AT MOST ONCE per attempt, and the error names exactly the
  blocks that were not delivered, so the reader (or the lineage recompute)
  re-fetches only those.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.parallel.mesh_batch import count_host_hop
from spark_rapids_tpu_torch.shuffle import messages as msg
from spark_rapids_tpu_torch.shuffle import retry
from spark_rapids_tpu_torch.shuffle.catalog import (ReceivedBufferCatalog,
                                              ShuffleBlockId)
from spark_rapids_tpu_torch.shuffle.codec import (ChecksumError, decompress_batch,
                                            verify_checksum)
from spark_rapids_tpu_torch.shuffle.table_meta import TableMeta
from spark_rapids_tpu_torch.shuffle.transport import (AddressLengthTag,
                                                ClientConnection,
                                                ShuffleTransport, Transaction,
                                                TransactionStatus)
from spark_rapids_tpu_torch.utils import metrics as mt
from spark_rapids_tpu_torch.utils.errors import triage_boundary


class ShuffleFetchHandler:
    """Callbacks a task iterator registers for one fetch
    (RapidsShuffleFetchHandler analog)."""

    def start(self, expected_tables: int,
              tables: Sequence[Tuple[ShuffleBlockId, int]] = ()) -> None:
        """``tables`` enumerates the (block, table_idx) pairs this fetch will
        deliver — the reader's completion/dedup bookkeeping."""

    def batch_received(self, received_id: int,
                       block: Optional[ShuffleBlockId] = None,
                       table_idx: int = 0) -> None: ...

    def transfer_error(self, message: str,
                       failed_blocks: Sequence[ShuffleBlockId] = (),
                       permanent: bool = False) -> None:
        """``failed_blocks`` are the blocks with ≥1 undelivered table — the
        scope of a retry/recompute; blocks already delivered are excluded.
        ``permanent`` marks failures a re-fetch cannot fix (lost blocks):
        the reader must skip its retries and surface the recompute signal."""


class PendingTransferRequest:
    """One table awaiting transfer (PendingTransferRequest analog)."""

    def __init__(self, block: ShuffleBlockId, table_idx: int, meta: TableMeta):
        self.block = block
        self.table_idx = table_idx
        self.meta = meta


class _FetchState:
    """Bookkeeping for one fetch() call: which (block, table_idx) pairs are
    still undelivered, and a fail-once latch so concurrent transfer failures
    collapse into ONE transfer_error carrying the precise failure scope."""

    def __init__(self, blocks: Sequence[ShuffleBlockId],
                 handler: ShuffleFetchHandler):
        self.blocks = tuple(blocks)
        self.handler = handler
        self._lock = threading.Lock()
        self._pending: Set[Tuple[ShuffleBlockId, int]] = set()
        self._failed = False

    def register(self, tables: Sequence[Tuple[ShuffleBlockId, int]]) -> None:
        with self._lock:
            self._pending.update(tables)

    def mark_delivered(self, block: ShuffleBlockId, table_idx: int) -> None:
        with self._lock:
            self._pending.discard((block, table_idx))

    @property
    def failed(self) -> bool:
        with self._lock:
            return self._failed

    def fail(self, message: str, permanent: bool = False) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
            failed_blocks = tuple(sorted({b for b, _ in self._pending}))
        self.handler.transfer_error(message, failed_blocks, permanent)


class BufferReceiveState:
    """Receives one table's packed buffer as chunked tag-addressed receives
    through the bounce pool, assembling into the final target buffer
    (BufferReceiveState + consumeBuffers analog)."""

    def __init__(self, client: "ShuffleClient", base_tag: int, wire_size: int,
                 chunk_size: int,
                 on_done: Callable[[Optional[bytearray], Optional[str]], None]):
        self.client = client
        self.base_tag = base_tag
        self.chunk_size = chunk_size
        self.wire_size = wire_size
        self.target = bytearray(wire_size)
        self.num_chunks = max(1, -(-wire_size // chunk_size))
        self._next_chunk = 0
        self._outstanding = 0
        self._failed = False
        self._lock = threading.Lock()
        self._on_done = on_done

    def start(self) -> None:
        window = min(self.num_chunks, 4)
        bounces = self.client.transport.recv_bounce.acquire(window)
        with self._lock:
            for bb in bounces:
                self._arm(bb)

    def _arm(self, bounce) -> None:
        i = self._next_chunk
        if i >= self.num_chunks or self._failed:
            bounce.close()
            if self._outstanding == 0:
                done, self._on_done = self._on_done, None
                if done is not None and not self._failed:
                    done(self.target, None)
            return
        self._next_chunk += 1
        self._outstanding += 1
        start = i * self.chunk_size
        length = min(self.chunk_size, self.wire_size - start)
        alt = AddressLengthTag(bounce.buffer, length, self.base_tag + i)

        def on_rx(tx: Transaction, bounce=bounce, i=i, start=start, length=length):
            with self._lock:
                self._outstanding -= 1
                if tx.status is not TransactionStatus.SUCCESS:
                    first_error = not self._failed
                    self._failed = True
                    bounce.close()
                    if first_error:
                        done, self._on_done = self._on_done, None
                        if done is not None:
                            done(None, tx.error_message or "receive failed")
                    return
                self.target[start:start + length] = \
                    memoryview(bounce.buffer)[:length]
                self._arm(bounce)
        self.client.connection.receive(alt, on_rx)


class ShuffleClient:
    """Per-peer fetch driver (RapidsShuffleClient analog)."""

    _tag_seq = itertools.count(1)

    def __init__(self, transport: ShuffleTransport,
                 connection: ClientConnection,
                 received_catalog: ReceivedBufferCatalog,
                 codec_name: str = "none"):
        self.transport = transport
        self.connection = connection
        self.received = received_catalog
        self.codec_name = codec_name
        if codec_name not in ("none", "copy"):
            # fail fast with the registry's ONE well-formed error on a
            # mistyped/unavailable codec conf, instead of erroring deep in
            # decompress after bytes already crossed the wire
            from spark_rapids_tpu_torch.shuffle.codec import get_codec
            get_codec(codec_name, transport.conf)
        self.chunk_size = transport.send_bounce.buffer_size
        conf = transport.conf
        self.max_retries = conf.shuffle_max_retries
        self.backoff_ms = conf.shuffle_retry_backoff_ms
        self.retry_seed = conf.shuffle_faults_seed
        self.verify_checksums = conf.shuffle_checksum_enabled
        self.metrics = transport.metrics

    # ---- protocol --------------------------------------------------------------
    def fetch(self, blocks: List[ShuffleBlockId],
              handler: ShuffleFetchHandler) -> None:
        """Fetch all tables of ``blocks`` from this peer; async — results land
        via handler callbacks."""
        if not blocks:
            handler.start(0, ())
            return
        state = _FetchState(blocks, handler)
        self._request_metadata(state, attempt=0)

    def _request_metadata(self, state: _FetchState, attempt: int) -> None:
        blocks = state.blocks
        req = msg.MetadataRequest(blocks[0].shuffle_id,
                                  blocks[0].partition_id, blocks)

        def on_meta(tx: Transaction):
            if tx.status is not TransactionStatus.SUCCESS:
                self._retry_metadata(
                    state, attempt, tx.error_message or "metadata failed")
                return
            resp = msg.MetadataResponse.from_bytes(tx.response)
            pending = [PendingTransferRequest(b, i, m)
                       for b, i, m in resp.tables]
            # the tracker only lists non-empty blocks, so a requested block the
            # server no longer has is a lost block, not an empty one — NOT
            # transient (no retry): only a map recompute brings it back
            answered = {p.block for p in pending}
            missing = [b for b in blocks if b not in answered]
            if missing:
                # register EVERY requested block, not just the missing ones:
                # the answered blocks' transfers are never issued either, so
                # the ShuffleFetchFailedError must scope the whole
                # undelivered set for the recompute round to be complete on
                # the first signal
                state.register([(b, 0) for b in blocks])
                state.fail(
                    f"peer {self.connection.peer_executor_id} lost blocks: "
                    f"{missing[:3]}{'...' if len(missing) > 3 else ''}",
                    permanent=True)
                return
            tables = [(p.block, p.table_idx) for p in pending]
            state.register(tables)
            state.handler.start(len(pending), tables)
            # off the transport's thread: the in-flight throttle may make
            # an issue wait for a release that only the thread this callback
            # runs on delivers (the TCP reader; the in-process fabric's rpc
            # threads), which is a deadlock when one fetch asks for more
            # than maxReceiveInflightBytes
            threading.Thread(target=self._issue_all, args=(state, pending),
                             name="shuffle-fetch-issue", daemon=True).start()
        self.connection.request(msg.REQ_METADATA, req.to_bytes(), on_meta)

    @triage_boundary
    def _issue_all(self, state: _FetchState,
                   pending: List[PendingTransferRequest]) -> None:
        for p in pending:
            if state.failed:
                return
            try:
                self._issue_transfer(state, p, attempt=0)
            except TimeoutError as e:   # the throttle's own bound
                state.fail(str(e))
                return

    # rung 1 of the failure ladder: transfer-retry triage (deterministic
    # backoff; exhaustion fails the fetch state, which escalates to the
    # driver's recompute rung as ShuffleFetchFailedError)
    @triage_boundary
    def _retry_metadata(self, state: _FetchState, attempt: int,
                        error: str) -> None:
        if attempt >= self.max_retries or state.failed:
            state.register([(b, 0) for b in state.blocks])
            state.fail(error)
            return
        self.metrics[mt.SHUFFLE_RPC_RETRIES].add(1)
        delay = retry.backoff_ms(
            attempt, self.backoff_ms, self.retry_seed,
            key=f"meta:{self.connection.peer_executor_id}")
        retry.call_later(delay,
                         lambda: self._request_metadata(state, attempt + 1))

    def _issue_transfer(self, state: _FetchState, p: PendingTransferRequest,
                        attempt: int) -> None:
        # a FRESH tag range per attempt: chunks of a failed attempt still in
        # flight can never land in a retry's bounce buffers
        base_tag = (next(self._tag_seq) << 16)
        treq = msg.TransferRequest(p.block, p.table_idx, base_tag,
                                   self.chunk_size, self.codec_name)
        # admission control before the server starts pushing chunks
        self.transport.throttle.acquire(p.meta.packed_size)
        released = threading.Event()

        def release_once():
            if not released.is_set():
                released.set()
                self.transport.throttle.release(p.meta.packed_size)

        # rung-1 triage point: a corrupt/failed transfer retries in place
        # with deterministic backoff, or fails the fetch state on
        # exhaustion (escalating to the recompute rung)
        @triage_boundary
        def fail_or_retry(error: str, corrupt: bool = False):
            release_once()
            if corrupt:
                self.metrics[mt.SHUFFLE_CHECKSUM_FAILURES].add(1)
            if attempt >= self.max_retries or state.failed:
                state.fail(error)
                return
            self.metrics[mt.SHUFFLE_TRANSFER_RETRIES].add(1)
            delay = retry.backoff_ms(
                attempt, self.backoff_ms, self.retry_seed,
                key=f"transfer:{p.block}:{p.table_idx}")
            retry.call_later(
                delay, lambda: self._issue_transfer(state, p, attempt + 1))

        def on_transfer_resp(tx: Transaction):
            if tx.status is not TransactionStatus.SUCCESS:
                fail_or_retry(tx.error_message or "transfer failed")
                return
            resp = msg.TransferResponse.from_bytes(tx.response)

            def on_buffer(target: Optional[bytearray], error: Optional[str]):
                if error is not None:
                    fail_or_retry(error)
                    return
                try:
                    wire = target          # the assembled bytearray itself
                    wire_meta = resp.meta
                    if self.verify_checksums:
                        verify_checksum(wire, resp.checksum,
                                        context=f"{p.block} table {p.table_idx}")
                        # the bytes are checked: the reader need not hash
                        # them again (with the check off it still does)
                        wire_meta = wire_meta.with_checksum(0)
                    raw, meta = decompress_batch(wire, wire_meta)
                    # the payload crossed the host (the in-process fabric
                    # or TCP): the mesh's exchange never reaches here
                    count_host_hop(len(raw))
                    rid = self.received.add(raw, meta)
                except ChecksumError as e:
                    fail_or_retry(str(e), corrupt=True)
                    return
                except Exception as e:  # noqa: BLE001
                    fail_or_retry(f"{type(e).__name__}: {e}")
                    return
                release_once()
                state.mark_delivered(p.block, p.table_idx)
                state.handler.batch_received(rid, p.block, p.table_idx)
            receive = BufferReceiveState(self, base_tag, resp.wire_size,
                                         self.chunk_size, on_buffer)

            def start_receive():
                try:
                    receive.start()
                except TimeoutError as e:   # the bounce pool's own bound
                    on_buffer(None, str(e))
            # off the transport's thread too: the receive bounce pool may
            # make the start wait for buffers that the chunks this thread
            # delivers free (a frame that lands first waits for its
            # receive: the fabric's tag table, TCP's early-data table)
            threading.Thread(target=start_receive, name="shuffle-receive",
                             daemon=True).start()
        self.connection.request(msg.REQ_TRANSFER, treq.to_bytes(),
                                on_transfer_resp)
