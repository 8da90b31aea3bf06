"""Host <-> device movement of batches (the JAX package's
``columnar/transfer.py``).

Uploads go through pinned host buffers and asynchronous copies on the current
stream, straight into zero-padded device buffers of the batch's capacity; on
the CPU they are plain copies. ``upload_table`` splits a large table into row
chunks (``transfer.chunkRows``): chunk N+1 is staged into a pinned slab on
the host while the copies of the chunks before it are in flight, at most
``transfer.maxInflight`` of them (one slab each, reused once its copies
have finished), and every chunk lands in its slice of one preallocated
device tensor per buffer, so the device never holds a chunk and the
assembled batch at once. Every copy goes on the current stream, as the
consumer's kernels do, so no side stream and no cross-stream wait is
needed.

The chunks are staged by a pool of plain threads with numpy copies, not by
torch's CPU copy: that one runs each copy as an OpenMP parallel region of
the calling thread's own team, and on a pipeline's producer thread (a
second team beside the main thread's on the same cores) every region paid
a wake-up, one per buffer and chunk, which made the chunked upload slower
there than the single shot.

Downloads move only the live rows. ``start_download`` begins one batch's
device-to-host copy (non_blocking, into pinned host buffers) and records a
CUDA event; ``PendingDownload.result()`` waits for that event only.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DType, bucket_capacity
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn


def to_device(arr: np.ndarray, cap: int, device: torch.device) -> torch.Tensor:
    """One host buffer -> a device tensor of ``cap`` rows, the rows beyond
    ``len(arr)`` zeroed. On CUDA the host side is staged in pinned memory so
    the copy runs asynchronously (the caching host allocator keeps the
    staging buffer alive until the copy has finished)."""
    host = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    n = host.shape[0]
    out = torch.empty((cap,) + tuple(host.shape[1:]), dtype=host.dtype,
                      device=device)
    if cap > n:
        out[n:].zero_()
    if device.type == "cuda":
        out[:n].copy_(host.pin_memory(), non_blocking=True)
    else:
        out[:n].copy_(host)
    return out


def _host_buffers(hb: HostBatch) -> List[List[np.ndarray]]:
    """Each column's host buffers in the device layout: data, validity as
    bool, and int32 lengths for strings."""
    n = hb.num_rows
    out = []
    for f, c in zip(hb.schema, hb.columns):
        bufs = [c.data[:n], c.validity[:n].astype(np.bool_, copy=False)]
        if f.dtype is DType.STRING:
            bufs.append(c.lengths[:n].astype(np.int32, copy=False))
        out.append(bufs)
    return out


def _columns(hb: HostBatch, tensors: List[List[torch.Tensor]]
             ) -> DeviceBatch:
    cols = [DeviceColumn(f.dtype, *ts) for f, ts in zip(hb.schema, tensors)]
    return DeviceBatch(hb.schema, tuple(cols), hb.num_rows)


def upload(hb: HostBatch, device: torch.device,
           capacity: Optional[int] = None) -> DeviceBatch:
    """HostBatch -> DeviceBatch at ``capacity`` (default: the row count's
    power-of-two bucket), in a single shot."""
    cap = capacity or bucket_capacity(hb.num_rows)
    return _columns(hb, [[to_device(a, cap, device) for a in bufs]
                         for bufs in _host_buffers(hb)])


def chunk_bounds(hb: HostBatch, chunk_rows: int) -> List[int]:
    """Chunk start offsets, aligned to the source table's record-batch
    ends (``HostBatch.batch_ends``) while keeping every chunk under about
    ``chunk_rows`` rows; an oversized record batch is split at
    ``chunk_rows``. The JAX package's rule, over the same edges."""
    n = hb.num_rows
    if chunk_rows <= 0 or n <= chunk_rows:
        return [0]
    edges = {0} | {e for e in hb.batch_ends if 0 < e < n}
    bounds = [0]
    for edge in sorted(edges | {n}):
        while edge - bounds[-1] > chunk_rows:
            bounds.append(bounds[-1] + chunk_rows)
        # take a record-batch edge only when the chunk grew big enough;
        # tiny trailing slivers merge into the previous chunk
        if edge != n and edge - bounds[-1] >= chunk_rows // 2:
            bounds.append(edge)
    return bounds


_STAGE_POOL: Optional[ThreadPoolExecutor] = None
_STAGE_POOL_LOCK = threading.Lock()


def _stage_pool() -> ThreadPoolExecutor:
    """The process's staging threads, made on first use."""
    global _STAGE_POOL
    with _STAGE_POOL_LOCK:
        if _STAGE_POOL is None:
            _STAGE_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="upload-stage")
        return _STAGE_POOL


#: rows per staging task are cut to about this many bytes, so a chunk's
#: wide buffers spread over the pool instead of each holding one thread
_STAGE_PIECE_BYTES = 2 << 20


def _stage(pairs) -> None:
    """Copy every (pinned destination, host source) pair, in parallel and
    in pieces of about ``_STAGE_PIECE_BYTES``. numpy releases the GIL for
    the copy; an error re-raises here."""
    pool = _stage_pool()
    futures = []
    for dst, src in pairs:
        step = max(1, _STAGE_PIECE_BYTES // max(1, src[:1].nbytes))
        for i in range(0, len(src), step):
            futures.append(pool.submit(np.copyto, dst[i:i + step],
                                       src[i:i + step]))
    for f in futures:
        f.result()


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 64) * 64


def upload_table(hb: HostBatch, device: torch.device, chunk_rows: int = 0,
                 max_inflight: int = 2, capacity: Optional[int] = None,
                 stats: Optional[Dict[str, Any]] = None) -> DeviceBatch:
    """HostBatch -> DeviceBatch through the chunked pipeline: one device
    tensor per buffer at the batch's capacity, filled chunk by chunk from
    ``max_inflight`` pinned slabs used in turn (the host waits on a slab's
    event before it stages the next chunk into it). A table of at most one
    chunk, or ``chunk_rows <= 0``, takes the single-shot ``upload``. The
    result equals the single shot's byte for byte.

    ``stats``, when given, is filled as the JAX package fills it: chunks,
    wall_s (to the copies' end: the call then synchronizes), stage_s (the
    host's staging and enqueueing, of which the waits on in-flight chunks
    are not part), upload_overlap_efficiency (stage_s over wall_s: 1.0 when
    every copy hides behind the staging) and inflight_high_water."""
    t_start = time.perf_counter()
    bounds = chunk_bounds(hb, chunk_rows)
    if len(bounds) < 2:
        out = upload(hb, device, capacity)
        if stats is not None:
            _finish(device)
            wall = time.perf_counter() - t_start
            stats.update(chunks=1, wall_s=wall, stage_s=wall,
                         upload_overlap_efficiency=0.0,
                         inflight_high_water=1)
        return out
    n = hb.num_rows
    cap = capacity or bucket_capacity(n)
    cuda = device.type == "cuda"
    per_column = _host_buffers(hb)
    host = [a for bufs in per_column for a in bufs]
    dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in host]
    outs = []
    for a, dt in zip(host, dtypes):
        t = torch.empty((cap,) + a.shape[1:], dtype=dt, device=device)
        if cap > n:
            t[n:].zero_()
        outs.append(t)
    ends = bounds[1:] + [n]
    row_bytes = [a.itemsize * int(np.prod(a.shape[1:])) for a in host]
    most = max(e - s for s, e in zip(bounds, ends))
    slabs = [torch.empty(sum(_aligned(most * rb) for rb in row_bytes),
                         dtype=torch.uint8, pin_memory=cuda)
             for _ in range(min(max_inflight, len(bounds)))]
    events: List[Optional[torch.cuda.Event]] = [None] * len(slabs)
    stage_s, inflight, peak = 0.0, 0, 0
    for i, (start, end) in enumerate(zip(bounds, ends)):
        k = i % len(slabs)
        if events[k] is not None:
            events[k].synchronize()     # bounded: this slab's last chunk
            inflight -= 1
        t0 = time.perf_counter()
        slab, off, views = slabs[k], 0, []
        for a, dt, rb in zip(host, dtypes, row_bytes):
            nb = (end - start) * rb
            views.append(slab[off:off + nb].view(dt).view(
                (end - start,) + a.shape[1:]))
            off += _aligned(nb)
        _stage([(v.numpy(), a[start:end]) for v, a in zip(views, host)])
        for v, t in zip(views, outs):
            t[start:end].copy_(v, non_blocking=cuda)
        stage_s += time.perf_counter() - t0
        if cuda:
            events[k] = torch.cuda.Event()
            events[k].record()
            inflight += 1
            peak = max(peak, inflight)
    if stats is not None:
        _finish(device)
        wall = time.perf_counter() - t_start
        stats.update(chunks=len(bounds), wall_s=wall, stage_s=stage_s,
                     upload_overlap_efficiency=min(1.0, stage_s / wall)
                     if wall > 0 else 0.0,
                     inflight_high_water=max(peak, 1))
    done = iter(outs)
    return _columns(hb, [[next(done) for _ in bufs] for bufs in per_column])


def _finish(device: torch.device) -> None:
    """Wait for the device's queued copies (instrumented uploads only)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload_table_conf(hb: HostBatch, device: torch.device, conf,
                      capacity: Optional[int] = None) -> DeviceBatch:
    """``upload_table`` with the chunking read from a TpuConf."""
    from spark_rapids_tpu_torch import config as cfg
    return upload_table(hb, device,
                        chunk_rows=conf.get(cfg.TRANSFER_CHUNK_ROWS),
                        max_inflight=conf.get(cfg.TRANSFER_MAX_INFLIGHT),
                        capacity=capacity)


def download(batch: DeviceBatch) -> HostBatch:
    """DeviceBatch -> HostBatch of the live rows."""
    n = batch.num_rows
    cols = []
    for c in batch.columns:
        lengths = c.lengths[:n].cpu().numpy() if c.lengths is not None else None
        cols.append(HostColumn(c.dtype, c.data[:n].cpu().numpy(),
                               c.validity[:n].cpu().numpy(), lengths))
    return HostBatch(batch.schema, tuple(cols), n)


class PendingDownload:
    """One result batch's device-to-host copy in flight. On CUDA the live
    rows of every buffer are copied with ``non_blocking`` into pinned host
    tensors and a CUDA event is recorded behind them; ``result()`` waits for
    that event before any host code reads the buffers. On the CPU the copy
    is the plain download."""

    def __init__(self, batch: DeviceBatch):
        self._schema = batch.schema
        self._num_rows = n = batch.num_rows
        self._event = None
        if batch.columns and batch.device.type == "cuda":
            self._cols = [[None if t is None else
                           torch.empty(t[:n].shape, dtype=t.dtype,
                                       pin_memory=True).copy_(
                               t[:n], non_blocking=True)
                           for t in (c.data, c.validity, c.lengths)]
                          for c in batch.columns]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._cols = [[None if t is None else t[:n].cpu()
                           for t in (c.data, c.validity, c.lengths)]
                          for c in batch.columns]
        self.nbytes = sum(t.numel() * t.element_size()
                          for ts in self._cols for t in ts if t is not None)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def result(self) -> HostBatch:
        if self._event is not None:
            self._event.synchronize()
        cols = [HostColumn(f.dtype, d.numpy(), v.numpy(),
                           None if ln is None else ln.numpy())
                for f, (d, v, ln) in zip(self._schema, self._cols)]
        return HostBatch(self._schema, tuple(cols), self._num_rows)


def start_download(batch: DeviceBatch) -> PendingDownload:
    return PendingDownload(batch)
