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
``download_arrow`` lays a batch out for arrow on the device first (validity
and booleans bit-packed, strings compacted to offsets and bytes), so the
host only wraps the copied buffers: the file writers' download.

Both directions count into the process's ``transfer.*`` counters
(``utils/metrics.py``), as the JAX package's do: the device bytes, the
host's seconds in the call (an upload's wall does not wait for its copies;
a download's is its wait for them), the chunks and the in-flight peak, and
the staged bytes beside their decoded equivalent.
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
from spark_rapids_tpu_torch.utils import metrics as um


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


def _count_upload(outs: List[torch.Tensor], t_start: float, chunks: int,
                  peak: int) -> None:
    m = um.TRANSFER_METRICS
    m[um.TRANSFER_UPLOAD_BYTES].add(sum(t.numel() * t.element_size()
                                        for t in outs))
    m[um.TRANSFER_UPLOAD_SECONDS].add(time.perf_counter() - t_start)
    m[um.TRANSFER_UPLOAD_CHUNKS].add(chunks)
    m[um.TRANSFER_INFLIGHT_PEAK].set_max(peak)


def _count_staged(encoded: int, decoded: int) -> None:
    m = um.TRANSFER_METRICS
    m[um.TRANSFER_ENCODED_BYTES].add(encoded)
    m[um.TRANSFER_DECODED_EQUIV_BYTES].add(decoded)


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
    return _bounds(hb.num_rows, hb.batch_ends, chunk_rows)


def _bounds(n: int, batch_ends, chunk_rows: int) -> List[int]:
    if chunk_rows <= 0 or n <= chunk_rows:
        return [0]
    edges = {0} | {e for e in batch_ends if 0 < e < n}
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
    staged = sum(a.nbytes for bufs in _host_buffers(hb) for a in bufs)
    _count_staged(staged, staged)
    if len(bounds) < 2:
        out = upload(hb, device, capacity)
        _count_upload([t for c in out.columns
                       for t in (c.data, c.validity, c.lengths)
                       if t is not None], t_start, 1, 1)
        if stats is not None:
            _finish(device)
            wall = time.perf_counter() - t_start
            stats.update(chunks=1, wall_s=wall, stage_s=wall,
                         upload_overlap_efficiency=0.0,
                         inflight_high_water=1)
        return out
    per_column = _host_buffers(hb)
    outs = _upload_rows([a for bufs in per_column for a in bufs],
                        hb.num_rows, capacity or bucket_capacity(hb.num_rows),
                        device, bounds, max_inflight, stats, t_start)
    done = iter(outs)
    return _columns(hb, [[next(done) for _ in bufs] for bufs in per_column])


def _upload_rows(host: List[np.ndarray], n: int, cap: int,
                 device: torch.device, bounds: List[int], max_inflight: int,
                 stats: Optional[Dict[str, Any]] = None,
                 t_start: Optional[float] = None) -> List[torch.Tensor]:
    """Row buffers of ``n`` rows -> device tensors of ``cap`` rows (zeroed
    past ``n``), chunk by chunk at ``bounds`` through pinned slabs staged by
    the numpy pool, so no torch CPU copy runs on the calling thread (a scan's
    producer thread among them). On the CPU a single chunk is one
    ``to_device`` per buffer."""
    t_start = time.perf_counter() if t_start is None else t_start
    if len(bounds) < 2 and device.type != "cuda":
        outs = [to_device(a, cap, device) for a in host]
        _count_upload(outs, t_start, 1, 1)
        if stats is not None:
            _finish(device)
            wall = time.perf_counter() - t_start
            stats.update(chunks=1, wall_s=wall, stage_s=wall,
                         upload_overlap_efficiency=0.0,
                         inflight_high_water=1)
        return outs
    cuda = device.type == "cuda"
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
    _count_upload(outs, t_start, len(bounds), max(peak, 1))
    if stats is not None:
        _finish(device)
        wall = time.perf_counter() - t_start
        stats.update(chunks=len(bounds), wall_s=wall, stage_s=stage_s,
                     upload_overlap_efficiency=min(1.0, stage_s / wall)
                     if wall > 0 else 0.0,
                     inflight_high_water=max(peak, 1))
    return outs


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


def _narrow_index_dtype(k: int):
    """The narrowest index type the link carries for a k-entry dictionary
    (torch's uint16 is thin, so int16 is the middle step)."""
    return np.uint8 if k <= 0xFF else np.int16 if k <= 0x7FFF else np.int32


def _staged_values(arr, string_max_bytes: int) -> HostColumn:
    """A dictionary's or a run form's values as one host column."""
    import pyarrow as pa
    return HostBatch.from_arrow(pa.table({"v": arr}),
                                string_max_bytes).columns[0]


def upload_arrow(table, device: torch.device, string_max_bytes: int = 256,
                 chunk_rows: int = 0, max_inflight: int = 2) -> DeviceBatch:
    """Arrow table -> DeviceBatch, with encoded columns decoded on the
    device (the JAX package's ``DeviceBatch.from_arrow``):

    - a dictionary column ships its index vector at the narrowest width
      (uint8, int16 or int32; widened to int32 on the device) and its
      dictionary once (a string dictionary as its byte matrix plus
      lengths), and decodes with one ``index_select``; when the dictionary
      is unique the column keeps it as its ``DictEncoding`` (token from the
      field metadata);
    - a run-end-encoded column ships (run_ends, per-run values) and
      expands with a searchsorted gather (``expand_ree_device``);
    - every other column takes the decoded layout.

    The per-row buffers (plain columns, indices, the validity of columns
    with nulls) go through the same chunked, pinned upload as
    ``upload_table``, one device tensor per buffer, so a chunk boundary
    never splits a dictionary: every chunk's indices point into the one
    uploaded dictionary. A null-free encoded column's validity is made on
    the device. The staged bytes and what the decoded forms would have
    staged are counted (``encoding.counters()``).

    A string dictionary's matrix is as wide as its longest value, which
    may be wider than any row of this batch: the decoded column is then
    ``capacity x that width``, at most ``string.maxBytes`` wide, the bound
    the decoded upload has too."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar import encoding as ce
    from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
    from spark_rapids_tpu_torch.columnar.host import _dtype_from_arrow
    ends_at, off = [], 0
    for b in table.to_batches():
        off += b.num_rows
        if off < table.num_rows:
            ends_at.append(off)
    n = table.num_rows
    cap = bucket_capacity(n)
    fields: List[Field] = []
    plans: List[tuple] = []
    plain: List[int] = []
    rows: List[np.ndarray] = []     # the per-row buffers, in upload order
    enc_bytes = dec_bytes = 0
    for i, (f, chunked) in enumerate(zip(table.schema, table.columns)):
        arr = (chunked.chunk(0) if chunked.num_chunks == 1
               else chunked.combine_chunks())
        dt = _dtype_from_arrow(f.type)
        fields.append(Field(f.name, dt, f.nullable))
        if pa.types.is_run_end_encoded(arr.type):
            ends, vals = ce.ree_staged(arr)
            if len(ends) and dt is not DType.STRING:
                hv = _staged_values(vals, string_max_bytes)
                rvalid = None if hv.validity.all() else hv.validity
                plans.append(("ree", ends, hv.data, rvalid))
                staged = ends.nbytes + hv.data.nbytes + (
                    rvalid.nbytes if rvalid is not None else 0)
                enc_bytes += staged
                dec_bytes += n * hv.data.itemsize + (
                    n if rvalid is not None else 0)
                continue
        if (isinstance(arr, pa.DictionaryArray) and len(arr.dictionary)
                and arr.dictionary.null_count == 0):
            idx = arr.indices
            k = len(arr.dictionary)
            np_idx = np.asarray(idx.fill_null(0)).astype(
                _narrow_index_dtype(k))
            validity = (None if idx.null_count == 0
                        else np.asarray(idx.is_valid()).astype(np.bool_))
            hv = _staged_values(arr.dictionary, string_max_bytes)
            unique = ce.dictionary_is_unique(hv.data, hv.lengths)
            plans.append(("dict", len(rows), validity is not None, hv,
                          ce.field_token(table.schema, i), unique))
            rows.append(np_idx)
            if validity is not None:
                rows.append(validity)
            vb = validity.nbytes if validity is not None else 0
            enc_bytes += np_idx.nbytes + vb + hv.data.nbytes + (
                hv.lengths.nbytes if hv.lengths is not None else 0)
            row_b = int(np.prod(hv.data.shape[1:])) * hv.data.itemsize
            dec_bytes += n * row_b + vb + (
                n * 4 if hv.lengths is not None else 0)
            continue
        plans.append(("plain", len(plain)))
        plain.append(i)
    # the rest converts as an in-memory table does (an empty dictionary, an
    # empty or string run form decode on the host there)
    hb = HostBatch.from_arrow(
        pa.table([table.column(i) for i in plain],
                 names=[table.schema.field(i).name for i in plain]),
        string_max_bytes) if plain else None
    plain_bufs = _host_buffers(hb) if hb is not None else []
    plain_at = []
    for bufs in plain_bufs:
        plain_at.append(len(rows))
        rows.extend(bufs)
        nb = sum(a.nbytes for a in bufs)
        enc_bytes += nb
        dec_bytes += nb
    ce.count("encoded_bytes", enc_bytes)
    ce.count("decoded_equivalent_bytes", dec_bytes)
    _count_staged(enc_bytes, dec_bytes)
    outs = _upload_rows(rows, n, cap, device,
                        _bounds(n, ends_at, chunk_rows), max_inflight)
    alive = torch.arange(cap, device=device) < n
    cols = []
    for f, plan in zip(fields, plans):
        kind = plan[0]
        if kind == "plain":
            j = plain_at[plan[1]]
            ts = outs[j:j + (3 if f.dtype is DType.STRING else 2)]
            cols.append(DeviceColumn(f.dtype, *ts))
        elif kind == "ree":
            _, ends, vdata, rvalid = plan
            r = len(ends)
            data, ridx = ce.expand_ree_device(
                to_device(ends, r, device), to_device(vdata, r, device), cap)
            if rvalid is None:
                validity = alive
            else:
                validity = (to_device(rvalid, r, device).index_select(0, ridx)
                            & alive)
            cols.append(DeviceColumn(f.dtype, _zero_invalid(data, validity),
                                     validity))
        else:
            _, j, has_valid, hv, token, unique = plan
            idx = outs[j].to(torch.int32)
            validity = outs[j + 1] if has_valid else alive
            k = hv.data.shape[0]
            values = to_device(hv.data, k, device)
            data = _zero_invalid(values.index_select(0, idx), validity)
            lengths = dlen = None
            if hv.lengths is not None:
                dlen = to_device(hv.lengths, k, device)
                lengths = _zero_invalid(dlen.index_select(0, idx), validity)
            enc = ce.DictEncoding(idx, values, dlen, token) if unique else None
            cols.append(DeviceColumn(f.dtype, data, validity, lengths, enc))
    return DeviceBatch(Schema(fields), tuple(cols), n)


def _zero_invalid(t: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Zero the rows of a gathered buffer that are null or padding, as the
    decoded layout holds them."""
    keep = validity.reshape((-1,) + (1,) * (t.dim() - 1))
    return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                            device=t.device))


def upload_arrow_conf(table, device: torch.device, conf) -> DeviceBatch:
    """``upload_arrow`` with the string width and chunking of a TpuConf."""
    from spark_rapids_tpu_torch import config as cfg
    return upload_arrow(table, device, conf.string_max_bytes,
                        chunk_rows=conf.get(cfg.TRANSFER_CHUNK_ROWS),
                        max_inflight=conf.get(cfg.TRANSFER_MAX_INFLIGHT))


def _count_download(nbytes: int, t0: float) -> None:
    m = um.TRANSFER_METRICS
    m[um.TRANSFER_DOWNLOAD_BYTES].add(nbytes)
    m[um.TRANSFER_DOWNLOAD_SECONDS].add(time.perf_counter() - t0)


def download(batch: DeviceBatch) -> HostBatch:
    """DeviceBatch -> HostBatch of the live rows."""
    t0 = time.perf_counter()
    n = batch.num_rows
    cols = []
    for c in batch.columns:
        lengths = c.lengths[:n].cpu().numpy() if c.lengths is not None else None
        cols.append(HostColumn(c.dtype, c.data[:n].cpu().numpy(),
                               c.validity[:n].cpu().numpy(), lengths))
    _count_download(sum(a.nbytes for c in cols
                        for a in (c.data, c.validity, c.lengths)
                        if a is not None), t0)
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
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        _count_download(self.nbytes, t0)
        cols = [HostColumn(f.dtype, d.numpy(), v.numpy(),
                           None if ln is None else ln.numpy())
                for f, (d, v, ln) in zip(self._schema, self._cols)]
        return HostBatch(self._schema, tuple(cols), self._num_rows)


def start_download(batch: DeviceBatch) -> PendingDownload:
    return PendingDownload(batch)


_BIT_WEIGHTS: Dict[torch.device, torch.Tensor] = {}


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n / 8)], least significant bit first (arrow's
    bitmap, ``np.packbits(..., bitorder="little")``)."""
    pad = (-bits.shape[0]) % 8
    b = bits.to(torch.int32)
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    w = _BIT_WEIGHTS.get(bits.device)
    if w is None:
        w = _BIT_WEIGHTS[bits.device] = torch.tensor(
            [1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
            device=bits.device)
    return (b.view(-1, 8) * w).sum(dim=1).to(torch.uint8)


def _arrow_buffers(c: DeviceColumn, n: int, nulls: int) -> List:
    """One column's arrow buffers on its device: [validity bitmap or None,
    values] for fixed widths, [validity or None, offsets, bytes] for
    strings (the bytes of each row's first ``length`` columns, row after
    row)."""
    valid = _packbits(c.validity[:n]) if nulls else None
    if c.dtype is DType.STRING:
        lengths = c.lengths[:n].to(torch.int64)
        data = c.data[:n]
        keep = (torch.arange(data.shape[1], device=data.device)[None, :]
                < lengths[:, None])
        offsets = torch.zeros(n + 1, dtype=torch.int64, device=data.device)
        torch.cumsum(lengths, 0, out=offsets[1:])
        return [valid, offsets, data[keep]]
    if c.dtype is DType.BOOLEAN:
        return [valid, _packbits(c.data[:n])]
    return [valid, c.data[:n].contiguous()]


class PendingArrowDownload:
    """One batch's download in arrow's layout in flight: the layout is
    made on the device (``_arrow_buffers``) and the buffers copied into
    pinned host memory behind one CUDA event (plain copies on the CPU);
    ``result()`` waits for that event and arrow wraps the buffers without
    a copy. A column that arrived encoded downloads its decoded values.
    Strings whose bytes pass 2 GiB come back as ``large_string``."""

    def __init__(self, batch: DeviceBatch):
        self._schema = batch.schema
        self._num_rows = n = batch.num_rows
        cols = batch.columns
        self._nulls = (torch.stack([(~c.validity[:n]).sum()
                                    for c in cols]).tolist()
                       if cols and n else [0] * len(cols))
        device_bufs = [_arrow_buffers(c, n, k)
                       for c, k in zip(cols, self._nulls)]
        self._event = None
        if batch.device.type == "cuda":
            self._host = [[None if t is None else
                           torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True).copy_(
                               t, non_blocking=True)
                           for t in bufs] for bufs in device_bufs]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = device_bufs

    def result(self):
        import pyarrow as pa

        from spark_rapids_tpu_torch.columnar.host import _arrow_type
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        _count_download(sum(t.numel() * t.element_size()
                            for bufs in self._host for t in bufs
                            if t is not None), t0)
        n = self._num_rows

        def wrap(t):
            return None if t is None else pa.py_buffer(
                t.contiguous().numpy())
        arrays = []
        for f, k, bufs in zip(self._schema, self._nulls, self._host):
            vbuf = wrap(bufs[0])
            if f.dtype is DType.NULL:
                arrays.append(pa.nulls(n))
            elif f.dtype is DType.STRING:
                offsets, data = bufs[1], bufs[2]
                if offsets[-1] < 2 ** 31:
                    arrays.append(pa.StringArray.from_buffers(
                        n, wrap(offsets.to(torch.int32)), wrap(data), vbuf,
                        k))
                else:
                    arrays.append(pa.LargeStringArray.from_buffers(
                        n, wrap(offsets), wrap(data), vbuf, k))
            else:
                storage = {DType.TIMESTAMP: pa.int64(),
                           DType.DATE: pa.int32()}.get(
                    f.dtype, _arrow_type(f.dtype))
                arr = pa.Array.from_buffers(storage, n,
                                            [vbuf, wrap(bufs[1])], k)
                arrays.append(arr if storage.equals(_arrow_type(f.dtype))
                              else arr.cast(_arrow_type(f.dtype)))
        return pa.Table.from_arrays(arrays, schema=pa.schema(
            [pa.field(f.name, a.type, f.nullable)
             for f, a in zip(self._schema, arrays)]))


def start_download_arrow(batch: DeviceBatch) -> PendingArrowDownload:
    return PendingArrowDownload(batch)


def download_arrow(batch: DeviceBatch):
    """DeviceBatch -> arrow table of its live rows, equal to
    ``download(batch).to_arrow()`` (``PendingArrowDownload``)."""
    return start_download_arrow(batch).result()
