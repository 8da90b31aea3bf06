"""Partition reorder: the map side of the device shuffle exchange.

  pack         columns -> one (rows, L) byte matrix (torch views: every
               value's little-endian bytes, then one validity byte per column)
  reorder      per group of G x 512-row windows, each partition's live rows
               in order into quota-padded per-(partition, group) staging
               pieces, plus live counts and an overflow flag
               (``partition_reorder``: the CUDA kernel
               csrc/partition_reorder.cu on a GPU, its plain PyTorch version
               on the CPU)
  consolidate  ``consolidate`` gathers one partition's pieces into an
               ordinary DeviceBatch; ``consolidate_all`` compacts every
               partition in one launch (``dma_compact``: the CUDA kernel
               csrc/dma_compact.cu on a GPU, its plain version on the CPU)
               and unpacks each partition from the compact

Both consolidations give a partition's rows in the JAX package's order:
every group's full 8-row blocks (``BLOCK``), group after group, then every
group's remainder rows, group after group.

The geometry (``KernelGeom``), the staging layout, the overflow rule and the
index plan are the JAX package's, so the pieces and the compact are
comparable byte for byte. An overflow sends the batch back to the sort
path: correctness never depends on the fast path applying.
"""
from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, pad_rows
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Schema,
                                                    bucket_capacity)

W = 512                    #: window rows
GROUP_WINDOWS = 64         #: windows per group (one set of pieces each)
MAX_PARTS = 32             #: wider fan-outs take the sort path
STAT_LANES = 128           #: lanes of a stats row (0: count, 1: overflow)
BLOCK = 8                  #: rows of a full block in the consolidated order
TAIL_ROWS = 2048           #: rows per CTA of dma_compact's remainder/zero part


# ------------------------------------------------------------------ pack spec
@dataclass(frozen=True)
class _ColPlan:
    dtype: DType
    kind: str          # u32x1 | u32x2 | f64 | u8 | string
    lane: int          # first byte lane of the data bytes
    nbytes: int        # data byte lanes
    smax: int = 0      # string byte width


@dataclass(frozen=True)
class PackSpec:
    """Byte-matrix layout of one batch schema: each column's data lanes, then
    one validity lane per column."""
    plans: Tuple[_ColPlan, ...]
    lanes: int

    @staticmethod
    def for_batch(batch: DeviceBatch) -> Optional["PackSpec"]:
        plans: List[_ColPlan] = []
        lane = 0
        for f, c in zip(batch.schema, batch.columns):
            dt = f.dtype
            if dt is DType.STRING:
                smax = int(c.data.shape[1])
                plan = _ColPlan(dt, "string", lane, smax + 4, smax)
            elif dt is DType.DOUBLE:
                plan = _ColPlan(dt, "f64", lane, 8)
            elif dt in (DType.LONG, DType.TIMESTAMP):
                plan = _ColPlan(dt, "u32x2", lane, 8)
            elif dt in (DType.INT, DType.DATE, DType.FLOAT, DType.SHORT):
                plan = _ColPlan(dt, "u32x1", lane, 4)
            elif dt in (DType.BOOLEAN, DType.BYTE):
                plan = _ColPlan(dt, "u8", lane, 1)
            else:
                return None                      # NULL columns: sort path
            plans.append(plan)
            lane += plan.nbytes
        return PackSpec(tuple(plans), lane + len(plans))


def _le_bytes(t: torch.Tensor) -> torch.Tensor:
    """[rows] tensor -> [rows, itemsize] uint8: the values' little-endian
    bytes (every supported device is little-endian)."""
    t = t.contiguous()
    return t.view(torch.uint8).view(t.shape[0], t.element_size())


def pack_matrix(spec: PackSpec, columns: Sequence[DeviceColumn]) -> torch.Tensor:
    """Columns -> (rows, L) uint8 matrix, laid out as the JAX package's
    (a double's 8 bytes are its ``f64bits`` lanes)."""
    pieces = []
    for plan, c in zip(spec.plans, columns):
        if plan.kind == "string":
            pieces += [c.data, _le_bytes(c.lengths.to(torch.int32))]
        elif plan.kind == "u32x1" and plan.dtype is DType.SHORT:
            pieces.append(_le_bytes(c.data.to(torch.int32)))
        elif plan.kind == "u8":
            pieces.append(c.data.to(torch.uint8)[:, None]
                          if plan.dtype is DType.BOOLEAN
                          else c.data.view(torch.uint8)[:, None])
        else:
            pieces.append(_le_bytes(c.data))
    pieces += [c.validity.to(torch.uint8)[:, None] for c in columns]
    return torch.cat(pieces, dim=1)


def unpack_columns(spec: PackSpec, schema: Schema,
                   mat: torch.Tensor) -> List[DeviceColumn]:
    """(rows, L) uint8 matrix -> DeviceColumns (inverse of pack_matrix)."""
    def lanes(lane: int, width: int, dtype: torch.dtype) -> torch.Tensor:
        return mat[:, lane:lane + width].contiguous().view(dtype).view(-1)

    nvals = len(spec.plans)
    cols: List[DeviceColumn] = []
    for i, (plan, f) in enumerate(zip(spec.plans, schema)):
        validity = mat[:, spec.lanes - nvals + i] != 0
        if plan.kind == "string":
            cols.append(DeviceColumn(
                f.dtype, mat[:, plan.lane:plan.lane + plan.smax].contiguous(),
                validity, lanes(plan.lane + plan.smax, 4, torch.int32)))
            continue
        if plan.kind == "u8":
            raw = mat[:, plan.lane]
            data = (raw != 0) if f.dtype is DType.BOOLEAN \
                else raw.contiguous().view(torch.int8)
        elif f.dtype is DType.SHORT:
            data = lanes(plan.lane, 4, torch.int32).to(torch.int16)
        else:
            data = lanes(plan.lane, plan.nbytes, f.dtype.torch_dtype())
        cols.append(DeviceColumn(f.dtype, data, validity))
    return cols


# ------------------------------------------------------------------ geometry
@dataclass(frozen=True)
class KernelGeom:
    cap: int          # padded row count = groups * G * W
    groups: int
    G: int
    n: int
    q_w: int          # per-window per-partition count bound
    quota: int        # rows of one (partition, group) piece
    L: int

    @staticmethod
    def plan(rows: int, n: int, L: int) -> "KernelGeom":
        G = min(GROUP_WINDOWS, max(1, math.ceil(rows / W)))
        gw = G * W
        groups = max(1, math.ceil(rows / gw))
        cap = groups * gw
        q_w = min(W, max(64, 2 * math.ceil(W / n)))
        q_w = (q_w + 7) // 8 * 8
        seg = q_w + 32
        quota = max(seg + 32, math.ceil(1.25 * gw / n))
        quota = (quota + 511) // 512 * 512
        return KernelGeom(cap, groups, G, n, q_w, quota, L)


def _check_inputs(pids: torch.Tensor, data: torch.Tensor,
                  geom: KernelGeom) -> None:
    if not 1 <= geom.n <= MAX_PARTS:
        raise ValueError(f"{geom.n} partitions: the reorder takes 1..{MAX_PARTS}")
    want_p = (geom.groups, geom.G, W)
    want_d = (geom.groups, geom.G * W, geom.L)
    if pids.dtype != torch.int32 or tuple(pids.shape) != want_p:
        raise ValueError(f"pids must be int32 {want_p}, got "
                         f"{pids.dtype} {tuple(pids.shape)}")
    if data.dtype != torch.uint8 or tuple(data.shape) != want_d:
        raise ValueError(f"data must be uint8 {want_d}, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if not (pids.is_contiguous() and data.is_contiguous()):
        raise ValueError("pids and data must be contiguous")
    if pids.device != data.device:
        raise ValueError(f"pids on {pids.device}, data on {data.device}")


# ------------------------------------------------------------------ reorder
def partition_reorder(pids: torch.Tensor, data: torch.Tensor,
                      geom: KernelGeom) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reorder -> (out uint8 [n, groups, quota, L], stats int32
    [groups, n, 128]). CPU tensors take the plain version; any other device
    goes to the CUDA kernel, which runs or raises."""
    _check_inputs(pids, data, geom)
    if pids.device.type == "cpu":
        return partition_reorder_plain(pids, data, geom)
    return REORDER_KERNEL(pids, data, geom)


def partition_reorder_plain(pids: torch.Tensor, data: torch.Tensor,
                            geom: KernelGeom
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reorder in plain PyTorch: per-window counts by ``bincount``, the
    overflow rule, a stable sort on ``group * n + pid``, then a scatter of
    the rows into their pieces."""
    _check_inputs(pids, data, geom)
    groups, G, n, quota, L = geom.groups, geom.G, geom.n, geom.quota, geom.L
    dev = pids.device
    p = pids.reshape(groups, G * W).to(torch.int64)
    live = (p >= 0) & (p < n)
    row_in_group = torch.arange(G * W, device=dev)
    window = (torch.arange(groups, device=dev)[:, None] * G
              + row_in_group[None, :] // W)
    bins = torch.where(live, window * n + p, groups * G * n).view(-1)
    cnt = torch.bincount(bins, minlength=groups * G * n + 1)[:-1]
    cnt = cnt.view(groups, G, n)
    run_before = torch.cumsum(cnt, dim=1) - cnt
    over = (cnt > geom.q_w) | (run_before + cnt > quota - (geom.q_w + 32))
    flag = over.view(groups, -1).any(dim=1)

    group = torch.arange(groups, device=dev)[:, None]
    key = torch.where(live, group * n + p, groups * n).view(-1)
    sorted_key, order = torch.sort(key, stable=True)
    per_key = torch.bincount(key, minlength=groups * n + 1)
    first = torch.cumsum(per_key, 0) - per_key
    rank = torch.arange(key.numel(), device=dev) - first[sorted_key]
    keep = (sorted_key < groups * n) & (rank < quota)
    sk = sorted_key[keep]
    dest = ((sk % n) * groups + sk // n) * quota + rank[keep]
    out = torch.empty((n, groups, quota, L), dtype=torch.uint8, device=dev)
    out.view(-1, L)[dest] = data.view(-1, L)[order[keep]]

    stats = torch.zeros((groups, n, STAT_LANES), dtype=torch.int32, device=dev)
    stats[:, :, 0] = cnt.sum(dim=1).to(torch.int32)
    stats[:, :, 1] = flag[:, None].to(torch.int32)
    return out, stats


#: rows of this many bytes or more take the reorder kernel's wide form
#: (32-row tiles streamed in 16 KB pieces; kWideRowBytes in
#: csrc/partition_reorder.cu, which refuses other tile sizes for them)
WIDE_ROW_BYTES = 1024
#: dynamic shared memory one CTA of the reorder kernel may take for its two
#: tile buffers and its staging buffer: at L = 76 that is 256-row tiles and
#: three CTAs an SM, which beat 128- and 512-row tiles on an H100
#: (chip_smoke.py --tile-sweep)
TILE_SMEM_BYTES = 64 << 10


def reorder_tile_rows(L: int) -> int:
    """Rows per tile of the reorder kernel for rows of L bytes: 32 for wide
    rows, else the most rows (a power of two in [64, 512]) whose two tile
    buffers (pids and rows) and staging buffer (smem_bytes in
    csrc/partition_reorder.cu) fit TILE_SMEM_BYTES, or 32 (which fits the
    card's 227 KB for any L under WIDE_ROW_BYTES)."""
    if L >= WIDE_ROW_BYTES:
        return 32
    rows = W
    while rows > 32 and 2 * (4 * rows + rows * L) + rows * L + 1024 \
            > TILE_SMEM_BYTES:
        rows //= 2
    return rows


class _Counted:
    """Launch counters safe under concurrent queries: each bump is one
    step under a lock, and lands on the query bound to the launching
    thread too (``QueryHandle`` metrics ``<prefix>_launches`` /
    ``<prefix>_kept``), so a served query reads its own launches."""

    PREFIX = ""

    def __init__(self):
        self._count_lock = threading.Lock()
        self.launches = 0
        self.kept = 0

    def _bump(self, what: str) -> None:
        from spark_rapids_tpu_torch.serving.lifecycle import current_query
        q = current_query()
        with self._count_lock:
            setattr(self, what, getattr(self, what) + 1)
            if q is not None:
                key = f"{self.PREFIX}_{what}"
                q.note_metric(key, q.metric(key, 0) + 1)


class _ReorderKernel(_Counted):
    """ctypes binding of csrc/partition_reorder.cu. ``launches`` counts the
    calls of its entry point (and nothing else); each call runs two device
    kernels, the pids pre-pass and the reorder. ``kept`` counts the
    launches whose output a split used (no overflow: ``split_batch_kernel``
    did not hand the batch to the sort path)."""

    SOURCE = "partition_reorder.cu"
    PREFIX = "reorder"

    @staticmethod
    def _bind(lib: ctypes.CDLL) -> None:
        lib.partition_reorder.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.partition_reorder.restype = ctypes.c_int
        lib.partition_reorder_error.argtypes = [ctypes.c_int]
        lib.partition_reorder_error.restype = ctypes.c_char_p

    def load(self) -> ctypes.CDLL:
        return cuda_build.load(self.SOURCE, self._bind)

    def __call__(self, pids: torch.Tensor, data: torch.Tensor,
                 geom: KernelGeom, tile_rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_inputs(pids, data, geom)
        if pids.device.type != "cuda":
            raise ValueError(f"the CUDA reorder kernel needs CUDA tensors, "
                             f"got {pids.device}")
        if pids.data_ptr() % 16 or data.data_ptr() % 16:
            raise ValueError("the CUDA reorder kernel needs 16-byte aligned "
                             "pids and data")
        tile_rows = tile_rows or reorder_tile_rows(geom.L)
        lib = self.load()
        dev = pids.device
        out = torch.empty((geom.n, geom.groups, geom.quota, geom.L),
                          dtype=torch.uint8, device=dev)
        stats = torch.empty((geom.groups, geom.n, STAT_LANES),
                            dtype=torch.int32, device=dev)
        tiles = geom.groups * geom.G * (W // tile_rows)
        scratch = torch.empty(tiles * (geom.n + 1), dtype=torch.int32,
                              device=dev)
        if out.data_ptr() % 16:
            raise ValueError("the CUDA reorder kernel needs a 16-byte aligned "
                             "out")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.partition_reorder(
            pids.data_ptr(), data.data_ptr(), out.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), geom.groups, geom.G, geom.n, geom.q_w,
            geom.quota, geom.L, tile_rows, stream)
        if err != 0:
            msg = lib.partition_reorder_error(err).decode()
            raise RuntimeError(f"partition_reorder launch failed: CUDA error "
                               f"{err} ({msg})")
        self._bump("launches")
        return out, stats


#: the process's binding of the CUDA reorder kernel
REORDER_KERNEL = _ReorderKernel()


# ------------------------------------------------------------------ batch split
def kernel_inputs(batch: DeviceBatch, pids: torch.Tensor, spec: PackSpec,
                  geom: KernelGeom) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a batch and shape it for the reorder: dead and padding rows get
    pid -1, rows are zero-padded to ``geom.cap`` -> (pids [groups, G, W],
    data [groups, G*W, L]). Both are fresh tensors (or a leading slice of
    one), so on a GPU they start on the allocator's aligned boundary, as the
    kernel's bulk copies need."""
    alive = torch.arange(batch.capacity, device=pids.device) < batch.num_rows
    p = pad_rows(torch.where(alive, pids, -1).to(torch.int32), geom.cap)
    p[batch.capacity:] = -1
    mat = pad_rows(pack_matrix(spec, batch.columns), geom.cap)
    return (p.view(geom.groups, geom.G, W),
            mat.view(geom.groups, geom.G * W, geom.L))


Split = Tuple[torch.Tensor, np.ndarray, PackSpec, KernelGeom]


def split_batch_kernel(batch: DeviceBatch, pids: torch.Tensor,
                       n: int) -> Optional[Split]:
    """Pack + reorder one batch -> (out, stats_host, spec, geom), or None
    when the batch is outside the fast path (n outside 2..MAX_PARTS, an
    unpackable column, an overflow): the caller takes the sort path."""
    if n < 2 or n > MAX_PARTS:
        return None
    spec = PackSpec.for_batch(batch)
    if spec is None:
        return None
    geom = KernelGeom.plan(batch.capacity, n, spec.lanes)
    out, stats = partition_reorder(*kernel_inputs(batch, pids, spec, geom),
                                   geom)
    res = finalize_split(out, stats, spec, geom)
    if res is not None and out.device.type != "cpu":
        REORDER_KERNEL._bump("kept")
    return res


def finalize_split(out: torch.Tensor, stats: torch.Tensor, spec: PackSpec,
                   geom: KernelGeom) -> Optional[Split]:
    """One small download of (count, flag) per piece; None on overflow."""
    stats_host = stats[:, :, :2].cpu().numpy()
    if stats_host[:, :, 1].max(initial=0) > 0:
        return None
    return out, stats_host, spec, geom


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host index array on ``device``; on a GPU through pinned
    memory and an asynchronous copy, so the stream is not synchronized."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _runs(starts: torch.Tensor, lengths: torch.Tensor,
          size: int) -> torch.Tensor:
    """Concatenated ranges [starts[i], starts[i] + lengths[i]) (int64;
    ``size`` is the lengths' sum)."""
    dev = starts.device
    first = torch.cumsum(lengths, 0) - lengths
    return (torch.repeat_interleave(starts - first, lengths, output_size=size)
            + torch.arange(size, device=dev))


def consolidate(out: torch.Tensor, stats_host: np.ndarray, j: int,
                spec: PackSpec, schema: Schema,
                geom: KernelGeom) -> Optional[DeviceBatch]:
    """Partition j's pieces -> one DeviceBatch (None when empty): one row
    gather in the reference's order (every group's full 8-row blocks, then
    every group's remainder rows)."""
    counts = stats_host[:, j, 0].astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return None
    full = counts // BLOCK * BLOCK
    nb_tot = int(full.sum())
    dev = out.device
    base = torch.arange(geom.groups, device=dev) * geom.quota
    full_t, rem_t = _upload(np.stack([full, counts - full]), dev)
    rows = torch.cat([_runs(base, full_t, nb_tot),
                      _runs(base + full_t, rem_t, total - nb_tot)])
    mat = pad_rows(out[j].reshape(-1, geom.L)[rows], bucket_capacity(total))
    return DeviceBatch(schema, tuple(unpack_columns(spec, schema, mat)), total)


# ------------------------------------------------------------------ compact
def dma_index_plan(counts: np.ndarray, geom: KernelGeom):
    """Host index math of the one-launch consolidation (the JAX package's,
    array for array): counts [groups, n] -> (prefix8 [n, groups] 8-aligned
    destination rows of each group's full-block run, nb8 [n] full-block
    rows per partition, ridx [n, ri_cap] remainder rows' staging indices
    within the partition's groups*quota rows, ri_cap, dst_rows)."""
    n, groups, quota = geom.n, geom.groups, geom.quota
    totals = counts.sum(axis=0)
    nb = counts // BLOCK
    rem = counts - nb * BLOCK
    nb8 = (nb.sum(axis=0) * BLOCK).astype(np.int32)
    prefix8 = np.zeros((n, groups), np.int32)
    prefix8[:, 1:] = np.cumsum((nb.T * BLOCK)[:, :-1], axis=1)
    ri_cap = int(bucket_capacity(max(1, int(rem.sum(axis=0).max()))))
    ridx = np.zeros((n, ri_cap), np.int32)
    for j in range(n):
        rj = rem[:, j]
        rem_tot = int(rj.sum())
        rgid = np.repeat(np.arange(groups), rj)
        rwithin = np.arange(rem_tot) - np.repeat(np.cumsum(rj) - rj, rj)
        ridx[j, :rem_tot] = (rgid * quota + nb[:, j][rgid] * BLOCK
                             + rwithin).astype(np.int32)
    dst_rows = int(bucket_capacity(int(totals.max()))) + max(quota, ri_cap)
    return prefix8, nb8, ridx, ri_cap, dst_rows


@dataclass(frozen=True)
class CompactPlan:
    """What ``dma_compact`` needs besides the staging tensor: the index plan
    and each partition's live and bucketed row counts (all host arrays)."""
    prefix8: np.ndarray     # int32 [n, groups]
    nb8: np.ndarray         # int32 [n]
    totals: np.ndarray      # int32 [n]
    fills: np.ndarray       # int32 [n]: bucket_capacity(total), 0 if empty
    ridx: np.ndarray        # int32 [n, ri_cap]
    dst_rows: int

    @staticmethod
    def of(counts: np.ndarray, geom: KernelGeom) -> "CompactPlan":
        prefix8, nb8, ridx, _ri_cap, dst_rows = dma_index_plan(counts, geom)
        totals = counts.sum(axis=0).astype(np.int32)
        fills = np.array([bucket_capacity(int(t)) if t else 0
                          for t in totals], np.int32)
        return CompactPlan(prefix8, nb8, totals, fills, ridx, dst_rows)

    def index_array(self) -> np.ndarray:
        """The kernel's one int32 index array: prefix8 | nb8 | totals |
        fills | ridx."""
        return np.concatenate([self.prefix8.ravel(), self.nb8, self.totals,
                               self.fills, self.ridx.ravel()]).astype(np.int32)

    def tail_ctas(self) -> int:
        """CTAs per partition for its remainder and zero rows."""
        span = int((self.fills - self.nb8).max(initial=0))
        return max(1, -(-span // TAIL_ROWS))


def _check_compact(out: torch.Tensor, plan: CompactPlan,
                   geom: KernelGeom) -> None:
    want = (geom.n, geom.groups, geom.quota, geom.L)
    if out.dtype != torch.uint8 or tuple(out.shape) != want:
        raise ValueError(f"out must be uint8 {want}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if plan.prefix8.shape != (geom.n, geom.groups) or \
            plan.ridx.shape[0] != geom.n:
        raise ValueError("the compact plan does not match the geometry")


def dma_compact(out: torch.Tensor, plan: CompactPlan,
                geom: KernelGeom) -> torch.Tensor:
    """Every partition's live rows in the reference's order -> compact
    uint8 [n, dst_rows, L]: rows [0, total) live, [total, bucket) zero,
    the rest undefined. CPU tensors take the plain version; any other
    device goes to the CUDA kernel, which runs or raises."""
    _check_compact(out, plan, geom)
    if out.device.type == "cpu":
        return dma_compact_plain(out, plan, geom)
    return COMPACT_KERNEL(out, plan, geom)


def dma_compact_plain(out: torch.Tensor, plan: CompactPlan,
                      geom: KernelGeom) -> torch.Tensor:
    """The compaction in plain PyTorch, from the same plan: each piece's
    full-block run to its prefix8 row, each partition's remainder rows
    (ridx) from its nb8 row on, one scatter for all; then the zero rows."""
    _check_compact(out, plan, geom)
    n, groups, quota, L = geom.n, geom.groups, geom.quota, geom.L
    dev = out.device

    def up(a: np.ndarray) -> torch.Tensor:
        return _upload(a.astype(np.int64), dev)

    prefix8, nb8, totals = up(plan.prefix8), up(plan.nb8), up(plan.totals)
    part = torch.arange(n, device=dev)
    run_end = torch.cat([prefix8[:, 1:], nb8[:, None]], dim=1)
    run_rows = (run_end - prefix8).reshape(-1)
    n_full = int(plan.nb8.astype(np.int64).sum())
    src_full = _runs(torch.arange(n * groups, device=dev) * quota, run_rows,
                     n_full)
    dst_full = _runs((part[:, None] * plan.dst_rows + prefix8).reshape(-1),
                     run_rows, n_full)
    rem = totals - nb8
    n_rem = int(plan.totals.astype(np.int64).sum()) - n_full
    ridx = up(plan.ridx)
    taken = torch.arange(ridx.shape[1], device=dev)[None, :] < rem[:, None]
    src_rem = (ridx + part[:, None] * (groups * quota))[taken]
    dst_rem = _runs(part * plan.dst_rows + nb8, rem, n_rem)
    compact = torch.empty((n, plan.dst_rows, L), dtype=torch.uint8, device=dev)
    compact.view(-1, L)[torch.cat([dst_full, dst_rem])] = \
        out.view(-1, L)[torch.cat([src_full, src_rem])]
    for j in range(n):
        compact[j, int(plan.totals[j]):int(plan.fills[j])] = 0
    return compact


class _CompactKernel(_Counted):
    """ctypes binding of csrc/dma_compact.cu. ``launches`` counts the
    launches of the kernel (and nothing else)."""

    SOURCE = "dma_compact.cu"
    PREFIX = "compact"

    @staticmethod
    def _bind(lib: ctypes.CDLL) -> None:
        lib.dma_compact.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.dma_compact.restype = ctypes.c_int
        lib.dma_compact_error.argtypes = [ctypes.c_int]
        lib.dma_compact_error.restype = ctypes.c_char_p

    def load(self) -> ctypes.CDLL:
        return cuda_build.load(self.SOURCE, self._bind)

    def __call__(self, out: torch.Tensor, plan: CompactPlan,
                 geom: KernelGeom) -> torch.Tensor:
        _check_compact(out, plan, geom)
        if out.device.type != "cuda":
            raise ValueError(f"the CUDA compact kernel needs CUDA tensors, "
                             f"got {out.device}")
        lib = self.load()
        idx = _upload(plan.index_array(), out.device)
        compact = torch.empty((geom.n, plan.dst_rows, geom.L),
                              dtype=torch.uint8, device=out.device)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.dma_compact(
            out.data_ptr(), idx.data_ptr(), compact.data_ptr(), geom.groups,
            geom.n, geom.quota, geom.L, plan.ridx.shape[1], plan.dst_rows,
            plan.tail_ctas(), stream)
        if err != 0:
            msg = lib.dma_compact_error(err).decode()
            raise RuntimeError(f"dma_compact launch failed: CUDA error {err} "
                               f"({msg})")
        self._bump("launches")
        return compact


#: the process's binding of the CUDA compact kernel
COMPACT_KERNEL = _CompactKernel()


def consolidate_all(out: torch.Tensor, stats_host: np.ndarray, spec: PackSpec,
                    schema: Schema,
                    geom: KernelGeom) -> List[Optional[DeviceBatch]]:
    """Every partition's pieces -> one DeviceBatch each (None for an empty
    partition): one ``dma_compact`` for all partitions, then each
    partition's unpack reads its rows of the compact directly."""
    counts = stats_host[:, :, 0].astype(np.int64)      # [groups, n]
    if counts.sum(axis=0).max(initial=0) == 0:
        return [None] * geom.n
    plan = CompactPlan.of(counts, geom)
    compact = dma_compact(out, plan, geom)
    batches: List[Optional[DeviceBatch]] = []
    for j in range(geom.n):
        total = int(plan.totals[j])
        if total == 0:
            batches.append(None)
            continue
        mat = compact[j, :int(plan.fills[j])]
        batches.append(DeviceBatch(
            schema, tuple(unpack_columns(spec, schema, mat)), total))
    return batches
