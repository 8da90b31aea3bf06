"""Shuffle exchange operator, its partitionings and its stage statistics.

The map side partitions each child batch on the device and caches the
pieces in the spillable shuffle catalog (shuffle/catalog.py over the
process's store chain, memory/store.py: device -> host -> disk under the
device budget), keyed (shuffle, map, partition); the reduce side reads one
partition's blocks back through the catalog, and the action's cleanups
remove the shuffle. A hash or round-robin batch with 2..32 partitions goes
through the partition-reorder kernel (shuffle/partition_kernel.py), then
one consolidation: ``consolidate_all`` (one compact launch for every
partition) when ``shuffle.kernel.dmaConsolidate.enabled`` is set, else one
``consolidate`` gather per partition; both give the same batches. A wider
fan-out, an unpackable batch or a quota overflow takes the sort path
(``split_by_pid``). A range exchange stages its child's batches, samples
their keys for the bounds, and always takes the sort path, as in the JAX
package.

Partition ids are bit-identical to the JAX package's: the same murmur3-style
32-bit mix, held in int64 tensors with the wrap made explicit by masking,
the same round-robin start offsets, and range bounds from the same sample
rows and quantile picks.

``TpuBroadcastExchangeExec`` materializes its child once into one batch that
every consumer partition reads, and releases it when the action ends.

The CPU engine's exchanges (``CpuShuffleExchangeExec``,
``CpuBroadcastExchangeExec``; execs/cpu_execs.py) run the same map side
on the host, keep the pieces in memory instead of the catalog (the stock
Spark shuffle's role in the JAX package) and always take the sort path.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema, bucket_capacity
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import CpuEngineExec, _row_width
from spark_rapids_tpu_torch.execs.tpu_execs import (batch_of,
                                                    concat_device_batches,
                                                    eval_ctx)
from spark_rapids_tpu_torch.exprs.core import ColV, Expression
from spark_rapids_tpu_torch.exprs.misc import SortOrder
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops.strings import align_widths, pad_width
from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
from spark_rapids_tpu_torch.shuffle.catalog import (ShuffleBlockId,
                                                    ShuffleBufferCatalog)
from spark_rapids_tpu_torch.shuffle.table_meta import (DevicePackLayout,
                                                       batch_string_max,
                                                       layout_to_meta,
                                                       uniform_string_batch)


# ------------------------------------------------------------------ partitionings
@dataclass(frozen=True)
class Partitioning:
    num_partitions: int

    @property
    def expressions(self) -> Tuple[Expression, ...]:
        """The expressions the plan layer tags (keys or sort orders)."""
        return ()


@dataclass(frozen=True)
class SinglePartitioning(Partitioning):
    """Everything into one partition."""
    num_partitions: int = 1


@dataclass(frozen=True)
class RoundRobinPartitioning(Partitioning):
    """Row-cycling distribution; the cycle's start varies per map partition
    and batch, like Spark's per-partition start."""


@dataclass(frozen=True)
class HashPartitioning(Partitioning):
    """Key-hash distribution."""
    keys: Tuple[Expression, ...] = ()

    @property
    def expressions(self) -> Tuple[Expression, ...]:
        return self.keys


@dataclass(frozen=True)
class RangePartitioning(Partitioning):
    """Contiguous key ranges; the n - 1 bounds come from a deterministic
    sample of the input, taken when the map side runs."""
    orders: Tuple[SortOrder, ...] = ()

    @property
    def expressions(self) -> Tuple[Expression, ...]:
        return self.orders


# ------------------------------------------------------------------ hash kernel
_M32 = 0xFFFFFFFF
_H_M1 = 0x85EBCA6B
_H_M2 = 0xC2B2AE35
_H_NULL = 0x9E3779B9
_H_SEED = 42


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * _H_M1) & _M32
    h = h ^ (h >> 13)
    h = (h * _H_M2) & _M32
    return h ^ (h >> 16)


def _column_hash(v: ColV) -> torch.Tensor:
    """Per-row 32-bit hash of one key column; equal values (NaN == NaN,
    -0.0 == 0.0) hash equal. DOUBLE keys hash their canonical bits."""
    if v.dtype is DType.STRING:
        width = v.data.shape[-1]
        weights = torch.tensor([pow(37, i, 1 << 32) for i in range(width)],
                               dtype=torch.int64, device=v.data.device)
        h = (v.data.to(torch.int64) * weights).sum(dim=-1) & _M32
        return _fmix32(h ^ v.lengths.to(torch.int64))
    if v.dtype.is_floating:
        d = v.data.to(torch.float64)
        d = torch.where(torch.isnan(d), float("nan"), d)
        d = torch.where(d == 0, 0.0, d)
        bits = d.contiguous().view(torch.int64)
    else:
        bits = v.data.to(torch.int64)
    lo = bits & _M32
    hi = (bits >> 32) & _M32
    return _fmix32(_fmix32(lo) ^ hi)


def key_hashes(keys: Sequence[ColV], cap: int) -> List[torch.Tensor]:
    """Per-row 32-bit hash of each key column (int64 tensors), nulls as
    ``_H_NULL``: what a partition id mixes and what the stage's KMV sketch
    keeps."""
    return [torch.where(v.validity, _column_hash(v), _H_NULL)
            for v in (bk.as_column(k, cap) for k in keys)]


def _mix_partition_ids(hashes: Sequence[torch.Tensor], n: int,
                       seed: Optional[int] = None) -> torch.Tensor:
    if not hashes:
        raise ValueError("hash partitioning needs at least one key")
    h = torch.full_like(hashes[0], _H_SEED if seed is None else seed)
    for ch in hashes:
        h = _fmix32((h * 31 + ch) & _M32)
    return (h % n).to(torch.int32)


def hash_partition_ids(keys: Sequence[ColV], cap: int, n: int,
                       seed: Optional[int] = None) -> torch.Tensor:
    """Target partition id (int32) per row from the key columns. ``seed``
    (default the exchange's) lets the grace partitioner hash each
    recursion depth differently (memory/grace.py)."""
    return _mix_partition_ids(key_hashes(keys, cap), n, seed)


# ------------------------------------------------------------------ range bounds
#: sample rows over all staged batches that the range bounds are picked from
_SAMPLE_TARGET = 4096


def _lex_gt_bounds(row_passes: Sequence[torch.Tensor],
                   bound_passes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Partition id per row: the number of bounds lexicographically smaller
    than the row over the sort-key passes. The JAX package compares every
    row with every bound at once through ``(rows, n - 1)`` matrices; here
    one bound at a time adds its ``(rows,)`` verdict to the count, which is
    the same sum over the same comparisons without the matrices."""
    pid = torch.zeros(row_passes[0].shape[0], dtype=torch.int32,
                      device=row_passes[0].device)
    for j in range(bound_passes[0].shape[0]):
        gt = torch.zeros_like(pid, dtype=torch.bool)
        eq = torch.ones_like(gt)
        for r, b in zip(row_passes, bound_passes):
            gt |= eq & (r > b[j])
            eq &= r == b[j]
        pid += gt
    return pid


def range_partition_ids(orders: Sequence[SortOrder], row_keys: Sequence[ColV],
                        bound_keys: Sequence[ColV]) -> torch.Tensor:
    """Target partition id (int32) per row from the range bounds."""
    row_passes: List[torch.Tensor] = []
    bound_passes: List[torch.Tensor] = []
    for o, rv, bv in zip(orders, row_keys, bound_keys):
        if rv.lengths is not None:
            # one width for rows and bounds, or their word passes misalign
            rd, bd = align_widths(rv.data, bv.data)
            rv = ColV(rv.dtype, rd, rv.validity, rv.lengths)
            bv = ColV(bv.dtype, bd, bv.validity, bv.lengths)
        row_passes.extend(bk._key_passes(rv, o.ascending, o.nulls_first))
        bound_passes.extend(bk._key_passes(bv, o.ascending, o.nulls_first))
    return _lex_gt_bounds(row_passes, bound_passes)


def _sample_rows(colvs: Sequence[ColV], num_rows: int, k: int) -> List[ColV]:
    """A deterministic, evenly spaced sample of ``k`` rows (SamplingUtils'
    role), taken on the columns' device."""
    idx = torch.from_numpy(np.linspace(0, num_rows - 1, min(k, num_rows))
                           .astype(np.int32)).long()
    return [bk.take_colv(v, idx.to(v.validity.device)) for v in colvs]


def _sample_bounds(orders: Sequence[SortOrder], sampled: List[List[ColV]],
                   n: int) -> Optional[List[ColV]]:
    """The n - 1 range bounds from the per-batch key samples (CPU tensors):
    the merged sample in key order, bound i at position (i + 1) / n of it.
    Returns one ColV of n - 1 rows per order key, or None without rows."""
    if not sampled or n <= 1:
        return None
    merged: List[ColV] = []
    for ki in range(len(orders)):
        parts = [keys[ki] for keys in sampled]
        datas = [p.data for p in parts]
        if parts[0].lengths is not None:
            width = max(d.shape[-1] for d in datas)
            datas = [pad_width(d, width) for d in datas]
        merged.append(ColV(parts[0].dtype, torch.cat(datas),
                           torch.cat([p.validity for p in parts]),
                           torch.cat([p.lengths for p in parts])
                           if parts[0].lengths is not None else None))
    total = merged[0].validity.shape[0]
    if total == 0:
        return None
    passes: List[torch.Tensor] = []
    for o, v in zip(orders, merged):
        passes.extend(bk._key_passes(v, o.ascending, o.nulls_first))
    order = bk.lexsort(passes)
    idx = order[[min(total - 1, ((i + 1) * total) // n)
                 for i in range(n - 1)]]
    return [bk.take_colv(v, idx) for v in merged]


def _round_robin_offset(part: Partitioning, map_partition: int,
                        batch_index: int) -> int:
    """Start of the row cycle; only round robin distinguishes batches."""
    if isinstance(part, RoundRobinPartitioning):
        return (map_partition * 7919 + batch_index) % part.num_partitions
    return 0


def _compute_pids(part: Partitioning, cap: int, offset: int,
                  hashes: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """Partition id per row; a hash partitioning mixes ``hashes``, its
    keys' ``key_hashes``."""
    if isinstance(part, SinglePartitioning) or part.num_partitions == 1:
        return torch.zeros(cap, dtype=torch.int32, device=device)
    if isinstance(part, RoundRobinPartitioning):
        return ((torch.arange(cap, device=device) + offset)
                % part.num_partitions).to(torch.int32)
    if isinstance(part, HashPartitioning):
        return _mix_partition_ids(hashes, part.num_partitions)
    raise NotImplementedError(type(part).__name__)


# ------------------------------------------------------------------ sort path
def pid_order(pids: torch.Tensor, num_rows: int,
              n: int) -> Tuple[torch.Tensor, List[int]]:
    """The stable partition-major row order and the per-partition counts
    (one host read); dead rows go to a virtual partition n at the back."""
    cap = pids.shape[0]
    key = torch.where(bk.alive_mask(cap, num_rows, pids.device), pids, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key.to(torch.int64), minlength=n + 1)[:n]
    return order, counts.tolist()


def split_by_pid(colvs: Sequence[ColV], pids: torch.Tensor, num_rows: int,
                 n: int) -> Tuple[List[ColV], List[int]]:
    """Stable partition-major reorder + per-partition counts; dead rows go
    to a virtual partition n at the back."""
    order, counts = pid_order(pids, num_rows, n)
    return [bk.take_colv(v, order) for v in colvs], counts


def _slice_padded(colvs: Sequence[ColV], schema: Schema, start: int,
                  cnt: int) -> DeviceBatch:
    rows = torch.arange(start, start + cnt, device=colvs[0].validity.device)
    return batch_of(schema, [bk.take_padded(v, rows, bucket_capacity(cnt))
                             for v in colvs], cnt)


# ------------------------------------------------------------------ encoded split
def _exchange_encodings(ctx: ExecContext, db: DeviceBatch) -> dict:
    """Columns whose dictionary encoding rides through the exchange
    (sql.exchange.keepEncodings): only token-carrying encodings, whose
    scan-wide dictionary every piece of every batch shares."""
    if not ctx.conf.get(cfg.EXCHANGE_KEEP_ENCODINGS):
        return {}
    return {ci: c.encoding for ci, c in enumerate(db.columns)
            if c.encoding is not None and c.encoding.token is not None}


def _encoded_split_preferred(ctx: ExecContext, part: Partitioning,
                             db: DeviceBatch, enc: dict) -> bool:
    """Whether the encoded sort-path split pre-empts the reorder kernel.
    Where the kernel would not launch (tensors off CUDA, kernel mode off,
    a range exchange) the encoded split always wins over the plain sort
    path. Where it would, the indices must save at least a quarter of the
    batch's per-row bytes, so one small encoded column among wide decoded
    ones does not cost the kernel."""
    kernel_possible = (db.device.type == "cuda"
                       and ctx.conf.get(cfg.SHUFFLE_KERNEL_MODE) != "off"
                       and not isinstance(part, RangePartitioning))
    if not kernel_possible:
        return True
    saved = total = 0
    for ci, c in enumerate(db.columns):
        width = int(np.prod(c.data.shape[1:])) if c.data.dim() > 1 else 1
        row_b = c.data.element_size() * width + 1       # + validity byte
        if c.lengths is not None:
            row_b += 4
        total += row_b
        if ci in enc:
            saved += max(0, row_b - 5)    # indices: 4 B + validity byte
    return total > 0 and saved / total >= 0.25


def _split_encoded(db: DeviceBatch, pids: torch.Tensor, n: int,
                   enc: dict) -> List[Tuple[int, DeviceBatch]]:
    """The sort-path split with the encoded columns moved as their int32
    indices: each piece gathers its rows from the stable partition order,
    decodes them from the shared dictionary once and keeps the encoding
    (same dictionary, same token)."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.columnar.encoding import DictEncoding
    wire = [ColV(DType.INT, enc[ci].indices, c.validity) if ci in enc
            else ColV(c.dtype, c.data, c.validity, c.lengths)
            for ci, c in enumerate(db.columns)]
    order, counts = pid_order(pids, db.num_rows, n)
    pieces, start = [], 0
    for j, cnt in enumerate(counts):
        if not cnt:
            continue
        rows, cap = order[start:start + cnt], bucket_capacity(cnt)
        start += cnt
        cols = []
        for ci, (f, v) in enumerate(zip(db.schema, wire)):
            w = bk.take_padded(v, rows, cap)
            if ci not in enc:
                cols.append(DeviceColumn(f.dtype, w.data, w.validity,
                                         w.lengths))
                continue
            e = enc[ci]
            keep = w.validity
            data = e.values.index_select(0, w.data)
            data = torch.where(
                keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                torch.zeros((), dtype=data.dtype, device=data.device))
            lengths = (None if e.lengths is None else torch.where(
                keep, e.lengths.index_select(0, w.data), 0))
            cols.append(DeviceColumn(
                f.dtype, data, keep, lengths,
                DictEncoding(w.data, e.values, e.lengths, e.token)))
        pieces.append((j, DeviceBatch(db.schema, tuple(cols), cnt)))
    return pieces


# ------------------------------------------------------------------ stage stats
#: k-minimum-values sketch width: the 64 smallest distinct key hashes bound
#: the distinct estimate's error around 1/sqrt(k), ~12%
_KMV_K = 64


def _kmv_candidates(hashes: torch.Tensor) -> torch.Tensor:
    """The ``_KMV_K`` smallest distinct values of ``hashes`` (int64 holding
    uint32), -1 in the slots left over, without a device-to-host sync."""
    s = torch.sort(hashes).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (rank < _KMV_K), rank, _KMV_K)
    out = torch.full((_KMV_K + 1,), -1, dtype=torch.int64,
                     device=hashes.device)
    return out.scatter_(0, slot, s)[:_KMV_K]


def _kmv_merge(pool: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """Fold uint32 hashes into a KMV pool: the ``_KMV_K`` smallest distinct
    hashes seen so far, ascending. Deduplicates before truncating, so one
    heavy hitter cannot evict every other hash."""
    if hashes.size == 0:
        return pool
    return np.unique(np.concatenate([pool, np.unique(hashes)]))[:_KMV_K]


def _kmv_estimate(pool: np.ndarray) -> int:
    """Distinct count from a KMV pool: exact (up to hash collisions) while
    the pool is not full, else the (k-1) / k-th-minimum density estimate."""
    if pool.size < _KMV_K:
        return int(pool.size)
    kth = int(pool[_KMV_K - 1])
    return int((_KMV_K - 1) * (1 << 32) / max(kth, 1))


@dataclass(frozen=True)
class StageStats:
    """What one materialized shuffle map stage observed: exact rows per
    reduce partition, bytes per partition (rows x the schema's nominal row
    width) and a KMV distinct estimate per hash-partitioning key column."""
    partition_rows: Tuple[int, ...]
    partition_bytes: Tuple[int, ...]
    #: distinct-count estimate per partitioning key (hash partitioning only)
    key_distinct: Tuple[int, ...]

    @property
    def total_rows(self) -> int:
        return sum(self.partition_rows)

    @property
    def total_bytes(self) -> int:
        return sum(self.partition_bytes)

    @property
    def median_bytes(self) -> int:
        sizes = sorted(self.partition_bytes)
        return sizes[len(sizes) // 2] if sizes else 0

    def describe(self) -> str:
        nz = [s for s in self.partition_bytes if s]
        out = (f"parts={len(self.partition_bytes)} rows={self.total_rows} "
               f"bytes={self.total_bytes}"
               + (f" max={max(nz)} median={self.median_bytes}" if nz else ""))
        if self.key_distinct:
            out += " ndv~" + "/".join(str(d) for d in self.key_distinct)
        return out


# ------------------------------------------------------------------ exec base
class ShuffleExchangeExecBase(PhysicalExec):
    """An exchange's map-side lifecycle (run once, shared by every reduce
    read) and the statistics it observes."""

    def __init__(self, partitioning: Partitioning, child: PhysicalExec):
        super().__init__((child,), child.output)
        self.partitioning = partitioning
        self._lock = threading.Lock()
        self._map_done = False
        #: rows written per reduce partition
        self._part_rows: Dict[int, int] = {}
        #: rows per (map partition, reduce partition)
        self._map_part_rows: Dict[Tuple[int, int], int] = {}
        #: KMV pool per hash-partitioning key column; None before the map
        self._key_sketches: Optional[List[np.ndarray]] = None
        #: per map batch, [keys, _KMV_K] candidates still on the device
        self._pending_sketches: List[torch.Tensor] = []

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def size_estimate(self) -> Optional[int]:
        # a repartition moves rows; it neither makes nor drops them
        return self.children[0].size_estimate()

    def _run_map(self, ctx: ExecContext) -> None:
        raise NotImplementedError(self.name)

    def _ensure_map(self, ctx: ExecContext) -> None:
        """Run the map side exactly once."""
        with self._lock:
            if not self._map_done:
                self._run_map(ctx)
                self._map_done = True

    def map_output_stats(self, ctx: ExecContext) -> List[int]:
        """Estimated bytes per reduce partition, running the map side if it
        has not run."""
        self._ensure_map(ctx)
        width = _row_width(self.output)
        return [self._part_rows.get(p, 0) * width
                for p in range(self.num_partitions)]

    def stage_stats(self, ctx: Optional[ExecContext] = None
                    ) -> Optional[StageStats]:
        """The executed stage's statistics, or None when the map side has
        not run and no ctx was given to run it."""
        if not self._map_done:
            if ctx is None:
                return None
            self._ensure_map(ctx)
        width = _row_width(self.output)
        rows = tuple(self._part_rows.get(p, 0)
                     for p in range(self.num_partitions))
        ndv = tuple(_kmv_estimate(pool) for pool in (self._key_sketches or ()))
        return StageStats(rows, tuple(r * width for r in rows), ndv)

    def _sketch_keys(self, hashes: Sequence[torch.Tensor],
                     num_rows: int) -> None:
        """Keep one batch's k smallest distinct hashes per key, on the
        device (``_fold_sketches`` merges them into the KMV pools once the
        map side has run). The batch's live rows are the union of its
        pieces, so this equals sketching every piece."""
        if num_rows > 0 and hashes:
            self._pending_sketches.append(torch.stack(
                [_kmv_candidates(h[:num_rows]) for h in hashes]))

    def _fold_sketches(self) -> None:
        """One download of every batch's candidates, merged per key."""
        if not self._pending_sketches:
            return
        cand = torch.stack(self._pending_sketches).cpu().numpy()
        self._pending_sketches = []
        pools = self._key_sketches or [np.zeros(0, dtype=np.uint32)
                                       for _ in range(cand.shape[1])]
        for ki, pool in enumerate(pools):
            vals = cand[:, ki].ravel()
            pools[ki] = _kmv_merge(pool, vals[vals >= 0].astype(np.uint32))
        self._key_sketches = pools

    def map_slices(self, pid: int, num_slices: int) -> List[Tuple[int, ...]]:
        """Contiguous map-id groups covering reduce partition ``pid``,
        balanced by the observed rows per map task; fewer than
        ``num_slices`` when too few map tasks contributed."""
        contrib = sorted((m, r) for (m, p), r in self._map_part_rows.items()
                         if p == pid and r > 0)
        if not contrib:
            return []
        total = sum(r for _, r in contrib)
        num_slices = max(1, min(num_slices, len(contrib)))
        target = total / num_slices
        slices: List[Tuple[int, ...]] = []
        group: List[int] = []
        acc = 0
        for m, r in contrib:
            group.append(m)
            acc += r
            if acc >= target * (len(slices) + 1) and \
                    len(slices) + 1 < num_slices:
                slices.append(tuple(group))
                group = []
        if group:
            slices.append(tuple(group))
        return slices

    def execute_partial(self, ctx: ExecContext,
                        map_ids: Tuple[int, ...]) -> Iterator:
        """Read one reduce partition (``ctx.partition_id``) restricted to
        the given map tasks' output."""
        raise NotImplementedError(self.name)


# ------------------------------------------------------------------ device exchange
class _LocalShuffleEnv:
    """The in-process shuffle environment: a shuffle catalog over the
    device manager's spillable store chain."""

    def __init__(self, device_manager: DeviceManager):
        self.shuffle_catalog = ShuffleBufferCatalog(
            device_manager.catalog, device_manager.device_store)


def _local_shuffle_env(ctx: ExecContext) -> _LocalShuffleEnv:
    dm = ctx.device_manager or DeviceManager.initialize(ctx.conf, ctx.device)
    if dm.shuffle_env is None:
        dm.shuffle_env = _LocalShuffleEnv(dm)
    return dm.shuffle_env


_SHUFFLE_IDS = itertools.count()


class TpuShuffleExchangeExec(ShuffleExchangeExecBase):
    """Device exchange: partition each child batch on the device, cache the
    pieces in the spillable shuffle catalog, read one reduce partition back
    per consumer."""

    def __init__(self, partitioning: Partitioning, child: PhysicalExec):
        super().__init__(partitioning, child)
        self._shuffle_id: Optional[int] = None
        #: map batches split by the reorder kernel / by the sort path /
        #: by the sort path carrying dictionary indices
        self.kernel_splits = 0
        self.sort_path_splits = 0
        self.encoded_splits = 0
        #: a range partitioning's bounds (one ColV of n - 1 rows per order
        #: key), set when the map side runs
        self.range_bounds: Optional[List[ColV]] = None

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        return self._read_partition(ctx, None)

    def execute_partial(self, ctx: ExecContext,
                        map_ids: Tuple[int, ...]) -> Iterator[DeviceBatch]:
        return self._read_partition(ctx, set(map_ids))

    def _read_partition(self, ctx: ExecContext,
                        map_filter) -> Iterator[DeviceBatch]:
        """One reduce partition's cached blocks, optionally restricted to a
        set of map tasks (blocks are keyed by map task, so a map slice is a
        filter)."""
        self._ensure_map(ctx)
        catalog = _local_shuffle_env(ctx).shuffle_catalog
        for block in catalog.blocks_for_partition(self._shuffle_id,
                                                  ctx.partition_id):
            if map_filter is not None and block.map_id not in map_filter:
                continue
            for buf, _meta in catalog.acquire_buffers(block):
                try:
                    batch = buf.get_batch()
                finally:
                    buf.close()
                yield batch

    # ---- map side ------------------------------------------------------------
    def iter_map_pieces(self, ctx: ExecContext, partition_ids=None
                        ) -> Iterator[Tuple[int, int, DeviceBatch]]:
        """(map partition, reduce partition, piece) triples: each child
        batch is split as it is produced, so the peak footprint is one batch
        plus the spillable shuffle cache. A range partitioning first stages
        every batch and samples the bounds from them."""
        child = self.children[0]
        batches = ((map_p, bi, db)
                   for map_p in range(child.num_partitions)
                   if partition_ids is None or map_p in partition_ids
                   for bi, db in enumerate(child.execute(
                       ctx.for_partition(map_p, child.num_partitions))))
        bounds = None
        if isinstance(self.partitioning, RangePartitioning):
            batches = list(batches)
            bounds = self._device_bounds(ctx, [db for _, _, db in batches])
            self.range_bounds = bounds
        for map_p, bi, db in batches:
            if db.num_rows == 0:
                continue
            offset = _round_robin_offset(self.partitioning, map_p, bi)
            for j, sub in self._split_batch(ctx, db, offset, bounds):
                yield map_p, j, sub

    def _device_bounds(self, ctx: ExecContext, staged: List[DeviceBatch]
                       ) -> Optional[List[ColV]]:
        """Evaluate the order keys on the device and gather the sample
        there; only the sampled rows (at most ``_SAMPLE_TARGET`` in all)
        reach the host, where the bounds are picked. The bounds go back to
        the device."""
        if not staged:
            return None
        part = self.partitioning
        per = max(1, _SAMPLE_TARGET // len(staged))
        sampled = []
        for db in staged:
            if db.num_rows == 0:
                continue
            ectx = eval_ctx(db, ctx)
            keys = [bk.as_column(o.child.eval(ectx), db.capacity)
                    for o in part.orders]
            sampled.append([ColV(v.dtype, v.data.cpu(), v.validity.cpu(),
                                 None if v.lengths is None
                                 else v.lengths.cpu())
                            for v in _sample_rows(keys, db.num_rows, per)])
        bounds = _sample_bounds(part.orders, sampled, part.num_partitions)
        if bounds is None:
            return None
        return [ColV(v.dtype, v.data.to(ctx.device),
                     v.validity.to(ctx.device),
                     None if v.lengths is None else v.lengths.to(ctx.device))
                for v in bounds]

    def _run_map(self, ctx: ExecContext) -> None:
        catalog = _local_shuffle_env(ctx).shuffle_catalog
        sid = next(_SHUFFLE_IDS)
        self._shuffle_id = sid
        if ctx.cleanups is not None:
            ctx.cleanups.append(lambda: catalog.remove_shuffle(sid))
        for map_p, j, sub in self.iter_map_pieces(ctx):
            sub = uniform_string_batch(sub)
            layout = DevicePackLayout.for_batch_shape(
                sub.schema, sub.capacity, batch_string_max(sub))
            catalog.add_batch(ShuffleBlockId(sid, map_p, j), sub,
                              layout_to_meta(layout, sub.num_rows))
            self._part_rows[j] = self._part_rows.get(j, 0) + sub.num_rows
            self._map_part_rows[(map_p, j)] = \
                self._map_part_rows.get((map_p, j), 0) + sub.num_rows
        self._fold_sketches()

    def _split_batch(self, ctx: ExecContext, db: DeviceBatch, offset: int,
                     bounds: Optional[List[ColV]] = None
                     ) -> List[Tuple[int, DeviceBatch]]:
        part, n = self.partitioning, self.partitioning.num_partitions
        ectx = eval_ctx(db, ctx)
        hashes: List[torch.Tensor] = []
        if isinstance(part, HashPartitioning):
            hashes = key_hashes([e.eval(ectx) for e in part.keys],
                                db.capacity)
            self._sketch_keys(hashes, db.num_rows)
        if isinstance(part, SinglePartitioning) or n == 1:
            return [(0, db)]
        if isinstance(part, RangePartitioning):
            # the bounds path stays on the sort path, as in the JAX package
            pids = (range_partition_ids(
                part.orders, [bk.as_column(o.child.eval(ectx), db.capacity)
                              for o in part.orders], bounds)
                    if bounds is not None else
                    torch.zeros(db.capacity, dtype=torch.int32,
                                device=db.device))
        else:
            pids = _compute_pids(part, db.capacity, offset, hashes,
                                 db.device)
        enc = _exchange_encodings(ctx, db)
        if enc and _encoded_split_preferred(ctx, part, db, enc):
            from spark_rapids_tpu_torch.columnar.encoding import count
            self.encoded_splits += 1
            count("exchange_encoded_ops")
            return _split_encoded(db, pids, n, enc)
        if ctx.conf.get(cfg.SHUFFLE_KERNEL_MODE) != "off" and \
                not isinstance(part, RangePartitioning):
            pieces = self._kernel_split(ctx, db, pids, n)
            if pieces is not None:
                self.kernel_splits += 1
                return pieces
        self.sort_path_splits += 1
        sorted_cols, counts = split_by_pid(ectx.columns, pids, db.num_rows, n)
        pieces, start = [], 0
        for j, cnt in enumerate(counts):
            if cnt:
                pieces.append((j, _slice_padded(sorted_cols, db.schema, start,
                                                cnt)))
            start += cnt
        return pieces

    @staticmethod
    def _kernel_split(ctx: ExecContext, db: DeviceBatch, pids: torch.Tensor,
                      n: int) -> Optional[List[Tuple[int, DeviceBatch]]]:
        """Reorder through the kernel, then consolidate every partition in
        one compact launch (dmaConsolidate) or one gather each; None when
        the batch must take the sort path."""
        res = pk.split_batch_kernel(db, pids, n)
        if res is None:
            return None
        out, stats, spec, geom = res
        if ctx.conf.get(cfg.SHUFFLE_DMA_CONSOLIDATE):
            subs = pk.consolidate_all(out, stats, spec, db.schema, geom)
        else:
            subs = [pk.consolidate(out, stats, j, spec, db.schema, geom)
                    for j in range(n)]
        return [(j, sub) for j, sub in enumerate(subs) if sub is not None]


# ------------------------------------------------------------------ broadcast
class TpuBroadcastExchangeExec(PhysicalExec):
    """Every partition of the child materialized once into one device batch,
    which every consumer partition reads; the action's cleanups release
    it."""

    def __init__(self, child: PhysicalExec):
        super().__init__((child,), child.output)
        self._lock = threading.Lock()
        self._cached: Optional[DeviceBatch] = None

    @property
    def num_partitions(self) -> int:
        return 1

    def size_estimate(self) -> Optional[int]:
        return self.children[0].size_estimate()

    def _release(self) -> None:
        self._cached = None

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        with self._lock:
            if self._cached is None:
                if ctx.cleanups is not None:
                    ctx.cleanups.append(self._release)
                child = self.children[0]
                parts = child.num_partitions
                self._cached = concat_device_batches(
                    [b for p in range(parts)
                     for b in child.execute(ctx.for_partition(p, parts))],
                    self.output, ctx.device)
            batch = self._cached
        yield batch


# ------------------------------------------------------------------ CPU engine
class _HostShuffleExchangeExec(TpuShuffleExchangeExec):
    """The map side on the host: the sort-path split (rows of a partition
    in input order, as the JAX package's CPU exchange keeps them), the
    pieces held in memory until the action's cleanups release them."""

    def _run_map(self, ctx: ExecContext) -> None:
        #: reduce partition -> [(map partition, piece)]
        self._parts: Dict[int, List[Tuple[int, DeviceBatch]]] = {}
        if ctx.cleanups is not None:
            ctx.cleanups.append(self._parts.clear)
        for map_p, j, sub in self.iter_map_pieces(ctx):
            self._parts.setdefault(j, []).append((map_p, sub))
            self._part_rows[j] = self._part_rows.get(j, 0) + sub.num_rows
            self._map_part_rows[(map_p, j)] = \
                self._map_part_rows.get((map_p, j), 0) + sub.num_rows
        self._fold_sketches()

    def _read_partition(self, ctx: ExecContext,
                        map_filter) -> Iterator[DeviceBatch]:
        self._ensure_map(ctx)
        for map_p, piece in self._parts.get(ctx.partition_id, []):
            if map_filter is None or map_p in map_filter:
                yield piece

    @staticmethod
    def _kernel_split(ctx, db, pids, n):
        return None


class CpuShuffleExchangeExec(CpuEngineExec):
    """The CPU engine's exchange."""

    def __init__(self, partitioning: Partitioning, child: PhysicalExec):
        self.partitioning = partitioning
        super().__init__((child,))

    def device_twin(self, children):
        return _HostShuffleExchangeExec(self.partitioning, children[0])


class CpuBroadcastExchangeExec(CpuEngineExec):
    """The CPU engine's broadcast: the child's batches concatenated once on
    the host."""

    def __init__(self, child: PhysicalExec):
        super().__init__((child,))

    def device_twin(self, children):
        return TpuBroadcastExchangeExec(children[0])
