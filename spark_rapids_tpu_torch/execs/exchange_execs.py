"""Shuffle exchange operator and its partitionings.

The map side partitions each child batch on the device and stores the
pieces in the action's in-memory block map (``ShuffleBlocks``, keyed
(shuffle, map, partition)); the reduce side reads one partition's blocks
back. A hash-partitioned batch with 2..32 partitions goes through the
partition-reorder kernel (shuffle/partition_kernel.py); a wider fan-out, an
unpackable batch or a quota overflow takes the sort path (``split_by_pid``).

Partition ids are bit-identical to the JAX package's: the same murmur3-style
32-bit mix, held in int64 tensors with the wrap made explicit by masking.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema, bucket_capacity
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.tpu_execs import batch_of, eval_ctx
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.shuffle import partition_kernel as pk


# ------------------------------------------------------------------ partitionings
@dataclass(frozen=True)
class Partitioning:
    num_partitions: int


@dataclass(frozen=True)
class SinglePartitioning(Partitioning):
    """Everything into one partition."""
    num_partitions: int = 1


@dataclass(frozen=True)
class HashPartitioning(Partitioning):
    """Key-hash distribution."""
    keys: Tuple[Expression, ...] = ()


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


def hash_partition_ids(keys: Sequence[ColV], cap: int, n: int) -> torch.Tensor:
    """Target partition id (int32) per row from the key columns."""
    h = None
    for v in keys:
        v = bk.as_column(v, cap)
        ch = torch.where(v.validity, _column_hash(v), _H_NULL)
        if h is None:
            h = torch.full_like(ch, _H_SEED)
        h = _fmix32((h * 31 + ch) & _M32)
    if h is None:
        raise ValueError("hash partitioning needs at least one key")
    return (h % n).to(torch.int32)


def _compute_pids(part: Partitioning, ectx: EvalCtx, cap: int) -> torch.Tensor:
    if isinstance(part, SinglePartitioning) or part.num_partitions == 1:
        return torch.zeros(cap, dtype=torch.int32, device=ectx.device)
    if isinstance(part, HashPartitioning):
        return hash_partition_ids([e.eval(ectx) for e in part.keys], cap,
                                  part.num_partitions)
    raise NotImplementedError(type(part).__name__)


# ------------------------------------------------------------------ sort path
def split_by_pid(colvs: Sequence[ColV], pids: torch.Tensor, num_rows: int,
                 n: int) -> Tuple[List[ColV], List[int]]:
    """Stable partition-major reorder + per-partition counts; dead rows go
    to a virtual partition n at the back."""
    cap = pids.shape[0]
    key = torch.where(bk.alive_mask(cap, num_rows, pids.device), pids, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key.to(torch.int64), minlength=n + 1)[:n]
    return [bk.take_colv(v, order) for v in colvs], counts.tolist()


def _slice_padded(colvs: Sequence[ColV], schema: Schema, start: int,
                  cnt: int) -> DeviceBatch:
    rows = torch.arange(start, start + cnt, device=colvs[0].validity.device)
    return batch_of(schema, [bk.take_padded(v, rows, bucket_capacity(cnt))
                             for v in colvs], cnt)


# ------------------------------------------------------------------ exchange
class ShuffleBlocks:
    """One action's map outputs: device batches keyed (shuffle, map,
    partition), released with the action."""

    def __init__(self):
        self._blocks: Dict[Tuple[int, int, int], List[DeviceBatch]] = {}
        self._mapped: set = set()

    def is_mapped(self, shuffle_id: int) -> bool:
        return shuffle_id in self._mapped

    def mark_mapped(self, shuffle_id: int) -> None:
        self._mapped.add(shuffle_id)

    def put(self, shuffle_id: int, map_id: int, partition: int,
            batch: DeviceBatch) -> None:
        self._blocks.setdefault((shuffle_id, map_id, partition), []).append(
            batch)

    def partition(self, shuffle_id: int, partition: int) -> List[DeviceBatch]:
        keys = sorted(k for k in self._blocks
                      if k[0] == shuffle_id and k[2] == partition)
        return [b for k in keys for b in self._blocks[k]]


_SHUFFLE_IDS = itertools.count()


class TpuShuffleExchangeExec(PhysicalExec):
    """Device exchange: partition each child batch on the device, keep the
    pieces in the action's block map, read one reduce partition back."""

    def __init__(self, partitioning: Partitioning, child: PhysicalExec):
        super().__init__((child,), child.output)
        self.partitioning = partitioning
        self.shuffle_id = next(_SHUFFLE_IDS)
        #: map batches split by the reorder kernel / by the sort path
        self.kernel_splits = 0
        self.sort_path_splits = 0

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        blocks = ctx.shuffle_blocks
        if not blocks.is_mapped(self.shuffle_id):
            self._run_map(ctx)
            blocks.mark_mapped(self.shuffle_id)
        for batch in blocks.partition(self.shuffle_id, ctx.partition_id):
            yield batch

    def _run_map(self, ctx: ExecContext) -> None:
        child = self.children[0]
        for map_p in range(child.num_partitions):
            cctx = ctx.for_partition(map_p, child.num_partitions)
            for db in child.execute(cctx):
                if db.num_rows == 0:
                    continue
                for j, sub in self._split_batch(ctx, db):
                    ctx.shuffle_blocks.put(self.shuffle_id, map_p, j, sub)

    def _split_batch(self, ctx: ExecContext,
                     db: DeviceBatch) -> List[Tuple[int, DeviceBatch]]:
        part, n = self.partitioning, self.partitioning.num_partitions
        if isinstance(part, SinglePartitioning) or n == 1:
            return [(0, db)]
        ectx = eval_ctx(db, ctx)
        pids = _compute_pids(part, ectx, db.capacity)
        if ctx.conf.get(cfg.SHUFFLE_KERNEL_MODE) != "off":
            pieces = self._kernel_split(db, pids, n)
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
    def _kernel_split(db: DeviceBatch, pids: torch.Tensor, n: int):
        """Reorder through the kernel and gather each partition into one
        batch; None when the batch must take the sort path."""
        res = pk.split_batch_kernel(db, pids, n)
        if res is None:
            return None
        out, stats, spec, geom = res
        pieces = []
        for j in range(n):
            sub = pk.consolidate(out, stats, j, spec, db.schema, geom)
            if sub is not None:
                pieces.append((j, sub))
        return pieces
