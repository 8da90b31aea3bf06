"""The exchange between mesh shards (the JAX package's ``shuffle/ici.py``).

The JAX package's repartition is one XLA ``all_to_all`` over the mesh; the
port's moves each (source, destination) piece device to device:

1. per source shard, a stable sort of its live rows by destination
   (``exchange_execs.split_by_pid``, the sort path; the reorder kernel's
   8-row blocks would change the order within a destination);
2. each destination's rows are the sources' pieces in shard order: source
   0's rows, then source 1's, each in its source order, copied into one
   fresh buffer on the destination's device (a copy between two cards goes
   peer to peer, never through host memory).

Destination ``d`` thus receives the rows the JAX package's compacted
``all_to_all`` gives it, in the same order. A source sends at most
``chunk_capacity`` rows to one destination, as in the JAX package, and the
rows past it are counted, not silently dropped: ``ici_repartition`` checks
the count and re-runs with a doubled chunk until nothing was clamped
(``RERUN_COUNT`` counts the re-runs). The mesh operators size the chunk
from the counts, so they never clamp (execs/mesh_execs.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (DType, Schema,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.parallel.mesh import Mesh
from spark_rapids_tpu_torch.parallel.mesh_batch import (MeshBatch,
                                                        count_crossing)

#: process-wide count of overflow-triggered re-runs (tests assert that the
#: detect-and-re-run loop fires)
RERUN_COUNT = 0


def exchange(mb: MeshBatch, pids: Sequence[torch.Tensor],
             chunk_capacity: Optional[int] = None
             ) -> Tuple[MeshBatch, int, np.ndarray]:
    """Move every live row of ``mb`` to shard ``pids[s][row]`` -> (the
    repartitioned batch, rows clamped by ``chunk_capacity``, the int64
    ``[source, destination]`` counts matrix). Without a chunk capacity
    nothing is clamped."""
    from spark_rapids_tpu_torch.execs.exchange_execs import split_by_pid
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    n = mb.n_dev
    sorted_cols: List[List[ColV]] = []
    cmat = np.zeros((n, n), dtype=np.int64)
    for s, b in enumerate(mb.shards):
        cols, counts = split_by_pid(colvs_of(b), pids[s].to(torch.int64),
                                    b.num_rows, n)
        sorted_cols.append(cols)
        cmat[s] = counts
    sent = cmat if chunk_capacity is None else np.minimum(cmat,
                                                          chunk_capacity)
    overflow = int((cmat - sent).sum())
    starts = np.concatenate([np.zeros((n, 1), np.int64),
                             np.cumsum(cmat, axis=1)[:, :-1]], axis=1)
    shards = []
    for d, dev in enumerate(mb.mesh.devices):
        pieces = [(s, int(starts[s, d]), int(sent[s, d])) for s in range(n)
                  if sent[s, d]]
        total = int(sent[:, d].sum())
        cols = [_assemble([sorted_cols[s][ci] for s, _, _ in pieces],
                          [(lo, k) for _, lo, k in pieces], f, total, dev)
                for ci, f in enumerate(mb.schema)]
        shards.append(DeviceBatch(mb.schema, tuple(cols), total))
    return MeshBatch(mb.schema, tuple(shards), mb.mesh), overflow, cmat


def copy_rows(db: DeviceBatch, spans: List[Tuple[int, int]],
              device: torch.device, capacity: int) -> DeviceBatch:
    """The rows ``[lo, lo + k)`` of each span of ``db``, in order, as a
    fresh batch of ``capacity`` rows on ``device``."""
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    total = sum(k for _, k in spans)
    cols = [_assemble([v] * len(spans), spans, f, total, device, capacity)
            for f, v in zip(db.schema, colvs_of(db))]
    return DeviceBatch(db.schema, tuple(cols), total)


def _assemble(srcs: List[ColV], spans: List[Tuple[int, int]], field,
              total: int, device: torch.device,
              cap: Optional[int] = None) -> DeviceColumn:
    """One destination column: each source's rows ``[lo, lo + k)``
    copied in order into fresh buffers of ``cap`` rows (default
    ``total``'s capacity bucket)."""
    cap = cap or bucket_capacity(total)
    strings = field.dtype is DType.STRING
    if strings:
        width = max((v.data.shape[1] for v in srcs), default=8)
        data = torch.zeros((cap, width), dtype=torch.uint8, device=device)
    else:
        data = torch.zeros(cap, dtype=(srcs[0].data.dtype if srcs else
                                       field.dtype.torch_dtype()),
                           device=device)
    validity = torch.zeros(cap, dtype=torch.bool, device=device)
    lengths = (torch.zeros(cap, dtype=torch.int32, device=device)
               if strings else None)
    off = 0
    for v, (lo, k) in zip(srcs, spans):
        rows = slice(lo, lo + k)
        count_crossing(v.data.device, data.device,
                       v.data[rows].nbytes + v.validity[rows].nbytes
                       + (v.lengths[rows].nbytes if strings else 0))
        if strings:
            data[off:off + k, :v.data.shape[1]].copy_(v.data[rows],
                                                      non_blocking=True)
            lengths[off:off + k].copy_(v.lengths[rows], non_blocking=True)
        else:
            data[off:off + k].copy_(v.data[rows], non_blocking=True)
        validity[off:off + k].copy_(v.validity[rows], non_blocking=True)
        off += k
    return DeviceColumn(field.dtype, data, validity, lengths)


def build_ici_repartition(mesh: Mesh, schema: Schema, local_capacity: int,
                          chunk_capacity: Optional[int] = None):
    """The repartition step at one chunk capacity (default
    ``local_capacity``, always safe: a source holds at most that many
    rows): fn(mesh batch, per-shard int pids) -> (int32[n_dev] rows per
    destination, rows clamped across every shard, the batch). A thin
    wrapper over ``exchange``, the step the mesh operators run
    (``execs/mesh_execs.py::_mesh_repartition``, which sizes no chunk and
    so never clamps); it keeps the JAX package's entry point."""
    chunk = chunk_capacity or local_capacity

    def fn(mb: MeshBatch, pids: Sequence[torch.Tensor]):
        out, overflow, _ = exchange(mb, pids, chunk)
        return out.rows_per_shard, overflow, out
    return fn


def ici_repartition(mesh: Mesh, schema: Schema, local_capacity: int,
                    mb: MeshBatch, pids: Sequence[torch.Tensor],
                    chunk_capacity: Optional[int] = None) -> MeshBatch:
    """The overflow-safe loop: runs the step, checks the clamped count,
    and re-runs with a doubled chunk capacity until no row was clamped.
    A thin wrapper over ``exchange`` (through ``build_ici_repartition``)
    that keeps the JAX package's driver and its ``RERUN_COUNT``; the mesh
    operators call ``exchange`` unclamped instead."""
    global RERUN_COUNT
    chunk = chunk_capacity or local_capacity
    while True:
        _, overflow, out = build_ici_repartition(
            mesh, schema, local_capacity, chunk)(mb, pids)
        if overflow == 0:
            return out
        if chunk >= local_capacity:
            raise AssertionError(
                "mesh repartition overflowed at chunk_capacity == "
                "local_capacity: the input breaks the padding invariant")
        chunk = min(chunk * 2, local_capacity)
        RERUN_COUNT += 1
