#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

Phases:
  1. require a CUDA device; print the card's name and power limit;
  2. build every hand-written kernel from csrc/ with nvcc, one nvcc per
     source, all started together;
  3. hold each kernel against its plain PyTorch version on the card:
     - the partition-reorder kernel at the main path's shape (lineitem, 8
       hash partitions on l_orderkey), at n = 2 and n = 32, on a ragged
       batch with dead rows and an odd row width, with a partition that
       gets no row, on a tiny batch, on wide rows (L = 300: fewer rows per
       tile; L = 1100 and 2600: the wide form, one and several bulk copies
       per tile), with half the rows dead in every window, with num_rows
       ending inside a tile, at n = 32 with L = 13, and on an
       all-in-one-partition batch that must raise the overflow flag; stats
       and every live staging row must match exactly; the kernel's time,
       byte bound and roofline share are printed beside the sort path's;
     - the compact kernel (dmaConsolidate) on the reorder kernel's real
       output at the main path's shape, at n = 2 and n = 32, at L = 21 with
       dead rows, with a partition that gets no row, and on a tiny batch;
       every live row and every zero padding row must match exactly, and
       the live rows must equal an index_select in the reference's order;
       the kernel, its plain version and that index_select are timed;
  4. the full exchange: lineitem uploaded once, TpuShuffleExchangeExec
     (hash 8 on l_orderkey) over a resident leaf, all 8 partitions read
     back through the spillable shuffle catalog, with dmaConsolidate off
     and on: the partitions must be equal, each kernel must launch once
     per map batch (the compact kernel only with dmaConsolidate), no batch
     may take the sort path, and the stage statistics must count every
     row; GB/s is the batch's logical bytes over the best of 3 warm runs;
     then a round-robin repartition(8) through the kernels, on and off;
  5. spill: at SF 1, a 256 MB device budget and a 256 MB host budget push
     the map outputs onto all three tiers; the partitions read back must
     equal the unspilled run's;
  6. TPC-H Q1 over lineitem hash-repartitioned 8 ways on l_orderkey,
     through TpuSession on cuda, held against a plain numpy Q1 over the
     same host arrays (keys and count_order exact, sums and averages to
     relative 1e-9); the reorder kernel must have launched and the exchange
     must not have taken the sort path; then the same with dmaConsolidate
     on (the compact kernel must have launched), then plain Q1 (no
     repartition) against the same reference;
  7. this slice's main path: TPC-H Q3 over customer, orders and lineitem
     (the columns Q3 reads, from tpch_data at the same scale and seed),
     orders and lineitem hash-repartitioned 8 ways on their order keys;
     first both kernels against their plain versions on the inputs Q3's
     two hash exchanges give them (stats and live staging rows exact; the
     compact kernel where the reorder's output is kept), timed and bounded
     there; then Q3 with the default conf (two shuffled hash joins), with
     the broadcast threshold at the customer side's estimate (a broadcast
     join of customer over orders' 8 partitions) and with dmaConsolidate
     on; each cold and warm against a numpy Q3 (keys and dates exact,
     revenue to relative 1e-9), with its join strategies, its reorder
     launches (one per hash-exchange map batch), the aggregate's
     escalation path and the peak device memory;
  8. TPC-H Q6 against a numpy Q6; lineitem hash-repartitioned 8 ways and
     sorted on (l_shipdate, l_orderkey) through the range exchange: the 7
     bounds, the per-partition counts and the collected rows against
     numpy (np.lexsort's order); with --range-forms, the range ids on the
     whole lineitem in one batch, the port's one-bound-at-a-time form
     against the JAX package's (rows, n - 1) matrix form: equal ids, time,
     peak memory (a one-time reading: the default run skips it).

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after; comparison launches are not counted. Each phase's
seconds are printed. Prints one JSON line of per-kernel numbers: Q3's
launches (and launches_kept, those whose output was used) with the times,
bounds and errors of phase 7's checks on Q3's inputs (summed over the
inputs a Q3 run launches the kernel on, each under "inputs"), phase 3's
reading at Q1's lineitem shape, and every path's launches under
launches_by_path; then as its last line {"ok": true, "device": {...}}. Any
failure exits non-zero before that line.

Usage: python3 chip_smoke.py [--sf 10.0] [--seed 42] [--profile DIR]
       [--tile-sweep ROWS ...] [--kernels-only] [--range-forms]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import gc
import json
import subprocess
import sys
import time
import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3 rate of one H100 SXM
REL_TOL = 1e-9                      # the variableFloatAgg sum carve-out


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phase 2
def build_kernels():
    from spark_rapids_tpu_torch import cuda_build
    sources = sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(cuda_build.build, sources))
    secs = time.perf_counter() - t0
    for src, (so, log) in zip(sources, logs):
        print(f"built {src} -> {so.name}")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"  ptxas: {line.strip()}")
    print(f"kernel build: {len(sources)} source(s) in {secs:.2f} s")


# ------------------------------------------------------------------ phase 3
def check_reorder(name, pids, data, geom, expect_flag=None, time_it=False,
                  tile_rows=None):
    """Run the CUDA reorder (at ``tile_rows`` rows per tile, else its
    default) and its plain version on the same inputs and compare exactly:
    the stats always, every live staging row unless the overflow flag is
    raised (the exchange then discards the output). Returns (max_abs_err,
    kernel_ms, plain_ms, overflow flag)."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    tile_rows = tile_rows or pk.reorder_tile_rows(geom.L)
    k_out, k_stats = pk.REORDER_KERNEL(pids, data, geom, tile_rows)
    p_out, p_stats = pk.partition_reorder_plain(pids, data, geom)
    torch.cuda.synchronize()
    if not torch.equal(k_stats, p_stats):
        bad = (k_stats != p_stats).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: stats differ at {bad}")
    flag = bool(k_stats[:, :, 1].any())
    if expect_flag is not None and flag != expect_flag:
        raise AssertionError(f"{name}: overflow flag {flag}, expected "
                             f"{expect_flag}")
    err = 0
    if not flag:
        counts = k_stats[:, :, 0].T.contiguous()            # [n, groups]
        live = (torch.arange(geom.quota, device=pids.device)[None, None, :]
                < counts[:, :, None])
        bad = (k_out != p_out).any(dim=-1) & live
        if bool(bad.any()):
            rows = bad.nonzero()
            err = int((k_out[bad].int() - p_out[bad].int()).abs().max())
            raise AssertionError(f"{name}: {rows.shape[0]} live staging rows "
                                 f"differ, first {rows[:3].tolist()}, max "
                                 f"byte error {err}")
        if int(counts.sum()) != int(((pids >= 0) & (pids < geom.n)).sum()):
            raise AssertionError(f"{name}: counts do not cover the live rows")
    del k_out, p_out
    k_ms = p_ms = None
    if time_it:
        k_ms = cuda_ms(lambda: pk.REORDER_KERNEL(pids, data, geom, tile_rows),
                       10)
        p_ms = cuda_ms(lambda: pk.partition_reorder_plain(pids, data, geom), 3)
    print(f"reorder {name}: groups={geom.groups} G={geom.G} n={geom.n} "
          f"L={geom.L} quota={geom.quota} tile_rows={tile_rows} "
          f"overflow={flag} exact=yes"
          + (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}" if time_it else ""))
    return float(err), k_ms, p_ms, flag


def reorder_bound_ms(pids, geom):
    """The reorder's byte bound: every pid is read; only live rows' data is
    read and written (no output depends on a dead or padding row's bytes);
    stats are written once."""
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    live = int((pids >= 0).sum())
    moved = (geom.cap * 4 + 2 * live * geom.L
             + geom.groups * geom.n * pk.STAT_LANES * 4)
    return moved, moved / H100_BYTES_PER_S * 1e3


def synthetic_case(rows, L, n, dead_frac, device, seed, one_partition=False,
                   empty=None):
    """Random pids (partition ``empty`` gets no row: its rows spread over
    the others) and random row bytes, in the reorder's input shape."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    g = torch.Generator(device=device).manual_seed(seed)
    geom = pk.KernelGeom.plan(rows, n, L)
    pids = torch.randint(0, n, (geom.cap,), generator=g, device=device,
                         dtype=torch.int32)
    if one_partition:
        pids.zero_()
    if empty is not None:
        spread = torch.randint(1, n, (geom.cap,), generator=g, device=device,
                               dtype=torch.int32)
        pids = torch.where(pids == empty, (pids + spread) % n, pids)
    dead = torch.rand(geom.cap, generator=g, device=device) < dead_frac
    pids[dead] = -1
    pids[rows:] = -1
    data = torch.randint(0, 256, (geom.cap, L), generator=g, device=device,
                         dtype=torch.uint8)
    return (pids.view(geom.groups, geom.G, pk.W),
            data.view(geom.groups, geom.G * pk.W, L), geom)


def reference_rows(counts, geom, device):
    """Flat staging rows (into out.view(-1, L)) of every partition's live
    rows in the reference's order, built from the counts alone: each
    group's full 8-row blocks, group by group, then each group's
    remainder rows, group by group."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    base = torch.arange(geom.groups, device=device) * geom.quota
    rows = []
    for j in range(geom.n):
        c = counts[:, j]
        full = c // pk.BLOCK * pk.BLOCK
        f = torch.from_numpy(full).to(device)
        r = torch.from_numpy(c - full).to(device)
        start = base + j * geom.groups * geom.quota
        rows += [pk._runs(start, f, int(full.sum())),
                 pk._runs(start + f, r, int((c - full).sum()))]
    return torch.cat(rows)


def check_compact(name, out, stats, geom, time_it=False):
    """Run the CUDA compaction and its plain version on the reorder's
    output and compare exactly: every live row, every zero padding row,
    and the live rows against an index_select in the reference's order.
    Returns (max_abs_err, kernel_ms, plain_ms, library_ms, bound_ms)."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    if bool(stats[:, :, 1].any()):
        raise AssertionError(f"compact {name}: the reorder overflowed")
    counts = stats[:, :, 0].cpu().numpy().astype(np.int64)
    plan = pk.CompactPlan.of(counts, geom)
    k = pk.COMPACT_KERNEL(out, plan, geom)
    p = pk.dma_compact_plain(out, plan, geom)
    flat = out.view(-1, geom.L)
    idx = reference_rows(counts, geom, out.device)
    lib = torch.index_select(flat, 0, idx)
    torch.cuda.synchronize()
    err, off = 0, 0
    for j in range(geom.n):
        t, f = int(plan.totals[j]), int(plan.fills[j])
        diff = (k[j, :f].int() - p[j, :f].int()).abs()
        err = max(err, int(diff.max()) if f else 0)
        if err:
            raise AssertionError(f"compact {name}: partition {j} differs "
                                 f"from the plain version (max byte error "
                                 f"{err}, rows {diff.any(1).nonzero()[:3]})")
        if bool(k[j, t:f].any()):
            raise AssertionError(f"compact {name}: partition {j}'s padding "
                                 f"rows are not zero")
        if not torch.equal(k[j, :t], lib[off:off + t]):
            raise AssertionError(f"compact {name}: partition {j}'s rows are "
                                 f"not in the reference's order")
        off += t
    if off != int(((stats[:, :, 0]).sum())):
        raise AssertionError(f"compact {name}: rows lost")
    del k, p, lib
    # each live row read and written once, each padding row written once,
    # the index array read once
    live = int(plan.totals.astype(np.int64).sum())
    pad = int((plan.fills.astype(np.int64) - plan.totals).sum())
    moved = (2 * live + pad) * geom.L + plan.index_array().nbytes
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    k_ms = p_ms = lib_ms = None
    if time_it:
        k_ms = cuda_ms(lambda: pk.COMPACT_KERNEL(out, plan, geom), 10)
        p_ms = cuda_ms(lambda: pk.dma_compact_plain(out, plan, geom), 3)
        lib_ms = cuda_ms(lambda: torch.index_select(flat, 0, idx), 10)
    print(f"compact {name}: groups={geom.groups} n={geom.n} L={geom.L} "
          f"rows={live} padding_rows={pad} dst_rows={plan.dst_rows} "
          f"empty_partitions={int((plan.totals == 0).sum())} exact=yes "
          f"bytes={moved} bound_ms={bound_ms:.4f}"
          + (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
             f"index_select_ms={lib_ms:.4f} "
             f"roofline_share={bound_ms / k_ms:.3f}" if time_it else ""))
    return float(err), k_ms, p_ms, lib_ms, bound_ms


# the fixed part of each kernel's record in the {"kernels": [...]} line
KERNELS = {
    "reorder": {"name": "partition_reorder", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/partition_reorder.cu",
                "replaces": "spark_rapids_tpu/shuffle/partition_kernel.py:261",
                "bound_by": "bytes"},
    "compact": {"name": "dma_compact", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/dma_compact.cu",
                "replaces": "spark_rapids_tpu/shuffle/partition_kernel.py:612",
                "bound_by": "bytes"},
}


def phase_kernels(lineitem, device, tile_sweep=()):
    """Every kernel against its plain version; returns each kernel's numbers
    at the Q1 path's shape (lineitem hash 8 on l_orderkey, the "main-path"
    case): max_abs_err, ms, plain_ms, bound_ms, library_ms. ``tile_sweep``
    names more tile sizes to check and time the reorder at there."""
    import torch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.exprs.core import ColV
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        hash_partition_ids, split_by_pid)
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk

    batch = upload(lineitem, device)
    key = batch.column_by_name("l_orderkey")
    pids = hash_partition_ids([ColV(key.dtype, key.data, key.validity)],
                              batch.capacity, 8)
    # the sort path's reorder of the same batch, for context
    sort_ms = cuda_ms(lambda: split_by_pid(colvs_of(batch), pids,
                                           batch.num_rows, 8), 3)
    print(f"sort path (split_by_pid) main-path: ms={sort_ms:.4f}")
    spec = pk.PackSpec.for_batch(batch)
    geom = pk.KernelGeom.plan(batch.capacity, 8, spec.lanes)
    p3, d3 = pk.kernel_inputs(batch, pids, spec, geom)
    del batch, pids
    err, k_ms, p_ms, _ = check_reorder("main-path", p3, d3, geom,
                                       expect_flag=False, time_it=True)
    moved, bound_ms = reorder_bound_ms(p3, geom)
    print(f"reorder main-path: bytes={moved} bound_ms={bound_ms:.4f} "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"roofline_share={bound_ms / k_ms:.3f} sort_path_ms={sort_ms:.4f}")
    for rows in tile_sweep:
        _, ms, _, _ = check_reorder(f"main-path tile_rows={rows}", p3, d3,
                                    geom, expect_flag=False, time_it=True,
                                    tile_rows=rows)
        print(f"reorder main-path tile_rows={rows}: kernel_ms={ms:.4f} "
              f"roofline_share={bound_ms / ms:.3f}")
    reorder = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "library_ms": None}
    out, stats = pk.REORDER_KERNEL(p3, d3, geom)
    del p3, d3
    c_err, c_ms, c_plain, c_lib, c_bound = check_compact(
        "main-path", out, stats, geom, time_it=True)
    compact = {"max_abs_err": c_err, "ms": c_ms, "plain_ms": c_plain,
               "bound_ms": c_bound, "library_ms": c_lib}
    del out, stats
    torch.cuda.empty_cache()

    rows = 1 << 22
    cases = [("n=2", (rows, 76, 2, 0.0), {}),
             ("n=32", (rows, 76, 32, 0.0), {}),
             ("ragged+dead L=21", (3 * 32768 + 1000 + 77, 21, 5, 0.1), {}),
             ("empty partition", (rows, 76, 8, 0.05), {"empty": 3}),
             ("tiny", (300, 13, 3, 0.2), {}),
             # the redesign's edges: tiles of fewer rows, the wide form
             # (one chunk and several per tile), half the rows dead in every
             # window, num_rows ending inside a tile, many partitions of a
             # narrow odd width
             ("wide L=300", (1 << 20, 300, 8, 0.02), {}),
             ("wide L=1100", (300000, 1100, 6, 0.02), {}),
             ("wide L=2600", (70000, 2600, 4, 0.1), {}),
             ("50% dead", (rows, 76, 8, 0.5), {}),
             ("rows end mid-tile", (3 * 32768 + 128 + 37, 76, 8, 0.0), {}),
             ("n=32 L=13", (rows, 13, 32, 0.0), {})]
    for name, args, kw in cases:
        case = synthetic_case(*args, device, seed=7, **kw)
        check_reorder(name, *case, expect_flag=False)
        out, stats = pk.REORDER_KERNEL(*case)
        check_compact(name, out, stats, case[2])
        del case, out, stats
    check_reorder("one-partition", *synthetic_case(rows, 76, 8, 0.0, device,
                                                   seed=9, one_partition=True),
                  expect_flag=True)
    torch.cuda.empty_cache()
    return reorder, compact


# ------------------------------------------------------------------ phases 4, 5
def logical_bytes(batch) -> int:
    """Column data + validity + lengths of a device batch (what bench.py's
    full-exchange rate divides)."""
    return sum(t.numel() * t.element_size() for c in batch.columns
               for t in (c.data, c.validity, c.lengths) if t is not None)


def reset_launches():
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    pk.REORDER_KERNEL.launches = 0
    pk.COMPACT_KERNEL.launches = 0


def read_launches():
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    return pk.REORDER_KERNEL.launches, pk.COMPACT_KERNEL.launches


def run_exchange(batch, part, conf, device):
    """One TpuShuffleExchangeExec over a resident one-batch leaf: every
    reduce partition read back through the shuffle catalog, then the
    action's cleanups. Returns (exec, partitions, seconds, tiers), where
    tiers counts the map outputs on (device, host, disk) before the read."""
    import torch
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.execs.base import ExecContext, LeafExec
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager

    class Resident(LeafExec):
        # holds the batch on the instance, not in a closure: a class is
        # freed only by the cycle collector, the instance with the exchange
        def __init__(self, b):
            super().__init__(b.schema)
            self.batch = b

        def execute(self, ctx):
            yield self.batch

    tconf = TpuConf(conf)
    dm = DeviceManager.initialize(tconf, device)
    ex = TpuShuffleExchangeExec(part, Resident(batch))
    cleanups = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = ExecContext(tconf, device, 0, ex.num_partitions, dm, cleanups)
        ex.map_output_stats(ctx)              # runs the map side
        tiers = (len(dm.device_store), len(dm.host_store),
                 len(dm.disk_store))
        parts = [list(ex.execute(ctx.for_partition(p, ex.num_partitions)))
                 for p in range(ex.num_partitions)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for fn in cleanups:
            fn()
    if not dm.is_idle:
        raise AssertionError("the exchange left buffers in the catalog")
    return ex, parts, secs, tiers


def assert_same_partitions(name, a, b):
    import torch
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} vs {len(b)} partitions")
    for p, (xs, ys) in enumerate(zip(a, b)):
        if [x.num_rows for x in xs] != [y.num_rows for y in ys]:
            raise AssertionError(f"{name}: partition {p} row counts differ")
        for x, y in zip(xs, ys):
            for cx, cy in zip(x.columns, y.columns):
                same = (torch.equal(cx.data, cy.data)
                        and torch.equal(cx.validity, cy.validity)
                        and (cx.lengths is None
                             or torch.equal(cx.lengths, cy.lengths)))
                if not same:
                    raise AssertionError(f"{name}: partition {p} differs")


def phase_exchange(lineitem, device, profile_dir=None):
    """The full exchange at the run's scale, dmaConsolidate off and on.
    Returns the compact kernel's launches in the dma-on exchange."""
    import torch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, RoundRobinPartitioning)
    from spark_rapids_tpu_torch.exprs.core import (UnresolvedAttribute,
                                                   bind_expression)

    batch = upload(lineitem, device)
    key = bind_expression(UnresolvedAttribute("l_orderkey"), batch.schema)
    dma_key = "spark.rapids.tpu.shuffle.kernel.dmaConsolidate.enabled"
    results, compact_launches = {}, None
    for dma in (False, True):
        conf = {dma_key: str(dma).lower()}
        reset_launches()
        ex, parts, cold_s, _ = run_exchange(
            batch, HashPartitioning(8, (key,)), conf, device)
        reorder_n, compact_n = read_launches()
        if (reorder_n, compact_n) != (1, int(dma)):
            raise AssertionError(f"exchange dma={dma}: launches reorder="
                                 f"{reorder_n} compact={compact_n}, want 1 "
                                 f"and {int(dma)} for one map batch")
        if (ex.kernel_splits, ex.sort_path_splits) != (1, 0):
            raise AssertionError(f"exchange dma={dma}: splits "
                                 f"{ex.kernel_splits}/{ex.sort_path_splits}")
        stats = ex.stage_stats()
        if stats.total_rows != lineitem.num_rows:
            raise AssertionError(f"exchange dma={dma}: stage stats count "
                                 f"{stats.total_rows} rows")
        if dma:
            compact_launches = compact_n
        warm = [run_exchange(batch, HashPartitioning(8, (key,)), conf,
                             device)[2] for _ in range(3)]
        gbps = logical_bytes(batch) / min(warm) / 1e9
        results[dma] = parts
        if profile_dir:
            profile_device(
                f"exchange hash(8) dma={dma}",
                lambda: run_exchange(batch, HashPartitioning(8, (key,)),
                                     conf, device),
                f"{profile_dir}/exchange_dma_{str(dma).lower()}.tsv",
                min(warm))
        print(f"exchange hash(8, l_orderkey) dma={dma}: rows="
              f"{stats.total_rows} launches reorder={reorder_n} "
              f"compact={compact_n} sort_path_splits=0 cold_s={cold_s:.4f} "
              f"warm_s={' '.join(f'{w:.4f}' for w in warm)} "
              f"gb_per_s={gbps:.3f} ({logical_bytes(batch)} logical bytes, "
              f"best warm run) stats: {stats.describe()}")
        del parts
    assert_same_partitions("exchange dma off vs on", results[False],
                           results[True])
    del results
    rr = {}
    for dma in (False, True):
        reset_launches()
        ex, rr[dma], secs, _ = run_exchange(
            batch, RoundRobinPartitioning(8), {dma_key: str(dma).lower()},
            device)
        reorder_n, compact_n = read_launches()
        rows = ex.stage_stats().partition_rows
        if (ex.kernel_splits, ex.sort_path_splits) != (1, 0) or \
                (reorder_n, compact_n) != (1, int(dma)) or \
                sum(rows) != lineitem.num_rows:
            raise AssertionError(f"round robin dma={dma}: splits "
                                 f"{ex.kernel_splits}/{ex.sort_path_splits} "
                                 f"launches {reorder_n}/{compact_n} rows "
                                 f"{rows}")
        print(f"exchange roundrobin(8) dma={dma}: rows per partition {rows} "
              f"launches reorder={reorder_n} compact={compact_n} "
              f"cold_s={secs:.4f}")
    assert_same_partitions("round robin dma off vs on", rr[False], rr[True])
    del rr, batch
    torch.cuda.empty_cache()
    return compact_launches


def phase_spill(seed, device, sf=1.0, budget=256 << 20):
    """lineitem at ``sf`` through the exchange with device and host budgets
    of ``budget`` bytes each: the map outputs must land on all three tiers
    and read back equal to the unspilled run."""
    import torch
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.execs.exchange_execs import HashPartitioning
    from spark_rapids_tpu_torch.exprs.core import (UnresolvedAttribute,
                                                   bind_expression)

    batch = upload(gen_lineitem(sf, seed=seed), device)
    key = bind_expression(UnresolvedAttribute("l_orderkey"), batch.schema)
    dma = {"spark.rapids.tpu.shuffle.kernel.dmaConsolidate.enabled": "true"}
    _, want, _, tiers0 = run_exchange(batch, HashPartitioning(8, (key,)),
                                      dma, device)
    conf = {**dma, "spark.rapids.tpu.memory.tpu.poolSizeBytes": budget,
            "spark.rapids.tpu.memory.host.spillStorageSize": budget}
    _, got, secs, tiers = run_exchange(batch, HashPartitioning(8, (key,)),
                                       conf, device)
    if tiers0 != (8, 0, 0) or min(tiers) < 1 or sum(tiers) != 8:
        raise AssertionError(f"spill: tiers {tiers0} unspilled, {tiers} "
                             f"spilled; want every tier used")
    assert_same_partitions("spill", got, want)
    print(f"spill sf={sf} hash(8): device/host/disk pieces {tiers} (unspilled "
          f"{tiers0}), budgets {budget} bytes each, read back equal, "
          f"s={secs:.4f}")
    del batch, want, got
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 6
def q1_numpy(li):
    """Plain numpy TPC-H Q1 over the host arrays -> {(flag, status): row}."""
    cols = {f.name: c for f, c in zip(li.schema, li.columns)}
    cut = (datetime.date(1998, 9, 2) - datetime.date(1970, 1, 1)).days
    keep = cols["l_shipdate"].data <= cut
    flag = cols["l_returnflag"].data[keep, 0].astype(np.int64)
    status = cols["l_linestatus"].data[keep, 0].astype(np.int64)
    keys, inv = np.unique(flag * 256 + status, return_inverse=True)
    qty = cols["l_quantity"].data[keep]
    price = cols["l_extendedprice"].data[keep]
    disc = cols["l_discount"].data[keep]
    tax = cols["l_tax"].data[keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = np.bincount(inv, minlength=len(keys))

    def s(w):
        return np.bincount(inv, weights=w, minlength=len(keys))

    out = {}
    for i, k in enumerate(keys):
        out[(chr(k // 256), chr(k % 256))] = {
            "sum_qty": s(qty)[i], "sum_base_price": s(price)[i],
            "sum_disc_price": s(disc_price)[i], "sum_charge": s(charge)[i],
            "avg_qty": s(qty)[i] / cnt[i], "avg_price": s(price)[i] / cnt[i],
            "avg_disc": s(disc)[i] / cnt[i], "count_order": int(cnt[i])}
    return out


def check_q1(name, res, ref):
    cols = {f.name: c for f, c in zip(res.schema, res.columns)}
    got_keys = []
    for i in range(res.num_rows):
        kf = cols["l_returnflag"]
        ks = cols["l_linestatus"]
        got_keys.append((bytes(kf.data[i, :kf.lengths[i]]).decode(),
                         bytes(ks.data[i, :ks.lengths[i]]).decode()))
    if got_keys != sorted(ref):
        raise AssertionError(f"{name}: groups {got_keys} != {sorted(ref)}")
    worst = 0.0
    for i, k in enumerate(got_keys):
        for col, want in ref[k].items():
            got = cols[col].data[i]
            if not cols[col].validity[i]:
                raise AssertionError(f"{name}: {k} {col} is null")
            if col == "count_order":
                if int(got) != want:
                    raise AssertionError(f"{name}: {k} count {got} != {want}")
                continue
            rel = abs(float(got) - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            if not np.isfinite(got) or rel > REL_TOL:
                raise AssertionError(f"{name}: {k} {col} {got!r} vs {want!r} "
                                     f"(rel {rel:.3e})")
    print(f"{name}: {len(got_keys)} groups match the numpy reference "
          f"(worst relative error {worst:.3e})")


def profile_device(label, fn, path, warm_s):
    """Run ``fn`` once more under torch.profiler: device time by kernel
    (and copy), written to ``path``. Two idle shares are printed: of this
    run's own wall (which the profiler's overhead inflates), and an
    estimate across two runs, of the unprofiled warm wall ``warm_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU-side operator rows
    # would count the same device time a second time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    with open(path, "w") as f:
        f.write("device_ms\tcount\tname\n")
        for e in events:
            f.write(f"{e.self_device_time_total / 1e3:.4f}\t{e.count}\t"
                    f"{e.key}\n")
    print(f"profile {label}: device_busy_ms={busy_ms:.2f} "
          f"profiled_wall_ms={wall_ms:.2f} "
          f"idle_share_profiled_run={1 - busy_ms / wall_ms:.3f} "
          f"warm_wall_ms={warm_s * 1e3:.2f} "
          f"idle_share_est_of_warm={1 - busy_ms / (warm_s * 1e3):.3f} "
          f"table={path}")
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")


def phase_main_path(lineitem, reference, profile_dir=None):
    """Q1 over the hash repartition (cold, warm), then with dmaConsolidate
    on, then without the repartition. Returns the reorder kernel's
    launches in the first run."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)

    def hash_exchange(sess):
        hashed = [e for e in sess.last_plan.walk()
                  if isinstance(e, TpuShuffleExchangeExec)
                  and isinstance(e.partitioning, HashPartitioning)]
        if len(hashed) != 1 or hashed[0].sort_path_splits != 0 \
                or hashed[0].kernel_splits < 1:
            raise AssertionError(
                f"the hash exchange must split through the kernel: "
                f"{[(e.kernel_splits, e.sort_path_splits) for e in hashed]}")

    sess = TpuSession(BENCH_CONF)                  # cuda: the default
    if sess.device.type != "cuda":
        raise AssertionError(f"session runs on {sess.device}")
    times, launches = [], None
    gc.collect()              # nothing of the earlier phases stays allocated
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for attempt in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        res = q1(sess.create_dataframe(lineitem)
                 .repartition(8, "l_orderkey")).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if launches is None:
            launches = read_launches()[0]
        hash_exchange(sess)
        check_q1(f"q1 repartition(8) {attempt}", res, reference)
    if launches < 1:
        raise AssertionError("the reorder kernel was not launched by Q1")
    print(f"q1 repartition(8, l_orderkey): rows={lineitem.num_rows} "
          f"cold_s={times[0]:.4f} warm_s={times[1]:.4f} "
          f"warm_rows_per_s={lineitem.num_rows / times[1]:.4g} "
          f"reorder_launches={launches} sort_path_splits=0 peak_device_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if profile_dir:
        profile_device(
            "q1 repartition(8)",
            lambda: q1(sess.create_dataframe(lineitem)
                       .repartition(8, "l_orderkey")).collect(),
            f"{profile_dir}/q1_profile.tsv", times[1])
    dma = TpuSession({**BENCH_CONF, "spark.rapids.tpu.shuffle.kernel."
                                    "dmaConsolidate.enabled": "true"})
    reset_launches()
    t0 = time.perf_counter()
    res = q1(dma.create_dataframe(lineitem)
             .repartition(8, "l_orderkey")).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    reorder_n, compact_n = read_launches()
    hash_exchange(dma)
    if reorder_n < 1 or compact_n < 1:
        raise AssertionError(f"q1 dmaConsolidate: launches reorder="
                             f"{reorder_n} compact={compact_n}")
    check_q1("q1 repartition(8) dmaConsolidate", res, reference)
    print(f"q1 repartition(8, l_orderkey) dmaConsolidate: s={secs:.4f} "
          f"reorder_launches={reorder_n} compact_launches={compact_n}")
    t0 = time.perf_counter()
    res = q1(sess.create_dataframe(lineitem)).collect()
    torch.cuda.synchronize()
    print(f"q1 (no repartition): s={time.perf_counter() - t0:.4f}")
    check_q1("q1 plain", res, reference)
    return launches


# ------------------------------------------------------------------ phase 7
def q3_tables(sf, seed):
    """customer, orders and lineitem with the columns Q3 and Q6 read."""
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import (Q3_COLUMNS,
                                                                Q6_COLUMNS)
    li_cols = [c for c in td.LINEITEM_COLUMNS
               if c in Q3_COLUMNS["lineitem"] + Q6_COLUMNS["lineitem"]]
    return {"customer": td.gen_customer(sf, seed, Q3_COLUMNS["customer"]),
            "orders": td.gen_orders(sf, seed, Q3_COLUMNS["orders"]),
            "lineitem": td.gen_lineitem_full(sf, seed, li_cols)}


def _col(hb, name):
    return hb.column_by_name(name).data


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def q3_numpy(t):
    """Plain numpy TPC-H Q3 -> (l_orderkey, revenue, o_orderdate,
    o_shippriority) arrays of the top 10: isin / searchsorted joins,
    np.unique grouping, a lexsort for the order."""
    cut = _days(1995, 3, 15)
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    seg = c.column_by_name("c_mktsegment")
    word = np.frombuffer(b"BUILDING", np.uint8)
    building = (seg.lengths == 8) & (seg.data[:, :8] == word).all(axis=1)
    okeep = (_col(o, "o_orderdate") < cut) & np.isin(
        _col(o, "o_custkey"), _col(c, "c_custkey")[building])
    okeys = _col(o, "o_orderkey")[okeep]             # ascending, unique
    lkeep = _col(li, "l_shipdate") > cut
    lkey = _col(li, "l_orderkey")[lkeep]
    pos = np.clip(np.searchsorted(okeys, lkey), 0, max(len(okeys) - 1, 0))
    hit = (okeys[pos] == lkey) if len(okeys) else np.zeros(len(lkey), bool)
    rev = (_col(li, "l_extendedprice")[lkeep][hit]
           * (1 - _col(li, "l_discount")[lkeep][hit]))
    keys, inv = np.unique(lkey[hit], return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(keys))
    opos = np.searchsorted(okeys, keys)
    date = _col(o, "o_orderdate")[okeep][opos]
    prio = _col(o, "o_shippriority")[okeep][opos]
    top = np.lexsort((date, -sums))[:10]
    return keys[top], sums[top], date[top], prio[top], len(keys)


def check_q3(name, res, ref):
    keys, sums, date, prio, _ = ref
    got = {f.name: c for f, c in zip(res.schema, res.columns)}
    if res.num_rows != len(keys):
        raise AssertionError(f"{name}: {res.num_rows} rows, want {len(keys)}")
    for col, want in (("l_orderkey", keys), ("o_orderdate", date),
                      ("o_shippriority", prio)):
        if not (got[col].validity.all()
                and np.array_equal(got[col].data, want)):
            raise AssertionError(f"{name}: {col} {got[col].data} != {want}")
    rev = got["revenue"].data
    rel = np.abs(rev - sums) / np.maximum(np.abs(sums), 1e-300)
    if not (got["revenue"].validity.all() and np.isfinite(rev).all()
            and rel.max(initial=0) <= REL_TOL):
        raise AssertionError(f"{name}: revenue {rev} vs {sums}")
    print(f"{name}: top {len(keys)} match the numpy Q3 (keys and dates "
          f"exact, worst relative revenue error {rel.max(initial=0):.3e})")


def join_strategies(plan):
    """Join exec names of a plan, depth first (the outer join first)."""
    out = [type(plan).__name__] if "HashJoin" in type(plan).__name__ else []
    for c in plan.children:
        out += join_strategies(c)
    return out


def q3_kernel_inputs(hb, key, device):
    """The reorder's inputs as Q3's hash exchange over ``hb`` builds them:
    the table uploaded as one batch, packed whole, pids hash 8 on ``key``."""
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.execs.exchange_execs import hash_partition_ids
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    batch = upload(hb, device)
    col = colvs_of(batch)[batch.schema.index_of(key)]
    pids = hash_partition_ids([col], batch.capacity, 8)
    spec = pk.PackSpec.for_batch(batch)
    geom = pk.KernelGeom.plan(batch.capacity, 8, spec.lanes)
    return (*pk.kernel_inputs(batch, pids, spec, geom), geom)


def phase_q3_kernels(tables, device):
    """Both kernels against their plain versions on the inputs Q3's two
    hash exchanges give them (orders on o_orderkey, lineitem on
    l_orderkey), timed and bounded there. Returns (each exchange's overflow
    flag, the reorder's Q3 numbers, the compact kernel's Q3 numbers). A Q3
    run launches the reorder once per exchange, so its ms, plain_ms and
    bound_ms are sums over the two inputs and max_abs_err their maximum;
    the compact kernel runs only where the reorder's output is kept (no
    overflow), and its numbers sum over those inputs. ``inputs`` lists each
    input's own reading."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk

    def empty():
        return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": None, "inputs": []}

    def add(rec, reading):
        rec["inputs"].append(reading)
        rec["max_abs_err"] = max(rec["max_abs_err"], reading["max_abs_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            rec[k] += reading[k]
        if reading["library_ms"] is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) \
                + reading["library_ms"]

    reorder, compact, flags = empty(), empty(), []
    for table, key in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        name = f"q3 {table} hash(8, {key})"
        p3, d3, geom = q3_kernel_inputs(tables[table], key, device)
        err, k_ms, p_ms, flag = check_reorder(name, p3, d3, geom,
                                              time_it=True)
        moved, bound = reorder_bound_ms(p3, geom)
        print(f"reorder {name}: bytes={moved} bound_ms={bound:.4f} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"roofline_share={bound / k_ms:.3f} overflow={flag}"
              + (" (stats compared; the exchange discards the staging rows "
                 "and takes the sort path)" if flag else ""))
        flags.append(flag)
        add(reorder, {"input": name, "rows": tables[table].num_rows,
                      "L": geom.L, "overflow": flag, "max_abs_err": err,
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                      "library_ms": None})
        if not flag:
            out, stats = pk.REORDER_KERNEL(p3, d3, geom)
            del p3, d3
            c_err, c_ms, c_plain, c_lib, c_bound = check_compact(
                name, out, stats, geom, time_it=True)
            add(compact, {"input": name, "rows": tables[table].num_rows,
                          "L": geom.L, "max_abs_err": c_err, "ms": c_ms,
                          "plain_ms": c_plain, "bound_ms": c_bound,
                          "library_ms": c_lib})
            del out, stats
        else:
            del p3, d3
        torch.cuda.empty_cache()
    return flags, reorder, compact


def phase_q3(tables, overflow, profile_dir=None):
    """Q3 over orders and lineitem hash-repartitioned 8 ways on their order
    keys: the default conf (shuffled joins), the broadcast threshold just
    above the customer side (a broadcast join over orders' 8 partitions),
    and the default with dmaConsolidate. Each run cold then warm, checked
    against the numpy Q3. ``overflow`` is each exchange's reorder overflow
    flag (orders, lineitem). Returns each run's cold-pass (reorder launches,
    compact launches, reorder launches whose output was kept)."""
    import torch
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q3
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.tpu_execs import TpuHashAggregateExec

    t0 = time.perf_counter()
    ref = q3_numpy(tables)
    print(f"q3 numpy reference: {ref[4]} groups in "
          f"{time.perf_counter() - t0:.2f} s")
    # each hash exchange has one map batch: it launches the reorder kernel
    # once, and takes the sort path after it only when the flag is raised
    want_splits = [(0, 1) if f else (1, 0) for f in overflow]
    threshold = tables["customer"].nbytes
    if tables["orders"].nbytes <= threshold:
        raise AssertionError("orders must not fit under the broadcast "
                             "threshold that customer fits under")
    bkey = "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes"
    dkey = "spark.rapids.tpu.shuffle.kernel.dmaConsolidate.enabled"
    # the default threshold (10 MiB) broadcasts customer below about SF 3:
    # there the shuffled runs turn broadcasts off
    shuffled = ({} if threshold > TpuConf({}).get(cfg.BROADCAST_JOIN_THRESHOLD)
                else {bkey: "-1"})
    runs = [("shuffled", shuffled, ["TpuShuffledHashJoinExec"] * 2),
            ("broadcast", {bkey: str(threshold)},
             ["TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec"]),
            ("shuffled+dma", {**shuffled, dkey: "true"},
             ["TpuShuffledHashJoinExec"] * 2)]
    launches = {}
    for label, extra, want_joins in runs:
        sess = TpuSession({**BENCH_CONF, **extra})
        times = []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for attempt in ("cold", "warm"):
            reset_launches()
            t0 = time.perf_counter()
            dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
            dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
            dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
            res = q3(dfs).collect()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_launch = read_launches()
            if attempt == "cold":
                launches[label] = (*n_launch,
                                   sum(k for k, _ in want_splits))
            check_q3(f"q3 {label} {attempt}", res, ref)
            plan = sess.last_plan
            joins = join_strategies(plan)
            hashed = [e for e in plan.walk()
                      if isinstance(e, TpuShuffleExchangeExec)
                      and isinstance(e.partitioning, HashPartitioning)]
            splits = [(e.kernel_splits, e.sort_path_splits) for e in hashed]
            modes = [e.modes_run for e in plan.walk()
                     if isinstance(e, TpuHashAggregateExec)]
            want_launch = (2, sum(k for k, _ in want_splits)
                           if dkey in extra else 0)
            if joins != want_joins or splits != want_splits or \
                    n_launch != want_launch:
                raise AssertionError(
                    f"q3 {label}: joins {joins} (want {want_joins}), splits "
                    f"{splits} (want {want_splits}), launches reorder/compact "
                    f"{n_launch} (want {want_launch}: one reorder per "
                    f"hash-exchange map batch)")
        print(f"q3 {label}: joins={joins} splits kernel/sort={splits} "
              f"cold_s={times[0]:.4f} "
              f"warm_s={times[1]:.4f} reorder_launches={n_launch[0]} "
              f"compact_launches={n_launch[1]} aggregate_modes={modes} "
              f"peak_device_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}"
              + (f" broadcast_threshold={extra[bkey]}" if bkey in extra
                 else ""))
        if profile_dir and label == "shuffled":
            def run(sess=sess):
                dfs = {k: sess.create_dataframe(v) for k, v in tables.items()}
                dfs["orders"] = dfs["orders"].repartition(8, "o_orderkey")
                dfs["lineitem"] = dfs["lineitem"].repartition(8, "l_orderkey")
                q3(dfs).collect()
            profile_device("q3 shuffled", run,
                           f"{profile_dir}/q3_profile.tsv", times[1])
    return launches


# ------------------------------------------------------------------ phase 8
def q6_numpy(li):
    d = _col(li, "l_shipdate")
    disc = _col(li, "l_discount")
    keep = ((d >= _days(1994, 1, 1)) & (d < _days(1995, 1, 1))
            & (disc >= 0.05) & (disc <= 0.07) & (_col(li, "l_quantity") < 24))
    return float((_col(li, "l_extendedprice")[keep] * disc[keep]).sum())


def lex_gt_bounds_matrix(row_passes, bound_passes):
    """The JAX package's ``_lex_gt_bounds`` structure in plain torch: every
    row against every bound at once through (rows, n - 1) matrices."""
    import torch
    cap, nb = row_passes[0].shape[0], bound_passes[0].shape[0]
    gt = torch.zeros((cap, nb), dtype=torch.bool, device=row_passes[0].device)
    eq = torch.ones_like(gt)
    for r, b in zip(row_passes, bound_passes):
        gt |= eq & (r[:, None] > b[None, :])
        eq &= r[:, None] == b[None, :]
    return gt.sum(dim=1).to(torch.int32)


def measure_range_ids(li, bounds, orders, device):
    """The port's one-bound-at-a-time range ids against the JAX package's
    matrix form on the whole lineitem (one batch of capacity 67,108,864 at
    SF 10), both over the same key passes: equal pids, device time and the
    peak memory each adds."""
    import torch
    from spark_rapids_tpu_torch.columnar.transfer import upload
    from spark_rapids_tpu_torch.execs import exchange_execs as tx
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    batch = upload(li, device)
    cols = colvs_of(batch)
    rows = [cols[batch.schema.index_of(n)] for n in ("l_shipdate",
                                                     "l_orderkey")]
    rp = [p for v in rows for p in bk._key_passes(v, True, True)]
    bp = [p for v in bounds for p in bk._key_passes(v, True, True)]
    out = {}
    for name, fn in (("per_bound", lambda: tx._lex_gt_bounds(rp, bp)),
                     ("matrix", lambda: lex_gt_bounds_matrix(rp, bp))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pids = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = (pids, cuda_ms(fn, 3), peak)
    if not (torch.equal(out["per_bound"][0], out["matrix"][0])
            and torch.equal(out["per_bound"][0],
                            tx.range_partition_ids(orders, rows, bounds))):
        raise AssertionError("range ids: per-bound and matrix forms differ")
    print(f"range ids cap={batch.capacity} n={len(bounds[0].validity) + 1}: "
          + " ".join(f"{k}_ms={v[1]:.3f} {k}_peak_gb={v[2] / 1e9:.3f}"
                     for k, v in out.items()) + " equal=yes")
    del batch, cols, rows, rp, bp, out
    torch.cuda.empty_cache()


def phase_q6_and_sort(li, device, range_forms=False):
    """Q6 against a numpy Q6, then lineitem hash-repartitioned 8 ways and
    sorted globally on (l_shipdate, l_orderkey) through the range exchange:
    the bounds, the per-partition counts and the collected rows checked
    against numpy; with ``range_forms``, the range ids' two forms
    measured."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import q6
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        RangePartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.tpu_execs import TpuHashAggregateExec

    sess = TpuSession(BENCH_CONF)
    want = q6_numpy(li)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = q6(sess.create_dataframe(li)).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = float(res.columns[0].data[0])
    rel = abs(got - want) / abs(want)
    if res.num_rows != 1 or not res.columns[0].validity[0] or rel > REL_TOL:
        raise AssertionError(f"q6: {got!r} vs numpy {want!r}")
    modes = [e.modes_run for e in sess.last_plan.walk()
             if isinstance(e, TpuHashAggregateExec)]
    print(f"q6: revenue {got!r} matches numpy (rel {rel:.3e}) cold_s="
          f"{times[0]:.4f} warm_s={times[1]:.4f} aggregate_modes={modes}")

    t0 = time.perf_counter()
    res = sess.create_dataframe(li).repartition(8, "l_orderkey") \
        .sort("l_shipdate", "l_orderkey").collect()
    sort_s = time.perf_counter() - t0
    # np.lexsort((l_orderkey, l_shipdate))'s order: a stable sort of the
    # combined key, done on the card by torch.sort (numpy's takes ~30 s)
    key = (_col(li, "l_shipdate").astype(np.int64) << 40) \
        | _col(li, "l_orderkey")
    order = torch.sort(torch.from_numpy(key).to(device),
                       stable=True).indices.cpu().numpy()
    ex = [e for e in sess.last_plan.walk()
          if isinstance(e, TpuShuffleExchangeExec)
          and isinstance(e.partitioning, RangePartitioning)]
    if len(ex) != 1 or ex[0].kernel_splits or ex[0].sort_path_splits != 8:
        raise AssertionError(f"sort: range exchanges {ex}")
    bounds = ex[0].range_bounds
    bkey = ((bounds[0].data.cpu().numpy().astype(np.int64) << 40)
            | bounds[1].data.cpu().numpy())
    skey = key[order]
    at = np.searchsorted(skey, bkey).clip(0, len(skey) - 1)
    if not (bool(np.all(np.diff(bkey) >= 0)) and len(bkey) == 7
            and bool((skey[at] == bkey).all())
            and all(bool(b.validity.all()) for b in bounds)):
        raise AssertionError(f"sort: bounds {bkey} are not 7 sorted row keys")
    counts = np.diff(np.concatenate(
        [[0], np.searchsorted(skey, bkey, side="right"), [len(skey)]]))
    rows = ex[0].stage_stats().partition_rows
    if list(rows) != counts.tolist():
        raise AssertionError(f"sort: partition rows {rows} != {counts}")
    for name in ("l_shipdate", "l_orderkey", "l_extendedprice"):
        if not np.array_equal(_col(res, name), _col(li, name)[order]):
            raise AssertionError(f"sort: {name} is not in np.lexsort order")
    pairs = [(int(k >> 40), int(k & (2**40 - 1))) for k in bkey]
    print(f"sort repartition(8) by (l_shipdate, l_orderkey): {res.num_rows} "
          f"rows equal np.lexsort s={sort_s:.4f} checks_s="
          f"{time.perf_counter() - t0 - sort_s:.2f} "
          f"partition_rows={list(rows)} bounds(shipdate, orderkey)={pairs}")
    del res, order, skey, key
    if range_forms:
        t0 = time.perf_counter()
        measure_range_ids(li, bounds, ex[0].partitioning.orders, device)
        print(f"range ids measured in {time.perf_counter() - t0:.2f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (1.0 = 6M lineitem rows)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tile-sweep", type=int, nargs="*", default=(),
                    metavar="ROWS", help="also check and time the reorder "
                    "at these rows per tile on the main path")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (a short first run of a new "
                         "kernel); prints no result line")
    ap.add_argument("--range-forms", action="store_true",
                    help="also time the range ids on the whole lineitem in "
                         "the port's one-bound-at-a-time form against the "
                         "JAX package's (rows, n - 1) matrix form (equal ids, "
                         "device time, peak memory)")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one exchange run with dmaConsolidate "
                         "off and on, one Q1 run and one Q3 run, and write "
                         "their per-kernel device times as tables to DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"gpu: {gpu_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem

    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.2f} s")
        clock[0] = now

    build_kernels()
    phase_done("2 build")
    device = torch.device("cuda", 0)
    lineitem = gen_lineitem(args.sf, seed=args.seed)
    reference = q1_numpy(lineitem)
    print(f"lineitem sf={args.sf}: {lineitem.num_rows} rows generated and "
          f"reference Q1 computed in {time.perf_counter() - clock[0]:.2f} s")
    lineitem_nums = phase_kernels(lineitem, device, args.tile_sweep)
    phase_done("3 kernels")
    if args.kernels_only:
        print(json.dumps({"kernels": [
            {**KERNELS[k], "launches": None, **n}
            for k, n in zip(("reorder", "compact"), lineitem_nums)]}))
        return 0
    by_path = {"exchange_dma": {"compact": phase_exchange(lineitem, device,
                                                          args.profile)}}
    phase_done("4 exchange")
    phase_spill(args.seed, device)
    phase_done("5 spill")
    by_path["q1"] = {"reorder": phase_main_path(lineitem, reference,
                                                args.profile)}
    del lineitem, reference
    phase_done("6 q1")
    tables = q3_tables(args.sf, args.seed)
    print(f"q3 tables sf={args.sf}: customer {tables['customer'].num_rows}, "
          f"orders {tables['orders'].num_rows}, lineitem "
          f"{tables['lineitem'].num_rows} rows generated in "
          f"{time.perf_counter() - clock[0]:.2f} s")
    overflow, *q3_nums = phase_q3_kernels(tables, device)
    phase_done("7 q3 kernel checks")
    q3_launches = phase_q3(tables, overflow, args.profile)
    for label, (r, c, _) in q3_launches.items():
        by_path[f"q3 {label}"] = {"reorder": r, "compact": c}
    phase_done("7 q3 runs")
    phase_q6_and_sort(tables["lineitem"], device, args.range_forms)
    del tables
    phase_done("8 q6 and range sort")
    # this slice's main path is Q3: the reorder's launches in its shuffled
    # run and the compact kernel's in its dmaConsolidate run, beside the
    # times, bounds and errors of those launches' inputs (phase 7's checks);
    # launches_kept counts the launches whose output the exchange used.
    # Phase 3's reading at Q1's lineitem shape and every path's launches
    # stand beside them.
    shuffled, dma = q3_launches["shuffled"], q3_launches["shuffled+dma"]
    records = []
    for name, q3n, li_n, launches, kept in (
            ("reorder", q3_nums[0], lineitem_nums[0], shuffled[0],
             shuffled[2]),
            ("compact", q3_nums[1], lineitem_nums[1], dma[1], dma[1])):
        if launches < 1 or kept < 1:
            raise AssertionError(f"{name}: Q3 launched it {launches} times, "
                                 f"{kept} of them kept")
        records.append({**KERNELS[name], "launches": launches,
                        "launches_kept": kept, **q3n,
                        "phase3_q1_lineitem": li_n,
                        "launches_by_path": {p: v[name]
                                             for p, v in by_path.items()
                                             if name in v}})
    print(json.dumps({"kernels": records}))
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
