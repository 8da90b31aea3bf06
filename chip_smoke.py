#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

Phases:
  1. require a CUDA device; print the card's name and power limit;
  2. build every hand-written kernel from csrc/ with nvcc;
  3. hold each kernel against its plain PyTorch version on the card: the
     partition-reorder kernel at the main path's shape (lineitem, 8 hash
     partitions on l_orderkey), at n = 2 and n = 32, on a ragged batch with
     dead rows and an odd row width, and on an all-in-one-partition batch
     that must raise the overflow flag; stats and every live staging row
     must match exactly;
  4. drive the main path: TPC-H Q1 over lineitem hash-repartitioned 8 ways
     on l_orderkey, through TpuSession on cuda, held against a plain numpy
     Q1 over the same host arrays (keys and count_order exact, sums and
     averages to relative 1e-9); the reorder kernel must have launched and
     the exchange must not have taken the sort path; then plain Q1 (no
     repartition) against the same reference.

Prints one JSON line of per-kernel numbers, then as its last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.

Usage: python3 chip_smoke.py [--sf 10.0] [--seed 42] [--profile PATH]
"""
from __future__ import annotations

import argparse
import datetime
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
    logs = [cuda_build.build(src) for src in sources]
    secs = time.perf_counter() - t0
    for src, (so, log) in zip(sources, logs):
        print(f"built {src} -> {so.name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"kernel build: {len(sources)} source(s) in {secs:.2f} s")


# ------------------------------------------------------------------ phase 3
def check_reorder(name, pids, data, geom, expect_flag=None, time_it=False):
    """Run the CUDA reorder and its plain version on the same inputs and
    compare exactly. Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    k_out, k_stats = pk.REORDER_KERNEL(pids, data, geom)
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
        k_ms = cuda_ms(lambda: pk.REORDER_KERNEL(pids, data, geom), 10)
        p_ms = cuda_ms(lambda: pk.partition_reorder_plain(pids, data, geom), 3)
    print(f"reorder {name}: groups={geom.groups} G={geom.G} n={geom.n} "
          f"L={geom.L} quota={geom.quota} overflow={flag} exact=yes"
          + (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}" if time_it else ""))
    return float(err), k_ms, p_ms


def synthetic_case(rows, L, n, dead_frac, device, seed, one_partition=False):
    import torch
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    g = torch.Generator(device=device).manual_seed(seed)
    geom = pk.KernelGeom.plan(rows, n, L)
    pids = torch.randint(0, n, (geom.cap,), generator=g, device=device,
                         dtype=torch.int32)
    if one_partition:
        pids.zero_()
    dead = torch.rand(geom.cap, generator=g, device=device) < dead_frac
    pids[dead] = -1
    pids[rows:] = -1
    data = torch.randint(0, 256, (geom.cap, L), generator=g, device=device,
                         dtype=torch.uint8)
    return (pids.view(geom.groups, geom.G, pk.W),
            data.view(geom.groups, geom.G * pk.W, L), geom)


def phase_kernels(lineitem, device):
    """Every kernel against its plain version; returns the kernel record
    of the main-path shape."""
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
    err, k_ms, p_ms = check_reorder("main-path", p3, d3, geom,
                                    expect_flag=False, time_it=True)
    # every pid is read; only live rows' data is read and written (no output
    # depends on a dead or padding row's bytes); stats are written once
    live = int((p3 >= 0).sum())
    moved = (geom.cap * 4 + 2 * live * geom.L
             + geom.groups * geom.n * pk.STAT_LANES * 4)
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    print(f"reorder main-path: bytes={moved} bound_ms={bound_ms:.4f} "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"roofline_share={bound_ms / k_ms:.3f}")
    del p3, d3
    torch.cuda.empty_cache()

    rows = 1 << 22
    for name, args, flag in [
            ("n=2", (rows, 76, 2, 0.0), False),
            ("n=32", (rows, 76, 32, 0.0), False),
            ("ragged+dead L=21", (3 * 32768 + 1000 + 77, 21, 5, 0.1), False),
            ("tiny", (300, 13, 3, 0.2), False)]:
        check_reorder(name, *synthetic_case(*args, device, seed=7),
                      expect_flag=flag)
    check_reorder("one-partition", *synthetic_case(rows, 76, 8, 0.0, device,
                                                   seed=9, one_partition=True),
                  expect_flag=True)
    torch.cuda.empty_cache()
    return {"name": "partition_reorder", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/partition_reorder.cu",
            "replaces": "spark_rapids_tpu/shuffle/partition_kernel.py:261",
            "launches": None, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------------ phase 4
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


def profile_q1(sess, lineitem, path, warm_s):
    """One more Q1 over the repartition, under torch.profiler: device time
    by kernel (and copy). Two idle shares are printed: of this run's own
    wall (which the profiler's overhead inflates), and an estimate across
    two runs, of the unprofiled warm wall ``warm_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.benchmarks.tpch import q1

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        q1(sess.create_dataframe(lineitem)
           .repartition(8, "l_orderkey")).collect()
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
    print(f"profile q1 repartition(8): device_busy_ms={busy_ms:.2f} "
          f"profiled_wall_ms={wall_ms:.2f} "
          f"idle_share_profiled_run={1 - busy_ms / wall_ms:.3f} "
          f"warm_wall_ms={warm_s * 1e3:.2f} "
          f"idle_share_est_of_warm={1 - busy_ms / (warm_s * 1e3):.3f} "
          f"table={path}")
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")


def phase_main_path(lineitem, reference, profile_path=None):
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, q1
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk

    sess = TpuSession(BENCH_CONF)                  # cuda: the default
    if sess.device.type != "cuda":
        raise AssertionError(f"session runs on {sess.device}")
    times, launches = [], None
    torch.cuda.reset_peak_memory_stats()
    for attempt in ("cold", "warm"):
        pk.REORDER_KERNEL.launches = 0
        t0 = time.perf_counter()
        res = q1(sess.create_dataframe(lineitem)
                 .repartition(8, "l_orderkey")).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if launches is None:
            launches = pk.REORDER_KERNEL.launches
        hashed = [e for e in sess.last_plan.walk()
                  if isinstance(e, TpuShuffleExchangeExec)
                  and isinstance(e.partitioning, HashPartitioning)]
        if len(hashed) != 1 or hashed[0].sort_path_splits != 0 \
                or hashed[0].kernel_splits < 1:
            raise AssertionError(
                f"the hash exchange must split through the kernel: "
                f"{[(e.kernel_splits, e.sort_path_splits) for e in hashed]}")
        check_q1(f"q1 repartition(8) {attempt}", res, reference)
    if launches < 1:
        raise AssertionError("the reorder kernel was not launched by Q1")
    print(f"q1 repartition(8, l_orderkey): rows={lineitem.num_rows} "
          f"cold_s={times[0]:.4f} warm_s={times[1]:.4f} "
          f"warm_rows_per_s={lineitem.num_rows / times[1]:.4g} "
          f"reorder_launches={launches} sort_path_splits=0 peak_device_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if profile_path:
        profile_q1(sess, lineitem, profile_path, times[1])
    t0 = time.perf_counter()
    res = q1(sess.create_dataframe(lineitem)).collect()
    torch.cuda.synchronize()
    print(f"q1 (no repartition): s={time.perf_counter() - t0:.4f}")
    check_q1("q1 plain", res, reference)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="lineitem scale factor (1.0 = 6M rows)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one Q1 run and write the per-kernel "
                         "device times to PATH")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"gpu: {gpu_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem

    build_kernels()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lineitem = gen_lineitem(args.sf, seed=args.seed)
    reference = q1_numpy(lineitem)
    print(f"lineitem sf={args.sf}: {lineitem.num_rows} rows generated and "
          f"reference Q1 computed in {time.perf_counter() - t0:.2f} s")
    record = phase_kernels(lineitem, device)
    record["launches"] = phase_main_path(lineitem, reference, args.profile)
    print(json.dumps({"kernels": [record]}))
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
