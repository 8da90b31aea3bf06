#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

Phases:
  1. require a CUDA device; print the card's name and power limit;
  2. build every hand-written kernel from csrc/ with nvcc, one nvcc per
     source, all started together; then make the port's CPU runs that
     phases 9-11, 13 and 15 hold the card against, in CPU_WORKERS processes,
     while two threads of this process generate the run's tables for
     phases 3-22, and wait for both; after phase 3 a thread writes phase
     16's parquet files beside phases 4-15 (pyarrow's encoder, off the
     main thread's critical path);
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
  7. slice 4's main path: TPC-H Q3 over customer, orders and lineitem
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
     numpy (np.lexsort's order);
  9. slice 5's main path, all 22 TPC-H queries through TpuSession:
     first at --check-sf (default 0.1) on the card against the port's own
     run on the CPU (keys, counts, dates and strings exact, floats to
     relative 1e-9, the queries whose sort can tie unordered); then the
     eight tables at the run's scale with the union of the columns the
     queries read, each query scanning only its own, orders and lineitem
     hash-repartitioned 8 ways; both kernels against their plain versions
     on the widest orders and lineitem inputs those exchanges build, timed
     and bounded there; LIKE's DFA timed on Q13's and Q16's columns; each
     query cold (a warm run would repeat it) with its
     wall time, rows, peak device memory, reorder launches (one per hash
     exchange, at least one where it reads orders or lineitem) and those
     kept, joins and aggregate modes; Q18 with dmaConsolidate on (the
     compact kernel must launch; the result equal to the default run's);
     Q13 and Q22 against numpy versions;
 10. slice 9's main path, all 99 TPC-DS queries and TPCx-BB q5 through
     TpuSession: first at --check-sf on the card against the port's own
     CPU run (as in phase 9); then the 24 TPC-DS tables at the run's
     scale with the union of the columns the 99 queries read and the four
     q5 reads, each query scanning only its own, store_sales,
     catalog_sales and web_sales hash-repartitioned 8 ways on their item
     keys; both kernels against their plain versions on the widest input
     those exchanges build from each sales fact, timed and bounded there;
     each query cold, the bench subset and q5 also warm (the warm result
     equal to the cold one), with
     its wall times, rows, peak device memory, reorder launches (one per hash
     exchange, every one kept) and those kept, joins, aggregate modes,
     the operators out of core and the bytes spilled per tier (q72, whose
     first join pairs every catalog line with all the inventory rows of
     its item, takes its largest joins out of core under pressure); q23
     with dmaConsolidate on (a compact launch per kept reorder
     output; the result equal to the default run's); the geomean of the 14
     bench queries' warm walls (bench.py's TPCDS_BENCH_QUERIES, the series of
     earlier runs) and of all 99's cold walls, with their sum, on lines of
     their own;
 11. slice 7's main path, all 30 TPCx-BB queries through TpuSession:
     first at --bb-check-sf (default 0.25) on the card against the port's
     own CPU run (as in phase 9); then the nineteen tables at the run's
     scale with the union of the columns the queries read, each query
     scanning only its own, store_sales and web_sales hash-repartitioned
     8 ways on their item keys and web_clickstreams on wcs_user_sk (the
     key its sessionizing windows partition on); both kernels against
     their plain versions on the widest input those exchanges build from
     each fact, timed and bounded there; the split's DFA (dfa_find_spans and
     regex_greedy_spans) timed over product_reviews; each query cold and
     warm (the warm result equal to the cold one) with its wall times,
     rows, peak device memory, reorder launches (one per hash exchange)
     and those kept, joins and aggregate modes; q29 with dmaConsolidate
     on (a compact launch per kept reorder output; the result equal to
     the default run's); the geomean of the 30 warm walls on a line of
     its own;
 12. slice 8's path, the default one (fused stages and the
     filter-into-aggregate fold, the scan cache, chunked uploads, the
     pipelined upload, the admission semaphore, the streaming collect)
     against ALL_OFF (fusion, scan cache, pipeline and streaming collect
     off, single-shot uploads): every query of the three suites at the
     check scales with ALL_OFF, equal bit for bit in the same row order to
     its default run of phases 9-11, with each query's fused stages and
     ops; Q1 and Q3 at the run's
     scale (orders and lineitem hash 8) and Q1 over the plain lineitem,
     both ways, cold and warm (the plain Q1 also, once, with each of
     ALL_OFF's keys alone, bit for bit against its default run), with walls, peak device memory, reorder
     launches and those kept (with --profile the device busy time over the
     warm wall); lineitem uploaded in 1 Mi-row chunks and in a single shot,
     once each, byte-equal, with their times; its TPC-DS part keeps the
     bench subset and q5;
 13. slice 9's entry point, TpuSession.sql over temp views: at
     --check-sf the 22 TPC-H and the 99 TPC-DS SQL texts, each over views
     of its DataFrame query's tables of phases 9 and 10 (orders, lineitem
     and the sales facts hash 8), each equal to that query's card result
     (by position;
     unordered where either reference test's sort can tie); one statement
     per function the SQL planner gained in this slice over the TPC-DS
     views, the card's result equal to the port's CPU run bit for bit
     (pow's within a few ulps: two libm pows); then TPC-H Q1, Q3 and Q21
     and TPC-DS q3, q14 and q67 by SQL at the run's scale over views of
     phases 9's and 10's tables, cold,
     each launching the reorder kernel and equal to its DataFrame query's
     result, and Q21's row ids (its non-equality correlation's semi/anti
     join) checked for repeats;
 14. slice 10's out-of-core layer (memory/grace.py, plan/footprint.py):
     the 22 TPC-H and 30 TPCx-BB queries and the TPC-DS bench subset and
     q5 at the check scales with
     memory.outOfCore.forcePartitions=4 (FORCE_CHECK; six card worker
     processes run them side by side, each query's time being the host's
     work per partition), each equal to its default run of phases 9-11
     (unordered; floats within REL_TOL), every grouped
     aggregate, keyed join and sort that ran having gone out of core;
     then at the run's scale Q1 hash 8, Q3 and TPC-DS q67 with
     forcePartitions=8, and Q3 with memory.faults.plan budget_clamp (its
     fraction sized from Q3's predicted footprint at the run's scale, at
     most 0.05) and alloc_fail:op=join,after=1 (the reactive path), cold,
     each equal to its default run, with
     walls, peak device memory, the operators out of core (trigger,
     sizing, partitions, depth) and the bytes spilled per tier;
 15. the expression and SQL surface (benchmarks/sql_surface.py):
     ``%`` as a grouping key, casts to strings fed to concat and length,
     regexp_replace, the unix-time conversions, percent_rank and
     cume_dist, framed min/max (a number and a string) by SQL, a PIVOT;
     initcap and rlike, the day and time parts, framed first/last with
     and without ignore nulls, the bitwise operators, shifts and
     transcendentals as DataFrames; the TPC-DS spec's query38
     (INTERSECT) and query87 (EXCEPT) with their semi/anti-join rewrites;
     first at --check-sf on the card against the port's CPU run (bit for
     bit, but the PIVOT's float sums within REL_TOL and the libm
     functions within TRANSCENDENTAL_ULPS), and TPC-DS q51 at
     Q51_CHECK_SF (its running float sum) against its CPU run; then each
     query at the run's scale over phase 10's tables (the sales facts
     hash 8), cold, with walls, reorder launches and peak device
     memory; each spec text must equal its rewrite;
 16. slice 12's main path, the parquet scan and the encoded domain
     (``TpuSession.read.parquet``): a thread started after phase 3 writes
     lineitem (Q1's columns and l_orderkey) and store_sales, item and
     date_dim (q3's columns) at the run's scale with pyarrow into a
     temporary directory, 16 row groups each (bench.py:1192); TPC-H Q1
     cold from lineitem.parquet with io.scan.prefetchBatches 2 and 0 and
     io.parquet.deviceDictDecode.enabled on and off (bench.py's cold conf:
     no scan cache, 16-byte strings), each equal to phase 6's in-memory
     cold Q1 (exact but the float sums, within REL_TOL), with the cold
     walls, serial_s/pipelined_s, the staged and decoded-equivalent bytes,
     the operators planned onto and run on the encoded domain; the upload
     rate of one row group encoded and decoded; TPC-H lineitem's
     dictionary strings and doubles from parquet hash-exchanged 8 ways
     with sql.exchange.keepEncodings on (every map batch must take the
     encoded split) and off (every one the reorder kernel), the
     partitions holding the same rows; q3 from parquet
     with store_sales hash 8 on ss_item_sk and keepEncodings off (it must
     launch the reorder kernel), equal to phase 10's
     result, and q3 with dmaConsolidate on (one compact launch per kept
     reorder output), printing each exchange's kernel, sort-path and
     encoded splits; then at --check-sf
     Q1 and q3 from files sorted on the pushed-down column, through a
     filter that must clip row groups and an input_file_name() filter,
     against the port's CPU run of the same files. It prints its seconds
     against a bound of 180 s;
 17. slice 13's main path, the plan layer's CPU fallback: the mortgage
     ETL (clean_acquisition_prime, benchmarks/mortgage.py) at scale 50,
     seed 42 (500,000 loans, ~10.5M performance rows, ~126M rows out of
     the 12-month explode) to ``ml.device_arrays`` on cuda, plain and
     with the performance table hash 8 on loan_id (the reorder kernel),
     cold: input rows/s over the cold wall, feature rows and
     columns, peak device memory, the operators out of core, reorder
     launches, launches kept and the launches whose quota overflowed; the
     tensors downloaded equal ``collect()``; at scale 0.5 both ETL
     functions on the card equal the port's CPU engine
     (sql.enabled=false). TPC-H Q1 with the row UDF ``charge(price, tax)
     = price * (1.0 + tax)`` (bench.py::_bench_udf_q1) compiled
     (sql.udfCompiler.enabled) at the run's scale, lineitem hash 8, cold
     and warm: no PythonUDF in the plan, equal bit for bit to the query
     with the built-in expression; at SF 0.1 the row fallback (its
     aggregate "cannot run on TPU") against the compiled UDF within
     REL_TOL. TPC-H Q1 and Q3 at --check-sf on the CPU engine of the
     card's host (sql.enabled=false) equal to phase 9's card results, and
     Q1 without variableFloatAgg (its aggregate on the CPU engine) within
     REL_TOL;
 18. slice 14's main path, adaptive execution and the coalesce
     (sql.adaptive.enabled, plan/adaptive.py) and the Catalyst import:
     phase 10's bench subset and q5 over its tables at the run's scale
     with adaptive execution on, cold, each equal to phase 10's
     result (exact but the float sums, within REL_TOL) with no more
     reorder launches than phase 10's run of the query, printing the
     coalesced partitions, broadcast switches, skew splits and re-fused
     stages, the cold wall beside phase 10's and the peak; the skew cell,
     bench.py::_bench_adaptive's Zipf(1.3) join and group-by at 100x its
     rows (6,000,000 at SF 10, scaled with --sf), its device pool and
     host spill budget scaled alike, adaptive off then on, warm: a skew
     split in the plan, the results equal bit for bit, the walls, spill
     partitions, recursion depth, reorder launches and those kept each
     way; the re-fusion and broadcast-switch probes (bench.py) and a
     cost-model probe whose join runs on the CPU engine, equal to the
     device join; the eight tests/catalyst_fixtures plans planned for the
     card as for the CPU;
 19. slice 15's main path, the file writers and the ORC and CSV scans:
     phase 9's lineitem (all 16 columns, the run's scale) from the scan
     cache written with ``df.write.mode("overwrite")`` to 12 ORC files
     (maxRecordsPerFile), and TPC-H Q1's output over phase 6's
     lineitem hash 8 (the reorder kernel, held against its plain version
     on that input first) to parquet; each write's WriteStats checked
     against the files on disk (rows, files, partitions, bytes, the
     commit's _SUCCESS and no _temporary), its wall and decoded GB/s;
     then Q1 and Q6 read back from the ORC files (the stripes read
     against the stripes present), each equal to phase 9's result; at
     PUSHDOWN_SF lineitem sorted by l_shipdate to zlib ORC, Q6 reading
     fewer stripes than the files hold and equal to the run that reads
     them all; at CSV_SF lineitem to parquet partitioned by l_returnflag
     and l_linestatus (4 directories) and Q1 read back through hive
     discovery, and to CSV on the CPU engine (the reference's reason in
     the explain) and read back with its schema, each Q1 equal to the
     in-memory Q1. It checks free disk first, fails at
     the start where pyarrow lacks ORC or CSV, and prints its seconds
     against a bound of 120 s. Every card run of phases 6-19 fails if its
     plan leaves an operator but the in-memory scans to the CPU engine,
     but the cost-model probe's join and the CSV write.
 20. slice 16's main path, the mesh: sql.mesh.enabled with MESH_SHARDS (4)
     shards on the one card and adaptive execution on (MESH_CONF), all 22
     TPC-H queries over phase 9's tables and the TPC-DS bench subset and
     q5 over phase 10's, each once (Q1 and Q3 cold and warm), every result
     equal to the phase's single-device card result (exact columns bit for
     bit, floats within REL_TOL, ties unordered); per query the wall, the
     peak device memory, the plan's Mesh* operators and its gathers, each
     mesh repartition's rows, recv_max and recv_min (EXCHANGE_STATS),
     host_hop_bytes and the reorder launches. Each plan must hold mesh
     operators, every shard tensor must lie on the card, host_hop_bytes
     must be 0 and Q1 and Q3 must launch no reorder kernel (every exchange
     on the mesh is a mesh repartition). It prints its seconds against a
     bound of 120 s.
 21. slice 17's main path, the cluster and the network shuffle
     (``sql.cluster.numExecutors`` 2, joins shuffled) at CLUSTER_SF (1;
     every query of the cluster moves all its rows through the network
     shuffle, about 0.1 GB/s, so SF 10 took 306.69 s: PERF.md §6),
     each run held against its single-device card run at that scale: 21a,
     two in-process executors over the TCP transport, TPC-H Q1 and Q3,
     every input repartition(2)-ed, then Q3 with dmaConsolidate on (the
     compact kernel must launch); per query the wall, the stages and
     their tasks, the map tasks per executor, the bytes fetched remotely
     and their rate over the wall, the seconds spent pickling and
     unpickling the stage plans, the reorder launches and those kept, and
     the peak. Both executors must map, remote bytes must flow and a
     reorder output must be kept. 21b, two executor daemons on the card
     (``sql.cluster.processExecutors``; each store at
     CLUSTER_DAEMON_FRACTION of the card), phase 2's 16 parquet files of
     lineitem spread over them: Q1 and the wide shuffle (every row moved
     by ``l_orderkey``, one group per order); each daemon's device and
     peak, its reorder launches and those kept (read from the daemons:
     the wide shuffle must launch the reorder) and the bytes moved
     between them. 21c, Q3 on two in-process executors over
     FaultInjectingTransport around TCP with exec-1 killed mid-reduce:
     equal, at least one lineage recompute. The script's run takes this
     floor of the phase's query lists (CLUSTER_FLOOR): with every query
     it passes 1140 s of phases on a slow host.
 22. slice 18's main path, serving: 22a, Q1, Q3 and Q6 over phase 9's
     tables (orders and lineitem hash 8) submitted twice by each of two
     tenants weighted 3:1 through TpuSession.submit
     (serving.maxConcurrentQueries 4, sql.concurrentTpuTasks 2), each
     equal to its phase 9 result with its single run's reorder launches
     (counted on its handle), printing its queue and admission waits,
     wall, launches and those kept; a Q3 cancelled while RUNNING; a query
     with a 1 ms deadline (QueryTimeoutError); preemption on one device
     permit (an interactive tenant's Q1 reaches the card before the
     whale's running Q3 ends; the whale yields at least once; both
     equal); a traced Q3 whose EXPLAIN ANALYZE names every executed exec
     with rows and batches and whose Chrome export holds a span per exec;
     after each part no semaphore holder and an empty shuffle catalog.
     22b, two in-process QueryServers over one session with
     dmaConsolidate on and a QueryServiceClient over both: Q1, Q6 and Q3
     by SQL over TCP (the compact kernel launching once per kept reorder
     output), each equal to its DataFrame result, then a filter whose
     first server's transport dies after its second result frame:
     resumed on the second server (resume_from), equal. 22c, one replica
     process of the port's server CLI (ReplicaSupervisor, started beside
     phase 21; lineitem at SERVING_REPLICA_SF, --partitions 8, its store
     SERVING_REPLICA_FRACTION of the card): Q1 through it equal to this
     process's run, its kernel counts read through serve.stats, then
     SIGKILL; it restarts on its backoff while 22a and 22b run, and Q1
     again is equal.

Phases 9-11 and 13 print, per query, the operators that went out of core
and the bytes spilled to the host and to disk. TPC-DS q72, which ran out
of the card's memory at SF 10 and SF 5 before slice 10, runs at the run's
scale with the other 98: its largest joins go out of core under pressure
(PERF.md, slice 10).

Usage beside the smoke run: --memory-profile QUERY ... measures where the
named TPC-DS queries' device memory goes, operator by operator, at
--memory-profile-sf (default 5 and 2), and prints no result line.
--cluster-only SF runs phase 21 alone at TPC-H scale SF with every query
of its lists (21a also Q6 and TPC-DS q3, q27, q42 and q96, and the wide
shuffle over CLUSTER_LZ4_ROWS rows of lineitem with the lz4 codec; 21b
also Q6), and prints no result line. --serving-only SF runs phase 22's
22a (with the TPC-DS bench subset and q5 added) and 22b alone at TPC-H
scale SF, then a checksum re-fetch under serving.net.faults.plan,
load-aware routing (a query lands on the replica with free budget) and
the breaker of a dead replica, and the FleetController scaling a
supervised fleet of replica processes from two to four under eight
clients and back to two through the drain path under two, no query
dropped; it prints no result line.

The sessions run the port's defaults, so phases 6-11 take the default
path too; their warm runs read the scan cache (a query's pruned tables are
made once per phase), and a cold run starts with the cache cleared.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after; comparison launches are not counted. Each phase's
seconds are printed. Prints one JSON line of per-kernel numbers: phase
10's launches over the 99 TPC-DS queries and q5 (and launches_kept,
those whose output was used; the compact kernel's from the dma-on q23)
with the
times, bounds and errors of phase 10's check on the widest input of each
sales fact (summed over the inputs, each under "inputs"), phase 11's
TPCx-BB and phase 9's TPC-H readings (launches and their checks,
likewise), phase 13's SQL launches at the run's scale, phase 15's
surface launches, phase 16's parquet launches (with the exchanges' encoded
splits), phase 18's adaptive suite and skew cell launches, phase 19's
Q1 output write's, phase 21's cluster launches, phase 22's served
queries' (22a's counted on each query's handle, 22b's around each wire
query; the replica process's under its paths), phase 7's reading on Q3's
inputs, phase 3's at Q1's
lineitem shape, and every path's launches under launches_by_path; then as its last
line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line.

Usage: python3 chip_smoke.py [--sf 10.0] [--seed 42] [--profile DIR]
       [--tile-sweep ROWS ...] [--kernels-only] [--check-sf 0.1]
       [--bb-check-sf 0.25] [--memory-profile QUERY ...
       [--memory-profile-sf SF ...]] [--cluster-only SF]
       [--serving-only SF]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
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
    pk.REORDER_KERNEL.kept = 0
    pk.COMPACT_KERNEL.launches = 0


def read_launches():
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    return pk.REORDER_KERNEL.launches, pk.COMPACT_KERNEL.launches


def read_kept():
    """The reorder launches since ``reset_launches`` whose output a split
    used."""
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    return pk.REORDER_KERNEL.kept


def run_exchange(batch, part, conf, device):
    """One TpuShuffleExchangeExec over a resident leaf of one batch (or a
    list of them): every reduce partition read back through the shuffle
    catalog, then the action's cleanups. Returns (exec, partitions,
    seconds, tiers), where tiers counts the map outputs on (device, host,
    disk) before the read."""
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
            self.batches = b if isinstance(b, list) else [b]
            super().__init__(self.batches[0].schema)

        def execute(self, ctx):
            yield from self.batches

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
    """Plain numpy TPC-H Q1 over the host arrays -> {(flag, status): row}.
    Each sum is one bincount over the (flag, status) byte pair, the rows
    past the ship-date cut in a bin of their own; a bin's rows add in row
    order, as over the filtered arrays."""
    cols = {f.name: c for f, c in zip(li.schema, li.columns)}
    cut = (datetime.date(1998, 9, 2) - datetime.date(1970, 1, 1)).days
    keep = cols["l_shipdate"].data <= cut
    flag = cols["l_returnflag"].data[:, 0].astype(np.int64)
    status = cols["l_linestatus"].data[:, 0].astype(np.int64)
    key = np.where(keep, flag * 256 + status, 1 << 16)
    qty = cols["l_quantity"].data
    price = cols["l_extendedprice"].data
    disc = cols["l_discount"].data
    tax = cols["l_tax"].data
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = np.bincount(key, minlength=(1 << 16) + 1)[:1 << 16]
    keys = np.nonzero(cnt)[0]
    sums = {name: np.bincount(key, weights=w, minlength=(1 << 16) + 1)
            for name, w in (("qty", qty), ("price", price), ("disc", disc),
                            ("disc_price", disc_price), ("charge", charge))}
    out = {}
    for k in keys:
        n = cnt[k]
        out[(chr(k // 256), chr(k % 256))] = {
            "sum_qty": sums["qty"][k], "sum_base_price": sums["price"][k],
            "sum_disc_price": sums["disc_price"][k],
            "sum_charge": sums["charge"][k],
            "avg_qty": sums["qty"][k] / n, "avg_price": sums["price"][k] / n,
            "avg_disc": sums["disc"][k] / n, "count_order": int(n)}
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
        assert_on_device(f"q1 repartition(8) {attempt}", sess)
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
    assert_on_device("q1 repartition(8) dmaConsolidate", dma)
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
    assert_on_device("q1 plain", sess)
    check_q1("q1 plain", res, reference)
    # phase 16's reference: the in-memory cold Q1 under bench.py's cold
    # conf (no scan cache, 16-byte strings)
    cold = TpuSession({**BENCH_CONF, **COLD_KEYS})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = q1(cold.create_dataframe(lineitem)).collect()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    assert_on_device("q1 plain cold", cold)
    check_q1("q1 plain cold", res, reference)
    print(f"q1 (no repartition, no scan cache, 16-byte strings): "
          f"cold_s={cold_s:.4f}")
    return launches, (res, cold_s)


# ------------------------------------------------------------------ phase 7
def q3_tables(tpch):
    """customer, orders and lineitem with the columns Q3 and Q6 read: those
    columns of ``tpch_tables``' tables (their generators make each column
    the same whatever columns are asked)."""
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import (Q3_COLUMNS,
                                                                Q6_COLUMNS)
    want = {"customer": Q3_COLUMNS["customer"],
            "orders": Q3_COLUMNS["orders"],
            "lineitem": [c for c in td.LINEITEM_COLUMNS
                         if c in Q3_COLUMNS["lineitem"]
                         + Q6_COLUMNS["lineitem"]]}
    return {t: tpch[t].select([c for c in tpch[t].schema.names()
                               if c in cols])
            for t, cols in want.items()}


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
    name = type(plan).__name__
    out = [name] if "Join" in name or "Cartesian" in name else []
    for c in plan.children:
        out += join_strategies(c)
    return out


def exchange_kernel_inputs(hb, key, device):
    """The reorder's inputs as a hash exchange over ``hb`` builds them:
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
    l_orderkey)."""
    return check_kernels_on(
        {f"q3 {t} hash(8, {k})": (tables[t], k)
         for t, k in (("orders", "o_orderkey"), ("lineitem", "l_orderkey"))},
        device)


def check_kernels_on(inputs, device):
    """Both kernels against their plain versions on the reorder inputs the
    hash exchanges (8 ways on ``key``) over the named tables build, timed
    and bounded there. ``inputs`` maps a name to (host table, key).
    Returns (each input's overflow flag, the reorder's numbers, the compact
    kernel's numbers). A query launches the reorder once per exchange, so
    its ms, plain_ms and bound_ms are sums over the inputs and max_abs_err
    their maximum; the compact kernel runs only where the reorder's output
    is kept (no overflow), and its numbers sum over those inputs.
    ``inputs`` in each record lists each input's own reading."""
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
    for name, (hb, key) in inputs.items():
        p3, d3, geom = exchange_kernel_inputs(hb, key, device)
        err, k_ms, p_ms, flag = check_reorder(name, p3, d3, geom,
                                              time_it=True)
        moved, bound = reorder_bound_ms(p3, geom)
        print(f"reorder {name}: bytes={moved} bound_ms={bound:.4f} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"roofline_share={bound / k_ms:.3f} overflow={flag}"
              + (" (stats compared; the exchange discards the staging rows "
                 "and takes the sort path)" if flag else ""))
        flags.append(flag)
        add(reorder, {"input": name, "rows": hb.num_rows,
                      "L": geom.L, "overflow": flag, "max_abs_err": err,
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                      "library_ms": None})
        if not flag:
            out, stats = pk.REORDER_KERNEL(p3, d3, geom)
            del p3, d3
            c_err, c_ms, c_plain, c_lib, c_bound = check_compact(
                name, out, stats, geom, time_it=True)
            add(compact, {"input": name, "rows": hb.num_rows,
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
            assert_on_device(f"q3 {label} {attempt}", sess)
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


def phase_q6_and_sort(li, device):
    """Q6 against a numpy Q6, then lineitem hash-repartitioned 8 ways and
    sorted globally on (l_shipdate, l_orderkey) through the range exchange:
    the bounds, the per-partition counts and the collected rows checked
    against numpy."""
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
        assert_on_device("q6", sess)
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
    assert_on_device("sort", sess)
    # np.lexsort((l_orderkey, l_shipdate))'s order: a stable sort of the
    # combined key, done on the card by torch.sort (numpy's takes ~30 s)
    key = (_col(li, "l_shipdate").astype(np.int64) << 40) \
        | _col(li, "l_orderkey")
    key_t = torch.from_numpy(key).to(device)
    order_t = torch.sort(key_t, stable=True).indices
    ex = [e for e in sess.last_plan.walk()
          if isinstance(e, TpuShuffleExchangeExec)
          and isinstance(e.partitioning, RangePartitioning)]
    if len(ex) != 1 or ex[0].kernel_splits or ex[0].sort_path_splits != 8:
        raise AssertionError(f"sort: range exchanges {ex}")
    bounds = ex[0].range_bounds
    bkey = ((bounds[0].data.cpu().numpy().astype(np.int64) << 40)
            | bounds[1].data.cpu().numpy())
    skey = key_t[order_t].cpu().numpy()
    del key_t
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
        # the gather on the card (numpy's over 60M rows took 1.5 s a column)
        want = torch.from_numpy(_col(li, name)).to(device)[order_t]
        if not np.array_equal(_col(res, name), want.cpu().numpy()):
            raise AssertionError(f"sort: {name} is not in np.lexsort order")
    del order_t
    pairs = [(int(k >> 40), int(k & (2**40 - 1))) for k in bkey]
    print(f"sort repartition(8) by (l_shipdate, l_orderkey): {res.num_rows} "
          f"rows equal np.lexsort s={sort_s:.4f} checks_s="
          f"{time.perf_counter() - t0 - sort_s:.2f} "
          f"partition_rows={list(rows)} bounds(shipdate, orderkey)={pairs}")
    del res, skey, key


# ------------------------------------------------------------------ phase 9
#: queries whose final sort can tie (tests/test_tpch_full.py's list): their
#: rows compare unordered
TPCH_TIES = {2, 3, 5, 9, 10, 11, 16, 18, 21}
PARTITION_KEYS = {"orders": "o_orderkey", "lineitem": "l_orderkey"}


def tpch_tables(sf, seed):
    """The eight tables with the union of the columns the 22 queries read,
    lineitem with all 16 (phase 19 writes it whole)."""
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import all_columns
    return td.gen_all(sf, seed, {**all_columns(),
                                 "lineitem": list(td.LINEITEM_COLUMNS)})


def query_tables(tables, q):
    """The tables query ``q`` reads, each with only its columns (and the
    partition key of orders and lineitem)."""
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import COLUMNS
    out = {}
    for t, names in COLUMNS[q].items():
        key = PARTITION_KEYS.get(t)
        out[t] = tables[t].select(names + ([key] if key and key not in names
                                           else []))
    return out


def input_width(hb):
    """Bytes of a packed row of ``hb`` (its reorder input's L, roughly)."""
    return sum(c.data.itemsize * (c.data.shape[1] if c.data.ndim > 1
                                  else 1) + 1
               + (4 if c.lengths is not None else 0) for c in hb.columns)


def memo(fn):
    """``fn(q)`` made once per ``q``: a query's pruned tables stay the same
    host objects across its runs, so every run after the first reads them
    from the scan cache, as repeated actions over one DataFrame do."""
    made = {}

    def get(q):
        if q not in made:
            made[q] = fn(q)
        return made[q]
    return get


def query_frames(sess, pruned, repartition=True):
    """A query's DataFrames over its pruned tables, orders and lineitem
    hash-repartitioned 8 ways on their order keys (with ``repartition``)."""
    dfs = {}
    for t, hb in pruned.items():
        df = sess.create_dataframe(hb)
        dfs[t] = df.repartition(8, PARTITION_KEYS[t]) \
            if repartition and t in PARTITION_KEYS else df
    return dfs


def result_rows(hb):
    """A result's rows as tuples (None for null, bytes for strings), read
    a column at a time."""
    n = hb.num_rows
    cols = []
    for c in hb.columns:
        valid = c.validity[:n].tolist()
        if c.lengths is not None:
            # a string column: uint8 rows of width w, each cut at its length
            w = c.data.shape[1]
            buf = c.data[:n].tobytes()
            vals = [buf[r * w:r * w + ln] if v else None for r, (v, ln)
                    in enumerate(zip(valid, c.lengths[:n].tolist()))]
        else:
            vals = [x if v else None
                    for x, v in zip(c.data[:n].tolist(), valid)]
        cols.append(vals)
    return list(zip(*cols))


def sorted_rows(rows):
    """Rows of a query whose sort can tie, in one canonical order: floats
    rounded (they agree to 1e-9, not bit for bit), nulls first. Each
    value's key is its (not null, value) pair, flattened into one tuple
    per row."""
    keys = []
    for col in zip(*rows):
        keys.append([v is not None for v in col])
        keys.append([0 if v is None else round(v, 6)
                     if isinstance(v, float) else v for v in col])
    keys = list(zip(*keys))
    return [rows[i] for i in sorted(range(len(rows)), key=keys.__getitem__)]


def check_same_result(name, got, want, ties, positional=False):
    """Keys, counts, dates and strings exact; floats within relative
    REL_TOL (NaN equals NaN); unordered when the query's sort can tie.
    ``positional``: the columns compare by position, whatever their
    names (a SQL text names its outputs as the spec does)."""
    if (not positional and got.schema.names() != want.schema.names()) \
            or len(got.schema) != len(want.schema) \
            or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows of "
                             f"{got.schema.names()} against {want.num_rows} "
                             f"of {want.schema.names()}")
    if _identical(got, want):
        # the same values in the same rows pass every rule below; results of
        # a million rows would take seconds to walk in Python
        return 0.0
    g, w = result_rows(got), result_rows(want)
    if ties:
        g, w = sorted_rows(g), sorted_rows(w)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        for x, y in zip(a, b):
            if isinstance(y, float) and x is not None:
                if math.isnan(y) or math.isnan(x):
                    ok = math.isnan(x) and math.isnan(y)
                else:
                    err = abs(x - y) / max(abs(y), 1e-300)
                    worst = max(worst, err)
                    ok = err <= REL_TOL
            else:
                ok = x == y
            if not ok:
                raise AssertionError(f"{name}: row {i} differs: {a} != {b}")
    return worst


def assert_on_device(name, sess):
    """Under BENCH_CONF the plan layer leaves nothing of a suite query to
    the CPU engine: the executed plan holds no ``Cpu*Exec`` but the
    in-memory scans, and the explain has no "cannot run on TPU" line but
    theirs (a host table has no device form; its upload follows it)."""
    host = sorted({type(n).__name__ for n in sess.last_plan.walk()
                   if type(n).__name__.startswith("Cpu")
                   and type(n).__name__ != "CpuLocalScanExec"})
    lines = [ln.strip() for ln in sess.last_explain.splitlines()
             if "cannot run on TPU" in ln and "CpuLocalScanExec" not in ln]
    if host or lines:
        raise AssertionError(f"{name}: the plan left {host} on the CPU "
                             f"engine: {lines}\n{sess.last_explain}")


def run_query(sess, name, build, on_device=True):
    """One run of ``build(sess).collect()`` on the session's device ->
    (result, seconds, reorder launches, compact launches, launches kept,
    plan). With ``on_device`` the plan must hold no CPU engine operator
    (``assert_on_device``)."""
    import torch
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    reset_launches()
    t0 = time.perf_counter()
    res = build(sess).collect()
    if sess.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    reorder_n, compact_n = read_launches()
    plan = sess.last_plan
    if on_device:
        assert_on_device(name, sess)
    hashed = [e for e in plan.walk() if isinstance(e, TpuShuffleExchangeExec)
              and isinstance(e.partitioning, HashPartitioning)]
    kept = sum(e.kernel_splits for e in hashed)
    if sess.device.type == "cuda" and reorder_n != len(hashed):
        raise AssertionError(f"{name}: {reorder_n} reorder launches for "
                             f"{len(hashed)} hash exchanges")
    return res, secs, reorder_n, compact_n, kept, plan


def check_against_cpu(label, sf, specs, refs):
    """Every query of ``specs`` ((name, build, ties, reads a partitioned
    table) as ``query_specs`` gives them) on the card against the port's
    own run on the CPU (whose answers the CPU tests hold against the JAX
    package): ``refs[name]`` is that run's (result, seconds), from
    ``cpu_references``. Returns the card's results."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    gpu = TpuSession(BENCH_CONF)
    cpu_s = gpu_s = 0.0
    results = {}
    for name, build, ties, _ in specs:
        want, secs = refs[name]
        cpu_s += secs
        got, secs = run_query(gpu, name, build)[:2]
        gpu_s += secs
        worst = check_same_result(f"{name} sf={sf} cuda against cpu", got,
                                  want, ties)
        print(f"{name} sf={sf}: {got.num_rows} rows equal the CPU run "
              f"(worst relative float error {worst:.3e})")
        results[name] = got
    print(f"{label} sf={sf} check: {len(specs)} queries on the CPU in "
          f"{cpu_s:.2f} s (in the CPU workers) and on the card in "
          f"{gpu_s:.2f} s, every result equal")
    return results


# ------------------------------------------------------ the CPU references
#: worker processes, and torch threads in each, that make the CPU
#: references: torch's CPU operators use extra threads poorly at the
#: check scales, so several processes of few threads finish sooner than
#: one process with every core
CPU_WORKERS, CPU_THREADS = 8, 1
#: a CPU worker's query builds, per (suite, scale, seed)
_WORKER_SPECS: dict = {}


def _worker_init(threads):
    import torch
    torch.set_num_threads(threads)


def cpu_run(suite, sf, seed, name):
    """In a CPU worker: query ``name`` of ``suite`` (``SUITES``) on the
    port's CPU session -> (result, seconds). The suite's tables are made
    once per worker, from the same generators and seed as the card's."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    key = (suite, sf, seed)
    if key not in _WORKER_SPECS:
        make_tables, make_specs = SUITES[suite]
        _WORKER_SPECS[key] = {s[0]: s[1] for s in
                              make_specs(make_tables(sf, seed))}
    sess = TpuSession(BENCH_CONF, device="cpu")
    return run_query(sess, name, _WORKER_SPECS[key][name])[:2]


def cpu_references(jobs):
    """The port's CPU runs that the card's results are held against, for
    ``jobs`` [(suite, scale, seed, query names)], made by CPU_WORKERS
    processes. The script waits for them all before its first timed
    phase, so no CPU work runs beside one; the workers are gone when this
    returns or raises. Returns {suite: {name: (result, seconds)}}."""
    import multiprocessing
    refs = {}
    with concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(CPU_THREADS,)) as pool:
        futures = {(suite, name): pool.submit(cpu_run, suite, sf, seed, name)
                   for suite, sf, seed, names in jobs for name in names}
        try:
            for (suite, name), f in futures.items():
                refs.setdefault(suite, {})[name] = f.result()
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
    return refs


def grace_summary(plan):
    """The operators of ``plan`` that went out of core (memory/grace.py),
    each as "Exec:trigger/sized_by/SxF/partitions/depth"; trigger is
    forced, predicted (the footprint contract's hint) or reactive
    (pressure while staging), sized_by force, observed (the inputs' stage
    statistics), hint or fanout; S top-level splits (a join splits each
    side, every stream partition that goes out of core splits on its own)
    of F partitions each; partitions made in all, at every depth."""
    out = []
    for n in plan.walk() if plan is not None else ():
        g = getattr(n, "grace_stats", None)
        if g:
            out.append(f"{n.name.replace('Tpu', '').replace('Exec', '')}:"
                       f"{g.get('trigger')}/{g.get('sized_by')}/"
                       f"{g.get('splits', 0)}x{g.get('fanout', 0)}/"
                       f"{g.get('partitions', 0)}/{g.get('depth', 0)}")
    return out


def spilled_bytes():
    """Bytes the store chain has spilled to the host and to disk."""
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    dm = DeviceManager.peek()
    return dm.spilled_bytes() if dm is not None else {"host": 0, "disk": 0}


def spilled_since(before):
    now = spilled_bytes()
    return {k: max(now[k] - before[k], 0) / 1e9 for k in now}


def run_cold_warm(specs, all_kept, conf=None, warm=None):
    """Each query of ``specs`` cold then warm on the card (the warm result
    must equal the cold one), under ``conf`` (default the benchmark conf),
    the warm run only for the names in ``warm`` when it is given (a warm
    run repeats its query: the script keeps those that feed a series),
    with its wall times, rows, peak device memory, reorder launches and
    launches kept (the hash exchanges that used the kernel's output rather
    than the sort path; every one with ``all_kept``), join strategies,
    aggregate grouping modes, the operators that went out of core and the
    bytes spilled per tier. Any failure raises. Returns (per-query
    numbers, warm results)."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.tpu_execs import TpuHashAggregateExec

    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache

    conf = conf or BENCH_CONF
    sess = TpuSession(conf)
    results, nums = {}, {}
    for name, build, ties, partitioned in specs:
        # a cold run finds nothing cached; the warm run reads the scan
        # cache, and the peak counts the query's cached tables
        if peek_cache() is not None:
            peek_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spill0 = spilled_bytes()
        cold, cold_s, launches, _, kept, plan = run_query(sess, name, build)
        grace = grace_summary(plan)
        if warm is None or name in warm:
            warm_res, warm_s = run_query(sess, name, build)[:2]
            check_same_result(f"{name} warm against cold", warm_res, cold,
                              ties)
        else:
            warm_res, warm_s = cold, None
        peak = torch.cuda.max_memory_allocated() / 1e9
        spilled = spilled_since(spill0)
        if partitioned and launches < 1:
            raise AssertionError(f"{name} reads a hash-repartitioned table "
                                 f"and did not launch the reorder kernel")
        splits = [(e.kernel_splits, e.sort_path_splits) for e in plan.walk()
                  if isinstance(e, TpuShuffleExchangeExec)
                  and isinstance(e.partitioning, HashPartitioning)]
        if all_kept and kept < len(splits):
            raise AssertionError(f"{name}: a hash exchange took the sort "
                                 f"path: {splits}")
        joins = [j.replace("Tpu", "").replace("Exec", "")
                 for j in join_strategies(plan)]
        modes = [e.modes_run for e in plan.walk()
                 if isinstance(e, TpuHashAggregateExec)]
        nums[name] = {"rows": warm_res.num_rows, "cold_s": cold_s,
                      "warm_s": warm_s, "peak_gb": peak,
                      "launches": launches, "launches_kept": kept,
                      "grace": grace, "spilled_gb": spilled}
        warm_text = "not run" if warm_s is None else f"{warm_s:.4f}"
        print(f"{name}: rows={warm_res.num_rows} cold_s={cold_s:.4f} "
              f"warm_s={warm_text} peak_device_gb={peak:.2f} "
              f"reorder_launches={launches} launches_kept={kept} "
              f"splits_kernel_sort={splits} joins={joins} "
              f"aggregate_modes={modes} out_of_core={grace} "
              f"spilled_host_gb={spilled['host']:.3f} "
              f"spilled_disk_gb={spilled['disk']:.3f}")
        results[name] = warm_res
        del cold, plan
    return nums, results


def run_dma(name, build, want):
    """The query again with dmaConsolidate on: the compact kernel must
    launch once per kept reorder output and the result equal ``want``.
    Returns (reorder, compact, kept) launches."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    dma = TpuSession({**BENCH_CONF, "spark.rapids.tpu.shuffle.kernel."
                                    "dmaConsolidate.enabled": "true"})
    res, secs, reorder_n, compact_n, kept = run_query(dma, name, build)[:5]
    if compact_n < 1 or compact_n != kept:
        raise AssertionError(f"{name} dmaConsolidate: {compact_n} compact "
                             f"launches for {kept} kept reorder outputs")
    check_same_result(f"{name} dmaConsolidate against the default run", res,
                      want, True)
    print(f"{name} dmaConsolidate: s={secs:.4f} reorder_launches="
          f"{reorder_n} compact_launches={compact_n}, equal to the default "
          f"run")
    return reorder_n, compact_n, kept


def tpch_specs(tables, pruned=None):
    """The 22 queries as (name, build, ties, reads a partitioned table);
    ``pruned(q)`` gives query ``q``'s tables (``query_tables``, made once
    per query)."""
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import (COLUMNS,
                                                                QUERIES)
    pruned = pruned or memo(lambda q: query_tables(tables, q))
    return [(f"q{q}", lambda sess, q=q: QUERIES[q](query_frames(
        sess, pruned(q))), q in TPCH_TIES,
        any(t in PARTITION_KEYS for t in COLUMNS[q])) for q in QUERIES]


def phase_tpch_check(sf, seed, refs):
    """The 22 queries at ``sf`` on the card against the CPU run
    (``refs``). Returns (the tables, the card's results, each query's
    pruned tables)."""
    t0 = time.perf_counter()
    tables = tpch_tables(sf, seed)
    print(f"tpch sf={sf}: tables generated in "
          f"{time.perf_counter() - t0:.2f} s")
    pruned = memo(lambda q: query_tables(tables, q))
    return tables, check_against_cpu("tpch", sf, tpch_specs(
        tables, pruned), refs), pruned


def like_numpy(data, lengths, parts):
    """LIKE '%p1%p2%...%' on the host: each part found, in order, after
    the previous part's end. The rows, cut at their lengths, are joined by
    newlines into one buffer that ``re`` searches at C speed (a byte
    matrix compared part by part took 15-25 s at SF 10's 15M comments)."""
    import re
    n, width = data.shape
    live = np.where(np.arange(width)[None, :] < lengths[:, None], data, 0)
    if (live == 10).any():
        raise ValueError("like_numpy: a row holds a newline")
    buf = np.concatenate([live, np.full((n, 1), 10, np.uint8)],
                         axis=1).tobytes()
    pattern = re.compile(b".*?".join(re.escape(p) for p in parts))
    ok = np.zeros(n, bool)
    ok[[m.start() // (width + 1) for m in pattern.finditer(buf)]] = True
    return ok


def q13_numpy(tables):
    """TPC-H Q13 in numpy -> (c_count, custdist) in the query's order."""
    orders = tables["orders"]
    com = orders.column_by_name("o_comment")
    keep = ~like_numpy(com.data, com.lengths, [b"special", b"requests"])
    n_cust = tables["customer"].num_rows
    cust = _col(orders, "o_custkey")[keep]
    per_cust = np.bincount(cust, minlength=n_cust + 1)[1:]
    custdist = np.bincount(per_cust)
    c_count = np.nonzero(custdist)[0]
    dist = custdist[c_count]
    order = np.lexsort((-c_count, -dist))
    return c_count[order], dist[order]


def q22_numpy(tables):
    """TPC-H Q22 in numpy -> (cntrycode, numcust, totacctbal) by code."""
    cust = tables["customer"]
    phone = cust.column_by_name("c_phone").data
    code = (phone[:, 0].astype(np.int64) - 48) * 10 + (phone[:, 1] - 48)
    bal = _col(cust, "c_acctbal")
    in_codes = np.isin(code, [13, 31, 23, 29, 30, 18, 17])
    avg = bal[in_codes & (bal > 0.0)].mean()
    has_order = np.zeros(cust.num_rows + 1, bool)
    has_order[_col(tables["orders"], "o_custkey")] = True
    keys = _col(cust, "c_custkey")
    pick = in_codes & ~has_order[keys] & (bal > avg)
    codes = np.unique(code[pick])
    return (codes, np.array([(code[pick] == c).sum() for c in codes]),
            np.array([bal[pick][code[pick] == c].sum() for c in codes]))


def check_q13_q22(results, tables):
    c_count, dist = q13_numpy(tables)
    got = results["q13"]
    if not (np.array_equal(_col(got, "c_count"), c_count)
            and np.array_equal(_col(got, "custdist"), dist)):
        raise AssertionError(f"q13: {got.num_rows} rows differ from numpy")
    codes, num, tot = q22_numpy(tables)
    got = results["q22"]
    got_codes = [int(bytes(r)) for r in got.column_by_name("cntrycode").data
                 [:, :2]]
    rel = np.abs(_col(got, "totacctbal") - tot) / np.abs(tot)
    if not (got_codes == codes.tolist()
            and np.array_equal(_col(got, "numcust"), num)
            and rel.max(initial=0) <= REL_TOL):
        raise AssertionError(f"q22: {got_codes} {_col(got, 'numcust')} "
                             f"against numpy {codes} {num}")
    print(f"q13: {len(c_count)} rows equal numpy (LIKE '%special%requests%' "
          f"over {tables['orders'].num_rows} comments); q22: {len(codes)} "
          f"country codes equal numpy (worst relative sum error "
          f"{rel.max(initial=0):.3e})")


def dfa_device_ms(tables, device):
    """Device time of LIKE's byte DFA over the whole column Q13 and Q16
    run it on (the queries run it per partition of the same rows)."""
    import torch
    from spark_rapids_tpu_torch.ops import regex as rk
    out = {}
    for q, table, column, pattern in (
            (13, "orders", "o_comment", "%special%requests%"),
            (16, "supplier", "s_comment", "%Customer%Complaints%")):
        c = tables[table].column_by_name(column)
        data = torch.from_numpy(c.data).to(device)
        lengths = torch.from_numpy(c.lengths).to(device)
        dfa = rk.compile_dfa(rk.like_to_regex(pattern))
        ms = cuda_ms(lambda: rk.dfa_match(dfa, data, lengths), 3)
        out[q] = {"rows": int(data.shape[0]), "width": int(data.shape[1]),
                  "states": dfa.n_states, "ms": ms}
        print(f"dfa q{q} {column} LIKE {pattern!r}: rows={data.shape[0]} "
              f"width={data.shape[1]} states={dfa.n_states} device_ms="
              f"{ms:.3f}")
        del data, lengths
    torch.cuda.empty_cache()
    return out


def phase_tpch_kernels(tables, device):
    """Both kernels against their plain versions on the widest orders and
    the widest lineitem input the 22 queries' hash exchanges give the
    reorder (their pruned columns), timed and bounded there; the compact
    kernel where the reorder's output is kept. Returns (reorder numbers,
    compact numbers) as phase 7's are."""
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    picks = {}
    for q in QUERIES:
        for t, hb in query_tables(tables, q).items():
            if t in PARTITION_KEYS and (t not in picks or input_width(hb)
                                        > input_width(picks[t][1])):
                picks[t] = (q, hb)
    inputs = {f"q{q} {t}": (hb, PARTITION_KEYS[t])
              for t, (q, hb) in sorted(picks.items())}
    return check_kernels_on(inputs, device)[1:]


def phase_tpch(tables):
    """All 22 queries at the run's scale, orders and lineitem
    hash-repartitioned 8 ways, cold and warm (``run_cold_warm``); then Q18
    with dmaConsolidate on; then Q13 and Q22 against numpy. Returns
    (per-query numbers, the dma-on Q18's (reorder, compact, kept)
    launches)."""
    specs = tpch_specs(tables)
    # cold only: a warm run repeats its query (the room phase 22 needs)
    nums, results = run_cold_warm(specs, all_kept=False, warm=())
    dma18 = run_dma("q18", dict((s[0], s[1]) for s in specs)["q18"],
                    results["q18"])
    check_q13_q22(results, tables)
    return nums, dma18, results


# ------------------------------------------------------------------ phase 10
#: the TPC-DS bench subset (bench.py's TPCDS_BENCH_QUERIES), whose warm
#: geomean continues the series of earlier runs, and phase 12's queries
TPCDS_QUERIES = ("q3", "q4", "q7", "q14", "q19", "q23", "q27", "q34", "q42",
                 "q52", "q55", "q67", "q68", "q96")
SUITE_BENCH = TPCDS_QUERIES + ("bb_q5",)
#: queries whose final sort can tie (tests/test_tpcds.py's list, and
#: tests/test_tpcxbb.py's q5): their rows compare unordered
SUITE_TIES = {
    "q3", "q7", "q19", "q34", "q42", "q43", "q46", "q52", "q55", "q59",
    "q65", "q68", "q73", "q79", "q89", "q98", "q15", "q18", "q20", "q25",
    "q26", "q29", "q45", "q62", "q93", "q99", "q6", "q17", "q33", "q36",
    "q47", "q53", "q60", "q63", "q69", "q76", "q86", "q50", "q71", "q1",
    "q2", "q4", "q5", "q8", "q9", "q10", "q11", "q12", "q14", "q22", "q23",
    "q24", "q27", "q30", "q31", "q35", "q38", "q39", "q49", "q51", "q54",
    "q56", "q57", "q58", "q64", "q66", "q67", "q70", "q72", "q74", "q75",
    "q77", "q78", "q80", "q81", "q83", "q84", "q85", "q91", "q95", "bb_q5"}
#: the fact tables, hash-repartitioned 8 ways on their item keys
FACT_KEYS = {"store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
             "web_sales": "ws_item_sk"}


def tpcds_queries():
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as dq
    return sorted(dq.QUERIES, key=lambda n: int(n[1:]))


def suite_names():
    """The 99 TPC-DS queries and TPCx-BB q5 (its name here is "bb_q5")."""
    return tuple(tpcds_queries()) + ("bb_q5",)


def suite_query(q):
    """(query function, the columns it reads per table) of a suite name."""
    if q == "bb_q5":
        from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as bq
        return bq.QUERIES["q5"], bq.COLUMNS["q5"]
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as dq
    return dq.QUERIES[q], dq.COLUMNS[q]


def tpcds_columns(names):
    """The union of the columns the named TPC-DS queries read (and the fact
    tables' partition keys), per table, in table order."""
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    want = {}
    for q in names:
        for t, cols in suite_query(q)[1].items():
            want.setdefault(t, set()).update(cols)
    for t, key in FACT_KEYS.items():
        if t in want:
            want[t].add(key)
    return {t: [c for c in getattr(dd, f"{t.upper()}_COLUMNS") if c in cols]
            for t, cols in want.items()}


def suite_tables(sf, seed, names=None):
    """{"ds": the TPC-DS tables the named queries read, each with the union
    of the columns they read (and the fact tables' partition keys); by
    default all 24 tables for the 99 queries (the two no query reads,
    catalog_page and income_band, whole), "bb": the four tables TPCx-BB
    q5 reads}."""
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as bd
    cols = tpcds_columns([q for q in (names or suite_names())
                          if q != "bb_q5"])
    return {"ds": dd.gen_all(sf, seed, cols, tables=dd.TABLES if names is None
                             else [t for t in dd.TABLES if t in cols]),
            "bb": bd.gen_all(sf, seed, suite_query("bb_q5")[1])}


def suite_query_tables(tables, q):
    """The tables query ``q`` reads, each with only its columns (and the
    fact tables' partition keys)."""
    src = tables["bb" if q == "bb_q5" else "ds"]
    out = {}
    for t, names in suite_query(q)[1].items():
        key = FACT_KEYS.get(t)
        out[t] = src[t].select(names + ([key] if key and key not in names
                                        else []))
    return out


def suite_frames(sess, pruned):
    """A suite query's DataFrames over its pruned tables, the fact tables
    hash-repartitioned 8 ways."""
    dfs = {}
    for t, hb in pruned.items():
        key = FACT_KEYS.get(t)
        df = sess.create_dataframe(hb)
        dfs[t] = df.repartition(8, key) if key else df
    return dfs


def suite_specs(tables, names=None, pruned=None):
    """The suite queries (all 100 by default) as (name, build, ties,
    reads a fact table); ``pruned(q)`` gives query ``q``'s tables
    (``suite_query_tables``, made once per query)."""
    pruned = pruned or memo(lambda q: suite_query_tables(tables, q))
    return [(q, lambda sess, q=q: suite_query(q)[0](suite_frames(
        sess, pruned(q))), q in SUITE_TIES,
        any(t in FACT_KEYS for t in suite_query(q)[1]))
        for q in (names or suite_names())]


def phase_suite_check(sf, seed, refs):
    """The 99 TPC-DS queries and q5 at ``sf`` on the card against the CPU
    run (``refs``). Returns (the tables, the card's results, each query's
    pruned tables)."""
    t0 = time.perf_counter()
    tables = suite_tables(sf, seed)
    print(f"tpcds+q5 sf={sf}: tables generated in "
          f"{time.perf_counter() - t0:.2f} s")
    pruned = memo(lambda q: suite_query_tables(tables, q))
    return tables, check_against_cpu("tpcds+q5", sf, suite_specs(
        tables, pruned=pruned), refs), pruned


def phase_suite_kernels(tables, device):
    """Both kernels against their plain versions on the widest input the
    99 queries' hash exchanges give the reorder from each sales fact,
    timed and bounded there. Returns (reorder numbers, compact numbers) as
    phase 7's are."""
    picks = {}
    for q in tpcds_queries():
        for t, hb in suite_query_tables(tables, q).items():
            if t in FACT_KEYS and (t not in picks or input_width(hb)
                                   > input_width(picks[t][1])):
                picks[t] = (q, hb)
    inputs = {f"{q} {t}": (hb, FACT_KEYS[t])
              for t, (q, hb) in sorted(picks.items())}
    return check_kernels_on(inputs, device)[1:]


def release_device():
    """Drop everything a failed query left on the card."""
    import torch
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    if peek_cache() is not None:
        peek_cache().clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_suite(tables):
    """The 99 TPC-DS queries and TPCx-BB q5 at the run's scale, the fact
    tables hash-repartitioned 8 ways on their item keys, cold and warm
    (``run_cold_warm``; q72's largest joins go out of core); then q23 with
    dmaConsolidate on; then the geomean of the 14 bench queries' warm
    walls (the series of earlier runs) and of all 99 TPC-DS warm walls, on
    lines of their own. Every hash exchange must use the reorder kernel's
    output. Returns (per-query numbers, the dma-on q23's (reorder,
    compact, kept) launches, the card's warm results)."""
    specs = suite_specs(tables)
    # warm runs only for the bench subset and q5 (their warm geomean
    # continues the series):
    # the other warm runs repeat their queries
    nums, results = run_cold_warm(specs, all_kept=True,
                                  warm=set(SUITE_BENCH))
    dma23 = run_dma("q23", dict((s[0], s[1]) for s in specs)["q23"],
                    results["q23"])
    bench = [nums[q]["warm_s"] for q in TPCDS_QUERIES]
    print(json.dumps({"tpcds_warm_geomean_s": float(np.exp(np.mean(
        np.log(bench)))), "queries": len(bench)}))
    every = [nums[q]["cold_s"] for q in tpcds_queries()]
    print(json.dumps({"tpcds99_cold_geomean_s": float(np.exp(np.mean(
        np.log(every)))), "queries": len(every),
        "cold_sum_s": sum(every)}))
    return nums, dma23, results


# ------------------------------------------------------------------ phase 11
#: queries whose final sort can tie (tests/test_tpcxbb.py's list): their
#: rows compare unordered
BB_TIES = {"q5", "q7", "q9", "q11", "q14", "q16", "q17", "q21", "q22",
           "q24"}
#: the facts and their partition keys: the sales on their item keys, the
#: clickstream on the user its sessionizing windows partition on
BB_FACT_KEYS = {"store_sales": "ss_item_sk", "web_sales": "ws_item_sk",
                "web_clickstreams": "wcs_user_sk"}
#: the web_sales query run again with dmaConsolidate on
BB_DMA_QUERY = "q29"


def bb_queries():
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_queries as bq
    return sorted(bq.QUERIES, key=lambda n: int(n[1:]))


def bb_tables(sf, seed):
    """The nineteen TPCx-BB tables with the union of the columns the 30
    queries read (and the facts' partition keys)."""
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_data as bd
    from spark_rapids_tpu_torch.benchmarks.tpcxbb_queries import COLUMNS
    want = {}
    for cols in COLUMNS.values():
        for t, names in cols.items():
            want.setdefault(t, set()).update(names)
    for t, key in BB_FACT_KEYS.items():
        want[t].add(key)
    return bd.gen_all(sf, seed, {t: sorted(v) for t, v in want.items()},
                      tables=[t for t in bd.TABLES if t in want])


def bb_query_tables(tables, q):
    """The tables query ``q`` reads, each with only its columns (and a
    fact's partition key)."""
    from spark_rapids_tpu_torch.benchmarks.tpcxbb_queries import COLUMNS
    out = {}
    for t, names in COLUMNS[q].items():
        key = BB_FACT_KEYS.get(t)
        out[t] = tables[t].select(names + ([key] if key and key not in names
                                           else []))
    return out


def bb_frames(sess, pruned):
    """A TPCx-BB query's DataFrames over its pruned tables, the facts
    hash-repartitioned 8 ways."""
    dfs = {}
    for t, hb in pruned.items():
        df = sess.create_dataframe(hb)
        dfs[t] = df.repartition(8, BB_FACT_KEYS[t]) \
            if t in BB_FACT_KEYS else df
    return dfs


def bb_specs(tables):
    """The 30 queries as (name, build, ties, reads a fact)."""
    from spark_rapids_tpu_torch.benchmarks.tpcxbb_queries import (COLUMNS,
                                                                  QUERIES)
    pruned = memo(lambda q: bb_query_tables(tables, q))
    return [(q, lambda sess, q=q: QUERIES[q](bb_frames(sess, pruned(q))),
             q in BB_TIES, any(t in BB_FACT_KEYS for t in COLUMNS[q]))
            for q in bb_queries()]


def phase_bb_check(sf, seed, refs):
    t0 = time.perf_counter()
    tables = bb_tables(sf, seed)
    print(f"tpcxbb sf={sf}: tables generated in "
          f"{time.perf_counter() - t0:.2f} s")
    return tables, check_against_cpu("tpcxbb", sf, bb_specs(tables), refs)


def phase_bb_kernels(tables, device):
    """Both kernels against their plain versions on the widest input the
    30 queries' hash exchanges give the reorder from each fact
    (store_sales, web_sales, web_clickstreams, pruned to a query's
    columns), timed and bounded there; the compact kernel where the
    reorder's output is kept. Returns (reorder numbers, compact numbers)
    as phase 7's are."""
    picks = {}
    for q in bb_queries():
        for t, hb in bb_query_tables(tables, q).items():
            if t in BB_FACT_KEYS and (t not in picks or input_width(hb)
                                      > input_width(picks[t][1])):
                picks[t] = (q, hb)
    inputs = {f"{q} {t}": (hb, BB_FACT_KEYS[t])
              for t, (q, hb) in sorted(picks.items())}
    return check_kernels_on(inputs, device)[1:]


def split_dfa_ms(tables, device):
    """Device time of split(pr_review_content, "\\. ")'s span search, the
    DFA run from every byte (``dfa_find_spans``) and the greedy choice of
    spans (``regex_greedy_spans``), over the whole review column, with
    CUDA events."""
    import torch
    from spark_rapids_tpu_torch.ops import regex as rk
    c = tables["product_reviews"].column_by_name("pr_review_content")
    data = torch.from_numpy(c.data).to(device)
    lengths = torch.from_numpy(c.lengths).to(device)
    dfa = rk.compile_dfa("\\. ")
    find_ms = cuda_ms(lambda: rk.dfa_find_spans(dfa, data, lengths), 5)
    spans = rk.dfa_find_spans(dfa, data, lengths)
    greedy_ms = cuda_ms(lambda: rk.regex_greedy_spans(spans, lengths), 5)
    out = {"rows": int(data.shape[0]), "width": int(data.shape[1]),
           "states": dfa.n_states,
           "steps": rk.max_match_steps(dfa, int(data.shape[1])),
           "find_ms": find_ms, "greedy_ms": greedy_ms}
    print(f"split dfa pr_review_content '\\. ': rows={out['rows']} "
          f"width={out['width']} states={out['states']} "
          f"steps={out['steps']} find_spans_ms={find_ms:.3f} "
          f"greedy_spans_ms={greedy_ms:.3f}")
    return out


def phase_bb(tables):
    """The 30 TPCx-BB queries at the run's scale, the facts
    hash-repartitioned 8 ways, cold and warm (``run_cold_warm``); then
    ``BB_DMA_QUERY`` with dmaConsolidate on; then the geomean of the 30
    warm walls on its own line. Returns (per-query numbers, the dma-on
    run's (reorder, compact, kept) launches)."""
    specs = bb_specs(tables)
    nums, results = run_cold_warm(specs, all_kept=False)
    dma = run_dma(BB_DMA_QUERY, dict((s[0], s[1]) for s in specs)[
        BB_DMA_QUERY], results[BB_DMA_QUERY])
    warm = [nums[q]["warm_s"] for q in bb_queries()]
    print(json.dumps({"tpcxbb_warm_geomean_s": float(np.exp(np.mean(
        np.log(warm)))), "queries": len(warm)}))
    return nums, dma


# ------------------------------------------------------------------ phase 12
#: the conf that turns off every piece of the default path this slice
#: ported: the fused stages (the filter-into-aggregate fold stays, as in the
#: JAX package), the scan cache, the pipeline, the streaming collect and the
#: chunked upload
ALL_OFF = {"spark.rapids.tpu.sql.fusion.enabled": "false",
           "spark.rapids.tpu.sql.scanCache.enabled": "false",
           "spark.rapids.tpu.transfer.pipeline.enabled": "false",
           "spark.rapids.tpu.transfer.streamingCollect.enabled": "false",
           "spark.rapids.tpu.transfer.chunkRows": "0"}


def check_same_bits(name, got, want):
    """Bit for bit, row order included: validity, lengths and the bytes of
    every value (a string's bytes within its length)."""
    if got.schema.names() != want.schema.names() \
            or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows of "
                             f"{got.schema.names()} against {want.num_rows} "
                             f"of {want.schema.names()}")
    n = got.num_rows
    for f, x, y in zip(got.schema, got.columns, want.columns):
        same = np.array_equal(x.validity[:n], y.validity[:n])
        if x.lengths is not None:
            w = int(x.lengths[:n].max(initial=0))
            keep = np.arange(w)[None, :] < x.lengths[:n, None]
            same = same and np.array_equal(x.lengths[:n], y.lengths[:n]) \
                and np.array_equal(np.where(keep, x.data[:n, :w], 0),
                                   np.where(keep, y.data[:n, :w], 0))
        else:
            same = same and x.data[:n].tobytes() == y.data[:n].tobytes()
        if not same:
            raise AssertionError(f"{name}: column {f.name} differs")


def fusion_counts(plan):
    from spark_rapids_tpu_torch.plan.fusion import fusion_stats
    st = fusion_stats(plan)
    return st["fused_stages"], st["fused_ops"]


def default_vs_all_off(label, sf, specs, wants):
    """Every query of ``specs`` on the card with ALL_OFF against its
    default-conf result ``wants[name]`` (phases 9-11's check runs, made in
    a session of the same conf): equal bit for bit, in the same row
    order. Prints each query's fused stages and ops (from its default
    plan, planned again, not run). Returns the reorder launches of each
    all-off run."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    on = TpuSession(BENCH_CONF)
    off = TpuSession({**BENCH_CONF, **ALL_OFF})
    launches = {}
    totals = [0.0, 0, 0]
    for name, build, _, _ in specs:
        stages, ops = fusion_counts(build(on).physical_plan())
        got, off_s, off_n = run_query(off, name, build)[:3]
        if fusion_counts(off.last_plan) != (0, 0):
            raise AssertionError(f"{name}: the all-off plan fused a stage")
        check_same_bits(f"{label} {name} default against all-off",
                        wants[name], got)
        launches[f"phase12 {label} {name} all-off"] = off_n
        totals = [totals[0] + off_s, totals[1] + stages, totals[2] + ops]
        print(f"{label} {name} sf={sf}: rows={got.num_rows} fused_stages="
              f"{stages} fused_ops={ops} all_off_s={off_s:.4f} "
              f"reorder_launches={off_n}, bit-identical")
    print(f"{label} sf={sf} default against all-off: {len(specs)} queries "
          f"bit-identical, {totals[1]} fused stages of {totals[2]} ops, "
          f"all-off {totals[0]:.2f} s")
    return launches


def sf10_both_ways(tables, profile_dir=None):
    """Q1 and Q3 over the run's tables, orders and lineitem hash 8, and Q1
    over the plain lineitem (the port aggregates above the single-partition
    exchange, so only the plain Q1 folds its filter into the aggregate),
    with the default conf and with ALL_OFF, cold and warm, in one pass;
    the plain Q1 also with each of ALL_OFF's keys alone: walls, peak
    device memory, reorder launches and those kept, fused stages; with
    ``profile_dir`` the device busy time over the warm wall. The two ways'
    results must be equal bit for bit. Returns the reorder launches of each
    cold run."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    launches = {}
    both = (("default", BENCH_CONF), ("all-off", {**BENCH_CONF, **ALL_OFF}))
    # the plain Q1 also runs with one piece off at a time, once: which of
    # them moves the cold and the warm wall
    one_off = tuple((f"{k.split('.', 3)[3]}={v}", {**BENCH_CONF, k: v})
                    for k, v in ALL_OFF.items())
    for label, q, rep, first in (("q1", 1, True, both),
                                 ("q1 plain", 1, False,
                                  both[:1] + one_off + both[1:]),
                                 ("q3", 3, True, both)):
        pruned = query_tables(tables, q)
        results = {}
        # one pass (a second, in the reverse order, repeated every run)
        for pas, (way, conf) in [(0, w) for w in first]:

            def build(sess, q=q, rep=rep):
                return QUERIES[q](query_frames(sess, pruned, rep))
            sess = TpuSession(conf)
            if peek_cache() is not None:
                peek_cache().clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cold, cold_s, n, _, kept, plan = run_query(sess, label, build)
            warm, warm_s = run_query(sess, label, build)[:2]
            peak = torch.cuda.max_memory_allocated() / 1e9
            check_same_bits(f"{label} {way} warm against cold", warm, cold)
            stages, ops = fusion_counts(plan)
            results.setdefault(way, warm)
            check_same_bits(f"{label} {way} pass {pas} against pass 0", warm,
                            results[way])
            launches[f"phase12 {label} sf10 {way} pass {pas}"] = n
            print(f"{label} sf10 {way} pass {pas}: rows={warm.num_rows} "
                  f"cold_s={cold_s:.4f} "
                  f"warm_s={warm_s:.4f} peak_device_gb={peak:.2f} "
                  f"reorder_launches={n} launches_kept={kept} "
                  f"fused_stages={stages} fused_ops={ops}")
            if profile_dir and pas == 0 and (way, conf) in both:
                tag = f"{label}_{way}".replace(" ", "_").replace("-", "_")
                profile_device(f"phase12 {label} {way}",
                               lambda: build(sess).collect(),
                               f"{profile_dir}/phase12_{tag}.tsv", warm_s)
            del cold, plan
        for way in results:
            check_same_bits(f"{label} sf10 default against {way}",
                            results["default"], results[way])
        print(f"{label} sf10: the results of {', '.join(results)} are "
              f"bit-identical")
    return launches


def chunked_upload_check(hb, device):
    """lineitem uploaded in chunks of transfer.chunkRows (1 Mi rows, two in
    flight) and in a single shot, each on this thread and on a fresh one
    (where a PipelinedExec's producer uploads), once each: every
    chunked batch must be byte-equal to the single shot's. Prints each
    upload's wall, the host's staging time within it and the rate."""
    import threading
    import torch
    from spark_rapids_tpu_torch.columnar.transfer import upload_table
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    if peek_cache() is not None:
        peek_cache().clear()
    gc.collect()
    torch.cuda.empty_cache()
    want = upload_table(hb, device)
    nbytes = logical_bytes(want)

    def run(chunk_rows, out):
        stats = {}
        out.append((upload_table(hb, device, chunk_rows=chunk_rows,
                                 max_inflight=2, stats=stats), stats))

    for rnd in range(1):
        for way, rows in (("single", 0), ("chunked", 1 << 20)):
            for where in ("main", "thread"):
                out = []
                if where == "main":
                    run(rows, out)
                else:
                    th = threading.Thread(target=run, args=(rows, out))
                    th.start()
                    th.join()
                got, st = out[0]
                for a, b in zip(got.columns, want.columns):
                    for x, y in ((a.data, b.data), (a.validity, b.validity),
                                 (a.lengths, b.lengths)):
                        if (x is None) != (y is None) or (
                                x is not None and (x.shape != y.shape
                                                   or not torch.equal(x, y))):
                            raise AssertionError(f"the {way} upload differs "
                                                 f"from the single shot")
                del got, out
                print(f"lineitem upload {way} {where} round {rnd}: rows="
                      f"{hb.num_rows} device_gb={nbytes / 1e9:.2f} chunks="
                      f"{st['chunks']} wall_s={st['wall_s']:.4f} stage_s="
                      f"{st['stage_s']:.4f} overlap="
                      f"{st['upload_overlap_efficiency']:.3f} inflight_peak="
                      f"{st['inflight_high_water']} gb_per_s="
                      f"{nbytes / st['wall_s'] / 1e9:.2f}")
    print("lineitem upload: every chunked batch byte-equal to the single "
          "shot")


def phase_default_path(check, check_results, check_sf, bb_check_sf,
                       tables, device, profile_dir=None):
    """Phase 12: the default path against ALL_OFF on the card: every query
    of the three suites at the check scales (the TPC-DS bench subset and
    q5), bit for bit against the default runs of phases 9-11; Q1 and Q3
    over the run's tables both ways, cold and warm; one chunked and one
    single-shot upload of lineitem, byte-equal. Returns the reorder
    launches of every run."""
    launches = default_vs_all_off("tpch", check_sf,
                                  tpch_specs(check["tpch"]),
                                  check_results["tpch"])
    launches.update(default_vs_all_off("tpcds+q5", check_sf,
                                       suite_specs(check["suite"],
                                                   SUITE_BENCH),
                                       check_results["suite"]))
    launches.update(default_vs_all_off("tpcxbb", bb_check_sf,
                                       bb_specs(check["bb"]),
                                       check_results["bb"]))
    launches.update(sf10_both_ways(tables, profile_dir))
    chunked_upload_check(tables["lineitem"], device)
    return launches


# ------------------------------------------------------------------ phase 13
#: queries whose final sort can tie in tests/test_tpcds_sql.py's list; a
#: SQL text's rows compare unordered with them and with SUITE_TIES
SQL_TIES = SUITE_TIES | {
    "q19", "q27", "q34", "q42", "q46", "q52", "q55", "q65", "q68", "q73",
    "q79", "q88", "q96", "q15", "q26", "q7", "q21", "q25", "q29", "q37",
    "q82", "q90", "q92", "q93", "q50", "q62", "q99", "q3", "q43", "q48",
    "q84", "q61", "q32", "q41", "q45", "q20", "q12", "q98", "q33", "q56",
    "q60", "q6", "q67"}
#: the SQL texts run at the run's scale over phase 9's and 10's tables
SQL_AT_SCALE = (("tpch", 1), ("tpch", 3), ("tpch", 21), ("tpcds", "q3"),
                ("tpcds", "q14"), ("tpcds", "q67"))
#: one statement per function the SQL planner's table gained in this
#: slice, over the TPC-DS views (strings from customer and item, dates
#: from date_dim, numbers from store_sales); the card's result must equal
#: the CPU run's bit for bit, but pow's (two libm pows, each within an
#: ulp or two of the exact power) to POW_ULPS
FUNCTION_SQL = {
    "minus_abs": "select ss_ticket_number, ss_item_sk, -ss_quantity as nq, "
                 "abs(ss_quantity - 50) as aq, -ss_net_profit as np, "
                 "abs(ss_net_profit) as ap from store_sales where "
                 "ss_ticket_number < 20000 order by ss_ticket_number, "
                 "ss_item_sk",
    "floor_ceil_sqrt": "select ss_ticket_number, ss_item_sk, "
                       "floor(ss_sales_price) as f, ceil(ss_list_price) as "
                       "c, sqrt(ss_net_paid) as r, floor(ss_quantity) as "
                       "fq from store_sales where ss_ticket_number < 20000 "
                       "order by ss_ticket_number, ss_item_sk",
    "pow": "select ss_ticket_number, ss_item_sk, pow(ss_quantity, 2) as p2, "
           "power(ss_wholesale_cost, 0.5) as ph, pow(ss_list_price, "
           "ss_quantity / 50.0) as pq from store_sales where "
           "ss_ticket_number < 20000 order by ss_ticket_number, ss_item_sk",
    "nanvl_greatest_least": "select ss_ticket_number, ss_item_sk, "
                            "nanvl(ss_net_profit, 0.0) as nv, "
                            "greatest(ss_list_price, ss_sales_price, 50.0) "
                            "as g, least(ss_quantity, 40, ss_item_sk) as l "
                            "from store_sales where ss_ticket_number < 20000 "
                            "order by ss_ticket_number, ss_item_sk",
    "cast_by_name": "select ss_ticket_number, ss_item_sk, cast(ss_quantity "
                    "as double) as qd, cast(ss_net_profit as int) as pi, "
                    "cast(ss_item_sk as int) as ii from store_sales where "
                    "ss_ticket_number < 20000 order by ss_ticket_number, "
                    "ss_item_sk",
    "dates": "select d_date_sk, date_add(d_date, 30) as da, date_sub(d_date, "
             "400) as ds, weekday(d_date) as wd from date_dim order by "
             "d_date_sk",
    "case_length": "select c_customer_sk, upper(c_first_name) as u, "
                   "lower(c_last_name) as l, length(c_birth_country) as n, "
                   "char_length(c_salutation) as cn from customer order by "
                   "c_customer_sk",
    "trims_concat_pads": "select i_item_sk, trim(concat('  ', i_brand, ' ')) "
                         "as t, ltrim('am', i_brand) as lt, rtrim('s', "
                         "i_category) as rt, concat(i_category, '/', "
                         "i_class) as c, i_brand || '#' as p, lpad(i_class, "
                         "12, '*') as lp, rpad(i_category, 4, '-') as rp "
                         "from item order by i_item_sk",
    "locate_replace": "select i_item_sk, instr(i_item_desc, 'desc') as i, "
                      "locate('1', i_item_id, 9) as lc, replace(i_item_desc, "
                      "'item', 'it') as r from item order by i_item_sk",
    "ntile": "select ss_ticket_number, ss_item_sk, ntile(5) over (partition "
             "by ss_store_sk order by ss_ticket_number, ss_item_sk) as nt "
             "from store_sales where ss_ticket_number < 5000 order by "
             "ss_ticket_number, ss_item_sk, nt",
    "sum_distinct": "select ss_store_sk, sum(distinct ss_quantity) as sq, "
                    "sum(distinct ss_item_sk) as si from store_sales group "
                    "by ss_store_sk order by ss_store_sk",
}
POW_ULPS = 4


def view_frames(sess, tables, keys):
    """DataFrames over whole tables, the ones ``keys`` names
    hash-repartitioned 8 ways on their keys, registered as temp views."""
    dfs = {}
    for t, hb in tables.items():
        df = sess.create_dataframe(hb)
        dfs[t] = df.repartition(8, keys[t]) if t in keys else df
        dfs[t].createOrReplaceTempView(t)
    return dfs


def function_tables(sf, seed):
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    return dd.gen_all(sf, seed, tables=("date_dim", "customer", "item",
                                        "store_sales"))


def function_specs(tables):
    """The function statements as (name, build, ties, reads a fact) over
    the plain views of ``tables``."""
    return [(name, lambda sess, text=text: (view_frames(sess, tables, {}),
                                            sess.sql(text))[1], False, False)
            for name, text in FUNCTION_SQL.items()]


def check_same_bits_ulps(name, got, want, ulps):
    """``check_same_bits``, but a double may differ by ``ulps`` units in
    the last place (same validity, NaN where the other is). Returns the
    largest difference seen, in ulps."""
    import copy
    same = copy.copy(got)
    worst = 0
    for i, (x, y) in enumerate(zip(got.columns, want.columns)):
        if x.data.dtype != np.float64:
            continue
        n = got.num_rows
        a, b = x.data[:n].view(np.int64), y.data[:n].view(np.int64)
        nan = np.isnan(x.data[:n])
        apart = np.abs(a - b)
        both_nan = nan & np.isnan(y.data[:n])
        close = (apart <= ulps) | both_nan
        seen = apart[x.validity[:n] & ~both_nan]
        worst = max(worst, int(seen.max()) if seen.size else 0)
        if not close[x.validity[:n]].all():
            raise AssertionError(f"{name}: column {got.schema[i].name} "
                                 f"differs by more than {ulps} ulps")
        cols = list(same.columns)
        cols[i] = y
        same = type(got)(got.schema, tuple(cols), got.num_rows,
                         got.batch_ends)
    check_same_bits(name, same, want)
    return worst


def row_ids_unique(sess, df):
    """The row ids of the planned SQL DataFrame ``df`` (the projection
    that adds monotonically_increasing_id(), run again on its own):
    (ids, repeated ids)."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    from spark_rapids_tpu_torch.exprs import MonotonicallyIncreasingID
    from spark_rapids_tpu_torch.plan import logical as lp

    def has_id(e):
        return isinstance(e, MonotonicallyIncreasingID) or any(
            has_id(c) for c in e.children)

    def find(node):
        if isinstance(node, lp.Project) and any(has_id(e)
                                                for e in node.exprs):
            return node
        for c in node.children:
            hit = find(c)
            if hit is not None:
                return hit
        return None
    node = find(df._plan)
    if node is None:
        raise AssertionError("the plan has no row id")
    col = next(e.name for e in node.exprs if has_id(e))
    out = DataFrame(node, sess).collect()
    assert_on_device("row ids", sess)
    ids = out.column_by_name(col).data[:out.num_rows]
    return ids.shape[0], ids.shape[0] - np.unique(ids).shape[0]


def phase_sql_check(sf, seed, check_results, check_pruned, refs):
    """At ``sf`` on the card: the 22 TPC-H and the 99 TPC-DS SQL texts,
    each over its DataFrame query's pruned tables of phases 9 and 10
    registered as temp views (orders, lineitem and the three sales facts
    hash 8), each equal to that query's card result (by position;
    unordered where either reference test's sort can tie); then the
    function statements, each equal to the CPU run (``refs``) bit for bit.
    Returns the reorder launches per path."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpcds_sql import (
        SQL_QUERIES as DS_SQL)
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import (
        SQL_QUERIES as H_SQL)
    launches = {}
    for suite, texts, keys, ties, want, pruned in (
            ("tpch", H_SQL, PARTITION_KEYS, {f"q{q}" for q in TPCH_TIES},
             check_results["tpch"], check_pruned["tpch"]),
            ("tpcds", DS_SQL, FACT_KEYS, SQL_TIES, check_results["suite"],
             check_pruned["suite"])):
        sess = TpuSession(BENCH_CONF)
        total = 0.0
        for q in sorted(texts, key=lambda n: int(str(n).lstrip("q"))):
            name = f"q{q}" if suite == "tpch" else q
            got, secs, n = run_query(
                sess, f"sql {suite} {name}",
                lambda s, t=texts[q], p=pruned(q), k=keys: (
                    view_frames(s, p, k), s.sql(t))[1])[:3]
            total += secs
            check_same_result(f"sql {suite} {name} against its DataFrame "
                              f"query", got, want[name], name in ties,
                              positional=True)
            launches[f"phase13 sql {suite} {name} sf={sf}"] = n
            print(f"sql {suite} {name} sf={sf}: rows={got.num_rows} "
                  f"s={secs:.4f} reorder_launches={n}, equal to the "
                  f"DataFrame query")
        print(f"sql {suite} sf={sf}: {len(texts)} texts in {total:.2f} s, "
              f"each equal to its DataFrame query")
    specs = function_specs(function_tables(sf, seed))
    gpu = TpuSession(BENCH_CONF)
    for name, build, _, _ in specs:
        want, cpu_s = refs[name]
        got, secs = run_query(gpu, name, build)[:2]
        if name == "pow":
            worst = check_same_bits_ulps(f"function {name}", got, want,
                                         POW_ULPS)
            how = (f"within {POW_ULPS} ulps (the largest difference "
                   f"{worst} ulps) of")
        else:
            check_same_bits(f"function {name} cuda against cpu", got, want)
            how = "bit-identical to"
        print(f"sql function {name} sf={sf}: rows={got.num_rows} "
              f"cuda_s={secs:.4f} cpu_s={cpu_s:.4f}, {how} the CPU run")
    return launches


def phase_sql_at_scale(tpch_tables_sf, tpch_results, ds_tables_sf,
                       ds_results):
    """TPC-H Q1, Q3 and Q21 and TPC-DS q3, q14 and q67 by SQL at the run's
    scale, each over views of its pruned tables from phases 9 and 10
    (orders, lineitem and the sales facts hash 8), cold and warm
    (``run_cold_warm``): each must launch the reorder kernel and equal its
    DataFrame query's warm result; Q21's row ids (its non-equality
    correlation's semi/anti join) must not repeat. Returns (per-query
    numbers, the row-id count and repeats)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpcds_sql import (
        SQL_QUERIES as DS_SQL)
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import (
        SQL_QUERIES as H_SQL)
    specs, wants = [], {}
    for suite, q in SQL_AT_SCALE:
        if suite == "tpch":
            name, text, keys = f"sql tpch q{q}", H_SQL[q], PARTITION_KEYS
            pruned = query_tables(tpch_tables_sf, q)
            wants[name] = (tpch_results[f"q{q}"], q in TPCH_TIES)
        else:
            name, text, keys = f"sql tpcds {q}", DS_SQL[q], FACT_KEYS
            pruned = suite_query_tables(ds_tables_sf, q)
            wants[name] = (ds_results[q], q in SQL_TIES)
        specs.append((name, lambda sess, p=pruned, k=keys, t=text: (
            view_frames(sess, p, k), sess.sql(t))[1], wants[name][1], True))
    nums, results = run_cold_warm(specs, all_kept=False, warm=())
    for name, _, _, _ in specs:
        want, ties = wants[name]
        check_same_result(f"{name} against its DataFrame query",
                          results[name], want, ties, positional=True)
        if nums[name]["launches"] < 1:
            raise AssertionError(f"{name}: the reorder kernel did not "
                                 f"launch")
        print(f"{name}: equal to the DataFrame query's result")
    sess = TpuSession(BENCH_CONF)
    view_frames(sess, query_tables(tpch_tables_sf, 21), PARTITION_KEYS)
    n_ids, repeats = row_ids_unique(sess, sess.sql(H_SQL[21]))
    print(f"sql tpch q21 row ids: {n_ids} ids, {repeats} repeated")
    if repeats:
        raise AssertionError(f"q21: {repeats} row ids repeat")
    return nums, {"ids": n_ids, "repeated": repeats}


# ------------------------------------------------------------------ phase 14
#: the grace conf keys phase 14 drives
FORCE_KEY = "spark.rapids.tpu.memory.outOfCore.forcePartitions"
#: the forced partitions of phase 14's check-scale runs of every suite query
FORCE_CHECK = 4
FAULTS_KEY = "spark.rapids.tpu.memory.faults.plan"
#: the budget_clamp run's fraction at SF 10, and its most at any scale
CLAMP_FRACTION = 0.05
#: the runs of phase 14 at the run's scale: (label, query, conf keys);
#: Q3's two fault plans take the reactive path (a clamped budget, a failed
#: admission); the clamp's keys come from ``clamp_keys`` (None here)
OOC_AT_SCALE = (("q1 hash8 force8", ("tpch", 1), {FORCE_KEY: "8"}),
                ("q3 force8", ("tpch", 3), {FORCE_KEY: "8"}),
                ("q67 force8", ("tpcds", "q67"), {FORCE_KEY: "8"}),
                ("q3 budget_clamp", ("tpch", 3), None),
                ("q3 alloc_fail", ("tpch", 3),
                 {FAULTS_KEY: "alloc_fail:op=join,after=1"}))


def clamp_keys(build):
    """The budget_clamp fault plan sized from the query's predicted
    footprint at this run's scale (plan/footprint.py): the clamped budget
    holds a quarter of the largest working set the plan declares, so an
    operator goes out of core at any ``--sf``; never more than
    CLAMP_FRACTION, the SF-10 run's clamp. At SF 1 a fixed 0.05 of the
    card's budget held Q3's whole working set."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.plan.footprint import (
        device_budget_estimate, plan_working_set_estimate)
    sess = TpuSession(BENCH_CONF)
    ws = plan_working_set_estimate(build(sess).physical_plan())
    if not ws:
        raise AssertionError("budget_clamp: the plan declares no working set")
    budget = device_budget_estimate(sess.conf, sess.device)
    frac = min(CLAMP_FRACTION, ws / 4 / budget)
    print(f"budget_clamp: predicted working set {ws} B of a {budget} B "
          f"budget -> fraction {frac:.6g}")
    return {FAULTS_KEY: f"budget_clamp:fraction={frac:.6g}"}


def _keyed(node):
    """An operator that can go out of core: a grouped aggregate, a keyed
    join or a sort."""
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.execs.tpu_execs import (TpuHashAggregateExec,
                                                        TpuSortExec)
    return (isinstance(node, TpuSortExec)
            or (isinstance(node, TpuHashAggregateExec) and node.grouping)
            or (isinstance(node, TpuShuffledHashJoinExec)
                and node.left_keys))


#: card worker processes for phase 14's forced runs at the check scales: a
#: forced run's time goes to the host's work per partition (not to the
#: scale: halving the check scales left it at 85-89 s), so the queries run
#: in several processes at once, each on the one card, one per CPU but two
#: (their walls are taken side by side; the runs at the run's scale stay
#: alone)
FORCE_WORKERS, FORCE_THREADS = 6, 1


def forced_run(suite, sf, seed, name, want):
    """In a card worker: query ``name`` of ``suite`` (``SUITES``, its tables
    made once per worker from the same generators and seed as the card's
    check runs) with forcePartitions=FORCE_CHECK, held against its default
    run's result ``want`` (phases 9-11's check runs): equal, unordered
    (grace emits a grouped result's partitions in turn), floats within
    REL_TOL; every operator that can go out of core and ran must have
    gone, forced. Returns (rows, seconds, reorder launches, the operators
    out of core, how many, partitions made)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.memory import grace
    key = (suite, sf, seed)
    if key not in _WORKER_SPECS:
        make_tables, make_specs = SUITES[suite]
        _WORKER_SPECS[key] = {s[0]: s[1] for s in
                              make_specs(make_tables(sf, seed))}
    sess = TpuSession({**BENCH_CONF, FORCE_KEY: str(FORCE_CHECK)})
    before = grace.counters()["spill_partitions"]
    got, secs, n, _, _, plan = run_query(sess, name,
                                         _WORKER_SPECS[key][name])
    check_same_result(f"{suite} {name} forcePartitions={FORCE_CHECK} "
                      f"against the default run", got, want, True)
    keyed = [x for x in plan.walk() if _keyed(x)]
    went = [x for x in keyed if getattr(x, "grace_stats", None)]
    if bool(went) != bool(keyed) or any(
            x.grace_stats["trigger"] != "forced" for x in went):
        raise AssertionError(f"{suite} {name}: forced out of core "
                             f"{grace_summary(plan)} of {len(keyed)} "
                             f"operators that can go")
    return (got.num_rows, secs, n, grace_summary(plan), len(went),
            grace.counters()["spill_partitions"] - before)


def forced_against_default(jobs, wants, seed):
    """Every query of ``jobs`` [(label, suite, scale, names)] on the card
    with forcePartitions=FORCE_CHECK against its default run's result
    ``wants[label][name]`` (``forced_run``), in FORCE_WORKERS processes;
    the workers are gone when this returns or raises. Returns the reorder
    launches of each run."""
    import multiprocessing
    t0 = time.perf_counter()
    # the card's memory goes to the workers: this process keeps nothing of
    # its earlier runs cached there
    release_device()
    with concurrent.futures.ProcessPoolExecutor(
            FORCE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(FORCE_THREADS,)) as pool:
        futures = {(label, name): pool.submit(
            forced_run, suite, sf, seed, name, wants[label][name])
            for label, suite, sf, names in jobs for name in names}
        try:
            done = {k: f.result() for k, f in futures.items()}
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
    launches = {}
    for label, _, sf, names in jobs:
        total = ops = parts = 0
        for name in names:
            rows, secs, n, summary, went, made = done[(label, name)]
            total, ops, parts = total + secs, ops + went, parts + made
            launches[f"phase14 {label} {name} force{FORCE_CHECK}"] = n
            print(f"{label} {name} sf={sf} force{FORCE_CHECK}: rows={rows} "
                  f"s={secs:.4f} out_of_core={summary}, equal to the "
                  f"default run")
        print(f"{label} sf={sf} forcePartitions={FORCE_CHECK}: {len(names)} "
              f"queries in {total:.2f} s of their walls, {ops} operators "
              f"out of core in {parts} partitions, every result equal to "
              f"the default run")
    print(f"forced runs: {len(futures)} queries in {FORCE_WORKERS} card "
          f"workers in {time.perf_counter() - t0:.2f} s")
    return launches


def phase_out_of_core(check_results, check_sf, bb_check_sf, seed,
                      tpch_sf_tables, tpch_results, ds_sf_tables,
                      ds_results):
    """Phase 14, out-of-core: the 22 TPC-H and 30 TPCx-BB queries and the
    TPC-DS bench subset and q5 at the check scales with
    forcePartitions=FORCE_CHECK, each equal to its default
    run (``forced_against_default``, in FORCE_WORKERS processes); then at
    the run's scale Q1 hash 8, Q3 and TPC-DS q67 with forcePartitions=8,
    and Q3 with a budget_clamp and an alloc_fail fault plan, cold and warm
    (walls, peak memory, the operators out of core with their trigger,
    partitions and depth, bytes spilled per tier), each equal to its
    default run of phase 9 or 10. Returns the reorder launches per
    path."""
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    # TPC-DS forced only for the bench subset and q5: the other 85 went for
    # room (tests/test_torch_out_of_core_tpcds.py holds the same 14 on the
    # CPU)
    launches = forced_against_default(
        (("tpcds+q5", "suite", check_sf, list(SUITE_BENCH)),
         ("tpch", "tpch", check_sf, [f"q{q}" for q in QUERIES]),
         ("tpcxbb", "bb", bb_check_sf, list(bb_queries()))),
        {"tpch": check_results["tpch"], "tpcds+q5": check_results["suite"],
         "tpcxbb": check_results["bb"]}, seed)
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    for label, (suite, q), keys in OOC_AT_SCALE:
        if suite == "tpch":
            pruned = query_tables(tpch_sf_tables, q)
            want, ties = tpch_results[f"q{q}"], q in TPCH_TIES
            spec = (label, lambda sess, q=q, p=pruned: QUERIES[q](
                query_frames(sess, p)), ties, True)
        else:
            pruned = suite_query_tables(ds_sf_tables, q)
            want, ties = ds_results[q], True
            spec = (label, lambda sess, q=q, p=pruned: suite_query(q)[0](
                suite_frames(sess, p)), ties, True)
        if keys is None:
            keys = clamp_keys(spec[1])
        nums, results = run_cold_warm([spec], all_kept=False,
                                      conf={**BENCH_CONF, **keys}, warm=())
        check_same_result(f"{label} against the default run",
                          results[label], want, True)
        if not nums[label]["grace"]:
            raise AssertionError(f"{label}: no operator went out of core")
        launches[f"phase14 {label}"] = nums[label]["launches"]
        print(json.dumps({"phase14": {"run": label, **nums[label]}}))
    return launches


# ------------------------------------------------------------------ phase 15
#: the scale of q51's check on the card against the CPU: its running float
#: sum per item differed there by 4.2e-9 relative before the framed sums
#: restarted at each partition
Q51_CHECK_SF = 0.25
#: how the card's surface results are held against the CPU's: bit for bit,
#: but the variableFloatAgg sums (REL_TOL) and the libm functions (ulps)
SURFACE_FLOAT_SUMS = {"pivot"}
TRANSCENDENTAL_ULPS = 4
#: the DataFrame surface queries that read store_sales (hash 8: each must
#: launch the reorder kernel)
SURFACE_DF_FACTS = {"framed_first_last", "bitwise_math"}


def surface_tables(sf, seed):
    from spark_rapids_tpu_torch.benchmarks import sql_surface as ss
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    return dd.gen_all(sf, seed, ss.COLUMNS, tables=list(ss.COLUMNS))


def surface_specs(tables):
    """The surface queries (benchmarks/sql_surface.py) as (name, build,
    ties, reads a fact) over views of ``tables``, the sales facts hash 8
    on their item keys: the SQL texts by ``TpuSession.sql``, the
    DataFrame queries over the same frames, and the spec's q38 and q87
    with their rewrites."""
    from spark_rapids_tpu_torch import exprs as E
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window
    from spark_rapids_tpu_torch.benchmarks import sql_surface as ss

    def sql(text):
        return lambda sess: (view_frames(sess, tables, FACT_KEYS),
                             sess.sql(text))[1]
    specs = [(name, sql(text), False, "_sales" in text)
             for name, text in ss.SQL.items()]
    specs += [(name, lambda sess, b=build: b(view_frames(
        sess, tables, FACT_KEYS), F, Window, E), False,
        name in SURFACE_DF_FACTS) for name, build in ss.DATAFRAME.items()]
    for q, (spec, rewrite) in ss.SET_OPS.items():
        specs += [(f"{q} spec", sql(spec), False, True),
                  (f"{q} rewrite", sql(rewrite), False, True)]
    return specs


def surface_names():
    from spark_rapids_tpu_torch.benchmarks import sql_surface as ss
    return (list(ss.SQL) + list(ss.DATAFRAME)
            + [f"{q} {k}" for q in ss.SET_OPS for k in ("spec", "rewrite")])


def check_surface(name, label, got, want):
    """Surface query ``name``'s result on the card against the CPU's: bit
    for bit, but the float sums within REL_TOL and the libm functions
    within TRANSCENDENTAL_ULPS. Returns how it was held, for the log."""
    from spark_rapids_tpu_torch.benchmarks import sql_surface as ss
    if name in SURFACE_FLOAT_SUMS:
        worst = check_same_result(label, got, want, False)
        return f"within {worst:.3e} relative (the float-sum carve-out) of"
    if name in ss.TRANSCENDENTAL:
        worst = check_same_bits_ulps(label, got, want, TRANSCENDENTAL_ULPS)
        return (f"within {TRANSCENDENTAL_ULPS} ulps (the largest "
                f"difference {worst} ulps) of")
    check_same_bits(label, got, want)
    return "bit-identical to"


def phase_surface(check_sf, seed, refs, q51_refs, ds_sf_tables):
    """Phase 15, the expression and SQL surface: at ``check_sf`` every
    surface query on the card against the port's CPU run (``refs``), and
    q51 at Q51_CHECK_SF against its CPU run (``q51_refs``); then every
    surface query at the run's scale over phase 10's tables (the columns
    they read), cold and warm, with walls, reorder launches and peak
    memory; the spec's q38 and q87 must equal their rewrites at both
    scales. Returns (per-query numbers at the run's scale, reorder
    launches per path)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import sql_surface as ss
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    launches = {}
    gpu = TpuSession(BENCH_CONF)
    specs = surface_specs(surface_tables(check_sf, seed))
    for name, build, _, _ in specs:
        want, cpu_s = refs[name]
        got, secs, n = run_query(gpu, name, build)[:3]
        how = check_surface(name, f"surface {name} sf={check_sf} cuda "
                                  f"against cpu", got, want)
        launches[f"phase15 {name} sf={check_sf}"] = n
        print(f"surface {name} sf={check_sf}: rows={got.num_rows} "
              f"cuda_s={secs:.4f} cpu_s={cpu_s:.4f} reorder_launches={n}, "
              f"{how} the CPU run")
    q51 = check_against_cpu("q51", Q51_CHECK_SF, suite_specs(
        suite_tables(Q51_CHECK_SF, seed, ["q51"]), ["q51"]), q51_refs)
    del q51
    tables = {t: ds_sf_tables[t].select(cols)
              for t, cols in ss.COLUMNS.items()}
    nums, results = run_cold_warm(surface_specs(tables), all_kept=False,
                                  warm=())
    for q in ss.SET_OPS:
        check_same_result(f"surface {q} spec against its rewrite",
                          results[f"{q} spec"], results[f"{q} rewrite"],
                          False, positional=True)
        print(f"surface {q} spec: {result_rows(results[f'{q} spec'])} "
              f"equal to its rewrite")
    for name, n in nums.items():
        launches[f"phase15 {name}"] = n["launches"]
    return nums, launches


# ------------------------------------------------------------------ phase 17
#: phase 17's mortgage scale (500,000 loans) and its check scale
MORTGAGE_SCALE = 50.0
MORTGAGE_CHECK_SCALE = 0.5
#: the UDF fallback's scale (row at a time on the host)
UDF_FALLBACK_SF = 0.1


def charge(price, tax):
    """bench.py::_bench_udf_q1's row UDF."""
    return price * (1.0 + tax)


def udf_q1(df, compiled_udf=True):
    """bench.py::_bench_udf_q1's query: Q1's filter and grouping with the
    UDF's sum (or the same arithmetic as built-in expressions)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    price, tax = F.col("l_extendedprice"), F.col("l_tax")
    charged = (F.udf(charge, DType.DOUBLE)(price, tax) if compiled_udf
               else price * (F.lit(1.0) + tax))
    return (df.filter(F.col("l_shipdate") <= F.lit(datetime.date(1998, 9, 2)))
              .groupBy("l_returnflag", "l_linestatus")
              .agg(F.sum(charged).alias("sum_charge"),
                   F.count(F.lit(1)).alias("cnt")))


def plan_expressions(plan):
    """Every expression node held by an operator of ``plan``."""
    from spark_rapids_tpu_torch.exprs.core import Expression
    out, seen = [], set()

    def visit(v, depth):
        if isinstance(v, Expression):
            stack = [v]
            while stack:
                e = stack.pop()
                out.append(e)
                stack.extend(e.children)
        elif depth < 4 and isinstance(v, (tuple, list)):
            for x in v:
                visit(x, depth + 1)
        elif depth < 4 and hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                visit(getattr(v, name), depth + 1)

    for node in plan.walk():
        if id(node) in seen:
            continue
        seen.add(id(node))
        for v in vars(node).values():
            visit(v, 0)
    return out


def arrays_batch(arrays, schema):
    """``ml.device_arrays``'s tensors downloaded into a HostBatch."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    cols, n = [], 0
    for f in schema:
        ts = [t.cpu().numpy() for t in arrays[f.name]]
        n = ts[0].shape[0]
        cols.append(HostColumn(f.dtype, *ts))
    return HostBatch(schema, tuple(cols), n)


def _row_hashes(hb):
    """One 64-bit hash per row over every column's bytes (strings cut at
    their lengths, null values as a constant), sorted: two results hold
    the same rows exactly when these agree (vectorized, for results of
    millions of rows that ``check_same_result`` would walk in Python)."""
    n = hb.num_rows
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for c in hb.columns:
            data = np.ascontiguousarray(c.data[:n])
            if c.lengths is not None:
                data = np.where(np.arange(data.shape[1])[None, :]
                                < c.lengths[:n, None], data, 0)
            raw = data.reshape(n, -1).view(np.uint8).reshape(n, -1)
            pad = -raw.shape[1] % 8
            if pad:
                raw = np.pad(raw, ((0, 0), (0, pad)))
            words = np.ascontiguousarray(raw).view(np.uint64)
            part = np.full(n, 1469598103934665603, np.uint64)
            for j in range(words.shape[1]):
                part = (part ^ words[:, j]) * np.uint64(1099511628211)
            part = np.where(c.validity[:n].astype(bool), part,
                            np.uint64(0x9E3779B97F4A7C15))
            h = (h ^ part) * np.uint64(0xBF58476D1CE4E5B9) \
                + np.uint64(0x94D049BB133111EB)
    return np.sort(h)


def _identical(got, want):
    """The same column types and, row by row, the same validity and the
    same bytes in every valid value (``_same_positions``)."""
    return (len(got.columns) == len(want.columns)
            and all(a.data.dtype == b.data.dtype
                    and (a.lengths is None) == (b.lengths is None)
                    for a, b in zip(got.columns, want.columns))
            and _same_positions(got, want))


def _same_positions(got, want):
    """Every column equal row by row: validity, and the values of the
    valid rows (strings up to their lengths). A column whose buffers are
    equal byte for byte, null and padding bytes too, passes on one compare
    each; only the others are masked row by row."""
    n = got.num_rows
    for a, b in zip(got.columns, want.columns):
        valid = a.validity[:n].astype(bool)
        if not np.array_equal(valid, b.validity[:n].astype(bool)):
            return False
        if (a.data.shape[1:] == b.data.shape[1:]
                and a.data.dtype == b.data.dtype
                and np.array_equal(
                    np.ascontiguousarray(a.data[:n]).view(np.uint8),
                    np.ascontiguousarray(b.data[:n]).view(np.uint8))
                and (a.lengths is None
                     or np.array_equal(a.lengths[:n], b.lengths[:n]))):
            continue
        if a.lengths is not None:
            if not np.array_equal(a.lengths[:n][valid], b.lengths[:n][valid]):
                return False
            w = min(a.data.shape[1], b.data.shape[1])
            live = np.arange(w)[None, :] < a.lengths[:n, None]
            if not (np.array_equal(np.where(live, a.data[:n, :w], 0),
                                   np.where(live, b.data[:n, :w], 0))
                    and not (a.data[:n, w:] * valid[:, None]).any()
                    and not (b.data[:n, w:] * valid[:, None]).any()):
                return False
        elif not np.array_equal(a.data[:n][valid].view(np.uint8),
                                b.data[:n][valid].view(np.uint8)):
            return False
    return True


def check_same_rows(name, got, want):
    """Same schema, row count and rows, exactly: row by row (the same plan
    run twice), else as sorted row hashes."""
    if got.schema.names() != want.schema.names() or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows of "
                             f"{got.schema.names()} against {want.num_rows} "
                             f"of {want.schema.names()}")
    if _same_positions(got, want):
        return
    if not np.array_equal(_row_hashes(got), _row_hashes(want)):
        raise AssertionError(f"{name}: the rows differ")


def exchange_counts(plan):
    """(hash exchanges, kernel splits kept, sort-path splits)."""
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    hashed = [e for e in plan.walk() if isinstance(e, TpuShuffleExchangeExec)
              and isinstance(e.partitioning, HashPartitioning)]
    return (len(hashed), sum(e.kernel_splits for e in hashed),
            sum(e.sort_path_splits for e in hashed))


def phase_mortgage(seed):
    """Part 1: the mortgage ETL to ``ml.device_arrays`` at MORTGAGE_SCALE,
    plain and hash 8, cold; the arrays against ``collect()``;
    both ETL functions at MORTGAGE_CHECK_SCALE against the CPU engine.
    Returns the reorder launches per path."""
    import torch
    from spark_rapids_tpu_torch import ml
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import mortgage as mg
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    t0 = time.perf_counter()
    perf = mg.gen_performance(MORTGAGE_SCALE, seed)
    acq = mg.gen_acquisition(MORTGAGE_SCALE, seed)
    n_in = perf.num_rows + acq.num_rows
    print(f"mortgage scale={MORTGAGE_SCALE}: {acq.num_rows} loans, "
          f"{perf.num_rows} performance rows, generated in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}
    for way in ("plain", "hash8"):
        sess = TpuSession(BENCH_CONF)

        def etl():
            p = sess.create_dataframe(perf)
            if way == "hash8":
                p = p.repartition(8, "loan_id")
            return mg.clean_acquisition_prime(p, sess.create_dataframe(acq))

        if peek_cache() is not None:
            peek_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # cold only: the warm run repeated the ETL (cut for room)
        reset_launches()
        t1 = time.perf_counter()
        arrays = ml.device_arrays(etl())
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t1
        n, _ = read_launches()
        assert_on_device(f"mortgage {way}", sess)
        hashed, kept, sorted_ = exchange_counts(sess.last_plan)
        grace = grace_summary(sess.last_plan)
        peak = torch.cuda.max_memory_allocated() / 1e9
        cols = list(arrays)
        rows = arrays[cols[0]][0].shape[0]
        where = {str(t.device) for a in arrays.values() for t in a}
        if where != {str(sess.device)} or rows == 0:
            raise AssertionError(f"mortgage {way}: {rows} feature rows on "
                                 f"{where}, not {sess.device}")
        if way == "hash8" and n < 1:
            raise AssertionError("mortgage hash8 did not launch the "
                                 "reorder kernel")
        got = arrays_batch(arrays, etl().schema())
        del arrays
        want = etl().collect()
        check_same_rows(f"mortgage {way} device_arrays against collect()",
                        got, want)
        del got, want
        launches[f"phase17 mortgage {way}"] = n
        rec = {"way": way, "input_rows": n_in, "feature_rows": rows,
               "feature_columns": len(cols), "cold_s": cold_s,
               "mortgage_etl_to_ml_rows_per_sec_cold": n_in / cold_s,
               "peak_gb": peak, "out_of_core": grace,
               "reorder_launches": n, "launches_kept": kept,
               "launches_overflowed": n - kept,
               "sort_path_splits": sorted_}
        print(f"mortgage {way}: feature rows={rows} columns={len(cols)} "
              f"cold_s={cold_s:.4f} cold_rows_per_s={n_in / cold_s:.0f} "
              f"peak_device_gb={peak:.2f} "
              f"out_of_core={grace} reorder_launches={n} "
              f"launches_kept={kept} overflowed={n - kept}, device_arrays "
              f"equal to collect()")
        print(json.dumps({"phase17_mortgage": rec}))
    del perf, acq
    # both ETL functions at the check scale against the CPU engine
    perf = mg.gen_performance(MORTGAGE_CHECK_SCALE, seed)
    acq = mg.gen_acquisition(MORTGAGE_CHECK_SCALE, seed)
    cpu = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.enabled": "false"})
    gpu = TpuSession(BENCH_CONF)
    for fn in ("clean_acquisition_prime", "simple_aggregates"):
        t1 = time.perf_counter()
        want = getattr(mg, fn)(cpu.create_dataframe(perf),
                               cpu.create_dataframe(acq)).collect()
        cpu_s = time.perf_counter() - t1
        if any(not type(n).__name__.startswith("Cpu")
               for n in cpu.last_plan.walk()):
            raise AssertionError(f"{fn}: sql.enabled=false planned a "
                                 f"device operator")
        t1 = time.perf_counter()
        got = getattr(mg, fn)(gpu.create_dataframe(perf),
                              gpu.create_dataframe(acq)).collect()
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t1
        assert_on_device(f"mortgage {fn}", gpu)
        worst = check_same_result(
            f"mortgage {fn} scale={MORTGAGE_CHECK_SCALE} card against the "
            f"CPU engine", got, want, fn != "simple_aggregates")
        print(f"mortgage {fn} scale={MORTGAGE_CHECK_SCALE}: rows="
              f"{got.num_rows} cpu_engine_s={cpu_s:.4f} card_s={gpu_s:.4f} "
              f"worst_rel_err={worst:.3g}, equal to the CPU engine")
    return launches


def phase_udf(lineitem, seed):
    """Part 2: the compiled UDF Q1 at the run's scale (lineitem hash 8)
    cold and warm, bit for bit against the built-in expression; the row
    fallback at UDF_FALLBACK_SF against the compiled UDF. Returns the
    reorder launches per path."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import (BENCH_CONF,
                                                        gen_lineitem)
    from spark_rapids_tpu_torch.udf import PythonUDF
    compiled = TpuSession({**BENCH_CONF,
                           "spark.rapids.tpu.sql.udfCompiler.enabled": "true"})
    fallback = TpuSession({**BENCH_CONF,
                           "spark.rapids.tpu.sql.udfCompiler.enabled":
                               "false"})
    launches = {}

    def frame(sess, hb):
        return sess.create_dataframe(hb).repartition(8, "l_orderkey")

    walls = []
    for _ in ("cold", "warm"):
        got, secs, n, _, kept, plan = run_query(
            compiled, "udf q1 compiled", lambda s: udf_q1(frame(s, lineitem)))
        walls.append(secs)
        if any(isinstance(e, PythonUDF) for e in plan_expressions(plan)):
            raise AssertionError("udf q1: a PythonUDF is left in the plan")
    launches["phase17 udf q1 compiled"] = n
    builtin = run_query(compiled, "udf q1 built-in",
                        lambda s: udf_q1(frame(s, lineitem), False))[0]
    check_same_bits("udf q1 compiled against the built-in expression",
                    got, builtin)
    print(f"udf q1 compiled rows={lineitem.num_rows}: cold_s={walls[0]:.4f} "
          f"warm_s={walls[1]:.4f} rows_per_s={lineitem.num_rows / walls[1]:.0f}"
          f" reorder_launches={n} launches_kept={kept}, no PythonUDF in the "
          f"plan, bit-identical to the built-in expression")
    small = gen_lineitem(UDF_FALLBACK_SF, seed)
    want, comp_s = run_query(compiled, "udf q1 compiled small",
                             lambda s: udf_q1(frame(s, small)))[:2]
    got, fb_s, n_fb = run_query(fallback, "udf q1 row fallback",
                                lambda s: udf_q1(frame(s, small)),
                                on_device=False)[:3]
    torch.cuda.synchronize()
    launches["phase17 udf q1 row fallback"] = n_fb
    lines = [ln.strip() for ln in fallback.last_explain.splitlines()
             if "cannot run on TPU" in ln or "PythonUDF" in ln]
    if "!CpuHashAggregateExec cannot run on TPU" not in lines or not any(
            "PythonUDF" in ln for ln in lines):
        raise AssertionError(f"udf q1 row fallback: explain does not name "
                             f"the UDF's operator:\n{fallback.last_explain}")
    worst = check_same_result("udf q1 row fallback against the compiled UDF",
                              got, want, True)
    print(f"udf q1 sf={UDF_FALLBACK_SF} rows={small.num_rows}: compiled_s="
          f"{comp_s:.4f} row_fallback_s={fb_s:.4f} worst_rel_err={worst:.3g}"
          f", explain: {lines[:2]}")
    print(json.dumps({"phase17_udf": {
        "rows": lineitem.num_rows, "compiled_cold_s": walls[0],
        "compiled_warm_s": walls[1],
        "udf_compiled_q1_rows_per_sec": lineitem.num_rows / walls[1],
        "fallback_rows": small.num_rows, "fallback_compiled_s": comp_s,
        "row_fallback_s": fb_s}}))
    return launches


def phase_cpu_engine(check_sf, tpch_tables, pruned, tpch_wants):
    """Part 3: TPC-H Q1 and Q3 at ``check_sf`` on the CPU engine
    (sql.enabled=false) against phase 9's card results, and Q1 without
    variableFloatAgg (its aggregate on the CPU engine)."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    off = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.enabled": "false"})
    no_float = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql."
                           "variableFloatAgg.enabled": "false"})
    for sess, label, q in ((off, "sql.enabled=false", 1),
                           (off, "sql.enabled=false", 3),
                           (no_float, "variableFloatAgg=false", 1)):
        got, secs = run_query(sess, f"q{q} {label}", lambda s, q=q: QUERIES[q](
            query_frames(s, pruned(q))), on_device=False)[:2]
        host = sorted({type(n).__name__ for n in sess.last_plan.walk()
                       if type(n).__name__.startswith("Cpu")})
        if sess is no_float and "CpuHashAggregateExec" not in host:
            raise AssertionError(f"q{q} {label}: the aggregate stayed on "
                                 f"the device: {host}")
        worst = check_same_result(f"q{q} {label} sf={check_sf} against the "
                                  f"card", got, tpch_wants[f"q{q}"],
                                  q in TPCH_TIES)
        print(f"q{q} {label} sf={check_sf}: rows={got.num_rows} s={secs:.4f}"
              f" cpu_engine_ops={host} worst_rel_err={worst:.3g}, equal to "
              f"phase 9's card result")


def phase_fallback(lineitem, seed, check_sf, tpch_tables, pruned,
                   tpch_wants):
    """Phase 17. Returns the reorder launches per path."""
    t0 = time.perf_counter()
    launches = phase_mortgage(seed)
    t1 = time.perf_counter()
    launches.update(phase_udf(lineitem, seed))
    t2 = time.perf_counter()
    phase_cpu_engine(check_sf, tpch_tables, pruned, tpch_wants)
    t3 = time.perf_counter()
    print(f"phase 17 parts: mortgage {t1 - t0:.2f} s, udf {t2 - t1:.2f} s, "
          f"cpu engine {t3 - t2:.2f} s")
    return launches


# ------------------------------------------------------------------ phase 16
#: the TPC-DS queries phase 16 reads from parquet (q42, q52 and q55, which
#: took the same path over the same tables, went for room)
PARQUET_DS = ("q3",)
#: bench.py::_bench_tpch_cold's conf over the benchmark conf: no scan
#: cache, 16-byte strings
COLD_KEYS = {"spark.rapids.tpu.sql.scanCache.enabled": "false",
             "spark.rapids.tpu.sql.string.maxBytes": "16"}
PREFETCH_KEY = "spark.rapids.tpu.io.scan.prefetchBatches"
DICT_KEY = "spark.rapids.tpu.io.parquet.deviceDictDecode.enabled"
KEEP_KEY = "spark.rapids.tpu.sql.exchange.keepEncodings"
DMA_KEY = "spark.rapids.tpu.shuffle.kernel.dmaConsolidate.enabled"
#: the check scale's pushed-down filters: the check files are sorted on
#: these columns, so the filters clip row groups
Q1_SINCE = datetime.date(1995, 6, 17)
SS_SINCE = 2451000
PHASE16_BOUND_S = 180.0
#: the TPC-H lineitem columns phase 16's exchange reads from parquet: the
#: dictionary strings and doubles make the index form save over a quarter
#: of a row's exchange bytes, so the encoded split pre-empts the kernel
EXCHANGE_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice",
                    "l_discount", "l_returnflag", "l_linestatus",
                    "l_shipinstruct", "l_shipmode")


def write_parquet(hb, path, sort_by=None):
    """One table as a parquet file of 16 row groups (bench.py:1192's
    ``row_group_size = rows // 16``), written by pyarrow."""
    import pyarrow.parquet as pq
    t = hb.to_arrow()
    if sort_by:
        t = t.sort_by(sort_by)
    pq.write_table(t, path, row_group_size=max(1, t.num_rows // 16))
    return path


def parquet_files(directory, lineitem, ds_tables, tag, sort=False,
                  tpch_lineitem=None):
    """lineitem (Q1's columns and l_orderkey) and the three TPC-DS tables
    of PARQUET_DS (with the columns those queries read) as parquet files
    under ``directory``; with ``sort`` lineitem sorted by ship date and
    store_sales by sale date; with ``tpch_lineitem`` its EXCHANGE_COLUMNS
    as "exchange_lineitem". Returns {table: path}."""
    paths = {"lineitem": write_parquet(
        lineitem, os.path.join(directory, f"{tag}_lineitem.parquet"),
        "l_shipdate" if sort else None)}
    if tpch_lineitem is not None:
        paths["exchange_lineitem"] = write_parquet(
            tpch_lineitem.select(list(EXCHANGE_COLUMNS)),
            os.path.join(directory, f"{tag}_exchange_lineitem.parquet"))
    for t, names in tpcds_columns(PARQUET_DS).items():
        paths[t] = write_parquet(
            ds_tables[t].select(names),
            os.path.join(directory, f"{tag}_{t}.parquet"),
            "ss_sold_date_sk" if sort and t == "store_sales" else None)
    return paths


def parquet_ds_frames(sess, paths, q, since=None, by_name=False):
    """Query ``q``'s tables read from parquet, store_sales hash 8 on its
    item key (optionally after a pushed-down sale-date filter and an
    input_file_name() filter)."""
    from spark_rapids_tpu_torch.api import functions as F
    dfs = {}
    for t in suite_query(q)[1]:
        df = sess.read.parquet(paths[t])
        if t == "store_sales":
            if since is not None:
                df = df.filter(F.col("ss_sold_date_sk") >= since)
            if by_name:
                df = df.filter(F.input_file_name().endswith(".parquet"))
            df = df.repartition(8, FACT_KEYS[t])
        dfs[t] = df
    return dfs


def exchange_splits(plan):
    """(kernel, sort path, encoded) splits summed over a plan's hash
    exchanges."""
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    ex = [e for e in plan.walk() if isinstance(e, TpuShuffleExchangeExec)
          and isinstance(e.partitioning, HashPartitioning)]
    return (sum(e.kernel_splits for e in ex),
            sum(e.sort_path_splits for e in ex),
            sum(e.encoded_splits for e in ex))


def on_indices(plan):
    """The operators of a plan that ran on dictionary indices."""
    return [type(n).__name__ for n in plan.walk()
            if getattr(n, "encoded_batches", 0)]


def upload_rates(path, device, chunk_rows):
    """The first row group of ``path`` as the scan stages it (encoded)
    and decoded on the host: each uploaded 3 times with a synchronize,
    the best wall's rate over the bytes staged for the link. Returns
    {form: (bytes, seconds)}."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch
    from spark_rapids_tpu_torch.columnar import encoding as ce
    from spark_rapids_tpu_torch.columnar.dtypes import Schema
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.columnar.transfer import (_host_buffers,
                                                          upload_arrow,
                                                          upload_table)
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    from spark_rapids_tpu_torch.io.parquet import (_iter_file_tables,
                                                   schema_of_arrow)
    schema = schema_of_arrow(pq.read_schema(path))
    table = next(_iter_file_tables(
        PartitionedFile(path), schema, Schema([]), (), 1 << 31, 1 << 31,
        device_dict=True, device_rle=True, unifier=ce.DictionaryUnifier()))
    decoded = HostBatch.from_arrow(pa.table(
        [c.combine_chunks().cast(c.type.value_type)
         if pa.types.is_dictionary(c.type) else c for c in table.columns],
        names=table.column_names), 16)
    out = {}
    for form, up in (("encoded", lambda: upload_arrow(
                         table, device, 16, chunk_rows=chunk_rows)),
                     ("decoded", lambda: upload_table(
                         decoded, device, chunk_rows=chunk_rows))):
        best = float("inf")
        for _ in range(3):
            ce.reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        staged = (ce.counters()["encoded_bytes"] if form == "encoded" else
                  sum(a.nbytes for b in _host_buffers(decoded) for a in b))
        out[form] = (staged, best)
    return out, table.num_rows


def row_hashes(batch):
    """A 64-bit hash of every live row's bits (validity, lengths and the
    data bytes of each column, null rows as zeros), so two splits' pieces
    can be held equal as multisets of rows."""
    import torch
    n = batch.num_rows
    h = torch.zeros(n, dtype=torch.int64, device=batch.columns[0].data.device)
    for c in batch.columns:
        valid = c.validity[:n]
        words = [valid.to(torch.int64)]
        if c.lengths is not None:
            words.append(torch.where(valid, c.lengths[:n], 0).to(torch.int64))
        b = c.data[:n].reshape(n, -1).contiguous().view(torch.uint8)
        b = torch.nn.functional.pad(b * valid[:, None],
                                    (0, (-b.shape[1]) % 8))
        words.extend(b.contiguous().view(torch.int64).unbind(1))
        for w in words:
            h = h * 0x100000001B3 + w       # FNV-style, wrapping
    return h


def partition_digests(parts):
    """Per reduce partition: its sorted row hashes."""
    import torch
    return [torch.sort(torch.cat([row_hashes(b) for b in bs]))[0]
            if bs else None for bs in parts]


def exchange_encoded_against_kernel(path, device):
    """TPC-H lineitem's EXCHANGE_COLUMNS read from parquet by the device
    scan and hash-exchanged 8 ways on l_orderkey, keepEncodings on then
    off over the same batches: on, every map batch must take the encoded
    split (the indices save over a quarter of a row's bytes) and no
    reorder launch; off, every one the reorder kernel. The reduce
    partitions must hold the same rows (the kernel's consolidation orders
    a partition's rows by 8-row blocks, so rows compare as sorted hashes),
    and the encoded pieces keep their dictionaries. Returns {path:
    (reorder, compact, reorder kept, encoded splits)}."""
    import pyarrow.parquet as pq
    import torch
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.execs.base import ExecContext
    from spark_rapids_tpu_torch.execs.exchange_execs import HashPartitioning
    from spark_rapids_tpu_torch.exprs.core import (UnresolvedAttribute,
                                                   bind_expression)
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    from spark_rapids_tpu_torch.io.parquet import (TpuParquetScanExec,
                                                   schema_of_arrow)
    scan = TpuParquetScanExec((PartitionedFile(path),),
                              schema_of_arrow(pq.read_schema(path)))
    batches = list(scan.execute(ExecContext(TpuConf(BENCH_CONF), device)))
    rows = sum(b.num_rows for b in batches)
    encoded_cols = sum(c.encoding is not None and c.encoding.token is not None
                       for c in batches[0].columns)
    key = bind_expression(UnresolvedAttribute("l_orderkey"),
                          batches[0].schema)
    digests, launches = {}, {}
    for keep in ("true", "false"):
        reset_launches()
        ex, parts, secs, _ = run_exchange(
            batches, HashPartitioning(8, (key,)),
            {**BENCH_CONF, KEEP_KEY: keep}, device)
        reorder_n, compact_n = read_launches()
        splits = (ex.kernel_splits, ex.sort_path_splits, ex.encoded_splits)
        # off, a batch whose piece overflows its quota takes the sort path
        # after its launch
        if (splits[2], reorder_n, splits[0] > 0) != (
                (len(batches), 0, False) if keep == "true" else
                (0, len(batches), True)):
            raise AssertionError(
                f"lineitem exchange keepEncodings={keep}: splits "
                f"kernel/sort/encoded {splits}, {reorder_n} reorder "
                f"launches for {len(batches)} map batches")
        kept = sum(c.encoding is not None for bs in parts for b in bs
                   for c in b.columns)
        if keep == "true" and not kept:
            raise AssertionError("lineitem exchange: the encoded pieces "
                                 "lost their dictionaries")
        if sum(b.num_rows for bs in parts for b in bs) != rows:
            raise AssertionError(f"lineitem exchange keepEncodings={keep}: "
                                 f"rows lost")
        digests[keep] = partition_digests(parts)
        del parts, ex
        launches[f"phase16 lineitem exchange keepEncodings={keep}"] = (
            reorder_n, compact_n, splits[0], splits[2])
        print(f"lineitem parquet exchange hash(8, l_orderkey) keepEncodings="
              f"{keep}: rows={rows} map_batches={len(batches)} "
              f"encoded_columns={encoded_cols} s={secs:.4f} reorder_launches"
              f"={reorder_n} splits_kernel_sort_encoded={splits} "
              f"encoded_columns_out={kept}")
    for p, (a, b) in enumerate(zip(digests["true"], digests["false"])):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"lineitem exchange: partition {p}'s rows "
                                 f"differ between the encoded and the "
                                 f"kernel split")
    print("lineitem parquet exchange: the encoded split's partitions hold "
          "the kernel split's rows")
    del batches, digests
    torch.cuda.empty_cache()
    return launches


def phase_parquet(paths, q1_cold, ds_wants, check_sf, seed, directory):
    """Phase 16 (slice 12's main path): the parquet scan and the encoded
    domain. Q1 cold from lineitem.parquet with prefetchBatches 2 and 0 and
    deviceDictDecode on and off, each equal to phase 6's in-memory cold Q1;
    the upload's rates for the encoded and the decoded form of a row group;
    TPC-H lineitem's exchange from parquet with keepEncodings on (the
    encoded split) against off (the reorder kernel) over the same batches;
    TPC-DS q3, q42, q52 and q55 from parquet with store_sales hash 8 and
    keepEncodings off (q3 on too), each equal to phase 10's result, and q3
    with dmaConsolidate on (a compact launch per kept reorder output);
    then at ``check_sf`` Q1 and q3 from sorted files through a pushed-down
    filter that clips row groups and input_file_name(), against the port's
    CPU run of the same files. Returns (reorder launches, compact
    launches, reorder launches kept, encoded splits) per path."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    from spark_rapids_tpu_torch.benchmarks.tpch import (BENCH_CONF,
                                                        gen_lineitem, q1)
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.columnar import encoding as ce
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.io.parquet import TpuParquetScanExec
    from spark_rapids_tpu_torch.plan.encoded import count_encoded_domain
    t_phase = time.perf_counter()
    q1_want, inmem_s = q1_cold
    launches = {}
    walls = {}
    # the decode on, then off; the first run also starts the page-decode
    # processes (the repeats that balanced that cost went for room)
    for dict_on, depth in (("true", 2), ("true", 0), ("false", 2),
                           ("false", 0)):
        conf = {**BENCH_CONF, **COLD_KEYS, PREFETCH_KEY: str(depth),
                DICT_KEY: dict_on}
        sess = TpuSession(conf)
        gc.collect()
        torch.cuda.empty_cache()
        ce.reset_counters()
        reset_launches()
        t0 = time.perf_counter()
        res = q1(sess.read.parquet(paths["lineitem"])).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert_on_device("q1 parquet", sess)
        walls.setdefault((dict_on, depth), []).append(wall)
        c = ce.counters()
        plan = sess.last_plan
        name = (f"q1 parquet deviceDictDecode={dict_on} "
                f"prefetchBatches={depth}")
        check_same_result(f"{name} against the in-memory cold q1", res,
                          q1_want, False)
        ops = on_indices(plan)
        if dict_on == "true" and (
                c["encoded_bytes"] >= c["decoded_equivalent_bytes"]
                or not ops):
            raise AssertionError(f"{name}: the encoded path did not "
                                 f"run: {c}, on indices {ops}")
        launches[f"phase16 {name}"] = read_launches() + (0, 0)
        batches = sum(n.batches_read for n in plan.walk()
                      if isinstance(n, TpuParquetScanExec))
        print(f"{name}: cold_s={wall:.4f} in_memory_cold_s={inmem_s:.4f}"
              f" staged_gb={c['encoded_bytes'] / 1e9:.4f} "
              f"decoded_equivalent_gb="
              f"{c['decoded_equivalent_bytes'] / 1e9:.4f} "
              f"encoded_domain_operators={count_encoded_domain(plan)} "
              f"ran_on_indices={ops} scan_batches={batches}, equal to the "
              f"in-memory cold q1")
    for dict_on in ("true", "false"):
        serial, pipelined = (float(np.mean(walls[dict_on, d]))
                             for d in (0, 2))
        print(f"q1 parquet deviceDictDecode={dict_on}: serial_s/pipelined_s"
              f"={serial / pipelined:.4f} (means of {walls[dict_on, 0]} and "
              f"{walls[dict_on, 2]}" + ("; the pipelined run started the "
                                        "page-decode processes)"
                                        if dict_on == "true" else ")"))
    rates, rows = upload_rates(
        paths["lineitem"], sess.device,
        TpuConf(BENCH_CONF).get(cfg.TRANSFER_CHUNK_ROWS))
    print("q1 parquet row group upload: rows=" + str(rows) + " " + " ".join(
        f"{form}_gb={b / 1e9:.4f} {form}_s={s:.4f} "
        f"{form}_gb_per_s={b / s / 1e9:.3f}"
        for form, (b, s) in rates.items()))
    launches.update(exchange_encoded_against_kernel(
        paths["exchange_lineitem"], sess.device))
    # TPC-DS from parquet, store_sales hash 8
    ds_conf = {**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.enabled":
               "false"}
    # keepEncodings on takes the kernel as off does here (store_sales keeps
    # only int columns encoded, under the quarter rule), so a run with it
    # on would repeat q3's; the lineitem exchange above takes the encoded
    # split
    runs = [(q, "false", {}) for q in PARQUET_DS]
    runs.append(("q3", "false", {DMA_KEY: "true"}))
    for q, keep, extra in runs:
        sess = TpuSession({**ds_conf, KEEP_KEY: keep, **extra})
        reset_launches()
        t0 = time.perf_counter()
        res = suite_query(q)[0](parquet_ds_frames(sess, paths, q)).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert_on_device(f"{q} parquet", sess)
        reorder_n, compact_n = read_launches()
        kernel, sort_path, encoded = exchange_splits(sess.last_plan)
        name = f"{q} parquet keepEncodings={keep}" + (
            " dmaConsolidate" if extra else "")
        check_same_result(f"{name} against phase 10", res, ds_wants[q],
                          q in SUITE_TIES)
        if keep == "false" and reorder_n < 1:
            raise AssertionError(f"{name}: the reorder kernel did not "
                                 f"launch")
        if extra and (compact_n < 1 or compact_n != kernel):
            raise AssertionError(f"{name}: {compact_n} compact launches "
                                 f"for {kernel} kept reorder outputs")
        launches[f"phase16 {name}"] = (reorder_n, compact_n, kernel,
                                       encoded)
        print(f"{name}: rows={res.num_rows} cold_s={wall:.4f} "
              f"reorder_launches={reorder_n} launches_kept={kernel} "
              f"compact_launches={compact_n} splits_kernel_sort_encoded="
              f"{(kernel, sort_path, encoded)} encoded_domain_operators="
              f"{count_encoded_domain(sess.last_plan)} ran_on_indices="
              f"{on_indices(sess.last_plan)}, equal to phase 10")
    # the check scale against the port's CPU run of the same files
    check = parquet_files(
        directory, gen_lineitem(check_sf, seed=seed),
        dd.gen_all(check_sf, seed, tpcds_columns(PARQUET_DS),
                   tables=list(tpcds_columns(PARQUET_DS))), "check",
        sort=True)
    wide = {**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.enabled": "false"}

    def q1_check(sess):
        from spark_rapids_tpu_torch.api import functions as F
        li = (sess.read.parquet(check["lineitem"])
              .filter(F.col("l_shipdate") >= F.lit(Q1_SINCE))
              .filter(F.input_file_name().endswith(".parquet")))
        return q1(li)

    def q3_check(sess):
        return suite_query("q3")[0](parquet_ds_frames(
            sess, check, "q3", since=SS_SINCE, by_name=True))

    for name, build, table, ties in (("q1", q1_check, "lineitem", False),
                                     ("q3", q3_check, "store_sales", True)):
        t0 = time.perf_counter()
        want = build(TpuSession(wide, device="cpu")).collect()
        cpu_s = time.perf_counter() - t0
        sess = TpuSession(wide)
        t0 = time.perf_counter()
        got = build(sess).collect()
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        assert_on_device(f"{name} parquet pushdown", sess)
        scans = [n for n in sess.last_plan.walk()
                 if isinstance(n, TpuParquetScanExec)
                 and n.paths == (check[table],)]
        total = pq.ParquetFile(check[table]).metadata.num_rows
        read = sum(n.rows_read for n in scans)
        if not 0 < read < total:
            raise AssertionError(f"{name} check: the pushed-down filter "
                                 f"read {read} of {total} rows")
        worst = check_same_result(f"{name} parquet sf={check_sf} against "
                                  f"the cpu", got, want, ties)
        print(f"{name} parquet sf={check_sf} pushdown+input_file_name: "
              f"rows={got.num_rows} scanned {read} of {total} {table} rows "
              f"cuda_s={cuda_s:.4f} cpu_s={cpu_s:.4f}, equal to the CPU run "
              f"(worst relative float error {worst:.3e})")
    from spark_rapids_tpu_torch.io import page_pool
    gc.collect()                # a left scan hands its workers back
    page_pool.shutdown()        # the scans' page-decode processes
    if page_pool.live_workers():
        raise AssertionError(f"{page_pool.live_workers()} page-decode "
                             f"processes left running")
    secs = time.perf_counter() - t_phase
    print(f"phase 16 parquet: {secs:.2f} s against the bound of "
          f"{PHASE16_BOUND_S:.0f} s")
    return launches


# ------------------------------------------------------------------ phase 18
#: adaptive execution on, the benchmark conf otherwise
ADAPTIVE_KEY = "spark.rapids.tpu.sql.adaptive.enabled"
#: the skew cell: bench.py::_bench_adaptive's query at 100x its rows
SKEW_ROWS = 6_000_000
SKEW_SCALE = 100
#: the JAX bench's device pool and host spill budget, before the scale
SKEW_POOL_BYTES = 256 << 10
SKEW_HOST_BYTES = 8 << 20
#: the Catalyst fixtures phase 18 plans for the card
CATALYST_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "catalyst_fixtures")


def adaptive_counts():
    from spark_rapids_tpu_torch.plan import adaptive
    return adaptive.counters()


def reset_adaptive():
    from spark_rapids_tpu_torch.plan import adaptive
    adaptive.reset_counters()


def exchange_kept(plan):
    """Map batches the reorder kernel's output served, over every device
    exchange of ``plan`` (hash and round-robin)."""
    from spark_rapids_tpu_torch.execs.exchange_execs import \
        TpuShuffleExchangeExec
    return sum(e.kernel_splits for e in plan.walk()
               if isinstance(e, TpuShuffleExchangeExec))


def same_or_close(name, got, want, ties):
    """``got`` equal to ``want`` bit for bit (one numpy compare), else
    within ``check_same_result``'s rules (row by row in Python: seconds
    for q5's million rows), which raises when they differ. Returns the
    worst relative float error."""
    try:
        check_same_bits(name, got, want)
        return 0.0
    except AssertionError:
        return check_same_result(name, got, want, ties)


def adaptive_suite(tables, suite_nums, suite_results):
    """Phase 10's bench subset and q5 over its tables with adaptive
    execution on, cold (the warm repeats went for room): each result
    equal to phase 10's (exact but the float sums, within REL_TOL), the
    plan on the device,
    reorder launches no more than phase 10's cold run of the query (a
    stage runs once). Returns {query: numbers}."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.memory.scan_cache import peek_cache
    sess = TpuSession({**BENCH_CONF, ADAPTIVE_KEY: "true"})
    nums = {}
    for name, build, ties, _ in suite_specs(tables, SUITE_BENCH):
        if peek_cache() is not None:
            peek_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_adaptive()
        cold, cold_s, launches, _, kept, plan = run_query(sess, name, build)
        counts = adaptive_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        worst = same_or_close(f"{name} adaptive against phase 10", cold,
                              suite_results[name], ties)
        want = suite_nums[name]["launches"]
        if launches > want:
            raise AssertionError(f"{name} adaptive: {launches} reorder "
                                 f"launches against phase 10's {want}")
        tags = sorted({n.adaptive_tag.split(" ")[0] for n in plan.walk()
                       if n.adaptive_tag})
        nums[name] = {"launches": launches, "launches_kept": kept,
                      "cold_s": cold_s, **counts}
        print(f"{name} adaptive: rows={cold.num_rows} cold_s={cold_s:.4f} "
              f"phase10_cold_s={suite_nums[name]['cold_s']:.4f} "
              f"peak_device_gb={peak:.2f} "
              f"reorder_launches={launches} (phase 10: {want}) "
              f"launches_kept={kept} "
              f"coalesced_partitions={counts['coalesced_partitions']} "
              f"broadcast_switches={counts['broadcast_switches']} "
              f"skew_splits={counts['skew_splits']} "
              f"refused_stages={counts['refused_stages']} tags={tags} "
              f"equal to phase 10 (worst relative float error "
              f"{worst:.3e})")
        del cold, plan
    return nums


def skew_tables(rows, seed=20):
    """bench.py::_bench_adaptive's tables at ``rows`` fact rows: k drawn
    Zipf(1.3) capped at 1000, a 1000-row dimension; and the hot key's
    bytes at 16 bytes a row."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    z = np.minimum(rng.zipf(1.3, rows), 1000).astype(np.int64)
    fact = pa.table({"k": z, "v": np.arange(rows, dtype=np.int64)})
    dims = pa.table({"k": np.arange(1, 1001, dtype=np.int64),
                     "w": rng.integers(0, 100, 1000).astype(np.int64)})
    hot_bytes = int(float((z == 1).mean()) * rows * 16)
    return (HostBatch.from_arrow(fact, 256), HostBatch.from_arrow(dims, 256),
            hot_bytes)


def skew_confs(hot_bytes, scale):
    """(off, on): the JAX bench's confs, the device pool and the host spill
    budget scaled with the rows."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    base = {**BENCH_CONF,
            "spark.rapids.tpu.sql.scanCache.enabled": "false",
            "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1",
            "spark.rapids.tpu.memory.tpu.poolSizeBytes":
                str(SKEW_POOL_BYTES * scale),
            "spark.rapids.tpu.memory.host.spillStorageSize":
                str(SKEW_HOST_BYTES * scale)}
    on = {**base, ADAPTIVE_KEY: "true",
          "spark.rapids.tpu.sql.adaptive.skewedPartitionThreshold.bytes":
              str(hot_bytes // 4),
          "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor": "2.0",
          "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes":
              str(max(hot_bytes // 8, 4096))}
    return base, on


def skew_query(sess, fact, dims):
    from spark_rapids_tpu_torch.api import functions as F
    lt = sess.create_dataframe(fact).repartition(8).repartition(6, "k")
    rt = sess.create_dataframe(dims).repartition(3).repartition(6, "k")
    return (lt.join(rt, "k").groupBy("k")
            .agg(F.count().alias("n"), F.sum("v").alias("sv")))


def skew_cell(rows, scale):
    """The skewed join and group-by with adaptive execution off, then on,
    each run once to warm and once timed: "skew-split" in the on plan, the
    two results equal bit for bit; the walls, the spill partitions and
    recursion depth, the reorder launches and those kept, each way.
    Returns {way: numbers}."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.memory import grace
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    fact, dims, hot_bytes = skew_tables(rows)
    off_conf, on_conf = skew_confs(hot_bytes, scale)
    out, results = {}, {}
    for way, conf in (("off", off_conf), ("on", on_conf)):
        DeviceManager.shutdown()
        sess = TpuSession(conf)
        skew_query(sess, fact, dims).collect()
        grace.reset_counters()
        reset_adaptive()
        reset_launches()
        t0 = time.perf_counter()
        res = skew_query(sess, fact, dims).collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()[0]
        plan = sess.last_plan
        assert_on_device(f"skew cell {way}", sess)
        g = grace.counters()
        text = plan.tree_string()
        if way == "on" and "skew-split" not in text:
            raise AssertionError(f"skew cell: no skew split in\n{text}")
        results[way] = res
        out[way] = {"wall_s": secs, "launches": launches,
                    "launches_kept": exchange_kept(plan),
                    "spill_partitions": g["spill_partitions"],
                    "recursion_depth": g["recursion_depth_peak"],
                    **adaptive_counts()}
        tags = [n.adaptive_tag for n in plan.walk() if n.adaptive_tag]
        print(f"skew cell rows={rows} adaptive {way}: wall_s={secs:.4f} "
              f"groups={res.num_rows} spill_partitions="
              f"{g['spill_partitions']} recursion_depth="
              f"{g['recursion_depth_peak']} reorder_launches={launches} "
              f"launches_kept={out[way]['launches_kept']} tags={tags}")
        del sess, plan
    DeviceManager.shutdown()
    check_same_bits("skew cell adaptive on against off",
                    sort_by_all(results["on"]), sort_by_all(results["off"]))
    print(f"skew cell: hot key bytes={hot_bytes}, on equal to off bit for "
          f"bit, speedup_x={out['off']['wall_s'] / out['on']['wall_s']:.3f}")
    return out


def sort_by_all(hb):
    """A host batch's rows sorted on every column (k is unique here)."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    t = hb.to_arrow()
    return HostBatch.from_arrow(t.sort_by([(c, "ascending")
                                           for c in t.column_names]), 256)


def adaptive_probes():
    """bench.py::_bench_adaptive's re-fusion and broadcast-switch probes
    (at least one re-fused stage, at least one switch), then the cost
    model: with costModel.enabled a join whose observed inputs are under
    minDeviceRows runs on the CPU engine (the one operator phase 18 may
    leave there), equal to its run with the cost model off."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.api import TpuSession, functions as F
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    t7 = pa.table({"k": pa.array(np.arange(3000) % 7, type=pa.int64()),
                   "v": pa.array(np.arange(3000), type=pa.int64())})
    on = {**BENCH_CONF, ADAPTIVE_KEY: "true"}
    DeviceManager.shutdown()
    reset_adaptive()
    s_rf = TpuSession(on)
    rf = (s_rf.create_dataframe(t7).repartition(6, "k")
          .filter(F.col("v") > 10).collect())
    refused = adaptive_counts()["refused_stages"]
    assert_on_device("re-fusion probe", s_rf)
    if refused < 1 or rf.num_rows != 3000 - 11:
        raise AssertionError(f"re-fusion probe: {refused} re-fused stages, "
                             f"{rf.num_rows} rows\n"
                             f"{s_rf.last_plan.tree_string()}")
    reset_adaptive()
    s_bc = TpuSession({**on, "spark.rapids.tpu.sql.broadcastJoinThreshold."
                             "bytes": "1000"})
    lt = s_bc.create_dataframe(t7).repartition(4, "k")
    rt = (s_bc.create_dataframe(t7).filter(F.col("v") < 30)
          .repartition(3, "k"))
    bc = lt.join(rt, "k").collect()
    switches = adaptive_counts()["broadcast_switches"]
    assert_on_device("broadcast-switch probe", s_bc)
    if switches < 1:
        raise AssertionError(f"broadcast-switch probe: no switch\n"
                             f"{s_bc.last_plan.tree_string()}")

    t13 = pa.table({"k": pa.array(np.arange(20000) % 13, type=pa.int64()),
                    "v": pa.array(np.arange(20000), type=pa.int64())})

    def cost_join(sess):
        lt = (sess.create_dataframe(t13).filter(F.col("v") < 20)
              .repartition(4, "k"))
        rt = (sess.create_dataframe(t13).filter(F.col("v") < 10)
              .repartition(3, "k"))
        return lt.join(rt, "k")

    no_bc = {**on, "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1"}
    reset_adaptive()
    s_cost = TpuSession({**no_bc,
                         "spark.rapids.tpu.sql.adaptive.costModel.enabled":
                             "true",
                         "spark.rapids.tpu.sql.adaptive.costModel."
                         "minDeviceRows": "1000"})
    cost = cost_join(s_cost).collect()
    text = s_cost.last_plan.tree_string()
    host = sorted({type(n).__name__ for n in s_cost.last_plan.walk()
                   if type(n).__name__.startswith("Cpu")
                   and type(n).__name__ != "CpuLocalScanExec"})
    if host != ["CpuHashJoinExec"] or "[adaptive: placement=cpu" not in text:
        raise AssertionError(f"cost-model probe: the CPU engine ran {host}"
                             f"\n{text}")
    s_ref = TpuSession(no_bc)
    ref = cost_join(s_ref).collect()
    assert_on_device("cost-model probe reference", s_ref)
    check_same_bits("cost-model probe against the device join",
                    sort_by_all(cost), sort_by_all(ref))
    DeviceManager.shutdown()
    print(f"adaptive probes: re-fusion refused_stages={refused}; broadcast "
          f"switches={switches} rows={bc.num_rows}; cost model: the join "
          f"on the CPU engine ({cost.num_rows} rows, equal to the device "
          f"join)")
    return {"refused_stages": refused, "broadcast_switches": switches}


def catalyst_plans():
    """Load the Catalyst fixtures and plan each for the card: its tree
    (class names) equal to the same plan for the CPU device, and the
    conversions the CPU test holds against the JAX package (plan only: the
    fixtures' scans carry no files)."""
    import torch
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.plan.catalyst_import import load_plan
    from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
    conf = TpuConf({"spark.rapids.tpu.sql.enabled": "true",
                    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"})
    expect = {"smj_with_sorts": ("TpuShuffledHashJoinExec",),
              "smj_left_semi": ("TpuShuffledHashJoinExec",),
              "reused_exchange": ("TpuReusedExchangeExec",
                                  "TpuShuffleExchangeExec"),
              "aqe_stage_wrappers": ("TpuShuffleExchangeExec",),
              "broadcast_join": ("TpuBroadcastHashJoinExec",
                                 "TpuBroadcastExchangeExec"),
              "union_limit": ("TpuLimitExec", "TpuUnionExec"),
              "project_mult": ("TpuProjectExec", "TpuParquetScanExec"),
              "scan_filter_project_agg": ("TpuShuffleExchangeExec",
                                          "TpuParquetScanExec")}
    names = sorted(f[:-5] for f in os.listdir(CATALYST_FIXTURES)
                   if f.endswith(".json"))
    if sorted(expect) != names:
        raise AssertionError(f"catalyst fixtures: {names}")
    for name in names:
        with open(os.path.join(CATALYST_FIXTURES, name + ".json")) as f:
            doc = json.load(f)
        trees = []
        for dev in (torch.device("cuda", 0), torch.device("cpu")):
            plan = TpuOverrides(conf, dev).apply(load_plan(doc))
            trees.append([type(n).__name__ for n in plan.walk()])
        cuda_tree = trees[0]
        if cuda_tree != trees[1]:
            raise AssertionError(f"catalyst {name}: {cuda_tree} on the card "
                                 f"against {trees[1]}")
        missing = [c for c in expect[name] if c not in cuda_tree]
        host = [c for c in cuda_tree if c.startswith("Cpu")]
        if missing or host or (name.startswith("smj")
                               and any("Sort" in c for c in cuda_tree)):
            raise AssertionError(f"catalyst {name}: {cuda_tree}")
    print(f"catalyst fixtures: {len(names)} plans converted for the card as "
          f"for the CPU")


def phase_adaptive(suite_tables_sf, suite_nums, suite_results, sf):
    """Phase 18: adaptive execution and the coalesce (the adaptive suite
    over phase 10's tables, the skew cell, the probes) and the Catalyst
    import. Returns (the suite's numbers, the skew cell's)."""
    t0 = time.perf_counter()
    nums = adaptive_suite(suite_tables_sf, suite_nums, suite_results)
    t1 = time.perf_counter()
    rows = max(int(SKEW_ROWS * min(sf, 10.0) / 10.0), 60_000)
    cell = skew_cell(rows, max(1, round(SKEW_SCALE * rows / SKEW_ROWS)))
    t2 = time.perf_counter()
    probes = adaptive_probes()
    catalyst_plans()
    t3 = time.perf_counter()
    print(f"phase 18 adaptive: suite {t1 - t0:.2f} s, skew cell "
          f"{t2 - t1:.2f} s, probes and catalyst {t3 - t2:.2f} s")
    return nums, cell, probes


#: the suites a CPU worker runs: name -> (make tables, make specs)
SUITES = {"tpch": (tpch_tables, tpch_specs),
          "suite": (suite_tables, suite_specs),
          "bb": (bb_tables, bb_specs),
          "functions": (function_tables, function_specs),
          "surface": (surface_tables, surface_specs),
          "q51": (lambda sf, seed: suite_tables(sf, seed, ["q51"]),
                  lambda tables: suite_specs(tables, ["q51"]))}


# ------------------------------------------------------------------ phase 19
PHASE19_BOUND_S = 120.0
#: the ORC write's maxRecordsPerFile splits lineitem into this many files
ORC_FILES = 12
#: the scale of the stripe-pushdown check and of the CSV round trip
PUSHDOWN_SF = 0.5
CSV_SF = 1.0
#: free disk the phase's files need at SF 10 (~4.5 GB written), with room
FILES_FREE_BYTES = 16 << 30
#: the explain lines of a CSV write (the JAX package's reason)
CSV_WRITE_REASON = [
    "!CpuWriteFilesExec cannot run on TPU",
    "    because CSV writing does not run on TPU (no accelerated CSV "
    "writer in the reference either)"]


def check_formats():
    """Phase 19 reads and writes ORC and CSV through pyarrow: a machine
    whose pyarrow lacks either fails here, at the start, on a line of its
    own."""
    try:
        import pyarrow.csv  # noqa: F401
        import pyarrow.orc  # noqa: F401
    except ImportError as e:
        print(f"phase 19: pyarrow lacks ORC or CSV support: {e}")
        raise SystemExit(1)


def files_conf():
    """The benchmark conf with a scan cache that holds lineitem's 16
    columns at SF 10."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    return {**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.maxBytes":
            str(48 << 30)}


def orc_stripes(plan):
    """(stripes read, stripes present) over the plan's ORC scans."""
    from spark_rapids_tpu_torch.io.orc import TpuOrcScanExec
    scans = [n for n in plan.walk() if isinstance(n, TpuOrcScanExec)]
    if not scans:
        raise AssertionError(f"no ORC scan on the card: {plan.tree_string()}")
    return (sum(s.stripes_read for s in scans),
            sum(s.stripes_total for s in scans))


def run_write(sess, name, write, decoded_bytes, on_device=True):
    """One write as ``write(sess)`` -> its WriteStats, checked against the
    files on disk; prints the wall and the rate (the table's decoded arrow
    bytes over the wall). ``on_device``: the plan holds no CPU engine
    operator but the in-memory scans (the write command too)."""
    import torch
    from spark_rapids_tpu_torch.io.write_exec import (TpuWriteFilesExec,
                                                      total_output_bytes)
    t0 = time.perf_counter()
    stats = write(sess)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    plan = sess.last_plan
    if on_device:
        assert_on_device(name, sess)
        if not any(isinstance(n, TpuWriteFilesExec) for n in plan.walk()):
            raise AssertionError(f"{name}: no TpuWriteFilesExec in "
                                 f"{plan.tree_string()}")
    path = next(n for n in plan.walk() if hasattr(n, "spec")).spec.path
    files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
             if not f.startswith("_")]
    if stats.num_files != len(files) or \
            stats.num_bytes != total_output_bytes(path) or \
            stats.num_bytes <= 0 or "_temporary" in os.listdir(path) or \
            not os.path.exists(os.path.join(path, "_SUCCESS")):
        raise AssertionError(f"{name}: {stats} against {len(files)} files "
                             f"on disk: {sorted(os.listdir(path))}")
    print(f"{name}: rows={stats.num_rows} files={stats.num_files} "
          f"partitions={stats.num_partitions} bytes={stats.num_bytes} "
          f"wall_s={secs:.4f} decoded_gb={decoded_bytes / 1e9:.3f} "
          f"gb_per_s={decoded_bytes / secs / 1e9:.3f}")
    return stats, secs


def run_read(sess, name, build, want, ties=False):
    """``build(sess).collect()`` on the card, every operator on the device,
    equal to ``want`` (exact but the float sums, within REL_TOL) -> (the
    result, seconds, the plan)."""
    import torch
    t0 = time.perf_counter()
    got = build(sess).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert_on_device(name, sess)
    worst = check_same_result(name, got, want, ties)
    return got, secs, sess.last_plan, worst


def phase_files(lineitem, q1_lineitem, tpch_results, seed, sf, directory):
    """Phase 19: the file writers and the ORC and CSV scans over
    ``lineitem`` (its 16 columns); Q1's output is written from
    ``q1_lineitem`` (Q1's table of phase 6, hash 8 on its unclustered
    order keys, so the exchange keeps the reorder kernel's output).
    Returns the reorder launches of the Q1 output write {path: (launches,
    kept)}."""
    import shutil

    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import (COLUMNS,
                                                                QUERIES)
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.io import page_pool
    from spark_rapids_tpu_torch.io.write_exec import CpuWriteFilesExec
    t_phase = time.perf_counter()
    free = shutil.disk_usage(directory).free
    if free < FILES_FREE_BYTES:
        raise SystemExit(f"phase 19: {free / 1e9:.1f} GB free under "
                         f"{directory}, it needs {FILES_FREE_BYTES / 1e9:.1f}")
    release_device()
    device = torch.device("cuda", 0)
    sess = TpuSession(files_conf())
    df = sess.create_dataframe(lineitem)
    decoded = lineitem.nbytes
    rows = lineitem.num_rows
    t0 = time.perf_counter()
    df.limit(1).collect()
    torch.cuda.synchronize()
    print(f"lineitem sf={sf}: {rows} rows, {len(lineitem.schema)} columns, "
          f"{decoded / 1e9:.3f} GB decoded, into the scan cache in "
          f"{time.perf_counter() - t0:.2f} s")
    out = {k: os.path.join(directory, k) for k in (
        "orc", "parquet", "q1", "sorted_orc", "csv")}
    launches = {}

    # (a) writes at the run's scale, from the scan cache
    per_file = -(-rows // ORC_FILES)
    stats, _ = run_write(
        sess, f"write lineitem sf={sf} orc maxRecordsPerFile={per_file}",
        lambda s: df.write.mode("overwrite")
        .option("maxRecordsPerFile", per_file).orc(out["orc"]), decoded)
    if (stats.num_rows, stats.num_files, stats.num_partitions) != \
            (rows, ORC_FILES, 0):
        raise AssertionError(f"orc write: {stats}")
    flags = check_kernels_on({"q1 output lineitem hash(8, l_orderkey)":
                              (q1_lineitem, "l_orderkey")}, device)[0]
    q1_df = sess.create_dataframe(q1_lineitem)
    q1_in_memory = QUERIES[1]({"lineitem": q1_df}).collect()
    reset_launches()
    stats, _ = run_write(
        sess, f"write q1 sf={sf} over lineitem hash 8 parquet",
        lambda s: QUERIES[1]({"lineitem": q1_df.repartition(8, "l_orderkey")})
        .write.mode("overwrite").parquet(out["q1"]), q1_lineitem.nbytes)
    reorder_n, _ = read_launches()
    hashed = [e for e in sess.last_plan.walk()
              if isinstance(e, TpuShuffleExchangeExec)
              and isinstance(e.partitioning, HashPartitioning)]
    kept = sum(e.kernel_splits for e in hashed)
    if reorder_n < 1 or reorder_n != len(hashed) \
            or stats.num_rows != q1_in_memory.num_rows \
            or kept != sum(not f for f in flags):
        raise AssertionError(f"q1 write: {reorder_n} reorder launches for "
                             f"{len(hashed)} hash exchanges, {kept} kept, "
                             f"{stats}")
    launches["phase19 q1 output write hash 8"] = (reorder_n, kept)
    print(f"q1 output write: reorder_launches={reorder_n} "
          f"launches_kept={kept}")
    run_read(sess, f"q1 sf={sf} read back from its parquet output",
             lambda s: s.read.parquet(out["q1"]).sort(
                 "l_returnflag", "l_linestatus"), q1_in_memory)
    del q1_df

    # (b) read-backs at the run's scale, equal to phase 9's results
    for q in (1, 6):
        _, secs, plan, worst = run_read(
            sess, f"q{q} sf={sf} from orc",
            lambda s, q=q: QUERIES[q]({"lineitem": s.read.orc(out["orc"])}),
            tpch_results[f"q{q}"])
        read, total = orc_stripes(plan)
        print(f"q{q} sf={sf} from orc: wall_s={secs:.4f} stripes read "
              f"{read} of {total}, equal to phase 9's result (worst "
              f"relative float error {worst:.3e})")
    del df
    release_device()

    # the stripe pushdown at a smaller scale: lineitem sorted by ship date,
    # zlib-compressed (the footer reader, the reference's, reads no snappy
    # footer: a snappy file's stripes are all read, as above)
    small = td.gen_lineitem_full(PUSHDOWN_SF, seed)
    sdf = sess.create_dataframe(small)
    stats, _ = run_write(
        sess, f"write lineitem sf={PUSHDOWN_SF} orderBy(l_shipdate) orc zlib",
        lambda s: sdf.orderBy("l_shipdate").write.mode("overwrite")
        .option("maxRecordsPerFile", -(-small.num_rows // ORC_FILES))
        .option("compression", "zlib").orc(out["sorted_orc"]), small.nbytes)
    q6_cols = COLUMNS[6]["lineitem"]
    in_memory = QUERIES[6]({"lineitem": sdf}).collect()
    clipped, secs, plan, _ = run_read(
        sess, f"q6 sf={PUSHDOWN_SF} from the sorted orc",
        lambda s: QUERIES[6]({"lineitem": s.read.orc(out["sorted_orc"])}),
        in_memory)
    read, total = orc_stripes(plan)
    unclipped, u_secs, u_plan, _ = run_read(
        sess, f"q6 sf={PUSHDOWN_SF} from the sorted orc, not pushed down",
        lambda s: QUERIES[6]({"lineitem": s.read.orc(out["sorted_orc"])
                              .select(*q6_cols)}), in_memory)
    u_read, u_total = orc_stripes(u_plan)
    if not read < total or u_read != u_total or u_total != total:
        raise AssertionError(f"q6 pushdown: {read} of {total} stripes read, "
                             f"{u_read} of {u_total} without pushdown")
    check_same_result("q6 clipped against unclipped", clipped, unclipped,
                      False)
    print(f"q6 sf={PUSHDOWN_SF} from the orc sorted by l_shipdate: stripes "
          f"read {read} of {total} (unclipped {u_read} of {u_total}), "
          f"wall_s={secs:.4f} (unclipped {u_secs:.4f}), equal to the "
          f"unclipped run and to the in-memory q6")
    del small, sdf

    # (c) at CSV_SF: parquet partitioned by the Q1 keys written and read
    # back through hive discovery (at the run's scale the write and the
    # read took 48-52 s; cut for room), then CSV: the write on the CPU
    # engine (the reference's rule), the read on the card
    small = td.gen_lineitem_full(CSV_SF, seed)
    cdf = sess.create_dataframe(small)
    in_memory = QUERIES[1]({"lineitem": cdf}).collect()
    per_file = -(-small.num_rows // ORC_FILES)
    stats, _ = run_write(
        sess, f"write lineitem sf={CSV_SF} parquet partitionBy(l_returnflag, "
        f"l_linestatus) maxRecordsPerFile={per_file}",
        lambda s: cdf.write.mode("overwrite")
        .partitionBy("l_returnflag", "l_linestatus")
        .option("maxRecordsPerFile", per_file).parquet(out["parquet"]),
        small.nbytes)
    dirs = sorted(os.path.relpath(d, out["parquet"])
                  for d, _, fs in os.walk(out["parquet"])
                  if any(f.endswith(".parquet") for f in fs))
    if (stats.num_rows, stats.num_partitions, len(dirs)) != \
            (small.num_rows, 4, 4):
        raise AssertionError(f"partitioned parquet write: {stats} {dirs}")
    print(f"partition directories: {dirs}")
    _, secs, _, worst = run_read(
        sess, f"q1 sf={CSV_SF} from partitioned parquet",
        lambda s: QUERIES[1]({"lineitem": s.read.parquet(out["parquet"])}),
        in_memory)
    print(f"q1 sf={CSV_SF} from the partitioned parquet through hive "
          f"discovery: wall_s={secs:.4f}, equal to q1 in memory (worst "
          f"relative float error {worst:.3e})")
    stats, _ = run_write(
        sess, f"write lineitem sf={CSV_SF} csv (cpu engine)",
        lambda s: cdf.write.mode("overwrite").option("header", "true")
        .option("maxRecordsPerFile", -(-small.num_rows // ORC_FILES))
        .csv(out["csv"]), small.nbytes, on_device=False)
    lines = sess.last_explain.splitlines()
    if lines[:2] != CSV_WRITE_REASON or not any(
            isinstance(n, CpuWriteFilesExec) for n in sess.last_plan.walk()):
        raise AssertionError(f"csv write: {sess.last_explain}")
    print(f"csv write explain: {lines[0]} / {lines[1].strip()}")
    _, secs, _, worst = run_read(
        sess, f"q1 sf={CSV_SF} from csv",
        lambda s: QUERIES[1]({"lineitem": s.read.option("header", "true")
                              .csv(out["csv"], schema=small.schema)}),
        in_memory)
    print(f"q1 sf={CSV_SF} from csv read with lineitem's schema: "
          f"wall_s={secs:.4f}, equal to q1 in memory (worst relative float "
          f"error {worst:.3e})")
    del small, cdf, sess
    release_device()
    gc.collect()
    page_pool.shutdown()
    secs = time.perf_counter() - t_phase
    print(f"phase 19 files: {secs:.2f} s against the bound of "
          f"{PHASE19_BOUND_S:.0f} s")
    return launches


# ------------------------------------------------- where a query's memory goes
class _ExecMemory:
    """Per-operator device memory of one query run: each exec's execute()
    generator is wrapped so that every step into it is measured. A node's
    own peak is the highest ``max_memory_allocated`` reached while its own
    code ran (its children's steps excluded); its inclusive peak counts
    its children's too. Rows, batches and bytes are what it handed up."""

    def __init__(self):
        self.nodes = {}          # id(exec) -> stats dict
        self.stack = []          # frames of the steps in progress
        #: (operators in progress, live bytes by site) at the first OOM
        self.oom = None

    def wrap(self, node, gen):
        import torch
        st = self.nodes.setdefault(id(node), {
            "node": node, "rows": 0, "batches": 0, "out_bytes": 0,
            "own_peak": 0, "incl_peak": 0, "live_at_yield": 0})
        while True:
            torch.cuda.synchronize()
            if self.stack:
                # the parent's own work up to here
                parent = self.stack[-1]
                parent["own"] = max(parent["own"],
                                    torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            frame = {"own": 0, "incl": 0, "st": st}
            self.stack.append(frame)
            try:
                batch = next(gen)
            except StopIteration:
                self._leave(frame)
                return
            except BaseException as e:
                if isinstance(e, torch.cuda.OutOfMemoryError) \
                        and self.oom is None:
                    # the first frame to see it: every operator in
                    # progress still holds its tensors
                    self.oom = ([f["st"]["node"].name for f in self.stack],
                                _oom_sites(torch.cuda.memory._snapshot()))
                self._leave(frame)
                raise
            self._leave(frame)
            rows = getattr(batch, "num_rows", 0)
            st["rows"] += rows
            st["batches"] += 1
            if hasattr(batch, "device_size_bytes"):
                st["out_bytes"] += batch.device_size_bytes
            st["live_at_yield"] = max(st["live_at_yield"],
                                      torch.cuda.memory_allocated())
            yield batch

    def _leave(self, frame):
        import torch
        torch.cuda.synchronize()
        top = self.stack.pop()
        assert top is frame
        now = torch.cuda.max_memory_allocated()
        frame["own"] = max(frame["own"], now)
        frame["incl"] = max(frame["incl"], frame["own"])
        st = frame["st"]
        st["own_peak"] = max(st["own_peak"], frame["own"])
        st["incl_peak"] = max(st["incl_peak"], frame["incl"])
        torch.cuda.reset_peak_memory_stats()
        if self.stack:
            parent = self.stack[-1]
            parent["incl"] = max(parent["incl"], frame["incl"])

    def install(self):
        """Wrap every exec class's execute; returns the undo function."""
        from spark_rapids_tpu_torch.execs.base import PhysicalExec

        def subclasses(cls):
            for sc in cls.__subclasses__():
                yield sc
                yield from subclasses(sc)
        import importlib
        import pkgutil
        import spark_rapids_tpu_torch.execs as ex
        for info in pkgutil.iter_modules(ex.__path__):
            importlib.import_module(f"spark_rapids_tpu_torch.execs.{info.name}")
        saved = []
        prof = self
        for cls in set(subclasses(PhysicalExec)):
            raw = cls.__dict__.get("execute")
            if raw is None:
                continue

            def execute(self, ctx, _raw=raw):
                return prof.wrap(self, _raw(self, ctx))
            saved.append((cls, raw))
            cls.execute = execute

        def undo():
            for cls, raw in saved:
                cls.execute = raw
        return undo


# ------------------------------------------------------------------ phase 20
#: phase 20's shards on the card: BASELINE.json config 2's four v5p chips
MESH_SHARDS = 4
MESH_BOUND_S = 120.0


def mesh_conf():
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    return {**BENCH_CONF, "spark.rapids.tpu.sql.mesh.enabled": "true",
            "spark.rapids.tpu.sql.mesh.numDevices": str(MESH_SHARDS),
            "spark.rapids.tpu.sql.exec.NestedLoopJoin": "true",
            "spark.rapids.tpu.sql.exec.CartesianProduct": "true",
            ADAPTIVE_KEY: "true"}


def run_mesh_query(sess, name, build):
    """One run of ``build(sess).collect()`` on the mesh, with its checks:
    mesh operators in the plan, every shard tensor on the card, no host
    hop. -> (result, seconds, reorder launches, the printed numbers)."""
    import torch
    from spark_rapids_tpu_torch.execs import mesh_execs as me
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    mbm.reset_counters()
    del me.EXCHANGE_STATS[:]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = build(sess).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    reorder_n, _ = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    plan = sess.last_plan
    ops = [type(n).__name__ for n in plan.walk()
           if type(n).__name__.startswith("Mesh")]
    gathers = [type(n.children[0]).__name__ for n in plan.walk()
               if isinstance(n, me.MeshGatherExec)]
    seen = mbm.counters()
    exchanges = [(st["op"], st["rows"], st["recv_max"], st["recv_min"])
                 for st in me.EXCHANGE_STATS]
    print(f"mesh {name}: rows={res.num_rows} s={secs:.4f} "
          f"peak_device_gb={peak:.2f} mesh_ops={ops} gathers={gathers} "
          f"exchanges(op,rows,recv_max,recv_min)={exchanges} "
          f"host_hop_bytes={seen['host_hop_bytes']} "
          f"shard_devices={seen['shard_device_kinds']} "
          f"reorder_launches={reorder_n}")
    if not ops:
        raise AssertionError(f"mesh {name}: no mesh operator in the plan\n"
                             f"{plan.tree_string()}")
    if seen["shard_device_kinds"] != ["cuda"]:
        raise AssertionError(f"mesh {name}: shard tensors on "
                             f"{seen['shard_device_kinds']}")
    if seen["host_hop_bytes"]:
        raise AssertionError(f"mesh {name}: {seen['host_hop_bytes']} bytes "
                             f"hopped through the host")
    return res, secs, reorder_n, {"s": secs, "peak_gb": peak,
                                  "mesh_ops": ops, "gathers": gathers,
                                  "exchanges": exchanges,
                                  "host_hop_bytes": seen["host_hop_bytes"],
                                  "reorder_launches": reorder_n}


def phase_mesh(tpch_tables_sf, tpch_results, suite_tables_sf,
               suite_results):
    """Phase 20: the 22 TPC-H queries and the TPC-DS bench subset with q5
    on MESH_SHARDS shards of the card, each equal to its single-device
    card result. Returns {query: numbers}."""
    from spark_rapids_tpu_torch.api import TpuSession
    t0 = time.perf_counter()
    sess = TpuSession(mesh_conf())
    nums = {}
    runs = [("tpch", s, tpch_results) for s in tpch_specs(tpch_tables_sf)]
    runs += [("tpcds", s, suite_results)
             for s in suite_specs(suite_tables_sf, SUITE_BENCH)]
    for suite, (name, build, ties, _), wants in runs:
        label = f"{suite} {name}"
        twice = suite == "tpch" and name in ("q1", "q3")
        try:
            res, secs, launches, n = run_mesh_query(sess, label + (
                " cold" if twice else ""), build)
            if twice:
                warm, warm_s, warm_l, _ = run_mesh_query(
                    sess, label + " warm", build)
                check_same_result(f"mesh {label} warm against cold", warm,
                                  res, ties)
                n["warm_s"] = warm_s
                if launches or warm_l:
                    raise AssertionError(f"mesh {label}: {launches} and "
                                         f"{warm_l} reorder launches")
            check_same_result(f"mesh {label} against the single-device "
                              f"card run", res, wants[name], ties)
        except BaseException:
            release_device()
            raise
        nums[label] = n
    del sess
    release_device()
    total = time.perf_counter() - t0
    print(json.dumps({"mesh_shards": MESH_SHARDS, "queries": len(nums),
                      "sum_s": sum(n["s"] for n in nums.values()),
                      "peak_gb": max(n["peak_gb"] for n in nums.values()),
                      "host_hop_bytes": sum(n["host_hop_bytes"]
                                            for n in nums.values())}))
    print(f"phase 20 mesh: {total:.2f} s against a bound of "
          f"{MESH_BOUND_S:.0f} s")
    return nums


# ------------------------------------------------------------------ phase 21
#: phase 21's scale. Every aggregate, join and sort of the cluster reads one
#: partition behind a single-partition exchange (the JAX package's plan),
#: so each query moves all its rows through the network shuffle, about
#: 0.1 GB/s on the card's host: at SF 10 the phase took 306.69 s (PERF.md
#: §6) where the script's 1200 s leave it about 60 s. ``--cluster-only
#: SF`` runs the phase alone, at any scale, with every query
CLUSTER_SF = 1.0
#: 21a's queries, each input repartition(2)-ed (round robin), as
#: tests/test_cluster.py does; the script's run takes the first two
#: (CLUSTER_FLOOR), ``--cluster-only`` all of them
CLUSTER_TPCH = ("q1", "q3", "q6")
CLUSTER_TPCDS = ("q3", "q27", "q42", "q96")
#: how many of CLUSTER_TPCH and CLUSTER_TPCDS, 21b's file queries, the
#: script's phase 21 runs: Q1 and Q3 in 21a, Q1 and the wide shuffle in
#: 21b (with every query the script passes 1140 s of phases on a slow
#: host)
CLUSTER_FLOOR = {"tpch": 2, "tpcds": 0, "files": ("q1",)}
#: 21b's lineitem files (the cluster's file-scan widening spreads them over
#: the daemons) and their columns: Q1's, Q6's and the wide shuffle's
CLUSTER_FILES = 16
#: the lz4 run's rows (``--cluster-only`` only): its codec is pure Python
#: on the card's host (~1 MB/s: 20.87 s for 17.6 MB at SF 0.05, PERF.md
#: §6), so it runs the wide shuffle over the first rows of lineitem
CLUSTER_LZ4_ROWS = 50_000
CLUSTER_FILE_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_returnflag",
                        "l_linestatus", "l_shipdate")
#: each daemon's store share of the card (memory.tpu.allocFraction): two
#: daemons and the driver hold the card together
CLUSTER_DAEMON_FRACTION = 0.25
CLUSTER_KILL_PLAN = "kill_peer:owner=exec-1,req_type=data,after=2"
#: 21c's fetch timeout: how long a reader waits on the killed executor
CLUSTER_KILL_TIMEOUT_S = 3


def cluster_queries(full):
    """Phase 21's (TPC-H, TPC-DS, 21b file) queries: all of them with
    ``full``, else CLUSTER_FLOOR's."""
    if full:
        return CLUSTER_TPCH, CLUSTER_TPCDS, ("q1", "q6")
    return (CLUSTER_TPCH[:CLUSTER_FLOOR["tpch"]],
            CLUSTER_TPCDS[:CLUSTER_FLOOR["tpcds"]], CLUSTER_FLOOR["files"])


def cluster_tables(sf, seed, full):
    """Phase 21's tables at ``sf``: {"tpch": the eight TPC-H tables as
    ``tpch_tables`` makes them, "ds": the TPC-DS tables its TPC-DS
    queries (``cluster_queries(full)``) read}."""
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    tpcds = cluster_queries(full)[1]
    cols = tpcds_columns(tpcds) if tpcds else {}
    return {"tpch": tpch_tables(sf, seed),
            "ds": dd.gen_all(sf, seed, cols,
                             tables=[t for t in dd.TABLES if t in cols])
            if cols else {}}


def cluster_conf(extra=None):
    """The benchmark conf on two cluster executors, joins shuffled."""
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    return {**BENCH_CONF, "spark.rapids.tpu.sql.cluster.numExecutors": "2",
            "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "1",
            **(extra or {})}


def daemon_probes(sess, reset_peak=False):
    """Each executor daemon's ``ping`` answer -> {executor id: answer}:
    its device, peak device memory (reset after reading with
    ``reset_peak``), fetched shuffle bytes and kernel counts, all counted
    in its own process."""
    return {ex.executor_id: ex.probe(reset_peak)
            for ex in sess._cluster_scheduler.executors}


def _daemon_delta(before, after, key):
    return sum(after[e][key] - before[e][key] for e in after)


def run_cluster_query(sess, name, build, daemons=False, spread=True):
    """One cluster run of ``build(sess).collect()`` with its checks: the
    stage scheduler ran it (every map stage registered a status per task)
    and, with ``spread``, both executors did map work -> (result, printed
    numbers). The bytes fetched remotely, the kernel counts and the peak
    are this process's (in-process executors) or, with ``daemons``, the
    sums of the executor processes' own counts across the run (each
    daemon's peak since the run began; ``daemons`` in the numbers)."""
    import collections

    import torch
    from spark_rapids_tpu_torch.parallel import cluster as cl
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    reset_launches()
    mbm.reset_counters()
    cl.reset_counters()
    before = daemon_probes(sess, reset_peak=True) if daemons else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = build(sess).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sched = sess._cluster_scheduler
    stages = sched.last_stages
    maps = [st for st in stages if not st.is_result and not st.is_broadcast]
    per_exec = collections.Counter(s.executor_id for st in maps
                                   for s in st.statuses)
    peak = torch.cuda.max_memory_allocated()
    if daemons:
        after = daemon_probes(sess)
        remote = _daemon_delta(before, after, "host_hop_bytes")
        reorder_n, kept, compact_n = (
            _daemon_delta(before, after, k) for k in (
                "reorder_launches", "reorder_kept", "compact_launches"))
        peak = max([peak] + [p["peak_bytes"] for p in after.values()])
    else:
        remote = mbm.counters()["host_hop_bytes"]
        (reorder_n, compact_n), kept = read_launches(), read_kept()
    pickling = cl.counters()
    n = {"s": secs, "stages": [(("result" if st.is_result else "broadcast"
                                 if st.is_broadcast else "map"),
                                st.num_tasks) for st in stages],
         "map_tasks_per_executor": dict(sorted(per_exec.items())),
         "remote_bytes": remote,
         "remote_gb_per_s": remote / secs / 1e9,
         "pickle_s": pickling["plan_pickle_seconds"],
         "unpickle_s": pickling["plan_unpickle_seconds"],
         "reorder_launches": reorder_n, "launches_kept": kept,
         "compact_launches": compact_n, "peak_gb": peak / 1e9,
         "recompute": dict(sess.last_metrics.get("shuffle", {}))}
    if daemons:
        n["daemons"] = {e: {"device": p["device"],
                            "peak_gb": p["peak_bytes"] / 1e9}
                        for e, p in after.items()}
    print(f"cluster {name}: rows={res.num_rows} " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in n.items()))
    if "shuffle" not in sess.last_metrics or not maps:
        raise AssertionError(f"cluster {name}: the stage scheduler did not "
                             f"run the query")
    for st in maps:
        if len(st.statuses) != st.num_tasks:
            raise AssertionError(f"cluster {name}: a map stage registered "
                                 f"{len(st.statuses)} statuses for "
                                 f"{st.num_tasks} tasks")
    if spread and set(per_exec) != {"exec-0", "exec-1"}:
        raise AssertionError(f"cluster {name}: map work on "
                             f"{dict(per_exec)}, not on both executors")
    if daemons and any(not d["device"].startswith("cuda")
                       for d in n["daemons"].values()):
        raise AssertionError(f"cluster {name}: a daemon off the card: "
                             f"{n['daemons']}")
    return res, n


def rr_frames(sess, pruned, parts=2):
    """A query's DataFrames over its pruned tables, each repartition(2)-ed
    (round robin)."""
    return {t: sess.create_dataframe(hb).repartition(parts)
            for t, hb in pruned.items()}


def cluster_files(directory, lineitem):
    """Phase 21b's lineitem (CLUSTER_FILE_COLUMNS) as CLUSTER_FILES parquet
    files of consecutive rows under ``directory`` -> their directory."""
    import pyarrow.parquet as pq
    t = lineitem.select(list(CLUSTER_FILE_COLUMNS)).to_arrow()
    path = os.path.join(directory, "cluster_lineitem")
    os.makedirs(path, exist_ok=True)
    per = -(-t.num_rows // CLUSTER_FILES)
    for i in range(CLUSTER_FILES):
        pq.write_table(t.slice(i * per, per),
                       os.path.join(path, f"part-{i:05d}.parquet"))
    return path


def wide_shuffle(df):
    """21b's wide shuffle: every lineitem row moved by its order key, then
    one group per order."""
    from spark_rapids_tpu_torch.api import functions as F
    return (df.repartition(8, "l_orderkey").groupBy("l_orderkey")
            .agg(F.count("l_quantity").alias("n"),
                 F.sum("l_quantity").alias("q")))


def check_same_groups(name, got, want, key):
    """Two results of one keyed query in any row order, with numpy: the
    keys and integer columns exact, floats within REL_TOL."""
    def by_key(hb):
        cols = {f.name: c for f, c in zip(hb.schema, hb.columns)}
        order = np.argsort(cols[key].data[:hb.num_rows], kind="stable")
        return {k: (c.data[:hb.num_rows][order],
                    c.validity[:hb.num_rows][order]) for k, c in cols.items()}
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows against "
                             f"{want.num_rows}")
    g, w = by_key(got), by_key(want)
    for k in w:
        (gd, gv), (wd, wv) = g[k], w[k]
        if not np.array_equal(gv, wv):
            raise AssertionError(f"{name}: column {k}'s nulls differ")
        if wd.dtype.kind == "f":
            err = np.abs(gd - wd) / np.maximum(np.abs(wd), 1e-300)
            if (err[wv] > REL_TOL).any():
                raise AssertionError(f"{name}: column {k} off by "
                                     f"{err[wv].max()}")
        elif not np.array_equal(gd[wv], wd[wv]):
            raise AssertionError(f"{name}: column {k} differs")


def phase_cluster(tables, files_dir, seed, sf=CLUSTER_SF, full=False):
    """Phase 21: the cluster and the network shuffle on the card, at ``sf``
    over ``cluster_tables``, with ``cluster_queries(full)``'s queries. 21a:
    two in-process executors over the TCP transport run the TPC-H and
    TPC-DS queries, every input repartition(2)-ed, each equal to its
    single-device card run; Q3 again with dmaConsolidate on; with ``full``
    also the wide shuffle over CLUSTER_LZ4_ROWS rows of lineitem with the
    lz4 codec. 21b: two executor daemons on the card
    (sql.cluster.processExecutors) run the file queries and the wide
    shuffle over lineitem's CLUSTER_FILES parquet files, each equal to its
    single-device card run over the same files, the wide shuffle with the
    reorder kernel launched in the daemons. 21c: Q3 on two in-process
    executors over FaultInjectingTransport wrapping TCP, exec-1 killed
    mid-reduce: equal to the single-device run, with at least one
    recompute. Returns {path: numbers}."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.parallel.cluster import cluster_scheduler_for
    t0 = time.perf_counter()
    tpch_q, tpcds_q, file_q = cluster_queries(full)
    tpch = {q: query_tables(tables["tpch"], int(q[1:])) for q in tpch_q}
    suite = {q: suite_query_tables({"ds": tables["ds"]}, q) for q in tpcds_q}
    runs = [(f"tpch {q}", lambda s, q=q: QUERIES[int(q[1:])](rr_frames(
        s, tpch[q])), int(q[1:]) in TPCH_TIES) for q in tpch_q]
    runs += [(f"tpcds {q}", lambda s, q=q: suite_query(q)[0](rr_frames(
        s, suite[q])), q in SUITE_TIES) for q in tpcds_q]
    q3 = next(r for r in runs if r[0] == "tpch q3")
    file_runs = [
        (q, lambda s, q=q: QUERIES[int(q[1:])]({"lineitem": s.read.parquet(
            files_dir)}), None) for q in file_q]
    file_runs.append(("wide shuffle", lambda s: wide_shuffle(
        s.read.parquet(files_dir)), "l_orderkey"))
    lz4_input = (tables["tpch"]["lineitem"].select(
        ["l_orderkey", "l_quantity"]).to_arrow().slice(0, CLUSTER_LZ4_ROWS)
        if full else None)

    def lz4_build(s):
        return wide_shuffle(s.create_dataframe(lz4_input).repartition(2))

    # 21b's daemons take seconds to start (an interpreter, torch and a CUDA
    # context each): they start beside the references and 21a. The files'
    # l_orderkey and l_quantity are dictionary columns: with
    # sql.exchange.keepEncodings on, the wide shuffle's split would be the
    # encoded sort-path split (the indices save 8 of its 18 bytes a row),
    # so it is off here and the daemons split through the reorder kernel
    daemons = TpuSession(cluster_conf({
        "spark.rapids.tpu.sql.cluster.processExecutors": "true",
        "spark.rapids.tpu.sql.exchange.keepEncodings": "false",
        "spark.rapids.tpu.memory.tpu.allocFraction":
            str(CLUSTER_DAEMON_FRACTION)}))

    def start_daemons():
        t1 = time.perf_counter()
        cluster_scheduler_for(daemons)
        return time.perf_counter() - t1
    starting = concurrent.futures.ThreadPoolExecutor(1)
    try:
        started = starting.submit(start_daemons)
        nums = _cluster_runs(runs, q3, file_runs,
                             lz4_build if full else None, started, daemons,
                             seed)
    finally:
        starting.shutdown(wait=True)
        if getattr(daemons, "_cluster_scheduler", None) is not None:
            daemons._cluster_scheduler.close()
        del daemons
        release_device()
    total = time.perf_counter() - t0
    print(json.dumps({"cluster": {
        k: {f: v[f] for f in ("s", "remote_bytes", "pickle_s", "unpickle_s",
                              "reorder_launches", "launches_kept",
                              "compact_launches", "peak_gb")}
        for k, v in nums.items()}}))
    print(f"phase 21 cluster sf={sf}: {total:.2f} s")
    return nums


def _cluster_runs(runs, q3, file_runs, lz4_build, started, daemons, seed):
    """Phase 21's references, 21a, 21b and 21c (``phase_cluster``), with
    21b's ``daemons`` session starting (``started``: the future of their
    start's seconds) -> {path: numbers}."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    t0 = time.perf_counter()
    nums = {}
    tcp = "spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport"
    # the single-device card runs each cluster run is held against (the
    # round-robin repartitions launch the reorder kernel too, so not
    # through run_query's one-launch-per-hash-exchange check)
    single = TpuSession(BENCH_CONF)
    wants = {}
    try:
        for name, build, _ in runs:
            wants[name] = build(single).collect()
            assert_on_device(name, single)
        for name, build, _ in file_runs:
            wants[f"files {name}"] = build(single).collect()
        if lz4_build is not None:
            wants["wide shuffle lz4"] = lz4_build(single).collect()
    finally:
        del single
        release_device()
    print(f"cluster: single-device card runs in "
          f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as reg:
        # ---- 21a: in-process executors over TCP
        sess = TpuSession(cluster_conf({
            "spark.rapids.tpu.shuffle.transport.class": tcp,
            "spark.rapids.tpu.shuffle.tcp.registryDir":
                os.path.join(reg, "a")}))
        try:
            for name, build, ties in runs:
                res, nums[f"21a {name}"] = run_cluster_query(
                    sess, name, build)
                check_same_result(f"cluster {name} against the "
                                  f"single-device card run", res,
                                  wants[name], ties)
        finally:
            sess._cluster_scheduler.close()
            del sess
            release_device()
        dma = TpuSession(cluster_conf({
            "spark.rapids.tpu.shuffle.transport.class": tcp,
            "spark.rapids.tpu.shuffle.tcp.registryDir":
                os.path.join(reg, "dma"), DMA_KEY: "true"}))
        try:
            name, build, ties = q3
            res, n = run_cluster_query(dma, f"{name} dmaConsolidate", build)
            check_same_result(f"cluster {name} dmaConsolidate against the "
                              f"single-device card run", res, wants[name],
                              ties)
            nums[f"21a {name} dmaConsolidate"] = n
        finally:
            dma._cluster_scheduler.close()
            del dma
            release_device()
        if n["compact_launches"] < 1:
            raise AssertionError("cluster Q3 dmaConsolidate: the compact "
                                 "kernel did not launch")
        if lz4_build is not None:
            lz4 = TpuSession(cluster_conf({
                "spark.rapids.tpu.shuffle.transport.class": tcp,
                "spark.rapids.tpu.shuffle.tcp.registryDir":
                    os.path.join(reg, "lz4"),
                "spark.rapids.tpu.shuffle.compression.codec": "lz4"}))
            try:
                res, n = run_cluster_query(lz4, "wide shuffle lz4",
                                           lz4_build)
                check_same_groups("cluster wide shuffle lz4", res,
                                  wants["wide shuffle lz4"], "l_orderkey")
                nums["21a wide shuffle lz4"] = n
            finally:
                lz4._cluster_scheduler.close()
                del lz4
                release_device()
        a = [v for k, v in nums.items() if k.startswith("21a")]
        if not sum(v["remote_bytes"] for v in a):
            raise AssertionError("21a fetched no byte remotely")
        if not sum(v["launches_kept"] for v in a):
            raise AssertionError("21a kept no reorder output")

        # ---- 21b: two executor daemons on the card, from files
        t1 = time.perf_counter()
        start_s = started.result()
        print(f"cluster files: two daemons started in {start_s:.2f} s "
              f"beside the runs above, waited {time.perf_counter() - t1:.2f}"
              f" s for them")
        try:
            for label, build, key in file_runs:
                name = f"files {label}"
                res, n = run_cluster_query(daemons, name, build,
                                           daemons=True)
                if key is not None:
                    check_same_groups(f"cluster {name}", res, wants[name],
                                      key)
                else:
                    check_same_result(f"cluster {name} against the "
                                      f"single-device card run", res,
                                      wants[name], False)
                nums[f"21b {name}"] = n
        finally:
            daemons._cluster_scheduler.close()
        if nums["21b files wide shuffle"]["reorder_launches"] < 1:
            raise AssertionError("cluster files wide shuffle: the daemons "
                                 "launched no reorder")

        # ---- 21c: recovery from an executor killed mid-reduce
        killed = TpuSession(cluster_conf({
            "spark.rapids.tpu.shuffle.transport.class":
                "spark_rapids_tpu_torch.shuffle.faults."
                "FaultInjectingTransport",
            "spark.rapids.tpu.shuffle.faults.transport.class": tcp,
            "spark.rapids.tpu.shuffle.tcp.registryDir":
                os.path.join(reg, "killed"),
            "spark.rapids.tpu.shuffle.faults.plan": CLUSTER_KILL_PLAN,
            "spark.rapids.tpu.shuffle.faults.seed": str(seed),
            "spark.rapids.tpu.shuffle.maxRetries": "1",
            "spark.rapids.tpu.shuffle.retryBackoffMs": "5",
            # a killed executor's sockets stay open to the reader (ROADMAP
            # queue 3 item 11): the fetch timeout is what notices the kill
            "spark.rapids.tpu.shuffle.fetch.timeoutSeconds": str(
                CLUSTER_KILL_TIMEOUT_S)}))
        try:
            name, build, ties = q3
            # the kill moves the dead executor's map work to the survivor
            res, n = run_cluster_query(
                killed, f"{name} {CLUSTER_KILL_PLAN}", build, spread=False)
            check_same_result(f"cluster {name} after the kill against the "
                              f"single-device card run", res, wants[name],
                              ties)
            sched = killed._cluster_scheduler
            n["dead"] = [ex.executor_id for ex in sched.executors
                         if not sched._executor_alive(ex)]
            print(f"cluster {name} recovery: recompute counters "
                  f"{n['recompute']} dead={n['dead']}")
            if n["recompute"].get("shuffle.recomputes", 0) < 1:
                raise AssertionError("21c: no recompute after the kill")
            nums[f"21c {name} kill_peer"] = n
        finally:
            killed._cluster_scheduler.close()
            del killed
            release_device()
    return nums


def cluster_only(sf, seed):
    """Phase 21 alone at ``sf``, with every query (``cluster_queries(True)``)
    and the lz4 run: its tables and files made here, then
    ``phase_cluster``. Prints no result line."""
    t0 = time.perf_counter()
    build_kernels()
    tables = cluster_tables(sf, seed, True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as d:
        files = cluster_files(d, tables["tpch"]["lineitem"])
        print(f"cluster sf={sf}: kernels, tables and files in "
              f"{time.perf_counter() - t0:.2f} s")
        phase_cluster(tables, files, seed, sf, full=True)
    print(f"cluster only sf={sf}: {time.perf_counter() - t0:.2f} s")


def _oom_sites(snapshot, top=12):
    """Live device bytes of a memory snapshot grouped by the innermost
    port frame that allocated them."""
    sites = {}
    for seg in snapshot.get("segments", ()):
        for blk in seg.get("blocks", ()):
            if blk.get("state") != "active_allocated":
                continue
            frames = blk.get("frames") or (blk.get("history") or [{}])[-1] \
                .get("frames", [])
            site = "unknown"
            for fr in frames:
                fn = fr.get("filename", "")
                if "spark_rapids_tpu_torch" in fn:
                    site = (fn.split("spark_rapids_tpu_torch/")[-1]
                            + f":{fr.get('line')} {fr.get('name')}")
                    break
            sites[site] = sites.get(site, 0) + blk.get("size", 0)
    return sorted(sites.items(), key=lambda kv: -kv[1])[:top]


def memory_profile(queries, scales, seed):
    """Each of ``queries`` (suite names) alone, cold, at each of
    ``scales``, the fact tables hash 8 as in phase 10, with every
    operator's device memory measured (``_ExecMemory``); on an
    out-of-memory error, the live bytes grouped by allocation site and the
    operators whose steps were in progress. Prints one line per operator
    and a JSON line per run."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    budget = None
    for sf in scales:
        tables = suite_tables(sf, seed, list(queries))
        for name, build, _, _ in suite_specs(tables, list(queries)):
            # no producer threads: the steps are measured on one stack
            sess = TpuSession({**BENCH_CONF,
                               "spark.rapids.tpu.transfer.pipeline.enabled":
                                   "false"})
            release_device()
            torch.cuda.reset_peak_memory_stats()
            prof = _ExecMemory()
            undo = prof.install()
            torch.cuda.memory._record_memory_history(max_entries=200000)
            oom, sites, inflight = None, [], []
            spill0 = spilled_bytes()
            t0 = time.perf_counter()
            try:
                df = build(sess)
                df.collect()
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0]
                inflight, sites = prof.oom or ([], _oom_sites(
                    torch.cuda.memory._snapshot()))
                prof.stack.clear()
            finally:
                torch.cuda.memory._record_memory_history(enabled=None)
                undo()
            secs = time.perf_counter() - t0
            from spark_rapids_tpu_torch.memory.device_manager import \
                DeviceManager
            dm = DeviceManager.peek()
            budget = dm.device_budget if dm is not None else budget
            plan = sess.last_plan
            order = {id(n): i for i, n in enumerate(plan.walk())} \
                if plan is not None else {}
            rows = sorted(prof.nodes.values(),
                          key=lambda s: order.get(id(s["node"]), 1 << 30))
            for st in rows:
                n = st["node"]
                kids = [prof.nodes.get(id(c)) for c in n.children]
                staged = sum(k["out_bytes"] for k in kids if k)
                est = None
                sizes = [c.size_estimate() for c in n.children]
                if n.children and all(s is not None for s in sizes):
                    est = 3 * sum(sizes)
                depth = 0
                if plan is not None:
                    for path_node, d in _depths(plan):
                        if path_node is n:
                            depth = d
                print(f"{name} sf={sf} {'  ' * depth}{n.name}: "
                      f"rows={st['rows']} batches={st['batches']} "
                      f"out_gb={st['out_bytes'] / 1e9:.3f} "
                      f"own_peak_gb={st['own_peak'] / 1e9:.2f} "
                      f"incl_peak_gb={st['incl_peak'] / 1e9:.2f} "
                      f"staged_input_x3_gb={3 * staged / 1e9:.2f} "
                      f"static_3x_estimate_gb="
                      f"{'None' if est is None else f'{est / 1e9:.2f}'}")
            peak = max((s["incl_peak"] for s in rows), default=0)
            top = max(rows, key=lambda s: s["own_peak"], default=None)
            print(json.dumps({"memory_profile": {
                "query": name, "sf": sf, "seconds": secs,
                "peak_gb": peak / 1e9, "oom": oom,
                "out_of_core": grace_summary(plan),
                "spilled_gb": spilled_since(spill0),
                "budget_gb": None if budget is None else budget / 1e9,
                "grace_threshold_gb": None if budget is None
                else 0.8 * budget / 1e9,
                "peak_operator": None if top is None else top["node"].name,
                "in_flight_at_oom": inflight,
                "live_gb_by_site_at_oom": [(s, b / 1e9) for s, b in sites]}}))
            del prof, rows, plan, sess
            release_device()
        del tables


def _unaligned_segment_sum(contrib, seg_ids, num_segments,
                           ids_sorted=False):
    """ops/batch_kernels.py's ``segment_sum`` with its segments as they lie
    (one ``torch.segment_reduce``, no aligned layout): the yardstick
    ``segment_sum_cost`` holds the shipped sum against."""
    import torch
    if not contrib.is_floating_point() or contrib.device.type == "cpu":
        return contrib.new_zeros(num_segments).index_add_(0, seg_ids, contrib)
    if not ids_sorted:
        order = torch.sort(seg_ids, stable=True).indices
        seg_ids, contrib = seg_ids[order], contrib[order]
    lengths = torch.bincount(seg_ids, minlength=num_segments)
    return torch.segment_reduce(contrib, "sum", lengths=lengths, unsafe=True)


def segment_sum_cost(sf, seed, reps=20):
    """What the aligned layout of the GPU float segment sums costs
    (``segment_sum``, whose segments start on a 32-byte boundary so that a
    group sums to the same bits wherever its rows sit): the 30 TPCx-BB and
    the 14 TPC-DS bench queries at ``sf``, each cold, then warm with the
    shipped sum and the unaligned one in turns (aligned, unaligned,
    unaligned, aligned), in one process over the same tables; the
    (rows, segments, dtype) shapes the aligned runs gave the sum; then the
    sum alone at the largest of those shapes and at fixed ones, both ways,
    by CUDA events, with the device bytes each call allocates. Prints JSON
    lines; no result line."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.ops import batch_kernels as bk
    shipped = bk.segment_sum
    seen = {}

    def recording(contrib, seg_ids, num_segments, ids_sorted=False):
        key = (int(contrib.shape[0]), int(num_segments), str(contrib.dtype))
        seen[key] = seen.get(key, 0) + 1
        return shipped(contrib, seg_ids, num_segments, ids_sorted)

    ways = (("aligned", recording), ("unaligned", _unaligned_segment_sum))
    walls = {}
    try:
        for suite, make, specs in (
                ("tpcxbb", lambda: bb_tables(sf, seed), bb_specs),
                ("tpcds bench", lambda: suite_tables(sf, seed, TPCDS_QUERIES),
                 lambda t: suite_specs(t, TPCDS_QUERIES))):
            tables = make()
            sess = TpuSession(BENCH_CONF)
            for name, build, ties, _ in specs(tables):
                release_device()
                bk.segment_sum = shipped
                run_query(sess, name, build)
                got = {}
                for way, fn in ways + ways[::-1]:
                    bk.segment_sum = fn
                    res, secs = run_query(sess, name, build)[:2]
                    walls.setdefault((suite, way), {}).setdefault(
                        name, []).append(secs)
                    if way in got:
                        check_same_bits(f"{name} {way} again", res, got[way])
                    got.setdefault(way, res)
                check_same_result(f"{name} unaligned against aligned",
                                  got["unaligned"], got["aligned"], ties)
                bk.segment_sum = shipped
            del tables, sess
            release_device()
    finally:
        bk.segment_sum = shipped
    for (suite, way), per in walls.items():
        mean = [float(np.mean(v)) for v in per.values()]
        print(json.dumps({"segment_sum_cost": {
            "suite": suite, "sf": sf, "way": way, "queries": len(per),
            "warm_geomean_s": float(np.exp(np.mean(np.log(mean)))),
            "warm_sum_s": float(np.sum(mean)),
            "warm_s": {q: v for q, v in per.items()}}}))
    top = sorted((k for k in seen if "float" in k[2]),
                 key=lambda k: -k[0] * k[1])[:4]
    print(json.dumps({"segment_sum_shapes": {
        "calls": sum(seen.values()), "distinct": len(seen),
        "max_rows": max((k[0] for k in seen), default=0),
        "max_segments": max((k[1] for k in seen), default=0),
        "largest": [list(k) + [seen[k]] for k in top]}}))
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    fixed = [(30_000_000, 100, "torch.float64"),
             (30_000_000, 180_000, "torch.float64"),
             (30_000_000, 1_000_000, "torch.float64"),
             (4_000_000, 4_000_000, "torch.float64"),
             (30_000_000, 1_000_000, "torch.float32")]
    for rows, segs, dt in [(r, s, d) for r, s, d in top] + fixed:
        dtype = getattr(torch, dt.split(".")[1])
        ids = torch.sort(torch.randint(0, segs, (rows,), device=device,
                                       generator=gen)).values
        contrib = torch.randn(rows, device=device, generator=gen,
                              dtype=torch.float64).to(dtype)
        out = {}
        for way, fn in (("aligned", shipped),
                        ("unaligned", _unaligned_segment_sum)):
            fn(contrib, ids, segs, True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = fn(contrib, ids, segs, True)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(contrib, ids, segs, True)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            out[way] = (float(np.median(times)), extra, res)
        diff = float((out["aligned"][2] - out["unaligned"][2]).abs().max())
        print(json.dumps({"segment_sum_alone": {
            "rows": rows, "segments": segs, "dtype": dt,
            "aligned_ms": out["aligned"][0],
            "unaligned_ms": out["unaligned"][0],
            "aligned_call_bytes": out["aligned"][1],
            "unaligned_call_bytes": out["unaligned"][1],
            "max_abs_diff": diff}}))
        del ids, contrib, out, res
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 22
#: 22a's queries: TPC-H Q1, Q3 and Q6 over phase 9's tables, each submitted
#: twice by each of two tenants weighted 3:1
SERVING_QUERIES = (1, 3, 6)
SERVING_TENANTS = ("a", "b")
SERVING_CONF = {"spark.rapids.tpu.serving.maxConcurrentQueries": "4",
                "spark.rapids.tpu.sql.concurrentTpuTasks": "2",
                "spark.rapids.tpu.serving.tenantWeights": "a:3,b:1"}
#: 22b's failover query: a filter whose result streams in several frames
SERVING_FAILOVER_SQL = ("SELECT l_orderkey, l_quantity, l_extendedprice "
                        "FROM lineitem WHERE l_quantity < 3")
#: a dead replica costs milliseconds, not the default retry walk
SERVING_FAST_DIAL = {"spark.rapids.tpu.shuffle.maxRetries": "0",
                     "spark.rapids.tpu.shuffle.connectTimeout": "2"}
#: 22c's supervised replica process: lineitem at this TPC-H scale,
#: round-robin repartitioned 8 ways, its store at this share of the card
#: (the main process keeps the JAX package's 0.9 of what is left)
SERVING_REPLICA_SF = 1.0
SERVING_REPLICA_FRACTION = 0.2
SERVING_REPLICA_SQL = 1
#: the restart backoff of 22c's supervisor
SERVING_RESTART_MS = 200


def start_replica(seed, n=1, extra=None):
    """A ReplicaSupervisor of ``n`` replica processes of the port's server
    CLI on the card (``python -m spark_rapids_tpu_torch.serving.server
    --device cuda``), each serving lineitem at SERVING_REPLICA_SF with
    ``--partitions 8``, its store at SERVING_REPLICA_FRACTION of the card.
    The processes start on the system memory pool of pyarrow (its
    mimalloc pool has crashed a process whose first use came from two
    threads). ``extra`` adds conf keys of the replicas. Returns
    (supervisor, its registry dir)."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.supervisor import ReplicaSupervisor
    os.environ["ARROW_DEFAULT_MEMORY_POOL"] = "system"
    registry = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    conf = TpuConf({
        **BENCH_CONF,
        "spark.rapids.tpu.serving.net.registryDir": registry,
        "spark.rapids.tpu.serving.fleet.superviseIntervalSeconds": "0.1",
        "spark.rapids.tpu.serving.fleet.restartBackoffMs":
            str(SERVING_RESTART_MS), **(extra or {})})
    sup = ReplicaSupervisor(conf, server_args=[
        "--device", "cuda", "--seed", str(seed),
        "--tpch-lineitem", str(SERVING_REPLICA_SF), "--partitions", "8",
        "--store-fraction", str(SERVING_REPLICA_FRACTION)])
    import atexit
    import shutil
    atexit.register(shutil.rmtree, registry, True)
    atexit.register(sup.stop, graceful=False)
    sup.start(n)
    return sup, registry


def _replica_addresses(sup, n=1, timeout=240.0, exclude=()):
    deadline = time.monotonic() + timeout
    while True:
        got = [a for a in sup.addresses() if a not in exclude]
        if len(got) >= n:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"no serving replica came up: "
                                 f"{sup.fleet_stats()}")
        time.sleep(0.05)


def serving_views(sess, tables):
    """The TPC-H tables SERVING_QUERIES read, each with only the union of
    their columns (a view of a whole table would upload all of it), as
    temp views of ``sess``; orders and lineitem hash 8 on their keys."""
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import COLUMNS
    cols = {}
    for q in SERVING_QUERIES:
        for t, names in COLUMNS[q].items():
            key = PARTITION_KEYS.get(t)
            cols.setdefault(t, set()).update(names + ([key] if key else []))
    return view_frames(sess, {t: tables[t].select(sorted(names))
                              for t, names in cols.items()}, PARTITION_KEYS)


def _wire_rows(table, smax):
    """A wire result (arrow) as a HostBatch, for check_same_result."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    return HostBatch.from_arrow(table, smax)


def _kernel_counts():
    from spark_rapids_tpu_torch.shuffle import partition_kernel as pk
    return (pk.REORDER_KERNEL.launches, pk.REORDER_KERNEL.kept,
            pk.COMPACT_KERNEL.launches)


def _no_leaks(label):
    """After the phase's queries: no semaphore holder or waiter and an
    empty shuffle catalog."""
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    dm = DeviceManager.peek()
    deadline = time.monotonic() + 60
    while dm is not None and dm.semaphore.active_holders and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    holders = dm.semaphore.active_holders if dm is not None else 0
    waiting = dm.semaphore.waiting if dm is not None else 0
    ids = list(dm.catalog.ids()) if dm is not None else []
    if holders or waiting or ids:
        raise AssertionError(f"{label}: {holders} semaphore holders, "
                             f"{waiting} waiters, {len(ids)} buffers left "
                             f"in the catalog")
    print(f"{label}: 0 semaphore holders, 0 waiters, the shuffle catalog "
          f"empty")


def _served(label, h, want, ties, single=None):
    """One served query's result held against ``want`` and its reorder
    launches against its single run's ``single``; prints its metrics.
    Returns (reorder launches, kept, compact launches)."""
    got = h.result(timeout=600)
    check_same_result(label, got, want, ties)
    s = h.snapshot()
    n = (s.get("reorder_launches", 0), s.get("reorder_kept", 0),
         s.get("compact_launches", 0))
    if single is not None and n[0] != single:
        raise AssertionError(f"{label}: {n[0]} reorder launches, its "
                             f"single run {single}")
    print(f"{label}: state={s['state']} rows={got.num_rows} "
          f"queue_wait_s={s['queue_wait_s']:.4f} admission_wait_s="
          f"{s['admission_wait_s']:.4f} wall_s={s['wall_s']:.4f} "
          f"reorder_launches={n[0]} launches_kept={n[1]} "
          f"compact_launches={n[2]} preemptions={s['preemptions']}, equal "
          f"to its single collect")
    return n


def _wait_state(h, state, timeout=120.0):
    deadline = time.monotonic() + timeout
    while h.state is not state and not h.done:
        if time.monotonic() > deadline:
            raise AssertionError(f"{h.label} never reached {state}")
        time.sleep(0.0005)


def serving_in_process(specs, wants, singles):
    """22a. The queries of ``specs`` {name: (build, ties)} submitted twice
    by each tenant through one session's scheduler (SERVING_CONF), each
    equal to ``wants[name]`` with its single run's reorder launches
    ``singles[name]``; then a Q3 cancelled while RUNNING, a query with a
    1 ms deadline, preemption (one device permit: an interactive tenant's
    Q1 behind a running Q3 is admitted to the card before the Q3 ends, the
    Q3 yields at least once, both equal), no holder and an empty catalog
    after all of it, and one traced Q3 (EXPLAIN ANALYZE names every exec
    with its rows and batches; its Chrome export holds a span per exec).
    Returns {path: (reorder launches, kept, compact launches)}."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.serving.lifecycle import (QueryState,
                                                          QueryTimeoutError)
    from spark_rapids_tpu_torch.utils import tracing
    nums = {}
    t0 = time.perf_counter()
    sess = TpuSession({**BENCH_CONF, **SERVING_CONF})
    handles = [(name, t, sess.submit(build(sess), tenant=t,
                                     label=f"{name} {t}{rep}"))
               for rep in range(2) for t in SERVING_TENANTS
               for name, (build, _) in specs.items()]
    for name, t, h in handles:
        n = _served(f"serving 22a {h.label}", h, wants[name],
                    specs[name][1], singles.get(name))
        prev = nums.get(f"serving 22a {name}", (0, 0, 0))
        nums[f"serving 22a {name}"] = tuple(a + b for a, b in zip(prev, n))
    print(f"serving 22a: {len(handles)} queries of {len(specs)} kinds by "
          f"{len(SERVING_TENANTS)} tenants in "
          f"{time.perf_counter() - t0:.2f} s, each equal to its single "
          f"collect with its single run's reorder launches; scheduler "
          f"{json.dumps(sess.scheduler.stats()['served_by_tenant'])}")
    q3, q3_ties = specs["q3"]
    q1 = specs["q1"][0]
    # a Q3 cancelled while it runs
    h = sess.submit(q3(sess), tenant="a", label="q3 cancelled")
    _wait_state(h, QueryState.RUNNING)
    h.cancel()
    h.wait(120)
    if h.state is not QueryState.CANCELLED:
        raise AssertionError(f"the cancelled Q3 ended {h.state}")
    print(f"serving 22a q3 cancelled while RUNNING: {h.state.value} after "
          f"{h.snapshot()['wall_s']:.4f} s")
    # a 1 ms deadline
    h = sess.submit(q3(sess), tenant="b", label="q3 deadline",
                    timeout=0.001)
    h.wait(120)
    if h.state is not QueryState.FAILED or \
            not isinstance(h.error, QueryTimeoutError):
        raise AssertionError(f"the 1 ms deadline ended {h.state} "
                             f"{h.error!r}")
    print(f"serving 22a q3 with a 1 ms deadline: {h.state.value} "
          f"{type(h.error).__name__}")
    sess.scheduler.shutdown()
    _no_leaks("serving 22a after the cancel and the deadline")
    # preemption: one permit, the whale's Q3 yields to the starved Q1
    pre = TpuSession({**BENCH_CONF, **SERVING_CONF,
                      "spark.rapids.tpu.sql.concurrentTpuTasks": "1",
                      "spark.rapids.tpu.serving.preemption.enabled": "true",
                      "spark.rapids.tpu.serving.preemption.starvationMs":
                          "10"})
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    wh = pre.submit(q3(pre), tenant="whale", label="q3 whale")
    deadline = time.monotonic() + 120
    while DeviceManager.peek() is None or \
            DeviceManager.peek().semaphore.max_concurrent != 1 or \
            DeviceManager.peek().semaphore.active_holders == 0:
        if wh.done or time.monotonic() > deadline:
            raise AssertionError("the whale finished before it was "
                                 "preempted")
        time.sleep(0.0005)
    ih = pre.submit(q1(pre), tenant="interactive", label="q1 interactive")
    _served("serving 22a preemption q1 interactive", ih, wants["q1"], False)
    _served("serving 22a preemption q3 whale", wh, wants["q3"], q3_ties)
    ws, is_ = wh.snapshot(), ih.snapshot()
    admitted = ih.submitted_at + is_["t_running"] + is_["admission_wait_s"]
    whale_end = wh.submitted_at + ws["wall_s"]
    if ws["preemptions"] < 1 or admitted >= whale_end:
        keys = ("t_running", "admission_wait_s", "footprint_est_bytes",
                "admission_footprint_wait_s", "admission_grace_hint",
                "wall_s")
        raise AssertionError(f"preemption: the whale yielded "
                             f"{ws['preemptions']} times; the interactive "
                             f"Q1 reached the card {admitted - whale_end:+.4f}"
                             f" s after the whale ended; whale "
                             f"{ {k: ws.get(k) for k in keys} }, interactive "
                             f"{ {k: is_.get(k) for k in keys} }")
    print(f"serving 22a preemption: the interactive Q1 reached the card "
          f"{whale_end - admitted:.4f} s before the whale's Q3 ended; the "
          f"whale yielded {ws['preemptions']} times, waiting "
          f"{ws['preempt_wait_s']:.4f} s")
    pre.scheduler.shutdown()
    _no_leaks("serving 22a after preemption")
    # one traced Q3: EXPLAIN ANALYZE and its Chrome export
    traced = TpuSession({**BENCH_CONF, **SERVING_CONF,
                         "spark.rapids.tpu.trace.enabled": "true"})
    h = traced.submit(q3(traced), label="q3 traced")
    _served("serving 22a q3 traced", h, wants["q3"], q3_ties)
    text = h.explain_analyze()
    plan = traced.last_plan
    ran = [n for n in plan.walk() if tracing.observed_of(n) is not None]
    lines = text.splitlines()
    for n in ran:
        if not any(n.name in ln and "rows=" in ln and "batches=" in ln
                   for ln in lines):
            raise AssertionError(f"EXPLAIN ANALYZE misses {n.name}:\n{text}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        spans = h.export_trace(os.path.join(d, "q3.json"))
        with open(os.path.join(d, "q3.json")) as f:
            events = json.load(f)["traceEvents"]
    per_exec = {e["args"].get("plan_id") for e in events
                if e["cat"] == "exec"}
    missing = [n.name for n in ran if n.plan_id not in per_exec]
    if missing:
        raise AssertionError(f"the Chrome export has no span of {missing}")
    print(f"serving 22a q3 traced: EXPLAIN ANALYZE names all {len(ran)} "
          f"executed execs with rows and batches; the Chrome export holds "
          f"{spans} spans, one or more per exec")
    print(text)
    traced.scheduler.shutdown()
    _no_leaks("serving 22a after the traced query")
    return nums


def serving_over_tcp(tables, wants):
    """22b. Two in-process QueryServers over one session of phase 9's
    tables (views; orders and lineitem hash 8) with dmaConsolidate on,
    and a QueryServiceClient over both: Q1, Q6 and Q3 by their SQL texts
    streamed from the second server, each equal to its DataFrame result
    by position, the compact kernel launching once per kept reorder
    output; then the failover query started on the first server, whose
    transport dies after its second result frame: the client resumes it
    on the second (resume_from), and the result is equal to the
    session's own collect. Returns {path: (reorder, kept, compact)}."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    from spark_rapids_tpu_torch.serving.server import QueryServer
    from spark_rapids_tpu_torch.utils import metrics as um
    nums = {}
    release_device()
    sess = TpuSession({**BENCH_CONF, **SERVING_CONF, DMA_KEY: "true"})
    serving_views(sess, tables)
    dying = QueryServer(sess, conf=sess.conf.with_overrides({
        "spark.rapids.tpu.serving.net.faults.plan":
            "kill_peer:req_type=data,after=2",
        "spark.rapids.tpu.serving.net.faults.seed": "7"}))
    alive = QueryServer(sess)
    addrs = [f"{h}:{p}" for h, p in (dying.address, alive.address)]
    client = QueryServiceClient(addrs, TpuConf({**BENCH_CONF,
                                               **SERVING_FAST_DIAL}))
    smax = sess.conf.string_max_bytes
    try:
        for q in (1, 6, 3):
            before = _kernel_counts()
            t0 = time.perf_counter()
            h = client.submit(SQL_QUERIES[q], replica=1)
            got = h.result()
            secs = time.perf_counter() - t0
            n = tuple(b - a for a, b in zip(before, _kernel_counts()))
            check_same_result(f"serving 22b q{q} over tcp",
                              _wire_rows(got, smax), wants[f"q{q}"],
                              q in TPCH_TIES, positional=True)
            if n[0] < 1 or n[2] != n[1]:
                raise AssertionError(f"serving 22b q{q}: {n[0]} reorder "
                                     f"launches, {n[1]} kept, {n[2]} "
                                     f"compact launches")
            nums[f"serving 22b q{q} dmaConsolidate"] = n
            print(f"serving 22b q{q} over tcp, dmaConsolidate on: rows="
                  f"{got.num_rows} s={secs:.4f} frames="
                  f"{h.batches_delivered} reorder_launches={n[0]} "
                  f"launches_kept={n[1]} compact_launches={n[2]}, equal "
                  f"to the DataFrame result")
        want = sess.sql(SERVING_FAILOVER_SQL).collect().to_arrow()
        f0 = um.SERVING_METRICS[um.SERVING_FAILOVERS].value
        r0 = um.SERVING_METRICS[um.SERVING_RESUMED_BATCHES].value
        t0 = time.perf_counter()
        h = client.submit(SERVING_FAILOVER_SQL, replica=0)
        got = h.result()
        secs = time.perf_counter() - t0
        fired = [f for f in dying.transport.plan.fired if f[0] == "kill_peer"]
        if not got.equals(want) or h.failovers != 1 or not fired or \
                h.replica != addrs[1]:
            raise AssertionError(f"serving 22b failover: equal="
                                 f"{got.equals(want)} failovers="
                                 f"{h.failovers} fired={fired} replica="
                                 f"{h.replica}")
        print(f"serving 22b failover: rows={got.num_rows} frames="
              f"{h.batches_delivered} s={secs:.4f}; the first server's "
              f"transport died after its second frame, the query resumed on "
              f"the second (failovers "
              f"{um.SERVING_METRICS[um.SERVING_FAILOVERS].value - f0}, "
              f"frames skipped by resume_from "
              f"{um.SERVING_METRICS[um.SERVING_RESUMED_BATCHES].value - r0})"
              f", equal to the collect")
    finally:
        client.close()
        dying.shutdown()
        alive.shutdown()
    sess.scheduler.drain(timeout=120)
    sess.scheduler.shutdown()
    _no_leaks("serving 22b")
    return nums


def replica_reference(seed):
    """22c's reference: SERVING_REPLICA_SQL's text over the replica's
    lineitem, made in this process on the card."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF, gen_lineitem
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    sess = TpuSession(BENCH_CONF)
    sess.create_dataframe(gen_lineitem(SERVING_REPLICA_SF, seed)).repartition(
        8).createOrReplaceTempView("lineitem")
    return sess.sql(SQL_QUERIES[SERVING_REPLICA_SQL]).collect()


def replica_query(addr, want, label):
    """One query through the routing client to the replica at ``addr``,
    equal to ``want``; its kernel counts read through serve.stats.
    Returns (the replica's reorder launches, kept, compact launches)."""
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    client = QueryServiceClient([addr], TpuConf(SERVING_FAST_DIAL))
    try:
        t0 = time.perf_counter()
        got = client.submit(SQL_QUERIES[SERVING_REPLICA_SQL]).result()
        secs = time.perf_counter() - t0
        check_same_result(label, _wire_rows(
            got, TpuConf().string_max_bytes), want, False, positional=True)
        k = client.stats()["kernels"]
    finally:
        client.close()
    n = (k["reorder_launches"], k["reorder_kept"], k["compact_launches"])
    if n[0] < 1:
        raise AssertionError(f"{label}: the replica launched no reorder")
    print(f"{label}: rows={got.num_rows} s={secs:.4f}; the replica's "
          f"serve.stats: reorder_launches={n[0]} launches_kept={n[1]} "
          f"compact_launches={n[2]}; equal to this process's run")
    return n


def phase_serving(tables, tpch_nums, tpch_results, sup, seed):
    """Phase 22, serving (``serving_in_process``, ``serving_over_tcp``),
    and 22c: the supervised replica process ``sup`` started beside phase
    21 answers one query equal to this process's run, is SIGKILLed (it
    restarts on its backoff while 22a and 22b run) and answers again,
    equal. Returns {path: (reorder launches, kept, compact launches)}."""
    import signal
    t0 = time.perf_counter()
    release_device()
    want_r = replica_reference(seed)
    first = _replica_addresses(sup)[0]
    print(f"serving 22c: the replica at {first} up "
          f"{time.perf_counter() - t0:.2f} s into the phase")
    nums = {"serving 22c replica": replica_query(
        first, want_r, "serving 22c replica, first process")}
    pid = sup._slots[0].proc.proc.pid
    os.kill(pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    specs = {s[0]: (s[1], s[2]) for s in tpch_specs(tables)
             if s[0] in {f"q{q}" for q in SERVING_QUERIES}}
    nums.update(serving_in_process(
        specs, tpch_results,
        {q: tpch_nums[q]["launches"] for q in specs}))
    nums.update(serving_over_tcp(tables, tpch_results))
    second = _replica_addresses(sup, exclude=(first,))[0]
    slot = sup.fleet_stats()["slots"][0]
    if slot["restarts"] < 1:
        raise AssertionError(f"the killed replica was not restarted: {slot}")
    print(f"serving 22c: the replica SIGKILLed, restarted on its backoff "
          f"at {second} (restarts {slot['restarts']}) within "
          f"{time.perf_counter() - t_kill:.2f} s")
    nums["serving 22c replica restarted"] = replica_query(
        second, want_r, "serving 22c replica, restarted process")
    sup.stop(graceful=False)
    return nums


def serving_checksum(tables, wants):
    """A corrupted result frame (``serving.net.faults.plan`` corrupt_frame
    on the server) is caught by the client's checksum and fetched again:
    Q1 by its SQL text equal to its DataFrame result."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    from spark_rapids_tpu_torch.serving.server import QueryServer
    from spark_rapids_tpu_torch.utils import metrics as um
    sess = TpuSession({**BENCH_CONF,
                       "spark.rapids.tpu.serving.net.faults.plan":
                           "corrupt_frame:after=1",
                       "spark.rapids.tpu.serving.net.faults.seed": "7"})
    serving_views(sess, tables)
    server = QueryServer(sess)
    client = QueryServiceClient(["%s:%d" % server.address], TpuConf())
    before = um.SERVING_METRICS[um.SERVING_WIRE_RETRIES].value
    try:
        got = client.submit(SQL_QUERIES[1]).result()
        check_same_result("serving checksum q1", _wire_rows(
            got, sess.conf.string_max_bytes), wants["q1"], False,
            positional=True)
        retries = um.SERVING_METRICS[um.SERVING_WIRE_RETRIES].value - before
        fired = [f for f in server.transport.plan.fired
                 if f[0] == "corrupt_frame"]
        if retries < 1 or not fired:
            raise AssertionError(f"serving checksum: {retries} re-fetches, "
                                 f"fired {fired}")
    finally:
        client.close()
        server.shutdown()
    sess.scheduler.shutdown()
    print(f"serving checksum: a corrupted frame caught and fetched again "
          f"({retries} re-fetches); Q1 equal to its DataFrame result")


def serving_routing(tables, wants):
    """Load-aware routing and the breaker: two in-process replicas, the
    first's footprint ledger charged half its budget, so Q6 (the large
    query here) lands on the second, whose budget is free; then the
    first's transport dies, its breaker opens at the first failed probe,
    and it receives no submission while open."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    from spark_rapids_tpu_torch.serving.health import BREAKER_OPEN
    from spark_rapids_tpu_torch.serving.lifecycle import QueryHandle
    from spark_rapids_tpu_torch.serving.server import QueryServer
    sessions = [TpuSession(BENCH_CONF), TpuSession(BENCH_CONF)]
    for s in sessions:
        serving_views(s, tables)
    servers = [QueryServer(s) for s in sessions]
    addrs = ["%s:%d" % s.address for s in servers]
    client = QueryServiceClient(addrs, TpuConf({
        **SERVING_FAST_DIAL,
        "spark.rapids.tpu.serving.health.probeIntervalSeconds": "0",
        "spark.rapids.tpu.serving.failover.breakerFailureThreshold": "1"}))
    smax = sessions[0].conf.string_max_bytes
    ledger = sessions[0].scheduler.admission
    whale = QueryHandle("ledger")
    budget = ledger._budget()
    try:
        ledger.admit(whale, budget // 2)
        for _ in range(2):
            h = client.submit(SQL_QUERIES[6])
            got = h.result()
            if h.replica != addrs[1]:
                raise AssertionError(f"routing: Q6 landed on {h.replica}, "
                                     f"the replica half charged")
            check_same_result("serving routing q6", _wire_rows(got, smax),
                              wants["q6"], False, positional=True)
        fractions = [client.stats(replica=i)["serve_stats"]["now"]
                     ["device_budget_fraction"] for i in range(2)]
        ledger.release(whale)
        servers[0].transport.kill()
        for _ in range(2):
            h = client.submit(SQL_QUERIES[6])
            h.result()
            if h.replica != addrs[1]:
                raise AssertionError("routing: a submission reached the "
                                     "dead replica")
        state = client._replica_state(addrs[0]).breaker.state
        if state != BREAKER_OPEN or \
                sessions[0].scheduler.stats()["submitted"] != 0:
            raise AssertionError(f"routing: the dead replica's breaker is "
                                 f"{state}")
    finally:
        client.close()
        for s in servers:
            s.shutdown()
    for s in sessions:
        s.scheduler.shutdown()
    print(f"serving routing: with the first replica's budget "
          f"{fractions[0]:.3f} charged and the second's {fractions[1]:.3f}, "
          f"Q6 went to the second; the first's transport killed, its "
          f"breaker {state}, no submission reached it")


def serving_fleet(sup, registry, want):
    """The FleetController over ``sup`` (two replica processes): eight
    clients keep queries in flight while the controller scales the fleet
    up to four replicas; then six stop, and with two still submitting it
    scales back down to two through the drain path (SIGTERM: running
    queries finish, new ones go elsewhere). Every query returns, equal to
    ``want``: none in flight was dropped."""
    import threading
    from spark_rapids_tpu_torch.benchmarks.tpch_sql import SQL_QUERIES
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.serving.client import QueryServiceClient
    from spark_rapids_tpu_torch.serving.controller import FleetController
    conf = TpuConf({
        **SERVING_FAST_DIAL,
        "spark.rapids.tpu.serving.net.registryDir": registry,
        "spark.rapids.tpu.serving.health.probeIntervalSeconds": "0.2",
        "spark.rapids.tpu.serving.maxConcurrentQueries": "1",
        "spark.rapids.tpu.serving.fleet.minReplicas": "2",
        "spark.rapids.tpu.serving.fleet.maxReplicas": "4",
        "spark.rapids.tpu.serving.fleet.scaleUpWatermark": "0.5",
        "spark.rapids.tpu.serving.fleet.scaleDownWatermark": "0.2",
        "spark.rapids.tpu.serving.fleet.scaleUpStableTicks": "1",
        "spark.rapids.tpu.serving.fleet.scaleDownStableTicks": "2",
        "spark.rapids.tpu.serving.fleet.scaleUpCooldownSeconds": "1",
        "spark.rapids.tpu.serving.fleet.scaleDownCooldownSeconds": "1"})
    ctl = FleetController(conf, sup)
    heavy, light = threading.Event(), threading.Event()
    done, errors = [], []
    smax = TpuConf().string_max_bytes

    def load(stop):
        client = QueryServiceClient(None, conf)
        try:
            while not stop.is_set():
                got = client.submit(SQL_QUERIES[SERVING_REPLICA_SQL]).result()
                check_same_result("serving fleet query",
                                  _wire_rows(got, smax), want, False,
                                  positional=True)
                done.append(1)
        except BaseException as e:      # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            client.close()

    def control_until(pred, what):
        deadline = time.monotonic() + 300
        while not pred():
            if errors or time.monotonic() > deadline:
                raise AssertionError(f"fleet: never {what}: "
                                     f"{sup.fleet_stats()} {errors}")
            decisions.append(ctl.tick().action)
            time.sleep(0.5)
    t0 = time.perf_counter()
    workers = [threading.Thread(target=load, args=(heavy if i < 6
                                                   else light,))
               for i in range(8)]
    for w in workers:
        w.start()
    decisions = []
    try:
        control_until(lambda: sup.active_count() == 4
                      and len(_live(sup)) == 4, "scaled up to 4")
        up_s, queries_up = time.perf_counter() - t0, len(done)
        heavy.set()
        control_until(lambda: sup.active_count() == 2, "scaled down to 2")
        down_s = time.perf_counter() - t0 - up_s
        queries_down = len(done) - queries_up
    finally:
        heavy.set()
        light.set()
        for w in workers:
            w.join(300)
        ctl.stop()
    if errors:
        raise errors[0]
    stats = sup.fleet_stats()
    print(f"serving fleet: scaled 2 -> 4 replica processes in {up_s:.2f} s "
          f"under 8 clients ({queries_up} queries), then 4 -> 2 through "
          f"the drain path in {down_s:.2f} s under 2 clients "
          f"({queries_down} queries); {len(done)} queries, every one equal "
          f"to this process's run, none dropped; decisions "
          f"+{decisions.count(1)} / -{decisions.count(-1)}; slots "
          f"{[(s['state'], s['restarts']) for s in stats['slots']]}")


def _live(sup):
    return [s for s in sup.fleet_stats()["slots"] if s["state"] == "UP"]


def serving_only(sf, seed):
    """Phase 22 alone at TPC-H scale ``sf``, with the rest of the slice:
    22a with the TPC-DS bench subset and q5 added (their tables and single
    runs made here), 22b, a checksum re-fetch, load-aware routing and the
    breaker, and the FleetController scaling a supervised fleet of
    replica processes from two to four and back. Prints no result line."""
    t0 = time.perf_counter()
    build_kernels()
    # one query at a time per replica, so clients queue and the
    # controller sees the pressure
    sup, registry = start_replica(
        seed, n=2, extra={"spark.rapids.tpu.serving.maxConcurrentQueries":
                          "1"})
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    tables = tpch_tables(sf, seed)
    suite = suite_tables(sf, seed, SUITE_BENCH)
    print(f"serving only sf={sf}: kernels and tables in "
          f"{time.perf_counter() - t0:.2f} s")
    specs = [s for s in tpch_specs(tables)
             if s[0] in {f"q{q}" for q in SERVING_QUERIES}]
    # TPC-DS's names take a prefix: its q3 is not TPC-H's
    specs += [(f"tpcds {n}", b, t, p)
              for n, b, t, p in suite_specs(suite, SUITE_BENCH)]
    sess = TpuSession(BENCH_CONF)
    wants, singles = {}, {}
    for name, build, ties, _ in specs:
        res, secs, n = run_query(sess, name, build)[:3]
        wants[name], singles[name] = res, n
        print(f"{name} single collect: s={secs:.4f} reorder_launches={n}")
    del sess
    release_device()
    serving_in_process({s[0]: (s[1], s[2]) for s in specs}, wants, singles)
    serving_over_tcp(tables, wants)
    serving_checksum(tables, wants)
    serving_routing(tables, wants)
    want_r = replica_reference(seed)
    serving_fleet(sup, registry, want_r)
    sup.stop(graceful=False)
    print(f"serving only sf={sf}: {time.perf_counter() - t0:.2f} s")


def run_tables(sf, seed, kernels_only, cluster_directory=None):
    """The tables of the run's scale every phase reads, generated at once
    (phase 2 makes them while the CPU workers run), and phase 21's tables
    (CLUSTER_SF) and 21b's lineitem files under ``cluster_directory`` ->
    ({"lineitem", "q1_reference", "q3", "tpch", "suite", "bb", "cluster",
    "cluster_files"}, seconds per set). Two threads make them, in chains
    of about equal length: lineitem, its Q1, the TPC-H tables (the Q3
    tables are columns of them) and phase 21's tables and files in one,
    the TPC-DS and TPCx-BB tables in the other (the host's 96 GiB also
    hold the CPU workers). pyarrow's memory pool is first touched here,
    on one thread: pyarrow 25's mimalloc pool has segfaulted when two
    threads first touched it at once (ROADMAP traps)."""
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
    made, secs = {}, {}
    chains = ((("lineitem", lambda: gen_lineitem(sf, seed=seed)),
               ("q1_reference", lambda: q1_numpy(made["lineitem"])),
               ("tpch", lambda: tpch_tables(sf, seed)),
               ("q3", lambda: q3_tables(made["tpch"])),
               ("cluster", lambda: cluster_tables(CLUSTER_SF, seed, False)),
               ("cluster_files", lambda: cluster_files(
                   cluster_directory, made["cluster"]["tpch"]["lineitem"]))),
              (("suite", lambda: suite_tables(sf, seed)),
               ("bb", lambda: bb_tables(sf, seed))))
    if kernels_only:
        chains = (chains[0][:1],)
    else:
        import pyarrow as pa
        pa.allocate_buffer(1)

    def run(chain):
        for key, make in chain:
            t0 = time.perf_counter()
            made[key] = make()
            secs[key] = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(chains)) as pool:
        for f in [pool.submit(run, c) for c in chains]:
            f.result()
    return made, {k: secs[k] for k in ("lineitem", "q1_reference", "q3",
                                       "tpch", "suite", "bb", "cluster",
                                       "cluster_files")
                  if k in secs}


def _depths(plan, d=0):
    yield plan, d
    for c in plan.children:
        yield from _depths(c, d + 1)


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
    ap.add_argument("--check-sf", type=float, default=0.1,
                    help="scale of phase 9's, 10's, 13's and 15's checks "
                         "of every query on the card against the CPU, of "
                         "the SQL texts against the DataFrame queries and "
                         "of phase 14's forced runs")
    ap.add_argument("--bb-check-sf", type=float, default=0.25,
                    help="scale of phase 11's check of the 30 TPCx-BB "
                         "queries on the card against the CPU and of "
                         "their forced runs in phase 14")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one exchange run with dmaConsolidate "
                         "off and on, one Q1 run and one Q3 run, and write "
                         "their per-kernel device times as tables to DIR")
    ap.add_argument("--memory-profile", nargs="+", metavar="QUERY",
                    help="only measure where these TPC-DS queries' device "
                         "memory goes, operator by operator, at "
                         "--memory-profile-sf; prints no result line")
    ap.add_argument("--cluster-only", type=float, metavar="SF",
                    help="only run phase 21 at this TPC-H scale, with "
                         "every query of its lists and the lz4 run; prints "
                         "no result line")
    ap.add_argument("--serving-only", type=float, metavar="SF",
                    help="only run phase 22 at this TPC-H scale, with the "
                         "TPC-DS bench subset and q5 added to 22a, a "
                         "checksum re-fetch, load-aware routing and the "
                         "breaker, and a fleet of replica processes scaled "
                         "from two to four and back; prints no result line")
    ap.add_argument("--memory-profile-sf", type=float, nargs="+",
                    default=(5.0, 2.0), metavar="SF")
    ap.add_argument("--segment-sum-cost", action="store_true",
                    help="only measure what the aligned GPU float segment "
                         "sums cost against unaligned ones, end to end on "
                         "TPCx-BB and the TPC-DS bench queries at --sf and "
                         "alone; prints no result line")
    args = ap.parse_args()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"gpu: {gpu_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    check_formats()

    if args.memory_profile:
        memory_profile(args.memory_profile, args.memory_profile_sf,
                       args.seed)
        print(f"gpu: {gpu_line()}")
        return 0
    if args.segment_sum_cost:
        segment_sum_cost(args.sf, args.seed)
        print(f"gpu: {gpu_line()}")
        return 0
    if args.cluster_only:
        cluster_only(args.cluster_only, args.seed)
        print(f"gpu: {gpu_line()}")
        return 0
    if args.serving_only:
        serving_only(args.serving_only, args.seed)
        print(f"gpu: {gpu_line()}")
        return 0
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.2f} s")
        clock[0] = now

    build_kernels()
    phase_done("2 build")
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    # phase 16's parquet files; removed when phase 16 ends (or at exit)
    parquet_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_parquet_")
    # phase 21b's lineitem files; removed when phase 21 ends (or at exit)
    cluster_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_")
    with concurrent.futures.ThreadPoolExecutor(1) as gen:
        making = gen.submit(run_tables, args.sf, args.seed,
                            args.kernels_only, cluster_dir.name)
        if not args.kernels_only:
            refs = cpu_references((
                ("suite", args.check_sf, args.seed, suite_names()),
                ("tpch", args.check_sf, args.seed,
                 [f"q{q}" for q in QUERIES]),
                ("bb", args.bb_check_sf, args.seed, bb_queries()),
                ("functions", args.check_sf, args.seed,
                 list(FUNCTION_SQL)),
                ("surface", args.check_sf, args.seed, surface_names()),
                ("q51", Q51_CHECK_SF, args.seed, ["q51"])))
        made, gen_s = making.result()
    print(f"tables sf={args.sf} generated beside the CPU workers: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in gen_s.items()))
    phase_done(f"2 cpu references ({CPU_WORKERS} workers of "
               f"{CPU_THREADS} threads) and the run's tables")
    # what exists now lives to the end of the run or is freed by its count:
    # the collections each query's gc.collect() makes skip it
    gc.freeze()
    device = torch.device("cuda", 0)
    lineitem = made.pop("lineitem")
    reference = made.pop("q1_reference", None)
    print(f"lineitem sf={args.sf}: {lineitem.num_rows} rows")
    lineitem_nums = phase_kernels(lineitem, device, args.tile_sweep)
    phase_done("3 kernels")
    if args.kernels_only:
        print(json.dumps({"kernels": [
            {**KERNELS[k], "launches": None, **n}
            for k, n in zip(("reorder", "compact"), lineitem_nums)]}))
        return 0
    # phase 16's parquet files, written beside phases 4-15
    writer = concurrent.futures.ThreadPoolExecutor(1)
    parquet_written = writer.submit(
        parquet_files, parquet_dir.name, lineitem, made["suite"]["ds"], "run",
        tpch_lineitem=made["tpch"]["lineitem"])
    writer.shutdown(wait=False)
    by_path = {"exchange_dma": {"compact": phase_exchange(lineitem, device,
                                                          args.profile)}}
    phase_done("4 exchange")
    phase_spill(args.seed, device)
    phase_done("5 spill")
    q1_launches, q1_cold = phase_main_path(lineitem, reference,
                                           args.profile)
    by_path["q1"] = {"reorder": q1_launches}
    udf_lineitem = lineitem             # phases 17 and 19 read it
    del lineitem, reference
    phase_done("6 q1")
    tables = made.pop("q3")
    print(f"q3 tables sf={args.sf}: customer {tables['customer'].num_rows}, "
          f"orders {tables['orders'].num_rows}, lineitem "
          f"{tables['lineitem'].num_rows} rows")
    overflow, *q3_nums = phase_q3_kernels(tables, device)
    phase_done("7 q3 kernel checks")
    q3_launches = phase_q3(tables, overflow, args.profile)
    for label, (r, c, _) in q3_launches.items():
        by_path[f"q3 {label}"] = {"reorder": r, "compact": c}
    phase_done("7 q3 runs")
    phase_q6_and_sort(tables["lineitem"], device)
    del tables
    phase_done("8 q6 and range sort")
    check, check_results, check_pruned = {}, {}, {}
    check["tpch"], check_results["tpch"], check_pruned["tpch"] = \
        phase_tpch_check(args.check_sf, args.seed, refs["tpch"])
    phase_done(f"9 tpch sf={args.check_sf} against the cpu")
    tables = made.pop("tpch")
    print(f"tpch tables sf={args.sf}: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables.items()) + " rows")
    tpch_kernel_nums = phase_tpch_kernels(tables, device)
    phase_done("9 tpch kernel checks")
    dfa_device_ms(tables, device)
    tpch, dma18, tpch_results = phase_tpch(tables)
    tpch_sf_tables = tables        # phases 12 and 13 run queries over them
    files_lineitem = tables["lineitem"]     # phase 19 writes it
    del tables
    phase_done(f"9 tpch sf={args.sf}")
    by_path["q18 dmaConsolidate"] = {"reorder": dma18[0],
                                     "compact": dma18[1]}
    for q, n in tpch.items():
        by_path[f"tpch {q}"] = {"reorder": n["launches"]}
    check["suite"], check_results["suite"], check_pruned["suite"] = \
        phase_suite_check(args.check_sf, args.seed,
                          refs["suite"])
    phase_done(f"10 tpcds+q5 sf={args.check_sf} against the cpu")
    tables = made.pop("suite")
    print(f"tpcds tables sf={args.sf}: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables["ds"].items())
        + "; tpcxbb: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables["bb"].items()) + " rows")
    suite_kernel_nums = phase_suite_kernels(tables, device)
    phase_done("10 tpcds kernel checks")
    suite, dma23, suite_results = phase_suite(tables)
    suite_sf_tables = tables       # phase 13 runs queries over them
    del tables
    phase_done(f"10 tpcds+q5 sf={args.sf}")
    by_path["q23 dmaConsolidate"] = {"reorder": dma23[0],
                                     "compact": dma23[1]}
    for q, n in suite.items():
        by_path[q] = {"reorder": n["launches"]}
    check["bb"], check_results["bb"] = phase_bb_check(
        args.bb_check_sf, args.seed, refs["bb"])
    phase_done(f"11 tpcxbb sf={args.bb_check_sf} against the cpu")
    tables = made.pop("bb")
    print(f"tpcxbb tables sf={args.sf}: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables.items()) + " rows")
    bb_kernel_nums = phase_bb_kernels(tables, device)
    split_dfa_ms(tables, device)
    phase_done("11 tpcxbb kernel checks")
    bb, dma_bb = phase_bb(tables)
    del tables
    phase_done(f"11 tpcxbb sf={args.sf}")
    by_path[f"tpcxbb {BB_DMA_QUERY} dmaConsolidate"] = {
        "reorder": dma_bb[0], "compact": dma_bb[1]}
    for q, n in bb.items():
        by_path[f"tpcxbb {q}"] = {"reorder": n["launches"]}
    for path, n in phase_default_path(check, check_results, args.check_sf,
                                      args.bb_check_sf, tpch_sf_tables,
                                      device, args.profile).items():
        by_path[path] = {"reorder": n}
    phase_done("12 default path against all-off")
    for path, n in phase_sql_check(args.check_sf, args.seed, check_results,
                                   check_pruned, refs["functions"]).items():
        by_path[path] = {"reorder": n}
    phase_done(f"13 sql sf={args.check_sf}")
    sql_nums, row_ids = phase_sql_at_scale(tpch_sf_tables, tpch_results,
                                           suite_sf_tables, suite_results)
    for q, n in sql_nums.items():
        by_path[q] = {"reorder": n["launches"]}
    phase_done(f"13 sql sf={args.sf}")
    for path, n in phase_out_of_core(
            check_results, args.check_sf, args.bb_check_sf, args.seed,
            tpch_sf_tables, tpch_results, suite_sf_tables,
            suite_results).items():
        by_path[path] = {"reorder": n}
    # phase 17 holds the CPU engine against phase 9's card results
    tpch_check = (check["tpch"], check_pruned["tpch"],
                  check_results["tpch"])
    del check, check_results, check_pruned
    phase_done("14 out of core")
    surface, surface_launches = phase_surface(
        args.check_sf, args.seed, refs["surface"], refs["q51"],
        suite_sf_tables["ds"])
    by_path.update({p: {"reorder": n} for p, n in surface_launches.items()})
    phase_done("15 sql surface")
    parquet = phase_parquet(parquet_written.result(), q1_cold, suite_results,
                            args.check_sf, args.seed, parquet_dir.name)
    parquet_dir.cleanup()
    for path, n in parquet.items():
        by_path[path] = {"reorder": n[0], "compact": n[1]}
    phase_done("16 parquet")
    for path, n in phase_fallback(udf_lineitem, args.seed, args.check_sf,
                                  *tpch_check).items():
        by_path[path] = {"reorder": n}
    del tpch_check
    phase_done("17 cpu fallback, udf and mortgage")
    adaptive_nums, skew, _ = phase_adaptive(suite_sf_tables, suite,
                                            suite_results, args.sf)
    for q, n in adaptive_nums.items():
        by_path[f"adaptive {q}"] = {"reorder": n["launches"]}
    for way, n in skew.items():
        by_path[f"adaptive skew cell {way}"] = {"reorder": n["launches"]}
    phase_done("18 adaptive, coalesce and catalyst")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as d:
        files = phase_files(files_lineitem, udf_lineitem, tpch_results,
                            args.seed, args.sf, d)
    del files_lineitem, udf_lineitem
    by_path.update({p: {"reorder": n[0]} for p, n in files.items()})
    phase_done("19 files")
    mesh = phase_mesh(tpch_sf_tables, tpch_results, suite_sf_tables,
                      suite_results)
    del suite_sf_tables
    by_path.update({f"mesh {q}": {"reorder": n["reorder_launches"]}
                    for q, n in mesh.items()})
    phase_done("20 mesh")
    # phase 22's supervised replica process starts beside phase 21
    replica = start_replica(args.seed)[0]
    cluster = phase_cluster(made.pop("cluster"), made.pop("cluster_files"),
                            args.seed)
    cluster_dir.cleanup()
    for path, n in cluster.items():
        by_path[f"cluster {path}"] = {"reorder": n["reorder_launches"]}
        if n["compact_launches"]:
            by_path[f"cluster {path}"]["compact"] = n["compact_launches"]
    phase_done("21 cluster")
    serving = phase_serving(tpch_sf_tables, tpch, tpch_results, replica,
                            args.seed)
    del tpch_sf_tables
    for path, n in serving.items():
        by_path[path] = {"reorder": n[0]}
        if n[2]:
            by_path[path]["compact"] = n[2]
    phase_done("22 serving")
    # this slice's main path is the 99 TPC-DS queries and q5 (phase 10):
    # the reorder's launches summed over their cold runs (launches_kept:
    # those whose output the exchange used) and the compact kernel's in
    # the dma-on q23, beside the times, bounds and errors of the widest
    # input of each sales fact those queries give the kernels. Phase 11's
    # TPCx-BB reading, phase 9's TPC-H reading, phase 13's SQL launches at
    # the run's scale, phase 15's surface launches at the run's scale,
    # phase 7's reading on Q3's inputs, phase 3's at Q1's lineitem shape
    # and every path's launches stand beside them.
    def launch_sums(runs):
        return (sum(n["launches"] for n in runs.values()),
                sum(n["launches_kept"] for n in runs.values()))
    # phase 16: reorder launches, compact launches, reorder launches kept,
    # encoded splits; the compact kernel's kept launches are the kept
    # reorder outputs of the run it launched in (phase 16 holds them equal)
    pq_r, pq_c, pq_kept, pq_enc = (sum(n[i] for n in parquet.values())
                                   for i in range(4))
    pq_c_kept = sum(n[2] for n in parquet.values() if n[1])
    readings = {
        "reorder": {"suite": launch_sums(suite), "bb": launch_sums(bb),
                    "tpch": launch_sums(tpch), "sql": launch_sums(sql_nums),
                    "surface": launch_sums(surface),
                    "parquet": (pq_r, pq_kept),
                    "adaptive": launch_sums(adaptive_nums),
                    "files": tuple(map(sum, zip(*files.values())))},
        "compact": {"suite": dma23[1:], "bb": dma_bb[1:],
                    "tpch": dma18[1:], "parquet": (pq_c, pq_c_kept)}}
    # phase 21: the reorder's launches and kept outputs over every cluster
    # run (21b's counted in the daemons), the compact kernel's in 21a's
    # dma-on Q3
    readings["reorder"]["cluster"] = (
        sum(n["reorder_launches"] for n in cluster.values()),
        sum(n["launches_kept"] for n in cluster.values()))
    dma_q3 = next(n for k, n in cluster.items()
                  if k.startswith("21a") and k.endswith("dmaConsolidate"))
    readings["compact"]["cluster"] = (dma_q3["compact_launches"],
                                      dma_q3["launches_kept"])
    # phase 22: the reorder's launches and kept outputs over the queries
    # served in this process (22a, 22b; counted on each query's handle and
    # around each wire query), the compact kernel's in 22b's dma-on
    # queries; the replica process's own counts stand under its paths
    in_process = [n for p, n in serving.items() if "replica" not in p]
    readings["reorder"]["serving"] = (sum(n[0] for n in in_process),
                                      sum(n[1] for n in in_process))
    dma_served = [n for p, n in serving.items() if "dmaConsolidate" in p]
    readings["compact"]["serving"] = (sum(n[2] for n in dma_served),
                                      sum(n[1] for n in dma_served))
    records = []
    for i, name in enumerate(("reorder", "compact")):
        for label, (launches, kept) in readings[name].items():
            if launches < 1 or kept < 1:
                raise AssertionError(f"{name}: the {label} runs launched it "
                                     f"{launches} times, {kept} of them "
                                     f"kept")
        (launches, kept), (b_l, b_k), (t_l, t_k) = (
            readings[name][k] for k in ("suite", "bb", "tpch"))
        record = {**KERNELS[name], "launches": launches,
                  "launches_kept": kept, **suite_kernel_nums[i],
                  "phase11_tpcxbb": {"launches": b_l, "launches_kept": b_k,
                                     **bb_kernel_nums[i]},
                  "phase9_tpch": {"launches": t_l, "launches_kept": t_k,
                                  **tpch_kernel_nums[i]},
                  "phase7_q3": q3_nums[i],
                  "phase3_q1_lineitem": lineitem_nums[i],
                  "launches_by_path": {p: v[name]
                                       for p, v in by_path.items()
                                       if name in v}}
        record["phase16_parquet"] = dict(zip(
            ("launches", "launches_kept"), readings[name]["parquet"]),
            encoded_splits=pq_enc)
        if "sql" in readings[name]:
            record["phase13_sql"] = dict(zip(
                ("launches", "launches_kept"), readings[name]["sql"]),
                row_ids=row_ids)
            record["phase15_surface"] = dict(zip(
                ("launches", "launches_kept"), readings[name]["surface"]))
            record["phase18_adaptive"] = dict(zip(
                ("launches", "launches_kept"), readings[name]["adaptive"]),
                skew_cell={way: {k: n[k] for k in ("launches",
                                                   "launches_kept")}
                           for way, n in skew.items()})
            record["phase19_files"] = dict(zip(
                ("launches", "launches_kept"), readings[name]["files"]))
        record["phase21_cluster"] = dict(zip(
            ("launches", "launches_kept"), readings[name]["cluster"]))
        record["phase22_serving"] = dict(zip(
            ("launches", "launches_kept"), readings[name]["serving"]))
        records.append(record)
    print(json.dumps({"kernels": records}))
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
