"""Host time to plan: ``DataFrame.physical_plan()`` of the 22 TPC-H and the
99 TPC-DS DataFrame queries, over the tables ``chip_smoke.py`` gives them
(orders, lineitem and the three sales facts hash 8), at a small scale:
planning reads the tables' sizes, not their rows.

    python3 -m spark_rapids_tpu_torch.benchmarks.plan_time [--device cuda]
        [--sf 0.01] [--reps 5] [--collect] [--out plan_time.json]

To time another checkout of the package with this script, put that
checkout first on the path: ``PYTHONPATH=<checkout> python3
<this file>``. Prints one line per query (the median and the least of
``--reps`` plans, in ms; with ``--collect`` a warm collect's wall) and,
last, one JSON object with the totals.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

PARTITION_KEYS = {"orders": "o_orderkey", "lineitem": "l_orderkey",
                  "store_sales": "ss_item_sk", "catalog_sales": "cs_item_sk",
                  "web_sales": "ws_item_sk"}


def frames(sess, tables, columns):
    """The query's DataFrames over its columns, the partitioned tables
    hash 8 on their keys."""
    dfs = {}
    for t, names in columns.items():
        key = PARTITION_KEYS.get(t)
        hb = tables[t].select(list(names) + ([key] if key and key not in names
                                             else []))
        df = sess.create_dataframe(hb)
        dfs[t] = df.repartition(8, key) if key else df
    return dfs


def specs(sf, seed):
    """(name, tables, query function, columns) of every query."""
    from spark_rapids_tpu_torch.benchmarks import tpcds_data as dd
    from spark_rapids_tpu_torch.benchmarks import tpcds_queries as dq
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks import tpch_queries as hq
    h = td.gen_all(sf, seed, hq.all_columns())
    out = [(f"tpch q{q}", h, hq.QUERIES[q], hq.COLUMNS[q])
           for q in sorted(hq.QUERIES)]
    want = {}
    for cols in dq.COLUMNS.values():
        for t, names in cols.items():
            want.setdefault(t, set()).update(names)
    for t in want:
        if t in PARTITION_KEYS:
            want[t].add(PARTITION_KEYS[t])
    ds = dd.gen_all(sf, seed, {
        t: [c for c in getattr(dd, f"{t.upper()}_COLUMNS") if c in names]
        for t, names in want.items()},
        tables=[t for t in dd.TABLES if t in want])
    out += [(f"tpcds {q}", ds, dq.QUERIES[q], dq.COLUMNS[q])
            for q in sorted(dq.QUERIES, key=lambda n: int(n[1:]))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--collect", action="store_true",
                    help="also time one collect() of each query, after "
                         "one untimed collect")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import spark_rapids_tpu_torch as pkg
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    sess = TpuSession(BENCH_CONF, device=args.device)
    rows, collects = {}, {}
    for name, tables, query, columns in specs(args.sf, args.seed):
        df = query(frames(sess, tables, columns))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            df.physical_plan()
            times.append((time.perf_counter() - t0) * 1e3)
        rows[name] = (statistics.median(times), min(times))
        if args.collect:
            df.collect()
            t0 = time.perf_counter()
            df.collect()
            if args.device == "cuda":
                import torch
                torch.cuda.synchronize()
            collects[name] = (time.perf_counter() - t0) * 1e3
        print(f"{name}: median_ms={rows[name][0]:.3f} "
              f"min_ms={rows[name][1]:.3f}"
              + (f" collect_ms={collects[name]:.3f}" if args.collect
                 else ""), flush=True)
    result = {
        "package": pkg.__file__, "device": args.device, "sf": args.sf,
        "reps": args.reps, "queries": len(rows),
        "tpch_median_ms_sum": sum(v[0] for k, v in rows.items()
                                  if k.startswith("tpch")),
        "tpcds_median_ms_sum": sum(v[0] for k, v in rows.items()
                                   if k.startswith("tpcds")),
        "collect_ms_sum": sum(collects.values()) if collects else None,
        "per_query_median_ms": {k: v[0] for k, v in rows.items()},
        "per_query_collect_ms": collects or None}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("per_query")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
