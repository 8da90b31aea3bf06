"""The write command's part files encoded side by side on a job's host
threads against one after another in the task's thread
(``io/write_exec.py::ENCODE_THREADS``), on the device's lineitem: the
ORC write of ``chip_smoke.py`` phase 19 (12 files) and its parquet write
partitioned by ``l_returnflag, l_linestatus``, both from the scan cache.

    python3 -m spark_rapids_tpu_torch.benchmarks.write_encode [--sf 10]
        [--seed 42] [--dir DIR] [--device cuda]

Runs each write side by side, one by one, one by one, side by side, on
the same table and prints one line a run (the wall, the decoded bytes
over it) and, last, one JSON object with the walls.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch_data as td
    from spark_rapids_tpu_torch.benchmarks.tpch import BENCH_CONF
    from spark_rapids_tpu_torch.io import write_exec
    lineitem = td.gen_lineitem_full(args.sf, args.seed)
    rows, decoded = lineitem.num_rows, lineitem.nbytes
    sess = TpuSession({**BENCH_CONF, "spark.rapids.tpu.sql.scanCache.maxBytes":
                       str(48 << 30)}, device=args.device)
    df = sess.create_dataframe(lineitem)
    df.limit(1).collect()
    per_file = -(-rows // 12)
    writes = {
        "orc": lambda out: df.write.mode("overwrite")
        .option("maxRecordsPerFile", per_file).orc(out),
        "parquet partitioned": lambda out: df.write.mode("overwrite")
        .partitionBy("l_returnflag", "l_linestatus")
        .option("maxRecordsPerFile", per_file).parquet(out)}
    side_by_side = write_exec.ENCODE_THREADS
    walls: dict = {}
    directory = tempfile.mkdtemp(prefix="write_encode_", dir=args.dir)
    try:
        for name, write in writes.items():
            for threads in (side_by_side, 0, 0, side_by_side):
                write_exec.ENCODE_THREADS = threads
                t0 = time.perf_counter()
                stats = write(os.path.join(directory, "out"))
                if args.device != "cpu":
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                assert stats.num_rows == rows, stats
                key = f"{name} threads={threads}"
                walls.setdefault(key, []).append(secs)
                print(f"{key}: files={stats.num_files} wall_s={secs:.4f} "
                      f"gb_per_s={decoded / secs / 1e9:.3f}", flush=True)
    finally:
        write_exec.ENCODE_THREADS = side_by_side
        shutil.rmtree(directory, ignore_errors=True)
    out = {"sf": args.sf, "rows": rows, "decoded_bytes": decoded,
           "walls_s": walls}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
