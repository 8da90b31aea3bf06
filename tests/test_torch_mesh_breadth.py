"""The mesh operators of the PyTorch port against the JAX package's mesh:
the 20 cases of tests/test_mesh_breadth.py (windows, rollup and cube,
explode, the range sort, the parquet, ORC and CSV scans, the writes, the
high-cardinality repartitioned aggregate, the global aggregate and the
adaptive broadcast switches), each on the port's 8 CPU shards and the JAX
package's 8 host devices: the results equal (exact columns bit for bit,
float sums within 1e-9), and the plans' ``Mesh*`` operators, in tree order,
are the same."""
import csv as _csv

import numpy as np
import pyarrow as pa
import pyarrow.orc as po_orc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window

from torch_mesh_common import (  # noqa: F401 - fixtures
    fresh_device_managers, jax_session, mesh_names, mesh_run,
    one_torch_thread)


def _rand_table(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 37, n).astype(np.int32),
        "b": rng.integers(0, 3, n).astype(np.int32),
        "v": rng.integers(-1000, 1000, n).astype(np.int64),
        "s": pa.array([f"row{int(i)}" for i in rng.integers(0, 50, n)]),
    })


def _both(build, conf=None, ignore_order=True, approx=None, expect=(),
          on_mesh=True):
    """``build(session, F, Window)`` on both meshes: equal results, equal
    mesh plans, the expected operators present."""
    got, sess = mesh_run(lambda s: build(s, F, Window), conf,
                         on_mesh=on_mesh)
    js = jax_session(conf)
    want = build(js, JF, JWindow).collect()
    assert_tables_equal(want, got, ignore_order=ignore_order,
                        approx_float=approx)
    names = mesh_names(sess.last_plan)
    assert names == mesh_names(js.last_plan), (
        sess.last_plan.tree_string(), js.last_plan.tree_string())
    for e in expect:
        assert e in names, names
    return got, sess


def test_mesh_window_rank_and_agg():
    t = _rand_table()
    _both(lambda s, f, w: s.create_dataframe(t).select(
        "k", "v", "s",
        f.row_number().over(w.partitionBy("k").orderBy("v")).alias("rn"),
        f.rank().over(w.partitionBy("k").orderBy("v")).alias("rk"),
        f.sum("v").over(w.partitionBy("k").orderBy("v")).alias("running")),
        expect=["MeshWindowExec"])


def test_mesh_window_multi_part_keys():
    t = _rand_table(seed=5)
    _both(lambda s, f, w: s.create_dataframe(t).select(
        "k", "b", "v",
        f.avg("v").over(w.partitionBy("k", "b").orderBy("v", "s"))
        .alias("ra"),
        f.lag("v", 1).over(w.partitionBy("k", "b").orderBy("v", "s"))
        .alias("pv")), approx=1e-9, expect=["MeshWindowExec"])


def test_unpartitioned_window_gathers():
    """No partition keys: one frame on one device. The scatter under it
    would be gathered at once, so the rewrite leaves the plain upload, in
    both packages."""
    t = _rand_table(800, seed=3)
    got, sess = _both(lambda s, f, w: s.create_dataframe(t).select(
        "v", f.row_number().over(w.orderBy("v")).alias("rn")),
        on_mesh=False)
    assert got.num_rows == 800


def test_mesh_expand_rollup():
    t = _rand_table()
    _both(lambda s, f, w: s.create_dataframe(t).rollup("k", "b").agg(
        f.sum("v").alias("sv"), f.count("v").alias("cv")),
        expect=["MeshExpandExec"])


def test_mesh_expand_cube_strings():
    t = _rand_table(seed=19)
    _both(lambda s, f, w: s.create_dataframe(t).cube("s", "b").agg(
        f.min("v").alias("mv"), f.max("s").alias("ms")),
        expect=["MeshExpandExec"])


def test_mesh_generate_explode():
    t = _rand_table(1200, seed=7)
    _both(lambda s, f, w: s.create_dataframe(t).select(
        "k", f.explode(f.array(f.col("v"), f.col("v") * 2,
                               f.lit(None))).alias("e")),
        expect=["MeshGenerateExec"])


def test_mesh_range_partition_sort():
    """The global sort is a sampled range repartition and a sort per
    shard: the shard-major order is the sorted order."""
    t = _rand_table(6000, seed=23)
    _both(lambda s, f, w: s.create_dataframe(t).sort("v", "k"),
          ignore_order=False, expect=["MeshSortExec"])


def _write_both(tmp_path, name, t, write):
    """``write(df writer)`` from both meshes into two directories; the
    port's stats and plan, with the mesh plans equal."""
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    from torch_mesh_common import port_session
    s = port_session()
    mbm.reset_counters()
    stats = write(s.create_dataframe(t).write.mode("overwrite"),
                  str(tmp_path / f"{name}_port"))
    assert mbm.counters()["host_hop_bytes"] == 0
    js = jax_session()
    write(js.create_dataframe(t).write.mode("overwrite"),
          str(tmp_path / f"{name}_jax"))
    assert mesh_names(s.last_plan) == mesh_names(js.last_plan)
    return stats, s


def test_mesh_write_parquet_roundtrip(tmp_path):
    from spark_rapids_tpu_torch.api import TpuSession
    t = _rand_table(3000, seed=29)
    stats, _ = _write_both(tmp_path, "pq", t,
                           lambda w, p: w.parquet(p))
    assert stats.num_rows == 3000 and stats.num_files > 1
    back = TpuSession(device="cpu").read.parquet(
        str(tmp_path / "pq_port")).collect().to_arrow()
    assert_tables_equal(t, back, ignore_order=True)


def test_mesh_write_partitioned_csv(tmp_path):
    from spark_rapids_tpu_torch.api import TpuSession
    t = _rand_table(500, seed=31)
    stats, _ = _write_both(tmp_path, "csv", t,
                           lambda w, p: w.partitionBy("b").csv(p))
    assert stats.num_rows == 500
    back = TpuSession(device="cpu").read.csv(
        str(tmp_path / "csv_port")).collect()
    assert back.num_rows == 500


def test_mesh_write_plan_shape(tmp_path):
    """The write lowers to MeshWriteFilesExec, with no gather."""
    t = _rand_table(1000, seed=37)
    _, s = _write_both(tmp_path, "shape", t, lambda w, p: w.parquet(p))
    names = mesh_names(s.last_plan)
    assert "MeshWriteFilesExec" in names and "MeshGatherExec" not in names


def test_mesh_agg_high_cardinality_repartition():
    """~50k keys over ``aggRepartitionThreshold=1024``: the partial
    buffers repartition by key and merge per shard."""
    from spark_rapids_tpu_torch.execs import mesh_execs as me
    rng = np.random.default_rng(41)
    t = pa.table({"k": rng.integers(0, 50000, 60000).astype(np.int64),
                  "v": rng.integers(-100, 100, 60000).astype(np.int64)})
    del me.EXCHANGE_STATS[:]
    _both(lambda s, f, w: s.create_dataframe(t).groupBy("k").agg(
        f.sum("v").alias("sv"), f.count("v").alias("cv"),
        f.min("v").alias("mn")),
        {"spark.rapids.tpu.sql.mesh.aggRepartitionThreshold": "1024"},
        expect=["MeshHashAggregateExec"])
    assert [st["op"] for st in me.EXCHANGE_STATS] == ["magg_part"]


def test_mesh_agg_repartition_with_strings_and_nulls():
    rng = np.random.default_rng(43)
    n = 8000
    t = pa.table({"k": pa.array([None if i % 97 == 0 else f"key_{int(i)}"
                                 for i in rng.integers(0, 3000, n)]),
                  "v": rng.standard_normal(n)})
    _both(lambda s, f, w: s.create_dataframe(t).groupBy("k").agg(
        f.avg("v").alias("av"), f.count(f.lit(1)).alias("c")),
        {"spark.rapids.tpu.sql.mesh.aggRepartitionThreshold": "64"},
        approx=1e-9, expect=["MeshHashAggregateExec"])


def test_mesh_post_agg_stays_distributed():
    """The aggregate's output feeds a filter and a sort on the mesh."""
    rng = np.random.default_rng(47)
    t = pa.table({"k": rng.integers(0, 5000, 20000).astype(np.int64),
                  "v": rng.integers(0, 1000, 20000).astype(np.int64)})
    _both(lambda s, f, w: s.create_dataframe(t).groupBy("k").agg(
        f.sum("v").alias("sv")).filter(f.col("sv") > 300).sort("sv", "k"),
        {"spark.rapids.tpu.sql.mesh.aggRepartitionThreshold": "1024"},
        ignore_order=False,
        expect=["MeshHashAggregateExec", "MeshFilterExec", "MeshSortExec"])


def test_mesh_global_agg_no_keys():
    t = pa.table({"v": np.arange(10000, dtype=np.int64)})
    _both(lambda s, f, w: s.create_dataframe(t).agg(
        f.sum("v").alias("s"), f.count("v").alias("c"),
        f.max("v").alias("m")), expect=["MeshHashAggregateExec"])


def _write_parts(tmp_path, n_files=6, rows=1500, seed=53, fmt="parquet"):
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = pa.table({
            "k": rng.integers(0, 100, rows).astype(np.int64),
            "v": rng.standard_normal(rows),
            "s": pa.array([f"f{i}_{int(x)}"
                           for x in rng.integers(0, 30, rows)])})
        p = str(tmp_path / f"part-{i}.{fmt}")
        (pq.write_table if fmt == "parquet" else po_orc.write_table)(t, p)
    return str(tmp_path)


def test_mesh_parquet_scan_shard_local(tmp_path):
    d = _write_parts(tmp_path)
    _both(lambda s, f, w: s.read.parquet(d).groupBy("k").agg(
        f.sum("v").alias("sv"), f.count("s").alias("c")),
        approx=1e-9, expect=["MeshFileScatterExec"])


def test_mesh_orc_scan_shard_local(tmp_path):
    d = _write_parts(tmp_path, n_files=4, rows=700, seed=59, fmt="orc")
    _both(lambda s, f, w: s.read.orc(d).select(
        "k", (f.col("v") * 2).alias("v2")),
        approx=1e-9, expect=["MeshFileScatterExec"])


def test_mesh_parquet_scan_with_pruning_filter(tmp_path):
    """Row-group pruning changes the per-file counts; the shard-local read
    still sizes its shards exactly."""
    rng = np.random.default_rng(61)
    for i in range(3):
        pq.write_table(pa.table({
            "k": np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64),
            "v": rng.standard_normal(1000)}),
            str(tmp_path / f"p{i}.parquet"), row_group_size=250)
    got, _ = _both(lambda s, f, w: s.read.parquet(str(tmp_path))
                   .filter(f.col("k") >= 2600), approx=1e-9)
    assert got.num_rows == 400


def test_mesh_csv_scan_falls_back_to_scatter(tmp_path):
    """CSV has no metadata row counts: read whole. A bare scan gathered at
    once stays the single-device scan, in both packages; under an
    aggregate the scan is a shard-local one, read whole and scattered."""
    for i in range(3):
        with open(tmp_path / f"c{i}.csv", "w", newline="") as fh:
            w = _csv.writer(fh)
            w.writerow(["a", "b"])
            for j in range(50):
                w.writerow([i * 100 + j, f"s{j}"])
    got, _ = _both(lambda s, f, w: s.read.option("header", "true")
                   .csv(str(tmp_path)), on_mesh=False)
    assert got.num_rows == 150
    got, _ = _both(lambda s, f, w: s.read.option("header", "true")
                   .csv(str(tmp_path)).groupBy("b").agg(
                       f.count("a").alias("n")),
                   expect=["MeshFileScatterExec"])
    assert got.num_rows == 50


def _adaptive_joins(sess):
    return [nd for nd in sess.last_plan.walk()
            if type(nd).__name__ == "MeshShuffledHashJoinExec"]


def test_mesh_adaptive_broadcast_switch():
    """A build side big by its estimate and small once filtered: with
    adaptive execution the mesh join switches to broadcast from the
    observed size; without it, it does not."""
    rng = np.random.default_rng(67)
    fact = pa.table({"k": rng.integers(0, 2000, 30000).astype(np.int64),
                     "v": rng.integers(0, 100, 30000).astype(np.int64)})
    dim = pa.table({"k": np.arange(2000, dtype=np.int64),
                    "pad": pa.array(["x" * 200] * 2000),
                    "grp": pa.array([int(i % 7) for i in range(2000)],
                                    type=pa.int64())})

    def q(s, f, w):
        d = s.create_dataframe(dim).filter(f.col("grp") == 3) \
            .select("k", "grp")
        return s.create_dataframe(fact).join(d, "k") \
            .groupBy("grp").agg(f.sum("v").alias("sv"))
    base = {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
            str(64 * 1024)}
    _, sess = _both(q, {**base, "spark.rapids.tpu.sql.adaptive.enabled":
                        "true"})
    joins = _adaptive_joins(sess)
    assert joins and any(j.adapted_broadcast for j in joins)
    _, sess = _both(q, {**base, "spark.rapids.tpu.sql.adaptive.enabled":
                        "false"})
    joins = _adaptive_joins(sess)
    assert joins and not any(j.adapted_broadcast for j in joins)


def test_mesh_adaptive_right_join_switch():
    """Broadcasting the left side (legal for a right join) also adapts."""
    rng = np.random.default_rng(71)
    left = pa.table({"k": np.arange(4000, dtype=np.int64),
                     "pad": pa.array(["y" * 200] * 4000)})
    big = pa.table({"k": rng.integers(0, 40, 20000).astype(np.int64),
                    "v": rng.integers(0, 9, 20000).astype(np.int64)})

    def q(s, f, w):
        lf = s.create_dataframe(left).filter(f.col("k") < 40)
        return lf.join(s.create_dataframe(big), "k", "right") \
            .groupBy("k").agg(f.count("v").alias("c"))
    _, sess = _both(q, {"spark.rapids.tpu.sql.adaptive.enabled": "true",
                        "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
                            "100000"})
    joins = _adaptive_joins(sess)
    assert joins and any(j.adapted_broadcast for j in joins)
