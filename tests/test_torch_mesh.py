"""The mesh layer of the PyTorch port against the JAX package's mesh.

The counterparts of tests/test_shuffle_ici.py, tests/test_distributed.py
and the mesh parts of tests/test_named_sharding.py: the port's 8 shards on
the one CPU device against the JAX package's 8 forced host devices. The
exchange delivers each destination the same rows in the same order; the
skew guard flags the same clamped count and re-runs; scatter and gather
keep ``rows_per_shard`` and ``local_capacity``; ``merge_aggregate`` equals
the JAX function on its numpy engine; the distributed aggregate equals the
JAX one; no exchange between shards hops through the host, and a copy
between device kinds is counted; the plan-time
row-group assignment equals the JAX planner's."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import upload
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.parallel.mesh_batch import MeshBatch

from torch_mesh_common import (  # noqa: F401 - fixtures
    CPU, fresh_device_managers, jax_session, mesh_names, mesh_run,
    one_torch_thread, port_session)

N_DEV = 8


def _port_mesh_batch(tables, local_cap):
    """Per-shard arrow tables -> the port's mesh batch (8 CPU shards)."""
    mesh = make_mesh(N_DEV, devices=[CPU])
    shards = tuple(upload(HostBatch.from_arrow(t, 64), CPU, local_cap)
                   for t in tables)
    return MeshBatch(shards[0].schema, shards, mesh)


def _jax_flat(tables, schema, local_cap, smax=64):
    """Per-shard arrow tables -> the JAX mesh's (rows, flat arrays)."""
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    num_rows = np.array([t.num_rows for t in tables], np.int32)
    flats = None
    for t in tables:
        hb = JHostBatch.from_arrow(t.cast(schema), smax)
        bufs = []
        for c in hb.columns:
            pad = local_cap - len(c.validity)
            bufs.append(np.pad(c.data, [(0, pad)] + [(0, 0)] *
                               (c.data.ndim - 1)))
            bufs.append(np.pad(c.validity, (0, pad)))
            if c.lengths is not None:
                bufs.append(np.pad(c.lengths, (0, pad)))
        flats = [[] for _ in bufs] if flats is None else flats
        for f, b in zip(flats, bufs):
            f.append(b)
    return num_rows, [np.concatenate(f) for f in flats]


def _tables(seed=0, local_cap=64, empty=()):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(N_DEV):
        n = 0 if d in empty else int(rng.integers(10, local_cap + 1))
        out.append(pa.table({
            "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
            "s": pa.array([None if i % 7 == 0 else f"d{d}r{i}"
                           for i in range(n)], pa.string()),
            "x": pa.array(rng.normal(size=n), pa.float64())}))
    return out


def _jax_out_rows(out_rows, flat, n_dev, out_cap):
    """The JAX exchange's destination ``p`` rows as (k, x) tuples."""
    rows = []
    for p in range(n_dev):
        sl = slice(p * out_cap, p * out_cap + int(out_rows[p]))
        rows.append(list(zip(np.asarray(flat[0])[sl].tolist(),
                             np.asarray(flat[5])[sl].tolist())))
    return rows


def _port_rows(mb):
    return [list(zip(b.columns[0].data[:b.num_rows].tolist(),
                     b.columns[2].data[:b.num_rows].tolist()))
            for b in mb.shards]


def test_ici_repartition_roundtrip_matches_jax(eight_devices):
    """k % 8 as the destination: every destination gets the JAX
    exchange's rows in its order (source 0's, then source 1's, ...), the
    strings and nulls intact."""
    from spark_rapids_tpu.parallel.mesh import make_mesh as jmake_mesh
    from spark_rapids_tpu.shuffle.ici import build_ici_repartition as jbuild
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu_torch.shuffle.ici import build_ici_repartition
    local_cap = 64
    tables = _tables(0, local_cap)
    mb = _port_mesh_batch(tables, local_cap)
    pids = [b.columns[0].data % N_DEV for b in mb.shards]
    rows, overflow, out = build_ici_repartition(
        mb.mesh, mb.schema, local_cap)(mb, pids)
    assert overflow == 0

    jschema = JSchema.from_pa(tables[0].schema)
    num_rows, flat = _jax_flat(tables, tables[0].schema, local_cap)
    jp = np.zeros(N_DEV * local_cap, np.int32)
    for d, t in enumerate(tables):
        jp[d * local_cap:d * local_cap + t.num_rows] = \
            np.asarray(t["k"]) % N_DEV
    jout = jbuild(jmake_mesh(N_DEV), jschema, local_cap)(num_rows, jp, *flat)
    assert int(jout[1]) == 0
    np.testing.assert_array_equal(rows, np.asarray(jout[0]))
    assert _port_rows(out) == _jax_out_rows(
        jout[0], jout[2:], N_DEV, N_DEV * local_cap)
    from spark_rapids_tpu_torch.columnar.transfer import download
    full = pa.concat_tables(tables)
    for p, b in enumerate(out.shards):
        want = full.filter(pa.compute.equal(
            pa.compute.bit_wise_and(full["k"], 7), p))
        assert_tables_equal(want, download(b).to_arrow(),
                            ignore_order=False)


def test_ici_repartition_empty_shard(eight_devices):
    from spark_rapids_tpu_torch.shuffle.ici import build_ici_repartition
    local_cap = 16
    tables = [pa.table({"k": pa.array(np.arange(0 if d == 3 else 8)
                                      + 100 * d, pa.int64())})
              for d in range(N_DEV)]
    mb = _port_mesh_batch(tables, local_cap)
    pids = [torch.zeros(b.capacity, dtype=torch.int32) for b in mb.shards]
    rows, overflow, out = build_ici_repartition(
        mb.mesh, mb.schema, local_cap)(mb, pids)
    assert overflow == 0 and rows[0] == 7 * 8 and (rows[1:] == 0).all()
    assert out.shards[0].columns[0].data[:56].tolist() == [
        v for d in range(N_DEV) if d != 3 for v in range(100 * d,
                                                         100 * d + 8)]


def test_ici_repartition_skew_overflow_guard(eight_devices):
    """A chunk of 4 with every row bound for shard 0: both packages flag
    the same clamped count, and both re-run loops run until nothing is
    clamped, counting each re-run."""
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.parallel.mesh import make_mesh as jmake_mesh
    from spark_rapids_tpu.shuffle import ici as jici
    from spark_rapids_tpu_torch.shuffle import ici
    local_cap = 32
    tables = [pa.table({"k": pa.array(np.arange(local_cap) + 100 * d,
                                      pa.int64())}) for d in range(N_DEV)]
    mb = _port_mesh_batch(tables, local_cap)
    pids = [torch.zeros(b.capacity, dtype=torch.int32) for b in mb.shards]
    _, clamped, _ = ici.build_ici_repartition(
        mb.mesh, mb.schema, local_cap, chunk_capacity=4)(mb, pids)
    jschema = JSchema.from_pa(tables[0].schema)
    num_rows, flat = _jax_flat(tables, tables[0].schema, local_cap)
    jp = np.zeros(N_DEV * local_cap, np.int32)
    jmesh = jmake_mesh(N_DEV)
    jout = jici.build_ici_repartition(jmesh, jschema, local_cap,
                                      chunk_capacity=4)(num_rows, jp, *flat)
    assert clamped == int(jout[1]) == N_DEV * (local_cap - 4)

    before, jbefore = ici.RERUN_COUNT, jici.RERUN_COUNT
    out = ici.ici_repartition(mb.mesh, mb.schema, local_cap, mb, pids,
                              chunk_capacity=4)
    jrows, jcols = jici.ici_repartition(jmesh, jschema, local_cap, num_rows,
                                        jp, flat, chunk_capacity=4)
    assert ici.RERUN_COUNT - before == jici.RERUN_COUNT - jbefore > 0
    np.testing.assert_array_equal(out.rows_per_shard, np.asarray(jrows))
    assert out.shards[0].columns[0].data[:N_DEV * local_cap].tolist() == \
        np.asarray(jcols[0])[:N_DEV * local_cap].tolist()


@pytest.mark.parametrize("n", [0, 5, 1000, 4097])
def test_scatter_gather_rows_per_shard(n, eight_devices):
    from spark_rapids_tpu.parallel.mesh import make_mesh as jmake_mesh
    from spark_rapids_tpu.parallel.mesh_batch import scatter_arrow as jscat
    from spark_rapids_tpu_torch.columnar.transfer import download
    from spark_rapids_tpu_torch.parallel.mesh_batch import (gather_mesh,
                                                            scatter_arrow)
    rng = np.random.default_rng(n)
    t = pa.table({"k": pa.array(rng.integers(0, 9, n), pa.int64()),
                  "s": pa.array([f"v{i}" for i in range(n)], pa.string())})
    mb = scatter_arrow(t, make_mesh(N_DEV, devices=[CPU]), 16)
    jmb = jscat(t, jmake_mesh(N_DEV), 16)
    np.testing.assert_array_equal(mb.rows_per_shard, jmb.rows_per_shard)
    assert mb.local_capacity == jmb.local_capacity
    assert all(b.capacity == mb.local_capacity for b in mb.shards)
    assert_tables_equal(t, download(gather_mesh(mb)).to_arrow(),
                        ignore_order=False)


def _agg_fns(pkg, schema, names=("v",)):
    bind, attr = pkg.bind_expression, pkg.UnresolvedAttribute
    v = bind(attr("v"), schema)
    s = bind(attr("s"), schema)
    return (pkg.Sum(v), pkg.Count(v), pkg.Min(v), pkg.Max(v),
            pkg.Average(v), pkg.Min(s), pkg.First(v), pkg.Last(s))


def _agg_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 10, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-100, 100, n) / 4.0,
                      mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{int(i)}" for i in rng.integers(0, 30, n)],
                      pa.string(), mask=rng.random(n) < 0.1)})


def test_merge_aggregate_matches_jax():
    """Three shards' Partial buffers (the JAX package's, on its numpy
    engine) merged by both packages' ``merge_aggregate``: the same groups,
    in the same order, with the same results."""
    import spark_rapids_tpu.exprs as J
    import spark_rapids_tpu_torch.exprs as T
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    from spark_rapids_tpu.exprs.core import ColV as JColV
    from spark_rapids_tpu.exprs.core import EvalCtx as JEvalCtx
    from spark_rapids_tpu.ops.aggregate import group_aggregate as jgroup
    from spark_rapids_tpu.ops.aggregate import merge_aggregate as jmerge
    from spark_rapids_tpu_torch.exprs.core import ColV
    from spark_rapids_tpu_torch.ops.aggregate import merge_aggregate
    parts = [_agg_table(n, seed) for seed, n in enumerate((300, 0, 257))]
    jschema = JSchema.from_pa(parts[0].schema)
    tschema = Schema.from_pa(parts[0].schema) if hasattr(
        Schema, "from_pa") else HostBatch.from_arrow(parts[0]).schema
    jfns = _agg_fns(J, jschema)
    tfns = _agg_fns(T, tschema)
    jkey = (J.bind_expression(J.UnresolvedAttribute("k"), jschema),)
    keys, bufs, counts = [], [], []
    for t in parts:
        hb = JHostBatch.from_arrow(t, 64)
        cap = max(hb.num_rows, 1)
        colvs = [JColV(c.dtype, np.resize(c.data, (cap,) + c.data.shape[1:]),
                       np.resize(c.validity, cap) & (np.arange(cap)
                                                     < hb.num_rows),
                       None if c.lengths is None else np.resize(c.lengths,
                                                                cap))
                 for c in hb.columns]
        k, b, ng = jgroup(np, JEvalCtx(np, colvs, cap, 64), jkey, jfns,
                          hb.num_rows, cap, evaluate=False)[:3]
        ng = int(ng)
        keys.append([(v.data[:ng], v.validity[:ng], None if v.lengths is None
                      else v.lengths[:ng]) for v in k])
        bufs.append([(v.data[:ng], v.validity[:ng], None if v.lengths is None
                      else v.lengths[:ng]) for v in b])
        counts.append(ng)

    def cat(per_part, j):
        arrs = [p[j] for p in per_part]
        width = max((a[0].shape[1] for a in arrs if a[0].ndim == 2),
                    default=None)
        if width is not None:
            arrs = [(np.pad(a[0], ((0, 0), (0, width - a[0].shape[1]))),
                     a[1], a[2]) for a in arrs]
        return [np.concatenate([a[i] for a in arrs]) if arrs[0][i]
                is not None else None for i in range(3)]
    total = sum(counts)
    jk = [JColV(f.dtype(), *cat(keys, 0)) for f in jkey]
    jb, tb = [], []
    for j, spec_dt in enumerate([sp.dtype for fn in jfns
                                 for sp in fn.buffer_specs()]):
        d, v, l = cat(bufs, j)
        jb.append(JColV(spec_dt, d, v, l))
    want_k, want_r, want_n = jmerge(np, jk, jb, jfns, total, total)
    tk = [ColV(v.dtype, torch.from_numpy(v.data.copy()),
               torch.from_numpy(v.validity.copy()),
               None if v.lengths is None else
               torch.from_numpy(v.lengths.astype(np.int32)))
          for v in jk]
    tspecs = [sp.dtype for fn in tfns for sp in fn.buffer_specs()]
    tb = [ColV(dt, torch.from_numpy(v.data.copy()),
               torch.from_numpy(v.validity.copy()),
               None if v.lengths is None else
               torch.from_numpy(v.lengths.astype(np.int32)))
          for dt, v in zip(tspecs, jb)]
    got_k, got_r, got_n = merge_aggregate(tk, tb, tfns, total, total)
    assert got_n == int(want_n)
    n = got_n
    for w, g in zip(list(want_k) + list(want_r), list(got_k) + list(got_r)):
        valid = np.asarray(w.validity)[:n]
        np.testing.assert_array_equal(valid, g.validity[:n].numpy())
        wd, gd = np.asarray(w.data)[:n][valid], g.data[:n].numpy()[valid]
        if w.lengths is not None:
            wl = np.asarray(w.lengths)[:n][valid]
            gl = g.lengths[:n].numpy()[valid]
            np.testing.assert_array_equal(wl, gl)
            assert [bytes(r[:m]) for r, m in zip(wd, wl)] == \
                [bytes(r[:m]) for r, m in zip(gd, gl)]
        else:
            np.testing.assert_array_equal(wd, gd)


def test_distributed_aggregate_matches_local(eight_devices):
    """Partial per shard, partials gathered in shard order, one merge (the
    steps ``MeshHashAggregateExec`` runs): the merged groups equal the JAX
    package's distributed aggregate over the same 8 shards, in the same
    order, and one local aggregate of all rows, on every shard device."""
    import spark_rapids_tpu.exprs as J
    import spark_rapids_tpu_torch.exprs as T
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.parallel.distributed import \
        build_distributed_aggregate as jbuild
    from spark_rapids_tpu.parallel.mesh import make_mesh as jmake_mesh
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    from spark_rapids_tpu_torch.exprs.core import EvalCtx
    from spark_rapids_tpu_torch.ops.aggregate import group_aggregate
    from spark_rapids_tpu_torch.parallel.distributed import \
        build_distributed_aggregate
    local_cap = 128
    rng = np.random.default_rng(3)
    tables = []
    for d in range(N_DEV):
        n = int(rng.integers(50, local_cap + 1))
        tables.append(pa.table({
            "k": pa.array(rng.integers(0, 10, n), pa.int64()),
            "v": pa.array(rng.integers(0, 100, n), pa.int64(),
                          mask=rng.random(n) < 0.1)}))

    def fns_of(pkg, schema):
        v = pkg.bind_expression(pkg.UnresolvedAttribute("v"), schema)
        return ((pkg.bind_expression(pkg.UnresolvedAttribute("k"), schema),),
                (pkg.Sum(v), pkg.Count(v), pkg.Min(v), pkg.Max(v),
                 pkg.Average(v)))
    mb = _port_mesh_batch(tables, local_cap)
    kexpr, fns = fns_of(T, mb.schema)
    per_shard, total = build_distributed_aggregate(
        mb.mesh, mb.schema, kexpr, fns, local_cap)(mb)
    assert len(per_shard) == N_DEV

    jschema = JSchema.from_pa(tables[0].schema)
    jkexpr, jfns = fns_of(J, jschema)
    num_rows, flat = _jax_flat(tables, tables[0].schema, local_cap)
    jout = jbuild(jmake_mesh(N_DEV), jschema, jkexpr, jfns,
                  local_cap)(num_rows, *flat)
    assert total == int(jout[-1]) == 10
    want = [(np.asarray(jout[2 * i])[:total],
             np.asarray(jout[2 * i + 1])[:total]) for i in range(6)]

    full = HostBatch.from_arrow(pa.concat_tables(tables))
    fb = upload(full, CPU)
    ref_k, ref_r, ref_n, _ = group_aggregate(
        EvalCtx(colvs_of(fb), fb.capacity, CPU), kexpr, fns, fb.num_rows,
        fb.capacity, grouping="sort")
    assert ref_n == total
    for cols in per_shard:
        for (wd, wv), g, r in zip(want, cols, list(ref_k) + list(ref_r)):
            gv = g.validity[:total].numpy()
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(g.data[:total].numpy()[gv], wd[wv])
            assert g.data[:total].tolist() == r.data[:total].tolist()


def _rand_table(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 37, n).astype(np.int64),
        "v": rng.integers(-1000, 1000, n).astype(np.int64),
        "x": rng.random(n),
        "s": pa.array([f"cat{int(i)}" for i in rng.integers(0, 9, n)])})


def test_in_mesh_exchange_zero_host_hop(eight_devices):
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    from spark_rapids_tpu_torch.execs import mesh_execs as me
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    from spark_rapids_tpu_torch.config import TpuConf
    mb = mbm.scatter_arrow(_rand_table(2048), make_mesh(N_DEV,
                                                        devices=[CPU]), 16)
    key = BoundReference(0, mb.schema.fields[0].dtype, False)
    mbm.reset_counters()
    out = me._mesh_repartition(mb, "t_zero_hop", me._hash_pid_fn(
        (key,), N_DEV, TpuConf({})))
    assert out.num_rows == mb.num_rows
    assert mbm.counters()["host_hop_bytes"] == 0


def test_scatter_device_batch_counts_host_hop():
    """The reshard copies each shard's run device to device: nothing is
    counted between shards of one kind; a copy onto a device of another
    kind (here the ``meta`` device, standing in for a card) counts every
    live byte, as does a broadcast copy (``replicate_device_batch``)."""
    from spark_rapids_tpu_torch.parallel import mesh_batch as mbm
    db = upload(HostBatch.from_arrow(_rand_table(512), 16), CPU)
    mbm.reset_counters()
    mb = mbm.scatter_device_batch(db, make_mesh(N_DEV, devices=[CPU]))
    assert mb.num_rows == 512
    np.testing.assert_array_equal(mb.rows_per_shard, [64] * N_DEV)
    assert mbm.counters()["host_hop_bytes"] == 0
    live = sum(t[:512].nbytes for c in db.columns
               for t in (c.data, c.validity, c.lengths) if t is not None)
    meta = make_mesh(N_DEV, devices=[torch.device("meta")])
    mbm.scatter_device_batch(db, meta)
    assert mbm.counters()["host_hop_bytes"] == live
    mbm.reset_counters()
    mbm.replicate_device_batch(db, meta)
    assert mbm.counters()["host_hop_bytes"] == db.device_size_bytes


def _write_parquet(table, tmpdir, row_groups=16):
    path = os.path.join(tmpdir, "t.parquet")
    pq.write_table(table, path,
                   row_group_size=max(1, table.num_rows // row_groups))
    return path


def _nodes(plan):
    yield plan
    for c in plan.children:
        yield from _nodes(c)


def _scatter_node(plan, cls_name="MeshFileScatterExec"):
    return next(n for n in _nodes(plan) if type(n).__name__ == cls_name)


@pytest.mark.parametrize("shards", [4, 8])
def test_plan_scan_shards_match_jax(tmp_path, shards, eight_devices):
    """A 16-row-group parquet file over 4 and 8 shards: the plan-time
    assignment (units and rows per shard) equals the JAX planner's, and
    the query equals the JAX mesh's."""
    from spark_rapids_tpu.api import functions as JF
    from spark_rapids_tpu_torch.api import functions as F
    t = _rand_table(3200)
    path = _write_parquet(t, str(tmp_path))
    conf = {"spark.rapids.tpu.sql.mesh.numDevices": str(shards)}
    got, sess = mesh_run(lambda s: s.read.parquet(path).groupBy("k").agg(
        F.count("v").alias("c"), F.sum("x").alias("sx")), conf)
    js = jax_session(conf)
    want = js.read.parquet(path).groupBy("k").agg(
        JF.count("v").alias("c"), JF.sum("x").alias("sx")).collect()
    a = _scatter_node(sess.last_plan).assignment
    ja = _scatter_node(js.last_plan).assignment
    assert a is not None and (a.units, a.rows) == (ja.units, ja.rows)
    assert sum(a.rows) == t.num_rows
    assert mesh_names(sess.last_plan) == mesh_names(js.last_plan)
    assert_tables_equal(want, got, ignore_order=True, approx_float=1e-9)


def test_file_assignment_conf_and_mixed_groups(tmp_path):
    """``shardAssignment=file`` leaves no plan-time assignment; a file
    whose row groups mix dictionary and plain pages still scans right."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api import TpuSession
    t = _rand_table(800)
    path = _write_parquet(t, str(tmp_path), row_groups=4)
    got, sess = mesh_run(lambda s: s.read.parquet(path).groupBy("k").agg(
        F.count("v").alias("c")),
        {"spark.rapids.tpu.sql.mesh.scan.shardAssignment": "file"})
    assert _scatter_node(sess.last_plan).assignment is None
    assert got.num_rows == 37
    single = TpuSession(device="cpu").read.parquet(path).groupBy("k").agg(
        F.count("v").alias("c")).collect().to_arrow()
    assert_tables_equal(single, got, ignore_order=True)


def test_mesh_query_zero_host_hop_and_placement(tmp_path):
    """scan -> filter -> aggregate over the mesh: the plan shows the mesh
    placement over 8 shards, and no exchange data crossed the host."""
    from spark_rapids_tpu_torch.api import functions as F
    path = _write_parquet(_rand_table(4000), str(tmp_path), row_groups=8)
    got, sess = mesh_run(lambda s: s.read.parquet(path)
                         .filter(F.col("v") > F.lit(0)).groupBy("s")
                         .agg(F.sum("v").alias("sv")),
                         {"spark.rapids.tpu.sql.broadcastJoinThreshold.bytes":
                          "1"})
    assert got.num_rows > 0
    tree = sess.last_plan.tree_string()
    assert "MeshHashAggregateExec" in tree and "mesh[8]" in tree, tree


def test_quiet_single_device_below_two_shards():
    """``sql.mesh.enabled`` on one shard (the CPU's default: one visible
    device) is a no-op: the plan holds no mesh operator."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as F
    for n in ("0", "1"):
        s = TpuSession({"spark.rapids.tpu.sql.mesh.enabled": "true",
                        "spark.rapids.tpu.sql.mesh.numDevices": n},
                       device="cpu")
        out = s.create_dataframe(_rand_table(300)).groupBy("k").agg(
            F.sum("v").alias("sv")).collect()
        assert out.num_rows == 37
        assert not mesh_names(s.last_plan), s.last_plan.tree_string()


def test_placement_and_peer_groups():
    from spark_rapids_tpu_torch.parallel import placement as pl
    from spark_rapids_tpu_torch.parallel.mesh import (batch_sharding,
                                                      replicated)
    mesh = make_mesh(8, devices=[CPU])
    assert mesh.devices == (CPU,) * 8
    assert pl.placement_label(batch_sharding(mesh)) == "mesh[8]:P('data',)"
    assert pl.placement_label(replicated(mesh)) == "mesh[8]:replicated"
    assert pl.placement_label(None) == "default"
    assert pl.ici_groups([CPU, CPU]) == [[CPU, CPU]]
    assert pl.largest_ici_group([CPU] * 4) == [CPU] * 4
    # a mesh batch, or a batch over two devices, is refused where one
    # device's batch is expected
    db = upload(HostBatch.from_arrow(_rand_table(64), 16), CPU)
    pl.assert_unsharded([db], "concat")
    mb = MeshBatch(db.schema, (db,) * 8, mesh)
    with pytest.raises(ValueError, match="gather it"):
        pl.assert_unsharded([mb], "concat")
    from spark_rapids_tpu_torch.execs.tpu_execs import concat_device_batches
    assert concat_device_batches([db, db], db.schema, CPU).num_rows == 128
    with pytest.raises(ValueError, match="concat_device_batches"):
        concat_device_batches([db, mb], db.schema, CPU)
    assert make_mesh(3, devices=[torch.device("cuda", 0),
                                 torch.device("cuda", 1)]).devices == (
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cuda", 0))
