"""The parquet scan of the PyTorch port (``TpuSession.read.parquet``,
spark_rapids_tpu_torch/io/) against the JAX package's: the parquet cases of
tests/test_io.py, each run through both packages on the same files, the JAX
side its TPU session (XLA on the CPU), the port's on the CPU. Exact columns
must match bit for bit, float sums under variableFloatAgg within 1e-9:
row-group clipping and pushdown, schema evolution, hive partitions (int,
string, mixed, null), the legacy-calendar rebase, the decode-ahead
prefetch (equal to the serial read, no thread left after an early exit),
the input-file functions, the device dictionary decode and the page-decode
scan path."""
import datetime
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar import encoding as ce
from spark_rapids_tpu_torch.io.parquet import TpuParquetScanExec

from torch_parquet_common import (  # noqa: F401 - fixtures
    assert_same, stop_decode_workers, fresh_device_managers,
    one_torch_thread)
from torch_parquet_common import jax_session as _jax
from torch_parquet_common import port_session as _port

FLOAT_AGG = "spark.rapids.tpu.sql.variableFloatAgg.enabled"
DICT_KEY = "spark.rapids.tpu.io.parquet.deviceDictDecode.enabled"
PREFETCH = "spark.rapids.tpu.io.scan.prefetchBatches"


def _scan_of(sess) -> TpuParquetScanExec:
    return next(n for n in sess.last_plan.walk()
                if isinstance(n, TpuParquetScanExec))


# ------------------------------------------------------------- pushdown
def test_row_group_clipping(tmp_path):
    from spark_rapids_tpu.exprs import GreaterThan as JGt
    from spark_rapids_tpu.exprs import LessThan as JLt
    from spark_rapids_tpu.exprs import Literal as JLit
    from spark_rapids_tpu.exprs import UnresolvedAttribute as JAttr
    from spark_rapids_tpu.io.parquet import clip_row_groups as jclip
    from spark_rapids_tpu_torch.exprs.core import UnresolvedAttribute
    from spark_rapids_tpu_torch.exprs.literals import Literal
    from spark_rapids_tpu_torch.exprs.predicates import (GreaterThan,
                                                         LessThan)
    from spark_rapids_tpu_torch.io.parquet import clip_row_groups
    path = str(tmp_path / "rg.parquet")
    pq.write_table(pa.table({"x": pa.array(range(1000), type=pa.int64())}),
                   path, row_group_size=100)
    pf = pq.ParquetFile(path)
    assert pf.metadata.num_row_groups == 10
    got = clip_row_groups(pf, [GreaterThan(UnresolvedAttribute("x"),
                                           Literal.of(750))])
    assert got == jclip(pf, [JGt(JAttr("x"), JLit.of(750))]) == [7, 8, 9]
    assert clip_row_groups(pf, [LessThan(UnresolvedAttribute("x"),
                                         Literal.of(0))]) == \
        jclip(pf, [JLt(JAttr("x"), JLit.of(0))]) == []


def test_pushdown_end_to_end(tmp_path):
    path = str(tmp_path / "pd.parquet")
    pq.write_table(pa.table({"x": pa.array(range(1000), type=pa.int64()),
                             "y": pa.array([i * 0.5 for i in range(1000)])}),
                   path, row_group_size=100)
    sess = _port()
    got = sess.read.parquet(path).filter(F.col("x") >= 950).collect()
    assert got.num_rows == 50
    scan = _scan_of(sess)
    assert scan.filters and scan.rows_read == 100    # one row group read
    exp = _jax().read.parquet(path).filter(JF.col("x") >= 950).collect()
    assert_same(exp, got)
    assert got.to_arrow().column("x").to_pylist() == list(range(950, 1000))


# ------------------------------------------------------------- schema evolution
def test_schema_evolution_missing_column(tmp_path):
    d = tmp_path / "evolve"
    d.mkdir()
    pq.write_table(pa.table({"a": pa.array([1, 2], type=pa.int64()),
                             "b": pa.array(["p", "q"])}),
                   str(d / "f1.parquet"))
    pq.write_table(pa.table({"a": pa.array([3], type=pa.int64())}),
                   str(d / "f2.parquet"))
    got = _port().read.parquet(str(d)).collect()
    back = got.to_arrow().sort_by("a")
    assert back.column("a").to_pylist() == [1, 2, 3]
    assert back.column("b").to_pylist() == ["p", "q", None]
    assert_same(_jax().read.parquet(str(d)).collect(), got, sort_by="a")


# ------------------------------------------------------------- hive partitions
def _hive(tmp_path, kind):
    """A hive-partitioned directory: int, string, mixed (k=1 and k=foo read
    back as strings) or null (__HIVE_DEFAULT_PARTITION__) partition
    values."""
    values = {"int": ["2020", "2021", "2021"], "string": ["x", "y", "x"],
              "mixed": ["1", "foo", "1"],
              "null": ["a", "__HIVE_DEFAULT_PARTITION__", "a"]}[kind]
    root = tmp_path / kind
    for i, v in enumerate(values):
        d = root / f"k={v}"
        d.mkdir(parents=True, exist_ok=True)
        pq.write_table(pa.table({"v": pa.array([i * 10, i * 10 + 1],
                                               pa.int64()),
                                 "w": pa.array([i + 0.5, -0.0])}),
                       str(d / f"part{i}.parquet"))
    return str(root)


@pytest.mark.parametrize("kind", ["int", "string", "mixed", "null"])
def test_hive_partitions(tmp_path, kind):
    root = _hive(tmp_path, kind)
    sess = _port()
    df = sess.read.parquet(root)
    exp = _jax().read.parquet(root)
    assert [f.dtype.value for f in df.schema()] == \
        [f.dtype.value for f in exp.schema()]
    assert_same(exp.collect(), df.collect(), sort_by="v")
    if kind == "int":
        got = df.filter(F.col("k") == 2021).collect()
        assert got.num_rows == 4
        assert_same(exp.filter(JF.col("k") == 2021).collect(), got,
                    sort_by="v")
    if kind == "null":
        back = df.collect().to_arrow().sort_by("v")
        assert back.column("k").to_pylist() == ["a", "a", None, None,
                                                "a", "a"]


# ------------------------------------------------------------- legacy calendar
def test_parquet_legacy_calendar_rebase(tmp_path):
    """A file with Spark 2.x writer metadata stores hybrid-Julian day
    counts: both packages rebase its ancient dates and timestamps; a
    modern file passes through."""
    ancient_julian = [-141428, -354285, 0, 18262]
    ts_us = [d * 86_400_000_000 + 7_200_000_000 for d in ancient_julian]
    table = pa.table({
        "d": pa.array(ancient_julian + [None], pa.int32()).cast(pa.date32()),
        "ts": pa.array(ts_us + [None], pa.int64()).cast(pa.timestamp("us")),
        "v": [1.0, 2.0, 3.0, None, 5.0],
    })
    legacy = str(tmp_path / "legacy.parquet")
    pq.write_table(table.replace_schema_metadata(
        {b"org.apache.spark.version": b"2.4.4",
         b"org.apache.spark.legacyDateTime": b""}), legacy)
    modern = str(tmp_path / "modern.parquet")
    pq.write_table(table.replace_schema_metadata(
        {b"org.apache.spark.version": b"3.1.0"}), modern)
    epoch = datetime.date(1970, 1, 1)
    for path in (legacy, modern):
        got = _port().read.parquet(path).collect()
        assert_same(_jax().read.parquet(path).collect(), got)
        days = [None if v is None else (v - epoch).days
                for v in got.to_arrow().column("d").to_pylist()]
        if path == modern:
            assert days == ancient_julian + [None]
        else:
            assert days[0] == -141438 and days[2:] == [0, 18262, None]


# ------------------------------------------------------------- prefetch
def _prefetch_table(tmp_path):
    rng = np.random.default_rng(3)
    n = 6000
    t = pa.table({"k": rng.integers(0, 50, n).astype(np.int64),
                  "v": np.round(rng.standard_normal(n), 3),
                  "s": pa.array([f"r{int(x)}" for x in
                                 rng.integers(0, 90, n)])})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=1000)
    return path


def test_parquet_scan_prefetch_matches_serial(tmp_path):
    path = _prefetch_table(tmp_path)

    def q(sess, f):
        return (sess.read.parquet(path).groupBy("k")
                .agg(f.sum("v").alias("sv"), f.count("s").alias("c"))
                .sort("k")).collect()

    runs = [q(_port(**{FLOAT_AGG: "true", PREFETCH: str(p)}), F)
            for p in (0, 3)]
    assert_same(runs[0].to_arrow(), runs[1])
    exp = q(_jax(**{FLOAT_AGG: "true"}), JF)
    assert_tables_equal(exp, runs[1].to_arrow(), approx_float=1e-9)


def test_prefetch_early_exit_leaves_no_thread(tmp_path):
    path = _prefetch_table(tmp_path)
    for pipeline in ("true", "false"):
        sess = _port(**{PREFETCH: "2", "spark.rapids.tpu.transfer.pipeline."
                        "enabled": pipeline})
        got = sess.read.parquet(path).limit(5).collect()
        assert got.num_rows == 5
        assert not [t for t in threading.enumerate()
                    if t.name == "parquet-scan-prefetch"]


# ------------------------------------------------------------- input file
def _files(tmp_path, n=3, extra=False):
    paths = []
    for i in range(n):
        cols = {"k": np.arange(i * 10, i * 10 + 10, dtype=np.int64)}
        if extra:
            cols["x"] = np.full(10, i, dtype=np.int64)
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table(cols), p)
        paths.append(p)
    return paths


def test_input_file_name_and_block(tmp_path):
    paths = _files(tmp_path)

    def q(sess, f):
        return sess.read.parquet(str(tmp_path)).select(
            "k", f.input_file_name().alias("fn"),
            f.input_file_block_start().alias("bs"),
            f.input_file_block_length().alias("bl")).collect()

    got = q(_port(), F)
    rows = {r["k"]: r for r in got.to_arrow().to_pylist()}
    assert rows[5]["fn"].endswith("f0.parquet")
    assert rows[25]["fn"].endswith("f2.parquet")
    assert all(r["bs"] == 0 for r in rows.values())
    assert rows[5]["bl"] == os.path.getsize(paths[0])
    assert_same(q(_jax(), JF), got, sort_by="k")

    def agg(sess, f):
        return (sess.read.parquet(str(tmp_path))
                .groupBy(f.input_file_name().alias("fn"))
                .agg(f.count("k").alias("c")).collect())

    assert_same(agg(_jax(), JF), agg(_port(), F), sort_by="fn")


def test_input_file_name_requires_file_scan():
    df = _port().create_dataframe(pa.table({"a": [1, 2]})).select(
        F.input_file_name().alias("f"))
    with pytest.raises(Exception, match="file scan"):
        df.collect()


def test_input_file_meta_hidden_columns_do_not_leak(tmp_path):
    _files(tmp_path, 2)
    sess = _port()
    got = sess.read.parquet(str(tmp_path)).filter(
        F.input_file_name().contains("f0")).collect()
    assert got.schema.names() == ["k"]
    assert sorted(got.to_arrow().column("k").to_pylist()) == list(range(10))
    exp = _jax().read.parquet(str(tmp_path)).filter(
        JF.input_file_name().contains("f0")).collect()
    assert_same(exp, got, sort_by="k")

    def union(sess, f):
        u = sess.read.parquet(str(tmp_path)).union(
            sess.create_dataframe(pa.table({"k": pa.array([99],
                                                          pa.int64())})))
        return u.select("k", f.input_file_name().alias("fn")).collect()

    got = union(_port(), F)
    by_k = dict(zip(got.to_arrow().column("k").to_pylist(),
                    got.to_arrow().column("fn").to_pylist()))
    assert by_k[99] == "" and by_k[0].endswith("f0.parquet")
    assert_same(union(_jax(), JF), got, sort_by="k")


def test_input_file_meta_through_projections(tmp_path):
    _files(tmp_path, 2, extra=True)

    def q(sess, f):
        return sess.read.parquet(str(tmp_path)).select("k").select(
            "k", f.input_file_name().alias("fn")).collect()

    got = q(_port(), F)
    assert got.schema.names() == ["k", "fn"]
    assert_same(q(_jax(), JF), got, sort_by="k")

    def union(sess, f):
        return (sess.read.parquet(str(tmp_path)).select("k")
                .union(sess.create_dataframe(
                    pa.table({"k": pa.array([99], pa.int64())})))
                .select("k", f.input_file_name().alias("fn")).collect())

    got = union(_port(), F)
    by_k = dict(zip(got.to_arrow().column("k").to_pylist(),
                    got.to_arrow().column("fn").to_pylist()))
    assert by_k[99] == "" and by_k[3].endswith("f0.parquet")
    assert_same(union(_jax(), JF), got, sort_by="k")


# ------------------------------------------------------------- device decode
def test_parquet_device_dict_decode_bit_identical(tmp_path):
    """Fixed-width columns cross the link dictionary-encoded and decode on
    the device: bit-identical to the host decode and to the JAX package,
    with nulls, doubles, dates and a column parquet writes PLAIN."""
    rng = np.random.default_rng(3)
    n = 8000
    table = pa.table({
        "qty": pa.array([None if i % 97 == 0 else float(rng.integers(1, 51))
                         for i in range(n)], pa.float64()),
        "disc": pa.array((rng.integers(0, 11, n) / 100.0)),
        "d": pa.array(rng.integers(8000, 8060, n), pa.int32()).cast(
            pa.date32()),
        "hi": pa.array(rng.random(n)),          # ~unique: PLAIN fallback
        "tag": pa.array([f"t{int(x)}" for x in rng.integers(0, 5, n)]),
        "k": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
    })
    path = str(tmp_path / "dict.parquet")
    pq.write_table(table, path, row_group_size=3000)
    exp = _jax().read.parquet(path).collect()
    ce.reset_counters()
    on = _port().read.parquet(path).collect()
    c = ce.counters()
    assert c["encoded_bytes"] < c["decoded_equivalent_bytes"]
    off = _port(**{DICT_KEY: "false"}).read.parquet(path).collect()
    assert_same(exp, on)
    assert_same(exp, off)

    def q(sess, f):
        return (sess.read.parquet(path).groupBy("tag")
                .agg(f.min("qty").alias("mn"), f.max("disc").alias("mx"),
                     f.count("d").alias("c")).sort("tag").collect())

    assert_same(q(_jax(), JF), q(_port(), F))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_parquet_page_decode_scan_path(tmp_path, version):
    """The page reader's columns (dictionary indices, runs, a PLAIN tail,
    nulls) ride the scan end to end, for data pages v1 and v2: equal to
    the host decode and to the JAX package bit for bit."""
    rng = np.random.default_rng(9)
    n = 30000
    table = pa.table({
        "k": pa.array(rng.integers(0, 40, n), pa.int64()),
        "price": pa.array([None if i % 501 == 0
                           else float(rng.integers(1, 9000)) / 100
                           for i in range(n)], pa.float64()),
        "dense": pa.array(rng.random(n)),
        "run": pa.array(np.repeat(np.arange(6), n // 6).astype(np.int32)),
        "d": pa.array(rng.integers(8000, 8200, n), pa.int32()).cast(
            pa.date32()),
        "tag": pa.array([None if i % 997 == 0 else f"tag{int(x)}"
                         for i, x in enumerate(rng.integers(0, 23, n))]),
    })
    path = str(tmp_path / f"pages_{version}.parquet")
    pq.write_table(table, path, row_group_size=10000,
                   data_page_version=version)
    sess = _port()
    got = sess.read.parquet(path).collect()
    assert_same(_jax().read.parquet(path).collect(), got)
    assert_same(_port(**{DICT_KEY: "false"}).read.parquet(path).collect()
                .to_arrow(), got)


def test_all_null_row_group_of_a_fixed_width_column(tmp_path):
    """A row group whose fixed-width column is all null has an empty
    dictionary page. The port decodes it on the host; the JAX package's
    device scan raises IndexError on it (ROADMAP queue 3), so the answer is
    held against its scan with the device decode off."""
    path = str(tmp_path / "nulltail.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2, 3, None, None, None],
                                           pa.int64()),
                             "b": pa.array(np.arange(6))}),
                   path, row_group_size=3)
    got = _port().read.parquet(path).collect()
    assert_same(_jax(**{DICT_KEY: "false"}).read.parquet(path).collect(),
                got)
    assert got.to_arrow().column("a").to_pylist() == [1, 2, 3, None, None,
                                                      None]


def test_page_decode_processes_equal_inline_and_survive_early_exit(
        tmp_path, monkeypatch):
    """The fixed-width chunks decoded in worker processes give the tables
    of a one-core host's decode in the scan's thread; a scan left after
    one batch hands its workers back clean, and the next scan is still
    exact."""
    from spark_rapids_tpu_torch.columnar.dtypes import Schema
    from spark_rapids_tpu_torch.columnar.encoding import DictionaryUnifier
    from spark_rapids_tpu_torch.io import page_pool
    from spark_rapids_tpu_torch.io.datasource import PartitionedFile
    from spark_rapids_tpu_torch.io.parquet import (_iter_file_tables,
                                                   schema_of_arrow)
    rng = np.random.default_rng(17)
    n = 24000
    path = str(tmp_path / "p.parquet")
    pq.write_table(pa.table({
        "a": pa.array(rng.integers(0, 30, n), pa.int64()),
        "b": pa.array([None if i % 7 == 0 else float(i % 50)
                       for i in range(n)]),
        "c": pa.array(np.repeat(np.arange(8), n // 8).astype(np.int32))}),
        path, row_group_size=3000)
    schema = schema_of_arrow(pq.read_schema(path))

    def scan():
        return _iter_file_tables(PartitionedFile(path), schema, Schema([]),
                                 (), 1 << 31, 1 << 31, device_dict=True,
                                 device_rle=True,
                                 unifier=DictionaryUnifier())

    def flat(tables):
        return [[(c.combine_chunks().indices.to_pylist(),
                  c.combine_chunks().dictionary.to_pylist())
                 if pa.types.is_dictionary(c.type)
                 else c.combine_chunks().to_pylist() for c in t.columns]
                for t in tables]

    with monkeypatch.context() as one_core:
        one_core.setattr(page_pool.os, "cpu_count", lambda: 1)
        page_pool.shutdown()        # no idle worker left to lend
        inline = flat(scan())
        assert page_pool.live_workers() == 0
    first = scan()
    next(first)
    first.close()               # the workers' results in flight drained
    assert flat(scan()) == inline
    assert page_pool.live_workers() > 1
    assert len(inline) == 8
