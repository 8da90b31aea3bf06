"""The CSV and ORC scans and the file writers of the PyTorch port
(``session.read.csv/orc``, ``df.write``, spark_rapids_tpu_torch/io/)
against the JAX package's: the write, CSV and ORC cases of
tests/test_io.py, case for case. Each case writes the same input through
the JAX session (its TPU session, XLA on the CPU) and through the port
(``device="cpu"``) into two directories, then compares the relative file
layout (the job's uuid masked), each file's rows and contents as read by
pyarrow (sorted: an exchange may order a partition's rows differently),
and the read-backs through both sessions. Also the ``orc_meta.py`` and
``writer.py`` copies byte-equal apart from imports, the types through
ORC and parquet, a write from an encoded parquet scan, ``to_pandas`` and
``write_parquet``, and a header-less CSV read with a schema (which the JAX
package fails)."""
import datetime
import os
import re
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.io.write_exec import (CpuWriteFilesExec,
                                                  TpuWriteFilesExec)

from torch_parquet_common import (  # noqa: F401 - fixtures
    fresh_device_managers, one_torch_thread, stop_decode_workers)
from torch_parquet_common import jax_session as _jax
from torch_parquet_common import port_session as _port

ROOT = Path(__file__).resolve().parents[1]
_JOB = re.compile(r"-[0-9a-f]{12}-")
#: float sums within relative 1e-9 only under this key (the reference's
#: carve-out for sums whose order differs)
FLOAT_AGG = "spark.rapids.tpu.sql.variableFloatAgg.enabled"


def sample_table(n=200, seed=3):
    """tests/test_io.py's sample table."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.choice(["x", "y", "z"], n).tolist()),
        "i": pa.array([None if rng.random() < 0.1 else int(v)
                       for v in rng.integers(-50, 50, n)], type=pa.int64()),
        "f": pa.array([None if rng.random() < 0.1 else float(v)
                       for v in rng.uniform(-5, 5, n)], type=pa.float64()),
    })


def _plan_str(sess) -> str:
    return sess.last_plan.tree_string() if sess.last_plan else ""


def _layout(root: str) -> dict:
    """Relative path (the job's uuid masked) -> absolute path of every
    file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), root)
            out[_JOB.sub("-JOB-", rel)] = os.path.join(d, f)
    return out


def _read_file(path: str, header: bool) -> pa.Table:
    if path.endswith(".parquet"):
        return pq.read_table(path)
    if path.endswith(".orc"):
        return po.read_table(path)
    return pacsv.read_csv(path, read_options=pacsv.ReadOptions(
        autogenerate_column_names=not header))


def assert_same_files(jroot: str, troot: str, header: bool = False) -> None:
    """Both writers left the same files, each with the same rows."""
    jl, tl = _layout(jroot), _layout(troot)
    assert sorted(jl) == sorted(tl)
    assert not any("_temporary" in r for r in tl)
    for rel, jpath in jl.items():
        if os.path.basename(rel).startswith("_"):
            continue
        a, b = _read_file(jpath, header), _read_file(tl[rel], header)
        assert a.num_rows == b.num_rows, rel
        assert_tables_equal(a, b, ignore_order=True)


def assert_read_back(jdf, tdf) -> None:
    """The port's read-back equals the JAX session's, unordered."""
    assert_tables_equal(jdf.collect(), tdf.collect().to_arrow(),
                        ignore_order=True)


def _both(tmp_path, name, write):
    """``write(session, create, out)`` through both packages -> (JAX
    stats, port stats, JAX dir, port dir, JAX session, port session)."""
    js, ts = _jax(), _port()
    jout, tout = str(tmp_path / "jax" / name), str(tmp_path / "port" / name)
    jst = write(js, jout)
    tst = write(ts, tout)
    return jst, tst, jout, tout, js, ts


def _same_stats(jst, tst) -> None:
    assert (tst.num_rows, tst.num_files, tst.num_partitions) == \
        (jst.num_rows, jst.num_files, jst.num_partitions)


# ------------------------------------------------------------- copies
@pytest.mark.parametrize("name", ["orc_meta.py", "writer.py"])
def test_io_copy_is_byte_equal_apart_from_imports(name):
    """The ORC footer reader and the writers run on the host only, so the
    port keeps copies of the JAX package's, equal but for the imports."""
    def strip(text):
        return "\n".join(line for line in text.splitlines()
                         if not re.match(r"(import|from) \S", line))
    port = (ROOT / "spark_rapids_tpu_torch" / "io" / name).read_text()
    ref = (ROOT / "spark_rapids_tpu" / "io" / name).read_text()
    assert strip(port) == strip(ref)
    assert "spark_rapids_tpu." not in port


# ------------------------------------------------------------- round trips
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_write_read_roundtrip_tpu(tmp_path, fmt):
    t = sample_table()
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, fmt, lambda s, out: getattr(
            s.create_dataframe(t).write.mode("error"), fmt)(out))
    # the write command itself ran on the device engine
    assert "TpuWriteFilesExec" in _plan_str(ts)
    assert os.path.exists(os.path.join(tout, "_SUCCESS"))
    assert tst.num_rows == t.num_rows and tst.num_files >= 1
    assert tst.num_bytes > 0
    _same_stats(jst, tst)
    assert_same_files(jout, tout)
    assert_read_back(getattr(js.read, fmt)(jout), getattr(ts.read, fmt)(tout))
    assert_tables_equal(t, getattr(ts.read, fmt)(tout).collect().to_arrow()
                        .cast(t.schema), ignore_order=True)


def test_write_csv_falls_back_to_cpu(tmp_path):
    t = sample_table()
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "csv", lambda s, out: s.create_dataframe(t).write
        .option("header", "true").csv(out))
    plan = _plan_str(ts)
    assert "TpuWriteFilesExec" not in plan and "CpuWriteFilesExec" in plan
    lines = ts.last_explain.splitlines()
    assert lines[:2] == [
        "!CpuWriteFilesExec cannot run on TPU",
        "    because CSV writing does not run on TPU (no accelerated CSV "
        "writer in the reference either)"]
    assert ts.last_explain == js.last_explain
    _same_stats(jst, tst)
    assert_same_files(jout, tout, header=True)
    back = ts.read.option("header", "true").csv(tout, schema=None)
    assert back.collect().num_rows == t.num_rows
    assert "TpuCsvScanExec" in _plan_str(ts)
    assert_read_back(js.read.option("header", "true").csv(jout), back)


def test_save_modes(tmp_path):
    t = sample_table(50)
    counts = {}
    for name, s in (("jax", _jax()), ("port", _port())):
        out = str(tmp_path / name / "modes")
        w = lambda: s.create_dataframe(t).write  # noqa: E731
        w().parquet(out)
        with pytest.raises(FileExistsError):
            w().parquet(out)
        w().mode("ignore").parquet(out)           # no-op
        seen = [s.read.parquet(out).collect().num_rows]
        w().mode("append").parquet(out)
        seen.append(s.read.parquet(out).collect().num_rows)
        w().mode("overwrite").parquet(out)
        seen.append(s.read.parquet(out).collect().num_rows)
        counts[name] = seen
    assert counts["port"] == counts["jax"] == [50, 100, 50]
    assert_same_files(str(tmp_path / "jax" / "modes"),
                      str(tmp_path / "port" / "modes"))
    with pytest.raises(ValueError, match="unknown save mode"):
        _port().create_dataframe(t).write.mode("sometimes")


def test_max_records_per_file(tmp_path):
    t = sample_table(100)
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "rolled", lambda s, out: s.create_dataframe(t).write
        .option("maxRecordsPerFile", 30).parquet(out))
    assert tst.num_files == 4  # 30+30+30+10
    _same_stats(jst, tst)
    assert_same_files(jout, tout)
    assert sorted(pq.read_metadata(p).num_rows
                  for r, p in _layout(tout).items()
                  if r.endswith(".parquet")) == [10, 30, 30, 30]
    assert ts.read.parquet(tout).collect().num_rows == 100


def test_unsupported_codec_falls_back(tmp_path):
    t = sample_table(20)
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "lz4hc", lambda s, out: s.create_dataframe(t).write
        .option("compression", "lz4").parquet(out))
    assert "TpuWriteFilesExec" not in _plan_str(ts)
    assert "compression codec 'lz4' is not supported for parquet on TPU" \
        in ts.last_explain
    assert ts.last_explain == js.last_explain
    assert_same_files(jout, tout)


# ------------------------------------------------------------- dynamic partitions
def test_partitioned_write_and_discovery(tmp_path):
    t = sample_table(300)
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "parts", lambda s, out: s.create_dataframe(t).write
        .partitionBy("k").parquet(out))
    assert tst.num_partitions == 3
    _same_stats(jst, tst)
    assert os.path.isdir(os.path.join(tout, "k=x"))
    # the partition column is not inside the data files
    a_file = next(p for r, p in _layout(tout).items()
                  if r.endswith(".parquet"))
    assert "k" not in pq.read_schema(a_file).names
    assert_same_files(jout, tout)
    back = ts.read.parquet(tout)
    # partition columns come back as trailing columns through discovery
    assert back.columns == ["i", "f", "k"]
    assert_read_back(js.read.parquet(jout), back)


def test_partitioned_write_null_keys(tmp_path):
    t = pa.table({"k": pa.array(["a", None, "a", None]),
                  "v": pa.array([1, 2, 3, 4], type=pa.int64())})
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "nullparts", lambda s, out: s.create_dataframe(t).write
        .partitionBy("k").parquet(out))
    assert os.path.isdir(os.path.join(tout, "k=__HIVE_DEFAULT_PARTITION__"))
    assert_same_files(jout, tout)
    back = ts.read.parquet(tout).collect().to_arrow().sort_by("v")
    assert back.column("k").to_pylist() == ["a", None, "a", None]
    assert_read_back(js.read.parquet(jout), ts.read.parquet(tout))


def test_int_partition_values_typed(tmp_path):
    t = pa.table({"year": pa.array([2020, 2021, 2021], type=pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0])})
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "typed", lambda s, out: s.create_dataframe(t).write
        .partitionBy("year").parquet(out))
    assert_same_files(jout, tout)
    df, jdf = ts.read.parquet(tout), js.read.parquet(jout)
    got = [f.dtype.value for f in df.schema() if f.name == "year"]
    assert got == [jdf.schema().field("year").dtype.value]
    assert got[0] in ("int", "long")
    sel = df.filter(F.col("year") == 2021)
    assert sel.collect().num_rows == 2
    assert_read_back(jdf.filter(JF.col("year") == 2021), sel)


def test_mixed_type_partition_values(tmp_path):
    # k=1 and k=foo both read back as strings once the column-wide
    # inferred type is STRING
    d = tmp_path / "mixed"
    (d / "k=1").mkdir(parents=True)
    (d / "k=foo").mkdir(parents=True)
    pq.write_table(pa.table({"v": pa.array([10], type=pa.int64())}),
                   str(d / "k=1" / "f.parquet"))
    pq.write_table(pa.table({"v": pa.array([20], type=pa.int64())}),
                   str(d / "k=foo" / "f.parquet"))
    back = _port().read.parquet(str(d)).collect().to_arrow().sort_by("v")
    assert back.column("k").to_pylist() == ["1", "foo"]
    assert_read_back(_jax().read.parquet(str(d)), _port().read.parquet(str(d)))


def test_orc_roundtrip_partitioned(tmp_path):
    t = sample_table(120)
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "orcparts", lambda s, out: s.create_dataframe(t).write
        .partitionBy("k").orc(out))
    assert "TpuWriteFilesExec" in _plan_str(ts)
    _same_stats(jst, tst)
    assert_same_files(jout, tout)
    back = ts.read.orc(tout).collect().to_arrow()
    assert back.num_rows == 120
    assert set(back.column("k").to_pylist()) == {"x", "y", "z"}
    assert_read_back(js.read.orc(jout), ts.read.orc(tout))


def test_overwrite_replaces_plain_file(tmp_path):
    for name, s in (("jax", _jax()), ("port", _port())):
        target = tmp_path / name / "plain"
        target.parent.mkdir()
        target.write_text("old")
        s.create_dataframe(sample_table(10)).write.mode("overwrite").parquet(
            str(target))
        assert s.read.parquet(str(target)).collect().num_rows == 10
    assert_same_files(str(tmp_path / "jax" / "plain"),
                      str(tmp_path / "port" / "plain"))


def test_csv_partition_discovery(tmp_path):
    d = tmp_path / "csvparts"
    (d / "k=a").mkdir(parents=True)
    (d / "k=b").mkdir(parents=True)
    pacsv.write_csv(pa.table({"v": pa.array([1, 2], type=pa.int64())}),
                    str(d / "k=a" / "f.csv"))
    pacsv.write_csv(pa.table({"v": pa.array([3], type=pa.int64())}),
                    str(d / "k=b" / "f.csv"))
    ts = _port()
    df = ts.read.option("header", "true").csv(str(d))
    back = df.collect().to_arrow().sort_by("v")
    assert back.column("k").to_pylist() == ["a", "a", "b"]
    assert "TpuCsvScanExec" in _plan_str(ts)
    assert_read_back(_jax().read.option("header", "true").csv(str(d)), df)


def test_orc_stripe_pruning_and_chunking(tmp_path):
    """The stripe statistics (read off the file's metadata section) prune
    the stripes a filter rules out, and small stripes coalesce to the
    reader's rows budget, as in the JAX package."""
    from dataclasses import asdict

    from spark_rapids_tpu.exprs import GreaterThanOrEqual as JGe
    from spark_rapids_tpu.exprs import Literal as JLit
    from spark_rapids_tpu.exprs import UnresolvedAttribute as JAttr
    from spark_rapids_tpu.io.orc import clip_stripes as jclip
    from spark_rapids_tpu.io.orc_meta import read_orc_meta as jmeta
    from spark_rapids_tpu_torch.exprs.core import UnresolvedAttribute
    from spark_rapids_tpu_torch.exprs.literals import Literal
    from spark_rapids_tpu_torch.exprs.predicates import GreaterThanOrEqual
    from spark_rapids_tpu_torch.io.orc import TpuOrcScanExec, clip_stripes
    from spark_rapids_tpu_torch.io.orc_meta import read_orc_meta
    from spark_rapids_tpu_torch.testing import assert_tpu_and_cpu_equal

    path = str(tmp_path / "t.orc")
    t = pa.table({
        "k": pa.array(np.arange(10_000), type=pa.int64()),
        "s": pa.array([f"v{i:05d}" for i in range(10_000)]),
        "d": pa.array([datetime.date(2000, 1, 1)
                       + datetime.timedelta(days=i % 90)
                       for i in range(10_000)])})
    po.write_table(t, path, stripe_size=64 * 1024)

    meta = read_orc_meta(path)
    assert len(meta.stripes) > 4
    assert len(meta.stripe_stats) == len(meta.stripes)
    assert meta.stripe_stats[0]["k"].min == 0
    assert meta.stripe_stats[-1]["k"].max == 9_999
    assert meta.stripe_stats[0]["s"].min == "v00000"
    assert asdict(meta) == asdict(jmeta(path))

    kept = clip_stripes(path, [GreaterThanOrEqual(UnresolvedAttribute("k"),
                                                  Literal.of(9_000))],
                        len(meta.stripes))
    assert 0 < len(kept) < len(meta.stripes)
    assert kept == jclip(path, [JGe(JAttr("k"), JLit.of(9_000))],
                         len(meta.stripes))

    # the engine end to end: pushdown and the right rows, the CPU engine
    # against the device path and the port against the JAX package
    cpu = assert_tpu_and_cpu_equal(
        lambda s: s.read.orc(path).filter(F.col("k") >= 9_000)
        .select("k", "s"), device="cpu")
    assert cpu.num_rows == 1_000
    ts = _port()
    df = ts.read.orc(path).filter(F.col("k") >= 9_000).select("k", "s")
    assert_read_back(_jax().read.orc(path).filter(JF.col("k") >= 9_000)
                     .select("k", "s"), df)
    scan = next(n for n in ts.last_plan.walk()
                if isinstance(n, TpuOrcScanExec))
    assert scan.filters
    assert (scan.stripes_read, scan.stripes_total) == (len(kept),
                                                       len(meta.stripes))

    # chunk coalescing: a small rows budget splits the scan into batches
    rows = {"spark.rapids.tpu.sql.reader.batchSizeRows": 3_000}
    cpu = assert_tpu_and_cpu_equal(lambda s: s.read.orc(path).select("k"),
                                   rows, device="cpu")
    assert cpu.num_rows == 10_000
    ts = _port(**rows)
    assert_read_back(_jax(**rows).read.orc(path).select("k"),
                     ts.read.orc(path).select("k"))
    scan = next(n for n in ts.last_plan.walk()
                if isinstance(n, TpuOrcScanExec))
    assert 1 < scan.batches_read < len(meta.stripes)


def test_input_file_meta_csv_and_orc(tmp_path):
    t = pa.table({"v": np.arange(20, dtype=np.int64)})
    po.write_table(t, str(tmp_path / "a.orc"))
    pacsv.write_csv(t, str(tmp_path / "b.csv"))
    ts, js = _port(), _jax()
    for fmt, name in (("orc", "a.orc"), ("csv", "b.csv")):
        r, jr = ts.read, js.read
        if fmt == "csv":
            r, jr = r.option("header", "true"), jr.option("header", "true")
        df = getattr(r, fmt)(str(tmp_path)).select(
            F.input_file_name().alias("fn"))
        out = df.collect().to_arrow()
        assert out.num_rows == 20
        assert all(x.endswith(name) for x in out.column("fn").to_pylist())
        assert_read_back(getattr(jr, fmt)(str(tmp_path)).select(
            JF.input_file_name().alias("fn")), df)


# ------------------------------------------------------------- beyond test_io
def _typed_table(n=300, seed=5):
    """Every type the writers take, with nulls, unicode and empty strings,
    dates and microsecond timestamps around the epoch. Each column draws
    its own nulls: a partition whose column is all null reads back
    through the JAX package's dictionary unifier, which fails on an empty
    dictionary (the port reads it; tests/test_torch_parquet.py)."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.15
    words = ["", "a", "ünï", "longer string value", "x" * 40, "tab\tin"]
    return pa.table({
        "b": pa.array([None if m else bool(v) for m, v in
                       zip(nulls(), rng.integers(0, 2, n))], pa.bool_()),
        "i8": pa.array(rng.integers(-128, 128, n), pa.int8()),
        "i16": pa.array(rng.integers(-3000, 3000, n), pa.int16()),
        "i32": pa.array([None if m else int(v) for m, v in
                         zip(nulls(), rng.integers(-2**31, 2**31, n))],
                        pa.int32()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "s": pa.array([None if m else words[int(v)] for m, v in
                       zip(nulls(), rng.integers(0, len(words), n))],
                      pa.string()),
        "d": pa.array(rng.integers(-40_000, 40_000, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "ts": pa.array([None if m else int(v) for m, v in
                        zip(nulls(), rng.integers(-2**40, 2**40, n))],
                       pa.int64()).cast(pa.timestamp("us", tz="UTC")),
    })


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_types_roundtrip(tmp_path, fmt):
    """Dates, timestamps (ORC stores nanoseconds, the engine
    microseconds), narrow ints, floats, booleans and padded strings write
    and read back as the JAX package's do, partitioned by a string."""
    t = _typed_table()
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, fmt, lambda s, out: getattr(
            s.create_dataframe(t).write.partitionBy("b"), fmt)(out))
    _same_stats(jst, tst)
    assert_same_files(jout, tout)
    back = getattr(ts.read, fmt)(tout)
    assert_read_back(getattr(js.read, fmt)(jout), back)
    got = back.select(*t.column_names).collect().to_arrow()
    assert_tables_equal(t, got.cast(t.schema), ignore_order=True)


@pytest.mark.parametrize("shape", ["scan", "exchange"])
def test_write_from_encoded_parquet_scan(tmp_path, monkeypatch, shape):
    """A batch whose columns arrived dictionary-encoded (the parquet
    scan's device dictionary decode), straight from the scan or through
    the encoded exchange split, writes the values the JAX writer writes
    from the scan."""
    src = str(tmp_path / "src.parquet")
    rng = np.random.default_rng(9)
    n = 4000
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 7, n), pa.int64()),
        "q": pa.array(rng.integers(0, 50, n).astype(np.float64)),
        "s": pa.array([f"grp{int(v)}" for v in rng.integers(0, 5, n)])}),
        src, row_group_size=1000)
    encoded = []
    plain = TpuWriteFilesExec._batch_table

    def batch_table(self, batch):
        encoded.append(any(c.encoding is not None for c in batch.columns))
        return plain(self, batch)
    monkeypatch.setattr(TpuWriteFilesExec, "_batch_table", batch_table)

    def write(s, out):
        df = s.read.parquet(src)
        if shape == "exchange" and isinstance(s, TpuSession):
            df = df.repartition(3, "k")
        return df.write.partitionBy("s").orc(out)
    jst, tst, jout, tout, js, ts = _both(tmp_path, "enc", write)
    assert encoded and all(encoded)
    assert tst.num_rows == jst.num_rows == n
    if shape == "scan":
        _same_stats(jst, tst)
        assert_same_files(jout, tout)
    # after the exchange three tasks write (the JAX side one): the same
    # rows in each directory
    assert_read_back(js.read.orc(jout), ts.read.orc(tout))


def test_write_after_exchange(tmp_path):
    """Four write tasks after a hash exchange: one part file per task, the
    rows of each file the JAX package's (compared sorted)."""
    t = sample_table(400, seed=11)
    jst, tst, jout, tout, js, ts = _both(
        tmp_path, "hashed", lambda s, out: s.create_dataframe(t)
        .repartition(4, "i").write.parquet(out))
    assert tst.num_files == jst.num_files == 4
    _same_stats(jst, tst)
    assert_same_files(jout, tout)


def test_to_pandas_and_write_parquet(tmp_path):
    t = sample_table(40)
    ts, js = _port(), _jax()
    got = ts.create_dataframe(t).filter(F.col("i") > 0).to_pandas()
    want = js.create_dataframe(t).filter(JF.col("i") > 0).toPandas()
    assert got.equals(want)
    ts.create_dataframe(t).write_parquet(str(tmp_path / "one.parquet"))
    js.create_dataframe(t).write_parquet(str(tmp_path / "ref.parquet"))
    assert pq.read_table(str(tmp_path / "one.parquet")).equals(
        pq.read_table(str(tmp_path / "ref.parquet")))


def test_csv_without_header_reads_by_position(tmp_path):
    """With no header and a given schema the columns are named by
    position, as in Spark. The JAX package casts the reader's f0, f1, ...
    to the schema's names and fails (ROADMAP queue 3)."""
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    t = sample_table(30)
    path = str(tmp_path / "noheader")
    ts = _port()
    df = ts.create_dataframe(t)
    df.write.csv(path)
    back = ts.read.csv(path, schema=df.schema())
    assert back.columns == ["k", "i", "f"]
    assert_tables_equal(t, back.collect().to_arrow(), ignore_order=True)
    with pytest.raises(ValueError, match="field names"):
        _jax().read.csv(path, schema=JSchema.from_pa(t.schema)).collect()


def test_csv_unsupported_option_stays_on_cpu(tmp_path):
    t = pa.table({"v": pa.array([1, 2, 3], pa.int64())})
    pacsv.write_csv(t, str(tmp_path / "f.csv"))
    ts, js = _port(), _jax()
    df = ts.read.option("header", "true").option("quote", "'").csv(
        str(tmp_path))
    assert df.collect().num_rows == 3
    js.read.option("header", "true").option("quote", "'").csv(
        str(tmp_path)).collect()
    assert "CSV option 'quote' is not supported on TPU" in ts.last_explain
    assert ts.last_explain == js.last_explain


def test_orc_files_read_side_by_side_in_file_order(tmp_path):
    """More ORC files than host threads: the scan reads them side by side
    and yields their batches in file order, the rows the JAX scan reads;
    a limit that stops the scan early leaves no reader thread."""
    n = 2 * (os.cpu_count() or 1) + 3
    for i in range(n):
        po.write_table(pa.table({"k": pa.array(np.arange(i * 10, i * 10 + 10),
                                               pa.int64())}),
                       str(tmp_path / f"f{i:03d}.orc"))
    ts = _port()
    got = ts.read.orc(str(tmp_path)).collect().to_arrow()
    assert got.column("k").to_pylist() == list(range(n * 10))
    assert_read_back(_jax().read.orc(str(tmp_path)),
                     _port().read.orc(str(tmp_path)))
    assert ts.read.orc(str(tmp_path)).limit(3).collect().num_rows == 3
    assert not [t for t in threading.enumerate()
                if t.name.startswith("orc-read")]


@pytest.mark.parametrize("threads", ["side by side", 0])
def test_failed_file_write_aborts_the_job(tmp_path, monkeypatch, threads):
    """A part file whose encoder fails, on its host thread or in the
    task's, fails the write: the error reaches the caller, the staging
    directory is removed and no _SUCCESS marker is left."""
    from spark_rapids_tpu_torch.io import write_exec, writer
    if threads == 0:
        monkeypatch.setattr(write_exec, "ENCODE_THREADS", 0)

    def broken(self, table):
        raise OSError("disk full")
    monkeypatch.setattr(writer.ParquetOutputWriter, "write", broken)
    out = tmp_path / "failed"
    with pytest.raises(OSError, match="disk full"):
        _port().create_dataframe(sample_table(50)).repartition(3, "i") \
            .write.partitionBy("k").parquet(str(out))
    assert not (out / "_temporary").exists()
    assert not (out / "_SUCCESS").exists()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("file-write")]


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_scans_read_only_the_columns_the_query_reads(tmp_path, fmt):
    """Column pruning: a scan under projections, filters and aggregates
    reads only their columns and at least one data column (a count, or
    only the partition column); the answers are the JAX package's, which
    reads every column (its CPU engine here)."""
    from spark_rapids_tpu.benchmarks import tpch_data as jtd
    from spark_rapids_tpu.benchmarks.tpch_queries import QUERIES as JQ
    from spark_rapids_tpu_torch.benchmarks.tpch_queries import QUERIES
    li = jtd.gen_lineitem_full(0.002, 5)
    # the JAX numpy engine (sql.enabled=false) reads every column
    js = _jax(**{"spark.rapids.tpu.sql.enabled": "false"})
    ts = _port(**{FLOAT_AGG: "true"})
    out = str(tmp_path / fmt)
    w = js.create_dataframe(li).write.partitionBy("l_returnflag")
    getattr(w.option("header", "true") if fmt == "csv" else w, fmt)(out)

    def read(s):
        r = s.read.option("header", "true") if fmt == "csv" else s.read
        return getattr(r, fmt)(out)
    for q, cols in ((1, {"l_quantity", "l_extendedprice", "l_discount",
                         "l_tax", "l_returnflag", "l_linestatus",
                         "l_shipdate"}),
                    (6, {"l_quantity", "l_extendedprice", "l_discount",
                         "l_shipdate"})):
        df = QUERIES[q]({"lineitem": read(ts)})
        assert_tables_equal(JQ[q]({"lineitem": read(js)}).collect(),
                            df.collect().to_arrow(), approx_float=1e-9)
        scans = [n for n in ts.last_plan.walk()
                 if getattr(n, "is_file_scan", False)]
        assert [set(n.output.names()) for n in scans] == [cols]
    assert read(ts).count() == li.num_rows == read(js).count()
    got = read(ts).select("l_returnflag").distinct()
    assert_read_back(read(js).select("l_returnflag").distinct(), got)
    assert got.collect().num_rows == 3


@pytest.mark.parametrize("rows", [0, 1, 1003])
def test_download_arrow_equals_the_host_conversion(rows):
    """The writers' download (``download_arrow``: bitmaps and compacted
    strings made on the device) equals the host batch's ``to_arrow``."""
    import torch

    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.columnar.transfer import (download,
                                                          download_arrow,
                                                          upload)
    t = _typed_table(rows, seed=rows)
    db = upload(HostBatch.from_arrow(t, 256), torch.device("cpu"))
    got = download_arrow(db)
    assert got.equals(download(db).to_arrow())
    assert got.equals(t)


def test_pruned_scan_keeps_the_columns_of_a_filter_under_a_count(tmp_path):
    """A count over a filtered scan reads no column itself: the scan still
    reads the filter's columns."""
    t = sample_table(60)
    path = str(tmp_path / "f.orc")
    po.write_table(t, path)
    got = _port().read.orc(path).filter(F.col("i") > 0).count()
    assert got == _jax().read.orc(path).filter(JF.col("i") > 0).count() > 0


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
@pytest.mark.parametrize("read", ["second", "both"])
def test_pruned_scan_of_two_partition_levels(tmp_path, fmt, read):
    """A table partitioned by two columns, read for some of them only: the
    pruned scan pairs each file's values with the columns it keeps (the
    JAX package reads every column)."""
    rng = np.random.default_rng(17)
    n = 300
    t = pa.table({
        "a": pa.array(rng.choice(["p", "q"], n).tolist()),
        "b": pa.array(rng.choice(["u", "v", "w"], n).tolist()),
        "c": pa.array(rng.integers(0, 4, n), pa.int64()),
        "v": pa.array(rng.integers(-9, 9, n), pa.int64())})
    cols = {"second": ["b", "c"], "both": ["c", "a"]}[read]
    js, ts = _jax(), _port()
    out = str(tmp_path / fmt)
    w = js.create_dataframe(t).write.partitionBy("a", "b", "c")
    getattr(w.option("header", "true") if fmt == "csv" else w, fmt)(out)

    def scan(s):
        r = s.read.option("header", "true") if fmt == "csv" else s.read
        return getattr(r, fmt)(out)
    for q in (lambda df: df.groupBy(*cols).count(),
              lambda df: df.select(*cols),
              lambda df: df.select(cols[-1], "v")):
        got = q(scan(ts))
        assert_read_back(q(scan(js)), got)
        scans = [e for e in ts.last_plan.walk()
                 if getattr(e, "is_file_scan", False)]
        assert len(scans) == 1 and len(scans[0].output) < len(t.schema)


def test_lanes_hold_a_task_that_outruns_the_encoders():
    """A write waits while two tables a host thread wait for their
    encoder, and goes on when one is written."""
    from spark_rapids_tpu_torch.io.write_exec import _Lanes
    lanes = _Lanes(1)
    pool, gate = lanes.lane(), threading.Event()
    lanes.submit(pool, gate.wait)
    lanes.submit(pool, gate.wait)
    third = threading.Thread(target=lanes.submit, args=(pool, gate.wait),
                             daemon=True)
    third.start()
    third.join(0.3)
    assert third.is_alive()
    gate.set()
    third.join(10)
    assert not third.is_alive()
    lanes.finish()


_WRITE_LOOP = """
import numpy as np, pyarrow as pa
from spark_rapids_tpu_torch.api import TpuSession
rng = np.random.default_rng(0)
n = 60000
t = pa.table({"k": pa.array(rng.choice(["x", "y", "z"], n).tolist()),
              "i": pa.array(rng.integers(-50, 50, n), pa.int64()),
              "s": pa.array(rng.choice(["a", "bb", "ccc"], n).tolist()),
              "f": pa.array(rng.random(n))})
df = TpuSession(device="cpu").create_dataframe(t)
for r in range({rounds}):
    for fmt in ("parquet", "orc"):
        w = df.write.mode("overwrite").option("maxRecordsPerFile", 4000)
        st = getattr(w.partitionBy("k"), fmt)("{out}/" + fmt)
        assert st.num_rows == n and st.num_files >= 15, st
print("ROUNDS_OK")
"""


def test_part_files_encoded_side_by_side_in_a_loop(tmp_path):
    """The write command encodes its part files on one host thread per
    CPU: many rounds of partitioned parquet and ORC writes, each of 15 or
    more files side by side, run to their end in a process of their own
    (a crash in an encoder would fail this test, not the test worker)."""
    import subprocess
    import sys
    code = _WRITE_LOOP.replace("{rounds}", "25").replace(
        "{out}", str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ROUNDS_OK" in r.stdout, r.stderr[-2000:]
