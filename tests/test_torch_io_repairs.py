"""Faults of the file layer repaired in the PyTorch port (ROADMAP queue 3
items 6, 8, 9 and 10). Each case holds the port against pyarrow, the input
table or Spark's rule, and shows that the JAX package keeps the fault.

- Item 6: a SNAPPY ORC file (the writer's default) is clipped by its
  stripe statistics; the JAX package's footer reader takes NONE and ZLIB
  only, so it reads every stripe.
- Item 8: a CSV column with no value in the first block is a STRING, and
  a null-typed arrow column is an all-null column; the JAX package raises.
- Item 9: string partition values are escaped in directory names as Spark
  escapes them, and unescaped on read; the JAX package reads "e/f" back as
  "e".
- Item 10: a quoted empty CSV field is an empty string and ``nullValue``
  the only null token; the JAX package reads "" and "null" as null."""
import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as po
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F

from torch_parquet_common import (  # noqa: F401 - fixtures
    fresh_device_managers, one_torch_thread, stop_decode_workers)
from torch_parquet_common import jax_session as _jax
from torch_parquet_common import port_session as _port


def _sorted(t: pa.Table, keys) -> pa.Table:
    return t.sort_by([(k, "ascending") for k in keys])


def test_snappy_orc_is_clipped(tmp_path):
    from spark_rapids_tpu.io.orc_meta import read_orc_meta as jmeta
    from spark_rapids_tpu_torch.io.orc import (TpuOrcScanExec,
                                               read_orc_meta_any_codec)
    n = 40_000
    rng = np.random.default_rng(6)
    path = str(tmp_path / "sorted.orc")
    po.write_table(pa.table({
        "k": pa.array(np.arange(n), type=pa.int64()),
        "v": pa.array(rng.random(n)),
        "s": pa.array([f"s{i % 97}" for i in range(n)])}),
        path, stripe_size=64 * 1024, compression="snappy")
    assert po.ORCFile(path).compression == "SNAPPY"
    meta = read_orc_meta_any_codec(path)
    assert len(meta.stripes) == po.ORCFile(path).nstripes > 4
    assert sum(s.num_rows for s in meta.stripes) == n
    assert meta.stripe_stats[-1]["k"].max == n - 1

    ts = _port()
    got = ts.read.orc(path).filter(F.col("k") >= 37_000).collect()
    scan = next(nd for nd in ts.last_plan.walk()
                if isinstance(nd, TpuOrcScanExec))
    assert 0 < scan.stripes_read < scan.stripes_total == len(meta.stripes)
    want = _jax().read.orc(path).filter(JF.col("k") >= 37_000).collect()
    assert want.num_rows == got.num_rows == 3_000
    assert_tables_equal(want, got.to_arrow(), ignore_order=False)
    with pytest.raises(ValueError, match="compression kind 2"):
        jmeta(path)            # the reference reads no snappy footer


def _write(path, text: str) -> None:
    with open(path, "w") as fh:
        fh.write(text)


def test_csv_empty_first_block_column_is_string(tmp_path):
    """Two files, the first with no value in ``s``: the column is a
    STRING, the rows equal pyarrow's read with ``s`` typed string."""
    d = tmp_path / "two"
    d.mkdir()
    _write(d / "a.csv", "i,s\n1,\n2,\n")
    _write(d / "b.csv", "i,s\n3,x\n4,y\n")
    got = _port().read.option("header", "true").csv(str(d)).collect()
    opts = pacsv.ConvertOptions(column_types={"s": pa.string()},
                                null_values=[""], strings_can_be_null=True,
                                quoted_strings_can_be_null=False)
    want = pa.concat_tables([pacsv.read_csv(str(d / f), convert_options=opts)
                             for f in ("a.csv", "b.csv")])
    assert_tables_equal(want, got.to_arrow(), ignore_order=True)
    assert got.to_arrow().column("s").to_pylist() == [None, None, "x", "y"]
    with pytest.raises(Exception, match="null"):
        _jax().read.option("header", "true").csv(str(d)).collect()


def test_null_typed_arrow_column(tmp_path):
    from spark_rapids_tpu.api import TpuSession as JaxSession
    t = pa.table({"n": pa.nulls(3), "i": pa.array([1, 2, 3], pa.int64())})
    got = _port().create_dataframe(t).collect().to_arrow()
    assert got.column("n").null_count == 3
    assert got.column("i").to_pylist() == [1, 2, 3]
    with pytest.raises(Exception, match="null"):
        JaxSession().create_dataframe(t).collect()


def test_csv_partition_with_all_null_first_file(tmp_path):
    """``partitionBy("d")`` where the first part file's string column is
    all null: the read-back equals the input table."""
    n = 60
    t = pa.table({
        "d": pa.array([i % 3 for i in range(n)], pa.int32()),
        "i": pa.array(np.arange(n), pa.int64()),
        "s": pa.array([None if i % 3 == 0 else f"v{i}" for i in range(n)])},
        schema=pa.schema([pa.field("d", pa.int32(), False),
                          ("i", pa.int64()), ("s", pa.string())]))
    path = str(tmp_path / "pcsv")
    _port().create_dataframe(t).write.option("header", "true") \
        .partitionBy("d").csv(path)
    got = _port().read.option("header", "true").csv(path) \
        .select("d", "i", "s").collect().to_arrow()
    assert_tables_equal(t, got, ignore_order=True)
    with pytest.raises(Exception, match="null"):
        _jax().read.option("header", "true").csv(path).collect()


def _strings_table(n=400, seed=10):
    rng = np.random.default_rng(seed)
    words = ["", "a", "null", "b c", 'q"t', "x,y", "NULL", "é"]
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "s": pa.array([None if rng.random() < 0.1 else
                       words[int(rng.integers(0, len(words)))]
                       for _ in range(n)])})


def test_csv_write_read_round_trip_keeps_empty_strings(tmp_path):
    t = _strings_table()
    assert t.column("s").to_pylist().count("") > 0
    path = str(tmp_path / "rt")
    _port().create_dataframe(t).write.option("header", "true").csv(path)
    schema = _port().create_dataframe(t).schema()
    got = _port().read.option("header", "true").csv(path, schema=schema) \
        .collect().to_arrow()
    assert_tables_equal(t, got, ignore_order=True)
    jgot = _jax().read.option("header", "true").csv(path).collect()
    jgot = _sorted(jgot, ["i"]).column("s").to_pylist()
    assert jgot != t.column("s").to_pylist()     # "" and "null" -> null


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_partition_values_with_path_characters(tmp_path, fmt):
    from spark_rapids_tpu.api import TpuSession as JaxSession
    values = ["e/f", "a=b", "c%d", "#x", "?q", ":c", "", "plain"]
    t = pa.table({"k": pa.array(values * 3),
                  "i": pa.array(np.arange(3 * len(values)), pa.int64())})
    path = str(tmp_path / f"p_{fmt}")
    writer = _port().create_dataframe(t).write.partitionBy("k")
    if fmt == "csv":
        writer = writer.option("header", "true")
    getattr(writer, fmt)(path)
    reader = _port().read
    if fmt == "csv":
        reader = reader.option("header", "true")
    got = getattr(reader, fmt)(path).select("i", "k").collect().to_arrow()
    # Spark writes the empty string to the default partition, which reads
    # back as null
    want = pa.table({"i": t.column("i"), "k": pa.array(
        [None if v == "" else v for v in t.column("k").to_pylist()])})
    assert_tables_equal(want, got, ignore_order=True)
    if fmt == "parquet":
        JaxSession({"spark.rapids.tpu.sql.enabled": "false"}) \
            .create_dataframe(t).write.partitionBy("k").parquet(
                str(tmp_path / "jax"))
        back = JaxSession().read.parquet(str(tmp_path / "jax")).collect()
        assert "e" in back.column("k").to_pylist()
