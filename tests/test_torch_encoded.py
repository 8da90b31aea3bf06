"""The encoded domain of the PyTorch port against the JAX package: the
cases of tests/test_encoded_path.py, each run through both packages on the
same input (the JAX side its TPU session, XLA on the CPU; the port's on the
CPU): encoded and run-end-encoded uploads bit-identical to the decoded
ones (with -0.0 and NaN dictionaries), the staged-byte counters,
mixed-encoding chunks and the per-column fallback, unifier tokens and the
concatenation's carry, Q1- and Q3-shaped plans on dictionary indices, the
join remap, null-tolerant predicates and float keys staying decoded, the
planner pass, the exchange with ``sql.exchange.keepEncodings`` on and off,
and an in-memory table with dictionary and run-end-encoded columns (which
the port refused before)."""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxDeviceBatch
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.columnar import encoding as ce
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.transfer import (download, upload,
                                                      upload_arrow)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import ExecContext
from spark_rapids_tpu_torch.execs.tpu_execs import concat_device_batches
from spark_rapids_tpu_torch.io.datasource import PartitionedFile
from spark_rapids_tpu_torch.io.parquet import (TpuParquetScanExec,
                                               schema_of_arrow)
from spark_rapids_tpu_torch.io.parquet_pages import (merge_runs,
                                                     read_dict_column,
                                                     rle_bp_decode,
                                                     rle_bp_runs)
from spark_rapids_tpu_torch.plan.encoded import count_encoded_domain

from torch_parquet_common import (  # noqa: F401 - fixtures
    assert_same, stop_decode_workers, fresh_device_managers,
    one_torch_thread)
from torch_parquet_common import jax_session as _jax
from torch_parquet_common import port_session as _port

CPU = torch.device("cpu")
Q1_CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true",
           "spark.rapids.tpu.sql.string.maxBytes": "16",
           "spark.rapids.tpu.sql.scanCache.enabled": "false"}
DECODED = {"spark.rapids.tpu.sql.encodedDomain.enabled": "false",
           "spark.rapids.tpu.io.parquet.deviceDictDecode.enabled": "false"}


def _write(table, tmp_path, name="t.parquet", **kw) -> str:
    path = str(tmp_path / name)
    pq.write_table(table, path, **kw)
    return path


def _scan_batches(path, schema, conf=None):
    scan = TpuParquetScanExec((PartitionedFile(path),), schema)
    return list(scan.execute(ExecContext(TpuConf(conf or {}), CPU)))


def _roundtrip(path, table, conf=None):
    batches = _scan_batches(path, schema_of_arrow(table.schema), conf)
    hb = [download(b) for b in batches]
    return pa.concat_tables(h.to_arrow() for h in hb), batches


def _ops() -> int:
    return ce.counters()["encoded_domain_ops"]


# ------------------------------------------------------- upload bit-identity
def _encoded_vs_decoded_table():
    rng = np.random.default_rng(7)
    n = 5000
    return pa.table({
        "dict_str": pa.array(np.array(["aa", "bb", "cc"])[
            rng.integers(0, 3, n)]).dictionary_encode(),
        "dict_i64": pa.array(rng.integers(0, 9, n),
                             pa.int64()).dictionary_encode(),
        "dict_f64": pa.array(np.round(rng.uniform(0, 1, n), 2),
                             pa.float64()).dictionary_encode(),
        "signed_zero_nan": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 4, n).astype(np.int8)),
            pa.array([0.0, -0.0, float("nan"), 1.5])),
        "nulls": pa.array([None if v % 11 == 0 else int(v)
                           for v in rng.integers(0, 6, n)],
                          pa.int64()).dictionary_encode(),
        "plain_f64": pa.array(rng.uniform(size=n) * 1e9),
    })


def _assert_columns_bitwise(a, b, n):
    """Two device batches hold the same bytes in every live row."""
    for ci, (x, y) in enumerate(zip(a.columns, b.columns)):
        assert torch.equal(x.validity[:n], y.validity[:n]), ci
        xd, yd = x.data[:n], y.data[:n]
        if x.lengths is not None:
            assert torch.equal(x.lengths[:n], y.lengths[:n]), ci
            w = max(xd.shape[1], yd.shape[1])
            xd = torch.nn.functional.pad(xd, (0, w - xd.shape[1]))
            yd = torch.nn.functional.pad(yd, (0, w - yd.shape[1]))
        assert torch.equal(xd.contiguous().view(torch.uint8),
                           yd.contiguous().view(torch.uint8)), ci


def test_encoded_upload_bit_identical_to_decoded():
    """Dictionary (string, int, double, -0.0/NaN) and null-bearing columns:
    the encoded upload equals the decoded upload of the same rows byte for
    byte, chunked or not, and the JAX package's."""
    t = _encoded_vs_decoded_table()
    dec = upload(HostBatch.from_arrow(t, 16), CPU)
    for chunk_rows in (0, 1500):
        enc = upload_arrow(t, CPU, 16, chunk_rows=chunk_rows)
        _assert_columns_bitwise(enc, dec, t.num_rows)
    assert_same(JaxDeviceBatch.from_arrow(t, 16).to_arrow(), download(enc))
    by = {f.name: c for f, c in zip(enc.schema, enc.columns)}
    assert by["dict_str"].encoding is not None
    assert by["dict_str"].encoding.lengths is not None
    assert by["plain_f64"].encoding is None
    # -0.0 and 0.0 (and NaN) are distinct slots but not distinct values:
    # index identity would be unsound, so the encoding is not kept
    assert by["signed_zero_nan"].encoding is None
    enc_col = by["dict_i64"]
    assert torch.equal(enc_col.data[:t.num_rows],
                       enc_col.encoding.values.index_select(
                           0, enc_col.encoding.indices[:t.num_rows]))


def test_ree_upload_bit_identical():
    ends = pa.array(np.array([100, 228, 412, 500], np.int32))
    vals = pa.array([1.5, -0.0, float("nan"), 3.75], pa.float64())
    ree = pa.RunEndEncodedArray.from_arrays(ends, vals)
    t = pa.table({"x": ree})
    plain = pa.table({"x": ce.ree_to_plain(ree)})
    _assert_columns_bitwise(upload_arrow(t, CPU, 16),
                            upload(HostBatch.from_arrow(plain, 16), CPU), 500)
    # a slice stays a run form and stays exact
    s = t.slice(150, 300)
    got = download(upload_arrow(s, CPU, 16, chunk_rows=64))
    assert_same(JaxDeviceBatch.from_arrow(s, 16).to_arrow(), got)
    assert_tables_equal(plain.slice(150, 300), got.to_arrow())


def test_ree_expand_with_nulls_matches_host():
    ree = pa.RunEndEncodedArray.from_arrays(
        pa.array([3, 7, 12], pa.int32()), pa.array([5, None, -2], pa.int64()))
    t = pa.table({"r": ree})
    _assert_columns_bitwise(upload_arrow(t, CPU),
                            upload(HostBatch.from_arrow(t), CPU), 12)


def test_upload_counts_encoded_vs_decoded_bytes():
    t = _encoded_vs_decoded_table()
    ce.reset_counters()
    upload_arrow(t, CPU, 16)
    c = ce.counters()
    n = t.num_rows
    # the string dictionary: uint8 indices + its 3 x 8 matrix and lengths
    # against the decoded n x 8 matrix and lengths
    assert 0 < c["encoded_bytes"] < c["decoded_equivalent_bytes"]
    plain = n * 8 + n                       # plain_f64: data + validity
    idx_only = 4 * n                        # 4 dictionary columns' uint8
    assert c["encoded_bytes"] >= plain + idx_only


# ------------------------------------------------------------- runs parsing
def test_rle_bp_runs_matches_decode_and_merges():
    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out
    bw = 2
    packed_vals = [0, 1, 2, 3, 0, 1, 2, 3]
    packed = np.packbits(
        np.array([[(v >> i) & 1 for i in range(bw)] for v in packed_vals],
                 np.uint8).reshape(-1), bitorder="little").tobytes()
    stream = (varint(7 << 1) + bytes([3]) + varint((1 << 1) | 1) + packed
              + varint(5 << 1) + bytes([1]))
    buf = memoryview(stream)
    expanded = rle_bp_decode(buf, bw, 20)
    rv, rl = rle_bp_runs(buf, bw, 20)
    assert np.array_equal(np.repeat(rv, rl), expanded)
    mv, ml = merge_runs(np.array([3, 3, 1, 1, 1, 2], np.int32),
                        np.array([2, 5, 1, 1, 3, 4], np.int64))
    assert mv.tolist() == [3, 1, 2] and ml.tolist() == [7, 5, 4]


def test_scan_keeps_rle_dominant_column_as_runs(tmp_path):
    n = 30000
    rng = np.random.default_rng(0)
    t = pa.table({"r": pa.array(np.sort(rng.integers(0, 15, n))
                                .astype(np.int64)),
                  "x": pa.array(rng.uniform(size=n))})
    path = _write(t, tmp_path, row_group_size=10000)
    pf = pq.ParquetFile(path)
    r = read_dict_column(path, pf.metadata, 0, 0, pa.int64(),
                         want_runs=True)
    assert pa.types.is_run_end_encoded(r.prefix.type)
    assert len(r.prefix.values) < 40
    ce.reset_counters()
    out, _ = _roundtrip(path, t)
    assert out.equals(t)
    # the runs crossed the link: "r" saved nearly all its n x 8 bytes
    c = ce.counters()
    assert c["decoded_equivalent_bytes"] - c["encoded_bytes"] > n * 8 - 2000
    out2, _ = _roundtrip(path, t, {
        "spark.rapids.tpu.io.parquet.deviceRleExpand.enabled": "false"})
    assert out2.equals(t)
    assert_same(_jax().read.parquet(path).collect(),
                _port().read.parquet(path).collect())


def test_per_column_fallback_when_encoding_does_not_shrink(tmp_path):
    rng = np.random.default_rng(1)
    t = pa.table({"hc": pa.array(rng.integers(0, 1 << 60, 20000,
                                              dtype=np.int64))})
    path = _write(t, tmp_path)
    pf = pq.ParquetFile(path)
    assert read_dict_column(path, pf.metadata, 0, 0, pa.int64()) is None
    out, batches = _roundtrip(path, t)
    assert out.equals(t)
    assert all(b.columns[0].encoding is None for b in batches)


def test_mixed_encoding_chunk_keeps_prefix_encoded(tmp_path):
    """A PLAIN fallback mid-chunk: the dictionary prefix stays encoded, only
    the tail decodes on the host, and the scan splits the row group at the
    boundary."""
    n = 50000
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 1 << 40, n).astype(np.int64)
    vals[:2000] = vals[0]
    t = pa.table({"m": pa.array(vals),
                  "d": pa.array(rng.integers(0, 5, n).astype(np.int32))})
    path = _write(t, tmp_path, dictionary_pagesize_limit=2048,
                  data_page_size=4096, row_group_size=n)
    pf = pq.ParquetFile(path)
    r = read_dict_column(path, pf.metadata, 0, 0, pa.int64())
    assert r is not None and r.tail is not None
    assert pa.types.is_dictionary(r.prefix.type)
    out, batches = _roundtrip(path, t)
    assert out.equals(t)
    assert len(batches) >= 2          # split at the prefix/tail boundary
    assert_same(_jax().read.parquet(path).collect(),
                _port().read.parquet(path).collect())


# ----------------------------------------------- unification + concat carry
def test_unifier_tokens_make_concat_carry_encoding(tmp_path):
    n = 9000
    rng = np.random.default_rng(3)
    t = pa.table({
        "s": pa.array(np.array(["x", "y", "z", "w"])[rng.integers(0, 4, n)]),
        "k": pa.array(rng.integers(0, 30, n).astype(np.int64))})
    path = _write(t, tmp_path, row_group_size=3000)
    schema = schema_of_arrow(t.schema)
    batches = _scan_batches(path, schema)
    assert len(batches) >= 3
    for ci in range(2):
        encs = [b.columns[ci].encoding for b in batches]
        assert all(e is not None for e in encs)
        assert len({e.token for e in encs}) == 1
    merged = concat_device_batches(batches, schema, CPU)
    for ci in range(2):
        col = merged.columns[ci]
        enc = col.encoding
        assert enc is not None
        assert torch.equal(col.data[:n],
                           enc.values.index_select(0, enc.indices[:n]))
    # two scans are two dictionary streams: no carry
    other = _scan_batches(path, schema)
    mixed = concat_device_batches([batches[0], other[1]], schema, CPU)
    assert mixed.columns[0].encoding is None


def test_unifier_remaps_into_prefix_compatible_dictionary():
    from spark_rapids_tpu.columnar.encoding import \
        DictionaryUnifier as JaxUnifier
    for u in (ce.DictionaryUnifier(), JaxUnifier()):
        ua, tok_a = u.unify("col", pa.array(["b", "a", "b"])
                            .dictionary_encode())
        ub, tok_b = u.unify("col", pa.array(["c", "a"]).dictionary_encode())
        assert tok_a == tok_b
        assert ua.to_pylist() == ["b", "a", "b"]
        assert ub.to_pylist() == ["c", "a"]
        assert ub.dictionary.to_pylist() == ["b", "a", "c"]
        assert ub.indices.to_pylist() == [2, 1]


def test_unifier_preserves_negative_zero_and_nan_bits(tmp_path):
    t = pa.table({"z": pa.array([0.0, -0.0, float("nan"), 1.5] * 2000)})
    path = _write(t, tmp_path, row_group_size=1000)
    out, batches = _roundtrip(path, t)
    assert_tables_equal(t, out)
    assert sum(1 for v in out["z"].to_pylist()
               if v == 0.0 and str(v).startswith("-")) == 2000
    assert all(b.columns[0].encoding is None for b in batches)
    u = ce.DictionaryUnifier()
    d = pa.array(np.array([0.0, -0.0, np.nan, 1.5])).dictionary_encode()
    u1, tok1 = u.unify("z", d)
    u2, tok2 = u.unify("z", d)
    assert tok1 == tok2 and len(u2.dictionary) == 4
    assert len(set(np.asarray(u2.dictionary).view(np.uint64).tolist())) == 4
    assert_same(_jax().read.parquet(path).collect(),
                _port().read.parquet(path).collect())


# ------------------------------------------------- encoded-domain operators
def _lineitem_parquet(tmp_path, n=20000):
    from spark_rapids_tpu_torch.benchmarks.tpch import gen_lineitem
    t = gen_lineitem(n / 6_000_000, 11).to_arrow()
    return _write(t, tmp_path, "lineitem.parquet",
                  row_group_size=max(1, t.num_rows // 3))


def test_q1_shaped_encoded_domain_equivalence(tmp_path):
    """TPC-H Q1 over parquet: grouping on the string keys' indices and the
    folded filter on the dictionaries equal the decoded path and the JAX
    package, and really ran on the encoded domain."""
    from spark_rapids_tpu.benchmarks.tpch import q1 as jq1
    from spark_rapids_tpu_torch.benchmarks.tpch import q1
    path = _lineitem_parquet(tmp_path)
    before = _ops()
    enc = q1(_port(**Q1_CONF).read.parquet(path)).collect()
    assert _ops() > before
    before = _ops()
    dec = q1(_port(**Q1_CONF, **DECODED).read.parquet(path)).collect()
    assert _ops() == before
    assert_same(enc.to_arrow(), dec)
    exp = jq1(_jax(**Q1_CONF).read.parquet(path)).collect()
    assert_tables_equal(exp, enc.to_arrow(), approx_float=1e-9)


def _q3_shape(sess, f, p1, p2):
    o, c = sess.read.parquet(p1), sess.read.parquet(p2)
    return (o.filter(f.col("seg") == "AUTO")
            .join(c, [("o_key", "c_key")], how="inner")
            .groupBy("nation")
            .agg(f.sum("price").alias("rev"), f.count().alias("cnt"))
            .sort("nation")).collect()


def test_q3_shaped_encoded_domain_join_equivalence(tmp_path):
    rng = np.random.default_rng(5)
    n, m = 15000, 400
    orders = pa.table({
        "o_key": pa.array(rng.integers(0, 300, n).astype(np.int64)),
        "seg": pa.array(np.array(["AUTO", "HOME", "SHIP"])[
            rng.integers(0, 3, n)]),
        "price": pa.array(np.round(rng.uniform(1, 100, n), 2))})
    cust = pa.table({
        "c_key": pa.array(rng.integers(0, 300, m).astype(np.int64)),
        "nation": pa.array(np.array(["US", "DE", "JP", "BR"])[
            rng.integers(0, 4, m)])})
    p1 = _write(orders, tmp_path, "orders.parquet", row_group_size=5000)
    p2 = _write(cust, tmp_path, "cust.parquet")
    before = _ops()
    enc = _q3_shape(_port(**Q1_CONF), F, p1, p2)
    assert _ops() > before
    dec = _q3_shape(_port(**Q1_CONF, **DECODED), F, p1, p2)
    assert_tables_equal(dec.to_arrow(), enc.to_arrow(), approx_float=1e-9)
    exp = _q3_shape(_jax(**Q1_CONF), JF, p1, p2)
    assert_tables_equal(exp, enc.to_arrow(), approx_float=1e-9)


def test_join_remap_path_fires_on_scan_joins(tmp_path):
    """Two direct scans (two dictionary streams) joined on encoded keys:
    the right dictionary remaps into the left one on the device."""
    from spark_rapids_tpu_torch.execs.join_execs import \
        TpuShuffledHashJoinExec
    rng = np.random.default_rng(8)
    n, m = 12000, 300
    left = pa.table({
        "o_key": pa.array(rng.integers(0, 250, n).astype(np.int64)),
        "price": pa.array(np.round(rng.uniform(1, 100, n), 2))})
    right = pa.table({
        "c_key": pa.array(rng.integers(0, 250, m).astype(np.int64)),
        "w": pa.array(rng.integers(0, 9, m).astype(np.int64))})
    p1 = _write(left, tmp_path, "l.parquet", row_group_size=4000)
    p2 = _write(right, tmp_path, "r.parquet")
    conf = {**Q1_CONF,
            "spark.rapids.tpu.sql.broadcastJoinThreshold.bytes": "-1"}

    def run(sess, f):
        return (sess.read.parquet(p1)
                .join(sess.read.parquet(p2), [("o_key", "c_key")],
                      how="inner")
                .agg(f.count().alias("n"), f.sum("price").alias("s"))
                ).collect()

    sess = _port(**conf)
    enc = run(sess, F)
    joins = [n for n in sess.last_plan.walk()
             if isinstance(n, TpuShuffledHashJoinExec)]
    assert joins and joins[0].encoded_batches == 1
    dec = run(_port(**conf, **DECODED), F)
    assert_tables_equal(dec.to_arrow(), enc.to_arrow(), approx_float=1e-9)
    assert_tables_equal(run(_jax(**conf), JF), enc.to_arrow(),
                        approx_float=1e-9)


def test_dict_remap_matches_values():
    from spark_rapids_tpu_torch.exprs.core import ColV
    from spark_rapids_tpu_torch.exprs.encoded import dict_remap
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    ones = torch.ones(4, dtype=torch.bool)
    lv = ColV(DType.LONG, torch.tensor([5, 7, 9, 11]), ones)
    rv = ColV(DType.LONG, torch.tensor([9, 1, 5]), ones[:3])
    assert dict_remap(lv, rv, 4).tolist() == [2, 4, 0]
    s = HostBatch.from_arrow(pa.table({"a": ["ab", "c", "abc"],
                                       "b": ["c", "abc", "x"]}))
    ls = ColV(DType.STRING, torch.from_numpy(s.columns[0].data),
              ones[:3], torch.from_numpy(s.columns[0].lengths))
    rs = ColV(DType.STRING, torch.from_numpy(s.columns[1].data),
              ones[:3], torch.from_numpy(s.columns[1].lengths))
    assert dict_remap(ls, rs, 3).tolist() == [1, 2, 3]


def test_encoded_filter_with_nulls_matches_decoded(tmp_path):
    rng = np.random.default_rng(6)
    n = 8000
    vals = [None if v % 9 == 0 else ["a", "b", "c"][v % 3]
            for v in rng.integers(0, 90, n)]
    t = pa.table({"s": pa.array(vals), "v": pa.array(np.arange(n))})
    path = _write(t, tmp_path, row_group_size=2000)

    def run(sess, f):
        return (sess.read.parquet(path).filter(f.col("s") != "b")
                .agg(f.count().alias("c"), f.sum("v").alias("sv"))).collect()

    got = run(_port(**Q1_CONF), F)
    assert_same(run(_port(**Q1_CONF, **DECODED), F).to_arrow(), got)
    assert_same(run(_jax(**Q1_CONF), JF), got)


def test_null_tolerant_predicates_stay_decoded(tmp_path):
    """IsNull and Coalesce make non-null verdicts from null inputs, which
    the dictionary gather cannot represent: they are not rewritten."""
    from spark_rapids_tpu_torch.exprs import encoded as ed
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    from spark_rapids_tpu_torch.exprs.nulls import Coalesce, IsNull
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    ref = BoundReference(0, DType.STRING, True, "s")
    spec = ce.EncSpec(0, DType.STRING, 3, 8)
    for e in (IsNull(ref), Coalesce((ref, ref))):
        assert ed.rewrite_predicate(e, [spec]) == (e, ())
    vals = ["a", "b", None, "c"] * 2000
    t = pa.table({"s": pa.array(vals), "v": pa.array(np.arange(8000))})
    path = _write(t, tmp_path, row_group_size=2000)
    queries = (
        lambda df, f: df.filter(f.col("s").isNull()).agg(
            f.count().alias("c")),
        lambda df, f: df.filter(f.col("s").isNotNull()).agg(
            f.count().alias("c")),
        lambda df, f: df.filter(f.coalesce(f.col("s"), f.lit("b")) == "b")
        .agg(f.count().alias("c")))
    for q in queries:
        got = q(_port(**Q1_CONF).read.parquet(path), F).collect()
        assert_same(q(_port(**Q1_CONF, **DECODED).read.parquet(path), F)
                    .collect().to_arrow(), got)
        assert_same(q(_jax(**Q1_CONF).read.parquet(path), JF).collect(),
                    got)
    got = queries[0](_port(**Q1_CONF).read.parquet(path), F).collect()
    assert got.to_arrow().column("c").to_pylist() == [2000]


def test_domain_safe_whitelist_is_the_reference_set():
    """The null-intolerant classes the port rewrites onto dictionaries are
    exactly the JAX package's Unary/BinaryExpression subclasses that keep
    the base ``eval``."""
    import importlib
    import inspect
    import pkgutil

    import spark_rapids_tpu.exprs as jex
    from spark_rapids_tpu.exprs.core import (BinaryExpression,
                                             UnaryExpression)
    from spark_rapids_tpu_torch.exprs.encoded import _null_intolerant
    bases = (UnaryExpression, BinaryExpression)
    ref = set()
    for m in pkgutil.iter_modules(jex.__path__):
        mod = importlib.import_module(f"spark_rapids_tpu.exprs.{m.name}")
        for name, c in vars(mod).items():
            if (inspect.isclass(c) and issubclass(c, bases)
                    and c.__module__ == mod.__name__
                    and not name.startswith("_") and c not in bases
                    and c.eval in (UnaryExpression.eval,
                                   BinaryExpression.eval)):
                ref.add(name)
    assert {c.__name__ for c in _null_intolerant()} == ref


def test_float_keys_stay_decoded(tmp_path):
    """Index identity is finer than float equality: float grouping and
    join keys are not rewritten, and -0.0/0.0 and NaNs group and join as
    the JAX package groups and joins them."""
    from spark_rapids_tpu_torch.columnar.dtypes import DType
    from spark_rapids_tpu_torch.exprs import encoded as ed
    from spark_rapids_tpu_torch.exprs.core import BoundReference
    ref = BoundReference(0, DType.DOUBLE, True, "x")
    grouping, subs, used = ed.rewrite_grouping(
        (ref,), [ce.EncSpec(0, DType.DOUBLE, 4)])
    assert grouping == (ref,) and not subs and not used
    rng = np.random.default_rng(4)
    n = 6000
    t = pa.table({"x": pa.array(np.array([0.25, 1.5, 2.0, 4.0])[
                      rng.integers(0, 4, n)]),
                  "z": pa.array(np.array([0.0, -0.0, np.nan, 3.0])[
                      rng.integers(0, 4, n)]),
                  "v": pa.array(rng.integers(0, 100, n))})
    dim = pa.table({"y": pa.array([0.25, 2.0, 9.0]),
                    "w": pa.array([1, 2, 3])})
    p1 = _write(t, tmp_path, "f.parquet", row_group_size=2000)
    p2 = _write(dim, tmp_path, "d.parquet")

    def run(sess, f):
        df = sess.read.parquet(p1)
        g = (df.groupBy("x", "z").agg(f.sum("v").alias("s"))
             .sort("x", "z").collect())
        j = (df.join(sess.read.parquet(p2), [("x", "y")])
             .groupBy("w").agg(f.count().alias("c")).sort("w").collect())
        return g, j

    for got, exp in zip(run(_port(**Q1_CONF), F), run(_jax(**Q1_CONF), JF)):
        assert_same(exp, got)


def test_planner_pass_marks_only_reachable_operators(tmp_path):
    from spark_rapids_tpu_torch.benchmarks.tpch import q1
    path = _lineitem_parquet(tmp_path, n=4000)
    sess = _port(**Q1_CONF)
    q1(sess.read.parquet(path)).collect()
    assert count_encoded_domain(sess.last_plan) >= 1
    marked = [type(n).__name__ for n in sess.last_plan.walk()
              if getattr(n, "encoded_domain_ok", False)]
    assert marked == ["FusedAggregateStageExec"]
    off = _port(**Q1_CONF, **{"spark.rapids.tpu.sql.encodedDomain.enabled":
                              "false"})
    q1(off.read.parquet(path)).collect()
    assert count_encoded_domain(off.last_plan) == 0
    # above an exchange nothing is marked: the exchange rebuilds columns
    # into its pieces and the pass does not look through it
    rep = _port(**Q1_CONF)
    q1(rep.read.parquet(path).repartition(4, "l_orderkey")).collect()
    assert count_encoded_domain(rep.last_plan) == 0


# ------------------------------------------------------------- exchange
def test_exchange_keep_encodings_on_and_off(tmp_path):
    """A hash exchange over an encoded scan: with keepEncodings the split
    moves indices (on the CPU the reorder kernel would not launch, so the
    encoded split is always taken) and every piece keeps the dictionary;
    off, the plain split. Both equal each other and the JAX package's
    numpy engine (its device path's exchange compiles for ~16 s on this
    CPU; the reference's own tests hold its engines equal)."""
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, TpuShuffleExchangeExec)
    rng = np.random.default_rng(12)
    n = 9000
    t = pa.table({"k": pa.array(rng.integers(0, 40, n).astype(np.int64)),
                  "s": pa.array(np.array(["p", "q", "rr", "sss"])[
                      rng.integers(0, 4, n)]),
                  "v": pa.array(np.round(rng.uniform(0, 10, n), 1))})
    path = _write(t, tmp_path, row_group_size=3000)

    def run(sess, f):
        return (sess.read.parquet(path).repartition(4, "k")
                .groupBy("s").agg(f.sum("v").alias("sv"),
                                  f.count().alias("c"),
                                  f.max("k").alias("mk"))
                .sort("s")).collect()

    key = "spark.rapids.tpu.sql.exchange.keepEncodings"
    results = []
    for keep in ("true", "false"):
        ce.reset_counters()
        sess = _port(**Q1_CONF, **{key: keep})
        results.append(run(sess, F))
        ex = next(n for n in sess.last_plan.walk()
                  if isinstance(n, TpuShuffleExchangeExec)
                  and isinstance(n.partitioning, HashPartitioning))
        if keep == "true":
            assert ex.encoded_splits == 3 and ex.kernel_splits == 0
            assert ce.counters()["exchange_encoded_ops"] == 3
        else:
            assert ex.encoded_splits == 0 and ex.kernel_splits == 3
    assert_same(results[1].to_arrow(), results[0])
    numpy_engine = JaxSession({**Q1_CONF,
                               "spark.rapids.tpu.sql.enabled": "false"})
    assert_tables_equal(run(numpy_engine, JF), results[0].to_arrow(),
                        approx_float=1e-9)


def test_exchange_pieces_keep_encodings_until_spilled(tmp_path):
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, _split_encoded, hash_partition_ids)
    from spark_rapids_tpu_torch.memory.buffer import (BufferId,
                                                      SpillableBuffer)
    from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
    rng = np.random.default_rng(13)
    t = pa.table({"s": pa.array(np.array(["a", "bb", "c"])[
                      rng.integers(0, 3, 3000)]),
                  "v": pa.array(rng.integers(0, 9, 3000))})
    path = _write(t, tmp_path)
    (db,) = _scan_batches(path, schema_of_arrow(t.schema))
    pids = hash_partition_ids([colvs_of(db)[1]], db.capacity, 3)
    enc = {0: db.columns[0].encoding}
    pieces = _split_encoded(db, pids, 3, enc)
    assert sum(p.num_rows for _, p in pieces) == 3000
    for _, piece in pieces:
        col = piece.columns[0]
        assert col.encoding is not None
        assert col.encoding.token == enc[0].token
        buf = SpillableBuffer.from_batch(BufferId(1, 0), piece)
        assert buf.get_batch().columns[0].encoding is not None
        back = buf.to_host().get_batch()
        assert back.columns[0].encoding is None
        _assert_columns_bitwise(back, piece, piece.num_rows)


# ------------------------------------------------------------- in memory
def _in_memory_tables():
    rng = np.random.default_rng(21)
    n = 600
    fact = pa.table({
        "s": pa.array(np.array(["x", "y", "zz", None], dtype=object)[
            rng.integers(0, 4, n)].tolist()).dictionary_encode(),
        "k": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 5, n).astype(np.int16)),
            pa.array([10, 20, 30, 40, 50], pa.int64())),
        "r": pa.RunEndEncodedArray.from_arrays(
            pa.array([150, 300, 450, 600], pa.int32()),
            pa.array([1, 2, None, 4], pa.int64())),
        "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})
    dim = pa.table({"dk": pa.array([10, 30, 50], pa.int64()).dictionary_encode(),
                    "name": pa.array(["ten", "thirty", "fifty"])})
    return fact, dim


def test_in_memory_dictionary_and_run_end_columns():
    """An in-memory table with dictionary and run-end-encoded columns runs
    through the port (it decodes them on the host), grouped, filtered and
    joined, equal to the JAX package."""
    fact, dim = _in_memory_tables()

    def run(sess, f):
        df = sess.create_dataframe(fact)
        g = (df.groupBy("s").agg(f.count().alias("c"),
                                 f.sum("v").alias("sv"))
             .sort("s").collect())
        flt = (df.filter((f.col("s") == "x") & (f.col("r") > 1))
               .agg(f.count().alias("c"), f.sum("k").alias("sk")).collect())
        j = (df.join(sess.create_dataframe(dim), [("k", "dk")])
             .groupBy("name", "r").agg(f.sum("v").alias("sv"))
             .sort("name", "r").collect())
        return g, flt, j

    for got, exp in zip(run(_port(), F), run(_jax(), JF)):
        assert_same(exp, got)
