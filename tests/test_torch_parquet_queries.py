"""TPC-H Q1 and TPC-DS q3, q42, q52 and q55 through the PyTorch port's
``TpuSession.read.parquet`` on the CPU, against the JAX package on the same
files: lineitem (Q1's columns and ``l_orderkey``, sorted by ship date) and
store_sales (sorted by sale date, hash 8 on ``ss_item_sk`` as on the card),
item and date_dim, written by pyarrow from the port's generators, plain and
hive-partitioned (lineitem on ``l_returnflag``, store_sales on
``ss_store_sk`` with its nulls), with every encoding key on and all off,
with a pushed-down filter that clips row groups, and with
``input_file_name()``. Q1's plain run is held against the JAX TPU session
(XLA on the CPU); the rest against the JAX numpy engine, whose device path
takes tens of seconds to compile these plans here and which the
reference's own tests hold equal to it. Float sums within 1e-9; with the
keys on, the Q1 and q3 plans have operators on the encoded domain."""
import datetime

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.benchmarks import tpcds_queries as jdq
from spark_rapids_tpu.benchmarks.tpch import q1 as jq1
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.benchmarks import tpcds_queries as tdq
from spark_rapids_tpu_torch.benchmarks.tpch import (BENCH_CONF,
                                                    gen_lineitem, q1)
from spark_rapids_tpu_torch.execs.exchange_execs import (
    HashPartitioning, TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.io.parquet import TpuParquetScanExec
from spark_rapids_tpu_torch.plan.encoded import count_encoded_domain

from torch_parquet_common import (  # noqa: F401 - fixtures
    stop_decode_workers, fresh_device_managers, one_torch_thread)
from torch_parquet_common import jax_session as _jax
from torch_parquet_common import port_session as _port

CONF = {**BENCH_CONF, "spark.rapids.tpu.sql.string.maxBytes": "16",
        "spark.rapids.tpu.sql.scanCache.enabled": "false"}
#: TPC-DS's strings, and input_file_name()'s paths, need the default width
WIDE = {**CONF, "spark.rapids.tpu.sql.string.maxBytes": "256"}
#: every encoding key off: host decode, no encoded domain, plain exchanges
ALL_OFF = {"spark.rapids.tpu.io.parquet.deviceDictDecode.enabled": "false",
           "spark.rapids.tpu.io.parquet.deviceRleExpand.enabled": "false",
           "spark.rapids.tpu.sql.encodedDomain.enabled": "false",
           "spark.rapids.tpu.sql.exchange.keepEncodings": "false"}
KEYS = {"on": {}, "off": ALL_OFF}
DS_TABLES = ("store_sales", "item", "date_dim")
DS_QUERIES = ("q3", "q42", "q52", "q55")
#: Q1 after a pushed-down filter on the sorted ship dates
SINCE = datetime.date(1995, 6, 17)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of every layout, plain and hive."""
    root = tmp_path_factory.mktemp("pq")
    out = {}
    li = gen_lineitem(0.002, 5).to_arrow().sort_by("l_shipdate")
    out["lineitem"] = str(root / "lineitem.parquet")
    pq.write_table(li, out["lineitem"], row_group_size=li.num_rows // 16)
    out["lineitem_hive"] = str(root / "lineitem_hive")
    pq.write_to_dataset(li, out["lineitem_hive"],
                        partition_cols=["l_returnflag"],
                        row_group_size=li.num_rows // 16)
    ds = tds.gen_all(0.01, 3, tables=list(DS_TABLES))
    for name, hb in ds.items():
        t = hb.to_arrow()
        if name == "store_sales":
            t = t.sort_by("ss_sold_date_sk")
            out["store_sales_hive"] = str(root / "store_sales_hive")
            pq.write_to_dataset(t, out["store_sales_hive"],
                                partition_cols=["ss_store_sk"],
                                row_group_size=max(1, t.num_rows // 16))
        out[name] = str(root / f"{name}.parquet")
        pq.write_table(t, out[name], row_group_size=max(1, t.num_rows // 16))
    return out


def _numpy_engine(conf=CONF):
    return JaxSession({**conf, "spark.rapids.tpu.sql.enabled": "false"})


def _scan_rows(sess) -> int:
    return sum(n.rows_read for n in sess.last_plan.walk()
               if isinstance(n, TpuParquetScanExec))


# ------------------------------------------------------------- TPC-H Q1
@pytest.mark.parametrize("keys", ["on", "off"])
@pytest.mark.parametrize("layout", ["lineitem", "lineitem_hive"])
def test_tpch_q1_from_parquet(files, layout, keys):
    sess = _port(**CONF, **KEYS[keys])
    got = q1(sess.read.parquet(files[layout])).collect()
    assert (count_encoded_domain(sess.last_plan) > 0) == (keys == "on")
    ref = (_jax(**CONF) if layout == "lineitem" else _numpy_engine())
    exp = jq1(ref.read.parquet(files[layout])).collect()
    assert_tables_equal(exp, got.to_arrow(), approx_float=1e-9)


def test_tpch_q1_pushdown_and_input_file_name(files):
    """A filter on the sorted ship dates clips row groups in the scan; an
    input_file_name() predicate takes the hidden columns through the query;
    both equal the JAX package, with every key on and all off."""
    def pushed(sess, f):
        return q_fn(f)(sess.read.parquet(files["lineitem"])
                       .filter(f.col("l_shipdate") >= f.lit(SINCE)))

    def by_file(sess, f):
        li = sess.read.parquet(files["lineitem_hive"])
        return q_fn(f)(li.filter(f.input_file_name().contains("=A")))

    def q_fn(f):
        return q1 if f is F else jq1

    total = pq.ParquetFile(files["lineitem"]).metadata.num_rows
    for make in (pushed, by_file):
        exp = make(_numpy_engine(WIDE), JF).collect()
        for keys in KEYS.values():
            sess = _port(**WIDE, **keys)
            got = make(sess, F).collect()
            assert_tables_equal(exp, got.to_arrow(), approx_float=1e-9)
            if make is pushed:
                assert 0 < _scan_rows(sess) < total
        assert exp.num_rows > 0


# ------------------------------------------------------------- TPC-DS
def _ds_frames(sess, files, layout, f, since=None, by_name=False):
    dfs = {t: sess.read.parquet(files[t]) for t in DS_TABLES}
    if layout == "hive":
        dfs["store_sales"] = sess.read.parquet(files["store_sales_hive"])
    ss = dfs["store_sales"]
    if since is not None:
        ss = ss.filter(f.col("ss_sold_date_sk") >= since)
    if by_name:
        ss = ss.filter(f.input_file_name().endswith(".parquet"))
    dfs["store_sales"] = ss.repartition(8, "ss_item_sk")
    return dfs


@pytest.mark.parametrize("layout", ["plain", "hive"])
@pytest.mark.parametrize("q", DS_QUERIES)
def test_tpcds_from_parquet(files, q, layout):
    exp = jdq.QUERIES[q](_ds_frames(_numpy_engine(WIDE), files, layout,
                                    JF)).collect()
    for name, keys in KEYS.items():
        sess = _port(**WIDE, **keys)
        got = tdq.QUERIES[q](_ds_frames(sess, files, layout, F)).collect()
        assert got.num_rows > 0
        assert_tables_equal(exp, got.to_arrow(), approx_float=1e-9)
        if q == "q3":
            assert (count_encoded_domain(sess.last_plan) > 0) == \
                (name == "on")
            ex = next(n for n in sess.last_plan.walk()
                      if isinstance(n, TpuShuffleExchangeExec)
                      and isinstance(n.partitioning, HashPartitioning))
            # on the CPU the kernel would not launch: with keepEncodings
            # every store_sales batch takes the encoded split
            assert (ex.encoded_splits > 0) == (name == "on")


def test_tpcds_q3_pushdown_and_input_file_name(files):
    since = 2451000
    total = pq.ParquetFile(files["store_sales"]).metadata.num_rows
    for layout, kw in (("plain", {"since": since}),
                       ("hive", {"by_name": True})):
        exp = jdq.q3(_ds_frames(_numpy_engine(WIDE), files, layout, JF,
                                **kw)).collect()
        for keys in KEYS.values():
            sess = _port(**WIDE, **keys)
            got = tdq.q3(_ds_frames(sess, files, layout, F, **kw)).collect()
            assert_tables_equal(exp, got.to_arrow(), approx_float=1e-9)
            if layout == "plain":
                ss_scan = next(
                    n for n in sess.last_plan.walk()
                    if isinstance(n, TpuParquetScanExec)
                    and n.paths == (files["store_sales"],))
                assert 0 < ss_scan.rows_read < total
