"""TPC-H-like lineitem data and Q1, in numpy and the port's API.

``gen_lineitem`` draws the same random numbers in the same order as the JAX
package's generator, so the same (scale, seed) gives the same rows; it
builds the numpy host layout directly (flags as a byte matrix plus lengths,
dates as int32 days), with no pyarrow. Scale factor 1.0 is 6,000,000 rows.
"""
from __future__ import annotations

import datetime

import numpy as np

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

_FLAGS = b"ANR"
_STATUS = b"FO"
_EPOCH_1992 = (datetime.date(1992, 1, 1) - datetime.date(1970, 1, 1)).days
_STRING_WIDTH = 8        # the width bucket of a one-byte string

LINEITEM_SCHEMA = Schema([
    Field("l_orderkey", DType.LONG), Field("l_quantity", DType.DOUBLE),
    Field("l_extendedprice", DType.DOUBLE), Field("l_discount", DType.DOUBLE),
    Field("l_tax", DType.DOUBLE), Field("l_returnflag", DType.STRING),
    Field("l_linestatus", DType.STRING), Field("l_shipdate", DType.DATE),
])


def _one_byte_strings(alphabet: bytes, idx: np.ndarray) -> HostColumn:
    n = idx.shape[0]
    mat = np.zeros((n, _STRING_WIDTH), dtype=np.uint8)
    mat[:, 0] = np.frombuffer(alphabet, dtype=np.uint8)[idx]
    return HostColumn(DType.STRING, mat, np.ones(n, np.bool_),
                      np.ones(n, np.int32))


def gen_lineitem(scale: float = 0.01, seed: int = 0) -> HostBatch:
    n = int(6_000_000 * scale)
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n).astype(np.float64)
    extendedprice = np.round(rng.uniform(900, 105000, n), 2)
    discount = np.round(rng.uniform(0.0, 0.1, n), 2)
    tax = np.round(rng.uniform(0.0, 0.08, n), 2)
    flag_idx = rng.integers(0, 3, n)
    status_idx = rng.integers(0, 2, n)
    shipdate = (_EPOCH_1992 + rng.integers(0, 2526, n)).astype(np.int32)
    orderkey = rng.integers(1, max(int(n / 4), 2), n).astype(np.int64)
    ones = np.ones(n, np.bool_)
    cols = (
        HostColumn(DType.LONG, orderkey, ones),
        HostColumn(DType.DOUBLE, quantity, ones),
        HostColumn(DType.DOUBLE, extendedprice, ones),
        HostColumn(DType.DOUBLE, discount, ones),
        HostColumn(DType.DOUBLE, tax, ones),
        _one_byte_strings(_FLAGS, flag_idx),
        _one_byte_strings(_STATUS, status_idx),
        HostColumn(DType.DATE, shipdate, ones),
    )
    return HostBatch(LINEITEM_SCHEMA, cols, n)


def q1(lineitem: DataFrame) -> DataFrame:
    """TPC-H Q1: pricing summary report."""
    cutoff = datetime.date(1998, 9, 2)
    disc_price = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    charge = disc_price * (1 + F.col("l_tax"))
    return (lineitem
            .filter(F.col("l_shipdate") <= F.lit(cutoff))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count().alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


#: float sums are required by TPC-H aggregates
BENCH_CONF = {
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": "true",
    "spark.rapids.tpu.sql.incompatibleOps.enabled": "true",
}
