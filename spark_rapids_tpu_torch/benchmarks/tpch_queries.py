"""TPC-H Q3 and Q6 over the DataFrame API, written as the JAX package
writes them (``benchmarks/tpch_queries.py::q3``, ``benchmarks/tpch.py::q6``).
``t`` maps a table name to its DataFrame; the columns each query reads are
listed so a caller can generate only those (``tpch_data``'s
``columns=``)."""
from __future__ import annotations

import datetime

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame

col, lit = F.col, F.lit
_d = datetime.date

Q3_COLUMNS = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
}
Q6_COLUMNS = {
    "lineitem": ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"],
}


def _revenue():
    return col("l_extendedprice") * (1 - col("l_discount"))


def q3(t) -> DataFrame:
    """TPC-H Q3: shipping priority."""
    cutoff = lit(_d(1995, 3, 15))
    return (t["customer"].filter(col("c_mktsegment") == "BUILDING")
            .join(t["orders"].filter(col("o_orderdate") < cutoff),
                  [("c_custkey", "o_custkey")])
            .join(t["lineitem"].filter(col("l_shipdate") > cutoff),
                  [("o_orderkey", "l_orderkey")])
            .groupBy("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(_revenue()).alias("revenue"))
            .select("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
            .sort(col("revenue").desc(), "o_orderdate")
            .limit(10))


def q6(lineitem: DataFrame) -> DataFrame:
    """TPC-H Q6: forecasting revenue change."""
    lo = _d(1994, 1, 1)
    hi = _d(1995, 1, 1)
    return (lineitem
            .filter((col("l_shipdate") >= lit(lo))
                    & (col("l_shipdate") < lit(hi))
                    & (col("l_discount") >= 0.05)
                    & (col("l_discount") <= 0.07)
                    & (col("l_quantity") < 24))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))
