"""All 22 TPC-H queries over the DataFrame API, written as the JAX package
writes them (its ``benchmarks/tpch_queries.py``: the spec's text with the
correlated and scalar subqueries decorrelated the way Catalyst does it,
EXISTS as a left-semi join, NOT EXISTS as a left-anti join, a scalar
subquery as a one-row aggregate cross-joined or equi-joined on its
correlation key). ``t`` maps a table name to its DataFrame; ``QUERIES``
maps 1..22 to the query; ``COLUMNS`` lists the columns each query reads,
so a caller can generate or scan only those (``tpch_data``'s
``columns=``). Q1 and Q6 keep their lineitem-only forms (``benchmarks/
tpch.py::q1`` and ``q6`` below) under ``QUERIES``."""
from __future__ import annotations

import datetime
from typing import Callable, Dict, List

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.benchmarks.tpch import q1 as _q1

col, lit, when = F.col, F.lit, F.when
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


def q2(t) -> DataFrame:
    eu_supp = (t["supplier"]
               .join(t["nation"], [("s_nationkey", "n_nationkey")])
               .join(t["region"].filter(col("r_name") == "EUROPE"),
                     [("n_regionkey", "r_regionkey")]))
    joined = (t["part"]
              .filter((col("p_size") == 15) & col("p_type").like("%BRASS"))
              .join(t["partsupp"], [("p_partkey", "ps_partkey")])
              .join(eu_supp, [("ps_suppkey", "s_suppkey")]))
    min_cost = (joined.groupBy("p_partkey")
                .agg(F.min("ps_supplycost").alias("min_cost"))
                .withColumnRenamed("p_partkey", "mc_partkey"))
    return (joined.join(min_cost, [("p_partkey", "mc_partkey")])
            .filter(col("ps_supplycost") == col("min_cost"))
            .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                    "s_address", "s_phone", "s_comment")
            .sort(col("s_acctbal").desc(), "n_name", "s_name", "p_partkey")
            .limit(100))


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


def q4(t) -> DataFrame:
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    return (t["orders"]
            .filter((col("o_orderdate") >= lit(_d(1993, 7, 1)))
                    & (col("o_orderdate") < lit(_d(1993, 10, 1))))
            .join(late, [("o_orderkey", "l_orderkey")], "left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count().alias("order_count"))
            .sort("o_orderpriority"))


def q5(t) -> DataFrame:
    return (t["customer"]
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(_d(1994, 1, 1)))
                          & (col("o_orderdate") < lit(_d(1995, 1, 1)))),
                  [("c_custkey", "o_custkey")])
            .join(t["lineitem"], [("o_orderkey", "l_orderkey")])
            .join(t["supplier"], [("l_suppkey", "s_suppkey"),
                                  ("c_nationkey", "s_nationkey")])
            .join(t["nation"], [("s_nationkey", "n_nationkey")])
            .join(t["region"].filter(col("r_name") == "ASIA"),
                  [("n_regionkey", "r_regionkey")])
            .groupBy("n_name")
            .agg(F.sum(_revenue()).alias("revenue"))
            .sort(col("revenue").desc()))


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


def q7(t) -> DataFrame:
    n1 = t["nation"].select(col("n_nationkey").alias("sn_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("cn_key"),
                            col("n_name").alias("cust_nation"))
    pair = (((col("supp_nation") == "FRANCE") & (col("cust_nation") == "GERMANY"))
            | ((col("supp_nation") == "GERMANY") & (col("cust_nation") == "FRANCE")))
    return (t["lineitem"]
            .filter((col("l_shipdate") >= lit(_d(1995, 1, 1)))
                    & (col("l_shipdate") <= lit(_d(1996, 12, 31))))
            .join(t["supplier"], [("l_suppkey", "s_suppkey")])
            .join(t["orders"], [("l_orderkey", "o_orderkey")])
            .join(t["customer"], [("o_custkey", "c_custkey")])
            .join(n1, [("s_nationkey", "sn_key")])
            .join(n2, [("c_nationkey", "cn_key")])
            .filter(pair)
            .select("supp_nation", "cust_nation",
                    F.year("l_shipdate").alias("l_year"),
                    _revenue().alias("volume"))
            .groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum("volume").alias("revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(t) -> DataFrame:
    n2 = t["nation"].select(col("n_nationkey").alias("sn_key"),
                            col("n_name").alias("supp_nation"))
    base = (t["part"].filter(col("p_type") == "ECONOMY ANODIZED STEEL")
            .join(t["lineitem"], [("p_partkey", "l_partkey")])
            .join(t["supplier"], [("l_suppkey", "s_suppkey")])
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(_d(1995, 1, 1)))
                          & (col("o_orderdate") <= lit(_d(1996, 12, 31)))),
                  [("l_orderkey", "o_orderkey")])
            .join(t["customer"], [("o_custkey", "c_custkey")])
            .join(t["nation"], [("c_nationkey", "n_nationkey")])
            .join(t["region"].filter(col("r_name") == "AMERICA"),
                  [("n_regionkey", "r_regionkey")])
            .join(n2, [("s_nationkey", "sn_key")])
            .select(F.year("o_orderdate").alias("o_year"),
                    _revenue().alias("volume"), "supp_nation"))
    return (base.groupBy("o_year")
            .agg(F.sum(when(col("supp_nation") == "BRAZIL", col("volume"))
                       .otherwise(0.0)).alias("brazil_volume"),
                 F.sum("volume").alias("total_volume"))
            .select("o_year", (col("brazil_volume")
                               / col("total_volume")).alias("mkt_share"))
            .sort("o_year"))


def q9(t) -> DataFrame:
    amount = (_revenue() - col("ps_supplycost") * col("l_quantity"))
    return (t["part"].filter(col("p_name").contains("green"))
            .join(t["lineitem"], [("p_partkey", "l_partkey")])
            .join(t["supplier"], [("l_suppkey", "s_suppkey")])
            .join(t["partsupp"], [("l_suppkey", "ps_suppkey"),
                                  ("l_partkey", "ps_partkey")])
            .join(t["orders"], [("l_orderkey", "o_orderkey")])
            .join(t["nation"], [("s_nationkey", "n_nationkey")])
            .select(col("n_name").alias("nation"),
                    F.year("o_orderdate").alias("o_year"),
                    amount.alias("amount"))
            .groupBy("nation", "o_year")
            .agg(F.sum("amount").alias("sum_profit"))
            .sort("nation", col("o_year").desc()))


def q10(t) -> DataFrame:
    return (t["customer"]
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(_d(1993, 10, 1)))
                          & (col("o_orderdate") < lit(_d(1994, 1, 1)))),
                  [("c_custkey", "o_custkey")])
            .join(t["lineitem"].filter(col("l_returnflag") == "R"),
                  [("o_orderkey", "l_orderkey")])
            .join(t["nation"], [("c_nationkey", "n_nationkey")])
            .groupBy("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                     "c_address", "c_comment")
            .agg(F.sum(_revenue()).alias("revenue"))
            .select("c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                    "c_address", "c_phone", "c_comment")
            .sort(col("revenue").desc())
            .limit(20))


def q11(t) -> DataFrame:
    de = (t["partsupp"]
          .join(t["supplier"], [("ps_suppkey", "s_suppkey")])
          .join(t["nation"].filter(col("n_name") == "GERMANY"),
                [("s_nationkey", "n_nationkey")])
          .select("ps_partkey",
                  (col("ps_supplycost") * col("ps_availqty")).alias("v")))
    grouped = de.groupBy("ps_partkey").agg(F.sum("v").alias("value"))
    total = de.agg(F.sum("v").alias("total"))
    return (grouped.crossJoin(total)
            .filter(col("value") > col("total") * 0.0001)
            .select("ps_partkey", "value")
            .sort(col("value").desc()))


def q12(t) -> DataFrame:
    high = col("o_orderpriority").isin("1-URGENT", "2-HIGH")
    return (t["lineitem"]
            .filter(col("l_shipmode").isin("MAIL", "SHIP")
                    & (col("l_commitdate") < col("l_receiptdate"))
                    & (col("l_shipdate") < col("l_commitdate"))
                    & (col("l_receiptdate") >= lit(_d(1994, 1, 1)))
                    & (col("l_receiptdate") < lit(_d(1995, 1, 1))))
            .join(t["orders"], [("l_orderkey", "o_orderkey")])
            .groupBy("l_shipmode")
            .agg(F.sum(when(high, 1).otherwise(0)).alias("high_line_count"),
                 F.sum(when(high, 0).otherwise(1)).alias("low_line_count"))
            .sort("l_shipmode"))


def q13(t) -> DataFrame:
    ords = t["orders"].filter(~col("o_comment").like("%special%requests%"))
    return (t["customer"]
            .join(ords, [("c_custkey", "o_custkey")], "left")
            .groupBy("c_custkey")
            .agg(F.count("o_orderkey").alias("c_count"))
            .groupBy("c_count")
            .agg(F.count().alias("custdist"))
            .sort(col("custdist").desc(), col("c_count").desc()))


def q14(t) -> DataFrame:
    promo = when(col("p_type").like("PROMO%"), _revenue()).otherwise(0.0)
    return (t["lineitem"]
            .filter((col("l_shipdate") >= lit(_d(1995, 9, 1)))
                    & (col("l_shipdate") < lit(_d(1995, 10, 1))))
            .join(t["part"], [("l_partkey", "p_partkey")])
            .agg(F.sum(promo).alias("promo"), F.sum(_revenue()).alias("total"))
            .select((col("promo") * 100.0 / col("total"))
                    .alias("promo_revenue")))


def q15(t) -> DataFrame:
    revenue = (t["lineitem"]
               .filter((col("l_shipdate") >= lit(_d(1996, 1, 1)))
                       & (col("l_shipdate") < lit(_d(1996, 4, 1))))
               .groupBy(col("l_suppkey").alias("supplier_no"))
               .agg(F.sum(_revenue()).alias("total_revenue")))
    max_rev = revenue.agg(F.max("total_revenue").alias("max_revenue"))
    return (t["supplier"]
            .join(revenue, [("s_suppkey", "supplier_no")])
            .crossJoin(max_rev)
            .filter(col("total_revenue") == col("max_revenue"))
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .sort("s_suppkey"))


def q16(t) -> DataFrame:
    complaints = (t["supplier"]
                  .filter(col("s_comment").like("%Customer%Complaints%"))
                  .select("s_suppkey"))
    ps = t["partsupp"].join(complaints, [("ps_suppkey", "s_suppkey")],
                            "left_anti")
    return (t["part"]
            .filter((col("p_brand") != "Brand#45")
                    & ~col("p_type").like("MEDIUM POLISHED%")
                    & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
            .join(ps, [("p_partkey", "ps_partkey")])
            .select("p_brand", "p_type", "p_size", "ps_suppkey")
            .distinct()
            .groupBy("p_brand", "p_type", "p_size")
            .agg(F.count().alias("supplier_cnt"))
            .sort(col("supplier_cnt").desc(), "p_brand", "p_type", "p_size"))


def q17(t) -> DataFrame:
    parts = t["part"].filter((col("p_brand") == "Brand#23")
                             & (col("p_container") == "MED BOX"))
    avg_qty = (t["lineitem"].groupBy(col("l_partkey").alias("aq_partkey"))
               .agg(F.avg("l_quantity").alias("aq")))
    return (t["lineitem"]
            .join(parts, [("l_partkey", "p_partkey")])
            .join(avg_qty, [("l_partkey", "aq_partkey")])
            .filter(col("l_quantity") < col("aq") * 0.2)
            .agg(F.sum("l_extendedprice").alias("s"))
            .select((col("s") / 7.0).alias("avg_yearly")))


def q18(t) -> DataFrame:
    big = (t["lineitem"].groupBy(col("l_orderkey").alias("big_orderkey"))
           .agg(F.sum("l_quantity").alias("big_qty"))
           .filter(col("big_qty") > 300))
    return (t["customer"]
            .join(t["orders"], [("c_custkey", "o_custkey")])
            .join(big, [("o_orderkey", "big_orderkey")], "left_semi")
            .join(t["lineitem"], [("o_orderkey", "l_orderkey")])
            .groupBy("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                     "o_totalprice")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .sort(col("o_totalprice").desc(), "o_orderdate")
            .limit(100))


def q19(t) -> DataFrame:
    qty, size = col("l_quantity"), col("p_size")
    c1 = ((col("p_brand") == "Brand#12")
          & col("p_container").isin("SM CASE", "SM BOX", "SM PACK", "SM PKG")
          & (qty >= 1) & (qty <= 11) & (size >= 1) & (size <= 5))
    c2 = ((col("p_brand") == "Brand#23")
          & col("p_container").isin("MED BAG", "MED BOX", "MED PKG", "MED PACK")
          & (qty >= 10) & (qty <= 20) & (size >= 1) & (size <= 10))
    c3 = ((col("p_brand") == "Brand#34")
          & col("p_container").isin("LG CASE", "LG BOX", "LG PACK", "LG PKG")
          & (qty >= 20) & (qty <= 30) & (size >= 1) & (size <= 15))
    return (t["lineitem"]
            .filter(col("l_shipmode").isin("AIR", "REG AIR")
                    & (col("l_shipinstruct") == "DELIVER IN PERSON"))
            .join(t["part"], [("l_partkey", "p_partkey")])
            .filter(c1 | c2 | c3)
            .agg(F.sum(_revenue()).alias("revenue")))


def q20(t) -> DataFrame:
    forest = t["part"].filter(col("p_name").like("forest%")).select("p_partkey")
    qty = (t["lineitem"]
           .filter((col("l_shipdate") >= lit(_d(1994, 1, 1)))
                   & (col("l_shipdate") < lit(_d(1995, 1, 1))))
           .groupBy(col("l_partkey").alias("q_partkey"),
                    col("l_suppkey").alias("q_suppkey"))
           .agg(F.sum("l_quantity").alias("qty_sum")))
    supps = (t["partsupp"]
             .join(forest, [("ps_partkey", "p_partkey")], "left_semi")
             .join(qty, [("ps_partkey", "q_partkey"),
                         ("ps_suppkey", "q_suppkey")])
             .filter(col("ps_availqty") > col("qty_sum") * 0.5)
             .select("ps_suppkey").distinct())
    return (t["supplier"]
            .join(supps, [("s_suppkey", "ps_suppkey")], "left_semi")
            .join(t["nation"].filter(col("n_name") == "CANADA"),
                  [("s_nationkey", "n_nationkey")])
            .select("s_name", "s_address")
            .sort("s_name"))


def q21(t) -> DataFrame:
    # EXISTS(other supplier on the order) / NOT EXISTS(other LATE supplier):
    # since the probe row is itself late, they reduce to per-order distinct
    # supplier counts — all_cnt > 1 and late_cnt == 1 (Catalyst decorrelates
    # to the same aggregate-join shape)
    late = t["lineitem"].filter(col("l_receiptdate") > col("l_commitdate"))
    late_cnt = (late.select("l_orderkey", "l_suppkey").distinct()
                .groupBy(col("l_orderkey").alias("lc_orderkey"))
                .agg(F.count().alias("late_cnt")))
    all_cnt = (t["lineitem"].select("l_orderkey", "l_suppkey").distinct()
               .groupBy(col("l_orderkey").alias("ac_orderkey"))
               .agg(F.count().alias("all_cnt")))
    return (late
            .join(t["orders"].filter(col("o_orderstatus") == "F"),
                  [("l_orderkey", "o_orderkey")])
            .join(t["supplier"], [("l_suppkey", "s_suppkey")])
            .join(t["nation"].filter(col("n_name") == "SAUDI ARABIA"),
                  [("s_nationkey", "n_nationkey")])
            .join(late_cnt, [("l_orderkey", "lc_orderkey")])
            .join(all_cnt, [("l_orderkey", "ac_orderkey")])
            .filter((col("late_cnt") == 1) & (col("all_cnt") > 1))
            .groupBy("s_name")
            .agg(F.count().alias("numwait"))
            .sort(col("numwait").desc(), "s_name")
            .limit(100))


def q22(t) -> DataFrame:
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (t["customer"]
            .select(F.substring("c_phone", 1, 2).alias("cntrycode"),
                    "c_acctbal", "c_custkey")
            .filter(col("cntrycode").isin(*codes)))
    avg_bal = (cust.filter(col("c_acctbal") > 0.0)
               .agg(F.avg("c_acctbal").alias("avg_bal")))
    return (cust
            .join(t["orders"], [("c_custkey", "o_custkey")], "left_anti")
            .crossJoin(avg_bal)
            .filter(col("c_acctbal") > col("avg_bal"))
            .groupBy("cntrycode")
            .agg(F.count().alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .sort("cntrycode"))


QUERIES: Dict[int, Callable] = {i: globals().get(f"q{i}")
                                for i in range(1, 23)}
QUERIES[1] = lambda t: _q1(t["lineitem"])
QUERIES[6] = lambda t: q6(t["lineitem"])

#: the columns each query reads, by table
COLUMNS: Dict[int, Dict[str, List[str]]] = {
    1: {"lineitem": ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                     "l_returnflag", "l_linestatus", "l_shipdate"]},
    2: {"part": ["p_partkey", "p_mfgr", "p_type", "p_size"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey",
                     "s_phone", "s_acctbal", "s_comment"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]},
    3: Q3_COLUMNS,
    4: {"orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
        "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]},
    5: {"customer": ["c_custkey", "c_nationkey"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]},
    6: Q6_COLUMNS,
    7: {"lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount", "l_shipdate"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "orders": ["o_orderkey", "o_custkey"],
        "customer": ["c_custkey", "c_nationkey"],
        "nation": ["n_nationkey", "n_name"]},
    8: {"part": ["p_partkey", "p_type"],
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey",
                     "l_extendedprice", "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "customer": ["c_custkey", "c_nationkey"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]},
    9: {"part": ["p_partkey", "p_name"],
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "orders": ["o_orderkey", "o_orderdate"],
        "nation": ["n_nationkey", "n_name"]},
    10: {"customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                      "c_phone", "c_acctbal", "c_comment"],
         "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
         "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                      "l_returnflag"],
         "nation": ["n_nationkey", "n_name"]},
    11: {"partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty",
                      "ps_supplycost"],
         "supplier": ["s_suppkey", "s_nationkey"],
         "nation": ["n_nationkey", "n_name"]},
    12: {"lineitem": ["l_orderkey", "l_shipdate", "l_commitdate",
                      "l_receiptdate", "l_shipmode"],
         "orders": ["o_orderkey", "o_orderpriority"]},
    13: {"customer": ["c_custkey"],
         "orders": ["o_orderkey", "o_custkey", "o_comment"]},
    14: {"lineitem": ["l_partkey", "l_extendedprice", "l_discount",
                      "l_shipdate"],
         "part": ["p_partkey", "p_type"]},
    15: {"lineitem": ["l_suppkey", "l_extendedprice", "l_discount",
                      "l_shipdate"],
         "supplier": ["s_suppkey", "s_name", "s_address", "s_phone"]},
    16: {"supplier": ["s_suppkey", "s_comment"],
         "partsupp": ["ps_partkey", "ps_suppkey"],
         "part": ["p_partkey", "p_brand", "p_type", "p_size"]},
    17: {"part": ["p_partkey", "p_brand", "p_container"],
         "lineitem": ["l_partkey", "l_quantity", "l_extendedprice"]},
    18: {"customer": ["c_custkey", "c_name"],
         "orders": ["o_orderkey", "o_custkey", "o_totalprice",
                    "o_orderdate"],
         "lineitem": ["l_orderkey", "l_quantity"]},
    19: {"lineitem": ["l_partkey", "l_quantity", "l_extendedprice",
                      "l_discount", "l_shipinstruct", "l_shipmode"],
         "part": ["p_partkey", "p_brand", "p_size", "p_container"]},
    20: {"part": ["p_partkey", "p_name"],
         "lineitem": ["l_partkey", "l_suppkey", "l_quantity", "l_shipdate"],
         "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty"],
         "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey"],
         "nation": ["n_nationkey", "n_name"]},
    21: {"lineitem": ["l_orderkey", "l_suppkey", "l_commitdate",
                      "l_receiptdate"],
         "orders": ["o_orderkey", "o_orderstatus"],
         "supplier": ["s_suppkey", "s_name", "s_nationkey"],
         "nation": ["n_nationkey", "n_name"]},
    22: {"customer": ["c_custkey", "c_phone", "c_acctbal"],
         "orders": ["o_custkey"]},
}


def all_columns() -> Dict[str, List[str]]:
    """The union of every query's columns, by table."""
    out: Dict[str, set] = {}
    for cols in COLUMNS.values():
        for table, names in cols.items():
            out.setdefault(table, set()).update(names)
    return {k: sorted(v) for k, v in out.items()}
