"""The TPC-DS bench subset over the DataFrame API: the 14 queries of
``bench.py``'s ``TPCDS_BENCH_QUERIES`` (q3, q4, q7, q14, q19, q23, q27, q34,
q42, q52, q55, q67, q68, q96), written as the JAX package's
``benchmarks/tpcds_queries.py`` writes them (with its helpers
``_ticket_counts`` and ``_year_total``; constants adapted to its
generator's pools as noted there). ``t`` maps a table name to its
DataFrame; ``QUERIES`` maps a name to the query; ``COLUMNS`` lists the
columns each query reads, so a caller can generate or scan only those
(``tpcds_data``'s ``columns=``)."""
from __future__ import annotations

from typing import Dict, List

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window

col, lit, when = F.col, F.lit, F.when


def q3(t):
    return (t["date_dim"].filter(col("d_moy") == 11)
            .join(t["store_sales"], [("d_date_sk", "ss_sold_date_sk")])
            .join(t["item"].filter(col("i_manufact_id") == 128),
                  [("ss_item_sk", "i_item_sk")])
            .groupBy("d_year", "i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
            .select("d_year", col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), "sum_agg")
            .sort("d_year", col("sum_agg").desc(), "brand_id")
            .limit(100))


def q7(t):
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == "M") & (col("cd_marital_status") == "S")
        & (col("cd_education_status") == "College"))
    promo = t["promotion"].filter((col("p_channel_email") == "N")
                                  | (col("p_channel_event") == "N"))
    return (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year") == 2000),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["item"], [("ss_item_sk", "i_item_sk")])
            .join(cd, [("ss_cdemo_sk", "cd_demo_sk")])
            .join(promo, [("ss_promo_sk", "p_promo_sk")])
            .groupBy("i_item_id")
            .agg(F.avg("ss_quantity").alias("agg1"),
                 F.avg("ss_list_price").alias("agg2"),
                 F.avg("ss_coupon_amt").alias("agg3"),
                 F.avg("ss_sales_price").alias("agg4"))
            .sort("i_item_id").limit(100))


def q19(t):
    return (t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 1998))
            .join(t["store_sales"], [("d_date_sk", "ss_sold_date_sk")])
            .join(t["item"].filter(col("i_manager_id") == 8),
                  [("ss_item_sk", "i_item_sk")])
            .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk", "ca_address_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")],
                  )
            .filter(F.substring("ca_zip", 1, 5) != F.substring("s_zip", 1, 5))
            .groupBy("i_brand", "i_brand_id", "i_manufact_id", "i_manufact")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select(col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), "i_manufact_id",
                    "i_manufact", "ext_price")
            .sort(col("ext_price").desc(), "brand", "brand_id",
                  "i_manufact_id", "i_manufact")
            .limit(100))


def _ticket_counts(t, date_filter, hd_filter, store_filter):
    """Shared inner block of q34/q73: count items per (ticket, customer)."""
    return (t["store_sales"]
            .join(t["date_dim"].filter(date_filter),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"].filter(store_filter),
                  [("ss_store_sk", "s_store_sk")])
            .join(t["household_demographics"].filter(hd_filter),
                  [("ss_hdemo_sk", "hd_demo_sk")])
            .groupBy("ss_ticket_number", "ss_customer_sk")
            .agg(F.count().alias("cnt")))


def q34(t):
    dn = _ticket_counts(
        t,
        (((col("d_dom") >= 1) & (col("d_dom") <= 3))
         | ((col("d_dom") >= 25) & (col("d_dom") <= 28)))
        & col("d_year").isin(1999, 2000, 2001),
        (col("hd_buy_potential").isin(">10000", "unknown"))
        & (col("hd_vehicle_count") > 0)
        & (when(col("hd_vehicle_count") > 0,
                col("hd_dep_count") / col("hd_vehicle_count"))
           .otherwise(None) > 1.2),
        col("s_county") == "Williamson County")
    return (dn.filter((col("cnt") >= 15) & (col("cnt") <= 20))
            .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .select("c_last_name", "c_first_name", "c_salutation",
                    "c_preferred_cust_flag", "ss_ticket_number", "cnt")
            .sort("c_last_name", "c_first_name", "c_salutation",
                  col("c_preferred_cust_flag").desc(), "ss_ticket_number"))


def q42(t):
    return (t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 2000))
            .join(t["store_sales"], [("d_date_sk", "ss_sold_date_sk")])
            .join(t["item"].filter(col("i_manager_id") == 1),
                  [("ss_item_sk", "i_item_sk")])
            .groupBy("d_year", "i_category_id", "i_category")
            .agg(F.sum("ss_ext_sales_price").alias("s"))
            .sort(col("s").desc(), "d_year", "i_category_id", "i_category")
            .limit(100))


def q52(t):
    return (t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 2000))
            .join(t["store_sales"], [("d_date_sk", "ss_sold_date_sk")])
            .join(t["item"].filter(col("i_manager_id") == 1),
                  [("ss_item_sk", "i_item_sk")])
            .groupBy("d_year", "i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select("d_year", col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), "ext_price")
            .sort("d_year", col("ext_price").desc(), "brand_id")
            .limit(100))


def q55(t):
    return (t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 1999))
            .join(t["store_sales"], [("d_date_sk", "ss_sold_date_sk")])
            .join(t["item"].filter(col("i_manager_id") == 28),
                  [("ss_item_sk", "i_item_sk")])
            .groupBy("i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select(col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), "ext_price")
            .sort(col("ext_price").desc(), "brand_id")
            .limit(100))


def q68(t):
    dn = (t["store_sales"]
          .join(t["date_dim"].filter(((col("d_dom") >= 1) & (col("d_dom") <= 2))
                                     & col("d_year").isin(1999, 2000, 2001)),
                [("ss_sold_date_sk", "d_date_sk")])
          .join(t["store"].filter(col("s_city").isin("Midway", "Fairview")),
                [("ss_store_sk", "s_store_sk")])
          .join(t["household_demographics"].filter(
                (col("hd_dep_count") == 4) | (col("hd_vehicle_count") == 3)),
                [("ss_hdemo_sk", "hd_demo_sk")])
          .join(t["customer_address"], [("ss_addr_sk", "ca_address_sk")])
          .groupBy("ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                   col("ca_city").alias("bought_city"))
          .agg(F.sum("ss_ext_sales_price").alias("extended_price"),
               F.sum("ss_ext_list_price").alias("list_price"),
               F.sum("ss_ext_tax").alias("extended_tax")))
    return (dn.join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk", "ca_address_sk")])
            .filter(col("ca_city") != col("bought_city"))
            .select("c_last_name", "c_first_name", "ca_city", "bought_city",
                    "ss_ticket_number", "extended_price", "extended_tax",
                    "list_price")
            .sort("c_last_name", "ss_ticket_number")
            .limit(100))


def q96(t):
    return (t["store_sales"]
            .join(t["time_dim"].filter((col("t_hour") == 20)
                                       & (col("t_minute") >= 30)),
                  [("ss_sold_time_sk", "t_time_sk")])
            .join(t["household_demographics"].filter(col("hd_dep_count") == 7),
                  [("ss_hdemo_sk", "hd_demo_sk")])
            .join(t["store"].filter(col("s_store_name") == "ese"),
                  [("ss_store_sk", "s_store_sk")])
            .agg(F.count().alias("cnt")))


def _year_total(t, sales, cust_k, date_k, amount, year, tag):
    """q4/q11/q74 CTE: per-customer yearly totals for one channel."""
    return (sales
            .join(t["date_dim"].filter(col("d_year") == year),
                  [(date_k, "d_date_sk")])
            .join(t["customer"], [(cust_k, "c_customer_sk")])
            .groupBy(col("c_customer_id").alias(f"{tag}_id"))
            .agg(F.sum(amount).alias(f"{tag}_total"),
                 F.first(col("c_preferred_cust_flag"))
                 .alias(f"{tag}_flag")))


def q4(t):
    ss_amt = ((col("ss_ext_list_price") - col("ss_ext_wholesale_cost")
               - col("ss_ext_discount_amt") + col("ss_ext_sales_price")) / 2)
    cs_amt = ((col("cs_ext_list_price") - col("cs_ext_wholesale_cost")
               - col("cs_ext_discount_amt") + col("cs_ext_sales_price")) / 2)
    ws_amt = ((col("ws_ext_list_price") - col("ws_ext_wholesale_cost")
               - col("ws_ext_discount_amt") + col("ws_ext_sales_price")) / 2)
    s1 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", ss_amt, 1999, "s1")
    s2 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", ss_amt, 2000, "s2")
    c1 = _year_total(t, t["catalog_sales"], "cs_bill_customer_sk",
                     "cs_sold_date_sk", cs_amt, 1999, "c1")
    c2 = _year_total(t, t["catalog_sales"], "cs_bill_customer_sk",
                     "cs_sold_date_sk", cs_amt, 2000, "c2")
    w1 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", ws_amt, 1999, "w1")
    w2 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", ws_amt, 2000, "w2")
    j = (s1.filter(col("s1_total") > 0)
         .join(s2, [("s1_id", "s2_id")])
         .join(c1.filter(col("c1_total") > 0), [("s1_id", "c1_id")])
         .join(c2, [("s1_id", "c2_id")])
         .join(w1.filter(col("w1_total") > 0), [("s1_id", "w1_id")])
         .join(w2, [("s1_id", "w2_id")])
         .filter(((col("c2_total") / col("c1_total"))
                  > (col("s2_total") / col("s1_total")))
                 & ((col("c2_total") / col("c1_total"))
                    > (col("w2_total") / col("w1_total")))))
    return (j.select(col("s1_id").alias("customer_id"),
                     col("s2_flag").alias("customer_preferred_cust_flag"))
            .sort("customer_id").limit(100))


def q14(t):
    # cross-channel items (the intersect CTE): brand/class/category sold in
    # all three channels during 1999-2000
    def ich(sales, item_k, date_k):
        return (sales
                .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                      [(date_k, "d_date_sk")])
                .join(t["item"], [(item_k, "i_item_sk")])
                .select("i_brand_id", "i_class_id_", "i_category_id")
                .distinct())
    # the generator has no i_class_id; class name stands in (noted adaption)
    items = t["item"].withColumn("i_class_id_", col("i_class"))
    tt = dict(t)
    tt["item"] = items

    def ich2(sales, item_k, date_k, tag):
        return (sales
                .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                      [(date_k, "d_date_sk")])
                .join(items, [(item_k, "i_item_sk")])
                .select(col("i_brand_id").alias(f"{tag}b"),
                        col("i_class_id_").alias(f"{tag}c"),
                        col("i_category_id").alias(f"{tag}g"))
                .distinct())
    ssi = ich2(t["store_sales"], "ss_item_sk", "ss_sold_date_sk", "s")
    csi = ich2(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk", "c")
    wsi = ich2(t["web_sales"], "ws_item_sk", "ws_sold_date_sk", "w")
    cross = (ssi.join(csi, [("sb", "cb"), ("sc", "cc"), ("sg", "cg")],
                      "leftsemi")
             .join(wsi, [("sb", "wb"), ("sc", "wc"), ("sg", "wg")],
                   "leftsemi"))
    cross_items = (items.join(
        cross, [("i_brand_id", "sb"), ("i_class_id_", "sc"),
                ("i_category_id", "sg")], "leftsemi")
        .select("i_item_sk"))
    # avg sales threshold over the three channels
    ss_q = (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .select((col("ss_quantity") * col("ss_list_price")).alias("v")))
    cs_q = (t["catalog_sales"]
            .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                  [("cs_sold_date_sk", "d_date_sk")])
            .select((col("cs_quantity") * col("cs_list_price")).alias("v")))
    ws_q = (t["web_sales"]
            .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                  [("ws_sold_date_sk", "d_date_sk")])
            .select((col("ws_quantity") * col("ws_list_price")).alias("v")))
    avg_sales = ss_q.union(cs_q).union(ws_q).agg(F.avg("v").alias("avg_v"))
    dd = t["date_dim"].filter((col("d_year") == 2000) & (col("d_moy") == 11))
    ch = (t["store_sales"].join(dd, [("ss_sold_date_sk", "d_date_sk")],
                                "leftsemi")
          .join(cross_items, [("ss_item_sk", "i_item_sk")], "leftsemi")
          .groupBy(col("ss_item_sk").alias("item"))
          .agg(F.sum(col("ss_quantity") * col("ss_list_price"))
               .alias("sales"), F.count().alias("number_sales")))
    return (ch.crossJoin(avg_sales).filter(col("sales") > col("avg_v"))
            .agg(F.sum("sales").alias("total_sales"),
                 F.sum("number_sales").alias("total_number")))


def q23(t):
    dd4 = t["date_dim"].filter(col("d_year").isin(1998, 1999, 2000, 2001))
    # frequent items: sold on more than 4 distinct dates in 4 years
    freq = (t["store_sales"]
            .join(dd4, [("ss_sold_date_sk", "d_date_sk")])
            .groupBy(col("ss_item_sk").alias("item_sk"))
            .agg(F.countDistinct("d_date_sk").alias("cnt"))
            .filter(col("cnt") > 4).select("item_sk"))
    totals = (t["store_sales"]
              .groupBy(col("ss_customer_sk").alias("csk"))
              .agg(F.sum(col("ss_quantity") * col("ss_sales_price"))
                   .alias("csales")))
    mx = totals.agg(F.max("csales").alias("tpcds_cmax"))
    best = (totals.crossJoin(mx)
            .filter(col("csales") > 0.5 * col("tpcds_cmax"))
            .select("csk"))
    dd1 = t["date_dim"].filter((col("d_year") == 2000) & (col("d_moy") == 2))
    cs = (t["catalog_sales"]
          .join(dd1, [("cs_sold_date_sk", "d_date_sk")], "leftsemi")
          .join(freq, [("cs_item_sk", "item_sk")], "leftsemi")
          .join(best, [("cs_bill_customer_sk", "csk")], "leftsemi")
          .select((col("cs_quantity") * col("cs_list_price")).alias("v")))
    ws = (t["web_sales"]
          .join(dd1, [("ws_sold_date_sk", "d_date_sk")], "leftsemi")
          .join(freq, [("ws_item_sk", "item_sk")], "leftsemi")
          .join(best, [("ws_bill_customer_sk", "csk")], "leftsemi")
          .select((col("ws_quantity") * col("ws_list_price")).alias("v")))
    return cs.union(ws).agg(F.sum("v").alias("total"))


def q27(t):
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == "M") & (col("cd_marital_status") == "S")
        & (col("cd_education_status") == "College"))
    return (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year") == 2002),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"].filter(col("s_state").isin("TN", "GA", "SD")),
                  [("ss_store_sk", "s_store_sk")])
            .join(cd, [("ss_cdemo_sk", "cd_demo_sk")])
            .join(t["item"], [("ss_item_sk", "i_item_sk")])
            .rollup("i_item_id", "s_state")
            .agg(F.avg("ss_quantity").alias("agg1"),
                 F.avg("ss_list_price").alias("agg2"),
                 F.avg("ss_coupon_amt").alias("agg3"),
                 F.avg("ss_sales_price").alias("agg4"))
            .sort("i_item_id", "s_state").limit(100))


def q67(t):
    base = (t["store_sales"]
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .join(t["item"], [("ss_item_sk", "i_item_sk")])
            .rollup("i_category", "i_class", "i_brand", "i_product_name",
                    "d_year", "d_qoy", "d_moy", "s_store_id")
            .agg(F.sum(F.coalesce(col("ss_sales_price") * col("ss_quantity"),
                                  lit(0.0))).alias("sumsales")))
    w = Window.partitionBy("i_category").orderBy(col("sumsales").desc())
    return (base.select("i_category", "i_class", "i_brand", "i_product_name",
                        "d_year", "d_qoy", "d_moy", "s_store_id", "sumsales",
                        F.rank().over(w).alias("rk"))
            .filter(col("rk") <= 100)
            .sort("i_category", col("sumsales").desc(), "rk")
            .limit(100))



QUERIES: Dict[str, object] = {
    name: fn for name, fn in list(globals().items())
    if name.startswith("q") and name[1:].isdigit() and callable(fn)}

_SS_SALES = ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"]
_DATE_MOY = ["d_date_sk", "d_year", "d_moy"]

#: the columns each query reads; a rollup carries its child's every column
#: through its Expand, so q27's and q67's lists name only the columns the
#: result depends on
COLUMNS: Dict[str, Dict[str, List[str]]] = {
    "q3": {"date_dim": _DATE_MOY, "store_sales": _SS_SALES,
           "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"]},
    "q4": {"date_dim": ["d_date_sk", "d_year"],
           "customer": ["c_customer_sk", "c_customer_id",
                        "c_preferred_cust_flag"],
           **{t: [f"{p}_sold_date_sk", cust, f"{p}_ext_discount_amt",
                  f"{p}_ext_sales_price", f"{p}_ext_wholesale_cost",
                  f"{p}_ext_list_price"]
              for t, p, cust in (("store_sales", "ss", "ss_customer_sk"),
                                 ("catalog_sales", "cs",
                                  "cs_bill_customer_sk"),
                                 ("web_sales", "ws", "ws_bill_customer_sk"))}},
    "q7": {"date_dim": ["d_date_sk", "d_year"],
           "item": ["i_item_sk", "i_item_id"],
           "customer_demographics": ["cd_demo_sk", "cd_gender",
                                     "cd_marital_status",
                                     "cd_education_status"],
           "promotion": ["p_promo_sk", "p_channel_email", "p_channel_event"],
           "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                           "ss_promo_sk", "ss_quantity", "ss_list_price",
                           "ss_sales_price", "ss_coupon_amt"]},
    "q14": {"date_dim": _DATE_MOY,
            "item": ["i_item_sk", "i_brand_id", "i_class", "i_category_id"],
            **{t: [f"{p}_sold_date_sk", f"{p}_item_sk", f"{p}_quantity",
                   f"{p}_list_price"]
               for t, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                            ("web_sales", "ws"))}},
    "q19": {"date_dim": _DATE_MOY,
            "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
                     "i_manufact", "i_manager_id"],
            "customer": ["c_customer_sk", "c_current_addr_sk"],
            "customer_address": ["ca_address_sk", "ca_zip"],
            "store": ["s_store_sk", "s_zip"],
            "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                            "ss_store_sk", "ss_ext_sales_price"]},
    "q23": {"date_dim": _DATE_MOY,
            "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                            "ss_quantity", "ss_sales_price"],
            **{t: [f"{p}_sold_date_sk", f"{p}_bill_customer_sk",
                   f"{p}_item_sk", f"{p}_quantity", f"{p}_list_price"]
               for t, p in (("catalog_sales", "cs"), ("web_sales", "ws"))}},
    "q27": {"date_dim": ["d_date_sk", "d_year"],
            "store": ["s_store_sk", "s_state"],
            "customer_demographics": ["cd_demo_sk", "cd_gender",
                                      "cd_marital_status",
                                      "cd_education_status"],
            "item": ["i_item_sk", "i_item_id"],
            "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                            "ss_store_sk", "ss_quantity", "ss_list_price",
                            "ss_sales_price", "ss_coupon_amt"]},
    "q34": {"date_dim": ["d_date_sk", "d_year", "d_dom"],
            "store": ["s_store_sk", "s_county"],
            "household_demographics": ["hd_demo_sk", "hd_buy_potential",
                                       "hd_dep_count", "hd_vehicle_count"],
            "customer": ["c_customer_sk", "c_first_name", "c_last_name",
                         "c_salutation", "c_preferred_cust_flag"],
            "store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                            "ss_hdemo_sk", "ss_store_sk",
                            "ss_ticket_number"]},
    "q42": {"date_dim": _DATE_MOY, "store_sales": _SS_SALES,
            "item": ["i_item_sk", "i_category_id", "i_category",
                     "i_manager_id"]},
    "q52": {"date_dim": _DATE_MOY, "store_sales": _SS_SALES,
            "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"]},
    "q55": {"date_dim": _DATE_MOY, "store_sales": _SS_SALES,
            "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"]},
    "q67": {"date_dim": ["d_date_sk", "d_year", "d_moy", "d_qoy",
                         "d_month_seq"],
            "store": ["s_store_sk", "s_store_id"],
            "item": ["i_item_sk", "i_product_name", "i_brand", "i_class",
                     "i_category"],
            "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                            "ss_quantity", "ss_sales_price"]},
    "q68": {"date_dim": ["d_date_sk", "d_year", "d_dom"],
            "store": ["s_store_sk", "s_city"],
            "household_demographics": ["hd_demo_sk", "hd_dep_count",
                                       "hd_vehicle_count"],
            "customer_address": ["ca_address_sk", "ca_city"],
            "customer": ["c_customer_sk", "c_current_addr_sk",
                         "c_first_name", "c_last_name"],
            "store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                            "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk",
                            "ss_ticket_number", "ss_ext_sales_price",
                            "ss_ext_list_price", "ss_ext_tax"]},
    "q96": {"time_dim": ["t_time_sk", "t_hour", "t_minute"],
            "household_demographics": ["hd_demo_sk", "hd_dep_count"],
            "store": ["s_store_sk", "s_store_name"],
            "store_sales": ["ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"]},
}
