"""The 99 TPC-DS queries over the DataFrame API, spanning the store,
catalog and web channels, their returns and inventory, written as the JAX
package's ``benchmarks/tpcds_queries.py`` writes them (the same text, with
its helpers; constants adapted to its generator's pools as noted there).
``t`` maps a table name to its DataFrame; ``QUERIES`` maps a name to the
query; ``COLUMNS`` lists the columns each query reads, so a caller can
generate or scan only those (``tpcds_data``'s ``columns=``)."""
from __future__ import annotations

import datetime
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


def q46(t):
    dn = (t["store_sales"]
          .join(t["date_dim"].filter(col("d_dow").isin(5, 6)
                                     & col("d_year").isin(1999, 2000, 2001)),
                [("ss_sold_date_sk", "d_date_sk")])
          .join(t["store"].filter(col("s_city").isin("Fairview", "Midway")),
                [("ss_store_sk", "s_store_sk")])
          .join(t["household_demographics"].filter(
                (col("hd_dep_count") == 4) | (col("hd_vehicle_count") == 3)),
                [("ss_hdemo_sk", "hd_demo_sk")])
          .join(t["customer_address"], [("ss_addr_sk", "ca_address_sk")])
          .groupBy("ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                   col("ca_city").alias("bought_city"))
          .agg(F.sum("ss_coupon_amt").alias("amt"),
               F.sum("ss_net_profit").alias("profit")))
    return (dn.join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk", "ca_address_sk")])
            .filter(col("ca_city") != col("bought_city"))
            .select("c_last_name", "c_first_name", "ca_city", "bought_city",
                    "ss_ticket_number", "amt", "profit")
            .sort("c_last_name", "c_first_name", "ca_city", "bought_city",
                  "ss_ticket_number")
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


def _weekly_store_sales(t):
    day = lambda n: F.sum(when(col("d_day_name") == n,  # noqa: E731
                               col("ss_sales_price")).otherwise(None))
    return (t["store_sales"]
            .join(t["date_dim"], [("ss_sold_date_sk", "d_date_sk")])
            .groupBy("d_week_seq", "ss_store_sk")
            .agg(day("Sunday").alias("sun_sales"),
                 day("Monday").alias("mon_sales"),
                 day("Tuesday").alias("tue_sales"),
                 day("Wednesday").alias("wed_sales"),
                 day("Thursday").alias("thu_sales"),
                 day("Friday").alias("fri_sales"),
                 day("Saturday").alias("sat_sales")))


def q59(t):
    wss = _weekly_store_sales(t)
    weeks = (t["date_dim"].select("d_week_seq", "d_month_seq").distinct())

    def year_slice(lo, hi, suffix):
        cols = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
        sel = [col("s_store_name").alias(f"s_store_name{suffix}"),
               col("d_week_seq").alias(f"d_week_seq{suffix}"),
               col("s_store_id").alias(f"s_store_id{suffix}")]
        sel += [col(f"{c}_sales").alias(f"{c}_sales{suffix}") for c in cols]
        return (wss
                .join(weeks.filter((col("d_month_seq") >= lo)
                                   & (col("d_month_seq") <= hi)),
                      [("d_week_seq", "d_week_seq")])
                .join(t["store"], [("ss_store_sk", "s_store_sk")])
                .select(*sel))

    y = year_slice(1212, 1223, "1")
    x = year_slice(1224, 1235, "2")
    joined = y.join(x, [("s_store_id1", "s_store_id2")]).filter(
        col("d_week_seq1") == col("d_week_seq2") - 52)
    ratio = lambda c: (col(f"{c}_sales1") / col(f"{c}_sales2")).alias(f"{c}_r")  # noqa: E731
    return (joined.select("s_store_name1", "s_store_id1", "d_week_seq1",
                          *[ratio(c) for c in
                            ("sun", "mon", "tue", "wed", "thu", "fri", "sat")])
            .sort("s_store_name1", "s_store_id1", "d_week_seq1")
            .limit(100))


def q65(t):
    # d_month_seq window shifted into the generator calendar (reference uses
    # 1176..1187, which predates the 1998 epoch here)
    base = (t["store_sales"]
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .groupBy("ss_store_sk", "ss_item_sk")
            .agg(F.sum("ss_sales_price").alias("revenue")))
    avg_rev = (base.groupBy(col("ss_store_sk").alias("sb_store_sk"))
               .agg(F.avg("revenue").alias("ave")))
    return (base.join(avg_rev, [("ss_store_sk", "sb_store_sk")])
            .filter(col("revenue") <= col("ave") * 0.1)
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .join(t["item"], [("ss_item_sk", "i_item_sk")])
            .select("s_store_name", "i_item_desc", "revenue",
                    "i_current_price", "i_wholesale_cost", "i_brand")
            .sort("s_store_name", "i_item_desc")
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


def q73(t):
    dn = _ticket_counts(
        t,
        ((col("d_dom") >= 1) & (col("d_dom") <= 2))
        & col("d_year").isin(1999, 2000, 2001),
        (col("hd_buy_potential").isin(">10000", "unknown"))
        & (col("hd_vehicle_count") > 0)
        & (when(col("hd_vehicle_count") > 0,
                col("hd_dep_count") / col("hd_vehicle_count"))
           .otherwise(None) > 1),
        col("s_county").isin("Williamson County", "Franklin Parish",
                             "Bronx County", "Orange County"))
    return (dn.filter((col("cnt") >= 1) & (col("cnt") <= 5))
            .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .select("c_last_name", "c_first_name", "c_salutation",
                    "c_preferred_cust_flag", "ss_ticket_number", "cnt")
            .sort(col("cnt").desc(), "c_last_name"))


def q79(t):
    ms = (t["store_sales"]
          .join(t["date_dim"].filter((col("d_dow") == 1)
                                     & col("d_year").isin(1999, 2000, 2001)),
                [("ss_sold_date_sk", "d_date_sk")])
          .join(t["store"].filter((col("s_number_employees") >= 200)
                                  & (col("s_number_employees") <= 295)),
                [("ss_store_sk", "s_store_sk")])
          .join(t["household_demographics"].filter(
                (col("hd_dep_count") == 6) | (col("hd_vehicle_count") > 2)),
                [("ss_hdemo_sk", "hd_demo_sk")])
          .groupBy("ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "s_city")
          .agg(F.sum("ss_coupon_amt").alias("amt"),
               F.sum("ss_net_profit").alias("profit")))
    return (ms.join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .select("c_last_name", "c_first_name",
                    F.substring("s_city", 1, 30).alias("city"),
                    "ss_ticket_number", "amt", "profit")
            .sort("c_last_name", "c_first_name", "city", col("profit").desc())
            .limit(100))


def q89(t):
    cls_match = (
        (col("i_category").isin("Books", "Electronics", "Sports")
         & col("i_class").isin("computers", "stereo", "football"))
        | (col("i_category").isin("Men", "Jewelry", "Women")
           & col("i_class").isin("shirts", "birdal", "dresses")))
    base = (t["store_sales"]
            .join(t["item"].filter(cls_match), [("ss_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter(col("d_year") == 1999),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .groupBy("i_category", "i_class", "i_brand", "s_store_name",
                     "s_company_name", "d_moy")
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    w = Window.partitionBy("i_category", "i_brand", "s_store_name",
                           "s_company_name")
    tmp = base.select("i_category", "i_class", "i_brand", "s_store_name",
                      "s_company_name", "d_moy", "sum_sales",
                      F.avg("sum_sales").over(w).alias("avg_monthly_sales"))
    dev = when(col("avg_monthly_sales") != 0.0,
               F.abs(col("sum_sales") - col("avg_monthly_sales"))
               / col("avg_monthly_sales")).otherwise(None)
    return (tmp.filter(dev > 0.1)
            .select("i_category", "i_class", "i_brand", "s_store_name",
                    "s_company_name", "d_moy", "sum_sales",
                    "avg_monthly_sales",
                    (col("sum_sales") - col("avg_monthly_sales")).alias("_d"))
            .sort("_d", "s_store_name")
            .drop("_d")
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


def q98(t):
    lo = datetime.date(1999, 2, 22)
    hi = lo + datetime.timedelta(days=30)
    base = (t["store_sales"]
            .join(t["item"].filter(col("i_category").isin("Sports", "Books",
                                                          "Home")),
                  [("ss_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter((col("d_date") >= lit(lo))
                                       & (col("d_date") <= lit(hi))),
                  [("ss_sold_date_sk", "d_date_sk")])
            .groupBy("i_item_id", "i_item_desc", "i_category", "i_class",
                     "i_current_price")
            .agg(F.sum("ss_ext_sales_price").alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (base.select("i_item_desc", "i_category", "i_class",
                        "i_current_price", "itemrevenue", "i_item_id",
                        (col("itemrevenue") * 100.0
                         / F.sum("itemrevenue").over(w)).alias("revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio")
            .drop("i_item_id"))


def q43(t):
    day = lambda n: F.sum(when(col("d_day_name") == n,  # noqa: E731
                               col("ss_sales_price")).otherwise(None))
    return (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year") == 2000),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"].filter(col("s_gmt_offset") == -5.0),
                  [("ss_store_sk", "s_store_sk")])
            .groupBy("s_store_name", "s_store_id")
            .agg(day("Sunday").alias("sun_sales"),
                 day("Monday").alias("mon_sales"),
                 day("Tuesday").alias("tue_sales"),
                 day("Wednesday").alias("wed_sales"),
                 day("Thursday").alias("thu_sales"),
                 day("Friday").alias("fri_sales"),
                 day("Saturday").alias("sat_sales"))
            .sort("s_store_name", "s_store_id")
            .limit(100))


# ---------------------------------------------------------------------------
# catalog / web channel queries (generator constants adapted to the pools:
# state lists -> the generator's state pool, manufact ids -> the 1..n_item
# cycle, reason desc -> the generated reason strings; noted per query)
# ---------------------------------------------------------------------------

def q15(t):
    zips = ["85669", "86197", "88274", "83405", "86475", "85392", "85460",
            "80348", "81792"]
    cond = (F.substring("ca_zip", 1, 5).isin(*zips)
            | col("ca_state").isin("CA", "WA", "GA")
            | (col("cs_sales_price") > 500))
    return (t["catalog_sales"]
            .join(t["customer"], [("cs_bill_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk",
                                           "ca_address_sk")])
            .join(t["date_dim"].filter((col("d_qoy") == 2)
                                       & (col("d_year") == 2001)),
                  [("cs_sold_date_sk", "d_date_sk")])
            .filter(cond)
            .groupBy("ca_zip")
            .agg(F.sum("cs_sales_price").alias("sum_sales_price"))
            .sort("ca_zip").limit(100))


def _shipping_report(sales, returns, prefix, t, extra_join, state):
    """Shared q16/q94 shape: distinct orders shipping to a state within 60
    days, from orders spanning >1 warehouse (exists), never returned
    (not exists)."""
    p = prefix
    lo = datetime.date(2002, 2, 1) if p == "cs" else datetime.date(1999, 2, 1)
    hi = lo + datetime.timedelta(days=60)
    multi_wh = (sales
                .select(col(f"{p}_order_number").alias("o2"),
                        col(f"{p}_warehouse_sk").alias("w2"))
                .filter(col("w2").isNotNull())
                .groupBy("o2").agg(F.countDistinct("w2").alias("nw"))
                .filter(col("nw") >= 2).select("o2"))
    base = (sales
            .join(t["date_dim"].filter((col("d_date") >= lit(lo))
                                       & (col("d_date") <= lit(hi))),
                  [(f"{p}_ship_date_sk", "d_date_sk")])
            .join(t["customer_address"].filter(col("ca_state") == state),
                  [(f"{p}_ship_addr_sk", "ca_address_sk")])
            .join(extra_join[0], [extra_join[1]])
            .join(multi_wh, [(f"{p}_order_number", "o2")], "leftsemi")
            .join(returns, [(f"{p}_order_number", "ro")], "leftanti"))
    return (base.agg(
        F.countDistinct(f"{p}_order_number").alias("order_count"),
        F.sum(f"{p}_ext_ship_cost").alias("total_shipping_cost"),
        F.sum(f"{p}_net_profit").alias("total_net_profit")))


def q16(t):
    cc = t["call_center"].filter(col("cc_county") == "Williamson County")
    wr = t["catalog_returns"].select(col("cr_order_number").alias("ro"))
    return _shipping_report(t["catalog_sales"], wr, "cs", t,
                            (cc, ("cs_call_center_sk", "cc_call_center_sk")),
                            "GA")


def q94(t):
    # state IL -> GA (generator state pool); web company 'pri' is in the pool
    ws = t["web_site"].filter(col("web_company_name") == "pri")
    wr = t["web_returns"].select(col("wr_order_number").alias("ro"))
    return _shipping_report(t["web_sales"], wr, "ws", t,
                            (ws, ("ws_web_site_sk", "web_site_sk")), "GA")


def q18(t):
    # birth months / state list adapted to the generator pools
    cd1 = t["customer_demographics"].filter(
        (col("cd_gender") == "F") & (col("cd_education_status") == "Unknown"))
    cust = t["customer"].filter(col("c_birth_month").isin(1, 6, 8, 9, 12, 2))
    return (t["catalog_sales"]
            .join(t["date_dim"].filter(col("d_year") == 1998),
                  [("cs_sold_date_sk", "d_date_sk")])
            .join(t["item"], [("cs_item_sk", "i_item_sk")])
            .join(cd1.select(col("cd_demo_sk").alias("cd1_sk"),
                             col("cd_dep_count").alias("cd1_dep_count")),
                  [("cs_bill_cdemo_sk", "cd1_sk")])
            .join(cust, [("cs_bill_customer_sk", "c_customer_sk")])
            .join(t["customer_demographics"].select(
                col("cd_demo_sk").alias("cd2_sk")),
                [("c_current_cdemo_sk", "cd2_sk")])
            .join(t["customer_address"].filter(
                col("ca_state").isin("TN", "IN", "SD", "OH", "TX", "GA")),
                [("c_current_addr_sk", "ca_address_sk")])
            .rollup("i_item_id", "ca_country", "ca_state", "ca_county")
            .agg(F.avg("cs_quantity").alias("agg1"),
                 F.avg("cs_list_price").alias("agg2"),
                 F.avg("cs_coupon_amt").alias("agg3"),
                 F.avg("cs_sales_price").alias("agg4"),
                 F.avg("cs_net_profit").alias("agg5"),
                 F.avg("c_birth_year").alias("agg6"),
                 F.avg("cd1_dep_count").alias("agg7"))
            .sort("ca_country", "ca_state", "ca_county", "i_item_id")
            .limit(100))


def q20(t):
    lo = datetime.date(1999, 2, 22)
    hi = lo + datetime.timedelta(days=30)
    base = (t["catalog_sales"]
            .join(t["item"].filter(col("i_category").isin("Sports", "Books",
                                                          "Home")),
                  [("cs_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter((col("d_date") >= lit(lo))
                                       & (col("d_date") <= lit(hi))),
                  [("cs_sold_date_sk", "d_date_sk")])
            .groupBy("i_item_id", "i_item_desc", "i_category", "i_class",
                     "i_current_price")
            .agg(F.sum("cs_ext_sales_price").alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (base.select("i_item_id", "i_item_desc", "i_category", "i_class",
                        "i_current_price", "itemrevenue",
                        (col("itemrevenue") * 100.0
                         / F.sum("itemrevenue").over(w)).alias("revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio")
            .limit(100))


def q21(t):
    pivot = lit(datetime.date(2000, 3, 11))
    dd = t["date_dim"].filter(
        (F.datediff(col("d_date"), pivot) >= -30)
        & (F.datediff(col("d_date"), pivot) <= 30))
    base = (t["inventory"]
            .join(t["warehouse"], [("inv_warehouse_sk", "w_warehouse_sk")])
            .join(t["item"].filter((col("i_current_price") >= 0.99)
                                   & (col("i_current_price") <= 1.49)),
                  [("inv_item_sk", "i_item_sk")])
            .join(dd, [("inv_date_sk", "d_date_sk")])
            .groupBy("w_warehouse_name", "i_item_id")
            .agg(F.sum(when(col("d_date") < pivot,
                            col("inv_quantity_on_hand")).otherwise(0))
                 .alias("inv_before"),
                 F.sum(when(col("d_date") >= pivot,
                            col("inv_quantity_on_hand")).otherwise(0))
                 .alias("inv_after")))
    ratio = when(col("inv_before") > 0,
                 col("inv_after") / col("inv_before")).otherwise(None)
    return (base.filter((ratio >= 2.0 / 3.0) & (ratio <= 3.0 / 2.0))
            .sort("w_warehouse_name", "i_item_id")
            .limit(100))


def _sold_returned_rebought(t, d1_filter, d2_filter, d3_filter, aggs):
    """Shared q25/q29 chain: store sale -> store return -> catalog re-buy by
    the same customer."""
    ss = (t["store_sales"]
          .join(t["date_dim"].filter(d1_filter).select("d_date_sk"),
                [("ss_sold_date_sk", "d_date_sk")])
          .join(t["item"], [("ss_item_sk", "i_item_sk")])
          .join(t["store"], [("ss_store_sk", "s_store_sk")]))
    sr = (t["store_returns"]
          .join(t["date_dim"].filter(d2_filter).select(
              col("d_date_sk").alias("d2_sk")),
              [("sr_returned_date_sk", "d2_sk")]))
    cs = (t["catalog_sales"]
          .join(t["date_dim"].filter(d3_filter).select(
              col("d_date_sk").alias("d3_sk")),
              [("cs_sold_date_sk", "d3_sk")]))
    return (ss.join(sr, [("ss_customer_sk", "sr_customer_sk"),
                         ("ss_item_sk", "sr_item_sk"),
                         ("ss_ticket_number", "sr_ticket_number")])
            .join(cs, [("sr_customer_sk", "cs_bill_customer_sk"),
                       ("sr_item_sk", "cs_item_sk")])
            .groupBy("i_item_id", "i_item_desc", "s_store_id", "s_store_name")
            .agg(*aggs)
            .sort("i_item_id", "i_item_desc", "s_store_id", "s_store_name")
            .limit(100))


def q25(t):
    return _sold_returned_rebought(
        t,
        (col("d_moy") == 4) & (col("d_year") == 2001),
        (col("d_moy") >= 4) & (col("d_moy") <= 10) & (col("d_year") == 2001),
        (col("d_moy") >= 4) & (col("d_moy") <= 10) & (col("d_year") == 2001),
        [F.sum("ss_net_profit").alias("store_sales_profit"),
         F.sum("sr_net_loss").alias("store_returns_loss"),
         F.sum("cs_net_profit").alias("catalog_sales_profit")])


def q29(t):
    return _sold_returned_rebought(
        t,
        (col("d_moy") == 9) & (col("d_year") == 1999),
        (col("d_moy") >= 9) & (col("d_moy") <= 12) & (col("d_year") == 1999),
        col("d_year").isin(1999, 2000, 2001),
        [F.sum("ss_quantity").alias("store_sales_quantity"),
         F.sum("sr_return_quantity").alias("store_returns_quantity"),
         F.sum("cs_quantity").alias("catalog_sales_quantity")])


def q26(t):
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == "M") & (col("cd_marital_status") == "S")
        & (col("cd_education_status") == "College"))
    promo = t["promotion"].filter((col("p_channel_email") == "N")
                                  | (col("p_channel_event") == "N"))
    return (t["catalog_sales"]
            .join(t["date_dim"].filter(col("d_year") == 2000),
                  [("cs_sold_date_sk", "d_date_sk")])
            .join(t["item"], [("cs_item_sk", "i_item_sk")])
            .join(cd, [("cs_bill_cdemo_sk", "cd_demo_sk")])
            .join(promo, [("cs_promo_sk", "p_promo_sk")])
            .groupBy("i_item_id")
            .agg(F.avg("cs_quantity").alias("agg1"),
                 F.avg("cs_list_price").alias("agg2"),
                 F.avg("cs_coupon_amt").alias("agg3"),
                 F.avg("cs_sales_price").alias("agg4"))
            .sort("i_item_id").limit(100))


def _excess_discount(t, sales, prefix, manufact_id):
    """Shared q32/q92: discounts above 1.3x the item's window average."""
    p = prefix
    lo = datetime.date(2000, 1, 27)
    hi = lo + datetime.timedelta(days=90)
    dd = (t["date_dim"]
          .filter((col("d_date") >= lit(lo)) & (col("d_date") <= lit(hi)))
          .select("d_date_sk"))
    windowed = sales.join(dd, [(f"{p}_sold_date_sk", "d_date_sk")])
    thresholds = (windowed
                  .groupBy(col(f"{p}_item_sk").alias("th_item"))
                  .agg(F.avg(f"{p}_ext_discount_amt").alias("th_avg"))
                  .select("th_item",
                          (col("th_avg") * 1.3).alias("threshold")))
    return (windowed
            .join(t["item"].filter(col("i_manufact_id") == manufact_id),
                  [(f"{p}_item_sk", "i_item_sk")])
            .join(thresholds, [(f"{p}_item_sk", "th_item")])
            .filter(col(f"{p}_ext_discount_amt") > col("threshold"))
            .agg(F.sum(f"{p}_ext_discount_amt")
                 .alias("excess_discount_amount")))


def q32(t):
    # manufact 977 -> 77 (the generator cycles manufact ids over 1..n_item)
    return _excess_discount(t, t["catalog_sales"], "cs", 77)


def q92(t):
    # manufact 350 -> 50
    return _excess_discount(t, t["web_sales"], "ws", 50)


def q37(t):
    lo = datetime.date(2000, 2, 1)
    hi = lo + datetime.timedelta(days=60)
    # manufact list 677/940/694/808 -> 8/33/58/83 (the generator's planted
    # mid-price band: manufact id == item sk cycle, plants at sk%25==8)
    items = t["item"].filter(
        (col("i_current_price") >= 68) & (col("i_current_price") <= 98)
        & col("i_manufact_id").isin(8, 33, 58, 83))
    inv = (t["inventory"]
           .filter((col("inv_quantity_on_hand") >= 100)
                   & (col("inv_quantity_on_hand") <= 500))
           .join(t["date_dim"].filter((col("d_date") >= lit(lo))
                                      & (col("d_date") <= lit(hi))),
                 [("inv_date_sk", "d_date_sk")]))
    return (items.join(inv, [("i_item_sk", "inv_item_sk")])
            .join(t["catalog_sales"], [("i_item_sk", "cs_item_sk")],
                  "leftsemi")
            .select("i_item_id", "i_item_desc", "i_current_price")
            .dropDuplicates()
            .sort("i_item_id").limit(100))


def q40(t):
    pivot = datetime.date(2000, 3, 11)
    dd = t["date_dim"].filter(
        (F.datediff(col("d_date"), lit(pivot)) >= -30)
        & (F.datediff(col("d_date"), lit(pivot)) <= 30))
    net = col("cs_sales_price") - F.coalesce(col("cr_refunded_cash"),
                                             lit(0.0))
    return (t["catalog_sales"]
            .join(t["catalog_returns"],
                  [("cs_order_number", "cr_order_number"),
                   ("cs_item_sk", "cr_item_sk")], "left")
            .join(t["warehouse"], [("cs_warehouse_sk", "w_warehouse_sk")])
            .join(t["item"].filter((col("i_current_price") >= 0.99)
                                   & (col("i_current_price") <= 1.49)),
                  [("cs_item_sk", "i_item_sk")])
            .join(dd, [("cs_sold_date_sk", "d_date_sk")])
            .groupBy("w_state", "i_item_id")
            .agg(F.sum(when(col("d_date") < lit(pivot), net).otherwise(0.0))
                 .alias("sales_before"),
                 F.sum(when(col("d_date") >= lit(pivot), net).otherwise(0.0))
                 .alias("sales_after"))
            .sort("w_state", "i_item_id")
            .limit(100))


def q45(t):
    zips = ["85669", "86197", "88274", "83405", "86475", "85392", "85460",
            "80348", "81792"]
    marked = (t["item"]
              .filter(col("i_item_sk").isin(2, 3, 5, 7, 11, 13, 17, 19,
                                            23, 29))
              .select(col("i_item_id").alias("m_id"))
              .withColumn("m_flag", lit(1)))
    return (t["web_sales"]
            .join(t["customer"], [("ws_bill_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk",
                                           "ca_address_sk")])
            .join(t["item"], [("ws_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter((col("d_qoy") == 2)
                                       & (col("d_year") == 2001)),
                  [("ws_sold_date_sk", "d_date_sk")])
            .join(marked.dropDuplicates(), [("i_item_id", "m_id")], "left")
            .filter(F.substring("ca_zip", 1, 5).isin(*zips)
                    | col("m_flag").isNotNull())
            .groupBy("ca_zip", "ca_city")
            .agg(F.sum("ws_sales_price").alias("sum_ws_sales_price"))
            .sort("ca_zip", "ca_city").limit(100))


def _ship_day_buckets(t, sales, prefix, dim, dim_key, dim_name):
    p = prefix
    days = col(f"{p}_ship_date_sk") - col(f"{p}_sold_date_sk")
    bucket = lambda lo, hi: F.sum(  # noqa: E731
        when(((days > lo) if lo is not None else lit(True))
             & ((days <= hi) if hi is not None else lit(True)), 1)
        .otherwise(0))
    return (sales
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [(f"{p}_ship_date_sk", "d_date_sk")])
            .join(t["warehouse"], [(f"{p}_warehouse_sk", "w_warehouse_sk")])
            .join(t["ship_mode"], [(f"{p}_ship_mode_sk", "sm_ship_mode_sk")])
            .join(dim, [dim_key])
            .groupBy(F.substring("w_warehouse_name", 1, 20).alias("wname"),
                     "sm_type", dim_name)
            .agg(bucket(None, 30).alias("d30"),
                 bucket(30, 60).alias("d31_60"),
                 bucket(60, 90).alias("d61_90"),
                 bucket(90, 120).alias("d91_120"),
                 bucket(120, None).alias("d_over_120"))
            .sort("wname", "sm_type", dim_name)
            .limit(100))


def q62(t):
    return _ship_day_buckets(t, t["web_sales"], "ws", t["web_site"],
                             ("ws_web_site_sk", "web_site_sk"), "web_name")


def q99(t):
    return _ship_day_buckets(t, t["catalog_sales"], "cs", t["call_center"],
                             ("cs_call_center_sk", "cc_call_center_sk"),
                             "cc_name")


def q90(t):
    def slot(h_lo):
        return (t["web_sales"]
                .join(t["household_demographics"]
                      .filter(col("hd_dep_count") == 6),
                      [("ws_ship_hdemo_sk", "hd_demo_sk")])
                .join(t["time_dim"].filter((col("t_hour") >= h_lo)
                                           & (col("t_hour") <= h_lo + 1)),
                      [("ws_sold_time_sk", "t_time_sk")])
                .join(t["web_page"].filter((col("wp_char_count") >= 5000)
                                           & (col("wp_char_count") <= 5200)),
                      [("ws_web_page_sk", "wp_web_page_sk")])
                .agg(F.count().alias("amc" if h_lo == 8 else "pmc")))

    return (slot(8).crossJoin(slot(19))
            .select((col("amc") / col("pmc")).alias("am_pm_ratio")))


def q93(t):
    # reason desc adapted to the generated reason table
    act = when(col("sr_return_quantity").isNotNull(),
               (col("ss_quantity") - col("sr_return_quantity"))
               * col("ss_sales_price")).otherwise(
        col("ss_quantity") * col("ss_sales_price"))
    return (t["store_sales"]
            .join(t["store_returns"],
                  [("ss_item_sk", "sr_item_sk"),
                   ("ss_ticket_number", "sr_ticket_number")], "left")
            .join(t["reason"].filter(
                col("r_reason_desc") == "Package was damaged"),
                [("sr_reason_sk", "r_reason_sk")])
            .select("ss_customer_sk", act.alias("act_sales"))
            .groupBy("ss_customer_sk")
            .agg(F.sum("act_sales").alias("sumsales"))
            .sort("sumsales", "ss_customer_sk")
            .limit(100))


# ---------------------------------------------------------------------------
# multi-channel, window and scalar-subquery queries
# ---------------------------------------------------------------------------

def q6(t):
    month = (t["date_dim"]
             .filter((col("d_year") == 2001) & (col("d_moy") == 1))
             .select("d_month_seq").distinct()
             .withColumnRenamed("d_month_seq", "m_seq"))
    cat_avg = (t["item"].groupBy(col("i_category").alias("cat"))
               .agg(F.avg("i_current_price").alias("cat_avg")))
    pricey = (t["item"].join(cat_avg, [("i_category", "cat")])
              .filter(col("i_current_price") > 1.2 * col("cat_avg"))
              .select("i_item_sk"))
    return (t["store_sales"]
            .join(t["date_dim"].join(month, [("d_month_seq", "m_seq")],
                                     "leftsemi"),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(pricey, [("ss_item_sk", "i_item_sk")], "leftsemi")
            .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
            .join(t["customer_address"], [("c_current_addr_sk",
                                           "ca_address_sk")])
            .groupBy(col("ca_state").alias("state"))
            .agg(F.count().alias("cnt"))
            .filter(col("cnt") >= 10)
            .sort("cnt").limit(100))


def q13(t):
    # state triplets adapted to the generator pool
    demo_ok = (((col("cd_marital_status") == "M")
                & (col("cd_education_status") == "Advanced Degree")
                & (col("ss_sales_price") >= 100.0)
                & (col("ss_sales_price") <= 150.0)
                & (col("hd_dep_count") == 3))
               | ((col("cd_marital_status") == "S")
                  & (col("cd_education_status") == "College")
                  & (col("ss_sales_price") >= 50.0)
                  & (col("ss_sales_price") <= 100.0)
                  & (col("hd_dep_count") == 1))
               | ((col("cd_marital_status") == "W")
                  & (col("cd_education_status") == "2 yr Degree")
                  & (col("ss_sales_price") >= 150.0)
                  & (col("ss_sales_price") <= 200.0)
                  & (col("hd_dep_count") == 1)))
    geo_ok = (((col("ca_country") == "United States")
               & col("ca_state").isin("TX", "OH", "GA")
               & (col("ss_net_profit") >= 100)
               & (col("ss_net_profit") <= 200))
              | ((col("ca_country") == "United States")
                 & col("ca_state").isin("TN", "IN", "SD")
                 & (col("ss_net_profit") >= 150)
                 & (col("ss_net_profit") <= 300))
              | ((col("ca_country") == "United States")
                 & col("ca_state").isin("LA", "MI", "SC")
                 & (col("ss_net_profit") >= 50)
                 & (col("ss_net_profit") <= 250)))
    return (t["store_sales"]
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .join(t["date_dim"].filter(col("d_year") == 2001),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["customer_demographics"], [("ss_cdemo_sk", "cd_demo_sk")])
            .join(t["household_demographics"], [("ss_hdemo_sk", "hd_demo_sk")])
            .join(t["customer_address"], [("ss_addr_sk", "ca_address_sk")])
            .filter(demo_ok & geo_ok)
            .agg(F.avg("ss_quantity").alias("avg_quantity"),
                 F.avg("ss_ext_sales_price").alias("avg_ext_sales_price"),
                 F.avg("ss_ext_wholesale_cost").alias("avg_ext_wholesale"),
                 F.sum("ss_ext_wholesale_cost").alias("sum_ext_wholesale")))


def q17(t):
    ss = (t["store_sales"]
          .join(t["date_dim"].filter(col("d_quarter_name") == "2001Q1")
                .select("d_date_sk"),
                [("ss_sold_date_sk", "d_date_sk")])
          .join(t["item"], [("ss_item_sk", "i_item_sk")])
          .join(t["store"], [("ss_store_sk", "s_store_sk")]))
    q123 = ("2001Q1", "2001Q2", "2001Q3")
    sr = (t["store_returns"]
          .join(t["date_dim"].filter(col("d_quarter_name").isin(*q123))
                .select(col("d_date_sk").alias("d2_sk")),
                [("sr_returned_date_sk", "d2_sk")]))
    cs = (t["catalog_sales"]
          .join(t["date_dim"].filter(col("d_quarter_name").isin(*q123))
                .select(col("d_date_sk").alias("d3_sk")),
                [("cs_sold_date_sk", "d3_sk")]))
    cov = lambda c: F.stddev(c) / F.avg(c)  # noqa: E731
    return (ss.join(sr, [("ss_customer_sk", "sr_customer_sk"),
                         ("ss_item_sk", "sr_item_sk"),
                         ("ss_ticket_number", "sr_ticket_number")])
            .join(cs, [("sr_customer_sk", "cs_bill_customer_sk"),
                       ("sr_item_sk", "cs_item_sk")])
            .groupBy("i_item_id", "i_item_desc", "s_state")
            .agg(F.count("ss_quantity").alias("store_sales_quantitycount"),
                 F.avg("ss_quantity").alias("store_sales_quantityave"),
                 F.stddev("ss_quantity").alias("store_sales_quantitystdev"),
                 F.count("sr_return_quantity")
                 .alias("store_returns_quantitycount"),
                 F.avg("sr_return_quantity")
                 .alias("store_returns_quantityave"),
                 F.stddev("sr_return_quantity")
                 .alias("store_returns_quantitystdev"),
                 F.count("cs_quantity").alias("catalog_sales_quantitycount"),
                 F.avg("cs_quantity").alias("catalog_sales_quantityave"),
                 F.stddev("cs_quantity").alias("catalog_sales_quantitystdev"))
            .withColumn("store_sales_quantitycov",
                        col("store_sales_quantitystdev")
                        / col("store_sales_quantityave"))
            .withColumn("store_returns_quantitycov",
                        col("store_returns_quantitystdev")
                        / col("store_returns_quantityave"))
            .withColumn("catalog_sales_quantitycov",
                        col("catalog_sales_quantitystdev")
                        / col("catalog_sales_quantityave"))
            .sort("i_item_id", "i_item_desc", "s_state")
            .limit(100))


def q28(t):
    buckets = [
        # (qty_lo, qty_hi, lp_lo, coupon_lo, cost_lo, name)
        (0, 5, 8, 459, 57, "b1"),
        (6, 10, 90, 2323, 31, "b2"),
        (11, 15, 142, 12214, 79, "b3"),
        (16, 20, 135, 6071, 38, "b4"),
        (21, 25, 122, 836, 17, "b5"),
        (26, 30, 154, 7326, 7, "b6"),
    ]

    def bucket(qlo, qhi, lp, cp, wc, name):
        return (t["store_sales"]
                .filter((col("ss_quantity") >= qlo)
                        & (col("ss_quantity") <= qhi)
                        & (((col("ss_list_price") >= lp)
                            & (col("ss_list_price") <= lp + 10))
                           | ((col("ss_coupon_amt") >= cp)
                              & (col("ss_coupon_amt") <= cp + 1000))
                           | ((col("ss_wholesale_cost") >= wc)
                              & (col("ss_wholesale_cost") <= wc + 20))))
                .agg(F.avg("ss_list_price").alias(f"{name}_lp"),
                     F.count("ss_list_price").alias(f"{name}_cnt"),
                     F.countDistinct("ss_list_price").alias(f"{name}_cntd")))

    out = bucket(*buckets[0])
    for b in buckets[1:]:
        out = out.crossJoin(bucket(*b))
    return out.limit(100)


def _channel_union_by(t, key_out, item_filter_col, item_filter_vals,
                      year, moy):
    """Shared q33/q60 shape: per-channel revenue for an item subset, unioned
    and re-aggregated. key_out is 'i_manufact_id' or 'i_item_id'."""
    subset = (t["item"]
              .filter(col(item_filter_col).isin(*item_filter_vals))
              .select(col(key_out).alias("sub_key")).distinct())
    dd = (t["date_dim"]
          .filter((col("d_year") == year) & (col("d_moy") == moy))
          .select("d_date_sk"))
    addr = (t["customer_address"].filter(col("ca_gmt_offset") == -5.0)
            .select("ca_address_sk"))

    def channel(sales, item_k, date_k, addr_k, amount):
        return (sales
                .join(dd, [(date_k, "d_date_sk")], "leftsemi")
                .join(addr, [(addr_k, "ca_address_sk")], "leftsemi")
                .join(t["item"], [(item_k, "i_item_sk")])
                .join(subset, [(key_out, "sub_key")], "leftsemi")
                .groupBy(key_out)
                .agg(F.sum(amount).alias("total_sales")))

    u = (channel(t["store_sales"], "ss_item_sk", "ss_sold_date_sk",
                 "ss_addr_sk", "ss_ext_sales_price")
         .union(channel(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk",
                        "cs_bill_addr_sk", "cs_ext_sales_price"))
         .union(channel(t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                        "ws_bill_addr_sk", "ws_ext_sales_price")))
    return u.groupBy(key_out).agg(F.sum("total_sales").alias("total_sales"))


def q33(t):
    return (_channel_union_by(t, "i_manufact_id", "i_category",
                              ["Electronics"], 1998, 5)
            .sort("total_sales").limit(100))


def q60(t):
    return (_channel_union_by(t, "i_item_id", "i_category", ["Music"],
                              1998, 9)
            .sort("i_item_id", "total_sales").limit(100))


def _rollup_rank(t, sales, item_k, date_k, value, date_filter, extra_joins):
    """Shared q36/q86 shape: rollup over (category, class) with a rank within
    each hierarchy level. grouping() is derived from the rolled-up nulls
    (generated categories/classes are never null)."""
    base = sales.join(t["date_dim"].filter(date_filter),
                      [(date_k, "d_date_sk")])
    for frame, key in extra_joins:
        base = base.join(frame, [key])
    base = base.join(t["item"], [(item_k, "i_item_sk")])
    rolled = (base.rollup("i_category", "i_class")
              .agg(F.sum(value[0]).alias("_num"),
                   *([F.sum(value[1]).alias("_den")] if value[1] else [])))
    measure = (col("_num") / col("_den")) if value[1] else col("_num")
    lochierarchy = (when(col("i_category").isNull(), 1).otherwise(0)
                    + when(col("i_class").isNull(), 1).otherwise(0))
    tmp = rolled.select(
        measure.alias("total_sum"), "i_category", "i_class",
        lochierarchy.alias("lochierarchy"),
        when(col("i_class").isNotNull(), col("i_category"))
        .otherwise(None).alias("_parent"))
    w = (Window.partitionBy("lochierarchy", "_parent")
         .orderBy(col("total_sum").desc() if value[1] is None
                  else col("total_sum").asc()))
    return (tmp.select("total_sum", "i_category", "i_class", "lochierarchy",
                       F.rank().over(w).alias("rank_within_parent"))
            .sort(col("lochierarchy").desc(),
                  when(col("lochierarchy") == 0, col("i_category"))
                  .otherwise(None),
                  "rank_within_parent")
            .limit(100))


def q36(t):
    return _rollup_rank(
        t, t["store_sales"], "ss_item_sk", "ss_sold_date_sk",
        ("ss_net_profit", "ss_ext_sales_price"),
        col("d_year") == 2001,
        [(t["store"].filter(col("s_state") == "TN"),
          ("ss_store_sk", "s_store_sk"))])


def q86(t):
    return _rollup_rank(
        t, t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
        ("ws_net_paid", None),
        (col("d_month_seq") >= 1200) & (col("d_month_seq") <= 1211),
        [])


def q44(t):
    # store 4 -> the generator's 6-store pool includes it
    base = (t["store_sales"].filter(col("ss_store_sk") == 4)
            .groupBy(col("ss_item_sk").alias("item_sk"))
            .agg(F.avg("ss_net_profit").alias("rank_col")))
    floor_ = (t["store_sales"]
              .filter((col("ss_store_sk") == 4) & col("ss_addr_sk").isNull())
              .groupBy("ss_store_sk")
              .agg(F.avg("ss_net_profit").alias("f_avg"))
              .select((col("f_avg") * 0.9).alias("floor_val")))
    qualified = (base.crossJoin(floor_)
                 .filter(col("rank_col") > col("floor_val")))
    asc = (qualified.select(
        "item_sk", F.rank().over(Window.orderBy(col("rank_col").asc()))
        .alias("rnk")).filter(col("rnk") < 11))
    desc = (qualified.select(
        col("item_sk").alias("item_sk_d"),
        F.rank().over(Window.orderBy(col("rank_col").desc()))
        .alias("rnk_d")).filter(col("rnk_d") < 11))
    return (asc.join(desc, [("rnk", "rnk_d")])
            .join(t["item"].select(col("i_item_sk").alias("i1_sk"),
                                   col("i_product_name").alias(
                                       "best_performing")),
                  [("item_sk", "i1_sk")])
            .join(t["item"].select(col("i_item_sk").alias("i2_sk"),
                                   col("i_product_name").alias(
                                       "worst_performing")),
                  [("item_sk_d", "i2_sk")])
            .select("rnk", "best_performing", "worst_performing")
            .sort("rnk").limit(100))


def q47(t):
    v1 = (t["store_sales"]
          .join(t["item"], [("ss_item_sk", "i_item_sk")])
          .join(t["date_dim"].filter(
              (col("d_year") == 1999)
              | ((col("d_year") == 1998) & (col("d_moy") == 12))
              | ((col("d_year") == 2000) & (col("d_moy") == 1))),
              [("ss_sold_date_sk", "d_date_sk")])
          .join(t["store"], [("ss_store_sk", "s_store_sk")])
          .groupBy("i_category", "i_brand", "s_store_name", "s_company_name",
                   "d_year", "d_moy")
          .agg(F.sum("ss_sales_price").alias("sum_sales")))
    wavg = Window.partitionBy("i_category", "i_brand", "s_store_name",
                              "s_company_name", "d_year")
    wrank = (Window.partitionBy("i_category", "i_brand", "s_store_name",
                                "s_company_name")
             .orderBy("d_year", "d_moy"))
    v1 = v1.select("i_category", "i_brand", "s_store_name", "s_company_name",
                   "d_year", "d_moy", "sum_sales",
                   F.avg("sum_sales").over(wavg).alias("avg_monthly_sales"),
                   F.rank().over(wrank).alias("rn"))
    lagf = v1.select(col("i_category").alias("lc"), col("i_brand").alias("lb"),
                     col("s_store_name").alias("lsn"),
                     col("s_company_name").alias("lcn"),
                     col("rn").alias("lrn"),
                     col("sum_sales").alias("psum"))
    leadf = v1.select(col("i_category").alias("dc"),
                      col("i_brand").alias("db"),
                      col("s_store_name").alias("dsn"),
                      col("s_company_name").alias("dcn"),
                      col("rn").alias("drn"),
                      col("sum_sales").alias("nsum"))
    v2 = (v1.withColumn("rn_prev", col("rn") - 1)
          .withColumn("rn_next", col("rn") + 1)
          .join(lagf, [("i_category", "lc"), ("i_brand", "lb"),
                       ("s_store_name", "lsn"), ("s_company_name", "lcn"),
                       ("rn_prev", "lrn")])
          .join(leadf, [("i_category", "dc"), ("i_brand", "db"),
                        ("s_store_name", "dsn"), ("s_company_name", "dcn"),
                        ("rn_next", "drn")]))
    dev = when(col("avg_monthly_sales") > 0,
               F.abs(col("sum_sales") - col("avg_monthly_sales"))
               / col("avg_monthly_sales")).otherwise(None)
    return (v2.filter((col("d_year") == 1999)
                      & (col("avg_monthly_sales") > 0) & (dev > 0.1))
            .select("i_category", "i_brand", "s_store_name", "s_company_name",
                    "d_year", "d_moy", "avg_monthly_sales", "sum_sales",
                    "psum", "nsum",
                    (col("sum_sales") - col("avg_monthly_sales")).alias("_d"))
            .sort("_d", "s_store_name").drop("_d")
            .limit(100))


def _manager_monthly_deviation(t, group_key, time_key):
    """Shared q53/q63 shape."""
    cls_a = (col("i_category").isin("Books", "Children", "Electronics")
             & col("i_class").isin("personal", "portable", "reference",
                                   "self-help")
             & col("i_brand").isin("scholaramalgamalg #14",
                                   "scholaramalgamalg #7",
                                   "exportiunivamalg #9",
                                   "scholaramalgamalg #9"))
    cls_b = (col("i_category").isin("Women", "Music", "Men")
             & col("i_class").isin("accessories", "classical", "fragrances",
                                   "pants")
             & col("i_brand").isin("amalgimporto #1", "edu packscholar #1",
                                   "exportiimporto #1", "importoamalg #1"))
    base = (t["store_sales"]
            .join(t["item"].filter(cls_a | cls_b),
                  [("ss_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .groupBy(group_key, time_key)
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    w = Window.partitionBy(group_key)
    tmp = base.select(group_key, "sum_sales",
                      F.avg("sum_sales").over(w).alias("avg_sales"))
    dev = when(col("avg_sales") > 0,
               F.abs(col("sum_sales") - col("avg_sales"))
               / col("avg_sales")).otherwise(None)
    return tmp.filter(dev > 0.1)


def q53(t):
    return (_manager_monthly_deviation(t, "i_manufact_id", "d_qoy")
            .withColumnRenamed("avg_sales", "avg_quarterly_sales")
            .sort("avg_quarterly_sales", "sum_sales", "i_manufact_id")
            .limit(100))


def q63(t):
    return (_manager_monthly_deviation(t, "i_manager_id", "d_moy")
            .withColumnRenamed("avg_sales", "avg_monthly_sales")
            .sort("i_manager_id", "avg_monthly_sales", "sum_sales")
            .limit(100))


def q69(t):
    dd = (t["date_dim"]
          .filter((col("d_year") == 2001) & (col("d_moy") >= 4)
                  & (col("d_moy") <= 6))
          .select("d_date_sk"))
    bought_store = (t["store_sales"]
                    .join(dd, [("ss_sold_date_sk", "d_date_sk")], "leftsemi")
                    .select(col("ss_customer_sk").alias("b_sk")))
    bought_web = (t["web_sales"]
                  .join(dd, [("ws_sold_date_sk", "d_date_sk")], "leftsemi")
                  .select(col("ws_bill_customer_sk").alias("b_sk")))
    bought_cat = (t["catalog_sales"]
                  .join(dd, [("cs_sold_date_sk", "d_date_sk")], "leftsemi")
                  .select(col("cs_ship_customer_sk").alias("b_sk")))
    return (t["customer"]
            .join(t["customer_address"].filter(
                col("ca_state").isin("TN", "GA", "SD")),
                [("c_current_addr_sk", "ca_address_sk")])
            .join(t["customer_demographics"],
                  [("c_current_cdemo_sk", "cd_demo_sk")])
            .join(bought_store, [("c_customer_sk", "b_sk")], "leftsemi")
            .join(bought_web, [("c_customer_sk", "b_sk")], "leftanti")
            .join(bought_cat, [("c_customer_sk", "b_sk")], "leftanti")
            .groupBy("cd_gender", "cd_marital_status", "cd_education_status",
                     "cd_purchase_estimate", "cd_credit_rating")
            .agg(F.count().alias("cnt1"))
            .select("cd_gender", "cd_marital_status", "cd_education_status",
                    "cnt1", "cd_purchase_estimate",
                    col("cnt1").alias("cnt2"), "cd_credit_rating",
                    col("cnt1").alias("cnt3"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status",
                  "cd_purchase_estimate", "cd_credit_rating")
            .limit(100))


def q76(t):
    def channel(sales, null_col, item_k, date_k, price, name):
        return (sales.filter(col(null_col).isNull())
                .join(t["item"], [(item_k, "i_item_sk")])
                .join(t["date_dim"], [(date_k, "d_date_sk")])
                .select(lit(name).alias("channel"),
                        lit(null_col).alias("col_name"), "d_year", "d_qoy",
                        "i_category", col(price).alias("ext_sales_price")))

    u = (channel(t["store_sales"], "ss_store_sk", "ss_item_sk",
                 "ss_sold_date_sk", "ss_ext_sales_price", "store")
         .union(channel(t["web_sales"], "ws_ship_customer_sk", "ws_item_sk",
                        "ws_sold_date_sk", "ws_ext_sales_price", "web"))
         .union(channel(t["catalog_sales"], "cs_ship_addr_sk", "cs_item_sk",
                        "cs_sold_date_sk", "cs_ext_sales_price", "catalog")))
    return (u.groupBy("channel", "col_name", "d_year", "d_qoy", "i_category")
            .agg(F.count().alias("sales_cnt"),
                 F.sum("ext_sales_price").alias("sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy", "i_category")
            .limit(100))


def q88(t):
    hd = t["household_demographics"].filter(
        ((col("hd_dep_count") == 4) & (col("hd_vehicle_count") <= 6))
        | ((col("hd_dep_count") == 2) & (col("hd_vehicle_count") <= 4))
        | ((col("hd_dep_count") == 0) & (col("hd_vehicle_count") <= 2)))
    store = t["store"].filter(col("s_store_name") == "ese")

    def half_hour(hour, first_half, name):
        td = t["time_dim"].filter(
            (col("t_hour") == hour)
            & ((col("t_minute") < 30) if first_half
               else (col("t_minute") >= 30)))
        return (t["store_sales"]
                .join(td, [("ss_sold_time_sk", "t_time_sk")], "leftsemi")
                .join(hd, [("ss_hdemo_sk", "hd_demo_sk")], "leftsemi")
                .join(store, [("ss_store_sk", "s_store_sk")], "leftsemi")
                .agg(F.count().alias(name)))

    slots = [(8, False, "h8_30_to_9"), (9, True, "h9_to_9_30"),
             (9, False, "h9_30_to_10"), (10, True, "h10_to_10_30"),
             (10, False, "h10_30_to_11"), (11, True, "h11_to_11_30"),
             (11, False, "h11_30_to_12"), (12, True, "h12_to_12_30")]
    out = half_hour(*slots[0])
    for s in slots[1:]:
        out = out.crossJoin(half_hour(*s))
    return out


def q41(t):
    """Manufacturers with qualifying item variants (correlated count(*)>0 as
    a semi-join on i_manufact). Manufact-id window 738..778 -> 38..78 (the
    generator cycles ids over 1..n_item)."""
    combo = lambda cat, colors, units, sizes: (  # noqa: E731
        (col("i_category") == cat) & col("i_color").isin(*colors)
        & col("i_units").isin(*units) & col("i_size").isin(*sizes))
    variants = (combo("Women", ("powder", "khaki"), ("Ounce", "Oz"),
                      ("medium", "extra large"))
                | combo("Women", ("brown", "honeydew"), ("Bunch", "Ton"),
                        ("N/A", "small"))
                | combo("Men", ("floral", "deep"), ("N/A", "Dozen"),
                        ("petite", "large"))
                | combo("Men", ("light", "cornflower"), ("Box", "Pound"),
                        ("medium", "extra large"))
                | combo("Women", ("midnight", "snow"), ("Pallet", "Gross"),
                        ("medium", "extra large"))
                | combo("Women", ("cyan", "papaya"), ("Cup", "Dram"),
                        ("N/A", "small"))
                | combo("Men", ("orange", "frosted"), ("Each", "Tbl"),
                        ("petite", "large"))
                | combo("Men", ("forest", "ghost"), ("Lb", "Bundle"),
                        ("medium", "extra large")))
    qualifying = (t["item"].filter(variants)
                  .select(col("i_manufact").alias("qm")).distinct())
    return (t["item"]
            .filter((col("i_manufact_id") >= 38)
                    & (col("i_manufact_id") <= 78))
            .join(qualifying, [("i_manufact", "qm")], "leftsemi")
            .select("i_product_name").distinct()
            .sort("i_product_name").limit(100))


def q48(t):
    # state triplets adapted to the generator pool
    demo_ok = (((col("cd_marital_status") == "M")
                & (col("cd_education_status") == "4 yr Degree")
                & (col("ss_sales_price") >= 100.0)
                & (col("ss_sales_price") <= 150.0))
               | ((col("cd_marital_status") == "D")
                  & (col("cd_education_status") == "2 yr Degree")
                  & (col("ss_sales_price") >= 50.0)
                  & (col("ss_sales_price") <= 100.0))
               | ((col("cd_marital_status") == "S")
                  & (col("cd_education_status") == "College")
                  & (col("ss_sales_price") >= 150.0)
                  & (col("ss_sales_price") <= 200.0)))
    geo_ok = (((col("ca_country") == "United States")
               & col("ca_state").isin("TX", "OH", "GA")
               & (col("ss_net_profit") >= 0) & (col("ss_net_profit") <= 2000))
              | ((col("ca_country") == "United States")
                 & col("ca_state").isin("TN", "IN", "SD")
                 & (col("ss_net_profit") >= 150)
                 & (col("ss_net_profit") <= 3000))
              | ((col("ca_country") == "United States")
                 & col("ca_state").isin("LA", "MI", "CA")
                 & (col("ss_net_profit") >= 50)
                 & (col("ss_net_profit") <= 25000)))
    return (t["store_sales"]
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .join(t["date_dim"].filter(col("d_year") == 2000),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["customer_demographics"], [("ss_cdemo_sk", "cd_demo_sk")])
            .join(t["customer_address"], [("ss_addr_sk", "ca_address_sk")])
            .filter(demo_ok & geo_ok)
            .agg(F.sum("ss_quantity").alias("sum_quantity")))


def q50(t):
    days = col("sr_returned_date_sk") - col("ss_sold_date_sk")
    bucket = lambda lo, hi: F.sum(  # noqa: E731
        when(((days > lo) if lo is not None else lit(True))
             & ((days <= hi) if hi is not None else lit(True)), 1)
        .otherwise(0))
    return (t["store_sales"]
            .join(t["store_returns"]
                  .join(t["date_dim"].filter((col("d_year") == 2001)
                                             & (col("d_moy") == 8))
                        .select(col("d_date_sk").alias("d2_sk")),
                        [("sr_returned_date_sk", "d2_sk")]),
                  [("ss_ticket_number", "sr_ticket_number"),
                   ("ss_item_sk", "sr_item_sk"),
                   ("ss_customer_sk", "sr_customer_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .groupBy("s_store_name", "s_company_id", "s_street_number",
                     "s_street_name", "s_street_type", "s_suite_number",
                     "s_city", "s_county", "s_state", "s_zip")
            .agg(bucket(None, 30).alias("d30"),
                 bucket(30, 60).alias("d31_60"),
                 bucket(60, 90).alias("d61_90"),
                 bucket(90, 120).alias("d91_120"),
                 bucket(120, None).alias("d_over_120"))
            .sort("s_store_name", "s_company_id", "s_street_number",
                  "s_street_name", "s_street_type", "s_suite_number",
                  "s_city", "s_county", "s_state", "s_zip")
            .limit(100))


def q61(t):
    def slice_sales(with_promo):
        base = (t["store_sales"]
                .join(t["date_dim"].filter((col("d_year") == 1998)
                                           & (col("d_moy") == 11)),
                      [("ss_sold_date_sk", "d_date_sk")])
                .join(t["store"].filter(col("s_gmt_offset") == -5.0),
                      [("ss_store_sk", "s_store_sk")])
                .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
                .join(t["customer_address"]
                      .filter(col("ca_gmt_offset") == -5.0),
                      [("c_current_addr_sk", "ca_address_sk")])
                .join(t["item"].filter(col("i_category") == "Jewelry"),
                      [("ss_item_sk", "i_item_sk")]))
        if with_promo:
            base = base.join(
                t["promotion"].filter((col("p_channel_dmail") == "Y")
                                      | (col("p_channel_email") == "Y")
                                      | (col("p_channel_tv") == "Y")),
                [("ss_promo_sk", "p_promo_sk")])
        name = "promotions" if with_promo else "total"
        return base.agg(F.sum("ss_ext_sales_price").alias(name))

    return (slice_sales(True).crossJoin(slice_sales(False))
            .select("promotions", "total",
                    (col("promotions") / col("total") * 100.0)
                    .alias("promo_pct")))


def q71(t):
    dd = (t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 1999))
          .select("d_date_sk"))

    def channel(sales, price, item_k, date_k, time_k):
        return (sales.join(dd, [(date_k, "d_date_sk")], "leftsemi")
                .select(col(price).alias("ext_price"),
                        col(item_k).alias("sold_item_sk"),
                        col(time_k).alias("time_sk")))

    u = (channel(t["web_sales"], "ws_ext_sales_price", "ws_item_sk",
                 "ws_sold_date_sk", "ws_sold_time_sk")
         .union(channel(t["catalog_sales"], "cs_ext_sales_price",
                        "cs_item_sk", "cs_sold_date_sk", "cs_sold_time_sk"))
         .union(channel(t["store_sales"], "ss_ext_sales_price", "ss_item_sk",
                        "ss_sold_date_sk", "ss_sold_time_sk")))
    return (u.join(t["item"].filter(col("i_manager_id") == 1),
                   [("sold_item_sk", "i_item_sk")])
            .join(t["time_dim"].filter(col("t_meal_time")
                                       .isin("breakfast", "dinner")),
                  [("time_sk", "t_time_sk")])
            .groupBy("i_brand", "i_brand_id", "t_hour", "t_minute")
            .agg(F.sum("ext_price").alias("ext_price"))
            .select(col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), "t_hour", "t_minute",
                    "ext_price")
            .sort(col("ext_price").desc(), "brand_id"))


def q82(t):
    lo = datetime.date(2000, 5, 25)
    hi = lo + datetime.timedelta(days=60)
    # price 62..92 overlaps the generator's planted 68-98 band; manufact list
    # 129/270/821/423 -> the planted ids 8/33/58/83 (like q37)
    items = t["item"].filter(
        (col("i_current_price") >= 62) & (col("i_current_price") <= 92)
        & col("i_manufact_id").isin(8, 33, 58, 83))
    inv = (t["inventory"]
           .filter((col("inv_quantity_on_hand") >= 100)
                   & (col("inv_quantity_on_hand") <= 500))
           .join(t["date_dim"].filter((col("d_date") >= lit(lo))
                                      & (col("d_date") <= lit(hi))),
                 [("inv_date_sk", "d_date_sk")]))
    return (items.join(inv, [("i_item_sk", "inv_item_sk")])
            .join(t["store_sales"], [("i_item_sk", "ss_item_sk")], "leftsemi")
            .select("i_item_id", "i_item_desc", "i_current_price")
            .dropDuplicates()
            .sort("i_item_id").limit(100))


def q87(t):
    dd = (t["date_dim"].filter((col("d_month_seq") >= 1200)
                               & (col("d_month_seq") <= 1211))
          .select("d_date_sk", "d_date"))

    def bought(sales, cust_k, date_k, names=("c_last_name", "c_first_name",
                                             "d_date")):
        return (sales.join(dd, [(date_k, "d_date_sk")])
                .join(t["customer"], [(cust_k, "c_customer_sk")])
                .select(col("c_last_name").alias(names[0]),
                        col("c_first_name").alias(names[1]),
                        col("d_date").alias(names[2])).distinct())

    store = bought(t["store_sales"], "ss_customer_sk", "ss_sold_date_sk")
    catalog = bought(t["catalog_sales"], "cs_bill_customer_sk",
                     "cs_sold_date_sk", ("ln", "fn", "dt"))
    web = bought(t["web_sales"], "ws_bill_customer_sk", "ws_sold_date_sk",
                 ("ln", "fn", "dt"))
    keys = [("c_last_name", "ln"), ("c_first_name", "fn"), ("d_date", "dt")]
    return (store.join(catalog, keys, "leftanti")
            .join(web, keys, "leftanti")
            .agg(F.count().alias("cnt")))


def q97(t):
    dd = (t["date_dim"].filter((col("d_month_seq") >= 1200)
                               & (col("d_month_seq") <= 1211))
          .select("d_date_sk"))
    ssci = (t["store_sales"].join(dd, [("ss_sold_date_sk", "d_date_sk")],
                                  "leftsemi")
            .select(col("ss_customer_sk").alias("s_cust"),
                    col("ss_item_sk").alias("s_item")).distinct())
    csci = (t["catalog_sales"].join(dd, [("cs_sold_date_sk", "d_date_sk")],
                                    "leftsemi")
            .select(col("cs_bill_customer_sk").alias("c_cust"),
                    col("cs_item_sk").alias("c_item")).distinct())
    j = ssci.join(csci, [("s_cust", "c_cust"), ("s_item", "c_item")], "full")
    return j.agg(
        F.sum(when(col("s_item").isNotNull() & col("c_item").isNull(), 1)
              .otherwise(0)).alias("store_only"),
        F.sum(when(col("s_item").isNull() & col("c_item").isNotNull(), 1)
              .otherwise(0)).alias("catalog_only"),
        F.sum(when(col("s_item").isNotNull() & col("c_item").isNotNull(), 1)
              .otherwise(0)).alias("store_and_catalog"))


# QUERIES registry built at end of module (after all additions)


# ---------------------------------------------------------------------------
# round-2 additions: the remaining reference inventory (TpcdsLikeSpark.scala
# q1..q99). Like the first 58, each is the DataFrame translation of the spec
# text with constants adapted to the generator's pools/date range, noted
# inline. The "Like" simplifications mirror the reference's own Like variants
# (dropped literal zip lists, reduced repeated blocks) without changing the
# query's join/aggregation shape.
# ---------------------------------------------------------------------------
def q1(t):
    ctr = (t["store_returns"]
           .join(t["date_dim"].filter(col("d_year") == 2000),
                 [("sr_returned_date_sk", "d_date_sk")])
           .groupBy(col("sr_customer_sk").alias("ctr_customer_sk"),
                    col("sr_store_sk").alias("ctr_store_sk"))
           .agg(F.sum("sr_return_amt").alias("ctr_total_return")))
    avg_ctr = (ctr.groupBy(col("ctr_store_sk").alias("avg_store_sk"))
               .agg(F.avg("ctr_total_return").alias("avg_ret"))
               .select("avg_store_sk", (col("avg_ret") * 1.2).alias("thr")))
    return (ctr.join(avg_ctr, [("ctr_store_sk", "avg_store_sk")])
            .filter(col("ctr_total_return") > col("thr"))
            .join(t["store"].filter(col("s_state") == "TN"),
                  [("ctr_store_sk", "s_store_sk")])
            .join(t["customer"], [("ctr_customer_sk", "c_customer_sk")])
            .select("c_customer_id").sort("c_customer_id").limit(100))


def _weekly_sums(t, sales, date_col, price_col):
    d = t["date_dim"]
    j = sales.join(d, [(date_col, "d_date_sk")])
    day = lambda n: F.sum(when(col("d_day_name") == n, col(price_col))
                          .otherwise(0.0))
    return (j.groupBy("d_week_seq")
            .agg(day("Sunday").alias("sun"), day("Monday").alias("mon"),
                 day("Tuesday").alias("tue"), day("Wednesday").alias("wed"),
                 day("Thursday").alias("thu"), day("Friday").alias("fri"),
                 day("Saturday").alias("sat")))


def q2(t):
    wscs = (_weekly_sums(t, t["web_sales"], "ws_sold_date_sk",
                         "ws_ext_sales_price")
            .union(_weekly_sums(t, t["catalog_sales"], "cs_sold_date_sk",
                                "cs_ext_sales_price"))
            .groupBy("d_week_seq")
            .agg(*[F.sum(c).alias(c) for c in
                   ("sun", "mon", "tue", "wed", "thu", "fri", "sat")]))
    weeks1 = (t["date_dim"].filter(col("d_year") == 1999)
              .select("d_week_seq").distinct())
    weeks2 = (t["date_dim"].filter(col("d_year") == 2000)
              .select(col("d_week_seq").alias("w2")).distinct())
    y = (wscs.join(weeks1, "d_week_seq", "leftsemi")
         .select(col("d_week_seq").alias("wk1"),
                 *[col(c).alias(c + "1")
                   for c in ("sun", "mon", "tue", "wed", "thu", "fri",
                             "sat")]))
    z = (wscs.join(weeks2.withColumnRenamed("w2", "d_week_seq"),
                   "d_week_seq", "leftsemi")
         .select((col("d_week_seq") - 53).alias("wk2"),
                 *[col(c).alias(c + "2")
                   for c in ("sun", "mon", "tue", "wed", "thu", "fri",
                             "sat")]))
    j = y.join(z, [("wk1", "wk2")])
    sel = [col("wk1").alias("d_week_seq")]
    for c in ("sun", "mon", "tue", "wed", "thu", "fri", "sat"):
        sel.append(F.round(when(col(c + "2") != 0,
                                col(c + "1") / col(c + "2"))
                           .otherwise(None), 2).alias("r_" + c))
    return j.select(*sel).sort("d_week_seq")


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


def q11(t):
    ss_amt = col("ss_ext_list_price") - col("ss_ext_discount_amt")
    ws_amt = col("ws_ext_list_price") - col("ws_ext_discount_amt")
    s1 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", ss_amt, 1999, "s1")
    s2 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", ss_amt, 2000, "s2")
    w1 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", ws_amt, 1999, "w1")
    w2 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", ws_amt, 2000, "w2")
    j = (s1.filter(col("s1_total") > 0)
         .join(s2, [("s1_id", "s2_id")])
         .join(w1.filter(col("w1_total") > 0), [("s1_id", "w1_id")])
         .join(w2, [("s1_id", "w2_id")])
         .filter((col("w2_total") / col("w1_total"))
                 > (col("s2_total") / col("s1_total"))))
    return (j.select(col("s1_id").alias("customer_id"),
                     col("s2_flag").alias("customer_preferred_cust_flag"))
            .sort("customer_id").limit(100))


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


def q74(t):
    s1 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", col("ss_net_paid"), 1999, "s1")
    s2 = _year_total(t, t["store_sales"], "ss_customer_sk",
                     "ss_sold_date_sk", col("ss_net_paid"), 2000, "s2")
    w1 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", col("ws_net_paid"), 1999, "w1")
    w2 = _year_total(t, t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", col("ws_net_paid"), 2000, "w2")
    j = (s1.filter(col("s1_total") > 0)
         .join(s2, [("s1_id", "s2_id")])
         .join(w1.filter(col("w1_total") > 0), [("s1_id", "w1_id")])
         .join(w2, [("s1_id", "w2_id")])
         .filter((col("w2_total") / col("w1_total"))
                 > (col("s2_total") / col("s1_total"))))
    return j.select(col("s1_id").alias("customer_id")).sort(
        "customer_id").limit(100)


def _channel_profit(t, sales, returns, date_k, ret_date_k, id_k, ret_id_k,
                    sales_price, sales_profit, ret_amt, ret_loss, id_name,
                    lo, hi):
    d = t["date_dim"].filter((col("d_date") >= lit(lo))
                             & (col("d_date") <= lit(hi)))
    s = (sales.join(d, [(date_k, "d_date_sk")])
         .groupBy(col(id_k).alias(id_name))
         .agg(F.sum(sales_price).alias("sales"),
              F.sum(sales_profit).alias("profit")))
    r = (returns.join(d, [(ret_date_k, "d_date_sk")])
         .groupBy(col(ret_id_k).alias(id_name + "_r"))
         .agg(F.sum(ret_amt).alias("returns_amt"),
              F.sum(ret_loss).alias("net_loss")))
    return (s.join(r, [(id_name, id_name + "_r")], "left")
            .select(col(id_name),
                    col("sales"),
                    F.coalesce(col("returns_amt"), lit(0.0)).alias("returns_amt"),
                    (col("profit") - F.coalesce(col("net_loss"), lit(0.0)))
                    .alias("profit")))


def q5(t):
    lo, hi = datetime.date(2000, 8, 1), datetime.date(2000, 8, 14)
    ssr = _channel_profit(
        t, t["store_sales"], t["store_returns"], "ss_sold_date_sk",
        "sr_returned_date_sk", "ss_store_sk", "sr_store_sk",
        col("ss_ext_sales_price"), col("ss_net_profit"),
        col("sr_return_amt"), col("sr_net_loss"), "sid", lo, hi)
    csr = _channel_profit(
        t, t["catalog_sales"], t["catalog_returns"], "cs_sold_date_sk",
        "cr_returned_date_sk", "cs_catalog_page_sk", "cr_catalog_page_sk",
        col("cs_ext_sales_price"), col("cs_net_profit"),
        col("cr_return_amount"), col("cr_net_loss"), "sid", lo, hi)
    wsr = _channel_profit(
        t, t["web_sales"], t["web_returns"], "ws_sold_date_sk",
        "wr_returned_date_sk", "ws_web_site_sk", "wr_web_page_sk",
        col("ws_ext_sales_price"), col("ws_net_profit"),
        col("wr_return_amt"), col("wr_net_loss"), "sid", lo, hi)
    u = (ssr.withColumn("channel", lit("store channel"))
         .union(csr.withColumn("channel", lit("catalog channel")))
         .union(wsr.withColumn("channel", lit("web channel"))))
    return (u.rollup("channel", "sid")
            .agg(F.sum("sales").alias("sales"),
                 F.sum("returns_amt").alias("returns_amt"),
                 F.sum("profit").alias("profit"))
            .sort("channel", "sid").limit(100))


def q8(t):
    pref_zips = (t["customer"].filter(col("c_preferred_cust_flag") == "Y")
                 .join(t["customer_address"],
                       [("c_current_addr_sk", "ca_address_sk")])
                 .groupBy(F.substring("ca_zip", 1, 5).alias("zip5"))
                 .agg(F.count().alias("cnt"))
                 .filter(col("cnt") > 10)
                 .select("zip5"))
    return (t["store_sales"]
            .join(t["date_dim"].filter((col("d_qoy") == 2)
                                       & (col("d_year") == 1998)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")])
            .withColumn("s_zip5", F.substring("s_zip", 1, 5))
            .join(pref_zips, [("s_zip5", "zip5")], "leftsemi")
            .groupBy("s_store_name")
            .agg(F.sum("ss_net_profit").alias("net_profit"))
            .sort("s_store_name"))


def q9(t):
    ss = t["store_sales"]
    buckets = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    aggs = []
    for i, (lo, hi) in enumerate(buckets, 1):
        in_b = (col("ss_quantity") >= lo) & (col("ss_quantity") <= hi)
        aggs.append(F.sum(when(in_b, 1).otherwise(0)).alias(f"cnt{i}"))
        aggs.append(F.avg(when(in_b, col("ss_ext_discount_amt"))
                          .otherwise(None)).alias(f"disc{i}"))
        aggs.append(F.avg(when(in_b, col("ss_net_paid"))
                          .otherwise(None)).alias(f"paid{i}"))
    stats = ss.agg(*aggs)
    sel = []
    for i in range(1, 6):
        sel.append(when(col(f"cnt{i}") > 62316685 / 1000,
                        col(f"disc{i}")).otherwise(col(f"paid{i}"))
                   .alias(f"bucket{i}"))
    return (t["reason"].filter(col("r_reason_sk") == 1)
            .select("r_reason_sk").crossJoin(stats).select(*sel))


def q10(t):
    dd = (t["date_dim"].filter((col("d_year") == 2002)
                               & (col("d_moy") >= 1) & (col("d_moy") <= 4))
          .select("d_date_sk"))
    ss_c = (t["store_sales"].join(dd, [("ss_sold_date_sk", "d_date_sk")],
                                  "leftsemi")
            .select(col("ss_customer_sk").alias("k")).distinct())
    ws_c = (t["web_sales"].join(dd, [("ws_sold_date_sk", "d_date_sk")],
                                "leftsemi")
            .select(col("ws_bill_customer_sk").alias("k")).distinct())
    cs_c = (t["catalog_sales"].join(dd, [("cs_sold_date_sk", "d_date_sk")],
                                    "leftsemi")
            .select(col("cs_bill_customer_sk").alias("k")).distinct())
    other = ws_c.union(cs_c).distinct()
    cust = (t["customer"]
            .join(t["customer_address"].filter(
                col("ca_county").isin("Williamson County", "Walker County",
                                      "Ziebach County")),
                [("c_current_addr_sk", "ca_address_sk")])
            .join(ss_c, [("c_customer_sk", "k")], "leftsemi")
            .join(other, [("c_customer_sk", "k")], "leftsemi"))
    return (cust.join(t["customer_demographics"],
                      [("c_current_cdemo_sk", "cd_demo_sk")])
            .groupBy("cd_gender", "cd_marital_status", "cd_education_status",
                     "cd_purchase_estimate", "cd_credit_rating")
            .agg(F.count().alias("cnt"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status",
                  "cd_purchase_estimate", "cd_credit_rating"))


def q12(t):
    # q98's shape over the web channel (reference stringizes the same text)
    base = (t["web_sales"]
            .join(t["item"].filter(col("i_category").isin(
                "Sports", "Books", "Home")), [("ws_item_sk", "i_item_sk")])
            .join(t["date_dim"].filter(
                (col("d_date") >= lit(datetime.date(1999, 2, 22)))
                & (col("d_date") <= lit(datetime.date(1999, 3, 24)))),
                [("ws_sold_date_sk", "d_date_sk")])
            .groupBy("i_item_id", "i_item_desc", "i_category", "i_class",
                     "i_current_price")
            .agg(F.sum("ws_ext_sales_price").alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (base.select("i_item_id", "i_item_desc", "i_category", "i_class",
                        "i_current_price", "itemrevenue",
                        (col("itemrevenue") * 100.0
                         / F.sum("itemrevenue").over(w)).alias("revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio")
            .limit(100))


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




def q22(t):
    return (t["inventory"]
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [("inv_date_sk", "d_date_sk")])
            .join(t["item"], [("inv_item_sk", "i_item_sk")])
            .rollup("i_product_name", "i_brand", "i_class", "i_category")
            .agg(F.avg("inv_quantity_on_hand").alias("qoh"))
            .sort("qoh", "i_product_name", "i_brand", "i_class",
                  "i_category")
            .limit(100))


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


def q24(t):
    ssales = (t["store_sales"]
              .join(t["store_returns"], [("ss_ticket_number",
                                          "sr_ticket_number"),
                                         ("ss_item_sk", "sr_item_sk")])
              .join(t["store"], [("ss_store_sk", "s_store_sk")])
              .join(t["item"], [("ss_item_sk", "i_item_sk")])
              .join(t["customer"], [("ss_customer_sk", "c_customer_sk")])
              .groupBy("c_last_name", "c_first_name", "s_store_name",
                       "i_color")
              .agg(F.sum("ss_net_paid").alias("netpaid")))
    avg_np = (ssales.agg(F.avg("netpaid").alias("avg_np"))
              .select((col("avg_np") * 0.05).alias("thr")))
    return (ssales.filter(col("i_color") == "blue")
            .crossJoin(avg_np)
            .filter(col("netpaid") > col("thr"))
            .select("c_last_name", "c_first_name", "s_store_name", "netpaid")
            .sort("c_last_name", "c_first_name", "s_store_name"))


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


def q30(t):
    ctr = (t["web_returns"]
           .join(t["date_dim"].filter(col("d_year") == 2000),
                 [("wr_returned_date_sk", "d_date_sk")])
           .join(t["customer"].select("c_customer_sk", "c_current_addr_sk"),
                 [("wr_returning_customer_sk", "c_customer_sk")])
           .join(t["customer_address"],
                 [("c_current_addr_sk", "ca_address_sk")])
           .groupBy(col("wr_returning_customer_sk").alias("ctr_cust"),
                    col("ca_state").alias("ctr_state"))
           .agg(F.sum("wr_return_amt").alias("ctr_total")))
    avg_ctr = (ctr.groupBy(col("ctr_state").alias("avg_state"))
               .agg(F.avg("ctr_total").alias("avg_ret"))
               .select("avg_state", (col("avg_ret") * 1.2).alias("thr")))
    return (ctr.join(avg_ctr, [("ctr_state", "avg_state")])
            .filter(col("ctr_total") > col("thr"))
            .join(t["customer"], [("ctr_cust", "c_customer_sk")])
            .join(t["customer_address"].filter(col("ca_state") == "GA")
                  .select(col("ca_address_sk").alias("home_addr")),
                  [("c_current_addr_sk", "home_addr")], "leftsemi")
            .select("c_customer_id", "c_salutation", "c_first_name",
                    "c_last_name", "ctr_total")
            .sort("c_customer_id", "c_salutation", "c_first_name",
                  "c_last_name", "ctr_total"))


def q31(t):
    def county_q(sales, date_k, addr_k, price, year, q, tag):
        return (sales
                .join(t["date_dim"].filter((col("d_year") == year)
                                           & (col("d_qoy") == q)),
                      [(date_k, "d_date_sk")])
                .join(t["customer_address"], [(addr_k, "ca_address_sk")])
                .groupBy(col("ca_county").alias(f"{tag}_county"))
                .agg(F.sum(price).alias(f"{tag}_sales")))
    ss1 = county_q(t["store_sales"], "ss_sold_date_sk", "ss_addr_sk",
                   col("ss_ext_sales_price"), 2000, 1, "ss1")
    ss2 = county_q(t["store_sales"], "ss_sold_date_sk", "ss_addr_sk",
                   col("ss_ext_sales_price"), 2000, 2, "ss2")
    ws1 = county_q(t["web_sales"], "ws_sold_date_sk", "ws_bill_addr_sk",
                   col("ws_ext_sales_price"), 2000, 1, "ws1")
    ws2 = county_q(t["web_sales"], "ws_sold_date_sk", "ws_bill_addr_sk",
                   col("ws_ext_sales_price"), 2000, 2, "ws2")
    j = (ss1.join(ss2, [("ss1_county", "ss2_county")])
         .join(ws1, [("ss1_county", "ws1_county")])
         .join(ws2, [("ss1_county", "ws2_county")])
         .filter((col("ws1_sales") > 0) & (col("ss1_sales") > 0))
         .filter((col("ws2_sales") / col("ws1_sales"))
                 > (col("ss2_sales") / col("ss1_sales"))))
    return (j.select(col("ss1_county").alias("county"),
                     (col("ws2_sales") / col("ws1_sales")).alias("web_g"),
                     (col("ss2_sales") / col("ss1_sales")).alias("store_g"))
            .sort("county"))


def q35(t):
    dd = (t["date_dim"].filter((col("d_year") == 2002) & (col("d_qoy") < 4))
          .select("d_date_sk"))
    ss_c = (t["store_sales"].join(dd, [("ss_sold_date_sk", "d_date_sk")],
                                  "leftsemi")
            .select(col("ss_customer_sk").alias("k")).distinct())
    ws_c = (t["web_sales"].join(dd, [("ws_sold_date_sk", "d_date_sk")],
                                "leftsemi")
            .select(col("ws_bill_customer_sk").alias("k")).distinct())
    cs_c = (t["catalog_sales"].join(dd, [("cs_sold_date_sk", "d_date_sk")],
                                    "leftsemi")
            .select(col("cs_bill_customer_sk").alias("k")).distinct())
    other = ws_c.union(cs_c).distinct()
    cust = (t["customer"]
            .join(ss_c, [("c_customer_sk", "k")], "leftsemi")
            .join(other, [("c_customer_sk", "k")], "leftsemi")
            .join(t["customer_address"],
                  [("c_current_addr_sk", "ca_address_sk")])
            .join(t["customer_demographics"],
                  [("c_current_cdemo_sk", "cd_demo_sk")]))
    return (cust.groupBy("ca_state", "cd_gender", "cd_marital_status",
                         "cd_dep_count")
            .agg(F.count().alias("cnt"),
                 F.min("cd_dep_count").alias("mn"),
                 F.max("cd_dep_count").alias("mx"),
                 F.avg("cd_dep_count").alias("av"))
            .sort("ca_state", "cd_gender", "cd_marital_status",
                  "cd_dep_count")
            .limit(100))


def q38(t):
    dd = (t["date_dim"].filter((col("d_month_seq") >= 1200)
                               & (col("d_month_seq") <= 1211))
          .select("d_date_sk"))

    def custs(sales, date_k, cust_k):
        return (sales.join(dd, [(date_k, "d_date_sk")], "leftsemi")
                .join(t["customer"], [(cust_k, "c_customer_sk")])
                .select("c_last_name", "c_first_name").distinct())
    s = custs(t["store_sales"], "ss_sold_date_sk", "ss_customer_sk")
    c = custs(t["catalog_sales"], "cs_sold_date_sk", "cs_bill_customer_sk")
    w = custs(t["web_sales"], "ws_sold_date_sk", "ws_bill_customer_sk")
    keys = [("c_last_name", "c_last_name"), ("c_first_name", "c_first_name")]
    return (s.join(c, keys, "leftsemi").join(w, keys, "leftsemi")
            .agg(F.count().alias("cnt")))


def q39(t):
    inv = (t["inventory"]
           .join(t["date_dim"].filter((col("d_year") == 2001)
                                      & col("d_moy").isin(1, 2)),
                 [("inv_date_sk", "d_date_sk")])
           .join(t["item"], [("inv_item_sk", "i_item_sk")])
           .join(t["warehouse"], [("inv_warehouse_sk", "w_warehouse_sk")])
           .groupBy("w_warehouse_sk", "i_item_sk", "d_moy")
           .agg(F.stddev("inv_quantity_on_hand").alias("stdev"),
                F.avg("inv_quantity_on_hand").alias("mean")))
    inv = (inv.filter(col("mean") != 0)
           .withColumn("cov", col("stdev") / col("mean"))
           .filter(col("cov") > 1.0))
    a = inv.filter(col("d_moy") == 1).select(
        col("w_warehouse_sk").alias("w1"), col("i_item_sk").alias("i1"),
        col("mean").alias("mean1"), col("cov").alias("cov1"))
    b = inv.filter(col("d_moy") == 2).select(
        col("w_warehouse_sk").alias("w2"), col("i_item_sk").alias("i2"),
        col("mean").alias("mean2"), col("cov").alias("cov2"))
    return (a.join(b, [("w1", "w2"), ("i1", "i2")])
            .select("w1", "i1", "mean1", "cov1", "mean2", "cov2")
            .sort("w1", "i1"))


def q49(t):
    def channel(sales, returns, qty, amt, skeys, rkeys, item_k, tag):
        s = (sales
             .join(t["date_dim"].filter((col("d_year") == 2000)
                                        & (col("d_moy") == 12)),
                   [(skeys, "d_date_sk")])
             .filter(col(amt) > 0))
        j = s.join(returns, rkeys, "left")
        g = (j.groupBy(col(item_k).alias("item"))
             .agg(F.sum(F.coalesce(col(tag + "_return_quantity"),
                                   lit(0)).cast("long")).alias("ret_q"),
                  F.sum(col(qty)).alias("sale_q"),
                  F.sum(F.coalesce(col(tag + ("_return_amt" if tag != "cr"
                                              else "_return_amount")),
                                   lit(0.0))).alias("ret_a"),
                  F.sum(col(amt)).alias("sale_a")))
        g = (g.filter(col("sale_q") > 0)
             .withColumn("return_ratio",
                         col("ret_q").cast("double") / col("sale_q"))
             .withColumn("currency_ratio", col("ret_a") / col("sale_a")))
        wr_ = Window.orderBy("return_ratio")
        wc_ = Window.orderBy("currency_ratio")
        g = g.select("item", "return_ratio", "currency_ratio",
                     F.rank().over(wr_).alias("return_rank"),
                     F.rank().over(wc_).alias("currency_rank"))
        return (g.filter((col("return_rank") <= 10)
                         | (col("currency_rank") <= 10))
                .withColumn("channel", lit(tag)))
    web = channel(t["web_sales"], t["web_returns"], "ws_quantity",
                  "ws_net_paid", "ws_sold_date_sk",
                  [("ws_order_number", "wr_order_number"),
                   ("ws_item_sk", "wr_item_sk")], "ws_item_sk", "wr")
    cat = channel(t["catalog_sales"], t["catalog_returns"], "cs_quantity",
                  "cs_net_paid", "cs_sold_date_sk",
                  [("cs_order_number", "cr_order_number"),
                   ("cs_item_sk", "cr_item_sk")], "cs_item_sk", "cr")
    st = channel(t["store_sales"], t["store_returns"], "ss_quantity",
                 "ss_net_paid", "ss_sold_date_sk",
                 [("ss_ticket_number", "sr_ticket_number"),
                  ("ss_item_sk", "sr_item_sk")], "ss_item_sk", "sr")
    cols = ["channel", "item", "return_ratio", "return_rank",
            "currency_rank"]
    return (web.select(*cols).union(cat.select(*cols)).union(st.select(*cols))
            .sort("channel", "return_rank", "currency_rank", "item")
            .limit(100))


def q51(t):
    dd = t["date_dim"].filter((col("d_month_seq") >= 1200)
                              & (col("d_month_seq") <= 1211))
    wss = (t["web_sales"].join(dd, [("ws_sold_date_sk", "d_date_sk")])
           .groupBy(col("ws_item_sk").alias("item_sk"), "d_date")
           .agg(F.sum("ws_sales_price").alias("daily")))
    sss = (t["store_sales"].join(dd, [("ss_sold_date_sk", "d_date_sk")])
           .groupBy(col("ss_item_sk").alias("item_sk"), "d_date")
           .agg(F.sum("ss_sales_price").alias("daily")))
    wcum = Window.partitionBy("item_sk").orderBy("d_date") \
        .rowsBetween(Window.unboundedPreceding, Window.currentRow)
    web = wss.select("item_sk", "d_date",
                     F.sum("daily").over(wcum).alias("web_cum"))
    store = sss.select(col("item_sk").alias("s_item"),
                       col("d_date").alias("s_date"),
                       F.sum("daily").over(wcum).alias("store_cum"))
    j = (web.join(store, [("item_sk", "s_item"), ("d_date", "s_date")])
         .filter(col("web_cum") > col("store_cum")))
    return (j.select("item_sk", "d_date", "web_cum", "store_cum")
            .sort("item_sk", "d_date").limit(100))


def q54(t):
    dd = t["date_dim"].filter((col("d_year") == 1999) & (col("d_moy") == 5))
    my_customers = (t["catalog_sales"]
                    .select(col("cs_sold_date_sk").alias("sold"),
                            col("cs_item_sk").alias("item"),
                            col("cs_bill_customer_sk").alias("cust"))
                    .union(t["web_sales"].select(
                        col("ws_sold_date_sk").alias("sold"),
                        col("ws_item_sk").alias("item"),
                        col("ws_bill_customer_sk").alias("cust")))
                    .join(dd, [("sold", "d_date_sk")], "leftsemi")
                    .join(t["item"].filter(
                        (col("i_category") == "Women")
                        & (col("i_class") == "dresses")),
                        [("item", "i_item_sk")], "leftsemi")
                    .select("cust").distinct())
    dd2 = t["date_dim"].filter((col("d_year") == 1999)
                               & col("d_moy").isin(6, 7, 8))
    rev = (t["store_sales"]
           .join(my_customers, [("ss_customer_sk", "cust")], "leftsemi")
           .join(dd2, [("ss_sold_date_sk", "d_date_sk")], "leftsemi")
           .groupBy(col("ss_customer_sk").alias("c"))
           .agg(F.sum("ss_ext_sales_price").alias("revenue")))
    seg = rev.select(F.floor(col("revenue") / 50).cast("int")
                     .alias("segment"))
    return (seg.groupBy("segment").agg(F.count().alias("num_customers"))
            .withColumn("segment_base", col("segment") * 50)
            .sort("segment", "num_customers").limit(100))




def _sales_by_item_channel(t, sales, item_k, date_k, price, months, year,
                           cat_filter):
    return (sales
            .join(t["date_dim"].filter((col("d_year") == year)
                                       & col("d_moy").isin(*months)),
                  [(date_k, "d_date_sk")])
            .join(t["item"].join(cat_filter, [("i_item_id", "f_item_id")],
                                 "leftsemi"),
                  [(item_k, "i_item_sk")])
            .groupBy("i_item_id")
            .agg(F.sum(price).alias("total_sales")))


def q56(t):
    # q33/q60 family: items in given colors, summed across the 3 channels
    ids = (t["item"].filter(col("i_color").isin("blue", "cyan", "green"))
           .select(col("i_item_id").alias("f_item_id")).distinct())
    s = _sales_by_item_channel(t, t["store_sales"], "ss_item_sk",
                               "ss_sold_date_sk", col("ss_ext_sales_price"),
                               (2,), 2001, ids)
    c = _sales_by_item_channel(t, t["catalog_sales"], "cs_item_sk",
                               "cs_sold_date_sk", col("cs_ext_sales_price"),
                               (2,), 2001, ids)
    w = _sales_by_item_channel(t, t["web_sales"], "ws_item_sk",
                               "ws_sold_date_sk", col("ws_ext_sales_price"),
                               (2,), 2001, ids)
    return (s.union(c).union(w)
            .groupBy("i_item_id")
            .agg(F.sum("total_sales").alias("total_sales"))
            .sort("total_sales", "i_item_id").limit(100))


def q57(t):
    # q47's deviation-from-average shape over the catalog channel
    v1 = (t["catalog_sales"]
          .join(t["item"], [("cs_item_sk", "i_item_sk")])
          .join(t["date_dim"].filter(
              (col("d_year") == 1999)
              | ((col("d_year") == 1998) & (col("d_moy") == 12))
              | ((col("d_year") == 2000) & (col("d_moy") == 1))),
              [("cs_sold_date_sk", "d_date_sk")])
          .join(t["call_center"], [("cs_call_center_sk", "cc_call_center_sk")])
          .groupBy("i_category", "i_brand", "cc_name", "d_year", "d_moy")
          .agg(F.sum("cs_sales_price").alias("sum_sales")))
    wavg = Window.partitionBy("i_category", "i_brand", "cc_name", "d_year")
    wrank = Window.partitionBy("i_category", "i_brand", "cc_name") \
        .orderBy("d_year", "d_moy")
    v1 = v1.select("i_category", "i_brand", "cc_name", "d_year", "d_moy",
                   "sum_sales",
                   F.avg("sum_sales").over(wavg).alias("avg_monthly_sales"),
                   F.rank().over(wrank).alias("rn"))
    prev = v1.select(col("i_category").alias("pc"), col("i_brand").alias("pb"),
                     col("cc_name").alias("pn"), col("rn").alias("prn"),
                     col("sum_sales").alias("psum"))
    nxt = v1.select(col("i_category").alias("nc"), col("i_brand").alias("nb"),
                    col("cc_name").alias("nn"), col("rn").alias("nrn"),
                    col("sum_sales").alias("nsum"))
    v2 = (v1.withColumn("rp", col("rn") - 1).withColumn("rx", col("rn") + 1)
          .join(prev, [("i_category", "pc"), ("i_brand", "pb"),
                       ("cc_name", "pn"), ("rp", "prn")])
          .join(nxt, [("i_category", "nc"), ("i_brand", "nb"),
                      ("cc_name", "nn"), ("rx", "nrn")]))
    dev = when(col("avg_monthly_sales") > 0,
               F.abs(col("sum_sales") - col("avg_monthly_sales"))
               / col("avg_monthly_sales")).otherwise(None)
    return (v2.filter((col("d_year") == 1999)
                      & (col("avg_monthly_sales") > 0)
                      & (dev > 0.1))
            .select("i_category", "i_brand", "cc_name", "d_year", "d_moy",
                    "avg_monthly_sales", "sum_sales", "psum", "nsum")
            .sort((col("sum_sales") - col("avg_monthly_sales")).asc(),
                  "cc_name")
            .limit(100))


def q58(t):
    week = (t["date_dim"].filter(col("d_date")
                                 == lit(datetime.date(2000, 1, 3)))
            .select(col("d_week_seq").alias("wseq")))
    dates = (t["date_dim"].join(week, [("d_week_seq", "wseq")], "leftsemi")
             .select("d_date_sk"))

    def rev(sales, item_k, date_k, price, tag):
        return (sales.join(dates, [(date_k, "d_date_sk")], "leftsemi")
                .join(t["item"], [(item_k, "i_item_sk")])
                .groupBy(col("i_item_id").alias(f"{tag}_item_id"))
                .agg(F.sum(price).alias(f"{tag}_rev")))
    ss = rev(t["store_sales"], "ss_item_sk", "ss_sold_date_sk",
             col("ss_ext_sales_price"), "ss")
    cs = rev(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk",
             col("cs_ext_sales_price"), "cs")
    ws = rev(t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
             col("ws_ext_sales_price"), "ws")
    j = (ss.join(cs, [("ss_item_id", "cs_item_id")])
         .join(ws, [("ss_item_id", "ws_item_id")]))
    between = lambda a, b: (col(a) >= 0.9 * col(b)) & (col(a) <= 1.1 * col(b))
    return (j.filter(between("ss_rev", "cs_rev") & between("ss_rev", "ws_rev")
                     & between("cs_rev", "ss_rev") & between("cs_rev", "ws_rev")
                     & between("ws_rev", "ss_rev") & between("ws_rev", "cs_rev"))
            .select(col("ss_item_id").alias("item_id"), "ss_rev", "cs_rev",
                    "ws_rev")
            .sort("item_id", "ss_rev").limit(100))


def q64(t):
    # cross_sales ("Like" reduction keeping the shape: store sales paired
    # with returns, catalog refund exclusion, two-year self-join)
    cs_ui = (t["catalog_sales"]
             .join(t["catalog_returns"],
                   [("cs_item_sk", "cr_item_sk"),
                    ("cs_order_number", "cr_order_number")])
             .groupBy(col("cs_item_sk").alias("ui_item"))
             .agg(F.sum(col("cs_ext_list_price")).alias("sale"),
                  F.sum(col("cr_refunded_cash") + col("cr_fee"))
                  .alias("refund"))
             .filter(col("sale") > 2 * col("refund"))
             .select("ui_item"))

    def cross_sales(year, tag):
        return (t["store_sales"]
                .join(t["store_returns"],
                      [("ss_item_sk", "sr_item_sk"),
                       ("ss_ticket_number", "sr_ticket_number")])
                .join(cs_ui, [("ss_item_sk", "ui_item")], "leftsemi")
                .join(t["date_dim"].filter(col("d_year") == year),
                      [("ss_sold_date_sk", "d_date_sk")])
                .join(t["store"], [("ss_store_sk", "s_store_sk")])
                .join(t["item"].filter(col("i_current_price").isNotNull()),
                      [("ss_item_sk", "i_item_sk")])
                .groupBy(col("i_product_name").alias(f"{tag}_pn"),
                         col("s_store_name").alias(f"{tag}_sn"),
                         col("s_zip").alias(f"{tag}_zip"))
                .agg(F.count().alias(f"{tag}_cnt"),
                     F.sum("ss_wholesale_cost").alias(f"{tag}_s1"),
                     F.sum("ss_list_price").alias(f"{tag}_s2"),
                     F.sum("ss_coupon_amt").alias(f"{tag}_s3")))
    y1 = cross_sales(1999, "y1")
    y2 = cross_sales(2000, "y2")
    return (y1.join(y2, [("y1_pn", "y2_pn"), ("y1_sn", "y2_sn"),
                         ("y1_zip", "y2_zip")])
            .filter(col("y2_cnt") <= col("y1_cnt"))
            .select("y1_pn", "y1_sn", "y1_zip", "y1_s1", "y1_s2", "y1_s3",
                    "y2_s1", "y2_s2", "y2_s3", "y2_cnt", "y1_cnt")
            .sort("y1_pn", "y1_sn", "y2_cnt").limit(100))


def q66(t):
    sm = t["ship_mode"].filter(col("sm_carrier").isin("DHL", "BARIAN"))

    def channel(sales, date_k, time_k, sm_k, wh_k, qty, price, tag):
        j = (sales
             .join(t["date_dim"].filter(col("d_year") == 2001),
                   [(date_k, "d_date_sk")])
             .join(t["time_dim"].filter((col("t_hour") >= 8)
                                        & (col("t_hour") <= 17)),
                   [(time_k, "t_time_sk")])
             .join(sm, [(sm_k, "sm_ship_mode_sk")], "leftsemi")
             .join(t["warehouse"], [(wh_k, "w_warehouse_sk")]))
        aggs = [F.sum(when(col("d_moy") == m, col(price) * col(qty))
                      .otherwise(0.0)).alias(f"{tag}_m{m}")
                for m in range(1, 13)]
        return (j.groupBy("w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                          "w_county", "w_state", "w_country")
                .agg(*aggs))
    ws = channel(t["web_sales"], "ws_sold_date_sk", "ws_sold_time_sk",
                 "ws_ship_mode_sk", "ws_warehouse_sk", "ws_quantity",
                 "ws_ext_sales_price", "m")
    cs = channel(t["catalog_sales"], "cs_sold_date_sk", "cs_sold_time_sk",
                 "cs_ship_mode_sk", "cs_warehouse_sk", "cs_quantity",
                 "cs_ext_sales_price", "m")
    month_cols = [f"m_m{m}" for m in range(1, 13)]
    return (ws.union(cs)
            .groupBy("w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                     "w_county", "w_state", "w_country")
            .agg(*[F.sum(c).alias(c) for c in month_cols])
            .sort("w_warehouse_name").limit(100))


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


def q70(t):
    base = (t["store_sales"]
            .join(t["date_dim"].filter((col("d_month_seq") >= 1200)
                                       & (col("d_month_seq") <= 1211)),
                  [("ss_sold_date_sk", "d_date_sk")])
            .join(t["store"], [("ss_store_sk", "s_store_sk")]))
    state_rank = (base.groupBy(col("s_state").alias("rank_state"))
                  .agg(F.sum("ss_net_profit").alias("sp")))
    wr = Window.orderBy(col("sp").desc())
    top_states = (state_rank.select("rank_state",
                                    F.rank().over(wr).alias("rnk"))
                  .filter(col("rnk") <= 5).select("rank_state"))
    return (base.join(top_states, [("s_state", "rank_state")], "leftsemi")
            .rollup("s_state", "s_county")
            .agg(F.sum("ss_net_profit").alias("total_sum"))
            .sort(col("total_sum").desc(), "s_state", "s_county")
            .limit(100))


def q72(t):
    return (t["catalog_sales"]
            .join(t["inventory"], [("cs_item_sk", "inv_item_sk")])
            .join(t["warehouse"], [("inv_warehouse_sk", "w_warehouse_sk")])
            .join(t["item"], [("cs_item_sk", "i_item_sk")])
            .join(t["customer_demographics"].filter(
                col("cd_marital_status") == "D"),
                [("cs_bill_cdemo_sk", "cd_demo_sk")])
            .join(t["household_demographics"].filter(
                col("hd_buy_potential") == ">10000"),
                [("cs_bill_hdemo_sk", "hd_demo_sk")])
            .join(t["date_dim"].filter(col("d_year") == 1999)
                  .select(col("d_date_sk").alias("sold_sk"),
                          col("d_week_seq").alias("sold_week")),
                  [("cs_sold_date_sk", "sold_sk")])
            .filter(col("inv_quantity_on_hand") < col("cs_quantity"))
            .groupBy("i_item_desc", "w_warehouse_name", "sold_week")
            .agg(F.count().alias("no_promo"))
            .sort(col("no_promo").desc(), "i_item_desc", "w_warehouse_name",
                  "sold_week")
            .limit(100))


def q75(t):
    def sales_yr(sales, item_k, date_k, qty, amt, ret, ret_keys, rq, ra):
        s = (sales
             .join(t["date_dim"].filter(col("d_year").isin(1999, 2000)),
                   [(date_k, "d_date_sk")])
             .join(t["item"].filter(col("i_category") == "Books"),
                   [(item_k, "i_item_sk")])
             .join(ret, ret_keys, "left"))
        return (s.groupBy("d_year", "i_brand_id", "i_category_id")
                .agg(F.sum(col(qty)).alias("_q"),
                     F.sum(F.coalesce(col(rq), lit(0)).cast("long"))
                     .alias("_rq"),
                     F.sum(col(amt)).alias("_a"),
                     F.sum(F.coalesce(col(ra), lit(0.0))).alias("_ra"))
                .select("d_year", "i_brand_id", "i_category_id",
                        (col("_q") - col("_rq")).alias("sales_cnt"),
                        (col("_a") - col("_ra")).alias("sales_amt")))
    ss = sales_yr(t["store_sales"], "ss_item_sk", "ss_sold_date_sk",
                  "ss_quantity", "ss_ext_sales_price", t["store_returns"],
                  [("ss_ticket_number", "sr_ticket_number"),
                   ("ss_item_sk", "sr_item_sk")],
                  "sr_return_quantity", "sr_return_amt")
    cs = sales_yr(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk",
                  "cs_quantity", "cs_ext_sales_price", t["catalog_returns"],
                  [("cs_order_number", "cr_order_number"),
                   ("cs_item_sk", "cr_item_sk")],
                  "cr_return_quantity", "cr_return_amount")
    ws = sales_yr(t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                  "ws_quantity", "ws_ext_sales_price", t["web_returns"],
                  [("ws_order_number", "wr_order_number"),
                   ("ws_item_sk", "wr_item_sk")],
                  "wr_return_quantity", "wr_return_amt")
    all_y = (ss.union(cs).union(ws)
             .groupBy("d_year", "i_brand_id", "i_category_id")
             .agg(F.sum("sales_cnt").alias("sales_cnt"),
                  F.sum("sales_amt").alias("sales_amt")))
    prev = all_y.filter(col("d_year") == 1999).select(
        col("i_brand_id").alias("pb"), col("i_category_id").alias("pg"),
        col("sales_cnt").alias("prev_cnt"), col("sales_amt").alias("prev_amt"))
    curr = all_y.filter(col("d_year") == 2000)
    return (curr.join(prev, [("i_brand_id", "pb"), ("i_category_id", "pg")])
            .filter((col("prev_cnt") > 0)
                    & (col("sales_cnt").cast("double")
                       / col("prev_cnt") < 0.9))
            .select("i_brand_id", "i_category_id", "prev_cnt",
                    col("sales_cnt").alias("curr_cnt"),
                    (col("sales_cnt") - col("prev_cnt")).alias("delta_cnt"),
                    (col("sales_amt") - col("prev_amt")).alias("delta_amt"))
            .sort("delta_cnt", "i_brand_id", "i_category_id")
            .limit(100))


def q77(t):
    lo, hi = datetime.date(2000, 8, 1), datetime.date(2000, 8, 30)
    ssr = _channel_profit(
        t, t["store_sales"], t["store_returns"], "ss_sold_date_sk",
        "sr_returned_date_sk", "ss_store_sk", "sr_store_sk",
        col("ss_ext_sales_price"), col("ss_net_profit"),
        col("sr_return_amt"), col("sr_net_loss"), "sid", lo, hi)
    csr = _channel_profit(
        t, t["catalog_sales"], t["catalog_returns"], "cs_sold_date_sk",
        "cr_returned_date_sk", "cs_call_center_sk", "cr_call_center_sk",
        col("cs_ext_sales_price"), col("cs_net_profit"),
        col("cr_return_amount"), col("cr_net_loss"), "sid", lo, hi)
    wsr = _channel_profit(
        t, t["web_sales"], t["web_returns"], "ws_sold_date_sk",
        "wr_returned_date_sk", "ws_web_page_sk", "wr_web_page_sk",
        col("ws_ext_sales_price"), col("ws_net_profit"),
        col("wr_return_amt"), col("wr_net_loss"), "sid", lo, hi)
    u = (ssr.withColumn("channel", lit("store channel"))
         .union(csr.withColumn("channel", lit("catalog channel")))
         .union(wsr.withColumn("channel", lit("web channel"))))
    return (u.rollup("channel", "sid")
            .agg(F.sum("sales").alias("sales"),
                 F.sum("returns_amt").alias("returns_amt"),
                 F.sum("profit").alias("profit"))
            .sort("channel", "sid").limit(100))


def q78(t):
    def channel(sales, ret, skeys, item_k, cust_k, date_k, qty, wc, sp, tag):
        no_ret = sales.join(ret, skeys, "leftanti")
        return (no_ret
                .join(t["date_dim"].filter(col("d_year") == 2000),
                      [(date_k, "d_date_sk")])
                .groupBy(col(item_k).alias(f"{tag}_item"),
                         col(cust_k).alias(f"{tag}_cust"))
                .agg(F.sum(col(qty)).alias(f"{tag}_qty"),
                     F.sum(col(wc)).alias(f"{tag}_wc"),
                     F.sum(col(sp)).alias(f"{tag}_sp")))
    ss = channel(t["store_sales"], t["store_returns"],
                 [("ss_ticket_number", "sr_ticket_number"),
                  ("ss_item_sk", "sr_item_sk")],
                 "ss_item_sk", "ss_customer_sk", "ss_sold_date_sk",
                 "ss_quantity", "ss_wholesale_cost", "ss_sales_price", "ss")
    ws = channel(t["web_sales"], t["web_returns"],
                 [("ws_order_number", "wr_order_number"),
                  ("ws_item_sk", "wr_item_sk")],
                 "ws_item_sk", "ws_bill_customer_sk", "ws_sold_date_sk",
                 "ws_quantity", "ws_wholesale_cost", "ws_sales_price", "ws")
    cs = channel(t["catalog_sales"], t["catalog_returns"],
                 [("cs_order_number", "cr_order_number"),
                  ("cs_item_sk", "cr_item_sk")],
                 "cs_item_sk", "cs_bill_customer_sk", "cs_sold_date_sk",
                 "cs_quantity", "cs_wholesale_cost", "cs_sales_price", "cs")
    j = (ss.join(ws, [("ss_item", "ws_item"), ("ss_cust", "ws_cust")])
         .join(cs, [("ss_item", "cs_item"), ("ss_cust", "cs_cust")]))
    ratio = F.round(col("ss_qty").cast("double")
                    / (col("ws_qty") + col("cs_qty")), 2)
    return (j.filter((col("ws_qty") > 0) | (col("cs_qty") > 0))
            .select("ss_item", "ss_cust", "ss_qty", "ss_wc", "ss_sp",
                    ratio.alias("ratio"))
            .sort("ss_item", "ss_cust").limit(100))


def q80(t):
    lo, hi = datetime.date(2000, 8, 1), datetime.date(2000, 8, 30)
    promo = t["promotion"].filter(col("p_channel_tv") == "N")

    def channel(sales, ret, skeys, date_k, id_k, promo_k, price, profit,
                ramt, rloss, tag):
        s = (sales
             .join(t["date_dim"].filter(
                 (col("d_date") >= lit(lo)) & (col("d_date") <= lit(hi))),
                 [(date_k, "d_date_sk")])
             .join(promo, [(promo_k, "p_promo_sk")], "leftsemi")
             .join(ret, skeys, "left"))
        return (s.groupBy(col(id_k).alias("id"))
                .agg(F.sum(col(price)).alias("sales"),
                     F.sum(F.coalesce(col(ramt), lit(0.0))).alias("returns_amt"),
                     F.sum(col(profit)).alias("_p"),
                     F.sum(F.coalesce(col(rloss), lit(0.0))).alias("_l"))
                .select("id", "sales", "returns_amt",
                        (col("_p") - col("_l")).alias("profit"))
                .withColumn("channel", lit(tag)))
    ss = channel(t["store_sales"], t["store_returns"],
                 [("ss_ticket_number", "sr_ticket_number"),
                  ("ss_item_sk", "sr_item_sk")],
                 "ss_sold_date_sk", "ss_store_sk", "ss_promo_sk",
                 "ss_ext_sales_price", "ss_net_profit", "sr_return_amt",
                 "sr_net_loss", "store channel")
    cs = channel(t["catalog_sales"], t["catalog_returns"],
                 [("cs_order_number", "cr_order_number"),
                  ("cs_item_sk", "cr_item_sk")],
                 "cs_sold_date_sk", "cs_catalog_page_sk", "cs_promo_sk",
                 "cs_ext_sales_price", "cs_net_profit", "cr_return_amount",
                 "cr_net_loss", "catalog channel")
    ws = channel(t["web_sales"], t["web_returns"],
                 [("ws_order_number", "wr_order_number"),
                  ("ws_item_sk", "wr_item_sk")],
                 "ws_sold_date_sk", "ws_web_site_sk", "ws_promo_sk",
                 "ws_ext_sales_price", "ws_net_profit", "wr_return_amt",
                 "wr_net_loss", "web channel")
    cols = ["channel", "id", "sales", "returns_amt", "profit"]
    return (ss.select(*cols).union(cs.select(*cols)).union(ws.select(*cols))
            .rollup("channel", "id")
            .agg(F.sum("sales").alias("sales"),
                 F.sum("returns_amt").alias("returns_amt"),
                 F.sum("profit").alias("profit"))
            .sort("channel", "id").limit(100))


def q81(t):
    ctr = (t["catalog_returns"]
           .join(t["date_dim"].filter(col("d_year") == 2000),
                 [("cr_returned_date_sk", "d_date_sk")])
           .join(t["customer"].select("c_customer_sk", "c_current_addr_sk"),
                 [("cr_returning_customer_sk", "c_customer_sk")])
           .join(t["customer_address"],
                 [("c_current_addr_sk", "ca_address_sk")])
           .groupBy(col("cr_returning_customer_sk").alias("ctr_cust"),
                    col("ca_state").alias("ctr_state"))
           .agg(F.sum("cr_return_amt_inc_tax").alias("ctr_total")))
    avg_ctr = (ctr.groupBy(col("ctr_state").alias("avg_state"))
               .agg(F.avg("ctr_total").alias("avg_ret"))
               .select("avg_state", (col("avg_ret") * 1.2).alias("thr")))
    return (ctr.join(avg_ctr, [("ctr_state", "avg_state")])
            .filter(col("ctr_total") > col("thr"))
            .join(t["customer"], [("ctr_cust", "c_customer_sk")])
            .join(t["customer_address"].filter(col("ca_state") == "GA"),
                  [("c_current_addr_sk", "ca_address_sk")])
            .select("c_customer_id", "c_salutation", "c_first_name",
                    "c_last_name", "ca_city", "ca_zip", "ctr_total")
            .sort("c_customer_id", "c_salutation", "c_first_name",
                  "c_last_name", "ca_city", "ca_zip")
            .limit(100))


def q83(t):
    week = (t["date_dim"]
            .filter(col("d_date").isin(datetime.date(2000, 6, 30),
                                       datetime.date(2000, 9, 27),
                                       datetime.date(2000, 11, 17)))
            .select(col("d_week_seq").alias("wseq")))
    dates = (t["date_dim"].join(week, [("d_week_seq", "wseq")], "leftsemi")
             .select("d_date_sk"))

    def rets(ret, item_k, date_k, qty, tag):
        return (ret.join(dates, [(date_k, "d_date_sk")], "leftsemi")
                .join(t["item"], [(item_k, "i_item_sk")])
                .groupBy(col("i_item_id").alias(f"{tag}_item_id"))
                .agg(F.sum(col(qty)).alias(f"{tag}_qty")))
    sr = rets(t["store_returns"], "sr_item_sk", "sr_returned_date_sk",
              "sr_return_quantity", "sr")
    cr = rets(t["catalog_returns"], "cr_item_sk", "cr_returned_date_sk",
              "cr_return_quantity", "cr")
    wr = rets(t["web_returns"], "wr_item_sk", "wr_returned_date_sk",
              "wr_return_quantity", "wr")
    j = (sr.join(cr, [("sr_item_id", "cr_item_id")])
         .join(wr, [("sr_item_id", "wr_item_id")]))
    total = (col("sr_qty") + col("cr_qty") + col("wr_qty")).cast("double")
    return (j.select(col("sr_item_id").alias("item_id"), "sr_qty",
                     (col("sr_qty") / total * 100).alias("sr_dev"),
                     "cr_qty", (col("cr_qty") / total * 100).alias("cr_dev"),
                     "wr_qty", (col("wr_qty") / total * 100).alias("wr_dev"),
                     (total / 3.0).alias("average"))
            .sort("item_id", "sr_qty").limit(100))


def q84(t):
    # adaption: the generator has no hd_income_band_sk path, so the income
    # band gate is dropped; the join shape (customer x address x demographics
    # x store_returns) is preserved
    return (t["customer"]
            .join(t["customer_address"].filter(col("ca_city") == "Fairview"),
                  [("c_current_addr_sk", "ca_address_sk")])
            .join(t["customer_demographics"],
                  [("c_current_cdemo_sk", "cd_demo_sk")])
            .join(t["store_returns"], [("cd_demo_sk", "sr_cdemo_sk")])
            .select(col("c_customer_id").alias("customer_id"),
                    col("c_last_name"), col("c_first_name"))
            .sort("customer_id").limit(100))


def q85(t):
    wr = (t["web_returns"]
          .join(t["web_sales"],
                [("wr_order_number", "ws_order_number"),
                 ("wr_item_sk", "ws_item_sk")])
          .join(t["date_dim"].filter(col("d_year") == 2000),
                [("ws_sold_date_sk", "d_date_sk")])
          .join(t["web_page"], [("ws_web_page_sk", "wp_web_page_sk")])
          .join(t["reason"], [("wr_reason_sk", "r_reason_sk")])
          .join(t["customer_demographics"],
                [("wr_refunded_cdemo_sk", "cd_demo_sk")])
          .filter(((col("cd_marital_status") == "M")
                   & (col("cd_education_status") == "Advanced Degree")
                   & (col("ws_sales_price") >= 100.0))
                  | ((col("cd_marital_status") == "S")
                     & (col("cd_education_status") == "College")
                     & (col("ws_sales_price") >= 50.0))
                  | ((col("cd_marital_status") == "W")
                     & (col("cd_education_status") == "2 yr Degree")
                     & (col("ws_sales_price") >= 0.0))))
    return (wr.groupBy("r_reason_desc")
            .agg(F.avg("ws_quantity").alias("avg_q"),
                 F.avg("wr_refunded_cash").alias("avg_cash"),
                 F.avg("wr_fee").alias("avg_fee"))
            .sort("r_reason_desc", "avg_q", "avg_cash", "avg_fee")
            .limit(100))


def q91(t):
    return (t["catalog_returns"]
            .join(t["date_dim"].filter((col("d_year") == 1998)
                                       & (col("d_moy") == 11)),
                  [("cr_returned_date_sk", "d_date_sk")])
            .join(t["call_center"], [("cr_call_center_sk",
                                      "cc_call_center_sk")])
            .join(t["customer"], [("cr_returning_customer_sk",
                                   "c_customer_sk")])
            .join(t["customer_demographics"].filter(
                ((col("cd_marital_status") == "M")
                 & (col("cd_education_status") == "Unknown"))
                | ((col("cd_marital_status") == "W")
                   & (col("cd_education_status") == "Advanced Degree"))),
                [("c_current_cdemo_sk", "cd_demo_sk")])
            .join(t["household_demographics"].filter(
                col("hd_buy_potential").like("Unknown%")),
                [("c_current_hdemo_sk", "hd_demo_sk")])
            .join(t["customer_address"].filter(col("ca_gmt_offset") == -7),
                  [("c_current_addr_sk", "ca_address_sk")])
            .groupBy("cc_call_center_id", "cc_name", "cc_manager",
                     "cd_marital_status", "cd_education_status")
            .agg(F.sum("cr_net_loss").alias("returns_loss"))
            .sort(col("returns_loss").desc())
            .limit(100))


def q95(t):
    ws1 = t["web_sales"].select(col("ws_order_number").alias("won"),
                                col("ws_warehouse_sk").alias("wwh"))
    ws2 = ws1.select(col("won").alias("won2"), col("wwh").alias("wwh2"))
    multi_wh = (ws1.join(ws2, [("won", "won2")])
                .filter(col("wwh") != col("wwh2"))
                .select("won").distinct())
    returned = t["web_returns"].select(
        col("wr_order_number").alias("rwon")).distinct()
    ws = (t["web_sales"]
          .join(t["date_dim"].filter(
              (col("d_date") >= lit(datetime.date(1999, 2, 1)))
              & (col("d_date") <= lit(datetime.date(1999, 4, 2)))),
              [("ws_ship_date_sk", "d_date_sk")])
          .join(t["customer_address"].filter(col("ca_state") == "GA"),
                [("ws_ship_addr_sk", "ca_address_sk")])
          .join(multi_wh, [("ws_order_number", "won")], "leftsemi")
          .join(returned, [("ws_order_number", "rwon")], "leftsemi"))
    return (ws.agg(F.countDistinct("ws_order_number").alias("order_count"),
                   F.sum("ws_ext_ship_cost").alias("total_shipping_cost"),
                   F.sum("ws_net_profit").alias("total_net_profit")))


QUERIES: Dict[str, object] = {
    name: fn for name, fn in list(globals().items())
    if name.startswith("q") and name[1:].isdigit() and callable(fn)}


#: the columns each query reads (the fewest with which it still binds); a
#: rollup carries its child's every column through its Expand, so its
#: queries' lists name only the columns the result depends on
COLUMNS: Dict[str, Dict[str, List[str]]] = {
    "q1": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id"],
        "store": ["s_store_sk", "s_state"],
        "store_returns": ["sr_returned_date_sk", "sr_customer_sk",
                          "sr_store_sk", "sr_return_amt"],
    },
    "q2": {
        "date_dim": ["d_date_sk", "d_year", "d_day_name", "d_week_seq"],
        "catalog_sales": ["cs_sold_date_sk", "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_ext_sales_price"],
    },
    "q3": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    },
    "q4": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id", "c_preferred_cust_flag"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                        "ss_ext_discount_amt", "ss_ext_sales_price",
                        "ss_ext_wholesale_cost", "ss_ext_list_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_ext_discount_amt", "cs_ext_sales_price",
                          "cs_ext_wholesale_cost", "cs_ext_list_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk",
                      "ws_ext_discount_amt", "ws_ext_sales_price",
                      "ws_ext_wholesale_cost", "ws_ext_list_price"],
    },
    "q5": {
        "date_dim": ["d_date_sk", "d_date"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk",
                        "ss_ext_sales_price", "ss_net_profit"],
        "store_returns": ["sr_returned_date_sk", "sr_store_sk",
                          "sr_return_amt", "sr_net_loss"],
        "catalog_sales": ["cs_sold_date_sk", "cs_catalog_page_sk",
                          "cs_ext_sales_price", "cs_net_profit"],
        "catalog_returns": ["cr_returned_date_sk", "cr_catalog_page_sk",
                            "cr_return_amount", "cr_net_loss"],
        "web_sales": ["ws_sold_date_sk", "ws_web_site_sk",
                      "ws_ext_sales_price", "ws_net_profit"],
        "web_returns": ["wr_returned_date_sk", "wr_web_page_sk",
                        "wr_return_amt", "wr_net_loss"],
    },
    "q6": {
        "date_dim": ["d_date_sk", "d_year", "d_moy", "d_month_seq"],
        "item": ["i_item_sk", "i_category", "i_current_price"],
        "customer": ["c_customer_sk", "c_current_addr_sk"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"],
    },
    "q7": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_item_id"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_education_status"],
        "promotion": ["p_promo_sk", "p_channel_email", "p_channel_event"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                        "ss_promo_sk", "ss_quantity", "ss_list_price",
                        "ss_sales_price", "ss_coupon_amt"],
    },
    "q8": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "customer": ["c_current_addr_sk", "c_preferred_cust_flag"],
        "customer_address": ["ca_address_sk", "ca_zip"],
        "store": ["s_store_sk", "s_store_name", "s_zip"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_net_profit"],
    },
    "q9": {
        "reason": ["r_reason_sk"],
        "store_sales": ["ss_quantity", "ss_ext_discount_amt", "ss_net_paid"],
    },
    "q10": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "customer": ["c_customer_sk", "c_current_addr_sk",
                     "c_current_cdemo_sk"],
        "customer_address": ["ca_address_sk", "ca_county"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_education_status",
                                  "cd_credit_rating", "cd_purchase_estimate"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    },
    "q11": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id", "c_preferred_cust_flag"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                        "ss_ext_discount_amt", "ss_ext_list_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk",
                      "ws_ext_discount_amt", "ws_ext_list_price"],
    },
    "q12": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_class",
                 "i_category", "i_current_price"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"],
    },
    "q13": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer_address": ["ca_address_sk", "ca_state", "ca_country"],
        "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                                  "cd_education_status"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count"],
        "store": ["s_store_sk"],
        "store_sales": ["ss_sold_date_sk", "ss_cdemo_sk", "ss_hdemo_sk",
                        "ss_addr_sk", "ss_store_sk", "ss_quantity",
                        "ss_sales_price", "ss_ext_sales_price",
                        "ss_ext_wholesale_cost", "ss_net_profit"],
    },
    "q14": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand_id", "i_class", "i_category_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_quantity",
                        "ss_list_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_quantity",
                          "cs_list_price"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_quantity",
                      "ws_list_price"],
    },
    "q15": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "customer": ["c_customer_sk", "c_current_addr_sk"],
        "customer_address": ["ca_address_sk", "ca_state", "ca_zip"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_sales_price"],
    },
    "q16": {
        "date_dim": ["d_date_sk", "d_date"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "call_center": ["cc_call_center_sk", "cc_county"],
        "catalog_sales": ["cs_ship_addr_sk", "cs_call_center_sk",
                          "cs_ship_date_sk", "cs_warehouse_sk",
                          "cs_order_number", "cs_ext_ship_cost",
                          "cs_net_profit"],
        "catalog_returns": ["cr_order_number"],
    },
    "q17": {
        "date_dim": ["d_date_sk", "d_quarter_name"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc"],
        "store": ["s_store_sk", "s_state"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_ticket_number", "ss_quantity"],
        "store_returns": ["sr_returned_date_sk", "sr_item_sk",
                          "sr_customer_sk", "sr_ticket_number",
                          "sr_return_quantity"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk", "cs_quantity"],
    },
    "q18": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_item_id"],
        "customer": ["c_customer_sk", "c_current_addr_sk",
                     "c_current_cdemo_sk", "c_birth_year", "c_birth_month"],
        "customer_address": ["ca_address_sk", "ca_county", "ca_state",
                             "ca_country"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_education_status", "cd_dep_count"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_bill_cdemo_sk", "cs_item_sk", "cs_quantity",
                          "cs_list_price", "cs_sales_price", "cs_coupon_amt",
                          "cs_net_profit"],
    },
    "q19": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
                 "i_manufact", "i_manager_id"],
        "customer": ["c_customer_sk", "c_current_addr_sk"],
        "customer_address": ["ca_address_sk", "ca_zip"],
        "store": ["s_store_sk", "s_zip"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_ext_sales_price"],
    },
    "q20": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_class",
                 "i_category", "i_current_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
    },
    "q21": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_current_price"],
        "warehouse": ["w_warehouse_sk", "w_warehouse_name"],
        "inventory": ["inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                      "inv_quantity_on_hand"],
    },
    "q22": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "item": ["i_item_sk", "i_product_name", "i_brand", "i_class",
                 "i_category"],
        "inventory": ["inv_date_sk", "inv_item_sk", "inv_quantity_on_hand"],
    },
    "q23": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_quantity", "ss_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk", "cs_quantity", "cs_list_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk",
                      "ws_quantity", "ws_list_price"],
    },
    "q24": {
        "item": ["i_item_sk", "i_color"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name"],
        "store": ["s_store_sk", "s_store_name"],
        "store_sales": ["ss_item_sk", "ss_customer_sk", "ss_store_sk",
                        "ss_ticket_number", "ss_net_paid"],
        "store_returns": ["sr_item_sk", "sr_ticket_number"],
    },
    "q25": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc"],
        "store": ["s_store_sk", "s_store_id", "s_store_name"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_ticket_number", "ss_net_profit"],
        "store_returns": ["sr_returned_date_sk", "sr_item_sk",
                          "sr_customer_sk", "sr_ticket_number", "sr_net_loss"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk", "cs_net_profit"],
    },
    "q26": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_item_id"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_education_status"],
        "promotion": ["p_promo_sk", "p_channel_email", "p_channel_event"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_cdemo_sk", "cs_item_sk",
                          "cs_promo_sk", "cs_quantity", "cs_list_price",
                          "cs_sales_price", "cs_coupon_amt"],
    },
    "q27": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_item_id"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_education_status"],
        "store": ["s_store_sk", "s_state"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                        "ss_store_sk", "ss_quantity", "ss_list_price",
                        "ss_sales_price", "ss_coupon_amt"],
    },
    "q28": {
        "store_sales": ["ss_quantity", "ss_wholesale_cost", "ss_list_price",
                        "ss_coupon_amt"],
    },
    "q29": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc"],
        "store": ["s_store_sk", "s_store_id", "s_store_name"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_ticket_number", "ss_quantity"],
        "store_returns": ["sr_returned_date_sk", "sr_item_sk",
                          "sr_customer_sk", "sr_ticket_number",
                          "sr_return_quantity"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk", "cs_quantity"],
    },
    "q30": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id", "c_current_addr_sk",
                     "c_first_name", "c_last_name", "c_salutation"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "web_returns": ["wr_returned_date_sk", "wr_returning_customer_sk",
                        "wr_return_amt"],
    },
    "q31": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "customer_address": ["ca_address_sk", "ca_county"],
        "store_sales": ["ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_addr_sk",
                      "ws_ext_sales_price"],
    },
    "q32": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_manufact_id"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_discount_amt"],
    },
    "q33": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_category", "i_manufact_id"],
        "customer_address": ["ca_address_sk", "ca_gmt_offset"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_addr_sk",
                        "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_addr_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_addr_sk", "ws_item_sk",
                      "ws_ext_sales_price"],
    },
    "q34": {
        "date_dim": ["d_date_sk", "d_year", "d_dom"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name",
                     "c_salutation", "c_preferred_cust_flag"],
        "household_demographics": ["hd_demo_sk", "hd_buy_potential",
                                   "hd_dep_count", "hd_vehicle_count"],
        "store": ["s_store_sk", "s_county"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_hdemo_sk",
                        "ss_store_sk", "ss_ticket_number"],
    },
    "q35": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "customer": ["c_customer_sk", "c_current_addr_sk",
                     "c_current_cdemo_sk"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_dep_count"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    },
    "q36": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_class", "i_category"],
        "store": ["s_store_sk", "s_state"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_ext_sales_price", "ss_net_profit"],
    },
    "q37": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_manufact_id",
                 "i_current_price"],
        "catalog_sales": ["cs_item_sk"],
        "inventory": ["inv_date_sk", "inv_item_sk", "inv_quantity_on_hand"],
    },
    "q38": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    },
    "q39": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk"],
        "warehouse": ["w_warehouse_sk"],
        "inventory": ["inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                      "inv_quantity_on_hand"],
    },
    "q40": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_current_price"],
        "warehouse": ["w_warehouse_sk", "w_state"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_warehouse_sk",
                          "cs_order_number", "cs_sales_price"],
        "catalog_returns": ["cr_item_sk", "cr_order_number",
                            "cr_refunded_cash"],
    },
    "q41": {
        "item": ["i_product_name", "i_category", "i_manufact_id",
                 "i_manufact", "i_color", "i_units", "i_size"],
    },
    "q42": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_category_id", "i_category", "i_manager_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    },
    "q43": {
        "date_dim": ["d_date_sk", "d_year", "d_day_name"],
        "store": ["s_store_sk", "s_store_id", "s_store_name", "s_gmt_offset"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_sales_price"],
    },
    "q44": {
        "item": ["i_item_sk", "i_product_name"],
        "store_sales": ["ss_item_sk", "ss_addr_sk", "ss_store_sk",
                        "ss_net_profit"],
    },
    "q45": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "item": ["i_item_sk", "i_item_id"],
        "customer": ["c_customer_sk", "c_current_addr_sk"],
        "customer_address": ["ca_address_sk", "ca_city", "ca_zip"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk",
                      "ws_sales_price"],
    },
    "q46": {
        "date_dim": ["d_date_sk", "d_year", "d_dow"],
        "customer": ["c_customer_sk", "c_current_addr_sk", "c_first_name",
                     "c_last_name"],
        "customer_address": ["ca_address_sk", "ca_city"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count",
                                   "hd_vehicle_count"],
        "store": ["s_store_sk", "s_city"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_hdemo_sk",
                        "ss_addr_sk", "ss_store_sk", "ss_ticket_number",
                        "ss_coupon_amt", "ss_net_profit"],
    },
    "q47": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand", "i_category"],
        "store": ["s_store_sk", "s_store_name", "s_company_name"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_sales_price"],
    },
    "q48": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer_address": ["ca_address_sk", "ca_state", "ca_country"],
        "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                                  "cd_education_status"],
        "store": ["s_store_sk"],
        "store_sales": ["ss_sold_date_sk", "ss_cdemo_sk", "ss_addr_sk",
                        "ss_store_sk", "ss_quantity", "ss_sales_price",
                        "ss_net_profit"],
    },
    "q49": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                        "ss_quantity", "ss_net_paid"],
        "store_returns": ["sr_item_sk", "sr_ticket_number",
                          "sr_return_quantity", "sr_return_amt"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_order_number",
                          "cs_quantity", "cs_net_paid"],
        "catalog_returns": ["cr_item_sk", "cr_order_number",
                            "cr_return_quantity", "cr_return_amount"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_order_number",
                      "ws_quantity", "ws_net_paid"],
        "web_returns": ["wr_item_sk", "wr_order_number", "wr_return_quantity",
                        "wr_return_amt"],
    },
    "q50": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "store": ["s_store_sk", "s_store_name", "s_city", "s_county",
                  "s_state", "s_company_id", "s_street_number",
                  "s_street_name", "s_street_type", "s_suite_number", "s_zip"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_ticket_number"],
        "store_returns": ["sr_returned_date_sk", "sr_item_sk",
                          "sr_customer_sk", "sr_ticket_number"],
    },
    "q51": {
        "date_dim": ["d_date_sk", "d_date", "d_month_seq"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_sales_price"],
    },
    "q52": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    },
    "q53": {
        "date_dim": ["d_date_sk", "d_qoy", "d_month_seq"],
        "item": ["i_item_sk", "i_brand", "i_class", "i_category",
                 "i_manufact_id"],
        "store": ["s_store_sk"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_sales_price"],
    },
    "q54": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_class", "i_category"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                        "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk"],
    },
    "q55": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    },
    "q56": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_item_id", "i_color"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"],
    },
    "q57": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand", "i_category"],
        "call_center": ["cc_call_center_sk", "cc_name"],
        "catalog_sales": ["cs_sold_date_sk", "cs_call_center_sk",
                          "cs_item_sk", "cs_sales_price"],
    },
    "q58": {
        "date_dim": ["d_date_sk", "d_date", "d_week_seq"],
        "item": ["i_item_sk", "i_item_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"],
    },
    "q59": {
        "date_dim": ["d_date_sk", "d_day_name", "d_week_seq", "d_month_seq"],
        "store": ["s_store_sk", "s_store_id", "s_store_name"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_sales_price"],
    },
    "q60": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_item_id", "i_category"],
        "customer_address": ["ca_address_sk", "ca_gmt_offset"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_addr_sk",
                        "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_addr_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_addr_sk", "ws_item_sk",
                      "ws_ext_sales_price"],
    },
    "q61": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_category"],
        "customer": ["c_customer_sk", "c_current_addr_sk"],
        "customer_address": ["ca_address_sk", "ca_gmt_offset"],
        "store": ["s_store_sk", "s_gmt_offset"],
        "promotion": ["p_promo_sk", "p_channel_dmail", "p_channel_email",
                      "p_channel_tv"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_store_sk", "ss_promo_sk", "ss_ext_sales_price"],
    },
    "q62": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "warehouse": ["w_warehouse_sk", "w_warehouse_name"],
        "web_site": ["web_site_sk", "web_name"],
        "ship_mode": ["sm_ship_mode_sk", "sm_type"],
        "web_sales": ["ws_sold_date_sk", "ws_ship_mode_sk", "ws_web_site_sk",
                      "ws_ship_date_sk", "ws_warehouse_sk"],
    },
    "q63": {
        "date_dim": ["d_date_sk", "d_moy", "d_month_seq"],
        "item": ["i_item_sk", "i_brand", "i_class", "i_category",
                 "i_manager_id"],
        "store": ["s_store_sk"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_sales_price"],
    },
    "q64": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_product_name", "i_current_price"],
        "store": ["s_store_sk", "s_store_name", "s_zip"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_ticket_number", "ss_wholesale_cost",
                        "ss_list_price", "ss_coupon_amt"],
        "store_returns": ["sr_item_sk", "sr_ticket_number"],
        "catalog_sales": ["cs_item_sk", "cs_order_number", "cs_ext_list_price"],
        "catalog_returns": ["cr_item_sk", "cr_order_number", "cr_fee",
                            "cr_refunded_cash"],
    },
    "q65": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "item": ["i_item_sk", "i_item_desc", "i_brand", "i_wholesale_cost",
                 "i_current_price"],
        "store": ["s_store_sk", "s_store_name"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_sales_price"],
    },
    "q66": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "time_dim": ["t_time_sk", "t_hour"],
        "warehouse": ["w_warehouse_sk", "w_warehouse_name",
                      "w_warehouse_sq_ft", "w_city", "w_county", "w_state",
                      "w_country"],
        "ship_mode": ["sm_ship_mode_sk", "sm_carrier"],
        "catalog_sales": ["cs_sold_date_sk", "cs_sold_time_sk",
                          "cs_ship_mode_sk", "cs_warehouse_sk", "cs_quantity",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_sold_time_sk", "ws_ship_mode_sk",
                      "ws_warehouse_sk", "ws_quantity", "ws_ext_sales_price"],
    },
    "q67": {
        "date_dim": ["d_date_sk", "d_year", "d_moy", "d_qoy", "d_month_seq"],
        "item": ["i_item_sk", "i_product_name", "i_brand", "i_class",
                 "i_category"],
        "store": ["s_store_sk", "s_store_id"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_quantity", "ss_sales_price"],
    },
    "q68": {
        "date_dim": ["d_date_sk", "d_year", "d_dom"],
        "customer": ["c_customer_sk", "c_current_addr_sk", "c_first_name",
                     "c_last_name"],
        "customer_address": ["ca_address_sk", "ca_city"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count",
                                   "hd_vehicle_count"],
        "store": ["s_store_sk", "s_city"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_hdemo_sk",
                        "ss_addr_sk", "ss_store_sk", "ss_ticket_number",
                        "ss_ext_sales_price", "ss_ext_list_price",
                        "ss_ext_tax"],
    },
    "q69": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "customer": ["c_customer_sk", "c_current_addr_sk",
                     "c_current_cdemo_sk"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "customer_demographics": ["cd_demo_sk", "cd_gender",
                                  "cd_marital_status", "cd_education_status",
                                  "cd_credit_rating", "cd_purchase_estimate"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_ship_customer_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    },
    "q70": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "store": ["s_store_sk", "s_county", "s_state"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_net_profit"],
    },
    "q71": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "time_dim": ["t_time_sk", "t_hour", "t_minute", "t_meal_time"],
        "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"],
        "store_sales": ["ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
                        "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_sold_time_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_sold_time_sk", "ws_item_sk",
                      "ws_ext_sales_price"],
    },
    "q72": {
        "date_dim": ["d_date_sk", "d_year", "d_week_seq"],
        "item": ["i_item_sk", "i_item_desc"],
        "customer_demographics": ["cd_demo_sk", "cd_marital_status"],
        "household_demographics": ["hd_demo_sk", "hd_buy_potential"],
        "warehouse": ["w_warehouse_sk", "w_warehouse_name"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_cdemo_sk",
                          "cs_bill_hdemo_sk", "cs_item_sk", "cs_quantity"],
        "inventory": ["inv_item_sk", "inv_warehouse_sk",
                      "inv_quantity_on_hand"],
    },
    "q73": {
        "date_dim": ["d_date_sk", "d_year", "d_dom"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name",
                     "c_salutation", "c_preferred_cust_flag"],
        "household_demographics": ["hd_demo_sk", "hd_buy_potential",
                                   "hd_dep_count", "hd_vehicle_count"],
        "store": ["s_store_sk", "s_county"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_hdemo_sk",
                        "ss_store_sk", "ss_ticket_number"],
    },
    "q74": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id", "c_preferred_cust_flag"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_net_paid"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_net_paid"],
    },
    "q75": {
        "date_dim": ["d_date_sk", "d_year"],
        "item": ["i_item_sk", "i_brand_id", "i_category_id", "i_category"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                        "ss_quantity", "ss_ext_sales_price"],
        "store_returns": ["sr_item_sk", "sr_ticket_number",
                          "sr_return_quantity", "sr_return_amt"],
        "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_order_number",
                          "cs_quantity", "cs_ext_sales_price"],
        "catalog_returns": ["cr_item_sk", "cr_order_number",
                            "cr_return_quantity", "cr_return_amount"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_order_number",
                      "ws_quantity", "ws_ext_sales_price"],
        "web_returns": ["wr_item_sk", "wr_order_number", "wr_return_quantity",
                        "wr_return_amt"],
    },
    "q76": {
        "date_dim": ["d_date_sk", "d_year", "d_qoy"],
        "item": ["i_item_sk", "i_category"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_ext_sales_price"],
        "catalog_sales": ["cs_sold_date_sk", "cs_ship_addr_sk", "cs_item_sk",
                          "cs_ext_sales_price"],
        "web_sales": ["ws_sold_date_sk", "ws_ship_customer_sk", "ws_item_sk",
                      "ws_ext_sales_price"],
    },
    "q77": {
        "date_dim": ["d_date_sk", "d_date"],
        "store_sales": ["ss_sold_date_sk", "ss_store_sk",
                        "ss_ext_sales_price", "ss_net_profit"],
        "store_returns": ["sr_returned_date_sk", "sr_store_sk",
                          "sr_return_amt", "sr_net_loss"],
        "catalog_sales": ["cs_sold_date_sk", "cs_call_center_sk",
                          "cs_ext_sales_price", "cs_net_profit"],
        "catalog_returns": ["cr_returned_date_sk", "cr_call_center_sk",
                            "cr_return_amount", "cr_net_loss"],
        "web_sales": ["ws_sold_date_sk", "ws_web_page_sk",
                      "ws_ext_sales_price", "ws_net_profit"],
        "web_returns": ["wr_returned_date_sk", "wr_web_page_sk",
                        "wr_return_amt", "wr_net_loss"],
    },
    "q78": {
        "date_dim": ["d_date_sk", "d_year"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                        "ss_ticket_number", "ss_quantity",
                        "ss_wholesale_cost", "ss_sales_price"],
        "store_returns": ["sr_item_sk", "sr_ticket_number"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk", "cs_order_number", "cs_quantity",
                          "cs_wholesale_cost", "cs_sales_price"],
        "catalog_returns": ["cr_item_sk", "cr_order_number"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk",
                      "ws_order_number", "ws_quantity", "ws_wholesale_cost",
                      "ws_sales_price"],
        "web_returns": ["wr_item_sk", "wr_order_number"],
    },
    "q79": {
        "date_dim": ["d_date_sk", "d_year", "d_dow"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count",
                                   "hd_vehicle_count"],
        "store": ["s_store_sk", "s_number_employees", "s_city"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk", "ss_hdemo_sk",
                        "ss_addr_sk", "ss_store_sk", "ss_ticket_number",
                        "ss_coupon_amt", "ss_net_profit"],
    },
    "q80": {
        "date_dim": ["d_date_sk", "d_date"],
        "promotion": ["p_promo_sk", "p_channel_tv"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_promo_sk", "ss_ticket_number",
                        "ss_ext_sales_price", "ss_net_profit"],
        "store_returns": ["sr_item_sk", "sr_ticket_number", "sr_return_amt",
                          "sr_net_loss"],
        "catalog_sales": ["cs_sold_date_sk", "cs_catalog_page_sk",
                          "cs_item_sk", "cs_promo_sk", "cs_order_number",
                          "cs_ext_sales_price", "cs_net_profit"],
        "catalog_returns": ["cr_item_sk", "cr_order_number",
                            "cr_return_amount", "cr_net_loss"],
        "web_sales": ["ws_sold_date_sk", "ws_web_site_sk", "ws_item_sk",
                      "ws_promo_sk", "ws_order_number", "ws_ext_sales_price",
                      "ws_net_profit"],
        "web_returns": ["wr_item_sk", "wr_order_number", "wr_return_amt",
                        "wr_net_loss"],
    },
    "q81": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer": ["c_customer_sk", "c_customer_id", "c_current_addr_sk",
                     "c_first_name", "c_last_name", "c_salutation"],
        "customer_address": ["ca_address_sk", "ca_city", "ca_state", "ca_zip"],
        "catalog_returns": ["cr_returned_date_sk", "cr_returning_customer_sk",
                            "cr_return_amt_inc_tax"],
    },
    "q82": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_manufact_id",
                 "i_current_price"],
        "store_sales": ["ss_item_sk"],
        "inventory": ["inv_date_sk", "inv_item_sk", "inv_quantity_on_hand"],
    },
    "q83": {
        "date_dim": ["d_date_sk", "d_date", "d_week_seq"],
        "item": ["i_item_sk", "i_item_id"],
        "store_returns": ["sr_returned_date_sk", "sr_item_sk",
                          "sr_return_quantity"],
        "catalog_returns": ["cr_returned_date_sk", "cr_item_sk",
                            "cr_return_quantity"],
        "web_returns": ["wr_returned_date_sk", "wr_item_sk",
                        "wr_return_quantity"],
    },
    "q84": {
        "customer": ["c_customer_id", "c_current_addr_sk",
                     "c_current_cdemo_sk", "c_first_name", "c_last_name"],
        "customer_address": ["ca_address_sk", "ca_city"],
        "customer_demographics": ["cd_demo_sk"],
        "store_returns": ["sr_cdemo_sk"],
    },
    "q85": {
        "date_dim": ["d_date_sk", "d_year"],
        "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                                  "cd_education_status"],
        "web_page": ["wp_web_page_sk"],
        "reason": ["r_reason_sk", "r_reason_desc"],
        "web_sales": ["ws_sold_date_sk", "ws_web_page_sk", "ws_item_sk",
                      "ws_order_number", "ws_quantity", "ws_sales_price"],
        "web_returns": ["wr_item_sk", "wr_order_number",
                        "wr_refunded_cdemo_sk", "wr_reason_sk", "wr_fee",
                        "wr_refunded_cash"],
    },
    "q86": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "item": ["i_item_sk", "i_class", "i_category"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_net_paid"],
    },
    "q87": {
        "date_dim": ["d_date_sk", "d_date", "d_month_seq"],
        "customer": ["c_customer_sk", "c_first_name", "c_last_name"],
        "store_sales": ["ss_sold_date_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk"],
        "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk"],
    },
    "q88": {
        "time_dim": ["t_time_sk", "t_hour", "t_minute"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count",
                                   "hd_vehicle_count"],
        "store": ["s_store_sk", "s_store_name"],
        "store_sales": ["ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"],
    },
    "q89": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "item": ["i_item_sk", "i_brand", "i_class", "i_category"],
        "store": ["s_store_sk", "s_store_name", "s_company_name"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                        "ss_sales_price"],
    },
    "q90": {
        "time_dim": ["t_time_sk", "t_hour"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count"],
        "web_page": ["wp_web_page_sk", "wp_char_count"],
        "web_sales": ["ws_sold_time_sk", "ws_ship_hdemo_sk", "ws_web_page_sk"],
    },
    "q91": {
        "date_dim": ["d_date_sk", "d_year", "d_moy"],
        "customer": ["c_customer_sk", "c_current_addr_sk",
                     "c_current_cdemo_sk", "c_current_hdemo_sk"],
        "customer_address": ["ca_address_sk", "ca_gmt_offset"],
        "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                                  "cd_education_status"],
        "household_demographics": ["hd_demo_sk", "hd_buy_potential"],
        "call_center": ["cc_call_center_sk", "cc_call_center_id", "cc_name",
                        "cc_manager"],
        "catalog_returns": ["cr_returned_date_sk", "cr_returning_customer_sk",
                            "cr_call_center_sk", "cr_net_loss"],
    },
    "q92": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_manufact_id"],
        "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_discount_amt"],
    },
    "q93": {
        "reason": ["r_reason_sk", "r_reason_desc"],
        "store_sales": ["ss_item_sk", "ss_customer_sk", "ss_ticket_number",
                        "ss_quantity", "ss_sales_price"],
        "store_returns": ["sr_item_sk", "sr_reason_sk", "sr_ticket_number",
                          "sr_return_quantity"],
    },
    "q94": {
        "date_dim": ["d_date_sk", "d_date"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "web_site": ["web_site_sk", "web_company_name"],
        "web_sales": ["ws_ship_addr_sk", "ws_web_site_sk", "ws_ship_date_sk",
                      "ws_warehouse_sk", "ws_order_number",
                      "ws_ext_ship_cost", "ws_net_profit"],
        "web_returns": ["wr_order_number"],
    },
    "q95": {
        "date_dim": ["d_date_sk", "d_date"],
        "customer_address": ["ca_address_sk", "ca_state"],
        "web_sales": ["ws_ship_addr_sk", "ws_ship_date_sk", "ws_warehouse_sk",
                      "ws_order_number", "ws_ext_ship_cost", "ws_net_profit"],
        "web_returns": ["wr_order_number"],
    },
    "q96": {
        "time_dim": ["t_time_sk", "t_hour", "t_minute"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count"],
        "store": ["s_store_sk", "s_store_name"],
        "store_sales": ["ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"],
    },
    "q97": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"],
        "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                          "cs_item_sk"],
    },
    "q98": {
        "date_dim": ["d_date_sk", "d_date"],
        "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_class",
                 "i_category", "i_current_price"],
        "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    },
    "q99": {
        "date_dim": ["d_date_sk", "d_month_seq"],
        "warehouse": ["w_warehouse_sk", "w_warehouse_name"],
        "call_center": ["cc_call_center_sk", "cc_name"],
        "ship_mode": ["sm_ship_mode_sk", "sm_type"],
        "catalog_sales": ["cs_sold_date_sk", "cs_ship_mode_sk",
                          "cs_call_center_sk", "cs_ship_date_sk",
                          "cs_warehouse_sk"],
    },
}
