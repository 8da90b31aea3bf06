"""Queries over the TPC-DS tables that drive the port's expression and SQL
surface: one per family of functions, operators, window functions and set
operations, as SQL where the SQL planner (the JAX package's, copied) has
the function, and as DataFrames otherwise (it has no ``initcap``,
``rlike``, day or time parts, bitwise operators, trigonometry or
``ignore nulls``).

Every query returns few rows: an aggregate of the rows it computes, or a
thin filtered slice of them, ordered so that the row order is fixed. A
DataFrame query is ``build(dfs, F, Window, E)`` over a dict of DataFrames,
with ``F`` a functions module (it has ``Column``), ``Window`` and ``E`` an
expressions namespace with the shifts: the port's, or the JAX package's,
which tests hold it against.

The TPC-DS specification's query38 (INTERSECT) and query87 (EXCEPT), from
the v3.2.0 templates with ``d_month_seq between 1200 and 1211``, are here
as written but for one thing: query87 puts each EXCEPT operand in
parentheses, which the SQL parser does not take; EXCEPT associates to the
left, so dropping them leaves the query as it was.
``benchmarks/tpcds_sql.py`` spells both as semi and anti joins. Its
query87 is the spec's; its query38 keeps only the customer's names, where
the spec intersects (name, first name, date) triples, so ``Q38_SEMI`` is
the spec's query38 as semi joins, with the date.
"""
from __future__ import annotations

from spark_rapids_tpu_torch.benchmarks.tpcds_sql import SQL_QUERIES

Q38_SPEC = """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
          where store_sales.ss_sold_date_sk = date_dim.d_date_sk
      and store_sales.ss_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
  intersect
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
          where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
      and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
  intersect
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
          where web_sales.ws_sold_date_sk = date_dim.d_date_sk
      and web_sales.ws_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
) hot_cust
limit 100
"""

Q87_SPEC = """
select count(*)
from (select distinct c_last_name, c_first_name, d_date
       from store_sales, date_dim, customer
       where store_sales.ss_sold_date_sk = date_dim.d_date_sk
         and store_sales.ss_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11
       except
      select distinct c_last_name, c_first_name, d_date
       from catalog_sales, date_dim, customer
       where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
         and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11
       except
      select distinct c_last_name, c_first_name, d_date
       from web_sales, date_dim, customer
       where web_sales.ws_sold_date_sk = date_dim.d_date_sk
         and web_sales.ws_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11
) cool_cust
"""

Q38_SEMI = """
select count(*) as cnt
from (select distinct c_last_name, c_first_name, d_date
      from store_sales, date_dim, customer
      where ss_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and ss_customer_sk = c_customer_sk) store_c
     left semi join
     (select distinct c_last_name as cl, c_first_name as cf, d_date as cd
      from catalog_sales, date_dim, customer
      where cs_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and cs_bill_customer_sk = c_customer_sk) catalog_c
     on c_last_name = cl and c_first_name = cf and d_date = cd
     left semi join
     (select distinct c_last_name as wl, c_first_name as wf, d_date as wd
      from web_sales, date_dim, customer
      where ws_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and ws_bill_customer_sk = c_customer_sk) web_c
     on c_last_name = wl and c_first_name = wf and d_date = wd
"""

#: the spec's set-operation texts and the rewrite each must equal
SET_OPS = {"q38": (Q38_SPEC, Q38_SEMI), "q87": (Q87_SPEC, SQL_QUERIES["q87"])}

#: ROWS BETWEEN 3 PRECEDING AND CURRENT ROW per item, in ticket order
_ITEM_FRAME = ("(partition by ss_item_sk order by ss_ticket_number "
               "rows between 3 preceding and current row)")

SQL = {
    "remainder": """
select ss_item_sk % 16 as bucket, count(*) as n, sum(ss_quantity) as q,
       min(ss_ticket_number % 7) as lo, max(ss_ticket_number % 7) as hi
from store_sales group by ss_item_sk % 16 order by bucket
""",
    "cast_string": """
select length(t) as len, count(*) as n, min(t) as lo, max(t) as hi
from (select concat('T', cast(ss_ticket_number as string), '-',
                    cast(ss_quantity > 50 as string)) as t
      from store_sales where ss_quantity > 90) x
group by length(t) order by len
""",
    "regexp_replace": """
select i_item_sk, regexp_replace(i_item_desc, '[aeiou]+', '_') as d,
       regexp_replace(i_brand, ' +', '') as b
from item where i_item_sk % 20 = 0 order by i_item_sk
""",
    "unix_time": """
select d_date_sk, unix_timestamp(d_date) as u,
       from_unixtime(unix_timestamp(d_date) + d_date_sk % 86400) as s
from date_dim where d_date_sk % 10 = 0 order by d_date_sk
""",
    "percent_rank_cume_dist": """
select ss_store_sk, ss_net_paid, pr, cd
from (select ss_store_sk, ss_net_paid,
             percent_rank() over (partition by ss_store_sk
                                  order by ss_net_paid) as pr,
             cume_dist() over (partition by ss_store_sk
                               order by ss_net_paid) as cd
      from store_sales) x
where pr >= 0.999 or cd <= 0.001
group by ss_store_sk, ss_net_paid, pr, cd
order by ss_store_sk, ss_net_paid
""",
    "framed_min_max": f"""
select count(*) as n, sum(case when mx > ss_net_paid then 1 else 0 end)
       as below_max, sum(cast(mx * 100 as bigint)) as mx_sum,
       sum(cast(mn * 100 as bigint)) as mn_sum, max(mx) as top,
       min(mn) as bottom, max(mb) as brand_hi, min(mb) as brand_lo,
       sum(length(mb)) as brand_len
from (select ss_net_paid, max(ss_net_paid) over {_ITEM_FRAME} as mx,
             min(ss_net_paid) over {_ITEM_FRAME} as mn,
             min(i_brand) over {_ITEM_FRAME} as mb
      from store_sales, item where ss_item_sk = i_item_sk) x
""",
    "pivot": """
select * from (select ss_store_sk, d_moy, ss_net_paid
               from store_sales, date_dim
               where ss_sold_date_sk = d_date_sk and d_year = 2000)
pivot (sum(ss_net_paid) for d_moy in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                      12))
order by ss_store_sk
""",
}


def _item_strings(dfs, F, Window, E):
    item = dfs["item"]
    c = F.col
    return (item.filter(c("i_item_desc").rlike("[0-9]|ly|er+s"))
            .select("i_item_sk", F.initcap(c("i_item_desc")).alias("cap"),
                    F.initcap(c("i_brand")).alias("brand"),
                    c("i_brand").rlike("#[0-9]").alias("numbered"))
            .filter(c("i_item_sk") % 10 == 0).sort("i_item_sk"))


def _date_parts(dfs, F, Window, E):
    c = F.col
    ts = ((F.unix_timestamp(c("d_date")) + c("d_date_sk") * 37)
          .cast("timestamp"))
    return (dfs["date_dim"]
            .select("d_date_sk", F.dayofweek(c("d_date")).alias("dow"),
                    F.dayofyear(c("d_date")).alias("doy"),
                    F.quarter(c("d_date")).alias("q"),
                    F.last_day(c("d_date")).alias("ld"),
                    F.hour(ts).alias("h"), F.minute(ts).alias("mi"),
                    F.second(ts).alias("s"))
            .filter(c("d_date_sk") % 7 == 0).sort("d_date_sk"))


def _first_last(dfs, F, Window, E):
    c = F.col
    ws = Window.partitionBy("ss_item_sk").orderBy("ss_ticket_number") \
        .rowsBetween(-3, 1)
    framed = dfs["store_sales"].select(
        F.first("ss_customer_sk").over(ws).alias("f"),
        F.last("ss_customer_sk").over(ws).alias("l"),
        F.first("ss_customer_sk", True).over(ws).alias("fn"),
        F.last("ss_customer_sk", True).over(ws).alias("ln"))
    return framed.agg(*[g(x).alias(f"{p}_{x}") for x in ("f", "l", "fn", "ln")
                        for p, g in (("n", F.count), ("sum", F.sum))],
                      F.count("*").alias("rows"))


def _bitwise_math(dfs, F, Window, E):
    c = F.col
    ss = dfs["store_sales"].filter(c("ss_ticket_number") % 1000 == 0)

    def shift(cls, col, n):
        return F.Column(cls(col.expr, F.lit(n).expr))
    return ss.select(
        "ss_ticket_number", "ss_item_sk",
        c("ss_item_sk").bitwiseAND(255).alias("band"),
        c("ss_customer_sk").bitwiseOR(c("ss_item_sk")).alias("bor"),
        c("ss_store_sk").bitwiseXOR(c("ss_ticket_number")).alias("bxor"),
        shift(E.ShiftLeft, c("ss_item_sk"), 40).alias("shl"),
        shift(E.ShiftRight, c("ss_ticket_number"), 3).alias("shr"),
        shift(E.ShiftRightUnsigned, -c("ss_customer_sk"), 60).alias("shru"),
        F.atan2(c("ss_sales_price"), c("ss_list_price")).alias("at2"),
        F.log_base(2.0, c("ss_net_paid")).alias("lg"),
        F.sinh(c("ss_sales_price") / 100).alias("sh"),
        F.cosh(c("ss_list_price") / 100).alias("ch"),
        F.tanh(c("ss_net_profit") / 1000).alias("th"),
        F.asinh(c("ss_net_profit")).alias("ash"),
        F.acosh(c("ss_list_price") + 1).alias("ach"),
        F.atanh(c("ss_sales_price") / 300).alias("ath"),
        F.cot(c("ss_quantity")).alias("ct"),
        F.cbrt(c("ss_net_profit")).alias("cb"),
    ).sort("ss_ticket_number", "ss_item_sk")


DATAFRAME = {
    "initcap_rlike": _item_strings,
    "date_parts": _date_parts,
    "framed_first_last": _first_last,
    "bitwise_math": _bitwise_math,
}

#: the queries whose doubles come from libm calls (held to a few ulps
#: between two devices, not bit for bit)
TRANSCENDENTAL = {"bitwise_math"}

#: the columns the queries read, per table, and the sales facts' item keys
#: (which their views are hash-partitioned on)
COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                    "ss_store_sk", "ss_ticket_number", "ss_quantity",
                    "ss_list_price", "ss_sales_price", "ss_net_paid",
                    "ss_net_profit"],
    "item": ["i_item_sk", "i_item_desc", "i_brand"],
    "date_dim": ["d_date_sk", "d_date", "d_year", "d_moy", "d_month_seq"],
    "customer": ["c_customer_sk", "c_first_name", "c_last_name"],
    "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                      "cs_item_sk"],
    "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk"],
}
