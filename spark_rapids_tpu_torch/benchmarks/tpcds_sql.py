"""TPC-DS queries as raw SQL text through the SQL frontend.

Reference analog: TpcdsLikeSpark.scala runs every TPC-DS query as SQL text
through Catalyst (TpcdsLikeSpark.scala:761 onward). This module carries the
same queries as SQL for THIS engine's frontend, written against the exact
constants of the DataFrame translations in benchmarks/tpcds_queries.py (which
adapt the public spec's parameters to the generator's calendar and pools) —
so `sess.sql(SQL_QUERIES[q])` must produce results identical to
`QUERIES[q](dfs)`, the fidelity bar Catalyst gets for free.

Queries are standard TPC-DS SQL shapes: star joins over channel fact tables,
derived tables, CTEs, window functions, ROLLUP, and correlated/scalar
subqueries — exercising the full frontend surface.
"""

SQL_QUERIES = {
    "q3": """
select d_year, i_brand_id as brand_id, i_brand as brand, sum_agg
from (select d_year, i_brand, i_brand_id,
             sum(ss_ext_sales_price) as sum_agg
      from date_dim, store_sales, item
      where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and d_moy = 11 and i_manufact_id = 128
      group by d_year, i_brand, i_brand_id) x
order by d_year, sum_agg desc, brand_id
limit 100
""",
    "q7": """
select i_item_id,
       avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, date_dim, item, customer_demographics, promotion
where ss_sold_date_sk = d_date_sk and d_year = 2000
  and ss_item_sk = i_item_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and ss_promo_sk = p_promo_sk
  and (p_channel_email = 'N' or p_channel_event = 'N')
group by i_item_id
order by i_item_id
limit 100
""",
    "q19": """
select i_brand_id as brand_id, i_brand as brand, i_manufact_id, i_manufact,
       ext_price
from (select i_brand, i_brand_id, i_manufact_id, i_manufact,
             sum(ss_ext_sales_price) as ext_price
      from date_dim, store_sales, item, customer, customer_address, store
      where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and d_moy = 11 and d_year = 1998 and i_manager_id = 8
        and ss_customer_sk = c_customer_sk
        and c_current_addr_sk = ca_address_sk
        and ss_store_sk = s_store_sk
        and substring(ca_zip, 1, 5) <> substring(s_zip, 1, 5)
      group by i_brand, i_brand_id, i_manufact_id, i_manufact) x
order by ext_price desc, brand, brand_id, i_manufact_id, i_manufact
limit 100
""",
    "q34": """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (d_dom between 1 and 3 or d_dom between 25 and 28)
        and d_year in (1999, 2000, 2001)
        and hd_buy_potential in ('>10000', 'unknown')
        and hd_vehicle_count > 0
        and (case when hd_vehicle_count > 0
                  then hd_dep_count / hd_vehicle_count
                  else null end) > 1.2
        and s_county = 'Williamson County'
      group by ss_ticket_number, ss_customer_sk) dn, customer
where ss_customer_sk = c_customer_sk and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number
""",
    "q42": """
select d_year, i_category_id, i_category, sum(ss_ext_sales_price) as s
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and d_moy = 11 and d_year = 2000 and i_manager_id = 1
group by d_year, i_category_id, i_category
order by s desc, d_year, i_category_id, i_category
limit 100
""",
    "q46": """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, ss_addr_sk,
             ca_city as bought_city,
             sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and d_dow in (5, 6) and d_year in (1999, 2000, 2001)
        and s_city in ('Fairview', 'Midway')
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
limit 100
""",
    "q52": """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and d_moy = 11 and d_year = 2000 and i_manager_id = 1
group by d_year, i_brand, i_brand_id
order by d_year, ext_price desc, brand_id
limit 100
""",
    "q55": """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and d_moy = 11 and d_year = 1999 and i_manager_id = 28
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100
""",
    "q16": """
select count(distinct cs_order_number) as order_count,
       sum(cs_ext_ship_cost) as total_shipping_cost,
       sum(cs_net_profit) as total_net_profit
from catalog_sales, date_dim, customer_address, call_center
where cs_ship_date_sk = d_date_sk
  and d_date between date '2002-02-01' and date '2002-04-02'
  and cs_ship_addr_sk = ca_address_sk and ca_state = 'GA'
  and cs_call_center_sk = cc_call_center_sk
  and cc_county = 'Williamson County'
  and exists (select *
              from (select cs_order_number as o2,
                           count(distinct cs_warehouse_sk) as nw
                    from catalog_sales
                    where cs_warehouse_sk is not null
                    group by cs_order_number) m
              where m.o2 = cs_order_number and m.nw >= 2)
  and not exists (select * from catalog_returns
                  where cr_order_number = cs_order_number)
""",
    "q94": """
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales, date_dim, customer_address, web_site
where ws_ship_date_sk = d_date_sk
  and d_date between date '1999-02-01' and date '1999-04-02'
  and ws_ship_addr_sk = ca_address_sk and ca_state = 'GA'
  and ws_web_site_sk = web_site_sk
  and web_company_name = 'pri'
  and exists (select *
              from (select ws_order_number as o2,
                           count(distinct ws_warehouse_sk) as nw
                    from web_sales
                    where ws_warehouse_sk is not null
                    group by ws_order_number) m
              where m.o2 = ws_order_number and m.nw >= 2)
  and not exists (select * from web_returns
                  where wr_order_number = ws_order_number)
""",
    "q20": """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue,
       itemrevenue * 100.0 / sum(itemrevenue)
           over (partition by i_class) as revenueratio
from (select i_item_id, i_item_desc, i_category, i_class, i_current_price,
             sum(cs_ext_sales_price) as itemrevenue
      from catalog_sales, item, date_dim
      where cs_item_sk = i_item_sk
        and i_category in ('Sports', 'Books', 'Home')
        and cs_sold_date_sk = d_date_sk
        and d_date between date '1999-02-22' and date '1999-03-24'
      group by i_item_id, i_item_desc, i_category, i_class,
               i_current_price) base
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    "q21": """
select w_warehouse_name, i_item_id, inv_before, inv_after
from (select w_warehouse_name, i_item_id,
             sum(case when d_date < date '2000-03-11'
                      then inv_quantity_on_hand else 0 end) as inv_before,
             sum(case when d_date >= date '2000-03-11'
                      then inv_quantity_on_hand else 0 end) as inv_after
      from inventory, warehouse, item, date_dim
      where inv_warehouse_sk = w_warehouse_sk and inv_item_sk = i_item_sk
        and inv_date_sk = d_date_sk
        and i_current_price between 0.99 and 1.49
        and datediff(d_date, date '2000-03-11') between -30 and 30
      group by w_warehouse_name, i_item_id) x
where (case when inv_before > 0 then inv_after / inv_before else null end)
      >= 2.0 / 3.0
  and (case when inv_before > 0 then inv_after / inv_before else null end)
      <= 3.0 / 2.0
order by w_warehouse_name, i_item_id
limit 100
""",
    "q25": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, date_dim, item, store, store_returns d2, catalog_sales
where ss_sold_date_sk = d_date_sk and d_moy = 4 and d_year = 2001
  and ss_item_sk = i_item_sk and ss_store_sk = s_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk in
      (select d_date_sk from date_dim
       where d_moy between 4 and 10 and d_year = 2001)
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk in
      (select d_date_sk from date_dim
       where d_moy between 4 and 10 and d_year = 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    "q29": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, date_dim, item, store, store_returns d2, catalog_sales
where ss_sold_date_sk = d_date_sk and d_moy = 9 and d_year = 1999
  and ss_item_sk = i_item_sk and ss_store_sk = s_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk in
      (select d_date_sk from date_dim
       where d_moy between 9 and 12 and d_year = 1999)
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk in
      (select d_date_sk from date_dim
       where d_year in (1999, 2000, 2001))
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    "q26": """
select i_item_id,
       avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4
from catalog_sales, date_dim, item, customer_demographics, promotion
where cs_sold_date_sk = d_date_sk and d_year = 2000
  and cs_item_sk = i_item_sk and cs_bill_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and cs_promo_sk = p_promo_sk
  and (p_channel_email = 'N' or p_channel_event = 'N')
group by i_item_id
order by i_item_id
limit 100
""",
    "q32": """
select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 77 and i_item_sk = cs_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt >
      (select 1.3 * avg(cs_ext_discount_amt)
       from catalog_sales, date_dim
       where cs_item_sk = i_item_sk and d_date_sk = cs_sold_date_sk
         and d_date between date '2000-01-27' and date '2000-04-26')
""",
    "q92": """
select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 50 and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt >
      (select 1.3 * avg(ws_ext_discount_amt)
       from web_sales, date_dim
       where ws_item_sk = i_item_sk and d_date_sk = ws_sold_date_sk
         and d_date between date '2000-01-27' and date '2000-04-26')
""",
    "q43": """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end)
           as sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end)
           as mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null
           end) as tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null
           end) as wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null
           end) as thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null
           end) as fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null
           end) as sat_sales
from store_sales, date_dim, store
where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
  and d_year = 2000 and s_gmt_offset = -5.0
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100
""",
    "q65": """
with base as (
  select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
  group by ss_store_sk, ss_item_sk),
avg_rev as (
  select ss_store_sk as sb_store_sk, avg(revenue) as ave
  from base group by ss_store_sk)
select s_store_name, i_item_desc, revenue, i_current_price,
       i_wholesale_cost, i_brand
from base, avg_rev, store, item
where ss_store_sk = sb_store_sk and revenue <= ave * 0.1
  and ss_store_sk = s_store_sk and ss_item_sk = i_item_sk
order by s_store_name, i_item_desc
limit 100
""",
    "q68": """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ss_addr_sk,
             ca_city as bought_city,
             sum(ss_ext_sales_price) as extended_price,
             sum(ss_ext_list_price) as list_price,
             sum(ss_ext_tax) as extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2 and d_year in (1999, 2000, 2001)
        and s_city in ('Midway', 'Fairview')
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
""",
    "q73": """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dom between 1 and 2 and d_year in (1999, 2000, 2001)
        and hd_buy_potential in ('>10000', 'unknown')
        and hd_vehicle_count > 0
        and (case when hd_vehicle_count > 0
                  then hd_dep_count / hd_vehicle_count
                  else null end) > 1
        and s_county in ('Williamson County', 'Franklin Parish',
                         'Bronx County', 'Orange County')
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_last_name
""",
    "q79": """
select c_last_name, c_first_name, substring(s_city, 1, 30) as city,
       ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city,
             sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dow = 1 and d_year in (1999, 2000, 2001)
        and s_number_employees between 200 and 295
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, city, profit desc
limit 100
""",
    "q89": """
select *
from (select i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum_sales, avg_monthly_sales
      from (select i_category, i_class, i_brand, s_store_name,
                   s_company_name, d_moy, sum_sales,
                   avg(sum_sales) over (partition by i_category, i_brand,
                                        s_store_name, s_company_name)
                       as avg_monthly_sales
            from (select i_category, i_class, i_brand, s_store_name,
                         s_company_name, d_moy,
                         sum(ss_sales_price) as sum_sales
                  from store_sales, item, date_dim, store
                  where ss_item_sk = i_item_sk
                    and ss_sold_date_sk = d_date_sk
                    and ss_store_sk = s_store_sk and d_year = 1999
                    and ((i_category in ('Books', 'Electronics', 'Sports')
                          and i_class in ('computers', 'stereo', 'football'))
                         or (i_category in ('Men', 'Jewelry', 'Women')
                             and i_class in ('shirts', 'birdal', 'dresses')))
                  group by i_category, i_class, i_brand, s_store_name,
                           s_company_name, d_moy) t1) t2
      where case when avg_monthly_sales <> 0.0
                 then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
                 else null end > 0.1
      order by sum_sales - avg_monthly_sales, s_store_name
      limit 100) t3
""",
    "q96": """
select count(*) as cnt
from store_sales, time_dim, household_demographics, store
where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20 and t_minute >= 30 and hd_dep_count = 7
  and s_store_name = 'ese'
""",
    "q98": """
select i_item_desc, i_category, i_class, i_current_price, itemrevenue,
       revenueratio
from (select i_item_id, i_item_desc, i_category, i_class, i_current_price,
             itemrevenue,
             itemrevenue * 100.0 / sum(itemrevenue)
                 over (partition by i_class) as revenueratio
      from (select i_item_id, i_item_desc, i_category, i_class,
                   i_current_price,
                   sum(ss_ext_sales_price) as itemrevenue
            from store_sales, item, date_dim
            where ss_item_sk = i_item_sk
              and i_category in ('Sports', 'Books', 'Home')
              and ss_sold_date_sk = d_date_sk
              and d_date between date '1999-02-22' and date '1999-03-24'
            group by i_item_id, i_item_desc, i_category, i_class,
                     i_current_price) base) x
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
""",
    "q15": """
select ca_zip, sum(cs_sales_price) as sum_sales_price
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and cs_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2001
  and (substring(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                   '86475', '85392', '85460', '80348',
                                   '81792')
       or ca_state in ('CA', 'WA', 'GA')
       or cs_sales_price > 500)
group by ca_zip
order by ca_zip
limit 100
""",
    "q37": """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim
where i_current_price between 68 and 98
  and i_manufact_id in (8, 33, 58, 83)
  and inv_item_sk = i_item_sk
  and inv_quantity_on_hand between 100 and 500
  and inv_date_sk = d_date_sk
  and d_date between date '2000-02-01' and date '2000-04-01'
  and exists (select * from catalog_sales where cs_item_sk = i_item_sk)
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    "q40": """
select w_state, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0.0)
                else 0.0 end) as sales_before,
       sum(case when d_date >= date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0.0)
                else 0.0 end) as sales_after
from catalog_sales left join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
     warehouse, item, date_dim
where cs_warehouse_sk = w_warehouse_sk and cs_item_sk = i_item_sk
  and i_current_price between 0.99 and 1.49
  and cs_sold_date_sk = d_date_sk
  and datediff(d_date, date '2000-03-11') between -30 and 30
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    "q45": """
select ca_zip, ca_city, sum(ws_sales_price) as sum_ws_sales_price
from web_sales, customer, customer_address, item, date_dim
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and ws_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
  and (substring(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                   '86475', '85392', '85460', '80348',
                                   '81792')
       or i_item_id in (select i_item_id from item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19,
                                            23, 29)))
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
""",
    "q62": """
select substring(w_warehouse_name, 1, 20) as wname, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30 then 1
                else 0 end) as d30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60 then 1
                else 0 end) as d31_60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                 and ws_ship_date_sk - ws_sold_date_sk <= 90 then 1
                else 0 end) as d61_90,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 90
                 and ws_ship_date_sk - ws_sold_date_sk <= 120 then 1
                else 0 end) as d91_120,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 120 then 1
                else 0 end) as d_over_120
from web_sales, date_dim, warehouse, ship_mode, web_site
where ws_ship_date_sk = d_date_sk
  and d_month_seq between 1200 and 1211
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by substring(w_warehouse_name, 1, 20), sm_type, web_name
order by wname, sm_type, web_name
limit 100
""",
    "q99": """
select substring(w_warehouse_name, 1, 20) as wname, sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30 then 1
                else 0 end) as d30,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
                 and cs_ship_date_sk - cs_sold_date_sk <= 60 then 1
                else 0 end) as d31_60,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
                 and cs_ship_date_sk - cs_sold_date_sk <= 90 then 1
                else 0 end) as d61_90,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 90
                 and cs_ship_date_sk - cs_sold_date_sk <= 120 then 1
                else 0 end) as d91_120,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 120 then 1
                else 0 end) as d_over_120
from catalog_sales, date_dim, warehouse, ship_mode, call_center
where cs_ship_date_sk = d_date_sk
  and d_month_seq between 1200 and 1211
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by substring(w_warehouse_name, 1, 20), sm_type, cc_name
order by wname, sm_type, cc_name
limit 100
""",
    "q90": """
select amc / pmc as am_pm_ratio
from (select count(*) as amc
      from web_sales, household_demographics, time_dim, web_page
      where ws_ship_hdemo_sk = hd_demo_sk and hd_dep_count = 6
        and ws_sold_time_sk = t_time_sk
        and t_hour between 8 and 9
        and ws_web_page_sk = wp_web_page_sk
        and wp_char_count between 5000 and 5200) at,
     (select count(*) as pmc
      from web_sales, household_demographics, time_dim, web_page
      where ws_ship_hdemo_sk = hd_demo_sk and hd_dep_count = 6
        and ws_sold_time_sk = t_time_sk
        and t_hour between 19 and 20
        and ws_web_page_sk = wp_web_page_sk
        and wp_char_count between 5000 and 5200) pt
""",
    "q93": """
select ss_customer_sk, sum(act_sales) as sumsales
from (select ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end as act_sales,
             sr_reason_sk
      from store_sales left join store_returns
             on ss_item_sk = sr_item_sk
            and ss_ticket_number = sr_ticket_number) x, reason
where sr_reason_sk = r_reason_sk
  and r_reason_desc = 'Package was damaged'
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
""",
    "q13": """
select avg(ss_quantity) as avg_quantity,
       avg(ss_ext_sales_price) as avg_ext_sales_price,
       avg(ss_ext_wholesale_cost) as avg_ext_wholesale,
       sum(ss_ext_wholesale_cost) as sum_ext_wholesale
from store_sales, store, date_dim, customer_demographics,
     household_demographics, customer_address
where ss_store_sk = s_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ss_cdemo_sk = cd_demo_sk and ss_hdemo_sk = hd_demo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M' and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.0 and 150.0 and hd_dep_count = 3)
       or (cd_marital_status = 'S' and cd_education_status = 'College'
           and ss_sales_price between 50.0 and 100.0 and hd_dep_count = 1)
       or (cd_marital_status = 'W' and cd_education_status = '2 yr Degree'
           and ss_sales_price between 150.0 and 200.0 and hd_dep_count = 1))
  and ((ca_country = 'United States' and ca_state in ('TX', 'OH', 'GA')
        and ss_net_profit between 100 and 200)
       or (ca_country = 'United States' and ca_state in ('TN', 'IN', 'SD')
           and ss_net_profit between 150 and 300)
       or (ca_country = 'United States' and ca_state in ('LA', 'MI', 'SC')
           and ss_net_profit between 50 and 250))
""",
    "q17": """
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev(ss_quantity) as store_sales_quantitystdev,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev(sr_return_quantity) as store_returns_quantitystdev,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev(cs_quantity) as catalog_sales_quantitystdev,
       stddev(ss_quantity) / avg(ss_quantity) as store_sales_quantitycov,
       stddev(sr_return_quantity) / avg(sr_return_quantity)
           as store_returns_quantitycov,
       stddev(cs_quantity) / avg(cs_quantity) as catalog_sales_quantitycov
from store_sales, date_dim, item, store, store_returns, catalog_sales
where ss_sold_date_sk = d_date_sk and d_quarter_name = '2001Q1'
  and ss_item_sk = i_item_sk and ss_store_sk = s_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk in
      (select d_date_sk from date_dim
       where d_quarter_name in ('2001Q1', '2001Q2', '2001Q3'))
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk in
      (select d_date_sk from date_dim
       where d_quarter_name in ('2001Q1', '2001Q2', '2001Q3'))
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""",
    "q28": """
select *
from (select avg(ss_list_price) as b1_lp, count(ss_list_price) as b1_cnt,
             count(distinct ss_list_price) as b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 8 and 18
             or ss_coupon_amt between 459 and 1459
             or ss_wholesale_cost between 57 and 77)) b1,
     (select avg(ss_list_price) as b2_lp, count(ss_list_price) as b2_cnt,
             count(distinct ss_list_price) as b2_cntd
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 90 and 100
             or ss_coupon_amt between 2323 and 3323
             or ss_wholesale_cost between 31 and 51)) b2,
     (select avg(ss_list_price) as b3_lp, count(ss_list_price) as b3_cnt,
             count(distinct ss_list_price) as b3_cntd
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 142 and 152
             or ss_coupon_amt between 12214 and 13214
             or ss_wholesale_cost between 79 and 99)) b3,
     (select avg(ss_list_price) as b4_lp, count(ss_list_price) as b4_cnt,
             count(distinct ss_list_price) as b4_cntd
      from store_sales
      where ss_quantity between 16 and 20
        and (ss_list_price between 135 and 145
             or ss_coupon_amt between 6071 and 7071
             or ss_wholesale_cost between 38 and 58)) b4,
     (select avg(ss_list_price) as b5_lp, count(ss_list_price) as b5_cnt,
             count(distinct ss_list_price) as b5_cntd
      from store_sales
      where ss_quantity between 21 and 25
        and (ss_list_price between 122 and 132
             or ss_coupon_amt between 836 and 1836
             or ss_wholesale_cost between 17 and 37)) b5,
     (select avg(ss_list_price) as b6_lp, count(ss_list_price) as b6_cnt,
             count(distinct ss_list_price) as b6_cntd
      from store_sales
      where ss_quantity between 26 and 30
        and (ss_list_price between 154 and 164
             or ss_coupon_amt between 7326 and 8326
             or ss_wholesale_cost between 7 and 27)) b6
limit 100
""",
    "q33": """
with subset as (
  select distinct i_manufact_id as sub_key from item
  where i_category in ('Electronics')),
dd as (select d_date_sk from date_dim where d_year = 1998 and d_moy = 5),
addr as (select ca_address_sk from customer_address
         where ca_gmt_offset = -5.0),
ss as (
  select i_manufact_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, item
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk in (select d_date_sk from dd)
    and ss_addr_sk in (select ca_address_sk from addr)
    and i_manufact_id in (select sub_key from subset)
  group by i_manufact_id),
cs as (
  select i_manufact_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, item
  where cs_item_sk = i_item_sk
    and cs_sold_date_sk in (select d_date_sk from dd)
    and cs_bill_addr_sk in (select ca_address_sk from addr)
    and i_manufact_id in (select sub_key from subset)
  group by i_manufact_id),
ws as (
  select i_manufact_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, item
  where ws_item_sk = i_item_sk
    and ws_sold_date_sk in (select d_date_sk from dd)
    and ws_bill_addr_sk in (select ca_address_sk from addr)
    and i_manufact_id in (select sub_key from subset)
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) u
group by i_manufact_id
order by total_sales
limit 100
""",
    "q60": """
with subset as (
  select distinct i_item_id as sub_key from item
  where i_category in ('Music')),
dd as (select d_date_sk from date_dim where d_year = 1998 and d_moy = 9),
addr as (select ca_address_sk from customer_address
         where ca_gmt_offset = -5.0),
ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, item
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk in (select d_date_sk from dd)
    and ss_addr_sk in (select ca_address_sk from addr)
    and i_item_id in (select sub_key from subset)
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, item
  where cs_item_sk = i_item_sk
    and cs_sold_date_sk in (select d_date_sk from dd)
    and cs_bill_addr_sk in (select ca_address_sk from addr)
    and i_item_id in (select sub_key from subset)
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, item
  where ws_item_sk = i_item_sk
    and ws_sold_date_sk in (select d_date_sk from dd)
    and ws_bill_addr_sk in (select ca_address_sk from addr)
    and i_item_id in (select sub_key from subset)
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) u
group by i_item_id
order by i_item_id, total_sales
limit 100
""",
    "q86": """
select total_sum, i_category, i_class, lochierarchy, rank_within_parent
from (select total_sum, i_category, i_class, lochierarchy,
             rank() over (partition by lochierarchy, _parent
                          order by total_sum desc) as rank_within_parent
      from (select sum(ws_net_paid) as total_sum, i_category, i_class,
                   (case when i_category is null then 1 else 0 end
                    + case when i_class is null then 1 else 0 end)
                       as lochierarchy,
                   case when i_class is not null then i_category
                        else null end as _parent
            from web_sales, date_dim, item
            where ws_sold_date_sk = d_date_sk
              and d_month_seq between 1200 and 1211
              and ws_item_sk = i_item_sk
            group by rollup(i_category, i_class)) x) y
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category else null end,
         rank_within_parent
limit 100
""",
    "q12": """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue,
       itemrevenue * 100.0 / sum(itemrevenue)
           over (partition by i_class) as revenueratio
from (select i_item_id, i_item_desc, i_category, i_class, i_current_price,
             sum(ws_ext_sales_price) as itemrevenue
      from web_sales, item, date_dim
      where ws_item_sk = i_item_sk
        and i_category in ('Sports', 'Books', 'Home')
        and ws_sold_date_sk = d_date_sk
        and d_date between date '1999-02-22' and date '1999-03-24'
      group by i_item_id, i_item_desc, i_category, i_class,
               i_current_price) base
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    "q1": """
with customer_total_return as (
  select sr_customer_sk as ctr_customer_sk, sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk
  and s_state = 'TN'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    "q2": """
with wscs as (
  select d_week_seq,
         sum(case when d_day_name = 'Sunday' then sales_price else 0.0 end) as sun,
         sum(case when d_day_name = 'Monday' then sales_price else 0.0 end) as mon,
         sum(case when d_day_name = 'Tuesday' then sales_price else 0.0 end) as tue,
         sum(case when d_day_name = 'Wednesday' then sales_price else 0.0 end) as wed,
         sum(case when d_day_name = 'Thursday' then sales_price else 0.0 end) as thu,
         sum(case when d_day_name = 'Friday' then sales_price else 0.0 end) as fri,
         sum(case when d_day_name = 'Saturday' then sales_price else 0.0 end) as sat
  from (select ws_sold_date_sk as sold_date_sk,
               ws_ext_sales_price as sales_price from web_sales
        union all
        select cs_sold_date_sk as sold_date_sk,
               cs_ext_sales_price as sales_price from catalog_sales) x,
       date_dim
  where sold_date_sk = d_date_sk
  group by d_week_seq),
y as (
  select d_week_seq as wk1, sun as sun1, mon as mon1, tue as tue1,
         wed as wed1, thu as thu1, fri as fri1, sat as sat1
  from wscs
  where d_week_seq in (select distinct d_week_seq from date_dim
                       where d_year = 1999)),
z as (
  select d_week_seq - 53 as wk2, sun as sun2, mon as mon2, tue as tue2,
         wed as wed2, thu as thu2, fri as fri2, sat as sat2
  from wscs
  where d_week_seq in (select distinct d_week_seq from date_dim
                       where d_year = 2000))
select wk1 as d_week_seq,
       round(case when sun2 <> 0 then sun1 / sun2 else null end, 2) as r_sun,
       round(case when mon2 <> 0 then mon1 / mon2 else null end, 2) as r_mon,
       round(case when tue2 <> 0 then tue1 / tue2 else null end, 2) as r_tue,
       round(case when wed2 <> 0 then wed1 / wed2 else null end, 2) as r_wed,
       round(case when thu2 <> 0 then thu1 / thu2 else null end, 2) as r_thu,
       round(case when fri2 <> 0 then fri1 / fri2 else null end, 2) as r_fri,
       round(case when sat2 <> 0 then sat1 / sat2 else null end, 2) as r_sat
from y, z
where wk1 = wk2
order by d_week_seq
""",
    "q4": """
with s1 as (
  select c_customer_id as s1_id,
         sum((ss_ext_list_price - ss_ext_wholesale_cost - ss_ext_discount_amt
              + ss_ext_sales_price) / 2) as s1_total,
         first(c_preferred_cust_flag) as s1_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 1999
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
s2 as (
  select c_customer_id as s2_id,
         sum((ss_ext_list_price - ss_ext_wholesale_cost - ss_ext_discount_amt
              + ss_ext_sales_price) / 2) as s2_total,
         first(c_preferred_cust_flag) as s2_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 2000
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
c1 as (
  select c_customer_id as c1_id,
         sum((cs_ext_list_price - cs_ext_wholesale_cost - cs_ext_discount_amt
              + cs_ext_sales_price) / 2) as c1_total,
         first(c_preferred_cust_flag) as c1_flag
  from catalog_sales, date_dim, customer
  where cs_sold_date_sk = d_date_sk and d_year = 1999
    and cs_bill_customer_sk = c_customer_sk
  group by c_customer_id),
c2 as (
  select c_customer_id as c2_id,
         sum((cs_ext_list_price - cs_ext_wholesale_cost - cs_ext_discount_amt
              + cs_ext_sales_price) / 2) as c2_total,
         first(c_preferred_cust_flag) as c2_flag
  from catalog_sales, date_dim, customer
  where cs_sold_date_sk = d_date_sk and d_year = 2000
    and cs_bill_customer_sk = c_customer_sk
  group by c_customer_id),
w1 as (
  select c_customer_id as w1_id,
         sum((ws_ext_list_price - ws_ext_wholesale_cost - ws_ext_discount_amt
              + ws_ext_sales_price) / 2) as w1_total,
         first(c_preferred_cust_flag) as w1_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 1999
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id),
w2 as (
  select c_customer_id as w2_id,
         sum((ws_ext_list_price - ws_ext_wholesale_cost - ws_ext_discount_amt
              + ws_ext_sales_price) / 2) as w2_total,
         first(c_preferred_cust_flag) as w2_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 2000
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id)
select s1_id as customer_id, s2_flag as customer_preferred_cust_flag
from s1, s2, c1, c2, w1, w2
where s1_total > 0 and s1_id = s2_id
  and c1_total > 0 and s1_id = c1_id and s1_id = c2_id
  and w1_total > 0 and s1_id = w1_id and s1_id = w2_id
  and c2_total / c1_total > s2_total / s1_total
  and c2_total / c1_total > w2_total / w1_total
order by customer_id
limit 100
""",
    "q74": """
with s1 as (
  select c_customer_id as s1_id, sum(ss_net_paid) as s1_total,
         first(c_preferred_cust_flag) as s1_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 1999
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
s2 as (
  select c_customer_id as s2_id, sum(ss_net_paid) as s2_total,
         first(c_preferred_cust_flag) as s2_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 2000
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
w1 as (
  select c_customer_id as w1_id, sum(ws_net_paid) as w1_total,
         first(c_preferred_cust_flag) as w1_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 1999
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id),
w2 as (
  select c_customer_id as w2_id, sum(ws_net_paid) as w2_total,
         first(c_preferred_cust_flag) as w2_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 2000
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id)
select s1_id as customer_id
from s1, s2, w1, w2
where s1_total > 0 and s1_id = s2_id
  and w1_total > 0 and s1_id = w1_id and s1_id = w2_id
  and w2_total / w1_total > s2_total / s1_total
order by customer_id
limit 100
""",
    "q5": """
with ssr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select ss_store_sk as sid, sum(ss_ext_sales_price) as sales,
               sum(ss_net_profit) as profit
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-14'
        group by ss_store_sk) s
  left join (select sr_store_sk as sid_r, sum(sr_return_amt) as returns_amt,
                    sum(sr_net_loss) as net_loss
             from store_returns, date_dim
             where sr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-14'
             group by sr_store_sk) r
  on s.sid = r.sid_r),
csr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select cs_catalog_page_sk as sid, sum(cs_ext_sales_price) as sales,
               sum(cs_net_profit) as profit
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-14'
        group by cs_catalog_page_sk) s
  left join (select cr_catalog_page_sk as sid_r,
                    sum(cr_return_amount) as returns_amt,
                    sum(cr_net_loss) as net_loss
             from catalog_returns, date_dim
             where cr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-14'
             group by cr_catalog_page_sk) r
  on s.sid = r.sid_r),
wsr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select ws_web_site_sk as sid, sum(ws_ext_sales_price) as sales,
               sum(ws_net_profit) as profit
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-14'
        group by ws_web_site_sk) s
  left join (select wr_web_page_sk as sid_r, sum(wr_return_amt) as returns_amt,
                    sum(wr_net_loss) as net_loss
             from web_returns, date_dim
             where wr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-14'
             group by wr_web_page_sk) r
  on s.sid = r.sid_r)
select channel, sid, sum(sales) as sales, sum(returns_amt) as returns_amt,
       sum(profit) as profit
from (select 'store channel' as channel, sid, sales, returns_amt, profit
      from ssr
      union all
      select 'catalog channel' as channel, sid, sales, returns_amt, profit
      from csr
      union all
      select 'web channel' as channel, sid, sales, returns_amt, profit
      from wsr) x
group by rollup(channel, sid)
order by channel, sid
limit 100
""",
    "q6": """
select ca_state as state, count(*) as cnt
from store_sales, date_dim, customer, customer_address
where ss_sold_date_sk = d_date_sk
  and d_month_seq in (select distinct d_month_seq from date_dim
                      where d_year = 2001 and d_moy = 1)
  and ss_item_sk in (
    select i_item_sk
    from item, (select i_category as cat, avg(i_current_price) as cat_avg
                from item group by i_category) j
    where i_category = cat and i_current_price > 1.2 * cat_avg)
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
group by ca_state
having count(*) >= 10
order by cnt
limit 100
""",
    "q8": """
select s_store_name, sum(ss_net_profit) as net_profit
from store_sales, date_dim, store
where ss_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 1998
  and ss_store_sk = s_store_sk
  and substring(s_zip, 1, 5) in (
    select substring(ca_zip, 1, 5) as zip5
    from customer, customer_address
    where c_preferred_cust_flag = 'Y'
      and c_current_addr_sk = ca_address_sk
    group by substring(ca_zip, 1, 5)
    having count(*) > 10)
group by s_store_name
order by s_store_name
""",
    "q9": """
select case when cnt1 > 62316.685 then disc1 else paid1 end as bucket1,
       case when cnt2 > 62316.685 then disc2 else paid2 end as bucket2,
       case when cnt3 > 62316.685 then disc3 else paid3 end as bucket3,
       case when cnt4 > 62316.685 then disc4 else paid4 end as bucket4,
       case when cnt5 > 62316.685 then disc5 else paid5 end as bucket5
from reason,
     (select
        sum(case when ss_quantity between 1 and 20 then 1 else 0 end) as cnt1,
        avg(case when ss_quantity between 1 and 20
            then ss_ext_discount_amt else null end) as disc1,
        avg(case when ss_quantity between 1 and 20
            then ss_net_paid else null end) as paid1,
        sum(case when ss_quantity between 21 and 40 then 1 else 0 end) as cnt2,
        avg(case when ss_quantity between 21 and 40
            then ss_ext_discount_amt else null end) as disc2,
        avg(case when ss_quantity between 21 and 40
            then ss_net_paid else null end) as paid2,
        sum(case when ss_quantity between 41 and 60 then 1 else 0 end) as cnt3,
        avg(case when ss_quantity between 41 and 60
            then ss_ext_discount_amt else null end) as disc3,
        avg(case when ss_quantity between 41 and 60
            then ss_net_paid else null end) as paid3,
        sum(case when ss_quantity between 61 and 80 then 1 else 0 end) as cnt4,
        avg(case when ss_quantity between 61 and 80
            then ss_ext_discount_amt else null end) as disc4,
        avg(case when ss_quantity between 61 and 80
            then ss_net_paid else null end) as paid4,
        sum(case when ss_quantity between 81 and 100 then 1 else 0 end) as cnt5,
        avg(case when ss_quantity between 81 and 100
            then ss_ext_discount_amt else null end) as disc5,
        avg(case when ss_quantity between 81 and 100
            then ss_net_paid else null end) as paid5
      from store_sales) stats
where r_reason_sk = 1
""",
    "q10": """
select cd_gender, cd_marital_status, cd_education_status,
       cd_purchase_estimate, cd_credit_rating, count(*) as cnt
from customer, customer_address, customer_demographics
where c_current_addr_sk = ca_address_sk
  and ca_county in ('Williamson County', 'Walker County', 'Ziebach County')
  and c_customer_sk in (
    select ss_customer_sk from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
      and d_year = 2002 and d_moy between 1 and 4)
  and (c_customer_sk in (
         select ws_bill_customer_sk from web_sales, date_dim
         where ws_sold_date_sk = d_date_sk
           and d_year = 2002 and d_moy between 1 and 4)
       or c_customer_sk in (
         select cs_bill_customer_sk from catalog_sales, date_dim
         where cs_sold_date_sk = d_date_sk
           and d_year = 2002 and d_moy between 1 and 4))
  and c_current_cdemo_sk = cd_demo_sk
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
""",
    "q11": """
with s1 as (
  select c_customer_id as s1_id,
         sum(ss_ext_list_price - ss_ext_discount_amt) as s1_total,
         first(c_preferred_cust_flag) as s1_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 1999
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
s2 as (
  select c_customer_id as s2_id,
         sum(ss_ext_list_price - ss_ext_discount_amt) as s2_total,
         first(c_preferred_cust_flag) as s2_flag
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and d_year = 2000
    and ss_customer_sk = c_customer_sk
  group by c_customer_id),
w1 as (
  select c_customer_id as w1_id,
         sum(ws_ext_list_price - ws_ext_discount_amt) as w1_total,
         first(c_preferred_cust_flag) as w1_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 1999
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id),
w2 as (
  select c_customer_id as w2_id,
         sum(ws_ext_list_price - ws_ext_discount_amt) as w2_total,
         first(c_preferred_cust_flag) as w2_flag
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and d_year = 2000
    and ws_bill_customer_sk = c_customer_sk
  group by c_customer_id)
select s1_id as customer_id, s2_flag as customer_preferred_cust_flag
from s1, s2, w1, w2
where s1_total > 0 and s1_id = s2_id
  and w1_total > 0 and s1_id = w1_id and s1_id = w2_id
  and w2_total / w1_total > s2_total / s1_total
order by customer_id
limit 100
""",
    "q18": """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4,
       avg(cs_net_profit) as agg5, avg(c_birth_year) as agg6,
       avg(cd1_dep_count) as agg7
from catalog_sales, date_dim, item,
     (select cd_demo_sk as cd1_sk, cd_dep_count as cd1_dep_count
      from customer_demographics
      where cd_gender = 'F' and cd_education_status = 'Unknown') cd1,
     customer,
     (select cd_demo_sk as cd2_sk from customer_demographics) cd2,
     customer_address
where cs_sold_date_sk = d_date_sk and d_year = 1998
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd1_sk
  and cs_bill_customer_sk = c_customer_sk
  and c_birth_month in (1, 6, 8, 9, 12, 2)
  and c_current_cdemo_sk = cd2_sk
  and c_current_addr_sk = ca_address_sk
  and ca_state in ('TN', 'IN', 'SD', 'OH', 'TX', 'GA')
group by rollup(i_item_id, ca_country, ca_state, ca_county)
order by ca_country, ca_state, ca_county, i_item_id
limit 100
""",
    "q22": """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) as qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk
  and d_month_seq between 1200 and 1211
  and inv_item_sk = i_item_sk
group by rollup(i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name, i_brand, i_class, i_category
limit 100
""",
    "q23": """
with freq as (
  select item_sk from (
    select ss_item_sk as item_sk, count(distinct d_date_sk) as cnt
    from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
      and d_year in (1998, 1999, 2000, 2001)
    group by ss_item_sk) f
  where cnt > 4),
totals as (
  select ss_customer_sk as csk,
         sum(ss_quantity * ss_sales_price) as csales
  from store_sales
  group by ss_customer_sk),
best as (
  select csk from totals,
       (select max(csales) as tpcds_cmax from totals) m
  where csales > 0.5 * tpcds_cmax)
select sum(v) as total
from (select cs_quantity * cs_list_price as v
      from catalog_sales
      where cs_sold_date_sk in (select d_date_sk from date_dim
                                where d_year = 2000 and d_moy = 2)
        and cs_item_sk in (select item_sk from freq)
        and cs_bill_customer_sk in (select csk from best)
      union all
      select ws_quantity * ws_list_price as v
      from web_sales
      where ws_sold_date_sk in (select d_date_sk from date_dim
                                where d_year = 2000 and d_moy = 2)
        and ws_item_sk in (select item_sk from freq)
        and ws_bill_customer_sk in (select csk from best)) x
""",
    "q24": """
with ssales as (
  select c_last_name, c_first_name, s_store_name, i_color,
         sum(ss_net_paid) as netpaid
  from store_sales, store_returns, store, item, customer
  where ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
    and ss_store_sk = s_store_sk and ss_item_sk = i_item_sk
    and ss_customer_sk = c_customer_sk
  group by c_last_name, c_first_name, s_store_name, i_color)
select c_last_name, c_first_name, s_store_name, netpaid
from ssales, (select avg(netpaid) * 0.05 as thr from ssales) a
where i_color = 'blue' and netpaid > thr
order by c_last_name, c_first_name, s_store_name
""",
    "q27": """
select i_item_id, s_state,
       avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, date_dim, store, customer_demographics, item
where ss_sold_date_sk = d_date_sk and d_year = 2002
  and ss_store_sk = s_store_sk and s_state in ('TN', 'GA', 'SD')
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and ss_item_sk = i_item_sk
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
limit 100
""",
    "q30": """
with ctr as (
  select wr_returning_customer_sk as ctr_cust, ca_state as ctr_state,
         sum(wr_return_amt) as ctr_total
  from web_returns, date_dim, customer, customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2000
    and wr_returning_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name, ctr_total
from ctr ctr1, customer
where ctr1.ctr_total > (select avg(ctr_total) * 1.2 from ctr ctr2
                        where ctr1.ctr_state = ctr2.ctr_state)
  and ctr1.ctr_cust = c_customer_sk
  and c_current_addr_sk in (select ca_address_sk from customer_address
                            where ca_state = 'GA')
order by c_customer_id, c_salutation, c_first_name, c_last_name, ctr_total
""",
    "q31": """
with ss1 as (
  select ca_county as ss1_county, sum(ss_ext_sales_price) as ss1_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk and d_year = 2000 and d_qoy = 1
    and ss_addr_sk = ca_address_sk
  group by ca_county),
ss2 as (
  select ca_county as ss2_county, sum(ss_ext_sales_price) as ss2_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk and d_year = 2000 and d_qoy = 2
    and ss_addr_sk = ca_address_sk
  group by ca_county),
ws1 as (
  select ca_county as ws1_county, sum(ws_ext_sales_price) as ws1_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk and d_year = 2000 and d_qoy = 1
    and ws_bill_addr_sk = ca_address_sk
  group by ca_county),
ws2 as (
  select ca_county as ws2_county, sum(ws_ext_sales_price) as ws2_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk and d_year = 2000 and d_qoy = 2
    and ws_bill_addr_sk = ca_address_sk
  group by ca_county)
select ss1_county as county, ws2_sales / ws1_sales as web_g,
       ss2_sales / ss1_sales as store_g
from ss1, ss2, ws1, ws2
where ss1_county = ss2_county and ss1_county = ws1_county
  and ss1_county = ws2_county
  and ws1_sales > 0 and ss1_sales > 0
  and ws2_sales / ws1_sales > ss2_sales / ss1_sales
order by county
""",
    "q35": """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) as cnt, min(cd_dep_count) as mn, max(cd_dep_count) as mx,
       avg(cd_dep_count) as av
from customer, customer_address, customer_demographics
where c_customer_sk in (
    select ss_customer_sk from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk and d_year = 2002 and d_qoy < 4)
  and (c_customer_sk in (
         select ws_bill_customer_sk from web_sales, date_dim
         where ws_sold_date_sk = d_date_sk and d_year = 2002 and d_qoy < 4)
       or c_customer_sk in (
         select cs_bill_customer_sk from catalog_sales, date_dim
         where cs_sold_date_sk = d_date_sk and d_year = 2002 and d_qoy < 4))
  and c_current_addr_sk = ca_address_sk
  and c_current_cdemo_sk = cd_demo_sk
group by ca_state, cd_gender, cd_marital_status, cd_dep_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count
limit 100
""",
    "q38": """
select count(*) as cnt
from (select distinct c_last_name, c_first_name
      from store_sales, customer
      where ss_sold_date_sk in (select d_date_sk from date_dim
                                where d_month_seq between 1200 and 1211)
        and ss_customer_sk = c_customer_sk) s
     left semi join
     (select distinct c_last_name as cl, c_first_name as cf
      from catalog_sales, customer
      where cs_sold_date_sk in (select d_date_sk from date_dim
                                where d_month_seq between 1200 and 1211)
        and cs_bill_customer_sk = c_customer_sk) c
     on c_last_name = cl and c_first_name = cf
     left semi join
     (select distinct c_last_name as wl, c_first_name as wf
      from web_sales, customer
      where ws_sold_date_sk in (select d_date_sk from date_dim
                                where d_month_seq between 1200 and 1211)
        and ws_bill_customer_sk = c_customer_sk) w
     on c_last_name = wl and c_first_name = wf
""",
    "q39": """
with inv as (
  select w_warehouse_sk, i_item_sk, d_moy,
         stddev(inv_quantity_on_hand) / avg(inv_quantity_on_hand) as cov,
         avg(inv_quantity_on_hand) as mean
  from inventory, date_dim, item, warehouse
  where inv_date_sk = d_date_sk and d_year = 2001 and d_moy in (1, 2)
    and inv_item_sk = i_item_sk
    and inv_warehouse_sk = w_warehouse_sk
  group by w_warehouse_sk, i_item_sk, d_moy),
qualified as (
  select w_warehouse_sk, i_item_sk, d_moy, mean, cov
  from inv
  where mean <> 0 and cov > 1.0)
select a.w1 as w1, a.i1 as i1, a.mean1 as mean1, a.cov1 as cov1,
       b.mean2 as mean2, b.cov2 as cov2
from (select w_warehouse_sk as w1, i_item_sk as i1, mean as mean1,
             cov as cov1 from qualified where d_moy = 1) a,
     (select w_warehouse_sk as w2, i_item_sk as i2, mean as mean2,
             cov as cov2 from qualified where d_moy = 2) b
where a.w1 = b.w2 and a.i1 = b.i2
order by w1, i1
""",
    "q41": """
select distinct i_product_name
from item
where i_manufact_id between 38 and 78
  and i_manufact in (
    select i_manufact from item
    where (i_category = 'Women' and i_color in ('powder', 'khaki')
           and i_units in ('Ounce', 'Oz')
           and i_size in ('medium', 'extra large'))
       or (i_category = 'Women' and i_color in ('brown', 'honeydew')
           and i_units in ('Bunch', 'Ton') and i_size in ('N/A', 'small'))
       or (i_category = 'Men' and i_color in ('floral', 'deep')
           and i_units in ('N/A', 'Dozen') and i_size in ('petite', 'large'))
       or (i_category = 'Men' and i_color in ('light', 'cornflower')
           and i_units in ('Box', 'Pound')
           and i_size in ('medium', 'extra large'))
       or (i_category = 'Women' and i_color in ('midnight', 'snow')
           and i_units in ('Pallet', 'Gross')
           and i_size in ('medium', 'extra large'))
       or (i_category = 'Women' and i_color in ('cyan', 'papaya')
           and i_units in ('Cup', 'Dram') and i_size in ('N/A', 'small'))
       or (i_category = 'Men' and i_color in ('orange', 'frosted')
           and i_units in ('Each', 'Tbl') and i_size in ('petite', 'large'))
       or (i_category = 'Men' and i_color in ('forest', 'ghost')
           and i_units in ('Lb', 'Bundle')
           and i_size in ('medium', 'extra large')))
order by i_product_name
limit 100
""",
    "q44": """
with qualified as (
  select item_sk, rank_col
  from (select ss_item_sk as item_sk, avg(ss_net_profit) as rank_col
        from store_sales where ss_store_sk = 4 group by ss_item_sk) base,
       (select f_avg * 0.9 as floor_val
        from (select avg(ss_net_profit) as f_avg
              from store_sales
              where ss_store_sk = 4 and ss_addr_sk is null
              group by ss_store_sk) f) flr
  where rank_col > floor_val),
asc_r as (
  select item_sk, rank() over (order by rank_col asc) as rnk
  from qualified),
desc_r as (
  select item_sk as item_sk_d, rank() over (order by rank_col desc) as rnk_d
  from qualified)
select rnk, i1.i_product_name as best_performing,
       i2.i_product_name as worst_performing
from asc_r, desc_r, item i1, item i2
where rnk < 11 and rnk_d < 11 and rnk = rnk_d
  and item_sk = i1.i_item_sk and item_sk_d = i2.i_item_sk
order by rnk
limit 100
""",
    "q47": """
with base as (
  select i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum(ss_sales_price) as sum_sales
  from store_sales, item, date_dim, store
  where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and (d_year = 1999 or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
    and ss_store_sk = s_store_sk
  group by i_category, i_brand, s_store_name, s_company_name, d_year, d_moy),
v1 as (
  select i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum_sales,
         avg(sum_sales) over (partition by i_category, i_brand, s_store_name,
                              s_company_name, d_year) as avg_monthly_sales,
         rank() over (partition by i_category, i_brand, s_store_name,
                      s_company_name
                      order by d_year, d_moy) as rn
  from base)
select v1.i_category as i_category, v1.i_brand as i_brand,
       v1.s_store_name as s_store_name, v1.s_company_name as s_company_name,
       v1.d_year as d_year, v1.d_moy as d_moy,
       v1.avg_monthly_sales as avg_monthly_sales, v1.sum_sales as sum_sales,
       v1_lag.sum_sales as psum, v1_lead.sum_sales as nsum
from v1, v1 v1_lag, v1 v1_lead
where v1.i_category = v1_lag.i_category and v1.i_brand = v1_lag.i_brand
  and v1.s_store_name = v1_lag.s_store_name
  and v1.s_company_name = v1_lag.s_company_name
  and v1.rn = v1_lag.rn + 1
  and v1.i_category = v1_lead.i_category and v1.i_brand = v1_lead.i_brand
  and v1.s_store_name = v1_lead.s_store_name
  and v1.s_company_name = v1_lead.s_company_name
  and v1.rn = v1_lead.rn - 1
  and v1.d_year = 1999
  and v1.avg_monthly_sales > 0
  and case when v1.avg_monthly_sales > 0
      then abs(v1.sum_sales - v1.avg_monthly_sales) / v1.avg_monthly_sales
      else null end > 0.1
order by v1.sum_sales - v1.avg_monthly_sales, s_store_name
limit 100
""",
    "q48": """
select sum(ss_quantity) as sum_quantity
from store_sales, store, date_dim, customer_demographics, customer_address
where ss_store_sk = s_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2000
  and ss_cdemo_sk = cd_demo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M' and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.0 and 150.0)
       or (cd_marital_status = 'D' and cd_education_status = '2 yr Degree'
           and ss_sales_price between 50.0 and 100.0)
       or (cd_marital_status = 'S' and cd_education_status = 'College'
           and ss_sales_price between 150.0 and 200.0))
  and ((ca_country = 'United States' and ca_state in ('TX', 'OH', 'GA')
        and ss_net_profit between 0 and 2000)
       or (ca_country = 'United States' and ca_state in ('TN', 'IN', 'SD')
           and ss_net_profit between 150 and 3000)
       or (ca_country = 'United States' and ca_state in ('LA', 'MI', 'CA')
           and ss_net_profit between 50 and 25000))
""",
    "q50": """
select s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(case when sr_returned_date_sk - ss_sold_date_sk <= 30
           then 1 else 0 end) as d30,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 30
                and sr_returned_date_sk - ss_sold_date_sk <= 60
           then 1 else 0 end) as d31_60,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 60
                and sr_returned_date_sk - ss_sold_date_sk <= 90
           then 1 else 0 end) as d61_90,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 90
                and sr_returned_date_sk - ss_sold_date_sk <= 120
           then 1 else 0 end) as d91_120,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 120
           then 1 else 0 end) as d_over_120
from store_sales, store_returns, date_dim, store
where ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and ss_customer_sk = sr_customer_sk
  and sr_returned_date_sk = d_date_sk and d_year = 2001 and d_moy = 8
  and ss_store_sk = s_store_sk
group by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
order by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
limit 100
""",
    "q53": """
with base as (
  select i_manufact_id, d_qoy, sum(ss_sales_price) as sum_sales
  from store_sales, item, date_dim, store
  where ss_item_sk = i_item_sk
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('personal', 'portable', 'reference', 'self-help')
          and i_brand in ('scholaramalgamalg #14', 'scholaramalgamalg #7',
                          'exportiunivamalg #9', 'scholaramalgamalg #9'))
         or (i_category in ('Women', 'Music', 'Men')
             and i_class in ('accessories', 'classical', 'fragrances',
                             'pants')
             and i_brand in ('amalgimporto #1', 'edu packscholar #1',
                             'exportiimporto #1', 'importoamalg #1')))
    and ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
    and ss_store_sk = s_store_sk
  group by i_manufact_id, d_qoy)
select i_manufact_id, sum_sales, avg_quarterly_sales
from (select i_manufact_id, sum_sales,
             avg(sum_sales) over (partition by i_manufact_id)
               as avg_quarterly_sales
      from base) tmp
where case when avg_quarterly_sales > 0
      then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
      else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
""",
    "q63": """
with base as (
  select i_manager_id, d_moy, sum(ss_sales_price) as sum_sales
  from store_sales, item, date_dim, store
  where ss_item_sk = i_item_sk
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('personal', 'portable', 'reference', 'self-help')
          and i_brand in ('scholaramalgamalg #14', 'scholaramalgamalg #7',
                          'exportiunivamalg #9', 'scholaramalgamalg #9'))
         or (i_category in ('Women', 'Music', 'Men')
             and i_class in ('accessories', 'classical', 'fragrances',
                             'pants')
             and i_brand in ('amalgimporto #1', 'edu packscholar #1',
                             'exportiimporto #1', 'importoamalg #1')))
    and ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
    and ss_store_sk = s_store_sk
  group by i_manager_id, d_moy)
select i_manager_id, sum_sales, avg_monthly_sales
from (select i_manager_id, sum_sales,
             avg(sum_sales) over (partition by i_manager_id)
               as avg_monthly_sales
      from base) tmp
where case when avg_monthly_sales > 0
      then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
      else null end > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales
limit 100
""",
    "q54": """
with my_customers as (
  select distinct cust
  from (select cs_sold_date_sk as sold, cs_item_sk as item,
               cs_bill_customer_sk as cust from catalog_sales
        union all
        select ws_sold_date_sk as sold, ws_item_sk as item,
               ws_bill_customer_sk as cust from web_sales) u
  where sold in (select d_date_sk from date_dim
                 where d_year = 1999 and d_moy = 5)
    and item in (select i_item_sk from item
                 where i_category = 'Women' and i_class = 'dresses')),
rev as (
  select ss_customer_sk as c, sum(ss_ext_sales_price) as revenue
  from store_sales
  where ss_customer_sk in (select cust from my_customers)
    and ss_sold_date_sk in (select d_date_sk from date_dim
                            where d_year = 1999 and d_moy in (6, 7, 8))
  group by ss_customer_sk)
select segment, count(*) as num_customers, segment * 50 as segment_base
from (select cast(floor(revenue / 50) as int) as segment from rev) seg
group by segment
order by segment, num_customers
limit 100
""",
    "q56": """
with ids as (
  select distinct i_item_id as f_item_id from item
  where i_color in ('blue', 'cyan', 'green')),
ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, date_dim, item
  where ss_sold_date_sk = d_date_sk and d_year = 2001 and d_moy in (2)
    and ss_item_sk = i_item_sk
    and i_item_id in (select f_item_id from ids)
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, date_dim, item
  where cs_sold_date_sk = d_date_sk and d_year = 2001 and d_moy in (2)
    and cs_item_sk = i_item_sk
    and i_item_id in (select f_item_id from ids)
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, date_dim, item
  where ws_sold_date_sk = d_date_sk and d_year = 2001 and d_moy in (2)
    and ws_item_sk = i_item_sk
    and i_item_id in (select f_item_id from ids)
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) x
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    "q57": """
with base as (
  select i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) as sum_sales
  from catalog_sales, item, date_dim, call_center
  where cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and (d_year = 1999 or (d_year = 1998 and d_moy = 12)
         or (d_year = 2000 and d_moy = 1))
    and cs_call_center_sk = cc_call_center_sk
  group by i_category, i_brand, cc_name, d_year, d_moy),
v1 as (
  select i_category, i_brand, cc_name, d_year, d_moy, sum_sales,
         avg(sum_sales) over (partition by i_category, i_brand, cc_name,
                              d_year) as avg_monthly_sales,
         rank() over (partition by i_category, i_brand, cc_name
                      order by d_year, d_moy) as rn
  from base)
select v1.i_category as i_category, v1.i_brand as i_brand,
       v1.cc_name as cc_name, v1.d_year as d_year, v1.d_moy as d_moy,
       v1.avg_monthly_sales as avg_monthly_sales, v1.sum_sales as sum_sales,
       v1_lag.sum_sales as psum, v1_lead.sum_sales as nsum
from v1, v1 v1_lag, v1 v1_lead
where v1.i_category = v1_lag.i_category and v1.i_brand = v1_lag.i_brand
  and v1.cc_name = v1_lag.cc_name and v1.rn = v1_lag.rn + 1
  and v1.i_category = v1_lead.i_category and v1.i_brand = v1_lead.i_brand
  and v1.cc_name = v1_lead.cc_name and v1.rn = v1_lead.rn - 1
  and v1.d_year = 1999
  and v1.avg_monthly_sales > 0
  and case when v1.avg_monthly_sales > 0
      then abs(v1.sum_sales - v1.avg_monthly_sales) / v1.avg_monthly_sales
      else null end > 0.1
order by v1.sum_sales - v1.avg_monthly_sales, cc_name
limit 100
""",
    "q58": """
with dates as (
  select d_date_sk from date_dim
  where d_week_seq in (select d_week_seq from date_dim
                       where d_date = date '2000-01-03')),
ss_items as (
  select i_item_id as ss_item_id, sum(ss_ext_sales_price) as ss_rev
  from store_sales, item
  where ss_sold_date_sk in (select d_date_sk from dates)
    and ss_item_sk = i_item_sk
  group by i_item_id),
cs_items as (
  select i_item_id as cs_item_id, sum(cs_ext_sales_price) as cs_rev
  from catalog_sales, item
  where cs_sold_date_sk in (select d_date_sk from dates)
    and cs_item_sk = i_item_sk
  group by i_item_id),
ws_items as (
  select i_item_id as ws_item_id, sum(ws_ext_sales_price) as ws_rev
  from web_sales, item
  where ws_sold_date_sk in (select d_date_sk from dates)
    and ws_item_sk = i_item_sk
  group by i_item_id)
select ss_item_id as item_id, ss_rev, cs_rev, ws_rev
from ss_items, cs_items, ws_items
where ss_item_id = cs_item_id and ss_item_id = ws_item_id
  and ss_rev between 0.9 * cs_rev and 1.1 * cs_rev
  and ss_rev between 0.9 * ws_rev and 1.1 * ws_rev
  and cs_rev between 0.9 * ss_rev and 1.1 * ss_rev
  and cs_rev between 0.9 * ws_rev and 1.1 * ws_rev
  and ws_rev between 0.9 * ss_rev and 1.1 * ss_rev
  and ws_rev between 0.9 * cs_rev and 1.1 * cs_rev
order by item_id, ss_rev
limit 100
""",
    "q61": """
select promotions, total, promotions / total * 100.0 as promo_pct
from (select sum(ss_ext_sales_price) as promotions
      from store_sales, date_dim, store, customer, customer_address, item,
           promotion
      where ss_sold_date_sk = d_date_sk and d_year = 1998 and d_moy = 11
        and ss_store_sk = s_store_sk and s_gmt_offset = -5.0
        and ss_customer_sk = c_customer_sk
        and c_current_addr_sk = ca_address_sk and ca_gmt_offset = -5.0
        and ss_item_sk = i_item_sk and i_category = 'Jewelry'
        and ss_promo_sk = p_promo_sk
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')) p,
     (select sum(ss_ext_sales_price) as total
      from store_sales, date_dim, store, customer, customer_address, item
      where ss_sold_date_sk = d_date_sk and d_year = 1998 and d_moy = 11
        and ss_store_sk = s_store_sk and s_gmt_offset = -5.0
        and ss_customer_sk = c_customer_sk
        and c_current_addr_sk = ca_address_sk and ca_gmt_offset = -5.0
        and ss_item_sk = i_item_sk and i_category = 'Jewelry') t
""",
    "q64": """
with cs_ui as (
  select ui_item from (
    select cs_item_sk as ui_item, sum(cs_ext_list_price) as sale,
           sum(cr_refunded_cash + cr_fee) as refund
    from catalog_sales, catalog_returns
    where cs_item_sk = cr_item_sk and cs_order_number = cr_order_number
    group by cs_item_sk) u
  where sale > 2 * refund),
y1 as (
  select i_product_name as y1_pn, s_store_name as y1_sn, s_zip as y1_zip,
         count(*) as y1_cnt, sum(ss_wholesale_cost) as y1_s1,
         sum(ss_list_price) as y1_s2, sum(ss_coupon_amt) as y1_s3
  from store_sales, store_returns, date_dim, store, item
  where ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number
    and ss_item_sk in (select ui_item from cs_ui)
    and ss_sold_date_sk = d_date_sk and d_year = 1999
    and ss_store_sk = s_store_sk
    and ss_item_sk = i_item_sk and i_current_price is not null
  group by i_product_name, s_store_name, s_zip),
y2 as (
  select i_product_name as y2_pn, s_store_name as y2_sn, s_zip as y2_zip,
         count(*) as y2_cnt, sum(ss_wholesale_cost) as y2_s1,
         sum(ss_list_price) as y2_s2, sum(ss_coupon_amt) as y2_s3
  from store_sales, store_returns, date_dim, store, item
  where ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number
    and ss_item_sk in (select ui_item from cs_ui)
    and ss_sold_date_sk = d_date_sk and d_year = 2000
    and ss_store_sk = s_store_sk
    and ss_item_sk = i_item_sk and i_current_price is not null
  group by i_product_name, s_store_name, s_zip)
select y1_pn, y1_sn, y1_zip, y1_s1, y1_s2, y1_s3, y2_s1, y2_s2, y2_s3,
       y2_cnt, y1_cnt
from y1, y2
where y1_pn = y2_pn and y1_sn = y2_sn and y1_zip = y2_zip
  and y2_cnt <= y1_cnt
order by y1_pn, y1_sn, y2_cnt
limit 100
""",
    "q66": """
with ws as (
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country,
         sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m1,
         sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m2,
         sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m3,
         sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m4,
         sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m5,
         sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m6,
         sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m7,
         sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m8,
         sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m9,
         sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m10,
         sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m11,
         sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
             else 0.0 end) as m_m12
  from web_sales, date_dim, time_dim, warehouse
  where ws_sold_date_sk = d_date_sk and d_year = 2001
    and ws_sold_time_sk = t_time_sk and t_hour between 8 and 17
    and ws_ship_mode_sk in (select sm_ship_mode_sk from ship_mode
                            where sm_carrier in ('DHL', 'BARIAN'))
    and ws_warehouse_sk = w_warehouse_sk
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country),
cs as (
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country,
         sum(case when d_moy = 1 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m1,
         sum(case when d_moy = 2 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m2,
         sum(case when d_moy = 3 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m3,
         sum(case when d_moy = 4 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m4,
         sum(case when d_moy = 5 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m5,
         sum(case when d_moy = 6 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m6,
         sum(case when d_moy = 7 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m7,
         sum(case when d_moy = 8 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m8,
         sum(case when d_moy = 9 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m9,
         sum(case when d_moy = 10 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m10,
         sum(case when d_moy = 11 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m11,
         sum(case when d_moy = 12 then cs_ext_sales_price * cs_quantity
             else 0.0 end) as m_m12
  from catalog_sales, date_dim, time_dim, warehouse
  where cs_sold_date_sk = d_date_sk and d_year = 2001
    and cs_sold_time_sk = t_time_sk and t_hour between 8 and 17
    and cs_ship_mode_sk in (select sm_ship_mode_sk from ship_mode
                            where sm_carrier in ('DHL', 'BARIAN'))
    and cs_warehouse_sk = w_warehouse_sk
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country)
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country,
       sum(m_m1) as m_m1, sum(m_m2) as m_m2, sum(m_m3) as m_m3,
       sum(m_m4) as m_m4, sum(m_m5) as m_m5, sum(m_m6) as m_m6,
       sum(m_m7) as m_m7, sum(m_m8) as m_m8, sum(m_m9) as m_m9,
       sum(m_m10) as m_m10, sum(m_m11) as m_m11, sum(m_m12) as m_m12
from (select * from ws union all select * from cs) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country
order by w_warehouse_name
limit 100
""",
    "q67": """
with base as (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id,
         sum(coalesce(ss_sales_price * ss_quantity, 0.0)) as sumsales
  from store_sales, date_dim, store, item
  where ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
    and ss_store_sk = s_store_sk
    and ss_item_sk = i_item_sk
  group by rollup(i_category, i_class, i_brand, i_product_name, d_year,
                  d_qoy, d_moy, s_store_id))
select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy,
       s_store_id, sumsales, rk
from (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             rank() over (partition by i_category
                          order by sumsales desc) as rk
      from base) ranked
where rk <= 100
order by i_category, sumsales desc, rk
limit 100
""",
    "q69": """
select cd_gender, cd_marital_status, cd_education_status, count(*) as cnt1,
       cd_purchase_estimate, count(*) as cnt2, cd_credit_rating,
       count(*) as cnt3
from customer
     left anti join
     (select ws_bill_customer_sk as wk from web_sales, date_dim
      where ws_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy between 4 and 6) w
     on c_customer_sk = wk
     left anti join
     (select cs_ship_customer_sk as ck from catalog_sales, date_dim
      where cs_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy between 4 and 6) c
     on c_customer_sk = ck,
     customer_address, customer_demographics
where c_current_addr_sk = ca_address_sk
  and ca_state in ('TN', 'GA', 'SD')
  and c_current_cdemo_sk = cd_demo_sk
  and c_customer_sk in (
    select ss_customer_sk from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
      and d_year = 2001 and d_moy between 4 and 6)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100
""",
    "q70": """
select s_state, s_county, sum(ss_net_profit) as total_sum
from store_sales, date_dim, store
where ss_sold_date_sk = d_date_sk
  and d_month_seq between 1200 and 1211
  and ss_store_sk = s_store_sk
  and s_state in (
    select rank_state from (
      select rank_state, rank() over (order by sp desc) as rnk
      from (select s_state as rank_state, sum(ss_net_profit) as sp
            from store_sales, date_dim, store
            where ss_sold_date_sk = d_date_sk
              and d_month_seq between 1200 and 1211
              and ss_store_sk = s_store_sk
            group by s_state) sr) ranked
    where rnk <= 5)
group by rollup(s_state, s_county)
order by total_sum desc, s_state, s_county
limit 100
""",
    "q71": """
select i_brand_id as brand_id, i_brand as brand, t_hour, t_minute,
       sum(ext_price) as ext_price
from (select ws_ext_sales_price as ext_price, ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from web_sales
      where ws_sold_date_sk in (select d_date_sk from date_dim
                                where d_moy = 11 and d_year = 1999)
      union all
      select cs_ext_sales_price as ext_price, cs_item_sk as sold_item_sk,
             cs_sold_time_sk as time_sk
      from catalog_sales
      where cs_sold_date_sk in (select d_date_sk from date_dim
                                where d_moy = 11 and d_year = 1999)
      union all
      select ss_ext_sales_price as ext_price, ss_item_sk as sold_item_sk,
             ss_sold_time_sk as time_sk
      from store_sales
      where ss_sold_date_sk in (select d_date_sk from date_dim
                                where d_moy = 11 and d_year = 1999)) u,
     item, time_dim
where sold_item_sk = i_item_sk and i_manager_id = 1
  and time_sk = t_time_sk and t_meal_time in ('breakfast', 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, brand_id
""",
    "q72": """
select i_item_desc, w_warehouse_name, sold_week, count(*) as no_promo
from catalog_sales, inventory, warehouse, item, customer_demographics,
     household_demographics,
     (select d_date_sk as sold_sk, d_week_seq as sold_week
      from date_dim where d_year = 1999) dd
where cs_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cd_marital_status = 'D'
  and cs_bill_hdemo_sk = hd_demo_sk and hd_buy_potential = '>10000'
  and cs_sold_date_sk = sold_sk
  and inv_quantity_on_hand < cs_quantity
group by i_item_desc, w_warehouse_name, sold_week
order by no_promo desc, i_item_desc, w_warehouse_name, sold_week
limit 100
""",
    "q75": """
with ss as (
  select d_year, i_brand_id, i_category_id,
         sum(ss_quantity) - sum(cast(coalesce(sr_return_quantity, 0)
                                     as long)) as sales_cnt,
         sum(ss_ext_sales_price) - sum(coalesce(sr_return_amt, 0.0))
           as sales_amt
  from store_sales
       left join store_returns
       on ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk,
       date_dim, item
  where ss_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and ss_item_sk = i_item_sk and i_category = 'Books'
  group by d_year, i_brand_id, i_category_id),
cs as (
  select d_year, i_brand_id, i_category_id,
         sum(cs_quantity) - sum(cast(coalesce(cr_return_quantity, 0)
                                     as long)) as sales_cnt,
         sum(cs_ext_sales_price) - sum(coalesce(cr_return_amount, 0.0))
           as sales_amt
  from catalog_sales
       left join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
       date_dim, item
  where cs_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and cs_item_sk = i_item_sk and i_category = 'Books'
  group by d_year, i_brand_id, i_category_id),
ws as (
  select d_year, i_brand_id, i_category_id,
         sum(ws_quantity) - sum(cast(coalesce(wr_return_quantity, 0)
                                     as long)) as sales_cnt,
         sum(ws_ext_sales_price) - sum(coalesce(wr_return_amt, 0.0))
           as sales_amt
  from web_sales
       left join web_returns
       on ws_order_number = wr_order_number and ws_item_sk = wr_item_sk,
       date_dim, item
  where ws_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and ws_item_sk = i_item_sk and i_category = 'Books'
  group by d_year, i_brand_id, i_category_id),
all_y as (
  select d_year, i_brand_id, i_category_id, sum(sales_cnt) as sales_cnt,
         sum(sales_amt) as sales_amt
  from (select * from ss union all select * from cs
        union all select * from ws) x
  group by d_year, i_brand_id, i_category_id)
select curr.i_brand_id as i_brand_id, curr.i_category_id as i_category_id,
       prev.sales_cnt as prev_cnt, curr.sales_cnt as curr_cnt,
       curr.sales_cnt - prev.sales_cnt as delta_cnt,
       curr.sales_amt - prev.sales_amt as delta_amt
from (select * from all_y where d_year = 2000) curr,
     (select * from all_y where d_year = 1999) prev
where curr.i_brand_id = prev.i_brand_id
  and curr.i_category_id = prev.i_category_id
  and prev.sales_cnt > 0
  and cast(curr.sales_cnt as double) / prev.sales_cnt < 0.9
order by delta_cnt, i_brand_id, i_category_id
limit 100
""",
    "q76": """
select channel, col_name, d_year, d_qoy, i_category, count(*) as sales_cnt,
       sum(ext_sales_price) as sales_amt
from (select 'store' as channel, 'ss_store_sk' as col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price as ext_sales_price
      from store_sales, item, date_dim
      where ss_store_sk is null and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
      union all
      select 'web' as channel, 'ws_ship_customer_sk' as col_name, d_year,
             d_qoy, i_category, ws_ext_sales_price as ext_sales_price
      from web_sales, item, date_dim
      where ws_ship_customer_sk is null and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
      union all
      select 'catalog' as channel, 'cs_ship_addr_sk' as col_name, d_year,
             d_qoy, i_category, cs_ext_sales_price as ext_sales_price
      from catalog_sales, item, date_dim
      where cs_ship_addr_sk is null and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk) u
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
""",
    "q77": """
with ssr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select ss_store_sk as sid, sum(ss_ext_sales_price) as sales,
               sum(ss_net_profit) as profit
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-30'
        group by ss_store_sk) s
  left join (select sr_store_sk as sid_r, sum(sr_return_amt) as returns_amt,
                    sum(sr_net_loss) as net_loss
             from store_returns, date_dim
             where sr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-30'
             group by sr_store_sk) r
  on s.sid = r.sid_r),
csr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select cs_call_center_sk as sid, sum(cs_ext_sales_price) as sales,
               sum(cs_net_profit) as profit
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-30'
        group by cs_call_center_sk) s
  left join (select cr_call_center_sk as sid_r,
                    sum(cr_return_amount) as returns_amt,
                    sum(cr_net_loss) as net_loss
             from catalog_returns, date_dim
             where cr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-30'
             group by cr_call_center_sk) r
  on s.sid = r.sid_r),
wsr as (
  select s.sid, s.sales, coalesce(r.returns_amt, 0.0) as returns_amt,
         s.profit - coalesce(r.net_loss, 0.0) as profit
  from (select ws_web_page_sk as sid, sum(ws_ext_sales_price) as sales,
               sum(ws_net_profit) as profit
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk
          and d_date between date '2000-08-01' and date '2000-08-30'
        group by ws_web_page_sk) s
  left join (select wr_web_page_sk as sid_r, sum(wr_return_amt) as returns_amt,
                    sum(wr_net_loss) as net_loss
             from web_returns, date_dim
             where wr_returned_date_sk = d_date_sk
               and d_date between date '2000-08-01' and date '2000-08-30'
             group by wr_web_page_sk) r
  on s.sid = r.sid_r)
select channel, sid, sum(sales) as sales, sum(returns_amt) as returns_amt,
       sum(profit) as profit
from (select 'store channel' as channel, sid, sales, returns_amt, profit
      from ssr
      union all
      select 'catalog channel' as channel, sid, sales, returns_amt, profit
      from csr
      union all
      select 'web channel' as channel, sid, sales, returns_amt, profit
      from wsr) x
group by rollup(channel, sid)
order by channel, sid
limit 100
""",
    "q88": """
select *
from (select count(*) as h8_30_to_9 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 8 and t_minute >= 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s1,
     (select count(*) as h9_to_9_30 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 9 and t_minute < 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s2,
     (select count(*) as h9_30_to_10 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 9 and t_minute >= 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s3,
     (select count(*) as h10_to_10_30 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 10 and t_minute < 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s4,
     (select count(*) as h10_30_to_11 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 10 and t_minute >= 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s5,
     (select count(*) as h11_to_11_30 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 11 and t_minute < 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s6,
     (select count(*) as h11_30_to_12 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 11 and t_minute >= 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s7,
     (select count(*) as h12_to_12_30 from store_sales
      where ss_sold_time_sk in (select t_time_sk from time_dim
                                where t_hour = 12 and t_minute < 30)
        and ss_hdemo_sk in (select hd_demo_sk from household_demographics
                            where (hd_dep_count = 4 and hd_vehicle_count <= 6)
                               or (hd_dep_count = 2 and hd_vehicle_count <= 4)
                               or (hd_dep_count = 0
                                   and hd_vehicle_count <= 2))
        and ss_store_sk in (select s_store_sk from store
                            where s_store_name = 'ese')) s8
""",
    "q14": """
with items as (
  select i_item_sk, i_brand_id, i_class as i_class_id_, i_category_id
  from item),
ssi as (
  select distinct i_brand_id as sb, i_class_id_ as sc, i_category_id as sg
  from store_sales, date_dim, items
  where ss_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and ss_item_sk = i_item_sk),
csi as (
  select distinct i_brand_id as cb, i_class_id_ as cc, i_category_id as cg
  from catalog_sales, date_dim, items
  where cs_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and cs_item_sk = i_item_sk),
wsi as (
  select distinct i_brand_id as wb, i_class_id_ as wc, i_category_id as wg
  from web_sales, date_dim, items
  where ws_sold_date_sk = d_date_sk and d_year in (1999, 2000)
    and ws_item_sk = i_item_sk),
cross_ids as (
  select sb, sc, sg from ssi
  left semi join csi on sb = cb and sc = cc and sg = cg
  left semi join wsi on sb = wb and sc = wc and sg = wg),
cross_items as (
  select i_item_sk from items
  left semi join cross_ids
  on i_brand_id = sb and i_class_id_ = sc and i_category_id = sg),
avg_sales as (
  select avg(v) as avg_v
  from (select ss_quantity * ss_list_price as v
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk and d_year in (1999, 2000)
        union all
        select cs_quantity * cs_list_price as v
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk and d_year in (1999, 2000)
        union all
        select ws_quantity * ws_list_price as v
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk and d_year in (1999, 2000)) x),
ch as (
  select ss_item_sk as item, sum(ss_quantity * ss_list_price) as sales,
         count(*) as number_sales
  from store_sales
  where ss_sold_date_sk in (select d_date_sk from date_dim
                            where d_year = 2000 and d_moy = 11)
    and ss_item_sk in (select i_item_sk from cross_items)
  group by ss_item_sk)
select sum(sales) as total_sales, sum(number_sales) as total_number
from ch, avg_sales
where sales > avg_v
""",
    "q36": """
with rolled as (
  select sum(ss_net_profit) as _num, sum(ss_ext_sales_price) as _den,
         i_category, i_class
  from store_sales, date_dim, store, item
  where ss_sold_date_sk = d_date_sk and d_year = 2001
    and ss_store_sk = s_store_sk and s_state = 'TN'
    and ss_item_sk = i_item_sk
  group by rollup(i_category, i_class)),
tmp as (
  select _num / _den as total_sum, i_category, i_class,
         case when i_category is null then 1 else 0 end
         + case when i_class is null then 1 else 0 end as lochierarchy,
         case when i_class is not null then i_category
              else null end as _parent
  from rolled)
select total_sum, i_category, i_class, lochierarchy,
       rank() over (partition by lochierarchy, _parent
                    order by total_sum asc) as rank_within_parent
from tmp
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category else null end,
         rank_within_parent
limit 100
""",
    "q49": """
with web_g as (
  select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select ws_item_sk as item,
               cast(sum(cast(coalesce(wr_return_quantity, 0) as long))
                    as double) / sum(ws_quantity) as return_ratio,
               sum(coalesce(wr_return_amt, 0.0)) / sum(ws_net_paid)
                 as currency_ratio,
               sum(ws_quantity) as sale_q
        from web_sales
             left join web_returns
             on ws_order_number = wr_order_number
                and ws_item_sk = wr_item_sk
        where ws_sold_date_sk in (select d_date_sk from date_dim
                                  where d_year = 2000 and d_moy = 12)
          and ws_net_paid > 0
        group by ws_item_sk) g
  where sale_q > 0),
cat_g as (
  select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select cs_item_sk as item,
               cast(sum(cast(coalesce(cr_return_quantity, 0) as long))
                    as double) / sum(cs_quantity) as return_ratio,
               sum(coalesce(cr_return_amount, 0.0)) / sum(cs_net_paid)
                 as currency_ratio,
               sum(cs_quantity) as sale_q
        from catalog_sales
             left join catalog_returns
             on cs_order_number = cr_order_number
                and cs_item_sk = cr_item_sk
        where cs_sold_date_sk in (select d_date_sk from date_dim
                                  where d_year = 2000 and d_moy = 12)
          and cs_net_paid > 0
        group by cs_item_sk) g
  where sale_q > 0),
store_g as (
  select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select ss_item_sk as item,
               cast(sum(cast(coalesce(sr_return_quantity, 0) as long))
                    as double) / sum(ss_quantity) as return_ratio,
               sum(coalesce(sr_return_amt, 0.0)) / sum(ss_net_paid)
                 as currency_ratio,
               sum(ss_quantity) as sale_q
        from store_sales
             left join store_returns
             on ss_ticket_number = sr_ticket_number
                and ss_item_sk = sr_item_sk
        where ss_sold_date_sk in (select d_date_sk from date_dim
                                  where d_year = 2000 and d_moy = 12)
          and ss_net_paid > 0
        group by ss_item_sk) g
  where sale_q > 0)
select channel, item, return_ratio, return_rank, currency_rank
from (select 'wr' as channel, item, return_ratio, return_rank, currency_rank
      from web_g where return_rank <= 10 or currency_rank <= 10
      union all
      select 'cr' as channel, item, return_ratio, return_rank, currency_rank
      from cat_g where return_rank <= 10 or currency_rank <= 10
      union all
      select 'sr' as channel, item, return_ratio, return_rank, currency_rank
      from store_g where return_rank <= 10 or currency_rank <= 10) u
order by channel, return_rank, currency_rank, item
limit 100
""",
    "q51": """
with wss as (
  select ws_item_sk as item_sk, d_date, sum(ws_sales_price) as daily
  from web_sales, date_dim
  where ws_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by ws_item_sk, d_date),
sss as (
  select ss_item_sk as item_sk, d_date, sum(ss_sales_price) as daily
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by ss_item_sk, d_date),
web as (
  select item_sk, d_date,
         sum(daily) over (partition by item_sk order by d_date
                          rows between unbounded preceding and current row)
           as web_cum
  from wss),
store as (
  select item_sk as s_item, d_date as s_date,
         sum(daily) over (partition by item_sk order by d_date
                          rows between unbounded preceding and current row)
           as store_cum
  from sss)
select item_sk, d_date, web_cum, store_cum
from web, store
where item_sk = s_item and d_date = s_date and web_cum > store_cum
order by item_sk, d_date
limit 100
""",
    "q59": """
with wss as (
  select d_week_seq, ss_store_sk,
         sum(case when d_day_name = 'Sunday' then ss_sales_price
             else null end) as sun_sales,
         sum(case when d_day_name = 'Monday' then ss_sales_price
             else null end) as mon_sales,
         sum(case when d_day_name = 'Tuesday' then ss_sales_price
             else null end) as tue_sales,
         sum(case when d_day_name = 'Wednesday' then ss_sales_price
             else null end) as wed_sales,
         sum(case when d_day_name = 'Thursday' then ss_sales_price
             else null end) as thu_sales,
         sum(case when d_day_name = 'Friday' then ss_sales_price
             else null end) as fri_sales,
         sum(case when d_day_name = 'Saturday' then ss_sales_price
             else null end) as sat_sales
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk
  group by d_week_seq, ss_store_sk),
weeks as (select distinct d_week_seq as wseq, d_month_seq from date_dim),
y as (
  select s_store_name as s_store_name1, d_week_seq as d_week_seq1,
         s_store_id as s_store_id1, sun_sales as sun_sales1,
         mon_sales as mon_sales1, tue_sales as tue_sales1,
         wed_sales as wed_sales1, thu_sales as thu_sales1,
         fri_sales as fri_sales1, sat_sales as sat_sales1
  from wss, weeks, store
  where d_week_seq = wseq and d_month_seq between 1212 and 1223
    and ss_store_sk = s_store_sk),
x as (
  select s_store_name as s_store_name2, d_week_seq as d_week_seq2,
         s_store_id as s_store_id2, sun_sales as sun_sales2,
         mon_sales as mon_sales2, tue_sales as tue_sales2,
         wed_sales as wed_sales2, thu_sales as thu_sales2,
         fri_sales as fri_sales2, sat_sales as sat_sales2
  from wss, weeks, store
  where d_week_seq = wseq and d_month_seq between 1224 and 1235
    and ss_store_sk = s_store_sk)
select s_store_name1, s_store_id1, d_week_seq1,
       sun_sales1 / sun_sales2 as sun_r, mon_sales1 / mon_sales2 as mon_r,
       tue_sales1 / tue_sales2 as tue_r, wed_sales1 / wed_sales2 as wed_r,
       thu_sales1 / thu_sales2 as thu_r, fri_sales1 / fri_sales2 as fri_r,
       sat_sales1 / sat_sales2 as sat_r
from y, x
where s_store_id1 = s_store_id2 and d_week_seq1 = d_week_seq2 - 52
order by s_store_name1, s_store_id1, d_week_seq1
limit 100
""",
    "q78": """
with ss as (
  select ss_item_sk as ss_item, ss_customer_sk as ss_cust,
         sum(ss_quantity) as ss_qty, sum(ss_wholesale_cost) as ss_wc,
         sum(ss_sales_price) as ss_sp
  from store_sales
       left anti join store_returns
       on ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk,
       date_dim
  where ss_sold_date_sk = d_date_sk and d_year = 2000
  group by ss_item_sk, ss_customer_sk),
ws as (
  select ws_item_sk as ws_item, ws_bill_customer_sk as ws_cust,
         sum(ws_quantity) as ws_qty, sum(ws_wholesale_cost) as ws_wc,
         sum(ws_sales_price) as ws_sp
  from web_sales
       left anti join web_returns
       on ws_order_number = wr_order_number and ws_item_sk = wr_item_sk,
       date_dim
  where ws_sold_date_sk = d_date_sk and d_year = 2000
  group by ws_item_sk, ws_bill_customer_sk),
cs as (
  select cs_item_sk as cs_item, cs_bill_customer_sk as cs_cust,
         sum(cs_quantity) as cs_qty, sum(cs_wholesale_cost) as cs_wc,
         sum(cs_sales_price) as cs_sp
  from catalog_sales
       left anti join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
       date_dim
  where cs_sold_date_sk = d_date_sk and d_year = 2000
  group by cs_item_sk, cs_bill_customer_sk)
select ss_item, ss_cust, ss_qty, ss_wc, ss_sp,
       round(cast(ss_qty as double) / (ws_qty + cs_qty), 2) as ratio
from ss, ws, cs
where ss_item = ws_item and ss_cust = ws_cust
  and ss_item = cs_item and ss_cust = cs_cust
  and (ws_qty > 0 or cs_qty > 0)
order by ss_item, ss_cust
limit 100
""",
    "q80": """
with ssr as (
  select ss_store_sk as id, sum(ss_ext_sales_price) as sales,
         sum(coalesce(sr_return_amt, 0.0)) as returns_amt,
         sum(ss_net_profit) - sum(coalesce(sr_net_loss, 0.0)) as profit
  from store_sales
       left join store_returns
       on ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk,
       date_dim
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-01' and date '2000-08-30'
    and ss_promo_sk in (select p_promo_sk from promotion
                        where p_channel_tv = 'N')
  group by ss_store_sk),
csr as (
  select cs_catalog_page_sk as id, sum(cs_ext_sales_price) as sales,
         sum(coalesce(cr_return_amount, 0.0)) as returns_amt,
         sum(cs_net_profit) - sum(coalesce(cr_net_loss, 0.0)) as profit
  from catalog_sales
       left join catalog_returns
       on cs_order_number = cr_order_number and cs_item_sk = cr_item_sk,
       date_dim
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-01' and date '2000-08-30'
    and cs_promo_sk in (select p_promo_sk from promotion
                        where p_channel_tv = 'N')
  group by cs_catalog_page_sk),
wsr as (
  select ws_web_site_sk as id, sum(ws_ext_sales_price) as sales,
         sum(coalesce(wr_return_amt, 0.0)) as returns_amt,
         sum(ws_net_profit) - sum(coalesce(wr_net_loss, 0.0)) as profit
  from web_sales
       left join web_returns
       on ws_order_number = wr_order_number and ws_item_sk = wr_item_sk,
       date_dim
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-01' and date '2000-08-30'
    and ws_promo_sk in (select p_promo_sk from promotion
                        where p_channel_tv = 'N')
  group by ws_web_site_sk)
select channel, id, sum(sales) as sales, sum(returns_amt) as returns_amt,
       sum(profit) as profit
from (select 'store channel' as channel, id, sales, returns_amt, profit
      from ssr
      union all
      select 'catalog channel' as channel, id, sales, returns_amt, profit
      from csr
      union all
      select 'web channel' as channel, id, sales, returns_amt, profit
      from wsr) x
group by rollup(channel, id)
order by channel, id
limit 100
""",
    "q81": """
with ctr as (
  select cr_returning_customer_sk as ctr_cust, ca_state as ctr_state,
         sum(cr_return_amt_inc_tax) as ctr_total
  from catalog_returns, date_dim, customer, customer_address
  where cr_returned_date_sk = d_date_sk and d_year = 2000
    and cr_returning_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
  group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name, ca_city,
       ca_zip, ctr_total
from ctr ctr1, customer, customer_address
where ctr1.ctr_total > (select avg(ctr_total) * 1.2 from ctr ctr2
                        where ctr1.ctr_state = ctr2.ctr_state)
  and ctr1.ctr_cust = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ca_state = 'GA'
order by c_customer_id, c_salutation, c_first_name, c_last_name, ca_city,
         ca_zip
limit 100
""",
    "q82": """
select distinct i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim
where i_current_price between 62 and 92
  and i_manufact_id in (8, 33, 58, 83)
  and inv_item_sk = i_item_sk
  and inv_quantity_on_hand between 100 and 500
  and inv_date_sk = d_date_sk
  and d_date between date '2000-05-25' and date '2000-07-24'
  and i_item_sk in (select ss_item_sk from store_sales)
order by i_item_id
limit 100
""",
    "q83": """
with dates as (
  select d_date_sk from date_dim
  where d_week_seq in (select d_week_seq from date_dim
                       where d_date in (date '2000-06-30',
                                        date '2000-09-27',
                                        date '2000-11-17'))),
sr_items as (
  select i_item_id as sr_item_id, sum(sr_return_quantity) as sr_qty
  from store_returns, item
  where sr_returned_date_sk in (select d_date_sk from dates)
    and sr_item_sk = i_item_sk
  group by i_item_id),
cr_items as (
  select i_item_id as cr_item_id, sum(cr_return_quantity) as cr_qty
  from catalog_returns, item
  where cr_returned_date_sk in (select d_date_sk from dates)
    and cr_item_sk = i_item_sk
  group by i_item_id),
wr_items as (
  select i_item_id as wr_item_id, sum(wr_return_quantity) as wr_qty
  from web_returns, item
  where wr_returned_date_sk in (select d_date_sk from dates)
    and wr_item_sk = i_item_sk
  group by i_item_id)
select sr_item_id as item_id, sr_qty,
       sr_qty / cast(sr_qty + cr_qty + wr_qty as double) * 100 as sr_dev,
       cr_qty,
       cr_qty / cast(sr_qty + cr_qty + wr_qty as double) * 100 as cr_dev,
       wr_qty,
       wr_qty / cast(sr_qty + cr_qty + wr_qty as double) * 100 as wr_dev,
       cast(sr_qty + cr_qty + wr_qty as double) / 3.0 as average
from sr_items, cr_items, wr_items
where sr_item_id = cr_item_id and sr_item_id = wr_item_id
order by item_id, sr_qty
limit 100
""",
    "q84": """
select c_customer_id as customer_id, c_last_name, c_first_name
from customer, customer_address, customer_demographics, store_returns
where c_current_addr_sk = ca_address_sk and ca_city = 'Fairview'
  and c_current_cdemo_sk = cd_demo_sk
  and cd_demo_sk = sr_cdemo_sk
order by customer_id
limit 100
""",
    "q85": """
select r_reason_desc, avg(ws_quantity) as avg_q,
       avg(wr_refunded_cash) as avg_cash, avg(wr_fee) as avg_fee
from web_returns, web_sales, date_dim, web_page, reason,
     customer_demographics
where wr_order_number = ws_order_number and wr_item_sk = ws_item_sk
  and ws_sold_date_sk = d_date_sk and d_year = 2000
  and ws_web_page_sk = wp_web_page_sk
  and wr_reason_sk = r_reason_sk
  and wr_refunded_cdemo_sk = cd_demo_sk
  and ((cd_marital_status = 'M' and cd_education_status = 'Advanced Degree'
        and ws_sales_price >= 100.0)
       or (cd_marital_status = 'S' and cd_education_status = 'College'
           and ws_sales_price >= 50.0)
       or (cd_marital_status = 'W' and cd_education_status = '2 yr Degree'
           and ws_sales_price >= 0.0))
group by r_reason_desc
order by r_reason_desc, avg_q, avg_cash, avg_fee
limit 100
""",
    "q87": """
select count(*) as cnt
from (select distinct c_last_name, c_first_name, d_date
      from store_sales, date_dim, customer
      where ss_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and ss_customer_sk = c_customer_sk) store_c
     left anti join
     (select distinct c_last_name as ln, c_first_name as fn, d_date as dt
      from catalog_sales, date_dim, customer
      where cs_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and cs_bill_customer_sk = c_customer_sk) catalog_c
     on c_last_name = ln and c_first_name = fn and d_date = dt
     left anti join
     (select distinct c_last_name as wl, c_first_name as wf, d_date as wd
      from web_sales, date_dim, customer
      where ws_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
        and ws_bill_customer_sk = c_customer_sk) web_c
     on c_last_name = wl and c_first_name = wf and d_date = wd
""",
    "q91": """
select cc_call_center_id, cc_name, cc_manager, cd_marital_status,
       cd_education_status, sum(cr_net_loss) as returns_loss
from catalog_returns, date_dim, call_center, customer,
     customer_demographics, household_demographics, customer_address
where cr_returned_date_sk = d_date_sk and d_year = 1998 and d_moy = 11
  and cr_call_center_sk = cc_call_center_sk
  and cr_returning_customer_sk = c_customer_sk
  and c_current_cdemo_sk = cd_demo_sk
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
       or (cd_marital_status = 'W'
           and cd_education_status = 'Advanced Degree'))
  and c_current_hdemo_sk = hd_demo_sk
  and hd_buy_potential like 'Unknown%'
  and c_current_addr_sk = ca_address_sk
  and ca_gmt_offset = -7
group by cc_call_center_id, cc_name, cc_manager, cd_marital_status,
         cd_education_status
order by returns_loss desc
limit 100
""",
    "q95": """
with multi_wh as (
  select distinct won
  from (select ws_order_number as won, ws_warehouse_sk as wwh
        from web_sales) ws1,
       (select ws_order_number as won2, ws_warehouse_sk as wwh2
        from web_sales) ws2
  where won = won2 and wwh <> wwh2)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales, date_dim, customer_address
where ws_ship_date_sk = d_date_sk
  and d_date between date '1999-02-01' and date '1999-04-02'
  and ws_ship_addr_sk = ca_address_sk and ca_state = 'GA'
  and ws_order_number in (select won from multi_wh)
  and ws_order_number in (select distinct wr_order_number from web_returns)
""",
    "q97": """
with ssci as (
  select distinct ss_customer_sk as s_cust, ss_item_sk as s_item
  from store_sales
  where ss_sold_date_sk in (select d_date_sk from date_dim
                            where d_month_seq between 1200 and 1211)),
csci as (
  select distinct cs_bill_customer_sk as c_cust, cs_item_sk as c_item
  from catalog_sales
  where cs_sold_date_sk in (select d_date_sk from date_dim
                            where d_month_seq between 1200 and 1211))
select sum(case when s_item is not null and c_item is null
           then 1 else 0 end) as store_only,
       sum(case when s_item is null and c_item is not null
           then 1 else 0 end) as catalog_only,
       sum(case when s_item is not null and c_item is not null
           then 1 else 0 end) as store_and_catalog
from ssci full join csci on s_cust = c_cust and s_item = c_item
""",
}
