"""The nineteen TPCx-BB tables, as ``HostBatch``es, numpy only.

The JAX package's ``benchmarks/tpcxbb_data.py``, built the way
``tpcds_data`` builds its tables: every column byte-equal to the JAX
generator's, ``columns=`` naming the ones to build (every random stream is
still drawn in the JAX generator's order, so the values do not change).
Dimensions come from ``tpcds_data``, item and customer with the TPCx-BB
columns added (i_class_id, c_login, c_email_address). The facts are linked
as in the JAX generator: store_returns come back from store_sales lines,
web_sales replays every third store return as a web re-buy, web_returns
refund web_sales lines, the clickstream replays a quarter of the store
sales as logged-in views, inventory is a zero-inflated Poisson per item
and item_marketprices holds a few competitor prices per item.
"""
from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.benchmarks import tpcds_data as ds
from spark_rapids_tpu_torch.benchmarks.tpch_data import (_strings, _Table,
                                                         _values,
                                                         _vocab_strings)
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

ITEM_COLUMNS = ds.ITEM_COLUMNS + ("i_class_id",)
CUSTOMER_COLUMNS = ds.CUSTOMER_COLUMNS + ("c_login", "c_email_address")
WAREHOUSE_COLUMNS = ("w_warehouse_sk", "w_warehouse_id", "w_warehouse_name",
                     "w_state")
WEB_PAGE_COLUMNS = ("wp_web_page_sk", "wp_web_page_id", "wp_char_count",
                    "wp_link_count", "wp_type")
PRODUCT_REVIEWS_COLUMNS = ("pr_review_sk", "pr_review_rating", "pr_item_sk",
                           "pr_user_sk", "pr_review_content")
STORE_RETURNS_COLUMNS = ("sr_returned_date_sk", "sr_item_sk",
                         "sr_customer_sk", "sr_ticket_number",
                         "sr_return_quantity", "sr_return_amt")
WEB_SALES_COLUMNS = (
    "ws_sold_date_sk", "ws_sold_time_sk", "ws_item_sk", "ws_bill_customer_sk",
    "ws_ship_hdemo_sk", "ws_web_page_sk", "ws_warehouse_sk",
    "ws_order_number", "ws_quantity", "ws_wholesale_cost", "ws_list_price",
    "ws_sales_price", "ws_ext_discount_amt", "ws_ext_sales_price",
    "ws_ext_wholesale_cost", "ws_ext_list_price", "ws_net_paid")
WEB_RETURNS_COLUMNS = ("wr_order_number", "wr_item_sk", "wr_refunded_cash")
WEB_CLICKSTREAMS_COLUMNS = ("wcs_click_date_sk", "wcs_click_time_sk",
                            "wcs_sales_sk", "wcs_item_sk", "wcs_web_page_sk",
                            "wcs_user_sk")
INVENTORY_COLUMNS = ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                     "inv_quantity_on_hand")
ITEM_MARKETPRICES_COLUMNS = ("imp_sk", "imp_item_sk", "imp_competitor_price",
                             "imp_start_date", "imp_end_date")

#: BigBench page taxonomy (q4 looks for 'order' pages without a
#: 'confirmation', q8 for 'review' pages), cycled so every type exists
PAGE_TYPES = ("ad", "dynamic", "feedback", "general", "order", "protected",
              "review", "welcome", "confirmation")
#: the sentiment vocabulary q10/q18/q19 match sentences against
POSITIVE_WORDS = ("great", "love", "works", "premium", "solid", "fast")
NEGATIVE_WORDS = ("poor", "broken", "hate", "slow", "failed", "cheap")
_REVIEW_WORDS = POSITIVE_WORDS + NEGATIVE_WORDS + ("classic", "value")
_REVIEW_NOUNS = ("product", "item", "quality", "packaging")
#: the competitor names q27's entity extraction looks for
COMPETITOR_COMPANIES = ("Acme", "Globex", "Initech", "Vandelay", "Hooli")
_WAREHOUSE_STATES = ("TN", "GA", "SD", "IN", "LA", "MI", "SC", "OH")


def date_sk(d: datetime.date) -> int:
    """The d_date_sk of a calendar date in the generated date_dim."""
    return ds._SK0 + (d - ds._D0).days


def n_warehouse(scale): return max(int(8 * scale), 4)
def n_web_page(scale): return max(int(120 * scale), 30)
def n_reviews(scale): return max(int(6_000 * scale), 250)
def n_web_orders(scale): return max(int(60_000 * scale), 400)
def n_clicks(scale): return max(int(400_000 * scale), 2_000)


def _extend(batch: HostBatch, order: Sequence[str], wanted, extra):
    """``batch`` with the extra columns (name -> (dtype, thunk)) in
    ``wanted``, in ``order``; an extra column replaces the batch's."""
    have = {f.name: (f, c) for f, c in zip(batch.schema, batch.columns)}
    fields, cols = [], []
    for name in order:
        if name not in wanted:
            continue
        if name in extra:
            dtype, build = extra[name]
            fields.append(Field(name, dtype))
            cols.append(build())
        else:
            f, c = have[name]
            fields.append(f)
            cols.append(c)
    return HostBatch(Schema(fields), tuple(cols), batch.num_rows)


def _wanted(order: Sequence[str], columns) -> list:
    wanted = list(order) if columns is None else list(columns)
    unknown = [c for c in wanted if c not in order]
    if unknown:
        raise KeyError(f"no columns {unknown} in {order}")
    return wanted


def _item_prices(scale: float, seed: int) -> np.ndarray:
    """The TPCx-BB item's i_current_price: tpcds_data's, with every 25th
    item (offset 3) re-priced into q22's 0.98-1.5 window."""
    p = ds.gen_item(scale, seed, ["i_current_price"]).columns[0].data.copy()
    rng = np.random.default_rng(seed + 30)
    cheap = np.arange(p.shape[0]) % 25 == 3
    p[cheap] = np.round(rng.uniform(1.0, 1.45, int(cheap.sum())), 2)
    return p


def gen_item(scale: float, seed: int,
             columns: Optional[Sequence[str]] = None) -> HostBatch:
    """tpcds_data's item with i_class_id 1..15 (cycled) and the re-priced
    items of ``_item_prices``."""
    wanted = _wanted(ITEM_COLUMNS, columns)
    base = ds.gen_item(scale, seed, [c for c in wanted
                                     if c in ds.ITEM_COLUMNS])
    n = ds.n_item(scale)
    return _extend(base, ITEM_COLUMNS, wanted, {
        "i_current_price": (DType.DOUBLE, lambda: _values(
            DType.DOUBLE, _item_prices(scale, seed))),
        "i_class_id": (DType.INT, lambda: _values(
            DType.INT, (np.arange(n) % 15 + 1).astype(np.int32)))})


def gen_customer(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    """tpcds_data's customer with c_login and c_email_address."""
    wanted = _wanted(CUSTOMER_COLUMNS, columns)
    base = ds.gen_customer(scale, seed, [c for c in wanted
                                         if c in ds.CUSTOMER_COLUMNS])
    n = ds.n_customer(scale)
    login = np.char.add("user", np.arange(1, n + 1).astype(str))
    return _extend(base, CUSTOMER_COLUMNS, wanted, {
        "c_login": (DType.STRING, lambda: _strings(login)),
        "c_email_address": (DType.STRING, lambda: _strings(
            np.char.add(login, "@example.com")))})


def gen_warehouse(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_warehouse(scale)
    t = _Table(WAREHOUSE_COLUMNS, columns)
    sk = np.arange(1, n + 1, dtype=np.int64)
    t.add("w_warehouse_sk", DType.LONG, lambda: ds._i64(sk))
    t.add("w_warehouse_id", DType.STRING, lambda: ds._ids("AAAAAAAA", sk))
    t.add("w_warehouse_name", DType.STRING, lambda: _strings(
        np.char.add("Warehouse no ", sk.astype(str))))
    t.add("w_state", DType.STRING, lambda: ds._cycle(_WAREHOUSE_STATES, sk))
    return t.batch(n)


def gen_web_page(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    """About a third of the pages land in q14's 5000-6000 character
    window."""
    n = n_web_page(scale)
    t = _Table(WEB_PAGE_COLUMNS, columns)
    rng = np.random.default_rng(seed + 31)
    sk = np.arange(1, n + 1, dtype=np.int64)
    chars = rng.integers(3000, 9000, n)
    links = rng.integers(2, 25, n)
    t.add("wp_web_page_sk", DType.LONG, lambda: ds._i64(sk))
    t.add("wp_web_page_id", DType.STRING, lambda: ds._ids("AAAAAAAA", sk))
    t.add("wp_char_count", DType.INT, lambda: ds._i32(chars))
    t.add("wp_link_count", DType.INT, lambda: ds._i32(links))
    t.add("wp_type", DType.STRING, lambda: ds._cycle(PAGE_TYPES, sk))
    return t.batch(n)


def gen_product_reviews(scale: float, seed: int,
                        columns: Optional[Sequence[str]] = None
                        ) -> HostBatch:
    """Reviews of one to three '. '-separated sentences, each of one kind:
    "<word> <noun>" (q10/q19's sentiment), "<word> service at store
    <name>" (q18's store mention, a name from gen_store's s_store_name)
    or "<word> compared to <Company>" (q27's entity)."""
    n = n_reviews(scale)
    t = _Table(PRODUCT_REVIEWS_COLUMNS, columns)
    rng = np.random.default_rng(seed + 32)
    sk = np.arange(1, n + 1, dtype=np.int64)
    words, nouns = np.array(_REVIEW_WORDS), np.array(_REVIEW_NOUNS)
    stores = np.array(ds.STORE_NAMES)
    companies = np.array(COMPETITOR_COMPANIES)

    def sentence():
        w = words[rng.integers(0, len(words), n)]
        kind = rng.random(n)
        plain = np.char.add(np.char.add(w, " "),
                            nouns[rng.integers(0, len(nouns), n)])
        store = np.char.add(np.char.add(w, " service at store "),
                            stores[rng.integers(0, len(stores), n)])
        comp = np.char.add(np.char.add(w, " compared to "),
                           companies[rng.integers(0, len(companies), n)])
        return np.where(kind < 0.2, store, np.where(kind < 0.4, comp, plain))

    content = sentence()
    for _ in range(2):
        more = rng.random(n) < 0.5
        content = np.where(
            more, np.char.add(np.char.add(content, ". "), sentence()),
            content)
    rating = rng.integers(1, 6, n)
    item, _ = ds._null_some(rng, DType.LONG, rng.integers(
        1, ds.n_item(scale) + 1, n).astype(np.int64), 0.02)
    user, _ = ds._null_some(rng, DType.LONG, rng.integers(
        1, ds.n_customer(scale) + 1, n).astype(np.int64), 0.04)
    t.add("pr_review_sk", DType.LONG, lambda: ds._i64(sk))
    t.add("pr_review_rating", DType.INT, lambda: ds._i32(rating))
    t.add("pr_item_sk", DType.LONG, item)
    t.add("pr_user_sk", DType.LONG, user)
    t.add("pr_review_content", DType.STRING, lambda: _strings(content))
    return t.batch(n)


class _StoreReturns:
    """store_returns as the JAX generator draws them: about 8% of the
    store-sales lines come back 1-60 days later (a line without a sale
    date comes back without a return date, one without a customer without
    a customer)."""

    def __init__(self, ss: "ds._StoreSales", seed: int):
        rng = np.random.default_rng(seed + 33)
        take = np.flatnonzero(rng.random(ss.n) < 0.08)
        k = take.shape[0]
        qty = ss.arrays["ss_quantity"][take]
        self.n = k
        self.date_null = ss.nulls["ss_sold_date_sk"][take]
        self.date = np.where(self.date_null, 0,
                             ss.arrays["ss_sold_date_sk"][take]
                             + rng.integers(1, 61, k)).astype(np.int64)
        self.cust_null = ss.nulls["ss_customer_sk"][take]
        self.cust = np.where(self.cust_null, 0,
                             ss.arrays["ss_customer_sk"][take])
        self.item = ss.arrays["ss_item_sk"][take]
        self.ticket = ss.arrays["ss_ticket_number"][take]
        self.qty = np.minimum(rng.integers(1, 101, k), qty).astype(np.int32)
        frac = self.qty / np.maximum(qty, 1)
        self.amt = np.round(ss.arrays["ss_net_paid"][take] * frac, 2)

    def batch(self, columns: Optional[Sequence[str]]) -> HostBatch:
        t = _Table(STORE_RETURNS_COLUMNS, columns)
        t.add("sr_returned_date_sk", DType.LONG, lambda: ds._nullable(
            ds._i64(self.date), self.date_null))
        t.add("sr_item_sk", DType.LONG, lambda: ds._i64(self.item))
        t.add("sr_customer_sk", DType.LONG, lambda: ds._nullable(
            ds._i64(self.cust), self.cust_null))
        t.add("sr_ticket_number", DType.LONG, lambda: ds._i64(self.ticket))
        t.add("sr_return_quantity", DType.INT, lambda: ds._i32(self.qty))
        t.add("sr_return_amt", DType.DOUBLE, lambda: ds._f64(self.amt))
        return t.batch(self.n)


class _WebSales:
    """The TPCx-BB web_sales as the JAX generator draws them: random web
    orders of 1-8 lines, then every third store return with a customer and
    a date re-bought on the web 30-400 days after the return (q21's
    store -> return -> web chain)."""

    def __init__(self, scale: float, seed: int, sr: _StoreReturns):
        rng = np.random.default_rng(seed + 34)
        orders = n_web_orders(scale)
        lines_per = rng.integers(1, 9, orders)
        n = int(lines_per.sum())
        order_no = np.repeat(np.arange(1, orders + 1, dtype=np.int64),
                             lines_per)
        o_cust = rng.integers(1, ds.n_customer(scale) + 1, orders)
        o_date = rng.integers(0, ds._DAYS, orders) + ds._SK0
        o_time = rng.integers(0, 1440, orders)
        o_hdemo = rng.integers(1, 6 * 10 * 5 + 1, orders)
        o_page = rng.integers(1, n_web_page(scale) + 1, orders)
        item = rng.integers(1, ds.n_item(scale) + 1, n).astype(np.int64)
        cust, date, time_, hdemo, page = (
            a.astype(np.int64)[order_no - 1]
            for a in (o_cust, o_date, o_time, o_hdemo, o_page))
        sel = np.flatnonzero(~sr.cust_null & ~sr.date_null)[::3]
        m = sel.shape[0]
        if m:
            r_date = np.minimum(sr.date[sel] + rng.integers(30, 401, m),
                                ds._SK0 + ds._DAYS - 1)
            item = np.concatenate([item, sr.item[sel]])
            cust = np.concatenate([cust, sr.cust[sel]])
            date = np.concatenate([date, r_date])
            order_no = np.concatenate(
                [order_no,
                 np.arange(orders + 1, orders + m + 1, dtype=np.int64)])
            time_ = np.concatenate([time_, rng.integers(0, 1440, m)])
            hdemo = np.concatenate(
                [hdemo, rng.integers(1, 6 * 10 * 5 + 1, m)])
            page = np.concatenate(
                [page, rng.integers(1, n_web_page(scale) + 1, m)])
            n += m
        p = ds._price_lines(rng, n)
        self.n = n
        self.arrays: Dict[str, np.ndarray] = {}
        self.nulls: Dict[str, np.ndarray] = {}
        for name, arr in (("ws_sold_date_sk", date),
                          ("ws_sold_time_sk", time_),
                          ("ws_item_sk", item),
                          ("ws_bill_customer_sk", cust),
                          ("ws_ship_hdemo_sk", hdemo),
                          ("ws_web_page_sk", page)):
            self.arrays[name] = arr.astype(np.int64)
            if name != "ws_item_sk":
                self.nulls[name] = rng.random(n) < 0.04
        self.arrays["ws_warehouse_sk"] = rng.integers(
            1, n_warehouse(scale) + 1, n).astype(np.int64)
        self.arrays.update({
            "ws_order_number": order_no, "ws_quantity": p["qty"],
            "ws_wholesale_cost": p["wholesale"],
            "ws_list_price": p["list_price"],
            "ws_sales_price": p["sales_price"],
            "ws_ext_discount_amt": p["ext_discount"],
            "ws_ext_sales_price": p["ext_sales"],
            "ws_ext_wholesale_cost": p["ext_wholesale"],
            "ws_ext_list_price": p["ext_list"],
            "ws_net_paid": p["ext_sales"]})

    def batch(self, columns: Optional[Sequence[str]]) -> HostBatch:
        t = _Table(WEB_SALES_COLUMNS, columns)
        for name in WEB_SALES_COLUMNS:
            dtype = (DType.INT if name == "ws_quantity" else DType.LONG
                     if name.endswith(("_sk", "_number")) else DType.DOUBLE)

            def build(name=name, dtype=dtype):
                col = _values(dtype, self.arrays[name])
                null = self.nulls.get(name)
                return col if null is None else ds._nullable(col, null)
            t.add(name, dtype, build)
        return t.batch(self.n)


def gen_store_returns(scale: float, seed: int,
                      columns: Optional[Sequence[str]] = None,
                      store_sales: Optional["ds._StoreSales"] = None
                      ) -> HostBatch:
    ss = store_sales or ds._StoreSales(scale, seed)
    return _StoreReturns(ss, seed).batch(columns)


def gen_web_sales(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None,
                  store_sales: Optional["ds._StoreSales"] = None
                  ) -> HostBatch:
    ss = store_sales or ds._StoreSales(scale, seed)
    return _WebSales(scale, seed, _StoreReturns(ss, seed)).batch(columns)


def _web_returns(seed: int, ws: _WebSales,
                 columns: Optional[Sequence[str]]) -> HostBatch:
    """About 8% of the web-sales lines refunded (q16 left-joins on order
    and item)."""
    t = _Table(WEB_RETURNS_COLUMNS, columns)
    rng = np.random.default_rng(seed + 35)
    take = np.flatnonzero(rng.random(ws.n) < 0.08)
    k = take.shape[0]
    cash = np.round(ws.arrays["ws_net_paid"][take]
                    * rng.uniform(0.1, 1.0, k), 2)
    refunded, _ = ds._null_some(rng, DType.DOUBLE, cash, 0.05)
    t.add("wr_order_number", DType.LONG,
          lambda: ds._i64(ws.arrays["ws_order_number"][take]))
    t.add("wr_item_sk", DType.LONG,
          lambda: ds._i64(ws.arrays["ws_item_sk"][take]))
    t.add("wr_refunded_cash", DType.DOUBLE, refunded)
    return t.batch(k)


def gen_web_returns(scale: float, seed: int,
                    columns: Optional[Sequence[str]] = None,
                    store_sales: Optional["ds._StoreSales"] = None
                    ) -> HostBatch:
    ss = store_sales or ds._StoreSales(scale, seed)
    return _web_returns(seed, _WebSales(scale, seed, _StoreReturns(ss, seed)),
                        columns)


def gen_web_clickstreams(scale: float, seed: int,
                         columns: Optional[Sequence[str]] = None,
                         store_sales: Optional["ds._StoreSales"] = None
                         ) -> HostBatch:
    """Bursty random browsing (each click near one of its user's three
    session anchors, items skewed by u^2) plus a replay of every 4th
    store-sales line with a customer and a date, viewed logged-in 1-30 days
    before."""
    t = _Table(WEB_CLICKSTREAMS_COLUMNS, columns)
    rng = np.random.default_rng(seed + 36)
    n = n_clicks(scale)
    n_it = ds.n_item(scale)
    item = (np.minimum(rng.random(n) ** 2 * n_it, n_it - 1) + 1) \
        .astype(np.int64)
    user = rng.integers(1, ds.n_customer(scale) + 1, n).astype(np.int64)
    anchor = rng.integers(0, 3, n)
    date = ((user * 131 + anchor * 211) % ds._DAYS + ds._SK0).astype(np.int64)
    minute = ((user * 97 + anchor * 311) % 1380
              + rng.integers(0, 45, n)).astype(np.int64)
    sales = rng.integers(1, 1_000_000, n).astype(np.int64)
    view = rng.random(n) < 0.6
    anon = rng.random(n) < 0.25
    ss = store_sales or ds._StoreSales(scale, seed)
    ok = np.flatnonzero(~ss.nulls["ss_customer_sk"]
                        & ~ss.nulls["ss_sold_date_sk"])[::4]
    m = ok.shape[0]
    item = np.concatenate([item, ss.arrays["ss_item_sk"][ok]])
    user = np.concatenate([user, ss.arrays["ss_customer_sk"][ok]])
    date = np.concatenate([date, ss.arrays["ss_sold_date_sk"][ok]
                           - rng.integers(1, 31, m)])
    minute = np.concatenate([minute,
                             rng.integers(0, 1440, m).astype(np.int64)])
    sales = np.concatenate([sales, np.zeros(m, dtype=np.int64)])
    view = np.concatenate([view, np.ones(m, dtype=bool)])
    anon = np.concatenate([anon, np.zeros(m, dtype=bool)])
    n += m
    item_col, _ = ds._null_some(rng, DType.LONG, item, 0.03)
    page = rng.integers(1, n_web_page(scale) + 1, n).astype(np.int64)
    t.add("wcs_click_date_sk", DType.LONG, lambda: ds._i64(date))
    t.add("wcs_click_time_sk", DType.LONG, lambda: ds._i64(minute))
    t.add("wcs_sales_sk", DType.LONG,
          lambda: ds._nullable(ds._i64(sales), view))
    t.add("wcs_item_sk", DType.LONG, item_col)
    t.add("wcs_web_page_sk", DType.LONG, lambda: ds._i64(page))
    t.add("wcs_user_sk", DType.LONG,
          lambda: ds._nullable(ds._i64(user), anon))
    return t.batch(n)


def gen_inventory(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    """Weekly snapshots of 2001 for every (item, warehouse), at most 400
    items: a Poisson quantity per item rate, so low-rate items clear q23's
    stddev/mean >= 1.3 bar and high-rate ones do not."""
    t = _Table(INVENTORY_COLUMNS, columns)
    rng = np.random.default_rng(seed + 37)
    items = min(ds.n_item(scale), 400)
    warehouses = n_warehouse(scale)
    weeks = np.arange(date_sk(datetime.date(2001, 1, 1)),
                      date_sk(datetime.date(2002, 1, 1)), 7, dtype=np.int64)
    n = items * warehouses * weeks.shape[0]
    per_item = warehouses * weeks.shape[0]
    item = np.repeat(np.arange(1, items + 1, dtype=np.int64), per_item)
    lam = np.exp(rng.uniform(np.log(0.3), np.log(60.0), items))
    qty = rng.poisson(lam[item - 1]).astype(np.int32)
    qty_col, _ = ds._null_some(rng, DType.INT, qty, 0.02)
    t.add("inv_date_sk", DType.LONG,
          lambda: ds._i64(np.tile(weeks, items * warehouses)))
    t.add("inv_item_sk", DType.LONG, lambda: ds._i64(item))
    t.add("inv_warehouse_sk", DType.LONG, lambda: ds._i64(np.tile(
        np.repeat(np.arange(1, warehouses + 1, dtype=np.int64),
                  weeks.shape[0]), items)))
    t.add("inv_quantity_on_hand", DType.INT, qty_col)
    return t.batch(n)


def gen_item_marketprices(scale: float, seed: int,
                          columns: Optional[Sequence[str]] = None
                          ) -> HostBatch:
    """Two to four competitor price records per item, each over a 30-120
    day window (q24 compares the quantities sold inside and before it)."""
    t = _Table(ITEM_MARKETPRICES_COLUMNS, columns)
    rng = np.random.default_rng(seed + 38)
    price = _item_prices(scale, seed)
    n_i = price.shape[0]
    per = rng.integers(2, 5, n_i)
    n = int(per.sum())
    isk = np.repeat(np.arange(1, n_i + 1, dtype=np.int64), per)
    comp_price = np.round(price[isk - 1] * rng.uniform(0.7, 1.3, n), 2)
    start = (rng.integers(0, ds._DAYS - 120, n) + ds._SK0).astype(np.int64)
    length = rng.integers(30, 121, n).astype(np.int64)
    comp, _ = ds._null_some(rng, DType.DOUBLE, comp_price, 0.05)
    t.add("imp_sk", DType.LONG,
          lambda: ds._i64(np.arange(1, n + 1, dtype=np.int64)))
    t.add("imp_item_sk", DType.LONG, lambda: ds._i64(isk))
    t.add("imp_competitor_price", DType.DOUBLE, comp)
    t.add("imp_start_date", DType.LONG, lambda: ds._i64(start))
    t.add("imp_end_date", DType.LONG, lambda: ds._i64(start + length))
    return t.batch(n)


#: every table, in the JAX ``gen_all``'s order
TABLES = ("date_dim", "time_dim", "item", "customer", "customer_address",
          "customer_demographics", "household_demographics", "store",
          "promotion", "warehouse", "web_page", "product_reviews",
          "store_sales", "store_returns", "web_sales", "web_returns",
          "web_clickstreams", "inventory", "item_marketprices")


def gen_all(scale: float = 0.002, seed: int = 0,
            columns: Optional[Dict[str, Sequence[str]]] = None,
            tables: Optional[Sequence[str]] = None
            ) -> Dict[str, HostBatch]:
    """The nineteen tables (``tables`` names a subset); ``columns`` maps a
    table to the columns to build (a table it leaves out gets all of
    them). The linked facts share one draw of the store sales, store
    returns and web sales."""
    cols = columns or {}
    names = TABLES if tables is None else tuple(tables)
    lazy: Dict[str, object] = {}

    def ss():
        if "ss" not in lazy:
            lazy["ss"] = ds._StoreSales(scale, seed)
        return lazy["ss"]

    def sr():
        if "sr" not in lazy:
            lazy["sr"] = _StoreReturns(ss(), seed)
        return lazy["sr"]

    def ws():
        if "ws" not in lazy:
            lazy["ws"] = _WebSales(scale, seed, sr())
        return lazy["ws"]

    build = {
        "date_dim": lambda c: ds.gen_date_dim(c),
        "time_dim": lambda c: ds.gen_time_dim(c),
        "item": lambda c: gen_item(scale, seed, c),
        "customer": lambda c: gen_customer(scale, seed, c),
        "customer_address": lambda c: ds.gen_customer_address(scale, seed,
                                                              c),
        "customer_demographics": lambda c: ds.gen_customer_demographics(c),
        "household_demographics": lambda c:
            ds.gen_household_demographics(c),
        "store": lambda c: ds.gen_store(scale, seed, c),
        "promotion": lambda c: ds.gen_promotion(scale, seed, c),
        "warehouse": lambda c: gen_warehouse(scale, seed, c),
        "web_page": lambda c: gen_web_page(scale, seed, c),
        "product_reviews": lambda c: gen_product_reviews(scale, seed, c),
        "store_sales": lambda c: ss().batch(c),
        "store_returns": lambda c: sr().batch(c),
        "web_sales": lambda c: ws().batch(c),
        "web_returns": lambda c: _web_returns(seed, ws(), c),
        "web_clickstreams": lambda c: gen_web_clickstreams(scale, seed, c,
                                                           ss()),
        "inventory": lambda c: gen_inventory(scale, seed, c),
        "item_marketprices": lambda c: gen_item_marketprices(scale, seed, c),
    }
    return {t: build[t](cols.get(t)) for t in names}
