"""The TPCx-BB tables q5 reads, as ``HostBatch``es, numpy only.

The JAX package's ``benchmarks/tpcxbb_data.py``, built the way
``tpcds_data`` builds its tables: every column byte-equal to the JAX
generator's, ``columns=`` naming the ones to build. q5 reads
web_clickstreams, item, customer and customer_demographics; the other
fifteen TPCx-BB tables are not ported yet. Dimensions come from
``tpcds_data``, item and customer with the TPCx-BB columns added
(i_class_id, c_login, c_email_address); the clickstream replays a quarter
of the store sales as logged-in views.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.benchmarks import tpcds_data as ds
from spark_rapids_tpu_torch.benchmarks.tpch_data import (_strings, _Table,
                                                         _values)
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import HostBatch

ITEM_COLUMNS = ds.ITEM_COLUMNS + ("i_class_id",)
CUSTOMER_COLUMNS = ds.CUSTOMER_COLUMNS + ("c_login", "c_email_address")
WEB_CLICKSTREAMS_COLUMNS = ("wcs_click_date_sk", "wcs_click_time_sk",
                            "wcs_sales_sk", "wcs_item_sk", "wcs_web_page_sk",
                            "wcs_user_sk")


def n_web_page(scale): return max(int(120 * scale), 30)
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


def gen_item(scale: float, seed: int,
             columns: Optional[Sequence[str]] = None) -> HostBatch:
    """tpcds_data's item with i_class_id 1..15 (cycled) and every 25th
    item (offset 3) re-priced into q22's 0.98-1.5 window."""
    wanted = list(ITEM_COLUMNS) if columns is None else list(columns)
    unknown = [c for c in wanted if c not in ITEM_COLUMNS]
    if unknown:
        raise KeyError(f"no columns {unknown} in {ITEM_COLUMNS}")
    base = ds.gen_item(scale, seed, [c for c in wanted
                                     if c in ds.ITEM_COLUMNS])
    n = base.num_rows
    rng = np.random.default_rng(seed + 30)
    cheap = np.arange(n) % 25 == 3
    new_price = np.round(rng.uniform(1.0, 1.45, int(cheap.sum())), 2)

    def price():
        p = base.column_by_name("i_current_price").data.copy()
        p[cheap] = new_price
        return _values(DType.DOUBLE, p)

    return _extend(base, ITEM_COLUMNS, wanted, {
        "i_current_price": (DType.DOUBLE, price),
        "i_class_id": (DType.INT, lambda: _values(
            DType.INT, (np.arange(n) % 15 + 1).astype(np.int32)))})


def gen_customer(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    """tpcds_data's customer with c_login and c_email_address."""
    wanted = list(CUSTOMER_COLUMNS) if columns is None else list(columns)
    unknown = [c for c in wanted if c not in CUSTOMER_COLUMNS]
    if unknown:
        raise KeyError(f"no columns {unknown} in {CUSTOMER_COLUMNS}")
    base = ds.gen_customer(scale, seed, [c for c in wanted
                                         if c in ds.CUSTOMER_COLUMNS])
    n = ds.n_customer(scale)
    login = np.char.add("user", np.arange(1, n + 1).astype(str))
    return _extend(base, CUSTOMER_COLUMNS, wanted, {
        "c_login": (DType.STRING, lambda: _strings(login)),
        "c_email_address": (DType.STRING, lambda: _strings(
            np.char.add(login, "@example.com")))})


def gen_web_clickstreams(scale: float, seed: int,
                         columns: Optional[Sequence[str]] = None,
                         store_sales: Optional["ds._StoreSales"] = None
                         ) -> HostBatch:
    """Bursty random browsing plus a replay of every 4th store-sales line
    with a customer and a date, viewed logged-in 1-30 days before."""
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


def gen_all(scale: float = 0.002, seed: int = 0,
            columns: Optional[Dict[str, Sequence[str]]] = None
            ) -> Dict[str, HostBatch]:
    """The four tables q5 reads; ``columns`` maps a table to the columns
    to build (a table it leaves out gets all of them)."""
    cols = columns or {}
    return {
        "item": gen_item(scale, seed, cols.get("item")),
        "customer": gen_customer(scale, seed, cols.get("customer")),
        "customer_demographics": ds.gen_customer_demographics(
            cols.get("customer_demographics")),
        "web_clickstreams": gen_web_clickstreams(
            scale, seed, cols.get("web_clickstreams")),
    }
