"""The 24 TPC-DS tables, as ``HostBatch``es, numpy only.

The JAX package's ``benchmarks/tpcds_data.py`` dsdgen-alike, built straight
into the port's host layout (``tpch_data``'s): for a given scale and seed
every column is byte-equal to the JAX generator's table converted to a
``HostBatch``. Every random stream is drawn in the JAX generator's order,
so the values do not change; ``columns=`` names the columns to build, and
the others are never materialized. The returns facts are sampled from
their sales facts, and catalog_sales replays a third of the store returns,
so ``gen_all`` draws store_sales, store_returns, catalog_sales and
web_sales once each and builds the linked tables from those draws.
"""
from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.benchmarks.tpch_data import (_strings, _Table,
                                                         _values,
                                                         _vocab_strings)
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

_EPOCH = datetime.date(1970, 1, 1)
_D0 = datetime.date(1998, 1, 1)
_DAYS = (datetime.date(2003, 12, 31) - _D0).days + 1
#: dsdgen's julian-style first date key
_SK0 = 2450815

CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women", "Children"]
CLASSES = ["accent", "bedding", "classical", "dresses", "mens watch",
           "pants", "football", "romance", "fiction", "shirts", "athletic",
           "computers", "stereo", "portable", "reference", "personal",
           "self-help", "fragrances", "accessories"]
#: planted (category, class, brand) combos (the JAX generator's, for the
#: brand-list predicates of q53/q63)
_BRAND_COMBOS = [
    ("Books", "personal", "scholaramalgamalg #14"),
    ("Children", "portable", "scholaramalgamalg #7"),
    ("Electronics", "reference", "exportiunivamalg #9"),
    ("Books", "self-help", "scholaramalgamalg #9"),
    ("Women", "accessories", "amalgimporto #1"),
    ("Music", "classical", "edu packscholar #1"),
    ("Men", "fragrances", "exportiimporto #1"),
    ("Women", "pants", "importoamalg #1"),
]
_BRAND_BASES = ["amalgimporto #", "edu packscholar #", "exportiimporto #",
                "importoamalg #", "scholaramalgamalg #", "exportiunivamalg #",
                "corpamalgamalg #", "amalgamalg #"]
#: q41-style (category, color, units, size) variants planted on items
_VARIANTS = [("Women", "powder", "Ounce", "medium"),
             ("Women", "brown", "Bunch", "small"),
             ("Men", "floral", "Dozen", "petite"),
             ("Men", "light", "Box", "medium"),
             ("Women", "midnight", "Pallet", "extra large"),
             ("Men", "orange", "Each", "large")]
CITIES = ["Midway", "Fairview", "Oakland", "Riverside", "Five Points",
          "Centerville", "Oak Grove", "Pleasant Hill", "Bethel", "Clinton",
          "Antioch", "Marion", "Greenville", "Union", "Salem", "Spring Hill",
          "Shiloh", "Liberty", "Wilson", "Glendale"]
COUNTIES = ["Williamson County", "Walker County", "Ziebach County",
            "Daviess County", "Barrow County", "Franklin Parish",
            "Luce County", "Richland County"]
STATES = ["TN", "GA", "SD", "IN", "LA", "MI", "SC", "OH", "TX", "CA"]
FIRST_NAMES = ["James", "Mary", "John", "Linda", "Robert", "Susan", "Ana",
               "David", "Carlos", "Laura", "Kevin", "Grace", "Amy", "Paul"]
LAST_NAMES = ["Smith", "Jones", "Brown", "Davis", "Miller", "Moore",
              "Garcia", "Lopez", "Lee", "Walker", "Hall", "Young"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
MARITAL = ["M", "S", "D", "W", "U"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
COLORS = ["powder", "khaki", "brown", "honeydew", "floral", "deep", "light",
          "cornflower", "midnight", "snow", "cyan", "papaya", "orange",
          "frosted", "forest", "ghost", "red", "blue", "green", "white"]
UNITS = ["Ounce", "Oz", "Bunch", "Ton", "N/A", "Dozen", "Box", "Pound",
         "Pallet", "Gross", "Cup", "Dram", "Each", "Tbl", "Lb", "Bundle"]
SIZES = ["medium", "extra large", "N/A", "small", "petite", "large",
         "economy"]
#: dsdgen's syllable name pool
STORE_NAMES = ("ought", "able", "pri", "ese", "anti", "cally", "ation",
               "eing")
_CD_N = 2 * len(MARITAL) * len(EDUCATION) * len(CREDIT)
_HD_N = len(BUY_POTENTIAL) * 10 * 5
_N_SHIP_MODES = 5 * 4


def n_item(scale): return max(int(18_000 * scale), 100)
def n_customer(scale): return max(int(100_000 * scale), 300)
def n_address(scale): return max(int(50_000 * scale), 120)
def n_store(scale): return max(int(12 * scale), 6)
def n_promo(scale): return max(int(300 * scale), 12)
def n_tickets(scale): return max(int(240_000 * scale), 600)
def n_warehouse(scale): return max(int(10 * scale), 5)
def n_web_site(scale): return max(int(8 * scale), 4)
def n_web_page(scale): return max(int(120 * scale), 30)
def n_call_center(scale): return max(int(8 * scale), 4)
def n_catalog_page(scale): return max(int(200 * scale), 40)
def n_orders(scale): return max(int(100_000 * scale), 500)


# ------------------------------------------------------------------ columns
def _nullable(col: HostColumn, null: np.ndarray) -> HostColumn:
    """The column with ``null`` rows invalid and zeroed, as the arrow
    conversion of a masked array gives them."""
    data = col.data.copy()
    data[null] = 0
    lengths = None
    if col.lengths is not None:
        lengths = np.where(null, 0, col.lengths).astype(np.int32)
    return HostColumn(col.dtype, data, ~null, lengths)


def _null_some(rng, dtype: DType, arr: np.ndarray, frac: float):
    """The JAX generator's ``_null_some``: one draw of ``frac``-nulls ->
    a thunk building the column and the null mask (``None`` arr is only
    drawn for)."""
    null = rng.random(arr.shape[0]) < frac
    return (lambda: _nullable(_values(dtype, arr), null)), null


def _ids(prefix: str, sk: np.ndarray) -> HostColumn:
    return _strings(np.char.add(prefix, np.char.zfill(sk.astype(str), 8)))


def _cycle(vocab: Sequence[str], sk: np.ndarray) -> HostColumn:
    return _vocab_strings(vocab, (sk - 1) % len(vocab))


def _i32(a) -> HostColumn:
    return _values(DType.INT, np.asarray(a).astype(np.int32))


def _i64(a) -> HostColumn:
    return _values(DType.LONG, np.asarray(a).astype(np.int64))


def _f64(a) -> HostColumn:
    return _values(DType.DOUBLE, np.asarray(a, np.float64))


# ------------------------------------------------------------------ tables
DATE_DIM_COLUMNS = ("d_date_sk", "d_date", "d_year", "d_moy", "d_dom",
                    "d_qoy", "d_quarter_name", "d_dow", "d_day_name",
                    "d_week_seq", "d_month_seq")
TIME_DIM_COLUMNS = ("t_time_sk", "t_hour", "t_minute", "t_meal_time")
ITEM_COLUMNS = ("i_item_sk", "i_item_id", "i_item_desc", "i_product_name",
                "i_brand_id", "i_brand", "i_class", "i_category_id",
                "i_category", "i_manufact_id", "i_manufact", "i_color",
                "i_units", "i_size", "i_wholesale_cost", "i_manager_id",
                "i_current_price")
CUSTOMER_COLUMNS = ("c_customer_sk", "c_customer_id", "c_current_addr_sk",
                    "c_current_cdemo_sk", "c_current_hdemo_sk",
                    "c_first_name", "c_last_name", "c_salutation",
                    "c_preferred_cust_flag", "c_birth_country",
                    "c_birth_year", "c_birth_month", "c_birth_day")
CUSTOMER_ADDRESS_COLUMNS = ("ca_address_sk", "ca_city", "ca_county",
                            "ca_state", "ca_zip", "ca_country",
                            "ca_gmt_offset")
CUSTOMER_DEMOGRAPHICS_COLUMNS = ("cd_demo_sk", "cd_gender",
                                 "cd_marital_status", "cd_education_status",
                                 "cd_credit_rating", "cd_purchase_estimate",
                                 "cd_dep_count")
HOUSEHOLD_DEMOGRAPHICS_COLUMNS = ("hd_demo_sk", "hd_buy_potential",
                                  "hd_dep_count", "hd_vehicle_count")
STORE_COLUMNS = ("s_store_sk", "s_store_id", "s_store_name",
                 "s_number_employees", "s_city", "s_county", "s_state",
                 "s_company_name", "s_company_id", "s_street_number",
                 "s_street_name", "s_street_type", "s_suite_number", "s_zip",
                 "s_gmt_offset")
PROMOTION_COLUMNS = ("p_promo_sk", "p_channel_dmail", "p_channel_email",
                     "p_channel_tv", "p_channel_event")
STORE_SALES_COLUMNS = (
    "ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk", "ss_customer_sk",
    "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk", "ss_promo_sk",
    "ss_ticket_number", "ss_quantity", "ss_wholesale_cost", "ss_list_price",
    "ss_sales_price", "ss_ext_discount_amt", "ss_ext_sales_price",
    "ss_ext_wholesale_cost", "ss_ext_list_price", "ss_ext_tax",
    "ss_coupon_amt", "ss_net_paid", "ss_net_paid_inc_tax", "ss_net_profit")
_CHANNEL_PER_ORDER = ("sold_date_sk", "sold_time_sk", "bill_customer_sk",
                      "bill_cdemo_sk", "bill_hdemo_sk", "bill_addr_sk",
                      "ship_customer_sk", "ship_cdemo_sk", "ship_hdemo_sk",
                      "ship_addr_sk", "ship_mode_sk")
_CHANNEL_LINES = ("item_sk", "warehouse_sk", "promo_sk", "order_number",
                  "quantity", "wholesale_cost", "list_price", "sales_price",
                  "ext_discount_amt", "ext_sales_price", "ext_wholesale_cost",
                  "ext_list_price", "ext_tax", "coupon_amt", "ext_ship_cost",
                  "net_paid", "net_paid_inc_tax", "net_paid_inc_ship",
                  "net_profit")
_CS_EXTRA = ("call_center_sk", "catalog_page_sk")
_WS_EXTRA = ("web_page_sk", "web_site_sk")


def _channel_columns(prefix: str, extra: Sequence[str]):
    return tuple(f"{prefix}_{c}" for c in
                 _CHANNEL_PER_ORDER + tuple(extra) + ("ship_date_sk",)
                 + _CHANNEL_LINES)


CATALOG_SALES_COLUMNS = _channel_columns("cs", _CS_EXTRA)
WEB_SALES_COLUMNS = _channel_columns("ws", _WS_EXTRA)


def gen_date_dim(columns: Optional[Sequence[str]] = None) -> HostBatch:
    """One row per day of 1998-2003."""
    t = _Table(DATE_DIM_COLUMNS, columns)
    day = np.arange(_DAYS, dtype=np.int64)
    epoch_day = day + (_D0 - _EPOCH).days
    ymd = epoch_day.astype("datetime64[D]")
    year = ymd.astype("datetime64[Y]").astype(np.int64) + 1970
    month = ymd.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (ymd - ymd.astype("datetime64[M]")).astype(np.int64) + 1
    qoy = (month - 1) // 3 + 1
    dow = (epoch_day + 3) % 7            # 1970-01-01 was a Thursday
    t.add("d_date_sk", DType.LONG, lambda: _i64(day + _SK0))
    t.add("d_date", DType.DATE,
          lambda: _values(DType.DATE, epoch_day.astype(np.int32)))
    t.add("d_year", DType.INT, lambda: _i32(year))
    t.add("d_moy", DType.INT, lambda: _i32(month))
    t.add("d_dom", DType.INT, lambda: _i32(dom))
    t.add("d_qoy", DType.INT, lambda: _i32(qoy))
    t.add("d_quarter_name", DType.STRING, lambda: _strings(np.char.add(
        np.char.add(year.astype(str), "Q"), qoy.astype(str))))
    t.add("d_dow", DType.INT, lambda: _i32(dow))
    t.add("d_day_name", DType.STRING, lambda: _vocab_strings(DAY_NAMES, dow))
    t.add("d_week_seq", DType.INT, lambda: _i32(day // 7 + 1))
    t.add("d_month_seq", DType.INT, lambda: _i32(
        (year - _D0.year) * 12 + month - 1 + 1189))
    return t.batch(_DAYS)


def gen_time_dim(columns: Optional[Sequence[str]] = None) -> HostBatch:
    """One row per minute of the day."""
    t = _Table(TIME_DIM_COLUMNS, columns)
    sk = np.arange(1440, dtype=np.int64)
    hour = sk // 60
    meal = np.where((hour >= 6) & (hour < 9), 1,
                    np.where((hour >= 11) & (hour < 13), 2,
                             np.where((hour >= 17) & (hour < 20), 3, 0)))
    t.add("t_time_sk", DType.LONG, lambda: _i64(sk))
    t.add("t_hour", DType.INT, lambda: _i32(hour))
    t.add("t_minute", DType.INT, lambda: _i32(sk % 60))
    t.add("t_meal_time", DType.STRING, lambda: _nullable(
        _vocab_strings(["", "breakfast", "lunch", "dinner"], meal),
        meal == 0))
    return t.batch(1440)


def gen_item(scale: float, seed: int,
             columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_item(scale)
    t = _Table(ITEM_COLUMNS, columns)
    rng = np.random.default_rng(seed + 11)
    sk = np.arange(1, n + 1, dtype=np.int64)
    brand_id = (rng.integers(1, 11, n) * 1000000
                + rng.integers(1, 11, n) * 1000 + rng.integers(1, 11, n))
    cat_id = rng.integers(1, len(CATEGORIES) + 1, n).astype(np.int32)
    brand_base = rng.integers(0, len(_BRAND_BASES), n)
    brand_no = rng.integers(1, 16, n)
    cls = rng.integers(0, len(CLASSES), n)
    color = rng.integers(0, len(COLORS), n)
    units = rng.integers(0, len(UNITS), n)
    size = rng.integers(0, len(SIZES), n)
    # the q41-style variant plants, on every 25th-offset-11 item
    vplant = np.flatnonzero((sk - 1) % 25 == 11)
    vwhich = np.arange(vplant.shape[0]) % len(_VARIANTS)
    cat_id[vplant] = np.array([CATEGORIES.index(v[0]) + 1
                               for v in _VARIANTS], np.int32)[vwhich]
    color[vplant] = np.array([COLORS.index(v[1]) for v in _VARIANTS])[vwhich]
    units[vplant] = np.array([UNITS.index(v[2]) for v in _VARIANTS])[vwhich]
    size[vplant] = np.array([SIZES.index(v[3]) for v in _VARIANTS])[vwhich]
    # every 10th item on a qualifying (category, class, brand) combo; a
    # planted brand is its own vocabulary entry past the drawn ones
    planted = np.flatnonzero((sk - 1) % 10 == 5)
    which = np.arange(planted.shape[0]) % len(_BRAND_COMBOS)
    cat_id[planted] = np.array([CATEGORIES.index(c[0]) + 1
                                for c in _BRAND_COMBOS], np.int32)[which]
    cls[planted] = np.array([CLASSES.index(c[1])
                             for c in _BRAND_COMBOS])[which]
    n_drawn = len(_BRAND_BASES) * 15
    brand = brand_base * 15 + brand_no - 1
    brand[planted] = n_drawn + which
    brand_vocab = ([f"{b}{i}" for b in _BRAND_BASES for i in range(1, 16)]
                   + [c[2] for c in _BRAND_COMBOS])
    wholesale = np.round(rng.uniform(0.05, 70.0, n), 2)
    cheap = np.round(rng.uniform(1.0, 1.45, n), 2)
    mid = np.round(rng.uniform(68.0, 98.0, n), 2)
    rest = np.round(rng.uniform(0.09, 99.99, n), 2)
    t.add("i_item_sk", DType.LONG, lambda: _i64(sk))
    t.add("i_item_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("i_item_desc", DType.STRING,
          lambda: _strings(np.char.add("item desc ", sk.astype(str))))
    t.add("i_product_name", DType.STRING,
          lambda: _strings(np.char.add("product ", sk.astype(str))))
    t.add("i_brand_id", DType.INT, lambda: _i32(brand_id))
    t.add("i_brand", DType.STRING, lambda: _vocab_strings(brand_vocab, brand))
    t.add("i_class", DType.STRING, lambda: _vocab_strings(CLASSES, cls))
    t.add("i_category_id", DType.INT, lambda: _i32(cat_id))
    t.add("i_category", DType.STRING,
          lambda: _vocab_strings(CATEGORIES, cat_id - 1))
    t.add("i_manufact_id", DType.INT, lambda: _i32((sk - 1) % 1000 + 1))
    t.add("i_manufact", DType.STRING, lambda: _vocab_strings(
        [f"manufact#{i}" for i in range(1, 51)], (sk - 1) % 50))
    t.add("i_color", DType.STRING, lambda: _vocab_strings(COLORS, color))
    t.add("i_units", DType.STRING, lambda: _vocab_strings(UNITS, units))
    t.add("i_size", DType.STRING, lambda: _vocab_strings(SIZES, size))
    t.add("i_wholesale_cost", DType.DOUBLE, lambda: _f64(wholesale))
    t.add("i_manager_id", DType.INT, lambda: _i32((sk - 1) % 100 + 1))
    t.add("i_current_price", DType.DOUBLE, lambda: _f64(np.where(
        (sk - 1) % 25 == 3, cheap, np.where((sk - 1) % 25 == 7, mid, rest))))
    return t.batch(n)


def gen_customer(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_customer(scale)
    t = _Table(CUSTOMER_COLUMNS, columns)
    rng = np.random.default_rng(seed + 12)
    sk = np.arange(1, n + 1, dtype=np.int64)
    draws = [rng.integers(1, n_address(scale) + 1, n),
             rng.integers(1, _CD_N + 1, n), rng.integers(1, _HD_N + 1, n),
             rng.integers(0, len(FIRST_NAMES), n),
             rng.integers(0, len(LAST_NAMES), n),
             rng.integers(0, len(SALUTATIONS), n),
             rng.random(n) < 0.5, rng.random(n) < 0.8,
             rng.integers(1924, 1993, n), rng.integers(1, 13, n),
             rng.integers(1, 29, n)]
    addr, cdemo, hdemo, first, last, sal, pref, us, by, bm, bd = draws
    t.add("c_customer_sk", DType.LONG, lambda: _i64(sk))
    t.add("c_customer_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("c_current_addr_sk", DType.LONG, lambda: _i64(addr))
    t.add("c_current_cdemo_sk", DType.LONG, lambda: _i64(cdemo))
    t.add("c_current_hdemo_sk", DType.LONG, lambda: _i64(hdemo))
    t.add("c_first_name", DType.STRING,
          lambda: _vocab_strings(FIRST_NAMES, first))
    t.add("c_last_name", DType.STRING,
          lambda: _vocab_strings(LAST_NAMES, last))
    t.add("c_salutation", DType.STRING,
          lambda: _vocab_strings(SALUTATIONS, sal))
    t.add("c_preferred_cust_flag", DType.STRING,
          lambda: _vocab_strings(["N", "Y"], pref.astype(np.int64)))
    t.add("c_birth_country", DType.STRING, lambda: _vocab_strings(
        ["CANADA", "UNITED STATES"], us.astype(np.int64)))
    t.add("c_birth_year", DType.INT, lambda: _i32(by))
    t.add("c_birth_month", DType.INT, lambda: _i32(bm))
    t.add("c_birth_day", DType.INT, lambda: _i32(bd))
    return t.batch(n)


def gen_customer_address(scale: float, seed: int,
                         columns: Optional[Sequence[str]] = None
                         ) -> HostBatch:
    n = n_address(scale)
    t = _Table(CUSTOMER_ADDRESS_COLUMNS, columns)
    rng = np.random.default_rng(seed + 13)
    sk = np.arange(1, n + 1, dtype=np.int64)
    city = rng.integers(0, len(CITIES), n)
    county = rng.integers(0, len(COUNTIES), n)
    state = rng.integers(0, len(STATES), n)
    zips = rng.integers(10000, 99999, n)
    gmt = rng.integers(-8, -4, n).astype(np.float64)
    t.add("ca_address_sk", DType.LONG, lambda: _i64(sk))
    t.add("ca_city", DType.STRING, lambda: _vocab_strings(CITIES, city))
    t.add("ca_county", DType.STRING, lambda: _vocab_strings(COUNTIES, county))
    t.add("ca_state", DType.STRING, lambda: _vocab_strings(STATES, state))
    t.add("ca_zip", DType.STRING, lambda: _strings(zips.astype(str)))
    t.add("ca_country", DType.STRING, lambda: _vocab_strings(
        ["United States"], np.zeros(n, np.int64)))
    t.add("ca_gmt_offset", DType.DOUBLE, lambda: _f64(gmt))
    return t.batch(n)


def gen_customer_demographics(columns: Optional[Sequence[str]] = None
                              ) -> HostBatch:
    """The cross product of gender, marital status, education and credit."""
    t = _Table(CUSTOMER_DEMOGRAPHICS_COLUMNS, columns)
    n = _CD_N
    i = np.arange(n, dtype=np.int64)
    per_g = len(MARITAL) * len(EDUCATION) * len(CREDIT)
    per_m = len(EDUCATION) * len(CREDIT)
    t.add("cd_demo_sk", DType.LONG, lambda: _i64(i + 1))
    t.add("cd_gender", DType.STRING, lambda: _vocab_strings(["M", "F"],
                                                            i // per_g))
    t.add("cd_marital_status", DType.STRING,
          lambda: _vocab_strings(MARITAL, i // per_m % len(MARITAL)))
    t.add("cd_education_status", DType.STRING, lambda: _vocab_strings(
        EDUCATION, i // len(CREDIT) % len(EDUCATION)))
    t.add("cd_credit_rating", DType.STRING,
          lambda: _vocab_strings(CREDIT, i % len(CREDIT)))
    t.add("cd_purchase_estimate", DType.INT,
          lambda: _i32(500 + (i % 10) * 500))
    t.add("cd_dep_count", DType.INT, lambda: _i32(i % 7))
    return t.batch(n)


def gen_household_demographics(columns: Optional[Sequence[str]] = None
                               ) -> HostBatch:
    t = _Table(HOUSEHOLD_DEMOGRAPHICS_COLUMNS, columns)
    n = _HD_N
    i = np.arange(n, dtype=np.int64)
    t.add("hd_demo_sk", DType.LONG, lambda: _i64(i + 1))
    t.add("hd_buy_potential", DType.STRING,
          lambda: _vocab_strings(BUY_POTENTIAL, i // 50))
    t.add("hd_dep_count", DType.INT, lambda: _i32(i // 5 % 10))
    t.add("hd_vehicle_count", DType.INT, lambda: _i32(i % 5))
    return t.batch(n)


def gen_store(scale: float, seed: int,
              columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_store(scale)
    t = _Table(STORE_COLUMNS, columns)
    rng = np.random.default_rng(seed + 14)
    sk = np.arange(1, n + 1, dtype=np.int64)
    employees = rng.integers(200, 301, n)
    street_no = rng.integers(1, 1000, n)
    zips = rng.integers(10000, 99999, n)
    t.add("s_store_sk", DType.LONG, lambda: _i64(sk))
    t.add("s_store_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("s_store_name", DType.STRING, lambda: _cycle(STORE_NAMES, sk))
    t.add("s_number_employees", DType.INT, lambda: _i32(employees))
    t.add("s_city", DType.STRING, lambda: _cycle(CITIES, sk))
    t.add("s_county", DType.STRING, lambda: _cycle(COUNTIES, sk))
    t.add("s_state", DType.STRING, lambda: _cycle(STATES, sk))
    t.add("s_company_name", DType.STRING,
          lambda: _vocab_strings(["Unknown"], np.zeros(n, np.int64)))
    t.add("s_company_id", DType.INT, lambda: _i32((sk - 1) % 6 + 1))
    t.add("s_street_number", DType.STRING,
          lambda: _strings(street_no.astype(str)))
    t.add("s_street_name", DType.STRING,
          lambda: _cycle(["Main", "Oak", "Park", "First", "Elm"], sk))
    t.add("s_street_type", DType.STRING,
          lambda: _cycle(["St", "Ave", "Blvd", "Ln"], sk))
    t.add("s_suite_number", DType.STRING, lambda: _strings(np.char.add(
        "Suite ", ((sk - 1) % 20 * 10).astype(str))))
    t.add("s_zip", DType.STRING, lambda: _strings(zips.astype(str)))
    t.add("s_gmt_offset", DType.DOUBLE,
          lambda: _f64(-5.0 - ((sk - 1) % 4)))
    return t.batch(n)


def gen_promotion(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_promo(scale)
    t = _Table(PROMOTION_COLUMNS, columns)
    rng = np.random.default_rng(seed + 15)
    t.add("p_promo_sk", DType.LONG,
          lambda: _i64(np.arange(1, n + 1, dtype=np.int64)))
    for name in PROMOTION_COLUMNS[1:]:
        yes = (rng.random(n) < 0.5).astype(np.int64)
        t.add(name, DType.STRING,
              lambda yes=yes: _vocab_strings(["N", "Y"], yes))
    return t.batch(n)


def _price_lines(rng, n: int) -> Dict[str, np.ndarray]:
    """Per-line pricing shared by the sales facts (the JAX generator's
    draws): quantity, wholesale/list/sales prices and the ext_* amounts."""
    qty = rng.integers(1, 101, n).astype(np.int32)
    wholesale = np.round(rng.uniform(1.0, 100.0, n), 2)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
    disc = np.round(rng.uniform(0.0, 1.0, n), 2)
    sales_price = np.round(list_price * (1 - disc), 2)
    return {
        "qty": qty, "wholesale": wholesale, "list_price": list_price,
        "sales_price": sales_price,
        "ext_sales": np.round(qty * sales_price, 2),
        "ext_wholesale": np.round(qty * wholesale, 2),
        "ext_list": np.round(qty * list_price, 2),
        "ext_discount": np.round(qty * (list_price - sales_price), 2),
    }


class _StoreSales:
    """store_sales' columns as the JAX generator draws them, with each
    nullable key's null mask; ``batch`` builds the columns asked for."""

    def __init__(self, scale: float, seed: int):
        tickets = n_tickets(scale)
        rng = np.random.default_rng(seed + 16)
        lines_per = rng.integers(1, 25, tickets)
        n = int(lines_per.sum())
        tick = np.repeat(np.arange(1, tickets + 1, dtype=np.int64), lines_per)
        per_ticket = [
            rng.integers(1, n_customer(scale) + 1, tickets),
            rng.integers(1, _CD_N + 1, tickets),
            rng.integers(1, _HD_N + 1, tickets),
            rng.integers(1, n_address(scale) + 1, tickets),
            rng.integers(1, n_store(scale) + 1, tickets),
            rng.integers(0, _DAYS, tickets) + _SK0,
            rng.integers(0, 1440, tickets)]
        cust, cdemo, hdemo, addr, store, date, time_ = [
            a.astype(np.int64)[tick - 1] for a in per_ticket]
        p = _price_lines(rng, n)
        coupon = np.where(rng.random(n) < 0.1,
                          np.round(p["ext_sales"] * rng.uniform(0, 0.5, n),
                                   2), 0.0)
        net_paid = np.round(p["ext_sales"] - coupon, 2)
        tax = np.round(net_paid * 0.08, 2)
        self.n = n
        self.arrays: Dict[str, np.ndarray] = {}
        self.nulls: Dict[str, np.ndarray] = {}

        def nullable(name, arr):
            self.arrays[name] = arr
            self.nulls[name] = rng.random(n) < 0.04

        nullable("ss_sold_date_sk", date)
        nullable("ss_sold_time_sk", time_)
        self.arrays["ss_item_sk"] = rng.integers(
            1, n_item(scale) + 1, n).astype(np.int64)
        for name, arr in (("ss_customer_sk", cust), ("ss_cdemo_sk", cdemo),
                          ("ss_hdemo_sk", hdemo), ("ss_addr_sk", addr),
                          ("ss_store_sk", store)):
            nullable(name, arr)
        nullable("ss_promo_sk",
                 rng.integers(1, n_promo(scale) + 1, n).astype(np.int64))
        self.arrays.update({
            "ss_ticket_number": tick, "ss_quantity": p["qty"],
            "ss_wholesale_cost": p["wholesale"],
            "ss_list_price": p["list_price"],
            "ss_sales_price": p["sales_price"],
            "ss_ext_discount_amt": p["ext_discount"],
            "ss_ext_sales_price": p["ext_sales"],
            "ss_ext_wholesale_cost": p["ext_wholesale"],
            "ss_ext_list_price": p["ext_list"], "ss_ext_tax": tax,
            "ss_coupon_amt": coupon, "ss_net_paid": net_paid})
        self._derived = {
            "ss_net_paid_inc_tax": lambda: np.round(net_paid + tax, 2),
            "ss_net_profit": lambda: np.round(net_paid - p["ext_wholesale"],
                                              2)}

    def batch(self, columns: Optional[Sequence[str]]) -> HostBatch:
        t = _Table(STORE_SALES_COLUMNS, columns)
        for name in STORE_SALES_COLUMNS:
            dtype = (DType.INT if name == "ss_quantity" else DType.LONG
                     if name.endswith(("_sk", "_number")) else DType.DOUBLE)

            def build(name=name, dtype=dtype):
                arr = (self.arrays[name] if name in self.arrays
                       else self._derived[name]())
                col = _values(dtype, arr)
                null = self.nulls.get(name)
                return col if null is None else _nullable(col, null)
            t.add(name, dtype, build)
        return t.batch(self.n)


def gen_store_sales(scale: float, seed: int,
                    columns: Optional[Sequence[str]] = None) -> HostBatch:
    return _StoreSales(scale, seed).batch(columns)


STORE_RETURNS_COLUMNS = (
    "sr_returned_date_sk", "sr_return_time_sk", "sr_item_sk",
    "sr_customer_sk", "sr_cdemo_sk", "sr_hdemo_sk", "sr_addr_sk",
    "sr_store_sk", "sr_reason_sk", "sr_ticket_number", "sr_return_quantity",
    "sr_return_amt", "sr_return_tax", "sr_return_amt_inc_tax", "sr_fee",
    "sr_refunded_cash", "sr_net_loss")


class _StoreReturns:
    """store_returns sampled from store_sales (8% of its lines, returned
    1-60 days after the sale), drawn as the JAX generator's
    ``gen_store_returns`` does; ``replay`` gives the (customer, item,
    returned date) catalog_sales re-buys."""

    def __init__(self, ss: _StoreSales, seed: int):
        rng = np.random.default_rng(seed + 23)
        take = np.flatnonzero(rng.random(ss.n) < 0.08)
        k = take.shape[0]
        sold_null = ss.nulls["ss_sold_date_sk"][take]
        ret_date = np.minimum(
            np.where(sold_null, _SK0, ss.arrays["ss_sold_date_sk"][take])
            + rng.integers(1, 61, k), _SK0 + _DAYS - 1)
        qty = ss.arrays["ss_quantity"][take]
        net = ss.arrays["ss_net_paid"][take]
        ret_qty = np.minimum(rng.integers(1, 101, k), qty).astype(np.int32)
        amt = np.round(net * (ret_qty / np.maximum(qty, 1)), 2)
        fee = np.round(rng.uniform(0.5, 100.0, k), 2)
        time_ = rng.integers(0, 1440, k).astype(np.int64)
        reason = rng.integers(1, 11, k).astype(np.int64)
        reason_null = rng.random(k) < 0.04
        cash = np.round(amt * rng.uniform(0.3, 1.0, k), 2)
        self.n = k

        def carried(name):
            null = ss.nulls.get(name)
            return ss.arrays[name][take], (None if null is None
                                           else null[take])
        #: name -> (type, values, null mask or None)
        self.cols: Dict[str, tuple] = {
            "sr_returned_date_sk": (DType.LONG, ret_date, sold_null),
            "sr_return_time_sk": (DType.LONG, time_, None)}
        for dst, src in (("item", "item"), ("customer", "customer"),
                         ("cdemo", "cdemo"), ("hdemo", "hdemo"),
                         ("addr", "addr"), ("store", "store")):
            self.cols[f"sr_{dst}_sk"] = (DType.LONG,
                                         *carried(f"ss_{src}_sk"))
        self.cols["sr_reason_sk"] = (DType.LONG, reason, reason_null)
        self.cols["sr_ticket_number"] = (DType.LONG,
                                         *carried("ss_ticket_number"))
        for name, dtype, vals in (
                ("sr_return_quantity", DType.INT, ret_qty),
                ("sr_return_amt", DType.DOUBLE, amt),
                ("sr_return_tax", DType.DOUBLE, np.round(amt * 0.08, 2)),
                ("sr_return_amt_inc_tax", DType.DOUBLE,
                 np.round(amt * 1.08, 2)),
                ("sr_fee", DType.DOUBLE, fee),
                ("sr_refunded_cash", DType.DOUBLE, cash),
                ("sr_net_loss", DType.DOUBLE, np.round(fee + amt * 0.1, 2))):
            self.cols[name] = (dtype, vals, None)

    def replay(self):
        """Every third return with both a customer and a sale date."""
        cust, cust_null = self.cols["sr_customer_sk"][1:]
        date, date_null = self.cols["sr_returned_date_sk"][1:]
        ok = np.flatnonzero(~cust_null & ~date_null)[::3]
        return cust[ok], self.cols["sr_item_sk"][1][ok], date[ok]

    def batch(self, columns: Optional[Sequence[str]]) -> HostBatch:
        return _fact_batch(STORE_RETURNS_COLUMNS, self.cols, self.n, columns)


def _fact_batch(order: Sequence[str], cols: Dict[str, tuple], n: int,
                columns: Optional[Sequence[str]]) -> HostBatch:
    """The columns asked for of a fact held as (type, values, null mask)."""
    t = _Table(order, columns)
    for name in order:
        dtype, vals, null = cols[name]

        def build(dtype=dtype, vals=vals, null=null):
            col = _values(dtype, vals)
            return col if null is None else _nullable(col, null)
        t.add(name, dtype, build)
    return t.batch(n)


class _ChannelSales:
    """The catalog/web sales fact as the JAX generator draws it: all lines
    of an order share its customer, date and addresses; the warehouse
    varies per line. ``replay`` is a (customer, item, date) triple appended
    as single-line orders (catalog_sales' re-buys of returned store
    items). Each column's values and null mask stay, for ``batch`` and for
    the returns sampled from this fact."""

    def __init__(self, scale: float, seed: int, prefix: str,
                 extra: Dict[str, int], replay=None):
        self.names = _channel_columns(prefix, tuple(extra))
        rng = np.random.default_rng(seed + sum(prefix.encode()))
        orders = n_orders(scale)
        lines_per = rng.integers(1, 9, orders)
        n = int(lines_per.sum())
        order_no = np.repeat(np.arange(1, orders + 1, dtype=np.int64),
                             lines_per)
        sizes = [_DAYS, 1440, n_customer(scale), _CD_N, _HD_N,
                 n_address(scale), n_customer(scale), _CD_N, _HD_N,
                 n_address(scale), _N_SHIP_MODES]
        per_order = {"sold_date_sk": rng.integers(0, sizes[0], orders)
                     + _SK0,
                     "sold_time_sk": rng.integers(0, sizes[1], orders)}
        for name, size in zip(_CHANNEL_PER_ORDER[2:], sizes[2:]):
            per_order[name] = rng.integers(1, size + 1, orders)
        for name, size in extra.items():
            per_order[name] = rng.integers(1, size + 1, orders)
        replay_items = None
        if replay is not None:
            r_cust, r_item, r_date = (np.asarray(a, dtype=np.int64)
                                      for a in replay)
            m = r_cust.shape[0]
            per_order = {k: np.concatenate(
                [v, rng.integers(1, int(v.max()) + 1, m)])
                for k, v in per_order.items()}
            per_order["sold_date_sk"][-m:] = np.minimum(
                r_date + rng.integers(1, 90, m), _SK0 + _DAYS - 1)
            per_order["bill_customer_sk"][-m:] = r_cust
            order_no = np.concatenate(
                [order_no, np.arange(orders + 1, orders + m + 1,
                                     dtype=np.int64)])
            replay_items = r_item
            orders += m
            n += m
        per_order["ship_date_sk"] = np.minimum(
            per_order["sold_date_sk"] + rng.integers(1, 121, orders),
            _SK0 + _DAYS - 1)
        p = _price_lines(rng, n)
        ship_cost = np.round(p["qty"] * rng.uniform(0.5, 10.0, n), 2)
        coupon = np.where(rng.random(n) < 0.1,
                          np.round(p["ext_sales"] * rng.uniform(0, 0.5, n),
                                   2), 0.0)
        net_paid = np.round(p["ext_sales"] - coupon, 2)
        tax = np.round(net_paid * 0.08, 2)
        self.n = n
        #: name -> (type, values thunk, null mask or None)
        self.cols: Dict[str, tuple] = {}

        def add(name, dtype, values, null=None):
            self.cols[f"{prefix}_{name}"] = (dtype, values, null)

        for name, arr in per_order.items():
            vals = arr.astype(np.int64)[order_no - 1]
            add(name, DType.LONG, lambda v=vals: v,
                rng.random(n) < 0.04)
        item_sk = rng.integers(1, n_item(scale) + 1, n).astype(np.int64)
        if replay_items is not None:
            item_sk[-replay_items.shape[0]:] = replay_items
        add("item_sk", DType.LONG, lambda: item_sk)
        wh = rng.integers(1, n_warehouse(scale) + 1, n).astype(np.int64)
        add("warehouse_sk", DType.LONG, lambda: wh, rng.random(n) < 0.04)
        promo = rng.integers(1, n_promo(scale) + 1, n).astype(np.int64)
        add("promo_sk", DType.LONG, lambda: promo, rng.random(n) < 0.04)
        add("order_number", DType.LONG, lambda: order_no)
        add("quantity", DType.INT, lambda: p["qty"])
        doubles = {
            "wholesale_cost": lambda: p["wholesale"],
            "list_price": lambda: p["list_price"],
            "sales_price": lambda: p["sales_price"],
            "ext_discount_amt": lambda: p["ext_discount"],
            "ext_sales_price": lambda: p["ext_sales"],
            "ext_wholesale_cost": lambda: p["ext_wholesale"],
            "ext_list_price": lambda: p["ext_list"],
            "ext_tax": lambda: tax, "coupon_amt": lambda: coupon,
            "ext_ship_cost": lambda: ship_cost,
            "net_paid": lambda: net_paid,
            "net_paid_inc_tax": lambda: np.round(net_paid + tax, 2),
            "net_paid_inc_ship": lambda: np.round(net_paid + ship_cost, 2),
            "net_profit": lambda: np.round(net_paid - p["ext_wholesale"],
                                           2)}
        for name, values in doubles.items():
            add(name, DType.DOUBLE, values)

    def values(self, name: str):
        """(values, null mask or None) of a column."""
        _, values, null = self.cols[name]
        return values(), null

    def batch(self, columns: Optional[Sequence[str]]) -> HostBatch:
        t = _Table(self.names, columns)
        for name in self.names:
            dtype, values, null = self.cols[name]

            def build(dtype=dtype, values=values, null=null):
                col = _values(dtype, values())
                return col if null is None else _nullable(col, null)
            t.add(name, dtype, build)
        return t.batch(self.n)


def _catalog_sales(scale: float, seed: int, sr: "_StoreReturns"
                   ) -> _ChannelSales:
    return _ChannelSales(scale, seed, "cs", {
        "call_center_sk": n_call_center(scale),
        "catalog_page_sk": n_catalog_page(scale)}, replay=sr.replay())


def _web_sales(scale: float, seed: int) -> _ChannelSales:
    """The JAX generator's ``gen_web_sales_ds``."""
    return _ChannelSales(scale, seed, "ws", {
        "web_page_sk": n_web_page(scale), "web_site_sk": n_web_site(scale)})




_CR_CARRY = (("cs_item_sk", "cr_item_sk"),
             ("cs_order_number", "cr_order_number"),
             ("cs_bill_customer_sk", "cr_refunded_customer_sk"),
             ("cs_ship_customer_sk", "cr_returning_customer_sk"),
             ("cs_bill_cdemo_sk", "cr_refunded_cdemo_sk"),
             ("cs_bill_addr_sk", "cr_returning_addr_sk"),
             ("cs_call_center_sk", "cr_call_center_sk"),
             ("cs_catalog_page_sk", "cr_catalog_page_sk"),
             ("cs_warehouse_sk", "cr_warehouse_sk"))
_WR_CARRY = (("ws_item_sk", "wr_item_sk"),
             ("ws_order_number", "wr_order_number"),
             ("ws_bill_customer_sk", "wr_refunded_customer_sk"),
             ("ws_bill_cdemo_sk", "wr_refunded_cdemo_sk"),
             ("ws_bill_addr_sk", "wr_refunded_addr_sk"),
             ("ws_ship_customer_sk", "wr_returning_customer_sk"),
             ("ws_web_page_sk", "wr_web_page_sk"))


def _returns_columns(rp: str, carry) -> tuple:
    amount = "return_amount" if rp == "cr" else "return_amt"
    return ((f"{rp}_returned_date_sk", f"{rp}_returned_time_sk")
            + tuple(dst for _, dst in carry)
            + tuple(f"{rp}_{c}" for c in (
                "reason_sk", "return_quantity", amount, "return_tax",
                "return_amt_inc_tax", "fee", "return_ship_cost",
                "refunded_cash", "net_loss")))


CATALOG_RETURNS_COLUMNS = _returns_columns("cr", _CR_CARRY)
WEB_RETURNS_COLUMNS = _returns_columns("wr", _WR_CARRY)


def _channel_returns(seed: int, sales: _ChannelSales, sp: str, rp: str,
                     carry, columns: Optional[Sequence[str]],
                     frac: float = 0.08) -> HostBatch:
    """A returns fact sampled from its sales fact's lines (the same
    order/item link), returned 1-60 days after the sale (the JAX
    generator's ``_gen_channel_returns``)."""
    rng = np.random.default_rng(seed + sum(rp.encode()))
    take = np.flatnonzero(rng.random(sales.n) < frac)
    k = take.shape[0]
    sold, sold_null = sales.values(f"{sp}_sold_date_sk")
    sold, sold_null = sold[take], sold_null[take]
    ret_date = np.minimum(np.where(sold_null, _SK0, sold)
                          + rng.integers(1, 61, k), _SK0 + _DAYS - 1)
    qty = sales.values(f"{sp}_quantity")[0][take]
    net = sales.values(f"{sp}_net_paid")[0][take]
    ret_qty = np.minimum(rng.integers(1, 101, k), qty).astype(np.int32)
    amt = np.round(net * (ret_qty / np.maximum(qty, 1)), 2)
    fee = np.round(rng.uniform(0.5, 100.0, k), 2)
    cols = {f"{rp}_returned_date_sk": (DType.LONG, ret_date, sold_null),
            f"{rp}_returned_time_sk": (
                DType.LONG, rng.integers(0, 1440, k).astype(np.int64), None)}
    for src, dst in carry:
        vals, null = sales.values(src)
        cols[dst] = (DType.LONG, vals[take],
                     None if null is None else null[take])
    reason = rng.integers(1, 11, k).astype(np.int64)
    cols[f"{rp}_reason_sk"] = (DType.LONG, reason, rng.random(k) < 0.04)
    amount = "return_amount" if rp == "cr" else "return_amt"
    ship = np.round(rng.uniform(0.5, 50.0, k) * ret_qty, 2)
    cash = np.round(amt * rng.uniform(0.3, 1.0, k), 2)
    for name, dtype, vals in (
            ("return_quantity", DType.INT, ret_qty),
            (amount, DType.DOUBLE, amt),
            ("return_tax", DType.DOUBLE, np.round(amt * 0.08, 2)),
            ("return_amt_inc_tax", DType.DOUBLE, np.round(amt * 1.08, 2)),
            ("fee", DType.DOUBLE, fee),
            ("return_ship_cost", DType.DOUBLE, ship),
            ("refunded_cash", DType.DOUBLE, cash),
            ("net_loss", DType.DOUBLE, np.round(fee + amt * 0.1, 2))):
        cols[f"{rp}_{name}"] = (dtype, vals, None)
    return _fact_batch(_returns_columns(rp, carry), cols, k, columns)


INVENTORY_COLUMNS = ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                     "inv_quantity_on_hand")


def gen_inventory(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    """Weekly per-item and warehouse snapshots over the whole calendar for
    the first min(items, 300) items, zero-inflated Poisson stock per
    item."""
    t = _Table(INVENTORY_COLUMNS, columns)
    rng = np.random.default_rng(seed + 24)
    items = min(n_item(scale), 300)
    warehouses = n_warehouse(scale)
    week_starts = np.arange(_SK0, _SK0 + _DAYS, 7, dtype=np.int64)
    per_item = warehouses * week_starts.shape[0]
    n = items * per_item
    lam = np.exp(rng.uniform(np.log(0.3), np.log(300.0), items))
    # the mid-price plant (gen_item's %25 == 7 band) keeps steady stock
    lam[np.arange(items) % 25 == 7] = 150.0
    qty = None
    if t.need("inv_quantity_on_hand"):
        qty = rng.poisson(np.repeat(lam, per_item)).astype(np.int32)
    t.add("inv_date_sk", DType.LONG,
          lambda: _i64(np.tile(week_starts, items * warehouses)))
    t.add("inv_item_sk", DType.LONG, lambda: _i64(np.repeat(
        np.arange(1, items + 1, dtype=np.int64), per_item)))
    t.add("inv_warehouse_sk", DType.LONG, lambda: _i64(np.tile(np.repeat(
        np.arange(1, warehouses + 1, dtype=np.int64),
        week_starts.shape[0]), items)))
    if qty is not None:
        build, _ = _null_some(rng, DType.INT, qty, 0.02)
        t.add("inv_quantity_on_hand", DType.INT, build)
    return t.batch(n)


WAREHOUSE_COLUMNS = ("w_warehouse_sk", "w_warehouse_id", "w_warehouse_name",
                     "w_warehouse_sq_ft", "w_city", "w_county", "w_state",
                     "w_country", "w_gmt_offset")
WEB_SITE_COLUMNS = ("web_site_sk", "web_site_id", "web_name",
                    "web_company_name", "web_state", "web_gmt_offset")
WEB_PAGE_COLUMNS = ("wp_web_page_sk", "wp_web_page_id", "wp_char_count",
                    "wp_link_count")
CALL_CENTER_COLUMNS = ("cc_call_center_sk", "cc_call_center_id", "cc_name",
                       "cc_manager", "cc_county")
CATALOG_PAGE_COLUMNS = ("cp_catalog_page_sk", "cp_catalog_page_id",
                        "cp_catalog_number", "cp_catalog_page_number")
SHIP_MODE_COLUMNS = ("sm_ship_mode_sk", "sm_ship_mode_id", "sm_type",
                     "sm_code", "sm_carrier")
REASON_COLUMNS = ("r_reason_sk", "r_reason_id", "r_reason_desc")
INCOME_BAND_COLUMNS = ("ib_income_band_sk", "ib_lower_bound",
                       "ib_upper_bound")
SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY"]
SHIP_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
                 "LATVIAN", "ALLIANCE", "GREAT EASTERN", "DIAMOND", "RUPEKSA"]
REASONS = ["Package was damaged", "Stopped working", "Did not get it on time",
           "Not the product that was ordred", "Parts missing",
           "Does not work with a product that I have",
           "Gift exchange", "Did not like the color",
           "Did not like the model", "Did not fit"]


def gen_warehouse(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_warehouse(scale)
    t = _Table(WAREHOUSE_COLUMNS, columns)
    rng = np.random.default_rng(seed + 21)
    sk = np.arange(1, n + 1, dtype=np.int64)
    sq_ft = rng.integers(50_000, 1_000_000, n)
    t.add("w_warehouse_sk", DType.LONG, lambda: _i64(sk))
    t.add("w_warehouse_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("w_warehouse_name", DType.STRING, lambda: _strings(
        np.char.add("Warehouse no ", sk.astype(str))))
    t.add("w_warehouse_sq_ft", DType.INT, lambda: _i32(sq_ft))
    t.add("w_city", DType.STRING, lambda: _cycle(CITIES, sk))
    t.add("w_county", DType.STRING, lambda: _cycle(COUNTIES, sk))
    t.add("w_state", DType.STRING, lambda: _cycle(STATES, sk))
    t.add("w_country", DType.STRING, lambda: _vocab_strings(
        ["United States"], np.zeros(n, np.int64)))
    t.add("w_gmt_offset", DType.DOUBLE, lambda: _f64(-5.0 - ((sk - 1) % 4)))
    return t.batch(n)


def gen_web_site(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_web_site(scale)
    t = _Table(WEB_SITE_COLUMNS, columns)
    sk = np.arange(1, n + 1, dtype=np.int64)
    t.add("web_site_sk", DType.LONG, lambda: _i64(sk))
    t.add("web_site_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("web_name", DType.STRING, lambda: _strings(
        np.char.add("site_", ((sk - 1) % 4).astype(str))))
    t.add("web_company_name", DType.STRING, lambda: _cycle(
        ["pri", "able", "ought", "ese", "anti", "cally"], sk))
    t.add("web_state", DType.STRING, lambda: _cycle(STATES, sk))
    t.add("web_gmt_offset", DType.DOUBLE,
          lambda: _f64(-5.0 - ((sk - 1) % 4)))
    return t.batch(n)


def gen_web_page(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_web_page(scale)
    t = _Table(WEB_PAGE_COLUMNS, columns)
    rng = np.random.default_rng(seed + 22)
    sk = np.arange(1, n + 1, dtype=np.int64)
    chars = rng.integers(3000, 9000, n)
    links = rng.integers(2, 25, n)
    t.add("wp_web_page_sk", DType.LONG, lambda: _i64(sk))
    t.add("wp_web_page_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("wp_char_count", DType.INT, lambda: _i32(chars))
    t.add("wp_link_count", DType.INT, lambda: _i32(links))
    return t.batch(n)


def gen_call_center(scale: float, seed: int,
                    columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_call_center(scale)
    t = _Table(CALL_CENTER_COLUMNS, columns)
    sk = np.arange(1, n + 1, dtype=np.int64)
    t.add("cc_call_center_sk", DType.LONG, lambda: _i64(sk))
    t.add("cc_call_center_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("cc_name", DType.STRING, lambda: _cycle(
        ["NY Metro", "Mid Atlantic", "North Midwest", "Pacific NW"], sk))
    t.add("cc_manager", DType.STRING, lambda: _cycle(FIRST_NAMES, sk))
    t.add("cc_county", DType.STRING, lambda: _cycle(COUNTIES, sk))
    return t.batch(n)


def gen_catalog_page(scale: float, seed: int,
                     columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_catalog_page(scale)
    t = _Table(CATALOG_PAGE_COLUMNS, columns)
    sk = np.arange(1, n + 1, dtype=np.int64)
    t.add("cp_catalog_page_sk", DType.LONG, lambda: _i64(sk))
    t.add("cp_catalog_page_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("cp_catalog_number", DType.INT, lambda: _i32((sk - 1) // 100 + 1))
    t.add("cp_catalog_page_number", DType.INT,
          lambda: _i32((sk - 1) % 100 + 1))
    return t.batch(n)


def gen_ship_mode(columns: Optional[Sequence[str]] = None) -> HostBatch:
    """Each ship type with each of the first four carriers."""
    t = _Table(SHIP_MODE_COLUMNS, columns)
    n = len(SHIP_TYPES) * 4
    i = np.arange(n, dtype=np.int64)
    sk = i + 1
    t.add("sm_ship_mode_sk", DType.LONG, lambda: _i64(sk))
    t.add("sm_ship_mode_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("sm_type", DType.STRING, lambda: _vocab_strings(SHIP_TYPES, i // 4))
    t.add("sm_code", DType.STRING,
          lambda: _cycle(["AIR", "SURFACE", "SEA"], sk))
    t.add("sm_carrier", DType.STRING,
          lambda: _vocab_strings(SHIP_CARRIERS[:4], i % 4))
    return t.batch(n)


def gen_reason(columns: Optional[Sequence[str]] = None) -> HostBatch:
    t = _Table(REASON_COLUMNS, columns)
    n = len(REASONS)
    sk = np.arange(1, n + 1, dtype=np.int64)
    t.add("r_reason_sk", DType.LONG, lambda: _i64(sk))
    t.add("r_reason_id", DType.STRING, lambda: _ids("AAAAAAAA", sk))
    t.add("r_reason_desc", DType.STRING,
          lambda: _vocab_strings(REASONS, sk - 1))
    return t.batch(n)


def gen_income_band(columns: Optional[Sequence[str]] = None) -> HostBatch:
    t = _Table(INCOME_BAND_COLUMNS, columns)
    sk = np.arange(1, 21, dtype=np.int64)
    t.add("ib_income_band_sk", DType.LONG, lambda: _i64(sk))
    t.add("ib_lower_bound", DType.INT, lambda: _i32((sk - 1) * 10000))
    t.add("ib_upper_bound", DType.INT, lambda: _i32(sk * 10000 - 1))
    return t.batch(20)


def gen_store_returns(scale: float, seed: int,
                      columns: Optional[Sequence[str]] = None) -> HostBatch:
    return _StoreReturns(_StoreSales(scale, seed), seed).batch(columns)


def gen_catalog_sales(scale: float, seed: int,
                      columns: Optional[Sequence[str]] = None) -> HostBatch:
    sr = _StoreReturns(_StoreSales(scale, seed), seed)
    return _catalog_sales(scale, seed, sr).batch(columns)


def gen_catalog_returns(scale: float, seed: int,
                        columns: Optional[Sequence[str]] = None
                        ) -> HostBatch:
    sr = _StoreReturns(_StoreSales(scale, seed), seed)
    return _channel_returns(seed, _catalog_sales(scale, seed, sr), "cs",
                            "cr", _CR_CARRY, columns)


def gen_web_sales(scale: float, seed: int,
                  columns: Optional[Sequence[str]] = None) -> HostBatch:
    """The JAX generator's ``gen_web_sales_ds``."""
    return _web_sales(scale, seed).batch(columns)


def gen_web_returns(scale: float, seed: int,
                    columns: Optional[Sequence[str]] = None) -> HostBatch:
    """The JAX generator's ``gen_web_returns_ds``."""
    return _channel_returns(seed, _web_sales(scale, seed), "ws", "wr",
                            _WR_CARRY, columns)


#: gen_all's tables, in the JAX generator's order
TABLES = ("date_dim", "time_dim", "item", "customer", "customer_address",
          "customer_demographics", "household_demographics", "store",
          "promotion", "warehouse", "web_site", "web_page", "call_center",
          "catalog_page", "ship_mode", "reason", "income_band",
          "store_sales", "store_returns", "catalog_sales", "catalog_returns",
          "web_sales", "web_returns", "inventory")


def gen_all(scale: float = 0.002, seed: int = 0,
            columns: Optional[Dict[str, Sequence[str]]] = None,
            tables: Optional[Sequence[str]] = None
            ) -> Dict[str, HostBatch]:
    """The 24 tables (``tables`` names a subset); ``columns`` maps a table
    to the columns to build (a table it leaves out gets all of them). The
    linked facts share one draw each of store_sales, store_returns,
    catalog_sales and web_sales."""
    cols = columns or {}
    lazy: Dict[str, object] = {}

    def memo(key, make):
        if key not in lazy:
            lazy[key] = make()
        return lazy[key]

    def ss():
        return memo("ss", lambda: _StoreSales(scale, seed))

    def sr():
        return memo("sr", lambda: _StoreReturns(ss(), seed))

    def cs():
        return memo("cs", lambda: _catalog_sales(scale, seed, sr()))

    def ws():
        return memo("ws", lambda: _web_sales(scale, seed))

    build = {
        "date_dim": lambda c: gen_date_dim(c),
        "time_dim": lambda c: gen_time_dim(c),
        "item": lambda c: gen_item(scale, seed, c),
        "customer": lambda c: gen_customer(scale, seed, c),
        "customer_address": lambda c: gen_customer_address(scale, seed, c),
        "customer_demographics": lambda c: gen_customer_demographics(c),
        "household_demographics": lambda c: gen_household_demographics(c),
        "store": lambda c: gen_store(scale, seed, c),
        "promotion": lambda c: gen_promotion(scale, seed, c),
        "warehouse": lambda c: gen_warehouse(scale, seed, c),
        "web_site": lambda c: gen_web_site(scale, seed, c),
        "web_page": lambda c: gen_web_page(scale, seed, c),
        "call_center": lambda c: gen_call_center(scale, seed, c),
        "catalog_page": lambda c: gen_catalog_page(scale, seed, c),
        "ship_mode": lambda c: gen_ship_mode(c),
        "reason": lambda c: gen_reason(c),
        "income_band": lambda c: gen_income_band(c),
        "store_sales": lambda c: ss().batch(c),
        "store_returns": lambda c: sr().batch(c),
        "catalog_sales": lambda c: cs().batch(c),
        "catalog_returns": lambda c: _channel_returns(
            seed, cs(), "cs", "cr", _CR_CARRY, c),
        "web_sales": lambda c: ws().batch(c),
        "web_returns": lambda c: _channel_returns(
            seed, ws(), "ws", "wr", _WR_CARRY, c),
        "inventory": lambda c: gen_inventory(scale, seed, c),
    }
    names = TABLES if tables is None else tuple(tables)
    return {t: build[t](cols.get(t)) for t in names}
