"""The eight TPC-H tables as ``HostBatch``es, numpy only.

The JAX package's ``benchmarks/tpch_data.py`` dbgen-alike, built straight
into the port's host layout (strings as a byte matrix at the width bucket
plus lengths, dates as int32 days since 1970): for a given scale and seed
every column is byte-equal to the JAX generator's table converted to a
``HostBatch``. ``columns=`` names the columns to build; every random stream
is still drawn in the JAX generator's order up to the last column asked
for, so the values do not change, but the columns not asked for are never
materialized (at SF 10 lineitem's comment alone is 60M numpy strings).
scale=1.0 is about the spec's SF 1 row counts.
"""
from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import (DType, Field, Schema,
                                                    string_width_bucket)
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

_EPOCH = datetime.date(1970, 1, 1)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey): the spec's 25 nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
          "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
          "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
          "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime",
          "linen", "magenta", "maroon", "medium", "metallic", "midnight"]


def _d(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
_WORDS = ["carefully", "furiously", "quickly", "ironic", "final", "bold",
          "pending", "regular", "express", "silent", "even", "blithely",
          "deposits", "packages", "accounts", "theodolites", "instructions",
          "foxes", "pinto", "beans", "dependencies", "platelets"]

N_SUPP_PER_PART = 4
_STRING_MAX_BYTES = 256     # the session default the JAX tables convert at


def n_supplier(scale: float) -> int:
    return max(int(10_000 * scale), 100)


def n_customer(scale: float) -> int:
    return max(int(150_000 * scale), 300)


def n_part(scale: float) -> int:
    return max(int(200_000 * scale), 200)


def n_orders(scale: float) -> int:
    return max(int(1_500_000 * scale), 3000)


def _orderdates(scale: float, seed: int) -> np.ndarray:
    """Order dates from a stream of their own, shared by orders and
    lineitem (ship, commit and receipt dates are offsets from them)."""
    rng = np.random.default_rng((seed + 5) * 1_000_003 + 17)
    return rng.integers(_d(1992, 1, 1), _d(1998, 8, 3),
                        n_orders(scale)).astype(np.int32)


def _ps_suppkey(partkey, i, n_supp):
    """The part -> supplier map shared by partsupp and lineitem."""
    return ((partkey + i * (n_supp // N_SUPP_PER_PART + 1)) % n_supp) + 1


# ------------------------------------------------------------------ columns
def _strings(values: np.ndarray) -> HostColumn:
    """A numpy string array -> byte matrix at the width bucket + lengths."""
    n = values.shape[0]
    raw = values.astype(np.bytes_)          # ASCII: one byte a character
    mat = np.frombuffer(raw.tobytes(), np.uint8).reshape(
        n, raw.dtype.itemsize)
    lengths = (mat != 0).sum(axis=1).astype(np.int32)
    width = string_width_bucket(int(lengths.max(initial=0)),
                                _STRING_MAX_BYTES)
    out = np.zeros((n, width), np.uint8)
    keep = min(width, mat.shape[1])
    out[:, :keep] = mat[:, :keep]
    return HostColumn(DType.STRING, out, np.ones(n, np.bool_), lengths)


def _values(dtype: DType, data: np.ndarray) -> HostColumn:
    return HostColumn(dtype, np.ascontiguousarray(data, dtype.np_dtype()),
                      np.ones(data.shape[0], np.bool_))


class _Table:
    """Columns in table order, each built by a thunk only when asked for;
    ``need(name)`` says whether a column at or after ``name`` is wanted, so
    a generator stops drawing after the last column asked for."""

    def __init__(self, order: Sequence[str], columns: Optional[Sequence[str]]):
        self.order = list(order)
        wanted = self.order if columns is None else list(columns)
        unknown = [c for c in wanted if c not in self.order]
        if unknown:
            raise KeyError(f"no columns {unknown} in {self.order}")
        self.wanted = set(wanted)
        self.last = max(self.order.index(c) for c in wanted) if wanted else -1
        self.cols: Dict[str, HostColumn] = {}
        self.fields: Dict[str, DType] = {}

    def need(self, name: str) -> bool:
        return self.order.index(name) <= self.last

    def add(self, name: str, dtype: DType, build: Callable[[], HostColumn]):
        self.fields[name] = dtype
        if name in self.wanted:
            self.cols[name] = build()

    def batch(self, n: int) -> HostBatch:
        names = [c for c in self.order if c in self.wanted]
        return HostBatch(Schema([Field(c, self.fields[c]) for c in names]),
                         tuple(self.cols[c] for c in names), n)


def _vocab_strings(vocab: Sequence[str], idx: np.ndarray) -> HostColumn:
    """The strings ``vocab[idx]`` as ``_strings`` builds them (the width
    bucket of the longest value used), gathered from the vocabulary's own
    byte matrix instead of made one numpy string at a time."""
    raw = [v.encode() for v in vocab]
    vlen = np.array([len(r) for r in raw], np.int32)
    lengths = vlen[idx]
    width = string_width_bucket(int(lengths.max(initial=0)),
                                _STRING_MAX_BYTES)
    mat = np.zeros((len(raw), width), np.uint8)
    for i, r in enumerate(raw):
        mat[i, :min(len(r), width)] = bytearray(r[:width])
    return HostColumn(DType.STRING, mat[idx], np.ones(idx.shape[0], np.bool_),
                      lengths)


def _comment(rng, n: int, build: bool, salt_phrase=None,
             salt_frac: float = 0.02) -> Optional[HostColumn]:
    """Word-soup comments; ``salt_frac`` of rows embed the two salt words.
    Every comment is one of a small vocabulary (each three-word soup, each
    salted phrase), so the column is gathered from it. With ``build``
    false the same random numbers are drawn and no string is made."""
    nw = len(_WORDS)
    a, b, c = (rng.integers(0, nw, n) for _ in range(3))
    code = (a * nw + b) * nw + c
    vocab = [f"{x} {y} {z}" for x in _WORDS for y in _WORDS for z in _WORDS]
    if salt_phrase is not None:
        hit = rng.random(n) < salt_frac
        mid = rng.integers(0, nw, n)
        last = rng.integers(0, nw, n)
        s1, s2 = salt_phrase
        code = np.where(hit, nw ** 3 + mid * nw + last, code)
        vocab += [f"{s1} {y} {s2} {z}" for y in _WORDS for z in _WORDS]
    return _vocab_strings(vocab, code) if build else None


def _phone(nationkey):
    code = (10 + nationkey).astype(np.int64)
    return np.char.add(code.astype(str),
                       "-" + np.char.zfill(
                           (nationkey * 7919 % 10_000_000).astype(str), 7))


# ------------------------------------------------------------------ tables
REGION_COLUMNS = ("r_regionkey", "r_name", "r_comment")
NATION_COLUMNS = ("n_nationkey", "n_name", "n_regionkey", "n_comment")
SUPPLIER_COLUMNS = ("s_suppkey", "s_name", "s_address", "s_nationkey",
                    "s_phone", "s_acctbal", "s_comment")
PART_COLUMNS = ("p_partkey", "p_name", "p_mfgr", "p_brand", "p_type",
                "p_size", "p_container", "p_retailprice", "p_comment")
PARTSUPP_COLUMNS = ("ps_partkey", "ps_suppkey", "ps_availqty",
                    "ps_supplycost", "ps_comment")
CUSTOMER_COLUMNS = ("c_custkey", "c_name", "c_address", "c_nationkey",
                    "c_phone", "c_acctbal", "c_mktsegment", "c_comment")
ORDERS_COLUMNS = ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                  "o_orderdate", "o_orderpriority", "o_clerk",
                  "o_shippriority", "o_comment")
LINEITEM_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate",
                    "l_commitdate", "l_receiptdate", "l_shipinstruct",
                    "l_shipmode", "l_comment")


def gen_region(columns: Optional[Sequence[str]] = None) -> HostBatch:
    t = _Table(REGION_COLUMNS, columns)
    t.add("r_regionkey", DType.LONG,
          lambda: _values(DType.LONG, np.arange(5, dtype=np.int64)))
    t.add("r_name", DType.STRING, lambda: _strings(np.array(REGIONS)))
    t.add("r_comment", DType.STRING, lambda: _strings(np.array(
        [f"{r.lower()} region" for r in REGIONS])))
    return t.batch(len(REGIONS))


def gen_nation(columns: Optional[Sequence[str]] = None) -> HostBatch:
    t = _Table(NATION_COLUMNS, columns)
    t.add("n_nationkey", DType.LONG,
          lambda: _values(DType.LONG, np.arange(25, dtype=np.int64)))
    t.add("n_name", DType.STRING,
          lambda: _strings(np.array([n for n, _ in NATIONS])))
    t.add("n_regionkey", DType.LONG, lambda: _values(
        DType.LONG, np.array([r for _, r in NATIONS], np.int64)))
    t.add("n_comment", DType.STRING, lambda: _strings(np.array(
        [f"{n.lower()} nation" for n, _ in NATIONS])))
    return t.batch(len(NATIONS))


def gen_supplier(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_supplier(scale)
    t = _Table(SUPPLIER_COLUMNS, columns)
    rng = np.random.default_rng(seed + 1)
    keys = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, n).astype(np.int64) \
        if t.need("s_nationkey") else None
    t.add("s_suppkey", DType.LONG, lambda: _values(DType.LONG, keys))
    t.add("s_name", DType.STRING, lambda: _strings(np.char.add(
        "Supplier#", np.char.zfill(keys.astype(str), 9))))
    t.add("s_address", DType.STRING, lambda: _strings(np.char.add(
        "addr ", keys.astype(str))))
    t.add("s_nationkey", DType.LONG, lambda: _values(DType.LONG, nationkey))
    t.add("s_phone", DType.STRING, lambda: _strings(_phone(nationkey)))
    if t.need("s_acctbal"):
        acctbal = np.round(rng.uniform(-999.99, 9999.99, n), 2)
        t.add("s_acctbal", DType.DOUBLE,
              lambda: _values(DType.DOUBLE, acctbal))
    if t.need("s_comment"):
        comment = _comment(rng, n, "s_comment" in t.wanted,
                           ("Customer", "Complaints"), 0.05)
        t.add("s_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_part(scale: float, seed: int,
             columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_part(scale)
    t = _Table(PART_COLUMNS, columns)
    rng = np.random.default_rng(seed + 3)
    keys = np.arange(1, n + 1, dtype=np.int64)
    t.add("p_partkey", DType.LONG, lambda: _values(DType.LONG, keys))
    if t.last >= 1:
        # the draws before the JAX generator's table literal, in its order;
        # the strings are made only for the columns asked for
        def draw(k):
            return rng.integers(0, k, n)
        name_a, name_b = draw(len(COLORS)), draw(len(COLORS))
        ty = [draw(len(TYPE_1)), draw(len(TYPE_2)), draw(len(TYPE_3))]
        cont = [draw(5), draw(8)]
        brand = rng.integers(1, 6, n) * 10 + rng.integers(1, 6, n)
        t.add("p_name", DType.STRING, lambda: _vocab_strings(
            [f"{x} {y}" for x in COLORS for y in COLORS],
            name_a * len(COLORS) + name_b))
        if t.need("p_mfgr"):
            mfgr = rng.integers(1, 6, n)
            t.add("p_mfgr", DType.STRING, lambda: _vocab_strings(
                [f"Manufacturer#{v}" for v in range(6)], mfgr))
        t.add("p_brand", DType.STRING, lambda: _vocab_strings(
            [f"Brand#{v}" for v in range(56)], brand))
        t.add("p_type", DType.STRING, lambda: _vocab_strings(
            [f"{x} {y} {z}" for x in TYPE_1 for y in TYPE_2 for z in TYPE_3],
            (ty[0] * len(TYPE_2) + ty[1]) * len(TYPE_3) + ty[2]))
        if t.need("p_size"):
            size = rng.integers(1, 51, n).astype(np.int32)
            t.add("p_size", DType.INT, lambda: _values(DType.INT, size))
        t.add("p_container", DType.STRING, lambda: _vocab_strings(
            [f"{x} {y}" for x in CONTAINER_1 for y in CONTAINER_2],
            cont[0] * len(CONTAINER_2) + cont[1]))
        t.add("p_retailprice", DType.DOUBLE, lambda: _values(
            DType.DOUBLE, np.round(900 + (keys % 1000) * 100 / 1000.0
                                   + 100 * (keys % 10), 2)))
        if t.need("p_comment"):
            comment = _comment(rng, n, "p_comment" in t.wanted)
            t.add("p_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_partsupp(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    np_ = n_part(scale)
    n_supp = n_supplier(scale)
    t = _Table(PARTSUPP_COLUMNS, columns)
    rng = np.random.default_rng(seed + 4)
    partkey = np.repeat(np.arange(1, np_ + 1, dtype=np.int64),
                        N_SUPP_PER_PART)
    n = partkey.shape[0]
    t.add("ps_partkey", DType.LONG, lambda: _values(DType.LONG, partkey))
    t.add("ps_suppkey", DType.LONG, lambda: _values(DType.LONG, _ps_suppkey(
        partkey, np.tile(np.arange(N_SUPP_PER_PART, dtype=np.int64), np_),
        n_supp)))
    if t.need("ps_availqty"):
        qty = rng.integers(1, 10_000, n).astype(np.int32)
        t.add("ps_availqty", DType.INT, lambda: _values(DType.INT, qty))
    if t.need("ps_supplycost"):
        cost = np.round(rng.uniform(1.0, 1000.0, n), 2)
        t.add("ps_supplycost", DType.DOUBLE,
              lambda: _values(DType.DOUBLE, cost))
    if t.need("ps_comment"):
        comment = _comment(rng, n, "ps_comment" in t.wanted)
        t.add("ps_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_customer(scale: float, seed: int,
                 columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_customer(scale)
    t = _Table(CUSTOMER_COLUMNS, columns)
    rng = np.random.default_rng(seed + 2)
    keys = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, n).astype(np.int64) \
        if t.need("c_nationkey") else None
    t.add("c_custkey", DType.LONG, lambda: _values(DType.LONG, keys))
    t.add("c_name", DType.STRING, lambda: _strings(np.char.add(
        "Customer#", np.char.zfill(keys.astype(str), 9))))
    t.add("c_address", DType.STRING, lambda: _strings(np.char.add(
        "caddr ", keys.astype(str))))
    t.add("c_nationkey", DType.LONG, lambda: _values(DType.LONG, nationkey))
    t.add("c_phone", DType.STRING, lambda: _strings(_phone(nationkey)))
    if t.need("c_acctbal"):
        acctbal = np.round(rng.uniform(-999.99, 9999.99, n), 2)
        t.add("c_acctbal", DType.DOUBLE,
              lambda: _values(DType.DOUBLE, acctbal))
    if t.need("c_mktsegment"):
        seg = rng.integers(0, 5, n)
        t.add("c_mktsegment", DType.STRING,
              lambda: _vocab_strings(SEGMENTS, seg))
    if t.need("c_comment"):
        comment = _comment(rng, n, "c_comment" in t.wanted)
        t.add("c_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_orders(scale: float, seed: int,
               columns: Optional[Sequence[str]] = None) -> HostBatch:
    n = n_orders(scale)
    n_cust = n_customer(scale)
    t = _Table(ORDERS_COLUMNS, columns)
    rng = np.random.default_rng(seed + 5)
    keys = np.arange(1, n + 1, dtype=np.int64)
    # dbgen gives orders to 2/3 of the customers (custkey % 3 != 0)
    cust_pool = np.arange(1, n_cust + 1, dtype=np.int64)
    cust_pool = cust_pool[cust_pool % 3 != 0]
    orderdate = _orderdates(scale, seed)
    # the status draw comes first in the JAX generator, before any column
    pending = rng.random(n) < 0.05 if t.need("o_orderkey") else None
    t.add("o_orderkey", DType.LONG, lambda: _values(DType.LONG, keys))
    if t.need("o_custkey"):
        cust = cust_pool[rng.integers(0, cust_pool.shape[0], n)]
        t.add("o_custkey", DType.LONG, lambda: _values(DType.LONG, cust))
    t.add("o_orderstatus", DType.STRING, lambda: _vocab_strings(
        ["F", "P", "O"], np.where(orderdate < _d(1995, 6, 17), 0,
                                  np.where(pending, 1, 2))))
    if t.need("o_totalprice"):
        price = np.round(rng.uniform(850.0, 560_000.0, n), 2)
        t.add("o_totalprice", DType.DOUBLE,
              lambda: _values(DType.DOUBLE, price))
    t.add("o_orderdate", DType.DATE, lambda: _values(DType.DATE, orderdate))
    if t.need("o_orderpriority"):
        prio = rng.integers(0, 5, n)
        t.add("o_orderpriority", DType.STRING,
              lambda: _vocab_strings(PRIORITIES, prio))
    if t.need("o_clerk"):
        clerk = rng.integers(1, max(n // 1000, 2), n)
        t.add("o_clerk", DType.STRING, lambda: _strings(np.char.add(
            "Clerk#", np.char.zfill(clerk.astype(str), 9))))
    t.add("o_shippriority", DType.INT,
          lambda: _values(DType.INT, np.zeros(n, np.int32)))
    if t.need("o_comment"):
        comment = _comment(rng, n, "o_comment" in t.wanted,
                           ("special", "requests"), 0.03)
        t.add("o_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_lineitem_full(scale: float, seed: int,
                      columns: Optional[Sequence[str]] = None) -> HostBatch:
    n_ord = n_orders(scale)
    np_ = n_part(scale)
    n_supp = n_supplier(scale)
    t = _Table(LINEITEM_COLUMNS, columns)
    rng = np.random.default_rng(seed + 6)
    lines_per = rng.integers(1, 8, n_ord)
    orderkey = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64), lines_per)
    n = orderkey.shape[0]
    cols: Dict[str, np.ndarray] = {}
    # the draws before the JAX generator's table literal, in its order
    pre: List = [
        ("shipdate", lambda: rng.integers(1, 122, n).astype(np.int32)),
        ("commit", lambda: rng.integers(30, 91, n).astype(np.int32)),
        ("receipt", lambda: rng.integers(1, 31, n).astype(np.int32)),
        ("partkey", lambda: rng.integers(1, np_ + 1, n).astype(np.int64)),
        ("supp_i", lambda: rng.integers(0, N_SUPP_PER_PART, n)),
        ("quantity", lambda: rng.integers(1, 51, n).astype(np.float64)),
        ("price", lambda: rng.uniform(900, 2100, n)),
        ("flag_draw", lambda: rng.random(n) < 0.5),
    ]
    if t.last >= 1:           # anything past l_orderkey needs every pre-draw
        for name, draw in pre:
            cols[name] = draw()
        odate = _orderdates(scale, seed)[orderkey - 1]
        shipdate = odate + cols["shipdate"]
        receiptdate = shipdate + cols["receipt"]
    t.add("l_orderkey", DType.LONG, lambda: _values(DType.LONG, orderkey))
    t.add("l_partkey", DType.LONG,
          lambda: _values(DType.LONG, cols["partkey"]))
    t.add("l_suppkey", DType.LONG, lambda: _values(DType.LONG, _ps_suppkey(
        cols["partkey"], cols["supp_i"], n_supp)))
    t.add("l_linenumber", DType.INT, lambda: _values(DType.INT, (
        np.arange(n, dtype=np.int64)
        - np.repeat(np.cumsum(lines_per) - lines_per, lines_per) + 1)))
    t.add("l_quantity", DType.DOUBLE,
          lambda: _values(DType.DOUBLE, cols["quantity"]))
    t.add("l_extendedprice", DType.DOUBLE, lambda: _values(
        DType.DOUBLE, np.round(cols["quantity"] * cols["price"], 2)))
    for name, lo, hi in (("l_discount", 0.0, 0.1), ("l_tax", 0.0, 0.08)):
        if t.need(name):
            v = np.round(rng.uniform(lo, hi, n), 2)
            t.add(name, DType.DOUBLE, lambda v=v: _values(DType.DOUBLE, v))
    t.add("l_returnflag", DType.STRING, lambda: _vocab_strings(
        ["R", "A", "N"], np.where(receiptdate <= _d(1995, 6, 17),
                                  np.where(cols["flag_draw"], 0, 1), 2)))
    t.add("l_linestatus", DType.STRING, lambda: _vocab_strings(
        ["O", "F"], np.where(shipdate > _d(1995, 6, 17), 0, 1)))
    t.add("l_shipdate", DType.DATE, lambda: _values(DType.DATE, shipdate))
    t.add("l_commitdate", DType.DATE,
          lambda: _values(DType.DATE, odate + cols["commit"]))
    t.add("l_receiptdate", DType.DATE,
          lambda: _values(DType.DATE, receiptdate))
    for name, vocab in (("l_shipinstruct", SHIPINSTRUCT),
                        ("l_shipmode", SHIPMODES)):
        if t.need(name):
            idx = rng.integers(0, len(vocab), n)
            t.add(name, DType.STRING,
                  lambda idx=idx, vocab=vocab: _vocab_strings(vocab, idx))
    if t.need("l_comment"):
        comment = _comment(rng, n, "l_comment" in t.wanted)
        t.add("l_comment", DType.STRING, lambda: comment)
    return t.batch(n)


def gen_all(scale: float = 0.001, seed: int = 0,
            columns: Optional[Dict[str, Sequence[str]]] = None
            ) -> Dict[str, HostBatch]:
    """All eight tables; ``columns`` maps a table to the columns to build
    (a table it leaves out gets all of them)."""
    cols = columns or {}
    return {
        "region": gen_region(cols.get("region")),
        "nation": gen_nation(cols.get("nation")),
        "supplier": gen_supplier(scale, seed, cols.get("supplier")),
        "customer": gen_customer(scale, seed, cols.get("customer")),
        "part": gen_part(scale, seed, cols.get("part")),
        "partsupp": gen_partsupp(scale, seed, cols.get("partsupp")),
        "orders": gen_orders(scale, seed, cols.get("orders")),
        "lineitem": gen_lineitem_full(scale, seed, cols.get("lineitem")),
    }
