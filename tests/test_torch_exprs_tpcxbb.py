"""The slice-7 modules of the PyTorch port against the JAX package.

The scalar expressions (``Pmod``, ``Round``, ``DateDiff``,
``SubstringIndex``) run against the JAX classes on its numpy engine
(``xp=np``), exactly: validity, and the data wherever it is valid. The
split's DFA span search (``dfa_find_spans``, ``regex_greedy_spans``),
``greedy_matches``, ``spans_inside`` and ``split_field`` run against the
JAX functions under ``jax.numpy``; lag and
lead, framed sums, explode and the moments (stddev, variance, corr,
covar) run through both sessions, the JAX one on its device path (XLA on
the CPU), on seeded inputs with nulls, NaN, ties and multibyte strings.
The moments' and framed sums' inputs are multiples of 1/4, so every sum
is exact in any order and the results must agree to the bit (the
comparison allows relative 1e-9, the variableFloatAgg carve-out)."""
import datetime
import math
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.execs.cpu_execs import _host_colvs
from spark_rapids_tpu.exprs.core import EvalCtx as JEvalCtx
from spark_rapids_tpu.exprs.strings import _regex_spans as j_regex_spans
from spark_rapids_tpu.ops import regex as jrk
from spark_rapids_tpu.ops import strings as jsk
from spark_rapids_tpu.testing import assert_tables_equal
import spark_rapids_tpu_torch.exprs as T
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.execs.tpu_execs import TpuHashAggregateExec
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
from spark_rapids_tpu_torch.exprs.strings import regex_spans
from spark_rapids_tpu_torch.ops import regex as trk
from spark_rapids_tpu_torch.ops import strings as tsk

#: the JAX package's expression classes under the port's names
J = types.SimpleNamespace(**vars(jexprs))
N = 256
CPU = torch.device("cpu")
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "true"}
_EPOCH = datetime.date(1970, 1, 1)
_WORDS = ["great item", "é日 compared to Acme", "", "a. b", "poor",
          "x at store able", "ab", "日本", ". ", "slow. ", "Globex"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test run's workers
    share the CPUs, and torch's pool of a thread per CPU in every worker
    would oversubscribe them on these small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sentences(rng, n):
    """'. '-joined runs of 0-4 phrases (empty, multibyte, and ending or
    starting with the delimiter among them)."""
    out = []
    for k in rng.integers(0, 5, n):
        out.append(". ".join(_WORDS[j] for j in
                             rng.integers(0, len(_WORDS), k)))
    return out


def _scalar_table(seed=5):
    rng = np.random.default_rng(seed)
    null = lambda p=0.1: rng.random(N) < p            # noqa: E731
    halves = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.05, -0.05,
                       1.005, 2.675, -0.0, 0.0, np.nan, np.inf, 1e300,
                       123.456789125, -7.0000000005])
    d = np.concatenate([halves, rng.standard_normal(N - len(halves)) * 50])
    i = rng.integers(-12, 13, N).astype(np.int32)
    i[:4] = [-(2**31), 2**31 - 1, 0, -1]
    l = rng.integers(-5, 6, N).astype(np.int64)
    l[:4] = [-1, -1, 0, 7]
    dt = rng.integers(-800, 20000, N).astype(np.int32)
    return pa.table({
        "i": pa.array(i, mask=null()),
        "l": pa.array(l, mask=null()),
        "d": pa.array(d, mask=null()),
        "f": pa.array(d.astype(np.float32), mask=null()),
        "s": pa.array(_sentences(rng, N), mask=null()),
        "dt": pa.array(dt, type=pa.int32(), mask=null()).cast(pa.date32()),
        "dt2": pa.array(rng.integers(-800, 20000, N).astype(np.int32),
                        type=pa.int32(), mask=null()).cast(pa.date32()),
    })


@pytest.fixture(scope="module")
def inputs():
    table = _scalar_table()
    jb = JHostBatch.from_arrow(table)
    tb = HostBatch.from_arrow(table)
    tcols = [ColV(c.dtype, torch.from_numpy(c.data), torch.from_numpy(
        c.validity), None if c.lengths is None else torch.from_numpy(
        c.lengths)) for c in tb.columns]
    return jb, tb, _host_colvs(jb), tcols


def _eval_both(inputs, build):
    jb, tb, jcols, tcols = inputs
    je = J.bind_expression(build(J), jb.schema)
    te = T.bind_expression(build(T), tb.schema)
    assert je.dtype().value == te.dtype().value
    with np.errstate(all="ignore"):
        jv = je.eval(JEvalCtx(np, jcols, N))
    return jv, te.eval(EvalCtx(tcols, N, CPU))


def _assert_same(jv, tv):
    jvalid = np.broadcast_to(np.asarray(jv.validity), (N,))
    assert np.array_equal(jvalid, np.broadcast_to(tv.validity.numpy(), (N,)))
    if jv.lengths is not None:
        jl = np.broadcast_to(np.asarray(jv.lengths), (N,))
        tl = np.broadcast_to(tv.lengths.numpy(), (N,))
        assert np.array_equal(jl[jvalid], tl[jvalid])
        jd, td = np.asarray(jv.data), tv.data.numpy()
        for r in np.nonzero(jvalid)[0]:
            assert bytes(jd[r][:jl[r]]) == bytes(td[r][:tl[r]]), r
        return
    jd = np.broadcast_to(np.asarray(jv.data), (N,))
    td = np.broadcast_to(tv.data.numpy(), (N,))
    assert jd.dtype == td.dtype
    jd, td = jd[jvalid], td[jvalid]
    if jd.dtype.kind == "f":
        # any NaN is NaN (its payload bits are not a value); every other
        # value, -0.0 included, to the bit
        nan = np.isnan(jd)
        assert np.array_equal(nan, np.isnan(td))
        jd, td = jd[~nan], td[~nan]
    assert jd.tobytes() == td.tobytes()


def c(E, name):
    return E.UnresolvedAttribute(name)


def lit(E, v):
    return E.Literal.of(v)


EXPRS = {
    "pmod_ints": lambda E: E.Pmod(c(E, "i"), c(E, "l")),
    "pmod_int_min_by_minus_one": lambda E: E.Pmod(c(E, "i"), lit(E, -1)),
    "pmod_long_literal": lambda E: E.Pmod(c(E, "l"), lit(E, 3)),
    "pmod_negative_divisor": lambda E: E.Pmod(c(E, "i"), lit(E, -5)),
    "pmod_zero_divisor": lambda E: E.Pmod(c(E, "l"), lit(E, 0)),
    "pmod_doubles": lambda E: E.Pmod(c(E, "d"), c(E, "l")),
    "pmod_double_divisor": lambda E: E.Pmod(c(E, "i"), lit(E, -2.5)),
    "round_half_up": lambda E: E.Round(c(E, "d"), 0),
    "round_scale_1": lambda E: E.Round(c(E, "d"), 1),
    "round_scale_2": lambda E: E.Round(c(E, "d"), 2),
    "round_scale_7": lambda E: E.Round(c(E, "d"), 7),
    "round_negative_scale": lambda E: E.Round(c(E, "d"), -1),
    "round_float32": lambda E: E.Round(c(E, "f"), 1),
    "round_int": lambda E: E.Round(c(E, "i"), 0),
    "round_int_negative_scale": lambda E: E.Round(c(E, "l"), -1),
    "round_ratio": lambda E: E.Round(E.Divide(c(E, "l"), c(E, "i")), 7),
    "datediff": lambda E: E.DateDiff(c(E, "dt"), c(E, "dt2")),
    "datediff_literal": lambda E: E.DateDiff(c(E, "dt"), lit(
        E, datetime.date(2001, 5, 8))),
}
for _count in (1, 2, -1, -2, 0):
    for _name, _delim in (("dot", ". "), ("multibyte", "日"),
                          ("word", "at store ")):
        EXPRS[f"substring_index_{_name}_{_count}"] = (
            lambda E, d=_delim, k=_count: E.SubstringIndex(
                c(E, "s"), lit(E, d), lit(E, k)))


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(inputs, name):
    _assert_same(*_eval_both(inputs, EXPRS[name]))


_PATTERNS = ["\\. ", "a+", "[ab]*c", "(é|日)+", "at store [a-z]+", " "]


@pytest.mark.parametrize("pattern", _PATTERNS)
def test_dfa_spans_equal_jax(inputs, pattern):
    """The span search and the greedy span choice equal the JAX
    package's ``lax.scan`` forms, including patterns whose DFA has a live
    cycle (every step runs) and ones it bounds."""
    _, tb, _, _ = inputs
    col = tb.column_by_name("s")
    data, lengths = col.data, col.lengths
    dfa, jdfa = trk.compile_dfa(pattern), jrk.compile_dfa(pattern)
    want = np.asarray(jrk.dfa_find_spans(jnp, jdfa, jnp.asarray(data),
                                         jnp.asarray(lengths)))
    got = trk.dfa_find_spans(dfa, torch.from_numpy(data),
                             torch.from_numpy(lengths))
    assert np.array_equal(got.numpy(), want)
    W = data.shape[1]
    want_sel = np.asarray(jrk.regex_greedy_spans(jnp, jnp.asarray(want),
                                                 jnp.asarray(lengths), W))
    got_sel = trk.regex_greedy_spans(got, torch.from_numpy(lengths))
    assert np.array_equal(got_sel.numpy(), want_sel)


@pytest.mark.parametrize("needle", [". ", "a", "日", "at store ", "b. a"])
def test_greedy_matches_equal_jax(inputs, needle):
    """The left-to-right choice of a constant needle's occurrences (the
    starts, and the bytes outside every chosen one) equals the JAX
    package's ``lax.scan`` form, overlapping candidates included."""
    _, tb, _, _ = inputs
    col = tb.column_by_name("s")
    W = col.data.shape[1]
    raw = needle.encode()
    want = jsk.greedy_matches(jnp, jnp.asarray(col.data),
                              jnp.asarray(col.lengths), raw, W)
    got = tsk.greedy_matches(torch.from_numpy(col.data),
                             torch.from_numpy(col.lengths), raw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("pattern", ["\\. ", "é"])
def test_split_field_equals_jax(inputs, pattern, k):
    """split(x, p)[k]: the field, its length and whether it exists (a row
    with fewer fields has none), past the last field too."""
    _, tb, _, _ = inputs
    col = tb.column_by_name("s")
    W = col.data.shape[1]
    jd, jl = jnp.asarray(col.data), jnp.asarray(col.lengths)
    jsel, jspan = j_regex_spans(jnp, pattern, jd, jl, W)
    want = jsk.split_field(jnp, jd, jl, jsel, jspan, k, W)
    td, tl = torch.from_numpy(col.data), torch.from_numpy(col.lengths)
    sel, span = regex_spans(pattern, td, tl)
    assert np.array_equal(sel.numpy(), np.asarray(jsel))
    assert np.array_equal(span.numpy(), np.asarray(jspan))
    assert np.array_equal(tsk.spans_inside(sel, span).numpy(),
                          np.asarray(jsk.spans_inside(jnp, jsel, jspan, W)))
    got = tsk.split_field(td, tl, sel, span, k)
    exists = np.asarray(want[2])
    assert np.array_equal(got[2].numpy(), exists)
    wl = np.asarray(want[1])
    assert np.array_equal(got[1].numpy()[exists], wl[exists])
    assert np.array_equal(got[0].numpy()[exists], np.asarray(want[0])[exists])


# ------------------------------------------------------------ sessions
def _table(n: int, groups: int, seed: int) -> pa.Table:
    """Keys with nulls, quarter-multiple doubles with nulls, NaN and
    -0.0, a per-key constant double, ints with ties, strings."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    v = rng.integers(-40, 41, n) / 4.0
    v[rng.random(n) < 0.02] = np.nan
    v[rng.random(n) < 0.02] = -0.0
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "ks": pa.array(np.char.add("g", (k % 997).astype(str)),
                       mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=rng.random(n) < 0.15),
        "z": pa.array((k % 7).astype(np.float64)),
        "w": pa.array(rng.integers(-3, 4, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "t": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.05),
        "s": pa.array(_sentences(rng, n), mask=rng.random(n) < 0.1),
    })


def _both(table, build, ignore_order=True):
    """Run ``build(df, F, Window)`` through both engines -> (port session,
    port result), after holding the two results equal."""
    jsess = JaxSession(CONF)
    want = build(jsess.create_dataframe(table), JF, JWindow).collect()
    sess = TpuSession(CONF, device="cpu")
    got = build(sess.create_dataframe(table), F, Window).collect()
    assert_tables_equal(want, got.to_arrow(), ignore_order=ignore_order,
                        approx_float=1e-9)
    return sess, got


@pytest.mark.parametrize("order", ["t", "t_desc", "two_keys"])
def test_lag_lead_match_reference(order):
    """lag and lead at offsets 1-5 across partition edges, with and
    without defaults, over nullable ints and doubles; ties in the order
    key keep the window sort's (stable) order. (Strings are left out: the
    JAX device path's null default is as wide as the session's string cap,
    and it cannot broadcast it against a narrower column.)"""
    def build(df, f, win):
        o = {"t": [f.col("t")], "t_desc": [f.col("t").desc()],
             "two_keys": [f.col("t"), f.col("w").desc()]}[order]
        ws = win.partitionBy("k").orderBy(*o)
        cols = ["k", "t", "w", "v"]
        for n in range(1, 6):
            cols += [f.lag("w", n).over(ws).alias(f"lw{n}"),
                     f.lead("v", n).over(ws).alias(f"dv{n}")]
        cols += [f.lag("w", 3, -1).over(ws).alias("lwd"),
                 f.lead("v", 2, 0.5).over(ws).alias("dvd")]
        return df.select(*cols)
    _both(_table(2000, 40, seed=21), build, ignore_order=False)


def test_string_lag_lead_match_python():
    """lag and lead over strings, with a default wider and narrower than
    the column, against plain Python over the rows in the window's
    (stable) order; the JAX device path cannot run these (see above)."""
    table = _table(600, 12, seed=26)
    sess = TpuSession(CONF, device="cpu")
    ws = Window.partitionBy("k").orderBy("t")
    got = sess.create_dataframe(table).select(
        "k", "t", "s", F.lag("s", 1).over(ws).alias("l1"),
        F.lead("s", 2, "a default much wider than every sentence in the "
                       "column").over(ws).alias("d2"),
        F.lag("s", 3, "x").over(ws).alias("l3")).collect().to_arrow()
    rows = sorted(table.select(["k", "t", "s"]).to_pylist(),
                  key=lambda r: (r["k"] is not None, r["k"] or 0,
                                 r["t"] is not None, r["t"] or 0))
    want = []
    for i, r in enumerate(rows):
        def at(j, default):
            ok = 0 <= j < len(rows) and rows[j]["k"] == r["k"]
            return rows[j]["s"] if ok else default
        want.append({**r, "l1": at(i - 1, None),
                     "d2": at(i + 2, "a default much wider than every "
                                     "sentence in the column"),
                     "l3": at(i - 3, "x")})
    assert got.to_pylist() == want


def _sum_frames_table(n: int = 1200, seed: int = 22) -> pa.Table:
    """Nullable keys, a unique int order key ``t`` and its double ``d``,
    quarter-multiple doubles with NaN, +inf, -inf and nulls (every finite
    sum exact in any order)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-40, 41, n) / 4.0
    u = rng.random(n)
    v[u < 0.03] = np.nan
    v[(u >= 0.03) & (u < 0.05)] = np.inf
    v[(u >= 0.05) & (u < 0.07)] = -np.inf
    t = rng.permutation(n).astype(np.int64)
    return pa.table({
        "k": pa.array(rng.integers(0, 12, n), mask=rng.random(n) < 0.05),
        "t": pa.array(t), "d": pa.array(t / 4.0),
        "v": pa.array(v, mask=rng.random(n) < 0.15)})


def _frame_fsum(vals):
    """Spark's sum of one frame's values: null when none is valid, NaN for
    a NaN or both infinities, an infinity, else the exact ``math.fsum``."""
    vals = [x for x in vals if x is not None]
    if not vals:
        return None
    if any(math.isnan(x) for x in vals) or (
            math.inf in vals and -math.inf in vals):
        return math.nan
    if math.inf in vals or -math.inf in vals:
        return math.inf if math.inf in vals else -math.inf
    return math.fsum(vals)


def _frame_members(frame: str, ts, j: int):
    """Positions (in ascending ``t``) of row ``j``'s frame."""
    m = len(ts)
    rows = {"running": (0, j), "bounded": (j - 3, j + 2),
            "following": (j + 1, j + 4), "whole": (0, m - 1)}
    if frame in rows:
        lo, hi = rows[frame]
        return range(max(lo, 0), min(hi, m - 1) + 1)
    lo, hi = {"range_int": (ts[j] - 5, ts[j] + 2),
              "range_peers": (-math.inf, ts[j]),
              "range_desc": (ts[j], ts[j] + 3),
              "range_double": (ts[j] - 6, ts[j] + 3)}[frame]
    return [i for i in range(m) if lo <= ts[i] <= hi]


@pytest.mark.parametrize("frame", ["running", "bounded", "following",
                                   "whole", "range_int", "range_peers",
                                   "range_desc", "range_double"])
def test_framed_sums_match_reference(frame):
    """sum/count over ROWS frames (running, bounded both sides,
    following-only, the whole partition) and RANGE frames (offsets on an
    int key, the default peer frame, a descending key, a double key) with
    NaN, +inf and -inf among the values: the port equals Spark's
    per-frame sum (``math.fsum`` of each frame, NaN and the infinities by
    IEEE's rules). The JAX device path differs on every frame but the
    whole partition: it takes a frame's sum from the whole column's prefix
    sums, so a NaN makes every later frame NaN.

    Over the same frames, the integer sum, the count and the average
    (a bounded frame ordered by two keys, and a RANGE frame over a double
    order key with NaN and null rows) equal the JAX package's."""
    def build_exact(df, f, win):
        base = win.partitionBy("k")
        ws = {"running": lambda: base.orderBy("t").rowsBetween(
                  win.unboundedPreceding, win.currentRow),
              "bounded": lambda: base.orderBy("t", "w").rowsBetween(-3, 2),
              "following": lambda: base.orderBy("t").rowsBetween(1, 4),
              "whole": lambda: base.orderBy("t").rowsBetween(
                  win.unboundedPreceding, win.unboundedFollowing),
              "range_int": lambda: base.orderBy("t").rangeBetween(-5, 2),
              "range_peers": lambda: base.orderBy("t"),
              "range_desc": lambda: base.orderBy(
                  f.col("t").desc()).rangeBetween(-3, 0),
              "range_double": lambda: base.orderBy("v").rangeBetween(
                  -1.5, 0.75)}[frame]()
        return df.select("k", "t", "w", "v",
                         f.sum("w").over(ws).alias("sw"),
                         f.count("v").over(ws).alias("n"),
                         f.avg("w").over(ws).alias("aw"))
    _both(_table(2000, 30, seed=22), build_exact, ignore_order=False)

    def build(df, f, win):
        base = win.partitionBy("k")
        ws = {"running": lambda: base.orderBy("t").rowsBetween(
                  win.unboundedPreceding, win.currentRow),
              "bounded": lambda: base.orderBy("t").rowsBetween(-3, 2),
              "following": lambda: base.orderBy("t").rowsBetween(1, 4),
              "whole": lambda: base.orderBy("t").rowsBetween(
                  win.unboundedPreceding, win.unboundedFollowing),
              "range_int": lambda: base.orderBy("t").rangeBetween(-5, 2),
              "range_peers": lambda: base.orderBy("t"),
              "range_desc": lambda: base.orderBy(
                  f.col("t").desc()).rangeBetween(-3, 0),
              "range_double": lambda: base.orderBy("d").rangeBetween(
                  -1.5, 0.75)}[frame]()
        return df.select("k", "t", "v", f.sum("v").over(ws).alias("sv"),
                         f.count("v").over(ws).alias("n"))
    table = _sum_frames_table()
    got = build(TpuSession(CONF, device="cpu").create_dataframe(table), F,
                Window).collect().to_arrow().to_pydict()
    parts = {}
    for k, t, v in zip(*(table[c].to_pylist() for c in ("k", "t", "v"))):
        parts.setdefault(k, []).append((t, v))
    want = {}
    for rows in parts.values():
        rows.sort()
        ts = [t for t, _ in rows]
        for j, (t, _) in enumerate(rows):
            vals = [rows[i][1] for i in _frame_members(frame, ts, j)]
            want[t] = (_frame_fsum(vals),
                       sum(x is not None for x in vals))

    def same(a, b):
        if a is None or b is None:
            return a is b
        return (math.isnan(a) and math.isnan(b)) or a == b
    assert len(got["t"]) == table.num_rows
    for t, sv, n in zip(got["t"], got["sv"], got["n"]):
        assert same(sv, want[t][0]) and n == want[t][1], (t, sv, want[t])
    if frame == "whole":
        return      # the JAX package sums a whole partition unframed
    jax_got = build(JaxSession(CONF).create_dataframe(table), JF,
                    JWindow).collect().to_pydict()
    poisoned = sum(sv is not None and math.isnan(sv)
                   and not math.isnan(want[t][0])
                   for t, sv in zip(jax_got["t"], jax_got["sv"]))
    assert poisoned > 0, "the JAX device path no longer differs"


def test_sessionize_matches_reference():
    """The TPCx-BB sessionization: a lag gap flag, then its running sum."""
    def build(df, f, win):
        w = win.partitionBy("k").orderBy("t")
        cum = w.rowsBetween(win.unboundedPreceding, win.currentRow)
        gap = f.col("t") - f.lag("t", 1).over(w)
        return (df.filter(f.col("k").isNotNull())
                .withColumn("new_s", f.when(gap.isNull() | (gap > 3), 1)
                            .otherwise(0))
                .withColumn("sid", f.sum("new_s").over(cum)))
    _both(_table(3000, 20, seed=23), build, ignore_order=False)


@pytest.mark.parametrize("case", ["nulls", "pos", "split", "numeric"])
def test_explode_matches_reference(case):
    """explode(array(...)) with null elements (null literal items and null
    column values), posexplode, the split-sentence shape of q10/q18/q27
    and numeric items widened to their common type."""
    def build(df, f, win):
        if case == "nulls":
            return df.select("k", f.explode(f.array(
                f.col("s"), f.lit(None), f.col("ks"))).alias("e"))
        if case == "pos":
            return df.select("k", f.posexplode(f.array(
                f.col("ks"), f.col("s"))))
        if case == "split":
            def part(i):
                return f.split(f.col("s"), "\\. ")[i]
            return (df.select("k", f.explode(f.array(
                part(0), part(1), part(2))).alias("sentence"))
                .filter(f.col("sentence").isNotNull()
                        & (f.col("sentence") != "")))
        return df.select("ks", f.explode(f.array(
            f.col("w"), f.col("v"), f.lit(2))).alias("x"))
    _both(_table(1500, 30, seed=24), build)


def test_substring_index_of_split_matches_reference():
    """q18/q27's mention: the text after the last delimiter of each
    sentence that holds one."""
    def build(df, f, win):
        return (df.select("k", f.explode(f.array(
            f.split(f.col("s"), "\\. ")[0], f.split(f.col("s"), "\\. ")[1]))
            .alias("sentence"))
            .filter(f.col("sentence").contains(" compared to "))
            .withColumn("company", f.substring_index(
                f.col("sentence"), " compared to ", -1)))
    _both(_table(1500, 30, seed=25), build)


@pytest.mark.parametrize("mode,keys,groups,rows", [
    ("global", (), 10, 3000),
    ("onehot", ("k",), 20, 3000),
    ("hash", ("ks",), 3000, 12000),
    ("sort", ("k",), 90000, 180000),
])
def test_moments_match_reference(mode, keys, groups, rows):
    """stddev, variance, corr and covar in each grouping mode: groups of
    one row (n < 2: null), constant columns (zero variance: corr null),
    NaN and null inputs."""
    table = _table(rows, groups, seed=groups + 1)

    def build(df, f, _w):
        return df.groupBy(*keys).agg(
            f.stddev("v").alias("sd"), f.stddev_pop("w").alias("sdp"),
            f.variance("z").alias("vz"), f.var_pop("v").alias("vp"),
            f.corr("v", "w").alias("cvw"), f.corr("z", "w").alias("czw"),
            f.covar_samp("w", "v").alias("cs"),
            f.covar_pop("z", "t").alias("cp"),
            f.count("v").alias("n"))

    sess, got = _both(table, build)
    agg = [e for e in sess.last_plan.walk()
           if isinstance(e, TpuHashAggregateExec)]
    assert len(agg) == 1
    if mode == "global":
        assert got.num_rows == 1
    else:
        assert agg[0].modes_run[-1] == mode


def test_moments_need_variable_float_agg():
    """Like the JAX tagger, the port leaves the moments to the CPU engine
    without sql.variableFloatAgg.enabled, even over integers, and the
    result equals the JAX package's fallback."""
    from spark_rapids_tpu_torch.execs.cpu_execs import CpuHashAggregateExec
    table = _table(50, 5, seed=1)
    sess = TpuSession({}, device="cpu")
    got = sess.create_dataframe(table).groupBy("k").agg(
        F.stddev("w").alias("sd")).collect()
    assert [type(e) for e in sess.last_plan.walk()
            if "HashAggregate" in type(e).__name__] == [CpuHashAggregateExec]
    assert "because expression StddevSamp: StddevSamp accumulates double " \
           "buffers whose reduction order varies" in sess.last_explain
    jsess = JaxSession({})
    want = jsess.create_dataframe(table).groupBy("k").agg(
        JF.stddev("w").alias("sd")).collect()
    assert "!CpuHashAggregateExec cannot run on TPU" in jsess.last_explain
    assert_tables_equal(want, got.to_arrow(), ignore_order=True,
                        approx_float=1e-9)
