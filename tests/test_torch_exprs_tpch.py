"""The PyTorch port's TPC-H expressions against the JAX package's same
classes on its numpy engine: Divide, In/InSet, the null predicates,
If/CaseWhen, Year/Month/DayOfMonth (dates before 1970 and leap days), the
constant-pattern string predicates, LIKE (its DFA for inner '%' and '_'),
Substring (on multibyte UTF-8) and Min/Max in every grouping mode. Inputs
are made with numpy from a seed, with nulls and NaNs; every result must be
exact: validity, and the data wherever it is valid. ``dfa_match`` must equal
the JAX package's under ``jax.numpy``."""
import datetime
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exprs as jexprs
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.exprs.core import EvalCtx as JEvalCtx
from spark_rapids_tpu.execs.cpu_execs import _host_colvs
from spark_rapids_tpu.ops import aggregate as jagg
from spark_rapids_tpu.exprs.predicates import InSet as JInSet
from spark_rapids_tpu.ops import regex as jrk
import spark_rapids_tpu_torch.exprs as T
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx
from spark_rapids_tpu_torch.ops import aggregate as tagg
from spark_rapids_tpu_torch.ops import regex as trk

#: the JAX package's expression classes under the port's names
J = types.SimpleNamespace(**vars(jexprs), InSet=JInSet)
N = 256
CPU = torch.device("cpu")
_ALPHABET = ["a", "b", "c", " ", "%", "é", "日"]
_ASCII = ["a", "b", "c", " ", "x"]
_EPOCH = datetime.date(1970, 1, 1)


def _strings(rng, alphabet, n, max_len=12):
    out = []
    for k in rng.integers(0, max_len + 1, n):
        out.append("".join(alphabet[j] for j in
                           rng.integers(0, len(alphabet), k)))
    return out


def _table(seed=3):
    rng = np.random.default_rng(seed)
    null = lambda p=0.15: rng.random(N) < p          # noqa: E731
    d = rng.choice([0.0, -0.0, 1.5, -2.25, 3.0, np.nan, np.inf, 7.25, 1e300],
                   N)
    # days from 1900 to 2100 plus leap days and the days around the epoch
    days = rng.integers(-25567, 47482, N).astype(np.int32)
    specials = [(1900, 2, 28), (1904, 2, 29), (1969, 12, 31), (1970, 1, 1),
                (2000, 2, 29), (2000, 3, 1), (1600, 2, 29), (2024, 2, 29)]
    days[:len(specials)] = [(datetime.date(*s) - _EPOCH).days
                            for s in specials]
    cols = {
        "i": pa.array(rng.integers(-3, 6, N).astype(np.int32), mask=null()),
        "l": pa.array(rng.integers(-2, 3, N).astype(np.int64), mask=null()),
        "d": pa.array(d, mask=null()),
        "s": pa.array(_strings(rng, _ALPHABET, N), mask=null()),
        "a": pa.array(_strings(rng, _ASCII, N), mask=null()),
        "dt": pa.array(days, type=pa.int32(), mask=null()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-3 * 10**15, 3 * 10**15, N),
                       mask=null()).cast(pa.timestamp("us", tz="UTC")),
        "b": pa.array(rng.random(N) < 0.5, mask=null()),
        "k": pa.array(rng.integers(0, 5, N).astype(np.int64), mask=null(0.1)),
    }
    return pa.table(cols)


@pytest.fixture(scope="module")
def inputs():
    table = _table()
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
    jv = je.eval(JEvalCtx(np, jcols, N))
    tv = te.eval(EvalCtx(tcols, N, CPU))
    return jv, tv


def _assert_same(jv, tv):
    jvalid = np.broadcast_to(np.asarray(jv.validity), (N,))
    tvalid = np.broadcast_to(tv.validity.numpy(), (N,))
    assert np.array_equal(jvalid, tvalid)
    if jv.lengths is not None:
        jl = np.broadcast_to(np.asarray(jv.lengths), (N,))
        tl = np.broadcast_to(tv.lengths.numpy(), (N,))
        assert np.array_equal(jl[jvalid], tl[jvalid])
        jd = np.asarray(jv.data)
        td = tv.data.numpy()
        for r in np.nonzero(jvalid)[0]:
            row_j = jd if jd.ndim == 1 else jd[r]
            row_t = td if td.ndim == 1 else td[r]
            assert bytes(row_j[:jl[r]]) == bytes(row_t[:tl[r]]), r
        return
    jd = np.broadcast_to(np.asarray(jv.data), (N,))
    td = np.broadcast_to(tv.data.numpy(), (N,))
    assert jd.dtype == td.dtype
    jd, td = jd[jvalid], td[jvalid]
    if jd.dtype.kind == "f":
        assert np.array_equal(np.isnan(jd), np.isnan(td))
        assert np.array_equal(jd[~np.isnan(jd)], td[~np.isnan(td)])
    else:
        assert np.array_equal(jd, td)


def c(E, name):
    return E.UnresolvedAttribute(name)


EXPRS = {
    "divide": lambda E: E.Divide(c(E, "d"), c(E, "l")),
    "divide_int_by_zero": lambda E: E.Divide(c(E, "i"), E.Literal.of(0)),
    "rdivide": lambda E: E.Divide(E.Literal.of(100.0), c(E, "i")),
    "in_strings": lambda E: E.In(c(E, "a"), (E.Literal.of("ab"),
                                             E.Literal.of("x"),
                                             E.Literal.of("a b c d e f g"))),
    "in_strings_null": lambda E: E.In(c(E, "s"), (E.Literal.of("a"),
                                                  E.Literal.of(None))),
    "in_ints": lambda E: E.In(c(E, "i"), tuple(E.Literal.of(v)
                                               for v in (1, 3, 5))),
    "in_widened": lambda E: E.In(c(E, "i"), (E.Literal.of(1.0),
                                             E.Literal.of(2.5))),
    "in_doubles_nan": lambda E: E.In(c(E, "d"), (E.Literal.of(float("nan")),
                                                 E.Literal.of(1.5))),
    "inset_ints": lambda E: E.InSet(c(E, "l"), tuple(range(-20, 40, 3))),
    "inset_doubles_null": lambda E: E.InSet(c(E, "d"), tuple(
        float(v) for v in range(-10, 10)) + (1.5,), has_null=True),
    "inset_float_items": lambda E: E.InSet(c(E, "i"), tuple(
        v + 0.5 for v in range(-10, 10)) + (3.0,)),
    "is_null": lambda E: E.IsNull(c(E, "s")),
    "is_not_null": lambda E: E.IsNotNull(c(E, "d")),
    "is_nan": lambda E: E.IsNan(c(E, "d")),
    "nanvl": lambda E: E.NaNvl(c(E, "d"), c(E, "l")),
    "at_least_2": lambda E: E.AtLeastNNonNulls(2, (c(E, "d"), c(E, "i"),
                                                   c(E, "s"))),
    "coalesce": lambda E: E.Coalesce((c(E, "i"), c(E, "l"),
                                      E.Literal.of(9))),
    "if_numeric": lambda E: E.If(E.GreaterThan(c(E, "i"), E.Literal.of(0)),
                                 c(E, "d"), c(E, "l")),
    "if_string": lambda E: E.If(c(E, "b"), c(E, "s"), E.Literal.of("zz")),
    "case_when": lambda E: E.CaseWhen(
        ((E.LessThan(c(E, "i"), E.Literal.of(0)), E.Literal.of(1)),
         (E.EqualTo(c(E, "a"), E.Literal.of("a")), c(E, "l"))),
        E.Literal.of(0.5)),
    "case_when_string_no_else": lambda E: E.CaseWhen(
        ((c(E, "b"), c(E, "a")),
         (E.IsNull(c(E, "d")), E.Literal.of("nulls here")))),
    "year": lambda E: E.Year(c(E, "dt")),
    "month": lambda E: E.Month(c(E, "dt")),
    "dayofmonth": lambda E: E.DayOfMonth(c(E, "dt")),
    "year_ts": lambda E: E.Year(c(E, "ts")),
    "month_ts": lambda E: E.Month(c(E, "ts")),
    "dayofmonth_ts": lambda E: E.DayOfMonth(c(E, "ts")),
    "starts_with": lambda E: E.StartsWith(c(E, "s"), E.Literal.of("a")),
    "starts_with_multibyte": lambda E: E.StartsWith(c(E, "s"),
                                                    E.Literal.of("é")),
    "ends_with": lambda E: E.EndsWith(c(E, "s"), E.Literal.of("日")),
    "ends_with_wide": lambda E: E.EndsWith(c(E, "a"),
                                           E.Literal.of("x" * 40)),
    "contains": lambda E: E.Contains(c(E, "s"), E.Literal.of("b c")),
    "contains_empty": lambda E: E.Contains(c(E, "a"), E.Literal.of("")),
    "substring_prefix": lambda E: E.Substring(c(E, "s"), E.Literal.of(1),
                                              E.Literal.of(2)),
    "substring_mid": lambda E: E.Substring(c(E, "s"), E.Literal.of(3),
                                           E.Literal.of(4)),
    "substring_zero": lambda E: E.Substring(c(E, "s"), E.Literal.of(0),
                                            E.Literal.of(3)),
    "substring_negative": lambda E: E.Substring(c(E, "s"), E.Literal.of(-3),
                                                E.Literal.of(2)),
    "substring_long": lambda E: E.Substring(c(E, "s"), E.Literal.of(2),
                                            E.Literal.of(100)),
    "substring_none": lambda E: E.Substring(c(E, "s"), E.Literal.of(2),
                                            E.Literal.of(-1)),
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(inputs, name):
    jv, tv = _eval_both(inputs, EXPRS[name])
    _assert_same(jv, tv)


LIKE_PATTERNS = ["a%", "%b", "%a b%", "ab", "%", "", "a_c%", "%a%b%",
                 "_", "%a%_%c", "x%x%", "a\\%b%"]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_matches_reference(inputs, pattern):
    """On ASCII data the JAX numpy engine's LIKE (Python ``re`` for the
    patterns its classifier rejects) and the port's (the byte DFA) agree."""
    jv, tv = _eval_both(inputs, lambda E: E.Like(c(E, "a"),
                                                 E.Literal.of(pattern)))
    _assert_same(jv, tv)


@pytest.mark.parametrize("regex", ["a.*b.*", ".*a b.*", "(ab|c)+ ?.*",
                                   "[a-b]*x?", ".é.*", "[^a ]+"])
def test_dfa_match_equals_jax(inputs, regex):
    """The anchored DFA scan equals the JAX package's ``jax.lax.scan`` form
    on the multibyte column."""
    jb, tb, _, _ = inputs
    col = tb.column_by_name("s")
    dfa = trk.compile_dfa(regex)
    jdfa = jrk.compile_dfa(regex)
    assert np.array_equal(dfa.trans, jdfa.trans)
    want = np.asarray(jrk.dfa_match(jnp, jdfa, jnp.asarray(col.data),
                                    jnp.asarray(col.lengths)))
    got = trk.dfa_match(dfa, torch.from_numpy(col.data),
                        torch.from_numpy(col.lengths)).numpy()
    assert np.array_equal(got, want)


MINMAX_COLS = ["i", "l", "d", "s", "dt", "b"]


def _grouped(inputs, fns_of, grouping_keys, mode):
    """Both engines' grouped aggregation; the port's groups sorted as the
    JAX sort mode's are (the one-hot and hash modes emit hash order)."""
    jb, tb, jcols, tcols = inputs
    keys = [J.bind_expression(J.UnresolvedAttribute(k), jb.schema)
            for k in grouping_keys]
    tkeys = [T.bind_expression(T.UnresolvedAttribute(k), tb.schema)
             for k in grouping_keys]
    jfns = [J.bind_expression(f, jb.schema) for f in fns_of(J)]
    tfns = [T.bind_expression(f, tb.schema) for f in fns_of(T)]
    jk, jr, jn = jagg.group_aggregate(np, JEvalCtx(np, jcols, N), keys, jfns,
                                      N, N, grouping="sort")[:3]
    tk, tr, tn, flagged = tagg.group_aggregate(EvalCtx(tcols, N, CPU), tkeys,
                                               tfns, N, N, grouping=mode)
    assert not flagged
    assert int(jn) == tn
    if keys and mode != "sort":
        from spark_rapids_tpu_torch.ops import batch_kernels as bk
        alive = torch.arange(tk[0].validity.shape[0]) < tn
        order = bk.sort_indices([(k, True, True) for k in tk], alive)
        tk = [bk.take_colv(k, order) for k in tk]
        tr = [bk.take_colv(r, order) for r in tr]
    return jk, jr, tk, tr, tn


def _assert_rows(jv, tv, n):
    jvalid = np.asarray(jv.validity)[:n]
    assert np.array_equal(jvalid, tv.validity.numpy()[:n])
    jd, td = np.asarray(jv.data)[:n], tv.data.numpy()[:n]
    if jv.lengths is not None:
        jl, tl = np.asarray(jv.lengths)[:n], tv.lengths.numpy()[:n]
        for r in np.nonzero(jvalid)[0]:
            assert bytes(jd[r, :jl[r]]) == bytes(td[r, :tl[r]])
        return
    jd, td = jd[jvalid], td[jvalid]
    if jd.dtype.kind == "f":
        assert np.array_equal(np.isnan(jd), np.isnan(td))
        jd, td = jd[~np.isnan(jd)], td[~np.isnan(td)]
    assert np.array_equal(jd, td)


@pytest.mark.parametrize("mode", ["onehot", "hash", "sort"])
@pytest.mark.parametrize("column", MINMAX_COLS)
def test_min_max_matches_reference(inputs, column, mode):
    """min and max of every type, grouped by a key with nulls, with NaN
    above every other value and null inputs ignored (a string min/max has
    no one-hot form: the exec skips it, and here its hash mode stands in)."""
    if column == "s" and mode == "onehot":
        assert tagg.grouping_modes([1], [T.Min(T.Literal.of("a"))]) == \
            ["hash", "sort"]
        mode = "hash"
    fns = lambda E: [E.Min(c(E, column)), E.Max(c(E, column)),   # noqa: E731
                     E.Count(E.Literal.of(1))]
    jk, jr, tk, tr, n = _grouped(inputs, fns, ["k"], mode)
    for jv, tv in zip(list(jk) + list(jr), list(tk) + list(tr)):
        _assert_rows(jv, tv, n)


@pytest.mark.parametrize("column", MINMAX_COLS)
def test_global_min_max_matches_reference(inputs, column):
    fns = lambda E: [E.Min(c(E, column)), E.Max(c(E, column))]  # noqa: E731
    _, jr, _, tr, n = _grouped(inputs, fns, [], "sort")
    assert n == 1
    for jv, tv in zip(jr, tr):
        _assert_rows(jv, tv, 1)


@pytest.mark.parametrize("mode,keys", [("onehot", ["k", "b"]),
                                       ("hash", ["k", "a"]),
                                       ("sort", ["k", "a"])])
def test_distinct_groups_without_functions(inputs, mode, keys):
    """A group-by with no aggregate function (``distinct``) in every mode
    (the one-hot mode over at most 64 groups)."""
    jk, _, tk, tr, n = _grouped(inputs, lambda E: [], keys, mode)
    assert tr == [] and n > 5
    for jv, tv in zip(jk, tk):
        _assert_rows(jv, tv, n)
