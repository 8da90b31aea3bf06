"""PyTorch port's hashes against the JAX package, bit for bit: the 32-bit
exchange hash behind ``hash_partition_ids`` and the 64-bit row hash and
injective key words behind the one-hot grouping (the port holds uint64 in
int64 tensors; the JAX package uses uint64).

The JAX package's device path decomposes a finite double with XLA's
``log2``/``exp2``, which XLA evaluates inexactly for most exponents, so its
numpy engine and its jax path disagree on most finite doubles. The port
computes the exact decomposition: it matches the numpy engine on every
double, and the jax path on the specials and on the exponents where XLA's
``exp2`` is exact (magnitudes in [0.25, 8))."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.dtypes import DType as JDType
from spark_rapids_tpu.execs import exchange_execs as jx
from spark_rapids_tpu.exprs.core import ColV as JColV
from spark_rapids_tpu.ops import batch_kernels as jbk
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.execs import exchange_execs as tx
from spark_rapids_tpu_torch.exprs.core import ColV
from spark_rapids_tpu_torch.ops import batch_kernels as tbk

N = 997
I64 = np.iinfo(np.int64)
SPECIALS = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf])


def _validity(rng, nulls: bool):
    return (rng.random(N) > 0.2) if nulls else np.ones(N, bool)


def _long(rng, nulls=False):
    d = rng.integers(I64.min, I64.max, N, dtype=np.int64)
    d[:6] = [I64.min, I64.max, 0, -1, 1, I64.min + 1]
    return "long", d, _validity(rng, nulls), None


def _double(rng, nulls=False, exact_range=True):
    if exact_range:   # magnitudes where XLA's exp2 is exact
        d = rng.uniform(0.25, 8.0, N) * rng.choice([-1.0, 1.0], N)
    else:
        d = rng.standard_normal(N) * 10.0 ** rng.integers(-300, 300, N)
        d[6:9] = [5e-324, 2.0 ** -1022, 1.7976931348623157e308]
    d[:len(SPECIALS)] = SPECIALS
    d[rng.random(N) < 0.1] = np.nan
    return "double", d, _validity(rng, nulls), None


def _string(rng, nulls=False):
    width = 16
    lengths = rng.integers(0, width + 1, N).astype(np.int32)
    data = rng.integers(0, 256, (N, width)).astype(np.uint8)
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    data[:3] = 0xFF                       # high bytes: sign bits of words
    lengths[:3] = width
    return "string", data, _validity(rng, nulls), lengths


def _bool(rng, nulls=False):
    return "boolean", rng.random(N) < 0.5, _validity(rng, nulls), None


def _int(rng, nulls=False):
    d = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    d[:2] = [-2**31, 2**31 - 1]
    return "int", d, _validity(rng, nulls), None


MAKERS = {"long": _long, "double": _double, "string": _string, "bool": _bool,
          "int": _int}


def _cols(names, nulls, seed=0, **kw):
    rng = np.random.default_rng(seed)
    specs = [MAKERS[n](rng, nulls, **kw) if n == "double" else
             MAKERS[n](rng, nulls) for n in names]
    jax_cols = [JColV(JDType(dt), jnp.asarray(d), jnp.asarray(v),
                      None if ln is None else jnp.asarray(ln))
                for dt, d, v, ln in specs]
    np_cols = [JColV(JDType(dt), d, v, ln) for dt, d, v, ln in specs]
    torch_cols = [ColV(DType(dt), torch.from_numpy(np.ascontiguousarray(d)),
                       torch.from_numpy(v),
                       None if ln is None else torch.from_numpy(ln))
                  for dt, d, v, ln in specs]
    return jax_cols, np_cols, torch_cols


KEY_SETS = [("long",), ("double",), ("string",), ("bool",), ("int",),
            ("string", "string"), ("long", "double", "string", "bool")]


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("keys", KEY_SETS, ids="-".join)
def test_hash_partition_ids_bit_identical(keys, nulls):
    jc, _, tc = _cols(keys, nulls, seed=len(keys))
    for n in (2, 7, 8, 32):
        want = np.asarray(jx.hash_partition_ids(jnp, jc, N, n))
        got = tx.hash_partition_ids(tc, N, n).numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got, want), (keys, n)


def test_column_hash_bit_identical_on_all_doubles():
    """The 32-bit exchange hash bitcasts canonical doubles: no exp2 there,
    so it matches the JAX path on every normal double and the numpy engine
    on every double. (XLA on the CPU flushes subnormals to zero, so the JAX
    path hashes 5e-324 as 0.0; the port, like numpy, does not.)"""
    jc, nc, tc = _cols(("double",), True, exact_range=False)
    got = tx._column_hash(tc[0]).numpy().astype(np.uint32)
    with np.errstate(all="ignore"):
        assert np.array_equal(got, jx._column_hash(np, nc[0]))
    d = nc[0].data
    normal = ~((d != 0) & (np.abs(d) < np.finfo(np.float64).tiny))
    want = np.asarray(jx._column_hash(jnp, jc[0]))
    assert np.array_equal(got[normal], want[normal])


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("keys", KEY_SETS, ids="-".join)
def test_hash64_cols_bit_identical_to_jax(keys, nulls):
    jc, _, tc = _cols(keys, nulls, seed=3)
    want = np.asarray(jbk.hash64_cols(jnp, jc))
    got = tbk.hash64_cols(tc).numpy().view(np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("keys", [("double",), ("long", "double")],
                         ids="-".join)
def test_hash64_cols_bit_identical_to_numpy_engine_on_all_doubles(keys):
    _, nc, tc = _cols(keys, True, seed=5, exact_range=False)
    with np.errstate(all="ignore"):
        want = jbk.hash64_cols(np, nc)
    got = tbk.hash64_cols(tc).numpy().view(np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["long", "double", "string", "bool", "int"])
def test_key_words_bit_identical(name):
    jc, nc, tc = _cols((name,), True, seed=9)
    want = [np.asarray(w) for w in jbk.key_words(jnp, jc[0])]
    got = [w.numpy().view(np.uint64) for w in tbk.key_words(tc[0])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(
        tbk.validity_word(tc).numpy().view(np.uint64),
        np.asarray(jbk.validity_word(jnp, jc)))


def test_unsigned_order_sorts_like_uint64():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64)
    u[:3] = [0, 2**63, 2**64 - 1]
    t = torch.from_numpy(u.view(np.int64))
    order = torch.argsort(tbk.unsigned_order(t), stable=True).numpy()
    assert np.array_equal(u[order], np.sort(u))
