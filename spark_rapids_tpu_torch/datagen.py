"""Composable random data generation for tests and fuzzing.

Reference analog: integration_tests/src/main/python/data_gen.py (~700 LoC) —
per-type generator classes with weighted special cases feeding the CPU-vs-GPU
compare harness — and FuzzerUtils.scala (random schemas/batches for operator
fuzzing). Same shape here: every generator owns a dtype, a nullability, and a
special-case pool that gets mixed into the random stream, so the edge values
(int extremes, ±0.0, ±inf, NaN, empty/unicode strings, epoch boundaries) hit
every operator the fuzz tests drive.
"""
from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch.columnar.dtypes import DType

_EPOCH = datetime.date(1970, 1, 1)


class DataGen:
    """Base generator: draws from ``_gen`` with ``special_cases`` mixed in at
    ``special_weight`` and nulls at ``null_weight`` when nullable."""

    def __init__(self, dtype: DType, pa_type, nullable: bool = True,
                 special_cases: Sequence = (), special_weight: float = 0.05,
                 null_weight: float = 0.08):
        self.dtype = dtype
        self.pa_type = pa_type
        self.nullable = nullable
        self.special_cases = list(special_cases)
        self.special_weight = special_weight
        self.null_weight = null_weight

    def _gen(self, rng: np.random.Generator):
        raise NotImplementedError

    def value(self, rng: np.random.Generator):
        if self.nullable and rng.random() < self.null_weight:
            return None
        if self.special_cases and rng.random() < self.special_weight:
            return self.special_cases[rng.integers(0, len(self.special_cases))]
        return self._gen(rng)

    def values(self, rng: np.random.Generator, n: int) -> list:
        return [self.value(rng) for _ in range(n)]

    def with_special_case(self, case, weight: Optional[float] = None) -> "DataGen":
        self.special_cases.append(case)
        if weight is not None:
            self.special_weight = weight
        return self


class _IntegralGen(DataGen):
    def __init__(self, dtype, pa_type, lo, hi, nullable=True,
                 min_val=None, max_val=None):
        lo = lo if min_val is None else max(lo, min_val)
        hi = hi if max_val is None else min(hi, max_val)
        super().__init__(dtype, pa_type, nullable,
                         special_cases=[0, 1, -1, lo, hi])
        self.lo, self.hi = lo, hi

    def _gen(self, rng):
        return int(rng.integers(self.lo, self.hi + 1))


class ByteGen(_IntegralGen):
    def __init__(self, nullable=True, min_val=None, max_val=None):
        super().__init__(DType.BYTE, pa.int8(), -128, 127, nullable,
                         min_val, max_val)


class ShortGen(_IntegralGen):
    def __init__(self, nullable=True, min_val=None, max_val=None):
        super().__init__(DType.SHORT, pa.int16(), -(2**15), 2**15 - 1,
                         nullable, min_val, max_val)


class IntegerGen(_IntegralGen):
    def __init__(self, nullable=True, min_val=None, max_val=None):
        super().__init__(DType.INT, pa.int32(), -(2**31), 2**31 - 1,
                         nullable, min_val, max_val)


class LongGen(_IntegralGen):
    def __init__(self, nullable=True, min_val=None, max_val=None):
        super().__init__(DType.LONG, pa.int64(), -(2**63), 2**63 - 1,
                         nullable, min_val, max_val)


class _FloatingGen(DataGen):
    def __init__(self, dtype, pa_type, nullable=True, no_nans=False):
        cases = [0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30, float("inf"),
                 float("-inf")]
        if not no_nans:
            cases.append(float("nan"))
        super().__init__(dtype, pa_type, nullable, special_cases=cases)

    def _gen(self, rng):
        return float(np.round(rng.normal(0, 1e4), 6))


class FloatGen(_FloatingGen):
    def __init__(self, nullable=True, no_nans=False):
        super().__init__(DType.FLOAT, pa.float32(), nullable, no_nans)

    def _gen(self, rng):
        return float(np.float32(super()._gen(rng)))


class DoubleGen(_FloatingGen):
    def __init__(self, nullable=True, no_nans=False):
        super().__init__(DType.DOUBLE, pa.float64(), nullable, no_nans)


class BooleanGen(DataGen):
    def __init__(self, nullable=True):
        super().__init__(DType.BOOLEAN, pa.bool_(), nullable)

    def _gen(self, rng):
        return bool(rng.integers(0, 2))


class StringGen(DataGen):
    """Random strings from a charset (the reference drives sre_yield with a
    regex; a charset + length range covers the same operator surface without
    a regex engine). Unicode and empty strings ride the special-case pool."""

    def __init__(self, charset: str = ("abcdefghijklmnopqrstuvwxyz"
                                       "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "),
                 min_len: int = 0, max_len: int = 20, nullable=True):
        super().__init__(DType.STRING, pa.string(), nullable,
                         special_cases=["", " ", "  leading", "trailing  ",
                                        "Ω≈ç√∫", "æøå", "\t", "0"])
        self.charset = charset
        self.min_len, self.max_len = min_len, max_len

    def _gen(self, rng):
        n = int(rng.integers(self.min_len, self.max_len + 1))
        idx = rng.integers(0, len(self.charset), n)
        return "".join(self.charset[i] for i in idx)


class DateGen(DataGen):
    def __init__(self, nullable=True,
                 start: datetime.date = datetime.date(1590, 1, 1),
                 end: datetime.date = datetime.date(2099, 12, 31)):
        super().__init__(DType.DATE, pa.date32(), nullable,
                         special_cases=[_EPOCH, start, end])
        self.lo = (start - _EPOCH).days
        self.hi = (end - _EPOCH).days

    def _gen(self, rng):
        return _EPOCH + datetime.timedelta(days=int(rng.integers(self.lo,
                                                                 self.hi + 1)))


class TimestampGen(DataGen):
    def __init__(self, nullable=True):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
        super().__init__(DType.TIMESTAMP, pa.timestamp("us", tz="UTC"),
                         nullable, special_cases=[epoch])

    def _gen(self, rng):
        micros = int(rng.integers(-(2**40), 2**41))
        return (datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
                + datetime.timedelta(microseconds=micros))


class NullGen(DataGen):
    def __init__(self):
        super().__init__(DType.NULL, pa.null(), True)

    def value(self, rng):
        return None


#: generators with full-range values, the default fuzz pool (FuzzerUtils set)
ALL_GENS: List[Callable[[], DataGen]] = [
    ByteGen, ShortGen, IntegerGen, LongGen, FloatGen, DoubleGen, BooleanGen,
    StringGen, DateGen, TimestampGen,
]
NUMERIC_GENS = [ByteGen, ShortGen, IntegerGen, LongGen, FloatGen, DoubleGen]


def gen_table(gens: Dict[str, DataGen], length: int, seed: int = 0) -> pa.Table:
    """One arrow table with ``length`` rows drawn from each named generator
    (data_gen.py gen_df analog)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, g in gens.items():
        cols[name] = pa.array(g.values(rng, length), type=g.pa_type)
    return pa.table(cols)


def random_gens(rng: np.random.Generator, n_cols: int,
                pool: Optional[Sequence] = None) -> Dict[str, DataGen]:
    """A random schema (FuzzerUtils.createSchema analog)."""
    pool = list(pool or ALL_GENS)
    return {f"c{i}": pool[rng.integers(0, len(pool))]()
            for i in range(n_cols)}
