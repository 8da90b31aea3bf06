"""The port's 24 TPC-DS generators against the JAX package's, byte for
byte, at scale 0.01 (seed 3) and 0.002 (seed 0): every table of
``gen_all``, each built whole and with subsets of its columns
(``columns=``, whose values must not change), through ``gen_all(tables=)``
(which draws the linked facts once) and through the table's own
generator."""
import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import tpcds_data as jds
from spark_rapids_tpu_torch.benchmarks import tpcds_data as tds
from spark_rapids_tpu_torch.columnar.host import HostBatch

SCALES = {0.01: 3, 0.002: 0}
_REF = {}


def _reference(scale):
    if scale not in _REF:
        _REF[scale] = jds.gen_all(scale, seed=SCALES[scale])
    return _REF[scale]


def _own_generator(table):
    """The table's own port generator as f(scale, seed, columns)."""
    fn = getattr(tds, f"gen_{table}")
    if table in ("date_dim", "time_dim", "customer_demographics",
                 "household_demographics", "ship_mode", "reason",
                 "income_band"):
        return lambda sc, s, c: fn(c)
    return fn


def _assert_same(got: HostBatch, ref):
    want = HostBatch.from_arrow(ref)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    assert got.nbytes == ref.nbytes
    for g, w in zip(got.columns, want.columns):
        assert g.data.shape == w.data.shape
        assert g.data.tobytes() == w.data.tobytes()
        assert np.array_equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        if g.lengths is not None:
            assert np.array_equal(g.lengths, w.lengths)


def test_gen_all_builds_the_reference_tables_in_order():
    got = tds.gen_all(0.002, seed=0)
    assert tuple(got) == tds.TABLES == tuple(_reference(0.002))
    for name, ref in _reference(0.002).items():
        _assert_same(got[name], ref)


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("table", tds.TABLES)
def test_generator_matches_reference(table, scale):
    seed = SCALES[scale]
    ref = _reference(scale)[table]
    order = ref.column_names
    _assert_same(_own_generator(table)(scale, seed, None), ref)
    picks = [[order[-1]], [order[0], order[len(order) // 2]]]
    picks += [[c] for c in order[1:-1]]
    for columns in picks:
        got = tds.gen_all(scale, seed, {table: columns}, tables=[table])
        assert list(got) == [table]
        _assert_same(got[table], ref.select(columns))
