"""PyTorch port's columnar core against the JAX package: a batch carried
across with ``batch_from_numpy`` and a batch uploaded from arrow by the port
must hold exactly the reference ``DeviceBatch.from_arrow`` buffers (same
capacity, padding, validity, string matrix and lengths, double bits), and
the host round trip must give back the reference's ``to_arrow`` table."""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import DeviceBatch as JaxBatch
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.interop import batch_from_numpy
from spark_rapids_tpu_torch.columnar.transfer import download, upload

CPU = torch.device("cpu")
SMAX = 32


def _table(n: int, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    nulls = rng.random((6, n)) < 0.15
    nulls[:, 0] = False      # the reference cannot fill an all-null date column
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324,
                         1.7976931348623157e308])
    dbl = np.where(rng.random(n) < 0.3, specials[rng.integers(0, 7, n)],
                   rng.standard_normal(n) * 1e6)
    words = ["", "a", "héllo", "x" * 20, "tpch", "ÅÄÖ"]
    return pa.table({
        "l": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                      mask=nulls[0]),
        "i": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
        "d": pa.array(dbl, mask=nulls[1]),
        "s": pa.array([words[k] for k in rng.integers(0, 6, n)],
                      mask=nulls[2]),
        "dt": pa.array([datetime.date(1992, 1, 1)
                        + datetime.timedelta(days=int(x))
                        for x in rng.integers(0, 3000, n)],
                       type=pa.date32(), mask=nulls[3]),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls[4]),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
    })


def _reference_buffers(jb: JaxBatch):
    return [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]


def _port_schema(jb: JaxBatch) -> tdt.Schema:
    return tdt.Schema([tdt.Field(f.name, tdt.DType(f.dtype.value), f.nullable)
                       for f in jb.schema])


def _assert_same_buffers(port_batch, ref_buffers, ref_batch: JaxBatch):
    assert port_batch.capacity == ref_batch.capacity
    assert port_batch.num_rows == ref_batch.num_rows
    for c, (data, validity, lengths), rc in zip(port_batch.columns,
                                                ref_buffers,
                                                ref_batch.columns):
        got = c.data.numpy()
        assert got.dtype == data.dtype and got.shape == data.shape
        # bitwise: NaN payloads and -0.0 must survive
        assert got.tobytes() == data.tobytes(), c.dtype
        if rc.bits is not None:
            assert np.array_equal(got.view(np.uint64), np.asarray(rc.bits))
        assert np.array_equal(c.validity.numpy(), validity)
        if lengths is None:
            assert c.lengths is None
        else:
            assert np.array_equal(c.lengths.numpy(), lengths)


@pytest.mark.parametrize("n", [1, 200, 1000])
def test_batch_from_numpy_matches_reference_layout(n):
    t = _table(n)
    jb = JaxBatch.from_arrow(t, string_max_bytes=SMAX)
    ref = _reference_buffers(jb)
    pb = batch_from_numpy(_port_schema(jb), ref, jb.num_rows, CPU)
    _assert_same_buffers(pb, ref, jb)


@pytest.mark.parametrize("n", [1, 200, 1000])
def test_port_upload_matches_reference_from_arrow(n):
    t = _table(n, seed=n)
    jb = JaxBatch.from_arrow(t, string_max_bytes=SMAX)
    pb = upload(HostBatch.from_arrow(t, SMAX), CPU)
    assert [f.name for f in pb.schema] == jb.schema.names()
    assert [f.dtype.value for f in pb.schema] == \
        [f.dtype.value for f in jb.schema]
    _assert_same_buffers(pb, _reference_buffers(jb), jb)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_host_round_trip_matches_reference_to_arrow(n):
    t = _table(n, seed=3)
    jb = JaxBatch.from_arrow(t, string_max_bytes=SMAX)
    back = download(upload(HostBatch.from_arrow(t, SMAX), CPU)).to_arrow()
    want = jb.to_arrow()
    assert back.schema.equals(want.schema)
    assert_tables_equal(want, back)
    # -0.0 and every NaN stay bit-exact through the port
    assert np.asarray(back.column("d").fill_null(0.0)).tobytes() == \
        np.asarray(want.column("d").fill_null(0.0)).tobytes()


def test_oversized_string_raises():
    t = pa.table({"s": ["x" * (SMAX + 1)]})
    with pytest.raises(ValueError, match="string.maxBytes"):
        HostBatch.from_arrow(t, SMAX)


def test_batch_from_numpy_pads_short_arrays():
    schema = tdt.Schema([tdt.Field("v", tdt.DType.LONG)])
    data = np.arange(5, dtype=np.int64)
    pb = batch_from_numpy(schema, [(data, np.ones(5, bool), None)], 5, CPU)
    assert pb.capacity == 128
    assert pb.columns[0].data[:5].tolist() == list(range(5))
    assert not pb.columns[0].validity[5:].any()
    assert not pb.columns[0].data[5:].any()
