"""Shared by ``tests/test_torch_parquet*.py`` and
``tests/test_torch_encoded.py``: the sessions of both packages on the CPU
and the comparison of a port result with a JAX one, floats bit for bit."""
import gc

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JaxSession
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxDeviceManager
from spark_rapids_tpu.testing import assert_tables_equal
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs: the test run's workers share
    the CPUs.

    After the module, the garbage collector runs here: the sessions it
    made sit in reference cycles, and their finalizers, run at a point
    where no lock is held, do not fire later inside a device manager's
    lock (where the JAX package's waits on itself)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def stop_decode_workers():
    """The page-decode processes (io/page_pool.py) a module's scans made
    are stopped after it."""
    from spark_rapids_tpu_torch.io import page_pool
    yield
    page_pool.shutdown()


@pytest.fixture(autouse=True)
def fresh_device_managers():
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()
    yield
    DeviceManager.shutdown()
    JaxDeviceManager.shutdown()


def jax_session(**conf):
    """The JAX package's TPU session (its device path, XLA on the CPU)."""
    return JaxSession({"spark.rapids.tpu.sql.enabled": "true", **conf})


def port_session(**conf):
    return TpuSession(conf, device="cpu")


def _bits(col) -> list:
    """A column's values with floats as their IEEE bit patterns."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_floating(arr.type):
        valid = np.asarray(arr.is_valid())
        raw = np.asarray(arr.fill_null(0)).view(
            np.uint64 if arr.type.bit_width == 64 else np.uint32)
        return [int(b) if v else None for b, v in zip(raw, valid)]
    return arr.to_pylist()


def assert_same(expected: pa.Table, got, sort_by=None) -> None:
    """``got`` (a port HostBatch) equals ``expected`` (an arrow table),
    floats bit for bit."""
    actual = got.to_arrow()
    if sort_by:
        expected, actual = expected.sort_by(sort_by), actual.sort_by(sort_by)
    assert_tables_equal(expected, actual)
    for name in expected.column_names:
        assert _bits(expected.column(name)) == _bits(actual.column(name)), \
            name
