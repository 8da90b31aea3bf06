"""ML integration: a DataFrame's result as tensors on the session's device
(the JAX package's ``ml.py``; reference: ColumnarRdd.scala:49, the
zero-copy ``DataFrame -> RDD[Table]`` export XGBoost consumes, and
InternalColumnarRddConverter.scala:455-476, which cuts the plan at its
columnar-to-row boundary).

The boundary here is the trailing ``DeviceToHostExec``: it is cut off the
executed plan and the device batches under it go to the caller as they
are, with no host round trip between the SQL engine and the model on the
same card. A plan whose root is on the CPU engine gets an upload instead.
The tensors are the engine's own; a consumer takes them as they are or
through DLPack (``torch.utils.dlpack.to_dlpack``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.execs.base import ExecContext


def device_batches(df) -> Iterator[DeviceBatch]:
    """The result as device batches (RDD[Table]). Rows past
    ``batch.num_rows`` are padding the consumer must mask (or use
    ``device_arrays``). The admission semaphore is held for the whole
    iteration, and the action's cleanups run however it ends."""
    from spark_rapids_tpu_torch.execs.tpu_execs import device_root
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    sess = df.session
    final = df.physical_plan()
    sess.last_plan = final
    plan = device_root(final)
    dm = DeviceManager.initialize(sess.conf, sess.device)
    cleanups: List = []
    try:
        with dm.semaphore.held():
            for p in range(plan.num_partitions):
                ctx = ExecContext(sess.conf, sess.device, p,
                                  plan.num_partitions, dm, cleanups)
                yield from plan.execute(ctx)
    finally:
        for fn in cleanups:
            fn()


def device_arrays(df) -> Dict[str, Tuple]:
    """The whole result as column name -> ``(data, validity)`` tensors on
    the session's device, trimmed to the real row count; a string column
    gives ``(byte matrix, validity, lengths)``. One batch is handed over
    as views of its own tensors; several are concatenated once."""
    from spark_rapids_tpu_torch.execs.tpu_execs import concat_device_batches
    sess = df.session
    schema = df.schema()
    batch = concat_device_batches(list(device_batches(df)), schema,
                                  sess.device)
    n = batch.num_rows
    out: Dict[str, Tuple] = {}
    for f, c in zip(schema, batch.columns):
        if f.dtype is DType.STRING:
            out[f.name] = (c.data[:n], c.validity[:n], c.lengths[:n])
        else:
            out[f.name] = (c.data[:n], c.validity[:n])
    return out
