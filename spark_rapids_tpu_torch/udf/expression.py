"""Python row-UDF expression (the JAX package's ``udf/expression.py``;
reference analog: GpuScalaUDF.scala, the uncompiled wrapper that keeps the
query correct on the fallback path).

A ``PythonUDF`` has no device rule, so any exec containing one is tagged
"cannot run on TPU" and runs on the CPU engine, where ``eval`` applies the
function row at a time; on the device path it raises. The UDF compiler
(udf/compiler.py) replaces these nodes with expression trees when it can.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression

_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _host_values(v: ColV, n: int):
    """The column's buffers as numpy (a scalar broadcast to ``n`` rows)."""
    data = v.data.numpy()
    valid = v.validity.numpy()
    lengths = None if v.lengths is None else v.lengths.numpy()
    if v.is_scalar:
        data = np.broadcast_to(data, (n,) + data.shape)
        valid = np.broadcast_to(valid, (n,))
        if lengths is not None:
            lengths = np.broadcast_to(lengths, (n,))
    return data, valid, lengths


def _to_python(dtype: DType, data, valid, lengths, i: int) -> Any:
    if not bool(valid[i]):
        return None
    if dtype is DType.STRING:
        return bytes(data[i][:int(lengths[i])]).decode("utf-8",
                                                       errors="replace")
    raw = data[i]
    if dtype is DType.DATE:
        return _EPOCH_DATE + datetime.timedelta(days=int(raw))
    if dtype is DType.TIMESTAMP:
        return _EPOCH_TS + datetime.timedelta(microseconds=int(raw))
    if dtype is DType.BOOLEAN:
        return bool(raw)
    if dtype.is_floating:
        return float(raw)
    return int(raw)


@dataclass(frozen=True)
class PythonUDF(Expression):
    fn: Callable
    ret_dtype: DType
    args: Tuple[Expression, ...]

    def dtype(self) -> DType:
        return self.ret_dtype

    def nullable(self) -> bool:
        return True

    @property
    def name_hint(self) -> str:
        return getattr(self.fn, "__name__", "udf")

    def eval(self, ctx: EvalCtx) -> ColV:
        if not ctx.host_engine:
            raise TypeError("Python UDFs cannot run on device; enable "
                            "spark.rapids.tpu.sql.udfCompiler.enabled or keep "
                            "this exec on the CPU engine")
        n = ctx.capacity
        cols = [(a.dtype(),) + _host_values(a.eval(ctx), n)
                for a in self.args]
        out = []
        valid = np.zeros(n, dtype=bool)
        # the function sees the live rows only, never the padding
        for i in range(ctx.num_rows):
            res = self.fn(*[_to_python(dt, d, v, ln, i)
                            for dt, d, v, ln in cols])
            valid[i] = res is not None
            out.append(res)
        dt = self.ret_dtype
        if dt is DType.STRING:
            data = np.zeros((n, ctx.string_max_bytes), dtype=np.uint8)
            lengths = np.zeros(n, dtype=np.int32)
            for i, res in enumerate(out):
                if res is None:
                    continue
                raw = str(res).encode("utf-8")[:ctx.string_max_bytes]
                data[i, :len(raw)] = bytearray(raw)
                lengths[i] = len(raw)
            return ColV(dt, torch.from_numpy(data), torch.from_numpy(valid),
                        torch.from_numpy(lengths))
        phys = np.zeros(n, dtype=dt.np_dtype())
        for i, res in enumerate(out):
            if res is None:
                continue
            if dt is DType.DATE and isinstance(res, datetime.date):
                res = (res - _EPOCH_DATE).days
            elif dt is DType.TIMESTAMP and isinstance(res, datetime.datetime):
                if res.tzinfo is None:
                    res = res.replace(tzinfo=datetime.timezone.utc)
                res = int(res.timestamp() * 1_000_000)
            phys[i] = res
        return ColV(dt, torch.from_numpy(phys), torch.from_numpy(valid))
