"""Named expressions, sort ordering, the non-deterministic generators
``rand`` and ``monotonically_increasing_id``, the partition id and the
float normalisation Catalyst plans before grouping (the JAX package's
``exprs/misc.py`` without its input-file metadata, which belongs to the
file scan)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression


@dataclass(frozen=True)
class Alias(Expression):
    c: Expression
    name: str

    def dtype(self) -> DType:
        return self.c.dtype()

    def nullable(self) -> bool:
        return self.c.nullable()

    @property
    def name_hint(self) -> str:
        return self.name

    def eval(self, ctx: EvalCtx) -> ColV:
        return self.c.eval(ctx)

    def __str__(self) -> str:
        return f"{self.c} AS {self.name}"


@dataclass(frozen=True)
class SortOrder(Expression):
    """Sort key spec: direction + null ordering (consumed by the sort exec)."""
    child: Expression
    ascending: bool = True
    nulls_first: bool = True

    def dtype(self) -> DType:
        return self.child.dtype()

    def eval(self, ctx: EvalCtx) -> ColV:
        return self.child.eval(ctx)


@dataclass(frozen=True)
class Rand(Expression):
    """rand(seed): uniform doubles in [0, 1), deterministic per (seed,
    partition). The stream is numpy's default generator seeded with (seed,
    partition, 0), which is the JAX package's CPU-engine stream; its device
    path draws from jax's threefry instead, so the values agree with the
    JAX package's CPU engine only."""
    seed: int = 0

    def dtype(self) -> DType:
        return DType.DOUBLE

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        rng = np.random.default_rng((self.seed, ctx.partition_id, 0))
        data = torch.from_numpy(rng.random(ctx.capacity)).to(ctx.device)
        return ColV(DType.DOUBLE, data,
                    torch.ones(ctx.capacity, dtype=torch.bool,
                               device=ctx.device))


@dataclass(frozen=True)
class MonotonicallyIncreasingID(Expression):
    """(partition_id << 33) + row_offset + the row's index in its batch,
    where ``row_offset`` is the count of the partition's rows in its
    earlier batches (``EvalCtx.row_offset``, kept by the project exec), so
    the ids are unique in every partition of any number of batches. The JAX
    package reads ``ctx.row_offset`` but nothing sets it, so its ids are
    unique only while a partition is one batch; there the two agree. It
    breaks a fused chain, as ``rand`` does."""

    def dtype(self) -> DType:
        return DType.LONG

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        data = ((ctx.partition_id << 33) + ctx.row_offset
                + torch.arange(ctx.capacity, dtype=torch.int64,
                               device=ctx.device))
        return ColV(DType.LONG, data,
                    torch.ones(ctx.capacity, dtype=torch.bool,
                               device=ctx.device))


@dataclass(frozen=True)
class SparkPartitionID(Expression):
    """The ordinal of the partition being evaluated."""

    def dtype(self) -> DType:
        return DType.INT

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        return ColV(DType.INT, torch.full((ctx.capacity,), ctx.partition_id,
                                          dtype=torch.int32,
                                          device=ctx.device),
                    torch.ones(ctx.capacity, dtype=torch.bool,
                               device=ctx.device))


@dataclass(frozen=True)
class KnownFloatingPointNormalized(Expression):
    """Catalyst's marker over an already normalized float: its input."""
    c: Expression

    def dtype(self) -> DType:
        return self.c.dtype()

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        return self.c.eval(ctx)


@dataclass(frozen=True)
class NormalizeNaNAndZero(Expression):
    """Every NaN to the one canonical NaN and -0.0 to 0.0 (before grouping
    or a join)."""
    c: Expression

    def dtype(self) -> DType:
        return self.c.dtype()

    def nullable(self) -> bool:
        return self.c.nullable()

    def eval(self, ctx: EvalCtx) -> ColV:
        v = self.c.eval(ctx)
        d = torch.where(torch.isnan(v.data), float("nan"), v.data)
        return ColV(v.dtype, torch.where(d == 0, 0.0, d).to(v.data.dtype),
                    v.validity, is_scalar=v.is_scalar)


# ---------------------------------------------------------------- input file
#: hidden column names a file scan emits when the plan references input-file
#: metadata (InputFileName / InputFileBlockStart / InputFileBlockLength ride
#: the scan's per-file values)
INPUT_FILE_NAME_COL = "__input_file_name"
INPUT_FILE_START_COL = "__input_file_block_start"
INPUT_FILE_LENGTH_COL = "__input_file_block_length"

#: the spec of the hidden trio, (name, dtype, default outside a file scan),
#: shared by FileScan.schema(), the planner's union defaults and the scan
INPUT_FILE_META_SPEC = (
    (INPUT_FILE_NAME_COL, DType.STRING, ""),
    (INPUT_FILE_START_COL, DType.LONG, -1),
    (INPUT_FILE_LENGTH_COL, DType.LONG, -1),
)


@dataclass(frozen=True)
class _InputFileMeta(Expression):
    """Marker bound by the planner to the scan's hidden metadata column.
    Rows not produced by a file scan get '' / -1 (Spark's defaults)."""

    _col = ""

    def nullable(self) -> bool:
        return False

    def eval(self, ctx: EvalCtx) -> ColV:
        raise TypeError(
            f"{type(self).__name__} must be bound against a file scan "
            "(no file-scan source below this expression)")

    @property
    def name_hint(self) -> str:
        import re
        return re.sub(r"(?<!^)(?=[A-Z])", "_", type(self).__name__).lower()


@dataclass(frozen=True)
class InputFileName(_InputFileMeta):
    _col = INPUT_FILE_NAME_COL

    def dtype(self) -> DType:
        return DType.STRING


@dataclass(frozen=True)
class InputFileBlockStart(_InputFileMeta):
    _col = INPUT_FILE_START_COL

    def dtype(self) -> DType:
        return DType.LONG


@dataclass(frozen=True)
class InputFileBlockLength(_InputFileMeta):
    _col = INPUT_FILE_LENGTH_COL

    def dtype(self) -> DType:
        return DType.LONG
