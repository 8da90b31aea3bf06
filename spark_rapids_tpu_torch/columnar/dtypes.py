"""SQL type system and its device (torch) and host (numpy) element types.

The port's own copy of the JAX package's ``columnar/dtypes.py`` type set:
boolean, byte, short, int, long, float, double, string, date, timestamp.
Dates are int32 days since the epoch and timestamps int64 microseconds since
the epoch UTC (Catalyst's physical representation). Strings are a
``uint8[rows, width]`` byte matrix plus int32 lengths; their element type is
the byte.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


class DType(enum.Enum):
    BOOLEAN = "boolean"
    BYTE = "byte"
    SHORT = "short"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    STRING = "string"
    DATE = "date"
    TIMESTAMP = "timestamp"
    NULL = "null"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self in _INTEGRAL

    @property
    def is_floating(self) -> bool:
        return self in (DType.FLOAT, DType.DOUBLE)

    def np_dtype(self) -> np.dtype:
        """Numpy element type of the host data buffer."""
        return _NP[self]

    def torch_dtype(self) -> torch.dtype:
        """Torch element type of the device data buffer."""
        return _TORCH[self]

    @staticmethod
    def common_numeric(a: "DType", b: "DType") -> "DType":
        """Numeric widening like Catalyst's binary-op type coercion."""
        order = [DType.BYTE, DType.SHORT, DType.INT, DType.LONG, DType.FLOAT,
                 DType.DOUBLE]
        if a not in order or b not in order:
            raise TypeError(f"no common numeric type for {a} and {b}")
        return order[max(order.index(a), order.index(b))]

    @staticmethod
    def common_type(a: "DType", b: "DType") -> "DType":
        """Catalyst's least common type of two operands (join keys,
        coalesce): equal types pass, NULL yields the other side, numerics
        widen; anything else raises."""
        if a == b or b is DType.NULL:
            return a
        if a is DType.NULL:
            return b
        return DType.common_numeric(a, b)

    @staticmethod
    def common_type_all(dtypes: Sequence["DType"]) -> "DType":
        out = dtypes[0]
        for dt in dtypes[1:]:
            out = DType.common_type(out, dt)
        return out


_NUMERIC = {DType.BYTE, DType.SHORT, DType.INT, DType.LONG, DType.FLOAT,
            DType.DOUBLE}
_INTEGRAL = {DType.BYTE, DType.SHORT, DType.INT, DType.LONG}

_NP = {
    DType.BOOLEAN: np.dtype(np.bool_),
    DType.BYTE: np.dtype(np.int8),
    DType.SHORT: np.dtype(np.int16),
    DType.INT: np.dtype(np.int32),
    DType.LONG: np.dtype(np.int64),
    DType.FLOAT: np.dtype(np.float32),
    DType.DOUBLE: np.dtype(np.float64),
    DType.STRING: np.dtype(np.uint8),
    DType.DATE: np.dtype(np.int32),
    DType.TIMESTAMP: np.dtype(np.int64),
    DType.NULL: np.dtype(np.int8),
}

_TORCH = {
    DType.BOOLEAN: torch.bool,
    DType.BYTE: torch.int8,
    DType.SHORT: torch.int16,
    DType.INT: torch.int32,
    DType.LONG: torch.int64,
    DType.FLOAT: torch.float32,
    DType.DOUBLE: torch.float64,
    DType.STRING: torch.uint8,
    DType.DATE: torch.int32,
    DType.TIMESTAMP: torch.int64,
    DType.NULL: torch.int8,
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True

    def __repr__(self) -> str:
        return f"{self.name}:{self.dtype.value}{'' if self.nullable else '!'}"


class Schema:
    """Ordered, name-addressable field list."""

    def __init__(self, fields: Sequence[Field]):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}
        if len(self._index) != len(self.fields):
            raise ValueError(f"duplicate field names in {self.fields}")

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def index_of(self, name: str) -> int:
        if name not in self._index:
            raise KeyError(f"no field {name!r} in {self}")
        return self._index[name]

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(repr(f) for f in self.fields) + ")"


def bucket_capacity(num_rows: int, minimum: int = 128) -> int:
    """Power-of-two row capacity of a device batch (the JAX package's
    buckets, kept so both engines lay batches out alike)."""
    cap = minimum
    while cap < num_rows:
        cap <<= 1
    return cap


def string_width_bucket(max_len: int, cap: int) -> int:
    """Per-column string width: the power-of-two bucket covering the longest
    value, clamped to the session cap."""
    w = 8
    while w < max_len:
        w *= 2
    return min(w, cap)
