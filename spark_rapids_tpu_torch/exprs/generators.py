"""Generator expressions (the JAX package's ``exprs/generators.py``):
explode of a created array, ``Explode(CreateArray(items))``. Each input
row emits exactly one row per item, the Expand exec's shape. These are
plan-time markers: the DataFrame API pulls an explode out into a
``Generate`` node, and neither reaches expression evaluation (ARRAY is not
a column type)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import Expression


def element_type(items: Tuple[Expression, ...]) -> DType:
    """The items' common type (NULL-typed items do not count)."""
    dt = DType.NULL
    for e in items:
        et = e.dtype()
        if et is not DType.NULL:
            dt = et if dt is DType.NULL else DType.common_type(dt, et)
    return dt


@dataclass(frozen=True)
class CreateArray(Expression):
    """An array of per-row scalar expressions (Spark's CreateArray)."""
    items: Tuple[Expression, ...]

    def dtype(self) -> DType:
        raise TypeError("array values only exist inside explode (ARRAY is "
                        "not a column type)")

    def element_type(self) -> DType:
        return element_type(self.items)


@dataclass(frozen=True)
class Explode(Expression):
    """One output row per array element (Spark's Explode generator);
    ``with_position`` is posexplode, with an INT ``pos`` column."""
    child_array: CreateArray
    with_position: bool = False

    def dtype(self) -> DType:
        return self.child_array.element_type()

    def nullable(self) -> bool:
        return any(e.nullable() for e in self.child_array.items)

    @property
    def name_hint(self) -> str:
        return "col"
