"""Expression tree core: typing, binding and columnar evaluation on tensors.

The JAX package's bound expression tree emits jax operations that its execs
jit into one program; here the same tree evaluates eagerly on torch tensors.
A scalar (a literal) is a 0-d tensor with ``is_scalar=True`` and broadcasts
against columns.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DType, Schema


@dataclass(frozen=True)
class ColV:
    """A columnar value: data + validity (+ lengths for strings)."""
    dtype: DType
    data: Any
    validity: Any
    lengths: Optional[Any] = None
    is_scalar: bool = False

    def with_validity(self, validity: Any) -> "ColV":
        return ColV(self.dtype, self.data, validity, self.lengths,
                    self.is_scalar)


class EvalCtx:
    """Evaluation context: the child batch's columns as ColVs, their row
    capacity, the device new tensors go to, and the string width cap."""

    def __init__(self, columns: Sequence[ColV], capacity: int,
                 device: torch.device, string_max_bytes: int = 256):
        self.columns = list(columns)
        self.capacity = capacity
        self.device = device
        self.string_max_bytes = string_max_bytes


class Expression:
    """Immutable expression node. Subclasses are frozen dataclasses."""

    @property
    def children(self) -> Tuple["Expression", ...]:
        out = []
        for f in fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, Expression):
                out.append(v)
            elif isinstance(v, tuple):
                out.extend(c for c in v if isinstance(c, Expression))
        return tuple(out)

    def map_children(self, fn) -> "Expression":
        kwargs, changed = {}, False
        for f in fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, Expression):
                nv = fn(v)
                changed |= nv is not v
                kwargs[f.name] = nv
            elif isinstance(v, tuple) and any(isinstance(c, Expression)
                                              for c in v):
                nv = tuple(fn(c) if isinstance(c, Expression) else c
                           for c in v)
                changed |= any(a is not b for a, b in zip(nv, v))
                kwargs[f.name] = nv
            else:
                kwargs[f.name] = v
        return type(self)(**kwargs) if changed else self

    def dtype(self) -> DType:
        raise NotImplementedError(type(self).__name__)

    def nullable(self) -> bool:
        return True

    @property
    def name_hint(self) -> str:
        return type(self).__name__.lower()

    def eval(self, ctx: EvalCtx) -> ColV:
        raise NotImplementedError(type(self).__name__)

    def __str__(self) -> str:
        args = ", ".join(str(c) for c in self.children)
        return f"{type(self).__name__}({args})"


@dataclass(frozen=True)
class UnresolvedAttribute(Expression):
    """Column reference by name; must be bound before evaluation."""
    name: str

    def dtype(self) -> DType:
        raise TypeError(f"unresolved attribute {self.name!r} has no type; "
                        f"bind first")

    @property
    def name_hint(self) -> str:
        return self.name

    def __str__(self) -> str:
        return f"'{self.name}"


@dataclass(frozen=True)
class BoundReference(Expression):
    """Column reference by ordinal, resolved against a schema."""
    ordinal: int
    ref_dtype: DType
    ref_nullable: bool = True
    ref_name: str = ""

    def dtype(self) -> DType:
        return self.ref_dtype

    def nullable(self) -> bool:
        return self.ref_nullable

    @property
    def name_hint(self) -> str:
        return self.ref_name or f"c{self.ordinal}"

    def eval(self, ctx: EvalCtx) -> ColV:
        return ctx.columns[self.ordinal]

    def __str__(self) -> str:
        return f"input[{self.ordinal}, {self.ref_dtype.value}]"


def bind_expression(expr: Expression, schema: Schema) -> Expression:
    """Replace every UnresolvedAttribute with a BoundReference."""
    def rec(e: Expression) -> Expression:
        if isinstance(e, UnresolvedAttribute):
            i = schema.index_of(e.name)
            f = schema[i]
            return BoundReference(i, f.dtype, f.nullable, f.name)
        return e.map_children(rec)
    return rec(expr)


def and_validity(*vals: ColV):
    """Validity of a null-intolerant op: all inputs valid."""
    out = None
    for v in vals:
        out = v.validity if out is None else out & v.validity
    return out


class BinaryExpression(Expression):
    """Null-intolerant binary op with numeric widening of operands."""

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    def nullable(self) -> bool:
        return self.left.nullable() or self.right.nullable()

    def operand_dtype(self) -> DType:
        lt, rt = self.left.dtype(), self.right.dtype()
        if lt == rt:
            return lt
        return DType.common_numeric(lt, rt)

    def eval(self, ctx: EvalCtx) -> ColV:
        to = self.operand_dtype()
        l = cast_operand(self.left.eval(ctx), to)
        r = cast_operand(self.right.eval(ctx), to)
        return ColV(self.dtype(), self.do_columnar(l, r), and_validity(l, r),
                    is_scalar=l.is_scalar and r.is_scalar)

    def do_columnar(self, l: ColV, r: ColV):
        raise NotImplementedError


def cast_operand(v: ColV, to: DType) -> ColV:
    """Widen one operand to the common numeric type (no-op when it matches)."""
    if v.dtype == to or v.dtype is DType.STRING:
        return v
    return ColV(to, v.data.to(to.torch_dtype()), v.validity,
                is_scalar=v.is_scalar)


def widen(v: ColV, to: DType, ctx: EvalCtx) -> ColV:
    """A branch value in the branches' common type (the JAX package's
    ``widen``, shared by Coalesce, If and CaseWhen): a NULL-typed value
    becomes an all-null value of ``to`` (strings with zero lengths), and
    numerics widen."""
    if v.dtype == to:
        return v
    if v.dtype is DType.NULL:
        false = torch.zeros_like(v.validity, dtype=torch.bool)
        if to is DType.STRING:
            shape = (8,) if v.is_scalar else (ctx.capacity, 8)
            data = torch.zeros(shape, dtype=torch.uint8, device=ctx.device)
            lengths = torch.zeros(shape[:-1], dtype=torch.int32,
                                  device=ctx.device)
            return ColV(to, data, false, lengths, is_scalar=v.is_scalar)
        return ColV(to, v.data.to(to.torch_dtype()), false,
                    is_scalar=v.is_scalar)
    if v.dtype.is_numeric and to.is_numeric:
        return cast_operand(v, to)
    raise TypeError(f"cannot widen {v.dtype} to {to}")
