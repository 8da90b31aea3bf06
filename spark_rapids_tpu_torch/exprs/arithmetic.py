"""Arithmetic expressions (Spark non-ANSI semantics: integral add, subtract
and multiply wrap like Java two's complement, as torch's do)."""
from __future__ import annotations

from dataclasses import dataclass

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs.core import BinaryExpression, ColV, Expression


class _Arith(BinaryExpression):
    def dtype(self) -> DType:
        return self.operand_dtype()


@dataclass(frozen=True)
class Add(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data + r.data


@dataclass(frozen=True)
class Subtract(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data - r.data


@dataclass(frozen=True)
class Multiply(_Arith):
    l: Expression
    r: Expression

    def do_columnar(self, l: ColV, r: ColV):
        return l.data * r.data
