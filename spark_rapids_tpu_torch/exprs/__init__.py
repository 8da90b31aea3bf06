"""Expressions of the port: the subset TPC-H Q1, Q3 and Q6 use."""
from spark_rapids_tpu_torch.exprs.aggregates import (AggregateFunction, Average,
                                                     BufferSpec, Count, Sum)
from spark_rapids_tpu_torch.exprs.arithmetic import Add, Multiply, Subtract
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression, UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.exprs.nulls import Coalesce
from spark_rapids_tpu_torch.exprs.predicates import (And, EqualNullSafe,
                                                     EqualTo, GreaterThan,
                                                     GreaterThanOrEqual,
                                                     LessThan, LessThanOrEqual,
                                                     Not, NotEqual, Or)

__all__ = [
    "AggregateFunction", "Average", "BufferSpec", "Count", "Sum", "Add",
    "Multiply", "Subtract", "Cast", "BoundReference", "ColV", "EvalCtx",
    "Expression", "UnresolvedAttribute", "bind_expression", "Literal",
    "Alias", "SortOrder", "Coalesce", "And", "EqualNullSafe", "EqualTo",
    "GreaterThan", "GreaterThanOrEqual", "LessThan", "LessThanOrEqual", "Not",
    "NotEqual", "Or",
]
