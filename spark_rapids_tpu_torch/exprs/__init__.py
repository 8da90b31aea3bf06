"""Expressions of the port: the subset the 22 TPC-H queries use."""
from spark_rapids_tpu_torch.exprs.aggregates import (AggregateFunction, Average,
                                                     BufferSpec, Count, Max,
                                                     Min, Sum)
from spark_rapids_tpu_torch.exprs.arithmetic import (Add, Divide, Multiply,
                                                     Subtract)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen, If
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression, UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.exprs.datetime import DayOfMonth, Month, Year
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.misc import Alias, SortOrder
from spark_rapids_tpu_torch.exprs.nulls import (AtLeastNNonNulls, Coalesce,
                                                IsNan, IsNotNull, IsNull,
                                                NaNvl)
from spark_rapids_tpu_torch.exprs.predicates import (And, EqualNullSafe,
                                                     EqualTo, GreaterThan,
                                                     GreaterThanOrEqual, In,
                                                     InSet, LessThan,
                                                     LessThanOrEqual, Not,
                                                     NotEqual, Or)
from spark_rapids_tpu_torch.exprs.strings import (Contains, EndsWith, Like,
                                                  StartsWith, Substring)

__all__ = [
    "AggregateFunction", "Average", "BufferSpec", "Count", "Max", "Min",
    "Sum", "Add", "Divide", "Multiply", "Subtract", "Cast", "CaseWhen", "If",
    "BoundReference", "ColV", "EvalCtx", "Expression", "UnresolvedAttribute",
    "bind_expression", "DayOfMonth", "Month", "Year", "Literal", "Alias",
    "SortOrder", "AtLeastNNonNulls", "Coalesce", "IsNan", "IsNotNull",
    "IsNull", "NaNvl", "And", "EqualNullSafe", "EqualTo", "GreaterThan",
    "GreaterThanOrEqual", "In", "InSet", "LessThan", "LessThanOrEqual", "Not",
    "NotEqual", "Or", "Contains", "EndsWith", "Like", "StartsWith",
    "Substring",
]
