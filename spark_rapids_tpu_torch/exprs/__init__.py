"""Expressions of the port: the subset the 22 TPC-H queries, the TPC-DS
bench subset and the 30 TPCx-BB queries use."""
from spark_rapids_tpu_torch.exprs.aggregates import (AggregateFunction, Average,
                                                     BufferSpec, Corr, Count,
                                                     CovarPop, CovarSamp,
                                                     DistinctAgg, First, Last,
                                                     Max, Min, StddevPop,
                                                     StddevSamp, Sum,
                                                     VariancePop, VarianceSamp)
from spark_rapids_tpu_torch.exprs.arithmetic import (Add, Divide, Multiply,
                                                     Pmod, Subtract)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen, If
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression, UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.exprs.datetime import (DateDiff, DayOfMonth,
                                                   Month, Year)
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.math import Round
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
from spark_rapids_tpu_torch.exprs.strings import (Contains, EndsWith,
                                                  GetArrayItem, Like,
                                                  StartsWith, StringSplit,
                                                  Substring, SubstringIndex)

__all__ = [
    "AggregateFunction", "Average", "BufferSpec", "Corr", "Count",
    "CovarPop", "CovarSamp", "DistinctAgg", "First", "Last", "Max", "Min",
    "StddevPop", "StddevSamp", "Sum", "VariancePop", "VarianceSamp", "Add",
    "Divide", "Multiply", "Pmod", "Subtract", "Cast", "CaseWhen", "If",
    "BoundReference", "ColV", "EvalCtx", "Expression", "UnresolvedAttribute",
    "bind_expression", "DateDiff", "DayOfMonth", "Month", "Year", "Literal",
    "Round", "Alias",
    "SortOrder", "AtLeastNNonNulls", "Coalesce", "IsNan", "IsNotNull",
    "IsNull", "NaNvl", "And", "EqualNullSafe", "EqualTo", "GreaterThan",
    "GreaterThanOrEqual", "In", "InSet", "LessThan", "LessThanOrEqual", "Not",
    "NotEqual", "Or", "Contains", "EndsWith", "GetArrayItem", "Like",
    "StartsWith", "StringSplit", "Substring", "SubstringIndex",
]
