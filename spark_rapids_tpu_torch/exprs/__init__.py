"""Expressions of the port: the subset the 22 TPC-H queries, the 99 TPC-DS
queries, the 30 TPCx-BB queries and the SQL planner's function table
use."""
from spark_rapids_tpu_torch.exprs.aggregates import (AggregateFunction, Average,
                                                     BufferSpec, Corr, Count,
                                                     CovarPop, CovarSamp,
                                                     DistinctAgg, First, Last,
                                                     Max, Min, StddevPop,
                                                     StddevSamp, Sum,
                                                     VariancePop, VarianceSamp)
from spark_rapids_tpu_torch.exprs.arithmetic import (Abs, Add, Divide,
                                                     Greatest, Least,
                                                     Multiply, Pmod, Subtract,
                                                     UnaryMinus)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen, If
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression, UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.exprs.datetime import (DateAdd, DateDiff,
                                                   DateSub, DayOfMonth,
                                                   Month, WeekDay, Year)
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.math import Ceil, Floor, Pow, Round, Sqrt
from spark_rapids_tpu_torch.exprs.misc import (Alias,
                                               MonotonicallyIncreasingID,
                                               SortOrder)
from spark_rapids_tpu_torch.exprs.nulls import (AtLeastNNonNulls, Coalesce,
                                                IsNan, IsNotNull, IsNull,
                                                NaNvl)
from spark_rapids_tpu_torch.exprs.predicates import (And, EqualNullSafe,
                                                     EqualTo, GreaterThan,
                                                     GreaterThanOrEqual, In,
                                                     InSet, LessThan,
                                                     LessThanOrEqual, Not,
                                                     NotEqual, Or)
from spark_rapids_tpu_torch.exprs.strings import (Concat, Contains,
                                                  EndsWith, GetArrayItem,
                                                  Length, Like, Lower,
                                                  StartsWith, StringLocate,
                                                  StringLPad, StringReplace,
                                                  StringRPad, StringSplit,
                                                  StringTrim, StringTrimLeft,
                                                  StringTrimRight, Substring,
                                                  SubstringIndex, Upper)

__all__ = [
    "AggregateFunction", "Average", "BufferSpec", "Corr", "Count",
    "CovarPop", "CovarSamp", "DistinctAgg", "First", "Last", "Max", "Min",
    "StddevPop", "StddevSamp", "Sum", "VariancePop", "VarianceSamp", "Abs",
    "Add", "Divide", "Greatest", "Least", "Multiply", "Pmod", "Subtract",
    "UnaryMinus", "Cast", "CaseWhen", "If",
    "BoundReference", "ColV", "EvalCtx", "Expression", "UnresolvedAttribute",
    "bind_expression", "DateAdd", "DateDiff", "DateSub", "DayOfMonth",
    "Month", "WeekDay", "Year", "Literal", "Ceil", "Floor", "Pow", "Round",
    "Sqrt", "Alias", "MonotonicallyIncreasingID",
    "SortOrder", "AtLeastNNonNulls", "Coalesce", "IsNan", "IsNotNull",
    "IsNull", "NaNvl", "And", "EqualNullSafe", "EqualTo", "GreaterThan",
    "GreaterThanOrEqual", "In", "InSet", "LessThan", "LessThanOrEqual", "Not",
    "NotEqual", "Or", "Concat", "Contains", "EndsWith", "GetArrayItem",
    "Length", "Like", "Lower", "StartsWith", "StringLocate", "StringLPad",
    "StringReplace", "StringRPad", "StringSplit", "StringTrim",
    "StringTrimLeft", "StringTrimRight", "Substring", "SubstringIndex",
    "Upper",
]
