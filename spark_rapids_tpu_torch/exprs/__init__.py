"""Expressions of the port: the JAX package's ``exprs/`` but its
input-file metadata (which belongs to the file scan) and its encoded
domain."""
from spark_rapids_tpu_torch.exprs.aggregates import (AggregateFunction, Average,
                                                     BufferSpec, Corr, Count,
                                                     CovarPop, CovarSamp,
                                                     DistinctAgg, First, Last,
                                                     Max, Min, StddevPop,
                                                     StddevSamp, Sum,
                                                     VariancePop, VarianceSamp)
from spark_rapids_tpu_torch.exprs.arithmetic import (Abs, Add, Divide,
                                                     Greatest, IntegralDivide,
                                                     Least, Multiply, Pmod,
                                                     Remainder, Subtract,
                                                     UnaryMinus,
                                                     UnaryPositive)
from spark_rapids_tpu_torch.exprs.bitwise import (BitwiseAnd, BitwiseNot,
                                                  BitwiseOr, BitwiseXor,
                                                  ShiftLeft, ShiftRight,
                                                  ShiftRightUnsigned)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen, If
from spark_rapids_tpu_torch.exprs.core import (BoundReference, ColV, EvalCtx,
                                               Expression, UnresolvedAttribute,
                                               bind_expression)
from spark_rapids_tpu_torch.exprs.datetime import (DateAdd, DateDiff,
                                                   DateSub, DayOfMonth,
                                                   DayOfWeek, DayOfYear,
                                                   FromUnixTime, Hour,
                                                   LastDay, Minute, Month,
                                                   Quarter, Second,
                                                   ToUnixTimestamp,
                                                   UnixTimestamp, WeekDay,
                                                   Year)
from spark_rapids_tpu_torch.exprs.literals import Literal
from spark_rapids_tpu_torch.exprs.math import (Acos, Acosh, Asin, Asinh,
                                               Atan, Atan2, Atanh, Cbrt,
                                               Ceil, Cos, Cosh, Cot, Exp,
                                               Expm1, Floor, Log, Log1p,
                                               Log2, Log10, Logarithm, Pow,
                                               Rint, Round, Signum, Sin,
                                               Sinh, Sqrt, Tan, Tanh,
                                               ToDegrees, ToRadians)
from spark_rapids_tpu_torch.exprs.misc import (
    Alias, KnownFloatingPointNormalized, MonotonicallyIncreasingID,
    NormalizeNaNAndZero, Rand, SortOrder, SparkPartitionID)
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
                                                  InitCap, Length, Like,
                                                  Lower, RegExpReplace,
                                                  RLike, StartsWith,
                                                  StringLocate,
                                                  StringLPad, StringReplace,
                                                  StringRPad, StringSplit,
                                                  StringTrim, StringTrimLeft,
                                                  StringTrimRight, Substring,
                                                  SubstringIndex, Upper)

__all__ = [
    "AggregateFunction", "Average", "BufferSpec", "Corr", "Count",
    "CovarPop", "CovarSamp", "DistinctAgg", "First", "Last", "Max", "Min",
    "StddevPop", "StddevSamp", "Sum", "VariancePop", "VarianceSamp", "Abs",
    "Add", "Divide", "Greatest", "IntegralDivide", "Least", "Multiply",
    "Pmod", "Remainder", "Subtract", "UnaryMinus", "UnaryPositive",
    "BitwiseAnd", "BitwiseNot", "BitwiseOr", "BitwiseXor", "ShiftLeft",
    "ShiftRight", "ShiftRightUnsigned", "Cast", "CaseWhen", "If",
    "BoundReference", "ColV", "EvalCtx", "Expression", "UnresolvedAttribute",
    "bind_expression", "DateAdd", "DateDiff", "DateSub", "DayOfMonth",
    "DayOfWeek", "DayOfYear", "FromUnixTime", "Hour", "LastDay", "Minute",
    "Month", "Quarter", "Second", "ToUnixTimestamp", "UnixTimestamp",
    "WeekDay", "Year", "Literal", "Acos", "Acosh", "Asin", "Asinh", "Atan",
    "Atan2", "Atanh", "Cbrt", "Ceil", "Cos", "Cosh", "Cot", "Exp", "Expm1",
    "Floor", "Log", "Log1p", "Log2", "Log10", "Logarithm", "Pow", "Rint",
    "Round", "Signum", "Sin", "Sinh", "Sqrt", "Tan", "Tanh", "ToDegrees",
    "ToRadians", "Alias", "KnownFloatingPointNormalized",
    "MonotonicallyIncreasingID", "NormalizeNaNAndZero", "Rand", "SortOrder",
    "SparkPartitionID", "AtLeastNNonNulls", "Coalesce", "IsNan", "IsNotNull",
    "IsNull", "NaNvl", "And", "EqualNullSafe", "EqualTo", "GreaterThan",
    "GreaterThanOrEqual", "In", "InSet", "LessThan", "LessThanOrEqual", "Not",
    "NotEqual", "Or", "Concat", "Contains", "EndsWith", "GetArrayItem",
    "InitCap", "Length", "Like", "Lower", "RegExpReplace", "RLike",
    "StartsWith", "StringLocate", "StringLPad", "StringReplace", "StringRPad",
    "StringSplit", "StringTrim", "StringTrimLeft", "StringTrimRight",
    "Substring", "SubstringIndex", "Upper",
]
