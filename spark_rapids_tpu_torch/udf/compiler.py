"""Python-bytecode -> expression-tree UDF compiler.

Reference analog: the udf-compiler module — LambdaReflection.scala (bytecode
access), CFG.scala:44 (basic blocks), Instruction.scala:83 (symbolic stack
interpreter over ~100 JVM opcodes), CatalystExpressionBuilder.scala:45 (drives
traversal, emits Catalyst). Same two-stage strategy here: the compiled output
is one of OUR expressions, which then rides the normal plan-rewrite path onto
the TPU — the compiler never generates device code itself.

This interpreter walks CPython 3.10–3.12 bytecode symbolically: the operand
stack holds Expression nodes; a conditional jump forks interpretation down
both successors and joins them as an If over the two reachable RETURNs
(loops and anything else unsupported raise UdfCompileError, leaving the UDF
on the row-wise fallback path — the reference falls back identically when
its opcode coverage runs out). Pre-3.11 spellings (BINARY_ADD et al.,
CALL_FUNCTION/CALL_METHOD, JUMP_IF_*_OR_POP, unflagged LOAD_GLOBAL) are
handled alongside the 3.11+ forms, the same version-drift posture as
shims/ takes for jax.
"""
from __future__ import annotations

import dis
import math
import sys
from typing import Any, Dict, List, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.exprs import arithmetic as ar
from spark_rapids_tpu_torch.exprs import bitwise as bw
from spark_rapids_tpu_torch.exprs import conditional as cond
from spark_rapids_tpu_torch.exprs import math as ma
from spark_rapids_tpu_torch.exprs import nulls as nu
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as st
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import Expression
from spark_rapids_tpu_torch.exprs.literals import Literal


class UdfCompileError(Exception):
    """Raised when the UDF body uses something outside the supported subset;
    the caller leaves the row-wise PythonUDF in place."""


class _Null:
    """Stack sentinel for PUSH_NULL / the NULL slot of LOAD_GLOBAL/LOAD_ATTR."""


class _Callable:
    """A resolved function/method the CALL handler knows how to map."""

    def __init__(self, name: str):
        self.name = name


class _Module:
    def __init__(self, name: str):
        self.name = name


class _TupleConst:
    """A tuple literal; only consumable by CONTAINS_OP (x in (...))."""

    def __init__(self, items: tuple):
        self.items = items


_BINOPS = {
    "+": ar.Add, "-": ar.Subtract, "*": ar.Multiply, "/": ar.Divide,
    "//": ar.IntegralDivide, "%": ar.Remainder, "**": ma.Pow,
    "&": bw.BitwiseAnd, "|": bw.BitwiseOr, "^": bw.BitwiseXor,
    "<<": bw.ShiftLeft, ">>": bw.ShiftRight,
}
_CMPOPS = {
    "==": pr.EqualTo, "!=": pr.NotEqual, "<": pr.LessThan,
    "<=": pr.LessThanOrEqual, ">": pr.GreaterThan, ">=": pr.GreaterThanOrEqual,
}
#: CPython <= 3.10 spellings of what 3.11 folded into BINARY_OP
_LEGACY_BINOPS = {
    "BINARY_ADD": "+", "BINARY_SUBTRACT": "-", "BINARY_MULTIPLY": "*",
    "BINARY_TRUE_DIVIDE": "/", "BINARY_FLOOR_DIVIDE": "//",
    "BINARY_MODULO": "%", "BINARY_POWER": "**", "BINARY_AND": "&",
    "BINARY_OR": "|", "BINARY_XOR": "^", "BINARY_LSHIFT": "<<",
    "BINARY_RSHIFT": ">>",
    "INPLACE_ADD": "+", "INPLACE_SUBTRACT": "-", "INPLACE_MULTIPLY": "*",
    "INPLACE_TRUE_DIVIDE": "/", "INPLACE_FLOOR_DIVIDE": "//",
    "INPLACE_MODULO": "%", "INPLACE_POWER": "**", "INPLACE_AND": "&",
    "INPLACE_OR": "|", "INPLACE_XOR": "^", "INPLACE_LSHIFT": "<<",
    "INPLACE_RSHIFT": ">>",
}
_PY311 = sys.version_info >= (3, 11)
_PY312 = sys.version_info >= (3, 12)
#: global functions: name -> (expr class, arity) — arity None = variadic>=2
_FUNCTIONS = {
    "abs": (ar.Abs, 1), "len": (st.Length, 1), "round": (ma.Rint, None),
    "min": (ar.Least, None), "max": (ar.Greatest, None),
    "math.sqrt": (ma.Sqrt, 1), "math.exp": (ma.Exp, 1),
    "math.expm1": (ma.Expm1, 1), "math.log": (ma.Log, 1),
    "math.log2": (ma.Log2, 1), "math.log10": (ma.Log10, 1),
    "math.log1p": (ma.Log1p, 1), "math.sin": (ma.Sin, 1),
    "math.cos": (ma.Cos, 1), "math.tan": (ma.Tan, 1),
    "math.asin": (ma.Asin, 1), "math.acos": (ma.Acos, 1),
    "math.atan": (ma.Atan, 1), "math.atan2": (ma.Atan2, 2),
    "math.sinh": (ma.Sinh, 1), "math.cosh": (ma.Cosh, 1),
    "math.tanh": (ma.Tanh, 1), "math.floor": (ma.Floor, 1),
    "math.ceil": (ma.Ceil, 1), "math.pow": (ma.Pow, 2),
    "math.degrees": (ma.ToDegrees, 1), "math.radians": (ma.ToRadians, 1),
    "math.isnan": (nu.IsNan, 1),
}
#: str methods: name -> builder(self, *args)
_METHODS = {
    "upper": lambda s: st.Upper(s),
    "lower": lambda s: st.Lower(s),
    "strip": lambda s: st.StringTrim(s),
    "startswith": lambda s, p: st.StartsWith(s, p),
    "endswith": lambda s, p: st.EndsWith(s, p),
}

_MAX_FORKS = 64


def compile_udf(fn, args: Tuple[Expression, ...]) -> Expression:
    """Compile ``fn``'s bytecode into an expression over ``args`` or raise
    UdfCompileError."""
    code = fn.__code__
    if (code.co_flags & 0x0C) or code.co_kwonlyargcount:  # *args/**kwargs
        raise UdfCompileError("varargs/kwargs are not supported")
    if fn.__defaults__ or code.co_freevars or code.co_cellvars:
        raise UdfCompileError("defaults and closures are not supported")
    if code.co_argcount != len(args):
        raise UdfCompileError(
            f"{getattr(fn, '__name__', 'udf')} takes {code.co_argcount} args, "
            f"{len(args)} columns given")
    instrs = list(dis.get_instructions(fn))
    by_offset = {ins.offset: i for i, ins in enumerate(instrs)}
    locals_: Dict[int, Any] = {i: a for i, a in enumerate(args)}
    state = _State(fn, instrs, by_offset)
    return state.run(0, [], dict(locals_))


class _State:
    def __init__(self, fn, instrs, by_offset):
        self.fn = fn
        self.instrs = instrs
        self.by_offset = by_offset
        self.forks = 0

    def run(self, i: int, stack: List[Any], locals_: Dict[int, Any]) -> Expression:
        """Symbolically execute from instruction index ``i`` to a RETURN."""
        instrs = self.instrs
        while i < len(instrs):
            ins = instrs[i]
            op = ins.opname
            if op in ("RESUME", "NOP", "CACHE", "PRECALL"):
                i += 1
            elif op == "PUSH_NULL":
                stack.append(_Null())
                i += 1
            elif op == "POP_TOP":
                stack.pop()
                i += 1
            elif op == "COPY":
                stack.append(stack[-ins.arg])
                i += 1
            elif op == "SWAP":
                stack[-ins.arg], stack[-1] = stack[-1], stack[-ins.arg]
                i += 1
            elif op == "LOAD_FAST":
                if ins.arg not in locals_:
                    raise UdfCompileError(f"local {ins.argrepr} read before "
                                          f"assignment")
                stack.append(locals_[ins.arg])
                i += 1
            elif op == "STORE_FAST":
                locals_[ins.arg] = stack.pop()
                i += 1
            elif op == "LOAD_CONST":
                stack.append(self._const(ins.argval))
                i += 1
            elif op == "RETURN_CONST":
                return self._expr(self._const(ins.argval))
            elif op == "RETURN_VALUE":
                return self._expr(stack.pop())
            elif op == "LOAD_GLOBAL":
                # the low "push NULL" flag bit exists only on 3.11+; on 3.10
                # ins.arg is a plain co_names index
                if _PY311 and ins.arg & 1:
                    stack.append(_Null())
                stack.append(self._global(ins.argval))
                i += 1
            elif op in ("LOAD_ATTR", "LOAD_METHOD"):
                obj = stack.pop()
                name = ins.argval
                # 3.12 folded LOAD_METHOD into LOAD_ATTR behind arg's low bit
                methodish = (op == "LOAD_METHOD"
                             or (_PY312 and bool(ins.arg & 1)))
                if isinstance(obj, _Module):
                    target = _Callable(f"{obj.name}.{name}")
                    stack.append(target)
                    if methodish:
                        stack.append(_Null())
                elif isinstance(obj, Expression) and name in _METHODS:
                    stack.append(_Callable(name))
                    stack.append(obj)
                else:
                    raise UdfCompileError(f"attribute {name!r} is not "
                                          f"supported")
                i += 1
            elif op == "BINARY_OP" or op in _LEGACY_BINOPS:
                sym = (_LEGACY_BINOPS[op] if op in _LEGACY_BINOPS
                       else ins.argrepr.rstrip("="))
                cls = _BINOPS.get(sym)
                if cls is None:
                    raise UdfCompileError(f"operator {ins.argrepr!r} is not "
                                          f"supported")
                r, l = self._expr(stack.pop()), self._expr(stack.pop())
                stack.append(cls(l, r))
                i += 1
            elif op == "DUP_TOP":
                stack.append(stack[-1])
                i += 1
            elif op == "ROT_TWO":
                stack[-1], stack[-2] = stack[-2], stack[-1]
                i += 1
            elif op == "COMPARE_OP":
                sym = ins.argrepr.replace("bool(", "").rstrip(")")
                cls = _CMPOPS.get(sym)
                if cls is None:
                    raise UdfCompileError(f"comparison {ins.argrepr!r} is not "
                                          f"supported")
                r, l = self._expr(stack.pop()), self._expr(stack.pop())
                stack.append(cls(l, r))
                i += 1
            elif op == "CONTAINS_OP":
                container = stack.pop()
                value = self._expr(stack.pop())
                if isinstance(container, _TupleConst):
                    items = tuple(Literal.of(v) for v in container.items)
                    e: Expression = pr.In(value, items)
                elif isinstance(container, Expression):
                    e = st.Contains(container, value)
                else:
                    raise UdfCompileError("unsupported `in` container")
                stack.append(pr.Not(e) if ins.arg else e)
                i += 1
            elif op == "UNARY_NEGATIVE":
                stack.append(ar.UnaryMinus(self._expr(stack.pop())))
                i += 1
            elif op in ("UNARY_NOT", "TO_BOOL"):
                if op == "UNARY_NOT":
                    stack.append(pr.Not(self._expr(stack.pop())))
                i += 1
            elif op == "UNARY_INVERT":
                stack.append(bw.BitwiseNot(self._expr(stack.pop())))
                i += 1
            elif op == "IS_OP":
                # `x is None` / `x is not None`
                r = stack.pop()
                l = self._expr(stack.pop())
                if not (isinstance(r, Literal) and r.value is None):
                    raise UdfCompileError("`is` only supports None")
                e = nu.IsNull(l)
                stack.append(pr.Not(e) if ins.arg else e)
                i += 1
            elif op.startswith("POP_JUMP_BACKWARD_IF_"):
                # 3.11 spelling of a loop back-edge
                raise UdfCompileError("loops are not supported")
            elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                        "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE",
                        # 3.11 spellings; 3.10/3.12 drop the direction
                        "POP_JUMP_FORWARD_IF_FALSE",
                        "POP_JUMP_FORWARD_IF_TRUE",
                        "POP_JUMP_FORWARD_IF_NONE",
                        "POP_JUMP_FORWARD_IF_NOT_NONE"):
                kind = op.replace("_FORWARD", "")
                v = self._expr(stack.pop())
                if kind == "POP_JUMP_IF_NONE":
                    pred = pr.Not(nu.IsNull(v))       # jump when None
                elif kind == "POP_JUMP_IF_NOT_NONE":
                    pred = nu.IsNull(v)               # jump when not None
                elif kind == "POP_JUMP_IF_TRUE":
                    pred = pr.Not(_as_bool(v))
                else:
                    pred = _as_bool(v)
                self.forks += 1
                if self.forks > _MAX_FORKS:
                    raise UdfCompileError("too many branches")
                then_e = self.run(i + 1, list(stack), dict(locals_))
                else_e = self.run(self.by_offset[ins.argval], list(stack),
                                  dict(locals_))
                return _merge_if(pred, then_e, else_e)
            elif op in ("JUMP_IF_FALSE_OR_POP", "JUMP_IF_TRUE_OR_POP"):
                # 3.10 spelling of `and`/`or` chains: the short-circuit
                # branch keeps the tested value on the stack
                v = self._expr(stack.pop())
                self.forks += 1
                if self.forks > _MAX_FORKS:
                    raise UdfCompileError("too many branches")
                fall = self.run(i + 1, list(stack), dict(locals_))
                jump = self.run(self.by_offset[ins.argval],
                                list(stack) + [v], dict(locals_))
                if op == "JUMP_IF_FALSE_OR_POP":
                    return _merge_if(_as_bool(v), fall, jump)
                return _merge_if(_as_bool(v), jump, fall)
            elif op == "JUMP_FORWARD":
                i = self.by_offset[ins.argval]
            elif op == "JUMP_ABSOLUTE":
                target = self.by_offset[ins.argval]
                if target <= i:
                    raise UdfCompileError("loops are not supported")
                i = target
            elif op == "JUMP_BACKWARD":
                raise UdfCompileError("loops are not supported")
            elif op == "CALL":
                argc = ins.arg
                call_args = [self._expr(stack.pop()) for _ in range(argc)][::-1]
                a = stack.pop()
                b = stack.pop() if stack else _Null()
                marker, self_obj = None, None
                for item in (a, b):
                    if isinstance(item, _Callable):
                        marker = item
                    elif isinstance(item, Expression):
                        self_obj = item
                if marker is None:
                    raise UdfCompileError("call target is not a supported "
                                          "function")
                stack.append(self._call(marker.name, self_obj, call_args))
                i += 1
            elif op == "CALL_FUNCTION":
                # 3.10: stack is [func, arg0..argN-1]; no NULL slot
                call_args = [self._expr(stack.pop())
                             for _ in range(ins.arg)][::-1]
                target = stack.pop()
                if not isinstance(target, _Callable):
                    raise UdfCompileError("call target is not a supported "
                                          "function")
                stack.append(self._call(target.name, None, call_args))
                i += 1
            elif op == "CALL_METHOD":
                # 3.10: stack is [method, self_or_null, arg0..argN-1]
                call_args = [self._expr(stack.pop())
                             for _ in range(ins.arg)][::-1]
                a = stack.pop()
                b = stack.pop()
                marker, self_obj = None, None
                for item in (a, b):
                    if isinstance(item, _Callable):
                        marker = item
                    elif isinstance(item, Expression):
                        self_obj = item
                if marker is None:
                    raise UdfCompileError("call target is not a supported "
                                          "function")
                stack.append(self._call(marker.name, self_obj, call_args))
                i += 1
            else:
                raise UdfCompileError(f"opcode {op} is not supported")
        raise UdfCompileError("fell off the end of the bytecode")

    # ---- helpers --------------------------------------------------------------
    def _const(self, v):
        if isinstance(v, tuple):
            return _TupleConst(v)
        try:
            return Literal.of(v)
        except TypeError:
            raise UdfCompileError(f"constant {v!r} is not supported")

    def _global(self, name: str):
        import builtins
        missing = object()
        v = self.fn.__globals__.get(name, missing)
        if v is missing:
            v = getattr(builtins, name, missing)
        if v is math:
            return _Module("math")
        # a shadowed builtin (def abs(x): ...) must NOT compile to the real one
        if name in _FUNCTIONS and v is getattr(builtins, name, None):
            return _Callable(name)
        raise UdfCompileError(f"global {name!r} is not supported")

    def _call(self, name: str, self_obj, args: List[Expression]) -> Expression:
        if self_obj is not None and name in _METHODS:
            try:
                return _METHODS[name](self_obj, *args)
            except TypeError:
                raise UdfCompileError(f"bad arity for method {name!r}")
        spec = _FUNCTIONS.get(name)
        if spec is None:
            raise UdfCompileError(f"function {name!r} is not supported")
        cls, arity = spec
        if arity is None:
            if name == "round":
                # python round() is half-even -> Rint, not Spark's HALF_UP
                if len(args) != 1:
                    raise UdfCompileError("only 1-arg round() is supported")
                return ma.Rint(args[0])
            if len(args) < 2:
                raise UdfCompileError(f"{name} needs at least 2 args")
            return cls(tuple(args))
        if len(args) != arity:
            raise UdfCompileError(f"bad arity for {name!r}")
        return cls(*args)

    def _expr(self, v) -> Expression:
        if isinstance(v, Expression):
            return v
        raise UdfCompileError(f"unsupported stack value {type(v).__name__}")


def _as_bool(e: Expression) -> Expression:
    """Python truthiness of the branch value. Types whose truthiness we cannot
    reproduce exactly raise, leaving the UDF on the row-wise path."""
    dt = e.dtype()
    if dt is DType.BOOLEAN:
        return e
    if dt is DType.STRING:
        return pr.GreaterThan(st.Length(e), Literal.of(0))
    if dt.is_numeric:
        return pr.NotEqual(e, Cast(Literal.of(0), dt))
    raise UdfCompileError(f"truthiness of {dt.value} is not supported")


def _merge_if(pred: Expression, t: Expression, f: Expression) -> Expression:
    """Join two return expressions under a condition, reconciling types."""
    td, fd = t.dtype(), f.dtype()
    if td is DType.NULL and isinstance(t, Literal):
        t = Literal(None, fd)
    elif fd is DType.NULL and isinstance(f, Literal):
        f = Literal(None, td)
    else:
        ct = DType.common_type(td, fd)
        if td is not ct:
            t = Cast(t, ct)
        if fd is not ct:
            f = Cast(f, ct)
    return cond.If(pred, t, f)
