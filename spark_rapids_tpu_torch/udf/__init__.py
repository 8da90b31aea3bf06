"""UDF support: row-function wrapper + bytecode compiler.

Reference analog: the udf-compiler module (udf-compiler/.../Plugin.scala:28 —
a resolution rule replacing ScalaUDF with compiled Catalyst expressions, gated
by spark.rapids.sql.udfCompiler.enabled) and GpuScalaUDF.scala (the fallback
wrapper). ``compile_plan_udfs`` is the resolution-rule analog, run by the
planner before physical planning when the conf is on."""
from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.core import Expression, bind_expression
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.udf.compiler import UdfCompileError, compile_udf
from spark_rapids_tpu_torch.udf.expression import PythonUDF

__all__ = ["PythonUDF", "UdfCompileError", "compile_udf", "compile_plan_udfs"]


def _compile_expr(e: Expression, schema) -> Expression:
    e = e.map_children(lambda c: _compile_expr(c, schema))
    if isinstance(e, PythonUDF):
        try:
            # bind the argument expressions so the compiler can reason about
            # types (If-branch harmonization); BoundReference survives the
            # planner's later bind pass untouched
            bound = tuple(bind_expression(a, schema) for a in e.args)
            compiled = compile_udf(e.fn, bound)
        except (UdfCompileError, KeyError, TypeError):
            return e
        # pin the declared return type regardless of what the body inferred
        return Cast(compiled, e.ret_dtype)
    return e


def _walk_field(v, schema):
    if isinstance(v, Expression):
        return _compile_expr(v, schema)
    if isinstance(v, tuple):
        return tuple(_walk_field(x, schema) for x in v)
    return v


def compile_plan_udfs(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """Replace compilable PythonUDF nodes across a logical plan (the
    LogicalPlanRules resolution-rule role, udf-compiler Plugin.scala:36-48).
    Expressions compile against the node's child schema; nodes without a
    single input schema (joins) keep their UDFs on the fallback path."""
    if not dataclasses.is_dataclass(plan):
        return plan
    changes = {}
    children = plan.children
    schema = children[0].schema() if len(children) == 1 else None
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, lp.LogicalPlan):
            nv = compile_plan_udfs(v)
        elif schema is not None:
            nv = _walk_field(v, schema)
        else:
            nv = v
        if nv is not v:
            changes[f.name] = nv
    return dataclasses.replace(plan, **changes) if changes else plan
