"""Window physical operator (the JAX package's ``execs/window_execs.py``).

One sort by (partition keys, order keys), then every window expression
under that spec evaluates against one shared ``FrameCtx``: the ranking
functions and lead/lag read positions; an aggregate function projects its
group-by buffers, reduces them over each row's frame
(``ops/window.py::frame_reduce_buffer``) and evaluates them as a group-by
would. Output rows come in (partition, order) sorted
order, as Spark's WindowExec gives them, with the window columns after the
child's. The exec needs its whole input in one partition
(``plan/planner.py::ensure_requirements``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.execs.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.execs.cpu_execs import (CpuEngineExec,
                                                    width_scaled_estimate)
from spark_rapids_tpu_torch.execs.tpu_execs import (batch_of,
                                                    concat_device_batches,
                                                    eval_ctx)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.core import ColV, EvalCtx, Expression
from spark_rapids_tpu_torch.exprs.misc import Alias
from spark_rapids_tpu_torch.exprs.windows import (WindowExpression,
                                                  WindowFunction)
from spark_rapids_tpu_torch.ops import batch_kernels as bk
from spark_rapids_tpu_torch.ops import window as wk


def window_output_schema(child_schema: Schema,
                         wexprs: Tuple[Expression, ...]) -> Schema:
    fields = list(child_schema.fields)
    for e in wexprs:
        w = e.c if isinstance(e, Alias) else e
        fields.append(Field(e.name_hint, w.dtype(), w.nullable()))
    return Schema(fields)


def evaluate_window(ctx: EvalCtx, wexprs: Tuple[Expression, ...],
                    num_rows: int) -> List[ColV]:
    """Child columns -> the child's columns (sorted) + one column per
    window expression. Every expression shares one (partition, order)
    spec (``DataFrame.select`` groups them so)."""
    first = wexprs[0].c if isinstance(wexprs[0], Alias) else wexprs[0]
    cap = ctx.capacity
    alive = bk.alive_mask(cap, num_rows, ctx.device)
    part_keys = [bk.as_column(e.eval(ctx), cap) for e in first.part_keys]
    order_keys = [(bk.as_column(o.child.eval(ctx), cap), o.ascending,
                   o.nulls_first) for o in first.orders]
    sort_keys = ([(k, True, True) for k in part_keys] + order_keys)
    order = (bk.sort_indices(sort_keys, alive) if sort_keys
             else torch.arange(cap, device=ctx.device))
    sorted_cols = [bk.take_colv(v, order) for v in ctx.columns]
    sctx = EvalCtx(sorted_cols, cap, ctx.device, ctx.string_max_bytes,
                   host_engine=ctx.host_engine, num_rows=num_rows)
    fr = wk.build_frame_ctx(part_keys, order_keys, order, alive, cap)
    out = list(sorted_cols)
    for e in wexprs:
        w = e.c if isinstance(e, Alias) else e
        if not isinstance(w, WindowExpression) or \
                w.sort_spec_key() != first.sort_spec_key():
            raise ValueError("one window exec evaluates one (partition, "
                             "order) spec")
        fn = w.fn
        if isinstance(fn, WindowFunction):
            out.append(fn.window_eval(sctx, fr))
        elif isinstance(fn, AggregateFunction):
            frame = w.resolved_frame()
            lo, hi, empty = wk.frame_bounds(fr, frame.frame_type,
                                            frame.lower, frame.upper)
            reduced = [wk.frame_reduce_buffer(fr, bk.as_column(b, cap),
                                              s.kind, lo, hi, empty,
                                              s.ignore_nulls)
                       for b, s in zip(fn.project(sctx), fn.buffer_specs())]
            res = fn.evaluate(reduced)
            out.append(res.with_validity(res.validity & fr.salive))
        else:
            raise TypeError(f"not a window function: {type(fn).__name__}")
    return out


class TpuWindowExec(PhysicalExec):
    """Window exec over the concatenation of the child's batches."""

    def __init__(self, wexprs: Tuple[Expression, ...], child: PhysicalExec):
        super().__init__((child,), window_output_schema(child.output, wexprs))
        self.wexprs = wexprs

    def size_estimate(self) -> Optional[int]:
        return width_scaled_estimate(self.children[0], self.output)

    def execute(self, ctx: ExecContext) -> Iterator:
        batch = concat_device_batches(list(self.children[0].execute(ctx)),
                                      self.children[0].output, ctx.device)
        out = evaluate_window(eval_ctx(batch, ctx), self.wexprs,
                              batch.num_rows)
        yield batch_of(self.output, out, batch.num_rows)


class CpuWindowExec(CpuEngineExec):
    """The CPU engine's window exec (execs/cpu_execs.py)."""

    def __init__(self, wexprs: Tuple[Expression, ...], child: PhysicalExec):
        self.wexprs = wexprs
        super().__init__((child,))

    def device_twin(self, children):
        return TpuWindowExec(self.wexprs, children[0])
