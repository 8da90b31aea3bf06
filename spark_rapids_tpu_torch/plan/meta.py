"""Meta-wrapper tree for plan tagging (the JAX package's ``plan/meta.py``;
reference: RapidsMeta.scala, 752 LoC).

Each physical-plan node and each expression gets a meta wrapper that records
whether it can move to the TPU and, when it cannot, the accumulated reasons
(``willNotWorkOnTpu`` -> RapidsMeta.scala:126). ``tag_for_tpu`` recurses
(RapidsMeta.scala:186); ``convert_if_needed`` (RapidsMeta.scala:539) converts
maximal supported subtrees and leaves the rest on the CPU engine, inserting
host<->device transitions at the boundaries.
"""
from __future__ import annotations

from typing import List, Set

from spark_rapids_tpu_torch.columnar.dtypes import DType
from spark_rapids_tpu_torch.config import INCOMPATIBLE_OPS, TpuConf
from spark_rapids_tpu_torch.execs.base import PhysicalExec
from spark_rapids_tpu_torch.exprs.core import Expression

SUPPORTED_TYPES = {DType.BOOLEAN, DType.BYTE, DType.SHORT, DType.INT, DType.LONG,
                   DType.FLOAT, DType.DOUBLE, DType.STRING, DType.DATE,
                   DType.TIMESTAMP, DType.NULL}


class BaseMeta:
    def __init__(self):
        self._reasons: Set[str] = set()

    def will_not_work(self, reason: str) -> None:
        self._reasons.add(reason)

    @property
    def can_this_be_replaced(self) -> bool:
        return not self._reasons

    @property
    def reasons(self) -> List[str]:
        return sorted(self._reasons)


class ExprMeta(BaseMeta):
    """Wrapper for one (bound) expression node (BaseExprMeta analog,
    RapidsMeta.scala:576)."""

    def __init__(self, expr: Expression, conf: TpuConf, rule):
        super().__init__()
        self.expr = expr
        self.conf = conf
        self.rule = rule
        self.child_metas: List[ExprMeta] = []

    def tag_for_tpu(self) -> None:
        from spark_rapids_tpu_torch.plan.overrides import wrap_expr
        for c in self.expr.children:
            m = wrap_expr(c, self.conf)
            m.tag_for_tpu()
            self.child_metas.append(m)
        if self.rule is None:
            self.will_not_work(
                f"expression {type(self.expr).__name__} has no TPU implementation")
            return
        if not self.conf.is_rule_enabled(self.rule.conf_key):
            self.will_not_work(
                f"expression {type(self.expr).__name__} disabled by "
                f"{self.rule.conf_key}")
        if self.rule.incompat and not self.conf.get(INCOMPATIBLE_OPS):
            self.will_not_work(
                f"expression {type(self.expr).__name__} is incompatible with Spark "
                f"semantics ({self.rule.incompat}); enable with "
                f"spark.rapids.tpu.sql.incompatibleOps.enabled")
        if not self.rule.array_valued:
            # an array-valued node (a split read by GetArrayItem) has no
            # column type
            try:
                dt = self.expr.dtype()
                if dt not in SUPPORTED_TYPES:
                    self.will_not_work(f"type {dt} is not supported on TPU")
            except TypeError as e:
                self.will_not_work(str(e))
        if self.rule.tag is not None:
            self.rule.tag(self)

    @property
    def all_replaceable(self) -> bool:
        return (self.can_this_be_replaced
                and all(m.all_replaceable for m in self.child_metas))

    def collect_reasons(self, out: List[str]) -> None:
        for r in self.reasons:
            out.append(f"expression {type(self.expr).__name__}: {r}")
        for m in self.child_metas:
            m.collect_reasons(out)


class ExecMeta(BaseMeta):
    """Wrapper for one physical exec node (SparkPlanMeta analog)."""

    def __init__(self, exec_node: PhysicalExec, conf: TpuConf, rule):
        super().__init__()
        self.exec = exec_node
        self.conf = conf
        self.rule = rule
        self.child_metas: List[ExecMeta] = []
        self.expr_metas: List[ExprMeta] = []

    def tag_for_tpu(self) -> None:
        from spark_rapids_tpu_torch.plan.overrides import wrap_exec, wrap_expr
        for c in self.exec.children:
            m = wrap_exec(c, self.conf)
            m.tag_for_tpu()
            self.child_metas.append(m)
        if not self.conf.sql_enabled:
            self.will_not_work("TPU acceleration is disabled "
                               "(spark.rapids.tpu.sql.enabled=false)")
            return
        if self.rule is None:
            self.will_not_work(
                f"{self.exec.name} has no TPU implementation")
            return
        if not self.conf.is_rule_enabled(self.rule.conf_key):
            self.will_not_work(
                f"{self.exec.name} disabled by {self.rule.conf_key}")
        for f in self.exec.output:
            if f.dtype not in SUPPORTED_TYPES:
                self.will_not_work(f"output column {f.name}: type {f.dtype} is "
                                   f"not supported on TPU")
        for e in self.rule.exprs_of(self.exec):
            m = wrap_expr(e, self.conf)
            m.tag_for_tpu()
            self.expr_metas.append(m)
        if self.rule.tag is not None:
            self.rule.tag(self)

    @property
    def exprs_replaceable(self) -> bool:
        return all(m.all_replaceable for m in self.expr_metas)

    @property
    def can_replace(self) -> bool:
        return self.can_this_be_replaced and self.exprs_replaceable

    def convert_if_needed(self) -> PhysicalExec:
        """Convert maximal supported subtrees to TPU execs
        (RapidsMeta.convertIfNeeded analog)."""
        new_children = [m.convert_if_needed() for m in self.child_metas]
        if self.can_replace:
            return self.rule.convert(self, new_children)
        node = self.exec
        if tuple(new_children) != node.children:
            node = node.with_children(new_children)
        return node

    def explain(self, out: List[str], indent: int = 0) -> None:
        """NOT_ON_TPU-style explain lines (GpuOverrides explain analog)."""
        pad = "  " * indent
        if self.can_replace:
            out.append(f"{pad}*{self.exec.name} will run on TPU")
        else:
            out.append(f"{pad}!{self.exec.name} cannot run on TPU")
            for r in self.reasons:
                out.append(f"{pad}    because {r}")
            expr_reasons: List[str] = []
            for m in self.expr_metas:
                m.collect_reasons(expr_reasons)
            for r in expr_reasons:
                out.append(f"{pad}    because {r}")
        for m in self.child_metas:
            m.explain(out, indent + 1)
