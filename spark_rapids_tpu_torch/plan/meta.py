"""Meta wrappers: the state of tag-then-convert planning.

Counterpart of spark_rapids_tpu/plan/meta.py (RapidsMeta.scala's
role): every logical node and every expression is wrapped in a meta
that records why it cannot run on the device (``will_not_work_on_tpu``;
the names are kept so that a reader finds the counterpart). After
tagging, ``can_this_be_replaced`` drives conversion; the reasons feed
``srt.sql.explain`` and ``DataFrame.explain``.
"""

from __future__ import annotations

from typing import List

from ..expr.core import Expression
from .logical import LogicalPlan


class BaseMeta:
    def __init__(self):
        self._cannot_reasons: List[str] = []

    def will_not_work_on_tpu(self, reason: str) -> None:
        if reason not in self._cannot_reasons:
            self._cannot_reasons.append(reason)

    @property
    def can_this_be_replaced(self) -> bool:
        return not self._cannot_reasons

    @property
    def reasons(self) -> List[str]:
        return list(self._cannot_reasons)


class ExprMeta(BaseMeta):
    """Wraps one Expression; child metas in ``child_exprs``."""

    def __init__(self, expr: Expression, schema):
        super().__init__()
        self.expr = expr
        self.schema = schema
        self.child_exprs = [ExprMeta(c, schema) for c in expr.children]

    def tag_for_tpu(self) -> None:
        from . import overrides
        # type the tree root first, before descending: higher-order
        # functions bind their lambda variables' types in data_type,
        # and children (which reference those variables) tag after. A
        # type error here means the device cannot plan the expression:
        # it runs on the CPU engine instead.
        try:
            self.expr.data_type(self.schema)
        except Exception as e:
            self.will_not_work_on_tpu(
                f"cannot type {type(self.expr).__name__}: {e}")
            return
        for c in self.child_exprs:
            c.tag_for_tpu()
        rule = overrides.expr_rule_for(type(self.expr))
        if rule is None:
            self.will_not_work_on_tpu(
                f"expression {type(self.expr).__name__} has no device "
                "implementation")
            return
        rule.tag(self)

    @property
    def can_expr_tree_be_replaced(self) -> bool:
        return self.can_this_be_replaced and all(
            c.can_expr_tree_be_replaced for c in self.child_exprs)

    def tree_reasons(self) -> List[str]:
        out = list(self._cannot_reasons)
        for c in self.child_exprs:
            out.extend(c.tree_reasons())
        return out


class PlanMeta(BaseMeta):
    """Wraps one logical node; children wrapped recursively."""

    def __init__(self, plan: LogicalPlan):
        super().__init__()
        self.plan = plan
        self.child_plans = [PlanMeta(c) for c in plan.children]
        self.expr_metas = [ExprMeta(e, schema)
                           for e, schema in plan.expressions_with_schemas()]

    def tag_for_tpu(self) -> None:
        from . import overrides
        for c in self.child_plans:
            c.tag_for_tpu()
        for em in self.expr_metas:
            em.tag_for_tpu()
        rule = overrides.exec_rule_for(type(self.plan))
        if rule is None:
            self.will_not_work_on_tpu(
                f"operator {type(self.plan).__name__} has no device "
                "implementation")
        else:
            rule.tag(self)
        for em in self.expr_metas:
            if not em.can_expr_tree_be_replaced:
                for r in em.tree_reasons():
                    self.will_not_work_on_tpu(r)

    def explain_lines(self, indent: int = 0, only_not_on_tpu: bool = False
                      ) -> List[str]:
        mark = "*" if self.can_this_be_replaced else "!"
        line = "  " * indent + f"{mark} {self.plan.node_description()}"
        lines = []
        if not only_not_on_tpu or not self.can_this_be_replaced:
            reasons = "; ".join(self._cannot_reasons)
            lines.append(line + (f"  [cannot replace: {reasons}]"
                                 if reasons else ""))
        for c in self.child_plans:
            lines.extend(c.explain_lines(indent + 1, only_not_on_tpu))
        return lines
