"""Logical -> physical conversion.

Counterpart of the conversion core of spark_rapids_tpu/plan/overrides.py
(``_build_tpu_exec``) for the nodes q6/q1 build. An Aggregate becomes
PARTIAL -> FINAL HashAggregateExec as in the JAX planner
(overrides.py:750-770). The port runs one partition, where the
exchanges the JAX planner inserts (round-robin or hash between PARTIAL
and FINAL, range before a global sort) pass batches through unchanged,
so none is placed. Tagging, CPU fallback and the cost model are not
ported.
"""

from __future__ import annotations

from ..conf import SrtConf
from ..exec.aggregate import FINAL, PARTIAL, HashAggregateExec
from ..exec.base import TpuExec
from ..exec.basic import BatchScanExec, FilterExec, ProjectExec
from ..exec.sort import SortExec, SortOrder
from .logical import (Aggregate, DeviceRelation, Filter, LogicalPlan,
                      Project, Sort)


def _to_physical(plan: LogicalPlan, conf: SrtConf) -> TpuExec:
    children = [_to_physical(c, conf) for c in plan.children]
    if isinstance(plan, DeviceRelation):
        return BatchScanExec(plan.batches, plan.schema)
    if isinstance(plan, Project):
        return ProjectExec(children[0], plan.exprs)
    if isinstance(plan, Filter):
        return FilterExec(children[0], plan.condition)
    if isinstance(plan, Sort):
        return SortExec(children[0],
                        [SortOrder(o.expr, o.ascending, o.nulls_first)
                         for o in plan.order])
    if isinstance(plan, Aggregate):
        partial = HashAggregateExec(children[0], plan.group_exprs,
                                    plan.agg_exprs, mode=PARTIAL)
        return HashAggregateExec(partial, plan.group_exprs, plan.agg_exprs,
                                 mode=FINAL,
                                 input_schema=plan.children[0].schema)
    raise NotImplementedError(
        f"{type(plan).__name__} has no physical operator in this port yet")


def apply_overrides(plan: LogicalPlan, conf: SrtConf) -> TpuExec:
    """The physical operator tree for ``plan``."""
    return _to_physical(plan, conf)
