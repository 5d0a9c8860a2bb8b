"""Static row-count estimates for planning.

Counterpart of ``estimate_rows`` in spark_rapids_tpu/plan/cost.py to the
depth the join planner reads it over in-memory relations: a relation
counts its rows, a filter keeps half, an aggregate a tenth, a limit at
most its n, a join (keyless ones too) as many rows as its larger side,
a union the sum of its children and an expand its child's rows once per
projection.
"""

from __future__ import annotations

from .logical import (Aggregate, DeviceRelation, Expand, Filter, Join,
                      Limit, LogicalPlan, Union)


def estimate_rows(plan: LogicalPlan) -> float:
    """Cardinality estimate (static, like Spark's RowCountPlanVisitor)."""
    if isinstance(plan, DeviceRelation):
        return float(sum(b.num_rows for b in plan.batches))
    child_rows = [estimate_rows(c) for c in plan.children]
    if isinstance(plan, Filter):
        return child_rows[0] * 0.5  # default selectivity
    if isinstance(plan, Limit):
        return float(min(plan.n, child_rows[0]))
    if isinstance(plan, Aggregate):
        return max(child_rows[0] * 0.1, 1.0)
    if isinstance(plan, Join):
        return max(child_rows)
    if isinstance(plan, Union):
        return sum(child_rows)
    if isinstance(plan, Expand):
        return child_rows[0] * len(plan.projections)
    return child_rows[0] if child_rows else 0.0
