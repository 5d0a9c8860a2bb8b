"""Row-count estimates and the CPU / device cost model.

Counterpart of spark_rapids_tpu/plan/cost.py (CostBasedOptimizer's
role). ``estimate_rows`` reads in-memory relations: a relation counts
its rows, a file scan guesses 64 bytes a Parquet row from the files'
sizes (the JAX package's guess), a filter keeps half, an aggregate a tenth, a limit at
most its n, a join (keyless ones too) as many rows as its larger side,
a union the sum of its children and an expand its child's rows once per
projection. A Generate over a column of a relation counts the elements
it emits (and the null or empty lists explode_outer keeps); over
anything else it keeps its child's rows, as in the JAX package.

``apply_cost_model`` (off unless ``srt.sql.optimizer.enabled``, as in
the JAX package) tags plan sections for the CPU engine where the model
says the device does not pay: a whole plan below ``ROW_THRESHOLD``
weighted rows, else, top down, a
small section whose CPU cost (rows x row bytes x the CPU engine's
per-operator weight) is below its device cost (the device weights, a
fixed cost per operator and the transfers its placement implies). The
weights are the JAX package's, unchanged: ratios of a byte's cost
through a projection on the CPU engine, not measurements of the H100.
"""

from __future__ import annotations

import os

import torch

from typing import Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..conf import OPTIMIZER_ENABLED, SrtConf
from .logical import (Aggregate, DeviceRelation, Expand, Filter, Generate,
                      Join, Limit, LocalRelation, LogicalPlan, Project,
                      Range, Sample, Sort, Union, Window)


def _generated_rows(plan: Generate) -> float:
    """The rows an explode of a relation's column emits."""
    rel, arg = plan.children[0], plan.generator.children[0]
    total = 0
    for b in rel.batches:
        lc = b.column(arg.name)
        n = b.num_rows
        lens = lc.lengths()[:n].to(torch.int64)
        if plan.generator.outer:
            lens = torch.where(lc.validity[:n], lens, 0).clamp(min=1)
        total += int(lens.sum())
    return float(total)


def estimate_rows(plan: LogicalPlan) -> float:
    """Cardinality estimate (static, like Spark's RowCountPlanVisitor)."""
    if isinstance(plan, DeviceRelation):
        return float(sum(b.num_rows for b in plan.batches))
    if isinstance(plan, LocalRelation):
        return float(len(next(iter(plan.data.values()), [])))
    if isinstance(plan, Range):
        return float(plan.num_rows)
    from ..io.scan import FileScan
    if isinstance(plan, FileScan):
        # bytes-based guess: ~64 B a parquet row
        total = sum(os.path.getsize(p) for p in plan.paths
                    if os.path.exists(p))
        return max(total / 64, 1.0)
    child_rows = [estimate_rows(c) for c in plan.children]
    if isinstance(plan, Sample):
        return child_rows[0] * plan.fraction
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
    if isinstance(plan, Generate):
        from ..expr.core import ColumnRef
        if isinstance(plan.children[0], DeviceRelation) and \
                isinstance(plan.generator.children[0], ColumnRef):
            return _generated_rows(plan)
    return child_rows[0] if child_rows else 0.0


# per-row-byte work factors: the CPU engine (cpu_eval) and the device
_CPU_W = {
    Project: 1.0, Filter: 1.0, Limit: 0.1, Union: 0.2, Expand: 2.0,
    Sort: 12.0, Aggregate: 6.0, Join: 10.0, Window: 20.0,
    LocalRelation: 0.05,
}
_DEV_W = {
    Project: 0.02, Filter: 0.02, Limit: 0.01, Union: 0.02, Expand: 0.04,
    Sort: 0.30, Aggregate: 0.15, Join: 0.25, Window: 0.40,
    LocalRelation: 0.05,
}
#: fixed device cost per operator (launches and dispatch), in the same
#: unit; it dominates small plans
_DEVICE_FIXED = 64 * 1024
#: host <-> device transfer cost per byte, relative to a CPU projection
_TRANSFER_W = 0.1
#: the floor gate's operator weights
_OP_WEIGHT = {
    Project: 1.0, Filter: 1.0, Limit: 0.1, Union: 0.2, Expand: 2.0,
    Sort: 4.0, Aggregate: 4.0, Join: 6.0, Window: 8.0,
    LocalRelation: 0.1,
}


def row_width_bytes(schema) -> float:
    """Estimated bytes a row of ``schema`` (strings and nested columns
    are guesses)."""
    total = 0.0
    for _, t in schema:
        if t == dt.STRING:
            total += 24.0
        elif t.is_nested:
            total += 64.0
        elif dt.is_wide_decimal(t):
            total += 16.0
        elif t.np_physical is not None:
            total += np.dtype(t.np_physical).itemsize
        else:
            total += 8.0
    return max(total, 1.0)


def _subtree_costs(plan: LogicalPlan) -> Tuple[float, float, float]:
    """(CPU cost, device compute cost, output bytes) of the subtree; the
    device cost leaves out the boundary transfers."""
    bytes_out = estimate_rows(plan) * row_width_bytes(plan.schema)
    cpu = _CPU_W.get(type(plan), 1.0) * bytes_out
    dev = _DEV_W.get(type(plan), 0.05) * bytes_out + _DEVICE_FIXED
    for c in plan.children:
        ccpu, cdev, _ = _subtree_costs(c)
        cpu += ccpu
        dev += cdev
    return cpu, dev, bytes_out


def _leaf_input_bytes(plan: LogicalPlan) -> float:
    """Bytes entering the subtree from host data (the upload a device
    placement pays)."""
    from ..io.scan import FileScan
    if isinstance(plan, (LocalRelation, FileScan)):
        return estimate_rows(plan) * row_width_bytes(plan.schema)
    return sum(_leaf_input_bytes(c) for c in plan.children)


def device_vs_cpu(plan: LogicalPlan) -> Tuple[float, float]:
    """(CPU cost, device cost) of the whole subtree on each engine, the
    device's with its boundary transfers."""
    cpu, dev, bytes_out = _subtree_costs(plan)
    dev += _TRANSFER_W * (_leaf_input_bytes(plan) + bytes_out)
    return cpu, dev


#: weighted rows below which the model keeps a whole plan on the CPU
#: engine (the JAX package's srt.sql.optimizer.rowThreshold default)
ROW_THRESHOLD = 10_000


def total_cost_rows(plan: LogicalPlan) -> float:
    """Weighted row volume of the whole tree (the floor gate)."""
    w = _OP_WEIGHT.get(type(plan), 1.0)
    return w * estimate_rows(plan) + sum(total_cost_rows(c)
                                         for c in plan.children)


def apply_cost_model(meta, conf: SrtConf) -> None:
    """Tag plan sections for the CPU engine where the model says the
    device does not pay (CostBasedOptimizer.optimize's role): a plan
    below the row threshold entirely, else the small sections that lose
    (``_refine``)."""
    if not conf.get(OPTIMIZER_ENABLED):
        return
    threshold = ROW_THRESHOLD
    cost = total_cost_rows(meta.plan)
    if cost < threshold:
        _tag_tree(meta, f"cost model: estimated work {cost:.0f} rows < "
                        f"threshold {threshold}")
        return
    _refine(meta, threshold)


def _refine(meta, threshold: float) -> None:
    """Top down: a subtree that wins on the device stays; a losing one
    goes to the CPU engine only while it is also small by the row
    threshold, and its children are weighed on their own."""
    cpu, dev = device_vs_cpu(meta.plan)
    if dev < cpu:
        return
    if total_cost_rows(meta.plan) < threshold:
        meta.will_not_work_on_tpu(
            f"cost model: CPU {cpu:.2e} < device {dev:.2e} for small "
            f"{type(meta.plan).__name__} section")
    for c in meta.child_plans:
        _refine(c, threshold)


def _tag_tree(meta, reason: str) -> None:
    meta.will_not_work_on_tpu(reason)
    for c in meta.child_plans:
        _tag_tree(c, reason)
