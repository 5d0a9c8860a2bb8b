"""Logical -> physical conversion.

Counterpart of the conversion core of spark_rapids_tpu/plan/overrides.py
(``_build_tpu_exec``, ``_build_join``, the Limit(Sort) -> TopN rewrite)
for the nodes q6/q1/q3 build. An Aggregate becomes PARTIAL -> FINAL
HashAggregateExec as in the JAX planner (overrides.py:750-770); an inner
Join becomes a BroadcastHashJoinExec when its build side's estimated
rows are at most ``srt.sql.broadcastRowThreshold`` and a
ShuffledHashJoinExec otherwise (overrides.py:820-871). The port runs one
partition, where the exchanges the JAX planner inserts (round-robin or
hash between PARTIAL and FINAL and below a shuffled join, broadcast
below a broadcast join, range before a global sort) pass batches through
unchanged, so none is placed. Tagging, CPU fallback and the cost model
beyond row estimates are not ported.
"""

from __future__ import annotations

from ..conf import BROADCAST_THRESHOLD_ROWS, SrtConf
from ..exec.aggregate import FINAL, PARTIAL, HashAggregateExec
from ..exec.base import TpuExec
from ..exec.basic import (BatchScanExec, FilterExec, LocalLimitExec,
                          ProjectExec)
from ..exec.join import BroadcastHashJoinExec, ShuffledHashJoinExec
from ..exec.sort import SortExec, SortOrder, TopNExec
from ..expr.cast import Cast
from ..expr.conditional import _common_type
from .cost import estimate_rows
from .logical import (Aggregate, DeviceRelation, Filter, Join, Limit,
                      LogicalPlan, Project, Sort)


def _sort_orders(sort: Sort):
    return [SortOrder(o.expr, o.ascending, o.nulls_first)
            for o in sort.order]


def _coerce_join_keys(plan: Join):
    """Join keys must share a type across sides: murmur3 is
    width-sensitive. Where they differ, both meet at their common type
    (expr/conditional.py ``_common_type``) through a Cast, as in the JAX
    planner."""
    ls, rs = plan.children[0].schema, plan.children[1].schema
    lk, rk = [], []
    for l, r in zip(plan.left_keys, plan.right_keys):
        lt, rt = l.data_type(ls), r.data_type(rs)
        if lt == rt:
            lk.append(l)
            rk.append(r)
            continue
        ct = _common_type([lt, rt])
        lk.append(l if lt == ct else Cast(l, ct))
        rk.append(r if rt == ct else Cast(r, ct))
    return lk, rk


def _join_cls(plan: Join, build: str, conf: SrtConf):
    """Broadcast when the build side's estimated rows are small
    (spark.sql.autoBroadcastJoinThreshold's role)."""
    build_plan = plan.children[1] if build == "right" else plan.children[0]
    if estimate_rows(build_plan) <= conf.get(BROADCAST_THRESHOLD_ROWS):
        return BroadcastHashJoinExec
    return ShuffledHashJoinExec


def _build_join(plan: Join, children, conf: SrtConf) -> TpuExec:
    if plan.join_type != "inner" or not plan.left_keys:
        raise NotImplementedError(
            f"{plan.join_type} join without equi-keys or of another type "
            "than inner is not in this port yet")
    left_keys, right_keys = _coerce_join_keys(plan)
    cls = _join_cls(plan, "right", conf)
    return cls(children[0], children[1], left_keys, right_keys,
               join_type=plan.join_type, build_side="right")


def _to_physical(plan: LogicalPlan, conf: SrtConf) -> TpuExec:
    if isinstance(plan, Limit) and isinstance(plan.children[0], Sort):
        # ORDER BY + LIMIT fuse into one top-n operator
        sort = plan.children[0]
        return TopNExec(_to_physical(sort.children[0], conf),
                        _sort_orders(sort), plan.n)
    children = [_to_physical(c, conf) for c in plan.children]
    if isinstance(plan, DeviceRelation):
        return BatchScanExec(plan.batches, plan.schema)
    if isinstance(plan, Project):
        return ProjectExec(children[0], plan.exprs)
    if isinstance(plan, Filter):
        return FilterExec(children[0], plan.condition)
    if isinstance(plan, Sort):
        return SortExec(children[0], _sort_orders(plan))
    if isinstance(plan, Limit):
        return LocalLimitExec(children[0], plan.n)
    if isinstance(plan, Join):
        return _build_join(plan, children, conf)
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
