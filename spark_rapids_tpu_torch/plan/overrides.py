"""Logical -> physical conversion.

Counterpart of the conversion core of spark_rapids_tpu/plan/overrides.py
(``_build_tpu_exec``, ``_build_join``, the Limit(Sort) -> TopN rewrite)
for the nodes the ported queries build. An Aggregate becomes PARTIAL ->
FINAL HashAggregateExec as in the JAX planner (overrides.py:750-770); an
equi-Join becomes a BroadcastHashJoinExec when its build side's
estimated rows are at most ``srt.sql.broadcastRowThreshold`` and a
ShuffledHashJoinExec otherwise, a keyless one a CartesianProductExec or
a BroadcastNestedLoopJoinExec, and a full outer one a UnionExec of two
hash joins (overrides.py:820-871); a Union becomes a UnionExec and an
Expand an ExpandExec. A
Window becomes a BatchedRunningWindowExec over a SortExec when every
function streams with carried state, else a WindowExec
(overrides.py:776-793); the
semantic gates of the JAX planner's window tagging (``_tag_window``)
raise NotImplementedError, as the port has no CPU fallback. The port
runs one partition, where the exchanges the JAX planner inserts
(round-robin or hash between PARTIAL and FINAL and below a shuffled
join, broadcast below a broadcast join, range before a global sort)
pass batches through unchanged, so none is placed. Tagging, CPU
fallback and the cost model beyond row estimates are not ported: what
the JAX planner sends to its CPU engine for a DECIMAL(p>18) (a group-by
or join key, a window partition or order key, a window aggregate over
or into one) raises here (``expr/core.py cpu_fallback``); an ORDER BY
on one runs on the device (two sort words a key).
"""

from __future__ import annotations

from ..columnar import dtypes as dt
from ..conf import (BROADCAST_THRESHOLD_ROWS, WINDOW_BATCHED_RUNNING,
                    SrtConf)
from ..exec.aggregate import FINAL, PARTIAL, HashAggregateExec
from ..exec.base import TpuExec
from ..exec.basic import (BatchScanExec, ExpandExec, FilterExec,
                          LocalLimitExec, ProjectExec, UnionExec)
from ..exec.join import BroadcastHashJoinExec, ShuffledHashJoinExec
from ..exec.nested_loop_join import (BroadcastNestedLoopJoinExec,
                                     CartesianProductExec)
from ..exec.sort import SortExec, SortOrder, TopNExec
from ..exec.window import (BatchedRunningWindowExec, WindowExec,
                           running_compatible)
from ..expr import aggregates as Agg
from ..expr import window as W
from ..expr.cast import Cast
from ..expr.conditional import _common_type
from ..expr.core import Alias, Literal, col, cpu_fallback
from .cost import estimate_rows
from .logical import (Aggregate, DeviceRelation, Expand, Filter, Join,
                      Limit, LogicalPlan, Project, Sort, Union, Window)


AGG_TYPES = (Agg.Sum, Agg.Count, Agg.CountStar, Agg.Average, Agg.Min,
             Agg.Max)


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
    """The JAX planner's ``_build_join``: a keyless join is a cartesian
    product, or a nested-loop join with its condition; a full outer
    join is ``left_outer(L, R)`` UNION ``left_anti(R, L)`` with L's
    columns null (both children run twice: the port places no exchange
    to share them, so their operator metrics count twice); a right
    outer join builds the left side; an inner join's residual condition
    is a filter above it. Where the JAX planner would drop a condition
    (on an outer, semi or anti join) or run a keyless join as inner,
    this port raises."""
    left, right = children
    if plan.condition is not None and plan.join_type not in ("inner",
                                                              "cross"):
        raise NotImplementedError(
            f"a condition on a {plan.join_type} join is not in this port "
            "yet")
    if not plan.left_keys:
        if plan.join_type not in ("inner", "cross"):
            raise NotImplementedError(
                f"a {plan.join_type} join without equi-keys is not in this "
                "port yet")
        if plan.condition is None:
            return CartesianProductExec(left, right)
        return BroadcastNestedLoopJoinExec(left, right, plan.condition,
                                           "inner")
    _no_wide_keys(plan.left_keys, plan.children[0].schema, "join key")
    _no_wide_keys(plan.right_keys, plan.children[1].schema, "join key")
    left_keys, right_keys = _coerce_join_keys(plan)
    if plan.join_type == "full_outer":
        outer = ShuffledHashJoinExec(left, right, left_keys, right_keys,
                                     join_type="left_outer",
                                     build_side="right")
        anti = ShuffledHashJoinExec(right, left, right_keys, left_keys,
                                    join_type="left_anti",
                                    build_side="right")
        exprs = ([Alias(Literal(None, t), n)
                  for n, t in plan.children[0].schema] +
                 [Alias(col(n), n) for n, _ in plan.children[1].schema])
        return UnionExec(outer, ProjectExec(anti, exprs))
    build = "left" if plan.join_type == "right_outer" else "right"
    cls = _join_cls(plan, build, conf)
    joined = cls(left, right, left_keys, right_keys,
                 join_type=plan.join_type, build_side=build)
    if plan.condition is not None:
        return FilterExec(joined, plan.condition)
    return joined


def _no_wide_keys(exprs, schema, what: str) -> None:
    for e in exprs:
        t = e.data_type(schema)
        if dt.is_wide_decimal(t):
            raise cpu_fallback(f"a {what} of type {t}")


def _check_window(plan: Window) -> None:
    """The JAX planner's window tagging (``_tag_window``) as hard
    refusals: the port has no CPU fallback to send these to."""
    in_schema = plan.children[0].schema
    ranking = (W.RowNumber, W.Rank, W.DenseRank, W.PercentRank, W.NTile,
               W.Lead)
    if plan.window_exprs:
        spec = plan.window_exprs[0][0].spec
        _no_wide_keys(list(spec.partition_by) +
                      [o.expr for o in spec.order_fields], in_schema,
                      "window partition or order key")
    for we, name in plan.window_exprs:
        fn, frame = we.func, we.spec.frame
        what = f"window {name} ({type(fn).__name__})"
        if isinstance(fn, ranking):
            continue
        if isinstance(fn, AGG_TYPES) and (
                any(dt.is_wide_decimal(c.data_type(in_schema))
                    for c in fn.children) or
                dt.is_wide_decimal(fn.data_type(in_schema))):
            raise cpu_fallback(f"{what} over or into a DECIMAL(p>18)")
        if isinstance(fn, (Agg.Min, Agg.Max)):
            if fn.children[0].data_type(in_schema) == dt.STRING:
                raise NotImplementedError(
                    f"{what}: string min/max is not in this port yet")
        elif not isinstance(fn, (Agg.Sum, Agg.Count, Agg.CountStar,
                                 Agg.Average)):
            raise NotImplementedError(
                f"{what}: window function {type(fn).__name__} is not in "
                "this port yet")
        bounded = not (frame.is_running or frame.is_unbounded)
        if bounded and not frame.row_based:
            # value offsets: one numeric or date order key to search
            ofs = we.spec.order_fields
            kt = ofs[0].expr.data_type(in_schema) if len(ofs) == 1 \
                else None
            if kt is None or not (kt.is_integral or kt.is_floating
                                  or kt == dt.DATE or dt.is_decimal(kt)):
                raise NotImplementedError(
                    f"{what}: a RANGE frame needs one numeric or date "
                    f"order key, got {kt if kt is not None else len(ofs)}")
        if bounded and frame.row_based and \
                isinstance(fn, (Agg.Min, Agg.Max)) and \
                (frame.lo is None or frame.hi is None):
            raise NotImplementedError(
                f"{what}: min/max sliding frames need bounded ROWS "
                "offsets")


def _build_window(plan: Window, child: TpuExec, conf: SrtConf) -> TpuExec:
    _check_window(plan)
    if conf.get(WINDOW_BATCHED_RUNNING) and \
            running_compatible(plan.window_exprs, plan.children[0].schema):
        # running-only windows stream batch by batch over a sorted child
        # with carried state (GpuRunningWindowExec role)
        spec = plan.window_exprs[0][0].spec
        orders = ([SortOrder(e, True, True) for e in spec.partition_by] +
                  [SortOrder(o.expr, o.ascending, o.nulls_first)
                   for o in spec.order_fields])
        return BatchedRunningWindowExec(
            SortExec(child, orders, batch_rows=conf.batch_size_rows),
            plan.window_exprs)
    return WindowExec(child, plan.window_exprs)


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
    if isinstance(plan, Union):
        first = plan.children[0].schema
        for c in plan.children[1:]:
            for (name, a), (_, b) in zip(first, c.schema):
                if (dt.is_decimal(a) or dt.is_decimal(b)) and a != b:
                    # Spark widens the column to a common decimal; the
                    # port's Union keeps its first child's types
                    raise NotImplementedError(
                        f"a UNION of {a} and {b} in column {name} is not in "
                        "this port yet")
        return UnionExec(*children)
    if isinstance(plan, Expand):
        return ExpandExec(children[0], plan.projections, plan.schema)
    if isinstance(plan, Window):
        return _build_window(plan, children[0], conf)
    if isinstance(plan, Aggregate):
        _no_wide_keys(plan.group_exprs, plan.children[0].schema,
                      "group-by key")
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
