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
on one runs on the device (two sort words a key). The JAX planner's
gates on nested types (JAX overrides.py:324-489: element, key, value and
lambda result types that are strings or nested, a column
``array_repeat`` count, an ``aggregate`` lambda reading outer columns,
an explode of a non-array, ``map_concat``, ``from_json`` / ``to_json``)
and its refusal of a nested GROUP BY, join or ORDER BY key raise the
same way at planning time (``_check_nested``). A Generate becomes a
GenerateExec.
"""

from __future__ import annotations

from ..columnar import dtypes as dt
from ..conf import (BROADCAST_THRESHOLD_ROWS, WINDOW_BATCHED_RUNNING,
                    SrtConf)
from ..exec.aggregate import FINAL, PARTIAL, HashAggregateExec
from ..exec.base import TpuExec
from ..exec.generate import GenerateExec
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
from .logical import (Aggregate, DeviceRelation, Expand, Filter, Generate,
                      Join, Limit, LogicalPlan, Project, Sort, Union,
                      Window)


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


def _string_or_nested(t: dt.DType) -> bool:
    return t.is_nested or t == dt.STRING


def _gate_primitive_elements(e, schema) -> None:
    """JAX ``_primitive_elements``: the lane kernels need a primitive
    (non-string) element type."""
    t = e.children[0].data_type(schema)
    if isinstance(t, dt.ArrayType) and _string_or_nested(t.element_type):
        raise cpu_fallback(f"{type(e).__name__} over {t.element_type} "
                           "elements")


def _gate_array_repeat(e, schema) -> None:
    if not isinstance(e.children[1], Literal):
        raise cpu_fallback("array_repeat with a column count")
    t = e.children[0].data_type(schema)
    if _string_or_nested(t):
        raise cpu_fallback(f"array_repeat of {t}")


def _gate_zip_with(e, schema) -> None:
    for child in e.children[:2]:
        t = child.data_type(schema)
        et = t.element_type if isinstance(t, dt.ArrayType) else t
        if _string_or_nested(et):
            raise cpu_fallback(f"zip_with over {et} elements")
    out = e.data_type(schema).element_type
    if _string_or_nested(out):
        raise cpu_fallback(f"zip_with producing {out}")


def _gate_lambda_elements(e, schema) -> None:
    """JAX ``_lambda_primitive_elements``: element, key and value types
    and a transform's lambda result must be primitive lanes."""
    from ..expr import higher_order as HO
    for child in e.children:
        t = child.data_type(schema)
        parts = [t.key_type, t.value_type] if isinstance(t, dt.MapType) \
            else [t.element_type] if isinstance(t, dt.ArrayType) else []
        for p in parts:
            if _string_or_nested(p):
                raise cpu_fallback(f"{type(e).__name__} over {p} elements")
    if isinstance(e, (HO.ArrayTransform, HO.TransformKeys,
                      HO.TransformValues)):
        rt = e.children[1].data_type(schema)
        if _string_or_nested(rt):
            raise cpu_fallback(f"{type(e).__name__} producing {rt}")


def _gate_aggregate(e, schema) -> None:
    from ..expr.higher_order import outer_refs
    for body in e.bodies():
        if outer_refs(body, e.lambda_vars):
            raise cpu_fallback("an aggregate() lambda reading outer "
                               "columns")
    _gate_lambda_elements(e, schema)


def _gate_explode(e, schema) -> None:
    t = e.children[0].data_type(schema)
    if not isinstance(t, dt.ArrayType):
        raise cpu_fallback(f"explode of {t}")


def _gate_cpu_only(e, schema) -> None:
    raise cpu_fallback(type(e).__name__)


def _nested_gates():
    from ..expr import collections as CX
    from ..expr import higher_order as HO
    from ..expr import json as JX
    gates = {}
    for cls in (CX.ArrayContains, CX.ArrayMin, CX.ArrayMax, CX.SortArray,
                CX.ArrayDistinct, CX.ArrayUnion, CX.ArrayIntersect,
                CX.ArrayExcept, CX.ArraysOverlap, CX.ArrayRemove,
                CX.ArrayPosition, CX.Slice, CX.ArrayReverse):
        gates[cls] = _gate_primitive_elements
    for cls in (HO.ArrayTransform, HO.ArrayExists, HO.ArrayForAll,
                HO.ArrayFilter, HO.GetMapValue, HO.MapContainsKey,
                HO.TransformValues, HO.TransformKeys, HO.MapFilter,
                HO.MapFromArrays):
        gates[cls] = _gate_lambda_elements
    gates[CX.ArrayRepeat] = _gate_array_repeat
    gates[CX.ZipWith] = _gate_zip_with
    gates[HO.ArrayAggregate] = _gate_aggregate
    gates[CX.Explode] = _gate_explode
    for cls in (CX.MapConcat, JX.JsonToStructs, JX.StructsToJson):
        gates[cls] = _gate_cpu_only
    return gates


_GATES = None


def _node_exprs(plan: LogicalPlan):
    """(expression, input schema) of each expression a node holds."""
    ins = [c.schema for c in plan.children]
    if isinstance(plan, Project):
        return [(e, ins[0]) for e in plan.exprs]
    if isinstance(plan, Filter):
        return [(plan.condition, ins[0])]
    if isinstance(plan, Aggregate):
        return [(e, ins[0]) for e in plan.group_exprs] + \
            [(fn, ins[0]) for fn, _ in plan.agg_exprs]
    if isinstance(plan, Sort):
        return [(o.expr, ins[0]) for o in plan.order]
    if isinstance(plan, Join):
        out = [(e, ins[0]) for e in plan.left_keys] + \
            [(e, ins[1]) for e in plan.right_keys]
        if plan.condition is not None:
            out.append((plan.condition, ins[0] + ins[1]))
        return out
    if isinstance(plan, Expand):
        return [(e, ins[0]) for p in plan.projections for e in p]
    if isinstance(plan, Generate):
        return [(plan.generator, ins[0])]
    if isinstance(plan, Window):
        return [(c, ins[0]) for we, _ in plan.window_exprs
                for c in list(we.func.children) + list(we.spec.partition_by)
                + [o.expr for o in we.spec.order_fields]]
    return []


def _check_nested(plan: LogicalPlan) -> None:
    """The JAX planner's nested-type gates as planning-time refusals:
    each expression tree typed root first (a higher-order function binds
    its lambda variables' types), then every node of it gated; a nested
    grouping, join or sort key refused."""
    global _GATES
    if _GATES is None:
        _GATES = _nested_gates()
    for child in plan.children:
        _check_nested(child)
    for root, schema in _node_exprs(plan):
        gated, stack = [], [root]
        while stack:
            e = stack.pop()
            if type(e) in _GATES:
                gated.append(e)
            stack.extend(e.children)
        if gated:
            root.data_type(schema)
            for e in gated:
                _GATES[type(e)](e, schema)
    keys = []
    if isinstance(plan, Aggregate):
        keys = [("group-by key", e, plan.children[0].schema)
                for e in plan.group_exprs]
    elif isinstance(plan, Sort):
        keys = [("sort key", o.expr, plan.children[0].schema)
                for o in plan.order]
    elif isinstance(plan, Join):
        keys = [("join key", e, plan.children[0].schema)
                for e in plan.left_keys] + \
            [("join key", e, plan.children[1].schema)
             for e in plan.right_keys]
    for what, e, schema in keys:
        t = e.data_type(schema)
        if t.is_nested:
            raise cpu_fallback(f"a {what} of type {t}")


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
    if isinstance(plan, Generate):
        return GenerateExec(children[0], plan.generator, plan.element_name,
                            plan.pos_name)
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
    _check_nested(plan)
    return _to_physical(plan, conf)
