"""Rule registry, tag-then-convert planning and logical -> physical
conversion.

Counterpart of spark_rapids_tpu/plan/overrides.py (GpuOverrides'
role): a registry of expression rules (``ExprRule``: a type signature
and an extra tag) and exec rules (``ExecRule``), the tagging pass over
the meta wrappers (meta.py), and the conversion of the tagged tree into
a physical tree that mixes device subtrees with CPU-engine subtrees,
with transitions at the seams (transitions.py).

The port's rules state what the port's device code runs, which is at
least what the JAX rules admit; where the port runs more, its rule
stays wider (``tests/test_torch_fallback.py`` lists each difference):
string ``least`` / ``greatest``, multi-byte LIKE patterns, CASE / IF /
COALESCE over two decimal types, map projections, nested payload
columns through sort, join, union and expand, and an ORDER BY on a
DECIMAL(p>18) run on the device. What a rule tags runs on the CPU
engine and ``srt.sql.explain`` / ``DataFrame.explain`` print why:

- a DECIMAL(p>18) as a group-by or join key (a join key's common type
  included), a window partition or order key, under ``div`` / ``%`` /
  ``pmod`` / ``least`` / ``greatest``, a window aggregate over or into
  one, or cast to or from STRING; an ``approx_percentile`` of a decimal,
  and the exact ``percentile``;
- a nested group-by, join or sort key and the nested gates (string or
  nested elements under the list kernels and lambdas, a column
  ``array_repeat`` count, an ``aggregate`` lambda reading outer
  columns, ``map_concat``, ``from_json`` / ``to_json``);
- window functions the window execs do not run (stddev / variance,
  first / last, collect, a string min / max), a min / max sliding frame
  without bounded ROWS offsets (a RANGE frame with value offsets needs
  one numeric or date order key: Spark refuses the rest, and so does
  the planner);
- a regex the device's transpiler refuses, and group references in a
  ``regexp_replace`` replacement;
- a condition on an outer, semi or anti join, and a keyless one that
  is not inner (ROADMAP C10).

An Aggregate becomes PARTIAL -> FINAL HashAggregateExec; an equi-Join a
BroadcastHashJoinExec when its build side's estimated rows are at most
``srt.sql.broadcastRowThreshold`` and a ShuffledHashJoinExec otherwise,
a keyless one a CartesianProductExec or a BroadcastNestedLoopJoinExec,
a full outer one a UnionExec of two hash joins; a Window a
BatchedRunningWindowExec over a SortExec when every function streams
with carried state, else a WindowExec; Limit over Sort a TopNExec. The
port runs one partition, so no exchange is placed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from ..columnar import dtypes as dt
from ..conf import (BROADCAST_THRESHOLD_ROWS, EXPLAIN, SQL_ENABLED,
                    WINDOW_BATCHED_RUNNING, SrtConf)
from ..exec.aggregate import FINAL, PARTIAL, HashAggregateExec
from ..exec.base import TpuExec
from ..exec.basic import (BatchScanExec, ExpandExec, FilterExec,
                          LocalLimitExec, ProjectExec, RangeExec, SampleExec,
                          UnionExec)
from ..exec.generate import GenerateExec
from ..exec.join import BroadcastHashJoinExec, ShuffledHashJoinExec
from ..exec.nested_loop_join import (BroadcastNestedLoopJoinExec,
                                     CartesianProductExec)
from ..exec.sort import SortExec, SortOrder, TopNExec
from ..exec.window import (BatchedRunningWindowExec, WindowExec,
                           running_compatible)
from ..expr import aggregates as Agg
from ..expr import window as W
from ..expr.cast import Cast, cpu_only
from ..expr.core import Alias, Expression, Literal, col
from . import typechecks as ts
from .cost import apply_cost_model, estimate_rows
from .logical import (Aggregate, DeviceRelation, Expand, Filter, Generate,
                      Join, Limit, LocalRelation, LogicalPlan, Project,
                      Range, Sample, Sort, Union, Window)
from .meta import ExprMeta, PlanMeta
from .transitions import CpuPhysical, DeviceToHostBridge, HostToDeviceExec


class ExprRule:
    """Support metadata for one expression class (GpuOverrides.expr):
    the types its inputs may have on the device and an extra tag."""

    def __init__(self, cls: Type, sig: ts.TypeSig,
                 extra_tag: Optional[Callable[[ExprMeta], None]] = None):
        self.cls = cls
        self.sig = sig
        self.extra_tag = extra_tag

    def tag(self, meta: ExprMeta) -> None:
        for child in meta.expr.children:
            reason = self.sig.reason_if_unsupported(
                child.data_type(meta.schema),
                f"{type(meta.expr).__name__} input")
            if reason:
                meta.will_not_work_on_tpu(reason)
        if self.extra_tag is not None:
            self.extra_tag(meta)


class ExecRule:
    """Support metadata for one logical node class (GpuOverrides.exec)."""

    def __init__(self, cls: Type,
                 tag_fn: Optional[Callable[[PlanMeta], None]] = None):
        self.cls = cls
        self.tag_fn = tag_fn

    def tag(self, meta: PlanMeta) -> None:
        if self.tag_fn is not None:
            self.tag_fn(meta)


_EXPR_RULES: Dict[Type, ExprRule] = {}
_EXEC_RULES: Dict[Type, ExecRule] = {}


def expr_rule_for(cls: Type) -> Optional[ExprRule]:
    if not _EXPR_RULES:
        _register_expr_rules()
    return _EXPR_RULES.get(cls)


def exec_rule_for(cls: Type) -> Optional[ExecRule]:
    return _EXEC_RULES.get(cls)


# --- expression rules ------------------------------------------------------

#: every type tag: the default signature of a port expression, whose
#: device code takes what its data_type admits
ALL_TYPES = ts.TypeSig(*ts.ALL_TAGS)
NO_WIDE = ALL_TYPES - ts.decimal128


def _string_or_nested(t: dt.DType) -> bool:
    return t.is_nested or t == dt.STRING


def _tag_cast(meta: ExprMeta) -> None:
    src = meta.expr.children[0].data_type(meta.schema)
    if cpu_only(src, meta.expr.to):
        meta.will_not_work_on_tpu(f"cast: {src} -> {meta.expr.to} runs on "
                                  "the CPU engine")


def _tag_regex(meta: ExprMeta) -> None:
    """_tag_rlike / _tag_regexp_extract / _tag_regexp_replace: a pattern
    the device's transpiler refuses, or group references in a
    replacement, run through Python's ``re``."""
    reason = meta.expr.device_unsupported()
    if reason:
        meta.will_not_work_on_tpu(reason)


def _tag_primitive_elements(meta: ExprMeta) -> None:
    """JAX ``_primitive_elements``: the list kernels need a primitive
    (non-string) element type."""
    t = meta.expr.children[0].data_type(meta.schema)
    if isinstance(t, dt.ArrayType) and _string_or_nested(t.element_type):
        meta.will_not_work_on_tpu(
            f"{type(meta.expr).__name__}: {t.element_type} elements run "
            "on the CPU engine")


def _tag_array_repeat(meta: ExprMeta) -> None:
    if not isinstance(meta.expr.children[1], Literal):
        meta.will_not_work_on_tpu("array_repeat: a column count runs on "
                                  "the CPU engine")
    t = meta.expr.children[0].data_type(meta.schema)
    if _string_or_nested(t):
        meta.will_not_work_on_tpu(f"array_repeat of {t} runs on the CPU "
                                  "engine")


def _tag_zip_with(meta: ExprMeta) -> None:
    for child in meta.expr.children[:2]:
        t = child.data_type(meta.schema)
        et = t.element_type if isinstance(t, dt.ArrayType) else t
        if _string_or_nested(et):
            meta.will_not_work_on_tpu(f"zip_with over {et} elements runs "
                                      "on the CPU engine")
    out = meta.expr.data_type(meta.schema).element_type
    if _string_or_nested(out):
        meta.will_not_work_on_tpu(f"zip_with producing {out} runs on the "
                                  "CPU engine")


def _tag_lambda_elements(meta: ExprMeta) -> None:
    """JAX ``_lambda_primitive_elements``: element, key and value types
    and a transform's lambda result must be primitive lanes."""
    from ..expr import higher_order as HO
    what = type(meta.expr).__name__
    for child in meta.expr.children:
        t = child.data_type(meta.schema)
        parts = [t.key_type, t.value_type] if isinstance(t, dt.MapType) \
            else [t.element_type] if isinstance(t, dt.ArrayType) else []
        for p in parts:
            if _string_or_nested(p):
                meta.will_not_work_on_tpu(f"{what}: {p} elements run on "
                                          "the CPU engine")
    if isinstance(meta.expr, (HO.ArrayTransform, HO.TransformKeys,
                              HO.TransformValues)):
        rt = meta.expr.children[1].data_type(meta.schema)
        if _string_or_nested(rt):
            meta.will_not_work_on_tpu(f"{what}: a {rt} lambda result runs "
                                      "on the CPU engine")


def _tag_aggregate_lambda(meta: ExprMeta) -> None:
    from ..expr.higher_order import outer_refs
    for body in meta.expr.bodies():
        if outer_refs(body, meta.expr.lambda_vars):
            meta.will_not_work_on_tpu("aggregate(): a lambda reading outer "
                                      "columns runs on the CPU engine")
    _tag_lambda_elements(meta)


def _tag_explode(meta: ExprMeta) -> None:
    t = meta.expr.children[0].data_type(meta.schema)
    if not isinstance(t, (dt.ArrayType, dt.MapType)):
        meta.will_not_work_on_tpu(f"explode of {t} runs on the CPU engine")


def _tag_cpu_only(meta: ExprMeta) -> None:
    meta.will_not_work_on_tpu(f"{type(meta.expr).__name__} runs on the "
                              "CPU engine")


def _concrete_expression_classes():
    """Every expression class of the port that can stand in a plan."""
    import importlib
    import pkgutil

    from .. import expr as pkg
    abstract = {"Expression", "BinaryArithmetic", "BinaryComparison",
                "AggregateFunction", "WindowFunction", "HigherOrderFunction",
                "WindowExpression"}
    out = []
    for m in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{m.name}")
        for name, cls in vars(mod).items():
            if (isinstance(cls, type) and issubclass(cls, Expression)
                    and cls.__module__ == mod.__name__
                    and not name.startswith("_") and name not in abstract):
                out.append(cls)
    return out


def _register_expr_rules() -> None:
    from ..expr import arithmetic as A
    from ..expr import bitwise as BW
    from ..expr import collections as CX
    from ..expr import hashing as H
    from ..expr import higher_order as HO
    from ..expr import json as JX
    from ..expr import regex as RX
    rules = {cls: ExprRule(cls, ALL_TYPES)
             for cls in _concrete_expression_classes()}

    def rule(cls, sig=ALL_TYPES, extra=None):
        rules[cls] = ExprRule(cls, sig, extra)

    # mod / div on a DECIMAL(p>18) needs wider than 128-bit alignment
    for cls in (A.IntegralDivide, A.Remainder, A.Pmod):
        rule(cls, NO_WIDE)
    for cls in (BW.BitwiseAnd, BW.BitwiseOr, BW.BitwiseXor, BW.BitwiseNot,
                BW.BitCount):
        rule(cls, ts.integral + ts.TypeSig(ts.BOOLEAN))
    for cls in (BW.ShiftLeft, BW.ShiftRight, BW.ShiftRightUnsigned,
                BW.InterleaveBits):
        rule(cls, ts.integral)
    rule(H.BloomFilterMightContain,
         ts.integral + ts.TypeSig(ts.DATE, ts.TIMESTAMP, ts.STRING))
    # the sketch reads its values as doubles; exact percentile keeps no
    # bounded state and runs on the CPU engine, as in the JAX planner
    rule(Agg.ApproxPercentile, ts.numeric_no_decimal)
    rule(Agg.Percentile, extra=_tag_cpu_only)
    # strings fold on the device (the JAX package sends them to its CPU
    # engine); a DECIMAL(p>18) does not
    for cls in (A.Least, A.Greatest):
        rule(cls, NO_WIDE)
    rule(Cast, extra=_tag_cast)
    for cls in (RX.RLike, RX.RegExpExtract, RX.RegExpReplace):
        rule(cls, extra=_tag_regex)
    for cls in (CX.ArrayContains, CX.ArrayMin, CX.ArrayMax, CX.SortArray,
                CX.ArrayDistinct, CX.ArrayUnion, CX.ArrayIntersect,
                CX.ArrayExcept, CX.ArraysOverlap, CX.ArrayRemove,
                CX.ArrayPosition, CX.Slice, CX.ArrayReverse):
        rule(cls, extra=_tag_primitive_elements)
    for cls in (HO.ArrayTransform, HO.ArrayExists, HO.ArrayForAll,
                HO.ArrayFilter, HO.GetMapValue, HO.MapContainsKey,
                HO.TransformValues, HO.TransformKeys, HO.MapFilter,
                HO.MapFromArrays):
        rule(cls, extra=_tag_lambda_elements)
    rule(CX.ArrayRepeat, extra=_tag_array_repeat)
    rule(CX.ZipWith, extra=_tag_zip_with)
    rule(HO.ArrayAggregate, extra=_tag_aggregate_lambda)
    rule(CX.Explode, extra=_tag_explode)
    for cls in (CX.MapConcat, JX.JsonToStructs, JX.StructsToJson):
        rule(cls, extra=_tag_cpu_only)
    _EXPR_RULES.update(rules)


# --- exec rules ------------------------------------------------------------

def _tag_keys(meta: PlanMeta, what: str, typed) -> None:
    """A nested or DECIMAL(p>18) key runs on the CPU engine."""
    for t in typed:
        if t.is_nested or dt.is_wide_decimal(t):
            meta.will_not_work_on_tpu(f"a {what} of type {t} runs on the "
                                      "CPU engine")


def _tag_agg(meta: PlanMeta) -> None:
    schema = meta.plan.children[0].schema
    _tag_keys(meta, "group-by key",
              [e.data_type(schema) for e in meta.plan.group_exprs])


def _tag_sort(meta: PlanMeta) -> None:
    """A nested sort key; a DECIMAL(p>18) one sorts on the device (two
    sort words a key), where the JAX planner sends it to its CPU
    engine."""
    schema = meta.plan.children[0].schema
    for o in meta.plan.order:
        t = o.expr.data_type(schema)
        if t.is_nested:
            meta.will_not_work_on_tpu(f"a sort key of type {t} runs on "
                                      "the CPU engine")


def _tag_join(meta: PlanMeta) -> None:
    plan: Join = meta.plan
    if plan.condition is not None and plan.join_type not in ("inner",
                                                              "cross"):
        # a residual condition on an outer, semi or anti join decides
        # which pairs match (ROADMAP C10)
        meta.will_not_work_on_tpu(f"a condition on a {plan.join_type} "
                                  "join runs on the CPU engine")
    if not plan.left_keys and plan.join_type not in ("inner", "cross"):
        meta.will_not_work_on_tpu(f"a keyless {plan.join_type} join runs "
                                  "on the CPU engine")
    keys, _ = plan.coerced_keys()   # the type both sides meet at
    _tag_keys(meta, "join key",
              [k.data_type(plan.children[0].schema) for k in keys])


_RANKING = (W.RowNumber, W.Rank, W.DenseRank, W.PercentRank, W.NTile,
            W.Lead)
_WINDOW_AGGS = (Agg.Sum, Agg.Count, Agg.CountStar, Agg.Average, Agg.Min,
                Agg.Max)


def _tag_window(meta: PlanMeta) -> None:
    """The JAX planner's ``_tag_window``, for what the port's window
    execs run."""
    plan: Window = meta.plan
    schema = plan.children[0].schema
    if plan.window_exprs:
        spec = plan.window_exprs[0][0].spec
        _tag_keys(meta, "window partition or order key", [
            e.data_type(schema) for e in list(spec.partition_by) +
            [o.expr for o in spec.order_fields]])
    for we, name in plan.window_exprs:
        fn, frame = we.func, we.spec.frame
        what = f"window {name} ({type(fn).__name__})"
        if isinstance(fn, _RANKING):
            continue
        if not isinstance(fn, _WINDOW_AGGS):
            meta.will_not_work_on_tpu(f"{what} runs on the CPU engine")
            continue
        types = [c.data_type(schema) for c in fn.children] + \
            [fn.data_type(schema)]
        if any(dt.is_wide_decimal(t) for t in types):
            meta.will_not_work_on_tpu(f"{what} over or into a "
                                      "DECIMAL(p>18) runs on the CPU engine")
        if isinstance(fn, (Agg.Min, Agg.Max)) and types[0] == dt.STRING:
            meta.will_not_work_on_tpu(f"{what}: a string min / max runs "
                                      "on the CPU engine")
        bounded = not (frame.is_running or frame.is_unbounded)
        if bounded and not frame.row_based:
            ofs = we.spec.order_fields
            kt = ofs[0].expr.data_type(schema) if len(ofs) == 1 else None
            if kt is None or not (kt.is_integral or kt.is_floating
                                  or kt == dt.DATE or dt.is_decimal(kt)):
                # Spark refuses such a frame when it analyzes the query
                raise NotImplementedError(
                    f"{what}: a RANGE frame needs one numeric or date "
                    f"order key, got {kt if kt is not None else len(ofs)}")
        if bounded and frame.row_based and \
                isinstance(fn, (Agg.Min, Agg.Max)) and \
                (frame.lo is None or frame.hi is None):
            meta.will_not_work_on_tpu(
                f"{what}: a min / max sliding frame without bounded ROWS "
                "offsets runs on the CPU engine")


_EXEC_RULES.update({
    DeviceRelation: ExecRule(DeviceRelation),
    LocalRelation: ExecRule(LocalRelation),
    Project: ExecRule(Project),
    Filter: ExecRule(Filter),
    Limit: ExecRule(Limit),
    Union: ExecRule(Union),
    Range: ExecRule(Range),
    Sample: ExecRule(Sample),
    Expand: ExecRule(Expand),
    Generate: ExecRule(Generate),
    Sort: ExecRule(Sort, _tag_sort),
    Aggregate: ExecRule(Aggregate, _tag_agg),
    Join: ExecRule(Join, _tag_join),
    Window: ExecRule(Window, _tag_window),
})


# --- conversion ------------------------------------------------------------

def _sort_orders(sort: Sort):
    return [SortOrder(o.expr, o.ascending, o.nulls_first)
            for o in sort.order]


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
    is a filter above it. ``_tag_join`` sends the rest to the CPU
    engine."""
    left, right = children
    if not plan.left_keys:
        if plan.condition is None:
            return CartesianProductExec(left, right)
        return BroadcastNestedLoopJoinExec(left, right, plan.condition,
                                           "inner")
    left_keys, right_keys = plan.coerced_keys()
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


def _build_window(plan: Window, child: TpuExec, conf: SrtConf) -> TpuExec:
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


def _build_device_exec(plan: LogicalPlan, children: List[TpuExec],
                       conf: SrtConf) -> TpuExec:
    if isinstance(plan, DeviceRelation):
        return BatchScanExec(plan.batches, plan.schema)
    if isinstance(plan, LocalRelation):
        # host data enters the device through the transition
        return HostToDeviceExec(CpuPhysical(plan, []))
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
        # each child cast to the union's widened types
        casts = [plan.child_casts(i) for i in range(len(children))]
        return UnionExec(*[c if e is None else ProjectExec(c, e)
                           for c, e in zip(children, casts)])
    if isinstance(plan, Range):
        return RangeExec(plan.start, plan.end, plan.step)
    if isinstance(plan, Sample):
        return SampleExec(children[0], plan.fraction, plan.seed)
    if isinstance(plan, Expand):
        return ExpandExec(children[0], plan.projections, plan.schema)
    if isinstance(plan, Window):
        return _build_window(plan, children[0], conf)
    if isinstance(plan, Generate):
        return GenerateExec(children[0], plan.generator, plan.element_name,
                            plan.pos_name, plan.value_name)
    if isinstance(plan, Aggregate):
        partial = HashAggregateExec(children[0], plan.group_exprs,
                                    plan.agg_exprs, mode=PARTIAL)
        return HashAggregateExec(partial, plan.group_exprs, plan.agg_exprs,
                                 mode=FINAL,
                                 input_schema=plan.children[0].schema)
    raise NotImplementedError(
        f"{type(plan).__name__} has no physical operator in this port yet")


def _to_device(children):
    return [c if isinstance(c, TpuExec) else HostToDeviceExec(c)
            for c in children]


def _refs(plan: LogicalPlan) -> set:
    out = set()
    for e in plan.expressions():
        out |= e.references()
    return out


def _child_needs(plan: LogicalPlan, needed):
    """The columns each child must give when the node's parent reads
    ``needed`` of its output (None: every column)."""
    k = len(plan.children)
    if isinstance(plan, (Project, Aggregate, Expand)):
        return [_refs(plan)] * k
    if needed is None or isinstance(plan, Union):
        return [None] * k
    if isinstance(plan, (Window, Generate)):
        made = {n for n, _ in plan.schema} - \
            {n for n, _ in plan.children[0].schema}
        return [(needed - made) | _refs(plan)]
    if isinstance(plan, Join):
        want = needed | _refs(plan)
        return [want & {n for n, _ in c.schema} for c in plan.children]
    return [needed | _refs(plan)] * k


class _Input(LogicalPlan):
    """A CPU-engine node's child as the seam gives it: the logical
    child's columns that the plan above reads."""

    def __init__(self, schema):
        super().__init__()
        self._schema = list(schema)

    @property
    def schema(self):
        return self._schema


def _kept(schema, need):
    """The columns of ``schema`` that ``need`` names, in order; one
    column where it names none (the rows must still cross); None to keep
    them all."""
    names = [n for n, _ in schema]
    if need is None or len(set(names)) < len(names) or set(names) <= need:
        return None
    return [n for n in names if n in need] or names[:1]


def _prune(child: TpuExec, need) -> TpuExec:
    """A device child cut to the columns ``need`` names, below a seam
    (the bytes a DeviceToHost seam moves: Spark's ColumnPruning at the
    seams)."""
    keep = _kept(child.output_schema, need)
    return child if keep is None else ProjectExec(child,
                                                  [col(n) for n in keep])


def _to_physical(meta: PlanMeta, conf: SrtConf, needed=None):
    """A TpuExec where the node runs on the device, a CpuPhysical where
    it runs on the CPU engine; a seam wherever the two meet. ``needed``
    names the columns the parent reads (None: all): a DeviceToHost seam
    moves only those, and a CPU-engine node's output keeps only those."""
    on = conf.get(SQL_ENABLED)
    plan = meta.plan
    if (isinstance(plan, Limit) and isinstance(plan.children[0], Sort)
            and on and meta.can_this_be_replaced
            and meta.child_plans[0].can_this_be_replaced):
        # ORDER BY + LIMIT fuse into one top-n operator, across a seam
        sort_meta = meta.child_plans[0]
        child = _to_device([_to_physical(c, conf)
                            for c in sort_meta.child_plans])[0]
        return TopNExec(child, _sort_orders(sort_meta.plan), plan.n)
    needs = _child_needs(plan, needed)
    if on and meta.can_this_be_replaced:
        # device operators read their inputs by name; only those that
        # replace their columns tell a CPU-engine child what they read
        if not isinstance(plan, (Project, Aggregate)):
            needs = [None] * len(needs)
        children = [_to_physical(c, conf, n)
                    for c, n in zip(meta.child_plans, needs)]
        return _build_device_exec(plan, _to_device(children), conf)
    keep = _kept(plan.schema, needed) \
        if isinstance(plan, DeviceRelation) else None
    if keep is not None:
        plan = DeviceRelation([b.select(keep) for b in plan.batches],
                              [(n, t) for n, t in plan.schema if n in keep])
    children = [_to_physical(c, conf, n)
                for c, n in zip(meta.child_plans, needs)]
    children = [DeviceToHostBridge(_prune(c, n))
                if isinstance(c, TpuExec) else c
                for c, n in zip(children, needs)]
    schemas = [c.output_schema for c in children]
    if any(s != c.schema for s, c in zip(schemas, plan.children)):
        plan = plan.with_children([_Input(s) for s in schemas])
    return CpuPhysical(plan, children)


def tag_only(plan: LogicalPlan, conf: Optional[SrtConf] = None) -> PlanMeta:
    """The tagging pass without conversion (explain), with the cost
    model where the conf enables it, so the marks are those
    ``apply_overrides`` plans by."""
    meta = PlanMeta(plan)
    meta.tag_for_tpu()
    apply_cost_model(meta, conf or SrtConf())
    return meta


def apply_overrides(plan: LogicalPlan, conf: SrtConf):
    """Wrap, tag, convert (GpuOverrides.applyWithContext). The root is a
    TpuExec (a device result) or a CpuPhysical (a host result).
    ``srt.sql.explain`` prints the marks: ``*`` on the device, ``!`` on
    the CPU engine with the reasons."""
    meta = tag_only(plan, conf)
    mode = conf.get(EXPLAIN)
    if mode != "NONE":
        lines = meta.explain_lines(only_not_on_tpu=mode == "NOT_ON_TPU")
        if lines:
            print("\n".join(lines))
    return _to_physical(meta, conf)


def generate_supported_ops_doc() -> str:
    """The expression rules' type signatures as a table (TypeChecks'
    doc generation): one row an expression class, one column a type
    tag; ``S`` runs on the device, ``NS`` sends the expression to the
    CPU engine. Extra tags (nested gates, regex, casts) are not in the
    table."""
    if not _EXPR_RULES:
        _register_expr_rules()
    tags = ts.ALL_TAGS
    lines = ["| Expression | " + " | ".join(tags) + " |",
             "|---" * (len(tags) + 1) + "|"]
    for cls in sorted(_EXPR_RULES, key=lambda c: c.__name__):
        sig = _EXPR_RULES[cls].sig
        cells = ["S" if t in sig.tags else "NS" for t in tags]
        lines.append(f"| {cls.__name__} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"
