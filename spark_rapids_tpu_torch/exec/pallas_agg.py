"""Fused filter+aggregate lowering onto the tile_reduce kernel.

Counterpart of spark_rapids_tpu/exec/pallas_agg.py (the module and class
names are the JAX package's; the kernel is the Triton rewrite in
ops/device_kernels.py). A global HashAggregateExec whose aggregates —
and the predicates of the chain of FilterExecs below it, as far as each
is one too — are simple numeric expressions runs as ONE kernel pass per input batch:
each input column is read once and no filtered batch is materialized.

All lanes stay float64, so nothing here demotes types (the JAX
package's ``_demote_f64`` / ``no_f64`` exist for the TPU's float32
tiles). String predicates on a string column (``col = 'lit'``,
``col IN ('a', ...)``, ``startswith``, ``IS [NOT] NULL``) are rewritten
into kernel-lane nodes (``ops.device_kernels.StrPred`` / ``StrNull``,
the counterparts of the JAX package's ``_PaddedStrPred`` /
``_PaddedStrNull``): the column then rides into the kernel as its Arrow
offsets, chars and validity, and is compared there byte by byte (B2,
the string-predicate lane), with no padded copy.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnarBatch
from ..expr import aggregates as Agg
from ..expr import arithmetic as A
from ..expr import core as E
from ..expr import predicates as Pr
from ..expr import strings as S
from ..expr.cast import Cast
from ..ops import device_kernels as DK

_SAFE_NODES = (
    E.ColumnRef, E.Literal, E.Alias, Cast,
    A.Add, A.Subtract, A.Multiply, A.Divide, A.UnaryMinus,
    A.UnaryPositive, A.Abs, A.Least, A.Greatest,
    Pr.EqualTo, Pr.LessThan, Pr.GreaterThan, Pr.LessThanOrEqual,
    Pr.GreaterThanOrEqual, Pr.EqualNullSafe, Pr.And, Pr.Or, Pr.Not,
    Pr.IsNull, Pr.IsNotNull, Pr.IsNaN, Pr.InSet,
)
_SAFE_DTYPES = (dt.BOOL, dt.INT8, dt.INT16, dt.INT32, dt.DATE,
                dt.FLOAT32, dt.FLOAT64)
_FLOATY = (dt.FLOAT32, dt.FLOAT64)
_MINMAX_DTYPES = (dt.FLOAT32, dt.FLOAT64, dt.DATE, dt.INT8, dt.INT16)


def _rewrite_string_preds(pred: E.Expression, schema):
    """Replace eligible string predicate subtrees (col = 'lit',
    col IN ('a', 'b'), startswith, IS [NOT] NULL) with kernel-lane
    nodes; returns (rewritten, {string column names}), or (pred, set())
    unchanged when nothing matched."""
    schema_d = dict(schema)
    found: set = set()

    def is_str_ref(e):
        return isinstance(e, E.ColumnRef) and \
            schema_d.get(e.name) == dt.STRING

    def rw(e: E.Expression):
        if isinstance(e, Pr.EqualTo):
            l, r = e.children
            if is_str_ref(l) and isinstance(r, E.Literal) and \
                    isinstance(r.value, str):
                found.add(l.name)
                return DK.StrPred(l.name, [S.utf8(r.value)])
            if is_str_ref(r) and isinstance(l, E.Literal) and \
                    isinstance(l.value, str):
                found.add(r.name)
                return DK.StrPred(r.name, [S.utf8(l.value)])
        if isinstance(e, Pr.InSet) and is_str_ref(e.children[0]) and \
                all(isinstance(v, str) for v in e.values):
            found.add(e.children[0].name)
            return DK.StrPred(e.children[0].name,
                              [S.utf8(v) for v in e.values])
        if isinstance(e, S.StartsWith) and is_str_ref(e.children[0]):
            found.add(e.children[0].name)
            return DK.StrPred(e.children[0].name, [S.utf8(e.prefix)],
                              prefix=True)
        if isinstance(e, (Pr.IsNull, Pr.IsNotNull)) and \
                is_str_ref(e.children[0]):
            found.add(e.children[0].name)
            return DK.StrNull(e.children[0].name,
                              isinstance(e, Pr.IsNotNull))
        if not e.children:
            return e
        out = copy.copy(e)
        out.children = [rw(c) for c in e.children]
        return out

    return rw(pred), found


def _expr_safe(expr: E.Expression, schema) -> bool:
    """True when ``expr`` is inside the subset tile_reduce lowers."""
    if isinstance(expr, (DK.StrPred, DK.StrNull)):
        return True  # byte compares over the string lanes, exact
    if not isinstance(expr, _SAFE_NODES):
        return False
    if isinstance(expr, E.Literal) and expr.value is None:
        return False
    try:
        if expr.data_type(schema) not in _SAFE_DTYPES:
            return False
        if ansi_checked(expr, schema):
            return False
    except (KeyError, TypeError):
        return False
    return all(_expr_safe(c, schema) for c in expr.children)


def ansi_checked(expr: E.Expression, schema) -> bool:
    """Whether an ansi-marked node runs a check at its types, which the
    kernel cannot raise: integral arithmetic (its overflow), a divide
    by anything but a non-zero literal, the minus or abs of an integral
    and a cast that can fail. Double arithmetic has no ANSI check in
    Spark, so such a tree keeps the kernel lane."""
    if not getattr(expr, "ansi", False):
        return False
    if isinstance(expr, Cast):
        return expr.can_fail(schema)
    out_t = expr.data_type(schema)
    if isinstance(expr, A.Divide):
        d = expr.children[1]
        return not (isinstance(d, E.Literal) and d.value not in (None, 0))
    return out_t.is_integral or dt.is_decimal(out_t)


def _collect_refs(exprs, names: set) -> None:
    for e in exprs:
        if isinstance(e, E.ColumnRef):
            names.add(e.name)
        _collect_refs(e.children, names)


class PallasAggPlan:
    """Static lowering of (pred, agg_exprs) onto tile_reduce lanes."""

    def __init__(self, agg_exprs, input_schema, pred: Optional[E.Expression]):
        self.input_schema = list(input_schema)
        schema = self.input_schema
        self.str_names: List[str] = []
        if pred is not None:
            pred, snames = _rewrite_string_preds(pred, schema)
            self.str_names = sorted(snames)
        self.pred = pred
        self.kinds: List[str] = []
        #: per aggregate: [(state_name, slot_index, state_dtype)]
        self.agg_slots: List[List[Tuple[str, int, dt.DType]]] = []
        builders = []
        refs: set = set()
        if pred is not None:
            _collect_refs([pred], refs)
        for fn, _name in agg_exprs:
            in_t = fn.children[0].data_type(schema) if fn.children else None
            slots = []
            if isinstance(fn, (Agg.Sum, Agg.Average)):
                slots.append(("sum", self._slot(DK.SUM), dt.FLOAT64))
                slots.append(("count", self._slot(DK.SUM), dt.INT64))
                builders.append(("sum", fn.children[0]))
            elif isinstance(fn, Agg.CountStar):
                slots.append(("count", self._slot(DK.SUM), dt.INT64))
                builders.append(("count_star", None))
            elif isinstance(fn, Agg.Count):
                slots.append(("count", self._slot(DK.SUM), dt.INT64))
                builders.append(("count", fn.children[0]))
            elif isinstance(fn, (Agg.Min, Agg.Max)):
                kind = DK.MAX if fn.largest else DK.MIN
                slots.append((fn._key, self._slot(kind), in_t))
                slots.append(("seen", self._slot(DK.SUM), dt.BOOL))
                is_float = in_t in _FLOATY
                if is_float:
                    # Spark float order puts NaN greatest: the kernel
                    # reduces non-NaN lanes and this count restores NaN
                    slots.append(("_nan", self._slot(DK.SUM), dt.FLOAT64))
                builders.append((kind, fn.children[0], is_float))
            else:
                raise TypeError(f"no fused lowering for {type(fn).__name__}")
            self.agg_slots.append(slots)
        _collect_refs([fn for fn, _ in agg_exprs], refs)
        self.ref_names = sorted(refs)
        schema_d = dict(schema)
        self.program = DK.RowProgram(
            self.ref_names, [schema_d[n] for n in self.ref_names], pred,
            builders, self.str_names)

    def _slot(self, kind: str) -> int:
        self.kinds.append(kind)
        return len(self.kinds) - 1

    def batch_fn(self):
        """The fused per-batch function: batch -> float64[n_slots]."""
        program, kinds = self.program, self.kinds

        def run(batch: ColumnarBatch) -> torch.Tensor:
            return DK.tile_reduce(self.kernel_inputs(batch), program, kinds)
        return run

    def kernel_inputs(self, batch: ColumnarBatch) -> List[torch.Tensor]:
        """tile_reduce's inputs for one batch, in RowProgram's layout:
        (data, validity) per scalar column, (offsets, chars, validity)
        per string column, then the live mask."""
        arrays = []
        for n in self.ref_names:
            c = batch.column(n)
            arrays += [c.data, c.validity.view(torch.uint8)]
        for n in self.str_names:
            c = batch.column(n)
            arrays += [c.offsets, c.chars, c.validity.view(torch.uint8)]
        arrays.append(batch.live_mask().view(torch.uint8))
        return arrays

    # --- host-side accumulation -> packed aggregate states ---
    def init_totals(self) -> List[float]:
        return [float(DK.reduce_identity(k, torch.float64))
                for k in self.kinds]

    def combine(self, totals: List[float], partials: torch.Tensor) -> None:
        for i, (k, v) in enumerate(zip(self.kinds, partials.tolist())):
            if k == DK.SUM:
                totals[i] += v
            elif np.isnan(v) or np.isnan(totals[i]):
                totals[i] = float("nan")
            elif k == DK.MIN:
                totals[i] = min(totals[i], v)
            else:
                totals[i] = max(totals[i], v)

    def states(self, totals: List[float], device, cap: int = 8
               ) -> List[dict]:
        """Accumulated scalars -> per-aggregate state dicts shaped for
        HashAggregateExec._pack (cap-length tensors, group 0 live)."""
        out = []
        for slots in self.agg_slots:
            aux = {sname: totals[idx] for sname, idx, _ in slots}
            if "_nan" in aux:
                _key, key_idx, _t = slots[0]
                kkind = self.kinds[key_idx]
                nan_ct, seen_ct = aux["_nan"], aux["seen"]
                if kkind == DK.MAX and nan_ct > 0:
                    totals[key_idx] = float("nan")
                elif kkind == DK.MIN and nan_ct > 0 and seen_ct - nan_ct <= 0:
                    totals[key_idx] = float("nan")
            d = {}
            for sname, idx, stype in slots:
                if sname == "_nan":
                    continue
                v = totals[idx]
                arr = np.zeros(cap, stype.np_physical)
                if stype == dt.BOOL:
                    arr[0] = v > 0
                elif not (np.issubdtype(arr.dtype, np.integer)
                          and not np.isfinite(v)):
                    # an integer min/max of zero rows keeps 0: seen=False
                    arr[0] = np.asarray(v).astype(arr.dtype)
                d[sname] = torch.from_numpy(arr).to(device)
            out.append(d)
        return out


def grouped_eligible(agg_exec) -> bool:
    """Static gate for the grouped kernel lane: grouping keys present
    and every aggregate sum-decomposable (Sum/Average over floats,
    Count, CountStar). The <= 1024-group bound is checked per batch. A
    grouping with no aggregate (GROUP BY alone, DISTINCT) has nothing
    for the kernel to sum and stays out (the JAX package's gate lets it
    in, and its kernel then fails on zero lanes)."""
    if not agg_exec.group_exprs or not agg_exec.agg_exprs or \
            agg_exec.mode == "final":
        return False
    schema = list(agg_exec.input_schema)
    for fn, _name in agg_exec.agg_exprs:
        if type(fn) in (Agg.CountStar, Agg.Count):
            continue
        if type(fn) not in (Agg.Sum, Agg.Average):
            return False
        if fn.children[0].data_type(schema) not in _FLOATY:
            return False
    return True


def pallas_eligible(agg_exec) -> bool:
    """Static gate of the fused global lane; False keeps the stock
    path."""
    if agg_exec.group_exprs:
        return False
    schema = list(agg_exec.input_schema)
    for fn, _name in agg_exec.agg_exprs:
        try:
            in_t = fn.children[0].data_type(schema) if fn.children \
                else None
        except TypeError:  # no type: the stock path raises its error
            return False
        if isinstance(fn, (Agg.Sum, Agg.Average)):
            if in_t not in _FLOATY:
                return False
        elif isinstance(fn, (Agg.Min, Agg.Max)):
            if in_t not in _MINMAX_DTYPES:
                return False
        elif not isinstance(fn, (Agg.CountStar, Agg.Count)):
            return False
        if not all(_expr_safe(c, schema) for c in fn.children):
            return False
    return True


def build_plan(agg_exec, pred: Optional[E.Expression]) -> PallasAggPlan:
    return PallasAggPlan(agg_exec.agg_exprs, agg_exec.input_schema, pred)


def pred_safe(pred: E.Expression, input_schema) -> bool:
    """A filter predicate fuses into the kernel when tile_reduce can
    lower all of it; string predicate subtrees are judged after their
    rewrite into string-lane nodes, as in the JAX gate."""
    rewritten, _ = _rewrite_string_preds(pred, list(input_schema))
    return _expr_safe(rewritten, list(input_schema))
