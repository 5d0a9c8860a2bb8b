"""Aggregate functions: update / merge / finalize over segment ids.

Counterpart of spark_rapids_tpu/expr/aggregates.py (Sum, Average,
Count, CountStar, Min, Max on non-decimal inputs, Min and Max on
strings too, the variance / stddev family, CollectList and CollectSet).
Every aggregate splits into an update phase (raw rows -> per-group
partial state), a merge phase (partial states -> merged state) and
finalize; states are dicts of tensors (a StringColumn for a string
MIN / MAX, a ListColumn for a collect) sized to the group table, so
partials flow as batches.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..columnar import dtypes as dt
from ..columnar.nested import ListColumn
from ..columnar.vector import (Column, ColumnVector, StringColumn,
                               compaction_indices, live_mask, with_validity)
from .core import Expression, Schema

State = Dict[str, torch.Tensor]


def _seg_sum(values, gid, num_groups, dtype=None):
    """Per-group sums over rows in group order (``gid`` non-decreasing:
    the grouping hands every aggregate its rows so). Integer sums are
    exact in any order (``index_add_``); float sums go through
    _ordered_seg_sum on every device."""
    out = torch.zeros(num_groups, dtype=dtype or values.dtype,
                      device=values.device)
    if out.is_floating_point():
        return _ordered_seg_sum(values.to(out.dtype), gid, out)
    return out.index_add_(0, gid, values.to(out.dtype))


def _ordered_seg_sum(values, gid, out):
    """Per-group float sums whose rounding depends only on each group's
    own values in row order: a log-step segmented scan over the rows
    (``gid`` non-decreasing), each group's total read at its last row.
    Two groups over the same rows get the same bits (a ROLLUP subtotal
    over one child ties with it exactly), every run and every device
    adds in the same association, and no atomics are involved
    (``index_add_`` adds floats on the card in an order that varies
    between runs)."""
    n = values.shape[0]
    if n == 0:
        return out
    g, v = gid, values
    step = 1
    while step < n:
        same = g[step:] == g[:-step]
        v = torch.cat([v[:step], v[step:] + torch.where(
            same, v[:-step], torch.zeros((), dtype=v.dtype,
                                         device=v.device))])
        step *= 2
    last = torch.ones(n, dtype=torch.bool, device=v.device)
    last[:-1] = g[1:] != g[:-1]
    # one total and zeros per group: exact in any order, and no host sync
    return out.index_add_(0, g, torch.where(last, v, torch.zeros(
        (), dtype=v.dtype, device=v.device)))


def _seg_reduce(values, gid, num_groups, fill, how):
    out = torch.full((num_groups,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, gid, values, how, include_self=True)


def _phys_extreme(dtype: torch.dtype, largest: bool):
    if dtype == torch.bool:
        return largest
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


class AggregateFunction(Expression):
    """Base; children[0] (if any) is the input expression."""

    name = "agg"
    #: True when update / merge need the rows of a group contiguous in
    #: key-sorted order (the collects' offset relabelling); grouping
    #: then takes the sort path, never the hash-claim one
    needs_sorted_groups = False

    def over(self, spec):
        """Use as a window aggregate: sum(x).over(spec)."""
        from .window import WindowExpression
        return WindowExpression(self, spec)

    def state_schema(self, schema: Schema) -> List:
        """[(state_name, DType), ...] — the partial-aggregation buffer."""
        raise NotImplementedError

    def update(self, gid, col: Column, num_groups: int, live) -> State:
        raise NotImplementedError

    def merge(self, gid, states: State, num_groups: int) -> State:
        raise NotImplementedError

    def finalize(self, states: State):
        """-> (data, validity) of the output column."""
        raise NotImplementedError


class Sum(AggregateFunction):
    """Spark sum: long for integrals, double for floats; an empty or
    all-null group is null."""

    name = "sum"

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        return dt.INT64 if t.is_integral or t == dt.BOOL else dt.FLOAT64

    def state_schema(self, schema: Schema) -> List:
        return [("sum", self.data_type(schema)), ("count", dt.INT64)]

    def update(self, gid, col, num_groups, live) -> State:
        out_t = dt.INT64 if col.dtype.is_integral or col.dtype == dt.BOOL \
            else dt.FLOAT64
        vals = torch.where(col.validity, col.data.to(out_t.physical),
                           torch.zeros((), dtype=out_t.physical,
                                       device=col.data.device))
        return {"sum": _seg_sum(vals, gid, num_groups),
                "count": _seg_sum(col.validity.to(torch.int64), gid,
                                  num_groups)}

    def merge(self, gid, states, num_groups) -> State:
        return {"sum": _seg_sum(states["sum"], gid, num_groups),
                "count": _seg_sum(states["count"], gid, num_groups)}

    def finalize(self, states):
        return states["sum"], states["count"] > 0


class Count(AggregateFunction):
    """count(x): non-null count."""

    name = "count"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def state_schema(self, schema: Schema) -> List:
        return [("count", dt.INT64)]

    def update(self, gid, col, num_groups, live) -> State:
        return {"count": _seg_sum((col.validity & live).to(torch.int64), gid,
                                  num_groups)}

    def merge(self, gid, states, num_groups) -> State:
        return {"count": _seg_sum(states["count"], gid, num_groups)}

    def finalize(self, states):
        return states["count"], torch.ones_like(states["count"],
                                                dtype=torch.bool)


class CountStar(AggregateFunction):
    name = "count(*)"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def state_schema(self, schema: Schema) -> List:
        return [("count", dt.INT64)]

    def update(self, gid, col, num_groups, live) -> State:
        return {"count": _seg_sum(live.to(torch.int64), gid, num_groups)}

    def merge(self, gid, states, num_groups) -> State:
        return {"count": _seg_sum(states["count"], gid, num_groups)}

    def finalize(self, states):
        return states["count"], torch.ones_like(states["count"],
                                                dtype=torch.bool)


class _MinMaxBase(AggregateFunction):
    largest = False

    @property
    def _key(self) -> str:
        return "max" if self.largest else "min"

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def state_schema(self, schema: Schema) -> List:
        return [(self._key, self.data_type(schema)), ("seen", dt.BOOL)]

    def _float_reduce(self, gid, data, valid, num_groups) -> State:
        """Spark float order: NaN is the greatest value. Reduce the
        non-NaN lanes, then reinstate NaN where the order demands it
        (any NaN for max, only NaN for min)."""
        nan_mask = torch.isnan(data)
        if self.largest:
            vals = torch.where(valid & ~nan_mask, data, float("-inf"))
            m = _seg_reduce(vals, gid, num_groups, float("-inf"), "amax")
            any_nan = _seg_sum((valid & nan_mask).to(torch.int32), gid,
                               num_groups) > 0
            out = torch.where(any_nan, float("nan"), m)
        else:
            vals = torch.where(valid & ~nan_mask, data, float("inf"))
            m = _seg_reduce(vals, gid, num_groups, float("inf"), "amin")
            any_num = _seg_sum((valid & ~nan_mask).to(torch.int32), gid,
                               num_groups) > 0
            out = torch.where(any_num, m, float("nan"))
        seen = _seg_sum(valid.to(torch.int32), gid, num_groups) > 0
        return {self._key: out, "seen": seen}

    def _reduce(self, gid, data, valid, num_groups) -> State:
        if data.is_floating_point():
            return self._float_reduce(gid, data, valid, num_groups)
        fill = _phys_extreme(data.dtype, largest=not self.largest)
        vals = torch.where(valid, data, torch.tensor(
            fill, dtype=data.dtype, device=data.device))
        how = "amax" if self.largest else "amin"
        return {self._key: _seg_reduce(vals, gid, num_groups, fill, how),
                "seen": _seg_sum(valid.to(torch.int32), gid, num_groups) > 0}

    def _string_reduce(self, gid, col: StringColumn, num_groups) -> State:
        """Strings, as the JAX package reduces them: a row's rank in a
        stable sort of the column is an order-isomorphic key, so the
        segment min (max) of the ranks picks each group's row, and its
        string is gathered; a group with no value is null."""
        from ..ops.kernels import sort_indices
        cap = col.capacity
        perm = sort_indices([col], [True], [False], col.validity)
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(cap, device=perm.device)
        if self.largest:
            keyed = torch.where(col.validity, rank, -1)
            sel = _seg_reduce(keyed, gid, num_groups, -1, "amax")
            found = sel >= 0
        else:
            keyed = torch.where(col.validity, rank, cap)
            sel = _seg_reduce(keyed, gid, num_groups, cap, "amin")
            found = sel < cap
        out = col.gather(perm[sel.clamp(0, max(cap - 1, 0))], found)
        return {self._key: out, "seen": found}

    def update(self, gid, col, num_groups, live) -> State:
        if isinstance(col, StringColumn):
            return self._string_reduce(gid, col, num_groups)
        return self._reduce(gid, col.data, col.validity, num_groups)

    def merge(self, gid, states, num_groups) -> State:
        if isinstance(states[self._key], StringColumn):
            sc = states[self._key]
            return self._string_reduce(
                gid, with_validity(sc, sc.validity & states["seen"]),
                num_groups)
        return self._reduce(gid, states[self._key], states["seen"],
                            num_groups)

    def finalize(self, states):
        return states[self._key], states["seen"]


class Min(_MinMaxBase):
    name = "min"
    largest = False


class Max(_MinMaxBase):
    name = "max"
    largest = True


class Average(AggregateFunction):
    """avg: double result over a (sum, count) state."""

    name = "avg"

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.FLOAT64

    def state_schema(self, schema: Schema) -> List:
        return [("sum", dt.FLOAT64), ("count", dt.INT64)]

    def update(self, gid, col, num_groups, live) -> State:
        vals = torch.where(col.validity, col.data.to(torch.float64), 0.0)
        return {"sum": _seg_sum(vals, gid, num_groups),
                "count": _seg_sum(col.validity.to(torch.int64), gid,
                                  num_groups)}

    def merge(self, gid, states, num_groups) -> State:
        return {"sum": _seg_sum(states["sum"], gid, num_groups),
                "count": _seg_sum(states["count"], gid, num_groups)}

    def finalize(self, states):
        n = states["count"]
        ok = n > 0
        return states["sum"] / torch.where(ok, n, 1).to(torch.float64), ok


class _M2Base(AggregateFunction):
    """Variance and stddev over (n, avg, m2) states, as the JAX package
    keeps them: the update takes each group's mean, then the sum of
    squared deviations from it; the merge is Chan et al.'s parallel
    combination, so a partial -> final split rounds as the JAX package
    does. A group with n <= ddof is null."""

    ddof = 1

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.FLOAT64

    def state_schema(self, schema: Schema) -> List:
        return [("n", dt.FLOAT64), ("avg", dt.FLOAT64), ("m2", dt.FLOAT64)]

    def update(self, gid, col, num_groups, live) -> State:
        x = torch.where(col.validity, col.data.to(torch.float64), 0.0)
        n = _seg_sum(col.validity.to(torch.float64), gid, num_groups)
        s = _seg_sum(x, gid, num_groups)
        mean = s / torch.where(n > 0, n, 1.0)
        dev = torch.where(col.validity, x - mean[gid], 0.0)
        m2 = _seg_sum(dev * dev, gid, num_groups)
        return {"n": n, "avg": mean, "m2": m2}

    def merge(self, gid, states, num_groups) -> State:
        n, navg, nm2 = states["n"], states["avg"], states["m2"]
        n_tot = _seg_sum(n, gid, num_groups)
        s_tot = _seg_sum(n * navg, gid, num_groups)
        avg_tot = s_tot / torch.where(n_tot > 0, n_tot, 1.0)
        delta = navg - avg_tot[gid]
        m2_tot = _seg_sum(nm2 + n * delta * delta, gid, num_groups)
        return {"n": n_tot, "avg": avg_tot, "m2": m2_tot}

    def _var(self, states: State):
        n = states["n"]
        denom = n - self.ddof
        ok = denom > 0
        return states["m2"] / torch.where(ok, denom, 1.0), ok & (n > 0)

    def finalize(self, states):
        return self._var(states)


class VariancePop(_M2Base):
    name = "var_pop"
    ddof = 0


class VarianceSamp(_M2Base):
    name = "var_samp"
    ddof = 1


class StddevPop(_M2Base):
    name = "stddev_pop"
    ddof = 0

    def finalize(self, states):
        v, ok = self._var(states)
        return torch.sqrt(v), ok


class StddevSamp(_M2Base):
    name = "stddev_samp"
    ddof = 1

    def finalize(self, states):
        v, ok = self._var(states)
        return torch.sqrt(v), ok


def _list_state(gid, col: Column, num_groups: int, eligible
                ) -> ListColumn:
    """A list state from rows whose groups are contiguous and in group
    order: per-group counts of the eligible rows, and those rows
    compacted in their current order as the child."""
    counts = _seg_sum(eligible.to(torch.int64),
                      gid.clamp(0, num_groups - 1), num_groups)
    offsets = torch.zeros(num_groups + 1, dtype=torch.int32,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    idx, n = compaction_indices(eligible)
    child = col.gather(idx, live_mask(col.capacity, n, col.device))
    return ListColumn(offsets, child,
                      torch.ones(num_groups, dtype=torch.bool,
                                 device=counts.device), col.dtype)


def _dedup_sorted(gid, col: Column, eligible):
    """Sort the rows by (group, value) with the ineligible rows last, and
    keep the first of each run of equal values in a group (NULL = NULL,
    NaN = NaN, as the grouping compares): (sorted gid, sorted column,
    kept mask)."""
    from ..ops import kernels as K
    gcol = ColumnVector(gid, eligible, dt.INT64)
    perm = K.sort_indices([gcol, col], [True, True], [True, True],
                          eligible)
    g_s = gid[perm]
    elig_s = eligible[perm]
    col_s = col.gather(perm, elig_s)
    same_group = torch.zeros_like(elig_s)
    same_group[1:] = g_s[1:] == g_s[:-1]
    dup = K._adjacent_equal(col_s) & same_group
    return g_s, col_s, elig_s & ~dup


class CollectList(AggregateFunction):
    """collect_list: a group's non-null values as a list, in row order.
    The sort-path grouping hands update() key-sorted rows, so each
    group's values are contiguous and the state is (cumulative group
    counts, compacted values); the merge relabels offsets the same way,
    as the JAX package does."""

    name = "collect_list"
    needs_sorted_groups = True

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.ArrayType(self.children[0].data_type(schema))

    def state_schema(self, schema: Schema) -> List:
        return [("list", self.data_type(schema))]

    def update(self, gid, col, num_groups, live) -> State:
        # NULLs are dropped (Spark's collect_list / collect_set)
        return {"list": _list_state(gid, col, num_groups,
                                    col.validity & live)}

    def merge(self, gid, states, num_groups) -> State:
        lc = states["list"]
        lens = torch.where(lc.validity, lc.lengths(), 0)
        counts = _seg_sum(lens.to(torch.int64), gid, num_groups)
        offsets = torch.zeros(num_groups + 1, dtype=torch.int32,
                              device=counts.device)
        offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
        # a group's rows are contiguous in merge-sorted order and the
        # gather repacked the child row by row: relabelling the offsets
        # is the concatenation
        return {"list": ListColumn(offsets, lc.child,
                                   torch.ones(num_groups, dtype=torch.bool,
                                              device=counts.device),
                                   lc.dtype.element_type)}

    def finalize(self, states):
        lc = states["list"]
        return lc, torch.ones(lc.capacity, dtype=torch.bool,
                              device=lc.device)


class CollectSet(CollectList):
    """collect_set: collect_list without repeated values, in value order
    (Spark leaves the order undefined); NULLs dropped, NaN = NaN."""

    name = "collect_set"

    def update(self, gid, col, num_groups, live) -> State:
        g_s, col_s, keep = _dedup_sorted(gid, col, col.validity & live)
        return {"list": _list_state(g_s, col_s, num_groups, keep)}

    def merge(self, gid, states, num_groups) -> State:
        merged = super().merge(gid, states, num_groups)["list"]
        # element-level dedup: each element's group, then as in update
        child = merged.child
        pos = torch.arange(child.capacity, device=child.device)
        alive = pos < merged.offsets[num_groups].to(torch.int64)
        egid = torch.searchsorted(merged.offsets[1:].to(torch.int64), pos,
                                  right=True)
        g_s, c_s, keep = _dedup_sorted(egid, child, alive)
        return {"list": _list_state(g_s, c_s, num_groups, keep)}


class First(AggregateFunction):
    """first(x [, ignoreNulls]): the value of each group's first row (its
    first non-null row with ``ignore_nulls``), in input order, as the
    JAX package's; order dependent, as in Spark. The grouping hands
    update() each group's rows in input order and the merge its
    partials in batch order, so the state is the picked value, its
    validity and whether the partial saw an eligible row."""

    name = "first"
    largest = False

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def state_schema(self, schema: Schema) -> List:
        return [("val", self.data_type(schema)), ("valid", dt.BOOL),
                ("found", dt.BOOL)]

    def _pick(self, gid, eligible, num_groups):
        cap = eligible.shape[0]
        idx = torch.arange(cap, device=eligible.device)
        if self.largest:
            sel = _seg_reduce(torch.where(eligible, idx, -1), gid,
                              num_groups, -1, "amax")
            found = sel >= 0
        else:
            sel = _seg_reduce(torch.where(eligible, idx, cap), gid,
                              num_groups, cap, "amin")
            found = sel < cap
        return sel.clamp(0, max(cap - 1, 0)), found

    @staticmethod
    def _take(val, validity, take, found):
        if isinstance(val, torch.Tensor):
            out = val[take]
            return torch.where(found, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
        return val.gather(take, found & validity[take])

    def update(self, gid, col, num_groups, live) -> State:
        eligible = live & col.validity if self.ignore_nulls else live
        take, found = self._pick(gid, eligible, num_groups)
        data = col.data if isinstance(col, ColumnVector) else col
        return {"val": self._take(data, col.validity, take, found),
                "valid": col.validity[take] & found, "found": found}

    def merge(self, gid, states, num_groups) -> State:
        take, found = self._pick(gid, states["found"], num_groups)
        return {"val": self._take(states["val"], states["valid"], take,
                                  found),
                "valid": states["valid"][take] & found, "found": found}

    def finalize(self, states):
        return states["val"], states["valid"] & states["found"]


class Last(First):
    """last(x [, ignoreNulls]): each group's last row's value."""

    name = "last"
    largest = True
