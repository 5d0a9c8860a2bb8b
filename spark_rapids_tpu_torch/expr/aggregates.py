"""Aggregate functions: update / merge / finalize over segment ids.

Counterpart of spark_rapids_tpu/expr/aggregates.py (Sum, Average,
Count, CountStar, Min, Max on non-decimal inputs). Every aggregate
splits into an update phase (raw rows -> per-group partial state), a
merge phase (partial states -> merged state) and finalize; states are
dicts of tensors sized to the group table, so partials flow as batches.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import Column
from .core import Expression, Schema

State = Dict[str, torch.Tensor]


def _seg_sum(values, gid, num_groups, dtype=None):
    out = torch.zeros(num_groups, dtype=dtype or values.dtype,
                      device=values.device)
    return out.index_add_(0, gid, values.to(out.dtype))


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

    def update(self, gid, col, num_groups, live) -> State:
        return self._reduce(gid, col.data, col.validity, num_groups)

    def merge(self, gid, states, num_groups) -> State:
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
