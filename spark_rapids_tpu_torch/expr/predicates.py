"""Predicates and comparisons.

Counterpart of spark_rapids_tpu/expr/predicates.py for non-string,
non-decimal operands: NaN compares greater than everything and equal to
itself (Spark ordering); And/Or use Kleene three-valued logic.
"""

from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Schema, literal_physical, make_result, \
    merged_validity


def _aligned(left: ColumnVector, right: ColumnVector):
    """Physical lanes made directly comparable (numeric promotion when
    the physical dtypes differ)."""
    a, b = left.data, right.data
    if a.dtype != b.dtype:
        out_t = dt.promote(left.dtype, right.dtype)
        a, b = a.to(out_t.physical), b.to(out_t.physical)
    return a, b


def _nan_safe_lt(a, b):
    """a < b with NaN greatest (Spark ordering)."""
    if a.is_floating_point():
        return torch.where(torch.isnan(a), False,
                           torch.where(torch.isnan(b), True, a < b))
    return a < b


def _nan_safe_eq(a, b):
    if a.is_floating_point():
        return (torch.isnan(a) & torch.isnan(b)) | (a == b)
    return a == b


class BinaryComparison(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        if isinstance(left, StringColumn) or isinstance(right, StringColumn):
            raise TypeError("string comparison is not in this port yet")
        a, b = _aligned(left, right)
        return make_result(self._compare(a, b), merged_validity(left, right),
                           dt.BOOL)

    def _compare(self, a, b):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    def _compare(self, a, b):
        return _nan_safe_eq(a, b)


class LessThan(BinaryComparison):
    def _compare(self, a, b):
        return _nan_safe_lt(a, b)


class GreaterThan(BinaryComparison):
    def _compare(self, a, b):
        return _nan_safe_lt(b, a)


class LessThanOrEqual(BinaryComparison):
    def _compare(self, a, b):
        return ~_nan_safe_lt(b, a)


class GreaterThanOrEqual(BinaryComparison):
    def _compare(self, a, b):
        return ~_nan_safe_lt(a, b)


class EqualNullSafe(Expression):
    """<=>: nulls compare equal; never null."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        both_null = ~left.validity & ~right.validity
        both_valid = left.validity & right.validity
        a, b = _aligned(left, right)
        data = both_null | (both_valid & _nan_safe_eq(a, b))
        return make_result(data, batch.live_mask(), dt.BOOL)


class And(Expression):
    """Kleene AND: false & null = false; true & null = null."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        l = self.children[0].eval(batch)
        r = self.children[1].eval(batch)
        lv, rv = l.validity, r.validity
        known_false = (lv & ~l.data) | (rv & ~r.data)
        validity = (lv & rv) | known_false
        return make_result(l.data & r.data & ~known_false, validity, dt.BOOL)


class Or(Expression):
    """Kleene OR: true | null = true; false | null = null."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        l = self.children[0].eval(batch)
        r = self.children[1].eval(batch)
        lv, rv = l.validity, r.validity
        known_true = (lv & l.data) | (rv & r.data)
        validity = (lv & rv) | known_true
        return make_result(known_true | (l.data | r.data), validity, dt.BOOL)


class Not(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(~c.data, c.validity, dt.BOOL)


class IsNull(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        live = batch.live_mask()
        return make_result(~c.validity & live, live, dt.BOOL)


class IsNotNull(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(c.validity, batch.live_mask(), dt.BOOL)


class IsNaN(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(torch.isnan(c.data), c.validity, dt.BOOL)


class InSet(Expression):
    """expr IN (literal set) over a numeric column."""

    def __init__(self, child: Expression, values: List):
        super().__init__(child)
        self.values = values

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if isinstance(c, StringColumn):
            raise TypeError("string IN is not in this port yet")
        hit = torch.zeros(batch.capacity, dtype=torch.bool,
                          device=batch.device)
        for v in self.values:
            if v is not None:
                hit = hit | (c.data == torch.tensor(
                    literal_physical(v, c.dtype), dtype=c.data.dtype,
                    device=batch.device))
        return make_result(hit, c.validity, dt.BOOL)
