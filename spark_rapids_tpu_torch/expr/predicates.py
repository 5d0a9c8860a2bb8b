"""Predicates and comparisons.

Counterpart of spark_rapids_tpu/expr/predicates.py for non-decimal
operands: NaN compares greater than everything and equal to itself
(Spark ordering); And/Or use Kleene three-valued logic. Strings support
``=`` and ``IN`` (byte equality over offsets/chars, expr/strings.py);
string ordering comparisons are not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from . import strings as S
from .core import (Expression, Literal, Schema, literal_physical,
                   make_result, merged_validity)


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
        string_lit = self._string_literal_side()
        if string_lit is not None:
            # col = 'lit': compare bytes in place, no literal column
            c = self.children[1 - string_lit].eval(batch)
            raw = S.utf8(self.children[string_lit].value)
            return make_result(S.match_literal(c, raw), c.validity, dt.BOOL)
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        if isinstance(left, StringColumn) or isinstance(right, StringColumn):
            if not (isinstance(self, EqualTo)
                    and isinstance(left, StringColumn)
                    and isinstance(right, StringColumn)):
                raise TypeError(f"string {type(self).__name__} is not in "
                                "this port yet")
            return make_result(S.string_eq(left, right),
                               merged_validity(left, right), dt.BOOL)
        a, b = _aligned(left, right)
        return make_result(self._compare(a, b), merged_validity(left, right),
                           dt.BOOL)

    def _string_literal_side(self):
        """Index of a non-null string literal child of an EqualTo whose
        other child is not a literal, else None."""
        if not isinstance(self, EqualTo):
            return None
        for i, e in enumerate(self.children):
            other = self.children[1 - i]
            if isinstance(e, Literal) and isinstance(e.value, str) and \
                    not isinstance(other, Literal):
                return i
        return None

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
    """expr IN (literal set); null entries of the set match nothing."""

    def __init__(self, child: Expression, values: List):
        super().__init__(child)
        self.values = values

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        hit = torch.zeros(batch.capacity, dtype=torch.bool,
                          device=batch.device)
        if isinstance(c, StringColumn):
            for v in self.values:
                if v is not None:
                    hit = hit | S.match_literal(c, S.utf8(v))
            return make_result(hit, c.validity, dt.BOOL)
        for v in self.values:
            if v is not None:
                hit = hit | (c.data == torch.tensor(
                    literal_physical(v, c.dtype), dtype=c.data.dtype,
                    device=batch.device))
        return make_result(hit, c.validity, dt.BOOL)
