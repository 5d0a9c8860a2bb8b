"""Predicates and comparisons.

Counterpart of spark_rapids_tpu/expr/predicates.py: NaN compares greater
than everything and equal to itself (Spark ordering); And/Or use Kleene
three-valued logic. Decimals compare by value across scales and widths
(``decimal_compare``: two limbs at the common scale; against a float as
doubles), in ``<=>`` and IN too, where the JAX package compares the
unscaled lanes of differing scales as they are (ROADMAP.md C15). Strings compare
over their offsets and chars (expr/strings.py): unsigned bytes, then the
shorter string first, so 'a' < 'a\\0' as in Spark (the JAX package pads
with zero bytes and finds them equal; ROADMAP.md C13).
"""

from __future__ import annotations

from typing import List

import torch

from ..columnar import decimal128 as d128
from ..columnar import dtypes as dt
from ..columnar.decimal128 import Decimal128Column
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


def _as_f64(c) -> torch.Tensor:
    if dt.is_decimal(c.dtype):
        hi, lo = d128.limbs_of(c)
        return d128.d128_to_f64(hi, lo) / (10.0 ** c.dtype.scale)
    return c.data.to(torch.float64)


def decimal_compare(left, right):
    """(lt, eq) of two numeric columns of which one is a decimal: as
    doubles against a float, else exactly at the common scale. The
    upscaled side (the one of smaller scale) is the only one that can
    pass 128 bits, and then it lies beyond the other: its sign
    decides."""
    if left.dtype.is_floating or right.dtype.is_floating:
        a, b = _as_f64(left), _as_f64(right)
        return _nan_safe_lt(a, b), _nan_safe_eq(a, b)

    def scale(c):
        return c.dtype.scale if dt.is_decimal(c.dtype) else 0

    s = max(scale(left), scale(right))
    narrow = all(not isinstance(c, Decimal128Column) and (
        not dt.is_decimal(c.dtype) or
        c.dtype.precision + s - scale(c) <= 18) for c in (left, right))
    if narrow and all(dt.is_decimal(c.dtype) or c.dtype.is_integral
                      and s == 0 for c in (left, right)):
        a = left.data.to(torch.int64) * 10 ** (s - scale(left))
        b = right.data.to(torch.int64) * 10 ** (s - scale(right))
        return a < b, a == b

    def lift(c):
        hi, lo = d128.limbs_of(c) if dt.is_decimal(c.dtype) else \
            d128.d128_from_i64(c.data)
        h, l, ovf = d128.d128_mul_pow10(hi, lo, s - scale(c))
        return h, l, ovf, hi < 0

    ah, al, ao, an = lift(left)
    bh, bl, bo, bn = lift(right)
    lt = torch.where(ao, an, torch.where(bo, ~bn,
                                         d128.d128_lt(ah, al, bh, bl)))
    eq = ~ao & ~bo & d128.d128_eq(ah, al, bh, bl)
    return lt, eq


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
            # col <op> 'lit': compare bytes in place, no literal column
            c = self.children[1 - string_lit].eval(batch)
            raw = S.utf8(self.children[string_lit].value)
            if isinstance(self, EqualTo):
                hit = S.match_literal(c, raw)
            else:
                cmp = S.compare_literal(c, raw)
                hit = self._from_cmp(cmp if string_lit == 1 else -cmp)
            return make_result(hit, c.validity, dt.BOOL)
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        if isinstance(left, StringColumn) or isinstance(right, StringColumn):
            if not (isinstance(left, StringColumn)
                    and isinstance(right, StringColumn)):
                raise TypeError(f"{type(self).__name__} of a string and a "
                                "non-string")
            hit = S.string_eq(left, right) if isinstance(self, EqualTo) \
                else self._from_cmp(S.string_compare(left, right))
            return make_result(hit, merged_validity(left, right), dt.BOOL)
        if dt.is_decimal(left.dtype) or dt.is_decimal(right.dtype):
            lt, eq = decimal_compare(left, right)
            cmp = lt.to(torch.int8) * -1 + (~lt & ~eq).to(torch.int8)
            return make_result(self._from_cmp(cmp),
                               merged_validity(left, right), dt.BOOL)
        a, b = _aligned(left, right)
        return make_result(self._compare(a, b), merged_validity(left, right),
                           dt.BOOL)

    def _from_cmp(self, cmp: torch.Tensor) -> torch.Tensor:
        """The comparison's answer from -1 / 0 / 1 per row."""
        return self._compare(cmp, torch.zeros((), dtype=cmp.dtype,
                                              device=cmp.device))

    def _string_literal_side(self):
        """Index of a non-null string literal child whose other child is
        not a literal, else None."""
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
        if dt.is_decimal(left.dtype) or dt.is_decimal(right.dtype):
            eq = decimal_compare(left, right)[1]
        elif isinstance(left, StringColumn):
            eq = S.string_eq(left, right)
        else:
            eq = _nan_safe_eq(*_aligned(left, right))
        data = both_null | (both_valid & eq)
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
        if dt.is_decimal(c.dtype):
            # each value by value (Spark's coercion of the IN list)
            for v in self.values:
                if v is not None:
                    hit = hit | decimal_compare(c, Literal(v).eval(batch))[1]
            return make_result(hit, c.validity, dt.BOOL)
        for v in self.values:
            if v is not None:
                hit = hit | (c.data == torch.tensor(
                    literal_physical(v, c.dtype), dtype=c.data.dtype,
                    device=batch.device))
        return make_result(hit, c.validity, dt.BOOL)
