"""Arithmetic expressions with Spark semantics (non-ANSI).

Counterpart of spark_rapids_tpu/expr/arithmetic.py for the non-decimal
types: + - * follow numeric promotion, Divide always returns double and
x / 0 is null, Abs keeps its input's type, a null input gives a null
result. ``div``, ``%`` and ``pmod`` take Java's truncating division
(x div 0, x % 0 and pmod(x, 0) are null); ``least`` / ``greatest`` skip
NULLs and order NaN above every number.

``pmod`` follows Spark's ``Pmod``: r = a % n, and (r + n) % n where r is
negative, so a negative divisor gives a result of its sign
(``pmod(-7, -3)`` is -1); the JAX package adds |n| and gives 2
(ROADMAP.md C13).
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result, merged_validity


class BinaryArithmetic(Expression):
    op_name = "?"

    def _result_type(self, lt: dt.DType, rt: dt.DType) -> dt.DType:
        return dt.promote(lt, rt)

    def data_type(self, schema: Schema) -> dt.DType:
        return self._result_type(self.children[0].data_type(schema),
                                 self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        out_t = self._result_type(left.dtype, right.dtype)
        a = left.data.to(out_t.physical)
        b = right.data.to(out_t.physical)
        data, validity = self._compute(a, b, merged_validity(left, right))
        return make_result(data, validity, out_t)

    def _compute(self, a, b, validity):
        raise NotImplementedError


class Add(BinaryArithmetic):
    op_name = "+"

    def _compute(self, a, b, validity):
        return a + b, validity


class Subtract(BinaryArithmetic):
    op_name = "-"

    def _compute(self, a, b, validity):
        return a - b, validity


class Multiply(BinaryArithmetic):
    op_name = "*"

    def _compute(self, a, b, validity):
        return a * b, validity


class Divide(BinaryArithmetic):
    """Spark Divide on non-decimals: the result is double; x / 0 is
    null."""

    op_name = "/"

    def _result_type(self, lt, rt):
        return dt.FLOAT64

    def _compute(self, a, b, validity):
        nonzero = b != 0.0
        one = torch.ones((), dtype=b.dtype, device=b.device)
        data = torch.where(nonzero, a / torch.where(nonzero, b, one),
                           torch.zeros((), dtype=a.dtype, device=a.device))
        return data, validity & nonzero


class UnaryMinus(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(-c.data, c.validity, c.dtype)


class Abs(Expression):
    """abs(x): the input's type; a null input gives null. Non-ANSI, as
    the JAX package's default: abs of an integral minimum wraps to
    itself."""

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(torch.abs(c.data), c.validity, c.dtype)


def _safe_divisor(b: torch.Tensor) -> torch.Tensor:
    """``b`` with 0 and -1 replaced by 1: the integer quotient and
    remainder by -1 are taken apart (MIN / -1 traps in a CPU's integer
    division), and by 0 the row is null."""
    bad = (b == 0) | (b == -1)
    return torch.where(bad, torch.ones((), dtype=b.dtype, device=b.device),
                       b)


def trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java's integer a / b (toward zero; MIN / -1 wraps to MIN) for
    b != 0."""
    q = torch.div(a, _safe_divisor(b), rounding_mode="trunc")
    return torch.where(b == -1, -a, q)


def trunc_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java's a % b: the sign of ``a`` (integers, and floats as fmod)
    for b != 0."""
    if a.is_floating_point():
        return torch.fmod(a, torch.where(b == 0, torch.ones(
            (), dtype=b.dtype, device=b.device), b))
    r = torch.fmod(a, _safe_divisor(b))
    return torch.where(b == -1, torch.zeros((), dtype=a.dtype,
                                            device=a.device), r)


class IntegralDivide(BinaryArithmetic):
    """``a div b``: bigint. Floating operands are cast to BIGINT first
    (Spark's input type is LongType), integral ones widen to it, so
    ``INT_MIN div -1`` is 2^31; x div 0 is null."""

    op_name = "div"

    def _result_type(self, lt, rt):
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .cast import cast_column
        left = cast_column(self.children[0].eval(batch), dt.INT64)
        right = cast_column(self.children[1].eval(batch), dt.INT64)
        validity = merged_validity(left, right) & (right.data != 0)
        return make_result(trunc_div(left.data, right.data), validity,
                           dt.INT64)


class Remainder(BinaryArithmetic):
    """``a % b`` with Java's sign (that of ``a``); x % 0 is null."""

    op_name = "%"

    def _compute(self, a, b, validity):
        return trunc_mod(a, b), validity & (b != 0)


class Pmod(BinaryArithmetic):
    """pmod(a, n): Spark's r = a % n, then (r + n) % n where r < 0."""

    op_name = "pmod"

    def _compute(self, a, b, validity):
        r = trunc_mod(a, b)
        r = torch.where(r < 0, trunc_mod(r + b, b), r)
        return r, validity & (b != 0)


class UnaryPositive(Expression):
    """+x: the child itself."""

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        return self.children[0].eval(batch)


class _LeastGreatestBase(Expression):
    largest = False

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        for c in self.children[1:]:
            t = dt.promote(t, c.data_type(schema))
        return t

    def eval(self, batch: ColumnarBatch):
        cols = [c.eval(batch) for c in self.children]
        if any(isinstance(c, StringColumn) for c in cols):
            return self._strings(cols)
        out_t = cols[0].dtype
        for c in cols[1:]:
            out_t = dt.promote(out_t, c.dtype)
        return minmax_columns(cols, out_t, self.largest)

    def _strings(self, cols):
        """Strings: a null-skipping fold over string order."""
        from .conditional import _select_strings
        from .strings import string_compare
        acc = cols[0]
        for c in cols[1:]:
            cmp = string_compare(c, acc)
            better = cmp > 0 if self.largest else cmp < 0
            take = ~acc.validity | (c.validity & better)
            acc = _select_strings(take, c, acc)
        return acc


def minmax_columns(cols, out_t: dt.DType, largest: bool) -> ColumnVector:
    """The row-wise greatest (``largest``) or least valid value of
    numeric ``cols`` as ``out_t``; null where every input is. Floats
    order NaN above every number: greatest is NaN where any valid value
    is, least only where every valid value is."""
    phys = out_t.physical
    dev = cols[0].data.device
    cap = cols[0].capacity
    fill = dt.min_value(out_t) if largest else dt.max_value(out_t)
    data = torch.full((cap,), fill, dtype=phys, device=dev)
    any_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    red = torch.maximum if largest else torch.minimum
    if out_t.is_floating:
        nan_seen = torch.zeros_like(any_valid)
        num_seen = torch.zeros_like(any_valid)
        for c in cols:
            x = c.data.to(phys)
            nan = torch.isnan(x)
            data = red(data, torch.where(c.validity & ~nan, x, fill))
            nan_seen = nan_seen | (c.validity & nan)
            num_seen = num_seen | (c.validity & ~nan)
            any_valid = any_valid | c.validity
        nan_v = torch.full((), float("nan"), dtype=phys, device=dev)
        data = torch.where(nan_seen, nan_v, data) if largest else \
            torch.where(num_seen, data, nan_v)
        return make_result(data, any_valid, out_t)
    for c in cols:
        data = red(data, torch.where(c.validity, c.data.to(phys),
                                     torch.full((), fill, dtype=phys,
                                                device=dev)))
        any_valid = any_valid | c.validity
    return make_result(data, any_valid, out_t)


class Least(_LeastGreatestBase):
    """least(...): the null-skipping minimum across columns."""

    largest = False


class Greatest(_LeastGreatestBase):
    """greatest(...): the null-skipping maximum across columns."""

    largest = True
