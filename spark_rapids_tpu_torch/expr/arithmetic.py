"""Arithmetic expressions with Spark semantics.

Counterpart of spark_rapids_tpu/expr/arithmetic.py: + - * follow numeric
promotion, Divide returns double on non-decimals and x / 0 is null, Abs
keeps its input's type, a null input gives a null result.

Decimals take Spark's DecimalPrecision result types
(dtypes.decimal_result_type) and its implicit coercion
(``decimal_coerced_children``): an integral column goes to its exact
decimal, an integral literal to the tight DECIMAL(digits, 0), and a
float makes the decimal side DOUBLE. Where both operands are
long-backed and the result is too, the int64 lane is exact; otherwise
the operands go to two limbs (columnar/decimal128.py), * and / through
Spark-exact 256-bit intermediates, and a result past its precision is
NULL (non-ANSI). ``div``, ``%`` and ``pmod`` run on long-backed
decimals; on a wide one, as ``least`` / ``greatest``, they run on the
CPU engine (their rules' type signatures send them there, as in the JAX
planner). ``div``, ``%`` and ``pmod`` take Java's truncating division
(x div 0, x % 0 and pmod(x, 0) are null); ``least`` / ``greatest`` skip
NULLs and order NaN above every number.

Under ANSI mode (``ansi=True``, set by expr/ansi.py's plan rewrite)
the lanes that give NULL or wrap raise instead: integral overflow of +,
-, *, unary minus and abs (Math.addExact and its kin), a zero divisor of
/, div, % and pmod, and a decimal result past its precision; each
guard reads only the rows that reach the node.

``pmod`` follows Spark's ``Pmod``: r = a % n, and (r + n) % n where r is
negative, so a negative divisor gives a result of its sign
(``pmod(-7, -3)`` is -1); the JAX package adds |n| and gives 2
(ROADMAP.md C13).
"""

from __future__ import annotations

import torch

from ..columnar import decimal128 as d128
from ..columnar import dtypes as dt
from ..columnar.decimal128 import Decimal128Column
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from . import errors as ERR
from .ansi import guard
from .core import (Expression, Literal, Schema, cpu_fallback, make_result,
                   merged_validity)


def _is_narrow_fast(left, right, out_t: dt.DecimalType) -> bool:
    """Both operands and the result long-backed: the int64 lane is exact
    (the result's precision covers the carry or the product)."""
    return not isinstance(left, Decimal128Column) and \
        not isinstance(right, Decimal128Column) and not out_t.is_wide


def _lift_rescaled(col, to_scale: int):
    """(hi, lo, overflow) of a decimal column at ``to_scale``; a scale cut
    (the result scale trimmed below an operand's) rounds HALF_UP, as the
    cast Spark inserts to the result type."""
    hi, lo = d128.limbs_of(col)
    k = to_scale - col.dtype.scale
    if k >= 0:
        return d128.d128_mul_pow10(hi, lo, k)
    hi, lo = d128.d128_div_pow10_half_up(hi, lo, -k)
    return hi, lo, torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)


def _finish_decimal(hi, lo, validity, ok, out_t: dt.DecimalType):
    """Overflow -> NULL (non-ANSI Spark) and the precision bound."""
    ok = ok & d128.d128_fits_precision(hi, lo, out_t.precision)
    return d128.build_decimal_column(hi, lo, validity & ok, out_t)


def _rescale(data: torch.Tensor, from_scale: int, to_scale: int):
    if to_scale > from_scale:
        return data * 10 ** (to_scale - from_scale)
    if to_scale < from_scale:
        return torch.div(data, 10 ** (from_scale - to_scale),
                         rounding_mode="floor")
    return data


#: Spark's exact decimal of each integral type (DecimalType.forType):
#: the implicit coercion target of integral-op-decimal arithmetic
_INTEGRAL_DECIMAL = {dt.INT8: 3, dt.INT16: 5, dt.INT32: 10, dt.INT64: 20}


def decimal_coerced_children(expr: Expression, schema: Schema):
    """Spark's DecimalPrecision coercion of a mixed decimal / non-decimal
    binary op: an integral side casts to its exact decimal (a literal to
    the tight DECIMAL(digits, 0), Spark's DecimalType.fromLiteral), and
    against a float or double the decimal side casts to DOUBLE."""
    left, right = expr.children[0], expr.children[1]
    lt, rt = left.data_type(schema), right.data_type(schema)
    ldec, rdec = dt.is_decimal(lt), dt.is_decimal(rt)
    if ldec == rdec:
        return left, right
    from .cast import Cast
    other = right if ldec else left
    other_t = rt if ldec else lt
    if other_t in _INTEGRAL_DECIMAL:
        if isinstance(other, Literal) and other.value is not None:
            target = dt.DecimalType(max(1, len(str(abs(int(other.value))))),
                                    0)
        else:
            target = dt.DecimalType(_INTEGRAL_DECIMAL[other_t], 0)
        wrapped = Cast(other, target)
        return (left, wrapped) if ldec else (wrapped, right)
    if other_t.is_floating:
        return (Cast(left, dt.FLOAT64), right) if ldec else \
            (left, Cast(right, dt.FLOAT64))
    if other_t == dt.NULL:
        wrapped = Cast(other, rt if rdec else lt)
        return (left, wrapped) if ldec else (wrapped, right)
    raise TypeError(f"decimal {expr.op_name} {other_t}: no implicit "
                    "coercion (Spark coerces integral and floating operands "
                    "only)")


def _overflow_guard(ovf, validity, out_t, batch) -> None:
    guard(ovf & validity, ERR.SparkArithmeticException(
        ERR.overflow_message(str(out_t))), batch)


def _decimal_guard(op_name, validity, res, batch) -> None:
    """ANSI: a decimal row the op made null (past the precision, or a
    zero divisor) raises."""
    guard(validity & ~res.validity, ERR.SparkArithmeticException(
        f"{op_name}: decimal overflow or division by zero (ANSI mode)"),
        batch)


class BinaryArithmetic(Expression):
    op_name = "?"
    #: the decimal op's name in dtypes.decimal_result_type
    decimal_op = None
    #: ANSI mode (expr/ansi.py): the guards below raise
    ansi = False

    def coerced_children(self, schema: Schema):
        """The children the op computes on, after implicit coercion."""
        return decimal_coerced_children(self, schema)

    def _result_type(self, lt: dt.DType, rt: dt.DType) -> dt.DType:
        return dt.promote(lt, rt)

    def _out_type(self, lt: dt.DType, rt: dt.DType) -> dt.DType:
        if dt.is_decimal(lt) and dt.is_decimal(rt):
            if self.decimal_op is None:
                raise TypeError(f"{self.op_name} does not take decimals")
            return dt.decimal_result_type(self.decimal_op, lt, rt)
        return self._result_type(lt, rt)

    def data_type(self, schema: Schema) -> dt.DType:
        left, right = self.coerced_children(schema)
        return self._out_type(left.data_type(schema),
                              right.data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc, rc = self.coerced_children(batch.schema())
        left, right = lc.eval(batch), rc.eval(batch)
        out_t = self._out_type(left.dtype, right.dtype)
        validity = merged_validity(left, right)
        if dt.is_decimal(left.dtype):
            res = self._eval_decimal(left, right, out_t, validity)
            if self.ansi:
                _decimal_guard(self.op_name, validity, res, batch)
            return res
        a = left.data.to(out_t.physical)
        b = right.data.to(out_t.physical)
        data, validity2 = self._compute(a, b, validity)
        if self.ansi:
            self._ansi_post(a, b, data, validity, validity2, out_t, batch)
        return make_result(data, validity2, out_t)

    def _compute(self, a, b, validity):
        raise NotImplementedError

    def _ansi_post(self, a, b, data, validity, validity2, out_t, batch):
        """ANSI: a null the op brought in (x / 0, x % 0) raises."""
        guard(validity & ~validity2,
              ERR.SparkArithmeticException(ERR.DIVIDE_BY_ZERO), batch)

    def _eval_decimal(self, left, right, out_t, validity):
        raise TypeError(f"{self.op_name} does not take decimals")


class _AddSubBase(BinaryArithmetic):
    _sub = False

    def _eval_decimal(self, left, right, out_t, validity):
        if _is_narrow_fast(left, right, out_t):
            a = _rescale(left.data, left.dtype.scale, out_t.scale)
            b = _rescale(right.data, right.dtype.scale, out_t.scale)
            return make_result(a - b if self._sub else a + b, validity,
                               out_t)
        ah, al, o1 = _lift_rescaled(left, out_t.scale)
        bh, bl, o2 = _lift_rescaled(right, out_t.scale)
        op = d128.d128_sub if self._sub else d128.d128_add
        rh, rl = op(ah, al, bh, bl)
        # a 128-bit wrap of the sum itself lands outside the precision
        # bound (|a|, |b| < 10^38), so the bound check catches it
        return _finish_decimal(rh, rl, validity, ~(o1 | o2), out_t)


class Add(_AddSubBase):
    op_name = "+"
    decimal_op = "add"

    def _compute(self, a, b, validity):
        return a + b, validity

    def _ansi_post(self, a, b, data, validity, validity2, out_t, batch):
        if out_t.is_integral:
            # Math.addExact: operands of one sign, a result of the other
            _overflow_guard(((a >= 0) == (b >= 0)) & ((data >= 0) != (a >= 0)),
                            validity, out_t, batch)


class Subtract(_AddSubBase):
    op_name = "-"
    decimal_op = "sub"
    _sub = True

    def _compute(self, a, b, validity):
        return a - b, validity

    def _ansi_post(self, a, b, data, validity, validity2, out_t, batch):
        if out_t.is_integral:
            # Math.subtractExact: operands of differing signs, a result
            # whose sign is not a's
            _overflow_guard(((a >= 0) != (b >= 0)) & ((data >= 0) != (a >= 0)),
                            validity, out_t, batch)


class Multiply(BinaryArithmetic):
    op_name = "*"
    decimal_op = "mul"

    def _compute(self, a, b, validity):
        return a * b, validity

    def _ansi_post(self, a, b, data, validity, validity2, out_t, batch):
        if out_t.is_integral:
            # Math.multiplyExact: a wrapped product fails the division
            # round trip; MIN * -1 wraps to MIN and is checked apart
            lo = dt.min_value(out_t)
            ovf = (b != 0) & (trunc_div(data, b) != a)
            ovf = ovf | ((a == lo) & (b == -1)) | ((b == lo) & (a == -1))
            _overflow_guard(ovf, validity, out_t, batch)

    def _eval_decimal(self, left, right, out_t, validity):
        raw_scale = left.dtype.scale + right.dtype.scale
        if _is_narrow_fast(left, right, out_t) and raw_scale == out_t.scale:
            # p1 + p2 + 1 <= 18: the int64 product cannot overflow
            return make_result(left.data * right.data, validity, out_t)
        ah, al = d128.limbs_of(left)
        bh, bl = d128.limbs_of(right)
        rh, rl, ovf = d128.d128_mul_exact(ah, al, bh, bl,
                                          raw_scale - out_t.scale)
        return _finish_decimal(rh, rl, validity, ~ovf, out_t)


class Divide(BinaryArithmetic):
    """Spark Divide: double on non-decimals; decimal / decimal is exact,
    HALF_UP at the result scale. x / 0 is null."""

    op_name = "/"
    decimal_op = "div"

    def _result_type(self, lt, rt):
        return dt.FLOAT64

    def _eval_decimal(self, left, right, out_t, validity):
        ah, al = d128.limbs_of(left)
        bh, bl = d128.limbs_of(right)
        nonzero = (bh != 0) | (bl != 0)
        safe_bl = torch.where(nonzero, bl, torch.ones_like(bl))
        up = out_t.scale - left.dtype.scale + right.dtype.scale
        rh, rl, ovf = d128.d128_div_exact(ah, al, bh, safe_bl, up)
        return _finish_decimal(rh, rl, validity & nonzero, ~ovf, out_t)

    def _compute(self, a, b, validity):
        nonzero = b != 0.0
        one = torch.ones((), dtype=b.dtype, device=b.device)
        data = torch.where(nonzero, a / torch.where(nonzero, b, one),
                           torch.zeros((), dtype=a.dtype, device=a.device))
        return data, validity & nonzero


def _min_guard(c, batch) -> None:
    """ANSI: -x and abs(x) of an integral minimum overflow."""
    if c.dtype.is_integral:
        _overflow_guard(c.data == dt.min_value(c.dtype), c.validity,
                        c.dtype, batch)


class UnaryMinus(Expression):
    ansi = False

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if isinstance(c, Decimal128Column):
            nh, nl = d128.d128_neg(c.hi, c.lo)
            return d128.build_decimal_column(nh, nl, c.validity, c.dtype)
        if self.ansi:
            _min_guard(c, batch)
        return make_result(-c.data, c.validity, c.dtype)


class Abs(Expression):
    """abs(x): the input's type; a null input gives null. Outside ANSI
    mode, as the JAX package's default, abs of an integral minimum wraps
    to itself; under it, it raises."""

    ansi = False

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if isinstance(c, Decimal128Column):
            ah, al = d128.d128_abs(c.hi, c.lo)
            return d128.build_decimal_column(ah, al, c.validity, c.dtype)
        if self.ansi:
            _min_guard(c, batch)
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


def _decimal_divmod_aligned(op_name: str, left, right, validity):
    """Common-scale truncating 128-bit divmod of long-backed decimal
    operands (the alignment cannot overflow: |v| < 10^18 * 10^18 <
    2^127): (qh, ql, rh, rl, bh, bl, validity & divisor != 0, scale).
    A wide operand runs on the CPU engine (the rule's type signature)."""
    if isinstance(left, Decimal128Column) or \
            isinstance(right, Decimal128Column):
        raise cpu_fallback(f"{op_name} on a DECIMAL(p>18)",
                           "type signature of div / % / pmod")
    s = max(left.dtype.scale, right.dtype.scale)
    ah, al, _ = _lift_rescaled(left, s)
    bh, bl, _ = _lift_rescaled(right, s)
    nonzero = (bh != 0) | (bl != 0)
    safe_bl = torch.where(nonzero, bl, torch.ones_like(bl))
    qh, ql, rh, rl = d128.d128_div_trunc(ah, al, bh, safe_bl)
    return qh, ql, rh, rl, bh, safe_bl, validity & nonzero, s


class IntegralDivide(BinaryArithmetic):
    """``a div b``: bigint. Floating operands are cast to BIGINT first
    (Spark's input type is LongType), integral ones widen to it, so
    ``INT_MIN div -1`` is 2^31; x div 0 is null. Decimals divide at a
    common scale, truncating; a quotient past BIGINT is null."""

    op_name = "div"
    decimal_op = "div"

    def _result_type(self, lt, rt):
        return dt.INT64

    def _out_type(self, lt, rt):
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .cast import cast_column
        lc, rc = self.coerced_children(batch.schema())
        left, right = lc.eval(batch), rc.eval(batch)
        base = merged_validity(left, right)
        if dt.is_decimal(left.dtype) and dt.is_decimal(right.dtype):
            qh, ql, _, _, _, _, validity, _ = _decimal_divmod_aligned(
                self.op_name, left, right, base)
            validity = validity & (qh == (ql >> 63))
            if self.ansi:
                guard(base & ~validity, ERR.SparkArithmeticException(
                    "div: division by zero or overflow (ANSI mode)"), batch)
            return make_result(ql, validity, dt.INT64)
        left = cast_column(left, dt.INT64)
        right = cast_column(right, dt.INT64)
        a, b = left.data, right.data
        if self.ansi:
            guard(base & (b == 0),
                  ERR.SparkArithmeticException(ERR.DIVIDE_BY_ZERO), batch)
            _overflow_guard((a == dt.min_value(dt.INT64)) & (b == -1), base,
                            dt.INT64, batch)
        return make_result(trunc_div(a, b), base & (b != 0), dt.INT64)


class Remainder(BinaryArithmetic):
    """``a % b`` with Java's sign (that of ``a``); x % 0 is null."""

    op_name = "%"
    decimal_op = "mod"

    def _compute(self, a, b, validity):
        return trunc_mod(a, b), validity & (b != 0)

    def _remainder(self, rh, rl, bh, bl):
        return rh, rl

    def _eval_decimal(self, left, right, out_t, validity):
        _, _, rh, rl, bh, bl, validity, s = _decimal_divmod_aligned(
            self.op_name, left, right, validity)
        rh, rl = self._remainder(rh, rl, bh, bl)
        if out_t.scale != s:   # the result scale was trimmed
            rh, rl = d128.d128_div_pow10_half_up(rh, rl, s - out_t.scale)
        return _finish_decimal(rh, rl, validity,
                               torch.ones_like(validity), out_t)


class Pmod(Remainder):
    """pmod(a, n): Spark's r = a % n, then (r + n) % n where r < 0 (for
    n < 0 that is r itself, ROADMAP.md C13)."""

    op_name = "pmod"

    def _compute(self, a, b, validity):
        r = trunc_mod(a, b)
        r = torch.where(r < 0, trunc_mod(r + b, b), r)
        return r, validity & (b != 0)

    def _remainder(self, rh, rl, bh, bl):
        ph, pl = d128.d128_add(rh, rl, bh, bl)
        shift = (rh < 0) & (bh >= 0)
        return torch.where(shift, ph, rh), torch.where(shift, pl, rl)


class UnaryPositive(Expression):
    """+x: the child itself."""

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        return self.children[0].eval(batch)


def _least_greatest_type(types) -> dt.DType:
    """Numeric promotion, decimals meeting at their wider type (an
    integral as its exact decimal, a float taking DOUBLE)."""
    if not any(dt.is_decimal(t) for t in types):
        out = types[0]
        for t in types[1:]:
            out = dt.promote(out, t)
        return out
    if any(t.is_floating for t in types):
        return dt.FLOAT64
    out = None
    for t in types:
        if t in _INTEGRAL_DECIMAL:
            t = dt.DecimalType(_INTEGRAL_DECIMAL[t], 0)
        elif not dt.is_decimal(t):
            raise TypeError(f"least / greatest of a decimal and {t}")
        out = t if out is None else dt.wider_decimal(out, t)
    return out


class _LeastGreatestBase(Expression):
    largest = False

    def data_type(self, schema: Schema) -> dt.DType:
        return _least_greatest_type([c.data_type(schema)
                                     for c in self.children])

    def eval(self, batch: ColumnarBatch):
        cols = [c.eval(batch) for c in self.children]
        if any(isinstance(c, StringColumn) for c in cols):
            return self._strings(cols)
        out_t = self.data_type(batch.schema())
        if dt.is_wide_decimal(out_t):
            raise cpu_fallback(f"{type(self).__name__.lower()} of a "
                               "DECIMAL(p>18)", "type signature of "
                               "least / greatest")
        if dt.is_decimal(out_t) or out_t == dt.FLOAT64 and \
                any(dt.is_decimal(c.dtype) for c in cols):
            from .cast import cast_column
            cols = [cast_column(c, out_t) for c in cols]
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
