"""Casts between numeric, boolean, date, timestamp and string types.

Counterpart of spark_rapids_tpu/expr/cast.py (``Cast``,
``cast_column``) for the types this port carries, with Spark's
non-ANSI semantics:

- integral narrowing wraps (Java narrowing conversion),
- float -> integral truncates toward zero and saturates, NaN -> 0,
- numeric -> boolean is x != 0; boolean -> numeric is 0 / 1,
- date -> integral is its day number,
- date <-> timestamp through the day's midnight in UTC, timestamp ->
  integral its whole seconds (floored), integral -> timestamp seconds,
- to and from STRING as expr/strings.py formats and parses them (a
  row that does not parse is null),
- decimal -> decimal rescales, HALF_UP on a scale cut, and a value past
  the target's precision is null; integral and boolean -> decimal
  likewise; float -> decimal rounds the value's decimal string HALF_UP
  (Spark's ``BigDecimal(Double.toString(x))``, as round does,
  expr/mathfns.py); decimal -> float divides the 128-bit value by
  10^scale as a double; decimal -> integral truncates toward zero and,
  as Spark's ``Decimal.toLong`` does, wraps to the target's width (the
  JAX package makes an out-of-range row null; ROADMAP.md C15).

Under ANSI mode (``ansi=True``) a row that would be null or wrap
raises (GpuCast.scala:212-252 ansiMode, JAX ``Cast._ansi_check``): a
string that does not parse (SparkNumberFormatException, or
SparkDateTimeException to a DATE), a value past the target's range or
precision (SparkCastOverflowException), NaN to an integral included.

``check_supported`` refuses, when the plan is made, what the port
cannot cast (STRING -> TIMESTAMP, TIMESTAMP -> float). A DECIMAL(p>18)
to or from STRING runs on the CPU engine: the planner's ``_tag_cast``
(plan/overrides.py) sends it there, as the JAX planner does.
"""

from __future__ import annotations

import torch

from ..columnar import decimal128 as d128
from ..columnar import dtypes as dt
from ..columnar.decimal128 import Decimal128Column
from ..columnar.vector import Column, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result, true_div


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DType, ansi: bool = False):
        super().__init__(child)
        self.to = to
        self.ansi = ansi

    def data_type(self, schema: Schema) -> dt.DType:
        return self.to

    def check_supported(self, schema: Schema) -> None:
        """Raise TypeError where this port has no such cast."""
        src = self.children[0].data_type(schema)
        if not supported(src, self.to) and not cpu_only(src, self.to):
            raise TypeError(f"cast {src} -> {self.to} is not in this port "
                            "yet")

    def eval(self, batch: ColumnarBatch) -> Column:
        c = self.children[0].eval(batch)
        res = cast_column(c, self.to)
        if self.ansi and c.dtype != self.to:
            ansi_check(c, res, self.to, batch)
        return res

    def __repr__(self):
        return f"Cast({self.children[0]!r}, {self.to!r})"

    def can_fail(self, schema: Schema) -> bool:
        """Whether an ANSI check of this cast can raise at its types: a
        parse, a narrowing to an integral or a decimal target."""
        src = self.children[0].data_type(schema)
        if src == self.to or src == dt.NULL:
            return False
        if src == dt.STRING:
            return self.to != dt.STRING
        if dt.is_decimal(self.to):
            return True
        if self.to.is_integral and self.to != dt.DATE:
            if src.is_floating or dt.is_decimal(src):
                return True
            if src.is_integral and src != dt.DATE:
                return src.physical.itemsize > self.to.physical.itemsize
        return False


def ansi_check(src: Column, res: Column, to: dt.DType, key=None) -> None:
    """ANSI cast errors: a row the cast made null, or one whose source
    value lies past an integral target's range (the lanes that wrap or
    saturate), raises."""
    from . import errors as ERR
    from .ansi import guard
    if isinstance(src, StringColumn):
        exc_t = ERR.SparkDateTimeException if to in (dt.DATE, dt.TIMESTAMP) \
            else ERR.SparkNumberFormatException
        guard(src.validity & ~res.validity,
              exc_t(f"invalid input syntax for type {to} (ANSI mode cast)"),
              key)
        return
    # the JAX package's messages, a decimal target by its repr there
    target = f"DecimalType(precision={to.precision}, scale={to.scale})" \
        if dt.is_decimal(to) else str(to)
    guard(src.validity & ~res.validity, ERR.SparkCastOverflowException(
        f"cast to {target} causes overflow (ANSI mode)"), key)
    if not to.is_integral or to == dt.DATE:
        return
    exc = ERR.SparkCastOverflowException(
        f"casting {src.dtype} to {to} causes overflow (ANSI mode)")
    if dt.is_decimal(src.dtype):
        # Decimal.toLong wraps (C15): range-check the truncated value
        hi, lo = d128.limbs_of(src)
        th, tl = d128.d128_div_pow10_trunc(hi, lo, src.dtype.scale)
        bad = (th != (tl >> 63)) | (tl < dt.min_value(to)) | \
            (tl > dt.max_value(to))
    elif src.dtype.is_floating:
        x = src.data.to(torch.float64)
        bad = torch.isnan(x) | (x < float(dt.min_value(to))) | \
            (x >= float(dt.max_value(to)) + 1.0)
    elif src.dtype.is_integral and \
            src.data.element_size() > torch.empty((), dtype=to.physical
                                                  ).element_size():
        bad = (src.data < dt.min_value(to)) | (src.data > dt.max_value(to))
    else:
        return
    guard(src.validity & bad, exc, key)


def _numeric(t: dt.DType) -> bool:
    return t.is_integral or t.is_floating or t == dt.BOOL or \
        dt.is_decimal(t)


def cpu_only(src: dt.DType, to: dt.DType) -> bool:
    """A cast only the CPU engine runs: a DECIMAL(p>18) to or from
    STRING."""
    return (dt.is_wide_decimal(src) and to == dt.STRING) or \
        (src == dt.STRING and dt.is_wide_decimal(to))


def supported(src: dt.DType, to: dt.DType) -> bool:
    """Whether cast_column takes ``src`` -> ``to``."""
    if src == to or src == dt.NULL:
        return True
    if dt.is_decimal(src) or dt.is_decimal(to):
        other = to if dt.is_decimal(src) else src
        if other == dt.STRING:
            return not (dt.is_wide_decimal(src) or dt.is_wide_decimal(to))
        return _numeric(other)
    if to == dt.STRING:
        return _numeric(src) or src in (dt.DATE, dt.TIMESTAMP)
    if src == dt.STRING:
        return _numeric(to) or to == dt.DATE
    if src == dt.TIMESTAMP:
        return to == dt.DATE or to.is_integral
    if to == dt.TIMESTAMP:
        return src == dt.DATE or src.is_integral
    if src == dt.DATE:
        return to.is_integral or to.is_floating or to == dt.BOOL
    return _numeric(src) and (_numeric(to) or to == dt.DATE)


def cast_column(c: Column, to: dt.DType) -> Column:
    src = c.dtype
    if src == to:
        return c
    if isinstance(c, StringColumn):
        from .strings import cast_from_string
        return cast_from_string(c, to)
    if to == dt.STRING:
        from .strings import cast_to_string
        return cast_to_string(c)
    if to.physical is None or not supported(src, to):
        raise TypeError(f"cast {src} -> {to} is not in this port yet")
    if dt.is_decimal(src):
        return _from_decimal(c, to)
    if dt.is_decimal(to):
        if src == dt.NULL:
            from ..columnar.vector import null_column
            return null_column(to, c.capacity, c.device)
        return _to_decimal(c, to)
    data, validity = c.data, c.validity
    if src == dt.DATE and to == dt.TIMESTAMP:
        return make_result(data.to(torch.int64) * 86_400_000_000, validity,
                           to)
    if src == dt.TIMESTAMP:
        if to == dt.DATE:
            return make_result((data // 86_400_000_000).to(torch.int32),
                               validity, to)
        return make_result((data // 1_000_000).to(to.physical), validity,
                           to)
    if to == dt.TIMESTAMP:
        return make_result(data.to(torch.int64) * 1_000_000, validity, to)
    if to == dt.BOOL:
        return make_result(data != 0, validity, to)
    if src == dt.BOOL:
        return make_result(data.to(to.physical), validity, to)
    if src.is_floating and to in (dt.INT8, dt.INT16):
        # Spark's non-ANSI cast: toInt (saturating at INT's range), then a
        # two's-complement wrap to the target width (the JAX package
        # saturates at the target's range)
        as_int = cast_column(c, dt.INT32)
        return make_result(as_int.data.to(to.physical), validity, to)
    if src.is_floating and to.is_integral:
        x = torch.where(torch.isnan(data), torch.zeros((), dtype=data.dtype,
                                                       device=data.device),
                        data)
        imin, imax = dt.min_value(to), dt.max_value(to)
        # float64(2**63 - 1) rounds up to 2**63: saturate explicitly
        hi_bound = float(2 ** 63) if to == dt.INT64 else float(imax)
        clamped = torch.trunc(x.to(torch.float64).clamp(float(imin),
                                                        hi_bound))
        top = torch.full((), imax, dtype=to.physical, device=data.device)
        out = torch.where(clamped >= hi_bound, top, clamped.to(to.physical))
        return make_result(out, validity, to)
    if (src.is_integral or src == dt.DATE) and to.is_integral:
        # Java narrowing: two's-complement wrap to the target width
        return make_result(data.to(torch.int64).to(to.physical), validity,
                           to)
    # everything else: a plain convert (int -> float, float widening or
    # narrowing, int -> date)
    return make_result(data.to(to.physical), validity, to)


def _from_decimal(c, to: dt.DType) -> Column:
    src = c.dtype
    if dt.is_decimal(to):
        return rescale_decimal(c, to)
    hi, lo = d128.limbs_of(c)
    if to.is_floating:
        out = true_div(d128.d128_to_f64(hi, lo), 10.0 ** src.scale)
        return make_result(out.to(to.physical), c.validity, to)
    if to == dt.BOOL:
        return make_result((hi != 0) | (lo != 0), c.validity, to)
    # integral (and DATE's int32 lane): truncate toward zero, then keep
    # the low bits, Java's narrowing of Decimal.toLong
    _, tl = d128.d128_div_pow10_trunc(hi, lo, src.scale)
    return make_result(tl.to(to.physical), c.validity, to)


def _to_decimal(c, to: dt.DecimalType) -> Column:
    data, validity = c.data, c.validity
    if not data.is_floating_point():   # integral or boolean
        hi, lo = d128.d128_from_i64(data.to(torch.int64))
        hi, lo, ovf = d128.d128_mul_pow10(hi, lo, to.scale)
        ok = ~ovf & d128.d128_fits_precision(hi, lo, to.precision)
        return d128.build_decimal_column(hi, lo, validity & ok, to)
    x = data.to(torch.float64)
    ax = x.abs()
    p = 10.0 ** to.scale
    y = ax * p
    q = torch.floor(y)
    # HALF_UP on the value's shortest decimal: it is at or past the
    # midpoint exactly when x is at or past the double nearest it
    # (expr/mathfns.py); from 2^52 up y has no fraction to round
    exact = y < float(1 << 52)
    q = torch.where(exact, q + (ax >= true_div(q + 0.5, p)).to(
        torch.float64), y)
    finite = torch.isfinite(x) & (q < 10.0 ** to.precision)
    q = torch.where(finite, torch.where(x < 0, -q, q), 0.0)
    small = q.abs() < float(1 << 62)
    sh, sl = d128.d128_from_i64(torch.where(small, q, 0.0).to(torch.int64))
    bh, bl = d128.f64_to_d128(torch.where(small, 0.0, q))
    hi = torch.where(small, sh, bh)
    lo = torch.where(small, sl, bl)
    ok = finite & d128.d128_fits_precision(hi, lo, to.precision)
    return d128.build_decimal_column(hi, lo, validity & ok, to)


def rescale_decimal(c, to: dt.DecimalType) -> Column:
    """decimal(p1, s1) -> decimal(p2, s2): HALF_UP on a scale cut, null
    past the target's precision, across either width."""
    src = c.dtype
    if not isinstance(c, Decimal128Column) and not to.is_wide and (
            to.scale <= src.scale or
            src.precision + to.scale - src.scale <= 18):
        data = c.data
        if to.scale > src.scale:
            data = data * 10 ** (to.scale - src.scale)
        elif to.scale < src.scale:
            p = 10 ** (src.scale - to.scale)
            mag = torch.div(data.abs() + p // 2, p, rounding_mode="floor")
            data = torch.where(data < 0, -mag, mag)
        ok = data.abs() < 10 ** to.precision
        return make_result(data, c.validity & ok, to)
    hi, lo = d128.limbs_of(c)
    hi, lo, ovf = d128.d128_rescale(hi, lo, src.scale, to.scale)
    ok = ~ovf & d128.d128_fits_precision(hi, lo, to.precision)
    return d128.build_decimal_column(hi, lo, c.validity & ok, to)
