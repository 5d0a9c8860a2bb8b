"""Math functions.

Counterpart of spark_rapids_tpu/expr/mathfns.py for the non-decimal
types: the unary functions of a double (Spark's NULL on a domain error
for ``ln`` / ``log*``, NaN and the infinities elsewhere, as
``StrictMath``), ``signum``, ``rint``, ``floor`` / ``ceil`` to BIGINT,
``pow``, ``atan2``, ``hypot``, and ``Round`` / ``BRound`` over floats,
integers, dates and decimals.

On a DECIMAL(p, s), ``floor`` / ``ceil`` give Spark's DECIMAL(p - s + 1,
0) (the JAX package caps the precision at 18), and ``round(x, d)`` /
``bround`` Spark's DECIMAL(min(p - s + 1 + min(s, d), 38), min(s, d))
(for d < 0, DECIMAL(max(p - s + 1, 1 - d), 0); the JAX package keeps
p), HALF_UP (HALF_EVEN) on the unscaled value; a result past its
precision is null (ROADMAP.md C15).

Where IEEE's ``pow`` and Java's differ, the port takes Java's: a NaN
exponent gives NaN (``pow(1, NaN)`` is 1 in C, in torch and in the JAX
package), and so does +-1 to an infinite power. ``floor`` / ``ceil`` of
NaN or a value past BIGINT's range take Spark's cast (0, saturated).
``signum`` keeps -0.0 and NaN. (ROADMAP.md C13 lists these.)

Spark rounds a double through its decimal string:
``BigDecimal(Double.toString(x)).setScale(d, mode).toDouble``. So
``round(1.005, 2)`` is 1.01, although the double nearest 1.005 lies just
below it. The JAX package rounds the binary value instead
(``floor(|x| * 10^d + 0.5) / 10^d`` gives 1.0; ROADMAP.md C11). This
port keeps Spark's rule without a string: with q = floor(|x| * 10^d)
and m = (q + 0.5) / 10^d, the shortest decimal of x is at or past the
midpoint m exactly when x is at or past the double nearest m, because
the shortest decimal of x is m itself when m rounds to x. Doubles whose
|x| * 10^d reaches 2^52 have no digit past the scale and pass through,
as do NaN and the infinities. A float is rounded as the double it
widens to, as Spark does.
"""

from __future__ import annotations

import torch

from ..columnar import decimal128 as d128
from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result, merged_validity

_EXACT = float(1 << 52)


def _round_float(x: torch.Tensor, scale: int, half_even: bool
                 ) -> torch.Tensor:
    xd = x.to(torch.float64)
    ax = xd.abs()
    if scale >= 0:
        p = 10.0 ** scale
        y = ax * p
        q = torch.floor(y)
        mid = (q + 0.5) / p
    else:
        p = 10.0 ** -scale
        y = ax / p
        q = torch.floor(y)
        mid = (q + 0.5) * p
    if half_even:
        up = (ax > mid) | ((ax == mid) & (torch.remainder(q, 2.0) == 1.0))
    else:
        up = ax >= mid
    q = q + up.to(torch.float64)
    r = q / p if scale >= 0 else q * p
    r = torch.where(r == 0, 0.0, torch.where(xd < 0, -r, r))
    keep = ~torch.isfinite(xd) | (y >= _EXACT)
    return torch.where(keep, xd, r).to(x.dtype)


def _round_integral(x: torch.Tensor, scale: int, half_even: bool
                    ) -> torch.Tensor:
    if scale >= 0:
        return x
    p = 10 ** -scale
    ax = x.to(torch.int64).abs()
    q, rem = ax // p, ax % p
    half = p // 2
    if half_even:
        up = (rem > half) | ((rem == half) & (q % 2 == 1))
    else:
        up = rem >= half
    r = (q + up.to(torch.int64)) * p
    return torch.where(x < 0, -r, r).to(x.dtype)


def _decimal_round(c, out_t: dt.DecimalType, drop: int, half_even: bool,
                   floor_ceil: int = 0):
    """A decimal column with ``drop`` fractional digits cut (rounded
    HALF_UP, HALF_EVEN, or with ``floor_ceil`` -1 / +1 toward -inf /
    +inf) and expressed at ``out_t``'s scale; null past its
    precision."""
    hi, lo = d128.limbs_of(c)
    if drop > 0:
        neg = hi < 0
        mh, ml = d128.d128_abs(hi, lo)
        qh, ql = d128.d128_div_pow10_trunc(mh, ml, drop)
        bh, bl, _ = d128.d128_mul_pow10(qh, ql, drop)
        rh, rl = d128.d128_sub(mh, ml, bh, bl)     # 0 <= r < 10^drop
        half = 10 ** drop // 2
        r_lt_half = d128.d128_lt(rh, rl, torch.full_like(rh, half >> 64),
                                 torch.full_like(rl, d128._signed(half)))
        r_eq_half = d128.d128_eq(rh, rl, torch.full_like(rh, half >> 64),
                                 torch.full_like(rl, d128._signed(half)))
        nonzero = (rh != 0) | (rl != 0)
        if floor_ceil:
            # toward -inf: a negative value with a remainder moves away
            # from zero; toward +inf a positive one does
            up = nonzero & (neg if floor_ceil < 0 else ~neg)
        elif half_even:
            up = ~r_lt_half & (~r_eq_half | ((ql & 1) == 1))
        else:
            up = ~r_lt_half
        qh, ql = d128.d128_add(qh, ql, torch.zeros_like(qh),
                               up.to(torch.int64))
        nh, nl = d128.d128_neg(qh, ql)
        hi, lo = torch.where(neg, nh, qh), torch.where(neg, nl, ql)
    ok = torch.ones_like(c.validity)
    lift = out_t.scale - (c.dtype.scale - max(drop, 0))
    if lift > 0:
        hi, lo, ovf = d128.d128_mul_pow10(hi, lo, lift)
        ok = ~ovf
    ok = ok & d128.d128_fits_precision(hi, lo, out_t.precision)
    return d128.build_decimal_column(hi, lo, c.validity & ok, out_t)


class Round(Expression):
    """round(x, d): HALF_UP on the value's decimal string (Spark); the
    input type is kept, but for a decimal's (see the module note)."""

    half_even = False

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__(child)
        self.scale = int(scale)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if dt.is_decimal(t):
            digits = t.precision - t.scale + 1
            if self.scale < 0:
                return dt.DecimalType(min(max(digits, 1 - self.scale),
                                          dt.DecimalType.MAX_PRECISION), 0)
            new_scale = min(t.scale, self.scale)
            return dt.DecimalType(min(digits + new_scale,
                                      dt.DecimalType.MAX_PRECISION),
                                  new_scale)
        if not (t.is_integral or t.is_floating or t == dt.DATE):
            raise TypeError(f"{type(self).__name__.lower()} of {t} is not "
                            "in this port yet")
        return t

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if dt.is_decimal(c.dtype):
            # a negative d rounds to a multiple of 10^-d, at scale 0
            drop = c.dtype.scale - min(self.scale, c.dtype.scale)
            return _decimal_round(c, self.data_type(batch.schema()), drop,
                                  self.half_even)
        fn = _round_float if c.dtype.is_floating else _round_integral
        return make_result(fn(c.data, self.scale, self.half_even),
                           c.validity, c.dtype)

    def __repr__(self):
        return f"{type(self).__name__}({self.children[0]!r}, {self.scale})"


class BRound(Round):
    """bround(x, d): HALF_EVEN (banker's rounding) on the value's
    decimal string."""

    half_even = True


class _UnaryDouble(Expression):
    """f(double(x)); a null input gives null. ``domain`` (optional)
    names the inputs f takes; outside it the row is null (Spark's
    ``ln`` of a non-positive value)."""

    @staticmethod
    def fn(x):
        raise NotImplementedError

    domain = None

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.FLOAT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        x = c.data.to(torch.float64)
        validity = c.validity
        if self.domain is not None:
            ok = type(self).domain(x)
            validity = validity & ok
            x = torch.where(ok, x, torch.ones((), dtype=x.dtype,
                                               device=x.device))
        return make_result(type(self).fn(x), validity, dt.FLOAT64)


def _unary(name: str, fn, domain=None, doc: str = ""):
    cls = type(name, (_UnaryDouble,), {"fn": staticmethod(fn),
                                       "domain": domain and
                                       staticmethod(domain),
                                       "__doc__": doc or f"{name}(x)"})
    cls.__module__ = __name__
    return cls


def _cbrt(x):
    """Real cube root: |x|^(1/3) with the sign, one Newton step to the
    nearest double (torch has no cbrt)."""
    y = x.abs().pow(1.0 / 3.0)
    y = torch.where((y > 0) & torch.isfinite(y),
                    y - (y * y * y - x.abs()) / (3.0 * y * y), y)
    return torch.copysign(y, x)


def _signum(x):
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


Sqrt = _unary("Sqrt", torch.sqrt)
Cbrt = _unary("Cbrt", _cbrt)
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Log = _unary("Log", torch.log, lambda x: x > 0,
             "ln(x); null where x <= 0 (Spark)")
Log1p = _unary("Log1p", torch.log1p, lambda x: x > -1,
               "log1p(x); null where x <= -1")
Log2 = _unary("Log2", torch.log2, lambda x: x > 0)
Log10 = _unary("Log10", torch.log10, lambda x: x > 0)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Asinh = _unary("Asinh", torch.asinh)
Acosh = _unary("Acosh", torch.acosh)
Atanh = _unary("Atanh", torch.atanh)
ToDegrees = _unary("ToDegrees", torch.rad2deg)
ToRadians = _unary("ToRadians", torch.deg2rad)
Signum = _unary("Signum", _signum)
Rint = _unary("Rint", torch.round, doc="rint(x): half to even")


class _FloorCeil(Expression):
    """floor / ceil: BIGINT, through Spark's double -> bigint cast (NaN
    is 0, saturated past the range); a DECIMAL(p, s > 0) gives
    DECIMAL(p - s + 1, 0), a DECIMAL(p, 0) itself."""

    fn = None
    direction = 0

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if dt.is_decimal(t):
            return t if t.scale == 0 else \
                dt.DecimalType(min(t.precision - t.scale + 1,
                                   dt.DecimalType.MAX_PRECISION), 0)
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .cast import cast_column
        c = self.children[0].eval(batch)
        if dt.is_decimal(c.dtype):
            if c.dtype.scale == 0:
                return c
            return _decimal_round(c, self.data_type(batch.schema()),
                                  c.dtype.scale, False, self.direction)
        if c.dtype.is_integral:
            return make_result(c.data.to(torch.int64), c.validity, dt.INT64)
        x = type(self).fn(c.data.to(torch.float64))
        return cast_column(ColumnVector(x, c.validity, dt.FLOAT64),
                           dt.INT64)


class Floor(_FloorCeil):
    fn = staticmethod(torch.floor)
    direction = -1


class Ceil(_FloorCeil):
    fn = staticmethod(torch.ceil)
    direction = 1


class _BinaryDouble(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.FLOAT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        data = self.fn(a.data.to(torch.float64), b.data.to(torch.float64))
        return make_result(data, merged_validity(a, b), dt.FLOAT64)


class Pow(_BinaryDouble):
    """pow(x, y) with Java's special cases (see the module note)."""

    @staticmethod
    def fn(x, y):
        r = torch.pow(x, y)
        nan = torch.isnan(y) | ((x.abs() == 1.0) & torch.isinf(y))
        return torch.where(nan, float("nan"), r)


class Atan2(_BinaryDouble):
    fn = staticmethod(torch.atan2)


class Hypot(_BinaryDouble):
    fn = staticmethod(torch.hypot)
