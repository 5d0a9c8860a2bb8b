"""Math functions.

Counterpart of spark_rapids_tpu/expr/mathfns.py for the non-decimal
types: the unary functions of a double (Spark's NULL on a domain error
for ``ln`` / ``log*``, NaN and the infinities elsewhere, as
``StrictMath``), ``signum``, ``rint``, ``floor`` / ``ceil`` to BIGINT,
``pow``, ``atan2``, ``hypot``, and ``Round`` / ``BRound`` over floats,
integers and dates (decimals wait for columnar/decimal128.py).

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


class Round(Expression):
    """round(x, d): HALF_UP on the value's decimal string (Spark); the
    input type is kept."""

    half_even = False

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__(child)
        self.scale = int(scale)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not (t.is_integral or t.is_floating or t == dt.DATE):
            raise TypeError(f"{type(self).__name__.lower()} of {t} is not "
                            "in this port yet")
        return t

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
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
    is 0, saturated past the range)."""

    fn = None

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .cast import cast_column
        c = self.children[0].eval(batch)
        if c.dtype.is_integral:
            return make_result(c.data.to(torch.int64), c.validity, dt.INT64)
        x = type(self).fn(c.data.to(torch.float64))
        return cast_column(ColumnVector(x, c.validity, dt.FLOAT64),
                           dt.INT64)


class Floor(_FloorCeil):
    fn = staticmethod(torch.floor)


class Ceil(_FloorCeil):
    fn = staticmethod(torch.ceil)


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
