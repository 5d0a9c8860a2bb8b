"""Rounding functions.

Counterpart of spark_rapids_tpu/expr/mathfns.py, cut to ``Round`` and
``BRound`` over floats, integers and dates (decimals wait for
columnar/decimal128.py).

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
from .core import Expression, Schema, make_result

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
