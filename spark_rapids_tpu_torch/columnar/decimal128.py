"""Two-limb 128-bit decimal column and its arithmetic, in torch.

Counterpart of spark_rapids_tpu/columnar/decimal128.py. A DECIMAL(p>18)
value is its unscaled 128-bit two's-complement integer in two 64-bit
limbs: ``hi`` (int64, carries the sign) and ``lo`` (the low 64 bits).
torch has almost no uint64 on CUDA, so ``lo`` is an int64 tensor holding
the same 64 bits, and the unsigned parts are built here:

- unsigned compare (and so every carry and borrow): compare after an
  XOR with the sign bit (``_ult``);
- logical right shift: ``_lshr`` (an arithmetic shift and a mask);
- 64 x 64 -> 128 products: 32-bit limbs whose partial products wrap in
  int64, exact as bits, every carry taken with the unsigned compare;
- constants of 2^63 and above: written as the int64 with their bits
  (``_signed``).

Every function is elementwise over equal-shaped tensors and has no data
dependent control flow: the long divisions run a fixed 128 or 256
shift-subtract steps (one Python loop, several launches a step).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dtypes as dt

_SIGN = -(1 << 63)          # the sign bit as an int64
_M32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def _signed(u: int) -> int:
    """The int64 holding the bits of unsigned 64-bit ``u``."""
    u &= _MASK64
    return u - (1 << 64) if u >= (1 << 63) else u


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full(like.shape, _signed(value), dtype=torch.int64,
                      device=like.device)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b of int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 <= s."""
    if s == 0:
        return x
    if s >= 64:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (64 - s)) - 1)


def _as_i64(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64)


class Decimal128Column:
    """DECIMAL(p>18) column: ``hi`` (int64) and ``lo`` (int64 holding the
    low 64 bits) unscaled limbs and a validity mask. Dead and null rows
    hold zero limbs."""

    __slots__ = ("hi", "lo", "validity", "dtype")

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor,
                 validity: torch.Tensor, dtype: dt.DecimalType):
        self.hi = hi
        self.lo = lo
        self.validity = validity
        self.dtype = dtype

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]

    @property
    def device(self) -> torch.device:
        return self.hi.device

    def with_validity(self, validity: torch.Tensor) -> "Decimal128Column":
        z = torch.zeros((), dtype=torch.int64, device=self.hi.device)
        return Decimal128Column(torch.where(validity, self.hi, z),
                                torch.where(validity, self.lo, z),
                                validity, self.dtype)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "Decimal128Column":
        safe = indices.clamp(0, max(self.capacity - 1, 0))
        hi, lo = self.hi[safe], self.lo[safe]
        validity = self.validity[safe]
        if valid is not None:
            validity = validity & valid
            z = torch.zeros((), dtype=torch.int64, device=hi.device)
            hi = torch.where(valid, hi, z)
            lo = torch.where(valid, lo, z)
        return Decimal128Column(hi, lo, validity, self.dtype)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy of the first ``num_rows`` rows as (object array of
        unscaled Python ints, mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        return ints_of_limbs(self.hi[:n].cpu().numpy(),
                             self.lo[:n].cpu().numpy()), \
            self.validity[:n].cpu().numpy()

    def __repr__(self):
        return f"Decimal128Column({self.dtype}, capacity={self.capacity})"


def ints_of_limbs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Object array of the Python ints hi * 2^64 + unsigned(lo)."""
    return hi.astype(object) * (1 << 64) + \
        np.asarray(lo, np.int64).view(np.uint64).astype(object)


def limbs_of_ints(values) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) int64 arrays of Python ints in the signed 128-bit
    range (numpy's object loops: no Python statement per value)."""
    ints = np.empty(len(values), dtype=object)
    ints[:] = [int(v) for v in values]
    hi = (ints >> 64).astype(np.int64)          # Python's >> keeps the sign
    lo = (ints & ((1 << 64) - 1)).astype(np.uint64).view(np.int64)
    return hi, lo


# ---------------------------------------------------------------------------
# limb arithmetic (wrapping, two's complement)
# ---------------------------------------------------------------------------

def d128_from_i64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extend an int64 into two limbs."""
    x = x.to(torch.int64)
    return x >> 63, x


def d128_add(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + _as_i64(_ult(lo, al)), lo


def d128_neg(h, l):
    nl = ~l + 1
    return ~h + _as_i64(nl == 0), nl


def d128_sub(ah, al, bh, bl):
    nh, nl = d128_neg(bh, bl)
    return d128_add(ah, al, nh, nl)


def d128_abs(h, l):
    neg = h < 0
    nh, nl = d128_neg(h, l)
    return torch.where(neg, nh, h), torch.where(neg, nl, l)


def d128_lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & _ult(al, bl))


def d128_eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def _mul_u64(a, b):
    """Unsigned 64 x 64 -> 128 product (hi, lo) of int64 bit patterns,
    from 32-bit limbs."""
    a0, a1 = a & _M32, _lshr(a, 32)
    b0, b1 = b & _M32, _lshr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lshr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << 32)
    hi = p11 + _lshr(p01, 32) + _lshr(p10, 32) + _lshr(mid, 32)
    return hi, lo


def d128_mul(ah, al, bh, bl):
    """Signed 128 x 128 multiply truncated to 128 bits, with the JAX
    package's overflow flag (set when either magnitude's high limb and
    the other's are both non-zero, a cross term passes 64 bits, the
    accumulate wraps or the magnitude reaches the sign bit)."""
    sa, sb = ah < 0, bh < 0
    ah1, al1 = d128_abs(ah, al)
    bh1, bl1 = d128_abs(bh, bl)
    p_hi, p_lo = _mul_u64(al1, bl1)
    hi = p_hi + ah1 * bl1 + bh1 * al1
    c1h, _ = _mul_u64(ah1, bl1)
    c2h, _ = _mul_u64(bh1, al1)
    overflow = (ah1 != 0) & (bh1 != 0)
    overflow |= (c1h != 0) | (c2h != 0)
    overflow |= _ult(hi, p_hi)
    overflow |= hi < 0
    nh, nl = d128_neg(hi, p_lo)
    neg = sa ^ sb
    return torch.where(neg, nh, hi), torch.where(neg, nl, p_lo), overflow


_POW10 = [10 ** k for k in range(39)]


def d128_mul_pow10(h, l, k: int):
    """(h, l) * 10^k for static k >= 0, with an overflow flag."""
    overflow = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    while k > 0:
        step = min(k, 18)
        m = _POW10[step]
        sa = h < 0
        h1, l1 = d128_abs(h, l)
        phi, plo = _mul_u64(l1, _full(l1, m))
        chk, _ = _mul_u64(h1, _full(h1, m))
        hi = phi + h1 * m
        overflow |= (chk != 0) | _ult(hi, phi) | (hi < 0)
        nh, nl = d128_neg(hi, plo)
        h = torch.where(sa, nh, hi)
        l = torch.where(sa, nl, plo)
        k -= step
    return h, l, overflow


def _divmod_small(h, l, d: int):
    """Unsigned (h, l) // d for 0 < d < 2^31 by 32-bit schoolbook
    division: each partial dividend is below 2^63, so int64 division is
    exact. Returns (qh, ql, rem)."""
    rem = torch.zeros_like(h)
    qs = []
    for limb in (_lshr(h, 32), h & _M32, _lshr(l, 32), l & _M32):
        cur = (rem << 32) | limb
        q = torch.div(cur, d, rounding_mode="floor")
        rem = cur - q * d
        qs.append(q)
    return (qs[0] << 32) | qs[1], (qs[2] << 32) | qs[3], rem


def _div_pow10_mag(uh, ul, k: int):
    while k > 0:
        step = min(k, 9)
        uh, ul, _ = _divmod_small(uh, ul, _POW10[step])
        k -= step
    return uh, ul


def _u128_add_const(uh, ul, c: int):
    nl = ul + _signed(c)
    return uh + _signed(c >> 64) + _as_i64(_ult(nl, ul)), nl


def d128_div_pow10_half_up(h, l, k: int):
    """(h, l) / 10^k rounded HALF_UP (ties away from zero), static k."""
    if k == 0:
        return h, l
    neg = h < 0
    mh, ml = d128_abs(h, l)
    mh, ml = _u128_add_const(mh, ml, _POW10[k] // 2)
    rh, rl = _div_pow10_mag(mh, ml, k)
    nh, nl = d128_neg(rh, rl)
    return torch.where(neg, nh, rh), torch.where(neg, nl, rl)


def d128_div_pow10_trunc(h, l, k: int):
    """(h, l) / 10^k truncated toward zero, static k."""
    if k == 0:
        return h, l
    neg = h < 0
    mh, ml = d128_abs(h, l)
    rh, rl = _div_pow10_mag(mh, ml, k)
    nh, nl = d128_neg(rh, rl)
    return torch.where(neg, nh, rh), torch.where(neg, nl, rl)


def _u128_ge(ah, al, bh, bl):
    return ~(_ult(ah, bh) | ((ah == bh) & _ult(al, bl)))


def _u128_sub(ah, al, bh, bl):
    return ah - bh - _as_i64(_ult(al, bl)), al - bl


def d128_divmod_u(nh, nl, dh, dl):
    """Unsigned 128 / 128 long division: (qh, ql, rh, rl). A zero
    divisor gives garbage: callers mask it. 128 fixed shift-subtract
    steps."""
    qh, ql = torch.zeros_like(nh), torch.zeros_like(nh)
    rh, rl = torch.zeros_like(nh), torch.zeros_like(nh)
    for k in range(127, -1, -1):
        bit = _lshr(nh, k - 64) & 1 if k >= 64 else _lshr(nl, k) & 1
        rh = (rh << 1) | _lshr(rl, 63)
        rl = (rl << 1) | bit
        ge = _u128_ge(rh, rl, dh, dl)
        sh, sl = _u128_sub(rh, rl, dh, dl)
        rh = torch.where(ge, sh, rh)
        rl = torch.where(ge, sl, rl)
        if k >= 64:
            qh = qh | (_as_i64(ge) << (k - 64))
        else:
            ql = ql | (_as_i64(ge) << k)
    return qh, ql, rh, rl


def d128_div_trunc(ah, al, bh, bl):
    """Signed truncating 128 / 128 divide: (qh, ql, rh, rl), the
    remainder with the dividend's sign (Java's %)."""
    qneg = (ah < 0) ^ (bh < 0)
    rneg = ah < 0
    mah, mal = d128_abs(ah, al)
    mbh, mbl = d128_abs(bh, bl)
    qh, ql, rh, rl = d128_divmod_u(mah, mal, mbh, mbl)
    nqh, nql = d128_neg(qh, ql)
    nrh, nrl = d128_neg(rh, rl)
    return (torch.where(qneg, nqh, qh), torch.where(qneg, nql, ql),
            torch.where(rneg, nrh, rh), torch.where(rneg, nrl, rl))


# ---------------------------------------------------------------------------
# 256-bit magnitudes (four limbs, little-endian) for Spark-exact
# multiply and divide: a decimal(38) x decimal(38) product, or a divide's
# numerator scaled up, passes 128 bits before the result scale applies
# ---------------------------------------------------------------------------

def _mul_u128_to_256(ah, al, bh, bl):
    p0h, p0l = _mul_u64(al, bl)
    p1h, p1l = _mul_u64(al, bh)
    p2h, p2l = _mul_u64(ah, bl)
    p3h, p3l = _mul_u64(ah, bh)
    w1 = p0h + p1l
    c1 = _as_i64(_ult(w1, p0h))
    w1b = w1 + p2l
    c1 = c1 + _as_i64(_ult(w1b, w1))
    w2 = p1h + p2h
    c2 = _as_i64(_ult(w2, p1h))
    w2b = w2 + p3l
    c2 = c2 + _as_i64(_ult(w2b, w2))
    w2c = w2b + c1
    c2 = c2 + _as_i64(_ult(w2c, w2b))
    return p0l, w1b, w2c, p3h + c2


def _d256_divmod_small(limbs, d: int):
    """256-bit magnitude // d for 0 < d < 2^31: (quotient limbs,
    remainder)."""
    w0, w1, w2, w3 = limbs
    rem = torch.zeros_like(w0)
    qs = []
    for w in (w3, w2, w1, w0):
        for c in (_lshr(w, 32), w & _M32):
            cur = (rem << 32) | c
            q = torch.div(cur, d, rounding_mode="floor")
            rem = cur - q * d
            qs.append(q)
    return tuple((qs[2 * i] << 32) | qs[2 * i + 1] for i in (3, 2, 1, 0)), \
        rem


def _d256_add_small(limbs, const: int):
    out = []
    carry = torch.zeros_like(limbs[0])
    for i, w in enumerate(limbs):
        r = w + _signed(const >> (64 * i))
        c_new = _as_i64(_ult(r, w))
        r2 = r + carry
        c_new = c_new + _as_i64(_ult(r2, carry))
        out.append(r2)
        carry = c_new
    return tuple(out)


def d256_div_pow10_half_up(limbs, k: int):
    """256-bit magnitude / 10^k, HALF_UP."""
    if k == 0:
        return limbs
    limbs = _d256_add_small(limbs, _POW10[k] // 2)
    while k > 0:
        step = min(k, 9)
        limbs, _ = _d256_divmod_small(limbs, _POW10[step])
        k -= step
    return limbs


def _d256_mul_small(limbs, m: int):
    """256-bit magnitude * m (0 < m < 2^31): (limbs, overflow)."""
    carry = torch.zeros_like(limbs[0])
    outc = []
    for w in limbs:
        for c in (w & _M32, _lshr(w, 32)):
            cur = c * m + carry
            outc.append(cur & _M32)
            carry = _lshr(cur, 32)
    return tuple((outc[2 * i + 1] << 32) | outc[2 * i] for i in range(4)), \
        carry != 0


def d256_mul_pow10(limbs, k: int):
    overflow = torch.zeros(limbs[0].shape, dtype=torch.bool,
                           device=limbs[0].device)
    while k > 0:
        step = min(k, 9)
        limbs, o = _d256_mul_small(limbs, _POW10[step])
        overflow |= o
        k -= step
    return limbs, overflow


def d256_fits_128(limbs):
    """The magnitude is below 2^127."""
    return (limbs[2] == 0) & (limbs[3] == 0) & (limbs[1] >= 0)


def d256_divmod_u128(n_limbs, dh, dl):
    """Unsigned 256 / 128 long division: (overflow, qh, ql, rh, rl),
    ``overflow`` set when the quotient needs more than 128 bits. A zero
    divisor gives garbage: callers mask it. 256 fixed steps."""
    zero = torch.zeros_like(n_limbs[0])
    qh, ql, rh, rl = zero, zero, zero, zero
    ovf = torch.zeros(zero.shape, dtype=torch.bool, device=zero.device)
    for k in range(255, -1, -1):
        bit = _lshr(n_limbs[k >> 6], k & 63) & 1
        rh = (rh << 1) | _lshr(rl, 63)
        rl = (rl << 1) | bit
        ge = _u128_ge(rh, rl, dh, dl)
        sh, sl = _u128_sub(rh, rl, dh, dl)
        rh = torch.where(ge, sh, rh)
        rl = torch.where(ge, sl, rl)
        ovf = ovf | (qh < 0)
        qh = (qh << 1) | _lshr(ql, 63)
        ql = (ql << 1) | _as_i64(ge)
    return ovf, qh, ql, rh, rl


def _signed_result(neg, mh, ml):
    nh, nl = d128_neg(mh, ml)
    return torch.where(neg, nh, mh), torch.where(neg, nl, ml)


def d128_mul_exact(ah, al, bh, bl, drop_scale: int):
    """Spark-exact multiply: |a| * |b| in 256 bits, / 10^drop_scale
    HALF_UP, sign reapplied. (hi, lo, overflow past 128 bits)."""
    neg = (ah < 0) ^ (bh < 0)
    mah, mal = d128_abs(ah, al)
    mbh, mbl = d128_abs(bh, bl)
    limbs = _mul_u128_to_256(mah, mal, mbh, mbl)
    limbs = d256_div_pow10_half_up(limbs, drop_scale)
    ok = d256_fits_128(limbs)
    h, l = _signed_result(neg, limbs[1], limbs[0])
    return h, l, ~ok


def d128_div_exact(ah, al, bh, bl, up_scale: int):
    """Spark-exact divide: (|a| * 10^up_scale) / |b| HALF_UP through a
    256-bit numerator. (hi, lo, overflow); a zero divisor must be masked
    by the caller."""
    neg = (ah < 0) ^ (bh < 0)
    mah, mal = d128_abs(ah, al)
    mbh, mbl = d128_abs(bh, bl)
    k0 = min(up_scale, 38)
    limbs = _mul_u128_to_256(mah, mal, _full(mah, _POW10[k0] >> 64),
                             _full(mah, _POW10[k0]))
    num_ovf = torch.zeros(ah.shape, dtype=torch.bool, device=ah.device)
    if up_scale > k0:
        limbs, num_ovf = d256_mul_pow10(limbs, up_scale - k0)
    ovf, qh, ql, rh, rl = d256_divmod_u128(limbs, mbh, mbl)
    # HALF_UP on the remainder: 2r >= |b|
    r2h = (rh << 1) | _lshr(rl, 63)
    bump = _as_i64(_u128_ge(r2h, rl << 1, mbh, mbl) | (rh < 0))
    ql2 = ql + bump
    qh2 = qh + _as_i64(_ult(ql2, ql))
    ovf = ovf | num_ovf | (qh2 < 0)
    h, l = _signed_result(neg, qh2, ql2)
    return h, l, ovf


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of int64 bits as the nearest float64 (one
    rounding, as a uint64 -> float64 conversion)."""
    hi32 = _lshr(x, 32).to(torch.float64) * 4294967296.0
    return hi32 + (x & _M32).to(torch.float64)


def d128_to_f64(h, l):
    """Approximate float64 value of the signed 128-bit integer, through
    sign and magnitude (h * 2^64 + l directly would cancel two floats
    near 2^64 for small negative values)."""
    neg = h < 0
    mh, ml = d128_abs(h, l)
    m = mh.to(torch.float64) * 18446744073709551616.0 + _u64_to_f64(ml)
    return torch.where(neg, -m, m)


def f64_to_d128(x):
    """A float64 rounded to the nearest signed 128-bit integer; callers
    bound-check through the float first."""
    two64 = 18446744073709551616.0
    neg = x < 0
    m = torch.abs(x)
    hi_f = torch.floor(m / two64)
    lo_f = torch.floor(m - hi_f * two64 + 0.5)
    carry = lo_f >= two64
    hi_f = hi_f + carry.to(hi_f.dtype)
    lo_f = torch.where(carry, 0.0, lo_f)
    # the largest double below 2^63 still converts to int64
    h = hi_f.clamp(0.0, 9223372036854774784.0).to(torch.int64)
    # a float at or past 2^63 does not convert to int64: split it
    big = lo_f >= 2.0 ** 63
    l = torch.where(big, lo_f - 2.0 ** 63, lo_f).to(torch.int64)
    l = torch.where(big, l ^ _SIGN, l)
    return _signed_result(neg, h, l)


def d128_fits_precision(h, l, precision: int):
    """|x| < 10^precision (Spark's changePrecision overflow check); the
    magnitude of -2^127 does not fit."""
    if precision >= 39:
        return torch.ones(h.shape, dtype=torch.bool, device=h.device)
    mh, ml = d128_abs(h, l)
    b = _POW10[precision]
    return (mh >= 0) & d128_lt(mh, ml, _full(mh, b >> 64), _full(mh, b))


def d128_rescale(h, l, from_scale: int, to_scale: int):
    """Change scale (HALF_UP down): (h, l, overflow from scaling up)."""
    if to_scale == from_scale:
        return h, l, torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    if to_scale > from_scale:
        return d128_mul_pow10(h, l, to_scale - from_scale)
    h2, l2 = d128_div_pow10_half_up(h, l, from_scale - to_scale)
    return h2, l2, torch.zeros(h.shape, dtype=torch.bool, device=h.device)


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------

def limbs_of(col) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) limbs of any decimal column: a long-backed one
    sign-extended."""
    if isinstance(col, Decimal128Column):
        return col.hi, col.lo
    return d128_from_i64(col.data)


def build_decimal_column(hi, lo, validity, dtype: dt.DecimalType):
    """Limbs as the physical column of ``dtype``: a Decimal128Column when
    wide, else an int64 ColumnVector (the caller's precision check says
    the value fits); lanes under nulls are zeroed."""
    from .vector import ColumnVector
    z = torch.zeros((), dtype=torch.int64, device=hi.device)
    if dtype.is_wide:
        return Decimal128Column(torch.where(validity, hi, z),
                                torch.where(validity, lo, z), validity,
                                dtype)
    return ColumnVector(torch.where(validity, lo, z), validity, dtype)


def sorted_seg_sum(values, gid, num_groups):
    """Per-group sums of rows in group order (``gid`` non-decreasing) as
    differences of one prefix sum at each group's bounds: no atomics,
    which serialize on the card when a batch has few groups. Exact for
    int64 while the running total stays below 2^63; for floats each
    group's sum carries the rounding of the prefix before it."""
    g = torch.arange(num_groups, dtype=gid.dtype, device=gid.device)
    first = torch.searchsorted(gid, g)
    after = torch.searchsorted(gid, g, right=True)
    cs = torch.zeros(values.shape[0] + 1, dtype=values.dtype,
                     device=values.device)
    torch.cumsum(values, 0, out=cs[1:])
    return cs[after] - cs[first]


def seg_sum128(hi, lo, gid, num_groups):
    """Segmented 128-bit sum of rows in group order (``gid``
    non-decreasing, as the grouping hands aggregates their rows), exact
    mod 2^128: each value split into four 32-bit limbs, each limb summed
    per group in an int64 (``sorted_seg_sum``, exact below 2^31 rows a
    call), then the carries propagated back into (hi, lo). Wrap
    detection is the caller's."""
    sums = [sorted_seg_sum(w, gid, num_groups)
            for w in (lo & _M32, _lshr(lo, 32), hi & _M32, _lshr(hi, 32))]
    acc = sums[0]
    w0 = acc & _M32
    acc = (acc >> 32) + sums[1]
    w1 = acc & _M32
    acc = (acc >> 32) + sums[2]
    w2 = acc & _M32
    acc = (acc >> 32) + sums[3]
    w3 = acc & _M32
    return w2 | (w3 << 32), w0 | (w1 << 32)


def sort_key_bias(h):
    """The hi limb with its sign bit flipped: as unsigned 64-bit values,
    (biased hi, lo) in lexicographic order is the signed 128-bit
    order (the JAX package's uint64 image, same bits)."""
    return h ^ _SIGN


def order_words(h, l):
    """Two int64 words whose signed lexicographic order is the signed
    128-bit order: hi as it is (``sort_key_bias`` read as signed), then
    lo with its sign bit flipped (unsigned order read as signed)."""
    return h, l ^ _SIGN


def seg_minmax128(hi, lo, valid, gid, num_groups, largest: bool):
    """Segmented 128-bit min / max in two lexicographic passes: the hi
    limb first, then lo (unsigned) among the rows on the group's best
    hi."""
    how = "amax" if largest else "amin"
    h_fill = _SIGN if largest else -1 - _SIGN
    hm = torch.where(valid, hi, h_fill)
    best_hi = torch.full((num_groups,), h_fill, dtype=torch.int64,
                         device=hi.device)
    best_hi.scatter_reduce_(0, gid, hm, how, include_self=True)
    on_best = valid & (hm == best_hi[gid])
    lo_b = torch.where(on_best, lo ^ _SIGN, h_fill)
    best_lo = torch.full((num_groups,), h_fill, dtype=torch.int64,
                         device=hi.device)
    best_lo.scatter_reduce_(0, gid, lo_b, how, include_self=True)
    return best_hi, best_lo ^ _SIGN


def from_unscaled_ints(values, capacity: int, dtype: dt.DecimalType,
                       mask: Optional[np.ndarray] = None, *,
                       device) -> Decimal128Column:
    """A column on ``device`` from unscaled Python ints (None for
    null)."""
    n = len(values)
    valid = np.array([v is not None for v in values], dtype=bool) \
        if mask is None else np.asarray(mask, dtype=bool)
    hi = np.zeros(capacity, np.int64)
    lo = np.zeros(capacity, np.int64)
    live = [0 if (not ok or v is None) else v
            for v, ok in zip(values, valid)]
    hi[:n], lo[:n] = limbs_of_ints(live)
    validity = np.zeros(capacity, bool)
    validity[:n] = valid
    return Decimal128Column(torch.from_numpy(hi).to(device),
                            torch.from_numpy(lo).to(device),
                            torch.from_numpy(validity).to(device), dtype)
