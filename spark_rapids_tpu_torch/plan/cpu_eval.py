"""CPU (numpy) expression evaluator over host tables.

Counterpart of spark_rapids_tpu/plan/cpu_eval.py, copied with its
imports re-pointed: it evaluates the same Expression trees the device
path runs, with numpy over host columns in the CPU engine's layout
(host_table.py ``to_engine``). It is where the planner sends what the
device does not run (overrides.py), the role CPU Spark plays for the
reference.

Semantics mirror the port's expr/ modules (which cite Spark):
divide-by-zero -> null, Java trunc-mod sign rules, Kleene AND/OR,
NaN-greatest ordering, null-iff-any-input-null for scalar functions,
decimal lanes as scaled int64 (Python ints above precision 18). Under
ANSI mode the evaluators raise the device's error types
(``_ansi_raise_if``, the JAX evaluators' raises), for the rows that
reach the node: a conditional and the right side of AND / OR bind them
as the device does (expr/ansi.py ``reach``). Where the port follows
Spark and the JAX package does not, the evaluator follows the port.
Every evaluator returns (values, mask).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple, Type

import numpy as np

from ..columnar import dtypes as dt
from ..expr import arithmetic as A
from ..expr import cast as C
from ..expr import conditional as Cond
from ..expr import core as E
from ..expr import datetime as D
from ..expr import mathfns as M
from ..expr import predicates as P
from ..expr import strings as S
from .host_table import HostColumn, HostTable

Result = Tuple[np.ndarray, np.ndarray]  # (values, mask)

_EVALUATORS: Dict[Type, Callable] = {}


def cpu_supported(expr: E.Expression) -> bool:
    return type(expr) in _EVALUATORS


def evaluate(expr: E.Expression, table: HostTable) -> HostColumn:
    """Evaluate to a HostColumn (physical lanes + null mask)."""
    fn = _EVALUATORS.get(type(expr))
    if fn is None:
        raise NotImplementedError(
            f"no CPU evaluator for {type(expr).__name__}")
    values, mask = fn(expr, table)
    return HostColumn(np.asarray(values), np.asarray(mask),
                      expr.data_type(table.schema()))


def _reg(cls):
    def deco(fn):
        _EVALUATORS[cls] = fn
        return fn
    return deco


def _ev(expr, table) -> Result:
    c = evaluate(expr, table)
    return c.values, c.mask


def _ansi_raise_if(mask, exc, table) -> None:
    """The CPU engine's ANSI guard: raise ``exc`` if a row of ``mask``
    that reaches the node is set."""
    from ..expr.ansi import guard
    guard(np.asarray(mask, bool), exc, table)


def _ev_reached(expr, table, rows) -> Result:
    """``_ev`` with the rows that reach ``expr`` bound (expr/ansi.py)."""
    from ..expr.ansi import evaluate_reached
    return evaluate_reached(expr, table, rows, lambda x: _ev(x, table))


def _zero_nulls(values, mask):
    """Zero data lanes under nulls (the device-side invariant)."""
    if values.dtype == object:
        return np.where(mask, values, "")
    return np.where(mask, values, np.zeros(1, dtype=values.dtype))


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

@_reg(E.ColumnRef)
def _col(expr, table):
    c = table.column(expr.name)
    return c.values, c.mask


@_reg(E.Alias)
def _alias(expr, table):
    return _ev(expr.children[0], table)


@_reg(E.Literal)
def _literal(expr, table):
    n = table.num_rows
    t = expr.dtype
    if expr.value is None:
        phys = object if t == dt.STRING else np.dtype(
            (t.np_physical or np.int32))
        return np.zeros(n, phys), np.zeros(n, bool)
    if t == dt.STRING:
        return np.full(n, str(expr.value), dtype=object), np.ones(n, bool)
    from ..expr.core import literal_physical as _to_physical
    v = _to_physical(expr.value, t)
    if isinstance(t, dt.DecimalType) and t.is_wide:
        return np.array([v] * n, dtype=object), np.ones(n, bool)
    return (np.full(n, v, dtype=np.dtype(t.np_physical)), np.ones(n, bool))


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _rescale_np(data, from_scale: int, to_scale: int):
    if to_scale > from_scale:
        return data * np.int64(10 ** (to_scale - from_scale))
    if to_scale < from_scale:
        return data // np.int64(10 ** (from_scale - to_scale))
    return data


def _obj_ints(a) -> np.ndarray:
    """Lanes as python ints (exact, arbitrary precision)."""
    if a.dtype == object:
        return a
    return np.array([int(x) for x in a], dtype=object)


def _half_up_obj(vals, k: int):
    """vals / 10^k with HALF_UP on python-int lanes."""
    if k <= 0:
        return vals
    p = 10 ** k
    half = p // 2
    return np.array([(abs(int(v)) + half) // p * (1 if v >= 0 else -1)
                     for v in vals], dtype=object)


_I128_MAX = 2 ** 127  # device two-limb intermediate bound


def _decimal_arith_obj(a, b, mask, op, lt, rt, out_t):
    """Exact decimal arithmetic on python-int lanes, mirroring the
    device decimal128 path including its overflow->null behavior: the
    result nulls when it exceeds 10^precision, and (add/sub only) when a
    scale-aligned operand exceeds the 128-bit intermediate range."""
    a = _obj_ints(a)
    b = _obj_ints(b)
    if op in ("add", "sub"):
        def align(v, fs):
            if out_t.scale >= fs:
                return v * 10 ** (out_t.scale - fs)
            return _half_up_obj(v, fs - out_t.scale)
        a2 = align(a, lt.scale)
        b2 = align(b, rt.scale)
        inter_ok = np.array([abs(int(x)) < _I128_MAX for x in a2], bool) & \
            np.array([abs(int(x)) < _I128_MAX for x in b2], bool)
        out = a2 - b2 if op == "sub" else a2 + b2
        mask = mask & inter_ok
    else:  # mul
        raw = a * b
        out = _half_up_obj(raw, lt.scale + rt.scale - out_t.scale)
    bound = 10 ** out_t.precision
    fits = np.array([abs(int(v)) < bound for v in out], bool)
    mask = mask & fits
    out = np.where(mask, out, 0)
    if not out_t.is_wide:
        out = np.array([int(v) for v in out], dtype=np.int64)
    return out, mask


def _coerced(expr, table):
    """(left_child, right_child, left_t, right_t) after the op's
    implicit coercion (DecimalPrecision + per-op inputType casts, e.g.
    IntegralDivide's float->long) — the ONE preamble every binary-
    arithmetic oracle evaluator must share (per-evaluator copies are
    exactly where float-mix paths got missed)."""
    lc, rc = expr.coerced_children(table.schema())
    return lc, rc, lc.data_type(table.schema()), \
        rc.data_type(table.schema())


def _spark_string_to_date(s: str) -> int:
    """DateTimeUtils.stringToDate: yyyy | yyyy-[m]m | yyyy-[m]m-[d]d
    (a trailing 'T…'/' …' time segment after a FULL date is ignored);
    real calendar validation. Returns epoch days; raises ValueError on
    any invalid form (caller maps to null / ANSI error)."""
    import datetime
    body = s
    for cut in ("T", " "):
        p = body.find(cut)
        if p >= 0:
            if body[:p].count("-") != 2:
                raise ValueError(s)
            body = body[:p]
    parts = body.split("-")
    if not 1 <= len(parts) <= 3 or len(parts[0]) != 4:
        raise ValueError(s)
    vals = []
    for seg in parts:
        if not seg.isdigit() or len(seg) == 0 or len(seg) > 4:
            raise ValueError(s)
        vals.append(int(seg))
    y = vals[0]
    mth = vals[1] if len(vals) > 1 else 1
    d = vals[2] if len(vals) > 2 else 1
    if len(vals) > 1 and len(parts[1]) > 2:
        raise ValueError(s)
    if len(vals) > 2 and len(parts[2]) > 2:
        raise ValueError(s)
    # proleptic Gregorian incl. year 0 (datetime.date rejects y < 1,
    # but Spark's LocalDate and the device lane accept it)
    if not 1 <= mth <= 12:
        raise ValueError(s)
    leap = (y % 4 == 0 and y % 100 != 0) or y % 400 == 0
    dim = [31, 29 if leap else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30,
           31][mth - 1]
    if not 1 <= d <= dim:
        raise ValueError(s)
    # Howard Hinnant's days_from_civil (same formula as the device)
    yy = y - (mth <= 2)
    era = (yy if yy >= 0 else yy - 399) // 400
    yoe = yy - era * 400
    doy = (153 * (mth + (-3 if mth > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _binary_arith(expr, table, op):
    lc, rc, lt, rt = _coerced(expr, table)
    out_t = expr.data_type(table.schema())
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    mask = am & bm
    if isinstance(out_t, dt.DecimalType):
        wide = out_t.is_wide or lt.is_wide or rt.is_wide
        if wide:
            out, omask = _decimal_arith_obj(a, b, mask, op, lt, rt, out_t)
            if expr.ansi:
                _ansi_raise_if(mask & ~omask, _decimal_exc(op), table)
            return out, omask
        a = _rescale_np(a.astype(np.int64), lt.scale, out_t.scale) \
            if op != "mul" else a.astype(np.int64)
        b = _rescale_np(b.astype(np.int64), rt.scale, out_t.scale) \
            if op != "mul" else b.astype(np.int64)
        if op == "add":
            out = a + b
        elif op == "sub":
            out = a - b
        else:
            out = _rescale_np(a * b, lt.scale + rt.scale, out_t.scale)
        return _zero_nulls(out, mask), mask
    phys = np.dtype(out_t.np_physical)
    a = a.astype(phys)
    b = b.astype(phys)
    with np.errstate(over="ignore"):
        if op == "add":
            out = a + b
        elif op == "sub":
            out = a - b
        else:
            out = a * b
    if expr.ansi and out_t.is_integral:
        from ..expr import errors as ERR
        ao, bo = a.astype(object), b.astype(object)
        exact = ao + bo if op == "add" else ao - bo if op == "sub" \
            else ao * bo
        info = np.iinfo(phys)
        bad = mask & np.array([not info.min <= int(v) <= info.max
                               for v in exact], bool)
        _ansi_raise_if(bad, ERR.SparkArithmeticException(
            ERR.overflow_message(str(out_t))), table)
    return _zero_nulls(out, mask), mask


def _decimal_exc(op_name: str):
    from ..expr import errors as ERR
    return ERR.SparkArithmeticException(
        f"{op_name}: decimal overflow or division by zero (ANSI mode)")


@_reg(A.Add)
def _add(e, t):
    return _binary_arith(e, t, "add")


@_reg(A.Subtract)
def _sub(e, t):
    return _binary_arith(e, t, "sub")


@_reg(A.Multiply)
def _mul(e, t):
    return _binary_arith(e, t, "mul")


@_reg(A.Divide)
def _div(expr, table):
    lc, rc, lt, rt = _coerced(expr, table)
    out_t = expr.data_type(table.schema())
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    if isinstance(out_t, dt.DecimalType):
        # exact decimal division, HALF_UP at the result scale
        a = _obj_ints(a)
        b = _obj_ints(b)
        mask = am & bm & np.array([int(x) != 0 for x in b], bool)
        up = out_t.scale - lt.scale + rt.scale
        bound = 10 ** out_t.precision
        out = np.zeros(len(a), dtype=object)
        for i in range(len(a)):
            if not mask[i]:
                out[i] = 0
                continue
            n = abs(int(a[i])) * 10 ** up
            d = abs(int(b[i]))
            q, r = divmod(n, d)
            if 2 * r >= d:
                q += 1
            if (int(a[i]) < 0) != (int(b[i]) < 0):
                q = -q
            if abs(q) >= bound or abs(q) >= _I128_MAX:
                mask[i] = False
                q = 0
            out[i] = q
        if not out_t.is_wide:
            out = np.array([int(v) for v in out], dtype=np.int64)
        if expr.ansi:
            _ansi_raise_if(am & bm & ~mask, _decimal_exc("/"), table)
        return out, mask
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if expr.ansi:
        _ansi_raise_if(am & bm & (b == 0.0), _div_zero(), table)
    mask = am & bm & (b != 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(b != 0.0, a / np.where(b == 0.0, 1.0, b), 0.0)
    return _zero_nulls(out, mask), mask


def _div_zero():
    from ..expr import errors as ERR
    return ERR.SparkArithmeticException(ERR.DIVIDE_BY_ZERO)


def _trunc_div_np(a, b):
    q = a // b
    r = a - q * b
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return q + adjust.astype(q.dtype)


def _trunc_mod_np(a, b):
    r = a % b
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return r - np.where(adjust, b, np.zeros(1, b.dtype))


def _decimal_divmod_obj(expr, table):
    """Common-scale exact truncating divmod for decimal operands.
    Returns (q, r, |b| at the common scale, mask, scale, base_mask)
    where base_mask is the pre-division operand validity (am & bm) —
    the ANSI guards diff it against the final mask to find
    op-introduced nulls without re-evaluating the operands."""
    lc, rc, lt, rt = _coerced(expr, table)
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    s = max(lt.scale, rt.scale)
    a = _obj_ints(a) * (10 ** (s - lt.scale))
    b = _obj_ints(b) * (10 ** (s - rt.scale))
    base_mask = am & bm
    mask = base_mask & np.array([int(x) != 0 for x in b], bool)
    n = len(a)
    q = np.zeros(n, dtype=object)
    r = np.zeros(n, dtype=object)
    for i in range(n):
        if not mask[i]:
            continue
        qq, rr = divmod(abs(int(a[i])), abs(int(b[i])))
        q[i] = qq if (int(a[i]) < 0) == (int(b[i]) < 0) else -qq
        r[i] = rr if int(a[i]) >= 0 else -rr
    return (q, r, np.array([abs(int(x)) for x in b], dtype=object),
            mask, s, base_mask)


@_reg(A.IntegralDivide)
def _idiv(expr, table):
    lc, rc, lt, rt = _coerced(expr, table)
    if isinstance(lt, dt.DecimalType):  # coerced: both-or-neither
        q, _, _, mask, _, base_mask = _decimal_divmod_obj(expr, table)
        fits = np.array([-(2 ** 63) <= int(v) < 2 ** 63 for v in q], bool)
        mask = mask & fits
        out = np.array([int(v) if f else 0 for v, f in zip(q, fits)],
                       dtype=np.int64)
        if expr.ansi:
            from ..expr import errors as ERR
            _ansi_raise_if(base_mask & ~mask, ERR.SparkArithmeticException(
                "div: division by zero or overflow (ANSI mode)"), table)
        return _zero_nulls(out, mask), mask
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    if expr.ansi:
        from ..expr import errors as ERR
        _ansi_raise_if(am & bm & (b == 0), _div_zero(), table)
        if not np.issubdtype(a.dtype, np.floating):
            _ansi_raise_if(am & bm & (a.astype(np.int64) == -(2 ** 63))
                           & (b.astype(np.int64) == -1),
                           ERR.SparkArithmeticException(
                               ERR.overflow_message("bigint")), table)
    mask = am & bm & (b != 0)
    safe = np.where(b == 0, np.ones(1, b.dtype), b)
    if np.issubdtype(a.dtype, np.floating):
        q = np.trunc(a.astype(np.float64) / safe.astype(np.float64))
    else:
        q = _trunc_div_np(a, safe)
    return _zero_nulls(q.astype(np.int64), mask), mask


def _decimal_mod_result(expr, table, positive: bool):
    out_t = expr.data_type(table.schema())
    _, r, babs, mask, s, base_mask = _decimal_divmod_obj(expr, table)
    if positive:
        r = np.array([int(v) + int(ab) if int(v) < 0 else int(v)
                      for v, ab in zip(r, babs)], dtype=object)
    if out_t.scale != s:
        r = _half_up_obj(r, s - out_t.scale)
    bound = 10 ** out_t.precision
    fits = np.array([abs(int(v)) < bound for v in r], bool)
    mask = mask & fits
    if expr.ansi:
        _ansi_raise_if(base_mask & ~mask, _decimal_exc(expr.op_name), table)
    r = np.where(mask, r, 0)
    if not out_t.is_wide:
        r = np.array([int(v) for v in r], dtype=np.int64)
    return r, mask


@_reg(A.Remainder)
def _rem(expr, table):
    out_t = expr.data_type(table.schema())
    if isinstance(out_t, dt.DecimalType):
        return _decimal_mod_result(expr, table, positive=False)
    phys = np.dtype(out_t.np_physical)
    lc, rc, _lt, _rt = _coerced(expr, table)
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    a = a.astype(phys)
    b = b.astype(phys)
    if expr.ansi:
        _ansi_raise_if(am & bm & (b == 0), _div_zero(), table)
    mask = am & bm & (b != 0)
    safe = np.where(b == 0, np.ones(1, b.dtype), b)
    if np.issubdtype(a.dtype, np.floating):
        out = np.fmod(a, safe)
    else:
        out = _trunc_mod_np(a, safe)
    return _zero_nulls(out, mask), mask


@_reg(A.Pmod)
def _pmod(expr, table):
    out_t = expr.data_type(table.schema())
    if isinstance(out_t, dt.DecimalType):
        return _decimal_mod_result(expr, table, positive=True)
    phys = np.dtype(out_t.np_physical)
    lc, rc, _lt, _rt = _coerced(expr, table)
    a, am = _ev(lc, table)
    b, bm = _ev(rc, table)
    a = a.astype(phys)
    b = b.astype(phys)
    if expr.ansi:
        _ansi_raise_if(am & bm & (b == 0), _div_zero(), table)
    mask = am & bm & (b != 0)
    safe = np.where(b == 0, np.ones(1, b.dtype), b)
    mod = np.fmod if np.issubdtype(a.dtype, np.floating) else _trunc_mod_np
    with np.errstate(all="ignore"):
        r = mod(a, safe)
        # Spark: (r + n) % n where r < 0 (for n < 0 that is r itself)
        r = np.where(r < 0, mod(r + safe, safe), r)
    return _zero_nulls(r, mask), mask


@_reg(A.UnaryMinus)
def _neg(expr, table):
    a, m = _ev(expr.children[0], table)
    t = expr.children[0].data_type(table.schema())
    _ansi_min_raise(expr, a, m, t, table)
    with np.errstate(over="ignore"):
        return _zero_nulls(-a, m), m


def _ansi_min_raise(expr, a, m, t, table) -> None:
    """ANSI: -x and abs(x) of an integral minimum overflow."""
    if expr.ansi and t.is_integral:
        from ..expr import errors as ERR
        _ansi_raise_if(m & (a == np.iinfo(a.dtype).min),
                       ERR.SparkArithmeticException(
                           ERR.overflow_message(str(t))), table)


@_reg(A.UnaryPositive)
def _pos(expr, table):
    return _ev(expr.children[0], table)


@_reg(A.Abs)
def _abs(expr, table):
    a, m = _ev(expr.children[0], table)
    t = expr.children[0].data_type(table.schema())
    _ansi_min_raise(expr, a, m, t, table)
    with np.errstate(over="ignore"):
        return _zero_nulls(np.abs(a), m), m


def _least_greatest(expr, table, largest: bool):
    schema = table.schema()
    out_t = expr.data_type(schema)
    if any(isinstance(c.data_type(schema), dt.DecimalType)
           for c in expr.children):
        # decimals meet at the result type (or DOUBLE), as on the device
        expr = type(expr)(*[c if c.data_type(schema) == out_t
                            else C.Cast(c, out_t) for c in expr.children])
    if out_t == dt.STRING:
        # null-skipping lexicographic min/max (the device lane folds
        # the same semantics through If/IsNull over string columns)
        n = table.num_rows
        cols = [_ev(c, table) for c in expr.children]
        out = np.empty(n, object)
        valid = np.zeros(n, bool)
        for i in range(n):
            best = None
            for v, m in cols:
                if not m[i]:
                    continue
                s = v[i]
                if best is None or \
                        ((s > best) if largest else (s < best)):
                    best = s
            valid[i] = best is not None
            out[i] = best if best is not None else ""
        return out, valid
    n = table.num_rows
    if dt.is_wide_decimal(out_t):  # Python ints: null-skipping min / max
        cols = [_ev(c, table) for c in expr.children]
        pick = max if largest else min
        out = np.zeros(n, dtype=object)
        valid = np.zeros(n, bool)
        for i in range(n):
            live = [int(v[i]) for v, m in cols if m[i]]
            if live:
                out[i], valid[i] = pick(live), True
        return out, valid
    phys = np.dtype(out_t.np_physical)
    fill = dt.max_value(out_t) if not largest else dt.min_value(out_t)
    acc = np.full(n, fill, phys)
    any_valid = np.zeros(n, bool)
    if np.issubdtype(phys, np.floating):
        # Spark float order: NaN greatest (mirrors the device lane)
        nan_seen = np.zeros(n, bool)
        num_seen = np.zeros(n, bool)
        for c in expr.children:
            v, m = _ev(c, table)
            v = v.astype(phys)
            nan = np.isnan(v)
            vv = np.where(m & ~nan, v, np.asarray(fill, phys))
            acc = np.maximum(acc, vv) if largest else np.minimum(acc, vv)
            nan_seen |= m & nan
            num_seen |= m & ~nan
            any_valid |= m
        nan_v = np.asarray(np.nan, phys)
        if largest:
            acc = np.where(nan_seen, nan_v, acc)
        else:
            acc = np.where(num_seen, acc, nan_v)
        return _zero_nulls(acc, any_valid), any_valid
    for c in expr.children:
        v, m = _ev(c, table)
        v = np.where(m, v.astype(phys), np.asarray(fill, phys))
        acc = np.maximum(acc, v) if largest else np.minimum(acc, v)
        any_valid |= m
    return _zero_nulls(acc, any_valid), any_valid


@_reg(A.Least)
def _least(e, t):
    return _least_greatest(e, t, largest=False)


@_reg(A.Greatest)
def _greatest(e, t):
    return _least_greatest(e, t, largest=True)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def _aligned_np(expr, table):
    lt = expr.children[0].data_type(table.schema())
    rt = expr.children[1].data_type(table.schema())
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    mask = am & bm
    l_dec = isinstance(lt, dt.DecimalType)
    r_dec = isinstance(rt, dt.DecimalType)
    if lt == dt.STRING or rt == dt.STRING:
        return a, b, mask, True
    if l_dec or r_dec:
        lf = (not l_dec) and lt.is_floating
        rf = (not r_dec) and rt.is_floating
        wide = (l_dec and lt.is_wide) or (r_dec and rt.is_wide)
        if lf or rf:
            fa = np.array([float(x) for x in a]) if a.dtype == object \
                else a.astype(np.float64)
            fb = np.array([float(x) for x in b]) if b.dtype == object \
                else b.astype(np.float64)
            a = fa / (10.0 ** lt.scale if l_dec else 1.0)
            b = fb / (10.0 ** rt.scale if r_dec else 1.0)
        elif wide:
            ls = lt.scale if l_dec else 0
            rs = rt.scale if r_dec else 0
            s = max(ls, rs)
            a = _obj_ints(a) * (10 ** (s - ls))
            b = _obj_ints(b) * (10 ** (s - rs))
        else:
            ls = lt.scale if l_dec else 0
            rs = rt.scale if r_dec else 0
            s = max(ls, rs)
            a = a.astype(np.int64) * (10 ** (s - ls))
            b = b.astype(np.int64) * (10 ** (s - rs))
        return a, b, mask, False
    if a.dtype != b.dtype:
        out_t = dt.promote(lt, rt)
        phys = np.dtype(out_t.np_physical)
        a = a.astype(phys)
        b = b.astype(phys)
    return a, b, mask, False


def _nan_lt(a, b):
    if np.issubdtype(a.dtype, np.floating):
        a_nan = np.isnan(a)
        b_nan = np.isnan(b)
        return np.where(a_nan, False, np.where(b_nan, True, a < b))
    return a < b


def _nan_eq(a, b):
    if a.dtype != object and np.issubdtype(a.dtype, np.floating):
        return (np.isnan(a) & np.isnan(b)) | (a == b)
    return a == b


def _str_lt(a, b):
    # Python str compare is code-point order == UTF-8 byte order.
    return np.array([x < y for x, y in zip(a, b)], dtype=bool) \
        if len(a) else np.zeros(0, bool)


def _cmp(expr, table, kind):
    a, b, mask, is_str = _aligned_np(expr, table)
    if is_str:
        if kind == "eq":
            out = a == b
        elif kind == "lt":
            out = _str_lt(a, b)
        elif kind == "gt":
            out = _str_lt(b, a)
        elif kind == "le":
            out = ~_str_lt(b, a)
        else:
            out = ~_str_lt(a, b)
    else:
        if kind == "eq":
            out = _nan_eq(a, b)
        elif kind == "lt":
            out = _nan_lt(a, b)
        elif kind == "gt":
            out = _nan_lt(b, a)
        elif kind == "le":
            out = ~_nan_lt(b, a)
        else:
            out = ~_nan_lt(a, b)
    out = np.asarray(out, bool)
    return out & mask, mask


@_reg(P.EqualTo)
def _eq(e, t):
    return _cmp(e, t, "eq")


@_reg(P.LessThan)
def _lt(e, t):
    return _cmp(e, t, "lt")


@_reg(P.GreaterThan)
def _gt(e, t):
    return _cmp(e, t, "gt")


@_reg(P.LessThanOrEqual)
def _le(e, t):
    return _cmp(e, t, "le")


@_reg(P.GreaterThanOrEqual)
def _ge(e, t):
    return _cmp(e, t, "ge")


@_reg(P.EqualNullSafe)
def _eqns(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    lt = expr.children[0].data_type(table.schema())
    if lt == dt.STRING:
        eq = a == b
    else:
        eq = _nan_eq(a, b)
    out = (~am & ~bm) | (am & bm & np.asarray(eq, bool))
    return out, np.ones(table.num_rows, bool)


@_reg(P.And)
def _and(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev_reached(expr.children[1], table, ~(am & ~a))
    known_false = (am & ~a) | (bm & ~b)
    mask = (am & bm) | known_false
    return (a & b) & ~known_false & mask, mask


@_reg(P.Or)
def _or(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev_reached(expr.children[1], table, ~(am & a))
    known_true = (am & a) | (bm & b)
    mask = (am & bm) | known_true
    return (known_true | (a & b)) & mask, mask


@_reg(P.Not)
def _not(expr, table):
    a, m = _ev(expr.children[0], table)
    return (~a) & m, m


@_reg(P.IsNull)
def _isnull(expr, table):
    _, m = _ev(expr.children[0], table)
    return ~m, np.ones(table.num_rows, bool)


@_reg(P.IsNotNull)
def _isnotnull(expr, table):
    _, m = _ev(expr.children[0], table)
    return m, np.ones(table.num_rows, bool)


@_reg(P.IsNaN)
def _isnan(expr, table):
    a, m = _ev(expr.children[0], table)
    out = np.isnan(a.astype(np.float64)) if a.dtype != object else \
        np.zeros(len(a), bool)
    return out & m, m


@_reg(P.InSet)
def _inset(expr, table):
    a, m = _ev(expr.children[0], table)
    lt = expr.children[0].data_type(table.schema())
    vals = [v for v in expr.values if v is not None]
    if lt == dt.STRING:
        hit = np.isin(np.asarray(a, dtype=object), np.array(vals, object)) \
            if vals else np.zeros(len(a), bool)
    else:
        from ..expr.core import literal_physical as _to_physical
        phys = [_to_physical(v, lt) for v in vals]
        hit = np.isin(a, np.array(phys, a.dtype)) if phys else \
            np.zeros(len(a), bool)
    return hit & m, m


# ---------------------------------------------------------------------------
# conditionals
# ---------------------------------------------------------------------------

def _coerce_to(values, mask, from_t, to_t, n):
    """Cast already-evaluated lanes to the common output type."""
    if from_t == to_t:
        return values, mask
    if to_t == dt.STRING or from_t == dt.STRING:
        return values, mask
    if isinstance(to_t, dt.DecimalType):
        wide = to_t.is_wide or (isinstance(from_t, dt.DecimalType)
                                and from_t.is_wide)
        if wide:
            v = _obj_ints(values)
            fs = from_t.scale if isinstance(from_t, dt.DecimalType) else 0
            if to_t.scale >= fs:
                v = v * (10 ** (to_t.scale - fs))
            else:
                v = _half_up_obj(v, fs - to_t.scale)
            return v, mask
        if isinstance(from_t, dt.DecimalType):
            return _rescale_np(values.astype(np.int64), from_t.scale,
                               to_t.scale), mask
        return values.astype(np.int64) * np.int64(10 ** to_t.scale), mask
    return values.astype(np.dtype(to_t.np_physical)), mask


def _select_eval(expr, table, branches, default):
    """Shared CASE WHEN machinery: branches = [(cond_expr, value_expr)]."""
    schema = table.schema()
    out_t = expr.data_type(schema)
    n = table.num_rows
    if out_t == dt.STRING:
        out = np.full(n, "", dtype=object)
    elif isinstance(out_t, dt.DecimalType) and out_t.is_wide:
        out = np.zeros(n, dtype=object)
    else:
        out = np.zeros(n, np.dtype(out_t.np_physical))
    out_mask = np.zeros(n, bool)
    decided = np.zeros(n, bool)
    for cond_e, val_e in branches:
        cv, cm = _ev_reached(cond_e, table, ~decided)
        take = (~decided) & cm & cv
        v, m = _ev_reached(val_e, table, take)
        v, m = _coerce_to(v, m, val_e.data_type(schema), out_t, n)
        out = np.where(take, v, out)
        out_mask = np.where(take, m, out_mask)
        decided |= take
    if default is not None:
        v, m = _ev_reached(default, table, ~decided)
        v, m = _coerce_to(v, m, default.data_type(schema), out_t, n)
        out = np.where(~decided, v, out)
        out_mask = np.where(~decided, m, out_mask)
    return _zero_nulls(out, out_mask), out_mask


@_reg(Cond.If)
def _if(expr, table):
    pred, a, b = expr.children
    return _select_eval(expr, table, [(pred, a)], b)


@_reg(Cond.CaseWhen)
def _casewhen(expr, table):
    return _select_eval(expr, table, expr.branches, expr.otherwise)


@_reg(Cond.Coalesce)
def _coalesce(expr, table):
    schema = table.schema()
    out_t = expr.data_type(schema)
    n = table.num_rows
    if out_t == dt.STRING:
        out = np.full(n, "", dtype=object)
    elif isinstance(out_t, dt.DecimalType) and out_t.is_wide:
        out = np.zeros(n, dtype=object)
    else:
        out = np.zeros(n, np.dtype(out_t.np_physical))
    out_mask = np.zeros(n, bool)
    for c in expr.children:
        v, m = _ev_reached(c, table, ~out_mask)
        v, m = _coerce_to(v, m, c.data_type(schema), out_t, n)
        take = (~out_mask) & m
        out = np.where(take, v, out)
        out_mask |= take
    return _zero_nulls(out, out_mask), out_mask


@_reg(Cond.Nvl)
def _nvl(expr, table):
    return _coalesce(expr, table)


@_reg(Cond.NullIf)
def _nullif(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    lt = expr.children[0].data_type(table.schema())
    eq = (a == b) if lt == dt.STRING else _nan_eq(a, b)
    mask = am & ~(am & bm & np.asarray(eq, bool))
    return _zero_nulls(a, mask), mask


@_reg(Cond.Nvl2)
def _nvl2(expr, table):
    from ..expr.predicates import IsNotNull
    x, a, b = expr.children
    return _select_eval(expr, table, [(IsNotNull(x), a)], b)


# --- timezone conversions (independent per-row zoneinfo oracle) -----------

def _tz_oracle(name: str):
    import datetime
    import zoneinfo
    from ..expr.timezone import fixed_offset_us
    fixed = fixed_offset_us(name)
    if fixed is not None:
        return datetime.timezone(
            datetime.timedelta(microseconds=fixed))
    return zoneinfo.ZoneInfo(name)


def _utc_offset_us(tz, us: int) -> int:
    import datetime
    from ..expr import timezone as TZX
    # clamp to the device transition tables' probe horizon (1800..2200):
    # past it the device freezes on the last known offset, so the oracle
    # asks zoneinfo for the horizon instant instead of the raw one
    lo = int((TZX._PROBE_START - TZX._EPOCH).total_seconds()) * 1_000_000
    hi = int((TZX._PROBE_END - TZX._EPOCH).total_seconds()) * 1_000_000 - 1
    us = max(lo, min(int(us), hi))
    inst = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc) + \
        datetime.timedelta(microseconds=us)
    return int(inst.astimezone(tz).utcoffset().total_seconds()) * 1_000_000


def _reg_tz():
    from ..expr import timezone as TZX

    @_reg(TZX.FromUTCTimestamp)
    def _from_utc(expr, table):
        a, m = _ev(expr.children[0], table)
        tz = _tz_oracle(expr.zone)
        out = np.array([int(v) + _utc_offset_us(tz, v) if mk else 0
                        for v, mk in zip(a, m)], np.int64)
        return out, m

    @_reg(TZX.ToUTCTimestamp)
    def _to_utc(expr, table):
        # mirror the device's two-step offset resolution, but with
        # per-row zoneinfo lookups (independent of the transition-table
        # builder the device uses)
        a, m = _ev(expr.children[0], table)
        tz = _tz_oracle(expr.zone)
        out = np.zeros(len(a), np.int64)
        for i, (v, mk) in enumerate(zip(a, m)):
            if not mk:
                continue
            o1 = _utc_offset_us(tz, v)
            o2 = _utc_offset_us(tz, int(v) - o1)
            out[i] = int(v) - o2
        return out, m


_reg_tz()


# --- JSON (independent sequential span walker as the oracle for the
# device byte-scan kernel; same raw-span envelope, see expr/json.py) --------

def _json_skip_ws(s, i):
    while i < len(s) and s[i] in " \t\n\r":
        i += 1
    return i


def _json_value_end(s, i):
    """End index (exclusive) of the JSON value starting at i."""
    import json
    if i >= len(s):
        return None
    c = s[i]
    if c == '"':
        j = i + 1
        while j < len(s):
            if s[j] == "\\":
                j += 2
                continue
            if s[j] == '"':
                return j + 1
            j += 1
        return None
    if c in "{[":
        depth = 0
        j = i
        in_str = False
        while j < len(s):
            ch = s[j]
            if in_str:
                if ch == "\\":
                    j += 2
                    continue
                if ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
                if depth == 0:
                    return j + 1
            j += 1
        return None
    j = i
    while j < len(s) and s[j] not in ",}] \t\n\r":
        j += 1
    # a zero-length "scalar" means the cursor sat on a delimiter —
    # malformed JSON (e.g. '{"k": ]}'), not an empty value; fuzz lane
    # caught the '' vs null divergence vs the device scanner
    return j if j > i else None


def _json_get_path(s, segments):
    """Raw span of the value at the path; None when missing/invalid."""
    import json
    i = _json_skip_ws(s, 0)
    end = _json_value_end(s, i)
    if end is None:
        return None
    for kind, arg in segments:
        i = _json_skip_ws(s, i)
        if kind == "key":
            if i >= len(s) or s[i] != "{":
                return None
            j = i + 1
            found = None
            while True:
                j = _json_skip_ws(s, j)
                if j >= len(s) or s[j] == "}":
                    break
                ke = _json_value_end(s, j)
                if ke is None:
                    return None
                try:
                    key = json.loads(s[j:ke])
                except ValueError:
                    return None
                j = _json_skip_ws(s, ke)
                if j >= len(s) or s[j] != ":":
                    return None
                j = _json_skip_ws(s, j + 1)
                ve = _json_value_end(s, j)
                if ve is None:
                    return None
                if key == arg:
                    found = (j, ve)
                    break
                j = _json_skip_ws(s, ve)
                if j < len(s) and s[j] == ",":
                    j += 1
            if found is None:
                return None
            i, end = found
        else:
            if i >= len(s) or s[i] != "[":
                return None
            j = _json_skip_ws(s, i + 1)
            n = 0
            found = None
            while j < len(s) and s[j] != "]":
                ve = _json_value_end(s, j)
                if ve is None:
                    return None
                if n == arg:
                    found = (j, ve)
                    break
                n += 1
                j = _json_skip_ws(s, ve)
                if j < len(s) and s[j] == ",":
                    j = _json_skip_ws(s, j + 1)
            if found is None:
                return None
            i, end = found
    span = s[i:end]
    if span == "null":
        return None
    if span.startswith('"'):
        # manual simple-escape decode matching the device kernel
        # (\uXXXX passes through un-decoded on both engines)
        body = span[1:-1]
        out = []
        k = 0
        esc_map = {'"': '"', "\\": "\\", "/": "/", "n": "\n",
                   "t": "\t", "r": "\r", "b": "\b", "f": "\f"}
        while k < len(body):
            c = body[k]
            if c == "\\" and k + 1 < len(body) and \
                    body[k + 1] in esc_map:
                out.append(esc_map[body[k + 1]])
                k += 2
                continue
            out.append(c)
            k += 1
        return "".join(out)
    return span


def _reg_json():
    from ..expr import json as JX

    @_reg(JX.GetJsonObject)
    def _gjo(expr, table):
        a, m = _ev(expr.children[0], table)
        out = np.empty(len(a), dtype=object)
        mask = np.zeros(len(a), bool)
        for i, (s, mk) in enumerate(zip(a, m)):
            v = _json_get_path(s, expr.segments) if mk else None
            out[i] = v if v is not None else ""
            mask[i] = mk and v is not None
        return out, mask

    @_reg(JX.JsonToStructs)
    def _from_json(expr, table):
        import json
        a, m = _ev(expr.children[0], table)
        out = np.empty(len(a), dtype=object)
        mask = np.zeros(len(a), bool)
        fields = expr.struct_schema.fields
        for i, (s, mk) in enumerate(zip(a, m)):
            if not mk:
                continue
            try:
                obj = json.loads(s)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            out[i] = {n: _json_coerce(obj.get(n), t) for n, t in fields}
            mask[i] = True
        return out, mask

    @_reg(JX.StructsToJson)
    def _to_json(expr, table):
        import json
        a, m = _ev(expr.children[0], table)
        out = np.empty(len(a), dtype=object)
        for i, (v, mk) in enumerate(zip(a, m)):
            out[i] = json.dumps(v, separators=(",", ":"),
                                default=str) if mk else ""
        return out, m


def _json_coerce(v, t):
    if v is None:
        return None
    try:
        if t == dt.STRING:
            return v if isinstance(v, str) else                 __import__("json").dumps(v, separators=(",", ":"))
        if t.is_integral:
            return int(v)
        if t.is_floating:
            return float(v)
        if isinstance(t, dt.BooleanType):
            return bool(v)
        if isinstance(t, dt.DecimalType):
            from decimal import ROUND_HALF_UP, Decimal
            d = Decimal(str(v)).quantize(Decimal(1).scaleb(-t.scale),
                                         rounding=ROUND_HALF_UP)
            # overflow past the declared precision -> null (Spark)
            if abs(d) >= Decimal(1).scaleb(t.precision - t.scale):
                return None
            return d
        if isinstance(t, dt.DateType):
            import datetime
            return datetime.date.fromisoformat(v)
        if isinstance(t, dt.TimestampType):
            import datetime
            return datetime.datetime.fromisoformat(v)
        if isinstance(t, dt.ArrayType):
            return [_json_coerce(x, t.element_type) for x in v]
        if isinstance(t, dt.StructType):
            return {n: _json_coerce(v.get(n), ft) for n, ft in t.fields}
    except (TypeError, ValueError, ArithmeticError):
        return None
    return None


_reg_json()


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _unary_double(fn):
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        with np.errstate(all="ignore"):
            out = fn(a.astype(np.float64))
        return _zero_nulls(out, m), m
    return ev


_MATH_FNS = {
    M.Sqrt: np.sqrt, M.Cbrt: np.cbrt, M.Exp: np.exp, M.Expm1: np.expm1,
    M.Sin: np.sin, M.Cos: np.cos, M.Tan: np.tan,
    M.Asin: np.arcsin, M.Acos: np.arccos, M.Atan: np.arctan,
    M.Sinh: np.sinh, M.Cosh: np.cosh, M.Tanh: np.tanh,
    M.Asinh: np.arcsinh, M.Acosh: np.arccosh, M.Atanh: np.arctanh,
    M.ToDegrees: np.degrees, M.ToRadians: np.radians,
    M.Signum: np.sign, M.Rint: np.rint,
}
for _cls, _fn in _MATH_FNS.items():
    _EVALUATORS[_cls] = _unary_double(_fn)


def _log_like(np_fn, shift: float = 0.0):
    """Spark log-family: non-positive input (after ``shift``: log1p's
    x <= -1) -> null."""
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        x = a.astype(np.float64) + shift
        mask = m & (x > 0)
        with np.errstate(all="ignore"):
            out = np_fn(np.where(x > 0, x, 1.0))
        return _zero_nulls(out, mask), mask
    return ev


_EVALUATORS[M.Log] = _log_like(np.log)
_EVALUATORS[M.Log1p] = _log_like(lambda x: np.log1p(x - 1.0), shift=1.0)
_EVALUATORS[M.Log2] = _log_like(np.log2)
_EVALUATORS[M.Log10] = _log_like(np.log10)


def _to_long(x):
    """Scala's Double.toLong: NaN -> 0, out of range saturates."""
    info = np.iinfo(np.int64)
    with np.errstate(invalid="ignore"):
        out = np.where(np.isnan(x), 0.0, x)
        big, small = out >= float(info.max), out <= float(info.min)
        out = np.where(big | small, 0.0, out).astype(np.int64)
    return np.where(big, info.max, np.where(small, info.min, out))


@_reg(M.Floor)
def _floor(expr, table):
    a, m = _ev(expr.children[0], table)
    t = expr.children[0].data_type(table.schema())
    if isinstance(t, dt.DecimalType):
        if a.dtype == object:
            out = np.array([int(v) // 10 ** t.scale for v in a], np.int64)
        else:
            out = a.astype(np.int64) // np.int64(10 ** t.scale)
        return _zero_nulls(out, m), m
    return _zero_nulls(_to_long(np.floor(a.astype(np.float64))), m), m


@_reg(M.Ceil)
def _ceil(expr, table):
    a, m = _ev(expr.children[0], table)
    t = expr.children[0].data_type(table.schema())
    if isinstance(t, dt.DecimalType):
        if a.dtype == object:
            out = np.array([-((-int(v)) // 10 ** t.scale) for v in a],
                           np.int64)
        else:
            out = -((-a.astype(np.int64)) // np.int64(10 ** t.scale))
        return _zero_nulls(out, m), m
    return _zero_nulls(_to_long(np.ceil(a.astype(np.float64))), m), m


@_reg(M.Pow)
def _pow(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    with np.errstate(all="ignore"):
        out = np.power(a.astype(np.float64), b.astype(np.float64))
    return _zero_nulls(out, m), m


@_reg(M.Atan2)
def _atan2(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    out = np.arctan2(a.astype(np.float64), b.astype(np.float64))
    return _zero_nulls(out, m), m


@_reg(M.Hypot)
def _hypot(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    out = np.hypot(a.astype(np.float64), b.astype(np.float64))
    return _zero_nulls(out, m), m


def _round_float_np(x, scale: int, half_even: bool):
    """The device's float rounding (expr/mathfns.py ``_round_float``),
    operation for operation in float64."""
    with np.errstate(all="ignore"):
        xd = x.astype(np.float64)
        ax = np.abs(xd)
        if scale >= 0:
            p = 10.0 ** scale
            y = ax * p
            q = np.floor(y)
            mid = (q + 0.5) / p
        else:
            p = 10.0 ** -scale
            y = ax / p
            q = np.floor(y)
            mid = (q + 0.5) * p
        if half_even:
            up = (ax > mid) | ((ax == mid) & (np.remainder(q, 2.0) == 1.0))
        else:
            up = ax >= mid
        q = q + up
        r = q / p if scale >= 0 else q * p
        r = np.where(r == 0, 0.0, np.where(xd < 0, -r, r))
        keep = ~np.isfinite(xd) | (y >= float(1 << 52))
        return np.where(keep, xd, r).astype(x.dtype)


def _round_int(v: int, drop: int, half_even: bool) -> int:
    """|v| / 10^drop rounded HALF_UP or HALF_EVEN, sign restored."""
    p = 10 ** drop
    q, rem = divmod(abs(v), p)
    half = p // 2
    if rem > half or (rem == half and (not half_even or q % 2 == 1)):
        q += 1
    return -q if v < 0 else q


def _round_common(expr, table, half_even: bool):
    a, m = _ev(expr.children[0], table)
    t = expr.children[0].data_type(table.schema())
    scale = expr.scale
    if isinstance(t, dt.DecimalType):
        # the device's _decimal_round: drop digits, then lift to the
        # result's scale; null past its precision
        out_t = expr.data_type(table.schema())
        drop = t.scale - min(scale, t.scale)
        lift = out_t.scale - (t.scale - max(drop, 0))
        bound = 10 ** out_t.precision
        vals = [_round_int(int(v), drop, half_even) * 10 ** lift
                if drop > 0 else int(v) * 10 ** lift for v in a]
        m = m & np.array([abs(v) < bound for v in vals], bool)
        vals = [v if ok else 0 for v, ok in zip(vals, m)]
        out = np.array(vals, dtype=object) if out_t.is_wide else \
            np.array(vals, dtype=np.int64)
        return out, m
    if t.is_integral:
        if scale >= 0:
            return a, m
        bits = 8 * a.dtype.itemsize
        out = np.array([_wrap(_round_int(int(v), -scale, half_even)
                              * 10 ** -scale, bits) for v in a],
                       dtype=a.dtype)
        return _zero_nulls(out, m), m
    return _zero_nulls(_round_float_np(a, scale, half_even), m), m


@_reg(M.Round)
def _round(expr, table):
    return _round_common(expr, table, half_even=False)


@_reg(M.BRound)
def _bround(expr, table):
    return _round_common(expr, table, half_even=True)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def _str_map(fn):
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        out = np.array([fn(x) for x in a], dtype=object) if len(a) else \
            np.empty(0, object)
        return np.where(m, out, ""), m
    return ev


_UPPER = {c: c - 32 for c in range(ord("a"), ord("z") + 1)}
_LOWER = {c: c + 32 for c in range(ord("A"), ord("Z") + 1)}


@_reg(S.Length)
def _length(expr, table):
    a, m = _ev(expr.children[0], table)
    out = np.array([len(x) for x in a], dtype=np.int32) if len(a) else \
        np.empty(0, np.int32)
    return _zero_nulls(out, m), m


@_reg(S.OctetLength)
def _octet_length(expr, table):
    a, m = _ev(expr.children[0], table)
    out = np.array([len(x.encode("utf-8")) for x in a], dtype=np.int32) \
        if len(a) else np.empty(0, np.int32)
    return _zero_nulls(out, m), m


# ASCII letters only, as on the device (expr/strings.py _CaseMap)
_EVALUATORS[S.Upper] = _str_map(lambda s: s.translate(_UPPER))
_EVALUATORS[S.Lower] = _str_map(lambda s: s.translate(_LOWER))


@_reg(S.Substring)
def _substring(expr, table):
    a, m = _ev(expr.children[0], table)
    pos, length = expr.pos, expr.length
    def sub(s):
        # Spark 1-based substring semantics
        if pos > 0:
            start = pos - 1
        elif pos == 0:
            start = 0
        else:
            start = max(len(s) + pos, 0)
        end = min(start + length, len(s))
        return s[start:end]
    out = np.array([sub(x) for x in a], dtype=object) if len(a) else \
        np.empty(0, object)
    return np.where(m, out, ""), m


@_reg(S.Concat)
def _concat(expr, table):
    n = table.num_rows
    parts = [_ev(c, table) for c in expr.children]
    mask = np.ones(n, bool)
    for _, m in parts:
        mask &= m
    out = np.array(["".join(p[0][i] for p in parts) for i in range(n)],
                   dtype=object) if n else np.empty(0, object)
    return np.where(mask, out, ""), mask


def _str_static_predicate(attr, fn):
    # StartsWith/EndsWith/Contains carry a static pattern string
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        p = getattr(expr, attr)
        out = np.array([fn(x, p) for x in a], dtype=bool) \
            if len(a) else np.empty(0, bool)
        return out & m, m
    return ev


_EVALUATORS[S.StartsWith] = _str_static_predicate(
    "prefix", lambda s, p: s.startswith(p))
_EVALUATORS[S.EndsWith] = _str_static_predicate(
    "suffix", lambda s, p: s.endswith(p))
_EVALUATORS[S.Contains] = _str_static_predicate(
    "needle", lambda s, p: p in s)


@_reg(S.Like)
def _like(expr, table):
    import re
    a, m = _ev(expr.children[0], table)
    pat = expr.pattern
    esc = expr.escape
    regex = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == esc and i + 1 < len(pat):
            regex.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if ch == "%":
            regex.append(".*")
        elif ch == "_":
            regex.append(".")
        else:
            regex.append(re.escape(ch))
        i += 1
    prog = re.compile("(?s)^" + "".join(regex) + "$")
    out = np.array([prog.match(x) is not None for x in a], dtype=bool) \
        if len(a) else np.empty(0, bool)
    return out & m, m


def _trim_eval(which):
    # the device trims only ASCII space (byte 32); mirror exactly.
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        def trim(s):
            if which == "both":
                return s.strip(" ")
            if which == "left":
                return s.lstrip(" ")
            return s.rstrip(" ")
        out = np.array([trim(x) for x in a], dtype=object) if len(a) else \
            np.empty(0, object)
        return np.where(m, out, ""), m
    return ev


_EVALUATORS[S.StringTrim] = _trim_eval("both")
_EVALUATORS[S.StringTrimLeft] = _trim_eval("left")
_EVALUATORS[S.StringTrimRight] = _trim_eval("right")


# ---------------------------------------------------------------------------
# datetime (lanes: date = int32 days since epoch, ts = int64 micros UTC)
# ---------------------------------------------------------------------------

_EPOCH = np.datetime64("1970-01-01", "D")


def _days_to_ymd(days):
    d = _EPOCH + days.astype("timedelta64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month = (d.astype("datetime64[M]").astype(np.int64) % 12) + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return y, month, day


def _date_field(fn):
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        t = expr.children[0].data_type(table.schema())
        days = a.astype(np.int64)
        if isinstance(t, dt.TimestampType):
            days = np.floor_divide(days, 86_400_000_000)
        y, mo, dnum = _days_to_ymd(days)
        out = fn(days, y, mo, dnum).astype(np.int32)
        return _zero_nulls(out, m), m
    return ev


_EVALUATORS[D.Year] = _date_field(lambda d, y, mo, dd: y)
_EVALUATORS[D.Month] = _date_field(lambda d, y, mo, dd: mo)
_EVALUATORS[D.DayOfMonth] = _date_field(lambda d, y, mo, dd: dd)
_EVALUATORS[D.Quarter] = _date_field(lambda d, y, mo, dd: (mo - 1) // 3 + 1)
# Spark dayofweek: 1 = Sunday. Epoch (1970-01-01) was a Thursday.
_EVALUATORS[D.DayOfWeek] = _date_field(
    lambda d, y, mo, dd: ((d + 4) % 7) + 1)
# weekday(): 0 = Monday
_EVALUATORS[D.WeekDay] = _date_field(lambda d, y, mo, dd: (d + 3) % 7)
_EVALUATORS[D.DayOfYear] = _date_field(
    lambda d, y, mo, dd: d - (
        (_EPOCH + d.astype("timedelta64[D]")).astype("datetime64[Y]")
        - _EPOCH).astype(np.int64) + 1)


@_reg(D.LastDay)
def _lastday(expr, table):
    a, m = _ev(expr.children[0], table)
    d = _EPOCH + a.astype(np.int64).astype("timedelta64[D]")
    month_start = d.astype("datetime64[M]")
    next_month = month_start + np.timedelta64(1, "M")
    out = (next_month.astype("datetime64[D]") - np.timedelta64(1, "D")
           - _EPOCH).astype(np.int32)
    return _zero_nulls(out, m), m


def _time_field(fn):
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        micros = a.astype(np.int64)
        secs = np.floor_divide(micros, 1_000_000)
        out = fn(secs).astype(np.int32)
        return _zero_nulls(out, m), m
    return ev


_EVALUATORS[D.Hour] = _time_field(lambda s: (s % 86400) // 3600)
_EVALUATORS[D.Minute] = _time_field(lambda s: (s % 3600) // 60)
_EVALUATORS[D.Second] = _time_field(lambda s: s % 60)


@_reg(D.DateAdd)
def _dateadd(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    return _zero_nulls((a.astype(np.int64) + b.astype(np.int64))
                       .astype(np.int32), m), m


@_reg(D.DateSub)
def _datesub(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    return _zero_nulls((a.astype(np.int64) - b.astype(np.int64))
                       .astype(np.int32), m), m


@_reg(D.DateDiff)
def _datediff(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    return _zero_nulls((a.astype(np.int64) - b.astype(np.int64))
                       .astype(np.int32), m), m


@_reg(D.AddMonths)
def _addmonths(expr, table):
    a, am = _ev(expr.children[0], table)
    b, bm = _ev(expr.children[1], table)
    m = am & bm
    d = _EPOCH + a.astype(np.int64).astype("timedelta64[D]")
    month0 = d.astype("datetime64[M]")
    day_in_month = (d - month0).astype(np.int64)
    new_month = month0 + b.astype(np.int64).astype("timedelta64[M]")
    next_m = new_month + np.timedelta64(1, "M")
    month_len = (next_m.astype("datetime64[D]")
                 - new_month.astype("datetime64[D]")).astype(np.int64)
    day = np.minimum(day_in_month, month_len - 1)
    out = (new_month.astype("datetime64[D]") - _EPOCH).astype(np.int64) + day
    return _zero_nulls(out.astype(np.int32), m), m


@_reg(D.UnixTimestampToSeconds)
def _unixts(expr, table):
    a, m = _ev(expr.children[0], table)
    out = np.floor_divide(a.astype(np.int64), 1_000_000)
    return _zero_nulls(out, m), m


@_reg(D.FromUnixTime)
def _fromunix(expr, table):
    a, m = _ev(expr.children[0], table)
    out = a.astype(np.int64) * 1_000_000
    return _zero_nulls(out, m), m


@_reg(D.MakeDate)
def _makedate(expr, table):
    y, ym = _ev(expr.children[0], table)
    mo, mm = _ev(expr.children[1], table)
    d, dm = _ev(expr.children[2], table)
    m = ym & mm & dm
    out = np.zeros(len(y), np.int32)
    ok = np.ones(len(y), bool)
    for i in range(len(y)):
        if not m[i]:
            continue
        try:
            import datetime
            out[i] = (datetime.date(int(y[i]), int(mo[i]), int(d[i]))
                      - datetime.date(1970, 1, 1)).days
        except ValueError:
            ok[i] = False
    m = m & ok
    return _zero_nulls(out, m), m


# ---------------------------------------------------------------------------
# cast
# ---------------------------------------------------------------------------

@_reg(C.Cast)
def _cast(expr, table):
    a, m = _ev(expr.children[0], table)
    out, om = _cast_values(expr, table, a, m)
    if expr.ansi:
        _ansi_cast_raise(expr, table, a, m, om)
    return out, om


def _ansi_cast_raise(expr, table, a, m, om) -> None:
    """ANSI cast errors, as the device's ``ansi_check``: a row the cast
    made null raises, and so does a source value past an integral
    target's range (the lanes that wrap or saturate)."""
    from ..expr import errors as ERR
    from_t = expr.children[0].data_type(table.schema())
    to_t = expr.to
    if from_t == to_t:
        return
    if from_t == dt.STRING:
        exc_t = ERR.SparkDateTimeException if to_t in (dt.DATE,
                                                       dt.TIMESTAMP) \
            else ERR.SparkNumberFormatException
        _ansi_raise_if(m & ~om, exc_t(f"invalid input syntax for type "
                                      f"{to_t} (ANSI mode cast)"), table)
        return
    target = f"DecimalType(precision={to_t.precision}, " \
        f"scale={to_t.scale})" if dt.is_decimal(to_t) else str(to_t)
    _ansi_raise_if(m & ~om, ERR.SparkCastOverflowException(
        f"cast to {target} causes overflow (ANSI mode)"), table)
    if not to_t.is_integral:
        return
    exc = ERR.SparkCastOverflowException(
        f"casting {from_t} to {to_t} causes overflow (ANSI mode)")
    lo, hi = dt.min_value(to_t), dt.max_value(to_t)
    if isinstance(from_t, dt.DecimalType):
        p = 10 ** from_t.scale
        bad = np.array([not lo <= (abs(int(v)) // p) * (1 if int(v) >= 0
                                                        else -1) <= hi
                        for v in a], bool)
    elif from_t.is_floating:
        x = a.astype(np.float64)
        with np.errstate(invalid="ignore"):
            bad = np.isnan(x) | (x < float(lo)) | (x >= float(hi) + 1.0)
    elif from_t.is_integral:
        x = a.astype(np.int64)
        bad = (x < lo) | (x > hi)
    else:
        return
    _ansi_raise_if(m & bad, exc, table)


def _cast_values(expr, table, a, m):
    schema = table.schema()
    from_t = expr.children[0].data_type(schema)
    to_t = expr.to
    n = table.num_rows
    if from_t == to_t:
        return a, m
    # string -> X
    if from_t == dt.STRING:
        if to_t == dt.STRING:
            return a, m
        out = np.zeros(n, np.dtype(to_t.np_physical))
        ok = np.zeros(n, bool)
        for i in range(n):
            if not m[i]:
                continue
            s = str(a[i]).strip()
            try:
                if isinstance(to_t, dt.DecimalType):
                    import decimal
                    out[i] = int(decimal.Decimal(s)
                                 .scaleb(to_t.scale).to_integral_value())
                elif to_t.is_floating:
                    # Cast.processFloatingPointSpecialLiterals: signed
                    # inf/infinity + unsigned nan, case-insensitive;
                    # python float() would reject 'Infinity'? (it
                    # accepts 'inf'/'infinity'/'nan' — normalize anyway
                    # so both engines share one rule)
                    sl = s.lower()
                    if sl in ("inf", "+inf", "infinity", "+infinity"):
                        out[i] = np.inf
                    elif sl in ("-inf", "-infinity"):
                        out[i] = -np.inf
                    elif sl == "nan":
                        out[i] = np.nan
                    elif sl in ("+nan", "-nan"):
                        raise ValueError(s)  # Spark: nan takes no sign
                    else:
                        out[i] = float(s)
                elif to_t == dt.BOOL:
                    sl = s.lower()
                    if sl in ("t", "true", "y", "yes", "1"):
                        out[i] = True
                    elif sl in ("f", "false", "n", "no", "0"):
                        out[i] = False
                    else:
                        raise ValueError(s)
                elif to_t == dt.DATE:
                    out[i] = _spark_string_to_date(s)
                else:
                    # UTF8String.toLong semantics, mirrored exactly
                    # with the device _parse_int: optional sign, ASCII
                    # digits, one optional '.' with an all-digit
                    # fraction that TRUNCATES (no float round-trip —
                    # '1.9999999999999999' is 1, not 2); scientific
                    # notation is invalid
                    body = s
                    sign = 1
                    if body[:1] in ("+", "-"):
                        sign = -1 if body[0] == "-" else 1
                        body = body[1:]
                    intpart, _, frac = body.partition(".")
                    if not intpart or \
                            not all("0" <= ch <= "9" for ch in intpart) \
                            or not all("0" <= ch <= "9" for ch in frac):
                        raise ValueError(s)
                    iv = sign * int(intpart)
                    info = np.iinfo(np.dtype(to_t.np_physical))
                    if not info.min <= iv <= info.max:
                        raise ValueError(s)  # out of range -> null
                    out[i] = iv
                ok[i] = True
            except (ValueError, ArithmeticError):
                ok[i] = False
        m = m & ok
        return _zero_nulls(out, m), m
    # X -> string
    if to_t == dt.STRING:
        out = np.empty(n, object)
        for i in range(n):
            out[i] = _value_to_string(a[i], from_t) if m[i] else ""
        return out, m
    # decimal source (exact python-int lanes; HALF_UP rescale, matching
    # the device decimal128 path and GpuCast decimal semantics)
    if isinstance(from_t, dt.DecimalType):
        av = _obj_ints(a)
        if isinstance(to_t, dt.DecimalType):
            if to_t.scale >= from_t.scale:
                out = av * (10 ** (to_t.scale - from_t.scale))
            else:
                out = _half_up_obj(av, from_t.scale - to_t.scale)
            bound = 10 ** to_t.precision
            ok = np.array([abs(int(v)) < bound and abs(int(v)) < _I128_MAX
                           for v in out], bool)
            m = m & ok
            out = np.where(m, out, 0)
            if not to_t.is_wide:
                out = np.array([int(v) for v in out], dtype=np.int64)
            return out, m
        if to_t.is_floating:
            real = np.array([float(int(v)) for v in av]) / \
                (10.0 ** from_t.scale)
            return _zero_nulls(real.astype(np.dtype(to_t.np_physical)), m), m
        if to_t == dt.BOOL:
            return _zero_nulls(
                np.array([int(v) != 0 for v in av], bool), m), m
        # integral target: truncate toward zero and wrap to the target's
        # width, as Spark's Decimal.toLong does (ROADMAP C15)
        p = 10 ** from_t.scale
        bits = 8 * np.dtype(to_t.np_physical).itemsize
        out = np.array([_wrap(abs(int(v)) // p * (1 if int(v) >= 0
                                                   else -1), bits)
                        for v in av], dtype=np.dtype(to_t.np_physical))
        return _zero_nulls(out, m), m
    # numeric -> decimal
    if isinstance(to_t, dt.DecimalType):
        bound = 10 ** to_t.precision
        if from_t.is_floating:
            scaled = a.astype(np.float64) * 10.0 ** to_t.scale
            ok = np.isfinite(scaled) & (np.abs(scaled) < float(bound))
            safe = np.where(ok, scaled, 0.0)
            vals = [int(np.sign(x)) * int(np.floor(abs(x) + 0.5))
                    for x in safe]
        else:
            vals = [int(x) * 10 ** to_t.scale for x in a]
            ok = np.array([abs(v) < bound for v in vals], bool)
            vals = [v if k else 0 for v, k in zip(vals, ok)]
        m = m & ok
        if to_t.is_wide:
            return np.array(vals, dtype=object), m
        out = np.array([int(v) for v in vals], dtype=np.int64)
        return _zero_nulls(out, m), m
    # timestamp <-> integral: whole seconds (floored)
    if from_t == dt.TIMESTAMP and to_t.is_integral:
        out = np.floor_divide(a.astype(np.int64), 1_000_000)
        return _zero_nulls(out.astype(np.dtype(to_t.np_physical)), m), m
    if from_t.is_integral and to_t == dt.TIMESTAMP:
        with np.errstate(over="ignore"):
            out = a.astype(np.int64) * np.int64(1_000_000)
        return _zero_nulls(out, m), m
    # timestamp <-> date
    if from_t == dt.TIMESTAMP and to_t == dt.DATE:
        out = np.floor_divide(a.astype(np.int64),
                              86_400_000_000).astype(np.int32)
        return _zero_nulls(out, m), m
    if from_t == dt.DATE and to_t == dt.TIMESTAMP:
        out = a.astype(np.int64) * 86_400_000_000
        return _zero_nulls(out, m), m
    # numeric <-> numeric / bool
    phys = np.dtype(to_t.np_physical)
    if from_t.is_floating and not (to_t.is_floating or to_t == dt.BOOL):
        # Scala Double.toLong semantics: NaN -> 0, out-of-range
        # saturates (np.trunc(...).astype alone is UB for both)
        info = np.iinfo(phys)
        with np.errstate(invalid="ignore"):
            x = np.where(np.isnan(a), 0.0, a)
            t = np.trunc(x)
            out = np.clip(t, float(info.min), float(info.max))
            out = out.astype(phys)
            # float64(int64.max) rounds UP to 2^63: clip leaves 2^63
            # which astype wraps — pin explicitly
            out = np.where(t >= float(info.max), info.max, out)
            out = np.where(t <= float(info.min), info.min, out)
        return _zero_nulls(out.astype(phys), m), m
    with np.errstate(over="ignore"):
        out = a.astype(phys)
    return _zero_nulls(out, m), m


def _wrap(v: int, bits: int) -> int:
    """``v`` wrapped to a two's complement integer of ``bits`` bits."""
    half = 1 << (bits - 1)
    return (v + half) % (1 << bits) - half


def _value_to_string(v, from_t) -> str:
    if isinstance(from_t, dt.BooleanType):
        return "true" if v else "false"
    if isinstance(from_t, dt.DecimalType):
        # plain notation at 80 digits, as the device writes it
        from ..columnar.vector import decimal_value
        return format(decimal_value(int(v), from_t.scale), "f")
    if isinstance(from_t, dt.DateType):
        import datetime
        return str(datetime.date(1970, 1, 1)
                   + datetime.timedelta(days=int(v)))
    if isinstance(from_t, dt.TimestampType):
        import datetime
        ts = (datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
              + datetime.timedelta(microseconds=int(v)))
        return ts.strftime("%Y-%m-%d %H:%M:%S") + (
            f".{ts.microsecond:06d}".rstrip("0")
            if ts.microsecond else "")
    if from_t.is_floating:
        f = float(v)
        if f != f or f in (float("inf"), float("-inf")):
            return {"inf": "Infinity", "-inf": "-Infinity"}.get(
                str(f), "NaN")
        if f == int(f) and abs(f) < 1e16:
            return f"{f:.1f}"
        return repr(f)
    return str(int(v))


# ---------------------------------------------------------------------------
# extended strings + regex (CPU side uses python re — the "CPU Spark"
# engine the device result is held against)
# ---------------------------------------------------------------------------

_EVALUATORS[S.Reverse] = _str_map(lambda s: s[::-1])


def _pad_eval(left: bool):
    def ev(expr, table):
        a, m = _ev(expr.children[0], table)
        tgt = expr.length
        pad = expr.pad
        def one(s):
            if len(s) >= tgt:
                return s[:tgt]
            fill = (pad * tgt)[: tgt - len(s)]
            return fill + s if left else s + fill
        out = np.array([one(x) for x in a], dtype=object) if len(a) else \
            np.empty(0, object)
        return np.where(m, out, ""), m
    return ev


_EVALUATORS[S.Lpad] = _pad_eval(True)
_EVALUATORS[S.Rpad] = _pad_eval(False)


def _initcap(s: str) -> str:
    out = []
    prev_space = True
    for ch in s:
        if prev_space and "a" <= ch <= "z":
            out.append(ch.upper())
        elif not prev_space and "A" <= ch <= "Z":
            out.append(ch.lower())
        else:
            out.append(ch)
        prev_space = ch == " "
    return "".join(out)


_EVALUATORS[S.InitCap] = _str_map(_initcap)


@_reg(S.ConcatWs)
def _concat_ws(expr, table):
    n = table.num_rows
    schema = table.schema()
    parts = []
    for c in expr.children:
        v, m = _ev(c, table)
        t = c.data_type(schema)
        if t != dt.STRING:
            # mirror the device's cast_column lowering, not python str()
            v = np.array([_value_to_string(x, t) for x in v], dtype=object)
        parts.append((v, m))
    out = []
    for i in range(n):
        vals = [p[0][i] for p in parts if p[1][i]]
        out.append(expr.sep.join(vals))
    return (np.array(out, dtype=object) if n else np.empty(0, object),
            np.ones(n, bool))


@_reg(S.StringLocate)
def _locate(expr, table):
    a, m = _ev(expr.children[0], table)
    sub = expr.substr
    start = max(expr.start - 1, 0)
    def one(s):
        if expr.start <= 0:
            return 0  # Spark: locate with start 0 is always 0
        if sub == "":
            return expr.start if expr.start <= len(s) + 1 else 0
        p = s.find(sub, start)
        return p + 1
    out = np.array([one(x) for x in a], dtype=np.int32) if len(a) else \
        np.empty(0, np.int32)
    return _zero_nulls(out, m), m


@_reg(S.StringRepeat)
def _repeat(expr, table):
    a, m = _ev(expr.children[0], table)
    out = np.array([x * expr.n for x in a], dtype=object) if len(a) else \
        np.empty(0, object)
    return np.where(m, out, ""), m


@_reg(S.StringReplace)
def _replace(expr, table):
    a, m = _ev(expr.children[0], table)
    search, repl = expr.search, expr.replace
    out = np.array([x.replace(search, repl) for x in a], dtype=object) \
        if len(a) else np.empty(0, object)
    return np.where(m, out, ""), m


@_reg(S.StringTranslate)
def _translate(expr, table):
    a, m = _ev(expr.children[0], table)
    tbl = expr.table
    dele = expr.delete
    def one(s):
        bs = s.encode("utf-8")
        return bytes(tbl[b] for b in bs if not dele[b]).decode(
            "utf-8", errors="replace")
    out = np.array([one(x) for x in a], dtype=object) if len(a) else \
        np.empty(0, object)
    return np.where(m, out, ""), m


from ..expr import regex as RX  # noqa: E402


def _java_like_re(pattern: str):
    import re
    # Java regex classes (\d \w \s) are ASCII by default; python's are
    # Unicode — re.ASCII aligns the CPU engine with Java/Spark and the
    # byte-level device DFA.
    return re.compile(pattern, re.ASCII)


@_reg(RX.RLike)
def _rlike(expr, table):
    a, m = _ev(expr.children[0], table)
    prog = _java_like_re(expr.pattern)
    out = np.array([prog.search(x) is not None for x in a], dtype=bool) \
        if len(a) else np.empty(0, bool)
    return out & m, m


@_reg(RX.RegExpExtract)
def _regexp_extract(expr, table):
    a, m = _ev(expr.children[0], table)
    prog = _java_like_re(expr.pattern)
    def one(s):
        mt = prog.search(s)
        if mt is None:
            return ""
        try:
            g = mt.group(expr.group)
        except IndexError:
            return ""
        return g if g is not None else ""
    out = np.array([one(x) for x in a], dtype=object) if len(a) else \
        np.empty(0, object)
    return np.where(m, out, ""), m


def _java_replacement(repl: str):
    """Java replacement syntax -> python re template: $N / ${N} are
    group refs, backslash escapes the next char (incl. literal $)."""
    out = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "\\" and i + 1 < len(repl):
            nxt = repl[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt.replace(
                "\\", "\\\\"))
            i += 2
            continue
        if ch == "$" and i + 1 < len(repl):
            j = i + 1
            if repl[j] == "{":
                k = repl.find("}", j)
                out.append("\\g<" + repl[j + 1:k] + ">")
                i = k + 1
                continue
            digits = ""
            while j < len(repl) and repl[j].isdigit():
                digits += repl[j]
                j += 1
            if digits:
                out.append("\\g<" + digits + ">")
                i = j
                continue
        out.append(ch if ch != "\\" else "\\\\")
        i += 1
    return "".join(out)


@_reg(RX.RegExpReplace)
def _regexp_replace(expr, table):
    import re
    a, m = _ev(expr.children[0], table)
    prog = _java_like_re(expr.pattern)
    repl = _java_replacement(expr.replacement)
    out = np.array([prog.sub(repl, x) for x in a], dtype=object) \
        if len(a) else np.empty(0, object)
    return np.where(m, out, ""), m


def _register_misc_exprs():
    from ..expr import misc as MX

    @_reg(MX.MonotonicallyIncreasingID)
    def _mono_id(expr, table):
        n = table.num_rows
        return np.arange(n, dtype=np.int64), np.ones(n, bool)

    @_reg(MX.SparkPartitionID)
    def _part_id(expr, table):
        n = table.num_rows
        return np.zeros(n, np.int32), np.ones(n, bool)

    @_reg(MX.Uuid)
    def _uuid(expr, table):
        # the device's generator and formatting on CPU tensors: the same
        # strings as a CPU device for the expression's seed
        import torch

        from ..columnar.vector import ColumnarBatch
        n = table.num_rows
        out = expr.eval(ColumnarBatch([], [], n, torch.device("cpu"),
                                      capacity=max(n, 1)))
        vals, mask = out.to_numpy(n)
        return np.where(mask, vals.to_objects(), ""), mask

    @_reg(MX.RaiseError)
    def _raise(expr, table):
        n = table.num_rows
        _ansi_raise_if(np.ones(n, bool),
                       MX.RaiseErrorException(expr.message), table)
        return np.full(n, "", dtype=object), np.zeros(n, bool)

    @_reg(MX.InputFileName)
    def _input_file(expr, table):
        n = table.num_rows
        return np.full(n, MX.current_input_file()[0], dtype=object), \
            np.ones(n, bool)

    @_reg(MX.InputFileBlockStart)
    def _block_start(expr, table):
        n = table.num_rows
        return np.full(n, MX.current_input_file()[1], np.int64), \
            np.ones(n, bool)

    @_reg(MX.InputFileBlockLength)
    def _block_len(expr, table):
        n = table.num_rows
        return np.full(n, MX.current_input_file()[2], np.int64), \
            np.ones(n, bool)

    @_reg(MX.Version)
    def _version(expr, table):
        n = table.num_rows
        return np.full(n, MX.version_string(), dtype=object), \
            np.ones(n, bool)

    from ..expr.hashing import BloomFilterMightContain

    @_reg(BloomFilterMightContain)
    def _might_contain(expr, table):
        # the probe is the device's hash chain, run on CPU tensors over a
        # host-built column, so the two engines agree bit for bit
        import torch

        from ..columnar.nested import column_from_host_lane
        from ..ops import bloom as B
        v, m = _ev(expr.children[0], table)
        t = expr.children[0].data_type(table.schema())
        if t == dt.STRING:
            from ..columnar.vector import HostStrings
            v = HostStrings.from_objects(
                [s if ok else None for s, ok in zip(v, m)])
        n = table.num_rows
        c = column_from_host_lane(v, m, t, max(n, 1),
                                  device=torch.device("cpu"))
        hit = B.might_contain(torch.from_numpy(expr.bits), [c])
        return hit.numpy()[:n].copy(), m.copy()


_register_misc_exprs()


def _register_device_identical():
    """Expressions whose semantics are a deterministic chain of integer
    operations (hash functions, date truncation): the CPU engine runs
    the port's own expression on CPU tensors over host-built columns,
    so the fallback is bit-identical and there is no second
    implementation to drift. (The JAX package does the same with its
    jnp chain.)"""
    import copy

    import torch

    from ..columnar.vector import ColumnarBatch
    from ..columnar.nested import column_from_host_lane
    from ..expr.datetime import TruncDate
    from ..expr.hashing import Murmur3Hash, XxHash64
    cpu = torch.device("cpu")

    def _device_eval(expr, table):
        schema = table.schema()
        n = table.num_rows
        cap = max(n, 1)
        cols, names = [], []
        for i, c in enumerate(expr.children):
            v, m = _ev(c, table)
            t = c.data_type(schema)
            if t == dt.STRING:
                from ..columnar.vector import HostStrings
                v = HostStrings.from_objects(
                    [s if ok else None for s, ok in zip(v, m)])
            cols.append(column_from_host_lane(v, m, t, cap, device=cpu))
            names.append(f"a{i}")
        batch = ColumnarBatch(cols, names, n, cpu)
        # rebind child refs positionally so expr.eval sees our columns
        clone = copy.copy(expr)
        clone.children = [E.col(f"a{i}")
                          for i in range(len(expr.children))]
        out = clone.eval(batch)
        vals, mask = out.to_numpy(n)
        if out.dtype == dt.STRING:
            vals = np.where(mask, vals, "")
        return vals, mask

    for cls in (Murmur3Hash, XxHash64, TruncDate):
        _EVALUATORS[cls] = _device_eval


_register_device_identical()


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------

from ..expr import bitwise as B  # noqa: E402


def _bitwise_binary(np_op):
    def ev(expr, table):
        out_t = expr.data_type(table.schema())
        phys = np.dtype(out_t.np_physical)
        a, am = _ev(expr.children[0], table)
        b, bm = _ev(expr.children[1], table)
        m = am & bm
        out = np_op(a.astype(phys), b.astype(phys))
        return _zero_nulls(out, m), m
    return ev


_EVALUATORS[B.BitwiseAnd] = _bitwise_binary(np.bitwise_and)
_EVALUATORS[B.BitwiseOr] = _bitwise_binary(np.bitwise_or)
_EVALUATORS[B.BitwiseXor] = _bitwise_binary(np.bitwise_xor)


@_reg(B.BitwiseNot)
def _bitwise_not(expr, table):
    a, m = _ev(expr.children[0], table)
    return _zero_nulls(~a, m), m


def _shift_eval(kind):
    def ev(expr, table):
        a, am = _ev(expr.children[0], table)
        b, bm = _ev(expr.children[1], table)
        m = am & bm
        width = 64 if expr.data_type(table.schema()) == dt.INT64 else 32
        n = b.astype(np.int64) & (width - 1)
        x = a.astype(np.int64) if width == 64 else a.astype(np.int32)
        if kind == "left":
            out = x << n.astype(x.dtype)
        elif kind == "right":
            out = x >> n.astype(x.dtype)
        else:  # unsigned right
            ux = x.astype(np.uint64 if width == 64 else np.uint32)
            out = (ux >> n.astype(ux.dtype)).astype(x.dtype)
        return _zero_nulls(out, m), m
    return ev


_EVALUATORS[B.ShiftLeft] = _shift_eval("left")
_EVALUATORS[B.ShiftRight] = _shift_eval("right")
_EVALUATORS[B.ShiftRightUnsigned] = _shift_eval("uright")


@_reg(B.BitCount)
def _bitcount(expr, table):
    a, m = _ev(expr.children[0], table)
    if a.dtype == np.bool_:
        return _zero_nulls(a.astype(np.int32), m), m
    u = a.astype(np.uint64 if a.dtype == np.int64 else np.uint32)
    out = np.array([bin(int(v)).count("1") for v in u], np.int32) \
        if len(u) else np.empty(0, np.int32)
    return _zero_nulls(out, m), m


@_reg(B.InterleaveBits)
def _interleave(expr, table):
    k = len(expr.children)
    bits_per = 63 // k
    parts = []
    mask = np.ones(table.num_rows, bool)
    schema = table.schema()
    for c in expr.children:
        v, m = _ev(c, table)
        mask &= m
        width = 64 if c.data_type(schema) == dt.INT64 else 32
        x = v.astype(np.int64)
        if width == 64:
            u = (x.astype(np.uint64) ^ np.uint64(1 << 63)).astype(np.int64)
        else:
            u = x + np.int64(1 << 31)
        parts.append((u >> (width - bits_per)) &
                     np.int64((1 << bits_per) - 1))
    out = np.zeros(table.num_rows, np.int64)
    for bit in range(bits_per):
        for ci, p in enumerate(parts):
            out |= ((p >> bit) & 1) << (bit * k + ci)
    return _zero_nulls(out, mask), mask


# ---------------------------------------------------------------------------
# collections (arrays/structs) — host lists/dicts of LOGICAL values
# (collectionOperations.scala / complexTypeExtractors.scala oracle)
# ---------------------------------------------------------------------------

def _obj_array(items):
    out = np.empty(len(items), dtype=object)
    for i, v in enumerate(items):
        out[i] = v
    return out


def _logical_of(col_values, col_mask, i, t: dt.DType):
    from ..columnar.vector import from_physical
    if not col_mask[i]:
        return None
    if t == dt.STRING or t.is_nested:
        return col_values[i]
    return from_physical(col_values[i], t)


def _physical_scalar(v, t: dt.DType):
    from ..expr.core import literal_physical as _to_physical
    if v is None:
        return 0
    if t == dt.STRING or t.is_nested:
        return v
    return _to_physical(v, t)


def _met(children, schema):
    """The children cast to their common type, as on the device."""
    from ..expr.conditional import _common_type
    et = _common_type([c.data_type(schema) for c in children])
    et = dt.INT32 if et == dt.NULL else et
    return [c if c.data_type(schema) == et else C.Cast(c, et)
            for c in children], et


def _register_collections():
    from ..expr import collections as CX

    @_reg(CX.CreateArray)
    def _create_array(expr, table):
        kids, et = _met(expr.children, table.schema())
        kids = [evaluate(c, table) for c in kids]
        n = table.num_rows
        out = _obj_array([
            [_logical_of(k.values, k.mask, i, et) for k in kids]
            for i in range(n)])
        return out, np.ones(n, bool)

    @_reg(CX.Size)
    def _size(expr, table):
        v, m = _ev(expr.children[0], table)
        out = np.array([len(v[i]) if m[i] else 0 for i in range(len(v))],
                       dtype=np.int32)
        return out, m.copy()

    def _item(expr, table, one_based):
        schema = table.schema()
        et = expr.data_type(schema)
        arr, am = _ev(expr.children[0], table)
        idx, im = _ev(expr.children[1], table)
        n = len(arr)
        vals, mask = [], np.zeros(n, bool)
        for i in range(n):
            v = None
            if am[i] and im[i]:
                k = int(idx[i])
                lst = arr[i]
                if one_based:
                    k = k - 1 if k > 0 else len(lst) + k
                    if int(idx[i]) == 0:
                        k = -10**9
                if 0 <= k < len(lst):
                    v = lst[k]
            mask[i] = v is not None
            vals.append(_physical_scalar(v, et))
        if et == dt.STRING or et.is_nested:
            return _obj_array(vals), mask
        return np.array(vals, dtype=np.dtype(et.np_physical)), mask

    _EVALUATORS[CX.GetArrayItem] = \
        lambda e, t: _item(e, t, one_based=False)
    _EVALUATORS[CX.ElementAt] = lambda e, t: _item(e, t, one_based=True)

    @_reg(CX.ArrayContains)
    def _contains(expr, table):
        schema = table.schema()
        et = expr.children[0].data_type(schema).element_type
        arr, am = _ev(expr.children[0], table)
        needle = evaluate(expr.children[1], table)
        n = len(arr)
        out = np.zeros(n, bool)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not (am[i] and needle.mask[i]):
                continue
            want = _logical_of(needle.values, needle.mask, i,
                              expr.children[1].data_type(schema))
            found = any(e is not None and e == want for e in arr[i])
            has_null = any(e is None for e in arr[i])
            out[i] = found
            mask[i] = found or not has_null
        return out, mask

    def _extreme(expr, table, fn):
        schema = table.schema()
        et = expr.data_type(schema)
        arr, am = _ev(expr.children[0], table)
        n = len(arr)
        vals, mask = [], np.zeros(n, bool)
        for i in range(n):
            v = None
            if am[i]:
                elems = [e for e in arr[i] if e is not None]
                if elems:
                    v = fn(elems)
            mask[i] = v is not None
            vals.append(_physical_scalar(v, et))
        if et == dt.STRING or et.is_nested:
            return _obj_array(vals), mask
        return np.array(vals, dtype=np.dtype(et.np_physical)), mask

    _EVALUATORS[CX.ArrayMin] = lambda e, t: _extreme(e, t, min)
    _EVALUATORS[CX.ArrayMax] = lambda e, t: _extreme(e, t, max)

    @_reg(CX.SortArray)
    def _sort_array(expr, table):
        arr, am = _ev(expr.children[0], table)
        n = len(arr)
        out = np.empty(n, dtype=object)
        for i in range(n):
            if not am[i]:
                out[i] = None
                continue
            non_null = sorted([e for e in arr[i] if e is not None],
                              reverse=not expr.ascending)
            nulls = [None] * (len(arr[i]) - len(non_null))
            out[i] = (nulls + non_null) if expr.ascending \
                else (non_null + nulls)
        return out, am.copy()

    def _list2(expr, table):
        av, am = _ev(expr.children[0], table)
        bv, bm = _ev(expr.children[1], table)
        return av, am, bv, bm

    def _dedup_first(items):
        seen, out = [], []
        for e in items:
            if e not in seen:
                seen.append(e)
                out.append(e)
        return out

    @_reg(CX.ArrayDistinct)
    def _distinct(expr, table):
        v, m = _ev(expr.children[0], table)
        out = _obj_array([_dedup_first(v[i]) if m[i] else None
                          for i in range(len(v))])
        return out, m.copy()

    @_reg(CX.ArrayUnion)
    def _union(expr, table):
        av, am, bv, bm = _list2(expr, table)
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = am & bm
        for i in range(n):
            out[i] = _dedup_first(list(av[i]) + list(bv[i])) \
                if mask[i] else None
        return out, mask

    @_reg(CX.ArrayIntersect)
    def _intersect(expr, table):
        av, am, bv, bm = _list2(expr, table)
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = am & bm
        for i in range(n):
            out[i] = _dedup_first([e for e in av[i] if e in bv[i]]) \
                if mask[i] else None
        return out, mask

    @_reg(CX.ArrayExcept)
    def _except(expr, table):
        av, am, bv, bm = _list2(expr, table)
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = am & bm
        for i in range(n):
            out[i] = _dedup_first([e for e in av[i]
                                   if e not in bv[i]]) \
                if mask[i] else None
        return out, mask

    @_reg(CX.ArraysOverlap)
    def _overlap(expr, table):
        av, am, bv, bm = _list2(expr, table)
        n = len(av)
        out = np.zeros(n, bool)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not (am[i] and bm[i]):
                continue
            hit = any(e is not None and e in bv[i] for e in av[i])
            nullish = bool(av[i]) and bool(bv[i]) and \
                (None in av[i] or None in bv[i])
            out[i] = hit
            mask[i] = hit or not nullish
        return out, mask

    @_reg(CX.ArrayRemove)
    def _remove(expr, table):
        schema = table.schema()
        et = expr.children[0].data_type(schema).element_type
        av, am = _ev(expr.children[0], table)
        vc = evaluate(expr.children[1], table)
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if am[i] and vc.mask[i]:
                want = _logical_of(vc.values, vc.mask, i, et)
                out[i] = [e for e in av[i]
                          if e is None or e != want]
                mask[i] = True
            else:
                out[i] = None
        return out, mask

    @_reg(CX.ArrayPosition)
    def _position(expr, table):
        schema = table.schema()
        et = expr.children[0].data_type(schema).element_type
        av, am = _ev(expr.children[0], table)
        vc = evaluate(expr.children[1], table)
        n = len(av)
        out = np.zeros(n, np.int64)
        mask = np.zeros(n, bool)
        for i in range(n):
            if am[i] and vc.mask[i]:
                want = _logical_of(vc.values, vc.mask, i, et)
                mask[i] = True
                for k, e in enumerate(av[i]):
                    if e is not None and e == want:
                        out[i] = k + 1
                        break
        return out, mask

    @_reg(CX.Slice)
    def _slice(expr, table):
        av, am = _ev(expr.children[0], table)
        sc = evaluate(expr.children[1], table)
        nc = evaluate(expr.children[2], table)
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not (am[i] and sc.mask[i] and nc.mask[i]):
                out[i] = None
                continue
            s, ln = int(sc.values[i]), int(nc.values[i])
            if s == 0 or ln < 0:
                out[i] = None
                continue
            z = s - 1 if s > 0 else len(av[i]) + s
            # window [z, z+ln) intersected with the valid index range
            out[i] = list(av[i][max(z, 0):max(z + ln, 0)])
            mask[i] = True
        return out, mask

    @_reg(CX.ArrayReverse)
    def _arr_reverse(expr, table):
        v, m = _ev(expr.children[0], table)
        out = _obj_array([list(reversed(v[i])) if m[i] else None
                          for i in range(len(v))])
        return out, m.copy()

    @_reg(CX.ArrayRepeat)
    def _repeat(expr, table):
        schema = table.schema()
        et = expr.children[0].data_type(schema)
        vc = evaluate(expr.children[0], table)
        nc = evaluate(expr.children[1], table)
        n = table.num_rows
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not nc.mask[i]:
                out[i] = None
                continue
            k = max(int(nc.values[i]), 0)
            e = _logical_of(vc.values, vc.mask, i, et)
            out[i] = [e] * k
            mask[i] = True
        return out, mask

    @_reg(CX.Flatten)
    def _flatten(expr, table):
        v, m = _ev(expr.children[0], table)
        n = len(v)
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not m[i] or any(e is None for e in v[i]):
                out[i] = None  # null inner array -> null (Spark)
                continue
            out[i] = [x for inner in v[i] for x in inner]
            mask[i] = True
        return out, mask

    @_reg(CX.ArraysZip)
    def _arrays_zip(expr, table):
        cols = [_ev(c, table) for c in expr.children]
        n = len(cols[0][0])
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not all(m[i] for _, m in cols):
                out[i] = None
                continue
            ln = max((len(v[i]) for v, _ in cols), default=0)
            out[i] = [
                {str(j): (v[i][k] if k < len(v[i]) else None)
                 for j, (v, _) in enumerate(cols)}
                for k in range(ln)]
            mask[i] = True
        return out, mask

    @_reg(CX.ArrayJoin)
    def _array_join(expr, table):
        v, m = _ev(expr.children[0], table)
        n = len(v)
        out = np.empty(n, dtype=object)
        for i in range(n):
            if not m[i]:
                out[i] = ""
                continue
            parts = [e if e is not None else expr.null_replacement
                     for e in v[i]]
            out[i] = expr.sep.join(p for p in parts if p is not None)
        return out, m.copy()

    @_reg(CX.ZipWith)
    def _zip_with(expr, table):
        schema = table.schema()
        expr.data_type(schema)  # bind lambda var dtypes
        av, am = _ev(expr.children[0], table)
        bv, bm = _ev(expr.children[1], table)
        body = expr.children[2]
        xt, yt = expr.x_var._dtype, expr.y_var._dtype
        from ..expr import higher_order as HO
        from .host_table import HostColumn, HostTable
        n = len(av)
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        lens = np.array([max(len(av[i]), len(bv[i]))
                         if am[i] and bm[i] else 0
                         for i in range(n)], dtype=np.int64)
        xs, ys = [], []
        for i in range(n):
            for k in range(lens[i]):
                xs.append(av[i][k] if k < len(av[i]) else None)
                ys.append(bv[i][k] if k < len(bv[i]) else None)

        def pc(vals, t):
            mk = np.array([v is not None for v in vals], bool)
            ph = [_physical_scalar(v, t) for v in vals]
            if t == dt.STRING or t.is_nested:
                return HostColumn(_obj_array(ph), mk, t)
            return HostColumn(np.array(ph, dtype=np.dtype(t.np_physical)),
                              mk, t)
        flat = HostTable([pc(xs, xt), pc(ys, yt)],
                         [expr.x_var.name, expr.y_var.name])
        res = evaluate(body, flat)
        rt = body.data_type(flat.schema())
        vals = [_logical_of(res.values, res.mask, i, rt)
                for i in range(len(res.values))]
        pos = 0
        for i in range(n):
            if am[i] and bm[i]:
                out[i] = vals[pos:pos + lens[i]]
                pos += lens[i]
                mask[i] = True
            else:
                out[i] = None
        return out, mask

    @_reg(CX.MapConcat)
    def _map_concat(expr, table):
        cols = [_ev(c, table) for c in expr.children]
        n = len(cols[0][0])
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not all(m[i] for _, m in cols):
                out[i] = None
                continue
            merged = {}
            for v, _ in cols:
                merged.update(v[i])  # last map wins duplicates
            out[i] = merged
            mask[i] = True
        return out, mask

    @_reg(CX.CreateNamedStruct)
    def _named_struct(expr, table):
        schema = table.schema()
        kids = [evaluate(c, table) for c in expr.children]
        types = [c.data_type(schema) for c in expr.children]
        n = table.num_rows
        out = _obj_array([
            {fn: _logical_of(k.values, k.mask, i, t)
             for fn, k, t in zip(expr.names, kids, types)}
            for i in range(n)])
        return out, np.ones(n, bool)

    @_reg(CX.GetStructField)
    def _get_field(expr, table):
        schema = table.schema()
        et = expr.data_type(schema)
        sv, sm = _ev(expr.children[0], table)
        n = len(sv)
        vals, mask = [], np.zeros(n, bool)
        for i in range(n):
            v = sv[i].get(expr.field) if sm[i] else None
            mask[i] = v is not None
            vals.append(_physical_scalar(v, et))
        if et == dt.STRING or et.is_nested:
            return _obj_array(vals), mask
        return np.array(vals, dtype=np.dtype(et.np_physical)), mask


_register_collections()


def _register_higher_order():
    """CPU oracle for lambda expressions (higherOrderFunctions.scala
    surface): lambda bodies evaluate over a FLAT element-level table —
    one row per element, lambda-var columns plus outer columns repeated
    per element — then results regroup by the original list lengths.
    The same lowering shape as the device path, at numpy speed."""
    from ..expr import higher_order as HO
    from .host_table import HostColumn, HostTable

    def _phys_col(values, t: dt.DType) -> HostColumn:
        mask = np.array([v is not None for v in values], dtype=bool)
        phys = [_physical_scalar(v, t) for v in values]
        if t == dt.STRING or t.is_nested or \
                (isinstance(t, dt.DecimalType) and t.is_wide):
            return HostColumn(_obj_array(phys), mask, t)
        return HostColumn(np.array(phys, dtype=np.dtype(t.np_physical)),
                          mask, t)

    def _flat_eval(body, table, lens, bindings):
        """bindings: [(name, logical-values list, dtype)]; returns
        logical results, one per element."""
        cols, names = [], []
        for name, vals, t in bindings:
            names.append(name)
            cols.append(_phys_col(vals, t))
        outer = HO.outer_refs(body, [])  # all free ColumnRefs in body
        outer -= set(names)
        for cname in outer:
            src = table.column(cname)
            rep_m = np.repeat(src.mask, lens)
            rep_vals = np.repeat(src.values, lens)
            names.append(cname)
            cols.append(HostColumn(rep_vals, rep_m, src.dtype))
        flat = HostTable(cols, names)
        out = evaluate(body, flat)
        rt = body.data_type(flat.schema())
        return [(_logical_of(out.values, out.mask, i, rt))
                for i in range(len(out.values))]

    def _elements_of(arr, am):
        lens = np.array([len(arr[i]) if am[i] else 0
                         for i in range(len(arr))], dtype=np.int64)
        flat = []
        for i in range(len(arr)):
            if am[i]:
                flat.extend(arr[i])
        return lens, flat

    @_reg(HO.LambdaVariable)
    def _lambda_var(expr, table):
        c = table.column(expr.name)
        return c.values, c.mask

    @_reg(HO.ArrayTransform)
    def _transform(expr, table):
        expr.data_type(table.schema())  # bind lambda var dtypes
        arr, am = _ev(expr.children[0], table)
        lens, flat = _elements_of(arr, am)
        binds = [(expr.var.name, flat, expr.var._dtype)]
        if expr.idx_var is not None:
            idx = [k for n in lens for k in range(n)]
            binds.append((expr.idx_var.name, idx, dt.INT32))
        res = _flat_eval(expr.children[1], table, lens, binds)
        out = np.empty(len(arr), dtype=object)
        pos = 0
        for i in range(len(arr)):
            if am[i]:
                out[i] = res[pos:pos + lens[i]]
                pos += lens[i]
            else:
                out[i] = None
        return out, am.copy()

    def _pred_rows(expr, table):
        expr.data_type(table.schema())
        arr, am = _ev(expr.children[0], table)
        lens, flat = _elements_of(arr, am)
        binds = [(expr.var.name, flat, expr.var._dtype)]
        res = _flat_eval(expr.children[1], table, lens, binds)
        return arr, am, lens, res

    @_reg(HO.ArrayExists)
    def _exists(expr, table):
        arr, am, lens, res = _pred_rows(expr, table)
        n = len(arr)
        out = np.zeros(n, bool)
        mask = np.zeros(n, bool)
        pos = 0
        for i in range(n):
            if not am[i]:
                continue
            window = res[pos:pos + lens[i]]
            pos += lens[i]
            any_true = any(v is True for v in window)
            any_null = any(v is None for v in window)
            out[i] = any_true
            mask[i] = any_true or not any_null
        return out, mask

    @_reg(HO.ArrayForAll)
    def _forall(expr, table):
        arr, am, lens, res = _pred_rows(expr, table)
        n = len(arr)
        out = np.zeros(n, bool)
        mask = np.zeros(n, bool)
        pos = 0
        for i in range(n):
            if not am[i]:
                continue
            window = res[pos:pos + lens[i]]
            pos += lens[i]
            any_false = any(v is False for v in window)
            any_null = any(v is None for v in window)
            out[i] = not any_false
            mask[i] = any_false or not any_null
        return out, mask

    @_reg(HO.ArrayFilter)
    def _filter(expr, table):
        arr, am, lens, res = _pred_rows(expr, table)
        n = len(arr)
        out = np.empty(n, dtype=object)
        pos = 0
        for i in range(n):
            if not am[i]:
                out[i] = None
                continue
            window = res[pos:pos + lens[i]]
            pos += lens[i]
            out[i] = [e for e, keep in zip(arr[i], window)
                      if keep is True]
        return out, am.copy()

    @_reg(HO.ArrayAggregate)
    def _aggregate(expr, table):
        schema = table.schema()
        rt = expr.data_type(schema)
        arr, am = _ev(expr.children[0], table)
        zero = evaluate(expr.children[1], table)
        zt = expr.children[1].data_type(schema)
        acc_t = expr.acc_var._dtype or zt
        et = expr.elem_var._dtype
        n = len(arr)
        merge = expr.children[2]
        finish = expr.children[3] if expr.has_finish else None
        # the outer columns the lambdas read, bound at the row's value
        # (the JAX engine leaves them out and cannot resolve them)
        outer = sorted(set().union(*[HO.outer_refs(b, expr.lambda_vars)
                                     for b in expr.bodies()]))
        vals, mask = [], np.zeros(n, bool)
        for i in range(n):
            if not am[i]:
                vals.append(_physical_scalar(None, rt))
                continue
            row = [table.column(c).take(np.array([i])) for c in outer]
            acc = _logical_of(zero.values, zero.mask, i, zt)
            for x in arr[i]:
                one = HostTable(
                    [_phys_col([acc], acc_t), _phys_col([x], et)] + row,
                    [expr.acc_var.name, expr.elem_var.name] + outer)
                r = evaluate(merge, one)
                acc = _logical_of(r.values, r.mask, 0, acc_t)
            if finish is not None:
                one = HostTable([_phys_col([acc], acc_t)] + row,
                                [expr.acc_var.name] + outer)
                r = evaluate(finish, one)
                acc = _logical_of(r.values, r.mask, 0, rt)
            mask[i] = acc is not None
            vals.append(_physical_scalar(acc, rt))
        if rt == dt.STRING or rt.is_nested:
            return _obj_array(vals), mask
        return np.array(vals, dtype=np.dtype(rt.np_physical)), mask

    # --- maps (logical value = dict) ---

    @_reg(HO.MapKeys)
    def _map_keys(expr, table):
        mv, mm = _ev(expr.children[0], table)
        out = _obj_array([list(mv[i].keys()) if mm[i] else None
                          for i in range(len(mv))])
        return out, mm.copy()

    @_reg(HO.MapValues)
    def _map_values(expr, table):
        mv, mm = _ev(expr.children[0], table)
        out = _obj_array([list(mv[i].values()) if mm[i] else None
                          for i in range(len(mv))])
        return out, mm.copy()

    @_reg(HO.MapEntries)
    def _map_entries(expr, table):
        mv, mm = _ev(expr.children[0], table)
        out = _obj_array([
            [{"key": k, "value": v} for k, v in mv[i].items()]
            if mm[i] else None for i in range(len(mv))])
        return out, mm.copy()

    @_reg(HO.GetMapValue)
    def _get_map_value(expr, table):
        schema = table.schema()
        vt = expr.data_type(schema)
        kt = expr.children[1].data_type(schema)
        mv, mm = _ev(expr.children[0], table)
        kc = evaluate(expr.children[1], table)
        n = len(mv)
        vals, mask = [], np.zeros(n, bool)
        for i in range(n):
            v = None
            if mm[i] and kc.mask[i]:
                key = _logical_of(kc.values, kc.mask, i, kt)
                v = mv[i].get(key)
            mask[i] = v is not None
            vals.append(_physical_scalar(v, vt))
        if vt == dt.STRING or vt.is_nested:
            return _obj_array(vals), mask
        return np.array(vals, dtype=np.dtype(vt.np_physical)), mask

    @_reg(HO.MapContainsKey)
    def _map_contains(expr, table):
        schema = table.schema()
        kt = expr.children[1].data_type(schema)
        mv, mm = _ev(expr.children[0], table)
        kc = evaluate(expr.children[1], table)
        n = len(mv)
        out = np.zeros(n, bool)
        mask = np.zeros(n, bool)
        for i in range(n):
            if mm[i] and kc.mask[i]:
                key = _logical_of(kc.values, kc.mask, i, kt)
                out[i] = key in mv[i]
                mask[i] = True
        return out, mask

    def _map_lambda(expr, table, fn):
        expr.data_type(table.schema())  # bind var dtypes
        mv, mm = _ev(expr.children[0], table)
        n = len(mv)
        keys = [k for i in range(n) if mm[i] for k in mv[i].keys()]
        vals = [v for i in range(n) if mm[i] for v in mv[i].values()]
        lens = np.array([len(mv[i]) if mm[i] else 0 for i in range(n)],
                        dtype=np.int64)
        binds = [(expr.key_var.name, keys, expr.key_var._dtype),
                 (expr.val_var.name, vals, expr.val_var._dtype)]
        res = _flat_eval(expr.children[1], table, lens, binds)
        out = np.empty(n, dtype=object)
        pos = 0
        for i in range(n):
            if not mm[i]:
                out[i] = None
                continue
            window = res[pos:pos + lens[i]]
            pos += lens[i]
            out[i] = fn(mv[i], window)
        return out, mm.copy()

    @_reg(HO.TransformValues)
    def _transform_values(expr, table):
        return _map_lambda(
            expr, table,
            lambda m, rs: dict(zip(m.keys(), rs)))

    @_reg(HO.TransformKeys)
    def _transform_keys(expr, table):
        return _map_lambda(
            expr, table,
            lambda m, rs: dict(zip(rs, m.values())))

    @_reg(HO.MapFilter)
    def _map_filter(expr, table):
        return _map_lambda(
            expr, table,
            lambda m, rs: {k: v for (k, v), keep in zip(m.items(), rs)
                           if keep is True})

    @_reg(HO.CreateMap)
    def _create_map(expr, table):
        schema = table.schema()
        n = table.num_rows
        kexprs, kt = _met(expr.children[0::2], schema)
        vexprs, vt = _met(expr.children[1::2], schema)
        keys = [evaluate(c, table) for c in kexprs]
        vals = [evaluate(c, table) for c in vexprs]
        rows = []
        for i in range(n):
            row = {}
            for k, v in zip(keys, vals):
                # Spark's key rules, as on the device (check_map_keys)
                if not k.mask[i]:
                    raise ValueError("map(): cannot use null as map key")
                key = _logical_of(k.values, k.mask, i, kt)
                if key in row:
                    raise ValueError("map(): duplicate map key (Spark's "
                                     "spark.sql.mapKeyDedupPolicy="
                                     "EXCEPTION)")
                row[key] = _logical_of(v.values, v.mask, i, vt)
            rows.append(row)
        return _obj_array(rows), np.ones(n, bool)

    @_reg(HO.MapFromArrays)
    def _map_from_arrays(expr, table):
        kv, km = _ev(expr.children[0], table)
        vv, vm = _ev(expr.children[1], table)
        n = len(kv)
        out = np.empty(n, dtype=object)
        mask = np.zeros(n, bool)
        for i in range(n):
            if not (km[i] and vm[i]):
                out[i] = None
                continue
            # Spark's rules, as on the device (ROADMAP C17): lengths
            # must agree, no NULL and no repeated key
            if len(kv[i]) != len(vv[i]):
                raise ValueError("map_from_arrays: the key and value "
                                 "arrays of a row differ in length")
            if any(k is None for k in kv[i]):
                raise ValueError("map_from_arrays: cannot use null as "
                                 "map key")
            out[i] = dict(zip(kv[i], vv[i]))
            if len(out[i]) != len(kv[i]):
                raise ValueError("map_from_arrays: duplicate map key "
                                 "(Spark's spark.sql.mapKeyDedupPolicy="
                                 "EXCEPTION)")
            mask[i] = True
        return out, mask


_register_higher_order()
