"""Row-group pruning from the footer's statistics.

The port's counterpart of the JAX package's ``to_arrow_filter``
(spark_rapids_tpu/io/scan.py:357, the reference's ParquetFilters), which
hands the pushed filter to pyarrow's dataset scanner. The same conjuncts
translate: ``=``, ``<``, ``<=``, ``>``, ``>=`` of a column and a literal
(either side), ``IS [NOT] NULL``, ``IN`` of literals, ``AND`` (one
translatable side is enough) and ``OR`` (both sides must translate).
Anything else is "might match". ``might_match`` then asks each row
group's column ``Statistics`` whether some row could pass, and the file
reader skips a row group only when they prove that none can under
Spark's semantics:

- only ``min_value`` / ``max_value`` are read (the deprecated ``min`` /
  ``max`` have an undefined order);
- strings order by unsigned bytes, decimals by signed value (FIXED_LEN
  big-endian two's complement, or the INT32 / INT64 lane);
- Parquet leaves NaN out of a float's min and max while Spark sorts NaN
  above every number, so ``>`` and ``>=`` on a float column never prune
  (a NaN row passes them), nor does a NaN literal or a NaN bound;
- the literal meets the bounds as the engine meets it
  (expr/predicates.py): a decimal or an integer column against a float
  as doubles (the bounds widened by two units in the last place), a
  FLOAT32 column against an integer in FLOAT32, and IN casts each value
  to the column's lane;
- a row group whose every value is NULL passes no comparison and no
  ``IN``; ``IS NULL`` needs ``null_count`` > 0, ``IS NOT NULL`` a value;
- dates and timestamps prune only under the CORRECTED rebase mode (a
  LEGACY file's statistics are in the hybrid calendar).

The Filter above the scan still runs: pruning only skips row groups.
"""

from __future__ import annotations

import datetime
import math
import struct
from decimal import Decimal
from fractions import Fraction
from typing import Optional

from ..columnar import dtypes as dt
from ..expr import core as E
from ..expr import predicates as P
from . import parquet_schema as PS
from . import thrift as T

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
_OPS = {P.EqualTo: "=", P.LessThan: "<", P.LessThanOrEqual: "<=",
        P.GreaterThan: ">", P.GreaterThanOrEqual: ">="}


def translate(expr: E.Expression, skip=frozenset()):
    """The filter as a tree of tuples, or None where nothing translates:
    ("cmp", op, name, value), ("in", name, values), ("null", name,
    is_null), ("and", a, b), ("or", a, b). Columns in ``skip``
    (partition columns) do not translate."""
    def column(e):
        if isinstance(e, E.ColumnRef) and e.name not in skip:
            return e.name
        return None

    def value(e):
        if isinstance(e, E.Literal) and e.value is not None:
            return e.value
        return None

    if isinstance(expr, P.And):
        a = translate(expr.children[0], skip)
        b = translate(expr.children[1], skip)
        if a is not None and b is not None:
            return ("and", a, b)
        return a if b is None else b
    if isinstance(expr, P.Or):
        a = translate(expr.children[0], skip)
        b = translate(expr.children[1], skip)
        return ("or", a, b) if a is not None and b is not None else None
    op = _OPS.get(type(expr))
    if op is not None:
        left, right = expr.children
        if column(left) is not None and value(right) is not None:
            return ("cmp", op, column(left), value(right))
        if column(right) is not None and value(left) is not None:
            return ("cmp", _FLIP[op], column(right), value(left))
        return None
    if isinstance(expr, (P.IsNull, P.IsNotNull)):
        name = column(expr.children[0])
        return None if name is None else \
            ("null", name, isinstance(expr, P.IsNull))
    if isinstance(expr, P.InSet):
        name = column(expr.children[0])
        vals = [v for v in expr.values if v is not None]
        return ("in", name, vals) if name is not None and vals else None
    return None


class ColumnStats:
    """One column chunk's statistics in the declared type's order."""
    __slots__ = ("lo", "hi", "nulls", "rows", "is_float")

    def __init__(self, lo, hi, nulls, rows, is_float):
        self.lo, self.hi, self.nulls, self.rows = lo, hi, nulls, rows
        self.is_float = is_float


def _decode(raw: Optional[bytes], el: T.SchemaElement, t: dt.DType):
    """A min / max value as a Python value that orders as Spark orders
    the column, or None where it cannot be read."""
    if raw is None:
        return None
    phys = el.type
    try:
        if t == dt.STRING:
            return bytes(raw)
        if phys == T.BOOLEAN:
            return bool(raw[0])
        if phys == T.FLOAT:
            return struct.unpack("<f", raw)[0]
        if phys == T.DOUBLE:
            return struct.unpack("<d", raw)[0]
        if phys in (T.INT32, T.INT64):
            v = struct.unpack("<i" if phys == T.INT32 else "<q", raw)[0]
        elif phys == T.FIXED_LEN_BYTE_ARRAY and isinstance(t,
                                                          dt.DecimalType):
            v = int.from_bytes(raw, "big", signed=True)
        else:
            return None
    except (struct.error, IndexError):
        return None
    if isinstance(t, dt.DecimalType):
        return Fraction(v, 10 ** t.scale)
    if t == dt.TIMESTAMP:
        mul, div = PS.timestamp_scale(el)
        q = abs(v) // div
        return v * mul if mul != 1 else (q if v >= 0 else -q)
    return v


def column_stats(cc: T.ColumnChunk, info: PS.ColumnInfo,
                 rows: int) -> Optional[ColumnStats]:
    md = cc.meta_data
    st = md.statistics if md is not None else None
    if st is None or getattr(info, "max_rep", 0) or info.dtype is None or \
            info.dtype.is_nested:
        return None
    t = info.dtype
    return ColumnStats(_decode(st.min_value, info.element, t),
                       _decode(st.max_value, info.element, t),
                       st.null_count, rows,
                       info.element.type in (T.FLOAT, T.DOUBLE))


def _double(x, down: bool):
    """An int or a Fraction as a double two units in the last place
    beyond it, toward ``down``: the engine's own conversion of a decimal
    (d128_to_f64, then a division) may round twice."""
    try:
        f = float(x)
    except OverflowError:
        return None
    step = -math.inf if down else math.inf
    return math.nextafter(math.nextafter(f, step), step)


def _f32(v: float):
    try:
        return struct.unpack("<f", struct.pack("<f", v))[0]
    except OverflowError:
        return None


def _bounds(s: ColumnStats, t: dt.DType, v, is_in: bool):
    """(lo, hi, v_lo, v_hi) in the domain where the engine compares a
    value of type ``t`` with the literal ``v`` (expr/predicates.py):
    every row's value lies in [lo, hi] and the literal's in [v_lo,
    v_hi]. None where the literal does not compare (a NaN, a type the
    column's order does not take) or its domain cannot be bounded."""
    lo, hi = s.lo, s.hi
    if isinstance(v, bool) or t == dt.BOOL:
        return (lo, hi, v, v) if isinstance(v, bool) and t == dt.BOOL \
            else None
    if t in (dt.STRING, dt.DATE, dt.TIMESTAMP):
        if t == dt.STRING and isinstance(v, str):
            v = v.encode("utf-8")
        elif t == dt.DATE and isinstance(v, datetime.date) and \
                not isinstance(v, datetime.datetime) or \
                t == dt.TIMESTAMP and isinstance(v, datetime.datetime):
            v = E.literal_physical(v, t)
        else:
            return None
        return lo, hi, v, v
    if isinstance(v, Decimal):
        if not v.is_finite():
            return None
        v = Fraction(v)
    elif not isinstance(v, (int, float)) or \
            isinstance(v, float) and math.isnan(v):
        return None
    decimal_col = isinstance(t, dt.DecimalType)
    if is_in and not decimal_col:
        # IN casts each value to the column's lane
        if t.is_integral:
            ok = type(v) is int and dt.min_value(t) <= v <= dt.max_value(t)
            return (lo, hi, v, v) if ok else None
        if isinstance(v, Fraction):
            return None
        if t == dt.FLOAT32 and isinstance(v, float):
            f = _f32(v)
            return None if f is None else (lo, hi, f, f)
    if not (t.is_floating or isinstance(v, float)):
        return lo, hi, v, v       # exact: integers and decimals by value
    # as doubles, except a FLOAT32 column against an integer, which
    # meets it in FLOAT32 (exact up to 2**24)
    if not t.is_floating:
        lo, hi = _double(lo, True), _double(hi, False)
    if isinstance(v, float):
        v_lo = v_hi = v
    elif t == dt.FLOAT32 and type(v) is int and abs(v) < 2 ** 63:
        if abs(v) > 2 ** 24:
            return None
        v_lo = v_hi = float(v)
    else:
        v_lo, v_hi = _double(v, True), _double(v, False)
    if None in (lo, hi, v_lo, v_hi):
        return None
    return lo, hi, v_lo, v_hi


def _bad(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def might_match(node, stats, types, calendar_ok: bool = True) -> bool:
    """Whether some row of a row group could pass ``node``; ``stats``
    maps a column name to its ColumnStats (or None), ``types`` to its
    declared dtype."""
    kind = node[0]
    if kind == "and":
        return might_match(node[1], stats, types, calendar_ok) and \
            might_match(node[2], stats, types, calendar_ok)
    if kind == "or":
        return might_match(node[1], stats, types, calendar_ok) or \
            might_match(node[2], stats, types, calendar_ok)
    name = node[2] if kind == "cmp" else node[1]
    s = stats.get(name)
    t = types.get(name)
    if s is None or t is None:
        return True
    if kind == "null":
        if s.nulls is None:
            return True
        return s.nulls > 0 if node[2] else s.nulls < s.rows
    if s.nulls is not None and s.nulls >= s.rows:
        return False          # every value NULL: no comparison passes
    if t in (dt.DATE, dt.TIMESTAMP) and not calendar_ok:
        return True
    if _bad(s.lo) or _bad(s.hi):
        return True
    if kind == "in":
        for v in node[2]:
            b = _bounds(s, t, v, True)
            if b is None or b[0] <= b[3] and b[2] <= b[1]:
                return True
        return False
    op, b = node[1], _bounds(s, t, node[3], False)
    if b is None:
        return True
    lo, hi, v_lo, v_hi = b
    try:
        if op == "=":
            return lo <= v_hi and v_lo <= hi
        if op == "<":
            return lo < v_hi
        if op == "<=":
            return lo <= v_hi
        if s.is_float:
            return True       # a NaN row passes > and >=
        return hi > v_lo if op == ">" else hi >= v_lo
    except TypeError:
        return True
