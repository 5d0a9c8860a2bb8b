"""Result comparison for queries with ORDER BY and LIMIT.

Counterpart of spark_rapids_tpu/testing/asserts.py's value rules
(``_values_equal``) and of nds_check's unordered row-set comparison,
extended for the case the JAX package's suite sidesteps: when a LIMIT
cuts through rows that tie on the ORDER BY keys, two engines may keep
different members of the tied group. ``compare_rows`` then compares the
rows before the tied group in full and the tied group on its count and
keys only; ``order_keys`` reads the ORDER BY and LIMIT from the query
text. An ORDER BY item is an output column (by name, by position, or as
the column a qualified name selects) or arithmetic over such columns
(``sum_sales - avg_monthly_sales``), evaluated on each row; a query
whose ORDER BY names something the output does not hold compares as a
multiset.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

from .sql.parser import BinA, ColA, LitA, Parser, StarA


class OrderExpr:
    """An ORDER BY item computed from output columns: ``columns`` are
    the output columns it reads, calling it on a row gives its value
    (None where an operand is null or a divisor zero)."""

    def __init__(self, fn: Callable[[dict], object], columns: List[str],
                 text: str):
        self.fn = fn
        self.columns = columns
        self.text = text

    def __call__(self, row: dict):
        return self.fn(row)

    def __repr__(self):
        return self.text


#: (output column or computed item, ascending, nulls first)
OrderKey = Tuple[Union[str, OrderExpr], bool, bool]

_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
          "*": lambda a, b: a * b,
          "/": lambda a, b: None if b == 0 else a / b}


def _output_column(ast: ColA, items, out_names) -> Optional[str]:
    """The output column a (possibly qualified) name selects: the select
    item that is that column, else the one output column of that name
    (an unqualified name, or a list with ``*``)."""
    star = any(isinstance(a, StarA) for a, _ in items)
    if not star:
        for (a, _alias), name in zip(items, out_names):
            if isinstance(a, ColA) and a.name.lower() == ast.name.lower() \
                    and (a.qualifier or "").lower() == \
                    (ast.qualifier or "").lower():
                return name
    if ast.qualifier is None or star:
        hits = [n for n in out_names if n.lower() == ast.name.lower()]
        if len(hits) == 1:
            return hits[0]
    return None


def _order_item(ast, items, out_names):
    """A column name, an OrderExpr, or None when the item reads
    something the output does not hold."""
    if isinstance(ast, LitA) and isinstance(ast.value, int) and \
            1 <= ast.value <= len(out_names):
        return out_names[ast.value - 1]
    if isinstance(ast, ColA):
        return _output_column(ast, items, out_names)
    if isinstance(ast, BinA) and ast.op in _ARITH:
        parts = []
        for side in (ast.l, ast.r):
            if isinstance(side, LitA) and isinstance(side.value,
                                                     (int, float)):
                v = side.value
                parts.append(OrderExpr(lambda r, v=v: v, [], repr(v)))
                continue
            part = _order_item(side, items, out_names)
            if part is None:
                return None
            parts.append(part if isinstance(part, OrderExpr) else
                         OrderExpr(lambda r, c=part: r[c], [part], part))
        op = _ARITH[ast.op]
        left, right = parts

        def fn(row):
            a, b = left(row), right(row)
            return None if a is None or b is None else op(a, b)
        return OrderExpr(fn, left.columns + right.columns,
                         f"({left!r} {ast.op} {right!r})")
    return None


def order_keys(text: str, out_names: Sequence[str]
               ) -> Tuple[List[OrderKey], Optional[int]]:
    """The statement's ORDER BY as output columns or items computed
    from them, and its LIMIT. Spark's defaults: NULLS FIRST ascending,
    NULLS LAST descending. If an item reads something the output does
    not hold, there are no keys: the rows compare as a multiset."""
    stmt = Parser(text).parse_statement()
    items = getattr(stmt, "items", [])
    keys = []
    for ast, asc, nulls_first in stmt.order_by:
        item = _order_item(ast, items, list(out_names))
        if item is None:
            return [], stmt.limit
        keys.append((item, asc, asc if nulls_first is None else nulls_first))
    return keys, stmt.limit


def _key_value(row: dict, key):
    return key(row) if isinstance(key, OrderExpr) else row[key]


def _key_columns(keys: Sequence[OrderKey]) -> List[str]:
    """The output columns the keys read."""
    out: List[str] = []
    for key, _, _ in keys:
        for c in (key.columns if isinstance(key, OrderExpr) else [key]):
            if c not in out:
                out.append(c)
    return out


def values_equal(a, b, rtol: float) -> bool:
    """Nulls equal nulls, floats within ``rtol`` (NaN equals NaN, infs
    exactly), everything else exactly."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isnan(fb):
            return math.isnan(fa) and math.isnan(fb)
        if math.isinf(fa) or math.isinf(fb):
            return fa == fb
        return abs(fa - fb) <= rtol * max(abs(fa), abs(fb))
    return a == b


def _canonical(rows: Sequence[dict]) -> List[dict]:
    """Rows sorted by their non-float values, then their floats."""
    def key(r):
        exact = [(v is None, "" if v is None else str(v))
                 for v in r.values() if not isinstance(v, float)]
        floats = [(v is None, 0.0 if v is None else v)
                  for v in r.values() if isinstance(v, float)]
        return exact, floats
    return sorted(rows, key=key)


def _same_multiset(got: Sequence[dict], ref: Sequence[dict], rtol: float,
                   cols: Optional[Sequence[str]] = None) -> Optional[str]:
    if cols is not None:
        got = [{c: r[c] for c in cols} for r in got]
        ref = [{c: r[c] for c in cols} for r in ref]
    if len(got) != len(ref):
        return f"{len(got)} rows, expected {len(ref)}"
    for i, (g, r) in enumerate(zip(_canonical(got), _canonical(ref))):
        if list(g) != list(r):
            return f"columns {list(g)}, expected {list(r)}"
        for k in r:
            if not values_equal(g[k], r[k], rtol):
                return f"row {i} column {k}: {g[k]!r}, expected {r[k]!r}"
    return None


def _sort_key(row: dict, keys: Sequence[OrderKey]):
    """A tuple whose ascending order is the ORDER BY order."""
    out = []
    for key, asc, nulls_first in keys:
        v = _key_value(row, key)
        null_rank = 0 if (v is None) == nulls_first else 1
        if v is None:
            out.append((null_rank, 0))
        elif isinstance(v, str):
            b = v.encode("utf-8")
            out.append((null_rank, b if asc else _Desc(b)))
        else:
            out.append((null_rank, v if asc else -v))
    return tuple(out)


class _Desc:
    """Reverses the order of bytes values inside a sort key."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return self.v > other.v

    def __eq__(self, other):
        return self.v == other.v


def sort_rows(rows: Sequence[dict], keys: Sequence[OrderKey]) -> List[dict]:
    """``rows`` in ORDER BY order (a stable sort: ties keep their
    order)."""
    return sorted(rows, key=lambda r: _sort_key(r, keys))


def is_ordered(rows: Sequence[dict], keys: Sequence[OrderKey]) -> bool:
    """True when ``rows`` are in ORDER BY order (ties in any order)."""
    ks = [_sort_key(r, keys) for r in rows]
    return all(not (b < a) for a, b in zip(ks, ks[1:]))


def compare_rows(got: Sequence[dict], ref: Sequence[dict],
                 keys: Sequence[OrderKey], limit: Optional[int],
                 rtol: float) -> Optional[str]:
    """None when ``got`` equals ``ref`` under the rules above, else what
    differs. ``got`` must also be in ORDER BY order. Where the LIMIT cut
    a group of rows tied on the ORDER BY keys, that group compares on
    the keys only."""
    if keys and not is_ordered(got, keys):
        return "rows are not in ORDER BY order"
    cut = limit is not None and len(ref) == limit and keys
    if not cut:
        return _same_multiset(got, ref, rtol)
    if len(got) != len(ref):
        return f"{len(got)} rows, expected {len(ref)}"
    last = [_key_value(ref[-1], k) for k, _, _ in keys]

    def tied(r):
        return all(values_equal(_key_value(r, k), v, rtol)
                   for (k, _, _), v in zip(keys, last))
    diff = _same_multiset([r for r in got if not tied(r)],
                          [r for r in ref if not tied(r)], rtol)
    if diff is not None:
        return diff
    return _same_multiset([r for r in got if tied(r)],
                          [r for r in ref if tied(r)], rtol,
                          _key_columns(keys))
