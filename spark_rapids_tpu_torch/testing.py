"""Result comparison for queries with ORDER BY and LIMIT.

Counterpart of spark_rapids_tpu/testing/asserts.py's value rules
(``_values_equal``) and of nds_check's unordered row-set comparison,
extended for the case the JAX package's suite sidesteps: when a LIMIT
cuts through rows that tie on the ORDER BY keys, two engines may keep
different members of the tied group. ``compare_rows`` then compares the
rows before the tied group in full and the tied group on its count and
keys only; ``order_keys`` reads the ORDER BY and LIMIT from the query
text.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from .sql.parser import ColA, LitA, Parser

OrderKey = Tuple[str, bool, bool]  # (output column, ascending, nulls first)


def order_keys(text: str, out_names: Sequence[str]
               ) -> Tuple[List[OrderKey], Optional[int]]:
    """The statement's ORDER BY as output columns, and its LIMIT.
    Spark's defaults: NULLS FIRST ascending, NULLS LAST descending."""
    stmt = Parser(text).parse_statement()
    keys = []
    for ast, asc, nulls_first in stmt.order_by:
        if isinstance(ast, LitA):
            name = out_names[ast.value - 1]
        elif isinstance(ast, ColA):
            name = next(n for n in out_names
                        if n.lower() == ast.name.lower())
        else:
            raise ValueError(f"ORDER BY {ast!r} is not an output column")
        keys.append((name, asc, asc if nulls_first is None else nulls_first))
    return keys, stmt.limit


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
    for name, asc, nulls_first in keys:
        v = row[name]
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
    names = [k for k, _, _ in keys]
    last = [ref[-1][k] for k in names]

    def tied(r):
        return all(values_equal(r[k], v, rtol) for k, v in zip(names, last))
    diff = _same_multiset([r for r in got if not tied(r)],
                          [r for r in ref if not tied(r)], rtol)
    if diff is not None:
        return diff
    return _same_multiset([r for r in got if tied(r)],
                          [r for r in ref if tied(r)], rtol, names)
