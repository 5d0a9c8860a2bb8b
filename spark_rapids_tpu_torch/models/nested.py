"""Nested tables over the TPC-H lineitem and orders, and the queries
N1-N7 over them (``chip_smoke.py`` phase 5d, tests/test_torch_nested.py).

``orders_nested``: lineitem, stably sorted on ``l_orderkey``, cut into
orders of 1-7 lines (TPC-H's lines per order, drawn from a seed; the
generated ``l_orderkey`` is zipf(1.5), so grouping by it would give one
order 38% of the lines). Each order holds the arrays ``price``,
``disc``, ``qty`` (DOUBLE), ``ship`` (DATE) and ``flags`` (STRING, the
return flags); every 101st order's ``price`` array is NULL.

``orders_json``: one JSON document per order, its priority and total
price from the orders table and an ``items`` array of the prices of its
first two lines, with key order and whitespace varied, a ``note`` with
escaped quotes and backslashes on every fifth, and every 97th document
cut short (malformed, so NULL for every path).

The queries take the expression API as an argument (``port_api()``, or
the JAX package's modules of the same names in the tests), so one text
builds both packages' plans. The numpy references work on the same host
lanes with segment reductions.
"""

from __future__ import annotations

import datetime
import json
from types import SimpleNamespace
from typing import Dict

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.nested import HostList
from ..columnar.vector import HostStrings
from ..plan.host_table import HostColumn, HostTable

NULL_PRICE_EVERY = 101
MALFORMED_EVERY = 97
NOTE_EVERY = 5
#: the lines of an order its JSON document lists
DOC_ITEMS = 2
#: the order range N3 compares row by row
N3_RANGE = (1000, 1064)
LATE = datetime.date(1998, 1, 1)
LATE_DAYS = (LATE - datetime.date(1970, 1, 1)).days


def port_api() -> SimpleNamespace:
    """The port's expression modules, as the queries take them."""
    from ..expr import aggregates, cast, collections, core, higher_order, \
        strings
    return SimpleNamespace(col=core.col, lit=core.lit, Alias=core.Alias,
                           CX=collections, HO=higher_order, Agg=aggregates,
                           Cast=cast.Cast, S=strings, dt=dt)


def order_offsets(n_lines: int, seed: int = 11) -> np.ndarray:
    """int64 offsets of orders of 1-7 lines covering ``n_lines``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 8, n_lines // 4 + 16)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, n_lines)) + 1
    offsets = np.zeros(k + 1, np.int64)
    offsets[1:] = np.minimum(ends[:k], n_lines)
    return offsets


class NestedOrders:
    """The host lanes of ``orders_nested``: per order its offsets into
    the sorted line lanes (``lines[name]``), and the price array's mask."""

    def __init__(self, lineitem: HostTable, seed: int = 11):
        key = lineitem.column("l_orderkey").values
        perm = np.argsort(key, kind="stable")
        self.sorted_key = key[perm]
        self.offsets = order_offsets(len(key), seed)
        self.n = len(self.offsets) - 1
        self.lines = {}
        for name in ("l_extendedprice", "l_discount", "l_quantity",
                     "l_shipdate"):
            self.lines[name] = lineitem.column(name).values[perm]
        self.flags = lineitem.column("l_returnflag").values.take(perm)
        self.orderkey = np.arange(self.n, dtype=np.int64)
        self.price_valid = self.orderkey % NULL_PRICE_EVERY != \
            NULL_PRICE_EVERY - 1
        self.lens = np.diff(self.offsets)
        self.row = np.repeat(np.arange(self.n), self.lens)

    def table(self) -> HostTable:
        ones = np.ones(len(self.row), bool)
        every = np.ones(self.n, bool)

        def lst(values):
            return HostList(self.offsets, values, ones)
        cols = [
            HostColumn(self.orderkey, every, dt.INT64),
            HostColumn(lst(self.lines["l_extendedprice"]), self.price_valid,
                       dt.ArrayType(dt.FLOAT64)),
            HostColumn(lst(self.lines["l_discount"]), every,
                       dt.ArrayType(dt.FLOAT64)),
            HostColumn(lst(self.lines["l_quantity"]), every,
                       dt.ArrayType(dt.FLOAT64)),
            HostColumn(lst(self.lines["l_shipdate"]), every,
                       dt.ArrayType(dt.DATE)),
            HostColumn(lst(self.flags), every, dt.ArrayType(dt.STRING)),
        ]
        return HostTable(cols, ["o_orderkey", "price", "disc", "qty",
                                "ship", "flags"])


def _doc_templates():
    """(spaced, key order) -> a %-template of (priority, total, items
    [, note])."""
    out = {}
    for sp in ("", " "):
        for note in (False, True):
            fields = [f'"o_orderpriority":{sp}"%(p)s"',
                      f'"o_totalprice":{sp}%(t)s',
                      f'"items":{sp}[%(i)s]']
            if note:
                fields.append(f'"note":{sp}"say \\"%(n)d\\" \\\\ ok"')
            for k in range(3):
                f = fields[k:] + fields[:k]
                out[sp, note, k] = "{" + sp + ("," + sp).join(f) + sp + "}"
    return out


def json_docs(no: NestedOrders, orders: HostTable, n_docs: int) -> list:
    """``n_docs`` JSON documents (str), one per order from the first;
    ``items`` holds the prices of an order's first DOC_ITEMS lines (a
    float's repr is most of the build's time)."""
    prio = orders.column("o_orderpriority").values.to_objects().tolist()
    total = list(map(repr, orders.column("o_totalprice").values.tolist()))
    offs = no.offsets[:n_docs + 1]
    counts = np.minimum(np.diff(offs), DOC_ITEMS)
    first = np.repeat(offs[:-1], counts) + (
        np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts,
                                                 counts))
    # every document's items in one string, cut at its items' ends
    prices = list(map(repr, no.lines["l_extendedprice"][first].tolist()))
    head, tail = '{"price":', "}"
    joined = head + (tail + "," + head).join(prices) + tail
    at = np.zeros(len(prices) + 1, np.int64)
    at[1:] = np.cumsum(np.fromiter(map(len, prices), np.int64, len(prices))
                       + len(head) + len(tail) + 1)
    ends = np.cumsum(counts)
    starts = at[ends - counts].tolist()
    stops = (at[ends] - 1).tolist()
    tmpl = _doc_templates()
    docs = []
    for i in range(n_docs):
        o = i % len(prio)
        doc = tmpl[" " if i % 2 else "", i % NOTE_EVERY == 0, i % 3] % {
            "p": prio[o], "t": total[o],
            "i": joined[starts[i]:stops[i]], "n": i}
        if i % MALFORMED_EVERY == MALFORMED_EVERY - 1:
            doc = doc[:-3]
        docs.append(doc)
    return docs


def json_table(docs) -> HostTable:
    return HostTable([HostColumn(HostStrings.from_objects(docs),
                                 np.ones(len(docs), bool), dt.STRING)],
                     ["doc"])


N6_SQL = """
SELECT prio, SUM(total) AS total, SUM(p1) AS p1, COUNT(note) AS notes,
       COUNT(*) AS n
FROM (SELECT get_json_object(doc, '$.o_orderpriority') AS prio,
             CAST(get_json_object(doc, '$.o_totalprice') AS DOUBLE) AS total,
             CAST(get_json_object(doc, '$.items[1].price') AS DOUBLE) AS p1,
             get_json_object(doc, '$.note') AS note
      FROM orders_json) t
GROUP BY prio
ORDER BY prio
"""


def n4_maps(a, on):
    """N4's maps: keys 1..n over each order's prices."""
    col, Alias, HO = a.col, a.Alias, a.HO
    m = HO.map_from_arrays(HO.transform(col("price"), lambda x, i: i + 1),
                           col("price"))
    return on.select(col("o_orderkey"), Alias(m, "m"))


def n4_explode(a, on):
    """explode of N4's maps into Spark's ``key`` and ``value`` columns,
    summed (the port's; the JAX package's DataFrame refuses a map)."""
    col, Alias, Agg = a.col, a.Alias, a.Agg
    return n4_maps(a, on).select(a.CX.explode(col("m"))).agg(
        Alias(Agg.CountStar(), "n"), Alias(Agg.Sum(col("key")), "ks"),
        Alias(Agg.Sum(col("value")), "vs"))


def queries(a, on, li) -> Dict[str, object]:
    """N1-N5 and N7 as DataFrames of the package whose API ``a`` is,
    over its ``orders_nested`` (``on``) and lineitem (``li``)."""
    col, lit, Alias, CX, HO, Agg = a.col, a.lit, a.Alias, a.CX, a.HO, a.Agg
    out = {}
    z = CX.ArraysZip(col("price"), col("disc"))
    ex = on.select(CX.posexplode(z))
    f0 = CX.GetStructField(col("col"), "0")
    f1 = CX.GetStructField(col("col"), "1")
    out["N1"] = ex.group_by("pos").agg(
        Alias(Agg.Sum(f0 * (lit(1.0) - f1)), "rev"),
        Alias(Agg.CountStar(), "n")).sort("pos")
    rev = HO.aggregate(CX.zip_with(col("price"), col("disc"),
                                   lambda p, d: p * (lit(1.0) - d)),
                       lit(0.0), lambda acc, x: acc + x)
    per = on.select(
        Alias(rev, "rev"),
        Alias(CX.Size(HO.filter_(col("qty"), lambda q: q > lit(45.0))),
              "big"),
        Alias(a.Cast(HO.exists(col("ship"), lambda s: s > lit(LATE)),
                     a.dt.INT64), "late"),
        Alias(a.Cast(HO.forall(col("disc"), lambda d: d < lit(0.1)),
                     a.dt.INT64), "cheap"))
    out["N2"] = per.agg(Alias(Agg.Sum(col("rev")), "rev"),
                        Alias(Agg.Sum(col("big")), "big"),
                        Alias(Agg.Sum(col("late")), "late"),
                        Alias(Agg.Sum(col("cheap")), "cheap"),
                        Alias(Agg.Count(col("late")), "n_late"))
    grid = CX.array(lit(0.0), lit(0.05), lit(0.1))
    n3 = {
        "amin": CX.ArrayMin(col("price")),
        "amax": CX.ArrayMax(col("price")),
        "sdesc": CX.ElementAt(CX.SortArray(col("disc"), False), lit(1)),
        "sasc": CX.ElementAt(CX.SortArray(col("price")), lit(2)),
        "ndist": CX.Size(CX.ArrayDistinct(col("disc"))),
        "last": CX.ElementAt(col("price"), lit(-1)),
        "nslice": CX.Size(CX.Slice(col("qty"), lit(2), lit(3))),
        "pos05": CX.ArrayPosition(col("disc"), lit(0.05)),
        "has0": a.Cast(CX.ArrayContains(col("disc"), lit(0.0)),
                       a.dt.INT64),
        "rfirst": CX.ElementAt(CX.ArrayReverse(col("qty")), lit(1)),
        "nflat": CX.Size(CX.Flatten(CX.array(col("price"), col("qty")))),
        "nunion": CX.Size(CX.ArrayUnion(col("disc"), grid)),
        "ninter": CX.Size(CX.ArrayIntersect(col("disc"), grid)),
        "nexcept": CX.Size(CX.ArrayExcept(col("disc"), grid)),
        "overlap": a.Cast(CX.ArraysOverlap(col("disc"), grid), a.dt.INT64),
        "joined": a.S.Length(CX.ArrayJoin(col("flags"), ",")),
    }
    out["N3"] = on.select(*[Alias(e, k) for k, e in n3.items()]).agg(
        *[Alias(Agg.Sum(col(k)), k) for k in n3])
    lo, hi = N3_RANGE
    out["N3_rows"] = on.filter((col("o_orderkey") >= lit(lo)) &
                               (col("o_orderkey") < lit(hi))).select(
        col("o_orderkey"),
        Alias(CX.SortArray(col("price")), "sorted"),
        Alias(CX.ArrayDistinct(col("disc")), "dist"),
        Alias(CX.Slice(col("qty"), lit(2), lit(3)), "slice"),
        Alias(CX.ArrayReverse(col("ship")), "rev"),
        Alias(CX.Flatten(CX.array(col("price"), col("qty"))), "flat"),
        Alias(CX.ArrayUnion(col("disc"), grid), "uni"),
        Alias(CX.ArrayIntersect(col("disc"), grid), "inter"),
        Alias(CX.ArrayExcept(col("disc"), grid), "exc"),
        Alias(CX.ArrayJoin(col("flags"), ","), "joined")).sort(
        "o_orderkey")
    maps = n4_maps(a, on)
    n4 = {
        "v2": HO.get_map_value(col("m"), lit(2)),
        "nkeys": CX.Size(HO.map_keys(col("m"))),
        "vmax": CX.ArrayMax(HO.map_values(col("m"))),
        "has3": a.Cast(HO.map_contains_key(col("m"), lit(3)), a.dt.INT64),
        "tv": HO.get_map_value(HO.transform_values(
            col("m"), lambda k, v: v * k), lit(1)),
        "nfilt": CX.Size(HO.map_keys(HO.map_filter(
            col("m"), lambda k, v: v > lit(50000.0)))),
        "nent": CX.Size(HO.map_entries(col("m"))),
        "cm": HO.get_map_value(HO.create_map(
            col("o_orderkey"), CX.Size(HO.map_keys(col("m")))),
            col("o_orderkey")),
    }
    out["N4"] = maps.select(*[Alias(e, k) for k, e in n4.items()]).agg(
        *[Alias(Agg.Sum(col(k)), k) for k in n4])
    st = CX.struct(k=col("o_orderkey"), p=CX.ArrayMax(col("price")))
    out["N5_struct"] = on.select(Alias(st, "s")).agg(
        Alias(Agg.Sum(CX.GetStructField(col("s"), "p")), "p"),
        Alias(Agg.Sum(CX.GetStructField(col("s"), "k")), "k"))
    big = HO.filter_(col("price"), lambda p: p > lit(100000.0))
    out["N5_explode"] = on.select(CX.explode_outer(big)).agg(
        Alias(Agg.CountStar(), "n"), Alias(Agg.Count(col("col")), "n_el"),
        Alias(Agg.Sum(col("col")), "s"))
    coll = li.group_by("l_orderkey").agg(
        Alias(Agg.CollectList(col("l_quantity")), "q"))
    out["N7"] = coll.select(Alias(CX.Size(col("q")), "n"),
                            Alias(CX.ArrayMax(col("q")), "mx")).agg(
        Alias(Agg.Sum(col("n")), "n"), Alias(Agg.Sum(col("mx")), "mx"),
        Alias(Agg.CountStar(), "groups"))
    return out


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------


def _dense(no: NestedOrders, values, fill):
    """(orders, 7) view of a line lane (TPC-H's 1-7 lines an order),
    ``fill`` past each order's lines: the references' layout."""
    w = int(no.lens.max()) if no.n else 1
    k = np.arange(w)
    ok = k[None, :] < no.lens[:, None]
    idx = np.minimum(no.offsets[:-1][:, None] + k[None, :],
                     max(len(values) - 1, 0))
    return np.where(ok, values[idx], fill), ok


def references(no: NestedOrders, lineitem: HostTable) -> Dict[str, dict]:
    """N1-N5 and N7 from the host lanes alone, over a dense (orders, 7)
    view of the lines."""
    nan = np.nan
    price, ok = _dense(no, no.lines["l_extendedprice"], nan)
    disc, _ = _dense(no, no.lines["l_discount"], nan)
    qty, _ = _dense(no, no.lines["l_quantity"], nan)
    ship, _ = _dense(no, no.lines["l_shipdate"], 0)
    lens, pv = no.lens, no.price_valid
    out = {}
    # N1: arrays_zip(price, disc) by position; NULL price arrays drop out
    rev_el = price * (1.0 - disc)
    out["N1"] = {int(p): (float(np.sum(rev_el[pv & ok[:, p], p])),
                          int(np.sum(pv & ok[:, p])))
                 for p in range(price.shape[1]) if np.any(pv & ok[:, p])}
    # N2 (the fold adds in element order; the sum here to rtol 1e-9)
    rev = np.where(ok, rev_el, 0.0).sum(1)
    out["N2"] = {"rev": float(np.sum(rev[pv])),
                 "big": int(np.sum(ok & (qty > 45.0))),
                 "late": int(np.sum(np.any(ok & (ship > LATE_DAYS), 1))),
                 "cheap": int(np.sum(np.all(~ok | (disc < 0.1), 1))),
                 "n_late": no.n}
    # N3 checksums
    amin = np.where(ok, price, np.inf).min(1)
    amax = np.where(ok, price, -np.inf).max(1)
    has = lens > 0
    last = np.take_along_axis(price, np.maximum(lens - 1, 0)[:, None],
                              1)[:, 0]
    rfirst = np.take_along_axis(qty, np.maximum(lens - 1, 0)[:, None],
                                1)[:, 0]
    second = np.sort(price, 1)[:, 1] if price.shape[1] > 1 else \
        np.full(no.n, nan)
    codes = np.where(ok, np.round(disc * 100), -1).astype(np.int64)
    sc = np.sort(codes, 1)
    ndist = ((sc[:, 1:] != sc[:, :-1]) & (sc[:, 1:] >= 0)).sum(1) + \
        (sc[:, 0] >= 0) if sc.shape[1] > 1 else (sc[:, 0] >= 0)
    ndist = np.where(has, ndist, 0)
    in_grid = sum(np.any(codes == g, 1).astype(np.int64) for g in (0, 5,
                                                                     10))
    hit05 = ok & (codes == 5)
    pos05 = np.where(hit05.any(1), hit05.argmax(1) + 1, 0)
    out["N3"] = {
        "amin": float(amin[pv & has].sum()),
        "amax": float(amax[pv & has].sum()),
        "sdesc": float(np.where(ok, disc, -np.inf).max(1)[has].sum()),
        "sasc": float(second[pv & (lens >= 2)].sum()),
        "ndist": int(ndist.sum()), "last": float(last[pv & has].sum()),
        "nslice": int(np.clip(lens - 1, 0, 3).sum()),
        "pos05": int(pos05.sum()),
        "has0": int(np.any(ok & (codes == 0), 1).sum()),
        "rfirst": float(rfirst[has].sum()),
        "nflat": int((2 * lens)[pv].sum()),
        "nunion": int((ndist + 3 - in_grid).sum()),
        "ninter": int(in_grid.sum()),
        "nexcept": int((ndist - in_grid).sum()),
        "overlap": int(((in_grid > 0) & has).sum()),
        "joined": int(np.where(has, 2 * lens - 1, 0).sum())}
    # N4: keys 1..n over the prices of each order with a price array
    n_pv = int(lens[pv].sum())
    out["N4"] = {"v2": float(price[pv & (lens >= 2), 1].sum()),
                 "nkeys": n_pv, "vmax": out["N3"]["amax"],
                 "has3": int((pv & (lens >= 3)).sum()),
                 "tv": float(price[pv & has, 0].sum()),
                 "nfilt": int((ok & (price > 50000.0))[pv].sum()),
                 "nent": n_pv, "cm": n_pv}
    # N4's maps exploded: Spark's key (1..n) and value columns
    out["N4_explode"] = {"n": n_pv,
                         "ks": int((lens * (lens + 1) // 2)[pv].sum()),
                         "vs": float(price[ok & pv[:, None]].sum())}
    out["N5_struct"] = {"p": out["N3"]["amax"],
                        "k": int(no.orderkey.sum())}
    big = ok & (price > 100000.0) & pv[:, None]
    kept = big.sum(1)
    out["N5_explode"] = {"n": int(np.maximum(kept, 1).sum()),
                         "n_el": int(kept.sum()),
                         "s": float(price[big].sum())}
    # N7: the lines grouped by the (skewed) key, in key order
    starts = np.flatnonzero(np.r_[True, np.diff(no.sorted_key) != 0])
    mx = np.maximum.reduceat(no.lines["l_quantity"], starts) \
        if len(starts) else np.zeros(0)
    out["N7"] = {"n": int(len(no.sorted_key)), "mx": float(mx.sum()),
                 "groups": int(len(starts))}
    return out


def n3_rows_reference(no: NestedOrders) -> list:
    """N3's whole rows over ``N3_RANGE`` from the host lanes."""
    lo, hi = N3_RANGE
    rows = []
    grid = [0.0, 0.05, 0.1]

    def distinct(xs):
        seen, out = set(), []
        for x in xs:
            if x not in seen:
                seen.add(x)
                out.append(x)
        return out
    for i in range(lo, min(hi, no.n)):
        a, b = no.offsets[i], no.offsets[i + 1]
        price = no.lines["l_extendedprice"][a:b].tolist()
        disc = no.lines["l_discount"][a:b].tolist()
        qty = no.lines["l_quantity"][a:b].tolist()
        ship = [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
                for d in no.lines["l_shipdate"][a:b]]
        flags = no.flags.take(np.arange(a, b)).to_objects().tolist()
        pv = bool(no.price_valid[i])
        d = distinct(disc)
        rows.append({
            "o_orderkey": i,
            "sorted": sorted(price) if pv else None,
            "dist": d, "slice": qty[1:4], "rev": ship[::-1],
            "flat": price + qty if pv else None,
            "uni": distinct(disc + grid),
            "inter": [x for x in d if x in grid],
            "exc": [x for x in d if x not in grid],
            "joined": ",".join(flags)})
    return rows


def json_reference(docs) -> dict:
    """N6 from Python's json module: {prio: (total, p1, notes, n)}."""
    groups: dict = {}
    for doc in docs:
        try:
            d = json.loads(doc)
        except ValueError:
            d = None
        prio = total = p1 = note = None
        if isinstance(d, dict):
            prio = d.get("o_orderpriority")
            total = d.get("o_totalprice")
            items = d.get("items")
            if isinstance(items, list) and len(items) > 1:
                p1 = items[1].get("price")
            note = d.get("note")
        g = groups.setdefault(prio, [None, None, 0, 0])
        if total is not None:
            g[0] = (g[0] or 0.0) + float(total)
        if p1 is not None:
            g[1] = (g[1] or 0.0) + float(p1)
        g[2] += note is not None
        g[3] += 1
    return {k: tuple(v) for k, v in groups.items()}
