"""Two decimal types meeting outside arithmetic (ROADMAP.md C16), on the
CPU.

DECIMAL(7,2) against DECIMAL(10,3) in inner, left outer and full outer
joins, ``IN (subquery)``, ``NOT IN`` (with and without a NULL in the
subquery) and ``EXISTS``; an INT key against DECIMAL(10,3); ``CASE``
over DECIMAL(7,2) and DECIMAL(18,0), typed DECIMAL(20,2); and
``concat(s, NULL)``. The port's rows are held against plain Python with
``decimal`` at 80 digits. The JAX package's ``promote`` refuses two
decimal types (``spark_rapids_tpu/columnar/dtypes.py:315``), so its side
of these cases is asserted to raise: a LEFT ANTI join between the two
types too, through the DataFrame API. Where it runs (NOT IN over a
subquery holding a NULL, which its plan-time count settles) both
packages and plain Python agree.
"""

import decimal
from decimal import Decimal as D

import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.plan.session import TpuSession

CTX = decimal.Context(prec=80)

T = {"id": [0, 1, 2, 3, 4, 5, 6],
     "k72": [D("1.00"), D("2.50"), D("3.10"), None, D("-7.25"), D("2.50"),
             D("99999.99")],
     "i": [1, 2, 3, 4, None, -7, 4],
     "x": [D("10"), D("-3"), None, D("999999999999999999"), D("0"),
           D("5"), D("-999999999999999999")],
     "s": ["a", None, "c", "d", "e", "f", ""]}
U = {"uid": [10, 11, 12, 13, 14, 15],
     "k103": [D("1.000"), D("2.500"), D("3.105"), D("-7.250"), D("4.000"),
              None]}
U2 = {"uid": [20, 21], "k103": [D("1.000"), None]}


def _schemas(t):
    return {
        "t": [("id", t.INT64), ("k72", t.DecimalType(7, 2)),
              ("i", t.INT32), ("x", t.DecimalType(18, 0)),
              ("s", t.STRING)],
        "u": [("uid", t.INT64), ("k103", t.DecimalType(10, 3))],
        "u2": [("uid", t.INT64), ("k103", t.DecimalType(10, 3))]}


def _register(session, types):
    for name, data in (("t", T), ("u", U), ("u2", U2)):
        session.create_or_replace_temp_view(name, session.create_dataframe(
            data, _schemas(types)[name]))


def _rows(name):
    data = {"t": T, "u": U, "u2": U2}[name]
    keys = list(data)
    return [dict(zip(keys, vals)) for vals in zip(*data.values())]


def _eq(a, b):
    """SQL equality of two values: None when either is NULL."""
    if a is None or b is None:
        return None
    return CTX.compare(D(a), D(b)) == 0


def _join(kind, lkey, rkey):
    t, u = _rows("t"), _rows("u")
    out = []
    matched_u = set()
    for r in t:
        hits = [s for s in u if _eq(r[lkey], s[rkey])]
        for s in hits:
            matched_u.add(s["uid"])
            out.append((r["id"], s["uid"]))
        if not hits and kind in ("left", "full"):
            out.append((r["id"], None))
    if kind == "full":
        out += [(None, s["uid"]) for s in u if s["uid"] not in matched_u]
    return sorted(out, key=lambda p: (p[0] is not None, p[0] or 0,
                                      p[1] is not None, p[1] or 0))


def _in(negate, table, drop_nulls=False):
    keys = [s["k103"] for s in _rows(table)
            if not (drop_nulls and s["k103"] is None)]
    out = []
    for r in _rows("t"):
        vals = [_eq(r["k72"], k) for k in keys]
        if any(v is True for v in vals):
            res = True
        elif any(v is None for v in vals):
            res = None
        else:
            res = False
        if negate:
            res = None if res is None else not res
        if res:
            out.append(r["id"])
    return out


def _case():
    out = []
    for r in _rows("t"):
        v = r["k72"] if (r["i"] is not None and r["i"] > 2) else r["x"]
        out.append(None if v is None else D(v).quantize(D("0.01")))
    return out


CASES = {
    "inner": ("SELECT id, uid FROM t JOIN u ON t.k72 = u.k103",
              lambda: _join("inner", "k72", "k103")),
    "left_outer": ("SELECT id, uid FROM t LEFT OUTER JOIN u "
                   "ON t.k72 = u.k103",
                   lambda: _join("left", "k72", "k103")),
    "full_outer": ("SELECT id, uid FROM t FULL OUTER JOIN u "
                   "ON t.k72 = u.k103",
                   lambda: _join("full", "k72", "k103")),
    "in_subquery": ("SELECT id FROM t WHERE k72 IN (SELECT k103 FROM u)",
                    lambda: _in(False, "u")),
    "not_in": ("SELECT id FROM t WHERE k72 NOT IN "
               "(SELECT k103 FROM u WHERE k103 IS NOT NULL)",
               lambda: _in(True, "u", drop_nulls=True)),
    "exists": ("SELECT id FROM t WHERE EXISTS "
               "(SELECT 1 FROM u WHERE u.k103 = t.k72)",
               lambda: _in(False, "u")),
    "int_key": ("SELECT id, uid FROM t JOIN u ON t.i = u.k103",
                lambda: _join("inner", "i", "k103")),
}


@pytest.fixture(scope="module")
def port():
    s = TpuSession(device="cpu")
    _register(s, dt)
    return s


@pytest.fixture(scope="module")
def jax_session():
    with pytest.MonkeyPatch.context() as mp, decimal.localcontext() as c:
        c.prec = 80
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        s = JSession()
        _register(s, jdt)
        yield s


def _pairs(rows):
    return sorted(((r["id"], r.get("uid")) if "uid" in r else r["id"]
                   for r in rows),
                  key=lambda p: (p[0] is not None, p[0] or 0,
                                 p[1] is not None, p[1] or 0)
                  if isinstance(p, tuple) else p)


@pytest.mark.parametrize("case", list(CASES))
def test_c16_port_against_python_jax_raises(port, jax_session, case):
    text, want = CASES[case]
    got = _pairs(port.sql(text).collect())
    expected = want()
    if case in ("in_subquery", "not_in", "exists"):
        assert got == sorted(expected), (case, got)
        assert case != "not_in" or expected  # a row survives NOT IN
    else:
        assert got == expected, (case, got)
    with decimal.localcontext() as c, pytest.raises(
            TypeError, match="decimal promotion"):
        c.prec = 80
        jax_session.sql(text).collect()


def test_c16_case_typed_decimal_20_2(port, jax_session):
    text = "SELECT id, CASE WHEN i > 2 THEN k72 ELSE x END AS c FROM t"
    df = port.sql(text)
    assert dict(df.schema)["c"] == dt.DecimalType(20, 2)
    rows = sorted(df.collect(), key=lambda r: r["id"])
    assert [r["c"] for r in rows] == _case()
    with pytest.raises(TypeError, match="decimal promotion"):
        jax_session.sql(text).collect()


def test_c16_concat_with_null(port, jax_session):
    text = "SELECT id, concat(s, NULL) AS c FROM t"
    rows = port.sql(text).collect()
    assert len(rows) == len(T["id"]) and all(r["c"] is None for r in rows)
    assert dict(port.sql(text).schema)["c"] == dt.STRING
    with pytest.raises(TypeError):
        jax_session.sql(text).collect()


def test_c16_not_in_over_a_null_both_agree(port, jax_session):
    text = "SELECT id FROM t WHERE k72 NOT IN (SELECT k103 FROM u2)"
    want = _in(True, "u2")
    assert want == []
    assert [r["id"] for r in port.sql(text).collect()] == want
    with decimal.localcontext() as c:
        c.prec = 80
        assert [r["id"] for r in jax_session.sql(text).collect()] == want


def test_c16_left_anti_join(port, jax_session):
    """The port's anti join by value; the JAX package refuses the two
    key types here as well."""
    from spark_rapids_tpu.expr.core import col as jcol
    want = sorted(r["id"] for r in _rows("t")
                  if not any(_eq(r["k72"], s["k103"]) for s in _rows("u")))
    got = port.table("t").join(port.table("u"), on=([col("k72")],
                                                    [col("k103")]),
                               how="anti").collect()
    assert sorted(r["id"] for r in got) == want == [2, 3, 6]
    with decimal.localcontext() as c, pytest.raises(
            TypeError, match="decimal promotion"):
        c.prec = 80
        jax_session.table("t").join(
            jax_session.table("u"), on=([jcol("k72")], [jcol("k103")]),
            how="anti").collect()
