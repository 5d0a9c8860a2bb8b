"""Set operations through both packages' ``session.sql`` on the CPU.

UNION ALL, UNION, INTERSECT and EXCEPT (two-way, three-way and
chained, under an ORDER BY + LIMIT, under a GROUP BY and under a
COUNT) over the same seeded tables with NULLs, NaN and duplicates run
through the port and the JAX package, and against plain Python set
semantics: UNION ALL keeps every row, UNION, INTERSECT and EXCEPT give
distinct rows, and NULL equals NULL (as does NaN NaN). Rows compare as
multisets, numbers as floats (a join or a union copies values, so
exactly).

Branches whose types differ are not cast in either package: a UNION's
schema is its first branch's, and each branch's batches keep their own
types until a concat meets them at the promoted physical type (an INT
column holding 2.5 from a DOUBLE branch). The port answers as the JAX
package does there; a string column against a non-string one, which the
JAX package passes on as a mixed column, raises in the port.
INTERSECT ALL and EXCEPT ALL raise in both.

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

from collections import Counter

import numpy as np
import pytest

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.sql.parser import SqlError
from spark_rapids_tpu_torch.testing import compare_rows, order_keys

N = 60


def _tables():
    rng = np.random.default_rng(21)
    words = np.array(["a", "bb", "", "ccc"], object)

    def table(seed_shift, n):
        r = np.random.default_rng(21 + seed_shift)
        d = np.round(r.uniform(0, 3, n), 0)
        d[r.random(n) < 0.1] = np.nan
        return {"a": (r.integers(0, 6, n).astype(np.int32),
                      r.random(n) > 0.15, "int"),
                "s": (words[r.integers(0, 4, n)], r.random(n) > 0.15,
                      "string"),
                "d": (d, r.random(n) > 0.1, "double")}
    t3 = {"b": (rng.integers(0, 4, 20).astype(np.int64),
                rng.random(20) > 0.2, "bigint"),
          "a": (rng.integers(0, 6, 20).astype(np.int64),
                rng.random(20) > 0.2, "bigint")}
    return {"t1": table(0, N), "t2": table(1, N), "t3": t3}


@pytest.fixture(scope="module")
def sessions():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan import host_table as jhost
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        from spark_rapids_tpu.sql.parser import SqlError as JSqlError
        settings = {"srt.sql.batchSizeRows": 16}
        port = TpuSession(carry.conf_from_dict(settings), device="cpu")
        jax = JSession(JConf(settings))
        jtypes = {"int": jdt.INT32, "bigint": jdt.INT64,
                  "double": jdt.FLOAT64, "string": jdt.STRING}
        for name, lanes in _tables().items():
            port.create_or_replace_temp_view(name, port.create_dataframe(
                carry.host_table_from_lanes(lanes)))
            table = jhost.HostTable(
                [jhost.HostColumn(v, m, jtypes[t])
                 for v, m, t in lanes.values()], list(lanes))
            jax.create_or_replace_temp_view(name, jax.create_dataframe(
                jhost.to_pydict(table), table.schema()))
        yield port, jax, JSqlError


def _py(name, cols):
    """Rows of a table's columns as tuples, None for null."""
    lanes = _tables()[name]
    out = []
    for i in range(len(next(iter(lanes.values()))[0])):
        row = []
        for c in cols:
            v, m, _ = lanes[c]
            row.append((v[i].item() if hasattr(v[i], "item") else v[i])
                       if m[i] else None)
        out.append(tuple(row))
    return out


def _key(v):
    """A value's set identity: numbers as floats (NaN = NaN), NULL as
    itself."""
    if v is None or isinstance(v, str):
        return v
    return "nan" if v != v else float(v)


def _canon(rows):
    return Counter(tuple(_key(v) for v in r) for r in rows)


def _distinct(rows):
    return list({tuple(_key(v) for v in r): r for r in rows}.values())


def _intersect(a, b):
    kb = {tuple(_key(v) for v in r) for r in b}
    return [r for r in _distinct(a) if tuple(_key(v) for v in r) in kb]


def _except(a, b):
    kb = {tuple(_key(v) for v in r) for r in b}
    return [r for r in _distinct(a) if tuple(_key(v) for v in r) not in kb]


def _grouped_sum(rows):
    out = {}
    for a, s in rows:
        out.setdefault(_key(s), [s, None])
        if a is not None:
            out[_key(s)][1] = (out[_key(s)][1] or 0) + a
    return [tuple(v) for v in out.values()]


T1, T2 = (lambda c: _py("t1", c)), (lambda c: _py("t2", c))

#: name -> (SQL, plain Python rows)
QUERIES = {
    "union_all": ("SELECT a, s FROM t1 UNION ALL SELECT a, s FROM t2",
                  lambda: T1(["a", "s"]) + T2(["a", "s"])),
    "union": ("SELECT a, s FROM t1 UNION SELECT a, s FROM t2",
              lambda: _distinct(T1(["a", "s"]) + T2(["a", "s"]))),
    "intersect": ("SELECT a, s, d FROM t1 INTERSECT SELECT a, s, d FROM t2",
                  lambda: _intersect(T1(["a", "s", "d"]),
                                     T2(["a", "s", "d"]))),
    "except": ("SELECT a, s FROM t1 EXCEPT SELECT a, s FROM t2",
               lambda: _except(T1(["a", "s"]), T2(["a", "s"]))),
    "except_chained": (
        "SELECT a FROM t1 EXCEPT SELECT a FROM t2 WHERE s = 'a' "
        "EXCEPT SELECT a FROM t3 WHERE b = 0",
        lambda: _except(_except(T1(["a"]), [r[:1] for r in T2(["a", "s"])
                                            if r[1] == "a"]),
                        [r[1:] for r in _py("t3", ["b", "a"])
                         if r[0] == 0])),
    "union_all_three_way": (
        "SELECT a, s FROM t1 WHERE a > 2 UNION ALL "
        "SELECT a, s FROM t2 WHERE a < 5 UNION ALL "
        "SELECT a, s FROM t1 WHERE s IS NULL",
        lambda: [r for r in T1(["a", "s"]) if r[0] is not None and r[0] > 2]
        + [r for r in T2(["a", "s"]) if r[0] is not None and r[0] < 5]
        + [r for r in T1(["a", "s"]) if r[1] is None]),
    "count_of_intersect": (
        "SELECT COUNT(*) AS c FROM (SELECT a, s FROM t1 INTERSECT "
        "SELECT a, s FROM t2) x",
        lambda: [(len(_intersect(T1(["a", "s"]), T2(["a", "s"]))),)]),
    "group_by_over_union_all": (
        "SELECT s, SUM(a) AS total FROM (SELECT a, s FROM t1 UNION ALL "
        "SELECT a, s FROM t2) u GROUP BY s",
        lambda: _grouped_sum(T1(["a", "s"]) + T2(["a", "s"]))),
    "int_union_all_double": ("SELECT a FROM t1 UNION ALL SELECT d FROM t2",
                             lambda: T1(["a"]) + T2(["d"])),
    "int_union_double": ("SELECT a FROM t1 UNION SELECT d FROM t2",
                         lambda: _distinct(T1(["a"]) + T2(["d"]))),
    "double_intersect_bigint": (
        "SELECT d FROM t1 INTERSECT SELECT b FROM t3",
        lambda: _intersect(T1(["d"]), _py("t3", ["b"]))),
    "int_except_bigint": ("SELECT a FROM t1 EXCEPT SELECT b FROM t3",
                          lambda: _except(T1(["a"]), _py("t3", ["b"]))),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_set_operation_matches_jax_and_python(name, sessions):
    port, jax, _ = sessions
    text, python = QUERIES[name]
    got = port.sql(text).collect()
    ref = jax.sql(text).collect()
    assert got and list(got[0]) == list(ref[0])
    assert _canon(r.values() for r in got) == \
        _canon(r.values() for r in ref) == _canon(python())


def test_order_by_and_limit_apply_to_the_whole_set_operation(sessions):
    port, jax, _ = sessions
    text = ("SELECT s, a FROM t1 UNION SELECT s, a FROM t2 "
            "ORDER BY a DESC, s LIMIT 7")
    df = port.sql(text)
    got, ref = df.collect(), jax.sql(text).collect()
    keys, limit = order_keys(text, df.columns)
    assert limit == 7 and len(got) == 7
    assert compare_rows(got, ref, keys, limit, 1e-9) is None
    want = sorted(_distinct(_py("t1", ["s", "a"]) + _py("t2", ["s", "a"])),
                  key=lambda r: (r[1] is None, -(r[1] or 0),
                                 r[0] is not None, r[0] or ""))
    assert [(r["s"], r["a"]) for r in got] == want[:7]


@pytest.mark.parametrize("op", ["INTERSECT ALL", "EXCEPT ALL"])
def test_all_variants_of_intersect_and_except_raise(op, sessions):
    port, jax, jax_error = sessions
    text = f"SELECT a FROM t1 {op} SELECT a FROM t2"
    with pytest.raises(SqlError, match="ALL is not supported"):
        port.sql(text)
    with pytest.raises(jax_error, match="ALL is not supported"):
        jax.sql(text)


def test_string_against_non_string_branch_raises(sessions):
    port, _, _ = sessions
    with pytest.raises(NotImplementedError, match="not in this port yet"):
        port.sql("SELECT a FROM t1 UNION ALL SELECT s FROM t2")


def test_dataframe_union_and_distinct(sessions):
    port, _, _ = sessions
    t1, t2 = port.table("t1"), port.table("t2")
    both = t1.select("a", "s").union(t2.select("a", "s"))
    assert "Union[2]" in both.explain()
    rows = both.collect()
    assert _canon(r.values() for r in rows) == \
        _canon(_py("t1", ["a", "s"]) + _py("t2", ["a", "s"]))
    distinct = both.distinct().collect()
    assert _canon(r.values() for r in distinct) == _canon(
        _distinct(_py("t1", ["a", "s"]) + _py("t2", ["a", "s"])))
