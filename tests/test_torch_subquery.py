"""Subquery predicates and COUNT(DISTINCT) through both packages'
``session.sql`` on the CPU.

Each shape runs through the port, the JAX package and plain Python over
the same seeded tables (NULLs in every column, NaN in the doubles, 16-row
batches so every table spans several batches):

- correlated and uncorrelated EXISTS / NOT EXISTS (semi and anti joins,
  a plan-time boolean);
- EXISTS with a ``<>`` correlation (q16 and q94: row ids, an inner join
  and a filter, then a semi or anti join on the ids);
- IN / NOT IN with a NULL in the subquery (NOT IN keeps no row), over an
  empty subquery (NOT IN keeps every row, a NULL probe too), and over
  an INTERSECT (q8's shape);
- EXISTS and IN under OR (existence markers over left outer joins);
- a correlated scalar subquery (a grouped aggregate joined left outer;
  an outer row without a match compares with NULL and is filtered out);
- COUNT(DISTINCT) grouped and global, over NULLs and NaN (NaN counts
  once, NULL not at all).

Rows compare as multisets, numbers as floats. The JAX side runs in three
subprocesses of this file (its ``__main__`` block), started before the
module's first test: there the persistent compile cache works, which a
JAX compile inside pytest cannot use (tests/conftest.py wraps jax's
``_cache_read`` with four arguments; this jax passes five).
"""

import json
import math
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from jax_reference import SUBPROCESS_XLA_FLAGS
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.plan.session import TpuSession

N = 60
SETTINGS = {"srt.sql.batchSizeRows": 16}


def _tables():
    r = np.random.default_rng(33)
    words = np.array(["a", "bb", "", "ccc", "dd"], object)
    d = np.round(r.uniform(0, 4, N), 0)
    d[r.random(N) < 0.1] = np.nan
    t1 = {"k": (r.integers(0, 8, N).astype(np.int32), r.random(N) > 0.1,
                "int"),
          "s": (words[r.integers(0, 5, N)], r.random(N) > 0.1, "string"),
          "d": (d, r.random(N) > 0.1, "double"),
          "w": (r.integers(0, 4, N).astype(np.int32), r.random(N) > 0.1,
                "int")}
    m = 40
    t2 = {"k": (r.integers(2, 11, m).astype(np.int32), r.random(m) > 0.1,
                "int"),
          "w": (r.integers(0, 4, m).astype(np.int32), r.random(m) > 0.1,
                "int"),
          "x": (r.uniform(0, 10, m), r.random(m) > 0.1, "double")}
    # t3: k without NULLs, for the NOT IN whose subquery has none
    t3 = {"k": (np.array([1, 3, 5, 7], np.int32), np.ones(4, bool), "int")}
    return {"t1": t1, "t2": t2, "t3": t3}


@pytest.fixture(scope="module")
def port():
    session = TpuSession(carry.conf_from_dict(SETTINGS), device="cpu")
    for name, lanes in _tables().items():
        session.create_or_replace_temp_view(name, session.create_dataframe(
            carry.host_table_from_lanes(lanes)))
    return session


def _jax_side(out_path: str, names) -> None:
    """The JAX package's rows for the QUERIES ``names`` (this file run
    as a script), on one core."""
    if hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[JAX_JOBS.index(tuple(names))
                                       % len(cores)]})
    import jax as jax_
    # every compile persists, as tests/conftest.py sets for the tests
    jax_.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.plan import host_table as jhost
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    jax = JSession(JConf(SETTINGS))
    jtypes = {"int": jdt.INT32, "double": jdt.FLOAT64, "string": jdt.STRING}
    for name, lanes in _tables().items():
        table = jhost.HostTable([jhost.HostColumn(v, m, jtypes[t])
                                 for v, m, t in lanes.values()], list(lanes))
        jax.create_or_replace_temp_view(name, jax.create_dataframe(
            jhost.to_pydict(table), table.schema()))
    out = {name: jax.sql(QUERIES[name][0]).collect() for name in names}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def jax_procs(tmp_path_factory):
    """The JAX side, started before this module's first test: processes
    of their own, whose compile cache works (tests/conftest.py's
    ``_cache_read`` wrapper takes four arguments; this jax passes
    five)."""
    tmp = tmp_path_factory.mktemp("subquery_jax")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        + SUBPROCESS_XLA_FLAGS).strip()
    procs = []
    for i, names in enumerate(JAX_JOBS):
        out = str(tmp / f"out{i}.json")
        # stderr to a file: a pipe left unread would stall the process
        err = open(str(tmp / f"err{i}.txt"), "wb")
        procs.append((out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, *names],
            env=env, stdout=subprocess.DEVNULL, stderr=err)))
    yield procs
    for _, err, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


@pytest.fixture(scope="module")
def jax_results(jax_procs):
    results = {}
    for out, err, proc in jax_procs:
        if proc.wait(timeout=600) != 0:
            err.flush()
            with open(err.name, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            pytest.fail(f"JAX side failed (rc {proc.returncode}):\n{tail}")
        with open(out) as f:
            results.update(json.load(f))
    return results


def _rows(name):
    """A table's rows as dicts, None for null."""
    lanes = _tables()[name]
    n = len(next(iter(lanes.values()))[0])
    return [{c: ((v[i].item() if hasattr(v[i], "item") else v[i])
                 if m[i] else None) for c, (v, m, _) in lanes.items()}
            for i in range(n)]


def _key(v):
    if v is None or isinstance(v, str):
        return v
    return "nan" if v != v else float(v)


def _canon(rows):
    return Counter(tuple(_key(v) for v in r) for r in rows)


def _eq(a, b):
    """SQL '=': NULL if either side is NULL."""
    return None if a is None or b is None else a == b


def _t1(cols, keep):
    return [tuple(r[c] for c in cols) for r in _rows("t1") if keep(r)]


T2, T3 = _rows("t2"), _rows("t3")


def _not_in(v, values):
    """SQL ``v NOT IN (values)``: True, False or None (UNKNOWN)."""
    if not values:
        return True
    if v is None:
        return None
    if any(x == v for x in values if x is not None):
        return False
    return None if any(x is None for x in values) else True


def _count_distinct(values):
    return len({_key(v) for v in values if v is not None})


def _scalar_avg(k):
    xs = [r["x"] for r in T2 if r["k"] is not None and r["k"] == k
          and r["x"] is not None]
    return sum(xs) / len(xs) if xs else None


#: name -> (SQL, plain Python rows)
QUERIES = {
    "exists_correlated": (
        "SELECT k, s FROM t1 WHERE EXISTS "
        "(SELECT * FROM t2 WHERE t2.k = t1.k AND t2.w = 1)",
        lambda: _t1(["k", "s"], lambda r: any(
            _eq(x["k"], r["k"]) and x["w"] == 1 for x in T2))),
    "not_exists_correlated": (
        "SELECT k, s FROM t1 WHERE NOT EXISTS "
        "(SELECT * FROM t2 WHERE t2.k = t1.k)",
        lambda: _t1(["k", "s"], lambda r: not any(
            _eq(x["k"], r["k"]) for x in T2))),
    "exists_uncorrelated_true": (
        "SELECT k FROM t1 WHERE EXISTS (SELECT * FROM t2 WHERE w = 3)",
        lambda: _t1(["k"], lambda r: True)),
    "exists_uncorrelated_false": (
        "SELECT k FROM t1 WHERE EXISTS (SELECT * FROM t2 WHERE w > 9)",
        lambda: []),
    "not_exists_uncorrelated": (
        "SELECT k FROM t1 WHERE NOT EXISTS (SELECT * FROM t2 WHERE w > 9)",
        lambda: _t1(["k"], lambda r: True)),
    "exists_with_residual": (
        "SELECT k, w FROM t1 a WHERE EXISTS (SELECT * FROM t1 b "
        "WHERE a.k = b.k AND a.w <> b.w)",
        lambda: _t1(["k", "w"], lambda r: any(
            _eq(x["k"], r["k"]) and _eq(x["w"], r["w"]) is False
            for x in _rows("t1")))),
    "not_exists_with_residual": (
        "SELECT k, w FROM t1 a WHERE NOT EXISTS (SELECT * FROM t1 b "
        "WHERE a.k = b.k AND a.w <> b.w)",
        lambda: _t1(["k", "w"], lambda r: not any(
            _eq(x["k"], r["k"]) and _eq(x["w"], r["w"]) is False
            for x in _rows("t1")))),
    "in_with_null_in_subquery": (
        "SELECT k, d FROM t1 WHERE k IN (SELECT k FROM t2)",
        lambda: _t1(["k", "d"], lambda r: r["k"] is not None and any(
            x["k"] == r["k"] for x in T2))),
    "not_in_with_null_in_subquery": (
        "SELECT k, d FROM t1 WHERE k NOT IN (SELECT k FROM t2)",
        lambda: _t1(["k", "d"], lambda r: _not_in(
            r["k"], [x["k"] for x in T2]) is True)),
    "not_in_without_null": (
        "SELECT k, d FROM t1 WHERE k NOT IN (SELECT k FROM t3)",
        lambda: _t1(["k", "d"], lambda r: _not_in(
            r["k"], [x["k"] for x in T3]) is True)),
    "not_in_empty_subquery": (
        "SELECT k, d FROM t1 WHERE k NOT IN (SELECT k FROM t2 WHERE w > 9)",
        lambda: _t1(["k", "d"], lambda r: True)),
    "in_over_intersect": (
        "SELECT k, s FROM t1 WHERE k IN (SELECT k FROM t2 INTERSECT "
        "SELECT k FROM t3)",
        lambda: _t1(["k", "s"], lambda r: r["k"] is not None and
                    r["k"] in {x["k"] for x in T2} & {x["k"] for x in T3})),
    "exists_under_or": (
        "SELECT k, w FROM t1 WHERE EXISTS (SELECT * FROM t2 WHERE t2.k = "
        "t1.k AND t2.w = 0) OR EXISTS (SELECT * FROM t3 WHERE t3.k = t1.k)",
        lambda: _t1(["k", "w"], lambda r: any(
            _eq(x["k"], r["k"]) and x["w"] == 0 for x in T2) or any(
            _eq(x["k"], r["k"]) for x in T3))),
    "in_under_or": (
        "SELECT k, w FROM t1 WHERE k IN (SELECT k FROM t3) OR w = 2",
        lambda: _t1(["k", "w"], lambda r: (
            r["k"] is not None and r["k"] in {x["k"] for x in T3})
            or r["w"] == 2)),
    "correlated_scalar": (
        "SELECT k, d FROM t1 WHERE d * 2 > (SELECT avg(x) FROM t2 "
        "WHERE t2.k = t1.k)",
        lambda: _t1(["k", "d"], lambda r: r["d"] is not None and
                    _scalar_avg(r["k"]) is not None and
                    (r["d"] * 2 > _scalar_avg(r["k"])
                     or math.isnan(r["d"])))),
    "count_distinct_grouped": (
        "SELECT w, COUNT(DISTINCT d) AS cd, COUNT(*) AS n FROM t1 "
        "GROUP BY w",
        lambda: [(w, _count_distinct([r["d"] for r in _rows("t1")
                                      if r["w"] == w]),
                  sum(r["w"] == w for r in _rows("t1")))
                 for w in {r["w"] for r in _rows("t1")}]),
    "count_distinct_grouped_string": (
        "SELECT w, COUNT(DISTINCT s) AS cs FROM t1 GROUP BY w",
        lambda: [(w, _count_distinct([r["s"] for r in _rows("t1")
                                      if r["w"] == w]))
                 for w in {r["w"] for r in _rows("t1")}]),
    "count_distinct_global": (
        "SELECT COUNT(DISTINCT d) AS cd, COUNT(DISTINCT k) AS ck, "
        "SUM(w) AS sw FROM t1",
        lambda: [(_count_distinct([r["d"] for r in _rows("t1")]),
                  _count_distinct([r["k"] for r in _rows("t1")]),
                  sum(r["w"] for r in _rows("t1") if r["w"] is not None))]),
    "count_distinct_global_empty": (
        "SELECT COUNT(DISTINCT d) AS cd FROM t1 WHERE k > 99",
        lambda: [(0,)]),
}


#: the JAX side's jobs, one process each
JAX_JOBS = tuple(tuple(sorted(QUERIES)[i::3]) for i in range(3))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_subquery_shape_matches_jax_and_python(name, port, jax_results):
    text, python = QUERIES[name]
    got = port.sql(text).collect()
    ref = jax_results[name]
    want = python()
    assert _canon(r.values() for r in got) == _canon(want)
    assert _canon(r.values() for r in ref) == _canon(want)
    if got:
        assert list(got[0]) == list(ref[0])


def test_c12_two_distinct_counts_in_one_aggregate(port):
    """A string COUNT(DISTINCT) beside a double one in the same GROUP BY:
    the JAX package keeps a NaN twice in the double's set there (w = 3
    counts 6 distinct values, of which two are NaN; ROADMAP.md C12), so
    the port is held against plain Python alone."""
    text = ("SELECT w, COUNT(DISTINCT d) AS cd, COUNT(DISTINCT s) AS cs "
            "FROM t1 GROUP BY w")
    rows = _rows("t1")
    want = [(w, _count_distinct([r["d"] for r in rows if r["w"] == w]),
             _count_distinct([r["s"] for r in rows if r["w"] == w]))
            for w in {r["w"] for r in rows}]
    assert _canon(r.values() for r in port.sql(text).collect()) == \
        _canon(want)


def test_collect_list_and_set_reach_the_host(port):
    """The list states themselves as results: collect_list keeps each
    group's non-null values in row order, collect_set each distinct
    one (NaN once) in value order."""
    rows = _rows("t1")
    got = port.sql("SELECT w, collect_list(k) AS l, collect_set(d) AS s "
                   "FROM t1 GROUP BY w").collect()
    assert len(got) == len({r["w"] for r in rows})
    for g in got:
        members = [r for r in rows if r["w"] == g["w"]]
        assert g["l"] == [r["k"] for r in members if r["k"] is not None]
        want = sorted({_key(r["d"]) for r in members if r["d"] is not None},
                      key=lambda v: (v == "nan", v if v != "nan" else 0))
        assert [_key(v) for v in g["s"]] == want

def test_count_distinct_spans_batches(port):
    """The global COUNT(DISTINCT) takes one set state from each 16-row
    batch (four of them) and deduplicates across them in the merge."""
    assert len(port.table("t1").plan.batches) == 4
    df = port.sql("SELECT COUNT(DISTINCT k) AS ck FROM t1")
    assert df.collect() == [{"ck": _count_distinct(
        [r["k"] for r in _rows("t1")])}]
    partial = [n for n in _walk(port._last_execution[0])
               if getattr(n, "mode", None) == "partial"][0]
    states = list(partial.execute(port._last_execution[1]))
    assert len(states) == 4
    per_batch = [int(b.columns[0].lengths()[0]) for b in states]
    assert sum(per_batch) > df.collect()[0]["ck"]


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_exists_residual_row_ids_are_unique(port):
    """The ids the residual rewrite tags rows with are unique across
    every batch of a run, and equal in two runs of one plan."""
    from spark_rapids_tpu_torch.expr.misc import monotonically_increasing_id
    df = port.table("t1").with_column("rid", monotonically_increasing_id())
    ids = [r["rid"] for r in df.collect()]
    assert sorted(ids) == list(range(N))
    assert [r["rid"] for r in df.collect()] == ids


def test_plan_time_subqueries_run_on_the_session_device(port):
    """Uncorrelated EXISTS and NOT IN's counts execute while the text is
    analyzed, through the session itself (its device)."""
    seen = []
    orig = port.execute

    def spy(plan):
        seen.append(port.device)
        return orig(plan)
    port.execute = spy
    try:
        port.sql("SELECT k FROM t1 WHERE EXISTS (SELECT * FROM t2) AND "
                 "k NOT IN (SELECT k FROM t3)")
    finally:
        del port.execute
    assert len(seen) == 2 and all(d.type == "cpu" for d in seen)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2:])
