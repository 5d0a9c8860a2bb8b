"""The port's SQL front door against the JAX package's, on the CPU.

The lexer gives the JAX lexer's tokens and the parser the JAX parser's
AST (``_ast_repr``) for every one of the 99 NDS texts, and the port's
analyzer and planner take every one. A function, clause or type the
port has not got yet raises ``SqlError`` before a plan exists; what the
planner sends to the CPU engine lowers and runs. Importing every module of the port loads neither JAX nor
the JAX package.
"""

import os
import subprocess
import sys

import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.models.nds import NDS_QUERIES, NDS_SLICE
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.sql import SqlError
from spark_rapids_tpu_torch.sql import lexer, parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QIDS = sorted(NDS_QUERIES)


@pytest.fixture(scope="module")
def jax_sql():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.models.nds import NDS_QUERIES as JQ
        from spark_rapids_tpu.sql import lexer as jlexer
        from spark_rapids_tpu.sql import parser as jparser
        yield jlexer, jparser, JQ


def test_query_texts_are_the_jax_packages(jax_sql):
    assert NDS_QUERIES == jax_sql[2]
    assert len(NDS_QUERIES) == 99 and set(NDS_SLICE) <= set(NDS_QUERIES)


@pytest.mark.parametrize("q", QIDS)
def test_lexer_matches_jax(q, jax_sql):
    jlexer = jax_sql[0]
    got = [tuple(t) for t in lexer.tokenize(NDS_QUERIES[q])]
    assert got == [tuple(t) for t in jlexer.tokenize(NDS_QUERIES[q])]


@pytest.mark.parametrize("q", QIDS)
def test_parser_matches_jax(q, jax_sql):
    jparser = jax_sql[1]
    got = parser._ast_repr(parser.Parser(NDS_QUERIES[q]).parse_statement())
    ref = jparser._ast_repr(
        jparser.Parser(NDS_QUERIES[q]).parse_statement())
    assert got == ref


@pytest.fixture(scope="module")
def session():
    s = TpuSession(SrtConf(), device="cpu")
    s.create_or_replace_temp_view("t", s.create_dataframe(
        {"k": [1, 2, None], "v": [1.5, None, 3.0], "s": ["a", "bc", None]},
        [("k", parser.dt.INT64), ("v", parser.dt.FLOAT64),
         ("s", parser.dt.STRING)]))
    return s


@pytest.mark.parametrize("text, what", [
    ("SELECT from_json(s, 'a INT') FROM t", "function 'from_json'"),
    ("SELECT to_json(s) FROM t", "function 'to_json'"),
])
def test_unported_sql_raises(session, text, what):
    """These functions raised here until the port's analyzer lowered
    them as the JAX analyzer does: now they plan, their Project marked
    for the CPU engine, and run."""
    df = session.sql(text)
    marks = df.explain("NOT_ON_TPU")
    name = what.split("'")[1]
    cls = {"from_json": "JsonToStructs", "to_json": "StructsToJson"}[name]
    assert marks.startswith("! Project") and cls in marks, marks
    assert len(df.collect()) == 3


@pytest.mark.parametrize("text, want", [
    # k = 1: one value (sample stddev / variance of one row is NULL);
    # k = None: 3.0 alone; the row with v NULL shares k = 2's NULL
    ("SELECT k, STDDEV_SAMP(v) OVER (PARTITION BY k) AS r FROM t",
     [(1, None), (2, None), (None, None)]),
    ("SELECT CAST(CAST(v AS DECIMAL(30,2)) AS STRING) AS r FROM t",
     ["1.50", None, "3.00"]),
    ("SELECT k, VAR_SAMP(v) OVER (PARTITION BY k) AS r FROM t",
     [(1, None), (2, None), (None, None)]),
])
def test_sql_the_cpu_engine_runs(session, text, want):
    """What the planner sends to the CPU engine (stddev / variance over
    a window, a DECIMAL(p>18) cast to STRING) lowers and runs."""
    rows = session.sql(text).collect()
    got = [(r["k"], r["r"]) if "k" in r else r["r"] for r in rows]
    assert sorted(got, key=repr) == sorted(want, key=repr)


@pytest.fixture(scope="module")
def nds_session():
    from spark_rapids_tpu_torch.models.nds import register_nds
    s = TpuSession(SrtConf(), device="cpu")
    register_nds(s, 200)
    return s


@pytest.mark.parametrize("q", QIDS)
def test_every_nds_text_analyzes_and_plans(nds_session, q):
    """All 99 texts analyze (their plan-time subqueries run) and plan
    into physical operators; their results are tests/test_torch_nds.py's
    differential."""
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    df = nds_session.sql(NDS_QUERIES[q])
    assert df.columns
    assert apply_overrides(df.plan, nds_session.conf).tree_string()


@pytest.mark.parametrize("text, want", [
    ("SELECT k, abs(v - 2.0) AS a FROM t ORDER BY k NULLS LAST",
     [{"k": 1, "a": 0.5}, {"k": 2, "a": None}, {"k": None, "a": 1.0}]),
    ("SELECT k, SUM(v) OVER (PARTITION BY k) AS s, ROW_NUMBER() OVER "
     "(ORDER BY v DESC) AS r FROM t ORDER BY k NULLS LAST",
     [{"k": 1, "s": 1.5, "r": 2}, {"k": 2, "s": None, "r": 3},
      {"k": None, "s": 3.0, "r": 1}]),
    ("SELECT COUNT(*) AS n, SUM(COUNT(*)) OVER (ORDER BY COUNT(*) ROWS "
     "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS c FROM t",
     [{"n": 3, "c": 3}]),
    # an ORDER BY expression before an output column: one sort over both
    ("SELECT k, v FROM t ORDER BY v IS NULL, k DESC",
     [{"k": 1, "v": 1.5}, {"k": None, "v": 3.0}, {"k": 2, "v": None}]),
    ("SELECT k, round(v, 0) AS r FROM t ORDER BY k NULLS LAST",
     [{"k": 1, "r": 2.0}, {"k": 2, "r": None}, {"k": None, "r": 3.0}]),
    ("SELECT k FROM t WHERE k IN (SELECT k FROM t WHERE v < 2.0)",
     [{"k": 1}]),
    ("SELECT k, SUM(v) AS s, GROUPING(k) AS g FROM t GROUP BY ROLLUP(k) "
     "ORDER BY g, k NULLS LAST",
     [{"k": 1, "s": 1.5, "g": 0}, {"k": 2, "s": None, "g": 0},
      {"k": None, "s": 3.0, "g": 0}, {"k": None, "s": 4.5, "g": 1}]),
    ("SELECT COUNT(DISTINCT k) AS c FROM t", [{"c": 2}]),
    ("SELECT sqrt(v) AS r FROM t",
     [{"r": 1.5 ** 0.5}, {"r": None}, {"r": 3.0 ** 0.5}]),
    ("SELECT upper(s) AS u FROM t", [{"u": "A"}, {"u": "BC"}, {"u": None}]),
    ("SELECT k FROM t WHERE s LIKE 'a%'", [{"k": 1}]),
    ("SELECT s || 'x' AS c FROM t", [{"c": "ax"}, {"c": "bcx"},
                                     {"c": None}]),
    ("SELECT k FROM t WHERE CAST('2000-01-01' AS DATE) + INTERVAL 30 DAYS "
     "> CAST('2000-01-02' AS DATE)", [{"k": 1}, {"k": 2}, {"k": None}]),
    ("SELECT first(v) AS f FROM t", [{"f": 1.5}]),
    ("SELECT k div 2 AS q FROM t", [{"q": 0}, {"q": 1}, {"q": None}]),
    ("SELECT k % 2 AS r FROM t", [{"r": 1}, {"r": 0}, {"r": None}]),
])
def test_ported_sql_runs(session, text, want):
    """What the unported cases above used to name (abs, OVER, a window
    over an aggregate, round, an IN subquery, ROLLUP, COUNT(DISTINCT)),
    and a mixed ORDER BY sorted as one key list."""
    assert session.sql(text).collect() == want


def test_nds_window_query_runs(nds_session):
    """q12 (a window over the aggregate) runs end to end; its
    differential is tests/test_torch_nds.py's."""
    df = nds_session.sql(NDS_QUERIES["q12"])
    assert df.columns[-1] == "revenueratio"
    rows = df.collect()
    assert all(0.0 < r["revenueratio"] <= 100.0 for r in rows)


def test_outer_join_raises(session):
    """Outer joins run; what still raises is an outer join the JAX
    planner would run wrongly: with a residual condition or without
    equi-keys (ROADMAP.md C10)."""
    with pytest.raises(SqlError, match="non-equi ON condition"):
        session.sql("SELECT a.k FROM t a LEFT JOIN t b ON a.k = b.k "
                    "AND a.v < b.v")
    with pytest.raises(SqlError, match="without equi-condition"):
        session.sql("SELECT a.k FROM t a FULL OUTER JOIN t b ON a.v < b.v")
    rows = session.sql("SELECT a.k, b.k AS bk FROM t a LEFT JOIN t b "
                       "ON a.k = b.k").collect()
    assert all((r["k"] is None) == (r["bk"] is None) for r in rows)
    assert session.sql("SELECT a.k FROM t a CROSS JOIN t b").collect()


def test_catalog_and_sql_run(session):
    rows = session.sql("SELECT k, v FROM t WHERE v > 1.0 ORDER BY k "
                       "NULLS LAST").collect()
    assert rows == [{"k": 1, "v": 1.5}, {"k": None, "v": 3.0}]
    rows = session.sql("SELECT DISTINCT k FROM t WHERE k IS NOT NULL "
                       "ORDER BY k DESC").collect()
    assert rows == [{"k": 2}, {"k": 1}]
    df = session.table("t").with_column("v", parser.col("k") * 2)
    assert df.columns == ["k", "s", "v"]
    assert [r["v"] for r in df.collect()] == [2, 4, None]
    with pytest.raises(KeyError, match="nope"):
        session.table("nope")


def test_importing_the_port_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither JAX nor the JAX package in ``sys.modules`` (the static scan
    of import statements is tests/test_torch_columnar.py's)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'spark_rapids_tpu'))\n"
        "assert 'spark_rapids_tpu_torch.sql.parser' in sys.modules\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
