"""The port's SQL front door against the JAX package's, on the CPU.

The lexer gives the JAX lexer's tokens and the parser the JAX parser's
AST (``_ast_repr``) for every one of the 99 NDS texts. A function,
clause or type the port has not got yet raises ``SqlError`` before a
plan exists. Importing every module of the port loads neither JAX nor
the JAX package.
"""

import os
import subprocess
import sys

import pytest

from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.models.nds import NDS_QUERIES, NDS_SLICE
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.sql import SqlError
from spark_rapids_tpu_torch.sql import lexer, parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QIDS = sorted(NDS_QUERIES)


@pytest.fixture(scope="module")
def jax_sql():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
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
    ("SELECT abs(v) FROM t", "function 'abs'"),
    ("SELECT upper(s) FROM t", "function 'upper'"),
    ("SELECT k, SUM(v) OVER (PARTITION BY k) FROM t", "window function"),
    ("SELECT k FROM t WHERE s LIKE 'a%'", "LIKE"),
    ("SELECT k FROM t UNION SELECT k FROM t", "UNION"),
    ("SELECT k FROM t WHERE k IN (SELECT k FROM t)", "subquery predicate"),
    ("SELECT k, SUM(v) FROM t GROUP BY ROLLUP(k)", "ROLLUP"),
    ("SELECT COUNT(DISTINCT k) FROM t", "count(DISTINCT"),
    ("SELECT CAST(v AS DECIMAL(10,2)) FROM t", "type decimal"),
    ("SELECT k % 2 FROM t", "'%' operator"),
])
def test_unported_sql_raises(session, text, what):
    with pytest.raises(SqlError, match="not in this port yet") as e:
        session.sql(text)
    assert what in str(e.value)


@pytest.fixture(scope="module")
def nds_session():
    from spark_rapids_tpu_torch.models.nds import register_nds
    s = TpuSession(SrtConf(), device="cpu")
    register_nds(s, 200)
    return s


@pytest.mark.parametrize("q", ["q1", "q2", "q12"])
def test_unported_nds_queries_raise(nds_session, q):
    """q1 (a correlated scalar subquery), q2 (UNION ALL) and q12 (a
    window over the aggregate) stop in the analyzer."""
    with pytest.raises(SqlError, match="not in this port yet"):
        nds_session.sql(NDS_QUERIES[q])


def test_outer_join_raises(session):
    df = session.table("t")
    with pytest.raises(NotImplementedError, match="left_outer"):
        df.join(df, "k", how="left")
    with pytest.raises(NotImplementedError):
        session.sql("SELECT a.k FROM t a CROSS JOIN t b")


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
