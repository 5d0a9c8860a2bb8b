"""``get_json_object`` through both packages on the CPU.

The documents are the JAX package's JSON fuzz corpus
(tests/test_fuzz_json.py: generated well-formed and malformed documents,
some NULL), its known documents (tests/test_json.py) and escape edges
(backslash runs at a string's end, ``\\uXXXX`` passed through, the JSON
escapes); the paths are both files' and a few more. Each path's column
through the port equals the JAX package's (its side in a subprocess,
tests/torch_nested_jax.py), exactly: the port keeps the JAX envelope
(a nested result is the raw span, ``\\uXXXX`` undecoded; ROADMAP C17).
Long documents, past the JAX pad widths, are held against Python's
``json``. ``get_json_object`` runs through ``session.sql``; a wildcard
path raises ``SqlError``. ``from_json`` / ``to_json`` are not in the
port's SQL yet; through the DataFrame API they run on the CPU engine,
against the JAX package's.
"""

import json

import pytest

import torch_nested_jax as J
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr.core import Alias, col
from spark_rapids_tpu_torch.expr.json import (GetJsonObject,
                                              JsonPathUnsupported,
                                              JsonToStructs, StructsToJson,
                                              parse_json_path)
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.sql import SqlError


@pytest.fixture(scope="module", autouse=True)
def _jax_jobs(tmp_path_factory):
    J.start(tmp_path_factory)


@pytest.fixture(scope="module")
def session():
    return TpuSession(device="cpu")


@pytest.fixture(scope="module")
def port_rows(session):
    df = session.create_dataframe({"j": J.json_docs()}, [("j", dt.STRING)])
    return df.select(*[Alias(GetJsonObject(col("j"), p), f"v{i}")
                       for i, p in enumerate(J.json_paths())]).collect()


@pytest.mark.parametrize("i, path", list(enumerate(J.json_paths())))
def test_path_matches_jax(i, path, port_rows):
    want = J.result("json")["rows"]
    docs = J.json_docs()
    assert len(port_rows) == len(want) == len(docs)
    for doc, g, w in zip(docs, port_rows, want):
        assert g[f"v{i}"] == w[f"v{i}"], (path, doc, g[f"v{i}"])


def test_sql_matches_jax(session):
    docs = J.json_docs()[:40]
    session.create_or_replace_temp_view("docs", session.create_dataframe(
        {"j": docs, "i": list(range(40))}, [("j", dt.STRING),
                                            ("i", dt.INT64)]))
    assert session.sql(J.JSON_SQL).collect() == J.result("json")["sql"]


def _py_get(doc, path):
    """Python's json for the scalar paths of the long documents."""
    try:
        v = json.loads(doc)
    except ValueError:
        return None
    for kind, arg in parse_json_path(path):
        if kind == "key":
            if not isinstance(v, dict) or arg not in v:
                return None
            v = v[arg]
        else:
            if not isinstance(v, list) or arg >= len(v):
                return None
            v = v[arg]
    if v is None or isinstance(v, (dict, list)):
        return None
    return v if isinstance(v, str) else json.dumps(v)


def test_long_documents_against_python_json(session):
    """Documents of thousands of bytes with deep nesting and escapes:
    the doubling scan's longest rows."""
    docs = []
    for i in range(30):
        inner = {"k": i, "s": "q\\" * (i % 4) + 'x"y' * i,
                 "arr": list(range(i * 40))}
        doc = {"a": [inner] * (i % 3 + 1), "b": {"c": {"d": "e" * i * 30}},
               "z": i * 0.25}
        docs.append(json.dumps(doc, indent=i % 3))
    paths = ["$.a[0].k", "$.a[2].s", "$.b.c.d", "$.z", "$.a[1].arr[37]",
             "$.a[0].arr[0]"]
    df = session.create_dataframe({"j": docs}, [("j", dt.STRING)])
    rows = df.select(*[Alias(GetJsonObject(col("j"), p), f"v{i}")
                       for i, p in enumerate(paths)]).collect()
    assert max(len(d) for d in docs) > 4000
    for doc, r in zip(docs, rows):
        for i, p in enumerate(paths):
            assert r[f"v{i}"] == _py_get(doc, p), (p, r[f"v{i}"])


@pytest.mark.parametrize("path", ["$.*", "$..a", "a.b", "$[x]"])
def test_unsupported_paths_raise(session, path):
    with pytest.raises(JsonPathUnsupported):
        parse_json_path(path)
    session.create_or_replace_temp_view("one", session.create_dataframe(
        {"s": ['{"a": 1}']}, [("s", dt.STRING)]))
    with pytest.raises(SqlError, match="get_json_object"):
        session.sql(f"SELECT get_json_object(s, '{path}') FROM one")


@pytest.mark.parametrize("fn", ["from_json", "to_json"])
def test_json_functions_wait_for_the_cpu_fallback(session, fn):
    """Not in the port's SQL yet; through the DataFrame API the planner
    sends them to the CPU engine (the name is kept from when the port
    refused them), against the JAX package's rows."""
    df = session.create_dataframe({"s": ['{"a": 1}']}, [("s", dt.STRING)])
    session.create_or_replace_temp_view("one", df)
    text = {"from_json": "SELECT from_json(s, 'a INT') FROM one",
            "to_json": "SELECT to_json(s) FROM one"}[fn]
    with pytest.raises(SqlError, match="not in this port yet"):
        session.sql(text)
    docs = ['{"a": 1}', '{"a": "x"}', 'not json', None, '{"b": 2}',
            '{"a": 2147483648}', '[1]', '{"a": -7, "a2": [1]}']
    rows = _json_fn_rows(session, fn, docs, dt, JsonToStructs,
                         StructsToJson, TpuSession)
    assert rows[0]["marks"].startswith("! Project")
    with pytest.MonkeyPatch.context() as mp:
        from jax_reference import patch_jax_compiles
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.expr.json import JsonToStructs as JTS
        from spark_rapids_tpu.expr.json import StructsToJson as JSJ
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        want = _json_fn_rows(None, fn, docs, jdt, JTS, JSJ, JSession)
    assert [r["r"] for r in rows] == [r["r"] for r in want]
    if fn == "from_json":
        assert [r["r"] for r in rows][:3] == [{"a": 1}, {"a": None}, None]


def _json_fn_rows(session, fn, docs, types, from_json, to_json, make):
    """from_json(s, 'a INT'), or to_json of it, through one package's
    DataFrame API (the port's with its explain marks)."""
    from_expr = from_json(col("s") if session else _jcol("s"),
                          types.StructType((("a", types.INT32),)))
    e = from_expr if fn == "from_json" else to_json(from_expr)
    s = session or make()
    df = s.create_dataframe({"s": docs}, [("s", types.STRING)])
    alias = Alias if session else _jalias
    q = df.select(alias(e, "r"))
    rows = q.collect()
    if session:
        rows[0]["marks"] = q.explain("NOT_ON_TPU")
    return rows


def _jcol(name):
    from spark_rapids_tpu.expr.core import col as jcol
    return jcol(name)


def _jalias(e, name):
    from spark_rapids_tpu.expr.core import Alias as JAlias
    return JAlias(e, name)
