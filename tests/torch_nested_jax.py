"""The JAX side of tests/test_torch_nested.py, test_torch_higher_order.py
and test_torch_json.py, and the data the three files share.

The JAX package compiles one program per projection and per batch
shape, and its ``get_json_object`` over padded documents compiles for
minutes at a 1024-byte pad. So its side runs in three jobs, each a
subprocess of this file at XLA's optimization level 0
(``jax_reference.SUBPROCESS_XLA_FLAGS``), started once per session: early by tests/torch_jax_early.py when the
session will run these files (they then compile on cores the port's
single-threaded files leave idle), else by the first of the three files
to need them.
Each job pickles its results; ``result`` waits for them. A job's stderr
goes to a file (an unread pipe would stall it).

``python tests/torch_nested_jax.py <job> <out>`` runs one job.
"""

import atexit
import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FILES = ("test_torch_nested.py", "test_torch_higher_order.py",
         "test_torch_json.py")
#: job -> the results it computes
JOBS = {"slice_n6": ("n6",), "json": ("json",),
        "rest": ("collections", "hof", "slice")}

N = 160
SLICE_ROWS = 20_000
SLICE_BATCH = 1 << 15


# --- shared data -------------------------------------------------------------

def lists(rng, n, lo, hi, maxlen, p_null=0.1, p_empty=0.1, p_elem=0.15):
    rows = []
    for _ in range(n):
        r = rng.random()
        if r < p_null:
            rows.append(None)
        elif r < p_null + p_empty:
            rows.append([])
        else:
            rows.append([int(v) if rng.random() > p_elem else None
                         for v in rng.integers(lo, hi,
                                               int(rng.integers(1, maxlen)))])
    return rows


def collection_data():
    rng = np.random.default_rng(23)
    a = lists(rng, N, -5, 6, 7)
    b = lists(rng, N, -5, 6, 7)
    f = [None if r is None else [None if v is None else v * 0.5 for v in r]
         for r in lists(rng, N, -40, 40, 6)]
    words = ["x", "yy", "zzz", "", "a b"]
    sa = [None if r is None else [None if v is None else words[v]
                                  for v in r]
          for r in lists(rng, N, 0, 5, 5)]
    ll = [None if r is None else [None if v is None else list(range(v))
                                  for v in r]
          for r in lists(rng, N, 0, 4, 4)]
    st = [None if i % 11 == 3 else
          {"p": int(rng.integers(-9, 9)), "q": words[i % 5]}
          for i in range(N)]
    return {"a": a, "b": b, "f": f, "sa": sa, "ll": ll, "st": st,
            "v": [int(x) for x in rng.integers(-5, 6, N)],
            "s": [int(x) for x in rng.choice([-3, -2, -1, 1, 2, 3], N)],
            "n": [int(x) for x in rng.integers(0, 4, N)],
            "x": list(range(N))}


def collection_schema(t):
    return [("a", t.ArrayType(t.INT64)), ("b", t.ArrayType(t.INT64)),
            ("f", t.ArrayType(t.FLOAT64)), ("sa", t.ArrayType(t.STRING)),
            ("ll", t.ArrayType(t.ArrayType(t.INT64))),
            ("st", t.StructType((("p", t.INT64), ("q", t.STRING)))),
            ("v", t.INT64), ("s", t.INT64), ("n", t.INT64),
            ("x", t.INT64)]


def collection_exprs(X, c, lt):
    """The collection cases, built with either package's modules."""
    return {
        "size": X.Size(c("a")),
        "get_item": X.GetArrayItem(c("a"), lt(1)),
        "element_at_pos": X.ElementAt(c("a"), lt(2)),
        "element_at_neg": X.ElementAt(c("a"), lt(-1)),
        "element_at_zero": X.ElementAt(c("a"), lt(0)),
        "contains": X.ArrayContains(c("a"), c("v")),
        "min": X.ArrayMin(c("a")),
        "max": X.ArrayMax(c("f")),
        "sort_asc": X.SortArray(c("a")),
        "sort_desc": X.SortArray(c("f"), False),
        "distinct": X.ArrayDistinct(c("a")),
        "union": X.ArrayUnion(c("a"), c("b")),
        "intersect": X.ArrayIntersect(c("a"), c("b")),
        "except": X.ArrayExcept(c("a"), c("b")),
        "overlap": X.ArraysOverlap(c("a"), c("b")),
        "remove": X.ArrayRemove(c("a"), c("v")),
        "position": X.ArrayPosition(c("a"), c("v")),
        "slice": X.Slice(c("a"), c("s"), c("n")),
        "reverse": X.ArrayReverse(c("f")),
        "repeat": X.ArrayRepeat(c("v"), lt(3)),
        "flatten_array": X.Flatten(X.array(c("a"), c("b"))),
        "flatten_column": X.Flatten(c("ll")),
        "arrays_zip": X.ArraysZip(c("a"), c("f")),
        "array_join": X.ArrayJoin(c("sa"), "-"),
        "array_join_repl": X.ArrayJoin(c("sa"), ",", "?"),
        "zip_with": X.zip_with(c("a"), c("b"), lambda p, q: p * 10 + q),
        "named_struct": X.struct(k=c("x"), m=X.ArrayMax(c("a"))),
        "struct_field": X.GetStructField(c("st"), "q"),
        "create_array": X.array(c("v"), c("x"), lt(7)),
    }


def gate_exprs(X, H, c, lt):
    """What the planners' nested gates send to the CPU engine, over the
    collection data, built with either package's modules."""
    return {
        "contains_string_elements": X.ArrayContains(c("sa"), lt("x")),
        "sort_nested_elements": X.SortArray(c("ll")),
        "array_repeat_column_count": X.ArrayRepeat(c("v"), c("n")),
        "array_repeat_string": X.ArrayRepeat(lt("x"), lt(2)),
        "zip_with_string_elements": X.zip_with(c("sa"), c("a"),
                                               lambda p, q: q),
        "zip_with_string_result": X.zip_with(c("a"), c("b"),
                                             lambda p, q: lt("s")),
        "map_concat": X.MapConcat(H.create_map(lt(1), c("x")),
                                  H.create_map(lt(2), c("x"))),
    }


def hof_gate_exprs(X, H, c, lt):
    """The lambda gates, over the higher-order data."""
    return {
        "transform_string_elements": H.transform(
            X.array(lt("a"), lt("b")), lambda v: lt(1)),
        "transform_string_result": H.transform(c("a"), lambda v: lt("s")),
        "exists_nested_elements": H.exists(
            X.array(c("a"), c("a")), lambda v: X.Size(v) > lt(1)),
        "aggregate_outer_column": H.aggregate(
            c("a"), lt(0), lambda acc, v: acc + v + c("x")),
        "map_string_keys": H.map_contains_key(
            H.create_map(lt("k"), c("x")), lt("k")),
        "filter_map_values_string": H.map_filter(
            H.create_map(c("x"), lt("v")), lambda k, v: k > lt(1)),
    }


def _each(api, df, exprs):
    """Each case in a query of its own: its rows, or the error it
    raised."""
    out = {}
    for k, e in exprs.items():
        try:
            out[k] = [r["r"] for r in df.select(api.Alias(e, "r")).collect()]
        except Exception as err:  # noqa: BLE001 - recorded for the test
            out[k] = err
    return out


def hof_data():
    rng = np.random.default_rng(11)
    a = lists(rng, N, -40, 40, 8)
    f = [None if r is None else [None if v is None else v * 0.37 + 0.1
                                 for v in r]
         for r in lists(rng, N, -500, 500, 9)]
    maps = []
    for _ in range(N):
        r = rng.random()
        if r < 0.1:
            maps.append(None)
        elif r < 0.2:
            maps.append({})
        else:
            maps.append({int(k): (int(rng.integers(0, 100))
                                  if rng.random() > 0.2 else None)
                         for k in rng.integers(0, 20,
                                               int(rng.integers(1, 6)))})
    return {"a": a, "f": f, "m": maps, "x": list(range(N)),
            "k": [int(v) for v in rng.integers(0, 20, N)]}


def hof_schema(t):
    return [("a", t.ArrayType(t.INT64)), ("f", t.ArrayType(t.FLOAT64)),
            ("m", t.MapType(t.INT64, t.INT64)), ("x", t.INT64),
            ("k", t.INT64)]


def hof_exprs(X, H, c, lt):
    nonnull = X.ArrayDistinct(H.filter_(c("a"), lambda v: v >= lt(-100)))
    return {
        "transform": H.transform(c("a"), lambda v: v * 2 + 1),
        "transform_index_outer": H.transform(c("a"),
                                             lambda v, i: v + i * c("x")),
        "exists": H.exists(c("a"), lambda v: v > lt(10)),
        "forall": H.forall(c("a"), lambda v: v < lt(30)),
        "filter": H.filter_(c("a"), lambda v: v > lt(0)),
        "aggregate_int": H.aggregate(c("a"), lt(0), lambda acc, v: acc + v),
        "aggregate_float": H.aggregate(c("f"), lt(0.0),
                                       lambda acc, v: acc + v * lt(0.1)),
        "aggregate_finish": H.aggregate(c("f"), lt(1.0),
                                        lambda acc, v: acc * lt(0.5) + v,
                                        lambda acc: acc * lt(3.0)),
        "map_keys": H.map_keys(c("m")),
        "map_values": H.map_values(c("m")),
        "map_entries": H.map_entries(c("m")),
        "get_map_value": H.get_map_value(c("m"), c("k")),
        "map_contains_key": H.map_contains_key(c("m"), c("k")),
        "transform_values": H.transform_values(c("m"),
                                               lambda k, v: v + k),
        "transform_keys": H.transform_keys(c("m"), lambda k, v: k * 100),
        "map_filter": H.map_filter(c("m"), lambda k, v: k > lt(5)),
        "create_map": H.create_map(lt(1), c("x"), lt(2), c("x") * 2),
        "map_from_arrays": H.map_from_arrays(
            nonnull, H.transform(nonnull, lambda v: v * 2)),
    }


def _fuzz_docs(n: int):
    """tests/test_fuzz_json.py's generator (copied, with its seed, so
    that importing it needs no JAX): well-formed documents, every third
    mutated to a malformed one, every 17th NULL."""
    import json
    import random
    import string
    rng = random.Random(1337)

    def scalar():
        r = rng.random()
        if r < 0.25:
            return rng.randint(-10**6, 10**6)
        if r < 0.45:
            return round(rng.uniform(-1e3, 1e3), 3)
        if r < 0.6:
            return rng.choice([True, False, None])
        return "".join(rng.choice(string.ascii_letters + ' \\"')
                       for _ in range(rng.randint(0, 8)))

    def value(depth=0):
        r = rng.random()
        if depth >= 3 or r < 0.4:
            return scalar()
        if r < 0.7:
            return {f"k{rng.randint(0, 5)}": value(depth + 1)
                    for _ in range(rng.randint(0, 4))}
        return [value(depth + 1) for _ in range(rng.randint(0, 4))]

    def mutate(s):
        if not s:
            return "{"
        op = rng.random()
        if op < 0.34:
            return s[:rng.randint(0, len(s))]
        if op < 0.67:
            i = rng.randint(0, len(s) - 1)
            return s[:i] + rng.choice('{}[],:"x') + s[i + 1:]
        i = rng.randint(0, len(s))
        return s[:i] + rng.choice(["{{", "]]", '"', ",,", "nul"]) + s[i:]
    docs = []
    for i in range(n):
        doc = json.dumps(value())
        if i % 3 == 0:
            doc = mutate(doc)
        if i % 17 == 0:
            doc = None
        docs.append(doc)
    return docs


#: tests/test_json.py's documents
KNOWN_DOCS = [
    '{"a": 1, "b": "two", "c": [1, 2, 3]}',
    '{"a": {"x": 10, "y": "deep"}, "b": null}',
    '{"b": "only b"}',
    '[5, 6, {"a": 7}]',
    '{"a": "with \\"quote\\" and \\n newline"}',
    '  {"a" : 42.50 , "list": [{"k": "v0"}, {"k": "v1"}]}  ',
    'not json at all',
    "",
    None,
    '{"a": true, "t": false}',
]


def json_docs():
    """The fuzz corpus, the known documents and escape edges."""
    return _fuzz_docs(240) + KNOWN_DOCS + [
        '{"a":"x\\\\"}', '{"a":"x\\\\\\"y"}', '{"a":"\\\\\\\\"}',
        '{"a":"u\\u0041\\/"}', '{"a": [1, {"b": 2} ] }', '{"a": null}',
        '{"a":"\\\\', '{"a": "\\t\\n\\r\\b\\f"}', '  ', '[[1,2],[3]]',
        '{"a": {"a": {"a": "deep"}}, "b": "x"}', '{"b": "a", "a": 1}']


def json_paths():
    """tests/test_fuzz_json.py's and tests/test_json.py's paths, and a
    few more."""
    return ["$.k0", "$.k1", "$.k0.k1", "$.k2[0]", "$.k3[1].k0",
            "$.k0[0][1]", "$.missing", "$.k4.k5.k6",
            "$.a", "$.b", "$.c", "$.a.x", "$.c[1]", "$[0]", "$[2].a",
            "$.list[1].k", "$.a.a.a", "$[0][1]", "$['a']"]


# --- JAX jobs ----------------------------------------------------------------

def _jax_api():
    from types import SimpleNamespace

    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.expr import (aggregates, cast, collections, core,
                                       higher_order, strings)
    return SimpleNamespace(col=core.col, lit=core.lit, Alias=core.Alias,
                           CX=collections, HO=higher_order, Agg=aggregates,
                           Cast=cast.Cast, S=strings, dt=jdt)


def to_jax_type(jdt, t):
    """The JAX package's type of a port type (by its name)."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    if isinstance(t, dt.ArrayType):
        return jdt.ArrayType(to_jax_type(jdt, t.element_type))
    return {"bigint": jdt.INT64, "double": jdt.FLOAT64, "date": jdt.DATE,
            "string": jdt.STRING, "int": jdt.INT32}[t.sql_name]


def slice_tables():
    """TPC-H lineitem (SLICE_ROWS rows) and orders as the port's host
    tables, generated by the port's datagen (byte-equal to the JAX
    package's), and the nested orders and JSON documents over them."""
    from spark_rapids_tpu_torch.datagen import (generate_chunk,
                                                lineitem_spec, orders_spec)
    from spark_rapids_tpu_torch.models import nested as NM
    li = generate_chunk(lineitem_spec(SLICE_ROWS), 0, SLICE_ROWS)
    od = generate_chunk(orders_spec(SLICE_ROWS // 4), 0, SLICE_ROWS // 4)
    no = NM.NestedOrders(li)
    return li, od, no, NM.json_docs(no, od, no.n)


def _job_collections(api, session):
    df = session.create_dataframe(collection_data(),
                                  collection_schema(api.dt))
    exprs = collection_exprs(api.CX, api.col, api.lit)
    rows = df.select(*[api.Alias(e, k) for k, e in exprs.items()]).collect()
    out = {k: [r[k] for r in rows] for k in exprs}
    for name in ("explode", "explode_outer", "posexplode"):
        gen = getattr(api.CX, name)
        out[name] = df.select(api.col("x"),
                              api.Alias(gen(api.col("a")), "e")).collect()
    out["gates"] = _each(api, df, gate_exprs(api.CX, api.HO, api.col,
                                             api.lit))
    return out


def _job_hof(api, session):
    df = session.create_dataframe(hof_data(), hof_schema(api.dt))
    exprs = hof_exprs(api.CX, api.HO, api.col, api.lit)
    rows = df.select(*[api.Alias(e, k) for k, e in exprs.items()]).collect()
    out = {k: [r[k] for r in rows] for k in exprs}
    # the JAX package nulls a row whose two arrays differ in length
    two = session.create_dataframe(
        {"ks": [[1, 2], [3]], "vs": [[10, 20], [30, 40]]},
        [("ks", api.dt.ArrayType(api.dt.INT64)),
         ("vs", api.dt.ArrayType(api.dt.INT64))])
    out["mismatch"] = two.select(api.Alias(api.HO.map_from_arrays(
        api.col("ks"), api.col("vs")), "m")).collect()
    out["gates"] = _each(api, df, hof_gate_exprs(api.CX, api.HO, api.col,
                                                 api.lit))
    return out


def _job_slice(api, session):
    from spark_rapids_tpu_torch.models import nested as NM
    from spark_rapids_tpu_torch.plan.host_table import to_pydict
    li, _, no, _ = slice_tables()
    table = no.table()
    on = session.create_dataframe(to_pydict(table), [
        (n, to_jax_type(api.dt, t)) for n, t in table.schema()])
    lidf = session.create_dataframe(to_pydict(li), [
        (n, to_jax_type(api.dt, t)) for n, t in li.schema()])
    return {k: q.collect() for k, q in NM.queries(api, on, lidf).items()}


def _job_n6(api, session):
    from spark_rapids_tpu_torch.models import nested as NM
    docs = slice_tables()[3]
    session.create_or_replace_temp_view("orders_json",
                                        session.create_dataframe(
                                            {"doc": docs},
                                            [("doc", api.dt.STRING)]))
    return session.sql(NM.N6_SQL).collect()


def _job_json(api, session):
    from spark_rapids_tpu.expr.json import GetJsonObject
    docs, paths = json_docs(), json_paths()
    df = session.create_dataframe({"j": docs}, [("j", api.dt.STRING)])
    rows = df.select(*[api.Alias(GetJsonObject(api.col("j"), p), f"v{i}")
                       for i, p in enumerate(paths)]).collect()
    sql_docs = session.create_dataframe(
        {"j": docs[:40], "i": list(range(40))},
        [("j", api.dt.STRING), ("i", api.dt.INT64)])
    session.create_or_replace_temp_view("docs", sql_docs)
    sql = session.sql(JSON_SQL).collect()
    return {"rows": rows, "sql": sql}


JSON_SQL = ("SELECT i, get_json_object(j, '$.k0') AS a, "
            "CAST(get_json_object(j, '$.k1') AS DOUBLE) AS b "
            "FROM docs ORDER BY i")


def run_job(job: str, out_path: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    api = _jax_api()
    out = {}
    for name in JOBS[job]:
        session = JSession(JConf({"srt.sql.batchSizeRows": SLICE_BATCH}))
        out[name] = {"collections": _job_collections, "hof": _job_hof,
                     "slice": _job_slice, "n6": _job_n6,
                     "json": _job_json}[name](api, session)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --- starting and reading the jobs -------------------------------------------

#: job -> (output path, stderr file, process), once per session
_STARTED: dict = {}


def start(tmp_path_factory) -> None:
    """Start every job, once per session."""
    if _STARTED:
        return
    from jax_reference import SUBPROCESS_XLA_FLAGS
    tmp = tmp_path_factory.mktemp("nested_jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        + SUBPROCESS_XLA_FLAGS).strip()
    for job in JOBS:
        out = str(tmp / f"{job}.pkl")
        err = open(str(tmp / f"{job}.stderr"), "wb")
        _STARTED[job] = (out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, out], env=env,
            stdout=subprocess.DEVNULL, stderr=err))
    atexit.register(stop)


def stop() -> None:
    for _, err, p in _STARTED.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        err.close()


_RESULTS: dict = {}


def result(name: str):
    """A JAX-side result, waiting for its job."""
    if name not in _RESULTS:
        job = next(j for j, names in JOBS.items() if name in names)
        out, err, p = _STARTED[job]
        rc = p.wait(timeout=1200)
        if rc != 0:
            err.flush()
            with open(err.name, "rb") as f:
                tail = f.read()[-4000:].decode(errors="replace")
            raise RuntimeError(f"JAX job {job} failed (rc {rc}):\n{tail}")
        with open(out, "rb") as f:
            _RESULTS.update(pickle.load(f))
    return _RESULTS[name]


if __name__ == "__main__":
    run_job(sys.argv[1], sys.argv[2])
