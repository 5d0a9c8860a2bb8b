"""Nested types through both packages on the CPU: the columns, the
collection expressions, explode / Generate, the planning gates, and the
slice as a whole (N1-N7 of ``models/nested.py`` at 20,000 lineitem
rows).

Cases come from tests/test_nested.py, test_collection_breadth.py and
test_collection_device_lanes.py: numpy-seeded arrays with NULL rows,
empty rows and NULL elements go through the JAX package (its side in
subprocesses, tests/torch_nested_jax.py) and through the port with
``device="cpu"``, and each column is held equal, floats to rtol 1e-9,
the rest exactly. Where the port follows Spark and
the JAX package does not (a slice start before the array's first
element; NaN and -0.0 in the element comparisons; ROADMAP.md C17), the
port is held against plain Python. Each gate of the planner that sends a
nested expression to the CPU engine runs it there, against the JAX
package's rows; a nested GROUP BY, ORDER BY or join key runs there too,
against plain Python.
"""

import datetime
import math

import numpy as np
import pytest
import torch

import torch_nested_jax as J
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.nested import (
    HostList, HostStruct, ListColumn, column_from_host_lane,
    nested_column_from_pylist, to_python)
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr import collections as CX
from spark_rapids_tpu_torch.expr import higher_order as HO
from spark_rapids_tpu_torch.expr.core import Alias, col, lit
from spark_rapids_tpu_torch.models import nested as NM
from spark_rapids_tpu_torch.plan.session import TpuSession

RTOL = 1e-9
CPU = torch.device("cpu")
N = J.N


def _slice_departs(row):
    """The JAX package keeps elements a start before the first reaches;
    Spark returns an empty array (ROADMAP C17)."""
    return row["a"] is not None and row["s"] < 0 and -row["s"] > len(
        row["a"])


def _py_slice(a, s, n):
    if a is None:
        return None
    start = s - 1 if s > 0 else len(a) + s
    if start < 0 or start >= len(a):
        return []
    return a[start:start + n]


EXPLODES = ["explode", "explode_outer", "posexplode"]


@pytest.fixture(scope="module", autouse=True)
def _jax_jobs(tmp_path_factory):
    J.start(tmp_path_factory)


@pytest.fixture(scope="module")
def data():
    return J.collection_data()


@pytest.fixture(scope="module")
def port_df(data):
    s = TpuSession(SrtConf({"srt.sql.batchSizeRows": 64}), device="cpu")
    return s.create_dataframe(data, J.collection_schema(dt))


@pytest.fixture(scope="module")
def port_side(port_df):
    exprs = J.collection_exprs(CX, col, lit)
    rows = port_df.select(*[Alias(e, k) for k, e in exprs.items()]).collect()
    return {k: [r[k] for r in rows] for k in exprs}


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=RTOL) or (a != a and b != b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("case", list(J.collection_exprs(CX, col, lit)))
def test_collection_matches_jax(case, data, port_side):
    got, want = port_side[case], J.result("collections")[case]
    assert len(got) == len(want) == N
    rows = [dict(zip(data, vals)) for vals in zip(*data.values())]
    for i, (g, w) in enumerate(zip(got, want)):
        if case == "slice" and _slice_departs(rows[i]):
            r = rows[i]
            assert g == _py_slice(r["a"], r["s"], r["n"]), (i, g)
            continue
        assert _same(g, w), (case, i, rows[i], g, w)


@pytest.mark.parametrize("kind", EXPLODES)
def test_explode_matches_jax(kind, port_df):
    gen = {"explode": CX.explode, "explode_outer": CX.explode_outer,
           "posexplode": CX.posexplode}[kind]
    got = port_df.select(col("x"), Alias(gen(col("a")), "e")).collect()
    assert got == J.result("collections")[kind]
    assert len(got) > N // 2


# --- where the port follows Spark (plain Python) -----------------------------

SPECIAL = [[1.5, float("nan"), -0.0, 0.0, float("nan"), None], [0.0, -0.0],
           [float("nan")], [], None, [2.0, None, -1.0]]


def _nan_key(v):
    return ("nan",) if isinstance(v, float) and v != v else \
        (0.0 if v == 0 else v)


def _py_distinct(xs):
    seen, out = set(), []
    for x in xs:
        k = _nan_key(x)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


@pytest.mark.parametrize("fn", ["distinct", "contains_nan", "position_zero",
                                "min", "max", "sort", "remove_nan"])
def test_nan_and_negative_zero_follow_spark(fn):
    s = TpuSession(device="cpu")
    df = s.create_dataframe({"f": SPECIAL},
                            [("f", dt.ArrayType(dt.FLOAT64))])
    nan = lit(float("nan"))
    e = {"distinct": CX.ArrayDistinct(col("f")),
         "contains_nan": CX.ArrayContains(col("f"), nan),
         "position_zero": CX.ArrayPosition(col("f"), lit(0.0)),
         "min": CX.ArrayMin(col("f")), "max": CX.ArrayMax(col("f")),
         "sort": CX.SortArray(col("f")),
         "remove_nan": CX.ArrayRemove(col("f"), nan)}[fn]
    got = [r["r"] for r in df.select(Alias(e, "r")).collect()]
    for xs, g in zip(SPECIAL, got):
        if xs is None:
            assert g is None
            continue
        vals = [x for x in xs if x is not None]
        nans = [x for x in vals if x != x]
        nums = [x for x in vals if x == x]
        if fn == "distinct":
            want = _py_distinct(xs)
        elif fn == "contains_nan":
            want = True if nans else (None if None in xs else False)
        elif fn == "position_zero":
            want = next((i + 1 for i, x in enumerate(xs)
                         if x is not None and x == 0), 0)
        elif fn == "min":
            want = min(nums) if nums else (float("nan") if nans else None)
        elif fn == "max":
            want = float("nan") if nans else (max(nums) if nums else None)
        elif fn == "sort":
            want = [None] * xs.count(None) + sorted(nums) + nans
        else:
            want = [x for x in xs if x is None or x == x]
        assert _same(g, want), (fn, xs, g, want)


# --- columns -----------------------------------------------------------------

LAYOUTS = {
    "list_of_struct": (dt.ArrayType(dt.StructType((("k", dt.INT32),
                                                    ("v", dt.STRING)))),
                       [[{"k": 1, "v": "a"}, None, {"k": None, "v": "bb"}],
                        None, [], [{"k": 4, "v": None}]]),
    "list_of_list": (dt.ArrayType(dt.ArrayType(dt.DATE)),
                     [[[datetime.date(2020, 1, 2)], None, []], None,
                      [[None, datetime.date(1969, 12, 31)]]]),
    "map": (dt.MapType(dt.INT64, dt.FLOAT64),
            [{1: 2.5, 3: None}, None, {}, {7: -1.0}]),
    "struct_of_list": (dt.StructType((("xs", dt.ArrayType(dt.INT64)),
                                      ("d", dt.FLOAT64))),
                       [{"xs": [1, None], "d": 0.5}, None,
                        {"xs": None, "d": None}]),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pylist_round_trip(layout):
    t, values = LAYOUTS[layout]
    c = nested_column_from_pylist(values, 8, t, device=CPU)
    assert to_python(c, len(values)) == values
    # through a gather that reverses the rows and a concat of halves
    idx = torch.arange(len(values) - 1, -1, -1)
    assert to_python(c.gather(idx), len(values)) == values[::-1]
    objects = np.empty(len(values), dtype=object)
    objects[:] = values
    again = column_from_host_lane(objects, [v is not None for v in values],
                                  t, 8, device=CPU)
    assert to_python(again, len(values)) == values


def test_flat_lanes_builder_drops_null_rows_elements():
    """A HostList whose null row keeps an extent: its elements go."""
    hl = HostList([0, 2, 3, 5], np.array([1.0, 2.0, 9.0, 4.0, 5.0]),
                  np.array([True, True, True, False, True]))
    c = column_from_host_lane(hl, np.array([True, False, True]),
                              dt.ArrayType(dt.FLOAT64), 4, device=CPU)
    assert isinstance(c, ListColumn) and c.total() == 4
    assert to_python(c, 3) == [[1.0, 2.0], None, [None, 5.0]]
    hs = HostStruct([(np.array([1, 2]), np.array([True, True])),
                     (hl.take(np.array([0, 2])), np.array([True, True]))])
    sc = column_from_host_lane(hs, np.array([True, False]),
                               dt.StructType((("i", dt.INT64), (
                                   "l", dt.ArrayType(dt.FLOAT64)))),
                               2, device=CPU)
    assert to_python(sc, 2) == [{"i": 1, "l": [1.0, 2.0]}, None]


def test_nested_batch_concat_limit_spill_and_split(tmp_path):
    from spark_rapids_tpu_torch.memory import spill as S
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.memory.retry import \
        split_spillable_in_half_by_rows
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.plan.host_table import (batch_to_table,
                                                        table_to_batch,
                                                        to_pydict)
    from spark_rapids_tpu_torch.plan.session import _host_table_from_pydict
    schema = [(k, t) for k, (t, _) in LAYOUTS.items()]
    n = min(len(v) for _, v in LAYOUTS.values())
    data = {k: v[:n] for k, (_, v) in LAYOUTS.items()}
    b = table_to_batch(_host_table_from_pydict(data, schema), device=CPU)
    both = K.concat_batches([b, b], 16)
    want = {k: v + v for k, v in data.items()}
    assert to_pydict(batch_to_table(both)) == want
    assert to_pydict(batch_to_table(K.local_limit(both, 2))) == \
        {k: v[:2] for k, v in data.items()}
    saved = S._CATALOG
    S.reset_spill_catalog(budget=MemoryBudget(1 << 30), spill_dir=str(
        tmp_path))
    try:
        sb = S.SpillableBatch(both)
        sb.spill_to_host()
        sb.spill_to_disk()
        assert to_pydict(batch_to_table(sb.get())) == want
        halves = split_spillable_in_half_by_rows(sb)
        parts = [to_pydict(batch_to_table(h.get())) for h in halves]
        assert {k: parts[0][k] + parts[1][k] for k in want} == want
        for h in halves:
            h.close()
    finally:
        S._CATALOG = saved


def test_type_names_read_jax_reprs():
    from spark_rapids_tpu.columnar import dtypes as jdt
    for jt, t in [
            (jdt.ArrayType(jdt.INT32), dt.ArrayType(dt.INT32)),
            (jdt.MapType(jdt.STRING, jdt.DecimalType(10, 2)),
             dt.MapType(dt.STRING, dt.DecimalType(10, 2))),
            (jdt.ArrayType(jdt.StructType((("0", jdt.FLOAT64),
                                           ("b", jdt.ArrayType(jdt.DATE))))),
             dt.ArrayType(dt.StructType((("0", dt.FLOAT64),
                                         ("b", dt.ArrayType(dt.DATE))))))]:
        assert dt.from_name(repr(jt)) == t == dt.from_name(jt.sql_name)
        assert repr(t) == jt.sql_name


def test_carry_takes_a_jax_host_table(data):
    from jax_reference import patch_jax_compiles
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.plan.host_table import HostColumn, HostTable
        cols = [HostColumn(np.array(data[k] + [None], dtype=object)
                           if t.is_nested else np.array(data[k] + [0]),
                           np.array([v is not None for v in data[k]] +
                                    [False]), t)
                for k, t in J.collection_schema(jdt)
                if k in ("a", "st", "ll", "x")]
        jt = HostTable(cols, ["a", "ll", "st", "x"])
        port = carry.host_tables_from({"t": jt})["t"]
    s = TpuSession(device="cpu")
    got = s.create_dataframe(port).collect()
    assert [r["a"] for r in got] == data["a"] + [None]
    assert [r["st"] for r in got] == data["st"] + [None]
    assert [r["ll"] for r in got] == data["ll"] + [None]


# --- gates -------------------------------------------------------------------

GATES = list(J.gate_exprs(CX, HO, col, lit))


@pytest.mark.parametrize("gate", GATES)
def test_gates_raise_at_planning(gate, port_df):
    """Each gate sends its expression to the CPU engine (the name is
    kept from when the port refused them): the node is marked ``!``
    and its rows equal the JAX package's."""
    df = port_df.select(Alias(J.gate_exprs(CX, HO, col, lit)[gate], "r"))
    marks = df.explain("NOT_ON_TPU").splitlines()
    assert marks[0].startswith("! Project"), marks
    got = [r["r"] for r in df.collect()]
    want = J.result("collections")["gates"][gate]
    assert len(got) == len(want) == N
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), (gate, i, g, w)


def _frozen(v):
    if isinstance(v, list):
        return tuple(_frozen(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _frozen(x)) for k, x in v.items())
    return v


def _spark_order(v):
    """Spark's ascending order, NULLs first, for the test's structs."""
    return (0,) if v is None else (1, v["p"] is not None, v["p"] or 0,
                                   v["q"] is not None, v["q"] or "")


@pytest.mark.parametrize("what", ["group_by", "sort", "join", "explode_map"])
def test_nested_keys_raise_at_planning(what, data, port_df):
    """A nested GROUP BY, ORDER BY or join key runs on the CPU engine
    (the name is kept from when the port refused them), against plain
    Python. explode of a map still raises: Spark gives a key and a value
    column, the port's Generate has one element column, and the JAX CPU
    engine explodes a map into its keys alone."""
    if what == "explode_map":
        with pytest.raises(NotImplementedError, match="not in this port"):
            port_df.select(CX.explode(HO.create_map(lit(1), col("x"))))
        return
    if what == "group_by":
        df = port_df.group_by(col("a")).agg()
        got = sorted((_frozen(r["a"]) for r in df.collect()), key=repr)
        want = sorted({_frozen(a) for a in data["a"]}, key=repr)
    elif what == "sort":
        df = port_df.sort(col("st"))
        got = [r["st"] for r in df.collect()]
        want = sorted(data["st"], key=_spark_order)
    else:
        df = port_df.join(port_df.select(col("a"), Alias(col("x"), "y")),
                          on="a")
        got = sorted(((_frozen(r["a"]), r["x"], r["y"])
                      for r in df.collect()), key=repr)
        rows = list(zip(data["a"], data["x"]))
        want = sorted(((_frozen(a), x, y) for a, x in rows for b, y in rows
                       if a is not None and a == b), key=repr)
    assert any(line.lstrip().startswith("!")
               for line in df.explain("NOT_ON_TPU").splitlines())
    assert got == want


# --- the slice as a whole ----------------------------------------------------


@pytest.fixture(scope="module")
def slice_inputs():
    return J.slice_tables()


@pytest.fixture(scope="module")
def slice_port(slice_inputs):
    li, _, no, docs = slice_inputs
    s = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4096}), device="cpu")
    on = s.create_dataframe(no.table())
    lidf = s.create_dataframe(li)
    out = {k: q.collect() for k, q in
           NM.queries(NM.port_api(), on, lidf).items()}
    s.create_or_replace_temp_view("orders_json", s.create_dataframe(
        NM.json_table(docs)))
    out["N6"] = s.sql(NM.N6_SQL).collect()
    return out


@pytest.mark.parametrize("q", ["N1", "N2", "N3", "N3_rows", "N4",
                               "N5_struct", "N5_explode", "N6", "N7"])
def test_slice_matches_jax_and_references(q, slice_inputs, slice_port):
    """N1-N7 at 20,000 lineitem rows: the port equals the JAX package
    and the numpy / json references. N7's ``array_max`` over the
    collected lists departs in the JAX package, which reads only a list
    bucket's first lanes of its longest groups (ROADMAP C17): there the
    port is held to numpy, and the JAX package on the counts."""
    li, _, no, docs = slice_inputs
    got = slice_port[q]
    want = J.result("n6") if q == "N6" else J.result("slice")[q]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if q == "N7":
            assert (g["n"], g["groups"]) == (w["n"], w["groups"])
            assert w["mx"] < g["mx"]
            continue
        assert _same(g, w), (q, g, w)
    if q == "N3_rows":
        assert got == NM.n3_rows_reference(no)
    elif q == "N6":
        ref = NM.json_reference(docs)
        assert {r["prio"] for r in got} == ref.keys()
        for r in got:
            assert _same(list(ref[r["prio"]]),
                         [r["total"], r["p1"], r["notes"], r["n"]])
    else:
        ref = NM.references(no, li)[q]
        if q == "N1":
            got = {r["pos"]: (r["rev"], r["n"]) for r in got}
            assert got.keys() == ref.keys()
            assert all(_same(list(got[k]), list(ref[k])) for k in ref)
        else:
            assert _same(got[0], ref), (q, got[0], ref)
