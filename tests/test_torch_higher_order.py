"""Higher-order functions and maps through both packages on the CPU.

Cases from tests/test_higher_order.py: ``transform`` (with the element
index and an outer column), ``exists`` / ``forall`` with Spark's
three-valued logic, ``filter``, ``aggregate`` (an integer fold, a float
fold held bit for bit, a finish lambda), and the map functions over
numpy-seeded arrays and maps with NULL rows, empty rows and NULL
elements. The JAX side runs in a subprocess (tests/torch_nested_jax.py).
Where the port follows Spark (``map_from_arrays`` of arrays of two
lengths, a NULL or repeated map key raise; ROADMAP C17) it is held
against plain Python. The fold's steps follow the longest list
(``FOLD_STEPS``). Each planner gate on lambdas sends its expression to
the CPU engine, held against the JAX package's rows (plain Python for
an ``aggregate`` reading an outer column, which the JAX engine cannot
resolve).
"""

import math

import pytest

import torch_nested_jax as J
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import collections as CX
from spark_rapids_tpu_torch.expr import higher_order as HO
from spark_rapids_tpu_torch.expr.core import Alias, col, lit
from spark_rapids_tpu_torch.plan.session import TpuSession

RTOL = 1e-9
EXACT = ("aggregate_float", "aggregate_finish")


@pytest.fixture(scope="module", autouse=True)
def _jax_jobs(tmp_path_factory):
    J.start(tmp_path_factory)


@pytest.fixture(scope="module")
def session():
    return TpuSession(device="cpu")


@pytest.fixture(scope="module")
def df(session):
    return session.create_dataframe(J.hof_data(), J.hof_schema(dt))


@pytest.fixture(scope="module")
def port_side(df):
    exprs = J.hof_exprs(CX, HO, col, lit)
    rows = df.select(*[Alias(e, k) for k, e in exprs.items()]).collect()
    return {k: [r[k] for r in rows] for k in exprs}


def _same(a, b, exact=False):
    if isinstance(a, float) and isinstance(b, float):
        return a == b if exact else math.isclose(a, b, rel_tol=RTOL)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y, exact)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k], exact)
                                            for k in a)
    return a == b


@pytest.mark.parametrize("case", list(J.hof_exprs(CX, HO, col, lit)))
def test_matches_jax(case, port_side):
    got, want = port_side[case], J.result("hof")[case]
    assert len(got) == len(want) == J.N
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w, exact=case in EXACT), (case, i, g, w)


def test_three_valued_exists_and_forall(session):
    d = session.create_dataframe(
        {"a": [[1, None], [None], [5, None], [], None, [1, 2]]},
        [("a", dt.ArrayType(dt.INT64))])
    rows = d.select(Alias(HO.exists(col("a"), lambda v: v > lit(3)), "e"),
                    Alias(HO.forall(col("a"), lambda v: v < lit(3)),
                          "f")).collect()
    assert [r["e"] for r in rows] == [None, None, True, False, None, False]
    assert [r["f"] for r in rows] == [None, None, False, True, None, True]


def test_fold_steps_follow_the_longest_list(session):
    long = list(range(1, 40))
    d = session.create_dataframe({"a": [[1, 2], long, None, []]},
                                 [("a", dt.ArrayType(dt.INT64))])
    HO.FOLD_STEPS["steps"] = 0
    rows = d.select(Alias(HO.aggregate(col("a"), lit(0),
                                       lambda acc, v: acc * 2 + v),
                          "r")).collect()
    want = []
    for xs in ([1, 2], long, None, []):
        acc = 0
        for v in xs or []:
            acc = acc * 2 + v
        want.append(None if xs is None else acc)
    assert [r["r"] for r in rows] == want
    assert HO.FOLD_STEPS["steps"] == len(long)


def test_map_from_arrays_lengths_follow_spark(session):
    """Spark raises where the two arrays differ; the JAX package nulls
    the row."""
    d = session.create_dataframe(
        {"ks": [[1, 2], [3]], "vs": [[10, 20], [30, 40]]},
        [("ks", dt.ArrayType(dt.INT64)), ("vs", dt.ArrayType(dt.INT64))])
    q = d.select(Alias(HO.map_from_arrays(col("ks"), col("vs")), "m"))
    with pytest.raises(ValueError, match="differ in length"):
        q.collect()
    assert [r["m"] for r in J.result("hof")["mismatch"]] == [{1: 10, 2: 20},
                                                             None]


@pytest.mark.parametrize("case", ["duplicate", "null_key", "create_map",
                                  "transform_keys"])
def test_map_keys_follow_spark(case, session):
    d = session.create_dataframe(
        {"ks": [[1, 2, 1], [None]], "x": [1, 2]},
        [("ks", dt.ArrayType(dt.INT64)), ("x", dt.INT64)])
    e = {"duplicate": HO.map_from_arrays(CX.Slice(col("ks"), lit(1), lit(3)),
                                         col("ks")),
         "null_key": HO.map_from_arrays(CX.Slice(col("ks"), lit(-1),
                                                 lit(1)),
                                        CX.Slice(col("ks"), lit(-1), lit(1))),
         "create_map": HO.create_map(col("x"), lit(1), lit(1), lit(2)),
         "transform_keys": HO.transform_keys(
             HO.map_from_arrays(CX.array(lit(1), lit(2)),
                                CX.array(lit(5), lit(6))),
             lambda k, v: k * lit(0))}[case]
    with pytest.raises(ValueError, match="map key"):
        d.select(Alias(e, "m")).collect()


GATES = list(J.hof_gate_exprs(CX, HO, col, lit))


def _outer_fold(a, x):
    """aggregate(a, 0, (acc, v) -> acc + v + x) in plain Python."""
    if a is None:
        return None
    acc = 0
    for v in a:
        acc = None if acc is None or v is None else acc + v + x
    return acc


@pytest.mark.parametrize("gate", GATES)
def test_gates_raise_at_planning(gate, df):
    """Each gate sends its expression to the CPU engine (the name is
    kept from when the port refused them): the node is marked ``!``
    and its rows equal the JAX package's."""
    q = df.select(Alias(J.hof_gate_exprs(CX, HO, col, lit)[gate], "r"))
    assert q.explain("NOT_ON_TPU").splitlines()[0].startswith("! Project")
    got = [r["r"] for r in q.collect()]
    want = J.result("hof")["gates"][gate]
    if isinstance(want, Exception):
        data = J.hof_data()
        want = [_outer_fold(a, x) for a, x in zip(data["a"], data["x"])]
    assert len(got) == len(want) == J.N
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), (gate, i, g, w)
