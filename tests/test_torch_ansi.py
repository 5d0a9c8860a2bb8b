"""ANSI mode (``srt.sql.ansi.enabled``) through both packages, on the
CPU.

Every case of the JAX package's tests/test_ansi.py runs through the
port's session (the device path, on CPU tensors), through the port's
CPU engine on the same rewritten plan (``execute_cpu(rewrite_plan(...))``)
and through the JAX session: an erroring case raises the same exception
type in all three, and the non-ANSI session runs it; a case that must
not raise gives the JAX package's rows.

Where the port follows Spark and the JAX package does not, the port is
held against plain Python and the JAX side's behaviour is asserted: a
guard fires only for the rows a conditional (IF, CASE, COALESCE) or
AND's short circuit lets reach it. The JAX package's IF raises for a
row its condition does not select (its CASE escapes only because its
rewrite misses the branches, expr/ansi.py). Also here: the kernel lanes
under ANSI (B1 takes double arithmetic and refuses integral arithmetic
or a cast that can fail; B3's inputs are evaluated, guards included,
before the kernel) and the single host read of an operator's guards.
"""

import math

import pytest

from torch_both import PORT, jax_api  # noqa: F401  (a fixture)

I64_MAX = 2 ** 63 - 1
I32_MAX = 2 ** 31 - 1


def _dec(api, p, s):
    return api.dt.DecimalType(p, s)


# --- the cases of tests/test_ansi.py ---------------------------------------
# each: (build(api, session) -> DataFrame, the exception's name or None)

def _unary(vals, t, fn):
    return lambda a, s: a.df(s, {"x": vals}, [("x", t)]).select(
        fn(a).alias("y"))


def _binary(xs, ds, t, fn):
    return lambda a, s: a.df(s, {"x": xs, "d": ds},
                             [("x", t), ("d", t)]).select(fn(a).alias("y"))


def _cast(vals, t, to):
    return lambda a, s: a.df(s, {"x": vals}, [("x", t)]).select(
        a.Cast(a.col("x"), getattr(a.dt, to)).alias("y"))


def _sum(xs):
    return lambda a, s: a.df(s, {"g": [0, 0, 1][:len(xs)], "x": xs},
                             [("g", "INT64"), ("x", "INT64")]) \
        .group_by(a.col("g")).agg(a.Agg.Sum(a.col("x")).alias("sx"))


def _sort(xs):
    return lambda a, s: a.df(s, {"x": xs}, [("x", "INT64")]).sort(
        (a.col("x") + a.lit(1)).alias("k"))


def _decimal_mod(a, s):
    import decimal
    D = decimal.Decimal
    return a.df(s, {"x": [D("1.50"), D("2.25")], "d": [D("1.00"), D("0.00")]},
                [("x", _dec(a, 3, 2)), ("d", _dec(a, 3, 2))]) \
        .select((a.col("x") % a.col("d")).alias("y"))


def _sql_overflow(a, s):
    s.create_or_replace_temp_view("t", a.df(s, {"x": [I64_MAX, 1]},
                                            [("x", "INT64")]))
    return s.sql("SELECT x + 1 AS y FROM t")


ARITH = "SparkArithmeticException"
CAST_OVF = "SparkCastOverflowException"
CASES = {
    "long_add_overflow": (_unary([I64_MAX, 5], "INT64",
                                 lambda a: a.col("x") + a.lit(1)), ARITH),
    "long_subtract_overflow": (_unary([-I64_MAX - 1, 5], "INT64",
                                      lambda a: a.col("x") - a.lit(2)),
                               ARITH),
    "long_multiply_overflow": (_unary([I64_MAX // 2 + 1, 1], "INT64",
                                      lambda a: a.col("x") * a.lit(2)),
                               ARITH),
    "unary_minus_min_long": (_unary([-(2 ** 63), 1], "INT64",
                                    lambda a: -a.col("x")), ARITH),
    "divide_by_zero": (_binary([1.5, 2.5], [1.0, 0.0], "FLOAT64",
                               lambda a: a.col("x") / a.col("d")), ARITH),
    "integral_divide_by_zero": (_binary(
        [10, 20], [2, 0], "INT64",
        lambda a: a.A.IntegralDivide(a.col("x"), a.col("d"))), ARITH),
    "remainder_by_zero": (_binary([10, 20], [3, 0], "INT64",
                                  lambda a: a.col("x") % a.col("d")), ARITH),
    "cast_long_to_int_overflow": (_cast([I32_MAX + 10, 1], "INT64",
                                        "INT32"), CAST_OVF),
    "cast_float_nan_to_int": (_cast([math.nan, 1.0], "FLOAT64", "INT64"),
                              CAST_OVF),
    "cast_float_out_of_range_to_int": (_cast([1e30, 1.0], "FLOAT64",
                                             "INT64"), CAST_OVF),
    "cast_invalid_string_to_int": (_cast(["12", "not_a_number"], "STRING",
                                         "INT64"),
                                   "SparkNumberFormatException"),
    "cast_valid_values_do_not_raise": (_cast(["12", "34"], "STRING",
                                             "INT64"), None),
    "null_inputs_do_not_raise": (_cast(["12", None], "STRING", "INT64"),
                                 None),
    "sum_long_overflow": (_sum([I64_MAX] * 3), ARITH),
    "sum_no_overflow_exact": (_sum([5, 7, 9]), None),
    "order_by_overflow_raises": (_sort([I64_MAX, 5]), ARITH),
    "order_by_valid_expr_under_ansi": (_sort([3, 1, 2]), None),
    "decimal_remainder_by_zero": (_decimal_mod, ARITH),
    "sql_ansi_overflow": (_sql_overflow, ARITH),
}


def _rows(df):
    return sorted(map(repr, df.collect()))


@pytest.mark.parametrize("name", list(CASES))
def test_ansi_case_as_the_jax_package(name, jax_api):
    build, exc = CASES[name]
    port_ansi = PORT.session(True)
    if exc is None:
        want = _rows(build(jax_api, jax_api.session(True)))
        assert _rows(build(PORT, port_ansi)) == want
        assert sorted(map(repr, _cpu_rows(build(PORT, port_ansi)))) == want
        return
    with pytest.raises(getattr(PORT.ERR, exc)):
        build(PORT, port_ansi).collect()
    with pytest.raises(getattr(PORT.ERR, exc)):
        PORT.execute_cpu(PORT.rewrite_plan(build(PORT, port_ansi).plan))
    with pytest.raises(getattr(jax_api.ERR, exc)):
        build(jax_api, jax_api.session(True)).collect()
    # non-ANSI: rows (null or wrapped), as the JAX package's
    assert _rows(build(PORT, PORT.session(False))) == \
        _rows(build(jax_api, jax_api.session(False)))


def _cpu_rows(df):
    from spark_rapids_tpu_torch.plan.host_table import from_engine, to_pydict
    data = to_pydict(from_engine(PORT.execute_cpu(
        PORT.rewrite_plan(df.plan))))
    return [dict(zip(data, vals)) for vals in zip(*data.values())]


# --- guards fire only for the rows that reach them ---------------------------

XS = [10, 20, 30, None, -7]
DS = [2, 0, 3, 0, 0]


def _guarded_df(a, s):
    s.create_or_replace_temp_view("t", a.df(s, {"x": XS, "d": DS},
                                            [("x", "INT64"), ("d", "INT64")]))
    return s


def _py_div(x, d):
    if x is None or d == 0:
        return None
    q = abs(x) // abs(d)
    return q if (x < 0) == (d < 0) else -q


GUARDED = {
    "case_when": ("SELECT CASE WHEN d <> 0 THEN x div d ELSE -1 END AS y "
                  "FROM t",
                  [_py_div(x, d) if d != 0 else -1 for x, d in zip(XS, DS)]),
    "if": ("SELECT IF(d <> 0, x % d, 0) AS y FROM t",
           [None if x is None and d != 0 else
            (int(math.fmod(x, d)) if d != 0 else 0)
            for x, d in zip(XS, DS)]),
    "and_short_circuit": ("SELECT x FROM t WHERE d <> 0 AND x div d > 5",
                          [x for x, d in zip(XS, DS) if d != 0 and
                           x is not None and _py_div(x, d) > 5]),
    "or_short_circuit": ("SELECT x FROM t WHERE d = 0 OR x div d > 5",
                         [x for x, d in zip(XS, DS) if d == 0 or
                          (x is not None and _py_div(x, d) > 5)]),
    "coalesce": ("SELECT COALESCE(d, x div 0) AS y FROM t", DS),
    "nested_case": ("SELECT CASE WHEN d = 0 THEN 0 WHEN x > 15 THEN "
                    "x div (d - 2) ELSE x div d END AS y FROM t",
                    [0 if d == 0 else None if x is None else
                     _py_div(x, d - 2) if x > 15 else _py_div(x, d)
                     for x, d in zip(XS, DS)]),
}


@pytest.mark.parametrize("name", list(GUARDED))
def test_guards_respect_the_rows_that_reach_them(name):
    """Both port engines run these under ANSI without raising, and equal
    plain Python; the unguarded division raises."""
    text, want = GUARDED[name]
    s = _guarded_df(PORT, PORT.session(True))
    df = s.sql(text)
    got = [list(r.values())[0] for r in df.collect()]
    assert got == want
    cpu = [list(r.values())[0] for r in _cpu_rows(df)]
    assert cpu == want
    with pytest.raises(PORT.ERR.SparkArithmeticException):
        s.sql("SELECT x div d AS y FROM t").collect()


def test_jax_if_raises_for_an_unselected_row(jax_api):
    """The JAX package's IF guards every row: ``IF(d <> 0, x div d, -1)``
    raises there where Spark, and the port, do not (its CASE escapes
    only because its plan rewrite leaves the branches unmarked)."""
    def q(a, s):
        return a.df(s, {"x": XS, "d": DS}, [("x", "INT64"), ("d", "INT64")]) \
            .select(a.Cond.If(a.P.Not(a.P.EqualTo(a.col("d"), a.lit(0))),
                              a.A.IntegralDivide(a.col("x"), a.col("d")),
                              a.lit(-1)).alias("y"))
    with pytest.raises(jax_api.ERR.SparkArithmeticException):
        q(jax_api, jax_api.session(True)).collect()
    assert [r["y"] for r in q(PORT, PORT.session(True)).collect()] == \
        [_py_div(x, d) if d != 0 else -1 for x, d in zip(XS, DS)]
    s = _guarded_df(jax_api, jax_api.session(True))
    assert [r["y"] for r in s.sql(GUARDED["case_when"][0]).collect()] == \
        GUARDED["case_when"][1]


# --- the kernel lanes and the host reads --------------------------------------

def _agg_exec(physical):
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    stack = [physical]
    while stack:
        node = stack.pop()
        if isinstance(node, HashAggregateExec) and node.mode == "partial":
            return node
        stack.extend(node.children)
    raise AssertionError("no partial aggregate")


@pytest.mark.parametrize("expr, takes", [
    ("SUM(f * (1 - g))", True),         # double arithmetic: no check
    ("SUM(f / 2)", True),               # a divide by a non-zero literal
    ("SUM(f / g)", False),              # a divide that can meet zero
    ("SUM(CAST(i * 2 AS DOUBLE))", False),   # integral arithmetic
    ("SUM(CAST(CAST(f AS INT) AS DOUBLE))", False),  # a cast that can fail
])
def test_b1_under_ansi(expr, takes):
    """B1 takes an ANSI tree whose nodes have no check at their types and
    refuses one that must run a check; the result equals the non-ANSI
    run's."""
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    rows = {"f": [1.5, 2.5, 4.0, None], "g": [0.5, 0.25, 0.0, 1.0],
            "i": [1, 2, 3, 4]}
    types = [("f", "FLOAT64"), ("g", "FLOAT64"), ("i", "INT32")]
    text = f"SELECT {expr} AS r FROM t WHERE g < 1.0 AND g > 0.0"
    out = {}
    for ansi in (True, False):
        s = PORT.session(ansi)
        s.create_or_replace_temp_view("t", PORT.df(s, rows, types))
        df = s.sql(text)
        plan = PORT.rewrite_plan(df.plan) if ansi else df.plan
        agg = _agg_exec(apply_overrides(plan, s.conf))
        if ansi:
            assert agg._pallas_gate == takes
        else:
            assert agg._pallas_gate
        out[ansi] = df.collect()
        launched = s._last_execution[1].metric_totals().get(
            "pallasBatches", 0)
        assert launched == (1 if takes or not ansi else 0)
    assert out[True] == out[False]


def test_b3_under_ansi():
    """The grouped lane takes a double sum under ANSI; an integral input
    sum is not sum-decomposable for it, ANSI or not."""
    n = 6000   # three batches, each past B3's 1024-row floor
    s = PORT.session(True, **{"srt.sql.batchSizeRows": 2048})
    rows = {"k": [i % 3 for i in range(n)],
            "f": [i * 0.5 for i in range(n)],
            "l": list(range(n))}
    s.create_or_replace_temp_view("t", PORT.df(
        s, rows, [("k", "INT64"), ("f", "FLOAT64"), ("l", "INT64")]))
    df = s.sql("SELECT k, SUM(f * 2) AS a, COUNT(*) AS c FROM t GROUP BY k "
               "ORDER BY k")
    assert [(r["k"], r["a"], r["c"]) for r in df.collect()] == [
        (k, sum(i * 1.0 for i in range(n) if i % 3 == k),
         len([i for i in range(n) if i % 3 == k])) for k in range(3)]
    assert s._last_execution[1].metric_totals()["pallasBatches"] == 3
    with pytest.raises(PORT.ERR.SparkArithmeticException):
        s.sql("SELECT k, SUM(f / (l - 100)) AS a FROM t GROUP BY k") \
            .collect()


def test_one_host_read_per_operator_batch(monkeypatch):
    """Every guard of a projection's batch is read with one host sync:
    ``flush`` runs once per operator batch with every flag of the tree
    gathered (q1's projection has many marked nodes)."""
    from spark_rapids_tpu_torch.expr import ansi
    calls = []
    orig = ansi.flush

    def counting(pending):
        calls.append(len(pending))
        return orig(pending)
    monkeypatch.setattr(ansi, "flush", counting)
    s = PORT.session(True, **{"srt.sql.batchSizeRows": 4})
    s.create_or_replace_temp_view("t", PORT.df(
        s, {"a": list(range(10)), "b": list(range(1, 11))},
        [("a", "INT64"), ("b", "INT64")]))
    s.sql("SELECT a + b AS p, a * b - 1 AS q, CAST(a AS INT) AS r, "
          "a div b AS d FROM t").collect()
    flagged = [n for n in calls if n]
    assert len(flagged) == 3          # three batches of the projection
    assert all(n >= 5 for n in flagged)


# --- E2 of the card's phase 5f at a small size -----------------------------

def _lineitem(a, s, n=3000, seed=13):
    import numpy as np
    rng = np.random.default_rng(seed)
    data = {"l_partkey": [int(v) for v in rng.integers(1, 200_000, n)],
            "l_discount": [round(int(v) * 0.01, 2)
                           for v in rng.integers(0, 11, n)],
            "l_returnflag": [["A", "N", "R"][int(v)]
                             for v in rng.integers(0, 3, n)],
            "l_extendedprice": [float(v) for v in rng.uniform(900, 105_000,
                                                               n)]}
    data["l_partkey"][:2] = [1, 2]   # no row overflow before row 2
    s.create_or_replace_temp_view("lineitem", a.df(s, data, [
        ("l_partkey", "INT64"), ("l_discount", "FLOAT64"),
        ("l_returnflag", "STRING"), ("l_extendedprice", "FLOAT64")]))
    return data


@pytest.mark.parametrize("name", list(__import__(
    "spark_rapids_tpu_torch.models.surface", fromlist=["E2"]).E2))
def test_e2_errors_as_the_jax_package(name, jax_api):
    """Each E2 case raises the type and first message line that
    models/surface.py records, in both port engines and the JAX
    package; without ANSI the port's row equals the JAX package's
    (a DECIMAL(7,2) cast apart: the JAX package keeps a price that
    rounds up to 100000.00, past the precision, so there the port is
    held against plain Python)."""
    from spark_rapids_tpu_torch.models.surface import E2
    text, exc, first = E2[name]
    for a, engine in ((PORT, "device"), (PORT, "cpu"), (jax_api, "jax")):
        s = a.session(True)
        _lineitem(a, s)
        with pytest.raises(getattr(a.ERR, exc)) as e:
            if engine == "cpu":
                a.execute_cpu(a.rewrite_plan(s.sql(text).plan))
            else:
                s.sql(text).collect()
        assert str(e.value).splitlines()[0] == first, (engine, e.value)
    got = PORT.session(False)
    data = _lineitem(PORT, got)
    rows = got.sql(text).collect()
    if name == "decimal_cast":
        import decimal
        cents = [int(decimal.Decimal(repr(p)).quantize(
            decimal.Decimal("0.01"), rounding=decimal.ROUND_HALF_UP)
            * 100) for p in data["l_extendedprice"]]
        kept = [c for c in cents if c < 10 ** 7]
        assert rows == [{"v": decimal.Decimal(sum(kept)).scaleb(-2),
                         "n": len(kept)}]
        return
    js = jax_api.session(False)
    _lineitem(jax_api, js)
    assert rows == js.sql(text).collect()


def test_e2_guarded_divide(jax_api):
    from spark_rapids_tpu_torch.models.surface import E2_GUARDED
    s = PORT.session(True)
    data = _lineitem(PORT, s)
    rows = s.sql(E2_GUARDED).collect()
    d = [int(x * 100) for x in data["l_discount"]]
    want = [p % k for p, k in zip(data["l_partkey"], d) if k]
    assert rows == [{"v": sum(want), "n": len(want)}]
    js = jax_api.session(True)
    _lineitem(jax_api, js)
    assert js.sql(E2_GUARDED).collect() == rows
