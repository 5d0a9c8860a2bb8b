"""Window functions through both packages' DataFrame API on the CPU.

Every case of the JAX package's window suites (tests/test_window.py and
tests/test_window_batched.py) builds the same query over the same data,
made from a numpy seed, in the JAX package and in the port; the port's
rows must equal the JAX package's as a multiset (floats to 1e-9, both
float64; the rest exactly). The JAX side runs once for the module,
every case in one session, under a patch that makes each JAX cache
read a miss (tests/conftest.py wraps jax's ``_cache_read`` with four
arguments, this jax passes five); the JAX package is imported under that
patch.

Where the port departs from the JAX package, the case says how:
- string min/max over a window and a min/max sliding frame with an
  unbounded side run on the CPU engine in both packages (``!`` nodes),
  held against the JAX package's rows; a RANGE frame with value offsets
  over two order keys raises while planning (Spark refuses it; the JAX
  engine reads the first key alone);
- the decimal RANGE key case runs both packages over DECIMAL(10,2);
- a ``Lag`` string default longer than both string buffers is held
  against plain Python (the JAX string select cuts it: condition C4 in
  ROADMAP.md).

Beyond the JAX suites: a float64 running sum whose partition follows one
whose total is about 1e12 (held at 1e-9 against ``math.fsum``), the
batched running exec carrying state across batches, window MIN over
frames holding NaN (ROADMAP.md C6: Spark puts NaN above every number,
the JAX package returns NaN; plain Python reference, over each frame
kind), and the segmented primitives against plain Python.
"""

import bisect
import decimal
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.vector import column_from_numpy
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.exec import window as XW
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.testing import compare_rows

RTOL = 1e-9
N = 96


def _ns(pkg: str) -> SimpleNamespace:
    """The window API of one package under common names."""
    W = importlib.import_module(f"{pkg}.expr.window")
    A = importlib.import_module(f"{pkg}.expr.aggregates")
    core = importlib.import_module(f"{pkg}.expr.core")
    logical = importlib.import_module(f"{pkg}.plan.logical")
    names = ("Window", "WindowFrame", "WindowSpec", "RowNumber", "Rank",
             "DenseRank", "PercentRank", "NTile", "Lead", "Lag",
             "UNBOUNDED")
    aggs = ("Sum", "Count", "CountStar", "Min", "Max", "Average")
    return SimpleNamespace(
        **{n: getattr(W, n) for n in names}, **{n: getattr(A, n)
                                                 for n in aggs},
        col=core.col, SortField=logical.SortField)


# --- data: {name: (values, type name)} from numpy seeds ----------------------

def _nulls(rng, values, rate):
    return [None if rng.random() < rate else v for v in values]


def _ints(rng, lo, hi, n, null_rate=0.0):
    return _nulls(rng, [int(x) for x in rng.integers(lo, hi + 1, n)],
                  null_rate)


def _base(seed=0, n=N):
    rng = np.random.default_rng(seed)
    o = _ints(rng, 0, 1000, n)
    return {"k": (_ints(rng, 0, 4, n, 0.1), "int"),
            "o": (o, "int"),
            "v": (_ints(rng, -100, 100, n, 0.1), "int"),
            "f": (_nulls(rng, [float(x) for x in rng.normal(0, 50, n)], 0.1),
                  "double"),
            # the JAX suite orders by (o % 5); the port has no '%' yet,
            # so both packages read the same key as a column
            "om": ([x % 5 for x in o], "int")}


def _range_data(seed, n, p_hi, o_hi, v_lo, v_hi, o_nulls=0.0):
    rng = np.random.default_rng(seed)
    return {"p": (_ints(rng, 0, p_hi, n), "int"),
            "o": (_ints(rng, 0, o_hi, n, o_nulls), "int"),
            "v": (_ints(rng, v_lo, v_hi, n, 0.05), "int")}


def _batched_data(n, n_keys, seed=0):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, n_keys, n)
    os_ = rng.integers(0, 6, n)
    vs = rng.uniform(0, 10, n)
    return {"k": ([int(x) for x in ks], "bigint"),
            "o": ([int(x) for x in os_], "bigint"),
            "v": ([None if i % 5 == 0 else float(x)
                   for i, x in enumerate(vs)], "double")}


TABLES = {
    "base": _base(),
    "base48": _base(n=48),
    "strings": {"k": ([i % 3 for i in range(48)], "int"),
                "s": ([None if i % 7 == 0 else "abcd"[:1 + i % 4]
                       for i in range(48)], "string")},
    "kx": {"k": ([1, 1, 2], "bigint"), "x": ([10, 20, 30], "bigint")},
    "peers6": {"k": ([1] * 6, "bigint"), "o": ([1, 1, 2, 2, 2, 3], "bigint"),
               "v": ([1, 2, 3, 4, 5, 6], "bigint")},
    "peers4": {"k": ([1] * 4, "bigint"), "o": ([1, 1, 2, 2], "bigint"),
               "v": ([1, 2, 3, 4], "bigint")},
    "range_sa": _range_data(29, 200, 3, 50, -20, 20),
    "range_mm": _range_data(31, 200, 3, 40, -50, 50),
    "range_up": _range_data(37, 150, 2, 30, -9, 9),
    "range_desc": _range_data(41, 150, 2, 25, -9, 9, o_nulls=0.1),
    "inf": {"p": ([1] * 6, "bigint"), "o": ([0, 10, 20, 30, 40, 50],
                                            "bigint"),
            "v": ([1.0, float("inf"), 2.0, 3.0, 4.0, 5.0], "double")},
    "nullp": {"p": ([None if i % 3 == 0 else i % 4 for i in range(64)],
                    "bigint"),
              "o": (list(range(64)), "bigint"),
              "v": ([float(i) for i in range(64)], "double")},
    "nanp": {"p": ([float("nan"), 1.0, float("nan"), 1.0, float("nan"), 2.0],
                   "double"),
             "o": ([1, 2, 3, 4, 5, 6], "bigint"),
             "v": ([10.0, 20.0, 30.0, 40.0, 50.0, 60.0], "double")},
    "batched": _batched_data(3000, 7, seed=1),
    "batched_small": _batched_data(50, 3),
    "one_partition": {"k": ([1] * 1000, "bigint"),
                      "o": (list(range(1000)), "bigint"),
                      "v": ([float(i % 13) for i in range(1000)], "double")},
}


def _frame(m, lo, hi, rows=True):
    return m.WindowFrame(lo, hi, row_based=rows)


def _running(m, rows=True):
    return _frame(m, None, 0, rows)


def _batched_select(m, df):
    w = m.Window.partition_by("k").order_by("o").with_frame(_running(m))
    return df.select(
        "k", "o", "v",
        m.RowNumber().over(w).alias("rn"), m.Rank().over(w).alias("rk"),
        m.DenseRank().over(w).alias("dr"),
        m.Sum(m.col("v")).over(w).alias("s"),
        m.Min(m.col("v")).over(w).alias("mn"),
        m.Max(m.col("v")).over(w).alias("mx"),
        m.Count(m.col("v")).over(w).alias("c"),
        m.Average(m.col("v")).over(w).alias("av"))


def _range_spec(m, lo, hi, desc=False):
    order = m.SortField(m.col("o"), ascending=False) if desc else m.col("o")
    return m.WindowSpec(partition_by=[m.col("p")], order_fields=[order],
                        frame=_frame(m, lo, hi, rows=False))


#: name -> (table, conf settings, query builder over a package namespace)
CASES = {
    "row_number": ("base", {}, lambda m, df: df.select(
        "k", "o", "v", m.RowNumber().over(
            m.Window.partition_by("k").order_by("o", "v")).alias("rn"))),
    "rank_dense_rank": ("base", {}, lambda m, df: df.select(
        "k", "o",
        *[f().over(m.Window.partition_by("k").order_by("om")).alias(a)
          for f, a in ((m.Rank, "r"), (m.DenseRank, "dr"),
                       (m.PercentRank, "pr"))])),
    "ntile": ("base", {}, lambda m, df: df.select(
        "k", *[m.NTile(n).over(m.Window.partition_by("k").order_by(
            "o", "v")).alias(f"n{n}") for n in (3, 7)])),
    "lead_lag": ("base", {}, lambda m, df: df.select(
        "k", "o", "v",
        m.Lead(m.col("v")).over(m.Window.partition_by("k").order_by(
            "o", "v")).alias("ld1"),
        m.Lag(m.col("v"), 2).over(m.Window.partition_by("k").order_by(
            "o", "v")).alias("lg2"),
        m.Lead(m.col("v"), 1, default=-999).over(
            m.Window.partition_by("k").order_by("o", "v")).alias("ldd"))),
    "running_aggregates": ("base", {}, lambda m, df: df.select(
        "k", "o",
        *[fn.over(m.Window.partition_by("k").order_by("o", "v")).alias(a)
          for fn, a in ((m.Sum(m.col("v")), "rsum"),
                        (m.Count(m.col("v")), "rcnt"),
                        (m.CountStar(), "rn"), (m.Min(m.col("v")), "rmin"),
                        (m.Max(m.col("v")), "rmax"),
                        (m.Average(m.col("f")), "ravg"))])),
    "whole_partition_aggregates": ("base", {}, lambda m, df: df.select(
        "k", "v",
        *[fn.over(m.Window.partition_by("k")).alias(a)
          for fn, a in ((m.Sum(m.col("v")), "psum"),
                        (m.Average(m.col("f")), "pavg"),
                        (m.CountStar(), "pn"))])),
    "sliding_frames": ("base", {}, lambda m, df: df.select(
        "k", "o",
        *[fn.over(m.Window.partition_by("k").order_by("o", "v")
                  .with_frame(_frame(m, lo, hi))).alias(a)
          for fn, lo, hi, a in ((m.Sum(m.col("v")), -2, 2, "ssum"),
                                (m.Count(m.col("v")), -2, 2, "scnt"),
                                (m.Min(m.col("v")), -1, 1, "smin"),
                                (m.Max(m.col("v")), -1, 1, "smax"))])),
    "trailing_frame": ("base", {}, lambda m, df: df.select(
        "k", m.Sum(m.col("v")).over(m.Window.partition_by("k").order_by(
            "o", "v").with_frame(_frame(m, -3, 0))).alias("tsum"))),
    "no_partition_window": ("base48", {}, lambda m, df: df.select(
        "o", "v",
        m.RowNumber().over(m.Window.partition_by().order_by("o", "v"))
        .alias("rn"),
        m.Sum(m.col("v")).over(m.Window.partition_by().order_by("o", "v"))
        .alias("rs"))),
    "multiple_specs_chain": ("base", {}, lambda m, df: df.select(
        "k", "o",
        m.RowNumber().over(m.Window.partition_by("k").order_by("o", "v"))
        .alias("rn_k"),
        m.Rank().over(m.Window.partition_by().order_by("v", "o"))
        .alias("r_all"))),
    "windows_run_on_the_device_path": ("base", {}, lambda m, df: df.select(
        "k",
        m.RowNumber().over(m.Window.partition_by("k").order_by("o", "v"))
        .alias("rn"),
        m.Sum(m.col("v")).over(m.Window.partition_by("k").order_by("o", "v"))
        .alias("rs"))),
    "window_column_replaces_existing": ("kx", {}, lambda m, df:
                                        df.with_column("x", m.Sum(m.col(
                                            "x")).over(m.Window.partition_by(
                                                "k")))),
    "range_running_frame_peers": ("peers6", {}, lambda m, df: df.select(
        "o", "v", m.Sum(m.col("v")).over(m.Window.partition_by("k").order_by(
            "o").with_frame(_running(m, rows=False))).alias("rs"))),
    "default_frame_is_range_running": ("peers4", {}, lambda m, df: df.select(
        "v", m.Sum(m.col("v")).over(m.Window.partition_by("k").order_by(
            "o")).alias("rs"))),
    "range_frame_sum_avg": ("range_sa", {}, lambda m, df: df.select(
        m.col("p"), m.col("o"),
        *[fn.over(_range_spec(m, -5, 3)).alias(a)
          for fn, a in ((m.Sum(m.col("v")), "s"), (m.Count(m.col("v")), "n"),
                        (m.Average(m.col("v")), "a"))])),
    "range_frame_min_max": ("range_mm", {}, lambda m, df: df.select(
        m.col("p"), m.col("o"),
        m.Min(m.col("v")).over(_range_spec(m, -10, 0)).alias("mn"),
        m.Max(m.col("v")).over(_range_spec(m, -10, 0)).alias("mx"))),
    "range_frame_unbounded_preceding_value_following": (
        "range_up", {}, lambda m, df: df.select(
            m.col("p"), m.col("o"),
            m.Sum(m.col("v")).over(_range_spec(m, m.UNBOUNDED, 2))
            .alias("s"),
            m.Max(m.col("v")).over(_range_spec(m, m.UNBOUNDED, 2))
            .alias("mx"))),
    "range_frame_desc_and_nulls": ("range_desc", {}, lambda m, df: df.select(
        m.col("p"), m.col("o"),
        m.Sum(m.col("v")).over(_range_spec(m, -4, 4, desc=True))
        .alias("s"))),
    "range_frame_inf_isolation": ("inf", {}, lambda m, df: df.select(
        m.col("o"), m.Sum(m.col("v")).over(_range_spec(m, -5, 5))
        .alias("s"))),
    "null_partition_key_forms_one_partition": ("nullp", {}, lambda m, df:
                                               df.select(
        m.col("p"), m.col("o"),
        m.Sum(m.col("v")).over(m.Window.partition_by("p").order_by("o")
                               .with_frame(_running(m))).alias("rs"),
        m.RowNumber().over(m.Window.partition_by("p").order_by("o"))
        .alias("rn"))),
    "nan_partition_key_groups_with_nan": ("nanp", {}, lambda m, df: df.select(
        m.col("p"), m.col("o"),
        m.Sum(m.col("v")).over(m.Window.partition_by("p").order_by("o")
                               .with_frame(_running(m))).alias("rs"))),
    # tests/test_window_batched.py
    "batched_matches_whole_partition": (
        "batched", {"srt.sql.batchSizeRows": 256,
                    "srt.sql.window.batchedRunning.enabled": True},
        _batched_select),
    "single_partition_spanning_all_batches": (
        "one_partition", {"srt.sql.batchSizeRows": 64}, _batched_select),
}


def _jax_frame(session, jdt, table):
    types = {"int": jdt.INT32, "bigint": jdt.INT64, "double": jdt.FLOAT64,
             "string": jdt.STRING}
    data = {n: v for n, (v, _) in table.items()}
    schema = [(n, types[t]) for n, (_, t) in table.items()]
    return session.create_dataframe(data, schema)


@pytest.fixture(scope="module")
def jax_side():
    """Every case's rows through the JAX package, plus the decimal-key
    RANGE case."""
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        m = _ns("spark_rapids_tpu")
        out = {}
        for name, (table, settings, build) in CASES.items():
            session = JSession(JConf({"srt.shuffle.partitions": 1,
                                      **settings}))
            out[name] = build(m, _jax_frame(session, jdt,
                                            TABLES[table])).collect()
        session = JSession(JConf({"srt.shuffle.partitions": 1}))
        df = session.create_dataframe(
            {"o": [decimal.Decimal("1.00"), decimal.Decimal("2.50"),
                   decimal.Decimal("6.00"), decimal.Decimal("7.25")],
             "v": [1, 10, 100, 1000]},
            [("o", jdt.DecimalType(10, 2)), ("v", jdt.INT64)])
        out["decimal_key"] = _decimal_key_query(m, df).collect()
        for name, (table, build) in CPU_ENGINE_CASES.items():
            session = JSession(JConf({"srt.shuffle.partitions": 1}))
            out[name] = build(m, _jax_frame(session, jdt,
                                            TABLES[table])).collect()
        yield out


#: window cases the planner sends to the CPU engine: name -> (table,
#: query builder)
CPU_ENGINE_CASES = {
    "string_min": ("strings", lambda m, df: df.select(
        "k", "s", m.Min(m.col("s")).over(
            m.Window.partition_by("k").order_by("s")).alias("ms"))),
    "sliding_unbounded_max": ("base", lambda m, df: df.select(
        "k", "o", "v", m.Max(m.col("v")).over(
            m.Window.partition_by("k").order_by("o", "v").with_frame(
                _frame(m, None, 2))).alias("w"))),
}


def _decimal_key_query(m, df):
    # RANGE 2 PRECEDING..CURRENT ROW over the key's logical values
    spec = m.WindowSpec(order_fields=[m.col("o")],
                        frame=_frame(m, -2, 0, rows=False))
    return df.select(m.col("v"), m.Sum(m.col("v")).over(spec).alias("s"))


PORT = _ns("spark_rapids_tpu_torch")
TYPES = {"int": dt.INT32, "bigint": dt.INT64, "double": dt.FLOAT64,
         "string": dt.STRING}


def _port_df(table, settings=None):
    session = TpuSession(SrtConf(settings or {}), device="cpu")
    return session, session.create_dataframe(
        {n: v for n, (v, _) in table.items()},
        [(n, TYPES[t]) for n, (_, t) in table.items()])


def _exec_nodes(node):
    yield node
    for c in node.children:
        yield from _exec_nodes(c)


def _run_case(name):
    table, settings, build = CASES[name]
    session, df = _port_df(TABLES[table], settings)
    q = build(PORT, df)
    return session, q, q.collect()


@pytest.mark.parametrize("name", list(CASES))
def test_window_matches_jax(name, jax_side):
    _, q, rows = _run_case(name)
    ref = jax_side[name]
    assert rows and list(rows[0]) == list(ref[0])
    diff = compare_rows(rows, ref, [], None, RTOL)
    assert diff is None, f"{name}: {diff}"


def test_multiple_specs_make_a_window_chain():
    """Different (partition, order) specs split into chained Window
    nodes, each its own exec."""
    session, q, _ = _run_case("multiple_specs_chain")

    def count(p):
        return isinstance(p, L.Window) + sum(count(c) for c in p.children)
    assert count(q.plan) == 2
    tree = apply_overrides(q.plan, session.conf)
    kinds = [type(n).__name__ for n in _exec_nodes(tree)]
    assert kinds.count("BatchedRunningWindowExec") == 2


def test_windows_on_the_device_path_have_no_fallback():
    """The planner gives windows to the window execs (the default
    RANGE running frame of a SUM keeps the whole-partition exec); the
    query ran on the session's device."""
    session, q, _ = _run_case("windows_run_on_the_device_path")
    physical, ctx = session._last_execution
    kinds = [type(n).__name__ for n in _exec_nodes(physical)]
    assert kinds == ["ProjectExec", "WindowExec", "BatchScanExec"], kinds
    assert ctx.device == torch.device("cpu")


def _on_the_cpu_engine(name, jax_side):
    table, build = CPU_ENGINE_CASES[name]
    _, df = _port_df(TABLES[table])
    q = build(PORT, df)
    marks = q.explain("NOT_ON_TPU").splitlines()
    assert any(line.lstrip().startswith("! Window") for line in marks)
    rows = q.collect()
    diff = compare_rows(rows, jax_side[name], [], None, RTOL)
    assert diff is None, f"{name}: {diff}"


def test_window_over_strings_raises(jax_side):
    """String min/max over a window runs on the CPU engine, as in the
    JAX package (the name is kept from when the port refused it)."""
    _on_the_cpu_engine("string_min", jax_side)


@pytest.mark.parametrize("build, what", [
    (lambda m: m.Max(m.col("v")).over(
        m.Window.partition_by("k").order_by("o").with_frame(
            _frame(m, None, 2))), "min/max sliding frames"),
    (lambda m: m.Sum(m.col("v")).over(
        m.Window.partition_by("k").order_by("o", "v").with_frame(
            _frame(m, -2, 2, rows=False))), "RANGE frame needs one"),
])
def test_unported_window_shapes_raise(build, what, jax_side):
    """A min/max sliding frame with an unbounded side runs on the CPU
    engine, against the JAX package (the name is kept from when the
    port refused it). A RANGE frame with value offsets over two order
    keys still raises: Spark refuses such a query, and the JAX engine
    would read its first key alone."""
    _, df = _port_df(TABLES["base"])
    if what == "min/max sliding frames":
        _on_the_cpu_engine("sliding_unbounded_max", jax_side)
        return
    with pytest.raises(NotImplementedError, match=what):
        df.select("k", build(PORT).alias("w")).collect()


def test_window_column_replaces_existing_values():
    _, _, rows = _run_case("window_column_replaces_existing")
    assert sorted((r["k"], r["x"]) for r in rows) == \
        [(1, 30), (1, 30), (2, 30)]


def test_range_running_peers_share_the_run_total():
    _, _, rows = _run_case("range_running_frame_peers")
    assert {r["v"]: r["rs"] for r in rows} == \
        {1: 3, 2: 3, 3: 15, 4: 15, 5: 15, 6: 21}
    _, _, rows = _run_case("default_frame_is_range_running")
    assert {r["v"]: r["rs"] for r in rows} == {1: 3, 2: 3, 3: 10, 4: 10}


def test_range_frame_inf_poisons_only_its_frames():
    _, _, rows = _run_case("range_frame_inf_isolation")
    got = {r["o"]: r["s"] for r in rows}
    assert got[30] == 3.0 and got[50] == 5.0 and got[10] == float("inf")


def test_range_frame_key_values_as_double_match_jax_decimal(jax_side):
    """Both packages order by DECIMAL(10,2): the RANGE offsets are taken
    to the key's fixed point."""
    session = TpuSession(SrtConf(), device="cpu")
    df = session.create_dataframe(
        {"o": [decimal.Decimal("1.00"), decimal.Decimal("2.50"),
               decimal.Decimal("6.00"), decimal.Decimal("7.25")],
         "v": [1, 10, 100, 1000]},
        [("o", dt.DecimalType(10, 2)), ("v", dt.INT64)])
    rows = _decimal_key_query(PORT, df).collect()
    assert {r["v"]: r["s"] for r in rows} == {1: 1, 10: 11, 100: 100,
                                             1000: 1100}
    assert compare_rows(rows, jax_side["decimal_key"], [], None, RTOL) \
        is None


def test_single_partition_spanning_all_batches_is_exact():
    _, _, rows = _run_case("single_partition_spanning_all_batches")
    rows = sorted(rows, key=lambda r: r["o"])
    assert [r["rn"] for r in rows] == list(range(1, 1001))
    assert [r["rk"] for r in rows] == list(range(1, 1001))
    want = np.cumsum([float(i % 13) for i in range(1000)])
    assert [r["s"] for r in rows] == pytest.approx(want.tolist(), rel=RTOL)


def test_batched_exec_carries_state_across_batches():
    """The planner picks BatchedRunningWindowExec over a SortExec that
    emits batchSizeRows slices; the exec gets at least 3 batches and
    equals WindowExec on the same data."""
    table, settings, build = CASES["batched_matches_whole_partition"]
    session, q, rows = _run_case("batched_matches_whole_partition")
    physical, ctx = session._last_execution
    node = next(n for n in _exec_nodes(physical)
                if isinstance(n, XW.BatchedRunningWindowExec))
    assert type(node.children[0]).__name__ == "SortExec"
    assert ctx.metrics[node.exec_id]["numOutputBatches"].value >= 3
    off, df = _port_df(TABLES[table], {
        "srt.sql.window.batchedRunning.enabled": False})
    q_off = build(PORT, df)
    tree = apply_overrides(q_off.plan, off.conf).tree_string()
    assert "BatchedRunningWindow" not in tree and "Window[" in tree
    assert compare_rows(rows, q_off.collect(), [], None, RTOL) is None


def test_planner_keeps_range_frames_on_the_whole_partition_exec():
    session, df = _port_df(TABLES["batched_small"])
    tree = apply_overrides(_batched_select(PORT, df).plan,
                           session.conf).tree_string()
    assert "BatchedRunningWindow" in tree and "Sort" in tree, tree
    w = PORT.Window.partition_by("k").order_by("o").with_frame(
        _running(PORT, rows=False))
    q = df.select("k", PORT.Sum(PORT.col("v")).over(w).alias("s"))
    tree = apply_overrides(q.plan, session.conf).tree_string()
    assert "BatchedRunningWindow" not in tree, tree


@pytest.mark.parametrize("batched", [True, False])
def test_float_running_sum_after_a_1e12_partition(batched):
    """A partition of small values sorted right after one whose total is
    about 1e12: a prefix difference over the whole column would lose
    about 1e-4 of each small running sum; the segmented scan keeps each
    within 1e-9 of math.fsum."""
    rng = np.random.default_rng(7)
    big = [float(x) for x in rng.uniform(0.9e11, 1.1e11, 10)]
    small = [float(x) for x in rng.uniform(0.001, 1.0, 300)]
    table = {"k": ([0] * 10 + [1] * 300, "bigint"),
             "o": (list(range(310)), "bigint"),
             "v": (big + small, "double")}
    _, df = _port_df(table, {
        "srt.sql.batchSizeRows": 64,
        "srt.sql.window.batchedRunning.enabled": batched})
    w = PORT.Window.partition_by("k").order_by("o").with_frame(
        _running(PORT))
    rows = df.select("k", "o", PORT.Sum(PORT.col("v")).over(w).alias("s"),
                     PORT.Sum(PORT.col("v")).over(
                         PORT.Window.partition_by("k")).alias("t")).collect()
    got = {r["o"]: (r["s"], r["t"]) for r in rows}
    for i in range(310):
        seg = big if i < 10 else small
        start = 0 if i < 10 else 10
        want = math.fsum(seg[:i - start + 1])
        assert got[i][0] == pytest.approx(want, rel=RTOL, abs=0), i
        assert got[i][1] == pytest.approx(math.fsum(seg), rel=RTOL, abs=0)


def _py_min(vals):
    """Spark's MIN: nulls skipped, NaN above every number."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    nums = [v for v in vals if v == v]
    return min(nums) if nums else float("nan")


@pytest.mark.parametrize("frame", ["whole", "running", "rows", "range",
                                   "batched"])
def test_c6_window_min_puts_nan_above_numbers(frame):
    """MIN over a frame holding NaN takes the least number: the whole
    partition (NaN, 5.0, 3.0) gives 3.0 (the JAX package gives NaN), and
    so do the running scan, a ROWS frame, a RANGE frame (the sparse
    table) and the batched running exec's carry across batches; only a
    frame of NaN and nulls alone gives NaN. Plain Python reference."""
    rng = np.random.default_rng(5)
    n = 240
    k = [0, 0, 0] + [int(x) for x in rng.integers(1, 4, n - 3)]
    v = [float("nan"), 5.0, 3.0] + [
        None if r < 0.15 else float("nan") if r < 0.4 else float(x)
        for r, x in zip(rng.random(n - 3), rng.integers(-9, 9, n - 3))]
    table = {"k": (k, "bigint"), "o": (list(range(n)), "bigint"),
             "v": (v, "double")}
    _, df = _port_df(table, {"srt.sql.batchSizeRows": 32})
    spec = {"whole": (None, None, True), "running": (None, 0, True),
            "batched": (None, 0, True), "rows": (-2, 1, True),
            "range": (-5, 0, False)}[frame]
    w = PORT.Window.partition_by("k")
    if frame != "whole":
        w = w.order_by("o").with_frame(_frame(PORT, spec[0], spec[1],
                                              rows=spec[2]))
    q = df.select("k", "o", PORT.Min(PORT.col("v")).over(w).alias("mn"))
    tree = apply_overrides(q.plan, q.session.conf).tree_string()
    assert ("BatchedRunningWindow" in tree) == (frame in ("running",
                                                          "batched"))
    got = {r["o"]: r["mn"] for r in q.collect()}
    for i in range(n):
        part = [j for j in range(n) if k[j] == k[i]]
        lo, hi = spec[0], spec[1]
        if frame == "whole":
            frame_rows = part
        elif frame == "range":
            frame_rows = [j for j in part if i + lo <= j <= i]
        else:
            pos = part.index(i)
            frame_rows = part[max(0, pos + lo) if lo is not None else 0:
                              pos + hi + 1]
        want = _py_min([v[j] for j in frame_rows])
        assert repr(got[i]) == repr(want), (frame, i)
    if frame == "whole":
        assert got[0] == 3.0
    else:  # some frame holds only NaN and nulls
        assert any(isinstance(x, float) and x != x for x in got.values())


def test_lag_string_default_longer_than_both_buffers():
    """Lag over short strings with a default longer than the column's
    and the default's own buffers: every byte arrives (plain Python
    reference; the JAX string select cuts such results, C4)."""
    vals = ["a", "bc", None, "d", "ef", "g"]
    default = "a default string that outgrows every buffer" * 4
    _, df = _port_df({"k": ([1, 1, 1, 2, 2, 2], "bigint"),
                      "o": ([1, 2, 3, 1, 2, 3], "bigint"),
                      "s": (vals, "string")})
    w = PORT.Window.partition_by("k").order_by("o")
    rows = df.select("k", "o", PORT.Lag(PORT.col("s"), 1, default)
                     .over(w).alias("prev")).collect()
    got = {(r["k"], r["o"]): r["prev"] for r in rows}
    want = {(1, 1): default, (1, 2): "a", (1, 3): "bc",
            (2, 1): default, (2, 2): "d", (2, 3): "ef"}
    assert got == want


# --- the segmented primitives against plain Python ----------------------------

def _segments(n, seed):
    rng = np.random.default_rng(seed)
    new = rng.random(n) < 0.2
    new[0] = True
    return torch.from_numpy(new)


def _py_seg_scan(op, vals, new):
    out, acc = [], None
    for v, f in zip(vals, new):
        acc = v if f else op(acc, v)
        out.append(acc)
    return out


@pytest.mark.parametrize("op, dtype", [
    (torch.add, torch.int64), (torch.add, torch.float64),
    (torch.minimum, torch.float64), (torch.maximum, torch.int32)])
@pytest.mark.parametrize("n", [1, 5, 257])
def test_seg_scan_matches_python(op, dtype, n):
    new = _segments(n, n)
    rng = np.random.default_rng(n + 1)
    vals = torch.from_numpy(rng.integers(-50, 50, n)).to(dtype)
    got = XW._seg_scan(op, vals, new).tolist()
    py = {torch.add: lambda a, b: a + b, torch.minimum: min,
          torch.maximum: max}[op]
    assert got == pytest.approx(_py_seg_scan(py, vals.tolist(),
                                             new.tolist()))


def test_seg_bounds_and_rmq_match_python():
    rng = np.random.default_rng(3)
    n = 120
    new = _segments(n, 4)
    start, end = XW._seg_bounds(new)
    flags = new.tolist()
    assert start.tolist() == [max(j for j in range(i + 1) if flags[j])
                              for i in range(n)]
    assert end.tolist() == [min([j - 1 for j in range(i + 1, n) if flags[j]]
                                + [n - 1]) for i in range(n)]
    keys = torch.empty(n, dtype=torch.float64)
    vals = torch.from_numpy(rng.integers(-9, 9, n)).to(torch.int64)
    for s, e in zip(start.unique().tolist(), (end.unique()).tolist()):
        keys[s:e + 1] = torch.from_numpy(np.sort(rng.integers(0, 20, e - s
                                                              + 1))).double()
    query = keys + torch.from_numpy(rng.integers(-3, 4, n)).double()
    lo = XW._seg_lower_bound(keys, start, end, query)
    hi = XW._seg_upper_bound(keys, start, end, query)
    mn = XW._rmq(vals, lo, hi, torch.minimum, int(2 ** 63 - 1))
    for i in range(n):
        s, e = int(start[i]), int(end[i])
        seg = keys[s:e + 1].tolist()
        want_lo = s + bisect.bisect_left(seg, float(query[i]))
        want_hi = s + bisect.bisect_right(seg, float(query[i])) - 1
        assert int(lo[i]) == want_lo and int(hi[i]) == want_hi, i
        if want_lo <= want_hi:
            assert int(mn[i]) == min(vals[want_lo:want_hi + 1].tolist())


def test_adjacent_equal_is_null_safe_and_nan_equal():
    f = column_from_numpy(np.array([1.0, 1.0, np.nan, np.nan, 0.0, 0.0]), 8,
                          dt.FLOAT64, np.array([1, 1, 1, 1, 0, 0], bool),
                          device="cpu")
    assert K._adjacent_equal(f).tolist() == [False, True, False, True,
                                             False, True, True, True]
    s = column_from_numpy(np.array(["ab", "ab", "abc", None, None, ""],
                                   dtype=object), 6, dt.STRING,
                          np.array([1, 1, 1, 0, 0, 1], bool), device="cpu")
    assert K._adjacent_equal(s).tolist() == [False, True, False, False,
                                             True, False]
