"""TPC-H q6, q1 and q3 and two string-filtered global aggregates through
both packages' TpuSession on the same 20,000-row lineitem (with 5,000
orders and 500 customers for q3, generated by the JAX package and
carried across as numpy lanes) in 4096-row batches, on the CPU.

The JAX side runs its grouped Pallas lane (SRT_PALLAS_GROUPED_FORCE=1)
and a counting wrapper shows both JAX kernels ran; on the port side the
kernels' plain versions run, and their counters show it. The JAX
reference runs once for the module. Every JAX cache read is made a miss
here (tests/conftest.py wraps jax's ``_cache_read`` with four arguments;
this jax passes five), and the JAX package is imported under that patch.
"""

import numpy as np
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan.session import TpuSession

ROWS, BATCH = 20_000, 4096
RTOL = 1e-9  # both sides float64; only the summation order differs
SETTINGS = {"srt.sql.batchSizeRows": BATCH}


@pytest.fixture(scope="module")
def lineitem_lanes():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.datagen import generate_chunk, lineitem_spec
        table = generate_chunk(lineitem_spec(ROWS), 0, ROWS)
        yield {n: (c.values, c.mask, repr(c.dtype))
               for n, c in zip(table.names, table.columns)}


@pytest.fixture(scope="module")
def jax_results(lineitem_lanes):
    """q6 and q1 through the JAX package, counting its kernel calls."""
    import jax
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        mp.setenv("SRT_PALLAS_GROUPED_FORCE", "1")
        from spark_rapids_tpu import jit_registry
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf
        from spark_rapids_tpu.models import tpch as jtpch
        from spark_rapids_tpu.ops import pallas_kernels as PK
        from spark_rapids_tpu.plan.host_table import (HostColumn, HostTable,
                                                      to_pydict)
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        calls = {"tile_reduce": 0, "tile_group_reduce": 0}
        for name in calls:
            orig = getattr(PK, name)

            def counting(*a, _orig=orig, _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)
            mp.setattr(PK, name, counting)
        # traced programs from earlier tests would skip the wrappers
        jax.clear_caches()
        jit_registry.clear()
        types = {repr(t): t for t in (jdt.INT64, jdt.FLOAT64, jdt.STRING,
                                      jdt.DATE)}
        table = HostTable([HostColumn(v, m, types[t])
                           for v, m, t in lineitem_lanes.values()],
                          list(lineitem_lanes))
        from spark_rapids_tpu.plan.overrides import apply_overrides
        session = JSession(SrtConf(SETTINGS))
        df = session.create_dataframe(to_pydict(table), table.schema())
        trees = {q: apply_overrides(getattr(jtpch, q)(df).plan,
                                    session.conf).tree_string()
                 for q in ("q6", "q1")}
        yield {"q6": jtpch.q6(df).collect(), "q1": jtpch.q1(df).collect(),
               "calls": dict(calls), "trees": trees}


@pytest.fixture(scope="module")
def port_df(lineitem_lanes):
    session = TpuSession(carry.conf_from_dict(SETTINGS), device="cpu")
    return session.create_dataframe(
        carry.host_table_from_lanes(lineitem_lanes))


@pytest.fixture(scope="module")
def port_results(port_df):
    DK.reset_counts()
    out = {"q6": tpch.q6(port_df).collect()}
    out["q6_counts"] = (DK.tile_reduce.plain_calls,
                        DK.tile_group_reduce.plain_calls)
    DK.reset_counts()
    out["q1"] = tpch.q1(port_df).collect()
    out["q1_counts"] = (DK.tile_reduce.plain_calls,
                        DK.tile_group_reduce.plain_calls)
    return out


def _assert_rows_match(got, ref, keys):
    assert [tuple(r[k] for k in keys) for r in got] == \
        [tuple(r[k] for k in keys) for r in ref]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                np.testing.assert_allclose(g[k], r[k], rtol=RTOL)
            else:
                assert g[k] == r[k], k


def test_port_uses_device_batches(port_df):
    batches = port_df.plan.batches
    assert len(batches) == -(-ROWS // BATCH)
    assert all(b.device.type == "cpu" for b in batches)


def test_q6_matches_jax(port_results, jax_results):
    assert len(port_results["q6"]) == 1
    _assert_rows_match(port_results["q6"], jax_results["q6"], [])


def test_q1_matches_jax(port_results, jax_results):
    assert 4 <= len(port_results["q1"]) <= 6
    _assert_rows_match(port_results["q1"], jax_results["q1"],
                       ["l_returnflag", "l_linestatus"])
    assert port_results["q1"][0]["count_order"] > 0


def test_jax_reference_ran_both_pallas_kernels(jax_results):
    assert jax_results["calls"]["tile_reduce"] > 0
    assert jax_results["calls"]["tile_group_reduce"] > 0


def test_port_ran_both_plain_kernels(port_results):
    batches = -(-ROWS // BATCH)
    assert port_results["q6_counts"] == (batches, 0)
    assert port_results["q1_counts"] == (0, batches)


def _plan_lines(tree, leaves):
    """Operator lines of a physical tree without its exchanges (which
    pass batches through at one partition) and its leaves."""
    out = []
    for line in tree.splitlines():
        text = line.strip().removeprefix("* ")
        if not text.startswith(("ShuffleExchange",) + leaves):
            out.append(text)
    return out


@pytest.mark.parametrize("query", ["q6", "q1"])
def test_port_plan_matches_jax_plan(port_df, jax_results, query):
    mine = _plan_lines(getattr(tpch, query)(port_df).explain(),
                       ("BatchScan",))
    ref = _plan_lines(jax_results["trees"][query],
                      ("HostToDevice", "CpuLocalRelation"))
    assert mine == ref
    assert mine[-2].startswith("HashAggregate[partial")
    assert mine[-1].startswith("Filter[")


@pytest.mark.parametrize("query,key", [
    ("q6", "srt.sql.pallas.enabled"),
    ("q1", "srt.sql.pallas.groupedAgg.enabled")])
def test_stock_path_matches_kernel_lane(port_df, port_results, query, key):
    session = TpuSession(carry.conf_from_dict({**SETTINGS, key: False}),
                         device="cpu")
    df = session.from_batches(port_df.plan.batches)
    DK.reset_counts()
    rows = getattr(tpch, query)(df).collect()
    assert (DK.tile_reduce.plain_calls,
            DK.tile_group_reduce.plain_calls) == (0, 0)
    _assert_rows_match(rows, port_results[query],
                       ["l_returnflag", "l_linestatus"] if query == "q1"
                       else [])


def test_empty_input_gives_spark_global_row(port_df):
    session = TpuSession(carry.conf_from_dict(SETTINGS), device="cpu")
    df = session.from_batches(port_df.plan.batches).filter(
        tpch.col("l_quantity") < -1.0)
    assert tpch.q6(df).collect() == [{"revenue": None}]
    assert tpch.q1(df).collect() == []


def test_select_projects_expressions(port_df, lineitem_lanes):
    from spark_rapids_tpu_torch.expr.core import Alias, col
    rows = (port_df.filter(col("l_quantity") < 3.0)
            .select(Alias(col("l_quantity") * 2.0 - col("l_tax"), "x"),
                    "l_returnflag")
            .collect())
    qty, _, _ = lineitem_lanes["l_quantity"]
    tax, _, _ = lineitem_lanes["l_tax"]
    flag, _, _ = lineitem_lanes["l_returnflag"]
    keep = qty < 3.0
    assert [r["l_returnflag"] for r in rows] == list(flag[keep])
    np.testing.assert_array_equal([r["x"] for r in rows],
                                  qty[keep] * 2.0 - tax[keep])


# --- q3 and the string-filtered aggregates on lineitem, orders, customer ---

def _string_queries(E, P, S, Agg):
    """The two string-filtered global aggregates, built from either
    package's modules: each fuses its string predicates into the
    tile_reduce kernel's string lane."""
    import datetime
    c, lit = E.col, E.lit
    q6_days = ((c("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
               & (c("l_shipdate") < lit(datetime.date(1995, 1, 1))))

    def lineitem(df):
        return (df.filter(P.InSet(c("l_returnflag"), ["A", "R"])
                          & (c("l_linestatus") == "F") & q6_days)
                .agg(E.Alias(Agg.Sum(c("l_extendedprice")
                                     * c("l_discount")), "revenue"),
                     E.Alias(Agg.CountStar(), "n")))

    def orders(df):
        return (df.filter((S.StartsWith(c("o_orderpriority"), "1-")
                           | (c("o_orderpriority") == "2-HIGH"))
                          & P.IsNotNull(c("o_orderpriority"))
                          & (c("o_orderdate")
                             < lit(datetime.date(1995, 3, 15))))
                .agg(E.Alias(Agg.Sum(c("o_totalprice")), "total"),
                     E.Alias(Agg.CountStar(), "n")))
    return {"lineitem": lineitem, "orders": orders}


@pytest.fixture(scope="module")
def q3_lanes(lineitem_lanes):
    """orders and customer generated by the JAX package at the
    lineitem's scale (tpch_tables' ratios), as numpy lanes."""
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.datagen import generate_chunk, orders_spec
        from spark_rapids_tpu.models.tpch import customer_spec
        tables = {spec.name: generate_chunk(spec, 0, spec.num_rows)
                  for spec in (orders_spec(ROWS // 4),
                               customer_spec(ROWS // 40))}
        lanes = {name: carry.lanes_of(t) for name, t in tables.items()}
    lanes["lineitem"] = lineitem_lanes
    return lanes


@pytest.fixture(scope="module")
def jax_q3_results(q3_lanes):
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf
        from spark_rapids_tpu.expr import aggregates as jAgg
        from spark_rapids_tpu.expr import core as jE
        from spark_rapids_tpu.expr import predicates as jP
        from spark_rapids_tpu.expr import strings as jS
        from spark_rapids_tpu.models import tpch as jtpch
        from spark_rapids_tpu.ops import pallas_kernels as PK
        from spark_rapids_tpu.plan.host_table import (HostColumn, HostTable,
                                                      to_pydict)
        from spark_rapids_tpu.plan.overrides import apply_overrides
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        types = {repr(t): t for t in (jdt.INT32, jdt.INT64, jdt.FLOAT64,
                                      jdt.STRING, jdt.DATE)}
        session = JSession(SrtConf(SETTINGS))
        dfs = {}
        for name, lanes in q3_lanes.items():
            table = HostTable([HostColumn(v, m, types[t])
                               for v, m, t in lanes.values()], list(lanes))
            dfs[name] = session.create_dataframe(to_pydict(table),
                                                 table.schema())
        q3 = jtpch.q3(dfs["customer"], dfs["orders"], dfs["lineitem"])
        out = {"q3": q3.collect(),
               "tree": apply_overrides(q3.plan, session.conf).tree_string()}
        calls = []
        orig = PK.tile_reduce
        mp.setattr(PK, "tile_reduce",
                   lambda *a, **k: calls.append(1) or orig(*a, **k))
        for name, query in _string_queries(jE, jP, jS, jAgg).items():
            calls.clear()
            out[name] = query(dfs[name]).collect()
            out[name + "_calls"] = len(calls)
        yield out


@pytest.fixture(scope="module")
def port_q3_dfs(q3_lanes):
    session = TpuSession(carry.conf_from_dict(SETTINGS), device="cpu")
    tables = carry.host_tables_from(
        {name: carry.host_table_from_lanes(lanes)
         for name, lanes in q3_lanes.items()})
    return {name: session.create_dataframe(t) for name, t in tables.items()}


def test_q3_matches_jax(port_q3_dfs, jax_q3_results):
    dfs = port_q3_dfs
    rows = tpch.q3(dfs["customer"], dfs["orders"], dfs["lineitem"]).collect()
    ref = jax_q3_results["q3"]
    assert len(rows) == 10
    # the order of the top 10 and every key exact, revenue to RTOL
    _assert_rows_match(rows, ref, ["o_orderkey", "o_orderdate"])
    assert [r["revenue"] for r in rows] == sorted(
        (r["revenue"] for r in rows), reverse=True)


def test_q3_plan_matches_jax_plan(port_q3_dfs, jax_q3_results):
    """Same operators in the same places. The JAX planner also wraps the
    top join and the partial aggregate into a FusedHashJoin (not in the
    port yet) and places broadcast exchanges, which pass batches
    through at one partition."""
    dfs = port_q3_dfs
    mine = _plan_lines(tpch.q3(dfs["customer"], dfs["orders"],
                               dfs["lineitem"]).explain(), ("BatchScan",))
    ref = _plan_lines(jax_q3_results["tree"],
                      ("HostToDevice", "CpuLocalRelation",
                       "BroadcastExchange", "FusedHashJoin"))
    assert [m for m in mine if not m.startswith("HashAggregate[partial")] \
        == ref
    assert mine[0] == "TopN[10]"
    assert sum(m.startswith("BroadcastHashJoin[inner, build=right]")
               for m in mine) == 2


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_string_aggregates_match_jax(port_q3_dfs, jax_q3_results, table):
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr import predicates as P
    from spark_rapids_tpu_torch.expr import strings as S
    df = port_q3_dfs[table]
    DK.reset_counts()
    rows = _string_queries(E, P, S, Agg)[table](df).collect()
    batches = len(df.plan.batches)
    # one kernel call with string lanes per batch (the plain version on
    # the CPU), as the JAX package runs its string lane in its kernel
    assert (DK.tile_reduce.plain_calls, DK.tile_reduce.str_plain_calls) \
        == (batches, batches)
    assert jax_q3_results[table + "_calls"] > 0
    assert rows[0]["n"] > 0
    _assert_rows_match(rows, jax_q3_results[table], ["n"])


def test_tables_carry_from_jax(port_q3_dfs, q3_lanes):
    for name, lanes in q3_lanes.items():
        df = port_q3_dfs[name]
        assert df.columns == list(lanes)
        assert [repr(t) for _, t in df.schema] == \
            [t for _, _, t in lanes.values()]
        assert sum(b.num_rows for b in df.plan.batches) == \
            len(next(iter(lanes.values()))[0])
    prio = port_q3_dfs["orders"].select("o_orderpriority").collect()
    assert [r["o_orderpriority"] for r in prio] == \
        list(q3_lanes["orders"]["o_orderpriority"][0])
    assert len(prio) == ROWS // 4
