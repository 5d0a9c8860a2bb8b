"""TPC-H q6 and q1 through both packages' TpuSession on the same
20,000-row lineitem in 4096-row batches, on the CPU.

The JAX side runs its grouped Pallas lane (SRT_PALLAS_GROUPED_FORCE=1)
and a counting wrapper shows both JAX kernels ran; on the port side the
kernels' plain versions run, and their counters show it. The JAX
reference runs once for the module. Every JAX cache read is made a miss
here (tests/conftest.py wraps jax's ``_cache_read`` with four arguments;
this jax passes five), and the JAX package is imported under that patch.
"""

import numpy as np
import pytest

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan.session import TpuSession

ROWS, BATCH = 20_000, 4096
RTOL = 1e-9  # both sides float64; only the summation order differs
SETTINGS = {"srt.sql.batchSizeRows": BATCH}


@pytest.fixture(scope="module")
def lineitem_lanes():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
        from spark_rapids_tpu.datagen import generate_chunk, lineitem_spec
        table = generate_chunk(lineitem_spec(ROWS), 0, ROWS)
        yield {n: (c.values, c.mask, repr(c.dtype))
               for n, c in zip(table.names, table.columns)}


@pytest.fixture(scope="module")
def jax_results(lineitem_lanes):
    """q6 and q1 through the JAX package, counting its kernel calls."""
    import jax
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
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
