"""The port's two kernels (ops/device_kernels.py) held against the JAX
package's Pallas kernels on the CPU: here each wrapper runs its plain
PyTorch version (the CUDA kernels run in chip_smoke.py), and the JAX
kernels run in Pallas interpret mode with float64 lanes.

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

import ast

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.exec import pallas_agg
from spark_rapids_tpu_torch.expr import aggregates as Agg
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.plan import host_table

RTOL = 1e-9  # both sides float64; only the summation order differs


@pytest.fixture(scope="module", autouse=True)
def _jax_cache_miss():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
        global PK, jpallas_agg, jAgg, jA, jE, jP, jhost, jS
        import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
        from spark_rapids_tpu.exec import pallas_agg as jpallas_agg
        from spark_rapids_tpu.expr import aggregates as jAgg
        from spark_rapids_tpu.expr import arithmetic as jA
        from spark_rapids_tpu.expr import core as jE
        from spark_rapids_tpu.expr import predicates as jP
        from spark_rapids_tpu.ops import pallas_kernels as PK
        from spark_rapids_tpu.expr import strings as jS
        from spark_rapids_tpu.plan import host_table as jhost
        yield


# --- B1 tile_reduce: plain version vs the JAX kernel -------------------------

def _b1_inputs(n, seed, all_masked_tiles=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 50, n)
    x[rng.integers(0, n, max(n // 50, 1))] = np.nan
    x[rng.integers(0, n, max(n // 70, 1))] = np.inf
    x[rng.integers(0, n, max(n // 90, 1))] = -np.inf
    y = rng.integers(-1000, 1000, n).astype(np.int32)
    m = (rng.random(n) > 0.4).astype(np.uint8)
    if all_masked_tiles:
        m[: 2 * 8192] = 0  # the first two JAX tiles carry no live row
    return x, y, m


def _row_fn(xp, x, y, m):
    """The same row function in either framework (xp = jnp or torch)."""
    mask = m != 0
    num = mask & ~xp.isnan(x)
    imax = np.iinfo(np.int32).max
    return [xp.where(num & xp.isfinite(x), x, 0.0),
            mask.astype(xp.float32) if xp is jnp else mask.to(torch.float32),
            xp.where(num, x, np.inf),
            xp.where(mask, y, imax if xp is jnp else torch.tensor(
                imax, dtype=torch.int32)),
            xp.where(mask, x, -np.inf)]


@pytest.mark.parametrize("n,seed,masked", [
    (20_000, 0, False),   # > 2 JAX tiles with a ragged tail
    (3, 1, False),        # one short tile
    (8192 * 3, 2, True),  # whole tiles without a live row
])
def test_tile_reduce_plain_matches_jax(n, seed, masked):
    x, y, m = _b1_inputs(n, seed, masked)
    kinds = [DK.SUM, DK.SUM, DK.MIN, DK.MIN, DK.MAX]
    got = DK.tile_reduce([torch.from_numpy(a) for a in (x, y, m)],
                         lambda b: _row_fn(torch, *b), kinds).numpy()
    ref = PK.tile_reduce([jnp.asarray(a) for a in (x, y, m)],
                         lambda b: _row_fn(jnp, *b),
                         [PK.SUM, PK.SUM, PK.MIN, PK.MIN, PK.MAX],
                         interpret=True)
    np.testing.assert_allclose(got, np.array([float(r) for r in ref]),
                               rtol=RTOL)


def test_tile_reduce_cpu_counts_plain_calls():
    DK.reset_counts()
    x = torch.tensor([1.0, 2.0, 3.0])
    m = torch.tensor([1, 0, 1], dtype=torch.uint8)
    (s,) = DK.tile_reduce([x, m], lambda b: [torch.where(b[1] != 0, b[0],
                                                         0.0)], [DK.SUM])
    assert float(s) == 4.0
    assert DK.tile_reduce.plain_calls == 1 and DK.tile_reduce.launches == 0


# --- B1 generated expressions: plain path vs JAX PallasAggPlan.batch_fn ------

def _cases(E, A, P, Agg):
    c = E.col
    lit = E.lit
    return {
        "q6": (((c("d") >= lit(0.05)) & (c("d") <= lit(0.07))
                & (c("q") < lit(24.0)) & (c("k") >= lit(5))),
               [(Agg.Sum(c("p") * c("d")), "revenue")]),
        "kleene_or_not": ((c("q") > lit(30.0)) | ~(c("d") < lit(0.04)),
                          [(Agg.Count(c("q")), "n"),
                           (Agg.Sum(c("q") - c("p")), "s")]),
        "divide_by_zero": (None,
                           [(Agg.Sum(c("p") / c("d")), "s"),
                            (Agg.Count(c("q") / (c("d") - lit(0.05))), "c"),
                            (Agg.Average(-c("q")), "a")]),
        "nulls_and_nan": (A.Add(c("q"), lit(1.0)).is_not_null()
                          & P.IsNaN(c("p")).__invert__(),
                          [(Agg.Min(c("q")), "mn"), (Agg.Max(c("q")), "mx"),
                           (Agg.CountStar(), "n")]),
        "nullsafe": (P.EqualNullSafe(c("d"), lit(0.05))
                     | P.EqualNullSafe(c("k"), lit(3)),
                           [(Agg.Min(c("k")), "kmin"),
                            (Agg.Max(c("p")), "pmax"),
                            (Agg.Sum(c("q") * lit(2.0)), "s")]),
        "isnull": (P.IsNull(c("d")) | P.EqualTo(c("k"), lit(2)),
                   [(Agg.Sum(c("p")), "s"), (Agg.Count(c("d")), "n")]),
    }


def _expr_lanes(n=30_000, seed=9):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-100, 100, n)
    p[rng.integers(0, n, 40)] = np.nan
    q = rng.uniform(0, 50, n)
    q[rng.integers(0, n, 20)] = np.nan
    d = rng.choice([0.0, 0.02, 0.05, 0.06, 0.07, 0.1], n)
    k = rng.integers(0, 10, n).astype(np.int16)
    null = lambda: rng.random(n) > 0.15  # noqa: E731
    return {"p": (p, null(), "double"), "q": (q, null(), "double"),
            "d": (d, null(), "double"), "k": (k, null(), "smallint")}


@pytest.mark.parametrize("case", ["q6", "kleene_or_not", "divide_by_zero",
                                  "nulls_and_nan", "nullsafe",
                                  "isnull"])
def test_generated_expressions_match_jax(case):
    from spark_rapids_tpu.columnar import dtypes as jdt
    lanes = _expr_lanes()
    table = carry.host_table_from_lanes(lanes)
    batch = host_table.table_to_batch(table, capacity=32768)
    jt = {"double": jdt.FLOAT64, "smallint": jdt.INT16}
    jtable = jhost.HostTable([jhost.HostColumn(v, m, jt[t])
                              for v, m, t in lanes.values()], list(lanes))
    jbatch = jhost.table_to_batch(jtable, 32768)

    pred, aggs = _cases(E, A, P, Agg)[case]
    jpred, jaggs = _cases(jE, jA, jP, jAgg)[case]
    plan = pallas_agg.PallasAggPlan(aggs, batch.schema(), pred)
    jplan = jpallas_agg.PallasAggPlan(jaggs, jbatch.schema(), jpred)
    assert plan.kinds == jplan.kinds
    assert pallas_agg.pallas_eligible(type("X", (), {
        "group_exprs": [], "agg_exprs": aggs,
        "input_schema": batch.schema()}))
    if pred is not None:
        assert pallas_agg.pred_safe(pred, batch.schema())
    got = plan.batch_fn()(batch).numpy()
    ref = np.array([float(r) for r in jplan.batch_fn()(jbatch)])
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    # the same tree lowers to a syntactically valid Triton module
    src, lits = plan.program.triton_source()
    ast.parse(src)
    assert "def tile_reduce_kernel(" in src and "tl.store" in src


def test_inset_matches_jax_eval():
    """A numeric IN cannot run inside the JAX Pallas kernel (it captures
    its value array), so the JAX side is held through expression eval
    and the port's fused path against its own stock path."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    lanes = _expr_lanes(5000)
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8192)
    jt = {"double": jdt.FLOAT64, "smallint": jdt.INT16}
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), 8192)
    pred = P.InSet(E.col("k"), [1, 3, 7, None])
    jv = jP.InSet(jE.col("k"), [1, 3, 7, None]).eval(jbatch)
    v = pred.eval(batch)
    np.testing.assert_array_equal(v.data.numpy(), np.asarray(jv.data))
    np.testing.assert_array_equal(v.validity.numpy(),
                                  np.asarray(jv.validity))
    aggs = [(Agg.Sum(E.col("p")), "s"), (Agg.CountStar(), "n")]
    plan = pallas_agg.PallasAggPlan(aggs, batch.schema(), pred)
    got = plan.batch_fn()(batch).numpy()
    kept = K.filter_batch(batch, v)
    _, st = K.group_aggregate(kept, [], [kept.column("p"), None],
                              [fn for fn, _ in aggs])
    ref = [float(st[0]["sum"][0]), float(st[0]["count"][0]),
           float(st[1]["count"][0])]
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    ast.parse(plan.program.triton_source()[0])


def test_generator_rejects_unported_nodes():
    class Mystery(E.Expression):
        def data_type(self, schema):
            from spark_rapids_tpu_torch.columnar import dtypes as dt
            return dt.FLOAT64
    program = DK.RowProgram(["x"], [pallas_agg.dt.FLOAT64], None,
                            [("sum", Mystery(E.col("x")))])
    with pytest.raises(NotImplementedError):
        program.triton_source()
    assert not pallas_agg._expr_safe(Mystery(E.col("x")),
                                     [("x", pallas_agg.dt.FLOAT64)])


# --- B2 the string lane of tile_reduce vs the JAX padded-byte lane ----------

STR_RTOL = 1e-12  # as tests/test_pallas.py holds the JAX string lane


def _string_cases(E, P, S):
    c, lit = E.col, E.lit
    return {
        "eq": c("s") == lit("alpha"),
        "eq_reversed": lit("héllo") == c("s"),
        "in": P.InSet(c("s"), ["beta", "gamma", "nope", ""]),
        "startswith": S.StartsWith(c("s"), "al"),
        "is_null": P.IsNull(c("s")) | (c("v") > lit(90.0)),
        "is_not_null": P.IsNotNull(c("s")) & (c("v") > lit(50.0)),
        "longer_than_every_value": (c("s") == lit("alphabet soup" * 4))
        | S.StartsWith(c("t"), "x" * 70),
        "two_columns": ~(c("t") == lit("F")) & P.InSet(c("s"), ["al", "beta"]),
    }


def _string_lanes(n=20_000, seed=11):
    rng = np.random.default_rng(seed)
    cats = np.array(["alpha", "beta", "gamma", "al", "", "héllo",
                     "alphabet"], dtype=object)
    flags = np.array(["F", "O", "FF"], dtype=object)
    return {"s": (cats[rng.integers(0, len(cats), n)], rng.random(n) > 0.1,
                  "string"),
            "t": (flags[rng.integers(0, 3, n)], rng.random(n) > 0.05,
                  "string"),
            "v": (rng.uniform(0, 100, n), rng.random(n) > 0.05, "double")}


@pytest.mark.parametrize("case", ["eq", "eq_reversed", "in", "startswith",
                                  "is_null", "is_not_null",
                                  "longer_than_every_value", "two_columns"])
def test_string_lane_matches_jax(case, monkeypatch):
    from spark_rapids_tpu.columnar import dtypes as jdt
    lanes = _string_lanes()
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=32768)
    jt = {"string": jdt.STRING, "double": jdt.FLOAT64}
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), 32768)
    pred = _string_cases(E, P, S)[case]
    jpred = _string_cases(jE, jP, jS)[case]
    aggs = [(Agg.Sum(E.col("v")), "s"), (Agg.CountStar(), "n")]
    jaggs = [(jAgg.Sum(jE.col("v")), "s"), (jAgg.CountStar(), "n")]
    assert pallas_agg.pred_safe(pred, batch.schema())
    assert jpallas_agg.pred_safe(jpred, jbatch.schema())
    plan = pallas_agg.PallasAggPlan(aggs, batch.schema(), pred)
    jplan = jpallas_agg.PallasAggPlan(jaggs, jbatch.schema(), jpred)
    assert plan.str_names == jplan.str_names and plan.str_names
    assert plan.kinds == jplan.kinds
    calls = []
    orig = PK.tile_reduce
    monkeypatch.setattr(PK, "tile_reduce",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ref = np.array([float(r) for r in jplan.batch_fn()(jbatch)])
    assert calls == [1]  # the JAX string lane ran inside its kernel
    DK.reset_counts()
    got = plan.batch_fn()(batch).numpy()
    assert (DK.tile_reduce.plain_calls, DK.tile_reduce.str_plain_calls) \
        == (1, 1)
    np.testing.assert_array_equal(got[1:], ref[1:])  # counts: exact
    np.testing.assert_allclose(got[0], ref[0], rtol=STR_RTOL)
    # and the stock path (FilterExec, then the aggregate) agrees
    kept = K.filter_batch(batch, pred.eval(batch))
    assert float(kept.num_rows) == got[2]
    src, _ = plan.program.triton_source()
    ast.parse(src)
    for name in plan.str_names:
        k = plan.str_names.index(name)
        assert f"so{k} = tl.load(" in src and f"sv{k} = tl.load(" in src


def test_string_literals_are_in_the_kernel_source():
    schema = [("s", pallas_agg.dt.STRING)]
    srcs = set()
    for word in ("alpha", "alphb"):
        plan = pallas_agg.PallasAggPlan([(Agg.CountStar(), "n")], schema,
                                        E.col("s") == E.lit(word))
        srcs.add(plan.program.triton_source()[0])
    assert len(srcs) == 2  # each literal set is its own kernel
    assert any("== 98)" in s for s in srcs)  # 'b' of "alphb"


def test_string_gate_refuses_what_the_jax_gate_refuses():
    schema = [("s", pallas_agg.dt.STRING), ("v", pallas_agg.dt.FLOAT64)]
    c, lit = E.col, E.lit
    for pred in (c("s") < lit("b"), P.EqualTo(c("s"), c("s")),
                 P.InSet(c("s"), ["a", None])):
        assert not pallas_agg.pred_safe(pred, schema)
    assert pallas_agg.pred_safe(P.InSet(c("s"), ["a"]) & (c("v") > lit(1.0)),
                                schema)


# --- B3 tile_group_reduce: plain version vs the JAX kernel -------------------

@pytest.mark.parametrize("n,buckets,tile", [(37, 16, 8), (300, 64, 32)])
def test_tile_group_reduce_plain_matches_jax(n, buckets, tile):
    rng = np.random.default_rng(n)
    gid = rng.integers(0, buckets - 1, n).astype(np.int32)
    gid[gid == 3] = 4  # bucket 3 stays empty
    vals = [rng.uniform(-10, 10, n), (rng.random(n) > 0.5).astype(np.float64),
            np.where(rng.random(n) > 0.3, rng.uniform(0, 1e6, n), 0.0)]
    got = DK.tile_group_reduce(torch.from_numpy(gid),
                               [torch.from_numpy(v) for v in vals], buckets)
    ref = PK.tile_group_reduce(jnp.asarray(gid),
                               [jnp.asarray(v) for v in vals],
                               num_buckets=buckets, tile_rows=tile,
                               interpret=True)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64 and g.shape == (buckets,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-12)
    assert all(float(g[3]) == 0.0 for g in got)


@pytest.mark.parametrize("bad", ["buckets", "gid_dtype", "lanes", "length"])
def test_tile_group_reduce_checks_inputs(bad):
    gid = torch.zeros(8, dtype=torch.int32)
    vals = [torch.ones(8, dtype=torch.float64)]
    kw = {"num_buckets": 16}
    if bad == "buckets":
        kw["num_buckets"] = 12
    elif bad == "gid_dtype":
        gid = gid.to(torch.int64)
    elif bad == "lanes":
        vals = []
    else:
        vals = [torch.ones(9, dtype=torch.float64)]
    with pytest.raises(ValueError):
        DK.tile_group_reduce(gid, vals, **kw)


# --- the grouped update lane around B3 ---------------------------------------

def _grouped_batch(n, groups, seed=2):
    rng = np.random.default_rng(seed)
    keys = np.array([f"g{i}" for i in rng.integers(0, groups, n)],
                    dtype=object)
    lanes = {"k": (keys, rng.random(n) > 0.05, "string"),
             "i": (rng.integers(0, 3, n).astype(np.int64),
                   np.ones(n, bool), "bigint"),
             "v": (rng.uniform(-5, 5, n), rng.random(n) > 0.1, "double")}
    return host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                     capacity=4096)


def _by_key(key_batch, states):
    g = key_batch.num_rows
    cols = [c.to_numpy(g) for c in key_batch.columns]
    cols = [(list(v.to_objects()) if hasattr(v, "to_objects") else list(v),
             m) for v, m in cols]
    return {tuple(v[r] if m[r] else None for v, m in cols):
            [float(st[name][r]) for st in states for name in sorted(st)]
            for r in range(g)}


@pytest.mark.parametrize("groups,expect_kernel", [(40, True), (1500, False)])
def test_group_aggregate_pallas_matches_stock(groups, expect_kernel):
    batch = _grouped_batch(3000, groups)
    keys = [batch.column("k"), batch.column("i")]
    v = batch.column("v")
    fns = [Agg.Sum(E.col("v")), Agg.Average(E.col("v")), Agg.Count(
        E.col("v")), Agg.CountStar()]
    DK.reset_counts()
    kb, st, used = K.group_aggregate_pallas(batch, keys, [v, v, v, None],
                                            fns)
    assert used is expect_kernel
    assert DK.tile_group_reduce.plain_calls == int(expect_kernel)
    kb2, st2 = K.group_aggregate(batch, keys, [v, v, v, None], fns)
    got, ref = _by_key(kb, st), _by_key(kb2, st2)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL)


def test_group_lane_rejects_non_sum_aggregates():
    batch = _grouped_batch(200, 5)
    v = batch.column("v")
    assert not K.pallas_group_fns_ok([v], [Agg.Min(E.col("v"))])
    assert K.pallas_group_fns_ok([v, None], [Agg.Sum(E.col("v")),
                                             Agg.CountStar()])
