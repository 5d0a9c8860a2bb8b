"""The port's two kernels (ops/device_kernels.py) held against the JAX
package's Pallas kernels on the CPU: here each wrapper runs its plain
PyTorch version (the CUDA kernels run in chip_smoke.py), and the JAX
kernels run in Pallas interpret mode with float64 lanes.

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

import ast
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
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
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
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
    batch = host_table.table_to_batch(table, capacity=32768,
                                      device="cpu")
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
                                      capacity=8192, device="cpu")
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
                                      capacity=32768, device="cpu")
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


def _smoke_exprs(E, P, S, Agg):
    """The programs chip_smoke.py times, as (table, predicate,
    aggregates) in either package: q6, a min/max/NaN program and the two
    string-filtered aggregates' programs."""
    c, lit = E.col, E.lit
    li, od = "lineitem", "orders"
    return {
        "q6": (li, (c("l_shipdate") >= lit(8766))
               & (c("l_shipdate") < lit(9131))
               & (c("l_discount") >= lit(0.05))
               & (c("l_discount") <= lit(0.07))
               & (c("l_quantity") < lit(24.0)),
               [(Agg.Sum(c("l_extendedprice") * c("l_discount")),
                 "revenue")]),
        "minmax_nan": (li, (c("l_tax") > lit(0.02))
                       | (c("l_quantity") < lit(10.0)),
                       [(Agg.Min(c("l_quantity")), "mn"),
                        (Agg.Max(c("l_quantity")), "mx"),
                        (Agg.Min(c("l_shipdate")), "first_ship"),
                        (Agg.Count(c("l_tax") / (c("l_discount")
                                                 - lit(0.05))), "n")]),
        "strings_lineitem": (li, P.InSet(c("l_returnflag"), ["A", "R"])
                             & (c("l_linestatus") == lit("F"))
                             & (c("l_shipdate") >= lit(8766)),
                             [(Agg.Sum(c("l_extendedprice")
                                       * c("l_discount")), "revenue"),
                              (Agg.CountStar(), "n")]),
        "strings_orders": (od, (S.StartsWith(c("o_orderpriority"), "1-")
                                | (c("o_orderpriority") == lit("2-HIGH")))
                           & P.IsNotNull(c("o_orderpriority"))
                           & (c("o_orderdate") < lit(9204)),
                           [(Agg.Sum(c("o_totalprice")), "total"),
                            (Agg.CountStar(), "n")]),
    }


def _smoke_programs():
    """{name: (schema, predicate, aggregates)} of _smoke_exprs."""
    d = pallas_agg.dt
    schemas = {
        "lineitem": [("l_quantity", d.FLOAT64), ("l_extendedprice", d.FLOAT64),
                     ("l_discount", d.FLOAT64), ("l_tax", d.FLOAT64),
                     ("l_shipdate", d.DATE), ("l_returnflag", d.STRING),
                     ("l_linestatus", d.STRING)],
        "orders": [("o_totalprice", d.FLOAT64), ("o_orderdate", d.DATE),
                   ("o_orderpriority", d.STRING)]}
    return {name: (schemas[table], pred, aggs)
            for name, (table, pred, aggs) in _smoke_exprs(E, P, S,
                                                          Agg).items()}


@pytest.mark.parametrize("name", ["q6", "minmax_nan", "strings_lineitem",
                                  "strings_orders"])
def test_generated_source_has_partial_and_combine_kernels(name):
    """The generated module compiles as Python (no triton import
    needed), defines the persistent partial kernel and the combine
    kernel, and the combine reduces each slot by its kind."""
    import re
    schema, pred, aggs = _smoke_programs()[name]
    plan = pallas_agg.PallasAggPlan(aggs, schema, pred)
    assert pallas_agg.pred_safe(pred, schema)
    src, _ = plan.program.triton_source()
    compile(src, f"tile_reduce_{name}", "exec")
    fns = {f.name: f for f in ast.parse(src).body
           if isinstance(f, ast.FunctionDef)}
    assert set(fns) == {"tile_reduce_kernel", "tile_reduce_combine"}
    assert [a.arg for a in fns["tile_reduce_combine"].args.args] == \
        ["partial", "out", "nprog", "P"]
    body = ast.get_source_segment(src, fns["tile_reduce_kernel"])
    assert "for blk in range(pid, tl.cdiv(n, BLOCK), nprog):" in body
    assert len(re.findall(r"tl\.store\(partial \+ pid \* ", body)) == \
        len(plan.kinds)
    combine = ast.get_source_segment(src, fns["tile_reduce_combine"])
    kinds = re.findall(r"tl\.store\(out \+ (\d+), tl\.(sum|min|max)\(x\1,",
                       combine)
    assert [int(j) for j, _ in kinds] == list(range(len(plan.kinds)))
    assert [k for _, k in kinds] == list(plan.kinds)
    if name.startswith("strings"):
        assert plan.str_names
    if name == "minmax_nan":
        assert {DK.MIN, DK.MAX} <= set(plan.kinds)


# --- B1/B2 generated kernels run under a numpy stand-in for Triton ----------

class _V:
    """A block (or scalar) value of the numpy stand-in for
    ``triton.language``: numpy arithmetic with Triton's ``.to``."""
    __slots__ = ("a",)
    __hash__ = None

    def __init__(self, a):
        self.a = np.asarray(a)

    def to(self, dtype):
        return _V(self.a.astype(dtype))


def _np(x):
    return x.a if isinstance(x, _V) else x


for _name, _f in {"add": np.add, "sub": np.subtract, "mul": np.multiply,
                  "truediv": np.true_divide, "and": np.bitwise_and,
                  "or": np.bitwise_or}.items():
    setattr(_V, f"__{_name}__", lambda s, o, f=_f: _V(f(s.a, _np(o))))
    setattr(_V, f"__r{_name}__", lambda s, o, f=_f: _V(f(_np(o), s.a)))
for _name, _f in {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
                  "le": np.less_equal, "gt": np.greater,
                  "ge": np.greater_equal}.items():
    setattr(_V, f"__{_name}__", lambda s, o, f=_f: _V(f(s.a, _np(o))))
_V.__neg__ = lambda s: _V(-s.a)
_V.__invert__ = lambda s: _V(~s.a)


class _Ptr:
    """A pointer (a flat array and element offsets) of the stand-in;
    every access it makes, masked-off lanes aside, must lie inside the
    array, as on the card."""
    __slots__ = ("arr", "idx")

    def __init__(self, arr, idx=0):
        self.arr, self.idx = arr, idx

    def __add__(self, o):
        return _Ptr(self.arr, self.idx + _np(o))

    def at(self, mask=None):
        idx = np.asarray(self.idx)
        keep = np.ones(idx.shape, bool) if mask is None else \
            np.broadcast_to(_np(mask), idx.shape)
        safe = np.where(keep, idx, 0)
        assert ((safe >= 0) & (safe < max(self.arr.size, 1)) | ~keep).all(), \
            "access outside the array"
        return keep, safe


class _Kernel:
    """``triton.jit`` of the stand-in: ``kernel[grid](...)`` runs the
    function once per program, in program order; tensors become
    pointers into their (shared) numpy memory."""
    state = [0, 1]

    def __init__(self, fn):
        self.fn = fn

    def __getitem__(self, grid):
        def launch(*args, num_warps=None, enable_fp_fusion=None, **consts):
            ptrs = [_Ptr(a.numpy()) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in range(grid[0]):
                _Kernel.state[:] = [pid, grid[0]]
                self.fn(*ptrs, **consts)
        return launch


def _tl_load(ptr, mask=None, other=0):
    keep, safe = ptr.at(mask)
    got = ptr.arr[safe] if ptr.arr.size else np.zeros(safe.shape,
                                                       ptr.arr.dtype)
    return _V(np.where(keep, got, np.asarray(other).astype(ptr.arr.dtype)))


def _tl_store(ptr, value):
    _, safe = ptr.at()
    ptr.arr[safe] = _np(value)


def _triton_stand_in():
    tl = types.ModuleType("triton.language")
    tl.constexpr = object
    for name, d in {"int1": np.bool_, "int8": np.int8, "int16": np.int16,
                    "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
                    "float32": np.float32, "float64": np.float64}.items():
        setattr(tl, name, d)
    tl.program_id = lambda axis: _Kernel.state[0]
    tl.num_programs = lambda axis: _Kernel.state[1]
    tl.cdiv = lambda a, b: -(-a // b)
    tl.arange = lambda lo, hi: _V(np.arange(lo, hi, dtype=np.int32))
    tl.zeros = lambda shape, d: _V(np.zeros(shape, d))
    tl.full = lambda shape, v, d: _V(np.full(shape, v, d))
    tl.where = lambda c, x, y: _V(np.where(_np(c), _np(x), _np(y)))
    # min.f64 / max.f64 on the card return the operand that is not NaN
    tl.minimum = lambda x, y: _V(np.fmin(_np(x), _np(y)))
    tl.maximum = lambda x, y: _V(np.fmax(_np(x), _np(y)))
    tl.abs = lambda x: _V(np.abs(_np(x)))
    tl.floor = lambda x: _V(np.floor(_np(x)))
    tl.sum = lambda x, axis: _V(np.sum(x.a, axis=axis))
    tl.min = lambda x, axis: _V(np.fmin.reduce(x.a, axis=axis))
    tl.max = lambda x, axis: _V(np.fmax.reduce(x.a, axis=axis))
    tl.load, tl.store = _tl_load, _tl_store
    triton = types.ModuleType("triton")
    triton.jit, triton.language, triton.cdiv = _Kernel, tl, tl.cdiv
    return triton, tl


def _run_generated(plan, batch, nprog, most, monkeypatch):
    """One tile_reduce call of ``plan`` on ``batch`` through the
    wrapper's own launch code, with the generated module executed under
    the stand-in and a grid of ``nprog`` programs out of ``most``."""
    triton, tl = _triton_stand_in()
    monkeypatch.setitem(sys.modules, "triton", triton)
    monkeypatch.setitem(sys.modules, "triton.language", tl)
    src, _ = plan.program.triton_source()
    # range over a block yields tensor scalars, which have ``.to``
    mod = {"__name__": "tile_reduce_stand_in",
           "range": lambda *a: (_V(np.int32(i)) for i in range(*a))}
    exec(compile(src, "tile_reduce_stand_in", "exec"), mod)
    args = [t.view(torch.uint8) if t.dtype == torch.bool else t
            for t in plan.kernel_inputs(batch)]
    ns = len(plan.kinds)
    partial = torch.full((nprog * ns,), float("nan"), dtype=torch.float64)
    out = torch.full((ns,), float("nan"), dtype=torch.float64)
    with np.errstate(all="ignore"):
        DK._launch_tile_reduce(mod["tile_reduce_kernel"],
                               mod["tile_reduce_combine"], args,
                               plan.program.literals(torch.device("cpu")),
                               partial, out, args[-1].shape[0], nprog, most)
    return out.numpy()


def _smoke_lanes(table, n=5000, seed=21):
    """Rows of the smoke programs' columns with nulls, NaN and the
    literals' near misses."""
    rng = np.random.default_rng(seed)
    valid = lambda p: rng.random(n) > p  # noqa: E731
    pick = lambda words: np.array(words, dtype=object)[  # noqa: E731
        rng.integers(0, len(words), n)]
    if table == "orders":
        return {
            "o_totalprice": (rng.uniform(1e3, 5e5, n), valid(0.05), "double"),
            "o_orderdate": (rng.integers(8700, 9500, n), valid(0.05),
                            "date"),
            "o_orderpriority": (pick(["1-URGENT", "2-HIGH", "3-MEDIUM",
                                      "4-NOT SPECIFIED", "5-LOW", "1-",
                                      "1", "2-HIG", "2-HIGHER", ""]),
                                valid(0.1), "string")}
    qty = rng.uniform(1, 50, n)
    qty[rng.integers(0, n, n // 40)] = np.nan
    return {
        "l_quantity": (qty, valid(0.05), "double"),
        "l_extendedprice": (rng.uniform(900, 1e5, n), valid(0.05), "double"),
        "l_discount": (rng.choice([0.0, 0.04, 0.05, 0.06, 0.07, 0.1], n),
                       valid(0.05), "double"),
        "l_tax": (rng.choice([0.0, 0.02, 0.03, 0.08], n), valid(0.05),
                  "double"),
        "l_shipdate": (rng.integers(8600, 9300, n), valid(0.05), "date"),
        "l_returnflag": (pick(["A", "R", "N", "AR", ""]), valid(0.05),
                         "string"),
        "l_linestatus": (pick(["F", "O", "FF"]), valid(0.05), "string")}


@pytest.mark.parametrize("name", ["q6", "minmax_nan", "strings_lineitem",
                                  "strings_orders"])
def test_generated_kernels_match_jax_under_numpy_triton(name, monkeypatch):
    """The generated partial and combine kernels, executed under a numpy
    stand-in for ``triton.language`` through the wrapper's launch code,
    equal the JAX kernel in interpret mode and the plain version on the
    same batch, for a grid that fills P and one that does not."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    table, pred, aggs = _smoke_exprs(E, P, S, Agg)[name]
    _, jpred, jaggs = _smoke_exprs(jE, jP, jS, jAgg)[name]
    lanes = _smoke_lanes(table)
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8192, device="cpu")
    jt = {"string": jdt.STRING, "double": jdt.FLOAT64, "date": jdt.DATE}
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), 8192)
    plan = pallas_agg.PallasAggPlan(aggs, batch.schema(), pred)
    jplan = jpallas_agg.PallasAggPlan(jaggs, jbatch.schema(), jpred)
    assert plan.kinds == jplan.kinds == plan.program.slot_kinds()
    calls = []
    orig = PK.tile_reduce
    monkeypatch.setattr(PK, "tile_reduce",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ref = np.array([float(r) for r in jplan.batch_fn()(jbatch)])
    assert calls == [1]  # the JAX Pallas kernel ran
    plain = plan.batch_fn()(batch).numpy()
    exact = np.array([k != DK.SUM for k in plan.kinds])
    for nprog, most in ((5, 8), (4, 4), (1, 1)):
        got = _run_generated(plan, batch, nprog, most, monkeypatch)
        np.testing.assert_allclose(got, ref, rtol=RTOL)
        np.testing.assert_allclose(got, plain, rtol=RTOL)
        np.testing.assert_array_equal(got[exact], ref[exact])
    assert ref[1] > 0  # the predicate keeps some rows


def test_tile_reduce_rejects_kinds_that_differ_from_the_program():
    """The kernel reduces each slot by the kind written into its source,
    so a caller's kinds must be the program's."""
    schema, pred, aggs = _smoke_programs()["minmax_nan"]
    plan = pallas_agg.PallasAggPlan(aggs, schema, pred)
    batch = host_table.table_to_batch(carry.host_table_from_lanes(
        _smoke_lanes("lineitem", n=100)), capacity=128, device="cpu")
    wrong = [DK.SUM] * len(plan.kinds)
    with pytest.raises(ValueError, match="differ from the program"):
        DK.tile_reduce(plan.kernel_inputs(batch), plan.program, wrong)
    DK.tile_reduce(plan.kernel_inputs(batch), plan.program, plan.kinds)


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


@pytest.mark.parametrize("n,buckets,groups,tile", [
    (500, 64, 20, 32),     # dead rows on the scratch id 20
    (2000, 1024, 600, 256),
    (64, 16, 16, 16),      # every bucket live: the scratch id clamps in
])
def test_tile_group_reduce_group_count_matches_jax(n, buckets, groups, tile):
    """The group count is a hint: rows at or above it carry zeros (dead
    rows on the scratch id ``groups``, and ids above it), and the result
    with it equals the result without it and the JAX kernel's."""
    rng = np.random.default_rng(groups)
    gid = rng.integers(0, groups, n).astype(np.int32)
    dead = rng.random(n) < 0.2
    gid[dead] = min(groups, buckets - 1)
    above = ~dead & (rng.random(n) < 0.05) & (groups < buckets)
    gid[above] = rng.integers(groups, buckets, int(above.sum()))
    zero = dead | above
    vals = [np.where(zero, 0.0, rng.uniform(0, 1e5, n)),
            np.where(zero, 0.0, (rng.random(n) > 0.3).astype(np.float64))]
    tg = torch.from_numpy(gid)
    tv = [torch.from_numpy(v) for v in vals]
    got = DK.tile_group_reduce(tg, tv, buckets, num_groups=groups)
    plain = DK.tile_group_reduce_plain(tg, tv, buckets)
    ref = PK.tile_group_reduce(jnp.asarray(gid),
                               [jnp.asarray(v) for v in vals],
                               num_buckets=buckets, tile_rows=tile,
                               interpret=True)
    for g, p, r in zip(got, plain, ref):
        assert g.shape == (buckets,) and torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-12)
        assert not g[groups:].any()


@pytest.mark.parametrize("bad", ["buckets", "gid_dtype", "lanes", "length",
                                 "groups_above_buckets", "groups_zero"])
def test_tile_group_reduce_checks_inputs(bad):
    gid = torch.zeros(8, dtype=torch.int32)
    vals = [torch.ones(8, dtype=torch.float64)]
    kw = {"num_buckets": 16}
    if bad == "buckets":
        kw["num_buckets"] = 12
    elif bad == "groups_above_buckets":
        kw["num_groups"] = 17
    elif bad == "groups_zero":
        kw["num_groups"] = 0
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
                                     capacity=4096, device="cpu")


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


@pytest.mark.parametrize("phase", ["update", "merge"])
def test_hash_and_sort_grouping_give_the_same_float_bits(phase,
                                                         monkeypatch):
    """The hash-claim path hands the aggregates its rows in group order,
    as the sort path does, so both add each group's floats in the same
    association: Sum, Average and VarianceSamp agree bit for bit, on
    the update pass and on the merge of its states."""
    batch = _grouped_batch(3000, 200, seed=5)
    keys = [batch.column("k"), batch.column("i")]
    v = batch.column("v")
    fns = [Agg.Sum(E.col("v")), Agg.Average(E.col("v")),
           Agg.VarianceSamp(E.col("v"))]
    kb, st = K.group_aggregate(batch, keys, [v, v, v], fns)
    # the states twice over, as two partials of one merge
    both = K.concat_batches([kb, kb], 2 * kb.capacity)
    n = kb.num_rows
    twice = [{k: torch.nn.functional.pad(torch.cat([s[k][:n]] * 2),
                                         (0, both.capacity - 2 * n))
              for k in s} for s in st]
    runs = []
    for fast in (True, False):
        monkeypatch.setattr(K, "_use_hash_grouping",
                            lambda *a, fast=fast: fast)
        stats = {}
        if phase == "update":
            out = K.group_aggregate(batch, keys, [v, v, v], fns, stats)
        else:
            out = K.group_merge(both, both.columns, twice, fns, stats)[:2]
        assert stats == ({"claimResolved": 1} if fast else {})
        runs.append(_by_key(*out))
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k], equal_nan=True), k


def test_group_lane_rejects_non_sum_aggregates():
    batch = _grouped_batch(200, 5)
    v = batch.column("v")
    assert not K.pallas_group_fns_ok([v], [Agg.Min(E.col("v"))])
    assert K.pallas_group_fns_ok([v, None], [Agg.Sum(E.col("v")),
                                             Agg.CountStar()])


# --- B1's casts, abs, unary plus, least and greatest --------------------------

def _node_lanes(n=3000, seed=33):
    """Columns of every type the fused lane takes, with NULLs, NaN, the
    infinities, values past the narrow types' ranges and their
    minimums."""
    rng = np.random.default_rng(seed)
    valid = lambda p: rng.random(n) > p  # noqa: E731
    f = rng.uniform(-60, 60, n)
    f[rng.integers(0, n, n // 30)] = np.nan
    f[rng.integers(0, n, n // 60)] = np.inf
    f[rng.integers(0, n, n // 60)] = -np.inf
    f[rng.integers(0, n, n // 60)] = 3e10
    i32 = rng.integers(-2 ** 31, 2 ** 31 - 1, n)
    i32[:n // 3] = rng.integers(-300, 300, n // 3)
    i16 = rng.integers(-2 ** 15, 2 ** 15 - 1, n)
    i16[rng.integers(0, n, 10)] = -2 ** 15
    return {
        "f64": (f, valid(0.1), "double"),
        "tax": (rng.choice([0.0, 0.02, 0.03, 0.08], n), valid(0.05),
                "double"),
        "f32": (rng.uniform(-5, 5, n).astype(np.float32), valid(0.1),
                "float"),
        "i32": (i32.astype(np.int32), valid(0.1), "int"),
        "i16": (i16.astype(np.int16), valid(0.1), "smallint"),
        "i8": (rng.integers(-128, 127, n).astype(np.int8), valid(0.1),
               "tinyint"),
        "d": (rng.integers(8600, 9300, n).astype(np.int32), valid(0.1),
              "date"),
        "b": (rng.random(n) > 0.5, valid(0.1), "boolean"),
    }


def _node_programs(E, P, A, Agg, Cast, d):
    """(predicate, aggregates) per node family, in either package."""
    c, lit = E.col, E.lit
    return {
        "cast": ((Cast(c("i32"), d.FLOAT64) < lit(10.5))
                 | (Cast(c("f64"), d.INT32) > lit(24))
                 | (Cast(c("d"), d.INT32) < lit(8700))
                 | (Cast(c("b"), d.INT32) == lit(1)),
                 [(Agg.Sum(Cast(c("i16"), d.FLOAT64)), "s16"),
                  (Agg.Sum(Cast(c("b"), d.FLOAT64)), "sb"),
                  (Agg.Min(Cast(c("f64"), d.FLOAT32)), "mn32"),
                  (Agg.Max(Cast(c("i32"), d.INT16)), "narrow"),
                  (Agg.Count(Cast(c("f32"), d.BOOL)), "nb"),
                  (Agg.Sum(Cast(c("f32"), d.FLOAT64)), "s32")]),
        "abs_plus": ((A.Abs(c("f64") - lit(0.06)) <= lit(30.0))
                     & (A.UnaryPositive(c("i32")) > lit(-2 ** 30)),
                     [(Agg.Sum(A.Abs(c("f64"))), "sabs"),
                      (Agg.Max(A.Abs(c("i16"))), "mabs"),
                      (Agg.Min(A.Abs(c("f32"))), "mabs32"),
                      (Agg.Sum(A.UnaryPositive(c("tax"))), "spos")]),
        "least_greatest": ((A.Greatest(c("tax"), lit(0.02)) < lit(0.08))
                           | (A.Least(c("f64"), c("f32")) > lit(1.0)),
                           [(Agg.Sum(A.Least(c("f64"), c("tax"))), "sl"),
                            (Agg.Max(A.Greatest(c("f64"), c("f32"),
                                                lit(-1.0))), "mg"),
                            (Agg.Min(A.Greatest(c("i16"), c("i8"))), "mi"),
                            (Agg.Min(A.Least(c("d"), Cast(lit(9000), d.DATE))),
                             "md"),
                            (Agg.Count(A.Least(c("i32"), c("i16"))), "n")]),
    }


def _node_batches(lanes):
    from spark_rapids_tpu.columnar import dtypes as jdt
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=4096, device="cpu")
    jt = {"double": jdt.FLOAT64, "float": jdt.FLOAT32, "int": jdt.INT32,
          "smallint": jdt.INT16, "tinyint": jdt.INT8, "date": jdt.DATE,
          "boolean": jdt.BOOL}
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), 4096)
    return batch, jbatch


@pytest.fixture(scope="module")
def node_cases():
    """Each node family's plan, plain result and JAX kernel result on
    one batch (the JAX kernel in interpret mode, compiled once per
    family here)."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.expr.cast import Cast as JCast
    from spark_rapids_tpu_torch.columnar import dtypes as d
    from spark_rapids_tpu_torch.expr.cast import Cast
    lanes = _node_lanes()
    batch, jbatch = _node_batches(lanes)
    progs = _node_programs(E, P, A, Agg, Cast, d)
    jprogs = _node_programs(jE, jP, jA, jAgg, JCast, jdt)
    out = {}
    for name, (pred, aggs) in progs.items():
        jpred, jaggs = jprogs[name]
        plan = pallas_agg.PallasAggPlan(aggs, batch.schema(), pred)
        jplan = jpallas_agg.PallasAggPlan(jaggs, jbatch.schema(), jpred)
        ref = np.array([float(r) for r in jplan.batch_fn()(jbatch)])
        out[name] = (plan, batch, ref)
    return out


@pytest.mark.parametrize("name", ["cast", "abs_plus", "least_greatest"])
def test_new_nodes_generated_source_parses(name):
    from spark_rapids_tpu_torch.columnar import dtypes as d
    from spark_rapids_tpu_torch.expr.cast import Cast
    pred, aggs = _node_programs(E, P, A, Agg, Cast, d)[name]
    schema = [(k, d.from_name(t)) for k, (_, _, t) in _node_lanes(8).items()]
    assert pallas_agg.pred_safe(pred, schema)
    agg_exec = types.SimpleNamespace(group_exprs=[], agg_exprs=aggs,
                                     input_schema=schema)
    assert pallas_agg.pallas_eligible(agg_exec)
    plan = pallas_agg.PallasAggPlan(aggs, schema, pred)
    src, _ = plan.program.triton_source()
    compile(src, f"tile_reduce_{name}", "exec")
    assert "tile_reduce_kernel" in {f.name for f in ast.parse(src).body
                                    if isinstance(f, ast.FunctionDef)}


@pytest.mark.parametrize("name", ["cast", "abs_plus", "least_greatest"])
def test_new_nodes_generated_kernel_equals_plain_and_jax(name, node_cases,
                                                         monkeypatch):
    """The generated kernel under the numpy stand-in equals the plain row
    function (the expressions' torch eval) on every slot, NULL and NaN
    lanes included, and both equal the JAX kernel."""
    plan, batch, ref = node_cases[name]
    plain = plan.batch_fn()(batch).numpy()
    got = _run_generated(plan, batch, 4, 4, monkeypatch)
    exact = np.array([k != DK.SUM for k in plan.kinds])
    np.testing.assert_allclose(got, plain, rtol=RTOL)
    np.testing.assert_array_equal(got[exact], plain[exact])
    np.testing.assert_allclose(plain, ref, rtol=RTOL)
    np.testing.assert_array_equal(plain[exact], ref[exact])
    assert plain[1] > 0  # the predicate keeps some rows


@pytest.mark.parametrize("pred_src", [
    "Cast(c('f64'), d.INT32) < lit(24)",
    "Cast(c('i32'), d.INT64) < lit(24)",
    "A.Abs(c('f64') - lit(0.06)) <= lit(0.011)",
    "A.Greatest(c('tax'), lit(0.02)) < lit(0.08)",
    "A.Least(c('i8'), c('i16')) > lit(0)",
    "A.UnaryPositive(c('d')) > lit(8800)",
    "Cast(c('f64'), d.STRING) == lit('1.0')",
    "A.Abs(c('k')) > lit(3)",
    "A.Greatest(c('k'), c('i32')) > lit(3)",
])
def test_b1_gate_agrees_with_jax(pred_src):
    """The port's fused-lane gates (pred_safe, pallas_eligible) take a
    filter or aggregate input with these nodes exactly where the JAX
    package's do."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.expr.cast import Cast as JCast
    from spark_rapids_tpu_torch.columnar import dtypes as d
    from spark_rapids_tpu_torch.expr.cast import Cast

    def build(E, A, Agg, Cast, d):
        c, lit = E.col, E.lit
        pred = eval(pred_src, {"Cast": Cast, "c": c, "lit": lit, "A": A,
                               "d": d})
        types_ = {"double": d.FLOAT64, "float": d.FLOAT32, "int": d.INT32,
                  "smallint": d.INT16, "tinyint": d.INT8, "date": d.DATE,
                  "boolean": d.BOOL}
        schema = [(k, types_[t]) for k, (_, _, t)
                  in _node_lanes(8).items()] + [("k", d.INT64)]
        agg_exec = types.SimpleNamespace(
            group_exprs=[], input_schema=schema,
            agg_exprs=[(Agg.Sum(Cast(pred, d.FLOAT64)), "s")])
        return pred, schema, agg_exec
    pred, schema, ex = build(E, A, Agg, Cast, d)
    jpred, jschema, jex = build(jE, jA, jAgg, JCast, jdt)
    assert pallas_agg.pred_safe(pred, schema) == \
        jpallas_agg.pred_safe(jpred, jschema)
    assert pallas_agg.pallas_eligible(ex) == jpallas_agg.pallas_eligible(jex)


@pytest.mark.parametrize("where,absorbed", [
    # S7's conjuncts: the lane takes all five filters
    ("d >= DATE '1994-01-01' AND d < DATE '1995-01-01' "
     "AND CAST(f64 AS INT) < 24 AND abs(f64 - 0.06) <= 30.0 "
     "AND greatest(tax, 0.02) < 0.08", 5),
    # a conjunct the lane cannot lower (the top one) keeps it stock
    ("CAST(f64 AS INT) < 24 AND CAST(i32 AS STRING) LIKE '1%'", 0),
    # one below the top ends the chain there
    ("CAST(i32 AS STRING) LIKE '1%' AND abs(f64) < 30.0 "
     "AND greatest(tax, 0.02) < 0.08", 2),
])
def test_global_aggregate_takes_the_filter_chain(where, absorbed):
    """A WHERE plans as one FilterExec per conjunct; the fused lane takes
    the chain below the global aggregate down to the first filter it
    cannot lower, as one conjunction, and the rest run as FilterExecs.
    The result equals the stock path's (the lane off)."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.plan.session import TpuSession
    lanes = _node_lanes()
    text = (f"SELECT SUM(f64 * tax) AS s, COUNT(*) AS n FROM t "
            f"WHERE {where}")
    out = {}
    for on in (True, False):
        session = TpuSession(SrtConf({"srt.sql.pallas.enabled": on}),
                             device="cpu")
        session.create_or_replace_temp_view("t", session.from_batches(
            [_node_batches(lanes)[0]]))
        DK.reset_counts()
        out[on] = session.sql(text).collect()
        physical, ctx = session._last_execution

        def execs(node):
            yield node
            for ch in node.children:
                yield from execs(ch)
        plans = [p for x in execs(physical)
                 if isinstance(x, HashAggregateExec)
                 for p in x._pallas_plans.values()]
        ran = [e for e in ctx.metrics if e.startswith("FilterExec#")]
        if on:
            assert DK.tile_reduce.plain_calls == 1 and len(plans) == 1
            assert (plans[0].pred is None) == (absorbed == 0)
            assert len(ran) == where.count(" AND ") + 1 - absorbed
        else:
            assert DK.tile_reduce.plain_calls == 0 and not plans
    assert out[True][0]["n"] == out[False][0]["n"] > 0
    np.testing.assert_allclose(out[True][0]["s"], out[False][0]["s"],
                               rtol=RTOL)
