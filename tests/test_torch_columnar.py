"""The PyTorch port's columnar layer, data generator and batch kernels,
held against the JAX package on the same seeded inputs (CPU).

The JAX side compiles in this process, so every JAX cache read is made a
miss for the module: tests/conftest.py wraps jax's ``_cache_read`` with a
four-argument function, and this jax calls it with five. The JAX package
compiles while it is imported, so it is imported under that patch too.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch
import torch_jax_early
from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch import carry, datagen
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar import vector
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.plan import host_table
from spark_rapids_tpu_torch.plan.session import TpuSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_sides_early(request, tmp_path_factory):
    """Start the long suites' JAX subprocesses now (tests/torch_jax_early.py),
    while the port's files before them run on one core each."""
    torch_jax_early.start_for(request.session, tmp_path_factory)
    yield


@pytest.fixture(scope="module", autouse=True)
def _jax_cache_miss():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        global jdatagen, jvector, jK, jhost
        import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
        from spark_rapids_tpu import datagen as jdatagen
        from spark_rapids_tpu.columnar import vector as jvector
        from spark_rapids_tpu.ops import kernels as jK
        from spark_rapids_tpu.plan import host_table as jhost
        yield


def _same(a, b) -> bool:
    """Equality of host values where NaN equals NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


def _strings(rng, n):
    pool = ["", "a", "N", "ab", "zz", "héllo", "AIR REG", "x" * 20, "R"]
    vals = np.array([pool[i] for i in rng.integers(0, len(pool), n)],
                    dtype=object)
    mask = rng.random(n) > 0.2
    return vals, mask


# --- dtypes -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["boolean", "tinyint", "smallint", "int",
                                  "bigint", "float", "double", "date",
                                  "string"])
def test_dtype_matches_jax(name):
    from spark_rapids_tpu.columnar import dtypes as jdt
    t = dt.from_name(name)
    jt = {repr(x): x for x in (jdt.BOOL, jdt.INT8, jdt.INT16, jdt.INT32,
                               jdt.INT64, jdt.FLOAT32, jdt.FLOAT64,
                               jdt.DATE, jdt.STRING)}[name]
    assert repr(t) == repr(jt)
    if t != dt.STRING:
        assert t.np_physical == np.dtype(jt.physical)
        assert dt.min_value(t) == jdt.min_value(jt)
        assert dt.max_value(t) == jdt.max_value(jt)


def test_promote_matches_jax():
    from spark_rapids_tpu.columnar import dtypes as jdt
    order = ["tinyint", "smallint", "int", "bigint", "float", "double"]
    jt = {repr(x): x for x in jdt._PROMOTION_ORDER}
    for a in order:
        for b in order:
            assert repr(dt.promote(dt.from_name(a), dt.from_name(b))) == \
                repr(jdt.promote(jt[a], jt[b]))


# --- batches and host tables ------------------------------------------------

@pytest.mark.parametrize("name", ["double", "int", "bigint", "date",
                                  "string"])
def test_batch_host_round_trip(name):
    rng = np.random.default_rng(7)
    n = 37
    if name == "string":
        values, mask = _strings(rng, n)
    else:
        t = dt.from_name(name)
        values = rng.integers(-1000, 1000, n).astype(t.np_physical)
        mask = rng.random(n) > 0.3
    table = carry.host_table_from_lanes({"c": (values, mask, name)})
    batch = host_table.table_to_batch(table, capacity=64,
                                      device="cpu")
    assert batch.capacity == 64 and batch.num_rows == n
    back = host_table.to_pydict(host_table.batch_to_table(batch))["c"]
    jt = {repr(x): x for x in _jdtypes()}[name]
    jtable = jhost.HostTable([jhost.HostColumn(values, mask, jt)], ["c"])
    jback = jhost.to_pydict(jhost.batch_to_table(
        jhost.table_to_batch(jtable, 64)))["c"]
    assert _same(back, jback)


def _jdtypes():
    from spark_rapids_tpu.columnar import dtypes as jdt
    return (jdt.FLOAT64, jdt.INT32, jdt.INT64, jdt.DATE, jdt.STRING)


def test_string_column_layout_matches_jax():
    rng = np.random.default_rng(3)
    values, mask = _strings(rng, 50)
    sc = vector.column_from_numpy(values, 64, dt.STRING, mask,
                                  device="cpu")
    jsc = jvector.column_from_numpy(values, 64, None, mask)
    assert sc.pad_bucket == jsc.pad_bucket
    np.testing.assert_array_equal(sc.offsets.numpy(), np.asarray(jsc.offsets))
    np.testing.assert_array_equal(sc.lengths().numpy(),
                                  np.asarray(jsc.lengths()))
    np.testing.assert_array_equal(sc.padded().numpy(),
                                  np.asarray(jsc.padded()))
    np.testing.assert_array_equal(sc.validity.numpy(),
                                  np.asarray(jsc.validity))


def test_string_gather_matches_jax():
    rng = np.random.default_rng(4)
    values, mask = _strings(rng, 40)
    idx = rng.integers(0, 40, 64)
    valid = np.arange(64) < 50
    sc = vector.column_from_numpy(values, 64, dt.STRING, mask,
                                  device="cpu").gather(
        torch.from_numpy(idx), torch.from_numpy(valid))
    jsc = jvector.column_from_numpy(values, 64, None, mask).gather(
        jnp.asarray(idx, jnp.int32), jnp.asarray(valid))
    hs, m = sc.to_numpy(64)
    jv, jm = jsc.to_numpy(64)
    np.testing.assert_array_equal(m, jm)
    assert [v for v, k in zip(hs.to_objects(), m) if k] == \
        [v for v, k in zip(jv, jm) if k]


def test_host_strings_take_and_concat():
    rng = np.random.default_rng(5)
    values, _ = _strings(rng, 30)
    hs = vector.HostStrings.from_objects(values)
    idx = rng.integers(0, 30, 45)
    assert list(hs.take(idx).to_objects()) == list(values[idx])
    both = vector.HostStrings.concat([hs.take(idx[:10]), hs.take(idx[10:])])
    assert list(both.to_objects()) == list(values[idx])


# --- data generation ---------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 1, 4])
def test_datagen_matches_jax(chunk):
    rows, chunk_rows = 20_000, 4096
    mine = datagen.generate_chunk(datagen.lineitem_spec(rows), chunk,
                                  chunk_rows)
    ref = jdatagen.generate_chunk(jdatagen.lineitem_spec(rows), chunk,
                                  chunk_rows)
    assert mine.names == ref.names
    assert mine.num_rows == ref.num_rows
    for c, r in zip(mine.columns, ref.columns):
        assert repr(c.dtype) == repr(r.dtype)
        np.testing.assert_array_equal(c.mask, r.mask)
        if c.dtype == dt.STRING:
            assert list(c.values.to_objects()) == list(r.values)
        else:
            assert c.values.dtype == r.values.dtype
            np.testing.assert_array_equal(c.values, r.values)


def test_carry_from_jax_host_table():
    ref = jdatagen.generate_chunk(jdatagen.lineitem_spec(500), 0, 500)
    lanes = {n: (c.values, c.mask, repr(c.dtype))
             for n, c in zip(ref.names, ref.columns)}
    mine = carry.host_table_from_lanes(lanes)
    assert _same(host_table.to_pydict(mine), jhost.to_pydict(ref))
    conf = carry.conf_from_dict({"srt.sql.batchSizeRows": 4096,
                                 "srt.sql.pallas.enabled": "false"})
    assert conf.batch_size_rows == 4096
    from spark_rapids_tpu_torch.conf import PALLAS_ENABLED
    assert conf.get(PALLAS_ENABLED) is False
    with pytest.raises(KeyError):
        carry.conf_from_dict({"srt.sql.pallas.tileRows": 8192})


# --- batch kernels -----------------------------------------------------------

def _key_table(n=300, seed=11):
    rng = np.random.default_rng(seed)
    f = rng.choice([0.0, -0.0, 1.5, -2.0, np.nan, np.inf], n)
    i = rng.integers(-3, 3, n).astype(np.int64)
    s, smask = _strings(rng, n)
    lanes = {"f": (f, rng.random(n) > 0.1, "double"),
             "i": (i, rng.random(n) > 0.1, "bigint"),
             "s": (s, smask, "string"),
             "v": (rng.uniform(-5, 5, n), rng.random(n) > 0.1, "double")}
    return lanes


def _jax_batch(lanes, cap):
    from spark_rapids_tpu.columnar import dtypes as jdt
    jt = {repr(x): x for x in (jdt.FLOAT64, jdt.INT64, jdt.STRING)}
    cols = [jhost.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()]
    return jhost.table_to_batch(jhost.HostTable(cols, list(lanes)), cap)


@pytest.mark.parametrize("keys,asc,nf", [
    (["f"], [True], [True]),
    (["f"], [False], [False]),
    (["s", "i"], [True, False], [True, False]),
    (["i", "f", "s"], [False, True, True], [False, True, False]),
])
def test_sort_indices_matches_jax(keys, asc, nf):
    lanes = _key_table()
    n = len(lanes["f"][0])
    b = host_table.table_to_batch(carry.host_table_from_lanes(lanes), 512,
                                  device="cpu")
    jb = _jax_batch(lanes, 512)
    perm = K.sort_indices([b.column(k) for k in keys], asc, nf,
                          b.live_mask())
    jperm = jK.sort_indices([jb.column(k) for k in keys], asc, nf,
                            jb.live_mask())
    np.testing.assert_array_equal(perm.numpy()[:n], np.asarray(jperm)[:n])


def test_filter_batch_matches_jax():
    lanes = _key_table()
    b = host_table.table_to_batch(carry.host_table_from_lanes(lanes), 512,
                                  device="cpu")
    jb = _jax_batch(lanes, 512)
    from spark_rapids_tpu.expr import col as jcol
    from spark_rapids_tpu_torch.expr import col
    out = K.filter_batch(b, (col("v") > 0.5).eval(b))
    jout = jK.filter_batch(jb, (jcol("v") > 0.5).eval(jb))
    got = host_table.to_pydict(host_table.batch_to_table(out))
    ref = jhost.to_pydict(jhost.batch_to_table(jout))
    assert _same(got, ref)


def test_group_aggregate_matches_jax():
    from spark_rapids_tpu.expr import aggregates as jAgg
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    lanes = _key_table()
    b = host_table.table_to_batch(carry.host_table_from_lanes(lanes), 512,
                                  device="cpu")
    jb = _jax_batch(lanes, 512)
    keys = ["s", "i"]

    def run(mod, batch, kmod, count):
        fns = [mod.Sum(None), mod.Min(None), mod.Max(None), mod.Count(None),
               mod.CountStar()]
        vals = batch.column("v")
        kb, states = kmod.group_aggregate(
            batch, [batch.column(k) for k in keys],
            [vals, vals, vals, vals, None], fns)
        g = int(kb.num_rows)
        out = {}
        kv = [c.to_numpy(g) for c in kb.columns]
        kv = [(list(v.to_objects()) if hasattr(v, "to_objects") else list(v),
               m) for v, m in kv]
        for r in range(g):
            key = tuple(v[r] if m[r] else None for v, m in kv)
            out[key] = tuple(
                (count(st[name][r]))
                for st, fn in zip(states, fns) for name in st)
        return out

    got = run(Agg, b, K, lambda x: float(x))
    ref = run(jAgg, jb, jK, lambda x: float(x))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9)


# --- package rules -----------------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = os.path.dirname(spark_rapids_tpu_torch.__file__)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(pkg):
        if os.sep + "build" in root:
            continue
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    for p in paths:
        for name in _imports(p):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_rapids_tpu"), \
                f"{os.path.relpath(p, REPO)} imports {name}"


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TpuSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TpuSession()
    assert TpuSession(device="cpu").device.type == "cpu"


def test_host_to_device_helpers_need_a_device():
    """table_to_batch and column_from_numpy have no default device: a
    caller who leaves it out gets a TypeError, never CPU tensors."""
    table = carry.host_table_from_lanes(
        {"c": (np.arange(4), np.ones(4, bool), "bigint")})
    with pytest.raises(TypeError, match="device"):
        host_table.table_to_batch(table)
    with pytest.raises(TypeError, match="device"):
        vector.column_from_numpy(np.arange(4), 8)
    assert host_table.table_to_batch(table, device="cpu").device.type == \
        "cpu"
