"""The DataFrame-only expressions through both packages, on the CPU.

Bitwise and shifts, z-order interleaving, exact and approximate
percentiles, bloom filters and ``might_contain``, and the
execution-context expressions (monotonically_increasing_id,
spark_partition_id, uuid, raise_error, version): the cases of the JAX
package's tests/test_bitwise_misc.py, test_misc_exprs.py (not
``input_file_*``), test_bloom.py and test_approx_percentile.py's
single-process cases, each built once (``torch_both.Api``) and run
through the port's session and the JAX session, whose rows must agree.

Where the port follows Spark and the JAX package does not, the port is
held against plain Python and the JAX side is asserted: ``raise_error``
under a branch no row selects does not raise in the port, and raises in
the JAX package (ROADMAP C18).
"""

import math
import re

import numpy as np
import pytest
import torch

from torch_both import PORT, jax_api  # noqa: F401  (a fixture)


def _both(build, jax_api, **conf):
    """(port rows, JAX rows) of ``build(api, session)``."""
    return (build(PORT, PORT.session(**conf)).collect(),
            build(jax_api, jax_api.session(**conf)).collect())


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=1e-12) or \
            (math.isnan(a) and math.isnan(b))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(_close(g[k], w[k]) for k in g), (g, w)


# --- bitwise (test_bitwise_misc.py) ---------------------------------------

def _ints(n, seed, lo, hi, null_every=0):
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(lo, hi, n)]
    if null_every:
        vals = [None if i % null_every == 0 else v
                for i, v in enumerate(vals)]
    return vals


BITWISE = {
    "ops": (lambda a: [
        a.B.BitwiseAnd(a.col("a"), a.lit(0xFF)).alias("and_"),
        a.B.BitwiseOr(a.col("a"), a.lit(0x10)).alias("or_"),
        a.B.BitwiseXor(a.col("a"), a.col("a") + 1).alias("xor_"),
        a.B.BitwiseNot(a.col("a")).alias("not_"),
        a.B.BitCount(a.col("a")).alias("pc")],
        {"a": _ints(96, 21, -10 ** 6, 10 ** 6, 7),
         "b": _ints(96, 21, 0, 63)}),
    "shifts": (lambda a: [
        a.B.ShiftLeft(a.col("a"), a.col("b")).alias("sl"),
        a.B.ShiftRight(a.col("a"), a.col("b")).alias("sr"),
        a.B.ShiftRightUnsigned(a.col("a"), a.col("b")).alias("sru"),
        a.B.ShiftLeft(a.col("i"), a.col("b")).alias("sli"),
        a.B.ShiftRightUnsigned(a.col("i"), a.col("b")).alias("srui")],
        {"a": _ints(96, 22, -10 ** 9, 10 ** 9, 9),
         "b": _ints(96, 22, 0, 63)}),
    "interleave": (lambda a: [
        a.col("a"), a.col("b"),
        a.B.InterleaveBits(a.col("i"), a.col("b")).alias("z"),
        a.B.InterleaveBits(a.col("a")).alias("z1"),
        a.B.InterleaveBits(a.col("i"), a.col("b"), a.col("a"),
                           a.col("i")).alias("z4")],
        {"a": _ints(64, 23, -1000, 1000), "b": _ints(64, 24, 0, 1000)}),
}


@pytest.mark.parametrize("name", list(BITWISE))
def test_bitwise_as_the_jax_package(name, jax_api):
    exprs, data = BITWISE[name]

    def build(a, s):
        d = dict(data, i=[None if v is None else v % 40000 - 20000
                          for v in data["a"]])
        return a.df(s, d, [("a", "INT64"), ("b", "INT32"), ("i", "INT32")]) \
            .select(*exprs(a))
    got, want = _both(build, jax_api)
    assert got == want
    # the port's CPU engine on the same plan
    from spark_rapids_tpu_torch.plan.host_table import from_engine, to_pydict
    cpu = to_pydict(from_engine(PORT.execute_cpu(build(
        PORT, PORT.session()).plan)))
    assert [dict(zip(cpu, v)) for v in zip(*cpu.values())] == got


def test_shift_right_unsigned_negative():
    """-1 >>> 1 is 2^63 - 1 (Java semantics)."""
    s = PORT.session()
    out = PORT.df(s, {"a": [-1, -8]}, [("a", "INT64")]).select(
        PORT.B.ShiftRightUnsigned(PORT.col("a"), PORT.lit(1)).alias("r")) \
        .collect()
    assert [r["r"] for r in out] == [2 ** 63 - 1, (2 ** 64 - 8) >> 1]


def test_interleave_bits_locality():
    """Identical points share a z-order key; nearby ones sort near."""
    s = PORT.session()
    x, y = _ints(64, 23, 0, 1000), _ints(64, 25, 0, 1000)
    out = PORT.df(s, {"x": x + x[:8], "y": y + y[:8]},
                  [("x", "INT32"), ("y", "INT32")]).select(
        "x", "y", PORT.B.InterleaveBits(PORT.col("x"), PORT.col("y"))
        .alias("z")).collect()
    keys = {}
    for r in out:
        keys.setdefault((r["x"], r["y"]), set()).add(r["z"])
    assert all(len(v) == 1 for v in keys.values())


# --- percentiles ------------------------------------------------------------

def test_percentile(jax_api):
    """Exact percentile (CPU engine in both), test_bitwise_misc.py's
    case, against numpy too."""
    data = {"k": [1] * 5 + [2] * 4,
            "v": [10.0, 20.0, 30.0, 40.0, 50.0, 1.0, 2.0, 3.0, 4.0]}

    def build(a, s):
        return a.df(s, data, [("k", "INT64"), ("v", "FLOAT64")]) \
            .group_by("k").agg(a.Agg.Percentile(a.col("v"), 0.5).alias("p50"),
                               a.Agg.Percentile(a.col("v"), 0.25)
                               .alias("p25")).sort("k")
    got, want = _both(build, jax_api)
    assert got == want
    assert [(r["p50"], r["p25"]) for r in got] == [(30.0, 20.0), (2.5, 1.75)]
    marks = build(PORT, PORT.session()).explain("NOT_ON_TPU")
    assert "Percentile runs on the CPU engine" in marks


def _approx(build_aggs, data, types):
    def build(a, s):
        df = a.df(s, data, types)
        keys = [n for n, _ in types if n == "k"]
        g = df.group_by(*keys) if keys else df.group_by()
        out = g.agg(*build_aggs(a))
        return out.sort("k") if keys else out
    return build


APPROX = {
    "small_groups_exact": (
        lambda a: [a.Agg.ApproxPercentile(a.col("v"), 0.5).alias("p50"),
                   a.Agg.ApproxPercentile(a.col("v"), 0.0).alias("p0"),
                   a.Agg.ApproxPercentile(a.col("v"), 1.0).alias("p100")],
        {"k": ["a"] * 5 + ["b"] * 4,
         "v": [10.0, 20.0, 30.0, 40.0, 50.0, 1.0, 2.0, 3.0, 4.0]},
        [("k", "STRING"), ("v", "FLOAT64")], {}),
    "large_group_accuracy": (
        lambda a: [a.Agg.ApproxPercentile(a.col("v"), p).alias(f"p{i}")
                   for i, p in enumerate((0.5, 0.9, 0.99))],
        {"v": [float(v) for v in np.random.default_rng(0).uniform(
            0.0, 1.0, 50_000)]}, [("v", "FLOAT64")], {}),
    "percentage_array": (
        lambda a: [a.Agg.ApproxPercentile(a.col("v"), [0.25, 0.75])
                   .alias("p")],
        {"k": ["a"] * 4 + ["b"] * 2, "v": [1.0, 2.0, 3.0, 4.0, None, None]},
        [("k", "STRING"), ("v", "FLOAT64")], {}),
    "nulls_ignored_and_merge_across_batches": (
        lambda a: [a.Agg.ApproxPercentile(a.col("v"), 0.5).alias("m")],
        {"v": [None if i % 7 == 0 else float(v) for i, v in enumerate(
            np.random.default_rng(1).normal(100.0, 15.0, 4000))]},
        [("v", "FLOAT64")], {"srt.sql.batchSizeRows": 512}),
    "grouped_across_batches": (
        lambda a: [a.Agg.ApproxPercentile(a.col("v"), [0.1, 0.5, 0.99],
                                          accuracy=4096).alias("m")],
        {"k": [int(v) for v in np.random.default_rng(2).integers(0, 5,
                                                                 9000)],
         "v": [float(v) for v in np.random.default_rng(3).uniform(
             0, 100, 9000)]},
        [("k", "INT64"), ("v", "FLOAT64")], {"srt.sql.batchSizeRows": 1024}),
}


@pytest.mark.parametrize("name", list(APPROX))
def test_approx_percentile_as_the_jax_package(name, jax_api):
    """The port's device sketch equals the JAX package's (the same
    centroids, means at 1e-12), and each answer's rank lies within the
    sketch's bound of p * N (2N / K, ApproxPercentile's docstring)."""
    aggs, data, types, conf = APPROX[name]
    build = _approx(aggs, data, types)
    got, want = _both(build, jax_api, **conf)
    _rows_equal(got, want)
    plan = build(PORT, PORT.session(**conf)).explain("NOT_ON_TPU")
    assert "!" not in plan.split("\n")[0], plan
    if name == "small_groups_exact":
        assert [(r["p50"], r["p0"], r["p100"]) for r in got] == \
            [(30.0, 10.0, 50.0), (2.0, 1.0, 4.0)]
    if name == "percentage_array":
        assert [r["p"] for r in got] == [[1.0, 3.0], None]
    keys = [r.get("k") for r in got]
    for r, k in zip(got, keys):
        vals = np.sort([v for v, kk in zip(data["v"], data.get(
            "k", [None] * len(data["v"]))) if kk == k and v is not None])
        for col, v in r.items():
            if col == "k" or v is None:
                continue
            fn = aggs(PORT)[[a.name for a in aggs(PORT)].index(col)]
            pcts = fn.children[0].percentages
            bound = 2 * len(vals) / fn.children[0].K
            for p, x in zip(pcts, v if isinstance(v, list) else [v]):
                rank = np.searchsorted(vals, x, side="right")
                assert abs(rank - p * len(vals)) <= bound + 1, (col, p)


# --- bloom filters (test_bloom.py) -------------------------------------------

def _lcol(a, vals, valid=None):
    import numpy as np_
    x = np_.asarray(vals, np_.int64)
    v = np_.ones(len(x), bool) if valid is None else np_.asarray(valid)
    if a.port:
        return a.dt, a.H, (torch.from_numpy(x), torch.from_numpy(v))
    import jax.numpy as jnp
    return a.dt, a.H, (jnp.asarray(x), jnp.asarray(v))


def _bloom(a, keys, valid, live, nbits):
    from importlib import import_module
    CV = import_module(("spark_rapids_tpu_torch" if a.port else
                        "spark_rapids_tpu") + ".columnar.vector").ColumnVector
    _, _, (x, v) = _lcol(a, keys, valid)
    live = torch.tensor(live) if a.port else __import__(
        "jax.numpy", fromlist=["asarray"]).asarray(live)
    return CV(x, v, a.dt.INT64), a.bloom.build_bloom(
        [CV(x, v, a.dt.INT64)], live, nbits)


def test_bloom_no_false_negatives_and_the_jax_bits(jax_api):
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 40, size=5000, replace=False)
    build = keys[:2000]
    nb = PORT.bloom.choose_num_bits(len(build))
    assert nb == jax_api.bloom.choose_num_bits(len(build))
    _, bits = _bloom(PORT, build, None, [True] * 2000, nb)
    _, jbits = _bloom(jax_api, build, None, [True] * 2000, nb)
    assert np.array_equal(bits.numpy(), np.asarray(jbits))
    hit_col, _ = _bloom(PORT, keys[:1000], None, [True] * 1000, nb)
    assert PORT.bloom.might_contain(bits, [hit_col]).all()
    miss_col, _ = _bloom(PORT, keys[2000:], None, [True] * 3000, nb)
    assert PORT.bloom.might_contain(bits, [miss_col]).float().mean() < 0.05


def test_bloom_null_and_dead_rows_excluded():
    _, bits = _bloom(PORT, [1, 2, 3], [True, False, True],
                     [True, True, False], PORT.bloom.MIN_BITS)
    probe, _ = _bloom(PORT, [1, 2, 3, 0], [True, True, True, False],
                      [True] * 4, PORT.bloom.MIN_BITS)
    out = PORT.bloom.might_contain(bits, [probe])
    assert out[0] and not out[3]


def test_might_contain_expression(jax_api):
    def build(a, s):
        _, bits = _bloom(a, [10, 20], None, [True, True], a.bloom.MIN_BITS)
        return a.df(s, {"k": [10, 20, 30, None]}, [("k", "INT64")]).select(
            a.H.BloomFilterMightContain(a.col("k"), np.asarray(bits))
            .alias("m"))
    got, want = _both(build, jax_api)
    assert got == want
    assert [r["m"] for r in got][:2] == [True, True]
    assert got[3]["m"] is None


def test_join_results_identical_with_bloom():
    """The join's bloom pre-filter drops probe rows and changes no
    result."""
    def run(conf):
        s = PORT.session(**conf)
        rng = np.random.default_rng(1)
        n = 20_000
        left = PORT.df(s, {"k": [int(v) for v in rng.integers(0, 100_000, n)],
                           "v": [float(v) for v in rng.uniform(0, 1, n)]},
                       [("k", "INT64"), ("v", "FLOAT64")])
        right = PORT.df(s, {"k": list(range(50)),
                            "name": [f"x{i}" for i in range(50)]},
                        [("k", "INT64"), ("name", "STRING")])
        rows = left.join(right, "k").count()
        return rows, s._last_execution[1].metric_totals().get(
            "bloomFilteredRows", 0)
    on = run({"srt.sql.join.bloomFilter.enabled": True,
              "srt.sql.join.bloomFilter.minProbeRows": 1,
              "srt.sql.broadcastRowThreshold": 1})
    off = run({"srt.sql.join.bloomFilter.enabled": False,
               "srt.sql.broadcastRowThreshold": 1})
    assert on[0] == off[0]
    assert on[1] > 0 and off[1] == 0


# --- execution context (test_misc_exprs.py) ------------------------------------

def test_monotonically_increasing_id(jax_api):
    def build(a, s):
        return a.df(s, {"v": list(range(10))}, [("v", "INT64")]).select(
            a.col("v"), a.MX.monotonically_increasing_id().alias("id"))
    got, want = _both(build, jax_api)
    assert got == want and [r["id"] for r in got] == list(range(10))


def test_mono_id_offsets_across_batches():
    s = PORT.session(**{"srt.sql.batchSizeRows": 4})
    out = PORT.df(s, {"v": list(range(10))}, [("v", "INT64")]).select(
        PORT.MX.monotonically_increasing_id().alias("id")).to_pydict()
    assert out["id"] == list(range(10))


def test_spark_partition_id(jax_api):
    def build(a, s):
        return a.df(s, {"v": [1, 2, 3]}, [("v", "INT64")]).select(
            a.MX.spark_partition_id().alias("p"))
    got, want = _both(build, jax_api)
    assert got == want == [{"p": 0}] * 3


UUID_V4 = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-"
                     r"[0-9a-f]{12}$")


@pytest.mark.parametrize("n, batch", [(8, 1 << 20), (5000, 1024)])
def test_uuid_unique_and_valid(n, batch):
    s = PORT.session(**{"srt.sql.batchSizeRows": batch})
    df = PORT.df(s, {"v": list(range(n))}, [("v", "INT64")]).select(
        PORT.MX.uuid_expr().alias("u"))
    out = df.to_pydict()["u"]
    assert len(set(out)) == n
    assert all(UUID_V4.match(u) for u in out)
    # a seeded uuid() is the same in two runs
    seeded = PORT.df(s, {"v": list(range(n))}, [("v", "INT64")]).select(
        PORT.MX.uuid_expr(seed=5).alias("u"))
    assert seeded.to_pydict() == seeded.to_pydict()


def test_version(jax_api):
    def build(a, s):
        return a.df(s, {"v": [1]}, [("v", "INT64")]).select(
            a.MX.version().alias("v"))
    got, want = _both(build, jax_api)
    assert got == want and got[0]["v"].startswith("spark_rapids_tpu ")


def test_raise_error(jax_api):
    def build(a, s):
        return a.df(s, {"v": [1, 2]}, [("v", "INT64")]).select(
            a.MX.raise_error("boom").alias("e"))
    with pytest.raises(PORT.MX.RaiseErrorException, match="boom"):
        build(PORT, PORT.session()).collect()
    with pytest.raises(jax_api.MX.RaiseErrorException, match="boom"):
        build(jax_api, jax_api.session()).collect()


@pytest.mark.parametrize("threshold, raises", [(100, False), (2, True)])
def test_raise_error_under_if(threshold, raises, jax_api):
    """C18: ``IF(a > t, raise_error('boom'), 'ok')`` raises only where a
    row selects the branch, as plain Python evaluates it; the JAX
    package raises for any live row."""
    def build(a, s):
        return a.df(s, {"a": [1, 2, 3]}, [("a", "INT64")]).select(
            a.Cond.If(a.col("a") > a.lit(threshold),
                      a.MX.raise_error("boom"), a.lit("ok")).alias("r"))
    python = ["boom" if a > threshold else "ok" for a in (1, 2, 3)]
    df = build(PORT, PORT.session())
    from spark_rapids_tpu_torch.plan.host_table import from_engine, to_pydict
    if raises:
        assert "boom" in python
        with pytest.raises(PORT.MX.RaiseErrorException, match="boom"):
            df.collect()
        with pytest.raises(PORT.MX.RaiseErrorException, match="boom"):
            PORT.execute_cpu(df.plan)
    else:
        assert [r["r"] for r in df.collect()] == python
        assert to_pydict(from_engine(PORT.execute_cpu(df.plan)))["r"] == \
            python
    with pytest.raises(jax_api.MX.RaiseErrorException, match="boom"):
        build(jax_api, jax_api.session()).collect()
