"""The DataFrame surface through both packages, on the CPU.

``TpuSession.range``, ``DataFrame.sample`` / ``sort_desc`` / ``count`` /
``to_pydict`` / ``to_pandas`` / ``explain(metrics=True)`` and the
``GroupedData`` shorthands (``count``, ``sum``, ``min``, ``max``,
``avg``), each through the port's session and the JAX session on the
same data. ``sample`` keeps the same rows at two batch sizes, on the
CPU engine and in the JAX package; ``range`` and ``sample`` run on the
CPU engine too (``srt.sql.enabled=false``).
"""

import numpy as np
import pytest

from torch_both import PORT, jax_api  # noqa: F401  (a fixture)


def _both(build, jax_api, **conf):
    return (build(PORT, PORT.session(**conf)),
            build(jax_api, jax_api.session(**conf)))


@pytest.mark.parametrize("args", [(10,), (3, 17), (20, 0, -3), (5, 5),
                                  (-4, 9, 4)])
def test_range(args, jax_api):
    port, jax = _both(lambda a, s: s.range(*args).to_pydict(), jax_api)
    assert port == jax == {"id": list(range(*args))}


def test_range_across_batches_and_the_cpu_engine():
    n = 10_000
    want = sum(i for i in range(n) if i % 3 == 0)
    for conf in ({"srt.sql.batchSizeRows": 1024},
                 {"srt.sql.enabled": False}):
        s = PORT.session(**conf)
        df = s.range(0, n).filter(PORT.col("id") % 3 == 0) \
            .agg(PORT.Agg.Sum(PORT.col("id")).alias("s"))
        assert df.collect() == [{"s": want}]


def _sample(a, s, fraction, seed):
    return s.range(0, 6000).sample(fraction, seed=seed).to_pydict()["id"]


@pytest.mark.parametrize("fraction, seed", [(0.1, 11), (0.5, 42), (0.0, 3),
                                            (1.0, 3)])
def test_sample_keeps_the_jax_packages_rows(fraction, seed, jax_api):
    """The keep mask hashes stream positions, so the rows are the same
    at two batch sizes, on the CPU engine and in the JAX package."""
    port, jax = _both(lambda a, s: _sample(a, s, fraction, seed), jax_api)
    assert port == jax
    for conf in ({"srt.sql.batchSizeRows": 777}, {"srt.sql.enabled": False}):
        assert _sample(PORT, PORT.session(**conf), fraction, seed) == port
    if 0.0 < fraction < 1.0:
        assert abs(len(port) - fraction * 6000) < 6 * np.sqrt(6000)


def test_sample_over_a_table(jax_api):
    data = {"k": list(range(500)), "v": [float(i) * 0.5 for i in range(500)]}

    def build(a, s):
        return a.df(s, data, [("k", "INT64"), ("v", "FLOAT64")]) \
            .sample(0.3, seed=7).collect()
    port, jax = _both(build, jax_api, **{"srt.sql.batchSizeRows": 128})
    assert port == jax


DATA = {"g": ["a", "b", "a", "c", "b", "a", None],
        "x": [1, 5, 3, None, 2, 8, 4],
        "f": [0.5, 1.5, None, 2.0, 4.5, -1.0, 3.0]}
TYPES = [("g", "STRING"), ("x", "INT64"), ("f", "FLOAT64")]


@pytest.fixture(scope="module")
def jax_grouped(jax_api):
    """Every shorthand's rows through the JAX package, in one query per
    shorthand's columns: {how: rows by group}."""
    s = jax_api.session()
    g = jax_api.df(s, DATA, TYPES).group_by("g")
    out = {}
    for how in ("count", "sum", "min", "max", "avg"):
        df = g.count() if how == "count" else getattr(g, how)("x", "f")
        out[how] = sorted(df.collect(), key=lambda r: str(r["g"]))
    return out


@pytest.mark.parametrize("how", ["count", "sum", "min", "max", "avg",
                                 "mean"])
def test_grouped_shorthands(how, jax_grouped):
    g = PORT.df(PORT.session(), DATA, TYPES).group_by("g")
    out = g.count() if how == "count" else getattr(g, how)("x", "f")
    port = sorted(out.collect(), key=lambda r: str(r["g"]))
    assert port == jax_grouped["avg" if how == "mean" else how]


def test_sort_desc_count_and_pydict(jax_api):
    def build(a, s):
        df = a.df(s, DATA, TYPES)
        return (df.sort_desc("x").collect(), df.count(),
                df.filter(a.col("x") > a.lit(2)).count(), df.to_pydict())
    port, jax = _both(build, jax_api)
    assert port == jax
    assert port[3] == DATA


def test_to_pandas():
    import pandas as pd
    df = PORT.df(PORT.session(), DATA, TYPES)
    got = df.to_pandas()
    assert isinstance(got, pd.DataFrame)
    assert list(got.columns) == ["g", "x", "f"]
    assert got["x"].tolist()[:3] == [1, 5, 3]


def test_explain_metrics_names_every_operator():
    s = PORT.session(**{"srt.sql.batchSizeRows": 4})
    df = PORT.df(s, DATA, TYPES).filter(PORT.col("x") > PORT.lit(1)) \
        .group_by("g").sum("x")
    out = df.explain(metrics=True)
    lines = out.split("\n")
    physical = s._last_execution[0]
    ops = []
    stack = [physical]
    while stack:
        node = stack.pop()
        ops.append(node.node_description())
        stack.extend(node.children)
    for op in ops:
        line = next(ln for ln in lines if op in ln)
        assert "opTime=" in line and "numOutputRows=" in line, line
    assert lines[-1].startswith("query: wall=")
