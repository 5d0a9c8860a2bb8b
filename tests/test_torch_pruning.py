"""Row-group pruning from Parquet statistics and runtime partition
pruning (DPP) in the port, held against unpruned scans, plain Python
and the JAX package over the same files.

Row groups: a file of ROW_GROUPS row groups sorted on ``k``, with a float
column holding NaN (which Parquet leaves out of min / max while Spark
sorts it above every number), an all-NULL row group, strings and
decimals; each filter runs with ``srt.sql.parquet.filterPushdown`` on
and off: the rows are equal, equal to plain Python and to the JAX
package (whose pyarrow lane hands the same filter to the dataset
scanner), and ``rowGroupsPruned`` is the count the statistics prove.
DPP: a partitioned fact table joined to a filtered dimension through a
broadcast join, with ``srt.sql.dpp.enabled`` on and off: the rows are
equal, equal to the JAX package's with its DPP on, ``dppPrunedFiles``
equal to the JAX package's and ``dppFilters`` as expected, and an outer
join never prunes. The JAX side runs its CPU engine under
``patch_jax_compiles`` (C1).
"""

import decimal
import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr import aggregates as Agg
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.plan.session import TpuSession

GROUP_ROWS = 500
ROW_GROUPS = 8
N = GROUP_ROWS * ROW_GROUPS
BIG = 2 ** 53


def port(**conf):
    return TpuSession(SrtConf(conf), device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.expr import predicates as JP
        from spark_rapids_tpu.expr.core import col as jcol
        from spark_rapids_tpu.expr.core import lit as jlit
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        yield {"session": JSession(JConf({"srt.sql.enabled": False})),
               "col": jcol, "lit": jlit, "P": JP}


@pytest.fixture(scope="module")
def sorted_file(tmp_path_factory):
    """ROW_GROUPS row groups of k ascending; f NaN in group 2, group 5
    wholly NULL in every column but k; s and d follow k."""
    rng = np.random.default_rng(16)
    k = np.arange(N, dtype=np.int64)
    f = rng.uniform(0, 1, N) + k // GROUP_ROWS
    f[2 * GROUP_ROWS + 7] = np.nan
    null = (k // GROUP_ROWS) == 5
    data = {
        "k": k.tolist(),
        "f": [None if z else float(v) for v, z in zip(f, null)],
        "s": [None if z else f"s{v:05d}" for v, z in zip(k, null)],
        "d": [None if z else decimal.Decimal(int(v)).scaleb(-2)
              for v, z in zip(k, null)],
        "n": [None if z else int(v % 7) for v, z in zip(k, null)],
        # past 2**53, where the engine meets a float as a double
        "b": [None if z else int(v) + BIG for v, z in zip(k, null)],
    }
    path = str(tmp_path_factory.mktemp("prune") / "sorted.parquet")
    s = port()
    df = s.create_dataframe(data, [("k", dt.INT64), ("f", dt.FLOAT64),
                                   ("s", dt.STRING),
                                   ("d", dt.DecimalType(12, 2)),
                                   ("n", dt.INT32), ("b", dt.INT64)])
    df.write.option("rowGroupRows", GROUP_ROWS).parquet(path)
    meta = pq.ParquetFile(next(_files(path))).metadata
    assert meta.num_row_groups == ROW_GROUPS
    return path, data


def _files(root):
    import os
    for dp, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".parquet"):
                yield os.path.join(dp, f)


def _gt(v, lim):
    """Spark's ``>``: NaN above every number, NULL passes nothing."""
    return v is not None and (math.isnan(v) or v > lim) \
        if isinstance(v, float) else v is not None and v > lim


# name: (port filter, JAX filter maker, plain Python keep(row), row groups
# the statistics rule out)
CASES = {
    "k_lt": (lambda: col("k") < 1200, lambda J: J["col"]("k") < 1200,
             lambda r: r["k"] < 1200, 5),
    "k_eq": (lambda: col("k") == 3333, lambda J: J["col"]("k") == 3333,
             lambda r: r["k"] == 3333, 7),
    "k_ge_or_le": (lambda: P.Or(col("k") >= 3900, col("k") <= 10),
                   lambda J: J["P"].Or(J["col"]("k") >= 3900,
                                       J["col"]("k") <= 10),
                   lambda r: r["k"] >= 3900 or r["k"] <= 10, 6),
    "k_in": (lambda: P.InSet(col("k"), [5, 2600, None]),
             lambda J: J["P"].InSet(J["col"]("k"), [5, 2600, None]),
             lambda r: r["k"] in (5, 2600), 6),
    # NaN trap: f > 7.5 holds in group 2 through its NaN row though
    # every max but group 7's is below 7.5: no float group prunes on
    # its max, only the all-NULL group 5 goes
    "f_gt_nan": (lambda: col("f") > 7.5, lambda J: J["col"]("f") > 7.5,
                 lambda r: _gt(r["f"], 7.5), 1),
    "f_lt": (lambda: col("f") < 1.5, lambda J: J["col"]("f") < 1.5,
             lambda r: r["f"] is not None and not math.isnan(r["f"])
             and r["f"] < 1.5, 6),
    # all-NULL group 5 passes no comparison; IS NULL keeps only it
    "n_eq_null_group": (lambda: col("n") == 3, lambda J: J["col"]("n") == 3,
                        lambda r: r["n"] == 3, 1),
    "n_is_null": (lambda: P.IsNull(col("n")),
                  lambda J: J["P"].IsNull(J["col"]("n")),
                  lambda r: r["n"] is None, 7),
    "n_is_not_null": (lambda: P.IsNotNull(col("n")),
                      lambda J: J["P"].IsNotNull(J["col"]("n")),
                      lambda r: r["n"] is not None, 1),
    "s_range": (lambda: (col("s") >= "s01000") & (col("s") < "s01500"),
                lambda J: (J["col"]("s") >= "s01000")
                & (J["col"]("s") < "s01500"),
                lambda r: r["s"] is not None and "s01000" <= r["s"]
                < "s01500", 7),
    "d_le": (lambda: col("d") <= lit(decimal.Decimal("4.99")),
             lambda J: J["col"]("d") <= J["lit"](decimal.Decimal("4.99")),
             lambda r: r["d"] is not None
             and r["d"] <= decimal.Decimal("4.99"), 7),
    # a decimal meets a float literal as a double: 4.99 (DECIMAL) equals
    # the double 4.99, which lies above it, so group 0 (max 4.99) stays
    "d_eq_float": (lambda: col("d") == 4.99,
                   lambda J: J["col"]("d") == 4.99,
                   lambda r: r["d"] is not None and float(r["d"]) == 4.99,
                   7),
    "d_ge_float": (lambda: col("d") >= 4.99,
                   lambda J: J["col"]("d") >= 4.99,
                   lambda r: r["d"] is not None and float(r["d"]) >= 4.99,
                   1),
    # an INT64 meets a float as a double: 2**53 + 499 rounds to the
    # literal, so group 0 (max 2**53 + 499) stays
    "b_eq_float": (lambda: col("b") == float(BIG + 500),
                   lambda J: J["col"]("b") == float(BIG + 500),
                   lambda r: r["b"] is not None
                   and float(r["b"]) == float(BIG + 500), 6),
    # a conjunct that does not translate prunes nothing by itself
    "and_untranslated": (lambda: (col("k") + 1 > 3000) & (col("k") < 600),
                         lambda J: (J["col"]("k") + 1 > 3000)
                         & (J["col"]("k") < 600),
                         lambda r: r["k"] + 1 > 3000 and r["k"] < 600, 6),
}


def _run(path, cond, push):
    s = port(**{"srt.sql.parquet.filterPushdown": push})
    rows = s.read.parquet(path).filter(cond()).select(col("k")).collect()
    return sorted(r["k"] for r in rows), \
        s._last_execution[1].metric_totals()


@pytest.mark.parametrize("case", list(CASES))
def test_pruned_scan_equals_unpruned(sorted_file, jax_side, case):
    path, data = sorted_file
    cond, jcond, keep, pruned = CASES[case]
    got, m = _run(path, cond, True)
    base, m0 = _run(path, cond, False)
    rows = [dict(zip(data, vals)) for vals in zip(*data.values())]
    want = sorted(r["k"] for r in rows if keep(r))
    assert got == base == want
    assert m.get("rowGroupsPruned", 0) == pruned
    assert m0.get("rowGroupsPruned", 0) == 0
    if pruned:
        assert m["scanBytesRead"] < m0["scanBytesRead"]
    jax = jax_side["session"].read.parquet(path).filter(jcond(jax_side)) \
        .to_pydict()["k"]
    assert sorted(jax) == want


@pytest.fixture(scope="module")
def fact_dim(tmp_path_factory):
    rng = np.random.default_rng(4)
    n = 3000
    fact = {"day": rng.integers(0, 24, n).tolist(),
            "item": rng.integers(0, 50, n).tolist(),
            "v": rng.integers(0, 1000, n).tolist()}
    root = str(tmp_path_factory.mktemp("dpp") / "fact")
    port().create_dataframe(fact, [("day", dt.INT64), ("item", dt.INT64),
                                   ("v", dt.INT64)]) \
        .write.partition_by("day").parquet(root)
    dim = {"dk": list(range(24)), "year": [2000 + d % 4 for d in range(24)]}
    return root, fact, dim


def _dpp_query(s, root, dim, how):
    d = s.create_dataframe(dim, [("dk", dt.INT64), ("year", dt.INT64)]) \
        .filter(col("year") == 2001)
    f = s.read.parquet(root).filter(col("v") >= 100)
    j = f.join(d, on=([col("day")], [col("dk")]), how=how)
    return j.group_by("day").agg(Agg.Sum(col("v")).alias("sv"))


def _jax_dpp(J, root, dim, how):
    """The same query through the JAX package's engine with its DPP on:
    (rows, dppPrunedFiles summed over its operators)."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.expr import aggregates as JAgg
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    jcol = J["col"]
    s = JSession(JConf({"srt.sql.dpp.enabled": True}))
    d = s.create_dataframe(dim, [("dk", jdt.INT64), ("year", jdt.INT64)]) \
        .filter(jcol("year") == 2001)
    f = s.read.parquet(root).filter(jcol("v") >= 100)
    rows = f.join(d, on=([jcol("day")], [jcol("dk")]), how=how) \
        .group_by("day").agg(JAgg.Sum(jcol("v")).alias("sv")).collect()
    pruned = sum(m["dppPrunedFiles"].value for m in
                 s._last_execution["ctx"].metrics.values()
                 if "dppPrunedFiles" in m)
    return sorted((r["day"], r["sv"]) for r in rows), pruned


@pytest.mark.parametrize("how", ["inner", "left_semi", "left_outer"])
def test_dpp_on_equals_off(fact_dim, jax_side, how):
    root, fact, dim = fact_dim
    out = {}
    for on in (True, False):
        s = port(**{"srt.sql.dpp.enabled": on})
        rows = _dpp_query(s, root, dim, how).collect()
        out[on] = (sorted((r["day"], r["sv"]) for r in rows),
                   s._last_execution[1].metric_totals())
    (got, m), (base, m0) = out[True], out[False]
    keep_days = {d for d, y in zip(dim["dk"], dim["year"]) if y == 2001}
    sums = {}
    for day, v in zip(fact["day"], fact["v"]):
        if v >= 100 and (how == "left_outer" or day in keep_days):
            sums[day] = sums.get(day, 0) + v
    assert got == base == sorted(sums.items())
    jax_rows, jax_pruned = _jax_dpp(jax_side, root, dim, how)
    assert jax_rows == got
    assert m.get("dppPrunedFiles", 0) == jax_pruned
    assert m0.get("dppPrunedFiles", 0) == 0
    if how == "left_outer":
        # an outer join keeps its unmatched probe rows: nothing prunes
        assert m.get("dppPrunedFiles", 0) == 0
        assert m["scanFiles"] == 24
    else:
        assert m["dppFilters"] == 1
        assert m["dppPrunedFiles"] == 24 - len(keep_days)
        assert m["scanFiles"] == len(keep_days)


# (column type, the row group's values, filter, plain Python keep(v)):
# the literal meets the bounds in the engine's own domain
ENGINE_DOMAIN = {
    # FLOAT32 against an integer meets it in FLOAT32: 2**24 + 1 rounds
    # to 2**24
    "f32_eq_int": (dt.FLOAT32, [16777216.0],
                   lambda: col("x") == (2 ** 24 + 1), lambda v: True),
    # IN casts to the column's lane: 1.5 into an INT64 is 1
    "i64_in_float": (dt.INT64, [1, 1],
                     lambda: P.InSet(col("x"), [1.5]), lambda v: True),
    # a FLOAT32 IN meets a double rounded to FLOAT32
    "f32_in_double": (dt.FLOAT32, [0.1],
                      lambda: P.InSet(col("x"), [0.1]), lambda v: True),
    "dec_lt_float": (dt.DecimalType(6, 2), [decimal.Decimal("19.99")],
                     lambda: col("x") <= 19.99, lambda v: True),
    "i64_gt_exact": (dt.INT64, [BIG + 1], lambda: col("x") > BIG,
                     lambda v: True),
    "i64_gt_none": (dt.INT64, [BIG - 10, BIG], lambda: col("x") > BIG,
                    lambda v: False),
}


@pytest.mark.parametrize("case", list(ENGINE_DOMAIN))
def test_literal_meets_the_bounds_in_the_engine_domain(case):
    """might_match answers True wherever the engine's own Filter keeps
    a row of the group, and prunes where it keeps none."""
    from fractions import Fraction
    from spark_rapids_tpu_torch.io import pruning as PR
    t, vals, cond, keep = ENGINE_DOMAIN[case]
    kept = port().create_dataframe({"x": vals}, [("x", t)]) \
        .filter(cond()).collect()
    assert bool(kept) == any(keep(v) for v in vals)
    # as the statistics hold them: a FLOAT32 as stored, a decimal exact
    bounds = [Fraction(v) if isinstance(v, decimal.Decimal) else
              float(np.float32(v)) if t == dt.FLOAT32 else v for v in vals]
    stats = {"x": PR.ColumnStats(min(bounds), max(bounds), 0, len(vals),
                                 t.is_floating)}
    node = PR.translate(cond())
    assert node is not None
    assert PR.might_match(node, stats, {"x": t}) == bool(kept)


def test_pyarrow_statistics_prune_too(tmp_path):
    """A file pyarrow wrote (its own statistics, a dictionary page, v2
    pages) prunes as the port's own: the same rows as unpruned."""
    k = np.arange(4000, dtype=np.int64)
    path = str(tmp_path / "pa.parquet")
    pq.write_table(pa.table({"k": k, "s": [f"x{v % 13}" for v in k]}),
                   path, row_group_size=1000, data_page_version="2.0")
    got, m = _run(path, lambda: col("k") >= 2500, True)
    base, _ = _run(path, lambda: col("k") >= 2500, False)
    assert got == base == list(range(2500, 4000))
    assert m["rowGroupsPruned"] == 2


def test_count_of_a_literal_over_a_pruned_scan(sorted_file):
    """COUNT(1) over a pruned scan: B1's plain row program reads no
    column, and its literal fills the block's rows (C28; it raised a
    size mismatch before)."""
    path, data = sorted_file
    s = port()
    rows = s.read.parquet(path).filter(col("k") < 1200) \
        .agg(Agg.Count(lit(1)).alias("c")).collect()
    assert rows == [{"c": sum(1 for k in data["k"] if k < 1200)}]
    assert s._last_execution[1].metric_totals()["rowGroupsPruned"] == 5
