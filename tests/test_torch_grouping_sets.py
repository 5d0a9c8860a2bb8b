"""GROUPING SETS / ROLLUP / CUBE through both packages' ``session.sql``
on the CPU.

Each form runs through the port, the JAX package and plain Python over
one seeded table of 3,000 rows in 1,024-row batches (NULLs in both keys
and in the value, NaN too):

- ROLLUP, CUBE and GROUPING SETS, with ``GROUPING()`` in SELECT, in
  HAVING and in ORDER BY (under a LIMIT, as q36 and q70 sort);
- a natural NULL key stays apart from the subtotal NULL: the grouping
  id is a grouping key, so (NULL, subtotal) and (NULL, grand total) are
  different rows;
- ``ExpandExec`` unifies a key slot whose type differs across the
  projections (an INT column against a BIGINT one) and passes plain
  column slots on without a copy;
- the expanded groupings reach the grouped kernel (B3): the port's
  batches through the lane equal the JAX grouped lane's
  ``pallasBatches`` (forced on there with SRT_PALLAS_GROUPED_FORCE=1).

Rows compare as multisets, numbers as floats to 1e-9. The JAX side runs
in a subprocess of this file (its ``__main__`` block), started before
the module's first test: there the persistent compile cache works,
which a JAX compile inside pytest cannot use (tests/conftest.py wraps
jax's ``_cache_read`` with four arguments; this jax passes five).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from jax_reference import SUBPROCESS_XLA_FLAGS
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.testing import compare_rows, order_keys

N = 3000
RTOL = 1e-9
SETTINGS = {"srt.sql.batchSizeRows": 1024}


def _lanes():
    r = np.random.default_rng(7)
    words = np.array(["x", "yy", "zzz"], object)
    v = np.round(r.uniform(-5, 20, N), 2)
    v[r.random(N) < 0.01] = np.nan
    return {"k1": (r.integers(0, 5, N).astype(np.int32), r.random(N) > 0.05,
                   "int"),
            "k2": (words[r.integers(0, 3, N)], r.random(N) > 0.05,
                   "string"),
            "v": (v, r.random(N) > 0.03, "double"),
            "b": (r.integers(0, 3, N).astype(np.int64), np.ones(N, bool),
                  "bigint")}


ORDER_TEXT = ("SELECT k1, k2, SUM(v) AS s, GROUPING(k1) + GROUPING(k2) "
              "AS lvl FROM t GROUP BY ROLLUP(k1, k2) "
              "ORDER BY GROUPING(k1) + GROUPING(k2) DESC, k1, k2 LIMIT 9")
B3_FORMS = ("ROLLUP(k1, k2)", "CUBE(k1, k2)", "GROUPING SETS ((k1), (k2))")


def _b3_text(form):
    return f"SELECT k1, k2, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY {form}"


@pytest.fixture(scope="module")
def port():
    session = TpuSession(carry.conf_from_dict(SETTINGS), device="cpu")
    session.create_or_replace_temp_view("t", session.create_dataframe(
        carry.host_table_from_lanes(_lanes())))
    return session


def _jax_side(out_path: str, jobs) -> None:
    """The JAX package's answers to ``jobs`` (this file run as a
    script): the rows of a QUERIES name or of "order" (ORDER_TEXT), and
    the grouped lane's ``pallasBatches`` for a B3_FORMS text, run with
    the lane forced."""
    if hasattr(os, "sched_setaffinity"):
        # one core each: XLA's thread pools would otherwise contend with
        # the other processes of this side
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[JAX_JOBS.index(tuple(jobs))
                                       % len(cores)]})
    import jax as jax_
    # every compile persists, as tests/conftest.py sets for the tests
    jax_.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.plan import host_table as jhost
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    jax = JSession(JConf(SETTINGS))
    jtypes = {"int": jdt.INT32, "bigint": jdt.INT64, "double": jdt.FLOAT64,
              "string": jdt.STRING}
    lanes = _lanes()
    table = jhost.HostTable([jhost.HostColumn(v, m, jtypes[t])
                             for v, m, t in lanes.values()], list(lanes))
    jax.create_or_replace_temp_view("t", jax.create_dataframe(
        jhost.to_pydict(table), table.schema()))
    out = {"rows": {}, "b3": {}}
    for job in jobs:
        if job not in B3_FORMS:
            text = ORDER_TEXT if job == "order" else QUERIES[job][0]
            out["rows"][job] = jax.sql(text).collect()
            continue
        os.environ["SRT_PALLAS_GROUPED_FORCE"] = "1"
        jax.sql(_b3_text(job)).collect()
        del os.environ["SRT_PALLAS_GROUPED_FORCE"]
        last = jax._last_execution
        nodes, stack = {}, [last["physical"]]
        while stack:
            node = stack.pop()
            nodes[node.exec_id] = node
            stack.extend(node.children)
        out["b3"][job] = sum(
            m["pallasBatches"].value
            for exec_id, m in last["ctx"].metrics.items()
            if "pallasBatches" in m and
            (getattr(nodes[exec_id], "_agg", None) or
             nodes[exec_id]).group_exprs)
    with open(out_path, "w") as f:
        json.dump(out, f)


#: the JAX side's jobs, one process each, balanced by their time
JAX_JOBS = (("rollup", "having_grouping", "order"),
            ("cube", "grouping_sets"),
            ("rollup_plus_plain_key",) + B3_FORMS)


@pytest.fixture(scope="module", autouse=True)
def jax_procs(tmp_path_factory):
    """The JAX side, started before this module's first test: processes
    of their own, whose compile cache works (tests/conftest.py's
    ``_cache_read`` wrapper takes four arguments; this jax passes
    five)."""
    tmp = tmp_path_factory.mktemp("grouping_sets_jax")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        + SUBPROCESS_XLA_FLAGS).strip()
    procs = []
    for i, jobs in enumerate(JAX_JOBS):
        out = str(tmp / f"out{i}.json")
        # stderr to a file: a pipe left unread would stall the process
        err = open(str(tmp / f"err{i}.txt"), "wb")
        procs.append((out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, *jobs],
            env=env, stdout=subprocess.DEVNULL, stderr=err)))
    yield procs
    for _, err, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


@pytest.fixture(scope="module")
def jax_results(jax_procs):
    results = {"rows": {}, "b3": {}}
    for out, err, proc in jax_procs:
        if proc.wait(timeout=600) != 0:
            err.flush()
            with open(err.name, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            pytest.fail(f"JAX side failed (rc {proc.returncode}):\n{tail}")
        with open(out) as f:
            part = json.load(f)
        for key in results:
            results[key].update(part[key])
    return results


def _rows():
    lanes = _lanes()
    return [{c: ((v[i].item() if hasattr(v[i], "item") else v[i])
                 if m[i] else None) for c, (v, m, _) in lanes.items()}
            for i in range(N)]


def _grouped(sets, aggs):
    """Plain Python GROUPING SETS over (k1, k2): one row per group of
    each set, keys absent from the set NULL, then the aggregates of its
    rows and the GROUPING() bits."""
    rows = _rows()
    out = []
    for gset in sets:
        groups = {}
        for r in rows:
            key = tuple(r[k] if k in gset else None for k in ("k1", "k2"))
            groups.setdefault(key, []).append(r)
        for key, members in groups.items():
            bits = tuple(int(k not in gset) for k in ("k1", "k2"))
            out.append(key + tuple(f(members, bits) for f in aggs))
    return out


def _sum(rs, _):
    vs = [r["v"] for r in rs if r["v"] is not None]
    return sum(vs) if vs else None


def _avg(rs, _):
    vs = [r["v"] for r in rs if r["v"] is not None]
    return sum(vs) / len(vs) if vs else None


ROLLUP = [("k1", "k2"), ("k1",), ()]
CUBE = [("k1", "k2"), ("k1",), ("k2",), ()]

#: name -> (SQL, plain Python rows or None when the ORDER BY / LIMIT
#: check below holds it)
QUERIES = {
    "rollup": (
        "SELECT k1, k2, SUM(v) AS s, COUNT(*) AS n, GROUPING(k1) AS g1, "
        "GROUPING(k2) AS g2 FROM t GROUP BY ROLLUP(k1, k2)",
        lambda: _grouped(ROLLUP, [_sum, lambda rs, b: len(rs),
                                  lambda rs, b: b[0],
                                  lambda rs, b: b[1]])),
    "cube": (
        "SELECT k1, k2, AVG(v) AS a, GROUPING(k1) + GROUPING(k2) AS lvl "
        "FROM t GROUP BY CUBE(k1, k2)",
        lambda: _grouped(CUBE, [_avg, lambda rs, b: b[0] + b[1]])),
    "grouping_sets": (
        "SELECT k1, k2, COUNT(v) AS c FROM t "
        "GROUP BY GROUPING SETS ((k1), (k2), ())",
        lambda: _grouped([("k1",), ("k2",), ()], [
            lambda rs, b: sum(r["v"] is not None for r in rs)])),
    "having_grouping": (
        "SELECT k1, k2, SUM(v) AS s FROM t GROUP BY ROLLUP(k1, k2) "
        "HAVING GROUPING(k2) = 1",
        lambda: [r[:3] for r in _grouped(ROLLUP, [
            _sum, lambda rs, b: b[1]]) if r[3] == 1]),
    "rollup_plus_plain_key": (
        "SELECT b, k1, SUM(v) AS s, GROUPING(k1) AS g FROM t "
        "GROUP BY b, ROLLUP(k1)",
        None),
}


def _canon(rows):
    def key(v):
        if v is None or isinstance(v, str):
            return (0, str(v))
        return (2, 0.0) if v != v else (1, float(v))
    return sorted(tuple(key(v) for v in r) for r in rows)


def _close(a, b):
    """Two multisets of rows equal, floats to RTOL."""
    ca, cb = _canon(a), _canon(b)
    if len(ca) != len(cb):
        return False
    return all(x == y or (x[0] == y[0] == 1 and
                          math.isclose(x[1], y[1], rel_tol=RTOL))
               for ra, rb in zip(ca, cb) for x, y in zip(ra, rb))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_grouping_form_matches_jax_and_python(name, port, jax_results):
    text, python = QUERIES[name]
    got = port.sql(text).collect()
    ref = jax_results["rows"][name]
    assert got and list(got[0]) == list(ref[0])
    assert compare_rows(got, ref, [], None, RTOL) is None
    if python is not None:
        assert _close([tuple(r.values()) for r in got], python())


def test_rollup_with_plain_key_matches_python(port):
    """A plain key beside ROLLUP is in every grouping set."""
    got = port.sql(QUERIES["rollup_plus_plain_key"][0]).collect()
    rows = _rows()
    want = []
    for with_k1 in (True, False):
        groups = {}
        for r in rows:
            groups.setdefault((r["b"], r["k1"] if with_k1 else None),
                              []).append(r)
        for (b, k1), rs in groups.items():
            want.append((b, k1, _sum(rs, None), int(not with_k1)))
    assert _close([tuple(r.values()) for r in got], want)


def test_grouping_in_order_by_under_limit(port, jax_results):
    """q36's and q70's shape: ORDER BY a sum of GROUPING() bits, then
    keys that are NULL in the subtotal rows, under a LIMIT."""
    text = ORDER_TEXT
    df = port.sql(text)
    got, ref = df.collect(), jax_results["rows"]["order"]
    keys, limit = order_keys(text, df.columns)
    assert limit == 9 and len(got) == 9
    assert compare_rows(got, ref, keys, limit, RTOL) is None
    want = sorted(_grouped(ROLLUP, [_sum, lambda rs, b: b[0] + b[1]]),
                  key=lambda r: (-r[3], r[0] is not None, r[0] or 0,
                                 r[1] is not None, r[1] or ""))
    assert [r["lvl"] for r in got] == [r[3] for r in want[:9]]
    assert [(r["k1"], r["k2"]) for r in got] == \
        [(r[0], r[1]) for r in want[:9]]


def test_natural_null_key_stays_apart_from_the_subtotal(port):
    got = port.sql("SELECT k1, k2, COUNT(*) AS n, GROUPING(k1) AS g1, "
                   "GROUPING(k2) AS g2 FROM t "
                   "GROUP BY ROLLUP(k1, k2)").collect()
    rows = _rows()
    null_k1 = [r for r in got if r["k1"] is None and r["k2"] is None
               and r["g2"] == 1]
    # the k1 = NULL subtotal over k2, and the grand total
    assert sorted((r["g1"], r["g2"], r["n"]) for r in null_k1) == [
        (0, 1, sum(r["k1"] is None for r in rows)), (1, 1, N)]
    # a natural NULL k2 under each k1 is a group of its own, g2 = 0
    natural = [r for r in got if r["k1"] is not None and r["k2"] is None
               and r["g2"] == 0]
    assert sorted(r["n"] for r in natural) == sorted(
        sum(1 for r in rows if r["k1"] == k and r["k2"] is None)
        for k in {r["k1"] for r in rows if r["k1"] is not None})


def test_expand_unifies_slot_types_and_reuses_plain_columns(port):
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.expr.cast import Cast
    from spark_rapids_tpu_torch.expr.core import Literal, col
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    df = port.table("t")
    plan = L.Expand(df.plan, [[col("k1"), col("k1"), Literal(0)],
                              [col("k1"), col("b"), Literal(1)],
                              [col("k1"), Literal(None, dt.INT32),
                               Literal(2)]],
                    ["k1", "slot", "gid"])
    assert plan.schema == [("k1", dt.INT32), ("slot", dt.INT64),
                           ("gid", dt.INT32)]
    exec_ = apply_overrides(plan, port.conf)
    assert sum(isinstance(e, Cast) for p in exec_.projections
               for e in p) == 2
    ctx = ExecContext(port.conf, port.device)
    source = list(exec_.children[0].execute(ctx))
    out = list(exec_.execute(ctx))
    assert len(out) == 3 * len(source) == 9
    for i, b in enumerate(out):
        src = source[i // 3]
        assert b.columns[0] is src.column("k1")
        assert b.schema() == plan.schema and b.num_rows == src.num_rows
        slot = b.columns[1]
        if i % 3 == 0:
            assert slot.validity.tolist() == \
                src.column("k1").validity.tolist()
            assert slot.data.tolist() == src.column("k1").data.tolist()
        elif i % 3 == 1:
            assert slot.data.tolist() == src.column("b").data.tolist()
        else:
            assert not slot.validity.any()
        assert (b.columns[2].data[:b.num_rows] == i % 3).all()


@pytest.mark.parametrize("form", B3_FORMS)
def test_expanded_groupings_reach_the_grouped_kernel(form, port,
                                                      jax_results):
    """Each projection is a batch of the input's capacity (1,024 rows,
    the lane's floor) with at most 24 groups, so B3 takes every one:
    3 batches x the number of grouping sets, as in the JAX package."""
    n_sets = {"R": 3, "C": 4, "G": 2}[form[0]]
    DK.reset_counts()
    port.sql(_b3_text(form)).collect()
    plain = DK.tile_group_reduce.plain_calls
    port_batches = port._last_execution[1].metric_totals()["pallasBatches"]
    assert plain == port_batches == 3 * n_sets
    assert jax_results["b3"][form] == port_batches


def test_stddev_and_collect_stay_out_of_the_kernel_lanes(port):
    """The variance family and the collects are not sum-decomposable:
    B3's and B1's gates refuse them, grouped and global."""
    for text in ["SELECT k1, STDDEV_SAMP(v) AS sd FROM t GROUP BY k1",
                 "SELECT k1, COUNT(DISTINCT k2) AS c FROM t GROUP BY k1",
                 "SELECT VAR_POP(v) AS vp FROM t",
                 "SELECT COUNT(DISTINCT k1) AS c FROM t"]:
        DK.reset_counts()
        port.sql(text).collect()
        assert DK.tile_group_reduce.plain_calls == 0, text
        assert DK.tile_reduce.plain_calls == 0, text


def test_ordered_float_sums_tie_where_row_sets_are_equal():
    """The float group sums of every device (``_ordered_seg_sum``, over
    rows in group order): within 1e-12 of ``index_add_``, and
    bit-equal for groups over the same rows in the same order whatever
    the other groups and their ids, so a ROLLUP subtotal over one child
    ties with it exactly."""
    import torch
    from spark_rapids_tpu_torch.expr.aggregates import _ordered_seg_sum
    def in_group_order(gid, v):  # as the grouping hands rows over
        gid_s, order = torch.sort(gid, stable=True)
        return v[order], gid_s, torch.zeros(48, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    gid = torch.randint(0, 40, (5003,), generator=gen)
    v = torch.randn(5003, generator=gen, dtype=torch.float64) * 1e3
    got = _ordered_seg_sum(*in_group_order(gid, v))
    ref = torch.zeros(48, dtype=torch.float64).index_add_(0, gid, v)
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-9)
    # the groups above 19 merge into one id: the others keep their bits
    gid2 = torch.where(gid < 20, gid + 7, 3)
    got2 = _ordered_seg_sum(*in_group_order(gid2, v))
    assert torch.equal(got2[7:27], got[:20])
    assert got2[3] == got2[3] and abs(got2[3] - got[20:40].sum()) < 1e-6

if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2:])
