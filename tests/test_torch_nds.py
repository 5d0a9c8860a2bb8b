"""The NDS slice through both packages' ``session.sql`` on the CPU.

- The port's ``register_nds`` tables equal the JAX package's
  ``generate_chunk`` lanes for all 24 tables at 20,000 rows.
- Each query of ``NDS_SLICE``, ``NDS_WINDOW``, ``NDS_ALSO_RUNS``,
  ``NDS_JOINS_SETOPS``, ``NDS_SUBQUERY``, ``NDS_ROLLUP`` and
  ``NDS_FUNCS`` (all 99) runs through the port (one partition, the
  kernels' plain versions) and through the JAX package on the same
  generated data; results match
  (floats to 1e-9, both float64; the rest exactly; ties cut by a LIMIT
  compare on their ORDER BY keys) and the port's rows are in ORDER BY
  order.
- The same queries reach the grouped kernel (B3), and the same reach
  the fused global one (B1), in both packages: the port's batches
  through each lane (its plain calls) against the JAX package's
  ``pallasBatches`` split by lane, with counting wrappers on the JAX
  ``tile_group_reduce`` and ``tile_reduce`` that count per jitted
  program: a query's count holds the kernel calls traced by every
  program it launched, whichever query first traced it.

The JAX side runs in subprocesses of this file (its ``__main__`` block),
eight chunks at once, balanced by their JAX time, each registering the
tables as parquet in a shared directory; they start with the session's
first port test file (tests/test_torch_columnar.py) when the session
runs this file, else before this file's port queries: a JAX compile inside pytest fails on tests/conftest.py's
``_cache_read`` wrapper, and the JAX package's own NDS suite keeps its
queries out of long processes. There the grouped Pallas lane is forced
on (SRT_PALLAS_GROUPED_FORCE=1), except for the queries with no
aggregate, which its gate would send into the kernel with no lane to
sum.
"""

import atexit
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax_reference import SUBPROCESS_XLA_FLAGS, patch_jax_compiles
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.models.nds import (NDS_ALSO_RUNS, NDS_FUNCS,
                                               NDS_JOINS_SETOPS, NDS_QUERIES,
                                               NDS_ROLLUP, NDS_SLICE,
                                               NDS_SUBQUERY, NDS_WINDOW,
                                               nds_specs, register_nds)
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.testing import (compare_rows, order_keys,
                                            sort_rows)

SCALE = 20_000
RTOL = 1e-9
QUERIES = NDS_SLICE + NDS_WINDOW + NDS_ALSO_RUNS + NDS_JOINS_SETOPS + \
    NDS_SUBQUERY + NDS_ROLLUP + NDS_FUNCS
#: the JAX side's chunks, run as concurrent subprocesses, each pinned to
#: a core of its own. With a cold JAX compile cache a chunk takes about
#: 500 s of one core (505-523 s for the seven forced chunks of one run
#: on 8 cores), almost all of it compiling a program per operator shape
#: of each query, at XLA's optimization level 0 (jax_reference.py; 700-
#: 1000 s at the default level); a query's programs are its own, so
#: keeping them across queries saves less than a tenth. The seven
#: forced chunks are balanced by those times, measured per query. The
#: chunks share one persistent cache, so a rerun takes a fraction of
#: that. The last holds the queries that group without an aggregate
#: (q37, q82, the CTEs of q97, the DISTINCT and the existence markers of
#: q10, q35, q41 and q95) and others that never reach the grouped lane,
#: and runs without the forced grouped lane
CHUNKS = (("q14", "q57", "q6", "q83", "q59", "q77", "q69", "q79", "q71",
           "q55", "q25", "q9"),
          ("q4", "q70", "q11", "q45", "q51", "q46", "q43", "q34", "q53", "q1",
           "q42"),
          ("q18", "q36", "q76", "q56", "q86", "q19", "q7", "q33", "q78",
           "q30", "q99", "q93"),
          ("q67", "q38", "q60", "q75", "q27", "q17", "q13", "q61", "q3", "q2",
           "q8", "q68"),
          ("q80", "q66", "q31", "q58", "q20", "q65", "q32", "q48", "q73",
           "q92", "q88", "q28"),
          ("q22", "q47", "q12", "q98", "q23", "q87", "q81", "q50", "q85",
           "q39", "q94", "q16"),
          ("q5", "q74", "q72", "q21", "q49", "q40", "q15", "q44", "q26",
           "q52", "q90", "q54"),
          ("q24", "q29", "q37", "q62", "q63", "q64", "q82", "q84", "q89",
           "q91", "q96", "q97", "q10", "q35", "q41", "q95"))
NO_AGGREGATE = CHUNKS[-1]
#: non-aggregate SELECTs whose ORDER BY mixes an expression with output
#: columns: the JAX analyzer orders them by the output columns first
#: (ROADMAP C4), so its side runs them without their LIMIT and the test
#: orders and cuts its rows
ORDER_FAULT = ("q47", "q57", "q89")
#: a query of the unforced chunk whose GROUP BY the port's grouped lane
#: takes: q41's correlated COUNT(*) groups item by i_manufact, while its
#: DISTINCT sends the forced JAX lane into C4's failure, so its JAX side
#: runs with the grouped lane off and has no B3 batches to compare
UNFORCED_B3 = ("q41",)
TABLES = [s.name for s in nds_specs(SCALE)]


def _lane_batches(physical, metrics) -> dict:
    """The JAX run's ``pallasBatches``: in all, under the grouped lane
    (aggregates with grouping keys, B3) and under the fused global lane
    (B1). A fused pipeline counts its terminal aggregate's batches."""
    nodes, stack = {}, [physical]
    while stack:
        node = stack.pop()
        nodes[node.exec_id] = node
        stack.extend(node.children)
    out = {"pallas_batches": 0, "b3_batches": 0, "b1_batches": 0}
    for exec_id, m in metrics.items():
        if "pallasBatches" not in m:
            continue
        n = m["pallasBatches"].value
        agg = getattr(nodes[exec_id], "_agg", None) or nodes[exec_id]
        lane = "b3_batches" if agg.group_exprs else "b1_batches"
        out[lane] += n
        out["pallas_batches"] += n
    return out


def _count_kernels_per_program(jax, PK, names):
    """Count the JAX kernels per jitted program instead of per trace.

    ``jax.jit`` is wrapped (before any program exists) so that each
    jitted function notes when it is launched and, while it is traced,
    stands on a stack; each of ``names`` in ``PK`` is wrapped to count
    its calls against every program on that stack, or as an eager call
    outside any trace. A query's count of a kernel is then the calls
    traced by the programs it launched, whenever they were traced, plus
    its eager calls: the same per-query count as clearing every cache
    before each query gave, without recompiling each query's programs.
    Returns (start a query, read its counts)."""
    import functools
    import itertools
    ids = itertools.count()
    stack, launched = [], set()
    per_program: dict = {}
    eager = {n: 0 for n in names}
    orig_jit = jax.jit

    class Program:
        def __init__(self, jitted, pid):
            self._jitted, self._pid = jitted, pid

        def __call__(self, *a, **k):
            launched.add(self._pid)
            return self._jitted(*a, **k)

        def __getattr__(self, name):
            return getattr(self._jitted, name)

    def jit(fun=None, *args, **kwargs):
        if fun is None:
            return lambda f: jit(f, *args, **kwargs)
        pid = next(ids)

        @functools.wraps(fun)
        def traced(*a, **k):
            stack.append(pid)
            try:
                return fun(*a, **k)
            finally:
                stack.pop()
        return Program(orig_jit(traced, *args, **kwargs), pid)
    jax.jit = jit

    for name in names:
        orig = getattr(PK, name)

        def counting(*a, _orig=orig, _name=name, **k):
            if stack:
                for pid in set(stack):
                    counts = per_program.setdefault(pid, {})
                    counts[_name] = counts.get(_name, 0) + 1
            else:
                eager[_name] += 1
            return _orig(*a, **k)
        setattr(PK, name, counting)

    def start():
        launched.clear()
        eager.update({n: 0 for n in names})

    def read():
        return {n: eager[n] + sum(per_program.get(p, {}).get(n, 0)
                                  for p in launched) for n in names}
    return start, read


def _jax_chunk(data_dir: str, out_path: str, qids, force: bool,
               core: int) -> None:
    """Run ``qids`` through the JAX package on one core; write {qid:
    {rows, calls, pallas_batches, seconds}} to ``out_path``."""
    if hasattr(os, "sched_setaffinity"):
        # XLA's thread pools would otherwise oversubscribe the cores
        # that the other chunks hold
        os.sched_setaffinity(0, {core})
    if force:
        os.environ["SRT_PALLAS_GROUPED_FORCE"] = "1"
    # shared programs launch through their jit wrappers, which the
    # per-program kernel count sees (the compile ledger would launch
    # its own compiled executables)
    os.environ["SRT_JIT_LEDGER"] = "0"
    import time

    import jax
    from spark_rapids_tpu.ops import pallas_kernels as PK
    start, read = _count_kernels_per_program(
        jax, PK, ("tile_reduce", "tile_group_reduce"))
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.models.nds import register_nds as jregister
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    session = JSession(JConf({"srt.shuffle.partitions": 1}))
    jregister(session, data_dir, scale_rows=SCALE)
    out = {}
    for q in qids:
        t = time.perf_counter()
        start()
        text = NDS_QUERIES[q]
        if q in ORDER_FAULT:
            text = re.sub(r"\bLIMIT\s+\d+\s*$", "", text.rstrip())
        rows = session.sql(text).collect()
        last = session._last_execution
        out[q] = {"rows": rows, "calls": read(),
                  **_lane_batches(last["physical"], last["ctx"].metrics),
                  "seconds": time.perf_counter() - t}
    with open(out_path, "w") as f:
        json.dump(out, f)


#: the running JAX side, once per session: [(output path, stderr file,
#: process)]
_STARTED: list = []


def start_jax_chunks(tmp_path_factory) -> list:
    """Start the JAX chunks, once per session, and return them. A port
    test file that runs before this one starts them while the session
    will run this file (tests/test_torch_columnar.py), so that they
    compile on the cores its single-threaded tests leave idle."""
    if _STARTED:
        return _STARTED
    tmp = tmp_path_factory.mktemp("nds_jax")
    data_dir = str(tmp / "data")
    os.makedirs(data_dir)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        + SUBPROCESS_XLA_FLAGS).strip()
    cores = sorted(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else [0]
    for i, qids in enumerate(CHUNKS):
        out = str(tmp / f"chunk{i}.json")
        force = "0" if qids == NO_AGGREGATE else "1"
        err = open(str(tmp / f"chunk{i}.stderr"), "wb")
        _STARTED.append((out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), data_dir, out,
             ",".join(qids), force, str(cores[i % len(cores)])], env=env,
            stdout=subprocess.DEVNULL,
            stderr=err)))
    # a session that ends before this file's tests ran stops them too
    atexit.register(stop_jax_chunks)
    return _STARTED


def stop_jax_chunks() -> None:
    for _, err, p in _STARTED:
        if p.poll() is None:
            p.kill()
            p.wait()
        err.close()


@pytest.fixture(scope="module")
def jax_procs(tmp_path_factory):
    """The JAX chunks, started: [(output path, stderr file, process)]."""
    yield start_jax_chunks(tmp_path_factory)
    stop_jax_chunks()


@pytest.fixture(scope="module")
def jax_results(jax_procs):
    results = {}
    for out, err, p in jax_procs:
        rc = p.wait(timeout=900)
        err.flush()
        if rc != 0:
            with open(err.name, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            pytest.fail(f"JAX chunk failed (rc {rc}):\n{tail}")
        with open(out) as f:
            results.update(json.load(f))
    return results


@pytest.fixture(scope="module")
def port_tables():
    session = TpuSession(SrtConf(), device="cpu")
    tables = {}
    register_nds(session, SCALE, host_tables=tables)
    return session, tables


@pytest.fixture(scope="module")
def port_results(port_tables, jax_procs):
    """The port's runs, made while the JAX chunks run, on one torch
    thread: the chunks hold a core each, and the port's small batches
    gain nothing from more threads."""
    session, _ = port_tables
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_runs(session)
    finally:
        torch.set_num_threads(threads)


def _port_runs(session):
    out = {}
    for q in QUERIES:
        df = session.sql(NDS_QUERIES[q])
        # counted from here, as the JAX side's pallasBatches is: a scalar
        # subquery (q9, q24) runs, and may launch B1, while the text is
        # analyzed
        DK.reset_counts()
        rows = df.collect()
        metrics = session._last_execution[1].metric_totals()
        out[q] = {"rows": rows, "columns": df.columns,
                  "pallas_batches": metrics.get("pallasBatches", 0),
                  "b1_plain": DK.tile_reduce.plain_calls,
                  "b3_plain": DK.tile_group_reduce.plain_calls}
    return out


@pytest.fixture(scope="module")
def jax_chunks():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.datagen import generate_chunk
        from spark_rapids_tpu.models.nds import nds_specs as jspecs
        yield {s.name: generate_chunk(s, 0, 1 << 18)
               for s in jspecs(SCALE)}


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_jax_datagen(table, port_tables, jax_chunks):
    got, ref = port_tables[1][table], jax_chunks[table]
    assert got.names == ref.names and got.num_rows == ref.num_rows
    for name, g, r in zip(got.names, got.columns, ref.columns):
        assert repr(g.dtype) == repr(r.dtype), name
        np.testing.assert_array_equal(g.mask, r.mask, err_msg=name)
        if repr(g.dtype) == "string":
            # every row's bytes, those under a null included
            want = b"".join(v.encode("utf-8") for v in r.values)
            assert g.values.chars.tobytes() == want, name
            assert list(g.values.to_objects()) == list(r.values), name
        else:
            assert g.values.dtype == r.values.dtype, name
            np.testing.assert_array_equal(g.values, r.values, err_msg=name)


def test_c3_float_formatted_strings(port_tables):
    """The reference draws a non-integral ``uniform`` column as floats
    and formats them, so no store is named 'store7' (q96) and no city
    is 'city1' (q68)."""
    store = port_tables[1]["store"]
    names = store.column("s_store_name").values.to_objects()
    assert "store7" not in set(names)
    assert all("." in n for n in names)


def test_chunks_cover_the_queries():
    flat = [q for chunk in CHUNKS for q in chunk]
    assert sorted(flat) == sorted(QUERIES) and len(set(flat)) == len(flat)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(q, port_results, jax_results):
    got, ref = port_results[q], jax_results[q]["rows"]
    keys, limit = order_keys(NDS_QUERIES[q], got["columns"])
    if q in ORDER_FAULT:
        ref = sort_rows(ref, keys)[:limit]
    if ref:
        assert list(ref[0]) == got["columns"]
    diff = compare_rows(got["rows"], ref, keys, limit, RTOL)
    assert diff is None, f"{q}: {diff}"


@pytest.mark.parametrize("q", QUERIES)
def test_same_queries_reach_the_grouped_kernel(q, port_results,
                                               jax_results):
    """The same queries reach the grouped kernel (B3), and the same
    reach the fused global one (B1), in both packages."""
    port, jax = port_results[q], jax_results[q]
    # the port's plain versions ran once per batch the lanes took
    assert port["b3_plain"] + port["b1_plain"] == port["pallas_batches"]
    if q in UNFORCED_B3:
        # only the fused global lane compares (test_grouped_kernel_queries
        # holds the port's B3 batches)
        assert jax["b3_batches"] == 0 < port["b3_plain"]
        assert (port["b1_plain"] > 0) == (jax["b1_batches"] > 0)
        return
    assert (port["pallas_batches"] > 0) == (jax["pallas_batches"] > 0)
    assert (port["b3_plain"] > 0) == (jax["b3_batches"] > 0)
    assert (port["b1_plain"] > 0) == (jax["b1_batches"] > 0)
    # the JAX lanes' batches went through its kernels (the counts are
    # traces, and the grouped lane's one-time probe counts too, so they
    # hold only one way)
    if jax["b3_batches"]:
        assert jax["calls"]["tile_group_reduce"] > 0
    if jax["b1_batches"]:
        assert jax["calls"]["tile_reduce"] > 0


def test_grouped_kernel_queries(port_results):
    """At this scale B3 takes q3, q15, q43, q52, q55 and q79 of the
    slice (q42's and q19's join outputs are too small for the lane's
    1024-row floor), the GROUP BY under q12's, q20's, q44's and q53's
    windows, q31, q34, q46, q65, q72 and q73, q4, q11, q33, q66 and q74
    of the joins and set operations, the grouped aggregates that q1's,
    q6's and q41's correlated scalar subqueries join to, q23's and q45's
    IN subqueries, q69, the expanded groupings of eight ROLLUP queries
    (q5, q14, q36, q67, q70, q77, q80, q86; not q18, q22 or q27, whose
    joins leave too few rows) and q2's weekly sums."""
    reached = {q for q in QUERIES if port_results[q]["b3_plain"]}
    assert reached == {"q3", "q15", "q43", "q52", "q55", "q79", "q12",
                       "q20", "q44", "q53", "q31", "q34", "q46", "q65",
                       "q72", "q73", "q4", "q11", "q33", "q66", "q74",
                       "q1", "q6", "q23", "q41", "q45", "q69", "q5", "q14",
                       "q36", "q67", "q70", "q77", "q80", "q86", "q2"}


def test_global_kernel_queries(port_results):
    """B1 takes the global aggregates over one-row cross products (q28,
    q61, q90), the COUNT over INTERSECT (q38) and EXCEPT (q87), and the
    global SUMs filtered by subquery predicates (q23, q32, q92)."""
    reached = {q for q in QUERIES if port_results[q]["b1_plain"]}
    assert reached == {"q28", "q61", "q90", "q38", "q87", "q23", "q32",
                       "q92"}


def test_c3_and_empty_joins(port_results):
    """q88's store is named 'store1' and q93's reason 'reason 3', which
    no generated row is (ROADMAP.md C3): q88 counts 0 in every column
    and q93's inner join after its left outer join keeps no row."""
    assert port_results["q88"]["rows"] == [
        {c: 0 for c in port_results["q88"]["columns"]}]
    assert port_results["q93"]["rows"] == []


def test_c3_queries_reach_no_row(port_results):
    assert port_results["q68"]["rows"] == []
    assert port_results["q96"]["rows"] == [{"cnt": 0}]


if __name__ == "__main__":
    _jax_chunk(sys.argv[1], sys.argv[2], sys.argv[3].split(","),
               sys.argv[4] == "1", int(sys.argv[5]))
