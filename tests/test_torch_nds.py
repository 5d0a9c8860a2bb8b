"""The NDS slice through both packages' ``session.sql`` on the CPU.

- The port's ``register_nds`` tables equal the JAX package's
  ``generate_chunk`` lanes for all 24 tables at 20,000 rows.
- Each query of ``NDS_SLICE`` runs through the port (one partition, the
  kernels' plain versions) and through the JAX package on the same
  generated data; results match (floats to 1e-9, both float64; the rest
  exactly; ties cut by a LIMIT compare on their ORDER BY keys) and the
  port's rows are in ORDER BY order.
- The same queries reach the grouped kernel (B3) in both packages: the
  port's ``pallasBatches`` against the JAX package's, with a counting
  wrapper on the JAX ``tile_group_reduce``.

The JAX side runs in subprocesses of this file (its ``__main__`` block),
four chunks at once, each registering the tables as parquet in a shared
directory: a JAX compile inside pytest fails on tests/conftest.py's
``_cache_read`` wrapper, and the JAX package's own NDS suite keeps its
queries out of long processes. There the grouped Pallas lane is forced
on (SRT_PALLAS_GROUPED_FORCE=1), except for the queries with no
aggregate, which its gate would send into the kernel with no lane to
sum.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.models.nds import (NDS_QUERIES, NDS_SLICE,
                                               nds_specs, register_nds)
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.testing import compare_rows, order_keys

SCALE = 20_000
RTOL = 1e-9
#: the JAX side's chunks, run as concurrent subprocesses; the last holds
#: the queries that group without an aggregate and runs without the
#: forced grouped lane
CHUNKS = (("q3", "q7", "q15", "q19", "q21", "q25"),
          ("q26", "q40", "q42", "q43", "q48", "q52"),
          ("q55", "q62", "q68", "q79", "q96", "q99"),
          ("q37", "q82"))
NO_AGGREGATE = CHUNKS[-1]
TABLES = [s.name for s in nds_specs(SCALE)]


def _jax_chunk(data_dir: str, out_path: str, qids, force: bool) -> None:
    """Run ``qids`` through the JAX package; write {qid: {rows, calls,
    pallas_batches}} to ``out_path``."""
    if force:
        os.environ["SRT_PALLAS_GROUPED_FORCE"] = "1"
    import jax
    from spark_rapids_tpu import jit_registry
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.models.nds import register_nds as jregister
    from spark_rapids_tpu.ops import pallas_kernels as PK
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    calls = {"tile_reduce": 0, "tile_group_reduce": 0}
    for name in calls:
        orig = getattr(PK, name)

        def counting(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        setattr(PK, name, counting)
    session = JSession(JConf({"srt.shuffle.partitions": 1}))
    jregister(session, data_dir, scale_rows=SCALE)
    out = {}
    for q in qids:
        # programs traced by an earlier query would skip the wrappers
        jax.clear_caches()
        jit_registry.clear()
        calls.update({k: 0 for k in calls})
        rows = session.sql(NDS_QUERIES[q]).collect()
        metrics = session._last_execution["ctx"].metrics
        pb = sum(m["pallasBatches"].value for m in metrics.values()
                 if "pallasBatches" in m)
        out[q] = {"rows": rows, "calls": dict(calls), "pallas_batches": pb}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nds_jax")
    data_dir = str(tmp / "data")
    os.makedirs(data_dir)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = []
    for i, qids in enumerate(CHUNKS):
        out = str(tmp / f"chunk{i}.json")
        force = "0" if qids == NO_AGGREGATE else "1"
        err = open(str(tmp / f"chunk{i}.stderr"), "wb")
        procs.append((out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), data_dir, out,
             ",".join(qids), force], env=env, stdout=subprocess.DEVNULL,
            stderr=err)))
    results = {}
    try:
        for out, err, p in procs:
            rc = p.wait(timeout=600)
            err.close()
            if rc != 0:
                with open(err.name, "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
                pytest.fail(f"JAX chunk failed (rc {rc}):\n{tail}")
            with open(out) as f:
                results.update(json.load(f))
    finally:
        for _, err, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    return results


@pytest.fixture(scope="module")
def port_tables():
    session = TpuSession(SrtConf(), device="cpu")
    tables = {}
    register_nds(session, SCALE, host_tables=tables)
    return session, tables


@pytest.fixture(scope="module")
def port_results(port_tables):
    session, _ = port_tables
    out = {}
    for q in NDS_SLICE:
        DK.reset_counts()
        df = session.sql(NDS_QUERIES[q])
        rows = df.collect()
        metrics = session._last_execution[1].metric_totals()
        out[q] = {"rows": rows, "columns": df.columns,
                  "pallas_batches": metrics.get("pallasBatches", 0),
                  "b3_plain": DK.tile_group_reduce.plain_calls}
    return out


@pytest.fixture(scope="module")
def jax_chunks():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
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


@pytest.mark.parametrize("q", NDS_SLICE)
def test_query_matches_jax(q, port_results, jax_results):
    got, ref = port_results[q], jax_results[q]["rows"]
    keys, limit = order_keys(NDS_QUERIES[q], got["columns"])
    if ref:
        assert list(ref[0]) == got["columns"]
    diff = compare_rows(got["rows"], ref, keys, limit, RTOL)
    assert diff is None, f"{q}: {diff}"


@pytest.mark.parametrize("q", NDS_SLICE)
def test_same_queries_reach_the_grouped_kernel(q, port_results,
                                               jax_results):
    port, jax = port_results[q], jax_results[q]
    # the port's plain version ran once per batch the lane took
    assert port["b3_plain"] == port["pallas_batches"]
    assert (port["pallas_batches"] > 0) == (jax["pallas_batches"] > 0)
    if jax["pallas_batches"]:
        assert jax["calls"]["tile_group_reduce"] > 0


def test_grouped_kernel_queries(port_results):
    """At this scale B3 takes q3, q15, q43, q52, q55 and q79; q42's and
    q19's join outputs are too small for the lane's 1024-row floor."""
    reached = {q for q in NDS_SLICE if port_results[q]["pallas_batches"]}
    assert reached == {"q3", "q15", "q43", "q52", "q55", "q79"}


def test_c3_queries_reach_no_row(port_results):
    assert port_results["q68"]["rows"] == []
    assert port_results["q96"]["rows"] == [{"cnt": 0}]


if __name__ == "__main__":
    _jax_chunk(sys.argv[1], sys.argv[2], sys.argv[3].split(","),
               sys.argv[4] == "1")
