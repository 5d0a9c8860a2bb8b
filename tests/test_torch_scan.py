"""The port's file scan and writer on the CPU, held against the JAX
package over the same files: TPC-H q6 / q1 / q3 over the JAX package's
``tpch_tables`` files under each reader type (with the batches each
reader makes, counted at the kernels' plain versions), the JAX
package's partitioned-scan cases (discovery, pruning, the null
partition) and ``input_file_name()`` / ``input_file_block_*``, the CPU
engine's FileScan against the device path, missing and corrupt files
as the JAX package's ``iter_file_tables`` treats them, the writer's
modes and layout, and ``generate_table`` against the JAX package's
files. The JAX side runs its CPU engine (``srt.sql.enabled=false``,
pyarrow and numpy) but for q6 and ``input_file_name()``, which run its
device path, under ``patch_jax_compiles`` (C1).
"""

import os
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.datagen import generate_table
from spark_rapids_tpu_torch.expr import misc as MX
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.io.scan import FileSourceScanExec
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import device_kernels as DK
from spark_rapids_tpu_torch.plan import overrides
from spark_rapids_tpu_torch.plan.session import TpuSession

ROWS = 20_000
READERS = ["COALESCING", "MULTITHREADED", "PERFILE"]
RTOL = 1e-9


def port(device="cpu", **conf):
    return TpuSession(SrtConf(conf), device=device)


@pytest.fixture(scope="module")
def jax_side():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        yield JConf, JSession


@pytest.fixture(scope="module")
def jax_tpch(tmp_path_factory, jax_side):
    """The JAX package's tpch_tables files and its q6 (device path),
    q1 and q3 (CPU engine) over them."""
    JConf, JSession = jax_side
    from spark_rapids_tpu.models import tpch as jtpch
    root = str(tmp_path_factory.mktemp("jax_tpch"))
    dev = jtpch.tpch_tables(JSession(JConf({})), root, ROWS)
    cpu = jtpch.tpch_tables(JSession(JConf({"srt.sql.enabled": False})),
                            root, ROWS)
    return root, {
        "q6": jtpch.q6(dev["lineitem"]).collect(),
        "q1": jtpch.q1(cpu["lineitem"]).collect(),
        "q3": jtpch.q3(cpu["customer"], cpu["orders"],
                       cpu["lineitem"]).collect()}


def _queries(t):
    return {"q6": lambda: tpch.q6(t["lineitem"]),
            "q1": lambda: tpch.q1(t["lineitem"]),
            "q3": lambda: tpch.q3(t["customer"], t["orders"], t["lineitem"])}


def _check_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=RTOL)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("reader", READERS)
def test_tpch_over_the_jax_package_files(jax_tpch, reader):
    root, want = jax_tpch
    t = tpch.tpch_tables(port(**{"srt.sql.format.parquet.reader.type":
                                 reader}), root, ROWS)
    for q, run in _queries(t).items():
        _check_rows(run().collect(), want[q])


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """The port's tpch_tables at 4,096-row files: 5 lineitem files."""
    root = str(tmp_path_factory.mktemp("port_tpch"))
    tpch.tpch_tables(port(), root, ROWS, chunk_rows=4096)
    return root


@pytest.mark.parametrize("reader,batches", [("COALESCING", 3),
                                            ("MULTITHREADED", 5),
                                            ("PERFILE", 5)])
def test_reader_batches_reach_the_kernels(small_files, reader, batches):
    """COALESCING joins files into batches of at least
    srt.sql.reader.batchSizeRows rows (8,192: 4,096 + 4,096 three times
    over 20,000 rows); the others give one batch a file. B1 takes each
    q6 batch and B3 each q1 batch (their plain versions here)."""
    s = port(**{"srt.sql.format.parquet.reader.type": reader,
                "srt.sql.reader.batchSizeRows": 8192})
    t = tpch.tpch_tables(s, small_files, ROWS, chunk_rows=4096)
    assert len(os.listdir(os.path.join(small_files, "lineitem"))) == 5
    DK.reset_counts()
    got6 = tpch.q6(t["lineitem"]).collect()
    assert DK.tile_reduce.plain_calls == batches
    DK.reset_counts()
    got1 = tpch.q1(t["lineitem"]).collect()
    assert DK.tile_group_reduce.plain_calls == batches
    # the same rows as the tables made in memory at the same chunking
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.plan.host_table import concat_tables
    spec = tpch.tpch_table_specs(ROWS)[0]
    ref = port().create_dataframe(concat_tables(
        [generate_chunk(spec, c, 4096) for c in range(5)]))
    _check_rows(got6, tpch.q6(ref).collect())
    _check_rows(got1, tpch.q1(ref).collect())
    metrics = s._last_execution[1].metric_totals()
    assert metrics["scanFiles"] == 5
    assert metrics["scanDecodedBytes"] > 0 and metrics["scanBytesRead"] > 0


def test_q6_reads_only_its_four_columns(small_files):
    t = tpch.tpch_tables(port(), small_files, ROWS, chunk_rows=4096)
    physical = overrides.apply_overrides(tpch.q6(t["lineitem"]).plan,
                                         SrtConf({}))
    scans = []

    def walk(node):
        if isinstance(node, FileSourceScanExec):
            scans.append(node)
        for c in node.children:
            walk(c)
    walk(physical)
    assert [sorted(n for n, _ in s.output_schema) for s in scans] == [
        sorted(["l_quantity", "l_extendedprice", "l_discount",
                "l_shipdate"])]
    assert scans[0].scan.pushed_filter is not None
    # the DataFrame's own plan is left as it was built
    assert len(t["lineitem"].plan.schema) == 9


def test_cpu_engine_file_scan_equals_the_device_path(small_files):
    dev = tpch.tpch_tables(port(), small_files, ROWS, chunk_rows=4096)
    cpu = tpch.tpch_tables(port(**{"srt.sql.enabled": False}), small_files,
                           ROWS, chunk_rows=4096)
    for q in ("q6", "q1", "q3"):
        _check_rows(_queries(cpu)[q]().collect(),
                    _queries(dev)[q]().collect())


# --- partitioned directories (the JAX package's test_partitioned_scan) -----

DATA = {"region": ["eu", "eu", "us", "us", None, "ap"],
        "day": [1, 1, 2, 2, 2, 3],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}
TYPES = [("region", dt.STRING), ("day", dt.INT64), ("v", dt.FLOAT64)]


@pytest.fixture(scope="module")
def table_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ptab") / "t")
    stats = port().create_dataframe(DATA, TYPES).write \
        .partition_by("region", "day").parquet(root)
    assert (stats.num_files, stats.num_rows) == (4, 6)
    return root


def _rows(table):
    return sorted(zip(*(table[k] for k in ("region", "day", "v"))),
                  key=repr)


def test_partition_discovery_against_the_jax_package(table_dir, jax_side):
    JConf, JSession = jax_side
    df = port().read.parquet(table_dir)
    assert df.schema == [("v", dt.FLOAT64), ("region", dt.STRING),
                         ("day", dt.INT64)]
    want = JSession(JConf({"srt.sql.enabled": False})).read \
        .parquet(table_dir).to_pydict()
    assert _rows(df.to_pydict()) == _rows(want)
    assert ("eu", 1, 1.0) in _rows(df.to_pydict())
    assert (None, 2, 5.0) in _rows(df.to_pydict())


@pytest.mark.parametrize("name,cond,pruned", [
    ("eq", lambda: (col("region") == "eu") & (col("v") > 1.0), 3),
    ("ge", lambda: col("day") >= 2, 1),
    ("is_null", lambda: P.IsNull(col("region")), 3),
])
def test_partition_pruning_against_the_jax_package(table_dir, jax_side,
                                                   name, cond, pruned):
    JConf, JSession = jax_side
    from spark_rapids_tpu.expr import col as jcol
    jconds = {"eq": lambda: (jcol("region") == "eu") & (jcol("v") > 1.0),
              "ge": lambda: jcol("day") >= 2,
              "is_null": lambda: jcol("region").is_null()}
    s = port()
    got = s.read.parquet(table_dir).filter(cond()).to_pydict()
    totals = s._last_execution[1].metric_totals()
    assert totals["partitionsPruned"] == pruned
    assert totals["scanFiles"] == 4 - pruned
    want = JSession(JConf({"srt.sql.enabled": False})).read \
        .parquet(table_dir).filter(jconds[name]()).to_pydict()
    assert _rows(got) == _rows(want)
    cpu = port(**{"srt.sql.enabled": False}).read.parquet(table_dir) \
        .filter(cond()).to_pydict()
    assert _rows(cpu) == _rows(got)


def test_input_file_name_against_the_jax_package(table_dir, jax_side):
    JConf, JSession = jax_side
    from spark_rapids_tpu.expr import col as jcol
    from spark_rapids_tpu.expr import misc as JMX
    from spark_rapids_tpu.expr.core import Alias as JAlias
    from spark_rapids_tpu_torch.expr.core import Alias
    s = port()   # COALESCING by default: the planner forces PERFILE
    df = s.read.parquet(table_dir).select(
        col("v"), Alias(MX.input_file_name(), "f"),
        Alias(MX.input_file_block_start(), "start"),
        Alias(MX.input_file_block_length(), "length"))
    got = df.collect()
    want = JSession(JConf({})).read.parquet(table_dir).select(
        jcol("v"), JAlias(JMX.input_file_name(), "f"),
        JAlias(JMX.input_file_block_start(), "start"),
        JAlias(JMX.input_file_block_length(), "length")).collect()
    assert sorted(got, key=repr) == sorted(want, key=repr)
    per_file = {}
    for r in got:
        path = r["f"]
        per_file[path] = per_file.get(path, 0) + 1
        assert r["start"] == 0
        assert r["length"] == os.path.getsize(path)
    assert per_file == {p: pq.ParquetFile(p).metadata.num_rows
                        for p in per_file}


# --- missing and corrupt files -------------------------------------------------

@pytest.fixture()
def broken(tmp_path):
    """Three files of 100 rows (one a write job), sorted by name."""
    root = str(tmp_path / "t")
    s = port()
    for k in range(3):
        s.create_dataframe({"k": list(range(k * 100, k * 100 + 100))},
                           [("k", dt.INT64)]).write.mode("append") \
            .parquet(root)
    files = sorted(os.path.join(root, f) for f in os.listdir(root))
    return root, files


@pytest.mark.parametrize("fault", ["corrupt", "missing"])
def test_faulty_files_against_the_jax_package(broken, jax_side, fault):
    """A truncated and a deleted file: by default each raises naming its
    path, under each reader; under srt.sql.ignoreCorruptFiles /
    ignoreMissingFiles it is skipped, on the device path and the CPU
    engine, as the JAX package's iter_file_tables skips it."""
    JConf, _ = jax_side
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.io.scan import read_file_to_tables as jax_read
    root, files = broken
    key = "srt.sql.ignoreCorruptFiles" if fault == "corrupt" else \
        "srt.sql.ignoreMissingFiles"
    df = port().read.parquet(root)
    lost = set(pq.read_table(files[1]).column("k").to_pylist())
    if fault == "corrupt":
        raw = open(files[1], "rb").read()
        with open(files[1], "wb") as f:
            f.write(raw[:len(raw) // 2])
        errors = (ValueError, EOFError, OSError)
    else:
        os.remove(files[1])
        errors = (FileNotFoundError,)
    name = os.path.basename(files[1])
    for reader in READERS:
        with pytest.raises(errors, match=name):
            port(**{"srt.sql.format.parquet.reader.type": reader}) \
                .execute(df.plan)
    with pytest.raises(errors, match=name):
        port(**{"srt.sql.enabled": False}).execute(df.plan)
    with pytest.raises(errors, match=name):
        jax_read(files[1], "parquet", [("k", jdt.INT64)], {}, None, 1 << 20,
                 JConf({key: False}))
    want = sorted(set(range(300)) - lost)
    theirs = [v for p in files for t in jax_read(
        p, "parquet", [("k", jdt.INT64)], {}, None, 1 << 20,
        JConf({key: True})) for v in t.columns[0].values.tolist()]
    assert sorted(theirs) == want
    for reader in READERS:
        got = port(**{key: True, "srt.sql.format.parquet.reader.type":
                      reader}).execute(df.plan).columns[0].values.tolist()
        assert sorted(got) == want
    cpu = port(**{key: True, "srt.sql.enabled": False}).execute(df.plan)
    assert sorted(cpu.columns[0].values.tolist()) == want


# --- the writer -------------------------------------------------------------------

def test_writer_modes_and_stats(tmp_path):
    s = port()
    root = str(tmp_path / "w")
    df = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
    assert df.write.parquet(root).num_rows == 3
    with pytest.raises(FileExistsError):
        df.write.parquet(root)
    assert df.write.mode("ignore").parquet(root).num_files == 0
    df.write.mode("append").parquet(root)
    assert sorted(s.read.parquet(root).to_pydict()["a"]) == [1, 1, 2, 2, 3, 3]
    st = df.write.mode("overwrite").option("compression", "none") \
        .parquet(root)
    assert (st.num_files, st.num_rows, st.partitions) == (1, 3, ["."])
    assert st.num_bytes == sum(os.path.getsize(os.path.join(root, f))
                               for f in os.listdir(root))
    assert sorted(s.read.parquet(root).to_pydict()["a"]) == [1, 2, 3]
    with pytest.raises(ValueError):
        df.write.mode("upsert")
    # ORC reads and writes now (tests/test_torch_orc.py)
    for fmt in ("csv", "json"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(s.read, fmt)(root)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(df.write, fmt)(root)


def test_declared_schema_renames_and_widens(tmp_path):
    s = port()
    root = str(tmp_path / "w")
    s.create_dataframe({"a": [1, None, 3], "b": ["x", "y", None]},
                       [("a", dt.INT32), ("b", dt.STRING)]).write.parquet(root)
    got = s.read.parquet(root, schema=[("n", dt.INT64), ("s", dt.STRING)]) \
        .to_pydict()
    assert got == {"n": [1, None, 3], "s": ["x", "y", None]}
    with pytest.raises(ValueError, match="declared"):
        s.read.parquet(root, schema=[("a", dt.STRING)]).to_pydict()


def test_generate_table_equals_the_jax_package_files(tmp_path, jax_side):
    from spark_rapids_tpu.datagen import generate_table as jgen
    from spark_rapids_tpu.datagen import lineitem_spec as jspec
    from spark_rapids_tpu_torch.datagen import lineitem_spec
    ours = generate_table(None, lineitem_spec(10_000),
                          str(tmp_path / "port"), 4096)
    theirs = jgen(None, jspec(10_000), str(tmp_path / "jax"), 4096)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert pq.read_table(a).equals(pq.read_table(b))
    shutil.rmtree(str(tmp_path / "port"))


ESCAPED = ["a/b", "x=y", "50%", "", None, "plain", "é:1"]


def test_partition_values_escape_and_round_trip(tmp_path, jax_side):
    """C25. Partition values go into directory names as Spark's
    ExternalCatalogUtils.escapePathName writes them (NULL and '' as
    __HIVE_DEFAULT_PARTITION__, '/', '=', '%', ':' as %XX) and read
    back exactly, '' as NULL (Spark's rule), through the hive layout and
    through a standard Delta table's partitionValues. The JAX package
    writes 'a/b' as two directory levels and reads it back as 'a'."""
    types = [("p", dt.STRING), ("v", dt.INT64)]
    data = {"p": ESCAPED, "v": list(range(len(ESCAPED)))}
    s = port()
    root = str(tmp_path / "hive")
    s.create_dataframe(data, types).write.partition_by("p").parquet(root)
    assert sorted(os.listdir(root)) == sorted(
        ["p=a%2Fb", "p=x%3Dy", "p=50%25", "p=__HIVE_DEFAULT_PARTITION__",
         "p=plain", "p=é%3A1"])
    # plain Python: '' reads back as NULL, every other value exactly
    want = [((None if p == "" else p), v)
            for p, v in zip(ESCAPED, data["v"])]
    got = s.read.parquet(root).to_pydict()
    assert sorted(zip(got["p"], got["v"]), key=repr) == sorted(want,
                                                               key=repr)
    delta_root = str(tmp_path / "delta")
    s.create_dataframe(data, types).write.partition_by("p").delta(delta_root)
    got = s.read.delta(delta_root).to_pydict()
    assert sorted(zip(got["p"], got["v"]), key=repr) == sorted(want,
                                                               key=repr)
    JConf, JSession = jax_side
    js = JSession(JConf({"srt.sql.enabled": False}))
    jroot = str(tmp_path / "jax")
    js.create_dataframe(data, [("p", jax_dtype("STRING")),
                               ("v", jax_dtype("INT64"))]) \
        .write.partition_by("p").parquet(jroot)
    assert os.path.isdir(os.path.join(jroot, "p=a", "b"))
    jgot = JSession(JConf({"srt.sql.enabled": False})).read \
        .parquet(jroot).to_pydict()
    assert "a/b" not in jgot["p"]


def jax_dtype(name):
    from spark_rapids_tpu.columnar import dtypes as jdt
    return getattr(jdt, name)
