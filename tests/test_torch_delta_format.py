"""The port's standard Delta format (io/delta_format.py) held against the
JAX package's: the cases of tests/test_delta_format.py through both
packages (log replay, partition values from add actions, time travel,
schema strings, the minReaderVersion check, writes in the standard
layout), a table the port wrote read by the JAX package's reader and
the reverse. The port reads no Parquet checkpoint (ROADMAP A7.3): a
replay that needs one raises NotImplementedError, and a version before
it still reads. pyarrow writes the hand-built tables' data files, as in
the JAX package's tests; the JAX side runs its CPU engine under
``patch_jax_compiles`` (C1).
"""

import importlib
import json
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from jax_reference import patch_jax_compiles

SCHEMA_STRING = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "string", "nullable": True, "metadata": {}},
    {"name": "v", "type": "long", "nullable": True, "metadata": {}},
    {"name": "d", "type": "decimal(10,2)", "nullable": True,
     "metadata": {}},
]})


class Pkg:
    def __init__(self, root: str):
        def m(sub):
            return importlib.import_module(f"{root}.{sub}")
        self.port = root == "spark_rapids_tpu_torch"
        self.dt = m("columnar.dtypes")
        self.fmt = m("io.delta_format")
        session = m("plan.session").TpuSession
        conf = m("conf").SrtConf
        self.session = session(conf({}), device="cpu") if self.port else \
            session(conf({"srt.sql.enabled": False}))


PORT = Pkg("spark_rapids_tpu_torch")


@pytest.fixture(scope="module")
def jax_pkg():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        import spark_rapids_tpu  # noqa: F401  (x64 and the jax config)
        yield Pkg("spark_rapids_tpu")


@pytest.fixture(params=["port", "jax"])
def pkg(request, jax_pkg):
    return PORT if request.param == "port" else jax_pkg


def _commit(log_dir, version, actions):
    with open(os.path.join(log_dir, f"{version:020d}.json"), "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")


def _external_table(root):
    """Hand-built table in the standard layout (as Spark/delta-rs would
    write it): v0 = f1+f2, v1 = remove f2, add f3."""
    os.makedirs(os.path.join(root, "_delta_log"))
    pq.write_table(pa.table({"v": [1, 2]}), os.path.join(root, "f1.parquet"))
    pq.write_table(pa.table({"v": [3]}), os.path.join(root, "f2.parquet"))
    pq.write_table(pa.table({"v": [4, 5]}), os.path.join(root, "f3.parquet"))
    meta = {"metaData": {
        "id": "t1", "format": {"provider": "parquet", "options": {}},
        "schemaString": json.dumps({"type": "struct", "fields": [
            {"name": "k", "type": "string", "nullable": True,
             "metadata": {}},
            {"name": "v", "type": "long", "nullable": True,
             "metadata": {}}]}),
        "partitionColumns": ["k"], "configuration": {}}}
    _commit(os.path.join(root, "_delta_log"), 0, [
        {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
        meta,
        {"add": {"path": "f1.parquet", "partitionValues": {"k": "a"},
                 "size": 1, "modificationTime": 0, "dataChange": True}},
        {"add": {"path": "f2.parquet", "partitionValues": {"k": "b"},
                 "size": 1, "modificationTime": 0, "dataChange": True}},
    ])
    _commit(os.path.join(root, "_delta_log"), 1, [
        {"remove": {"path": "f2.parquet", "deletionTimestamp": 1,
                    "dataChange": True}},
        {"add": {"path": "f3.parquet", "partitionValues": {"k": "c"},
                 "size": 1, "modificationTime": 1, "dataChange": True}},
    ])
    return root


def _kv(df):
    return sorted((r["k"], r["v"]) for r in df.collect())


def test_schema_string_roundtrip(pkg):
    dt = pkg.dt
    schema = pkg.fmt.schema_from_string(SCHEMA_STRING)
    assert schema == [("k", dt.STRING), ("v", dt.INT64),
                      ("d", dt.DecimalType(10, 2))]
    assert pkg.fmt.schema_from_string(pkg.fmt.schema_to_string(schema)) \
        == schema


def test_schema_strings_equal_jax(jax_pkg):
    for text in (SCHEMA_STRING, jax_pkg.fmt.schema_to_string(
            jax_pkg.fmt.schema_from_string(SCHEMA_STRING))):
        port = PORT.fmt.schema_from_string(text)
        assert PORT.fmt.schema_to_string(port) == \
            jax_pkg.fmt.schema_to_string(
                jax_pkg.fmt.schema_from_string(text))


def test_read_external_table_with_partition_values(pkg, tmp_path):
    root = _external_table(str(tmp_path / "t"))
    df = pkg.session.read.delta(root)
    assert _kv(df) == [("a", 1), ("a", 2), ("c", 4), ("c", 5)]


def test_time_travel(pkg, tmp_path):
    root = _external_table(str(tmp_path / "t"))
    v0 = pkg.session.read.delta(root, version_as_of=0)
    assert _kv(v0) == [("a", 1), ("a", 2), ("b", 3)]
    t = pkg.fmt.DeltaFormatTable(root)
    assert t.version == 1 and t.partition_columns == ["k"]


def test_parquet_checkpoint(jax_pkg, tmp_path):
    """A checkpoint at v1 and a later v2 that adds f2 back: the JAX
    package replays from the checkpoint; the port raises naming A7.3,
    and both read version 0 (before the checkpoint) from the JSON."""
    root = _external_table(str(tmp_path / "t"))
    log_dir = os.path.join(root, "_delta_log")
    t = jax_pkg.fmt.DeltaFormatTable(root)
    ckpt_meta = {k: v for k, v in t.metadata.items()
                 if k not in ("format", "configuration")}
    rows = [{"metaData": ckpt_meta, "add": None}]
    for a in t.adds:
        rows.append({"metaData": None, "add": a})
    pq.write_table(pa.Table.from_pylist(rows),
                   os.path.join(log_dir, f"{1:020d}.checkpoint.parquet"))
    with open(os.path.join(log_dir, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1, "size": len(rows)}, f)
    _commit(log_dir, 2, [
        {"add": {"path": "f2.parquet", "partitionValues": {"k": "b"},
                 "size": 1, "modificationTime": 2, "dataChange": True}}])
    assert sorted(r["v"] for r in jax_pkg.session.read.delta(root)
                  .collect()) == [1, 2, 3, 4, 5]
    for version in (None, 1, 2):
        with pytest.raises(NotImplementedError, match="A7.3"):
            PORT.session.read.delta(root, version_as_of=version)
    for pkg in (PORT, jax_pkg):
        v0 = pkg.session.read.delta(root, version_as_of=0)
        assert sorted(r["v"] for r in v0.collect()) == [1, 2, 3]


def test_write_and_roundtrip(pkg, tmp_path):
    s = pkg.session
    root = str(tmp_path / "w")
    df = s.create_dataframe({"k": ["x", "x", "y"], "v": [1, 2, 3]},
                            [("k", pkg.dt.STRING), ("v", pkg.dt.INT64)])
    assert df.write.partition_by("k").delta(root) == 0
    assert os.path.exists(os.path.join(root, "_delta_log",
                                       f"{0:020d}.json"))
    assert _kv(s.read.delta(root)) == [("x", 1), ("x", 2), ("y", 3)]
    df2 = s.create_dataframe({"k": ["z"], "v": [9]},
                             [("k", pkg.dt.STRING), ("v", pkg.dt.INT64)])
    assert df2.write.mode("append").partition_by("k").delta(root) == 1
    assert sorted(r["v"] for r in s.read.delta(root).collect()) == \
        [1, 2, 3, 9]
    assert df2.write.mode("overwrite").partition_by("k").delta(root) == 2
    assert [r["v"] for r in s.read.delta(root).collect()] == [9]
    assert sorted(r["v"] for r in
                  s.read.delta(root, version_as_of=1).collect()) \
        == [1, 2, 3, 9]


def test_unsupported_reader_version(pkg, tmp_path):
    root = str(tmp_path / "t3")
    os.makedirs(os.path.join(root, "_delta_log"))
    _commit(os.path.join(root, "_delta_log"), 0, [
        {"protocol": {"minReaderVersion": 3, "minWriterVersion": 7}},
        {"metaData": {"id": "x", "schemaString": SCHEMA_STRING,
                      "partitionColumns": [],
                      "format": {"provider": "parquet", "options": {}},
                      "configuration": {}}}])
    with pytest.raises(pkg.fmt.DeltaFormatError, match="minReaderVersion"):
        pkg.session.read.delta(root)


def _typed_rows(pkg):
    s, dt = pkg.session, pkg.dt
    schema = [("p", dt.INT64), ("name", dt.STRING), ("x", dt.FLOAT64),
              ("q", dt.STRING)]
    return s.create_dataframe(
        {"p": [1, 1, 2, None, 2], "name": ["a", None, "ü", "d", ""],
         "x": [1.5, -0.0, None, 2.25, 1e300], "q": ["u", "v", "u", "v", None]},
        schema)


def _rows(df):
    return sorted((tuple(r.values()) for r in df.collect()),
                  key=lambda r: [(v is None, v if v is not None else 0)
                                 for v in r])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_read(jax_pkg, tmp_path, writer):
    """A table one package wrote, partitioned by an integral column with
    a NULL partition and by a string column, then overwritten, read by
    the other at the head and at version 0."""
    w, r = (PORT, jax_pkg) if writer == "port" else (jax_pkg, PORT)
    root = str(tmp_path / "t")
    df = _typed_rows(w)
    assert df.write.partition_by("p", "q").delta(root) == 0
    first = _rows(w.session.read.delta(root))
    head = w.session.create_dataframe(
        {"p": [7], "name": ["z"], "x": [0.5], "q": ["w"]}, df.schema)
    assert head.write.mode("overwrite").partition_by("p", "q") \
        .delta(root) == 1
    assert _rows(r.session.read.delta(root, version_as_of=0)) == first
    assert _rows(r.session.read.delta(root)) == \
        _rows(w.session.read.delta(root)) == [(7, "z", 0.5, "w")]
    assert [n for n, _ in r.session.read.delta(root).schema] == \
        ["p", "name", "x", "q"]
    assert len(first) == 5
