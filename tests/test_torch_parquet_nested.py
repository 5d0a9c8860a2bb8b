"""Nested Parquet columns (LIST, STRUCT, MAP and their legacy forms),
INT96 timestamps and BYTE_ARRAY decimals through the port's reader and
writer, held against the JAX package and pyarrow.

Files pyarrow writes (v1 and v2 data pages, with and without
dictionaries, several row groups) read through the port equal to the JAX
package's reading of them, with NULL at every level: a null list, an
empty one and a null element stay apart, as do a null struct and one
whose fields are all null. Files the port writes read back identically
through pyarrow and through the port. The legacy two-level lists and an
un-annotated repeated field (LogicalTypes.md's backward-compatibility
rules) read as pyarrow reads them. The JAX side reads through pyarrow
(its CPU engine, ``srt.sql.enabled=false``) under ``patch_jax_compiles``
(C1).
"""

import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.io import parquet_nested as PN
from spark_rapids_tpu_torch.io import thrift as T
from spark_rapids_tpu_torch.io.native_parquet import file_schema
from spark_rapids_tpu_torch.plan.session import TpuSession

ROWS = 600


def port():
    return TpuSession(SrtConf({}), device="cpu")


@pytest.fixture(scope="module")
def jax_session():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        yield JSession(JConf({"srt.sql.enabled": False}))


def _maybe(rng, v, p=0.15):
    return None if rng.random() < p else v


def nested_table(seed=11, n=ROWS) -> pa.Table:
    """Seeded rows with NULL at every level of every nested type."""
    rng = np.random.default_rng(seed)

    def ints(k):
        return [_maybe(rng, int(x)) for x in rng.integers(-50, 50, k)]

    def strs(k):
        return [_maybe(rng, "é" * int(x) + str(x))
                for x in rng.integers(0, 4, k)]

    cols = {
        "l": [_maybe(rng, ints(int(rng.integers(0, 4)))) for _ in range(n)],
        "ll": [_maybe(rng, [_maybe(rng, ints(int(rng.integers(0, 3))))
                            for _ in range(int(rng.integers(0, 3)))])
               for _ in range(n)],
        "st": [_maybe(rng, {"x": _maybe(rng, int(rng.integers(0, 9))),
                            "y": _maybe(rng, str(rng.integers(0, 9))),
                            "z": _maybe(rng, ints(int(rng.integers(0, 3))))})
               for _ in range(n)],
        "m": [_maybe(rng, [(f"k{j}", _maybe(rng, float(rng.uniform())))
                           for j in range(int(rng.integers(0, 4)))])
              for _ in range(n)],
        "ls": [_maybe(rng, [_maybe(rng, {"a": _maybe(rng, float(x)),
                                         "b": _maybe(rng, "s" + str(x))})
                            for x in rng.integers(0, 9, int(rng.integers(0, 3)))])
               for _ in range(n)],
        "sl": [_maybe(rng, strs(int(rng.integers(0, 4)))) for _ in range(n)],
        "k": list(range(n)),
    }
    types = {
        "l": pa.list_(pa.int64()), "ll": pa.list_(pa.list_(pa.int32())),
        "st": pa.struct([("x", pa.int64()), ("y", pa.string()),
                         ("z", pa.list_(pa.int64()))]),
        "m": pa.map_(pa.string(), pa.float64()),
        "ls": pa.list_(pa.struct([("a", pa.float64()), ("b", pa.string())])),
        "sl": pa.list_(pa.string()), "k": pa.int64(),
    }
    # the special cases of each level, first
    cols["l"][:4] = [None, [], [None], [1, None]]
    cols["st"][:3] = [None, {"x": None, "y": None, "z": None},
                      {"x": None, "y": None, "z": []}]
    cols["m"][:3] = [None, [], [("a", None)]]
    cols["ll"][:4] = [None, [], [None], [[]]]
    t = pa.table({c: pa.array(v, types[c]) for c, v in cols.items()})
    # a required struct of an optional field: one definition level
    rs = pa.struct([("a", pa.int64())])
    return t.append_column(pa.field("rs", rs, nullable=False), pa.array(
        [{"a": _maybe(rng, int(x))} for x in rng.integers(0, 9, n)], rs))


def _norm(v):
    """Python values as both packages give them: maps as sorted pairs,
    timestamps without a zone."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, list):
        if v and all(isinstance(e, tuple) and len(e) == 2 for e in v):
            return sorted((k, _norm(x)) for k, x in v)
        return [_norm(x) for x in v]
    if isinstance(v, datetime.datetime):
        return v.replace(tzinfo=None)
    return v


def _rows(d, mapcols=("m",)):
    out = {}
    for c, vals in d.items():
        out[c] = [None if v is None else
                  (sorted((k, _norm(x)) for k, x in
                          (v.items() if isinstance(v, dict) else v))
                   if c in mapcols else _norm(v)) for v in vals]
    return out


@pytest.mark.parametrize("layout", ["v1_dict", "v2_plain"])
def test_pyarrow_nested_files_read_as_the_jax_package(tmp_path, jax_session,
                                                      layout):
    t = nested_table()
    path = str(tmp_path / "n.parquet")
    pq.write_table(t, path, row_group_size=250,
                   data_page_version="1.0" if layout == "v1_dict" else "2.0",
                   use_dictionary=layout == "v1_dict")
    assert [n for n, _ in file_schema(path)] == t.column_names
    got = port().read.parquet(path).to_pydict()
    jax = jax_session.read.parquet(path).to_pydict()
    want = _rows(t.to_pydict())
    assert _rows(got) == want
    assert _rows(jax) == want
    s = port()
    assert file_schema(path)[3][1] == dt.MapType(dt.STRING, dt.FLOAT64)
    # three different things at each level
    assert got["l"][:4] == [None, [], [None], [1, None]]
    assert got["st"][:2] == [None, {"x": None, "y": None, "z": None}]
    assert got["ll"][:4] == [None, [], [None], [[]]]
    # the nested lanes reach the operators: a projection and a filter
    rows = s.read.parquet(path).filter(col("k") < 4).select(col("l")) \
        .collect()
    assert [r["l"] for r in rows] == [None, [], [None], [1, None]]


def test_port_written_nested_reads_back_through_pyarrow(tmp_path):
    t = nested_table(seed=12)
    src = str(tmp_path / "src.parquet")
    pq.write_table(t, src)
    s = port()
    out = str(tmp_path / "out")
    s.read.parquet(src).write.option("rowGroupRows", 200) \
        .option("compression", "zstd").parquet(out)
    back = pq.read_table(out)
    assert back.num_rows == t.num_rows
    assert _rows(back.to_pydict()) == _rows(t.to_pydict())
    assert _rows(s.read.parquet(out).to_pydict()) == _rows(t.to_pydict())
    assert pq.ParquetFile(os.path.join(out, os.listdir(out)[0])) \
        .metadata.num_row_groups == 3


def _legacy_elements(name, t, path=()):
    """The legacy two-level and un-annotated forms the writer declares
    for the columns named ``two_level_*`` and ``repeated``."""
    if name == "repeated":
        el = T.SchemaElement(name=name, type=T.INT32,
                             repetition_type=T.REPEATED)
        return [el], [[name]]
    if name == "two_level_prim":
        return ([T.SchemaElement(name=name, repetition_type=T.OPTIONAL,
                                 num_children=1, converted_type=T.LIST),
                 T.SchemaElement(name="element", type=T.INT64,
                                 repetition_type=T.REPEATED)],
                [[name, "element"]])
    if name == "two_level_array":
        return ([T.SchemaElement(name=name, repetition_type=T.OPTIONAL,
                                 num_children=1, converted_type=T.LIST),
                 T.SchemaElement(name="array", repetition_type=T.REPEATED,
                                 num_children=1),
                 T.SchemaElement(name="x", type=T.INT64,
                                 repetition_type=T.OPTIONAL)],
                [[name, "array", "x"]])
    return ORIGINAL(name, t, path)


ORIGINAL = PN.writer_elements


def test_legacy_list_forms_read_as_pyarrow(tmp_path, monkeypatch):
    """LogicalTypes.md's backward-compatibility rules: a repeated
    primitive inside LIST is the element, a repeated group named
    ``array`` is the element (a struct), a repeated field outside LIST
    is a required list of required elements."""
    monkeypatch.setattr(PN, "writer_elements", _legacy_elements)
    data = {"repeated": [[1, 2], [], [3]],
            "two_level_prim": [[5], None, []],
            "two_level_array": [[{"x": 1}, {"x": None}], None, []]}
    schema = [("repeated", dt.ArrayType(dt.INT32)),
              ("two_level_prim", dt.ArrayType(dt.INT64)),
              ("two_level_array", dt.ArrayType(dt.StructType([("x",
                                                               dt.INT64)])))]
    s = port()
    path = str(tmp_path / "legacy")
    s.create_dataframe(data, schema).write.parquet(path)
    monkeypatch.setattr(PN, "writer_elements", ORIGINAL)
    f = os.path.join(path, os.listdir(path)[0])
    assert file_schema(f) == schema
    assert s.read.parquet(path).to_pydict() == data
    back = pq.read_table(f).to_pydict()
    assert back["repeated"] == data["repeated"]
    assert back["two_level_prim"] == data["two_level_prim"]


def test_int96_and_byte_array_decimals_as_the_jax_package(tmp_path,
                                                           jax_session):
    """INT96 timestamps (pyarrow's deprecated layout, before 1970 and
    after) and BYTE_ARRAY decimals (a binary column whose footer names
    it DECIMAL(30, 3), as some writers lay decimals out) read equal to
    the JAX package's pyarrow reading, under CORRECTED and LEGACY; an
    INT96 before 1582 (which the JAX package's reading, through
    nanoseconds, cannot hold) reads exactly under CORRECTED."""
    ts = [datetime.datetime(2020, 5, 17, 3, 4, 5, 123456), None,
          datetime.datetime(1969, 12, 31, 23, 59, 59, 999999),
          datetime.datetime(1900, 3, 1, 12), datetime.datetime(1970, 1, 1)]
    decs = [decimal.Decimal("1.250"), None, decimal.Decimal("-3.100"),
            decimal.Decimal("123456789012345678901234.567"),
            decimal.Decimal("-0.001")]
    raw = [None if d is None else
           int(d.scaleb(3)).to_bytes(13, "big", signed=True) for d in decs]
    path = str(tmp_path / "i96.parquet")
    pq.write_table(pa.table({"t": pa.array(ts, pa.timestamp("us")),
                             "d": pa.array(raw, pa.binary())}), path,
                   use_deprecated_int96_timestamps=True)
    _annotate_decimal(path, "d", 30, 3)
    assert file_schema(path) == [("t", dt.TIMESTAMP),
                                 ("d", dt.DecimalType(30, 3))]
    assert pq.read_table(path).column("d").to_pylist() == decs
    for mode in ("CORRECTED", "LEGACY"):
        got = port().read.option("datetimeRebaseMode", mode) \
            .parquet(path).to_pydict()
        jax = jax_session.read.option("datetimeRebaseMode", mode) \
            .parquet(path).to_pydict()
        assert _rows(got) == _rows(jax)
        assert got["d"] == decs
        assert [_norm(v) for v in got["t"]] == ts
    old = str(tmp_path / "old.parquet")
    early = [datetime.datetime(1500, 3, 1, 12, 0, 0, 1), None]
    pq.write_table(pa.table({"t": pa.array(early, pa.timestamp("us"))}), old,
                   use_deprecated_int96_timestamps=True)
    assert [_norm(v) for v in port().read.parquet(old).to_pydict()["t"]] \
        == early


def _annotate_decimal(path, name, precision, scale):
    """Rewrite a file's footer so that BYTE_ARRAY column ``name`` is a
    DECIMAL(precision, scale)."""
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "rb") as fh:
        meta = T.read_footer(fh, path)
    for el in meta.schema:
        if el.name == name:
            el.converted_type = T.DECIMAL
            el.precision, el.scale = precision, scale
            el.logicalType = T.LogicalType(DECIMAL=T.DecimalType(
                scale=scale, precision=precision))
    flen = int.from_bytes(data[-8:-4], "little")
    with open(path, "wb") as fh:
        fh.write(data[:len(data) - 8 - flen])
        fh.write(T.footer_bytes(meta))


def test_nested_scan_runs_on_the_device(tmp_path, capsys):
    """A file scan of nested columns uploads them through their flat
    lanes: the plan holds no CPU-engine scan (the JAX package tags such
    a scan for its CPU engine)."""
    path = str(tmp_path / "n.parquet")
    pq.write_table(nested_table(n=40), path)
    df = port().read.parquet(path).select(col("l"), col("m"), col("st"))
    df.explain("ALL")
    out = capsys.readouterr().out
    assert "TpuFileScan" in out and "CpuFileScan" not in out, out
    assert _rows(df.to_pydict()) == _rows(
        nested_table(n=40).select(["l", "m", "st"]).to_pydict())
