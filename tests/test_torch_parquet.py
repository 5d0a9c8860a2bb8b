"""The port's Parquet format layer on the CPU: the footer reader
(io/thrift.py) against ``pq.ParquetFile(...).metadata`` field for field,
the host decoder against pyarrow's read of the files the JAX package's
tests/test_native_parquet.py writes (every codec, dictionary on and off,
v1 and v2 pages, the DELTA and BYTE_STREAM_SPLIT encodings, several row
groups, the dictionary falling back to PLAIN inside one chunk), every
flat type written by the port and read back bit for bit by the port,
by pyarrow and by the JAX package on both of its lanes (pyarrow, and
native with ``srt.sql.format.parquet.nativeDecode.enabled``), the
rebase modes against the JAX package's, and nested / INT96 files
raising NotImplementedError. pyarrow is the tests' independent reader
and writer; the port never imports it.
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
from spark_rapids_tpu_torch.columnar.vector import HostStrings
from spark_rapids_tpu_torch.io import host_lib as HL
from spark_rapids_tpu_torch.io import thrift as T
from spark_rapids_tpu_torch.io.native_parquet import (
    file_schema, iter_row_group_tables_native, read_metadata)
from spark_rapids_tpu_torch.io.parquet_writer import write_parquet_file
from spark_rapids_tpu_torch.plan.host_table import (HostColumn, HostTable,
                                                    concat_tables, to_engine)

CODECS = ["none", "snappy", "gzip", "zstd"]
EPOCH = datetime.date(1970, 1, 1)
#: decimal's default context rounds at 28 digits: 38-digit values need more
CTX = decimal.Context(prec=80)


# --- lanes: the port's host layout, built and compared without the port ---

def _flat_table(n=3000, seed=7):
    """Every flat type with about 10% nulls: NaN, +-inf and -0.0 in the
    floats, empty and multi-byte strings, dates before 1582, negative
    timestamps, DECIMAL(12,2) and DECIMAL(24,4) at their extremes."""
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) >= 0.1
    f64 = rng.standard_normal(n) * 1e3
    f64[rng.integers(0, n, 40)] = np.nan
    f64[:6] = [np.inf, -np.inf, -0.0, 0.0, np.nan, 5e-324]
    f32 = f64.astype(np.float32)
    words = ["", "a", "héllo", "日本語", "x" * 300, "emoji \U0001F600",
             "tab\tnew\nline"]
    strs = [words[i % len(words)] + (str(i) if i % 3 else "")
            for i in range(n)]
    dates = rng.integers(-250_000, 40_000, n).astype(np.int32)
    ts = rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64)
    d12 = rng.integers(-10 ** 12 + 1, 10 ** 12, n).astype(np.int64)
    d24 = np.array([int(x) * 10 ** 12 + int(y) for x, y in zip(
        rng.integers(-10 ** 12 + 1, 10 ** 12, n),
        rng.integers(0, 10 ** 12, n))], dtype=object)
    d24[:2] = [10 ** 24 - 1, -(10 ** 24 - 1)]
    cols = [
        ("b", dt.BOOL, rng.random(n) < 0.5),
        ("i8", dt.INT8, rng.integers(-128, 128, n).astype(np.int8)),
        ("i16", dt.INT16, rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        ("i32", dt.INT32, rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
        ("i64", dt.INT64, rng.integers(-2 ** 63, 2 ** 63 - 1, n)),
        ("f32", dt.FLOAT32, f32),
        ("f64", dt.FLOAT64, f64),
        ("s", dt.STRING, HostStrings.from_objects(strs)),
        ("d", dt.DATE, dates),
        ("ts", dt.TIMESTAMP, ts),
        ("m", dt.DecimalType(12, 2), d12),
        ("w", dt.DecimalType(24, 4), d24),
    ]
    out = []
    for name, t, v in cols:
        m = mask()
        if t == dt.STRING:
            v = HostStrings.from_objects([s if ok else None
                                          for s, ok in zip(strs, m)])
        elif dt.is_wide_decimal(t):
            v = np.where(m, v, 0)
        else:
            v = np.where(m, v, np.zeros(1, v.dtype))
        out.append(HostColumn(v, m, t))
    return HostTable(out, [c[0] for c in cols])


def _valid_values(c: HostColumn):
    """A column's valid values in a bit-exact comparable form."""
    m = c.mask
    v = c.values
    if c.dtype == dt.STRING:
        if not isinstance(v, HostStrings):
            v = HostStrings.from_objects(list(v))
        raw = v.chars.tobytes()
        o = v.offsets
        return [raw[o[i]:o[i + 1]] for i in np.nonzero(m)[0]]
    if c.dtype.is_floating:
        w = np.int32 if c.dtype == dt.FLOAT32 else np.int64
        return np.asarray(v)[m].view(w).tolist()
    return [int(x) for x in np.asarray(v)[m]]


def _assert_same(got: HostTable, want: HostTable):
    assert got.names == want.names
    for name, g, w in zip(got.names, got.columns, want.columns):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g.mask, w.mask), name
        assert _valid_values(g) == _valid_values(w), name


def _arrow_lanes(table: pa.Table, schema) -> HostTable:
    """pyarrow's read as the port's lanes, converted here."""
    cols = []
    for name, t in schema:
        arr = table.column(name).combine_chunks()
        m = np.asarray(arr.is_valid())
        if t == dt.STRING:
            v = HostStrings.from_objects(arr.to_pylist())
        elif dt.is_decimal(t):
            raw = [0 if x is None else int(x.scaleb(t.scale, context=CTX))
                   for x in arr.to_pylist()]
            v = np.array(raw, dtype=object if t.is_wide else np.int64)
        elif t == dt.DATE:
            v = np.asarray(arr.cast(pa.int32()).fill_null(0))
        elif t == dt.TIMESTAMP:
            us = arr.cast(pa.timestamp("us", tz="UTC"), safe=False)
            v = np.asarray(us.cast(pa.int64()).fill_null(0))
        elif t == dt.BOOL:
            v = np.asarray(arr.fill_null(False))
        else:
            v = np.asarray(arr.fill_null(0)).astype(t.np_physical)
        cols.append(HostColumn(v, m, t))
    return HostTable(cols, [n for n, _ in schema])


def _arrow_table(ht: HostTable) -> pa.Table:
    """A host table as pyarrow data, built here."""
    arrays = []
    for name, c in zip(ht.names, ht.columns):
        t, m = c.dtype, c.mask
        if t == dt.STRING:
            objs = c.values.to_objects()
            arrays.append(pa.array([s if ok else None
                                    for s, ok in zip(objs, m)], pa.string()))
        elif dt.is_decimal(t):
            arrays.append(pa.array(
                [decimal.Decimal(int(v)).scaleb(-t.scale, context=CTX)
                 if ok else None
                 for v, ok in zip(c.values, m)],
                pa.decimal128(t.precision, t.scale)))
        elif t == dt.DATE:
            arrays.append(pa.array(c.values, pa.int32(), mask=~m)
                          .cast(pa.date32()))
        elif t == dt.TIMESTAMP:
            arrays.append(pa.array(c.values, pa.int64(), mask=~m)
                          .cast(pa.timestamp("us", tz="UTC")))
        else:
            arrays.append(pa.array(c.values, mask=~m))
    return pa.table(arrays, names=ht.names)


def port_read(path, schema=None, options=None, max_rows=1 << 30):
    schema = schema or file_schema(path)
    return concat_tables(list(iter_row_group_tables_native(
        path, schema, options or {}, max_rows, None)))


# --- the host library ------------------------------------------------------

def test_codecs_in_this_build():
    assert {"UNCOMPRESSED", "SNAPPY"} <= set(HL.codecs())


@pytest.mark.parametrize("kind", ["random", "runs", "text", "empty"])
def test_snappy_compressor_against_pyarrow(kind):
    rng = np.random.default_rng(3)
    data = {"random": rng.bytes(300_000),
            "runs": bytes(rng.integers(0, 3, 500_000).astype(np.uint8)),
            "text": b"the quick brown fox " * 20_000 + b"x" * 70_000,
            "empty": b""}[kind]
    comp = HL.compress(1, data)
    assert HL.decompress(1, comp, len(data)) == data
    if data:
        assert pa.decompress(comp, decompressed_size=len(data),
                             codec="snappy").to_pybytes() == data


# --- the footer ------------------------------------------------------------

def _pyarrow_files(tmp_path):
    """Files pyarrow writes with the JAX package's test settings."""
    rng = np.random.default_rng(5)
    n = 4000
    base = pa.table({
        "i": pa.array(rng.integers(-10 ** 9, 10 ** 9, n), mask=rng.random(n) < .1),
        "f": pa.array(rng.random(n)),
        "s": pa.array([None if k % 11 == 0 else f"w{k % 97}" for k in range(n)]),
        "d": pa.array(rng.integers(0, 20_000, n).astype(np.int32))
        .cast(pa.date32()),
        "m": pa.array([decimal.Decimal(int(x)).scaleb(-2)
                       for x in rng.integers(-10 ** 9, 10 ** 9, n)],
                      pa.decimal128(12, 2)),
        "b": pa.array(rng.random(n) < 0.3),
    })
    out = {}
    for key, kw in {
            "snappy": dict(compression="snappy"),
            "plain_zstd": dict(compression="zstd", use_dictionary=False),
            "v2_gzip": dict(compression="gzip", data_page_version="2.0"),
            "groups": dict(row_group_size=700, compression="none")}.items():
        p = str(tmp_path / f"{key}.parquet")
        pq.write_table(base, p, **kw)
        out[key] = p
    return out


def _stat_value(raw, phys):
    fmt = {"INT32": "<i", "INT64": "<q", "DOUBLE": "<d", "FLOAT": "<f",
           "BOOLEAN": "<?"}.get(phys)
    import struct
    return struct.unpack(fmt, raw)[0] if fmt else raw


def test_footer_equals_pyarrow_metadata(tmp_path):
    for path in _pyarrow_files(tmp_path).values():
        ours = read_metadata(path)
        theirs = pq.ParquetFile(path).metadata
        assert ours.num_rows == theirs.num_rows
        assert ours.created_by == theirs.created_by
        assert len(ours.row_groups) == theirs.num_row_groups
        assert len(ours.schema) - 1 == theirs.num_columns
        schema = pq.ParquetFile(path).schema
        for k, el in enumerate(ours.schema[1:]):
            col = schema.column(k)
            assert el.name == col.name
            assert T.TYPE_NAMES[el.type] == col.physical_type
            assert (T.CONVERTED_NAMES[el.converted_type]
                    if el.converted_type is not None else "NONE") == \
                col.converted_type
            assert (1 if el.repetition_type == T.OPTIONAL else 0) == \
                col.max_definition_level
            if col.converted_type == "DECIMAL":
                assert (el.precision, el.scale) == (col.precision, col.scale)
                assert el.type_length == col.length
        for g, rg in enumerate(ours.row_groups):
            trg = theirs.row_group(g)
            assert rg.num_rows == trg.num_rows
            assert rg.total_byte_size == trg.total_byte_size
            for k, cc in enumerate(rg.columns):
                md, tc = cc.meta_data, trg.column(k)
                assert T.TYPE_NAMES[md.type] == tc.physical_type
                assert ".".join(md.path_in_schema) == tc.path_in_schema
                assert T.CODECS[md.codec] == tc.compression
                assert tuple(T.ENCODINGS[e] for e in md.encodings) == \
                    tc.encodings
                assert md.num_values == tc.num_values
                assert md.total_compressed_size == tc.total_compressed_size
                assert md.total_uncompressed_size == \
                    tc.total_uncompressed_size
                assert md.data_page_offset == tc.data_page_offset
                assert (md.dictionary_page_offset or None) == \
                    (tc.dictionary_page_offset if tc.has_dictionary_page
                     else None)
                st, ts = md.statistics, tc.statistics
                assert st.null_count == ts.null_count
                if ts.has_min_max and tc.physical_type != \
                        "FIXED_LEN_BYTE_ARRAY":
                    lo = _stat_value(st.min_value, tc.physical_type)
                    hi = _stat_value(st.max_value, tc.physical_type)
                    if tc.physical_type == "BYTE_ARRAY":
                        lo, hi = lo.decode(), hi.decode()
                    if tc.physical_type == "INT32" and \
                            schema.column(k).logical_type.type == "DATE":
                        lo, hi = (EPOCH + datetime.timedelta(days=x)
                                  for x in (lo, hi))
                    assert (lo, hi) == (ts.min, ts.max)


def test_thrift_round_trip_keeps_every_field(tmp_path):
    path = _pyarrow_files(tmp_path)["groups"]
    meta = read_metadata(path)
    again = T.FileMetaData.from_fields(T.read_struct(meta.to_bytes())[0])
    assert again == meta


def test_unknown_fields_are_skipped():
    # a SchemaElement with extra fields of every wire type between and
    # after the known ones, as a newer writer may add
    w = T._Writer()
    w.begin()
    w.field(4, 8)
    w.element("string", "col")
    w.field(20, 6)
    w.element("i64", -5)
    w.field(21, 7)
    w.element("double", 1.5)
    w.field(22, 9)
    w.element(("list", "string"), ["a", "b"])
    w.field(23, 12)
    T.KeyValue(key="k", value="v").write(w)
    w.field(24, 1)
    w.end()
    el = T.SchemaElement.from_fields(T.read_struct(bytes(w.out))[0])
    assert el == T.SchemaElement(name="col")


def test_truncated_footer_is_a_corrupt_file(tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3]}), p)
    raw = open(p, "rb").read()
    for cut in (raw[:-3], raw[:8], raw[:-8 - 20] + raw[-8:]):
        with open(p, "wb") as f:
            f.write(cut)
        with pytest.raises(ValueError):
            read_metadata(p)


# --- pyarrow's files read by the port (the JAX native tests' writers) -------

def _jax_test_tables():
    """(name, arrow table, writer kwargs) as tests/test_native_parquet.py
    writes them."""
    rng = np.random.default_rng(5)
    n = 10_000

    def nullify(arr, p=0.1):
        m = rng.random(n) < p
        return [None if m[i] else arr[i].item() for i in range(n)]
    fixed = pa.table({
        "i32": pa.array(nullify(rng.integers(-2 ** 31, 2 ** 31 - 1, n)),
                        type=pa.int32()),
        "i64": pa.array(nullify(rng.integers(-2 ** 62, 2 ** 62, n)),
                        type=pa.int64()),
        "f32": pa.array(nullify(rng.standard_normal(n).astype(np.float32)),
                        type=pa.float32()),
        "f64": pa.array(nullify(rng.standard_normal(n)), type=pa.float64()),
        "dense": pa.array(rng.integers(0, 50, n), type=pa.int64()),
    })
    cases = []
    for codec in ("snappy", "none"):
        for dictionary in (True, False):
            cases.append((f"fixed-{codec}-dict{int(dictionary)}", fixed,
                          dict(compression=codec,
                               use_dictionary=dictionary)))
    cases.append(("row_groups", pa.table({"v": pa.array(range(5000),
                                                        pa.int64())}),
                  dict(row_group_size=700)))
    cases.append(("strings", pa.table({
        "s": pa.array(["a", None, "ccc"] * 100),
        "v": pa.array(range(300), type=pa.int64())}), {}))
    words = ["prefix_shared_" + str(i // 7) + "_suffix" + str(i)
             for i in range(5000)]
    rng2 = np.random.default_rng(11)
    vals = [None if rng2.random() < 0.08 else words[i] for i in range(5000)]
    for enc in ("DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY"):
        for codec in ("snappy", "zstd", "none"):
            cases.append((f"{enc}-{codec}", pa.table({"s": pa.array(vals)}),
                          dict(use_dictionary=False,
                               column_encoding={"s": enc}, compression=codec,
                               data_page_version="2.0")))
    cases.append(("delta_v1", pa.table({"s": pa.array(
        ["aa", "ab", "abc", None, "b", ""] * 500)}),
        dict(use_dictionary=False, column_encoding={"s": "DELTA_BYTE_ARRAY"},
             compression="snappy", data_page_version="1.0")))
    rng3 = np.random.default_rng(4)
    cases.append(("byte_stream_split", pa.table({
        "a": pa.array(rng3.standard_normal(4000).astype(np.float32)),
        "b": pa.array(rng3.standard_normal(4000))}),
        dict(use_dictionary=False, compression="zstd",
             column_encoding={"a": "BYTE_STREAM_SPLIT",
                              "b": "BYTE_STREAM_SPLIT"})))
    cases.append(("dates", pa.table({"d": pa.array(
        [datetime.date(2020, 1, 1) + datetime.timedelta(days=i)
         if i % 7 else None for i in range(500)], pa.date32())}), {}))
    rng4 = np.random.default_rng(0)
    m = rng4.random(20_000) < 0.1
    breadth = pa.table({
        "i": pa.array(np.where(m, 0, rng4.integers(-10 ** 9, 10 ** 9, 20_000)),
                      mask=m),
        "f": pa.array(rng4.random(20_000) * 1000),
        "s": pa.array(np.arange(20_000) * 3 + 7)})
    delta = {"i": "DELTA_BINARY_PACKED", "s": "DELTA_BINARY_PACKED",
             "f": "PLAIN"}
    for key, kw in {
            "zstd": dict(compression="zstd"),
            "gzip": dict(compression="gzip"),
            "v2_zstd": dict(compression="zstd", data_page_version="2.0"),
            "delta_bp": dict(compression="snappy", use_dictionary=False,
                             column_encoding=delta),
            "v2_gzip_delta": dict(compression="gzip", use_dictionary=False,
                                  data_page_version="2.0",
                                  column_encoding=delta)}.items():
        cases.append((f"breadth-{key}", breadth, kw))
    return cases


_CASES = _jax_test_tables()


def _schema_of(table: pa.Table):
    conv = {pa.int32(): dt.INT32, pa.int64(): dt.INT64,
            pa.float32(): dt.FLOAT32, pa.float64(): dt.FLOAT64,
            pa.string(): dt.STRING, pa.date32(): dt.DATE,
            pa.bool_(): dt.BOOL}
    return [(f.name, conv[f.type]) for f in table.schema]


@pytest.mark.parametrize("case", range(len(_CASES)),
                         ids=[c[0] for c in _CASES])
def test_port_reads_pyarrow_files(tmp_path, case):
    name, table, kw = _CASES[case]
    p = str(tmp_path / "t.parquet")
    pq.write_table(table, p, **kw)
    schema = _schema_of(table)
    assert file_schema(p) == schema
    _assert_same(port_read(p), _arrow_lanes(pq.read_table(p), schema))
    if name == "row_groups":
        # several row groups, sliced under max_rows
        parts = list(iter_row_group_tables_native(p, schema, {}, 300, None))
        assert max(t.num_rows for t in parts) <= 300
        assert sum(t.num_rows for t in parts) == 5000


def test_dictionary_falls_back_to_plain_mid_chunk(tmp_path):
    """pyarrow leaves the dictionary for PLAIN inside one column chunk
    once the dictionary passes its page limit (1 MiB by default; 4 KiB
    here)."""
    rng = np.random.default_rng(2)
    vals = [None if k % 13 == 0 else f"key-{int(x):09d}-ü"
            for k, x in enumerate(rng.integers(0, 10 ** 9, 30_000))]
    nums = rng.integers(0, 10 ** 12, 30_000)
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"s": pa.array(vals), "n": pa.array(nums)}), p,
                   dictionary_pagesize_limit=4096, compression="snappy")
    col = pq.ParquetFile(p).metadata.row_group(0).column(0)
    assert {"PLAIN", "RLE_DICTIONARY"} <= set(col.encodings)
    schema = [("s", dt.STRING), ("n", dt.INT64)]
    _assert_same(port_read(p), _arrow_lanes(pq.read_table(p), schema))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_booleans_and_fixed_len_decimals(tmp_path, version):
    rng = np.random.default_rng(9)
    n = 5000
    b = rng.random(n) < 0.6
    m = rng.random(n) < 0.15
    decs = {p: [decimal.Decimal(int(x)).scaleb(-3, context=CTX) for x in
                rng.integers(-(10 ** min(p, 18)) + 1, 10 ** min(p, 18), n)]
            for p in (5, 18, 30, 38)}
    decs[38][:2] = [decimal.Decimal(10 ** 38 - 1).scaleb(-3, context=CTX),
                    decimal.Decimal(-(10 ** 38 - 1)).scaleb(-3, context=CTX)]
    table = pa.table({
        "b": pa.array(b, mask=m),
        **{f"d{p}": pa.array(v, pa.decimal128(p, 3), mask=m)
           for p, v in decs.items()}})
    p = str(tmp_path / "t.parquet")
    pq.write_table(table, p, data_page_version=version, compression="snappy")
    schema = [("b", dt.BOOL)] + [(f"d{q}", dt.DecimalType(q, 3))
                                 for q in decs]
    assert file_schema(p) == schema
    _assert_same(port_read(p), _arrow_lanes(pq.read_table(p), schema))


@pytest.mark.parametrize("unit", ["ms", "us", "ns"])
def test_timestamp_units_before_and_after_the_epoch(tmp_path, unit):
    rng = np.random.default_rng(1)
    raw = rng.integers(-(1 << 61), 1 << 61, 2000)
    raw[:4] = [-1, -1500, 1500, -999]
    arr = pa.array(raw, pa.int64()).cast(pa.timestamp(unit, tz="UTC"))
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"t": arr}), p, coerce_timestamps=None)
    schema = [("t", dt.TIMESTAMP)]
    _assert_same(port_read(p), _arrow_lanes(pq.read_table(p), schema))


# --- the port's files ---------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_port_round_trip_every_flat_type(tmp_path, codec):
    ht = _flat_table()
    p = str(tmp_path / "t.parquet")
    write_parquet_file(ht, p, codec, row_group_rows=1024, page_bytes=2048)
    meta = read_metadata(p)
    assert len(meta.row_groups) == 3
    assert file_schema(p) == ht.schema()
    _assert_same(port_read(p), ht)
    # and in row groups sliced under max_rows
    parts = list(iter_row_group_tables_native(p, ht.schema(), {}, 500, None))
    assert max(t.num_rows for t in parts) == 500
    _assert_same(concat_tables(parts), ht)
    # pyarrow reads every column as dtype_to_arrow_type gives it
    got = pq.read_table(p)
    assert got.schema == _arrow_table(ht).schema
    _assert_same(_arrow_lanes(got, ht.schema()), ht)


def test_port_statistics_read_by_pyarrow(tmp_path):
    ht = _flat_table(n=800)
    p = str(tmp_path / "t.parquet")
    write_parquet_file(ht, p)
    rg = pq.ParquetFile(p).metadata.row_group(0)
    arrow = _arrow_table(ht)
    for k, name in enumerate(ht.names):
        st = rg.column(k).statistics
        col = arrow.column(name)
        assert st.null_count == col.null_count, name
        if name in ("f32", "f64"):
            vals = col.drop_null().to_numpy()
            vals = vals[~np.isnan(vals)]
            assert (st.min, st.max) == (vals.min(), vals.max()), name
        elif name == "ts":
            lane = ht.column(name)
            vals = lane.values[lane.mask]
            assert (st.min_raw, st.max_raw) == (vals.min(), vals.max())
        else:
            import pyarrow.compute as pc
            mm = pc.min_max(col)
            assert (st.min, st.max) == (mm["min"].as_py(),
                                        mm["max"].as_py()), name


def test_pyarrow_written_flat_types_read_by_the_port(tmp_path):
    ht = _flat_table()
    p = str(tmp_path / "t.parquet")
    pq.write_table(_arrow_table(ht), p)
    assert file_schema(p) == ht.schema()
    _assert_same(port_read(p), ht)


@pytest.fixture(scope="module")
def jax_io():
    """The JAX package's reader, its compiles patched (C1)."""
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.io import scan as jscan
        yield jdt, JConf, jscan


def _jax_dtype(jdt, t):
    if dt.is_decimal(t):
        return jdt.DecimalType(t.precision, t.scale)
    return getattr(jdt, {dt.BOOL: "BOOL", dt.INT8: "INT8", dt.INT16: "INT16",
                         dt.INT32: "INT32", dt.INT64: "INT64",
                         dt.FLOAT32: "FLOAT32", dt.FLOAT64: "FLOAT64",
                         dt.STRING: "STRING", dt.DATE: "DATE",
                         dt.TIMESTAMP: "TIMESTAMP"}[t])


@pytest.mark.parametrize("native", [False, True], ids=["pyarrow", "native"])
@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_jax_package_reads_port_files(tmp_path, jax_io, native, codec):
    jdt, JConf, jscan = jax_io
    ht = _flat_table()
    p = str(tmp_path / "t.parquet")
    write_parquet_file(ht, p, codec, row_group_rows=2048)
    ours = to_engine(port_read(p))
    conf = JConf({"srt.sql.format.parquet.nativeDecode.enabled": native})
    schema = [(n, _jax_dtype(jdt, t)) for n, t in ht.schema()]
    theirs = jscan.read_file_to_tables(p, "parquet", schema, {}, None,
                                       1 << 30, conf)
    cols = [HostColumn(np.concatenate([t.columns[k].values
                                       for t in theirs]),
                       np.concatenate([t.columns[k].mask for t in theirs]),
                       ht.columns[k].dtype)
            for k in range(len(ht.names))]
    _assert_same(HostTable(cols, ht.names), ours)


# --- rebase, and what the port does not read -----------------------------------

@pytest.mark.parametrize("mode", ["CORRECTED", "LEGACY", "EXCEPTION"])
def test_rebase_modes_against_the_jax_package(tmp_path, jax_io, mode):
    from spark_rapids_tpu.io.writer import _apply_write_rebase as jax_write
    from spark_rapids_tpu.plan.host_table import (HostColumn as JCol,
                                                  HostTable as JTable)
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu_torch.io.writer import _apply_write_rebase
    days = np.array([-200_000, -141_428, -141_427, -1, 0, 18_000], np.int32)
    us = days.astype(np.int64) * 86_400_000_000 + 12_345
    mask = np.ones(len(days), bool)
    ht = HostTable([HostColumn(days, mask, dt.DATE),
                    HostColumn(us, mask, dt.TIMESTAMP)], ["d", "t"])
    jt = JTable([JCol(days, mask, jdt.DATE), JCol(us, mask, jdt.TIMESTAMP)],
                ["d", "t"])
    opts = {"datetimeRebaseMode": mode}
    if mode == "EXCEPTION":
        with pytest.raises(ValueError, match="1582"):
            _apply_write_rebase(ht, opts)
        p = str(tmp_path / "t.parquet")
        write_parquet_file(ht, p)
        with pytest.raises(ValueError, match="1582"):
            port_read(p, options=opts)
        return
    written = _apply_write_rebase(ht, opts)
    want = jax_write(jt, opts)
    for a, b in zip(written.columns, want.columns):
        assert np.array_equal(a.values, b.values)
    p = str(tmp_path / "t.parquet")
    write_parquet_file(written, p)
    back = port_read(p, options=opts)
    from spark_rapids_tpu.io.scan import _apply_read_rebase as jax_read
    jax_read(want, opts)
    for a, b in zip(back.columns, want.columns):
        assert np.array_equal(a.values, b.values)
    # the calendar day comes back, but for the ten proleptic days
    # before the cutover that the Julian calendar skips
    for a, b in zip(back.columns, ht.columns):
        assert (a.values == b.values).sum() >= 5


def test_nested_and_int96_raise_naming_the_column(tmp_path):
    """Nested and INT96 columns read now (tests/test_torch_parquet_nested.py
    holds them against the JAX package); a column still outside the
    port, unsigned or TIME, raises naming itself, a declared schema that
    leaves it out reads the rest, and ignoreCorruptFiles does not
    swallow it."""
    from spark_rapids_tpu_torch.io.scan import FileScan
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2]),
                             "l": pa.array([[1], [2, 3]]),
                             "st": pa.array([{"x": 1}, {"x": 2}]),
                             "u": pa.array([1, 2], pa.uint32())}), p)
    with pytest.raises(NotImplementedError, match="'u'.*unsigned"):
        file_schema(p)
    got = port_read(p, schema=[("a", dt.INT64), ("l", dt.ArrayType(
        dt.INT64)), ("st", dt.StructType([("x", dt.INT64)]))])
    from spark_rapids_tpu_torch.plan.host_table import to_pydict
    assert to_pydict(got) == {"a": [1, 2], "l": [[1], [2, 3]],
                              "st": [{"x": 1}, {"x": 2}]}
    with pytest.raises(ValueError, match="declared"):
        port_read(p, schema=[("a", dt.INT64), ("st", dt.INT64)])
    q = str(tmp_path / "i96.parquet")
    pq.write_table(pa.table({"t": pa.array([0, 1000], pa.timestamp("ns")),
                             "tm": pa.array([1, 2], pa.time32("ms"))}), q,
                   use_deprecated_int96_timestamps=True)
    with pytest.raises(NotImplementedError, match="'tm'.*TIME"):
        FileScan(q)
    assert port_read(q, schema=[("t", dt.TIMESTAMP)]).columns[0] \
        .values.tolist() == [0, 1]
    # ignoreCorruptFiles does not swallow it
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.io.scan import read_file_to_tables
    with pytest.raises(NotImplementedError, match="TIME"):
        read_file_to_tables(q, "parquet", [("tm", dt.INT32)], {}, 1 << 20,
                            SrtConf({"srt.sql.ignoreCorruptFiles": True}))


def test_writer_refuses_nested_and_unknown_codecs(tmp_path):
    """Nested columns are written now (a NULL list row reads back NULL
    through pyarrow; tests/test_torch_parquet_nested.py covers the
    rest); an unknown codec is refused before the file exists."""
    ht = HostTable([HostColumn(np.array([None], object), np.zeros(1, bool),
                               dt.ArrayType(dt.INT64))], ["a"])
    write_parquet_file(ht, str(tmp_path / "a.parquet"))
    assert pq.read_table(str(tmp_path / "a.parquet")).to_pydict() == \
        {"a": [None]}
    flat = _flat_table(n=10)
    with pytest.raises(ValueError, match="lz4"):
        write_parquet_file(flat, str(tmp_path / "b.parquet"), "lz4")
    assert not os.path.exists(str(tmp_path / "b.parquet"))
