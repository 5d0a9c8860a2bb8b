"""Thrift compact protocol for the Parquet footer (parquet.thrift).

The port reads and writes Parquet footers itself, so neither the
reader nor the writer needs the Arrow library: the JAX package reads
footers through Arrow's ``ParquetFile`` and writes files through its
``write_table``.
The page headers inside column chunks are read and written by the host
library (csrc/host/).

``read_struct`` decodes any compact-protocol struct into a dict of
{field id: value}, reading fields of unknown ids by their wire type and
dropping them, so files from newer writers still read. The classes
below name the fields of the parquet.thrift structs the port uses, in
both directions: ``Cls.from_fields(read_struct(...))`` and
``obj.to_bytes()``. ``read_footer`` / ``footer_bytes`` frame a
``FileMetaData`` in the file's tail (``<footer><u32 length>PAR1``).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"PAR1"

# compact protocol wire types
_BOOL_TRUE, _BOOL_FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, \
    _LIST, _SET, _MAP, _STRUCT = range(1, 13)

# parquet.thrift enums the port names
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, \
    FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
              "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD",
          "LZ4_RAW")
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
# ConvertedType
UTF8, MAP, MAP_KEY_VALUE, LIST, ENUM, DECIMAL, DATE, TIME_MILLIS, \
    TIME_MICROS, TIMESTAMP_MILLIS, TIMESTAMP_MICROS, UINT_8, UINT_16, \
    UINT_32, UINT_64, INT_8, INT_16, INT_32, INT_64, JSON, BSON, \
    INTERVAL = range(22)
CONVERTED_NAMES = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL",
                   "DATE", "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS",
                   "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32",
                   "UINT_64", "INT_8", "INT_16", "INT_32", "INT_64", "JSON",
                   "BSON", "INTERVAL")


class ThriftError(ValueError):
    """A footer that does not decode (truncated or not compact
    thrift): the file is corrupt."""


# ---------------------------------------------------------------------------
# generic compact-protocol reader
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, buf: bytes, pos: int = 0):
        self.b = buf
        self.i = pos

    def byte(self) -> int:
        if self.i >= len(self.b):
            raise ThriftError("footer ends inside a value")
        v = self.b[self.i]
        self.i += 1
        return v

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 70:
                raise ThriftError("varint longer than 10 bytes")

    def zigzag(self) -> int:
        u = self.varint()
        return (u >> 1) ^ -(u & 1)

    def take(self, n: int) -> bytes:
        if n < 0 or self.i + n > len(self.b):
            raise ThriftError("footer ends inside a binary field")
        out = self.b[self.i:self.i + n]
        self.i += n
        return bytes(out)

    def value(self, t: int, in_list: bool = False) -> Any:
        if t in (_BOOL_TRUE, _BOOL_FALSE):
            # a struct field carries the bool in its type nibble; a list
            # element is a byte of its own
            return self.byte() == 1 if in_list else t == _BOOL_TRUE
        if t == _BYTE:
            v = self.byte()
            return v - 256 if v > 127 else v
        if t in (_I16, _I32, _I64):
            return self.zigzag()
        if t == _DOUBLE:
            return struct.unpack("<d", self.take(8))[0]
        if t == _BINARY:
            return self.take(self.varint())
        if t in (_LIST, _SET):
            h = self.byte()
            size, et = h >> 4, h & 0x0F
            if size == 15:
                size = self.varint()
            return [self.value(et, True) for _ in range(size)]
        if t == _MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.byte()
            kt, vt = kv >> 4, kv & 0x0F
            return {self.value(kt, True): self.value(vt, True)
                    for _ in range(size)}
        if t == _STRUCT:
            return self.struct()
        raise ThriftError(f"unknown compact type {t}")

    def struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last = 0
        while True:
            h = self.byte()
            if h == 0:
                return out
            t, delta = h & 0x0F, h >> 4
            fid = last + delta if delta else self.zigzag()
            last = fid
            out[fid] = self.value(t)


def read_struct(buf: bytes, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """(the struct at ``pos`` as {field id: value}, the position after
    it)."""
    r = _Reader(buf, pos)
    return r.struct(), r.i


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.out = bytearray()
        self.last = [0]

    def varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def field(self, fid: int, t: int) -> None:
        delta = fid - self.last[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | t)
        else:
            self.out.append(t)
            self.zigzag(fid)
        self.last[-1] = fid

    def element(self, kind, v) -> None:
        """One value without a field header (a list element, or a
        field's value after its header)."""
        if kind == "bool":
            self.out.append(1 if v else 2)
        elif kind in ("i8",):
            self.out.append(v & 0xFF)
        elif kind in ("i16", "i32", "i64"):
            self.zigzag(v)
        elif kind == "double":
            self.out += struct.pack("<d", v)
        elif kind in ("binary", "string"):
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.varint(len(raw))
            self.out += raw
        elif isinstance(kind, tuple):  # ("list", element kind)
            et = _wire(kind[1])
            n = len(v)
            if n < 15:
                self.out.append((n << 4) | et)
            else:
                self.out.append(0xF0 | et)
                self.varint(n)
            for x in v:
                self.element(kind[1], x)
        else:  # a Struct class
            v.write(self)

    def begin(self) -> None:
        self.last.append(0)

    def end(self) -> None:
        self.out.append(0)
        self.last.pop()


def _wire(kind) -> int:
    if kind == "bool":
        return _BOOL_TRUE
    if isinstance(kind, tuple):
        return _LIST
    if isinstance(kind, str):
        return {"i8": _BYTE, "i16": _I16, "i32": _I32, "i64": _I64,
                "double": _DOUBLE, "binary": _BINARY,
                "string": _BINARY}[kind]
    return _STRUCT


class Struct:
    """A parquet.thrift struct: ``FIELDS`` = ((id, name, kind), ...),
    kind one of i8 / i16 / i32 / i64 / bool / double / binary / string,
    ("list", kind) or a Struct class. Unset fields are None."""

    FIELDS: Tuple = ()
    #: the fields parquet.thrift marks required
    REQUIRED: Tuple = ()

    def __init__(self, **kw):
        for _, name, _ in self.FIELDS:
            setattr(self, name, kw.pop(name, None))
        if kw:
            raise TypeError(f"{type(self).__name__}: unknown fields {kw}")

    @classmethod
    def from_fields(cls, d: Dict[int, Any]) -> "Struct":
        obj = cls()
        for fid, name, kind in cls.FIELDS:
            if fid in d:
                setattr(obj, name, _convert(kind, d[fid]))
        for name in cls.REQUIRED:
            if getattr(obj, name) is None:
                raise ThriftError(f"{cls.__name__} without its required "
                                  f"field {name}")
        return obj

    def write(self, w: _Writer) -> None:
        w.begin()
        for fid, name, kind in self.FIELDS:
            v = getattr(self, name)
            if v is None:
                continue
            if kind == "bool":
                w.field(fid, _BOOL_TRUE if v else _BOOL_FALSE)
                continue
            w.field(fid, _wire(kind))
            w.element(kind, v)
        w.end()

    def to_bytes(self) -> bytes:
        w = _Writer()
        self.write(w)
        return bytes(w.out)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for _, n, _ in self.FIELDS)

    def __repr__(self):
        parts = [f"{n}={getattr(self, n)!r}" for _, n, _ in self.FIELDS
                 if getattr(self, n) is not None]
        return f"{type(self).__name__}({', '.join(parts)})"


def _convert(kind, v):
    if kind == "string":
        if not isinstance(v, bytes):
            raise ThriftError(f"expected a string, got {type(v).__name__}")
        return v.decode("utf-8", errors="replace")
    if isinstance(kind, tuple):
        if not isinstance(v, list):
            raise ThriftError(f"expected a list, got {type(v).__name__}")
        return [_convert(kind[1], x) for x in v]
    if isinstance(kind, type):
        if not isinstance(v, dict):
            raise ThriftError(f"expected a struct, got {type(v).__name__}")
        return kind.from_fields(v)
    return v


# ---------------------------------------------------------------------------
# parquet.thrift
# ---------------------------------------------------------------------------

class Empty(Struct):
    """The field-less structs of the unions (StringType, DateType,
    MilliSeconds, TypeDefinedOrder, ...)."""


class DecimalType(Struct):
    FIELDS = ((1, "scale", "i32"), (2, "precision", "i32"))
    REQUIRED = ("scale", "precision")


class TimeUnit(Struct):
    FIELDS = ((1, "MILLIS", Empty), (2, "MICROS", Empty), (3, "NANOS", Empty))

    @property
    def name(self) -> str:
        return next(n for _, n, _ in self.FIELDS
                    if getattr(self, n) is not None)


class TimestampType(Struct):
    FIELDS = ((1, "isAdjustedToUTC", "bool"), (2, "unit", TimeUnit))


class IntType(Struct):
    FIELDS = ((1, "bitWidth", "i8"), (2, "isSigned", "bool"))


class LogicalType(Struct):
    FIELDS = ((1, "STRING", Empty), (2, "MAP", Empty), (3, "LIST", Empty),
              (4, "ENUM", Empty), (5, "DECIMAL", DecimalType),
              (6, "DATE", Empty), (7, "TIME", TimestampType),
              (8, "TIMESTAMP", TimestampType), (10, "INTEGER", IntType),
              (11, "UNKNOWN", Empty), (12, "JSON", Empty), (13, "BSON", Empty),
              (14, "UUID", Empty), (15, "FLOAT16", Empty))

    @property
    def name(self) -> Optional[str]:
        """The union's member, or None (a member this reader does not
        name)."""
        return next((n for _, n, _ in self.FIELDS
                     if getattr(self, n) is not None), None)


class SchemaElement(Struct):
    FIELDS = ((1, "type", "i32"), (2, "type_length", "i32"),
              (3, "repetition_type", "i32"), (4, "name", "string"),
              (5, "num_children", "i32"), (6, "converted_type", "i32"),
              (7, "scale", "i32"), (8, "precision", "i32"),
              (9, "field_id", "i32"), (10, "logicalType", LogicalType))
    REQUIRED = ("name",)


class Statistics(Struct):
    FIELDS = ((1, "max", "binary"), (2, "min", "binary"),
              (3, "null_count", "i64"), (4, "distinct_count", "i64"),
              (5, "max_value", "binary"), (6, "min_value", "binary"),
              (7, "is_max_value_exact", "bool"),
              (8, "is_min_value_exact", "bool"))


class KeyValue(Struct):
    FIELDS = ((1, "key", "string"), (2, "value", "string"))
    REQUIRED = ("key",)


class PageEncodingStats(Struct):
    FIELDS = ((1, "page_type", "i32"), (2, "encoding", "i32"),
              (3, "count", "i32"))


class ColumnMetaData(Struct):
    FIELDS = ((1, "type", "i32"), (2, "encodings", ("list", "i32")),
              (3, "path_in_schema", ("list", "string")), (4, "codec", "i32"),
              (5, "num_values", "i64"), (6, "total_uncompressed_size", "i64"),
              (7, "total_compressed_size", "i64"),
              (8, "key_value_metadata", ("list", KeyValue)),
              (9, "data_page_offset", "i64"),
              (10, "index_page_offset", "i64"),
              (11, "dictionary_page_offset", "i64"),
              (12, "statistics", Statistics),
              (13, "encoding_stats", ("list", PageEncodingStats)),
              (14, "bloom_filter_offset", "i64"),
              (15, "bloom_filter_length", "i32"))
    REQUIRED = ("type", "encodings", "path_in_schema", "codec", "num_values",
                "total_uncompressed_size", "total_compressed_size",
                "data_page_offset")


class ColumnChunk(Struct):
    FIELDS = ((1, "file_path", "string"), (2, "file_offset", "i64"),
              (3, "meta_data", ColumnMetaData),
              (4, "offset_index_offset", "i64"),
              (5, "offset_index_length", "i32"),
              (6, "column_index_offset", "i64"),
              (7, "column_index_length", "i32"))


class RowGroup(Struct):
    FIELDS = ((1, "columns", ("list", ColumnChunk)),
              (2, "total_byte_size", "i64"), (3, "num_rows", "i64"),
              (5, "file_offset", "i64"), (6, "total_compressed_size", "i64"),
              (7, "ordinal", "i16"))
    REQUIRED = ("columns", "total_byte_size", "num_rows")


class ColumnOrder(Struct):
    FIELDS = ((1, "TYPE_ORDER", Empty),)


class FileMetaData(Struct):
    FIELDS = ((1, "version", "i32"), (2, "schema", ("list", SchemaElement)),
              (3, "num_rows", "i64"), (4, "row_groups", ("list", RowGroup)),
              (5, "key_value_metadata", ("list", KeyValue)),
              (6, "created_by", "string"),
              (7, "column_orders", ("list", ColumnOrder)))
    REQUIRED = ("version", "schema", "num_rows", "row_groups")


# ---------------------------------------------------------------------------
# the file's tail
# ---------------------------------------------------------------------------

def read_footer(fh, path: str = "") -> FileMetaData:
    """The FileMetaData of an open Parquet file. A file too short, with
    the wrong magic or an undecodable footer raises ValueError (a
    corrupt file); an encrypted footer raises NotImplementedError."""
    fh.seek(0, 2)
    size = fh.tell()
    if size < 12:
        raise ValueError(f"{path}: {size} bytes is too short for a "
                         "Parquet file")
    fh.seek(size - 8)
    tail = fh.read(8)
    if tail[4:] == b"PARE":
        raise NotImplementedError(f"{path}: encrypted Parquet footers are "
                                  "not read by this port")
    if tail[4:] != MAGIC:
        raise ValueError(f"{path}: no Parquet magic at the end of the file")
    n = struct.unpack("<I", tail[:4])[0]
    if n + 12 > size:
        raise ValueError(f"{path}: footer length {n} exceeds the file "
                         f"({size} bytes)")
    fh.seek(size - 8 - n)
    raw = fh.read(n)
    try:
        fields, _ = read_struct(raw)
        return FileMetaData.from_fields(fields)
    except ThriftError as e:
        raise ValueError(f"{path}: corrupt footer: {e}") from None


def footer_bytes(meta: FileMetaData) -> bytes:
    """The file's tail for ``meta``: the footer, its length, PAR1."""
    raw = meta.to_bytes()
    return raw + struct.pack("<I", len(raw)) + MAGIC


def subtree_end(schema: List[SchemaElement], i: int) -> int:
    """The index after element ``i`` and its subtree."""
    if i >= len(schema):
        raise ValueError("parquet schema ends inside a group")
    kids = schema[i].num_children or 0
    i += 1
    for _ in range(kids):
        i = subtree_end(schema, i)
    return i
