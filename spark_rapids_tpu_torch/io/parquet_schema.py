"""Parquet schema <-> the port's dtypes.

The counterpart of spark_rapids_tpu/io/arrow_convert.py:26-95 for the
port, which reads Parquet's own schema (io/thrift.py) where the JAX
package reads Arrow's. The flat types and their host lanes (the
physical lanes the device uses, plan/host_table.py):

- BOOLEAN -> BOOL;
- INT32 as INT(8) / INT_8 -> INT8, INT(16) / INT_16 -> INT16, plain or
  INT(32) -> INT32, DATE -> DATE (int32 days), DECIMAL -> its unscaled
  int64;
- INT64 plain or INT(64) -> INT64, DECIMAL -> its unscaled int64,
  TIMESTAMP in MILLIS / MICROS / NANOS -> TIMESTAMP in the port's UTC
  microseconds (nanoseconds truncate toward zero, as arrow's cast);
- FLOAT -> FLOAT32, DOUBLE -> FLOAT64;
- BYTE_ARRAY as STRING / UTF8 -> STRING (HostStrings);
- FIXED_LEN_BYTE_ARRAY as DECIMAL, big-endian two's complement (Arrow's
  writer writes every decimal so): precision <= 18 into the 64-bit lane, above
  into the two-limb lane's host form (unscaled Python ints,
  columnar/decimal128.py).

- INT96 -> TIMESTAMP (nanoseconds of the day and a Julian day, as
  Spark's ``fromJulianDay``), under the same read rebase as the other
  timestamps;
- BYTE_ARRAY as DECIMAL: big-endian two's complement of any length;
- nested groups (LIST, MAP, STRUCT, and the legacy repeated forms) ->
  ArrayType / MapType / StructType, whose levels io/parquet_nested.py
  assembles.

Unsigned and TIME columns, BINARY without a string annotation and other
annotations raise NotImplementedError naming the column.

The writer's side (``schema_element``) writes what Arrow reads back as
the arrow type ``dtype_to_arrow_type`` gives (JAX arrow_convert.py:61):
INT8 / INT16 as INT32 with INT(8) / INT(16), DATE with DATE, TIMESTAMP
as INT64 TIMESTAMP(UTC, MICROS), STRING as BYTE_ARRAY STRING, a DECIMAL
of precision <= 9 as INT32, <= 18 as INT64 and above as the
FIXED_LEN_BYTE_ARRAY of its least width (Spark's layout). Every column
is OPTIONAL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.decimal128 import ints_of_limbs
from . import thrift as T


@dataclass
class ColumnInfo:
    """One top-level column of a file: its name, the index of its
    column chunk in each row group, its schema element and max
    definition level, and its dtype (None for a column the port does not
    read: ``unsupported`` says why)."""
    name: str
    chunk: int
    element: T.SchemaElement
    max_def: int
    dtype: Optional[dt.DType]
    unsupported: Optional[str] = None
    #: a nested column's schema tree (io/parquet_nested.py), else None
    node: Optional[object] = None
    max_rep: int = 0

    def require(self) -> dt.DType:
        if self.dtype is None:
            raise NotImplementedError(
                f"parquet column {self.name!r}: {self.unsupported}")
        return self.dtype


def file_columns(meta: T.FileMetaData) -> List[ColumnInfo]:
    """The top-level columns, in schema order, each with the index of
    its first leaf chunk (a nested column spans several)."""
    schema = meta.schema or []
    if not schema:
        raise ValueError("parquet footer without a schema")
    out: List[ColumnInfo] = []
    i, leaf = 1, 0
    for _ in range(schema[0].num_children or 0):
        el = schema[i]
        end = T.subtree_end(schema, i)
        leaves = sum(1 for e in schema[i:end] if not e.num_children)
        if el.num_children or el.repetition_type == T.REPEATED:
            from .parquet_nested import field_node
            node, _ = field_node(schema, i, 0, 0, [leaf], _dtype_of)
            out.append(ColumnInfo(
                el.name, leaf, el, 0, node.dtype,
                None if node.dtype is not None else node.why, node,
                max(x.max_rep for x in node.leaves())))
        else:
            max_def = 1 if el.repetition_type == T.OPTIONAL else 0
            t, why = _dtype_of(el)
            out.append(ColumnInfo(el.name, leaf, el, max_def, t, why))
        i, leaf = end, leaf + leaves
    return out


def _logical(el: T.SchemaElement) -> Optional[str]:
    return el.logicalType.name if el.logicalType is not None else None


def _dtype_of(el: T.SchemaElement) -> Tuple[Optional[dt.DType],
                                             Optional[str]]:
    """(dtype, None) or (None, why the port does not read it)."""
    phys, conv, lt = el.type, el.converted_type, el.logicalType
    logical = _logical(el)
    if logical == "DECIMAL" or conv == T.DECIMAL:
        if lt is not None and lt.DECIMAL is not None:
            p, s = lt.DECIMAL.precision, lt.DECIMAL.scale
        else:
            p, s = el.precision, el.scale or 0
        if phys not in (T.INT32, T.INT64, T.FIXED_LEN_BYTE_ARRAY,
                        T.BYTE_ARRAY):
            return None, f"a {T.TYPE_NAMES[phys]} DECIMAL is not read by " \
                "this port"
        if p is None or not 0 < p <= dt.DecimalType.MAX_PRECISION:
            return None, f"DECIMAL precision {p} is outside 1..38"
        return dt.DecimalType(p, s), None
    if phys == T.BOOLEAN:
        return dt.BOOL, None
    if phys == T.INT32:
        if logical == "INTEGER":
            it = lt.INTEGER
            if not it.isSigned:
                return None, f"unsigned INT({it.bitWidth}) is not read " \
                    "by this port"
            return {8: dt.INT8, 16: dt.INT16, 32: dt.INT32}.get(
                it.bitWidth), None
        if conv in (T.UINT_8, T.UINT_16, T.UINT_32):
            return None, "unsigned integers are not read by this port"
        if logical == "DATE" or conv == T.DATE:
            return dt.DATE, None
        if conv == T.INT_8:
            return dt.INT8, None
        if conv == T.INT_16:
            return dt.INT16, None
        if logical is None and conv in (None, T.INT_32):
            return dt.INT32, None
        return None, f"INT32 as {logical or T.CONVERTED_NAMES[conv]} is " \
            "not read by this port"
    if phys == T.INT64:
        if logical == "TIMESTAMP" or conv in (T.TIMESTAMP_MILLIS,
                                              T.TIMESTAMP_MICROS):
            return dt.TIMESTAMP, None
        if logical == "INTEGER":
            if not lt.INTEGER.isSigned:
                return None, "unsigned INT(64) is not read by this port"
            return dt.INT64, None
        if conv == T.UINT_64:
            return None, "unsigned integers are not read by this port"
        if logical is None and conv in (None, T.INT_64):
            return dt.INT64, None
        return None, f"INT64 as {logical or T.CONVERTED_NAMES[conv]} is " \
            "not read by this port"
    if phys == T.INT96:
        return dt.TIMESTAMP, None
    if phys == T.FLOAT:
        return dt.FLOAT32, None
    if phys == T.DOUBLE:
        return dt.FLOAT64, None
    if phys == T.BYTE_ARRAY:
        if logical == "STRING" or conv == T.UTF8:
            return dt.STRING, None
        return None, f"BYTE_ARRAY as {logical or 'BINARY'} is not read " \
            "by this port"
    return None, f"{T.TYPE_NAMES[phys] if phys is not None else phys} " \
        f"as {logical} is not read by this port"


def timestamp_scale(el: T.SchemaElement) -> Tuple[int, int]:
    """(multiply, divide) that bring the column's unit to microseconds."""
    lt = el.logicalType
    unit = lt.TIMESTAMP.unit.name if lt is not None and \
        lt.TIMESTAMP is not None else \
        "MILLIS" if el.converted_type == T.TIMESTAMP_MILLIS else "MICROS"
    return {"MILLIS": (1000, 1), "MICROS": (1, 1), "NANOS": (1, 1000)}[unit]


def to_host_lane(raw: np.ndarray, el: T.SchemaElement,
                 t: dt.DType) -> np.ndarray:
    """A decoded physical lane (one value per row, nulls zeroed) as the
    dtype's host lane."""
    if t == dt.BOOL:
        return raw.view(np.bool_)
    if t == dt.TIMESTAMP and el.type == T.INT96:
        # 8 bytes of nanoseconds within the day, then the Julian day
        rows = raw.reshape(-1, 12)
        nanos = rows[:, :8].copy().view("<i8").reshape(-1)
        day = rows[:, 8:].copy().view("<i4").reshape(-1).astype(np.int64)
        return (day - JULIAN_DAY_OF_EPOCH) * MICROS_PER_DAY + nanos // 1000
    if t == dt.TIMESTAMP:
        mul, div = timestamp_scale(el)
        if mul != 1:
            return raw * mul
        if div != 1:
            # arrow's cast: the quotient truncated toward zero
            q = raw // div
            return q + ((raw < 0) & (raw % div != 0))
        return raw
    if isinstance(t, dt.DecimalType):
        if el.type == T.FIXED_LEN_BYTE_ARRAY:
            hi, lo = _be_limbs(raw.reshape(-1, el.type_length))
            return lo if not t.is_wide else ints_of_limbs(hi, lo)
        return raw.astype(np.int64)
    if raw.dtype != t.np_physical:
        return raw.astype(t.np_physical)
    return raw


JULIAN_DAY_OF_EPOCH = 2440588
MICROS_PER_DAY = 86_400_000_000


def var_decimal_lane(offsets: np.ndarray, chars: np.ndarray,
                     t: dt.DecimalType) -> np.ndarray:
    """BYTE_ARRAY decimals (big-endian two's complement of up to 16
    bytes each) as the dtype's unscaled lane."""
    offsets = np.asarray(offsets, np.int64)
    lens = np.diff(offsets)
    if len(lens) and lens.max() > 16:
        raise ValueError(f"a BYTE_ARRAY DECIMAL of {int(lens.max())} bytes")
    n = len(lens)
    full = np.zeros((n, 16), np.uint8)
    first = chars[np.minimum(offsets[:-1], max(len(chars) - 1, 0))] \
        if len(chars) else np.zeros(n, np.uint8)
    full[(lens > 0) & (first >= 0x80)] = 0xFF
    col = np.arange(16)[None, :]
    fill = col >= (16 - lens)[:, None]
    src = offsets[:-1][:, None] + col - (16 - lens)[:, None]
    full[fill] = chars[src[fill]]
    hi, lo = _be_limbs(full)
    return lo if not t.is_wide else ints_of_limbs(hi, lo)


def _be_limbs(b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) int64 limbs of big-endian two's complement rows of
    ``b.shape[1]`` (<= 16) bytes, sign-extended."""
    n, w = b.shape
    full = np.empty((n, 16), np.uint8)
    sign = np.where(b[:, :1] >= 0x80, 0xFF, 0).astype(np.uint8) if w \
        else np.zeros((n, 1), np.uint8)
    full[:, :16 - w] = sign
    full[:, 16 - w:] = b
    hi = full[:, :8].copy().view(">i8").reshape(n).astype(np.int64)
    lo = full[:, 8:].copy().view(">u8").reshape(n).astype(np.uint64) \
        .view(np.int64)
    return hi, lo


# ---------------------------------------------------------------------------
# the writer's side
# ---------------------------------------------------------------------------

def decimal_width(precision: int) -> int:
    """The fewest bytes whose signed range holds every value of the
    precision (Arrow's and Spark's FIXED_LEN_BYTE_ARRAY width)."""
    w = 1
    while 10 ** precision - 1 >= 1 << (8 * w - 1):
        w += 1
    return w


def physical_of(t: dt.DType) -> Tuple[int, Optional[int]]:
    """(parquet physical type, type_length) the writer uses."""
    if t == dt.BOOL:
        return T.BOOLEAN, None
    if t in (dt.INT8, dt.INT16, dt.INT32, dt.DATE):
        return T.INT32, None
    if t in (dt.INT64, dt.TIMESTAMP):
        return T.INT64, None
    if t == dt.FLOAT32:
        return T.FLOAT, None
    if t == dt.FLOAT64:
        return T.DOUBLE, None
    if t == dt.STRING:
        return T.BYTE_ARRAY, None
    if isinstance(t, dt.DecimalType):
        if t.precision <= 9:
            return T.INT32, None
        if t.precision <= 18:
            return T.INT64, None
        return T.FIXED_LEN_BYTE_ARRAY, decimal_width(t.precision)
    raise NotImplementedError(f"the parquet writer does not write {t} "
                              "columns")


def schema_element(name: str, t: dt.DType) -> T.SchemaElement:
    """The OPTIONAL leaf the writer declares for a column."""
    phys, length = physical_of(t)
    el = T.SchemaElement(type=phys, type_length=length,
                         repetition_type=T.OPTIONAL, name=name)
    if t in (dt.INT8, dt.INT16):
        bits = 8 if t == dt.INT8 else 16
        el.logicalType = T.LogicalType(INTEGER=T.IntType(bitWidth=bits,
                                                         isSigned=True))
        el.converted_type = T.INT_8 if bits == 8 else T.INT_16
    elif t == dt.DATE:
        el.logicalType = T.LogicalType(DATE=T.Empty())
        el.converted_type = T.DATE
    elif t == dt.TIMESTAMP:
        el.logicalType = T.LogicalType(TIMESTAMP=T.TimestampType(
            isAdjustedToUTC=True, unit=T.TimeUnit(MICROS=T.Empty())))
        el.converted_type = T.TIMESTAMP_MICROS
    elif t == dt.STRING:
        el.logicalType = T.LogicalType(STRING=T.Empty())
        el.converted_type = T.UTF8
    elif isinstance(t, dt.DecimalType):
        el.logicalType = T.LogicalType(DECIMAL=T.DecimalType(
            scale=t.scale, precision=t.precision))
        el.converted_type = T.DECIMAL
        el.scale, el.precision = t.scale, t.precision
    return el
