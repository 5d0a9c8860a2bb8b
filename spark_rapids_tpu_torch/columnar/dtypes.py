"""Logical SQL data types mapped onto torch physical dtypes.

Counterpart of spark_rapids_tpu/columnar/dtypes.py, cut to the types the
ported path carries: booleans, integers, floats, DATE (int32 days since
the epoch, Spark's layout), TIMESTAMP (int64 microseconds since the
epoch in UTC), DECIMAL(p, s) (a scaled int64 up to p = 18, two
64-bit limbs above, see columnar/decimal128.py), STRING (offsets +
bytes, see columnar/vector.py) and the nested types (columnar/nested.py):
ARRAY (offsets + a child column), STRUCT (named children sharing the
parent validity) and MAP (physically ``array<struct<key,value>>``). ``physical`` is the torch dtype
of the data buffer and ``np_physical`` the numpy dtype of the host lane
(a wide decimal's host lane is an object array of Python ints).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch


class DType:
    """Base class for logical SQL types; one singleton per type."""

    physical: Any = None
    np_physical: Any = None
    sql_name: str = "?"

    def __repr__(self) -> str:
        return self.sql_name

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(self.sql_name)

    @property
    def is_integral(self) -> bool:
        return False

    @property
    def is_floating(self) -> bool:
        return False

    @property
    def is_nested(self) -> bool:
        return False


class BooleanType(DType):
    physical = torch.bool
    np_physical = np.dtype(np.bool_)
    sql_name = "boolean"


class _IntegralType(DType):
    @property
    def is_integral(self) -> bool:
        return True


class ByteType(_IntegralType):
    physical = torch.int8
    np_physical = np.dtype(np.int8)
    sql_name = "tinyint"


class ShortType(_IntegralType):
    physical = torch.int16
    np_physical = np.dtype(np.int16)
    sql_name = "smallint"


class IntegerType(_IntegralType):
    physical = torch.int32
    np_physical = np.dtype(np.int32)
    sql_name = "int"


class LongType(_IntegralType):
    physical = torch.int64
    np_physical = np.dtype(np.int64)
    sql_name = "bigint"


class _FloatingType(DType):
    @property
    def is_floating(self) -> bool:
        return True


class FloatType(_FloatingType):
    physical = torch.float32
    np_physical = np.dtype(np.float32)
    sql_name = "float"


class DoubleType(_FloatingType):
    physical = torch.float64
    np_physical = np.dtype(np.float64)
    sql_name = "double"


class StringType(DType):
    sql_name = "string"


class DateType(DType):
    """Days since the unix epoch, int32 (Spark's internal DateType)."""

    physical = torch.int32
    np_physical = np.dtype(np.int32)
    sql_name = "date"


class TimestampType(DType):
    """Microseconds since the unix epoch in UTC, int64 (Spark's internal
    TimestampType)."""

    physical = torch.int64
    np_physical = np.dtype(np.int64)
    sql_name = "timestamp"


class DecimalType(DType):
    """Fixed point DECIMAL(precision, scale): the unscaled value in a
    scaled int64 up to precision 18 ("long-backed", Spark's compact
    Decimal), in two limbs (hi: int64 with the sign, lo: the low 64 bits
    held in an int64) above it (columnar/decimal128.py). Equal when
    precision and scale are."""

    MAX_PRECISION = 38
    MAX_LONG_PRECISION = 18
    physical = torch.int64
    np_physical = np.dtype(np.int64)

    def __init__(self, precision: int = 10, scale: int = 0):
        if not 0 < precision <= self.MAX_PRECISION or \
                not 0 <= scale <= precision:
            raise TypeError(f"no decimal({precision},{scale})")
        self.precision = precision
        self.scale = scale
        self.sql_name = f"decimal({precision},{scale})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DecimalType) and \
            (self.precision, self.scale) == (other.precision, other.scale)

    def __hash__(self) -> int:
        return hash(self.sql_name)

    @property
    def is_wide(self) -> bool:
        return self.precision > self.MAX_LONG_PRECISION


def is_decimal(t: DType) -> bool:
    return isinstance(t, DecimalType)


def is_wide_decimal(t: DType) -> bool:
    return isinstance(t, DecimalType) and t.is_wide


def adjust_decimal_precision(precision: int, scale: int) -> DecimalType:
    """Spark's DecimalPrecision.adjustPrecisionScale with
    allowPrecisionLoss: past 38 digits keep the integral digits and cut
    the scale, but to no fewer than min(scale, 6) digits."""
    if precision <= DecimalType.MAX_PRECISION:
        return DecimalType(precision, scale)
    digits = precision - scale
    min_scale = min(scale, 6)
    return DecimalType(DecimalType.MAX_PRECISION,
                       max(DecimalType.MAX_PRECISION - digits, min_scale))


def decimal_result_type(op: str, a: DecimalType, b: DecimalType
                        ) -> DecimalType:
    """Spark's DecimalPrecision result type of a binary decimal op
    (add / sub / mul / div / mod)."""
    p1, s1, p2, s2 = a.precision, a.scale, b.precision, b.scale
    if op in ("add", "sub"):
        scale = max(s1, s2)
        prec = max(p1 - s1, p2 - s2) + scale + 1
    elif op == "mul":
        scale = s1 + s2
        prec = p1 + p2 + 1
    elif op == "div":
        scale = max(6, s1 + p2 + 1)
        prec = p1 - s1 + s2 + scale
    elif op == "mod":
        scale = max(s1, s2)
        prec = min(p1 - s1, p2 - s2) + scale
    else:
        raise TypeError(f"decimal {op} unsupported")
    return adjust_decimal_precision(prec, scale)


def wider_decimal(a: DecimalType, b: DecimalType) -> DecimalType:
    """Spark's DecimalPrecision.widerDecimalType: room for both sides'
    integral and fractional digits, bounded at 38."""
    scale = max(a.scale, b.scale)
    digits = max(a.precision - a.scale, b.precision - b.scale)
    return DecimalType(min(digits + scale, DecimalType.MAX_PRECISION),
                       min(scale, DecimalType.MAX_PRECISION))


class NullType(DType):
    physical = torch.bool
    np_physical = np.dtype(np.bool_)
    sql_name = "void"


class ArrayType(DType):
    """A list column's type: offsets + one child column of
    ``element_type`` (cuDF's LIST layout); equal when the element types
    are."""

    def __init__(self, element_type: DType):
        self.element_type = element_type
        self.sql_name = f"array<{element_type.sql_name}>"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ArrayType) and \
            self.element_type == other.element_type

    def __hash__(self) -> int:
        return hash(self.sql_name)

    @property
    def is_nested(self) -> bool:
        return True


class StructType(DType):
    """A struct column's type: named child columns sharing the parent
    validity; ``fields`` is a tuple of (name, DType)."""

    def __init__(self, fields=()):
        self.fields = tuple((str(n), t) for n, t in fields)
        inner = ",".join(f"{n}:{t.sql_name}" for n, t in self.fields)
        self.sql_name = f"struct<{inner}>"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.sql_name)

    @property
    def is_nested(self) -> bool:
        return True

    def field_names(self):
        return [n for n, _ in self.fields]

    def field_types(self):
        return [t for _, t in self.fields]


class MapType(DType):
    """A map column's type: physically ``array<struct<key,value>>``
    (cuDF's and Arrow's layout), so the list machinery that asks for
    ``element_type`` works on maps unchanged."""

    def __init__(self, key_type: DType, value_type: DType):
        self.key_type = key_type
        self.value_type = value_type
        self.sql_name = f"map<{key_type.sql_name},{value_type.sql_name}>"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, MapType) and \
            (self.key_type, self.value_type) == (other.key_type,
                                                 other.value_type)

    def __hash__(self) -> int:
        return hash(self.sql_name)

    @property
    def is_nested(self) -> bool:
        return True

    @property
    def element_type(self) -> StructType:
        return StructType((("key", self.key_type),
                           ("value", self.value_type)))


BOOL = BooleanType()
INT8 = ByteType()
INT16 = ShortType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

_BY_NAME = {t.sql_name: t for t in (BOOL, INT8, INT16, INT32, INT64, FLOAT32,
                                     FLOAT64, STRING, DATE, TIMESTAMP, NULL)}

_NUMPY_TO_DTYPE = {t.np_physical: t for t in (BOOL, INT8, INT16, INT32,
                                              INT64, FLOAT32, FLOAT64)}


class _TypeNameParser:
    """Recursive descent over a type name: the SQL names (``int``,
    ``decimal(10,2)``, ``array<int>``, ``struct<a:int,b:string>``,
    ``map<string,double>``) and the JAX package's dataclass reprs
    (``DecimalType(precision=10, scale=2)``, ``ArrayType(element_type=int,
    contains_null=True)``, ``StructType(fields=(('a', int),))``,
    ``MapType(key_type=string, value_type=double)``)."""

    _WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
    _INT = re.compile(r"\d+")
    _FIELD = re.compile(r"[A-Za-z0-9_$]+")

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def fail(self):
        raise TypeError(f"unsupported type {self.text!r}")

    def ws(self):
        while self.i < len(self.text) and self.text[self.i] == " ":
            self.i += 1

    def eat(self, tok: str) -> bool:
        self.ws()
        if self.text.startswith(tok, self.i):
            self.i += len(tok)
            return True
        return False

    def need(self, tok: str):
        if not self.eat(tok):
            self.fail()

    def match(self, pat) -> str:
        self.ws()
        m = pat.match(self.text, self.i)
        if not m:
            self.fail()
        self.i = m.end()
        return m.group(0)

    def kwarg(self, name: str):
        self.need(name)
        self.need("=")

    def quoted(self) -> str:
        self.ws()
        q = self.text[self.i:self.i + 1]
        if q not in ("'", '"'):
            self.fail()
        j = self.text.index(q, self.i + 1)
        out = self.text[self.i + 1:j]
        self.i = j + 1
        return out

    def parse(self) -> DType:
        word = self.match(self._WORD)
        if word == "decimal":
            self.need("(")
            p = int(self.match(self._INT))
            self.need(",")
            s = int(self.match(self._INT))
            self.need(")")
            return DecimalType(p, s)
        if word == "DecimalType":
            self.need("(")
            self.kwarg("precision")
            p = int(self.match(self._INT))
            self.need(",")
            self.kwarg("scale")
            s = int(self.match(self._INT))
            self.need(")")
            return DecimalType(p, s)
        if word == "array":
            self.need("<")
            et = self.parse()
            self.need(">")
            return ArrayType(et)
        if word == "ArrayType":
            self.need("(")
            self.kwarg("element_type")
            et = self.parse()
            if self.eat(","):
                self.kwarg("contains_null")
                self.match(self._WORD)
            self.need(")")
            return ArrayType(et)
        if word == "map":
            self.need("<")
            kt = self.parse()
            self.need(",")
            vt = self.parse()
            self.need(">")
            return MapType(kt, vt)
        if word == "MapType":
            self.need("(")
            self.kwarg("key_type")
            kt = self.parse()
            self.need(",")
            self.kwarg("value_type")
            vt = self.parse()
            self.need(")")
            return MapType(kt, vt)
        if word == "struct":
            self.need("<")
            fields = []
            while not self.eat(">"):
                if fields:
                    self.need(",")
                name = self.match(self._FIELD)
                self.need(":")
                fields.append((name, self.parse()))
            return StructType(tuple(fields))
        if word == "StructType":
            self.need("(")
            self.kwarg("fields")
            self.need("(")
            fields = []
            while not self.eat(")"):
                self.eat(",")
                if self.eat(")"):
                    break
                self.need("(")
                name = self.quoted()
                self.need(",")
                fields.append((name, self.parse()))
                self.need(")")
            self.need(")")
            return StructType(tuple(fields))
        try:
            return _BY_NAME[word]
        except KeyError:
            self.fail()


def from_name(sql_name: str) -> DType:
    """The type whose ``sql_name`` (its repr) is ``sql_name``, or whose
    JAX package repr it is."""
    p = _TypeNameParser(sql_name)
    t = p.parse()
    p.ws()
    if p.i != len(sql_name):
        p.fail()
    return t


def from_numpy_dtype(d) -> DType:
    d = np.dtype(d)
    if d.kind in ("U", "S", "O"):
        return STRING
    try:
        return _NUMPY_TO_DTYPE[d]
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {d}") from None


_PROMOTION_ORDER = [INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]


def promote(a: DType, b: DType) -> DType:
    """Numeric promotion for binary arithmetic, Spark-style."""
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal types meet per operator "
                        "(expr/arithmetic.py)")
    if a in _PROMOTION_ORDER and b in _PROMOTION_ORDER:
        return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a),
                                    _PROMOTION_ORDER.index(b))]
    raise TypeError(f"cannot promote {a} and {b}")


def min_value(t: DType):
    if t.is_integral or t in (DATE, TIMESTAMP) or isinstance(t, DecimalType):
        return int(np.iinfo(t.np_physical).min)
    if t.is_floating:
        return -np.inf
    if t == BOOL:
        return False
    raise TypeError(f"no min for {t}")


def max_value(t: DType):
    if t.is_integral or t in (DATE, TIMESTAMP) or isinstance(t, DecimalType):
        return int(np.iinfo(t.np_physical).max)
    if t.is_floating:
        return np.inf
    if t == BOOL:
        return True
    raise TypeError(f"no max for {t}")
