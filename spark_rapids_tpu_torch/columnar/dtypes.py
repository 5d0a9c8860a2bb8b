"""Logical SQL data types mapped onto torch physical dtypes.

Counterpart of spark_rapids_tpu/columnar/dtypes.py, cut to the types the
ported path carries: booleans, integers, floats, DATE (int32 days since
the epoch, Spark's layout) and STRING (offsets + bytes, see
columnar/vector.py). ``physical`` is the torch dtype of the data buffer
and ``np_physical`` the numpy dtype of the host lane.
"""

from __future__ import annotations

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


class NullType(DType):
    physical = torch.bool
    np_physical = np.dtype(np.bool_)
    sql_name = "void"


BOOL = BooleanType()
INT8 = ByteType()
INT16 = ShortType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
STRING = StringType()
DATE = DateType()
NULL = NullType()

_BY_NAME = {t.sql_name: t for t in (BOOL, INT8, INT16, INT32, INT64, FLOAT32,
                                     FLOAT64, STRING, DATE, NULL)}

_NUMPY_TO_DTYPE = {t.np_physical: t for t in (BOOL, INT8, INT16, INT32,
                                              INT64, FLOAT32, FLOAT64)}


def from_name(sql_name: str) -> DType:
    """The type whose ``sql_name`` (its repr) is ``sql_name``."""
    try:
        return _BY_NAME[sql_name]
    except KeyError:
        raise TypeError(f"unsupported type {sql_name!r}") from None


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
    if a in _PROMOTION_ORDER and b in _PROMOTION_ORDER:
        return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a),
                                    _PROMOTION_ORDER.index(b))]
    raise TypeError(f"cannot promote {a} and {b}")


def min_value(t: DType):
    if t.is_integral or t == DATE:
        return int(np.iinfo(t.np_physical).min)
    if t.is_floating:
        return -np.inf
    if t == BOOL:
        return False
    raise TypeError(f"no min for {t}")


def max_value(t: DType):
    if t.is_integral or t == DATE:
        return int(np.iinfo(t.np_physical).max)
    if t.is_floating:
        return np.inf
    if t == BOOL:
        return True
    raise TypeError(f"no max for {t}")
