"""Per-operator type-support signatures (TypeSig).

Counterpart of spark_rapids_tpu/plan/typechecks.py (TypeChecks.scala's
role): every expression rule declares which input types it takes on the
device; the tagging pass (meta.py) consults these to decide what runs
on the CPU engine, and ``overrides.generate_supported_ops_doc`` renders
the signatures as a table.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

from ..columnar import dtypes as dt

# type tags
BOOLEAN = "BOOLEAN"
BYTE = "BYTE"
SHORT = "SHORT"
INT = "INT"
LONG = "LONG"
FLOAT = "FLOAT"
DOUBLE = "DOUBLE"
STRING = "STRING"
DATE = "DATE"
TIMESTAMP = "TIMESTAMP"
DECIMAL_64 = "DECIMAL_64"  # long-backed decimal, precision <= 18
DECIMAL_128 = "DECIMAL_128"  # two-limb decimal, precision 19..38
NULL = "NULL"
ARRAY = "ARRAY"
STRUCT = "STRUCT"
MAP = "MAP"

ALL_TAGS = [BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, DATE,
            TIMESTAMP, DECIMAL_64, DECIMAL_128, NULL, ARRAY, STRUCT, MAP]


def tag_of(t: dt.DType) -> str:
    if isinstance(t, dt.BooleanType):
        return BOOLEAN
    if isinstance(t, dt.ByteType):
        return BYTE
    if isinstance(t, dt.ShortType):
        return SHORT
    if isinstance(t, dt.IntegerType):
        return INT
    if isinstance(t, dt.LongType):
        return LONG
    if isinstance(t, dt.FloatType):
        return FLOAT
    if isinstance(t, dt.DoubleType):
        return DOUBLE
    if isinstance(t, dt.StringType):
        return STRING
    if isinstance(t, dt.DateType):
        return DATE
    if isinstance(t, dt.TimestampType):
        return TIMESTAMP
    if isinstance(t, dt.DecimalType):
        return DECIMAL_128 if t.precision > 18 else DECIMAL_64
    if isinstance(t, dt.NullType):
        return NULL
    if isinstance(t, dt.ArrayType):
        return ARRAY
    if isinstance(t, dt.StructType):
        return STRUCT
    if isinstance(t, dt.MapType):
        return MAP
    raise TypeError(f"unknown dtype {t}")


class TypeSig:
    """A set of supported type tags (TypeChecks.scala TypeSig)."""

    def __init__(self, *tags: str):
        self.tags: FrozenSet[str] = frozenset(tags)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        out = TypeSig()
        out.tags = self.tags | other.tags
        return out

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        out = TypeSig()
        out.tags = self.tags - other.tags
        return out

    def supports(self, t: dt.DType) -> bool:
        return tag_of(t) in self.tags

    def reason_if_unsupported(self, t: dt.DType,
                              what: str) -> Optional[str]:
        if self.supports(t):
            return None
        return f"{what}: type {t} not supported on the device"

    def __repr__(self):
        return "TypeSig(" + ", ".join(sorted(self.tags)) + ")"


# common signatures
integral = TypeSig(BYTE, SHORT, INT, LONG)
fp = TypeSig(FLOAT, DOUBLE)
decimal128 = TypeSig(DECIMAL_128)
numeric = integral + fp + TypeSig(DECIMAL_64)
numeric_all = numeric + decimal128
numeric_no_decimal = integral + fp
comparable = numeric + TypeSig(BOOLEAN, STRING, DATE, TIMESTAMP)
orderable = comparable
all_basic = comparable + TypeSig(NULL)
all_basic_128 = all_basic + decimal128
none_sig = TypeSig()
