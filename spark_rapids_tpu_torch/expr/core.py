"""Expression IR core.

Counterpart of spark_rapids_tpu/expr/core.py. An expression tree lowers
to torch ops over ColumnVector buffers, evaluated eagerly. Null
semantics are SQL three-valued logic carried in the validity mask: a
scalar function's result is null iff an input is null (And/Or use
Kleene logic, predicates.py), and data lanes under a null are zeroed.
"""

from __future__ import annotations

import datetime
import decimal
from typing import List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (Column, ColumnVector, ColumnarBatch,
                               StringColumn, null_column, round_pow2)

Schema = Sequence  # [(name, DType), ...]


class Expression:
    """Base expression node. Immutable; children in ``children``."""

    def __init__(self, *children: "Expression"):
        self.children: List[Expression] = list(children)

    def data_type(self, schema: Schema) -> dt.DType:
        raise NotImplementedError

    def references(self) -> set:
        refs = set()
        for c in self.children:
            refs |= c.references()
        return refs

    def eval(self, batch: ColumnarBatch) -> Column:
        raise NotImplementedError

    # --- tree-building sugar (Spark's Column DSL) ---
    def __add__(self, other):
        from .arithmetic import Add
        return Add(self, _lit(other))

    def __radd__(self, other):
        from .arithmetic import Add
        return Add(_lit(other), self)

    def __sub__(self, other):
        from .arithmetic import Subtract
        return Subtract(self, _lit(other))

    def __rsub__(self, other):
        from .arithmetic import Subtract
        return Subtract(_lit(other), self)

    def __mul__(self, other):
        from .arithmetic import Multiply
        return Multiply(self, _lit(other))

    def __rmul__(self, other):
        from .arithmetic import Multiply
        return Multiply(_lit(other), self)

    def __truediv__(self, other):
        from .arithmetic import Divide
        return Divide(self, _lit(other))

    def __mod__(self, other):
        from .arithmetic import Remainder
        return Remainder(self, _lit(other))

    def __neg__(self):
        from .arithmetic import UnaryMinus
        return UnaryMinus(self)

    def __eq__(self, other):  # type: ignore[override]
        from .predicates import EqualTo
        return EqualTo(self, _lit(other))

    def __ne__(self, other):  # type: ignore[override]
        from .predicates import EqualTo, Not
        return Not(EqualTo(self, _lit(other)))

    def __lt__(self, other):
        from .predicates import LessThan
        return LessThan(self, _lit(other))

    def __le__(self, other):
        from .predicates import LessThanOrEqual
        return LessThanOrEqual(self, _lit(other))

    def __gt__(self, other):
        from .predicates import GreaterThan
        return GreaterThan(self, _lit(other))

    def __ge__(self, other):
        from .predicates import GreaterThanOrEqual
        return GreaterThanOrEqual(self, _lit(other))

    def __and__(self, other):
        from .predicates import And
        return And(self, _lit(other))

    def __or__(self, other):
        from .predicates import Or
        return Or(self, _lit(other))

    def __invert__(self):
        from .predicates import Not
        return Not(self)

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def is_not_null(self):
        from .predicates import IsNotNull
        return IsNotNull(self)

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__}({args})"


def _lit(v):
    return v if isinstance(v, Expression) else Literal(v)


class ColumnRef(Expression):
    """Reference to a named input column."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def data_type(self, schema: Schema) -> dt.DType:
        for n, t in schema:
            if n == self.name:
                return t
        raise KeyError(f"column {self.name!r} not in schema "
                       f"{[n for n, _ in schema]}")

    def references(self) -> set:
        return {self.name}

    def eval(self, batch: ColumnarBatch) -> Column:
        return batch.column(self.name)

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def _infer_literal_dtype(value) -> dt.DType:
    if value is None:
        return dt.NULL
    if isinstance(value, bool):
        return dt.BOOL
    if isinstance(value, int):
        if -(2 ** 31) <= value < 2 ** 31:
            return dt.INT32
        if -(2 ** 63) <= value < 2 ** 63:
            return dt.INT64
        # past BIGINT Spark types an integral literal DECIMAL(digits, 0);
        # past 38 digits its analysis fails
        digits = len(str(abs(value)))
        if digits > dt.DecimalType.MAX_PRECISION:
            raise TypeError(f"integral literal needs precision {digits} "
                            "> 38")
        return dt.DecimalType(digits, 0)
    if isinstance(value, decimal.Decimal):
        # its own precision and scale (Spark's Literal of a BigDecimal)
        sign, digits, exp = value.as_tuple()
        scale = max(-exp, 0)
        return dt.DecimalType(max(len(digits) + max(exp, 0), scale + 1,
                                  1), scale)
    if isinstance(value, float):
        return dt.FLOAT64
    if isinstance(value, str):
        return dt.STRING
    if isinstance(value, datetime.datetime):
        return dt.TIMESTAMP
    if isinstance(value, datetime.date):
        return dt.DATE
    raise TypeError(f"no literal of {type(value).__name__} {value!r} in "
                    "this port yet")


def literal_physical(value, dtype: dt.DType):
    """The physical lane value of a literal (DATE -> int days, TIMESTAMP
    -> int microseconds since the epoch; a datetime without a zone
    reads as UTC)."""
    if dtype == dt.TIMESTAMP and isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=datetime.timezone.utc)
        delta = value - datetime.datetime(1970, 1, 1,
                                          tzinfo=datetime.timezone.utc)
        return (delta.days * 86_400 + delta.seconds) * 1_000_000 + \
            delta.microseconds
    if dtype == dt.DATE and isinstance(value, datetime.date):
        return (value - datetime.date(1970, 1, 1)).days
    if isinstance(dtype, dt.DecimalType):
        from ..columnar.vector import decimal_unscaled
        return decimal_unscaled(value, dtype)
    return value


class Literal(Expression):
    """A scalar constant broadcast over the batch's live rows."""

    def __init__(self, value, dtype: Optional[dt.DType] = None):
        super().__init__()
        self.value = value
        self.dtype = dtype or _infer_literal_dtype(value)

    def data_type(self, schema: Schema) -> dt.DType:
        return self.dtype

    def eval(self, batch: ColumnarBatch) -> Column:
        cap, live = batch.capacity, batch.live_mask()
        if self.value is None:
            return null_column(self.dtype, cap, batch.device)
        if self.dtype == dt.STRING:
            return _string_literal_column(self.value.encode("utf-8"), live)
        if dt.is_wide_decimal(self.dtype):
            from ..columnar.decimal128 import Decimal128Column, _signed
            v = literal_physical(self.value, self.dtype)
            hi, lo = (torch.full((cap,), w, dtype=torch.int64,
                                 device=batch.device)
                      for w in (v >> 64, _signed(v)))
            return Decimal128Column(hi, lo, live, self.dtype) \
                .with_validity(live)
        phys = self.dtype.physical
        data = torch.full((cap,), literal_physical(self.value, self.dtype),
                          dtype=phys, device=batch.device)
        zero = torch.zeros((), dtype=phys, device=batch.device)
        return ColumnVector(torch.where(live, data, zero), live, self.dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def _string_literal_column(raw: bytes, live: torch.Tensor) -> StringColumn:
    """The literal's bytes on every live row (dead rows empty)."""
    dev = live.device
    lens = live.to(torch.int64) * len(raw)
    offsets = torch.zeros(live.shape[0] + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0).to(torch.int32)
    n_live = int(live.sum())
    pattern = torch.tensor(list(raw), dtype=torch.uint8, device=dev)
    chars = torch.zeros(max(-(-n_live * len(raw) // 128) * 128, 128),
                        dtype=torch.uint8, device=dev)
    chars[:n_live * len(raw)] = pattern.repeat(n_live)
    return StringColumn(offsets, chars, live.clone(),
                        pad_bucket=round_pow2(len(raw)))


def lit(value, dtype: Optional[dt.DType] = None) -> Literal:
    return Literal(value, dtype)


class Alias(Expression):
    """Named output expression."""

    def __init__(self, child: Expression, name: str):
        super().__init__(child)
        self.name = name

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> Column:
        return self.children[0].eval(batch)

    def __repr__(self):
        return f"{self.children[0]!r}.alias({self.name!r})"


def output_name(expr: Expression, index: int) -> str:
    """Output column name for a projection list entry."""
    if isinstance(expr, (Alias, ColumnRef)):
        return expr.name
    return f"_c{index}"


def cpu_fallback(what: str, rule: str) -> NotImplementedError:
    """The guard a device evaluator raises on what only the CPU engine
    runs. The planner's ``rule`` (plan/overrides.py) tags such an
    expression off the device, so reaching this is a planner fault: the
    port never falls back quietly."""
    return NotImplementedError(
        f"{what} runs on the CPU engine: the planner's {rule} "
        "should have tagged it off the device (a planner fault)")


def true_div(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x / p`` correctly rounded on every device. On CUDA, PyTorch
    divides a tensor by a Python number as a multiply by its reciprocal,
    which can be one unit in the last place off (a decimal rounding's
    midpoint test then flips); dividing by a tensor divides."""
    return x / torch.tensor(p, dtype=x.dtype, device=x.device)


def merged_validity(*cols: Column) -> torch.Tensor:
    v = cols[0].validity
    for c in cols[1:]:
        v = v & c.validity
    return v


def make_result(data: torch.Tensor, validity: torch.Tensor,
                dtype: dt.DType) -> ColumnVector:
    """Standard result construction: zero data lanes under nulls."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return ColumnVector(torch.where(validity, data, zero), validity, dtype)
