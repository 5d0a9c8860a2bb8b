"""Casts between numeric, boolean, date, timestamp and string types.

Counterpart of spark_rapids_tpu/expr/cast.py (``Cast``,
``cast_column``) for the types this port carries, with Spark's
non-ANSI semantics:

- integral narrowing wraps (Java narrowing conversion),
- float -> integral truncates toward zero and saturates, NaN -> 0,
- numeric -> boolean is x != 0; boolean -> numeric is 0 / 1,
- date -> integral is its day number,
- date <-> timestamp through the day's midnight in UTC, timestamp ->
  integral its whole seconds (floored), integral -> timestamp seconds,
- to and from STRING as expr/strings.py formats and parses them (a
  row that does not parse is null).

``check_supported`` refuses, when the plan is made, what the port
cannot cast (STRING -> TIMESTAMP, TIMESTAMP -> float, decimals).
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import Column, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DType):
        super().__init__(child)
        self.to = to

    def data_type(self, schema: Schema) -> dt.DType:
        return self.to

    def check_supported(self, schema: Schema) -> None:
        """Raise TypeError where this port has no such cast."""
        src = self.children[0].data_type(schema)
        if not supported(src, self.to):
            raise TypeError(f"cast {src} -> {self.to} is not in this port "
                            "yet")

    def eval(self, batch: ColumnarBatch) -> Column:
        return cast_column(self.children[0].eval(batch), self.to)

    def __repr__(self):
        return f"Cast({self.children[0]!r}, {self.to!r})"


def _numeric(t: dt.DType) -> bool:
    return t.is_integral or t.is_floating or t == dt.BOOL


def supported(src: dt.DType, to: dt.DType) -> bool:
    """Whether cast_column takes ``src`` -> ``to``."""
    if src == to or src == dt.NULL:
        return True
    if to == dt.STRING:
        return _numeric(src) or src in (dt.DATE, dt.TIMESTAMP)
    if src == dt.STRING:
        return _numeric(to) or to == dt.DATE
    if src == dt.TIMESTAMP:
        return to == dt.DATE or to.is_integral
    if to == dt.TIMESTAMP:
        return src == dt.DATE or src.is_integral
    if src == dt.DATE:
        return to.is_integral or to.is_floating or to == dt.BOOL
    return _numeric(src) and (_numeric(to) or to == dt.DATE)


def cast_column(c: Column, to: dt.DType) -> Column:
    src = c.dtype
    if src == to:
        return c
    if isinstance(c, StringColumn):
        from .strings import cast_from_string
        return cast_from_string(c, to)
    if to == dt.STRING:
        from .strings import cast_to_string
        return cast_to_string(c)
    if to.physical is None or not supported(src, to):
        raise TypeError(f"cast {src} -> {to} is not in this port yet")
    data, validity = c.data, c.validity
    if src == dt.DATE and to == dt.TIMESTAMP:
        return make_result(data.to(torch.int64) * 86_400_000_000, validity,
                           to)
    if src == dt.TIMESTAMP:
        if to == dt.DATE:
            return make_result((data // 86_400_000_000).to(torch.int32),
                               validity, to)
        return make_result((data // 1_000_000).to(to.physical), validity,
                           to)
    if to == dt.TIMESTAMP:
        return make_result(data.to(torch.int64) * 1_000_000, validity, to)
    if to == dt.BOOL:
        return make_result(data != 0, validity, to)
    if src == dt.BOOL:
        return make_result(data.to(to.physical), validity, to)
    if src.is_floating and to in (dt.INT8, dt.INT16):
        # Spark's non-ANSI cast: toInt (saturating at INT's range), then a
        # two's-complement wrap to the target width (the JAX package
        # saturates at the target's range)
        as_int = cast_column(c, dt.INT32)
        return make_result(as_int.data.to(to.physical), validity, to)
    if src.is_floating and to.is_integral:
        x = torch.where(torch.isnan(data), torch.zeros((), dtype=data.dtype,
                                                       device=data.device),
                        data)
        imin, imax = dt.min_value(to), dt.max_value(to)
        # float64(2**63 - 1) rounds up to 2**63: saturate explicitly
        hi_bound = float(2 ** 63) if to == dt.INT64 else float(imax)
        clamped = torch.trunc(x.to(torch.float64).clamp(float(imin),
                                                        hi_bound))
        top = torch.full((), imax, dtype=to.physical, device=data.device)
        out = torch.where(clamped >= hi_bound, top, clamped.to(to.physical))
        return make_result(out, validity, to)
    if (src.is_integral or src == dt.DATE) and to.is_integral:
        # Java narrowing: two's-complement wrap to the target width
        return make_result(data.to(torch.int64).to(to.physical), validity,
                           to)
    # everything else: a plain convert (int -> float, float widening or
    # narrowing, int -> date)
    return make_result(data.to(to.physical), validity, to)
