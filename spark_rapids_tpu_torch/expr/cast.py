"""Cast between numeric, boolean and date types.

Counterpart of spark_rapids_tpu/expr/cast.py (``Cast``, ``cast_column``)
for the types this port carries, with Spark's non-ANSI semantics:

- integral narrowing wraps (Java narrowing conversion),
- float -> integral truncates toward zero and saturates, NaN -> 0,
- numeric -> boolean is x != 0; boolean -> numeric is 0 / 1,
- date -> integral is its day number.

Casts from and to strings, decimals and timestamps are not in this port
yet and raise TypeError.
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

    def eval(self, batch: ColumnarBatch) -> Column:
        return cast_column(self.children[0].eval(batch), self.to)

    def __repr__(self):
        return f"Cast({self.children[0]!r}, {self.to!r})"


def cast_column(c: Column, to: dt.DType) -> Column:
    src = c.dtype
    if src == to:
        return c
    if isinstance(c, StringColumn) or to == dt.STRING or \
            to.physical is None:
        raise TypeError(f"cast {src} -> {to} is not in this port yet")
    data, validity = c.data, c.validity
    if to == dt.BOOL:
        return make_result(data != 0, validity, to)
    if src == dt.BOOL:
        return make_result(data.to(to.physical), validity, to)
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
