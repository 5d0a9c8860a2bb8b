"""Conditional expressions: IF / CASE WHEN / COALESCE / NULLIF / NVL /
NVL2.

Counterpart of spark_rapids_tpu/expr/conditional.py. Every branch is
evaluated over the whole batch, then rows are selected (the columnar
"evaluate all branches, then select" semantics); a null condition takes
the else branch. String results are repacked into fresh offsets and
chars, so null rows keep zero-length extents.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import Column, ColumnarBatch, StringColumn
from .core import Expression, Literal, Schema, make_result


def _common_type(types: List[dt.DType]) -> dt.DType:
    """The type a set of branch types meets at: NULL gives way to any
    other type, numerics promote (dtypes.promote), decimals meet at
    their wider decimal (an integral as its exact decimal; a float
    makes it DOUBLE)."""
    out = types[0]
    for t in types[1:]:
        if t == dt.NULL:
            continue
        if out == dt.NULL:
            out = t
        elif out != t:
            if dt.is_decimal(out) or dt.is_decimal(t):
                from .arithmetic import _least_greatest_type
                out = _least_greatest_type([out, t])
            else:
                out = dt.promote(out, t)
    return out


def _as_string(c: Column) -> StringColumn:
    """An all-null non-string column (a NULL literal) as an empty string
    column, so a string select has two string operands."""
    if isinstance(c, StringColumn):
        return c
    cap, dev = c.capacity, c.device
    return StringColumn(torch.zeros(cap + 1, dtype=torch.int32, device=dev),
                        torch.zeros(128, dtype=torch.uint8, device=dev),
                        torch.zeros(cap, dtype=torch.bool, device=dev),
                        pad_bucket=8)


def _select(cond: torch.Tensor, a: Column, b: Column,
            out_t: dt.DType) -> Column:
    """Row-wise ``a`` where ``cond`` else ``b``, as ``out_t``."""
    if out_t == dt.STRING or isinstance(a, StringColumn) or \
            isinstance(b, StringColumn):
        return _select_strings(cond, _as_string(a), _as_string(b))
    if dt.is_decimal(out_t) or dt.is_decimal(a.dtype) or \
            dt.is_decimal(b.dtype):
        from .cast import cast_column
        a, b = cast_column(a, out_t), cast_column(b, out_t)
        if dt.is_wide_decimal(out_t):
            from ..columnar.decimal128 import Decimal128Column
            return Decimal128Column(
                torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo),
                torch.where(cond, a.validity, b.validity), out_t
            ).with_validity(torch.where(cond, a.validity, b.validity))
    phys = out_t.physical
    data = torch.where(cond, a.data.to(phys), b.data.to(phys))
    return make_result(data, torch.where(cond, a.validity, b.validity),
                       out_t)


def _select_strings(cond: torch.Tensor, a: StringColumn,
                    b: StringColumn) -> StringColumn:
    """String select: each row's bytes copied from the chosen column
    into a new buffer sized to the selected total."""
    dev = cond.device
    validity = torch.where(cond, a.validity, b.validity)
    lens = torch.where(validity, torch.where(cond, a.lengths(),
                                             b.lengths()), 0).to(torch.int64)
    cap = lens.shape[0]
    ends = torch.cumsum(lens, 0)
    offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    offsets[1:] = ends.to(torch.int32)
    total = int(ends[-1]) if cap else 0
    chars = torch.zeros(max(-(-total // 128) * 128, 128), dtype=torch.uint8,
                        device=dev)
    if total:
        row = torch.repeat_interleave(torch.arange(cap, device=dev), lens,
                                      output_size=total)
        within = torch.arange(total, device=dev) - (ends - lens)[row]
        sa = (a.offsets[:-1].to(torch.int64)[row] + within).clamp(
            0, a.char_capacity - 1)
        sb = (b.offsets[:-1].to(torch.int64)[row] + within).clamp(
            0, b.char_capacity - 1)
        chars[:total] = torch.where(cond[row], a.chars[sa], b.chars[sb])
    return StringColumn(offsets, chars, validity,
                        pad_bucket=max(a.pad_bucket, b.pad_bucket))


def _eval_reached(e: Expression, batch: ColumnarBatch, rows) -> Column:
    """``e`` over the batch; a guard in it fires only on ``rows``, the
    rows the conditional selects it for (expr/ansi.py)."""
    from .ansi import evaluate_reached
    return evaluate_reached(e, batch, rows, lambda x: x.eval(batch))


def _as_type(result: Column, out_t: dt.DType) -> Column:
    """A lone branch's column at the expression's type."""
    if isinstance(result, StringColumn) or result.dtype == out_t:
        return result
    if dt.is_decimal(out_t):
        from .cast import cast_column
        return cast_column(result, out_t)
    return make_result(result.data.to(out_t.physical), result.validity,
                       out_t)


class If(Expression):
    """if(cond, a, b); a null cond selects ``b`` (Spark semantics)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return _common_type([self.children[1].data_type(schema),
                             self.children[2].data_type(schema)])

    def eval(self, batch: ColumnarBatch) -> Column:
        cond = self.children[0].eval(batch)
        take = cond.data & cond.validity
        a = _eval_reached(self.children[1], batch, take)
        b = _eval_reached(self.children[2], batch, ~take)
        return _select(take, a, b, self.data_type(batch.schema()))


class CaseWhen(Expression):
    """CASE WHEN ... THEN ... [ELSE ...] END; no ELSE is ELSE NULL."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 otherwise: Optional[Expression] = None):
        self.branches = branches
        self.otherwise = otherwise if otherwise is not None else Literal(None)
        children = []
        for c, v in branches:
            children.extend([c, v])
        children.append(self.otherwise)
        super().__init__(*children)

    def data_type(self, schema: Schema) -> dt.DType:
        ts = [v.data_type(schema) for _, v in self.branches]
        ts.append(self.otherwise.data_type(schema))
        return _common_type(ts)

    def eval(self, batch: ColumnarBatch) -> Column:
        out_t = self.data_type(batch.schema())
        # a WHEN is reached by the rows no earlier WHEN took, its THEN by
        # those it takes
        open_rows = batch.live_mask()
        picked = []
        for cond_e, val_e in self.branches:
            cond = _eval_reached(cond_e, batch, open_rows)
            take = cond.data & cond.validity
            picked.append((take, _eval_reached(val_e, batch,
                                               open_rows & take)))
            open_rows = open_rows & ~take
        result = _eval_reached(self.otherwise, batch, open_rows)
        # from the last branch backwards, so the first matching WHEN wins
        for take, val in reversed(picked):
            result = _select(take, val, result, out_t)
        return _as_type(result, out_t)


class Coalesce(Expression):
    """The first non-null argument."""

    def data_type(self, schema: Schema) -> dt.DType:
        return _common_type([c.data_type(schema) for c in self.children])

    def eval(self, batch: ColumnarBatch) -> Column:
        out_t = self.data_type(batch.schema())
        # an argument is reached by the rows every earlier one left null
        open_rows = batch.live_mask()
        cols = []
        for e in self.children:
            c = _eval_reached(e, batch, open_rows)
            cols.append(c)
            open_rows = open_rows & ~c.validity
        result = cols[-1]
        for c in reversed(cols[:-1]):
            result = _select(c.validity, c, result, out_t)
        return _as_type(result, out_t)


class NullIf(Expression):
    """nullif(a, b): null where a == b, else a."""

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> Column:
        from .predicates import EqualTo
        a = self.children[0].eval(batch)
        eq = EqualTo(self.children[0], self.children[1]).eval(batch)
        kill = eq.data & eq.validity
        return _select(kill, Literal(None).eval(batch), a, a.dtype)


class Nvl(Coalesce):
    """nvl(a, b) == coalesce(a, b)."""


class Nvl2(Expression):
    """nvl2(a, b, c): b where a is not null, else c."""

    def data_type(self, schema: Schema) -> dt.DType:
        return _common_type([self.children[1].data_type(schema),
                             self.children[2].data_type(schema)])

    def eval(self, batch: ColumnarBatch) -> Column:
        a = self.children[0].eval(batch)
        b = _eval_reached(self.children[1], batch, a.validity)
        c = _eval_reached(self.children[2], batch, ~a.validity)
        return _select(a.validity, b, c, self.data_type(batch.schema()))
