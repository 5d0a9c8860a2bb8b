"""Bitwise expressions.

Counterpart of spark_rapids_tpu/expr/bitwise.py, cut to what
``GROUPING()`` lowers onto: ``(__grouping_id >> (n - 1 - i)) & 1``.
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result, merged_validity


class BitwiseAnd(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.promote(self.children[0].data_type(schema),
                          self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        out_t = self.data_type(batch.schema())
        phys = out_t.physical
        return make_result(a.data.to(phys) & b.data.to(phys),
                           merged_validity(a, b), out_t)


class ShiftRight(Expression):
    """Arithmetic (sign-extending) right shift, Java's ``>>``: byte,
    short and int shift as INT, long as LONG, and the count is taken
    modulo the result's width."""

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        return dt.INT64 if t == dt.INT64 else dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        out_t = self.data_type(batch.schema())
        width = 64 if out_t == dt.INT64 else 32
        x = a.data.to(out_t.physical)
        n = (b.data.to(torch.int32) & (width - 1)).to(x.dtype)
        return make_result(x >> n, merged_validity(a, b), out_t)
