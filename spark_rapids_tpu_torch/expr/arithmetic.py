"""Arithmetic expressions with Spark semantics (non-ANSI).

Counterpart of spark_rapids_tpu/expr/arithmetic.py for the non-decimal
types: + - * follow numeric promotion, Divide always returns double and
x / 0 is null, Abs keeps its input's type, a null input gives a null
result.
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result, merged_validity


class BinaryArithmetic(Expression):
    op_name = "?"

    def _result_type(self, lt: dt.DType, rt: dt.DType) -> dt.DType:
        return dt.promote(lt, rt)

    def data_type(self, schema: Schema) -> dt.DType:
        return self._result_type(self.children[0].data_type(schema),
                                 self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        left = self.children[0].eval(batch)
        right = self.children[1].eval(batch)
        out_t = self._result_type(left.dtype, right.dtype)
        a = left.data.to(out_t.physical)
        b = right.data.to(out_t.physical)
        data, validity = self._compute(a, b, merged_validity(left, right))
        return make_result(data, validity, out_t)

    def _compute(self, a, b, validity):
        raise NotImplementedError


class Add(BinaryArithmetic):
    op_name = "+"

    def _compute(self, a, b, validity):
        return a + b, validity


class Subtract(BinaryArithmetic):
    op_name = "-"

    def _compute(self, a, b, validity):
        return a - b, validity


class Multiply(BinaryArithmetic):
    op_name = "*"

    def _compute(self, a, b, validity):
        return a * b, validity


class Divide(BinaryArithmetic):
    """Spark Divide on non-decimals: the result is double; x / 0 is
    null."""

    op_name = "/"

    def _result_type(self, lt, rt):
        return dt.FLOAT64

    def _compute(self, a, b, validity):
        nonzero = b != 0.0
        one = torch.ones((), dtype=b.dtype, device=b.device)
        data = torch.where(nonzero, a / torch.where(nonzero, b, one),
                           torch.zeros((), dtype=a.dtype, device=a.device))
        return data, validity & nonzero


class UnaryMinus(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(-c.data, c.validity, c.dtype)


class Abs(Expression):
    """abs(x): the input's type; a null input gives null. Non-ANSI, as
    the JAX package's default: abs of an integral minimum wraps to
    itself."""

    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(torch.abs(c.data), c.validity, c.dtype)
