"""Collection expressions over list columns.

Counterpart of spark_rapids_tpu/expr/collections.py, cut to ``Size``,
which ``COUNT(DISTINCT x)`` lowers onto (``size(collect_set(x))``).
Array constructors, element access and the rest wait for the nested
types (columnar/nested.py holds lists only).
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result


class Size(Expression):
    """size(array): the element count; a null list is null."""

    def __init__(self, child: Expression):
        super().__init__(child)

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        if not isinstance(t, dt.ArrayType):
            raise TypeError(f"size() needs an array, got {t}")
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        lc = self.children[0].eval(batch)
        return make_result(lc.lengths().to(torch.int32), lc.validity,
                           dt.INT32)
