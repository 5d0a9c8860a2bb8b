"""Row-position expressions.

Counterpart of spark_rapids_tpu/expr/misc.py, cut to
``MonotonicallyIncreasingID``, which the analyzer's EXISTS-with-residual
rewrite tags rows with. The projection that evaluates it binds the
stream position of its batch's first row (``row_offset``): ids are that
offset plus the row's index, so they are unique across every batch of a
run and the same in two runs of one plan. Outside such a binding the
offset is 0, as in the JAX package. One partition runs, so the
partition id bits (``pid << 33``) are 0.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result

_CTX = threading.local()


@contextlib.contextmanager
def row_offset(offset: int):
    """Bind the stream position of the next evaluated batch's row 0."""
    prev = getattr(_CTX, "offset", 0)
    _CTX.offset = int(offset)
    try:
        yield
    finally:
        _CTX.offset = prev


class MonotonicallyIncreasingID(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        ids = torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.device) + getattr(_CTX, "offset", 0)
        return make_result(ids, batch.live_mask(), dt.INT64)

    def __repr__(self):
        return "monotonically_increasing_id()"


def monotonically_increasing_id() -> MonotonicallyIncreasingID:
    return MonotonicallyIncreasingID()


def uses_row_position(exprs) -> bool:
    def walk(e):
        return isinstance(e, MonotonicallyIncreasingID) or \
            any(walk(c) for c in e.children)
    return any(walk(e) for e in exprs)
