"""Bitwise expressions: and / or / xor / not, the shift family,
bit_count, and bit interleaving for z-order clustering.

Counterpart of spark_rapids_tpu/expr/bitwise.py (bitwise.scala,
zorder/GpuInterleaveBits). Shifts follow Java: byte, short and int
shift as INT, long as LONG, and the count is taken modulo the result's
width. ``>>>`` is torch's arithmetic shift with the sign-copied top bits
cleared (torch has no unsigned 64-bit shift), ``bit_count`` a popcount
of the two 32-bit halves.
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result, merged_validity


class _BitwiseBinary(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.promote(self.children[0].data_type(schema),
                          self.children[1].data_type(schema))

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        out_t = self.data_type(batch.schema())
        phys = out_t.physical
        return make_result(self._op(a.data.to(phys), b.data.to(phys)),
                           merged_validity(a, b), out_t)


class BitwiseAnd(_BitwiseBinary):
    def _op(self, a, b):
        return a & b


class BitwiseOr(_BitwiseBinary):
    def _op(self, a, b):
        return a | b


class BitwiseXor(_BitwiseBinary):
    def _op(self, a, b):
        return a ^ b


class BitwiseNot(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return self.children[0].data_type(schema)

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(~c.data, c.validity, c.dtype)


class ShiftLeft(Expression):
    """shiftleft(x, n): Java's ``<<``."""

    def data_type(self, schema: Schema) -> dt.DType:
        t = self.children[0].data_type(schema)
        return dt.INT64 if t == dt.INT64 else dt.INT32

    def _operands(self, batch: ColumnarBatch):
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        out_t = self.data_type(batch.schema())
        width = 64 if out_t == dt.INT64 else 32
        x = a.data.to(out_t.physical)
        n = (b.data.to(torch.int32) & (width - 1)).to(x.dtype)
        return x, n, merged_validity(a, b), out_t, width

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        x, n, validity, out_t, _ = self._operands(batch)
        return make_result(x << n, validity, out_t)


class ShiftRight(ShiftLeft):
    """Arithmetic (sign-extending) right shift, Java's ``>>``."""

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        x, n, validity, out_t, _ = self._operands(batch)
        return make_result(x >> n, validity, out_t)


class ShiftRightUnsigned(ShiftLeft):
    """Logical right shift, Java's ``>>>``: the arithmetic shift with
    the ``n`` sign-copied top bits cleared."""

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        x, n, validity, out_t, width = self._operands(batch)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        mask = torch.where(n > 0, (one << (width - n)) - 1, -one)
        return make_result((x >> n) & mask, validity, out_t)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of int64 lanes holding values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


class BitCount(Expression):
    """bit_count(x): the set bits of x's two's complement at its width
    (a boolean counts as 0 or 1)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        x = c.data
        if x.dtype == torch.bool:
            return make_result(x.to(torch.int32), c.validity, dt.INT32)
        x = x.to(torch.int64)
        if c.data.dtype == torch.int64:
            n = _popcount32(x & 0xFFFFFFFF) + _popcount32((x >> 32) &
                                                          0xFFFFFFFF)
        else:
            n = _popcount32(x & 0xFFFFFFFF)
        return make_result(n.to(torch.int32), c.validity, dt.INT32)


class InterleaveBits(Expression):
    """z-order key: the top ``63 // k`` bits of each of k = 1..4 columns
    interleaved into a long (zorder/GpuInterleaveBits). Each value is
    first mapped to unsigned order within its own width (a long by its
    sign bit, a narrower integral by adding 2^(width - 1)), as the
    reference's ZOrder kernel does, so negative numbers cluster."""

    def __init__(self, *children: Expression):
        super().__init__(*children)
        if not 1 <= len(children) <= 4:
            raise TypeError("interleave_bits takes 1-4 columns")

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        cols = [c.eval(batch) for c in self.children]
        k = len(cols)
        bits_per = 63 // k
        parts = []
        for c in cols:
            width = 64 if c.dtype == dt.INT64 else 32
            x = c.data.to(torch.int64)
            u = x ^ (-(2 ** 63)) if width == 64 else x + 2 ** (width - 1)
            parts.append((u >> (width - bits_per)) & (2 ** bits_per - 1))
        out = torch.zeros_like(parts[0])
        for bit in range(bits_per):
            for ci, p in enumerate(parts):
                out = out | (((p >> bit) & 1) << (bit * k + ci))
        return make_result(out, merged_validity(*cols), dt.INT64)
