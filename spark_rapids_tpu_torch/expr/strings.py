"""String expressions over the Arrow layout (int32 offsets + uint8 chars).

Counterpart of spark_rapids_tpu/expr/strings.py to the depth TPC-H q3
and the string-filtered aggregates need: ``StartsWith``, and the byte
comparisons behind string ``=`` / ``IN`` (expr/predicates.py) and join
key verification (ops/kernels.py). Every comparison reads the offsets
and chars directly; none builds a padded copy. UTF-8 byte order is Spark
string order, so byte equality is string equality.
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result


def utf8(value: str) -> bytes:
    return value.encode("utf-8")


def match_literal(col: StringColumn, lit: bytes,
                  prefix: bool = False) -> torch.Tensor:
    """bool[capacity]: row equals ``lit`` (or starts with it when
    ``prefix``). The length test comes first, so a byte read past a
    shorter row never decides the result."""
    starts = col.offsets[:-1].to(torch.int64)
    lens = col.lengths()
    m = len(lit)
    hit = lens >= m if prefix else lens == m
    if m and col.char_capacity:
        last = col.char_capacity - 1
        for j, byte in enumerate(lit):
            hit = hit & (col.chars[(starts + j).clamp(max=last)] == byte)
    elif m:
        hit = torch.zeros_like(hit)
    return hit


def pairs_equal(a: StringColumn, a_idx: torch.Tensor, b: StringColumn,
                b_idx: torch.Tensor) -> torch.Tensor:
    """bool per pair k: bytes of a[a_idx[k]] == bytes of b[b_idx[k]]
    (validity is the caller's business). Pairs of equal length compare
    their bytes in one flat pass over exactly those bytes."""
    la = a.lengths()[a_idx].to(torch.int64)
    lb = b.lengths()[b_idx].to(torch.int64)
    same_len = la == lb
    lens = torch.where(same_len, la, 0)
    total = int(lens.sum()) if lens.numel() else 0
    if total == 0:
        return same_len
    npairs = a_idx.shape[0]
    pair = torch.repeat_interleave(torch.arange(npairs, device=a.device),
                                   lens, output_size=total)
    ends = torch.cumsum(lens, 0)
    within = torch.arange(total, device=a.device) - (ends - lens)[pair]
    sa = a.offsets[:-1][a_idx].to(torch.int64)[pair] + within
    sb = b.offsets[:-1][b_idx].to(torch.int64)[pair] + within
    diff = (a.chars[sa] != b.chars[sb]).to(torch.int32)
    bad = torch.zeros(npairs, dtype=torch.int32, device=a.device)
    bad.index_add_(0, pair, diff)
    return same_len & (bad == 0)


def string_eq(a: StringColumn, b: StringColumn) -> torch.Tensor:
    """Row-wise byte equality of two string columns of one capacity."""
    idx = torch.arange(a.capacity, device=a.device)
    return pairs_equal(a, idx, b, idx)


class StartsWith(Expression):
    def __init__(self, child: Expression, prefix: str):
        super().__init__(child)
        self.prefix = prefix

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if not isinstance(c, StringColumn):
            raise TypeError("startswith takes a string column")
        return make_result(match_literal(c, utf8(self.prefix), prefix=True),
                           c.validity, dt.BOOL)

    def __repr__(self):
        return f"StartsWith({self.children[0]!r}, {self.prefix!r})"
