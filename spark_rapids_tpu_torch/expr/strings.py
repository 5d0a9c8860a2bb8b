"""String expressions over the Arrow layout (int32 offsets + uint8 chars).

Counterpart of spark_rapids_tpu/expr/strings.py to the depth TPC-H q3,
the string-filtered aggregates and the NDS slice need: ``StartsWith``,
``Substring``, and the byte comparisons behind string ``=`` / ``IN``
(expr/predicates.py) and key equality in joins and grouping
(ops/kernels.py). Every comparison reads the offsets and chars
directly; none builds a padded copy. UTF-8 byte order is Spark string
order, so byte equality is string equality.
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


#: bytes compared per pass of :func:`pairs_equal`: each compared byte
#: costs about 40 bytes of int64 index temporaries, so a pass stays
#: near 1.3 GB however many pairs (a 21.9M-row grouping on 50-byte keys
#: compares 1.1G bytes)
PAIR_BYTES_PER_PASS = 1 << 25


def pairs_equal(a: StringColumn, a_idx: torch.Tensor, b: StringColumn,
                b_idx: torch.Tensor,
                bytes_per_pass: int = PAIR_BYTES_PER_PASS) -> torch.Tensor:
    """bool per pair k: bytes of a[a_idx[k]] == bytes of b[b_idx[k]]
    (validity is the caller's business). Pairs of equal length compare
    their bytes in flat passes over exactly those bytes, in runs of
    consecutive pairs of at most ``bytes_per_pass`` bytes (a longer
    single pair takes a pass of its own)."""
    la = a.lengths()[a_idx].to(torch.int64)
    lb = b.lengths()[b_idx].to(torch.int64)
    same_len = la == lb
    lens = torch.where(same_len, la, 0)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if lens.numel() else 0
    if total == 0:
        return same_len
    if total <= bytes_per_pass:
        return same_len & _bytes_equal(a, a_idx, b, b_idx, lens, total)
    marks = torch.arange(bytes_per_pass, total, bytes_per_pass,
                         device=ends.device)
    cuts = torch.searchsorted(ends, marks, right=True).tolist()
    ok = torch.ones_like(same_len)
    for start, stop in zip([0] + cuts, cuts + [lens.shape[0]]):
        if stop > start:
            part = lens[start:stop]
            ok[start:stop] = _bytes_equal(a, a_idx[start:stop], b,
                                          b_idx[start:stop], part,
                                          int(part.sum()))
    return same_len & ok


def _bytes_equal(a: StringColumn, a_idx: torch.Tensor, b: StringColumn,
                 b_idx: torch.Tensor, lens: torch.Tensor,
                 total: int) -> torch.Tensor:
    """bool per pair: the first ``lens[k]`` bytes of the two rows agree
    (``total`` = lens.sum())."""
    npairs = a_idx.shape[0]
    if total == 0:
        return torch.ones(npairs, dtype=torch.bool, device=a.device)
    pair = torch.repeat_interleave(torch.arange(npairs, device=a.device),
                                   lens, output_size=total)
    ends = torch.cumsum(lens, 0)
    within = torch.arange(total, device=a.device) - (ends - lens)[pair]
    sa = a.offsets[:-1][a_idx].to(torch.int64)[pair] + within
    sb = b.offsets[:-1][b_idx].to(torch.int64)[pair] + within
    diff = (a.chars[sa] != b.chars[sb]).to(torch.int32)
    bad = torch.zeros(npairs, dtype=torch.int32, device=a.device)
    bad.index_add_(0, pair, diff)
    return bad == 0


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


class Substring(Expression):
    """substring(str, pos, len): 1-based ``pos``, 0 reads as 1, a
    negative ``pos`` counts from the end. Byte-based, as in the JAX
    package (exact for ASCII; Spark counts code points)."""

    def __init__(self, child: Expression, pos: int, length: int = 1 << 30):
        super().__init__(child)
        self.pos = pos
        self.length = length

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self.children[0].eval(batch)
        if not isinstance(c, StringColumn):
            raise TypeError("substring takes a string column")
        dev = c.device
        lens = c.lengths().to(torch.int64)
        if self.pos > 0:
            start = lens.clamp(max=self.pos - 1)
        elif self.pos == 0:
            start = torch.zeros_like(lens)
        else:
            start = (lens + self.pos).clamp(min=0)
        out_len = (lens - start).clamp(max=self.length).clamp(min=0)
        ends = torch.cumsum(out_len, 0)
        cap = c.capacity
        offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        offsets[1:] = ends.to(torch.int32)
        total = int(ends[-1]) if cap else 0
        chars = torch.zeros(max(-(-total // 128) * 128, 128),
                            dtype=torch.uint8, device=dev)
        if total:
            row = torch.repeat_interleave(torch.arange(cap, device=dev),
                                          out_len, output_size=total)
            within = torch.arange(total, device=dev) - (ends - out_len)[row]
            src = c.offsets[:-1].to(torch.int64)[row] + start[row] + within
            chars[:total] = c.chars[src]
        return StringColumn(offsets, chars, c.validity, c.pad_bucket)

    def __repr__(self):
        return (f"Substring({self.children[0]!r}, {self.pos}, "
                f"{self.length})")
