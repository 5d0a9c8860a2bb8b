"""String expressions and the string casts, over the Arrow layout
(int32 offsets + uint8 chars).

Counterpart of spark_rapids_tpu/expr/strings.py. The JAX package works
on a padded (rows, width) byte view; here each function computes the
same values over the flat bytes of a batch: every byte knows its row,
its position in the row and its code point, and a result is assembled
from per-row pieces (``_assemble``) or from a kept subset of the input
bytes (``_keep_bytes``). Comparisons read the offsets and chars
directly. UTF-8 byte order is Spark string order.

Where the JAX package counts bytes and Spark counts characters, the
port counts characters, as Spark does: ``reverse``, ``lpad`` / ``rpad``,
``locate`` and LIKE's ``_`` (ROADMAP.md C13, which lists every place the
port follows Spark and the JAX package does not). ``upper``, ``lower``
and ``initcap`` map ASCII letters only, as the JAX package does (Spark
maps all of Unicode; C13).

Casts: to STRING from booleans, integers, floats (Java's
``Double.toString`` / ``Float.toString``: the shortest digits that read
back to the value, plain between 1e-3 and 1e7 and ``1.0E7`` beyond,
which the JAX package refuses), dates and timestamps; from STRING to
integers, floats, booleans and dates with Spark's parsing rules
(``cast_from_string``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (Column, ColumnVector, ColumnarBatch,
                               StringColumn, round_pow2)
from .core import Expression, Schema, make_result, merged_validity


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
    negative ``pos`` counts from the end, and the end is ``len`` past
    the start before the start is clipped to the string, as in Spark's
    ``substringSQL``. ``pos`` and ``len`` count code points, as in Spark
    (the JAX package counts bytes and clips the start first). A code
    point starts at every UTF-8 byte that is not a continuation byte
    (0b10xxxxxx)."""

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
        bv = _Bytes(c)
        # Spark's substringSQL: the end counts from the unclamped start
        start = bv.n_cp + self.pos if self.pos < 0 else \
            torch.full_like(bv.n_cp, max(self.pos - 1, 0))
        stop = start + self.length
        return _keep_bytes(bv, (bv.cp >= start.clamp(min=0)[bv.row])
                           & (bv.cp < stop[bv.row]))

    def __repr__(self):
        return (f"Substring({self.children[0]!r}, {self.pos}, "
                f"{self.length})")


# ---------------------------------------------------------------------------
# flat-byte building blocks
# ---------------------------------------------------------------------------

def _chars_buffer(n: int, device) -> torch.Tensor:
    return torch.zeros(max(-(-n // 128) * 128, 128), dtype=torch.uint8,
                       device=device)


def from_lengths(lens: torch.Tensor, chars: torch.Tensor,
                 validity: torch.Tensor) -> StringColumn:
    """A StringColumn from per-row byte lengths (0 on null rows) and the
    rows' bytes back to back."""
    cap = lens.shape[0]
    dev = lens.device
    offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0).to(torch.int32)
    buf = _chars_buffer(chars.shape[0], dev)
    buf[:chars.shape[0]] = chars
    longest = int(lens.max()) if cap else 0
    return StringColumn(offsets, buf, validity, pad_bucket=round_pow2(longest))


class _Bytes:
    """Every byte of a string column's rows: its row, its position in
    the row, its value, whether it starts a code point, and its code
    point's index in the row."""

    def __init__(self, c: StringColumn):
        self.c = c
        dev = c.device
        self.dev = dev
        self.cap = c.capacity
        self.lens = c.lengths().to(torch.int64)
        self.starts = c.offsets[:-1].to(torch.int64)
        ends = torch.cumsum(self.lens, 0)
        self.base = ends - self.lens
        self.total = int(ends[-1]) if self.cap else 0
        self.row = torch.repeat_interleave(
            torch.arange(self.cap, device=dev), self.lens,
            output_size=self.total)
        self.within = torch.arange(self.total, device=dev) - \
            self.base[self.row]
        self.pos = self.starts[self.row] + self.within
        self.byte = c.chars[self.pos] if self.total else \
            torch.zeros(0, dtype=torch.uint8, device=dev)
        # a stray continuation byte at a row's start counts as a lead
        self.lead = ((self.byte & 0xC0) != 0x80) | (self.within == 0)
        lead64 = self.lead.to(torch.int64)
        self.n_cp = torch.zeros(self.cap, dtype=torch.int64,
                                device=dev).index_add_(0, self.row, lead64)
        self.cp = torch.cumsum(lead64, 0) - 1 - \
            (torch.cumsum(self.n_cp, 0) - self.n_cp)[self.row]

    def per_row_sum(self, flags: torch.Tensor) -> torch.Tensor:
        return torch.zeros(self.cap, dtype=torch.int64, device=self.dev) \
            .index_add_(0, self.row, flags.to(torch.int64))

    def per_row(self, values: torch.Tensor, fill: int, how: str
                ) -> torch.Tensor:
        out = torch.full((self.cap,), fill, dtype=torch.int64,
                         device=self.dev)
        return out.scatter_reduce(0, self.row, values, how,
                                  include_self=True)


def _keep_bytes(bv: _Bytes, keep: torch.Tensor,
                byte: Optional[torch.Tensor] = None) -> StringColumn:
    """The column of each row's kept bytes, in order (``byte`` replaces
    the values)."""
    src = bv.byte if byte is None else byte
    return from_lengths(bv.per_row_sum(keep), src[keep], bv.c.validity)


def _assemble(validity: torch.Tensor, pieces) -> StringColumn:
    """Rows assembled from pieces, each (chars, start[row], n[row]): row
    r appends chars[start[r]:start[r] + n[r]] of every piece in turn.
    Null rows are empty."""
    dev = validity.device
    cap = validity.shape[0]
    pieces = [(src, start, torch.where(validity, n, 0))
              for src, start, n in pieces]
    lens = torch.zeros(cap, dtype=torch.int64, device=dev)
    for _, _, n in pieces:
        lens = lens + n
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if cap else 0
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    acc = ends - lens
    for src, start, n in pieces:
        m = int(n.sum()) if cap else 0
        if m:
            row = torch.repeat_interleave(torch.arange(cap, device=dev), n,
                                          output_size=m)
            within = torch.arange(m, device=dev) - (torch.cumsum(n, 0) -
                                                    n)[row]
            last = max(src.shape[0] - 1, 0)
            out[acc[row] + within] = src[(start[row] + within).clamp(0,
                                                                     last)]
        acc = acc + n
    return from_lengths(lens, out, validity)


def _literal_chars(raw: bytes, device) -> torch.Tensor:
    return torch.tensor(list(raw) or [0], dtype=torch.uint8, device=device)


def slice_rows(c: StringColumn, start: torch.Tensor, n: torch.Tensor
               ) -> StringColumn:
    """Each row's bytes [start, start + n) (byte positions in the
    row)."""
    return _assemble(c.validity, [(c.chars, c.offsets[:-1].to(torch.int64)
                                   + start, n)])


def code_point_length(rows, p: torch.Tensor) -> torch.Tensor:
    """Bytes of the code point at within-row position ``p`` (1 at or past
    the row's end), from its lead byte. ``rows`` has ``byte_at`` and
    ``lens`` (expr/regex.py's _Rows)."""
    b = rows.byte_at(p)
    n = torch.where(b < 0xC0, 1, torch.where(b < 0xE0, 2,
                                             torch.where(b < 0xF0, 3, 4)))
    return torch.minimum(n, (rows.lens - p).clamp(min=1))


def replace_spans(rows, chosen: torch.Tensor, spans, repl: bytes
                  ) -> StringColumn:
    """The rows with each chosen span replaced by ``repl``: ``chosen``
    marks (in the positions view of ``rows``, expr/regex.py's _Rows)
    where a replacement goes, before the byte there or after the row's
    last byte; ``spans`` is a list of per-row (start, end) byte ranges
    that are dropped."""
    bv = _Bytes(rows.c)
    dropped = torch.zeros(bv.total, dtype=torch.bool, device=bv.dev)
    for p, q in spans:
        dropped = dropped | ((bv.within >= p[bv.row]) &
                             (bv.within < q[bv.row]))
    at_byte = chosen[rows.vstart[bv.row] + bv.within]
    at_end = chosen[rows.vstart + rows.lens]
    return _emit(bv, at_byte, at_end, dropped, repl)


def _emit(bv: "_Bytes", at_byte: torch.Tensor, at_end: torch.Tensor,
          dropped: torch.Tensor, repl: bytes) -> StringColumn:
    """Each row rebuilt byte by byte: a byte emits ``repl`` first where
    ``at_byte``, then itself unless ``dropped``; a row's end emits
    ``repl`` where ``at_end``."""
    c = bv.c
    nr = len(repl)
    emit = at_byte.to(torch.int64) * nr + (~dropped).to(torch.int64)
    row_emit = bv.per_row_sum(emit)
    lens = torch.where(c.validity, row_emit + at_end.to(torch.int64) * nr, 0)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if bv.cap else 0
    out = torch.zeros(total, dtype=torch.uint8, device=bv.dev)
    row_start = ends - lens
    # output position of each byte's emission: its exclusive prefix sum
    # within the row
    g = torch.cumsum(emit, 0) - emit
    before = (torch.cumsum(row_emit, 0) - row_emit)[bv.row]
    opos = row_start[bv.row] + g - before
    live = c.validity[bv.row]
    rb = _literal_chars(repl, bv.dev)
    sel = at_byte & live
    for k in range(nr):
        out[opos[sel] + k] = rb[k]
    keep = ~dropped & live
    out[(opos + at_byte.to(torch.int64) * nr)[keep]] = bv.byte[keep]
    tail = at_end & c.validity
    for k in range(nr):
        out[(row_start + row_emit)[tail] + k] = rb[k]
    return from_lengths(lens, out, c.validity)


def _as_string_col(c: Column) -> StringColumn:
    if isinstance(c, StringColumn):
        return c
    from .cast import cast_column
    return cast_column(c, dt.STRING)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

def string_compare(a: StringColumn, b: StringColumn) -> torch.Tensor:
    """int8 per row: -1 / 0 / 1 as row i of ``a`` sorts before, equal
    to, or after row i of ``b``: unsigned bytes, then the shorter string
    first (Spark's order; the port's ORDER BY sorts the same way,
    ops/kernels.py ``_rank_keys``)."""
    la = a.lengths().to(torch.int64)
    lb = b.lengths().to(torch.int64)
    sa, sb = a.offsets[:-1].to(torch.int64), b.offsets[:-1].to(torch.int64)
    cap = la.shape[0]
    out = torch.zeros(cap, dtype=torch.int8, device=a.device)
    undecided = torch.ones(cap, dtype=torch.bool, device=a.device)
    steps = min(int(la.max()), int(lb.max())) + 1 if cap else 0
    last_a, last_b = max(a.char_capacity - 1, 0), max(b.char_capacity - 1, 0)
    for j in range(steps):
        ca = torch.where(j < la, a.chars[(sa + j).clamp(max=last_a)]
                         .to(torch.int64), -1)
        cb = torch.where(j < lb, b.chars[(sb + j).clamp(max=last_b)]
                         .to(torch.int64), -1)
        diff = undecided & (ca != cb)
        out = torch.where(diff, torch.where(ca < cb, -1, 1).to(torch.int8),
                          out)
        undecided = undecided & ~diff
    return out


def compare_literal(c: StringColumn, raw: bytes) -> torch.Tensor:
    """int8 per row: -1 / 0 / 1 as the row sorts before, equal to, or
    after the bytes ``raw``."""
    lens = c.lengths().to(torch.int64)
    starts = c.offsets[:-1].to(torch.int64)
    last = max(c.char_capacity - 1, 0)
    out = torch.zeros(lens.shape[0], dtype=torch.int8, device=c.device)
    undecided = torch.ones_like(out, dtype=torch.bool)
    for j in range(len(raw) + 1):
        ca = torch.where(j < lens, c.chars[(starts + j).clamp(max=last)]
                         .to(torch.int64), -1)
        cb = raw[j] if j < len(raw) else -1
        diff = undecided & (ca != cb)
        out = torch.where(diff, torch.where(ca < cb, -1, 1).to(torch.int8),
                          out)
        undecided = undecided & ~diff
    return out


# ---------------------------------------------------------------------------
# string functions
# ---------------------------------------------------------------------------

class _StringFn(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def _child(self, batch: ColumnarBatch) -> StringColumn:
        return _as_string_col(self.children[0].eval(batch))


class Length(Expression):
    """char_length: UTF-8 code points, as Spark counts."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = _as_string_col(self.children[0].eval(batch))
        return make_result(_Bytes(c).n_cp.to(torch.int32), c.validity,
                           dt.INT32)


class OctetLength(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = _as_string_col(self.children[0].eval(batch))
        return make_result(c.lengths().to(torch.int32), c.validity,
                           dt.INT32)


class _CaseMap(_StringFn):
    lo, hi, delta = 0, 0, 0

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        src = c.chars
        conv = (src >= self.lo) & (src <= self.hi)
        chars = torch.where(conv, (src.to(torch.int16) + self.delta)
                            .to(torch.uint8), src)
        return StringColumn(c.offsets, chars, c.validity, c.pad_bucket)


class Upper(_CaseMap):
    lo, hi, delta = ord("a"), ord("z"), -32


class Lower(_CaseMap):
    lo, hi, delta = ord("A"), ord("Z"), 32


class InitCap(_StringFn):
    """initcap: each space-separated word's first letter upper, the rest
    lower (ASCII letters)."""

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        bv = _Bytes(c)
        b = bv.byte
        prev = torch.zeros_like(b)
        if bv.total:
            prev[1:] = b[:-1]
        after_space = (bv.within == 0) | (prev == 32)
        is_lower = (b >= 97) & (b <= 122)
        is_upper = (b >= 65) & (b <= 90)
        out = torch.where(is_lower & after_space, b - 32, b)
        out = torch.where(is_upper & ~after_space, b + 32, out)
        return _keep_bytes(bv, torch.ones_like(bv.lead), out)


class Concat(_StringFn):
    """concat(...) and ``||``: null if any input is null."""

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        cols = [_as_string_col(c.eval(batch)) for c in self.children]
        return _assemble(merged_validity(*cols), [
            (c.chars, c.offsets[:-1].to(torch.int64),
             c.lengths().to(torch.int64)) for c in cols])


class ConcatWs(_StringFn):
    """concat_ws(sep, ...): null inputs are skipped (and so are their
    separators); the result is never null."""

    def __init__(self, sep: str, *children: Expression):
        super().__init__(*children)
        self.sep = sep

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        cols = [_as_string_col(c.eval(batch)) for c in self.children]
        live = batch.live_mask()
        dev = live.device
        sep = self.sep.encode("utf-8")
        sep_t = _literal_chars(sep, dev)
        zero = torch.zeros(live.shape[0], dtype=torch.int64, device=dev)
        seen = torch.zeros_like(live)
        pieces = []
        for c in cols:
            put_sep = c.validity & seen
            pieces.append((sep_t, zero, put_sep.to(torch.int64) * len(sep)))
            pieces.append((c.chars, c.offsets[:-1].to(torch.int64),
                           torch.where(c.validity, c.lengths(), 0)
                           .to(torch.int64)))
            seen = seen | c.validity
        return _assemble(live, pieces)

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"ConcatWs({self.sep!r}, {args})"


class EndsWith(Expression):
    def __init__(self, child: Expression, suffix: str):
        super().__init__(child)
        self.suffix = suffix

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = _as_string_col(self.children[0].eval(batch))
        raw = utf8(self.suffix)
        lens = c.lengths().to(torch.int64)
        start = c.offsets[:-1].to(torch.int64) + lens - len(raw)
        hit = lens >= len(raw)
        last = max(c.char_capacity - 1, 0)
        for j, byte in enumerate(raw):
            hit = hit & (c.chars[(start + j).clamp(0, last)] == byte)
        return make_result(hit, c.validity, dt.BOOL)

    def __repr__(self):
        return f"EndsWith({self.children[0]!r}, {self.suffix!r})"


def _find_literal(bv: _Bytes, raw: bytes) -> torch.Tensor:
    """bool per byte: ``raw`` occurs in the row starting at this byte."""
    hit = bv.within + len(raw) <= bv.lens[bv.row]
    last = max(bv.c.char_capacity - 1, 0)
    for j, byte in enumerate(raw):
        hit = hit & (bv.c.chars[(bv.pos + j).clamp(max=last)] == byte)
    return hit


class Contains(Expression):
    def __init__(self, child: Expression, needle: str):
        super().__init__(child)
        self.needle = needle

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = _as_string_col(self.children[0].eval(batch))
        raw = utf8(self.needle)
        if not raw:
            return make_result(torch.ones_like(c.validity), c.validity,
                               dt.BOOL)
        bv = _Bytes(c)
        return make_result(bv.per_row_sum(_find_literal(bv, raw)) > 0,
                           c.validity, dt.BOOL)

    def __repr__(self):
        return f"Contains({self.children[0]!r}, {self.needle!r})"


class Like(Expression):
    """``str LIKE pattern`` with a constant pattern: a DFA walked over
    each row's bytes (expr/regex.py ``like_dfa``). ``_`` is one
    character and a literal may be any character, as in Spark (the JAX
    package matches ``_`` against one byte and refuses a multi-byte
    literal; ROADMAP.md C13)."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        super().__init__(child)
        from .regex import like_dfa
        self.pattern = pattern
        self.escape = escape
        self._dfa = like_dfa(pattern, escape)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.BOOL

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        from .regex import like_match
        c = _as_string_col(self.children[0].eval(batch))
        return make_result(like_match(c, self._dfa), c.validity, dt.BOOL)

    def __repr__(self):
        return f"{self.children[0]!r} LIKE {self.pattern!r}"


class StringTrim(_StringFn):
    """trim: spaces (0x20) off both ends; ltrim / rtrim one end."""

    side = "both"

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        bv = _Bytes(c)
        ns = bv.byte != 32
        first = bv.per_row(torch.where(ns, bv.within, bv.lens[bv.row]),
                           2 ** 62, "amin")
        last = bv.per_row(torch.where(ns, bv.within, -1), -1, "amax")
        keep = torch.ones_like(ns)
        if self.side in ("both", "leading"):
            keep = keep & (bv.within >= first[bv.row])
        if self.side in ("both", "trailing"):
            keep = keep & (bv.within <= last[bv.row])
        return _keep_bytes(bv, keep)


class StringTrimLeft(StringTrim):
    side = "leading"


class StringTrimRight(StringTrim):
    side = "trailing"


class Reverse(_StringFn):
    """reverse(str): the characters in reverse order (a character's
    bytes keep their order)."""

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        bv = _Bytes(c)
        if not bv.total:
            return from_lengths(torch.where(c.validity, bv.lens, 0),
                                bv.byte, c.validity)
        lead_at = torch.nonzero(bv.lead).flatten()
        cp_id = torch.cumsum(bv.lead.to(torch.int64), 0) - 1
        nxt = torch.cat([lead_at[1:], torch.full((1,), bv.total,
                                                 device=bv.dev)])
        row_end = bv.base + bv.lens
        cp_start = lead_at[cp_id]
        cp_end = torch.minimum(nxt, row_end[bv.row[lead_at]])[cp_id]
        flat = torch.arange(bv.total, device=bv.dev)
        dest = bv.base[bv.row] + (row_end[bv.row] - cp_end) + \
            (flat - cp_start)
        out = torch.empty_like(bv.byte)
        out[dest] = bv.byte
        return from_lengths(bv.lens, out, c.validity)


class _Pad(_StringFn):
    """lpad / rpad(str, len, pad) in characters, as Spark: a longer
    string is cut to ``len`` characters, a shorter one is filled with
    ``pad`` repeated; an empty ``pad`` leaves it short; ``len`` <= 0
    gives ''."""

    left = True

    def __init__(self, child: Expression, length: int, pad: str = " "):
        super().__init__(child)
        self.length = int(length)
        self.pad = pad

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        bv = _Bytes(c)
        L = max(self.length, 0)
        fill = (self.pad * (L // max(len(self.pad), 1) + 1))[:L] \
            if self.pad else ""
        # bytes of the first k characters of the fill, k = 0..L
        prefix = [0]
        for ch in fill:
            prefix.append(prefix[-1] + len(ch.encode("utf-8")))
        prefix += [prefix[-1]] * (L + 1 - len(prefix))
        prefix_t = torch.tensor(prefix, dtype=torch.int64, device=bv.dev)
        fill_t = _literal_chars(fill.encode("utf-8"), bv.dev)
        kept = bv.per_row_sum(bv.cp < L)
        k = (L - bv.n_cp).clamp(min=0)
        zero = torch.zeros_like(k)
        pad_piece = (fill_t, zero, prefix_t[k])
        str_piece = (c.chars, bv.starts, kept)
        return _assemble(c.validity, [pad_piece, str_piece] if self.left
                         else [str_piece, pad_piece])

    def __repr__(self):
        return (f"{type(self).__name__}({self.children[0]!r}, "
                f"{self.length}, {self.pad!r})")


class Lpad(_Pad):
    left = True


class Rpad(_Pad):
    left = False


class StringLocate(Expression):
    """locate(substr, str[, pos]): the 1-based character position of the
    first ``substr`` at or after character ``pos``; 0 if none, and 0
    for ``pos`` < 1. An empty ``substr`` is found at 1 (Spark's
    ``UTF8String.indexOf``)."""

    def __init__(self, child: Expression, substr: str, start: int = 1):
        super().__init__(child)
        self.substr = substr
        self.start = int(start)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = _as_string_col(self.children[0].eval(batch))
        raw = utf8(self.substr)
        cap = c.capacity
        if self.start < 1 or not raw:
            v = 0 if self.start < 1 else 1
            return make_result(torch.full((cap,), v, dtype=torch.int32,
                                          device=c.device),
                               c.validity, dt.INT32)
        bv = _Bytes(c)
        hit = _find_literal(bv, raw) & bv.lead & (bv.cp >= self.start - 1)
        first = bv.per_row(torch.where(hit, bv.cp, 2 ** 62), 2 ** 62,
                           "amin")
        pos = torch.where(first < 2 ** 62, first + 1, 0)
        return make_result(pos.to(torch.int32), c.validity, dt.INT32)

    def __repr__(self):
        return (f"StringLocate({self.children[0]!r}, {self.substr!r}, "
                f"{self.start})")


class StringRepeat(_StringFn):
    """repeat(str, n) with a constant n (n <= 0 gives '')."""

    def __init__(self, child: Expression, n: int):
        super().__init__(child)
        self.n = max(int(n), 0)

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        piece = (c.chars, c.offsets[:-1].to(torch.int64),
                 c.lengths().to(torch.int64))
        return _assemble(c.validity, [piece] * self.n)


class StringReplace(_StringFn):
    """replace(str, search, replace) with constants: every
    non-overlapping occurrence, leftmost first; an empty ``search``
    leaves the string as it is (Spark; the JAX package raises)."""

    def __init__(self, child: Expression, search: str, replace: str = ""):
        super().__init__(child)
        self.search = search
        self.replace = replace

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        raw = utf8(self.search)
        if not raw:
            return c
        bv = _Bytes(c)
        cand = _find_literal(bv, raw)
        taken = torch.zeros_like(cand)
        if bv.total:
            # leftmost first: one step per position of the rows with a
            # candidate, each row blocked until its last match ends
            last = int(bv.per_row(torch.where(cand, bv.within, -1), -1,
                                  "amax").max())
            blocked = torch.zeros(bv.cap, dtype=torch.int64, device=bv.dev)
            for j in range(last + 1):
                idx = (bv.base + j).clamp(max=bv.total - 1)
                take = (j < bv.lens) & cand[idx] & (j >= blocked)
                taken[idx[take]] = True
                blocked = torch.where(take, j + len(raw), blocked)
        dropped = torch.zeros_like(cand)
        at = torch.nonzero(taken).flatten()
        for j in range(len(raw)):
            dropped[at + j] = True
        no_end = torch.zeros(bv.cap, dtype=torch.bool, device=bv.dev)
        return _emit(bv, taken, no_end, dropped, utf8(self.replace))

    def __repr__(self):
        return (f"StringReplace({self.children[0]!r}, {self.search!r}, "
                f"{self.replace!r})")


class StringTranslate(_StringFn):
    """translate(str, from, to): each character of ``from`` becomes the
    one at its index in ``to``, or is deleted past ``to``'s end; the
    first occurrence in ``from`` wins. ASCII ``from`` / ``to`` only (a
    non-ASCII one raises, as in the JAX package)."""

    def __init__(self, child: Expression, src: str, dst: str):
        super().__init__(child)
        table = np.arange(256, dtype=np.int64)
        delete = np.zeros(256, bool)
        seen = set()
        for ch in src + dst:
            if ord(ch) > 127:
                raise TypeError("translate: non-ASCII characters are not "
                                "supported")
        for i, ch in enumerate(src):
            b = ord(ch)
            if b in seen:
                continue
            seen.add(b)
            if i < len(dst):
                table[b] = ord(dst[i])
            else:
                delete[b] = True
        self.src, self.dst = src, dst
        self.table = table
        self.delete = delete

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        c = self._child(batch)
        bv = _Bytes(c)
        idx = bv.byte.to(torch.int64)
        table = torch.from_numpy(self.table).to(bv.dev)
        delete = torch.from_numpy(self.delete).to(bv.dev)
        return _keep_bytes(bv, ~delete[idx], table[idx].to(torch.uint8))

    def __repr__(self):
        return (f"StringTranslate({self.children[0]!r}, {self.src!r}, "
                f"{self.dst!r})")


# ---------------------------------------------------------------------------
# casts to STRING
# ---------------------------------------------------------------------------

def _pack_matrix(mat: torch.Tensor, lens: torch.Tensor,
                 validity: torch.Tensor) -> StringColumn:
    """Rows of a (rows, width) uint8 matrix cut to ``lens``."""
    lens = torch.where(validity, lens.to(torch.int64), 0)
    k = torch.arange(mat.shape[1], device=mat.device)
    return from_lengths(lens, mat[k[None, :] < lens[:, None]], validity)


_POW10 = [10 ** k for k in range(19)]


def _pow10(device) -> torch.Tensor:
    return torch.tensor(_POW10, dtype=torch.int64, device=device)


def _ndigits(v: torch.Tensor) -> torch.Tensor:
    """Decimal digits of non-negative int64 ``v`` (1 for 0)."""
    n = torch.ones_like(v)
    for k in range(1, 19):
        n = n + (v >= _POW10[k]).to(torch.int64)
    return n


def _digit(v: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    """ASCII digit of ``v`` at decimal ``power`` (v >= 0)."""
    p10 = _pow10(v.device)[power.clamp(0, 18)]
    return (48 + (v // p10) % 10).to(torch.uint8)


def _int_to_string(data: torch.Tensor, validity) -> StringColumn:
    v = data.to(torch.int64)
    neg = v < 0
    # digits of the non-positive -|v| (int64's minimum has no positive)
    a = torch.where(neg, v, -v)
    digits = []
    for _ in range(19):
        digits.append(-torch.fmod(a, 10))
        a = torch.div(a, 10, rounding_mode="trunc")
    mag_digits = torch.stack(digits[::-1], 1)  # most significant first
    nz = mag_digits != 0
    first = torch.where(nz.any(1), nz.to(torch.int8).argmax(1), 18)
    ndig = 19 - first
    sign = neg.to(torch.int64)
    width = 20
    k = torch.arange(width, device=v.device)[None, :]
    src = (k - sign[:, None] + first[:, None]).clamp(0, 18)
    mat = (48 + torch.gather(mag_digits, 1, src)).to(torch.uint8)
    mat = torch.where((k == 0) & neg[:, None], 45, mat).to(torch.uint8)
    return _pack_matrix(mat, ndig + sign, validity)


def _decimal_to_string(c: ColumnVector) -> StringColumn:
    """A long-backed decimal in plain notation, Spark's form: a sign,
    the integral digits (0 under 1), and, for a scale s > 0, a point and
    s digits (-0.50, 12.30)."""
    if c.dtype.is_wide:
        from .core import cpu_fallback
        raise cpu_fallback(f"CAST({c.dtype} AS STRING)", "_tag_cast")
    s = c.dtype.scale
    if s == 0:
        return _int_to_string(c.data, c.validity)
    v = c.data
    neg = v < 0
    mag = v.abs()          # |v| < 10^18: no int64 minimum here
    ip = torch.div(mag, _POW10[s], rounding_mode="floor")
    frac = mag - ip * _POW10[s]
    sign = neg.to(torch.int64)
    int_len = sign + _ndigits(ip)
    width = 1 + 19 + 1 + s
    k = torch.arange(width, device=v.device)[None, :]
    L = int_len[:, None]
    int_ch = _digit(ip[:, None].expand(-1, width), L - 1 - k)
    frac_ch = _digit(frac[:, None].expand(-1, width), L + s - k)
    mat = torch.where(k < L, int_ch, torch.where(k == L, 46, frac_ch))
    mat = torch.where((k == 0) & neg[:, None], 45, mat).to(torch.uint8)
    return _pack_matrix(mat, int_len + 1 + s, c.validity)


def _two_digits(mat, col: int, v):
    mat[:, col] = (48 + v // 10).to(torch.uint8)
    mat[:, col + 1] = (48 + v % 10).to(torch.uint8)


def _ymd_matrix(days: torch.Tensor, width: int) -> torch.Tensor:
    from .datetime import civil_from_days
    y, m, d = civil_from_days(days)
    mat = torch.zeros((days.shape[0], width), dtype=torch.uint8,
                      device=days.device)
    for i, p in enumerate((1000, 100, 10, 1)):
        mat[:, i] = (48 + (y // p) % 10).to(torch.uint8)
    mat[:, 4] = 45
    _two_digits(mat, 5, m)
    mat[:, 7] = 45
    _two_digits(mat, 8, d)
    return mat


def _date_to_string(data, validity) -> StringColumn:
    days = data.to(torch.int64)
    return _pack_matrix(_ymd_matrix(days, 10), torch.full_like(days, 10),
                        validity)


def _timestamp_to_string(data, validity) -> StringColumn:
    """'yyyy-mm-dd hh:mm:ss' and, for a fraction, '.' and its digits
    without trailing zeros (the timestamp read in UTC)."""
    us = data.to(torch.int64)
    days = us // 86_400_000_000
    rem = us - days * 86_400_000_000
    mat = _ymd_matrix(days, 26)
    sec, micro = rem // 1_000_000, rem % 1_000_000
    mat[:, 10] = 32
    _two_digits(mat, 11, sec // 3600)
    mat[:, 13] = 58
    _two_digits(mat, 14, (sec % 3600) // 60)
    mat[:, 16] = 58
    _two_digits(mat, 17, sec % 60)
    mat[:, 19] = 46
    frac = torch.zeros_like(micro)
    for i, p in enumerate((100000, 10000, 1000, 100, 10, 1)):
        dig = (micro // p) % 10
        mat[:, 20 + i] = (48 + dig).to(torch.uint8)
        frac = torch.where(dig != 0, i + 1, frac)
    lens = torch.where(frac > 0, 20 + frac, 19)
    return _pack_matrix(mat, lens, validity)


# --- doubles: Java's Double.toString --------------------------------------

_K_MIN, _K_MAX = -330, 350
_POW10_PARTS = {}


def _pow10_parts(device):
    """10^k for k in [_K_MIN, _K_MAX] as mant_hi + mant_lo (the mantissa
    in [0.5, 1) to about 2^-106) times 2^exp: (hi, lo, exp) tensors."""
    device = torch.device(device)
    got = _POW10_PARTS.get(device)
    if got is None:
        from fractions import Fraction
        his, los, exps = [], [], []
        for k in range(_K_MIN, _K_MAX + 1):
            v = Fraction(10) ** k
            e = v.numerator.bit_length() - v.denominator.bit_length()
            m = v / Fraction(2) ** e
            while m >= 1:
                m, e = m / 2, e + 1
            while m < Fraction(1, 2):
                m, e = m * 2, e - 1
            hi = float(m)
            his.append(hi)
            los.append(float(m - Fraction(hi)))
            exps.append(e)
        got = _POW10_PARTS[device] = (
            torch.tensor(his, dtype=torch.float64, device=device),
            torch.tensor(los, dtype=torch.float64, device=device),
            torch.tensor(exps, dtype=torch.int64, device=device))
    return got


def _ldexp(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x * 2^n for int64 ``n`` with |n| <= 2044, exactly where the result
    is a normal double: two powers of two made from their bits
    (``torch.ldexp`` multiplies by ``pow(2, n)``, which CUDA's ``pow``
    does not always give exactly)."""
    half = n // 2

    def pow2(e):
        return ((e + 1023) << 52).view(torch.float64)
    return x * pow2(half) * pow2(n - half)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p + e = a * b exactly (Dekker), |a|, |b| < 1."""
    p = a * b
    split = 134217729.0  # 2^27 + 1
    ca, cb = split * a, split * b
    ah = ca - (ca - a)
    al = a - ah
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _int_frac(i0: torch.Tensor, r: torch.Tensor):
    """i0 + r (r a small double) as (integer part, fraction in [0, 1))."""
    f = torch.floor(r)
    return i0 + f.to(torch.int64), r - f


def shortest_decimal(a: torch.Tensor, mant_bits: int, min_exp: int):
    """For finite positive doubles ``a`` holding values of a binary
    format with ``mant_bits`` of mantissa and least exponent ``min_exp``
    (53 / -1074 for double, 24 / -149 for float): (digits, exp10) with
    digits * 10^exp10 the shortest decimal that reads back to the value,
    the one nearest it among those (ties to an even last digit), as
    Java's Double.toString / Float.toString choose (JDK 19 and later).

    The value, scaled by 10^k into [1e16, 1e18], and its rounding
    interval are kept as int64 integer parts plus double fractions, from
    a double-double product with a table of 10^k; the largest power of
    ten with a multiple inside the interval gives the digits."""
    dev = a.device
    m, e = torch.frexp(a)
    e = e.to(torch.int64)
    u_exp = (e - mant_bits).clamp(min=min_exp)  # the value's ulp 2^u_exp
    pow2 = (m == 0.5) & (e - 1 - mant_bits >= min_exp)
    mant_int = _ldexp(m, e - u_exp)
    even = torch.fmod(mant_int, 2.0) == 0
    k = (17 - torch.floor(torch.log10(a))).to(torch.int64)
    k = k.clamp(_K_MIN, _K_MAX)
    hi_t, lo_t, ex_t = _pow10_parts(dev)
    ti = k - _K_MIN
    th, tl, te = hi_t[ti], lo_t[ti], ex_t[ti]
    p1, p2 = _two_prod(m, th)
    p2 = p2 + m * tl
    s = e + te
    s_hi = _ldexp(p1, s)
    s_lo = _ldexp(p2, s)
    i0 = s_hi.to(torch.int64)  # s_hi >= 2^53 is a whole number
    # half the gap to each neighbour, in the same scale
    ws = u_exp - 1 + te
    w_hi, w_lo = _ldexp(th, ws), _ldexp(tl, ws)
    w_int = torch.floor(w_hi)
    w_frac = (w_hi - w_int) + w_lo
    w_int = w_int.to(torch.int64)
    low_int = torch.where(pow2, w_int // 2, w_int)
    low_frac = torch.where(pow2, (w_hi / 2 - torch.floor(w_hi / 2))
                           + w_lo / 2, w_frac)
    lo_i, lo_f = _int_frac(i0 - low_int, s_lo - low_frac)
    hi_i, hi_f = _int_frac(i0 + w_int, s_lo + w_frac)
    x_i, x_f = _int_frac(i0, s_lo)

    def valid(c):
        above = (c > lo_i) | ((c == lo_i) & (lo_f == 0) & even)
        below = (c < hi_i) | ((c == hi_i) & (hi_f > 0)) | \
            ((c == hi_i) & (hi_f == 0) & even)
        return above & below

    out = torch.zeros_like(i0)
    done = torch.zeros_like(even)
    for j in range(18, -1, -1):
        t = 10 ** j
        q = x_i // t
        rem = x_i - q * t
        lo_c, hi_c = q * t, (q + 1) * t
        va, vb = valid(lo_c), valid(hi_c)
        if t == 1:
            up = (x_f > 0.5) | ((x_f == 0.5) & (q % 2 == 1))
        else:
            half = t // 2
            up = (rem > half) | ((rem == half) & ((x_f > 0) | (q % 2 == 1)))
        pick = torch.where(va & vb, torch.where(up, hi_c, lo_c),
                           torch.where(va, lo_c, hi_c))
        found = (va | vb) & ~done
        out = torch.where(found, pick, out)
        done = done | found
    exp10 = -k
    for _ in range(18):
        z = (out % 10 == 0) & (out != 0)
        out = torch.where(z, out // 10, out)
        exp10 = exp10 + z.to(torch.int64)
    return out, exp10


def _float_to_string(data: torch.Tensor, validity) -> StringColumn:
    """Java's Double.toString (Float.toString for a FLOAT column):
    'NaN', 'Infinity', '-0.0'; plain digits with at least one after the
    point for 1e-3 <= |x| < 1e7, else 'd.dddE[-]n'."""
    dev = data.device
    is_f32 = data.dtype == torch.float32
    x = data.to(torch.float64)
    finite = torch.isfinite(x) & (x != 0)
    a = torch.where(finite, x.abs(), 1.0)
    digits, exp10 = shortest_decimal(a, 24 if is_f32 else 53,
                                     -149 if is_f32 else -1074)
    ndig = _ndigits(digits)
    sx = ndig - 1 + exp10  # the decimal exponent of the first digit
    plain = (sx >= -3) & (sx < 7)
    neg = torch.signbit(x) & ~torch.isnan(x)
    width = 32
    cap = x.shape[0]
    c = torch.arange(width, device=dev)[None, :] - \
        neg.to(torch.int64)[:, None]  # body position of each column
    sxb, nd = sx[:, None], ndig[:, None]
    D = digits[:, None]

    def digit_at(i):  # the i-th digit from the most significant
        return torch.where((i >= 0) & (i < nd), _digit(D, nd - 1 - i),
                           torch.full_like(i, 48, dtype=torch.uint8))
    # plain, sx >= 0: int digits (zero-filled), '.', the rest or '0'
    p_pos = torch.where(c <= sxb, digit_at(c),
                        torch.where(c == sxb + 1, 46, digit_at(c - 1)))
    p_pos_len = sx + 2 + torch.clamp(ndig - sx - 1, min=1)
    # plain, sx < 0: '0.', -sx - 1 zeros, the digits
    lead0 = -sxb - 1
    p_neg = torch.where(c == 0, 48, torch.where(
        c == 1, 46, torch.where(c < 2 + lead0, 48,
                                digit_at(c - 2 - lead0))))
    p_neg_len = 1 - sx + ndig
    # scientific: d '.' (rest or '0') 'E' ['-'] exponent
    mant_len = 2 + torch.clamp(ndig - 1, min=1)
    ml = mant_len[:, None]
    ex = sx.abs()[:, None]
    ex_n = 1 + (ex >= 10).to(torch.int64) + (ex >= 100).to(torch.int64)
    ex_at = ml + 1 + (sxb < 0).to(torch.int64)
    sci = torch.where(c == 0, digit_at(c), torch.where(
        c == 1, 46, torch.where(c < ml, digit_at(c - 1), torch.where(
            c == ml, 69, torch.where((c == ml + 1) & (sxb < 0), 45,
                                     _digit(ex, ex_at + ex_n - 1 - c))))))
    sci_len = mant_len + 1 + (sx < 0).to(torch.int64) + ex_n[:, 0]
    body = torch.where(plain[:, None],
                       torch.where(sxb >= 0, p_pos, p_neg), sci)
    blen = torch.where(plain, torch.where(sx >= 0, p_pos_len, p_neg_len),
                       sci_len)
    mat = torch.where(c < 0, 45, body).to(torch.uint8)
    lens = blen + neg.to(torch.int64)
    # NaN, the infinities and the zeros
    for cond, text in ((torch.isnan(x), b"NaN"),
                       (torch.isinf(x) & (x > 0), b"Infinity"),
                       (torch.isinf(x) & (x < 0), b"-Infinity"),
                       ((x == 0) & ~torch.signbit(x), b"0.0"),
                       ((x == 0) & torch.signbit(x), b"-0.0")):
        row = torch.zeros(width, dtype=torch.uint8, device=dev)
        row[:len(text)] = torch.tensor(list(text), dtype=torch.uint8,
                                       device=dev)
        mat = torch.where(cond[:, None], row[None, :], mat)
        lens = torch.where(cond, len(text), lens)
    del cap
    return _pack_matrix(mat, lens, validity)


def cast_to_string(c: ColumnVector) -> StringColumn:
    src = c.dtype
    if src == dt.BOOL:
        mat = torch.zeros((c.capacity, 5), dtype=torch.uint8,
                          device=c.device)
        t = torch.tensor(list(b"true\0"), dtype=torch.uint8, device=c.device)
        f = torch.tensor(list(b"false"), dtype=torch.uint8, device=c.device)
        mat = torch.where(c.data[:, None], t[None, :], f[None, :])
        return _pack_matrix(mat, torch.where(c.data, 4, 5), c.validity)
    if dt.is_decimal(src):
        return _decimal_to_string(c)
    if src.is_integral:
        return _int_to_string(c.data, c.validity)
    if src.is_floating:
        return _float_to_string(c.data, c.validity)
    if src == dt.DATE:
        return _date_to_string(c.data, c.validity)
    if src == dt.TIMESTAMP:
        return _timestamp_to_string(c.data, c.validity)
    raise TypeError(f"cast {src} -> string is not in this port yet")


# ---------------------------------------------------------------------------
# casts from STRING (Spark's UTF8String parsing), over the padded view
# ---------------------------------------------------------------------------

def _strip_bounds(padded: torch.Tensor, lens: torch.Tensor):
    """(start, end, nonempty) after trimming ASCII whitespace."""
    w = padded.shape[1]
    k = torch.arange(w, device=padded.device)[None, :]
    in_str = k < lens[:, None]
    is_sp = in_str & ((padded == 32) | (padded == 9) | (padded == 10) |
                      (padded == 13))
    non_sp = in_str & ~is_sp
    any_c = non_sp.any(1)
    start = torch.where(any_c, non_sp.to(torch.int8).argmax(1), 0)
    end = torch.where(any_c, w - non_sp.flip(1).to(torch.int8).argmax(1), 0)
    return start.to(torch.int64), end.to(torch.int64), any_c


def _first_true(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.any(1), mask.to(torch.int8).argmax(1),
                       default).to(torch.int64)


def _at(padded: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    w = padded.shape[1]
    return torch.gather(padded, 1, pos.clamp(0, max(w - 1, 0))[:, None])[:, 0]


def _parse_int(padded: torch.Tensor, lens: torch.Tensor):
    """[+-]digits[.digits] (the fraction truncated, as
    UTF8String.toLong); (value, ok) with ok false past int64."""
    w = padded.shape[1]
    start, end, nonempty = _strip_bounds(padded, lens)
    k = torch.arange(w, device=padded.device)[None, :]
    first = _at(padded, start)
    neg = first == 45
    has_sign = neg | (first == 43)
    dstart = start + has_sign.to(torch.int64)
    in_num = (k >= dstart[:, None]) & (k < end[:, None])
    digit = padded.to(torch.int64) - 48
    is_digit = (padded >= 48) & (padded <= 57)
    dot_mask = in_num & (padded == 46)
    dot_pos = _first_true(dot_mask, end)
    int_zone = in_num & (k < dot_pos[:, None])
    frac_zone = in_num & (k > dot_pos[:, None])
    ok = nonempty & (dot_pos > dstart) & (dot_mask.sum(1) <= 1) & \
        (~int_zone | is_digit).all(1) & (~frac_zone | is_digit).all(1)
    val = torch.zeros(padded.shape[0], dtype=torch.int64,
                      device=padded.device)
    for i in range(w):
        val = torch.where(int_zone[:, i], val * 10 + digit[:, i], val)
    # significant digits past 18 can leave int64: a 19-digit value that
    # wrapped is negative here; int64's minimum is allowed
    nonzero = int_zone & (digit != 0) & is_digit
    first_sig = _first_true(nonzero, dot_pos)
    sig = torch.where(nonzero.any(1), dot_pos - first_sig, 0)
    wrapped = (sig == 19) & (val < 0)
    min_long = wrapped & neg & (val == -2 ** 63)
    ok = (ok & (sig <= 18)) | (ok & (sig == 19) & (~wrapped | min_long))
    val = torch.where(neg & ~min_long, -val, val)
    return val, ok


def _decimal_to_double(mant: torch.Tensor, exp: torch.Tensor
                       ) -> torch.Tensor:
    """mant * 10^exp correctly rounded where mant < 2^53 and |exp| <=
    22 (one exact operation), else through a double-double product with
    10^exp (mant < 2^63)."""
    m = mant.to(torch.float64)
    fast = (mant < (1 << 53)) & (exp.abs() <= 22)
    exact = torch.tensor([10.0 ** i for i in range(23)], dtype=torch.float64,
                         device=mant.device)
    p = exact[exp.abs().clamp(max=22)]
    quick = torch.where(exp >= 0, m * p, m / p)
    # mant as hi + lo, each exact, times 10^exp = th + tl times 2^te
    m_hi = mant.to(torch.float64)
    m_lo = (mant - m_hi.to(torch.int64)).to(torch.float64)
    hi_t, lo_t, ex_t = _pow10_parts(mant.device)
    ti = (exp.clamp(_K_MIN, _K_MAX) - _K_MIN)
    th, tl, te = hi_t[ti], lo_t[ti], ex_t[ti]
    mm, me = torch.frexp(m_hi)
    me = me.to(torch.int64)
    m_lo_s = _ldexp(m_lo, -me)
    p1, p2 = _two_prod(mm, th)
    p2 = p2 + mm * tl + m_lo_s * th
    slow = _ldexp(p1 + p2, me + te)
    big = exp > _K_MAX
    small = exp < _K_MIN
    slow = torch.where(big, float("inf"), torch.where(small, 0.0, slow))
    return torch.where(fast, quick, torch.where(mant == 0, 0.0, slow))


def _parse_float(padded: torch.Tensor, lens: torch.Tensor):
    """[+-]digits[.digits][eE[+-]digits], or inf / infinity / nan (case
    blind; inf may carry a sign): (value, ok). Up to 18 significant
    digits are kept (the rest only move the exponent); the value is
    correctly rounded where _decimal_to_double says so."""
    cap, w = padded.shape
    dev = padded.device
    start, end, nonempty = _strip_bounds(padded, lens)
    k = torch.arange(w, device=dev)[None, :]
    first = _at(padded, start)
    neg = first == 45
    has_sign = neg | (first == 43)
    pos0 = start + has_sign.to(torch.int64)
    in_str = (k >= pos0[:, None]) & (k < end[:, None])
    is_digit = (padded >= 48) & (padded <= 57)
    is_dot = padded == 46
    e_mask = in_str & ((padded == 101) | (padded == 69))
    has_e = e_mask.any(1)
    e_pos = _first_true(e_mask, end)
    dot_mask = in_str & is_dot & (k < e_pos[:, None])
    has_dot = dot_mask.any(1)
    dot_pos = _first_true(dot_mask, e_pos)
    mant_zone = in_str & (k < e_pos[:, None]) & ~is_dot
    ok = nonempty & (~mant_zone | is_digit).all(1) & \
        (dot_mask.sum(1) <= 1) & (mant_zone & is_digit).any(1)
    mant = torch.zeros(cap, dtype=torch.int64, device=dev)
    shift = torch.zeros(cap, dtype=torch.int64, device=dev)
    nsig = torch.zeros(cap, dtype=torch.int64, device=dev)
    digit = padded.to(torch.int64) - 48
    for i in range(w):
        use = mant_zone[:, i] & is_digit[:, i]
        after_dot = has_dot & (i > dot_pos)
        started = (nsig > 0) | (digit[:, i] != 0)
        room = nsig < 18
        take = use & room
        mant = torch.where(take, mant * 10 + digit[:, i], mant)
        nsig = nsig + (take & started).to(torch.int64)
        # a digit dropped before the point scales by 10; one kept after
        # it divides by 10
        shift = shift + (use & ~room & ~after_dot).to(torch.int64) - \
            (take & after_dot).to(torch.int64)
    e_first = e_pos + 1
    efirst = _at(padded, e_first)
    eneg = efirst == 45
    e_dstart = e_first + (eneg | (efirst == 43)).to(torch.int64)
    e_zone = (k >= e_dstart[:, None]) & (k < end[:, None])
    ok = ok & torch.where(has_e, (e_zone & is_digit).any(1) &
                          (~e_zone | is_digit).all(1), True)
    ev = torch.zeros(cap, dtype=torch.int64, device=dev)
    for i in range(w):
        use = e_zone[:, i] & has_e
        ev = torch.where(use, (ev * 10 + digit[:, i]).clamp(max=10 ** 6),
                         ev)
    ev = torch.where(eneg, -ev, ev)
    val = _decimal_to_double(mant, ev + shift)
    val = torch.where(neg, -val, val)
    lowered = torch.where((padded >= 65) & (padded <= 90), padded + 32,
                          padded)

    def match_at(text: bytes, from_pos):
        n = len(text)
        if n > w:
            return torch.zeros(cap, dtype=torch.bool, device=dev)
        idx = (from_pos[:, None] + torch.arange(n, device=dev)[None, :]) \
            .clamp(0, w - 1)
        got = torch.gather(lowered, 1, idx)
        want = torch.tensor(list(text), dtype=torch.uint8, device=dev)
        return (end - from_pos == n) & (got == want[None, :]).all(1)

    is_inf = match_at(b"inf", pos0) | match_at(b"infinity", pos0)
    is_nan = match_at(b"nan", pos0) & ~has_sign
    val = torch.where(is_inf, torch.where(neg, float("-inf"),
                                          float("inf")), val)
    val = torch.where(is_nan, float("nan"), val)
    ok = ok | (nonempty & (is_inf | is_nan))
    return val, ok


_TRUE_STRS = [b"true", b"t", b"yes", b"y", b"1"]
_FALSE_STRS = [b"false", b"f", b"no", b"n", b"0"]


def _parse_bool(padded: torch.Tensor, lens: torch.Tensor):
    """(value, ok): true / t / yes / y / 1 and their false twins, case
    blind, whitespace trimmed as Spark trims (the JAX package does not
    trim; ROADMAP.md C13)."""
    lowered = torch.where((padded >= 65) & (padded <= 90), padded + 32,
                          padded)
    cap, w = lowered.shape
    start, end, _ = _strip_bounds(padded, lens)

    def match(text: bytes):
        if len(text) > w:
            return torch.zeros(cap, dtype=torch.bool, device=padded.device)
        want = torch.tensor(list(text), dtype=torch.uint8,
                            device=padded.device)
        idx = (start[:, None] + torch.arange(len(text),
                                             device=padded.device)[None, :])
        got = torch.gather(lowered, 1, idx.clamp(0, w - 1))
        return (end - start == len(text)) & (got == want[None, :]).all(1)
    t = torch.zeros(cap, dtype=torch.bool, device=padded.device)
    f = torch.zeros_like(t)
    for text in _TRUE_STRS:
        t = t | match(text)
    for text in _FALSE_STRS:
        f = f | match(text)
    return t, t | f


def _parse_date(padded: torch.Tensor, lens: torch.Tensor):
    """Spark's stringToDate forms: ``yyyy``, ``yyyy-[m]m``,
    ``yyyy-[m]m-[d]d``, the last with a trailing ``T...`` or `` ...``
    ignored; whitespace trimmed; a day past its month is null. (days,
    ok)."""
    from .datetime import days_from_civil
    cap, w = padded.shape
    dev = padded.device
    is_digit = (padded >= 48) & (padded <= 57)
    k = torch.arange(w, device=dev)[None, :]
    start, end0, nonempty = _strip_bounds(padded, lens)
    in_trim = (k >= start[:, None]) & (k < end0[:, None])
    t_mask = in_trim & ((padded == 84) | (padded == 32))
    has_t = t_mask.any(1)
    end = _first_true(t_mask, end0)
    in_str = (k >= start[:, None]) & (k < end[:, None])
    dash_mask = in_str & (padded == 45)
    n_dash = dash_mask.sum(1)
    first_dash = _first_true(dash_mask, end)
    second_dash = _first_true(dash_mask & (k > first_dash[:, None]), end)
    digit = padded.to(torch.int64) - 48

    def span(lo, hi):
        v = torch.zeros(cap, dtype=torch.int64, device=dev)
        good = torch.ones(cap, dtype=torch.bool, device=dev)
        for i in range(w):
            use = (i >= lo) & (i < hi)
            v = torch.where(use, (v * 10 + digit[:, i]).clamp(max=10 ** 9),
                            v)
            good = good & torch.where(use, is_digit[:, i], True)
        return v, good
    y, gy = span(start, first_dash)
    m, gm = span(first_dash + 1, second_dash)
    d, gd = span(second_dash + 1, end)
    ylen = first_dash - start
    mlen = second_dash - first_dash - 1
    dlen = end - second_dash - 1
    y_ok = gy & (ylen == 4)
    shape0 = (n_dash == 0) & y_ok & ~has_t
    shape1 = (n_dash == 1) & y_ok & gm & (mlen >= 1) & (mlen <= 2) & ~has_t
    shape2 = (n_dash == 2) & y_ok & gm & gd & (mlen >= 1) & (mlen <= 2) \
        & (dlen >= 1) & (dlen <= 2)
    m = torch.where(n_dash >= 1, m, 1)
    d = torch.where(n_dash >= 2, d, 1)
    ok = nonempty & (shape0 | shape1 | shape2) & (m >= 1) & (m <= 12)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    dim = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=torch.int64, device=dev)
    max_d = torch.where((m == 2) & leap, 29, dim[(m - 1).clamp(0, 11)])
    ok = ok & (d >= 1) & (d <= max_d)
    days = days_from_civil(y, m.clamp(1, 12), d.clamp(1, 31))
    return days, ok


def cast_from_string(c: StringColumn, to: dt.DType) -> Column:
    """A string column parsed as ``to``; a row that does not parse is
    null (non-ANSI)."""
    padded = c.padded()
    lens = c.lengths().to(torch.int64)
    if to.is_integral:
        val, ok = _parse_int(padded, lens)
        ok = ok & (val >= dt.min_value(to)) & (val <= dt.max_value(to))
        return make_result(val.to(to.physical), c.validity & ok, to)
    if to.is_floating:
        val, ok = _parse_float(padded, lens)
        return make_result(val.to(to.physical), c.validity & ok, to)
    if to == dt.BOOL:
        val, ok = _parse_bool(padded, lens)
        return make_result(val, c.validity & ok, to)
    if to == dt.DATE:
        val, ok = _parse_date(padded, lens)
        return make_result(val.to(torch.int32), c.validity & ok, to)
    if dt.is_decimal(to):
        if to.is_wide:
            from .core import cpu_fallback
            raise cpu_fallback(f"CAST(STRING AS {to})", "_tag_cast")
        val, ok = _parse_decimal(padded, lens, to)
        return make_result(val, c.validity & ok, to)
    raise TypeError(f"cast string -> {to} is not in this port yet")


def _parse_decimal(padded: torch.Tensor, lens: torch.Tensor,
                   to: "dt.DecimalType"):
    """[+-]digits[.digits][eE[+-]digits] as the unscaled int64 at the
    long-backed ``to``, exactly: each digit lands at its power of ten
    plus the scale, the first digit past the scale rounds HALF_UP, and
    a digit at or past the precision makes the row null (Spark's
    BigDecimal, then changePrecision)."""
    cap, w = padded.shape
    dev = padded.device
    start, end, nonempty = _strip_bounds(padded, lens)
    k = torch.arange(w, device=dev)[None, :]
    first = _at(padded, start)
    neg = first == 45
    pos0 = start + (neg | (first == 43)).to(torch.int64)
    in_str = (k >= pos0[:, None]) & (k < end[:, None])
    is_digit = (padded >= 48) & (padded <= 57)
    e_mask = in_str & ((padded == 101) | (padded == 69))
    has_e = e_mask.any(1)
    e_pos = _first_true(e_mask, end)
    dot_mask = in_str & (padded == 46) & (k < e_pos[:, None])
    dot_pos = _first_true(dot_mask, e_pos)
    mant_zone = in_str & (k < e_pos[:, None]) & (padded != 46)
    ok = nonempty & (~mant_zone | is_digit).all(1) & \
        (dot_mask.sum(1) <= 1) & (mant_zone & is_digit).any(1)
    digit = padded.to(torch.int64) - 48
    e_first = e_pos + 1
    efirst = _at(padded, e_first)
    eneg = efirst == 45
    e_dstart = e_first + (eneg | (efirst == 43)).to(torch.int64)
    e_zone = (k >= e_dstart[:, None]) & (k < end[:, None])
    ok = ok & torch.where(has_e, (e_zone & is_digit).any(1) &
                          (~e_zone | is_digit).all(1), True)
    ev = torch.zeros(cap, dtype=torch.int64, device=dev)
    for i in range(w):
        ev = torch.where(e_zone[:, i] & has_e,
                         (ev * 10 + digit[:, i]).clamp(max=10 ** 6), ev)
    ev = torch.where(eneg, -ev, ev) + to.scale
    val = torch.zeros(cap, dtype=torch.int64, device=dev)
    over = torch.zeros(cap, dtype=torch.bool, device=dev)
    up = torch.zeros(cap, dtype=torch.bool, device=dev)
    for i in range(w):
        d = torch.where(mant_zone[:, i] & is_digit[:, i], digit[:, i], 0)
        # the digit's power of ten at the target scale
        e = dot_pos - i - (i < dot_pos).to(torch.int64) + ev
        val = val + torch.where((e >= 0) & (e < to.precision),
                                d * _pow10(dev)[e.clamp(0, 18)], 0)
        over = over | ((d != 0) & (e >= to.precision))
        up = up | ((e == -1) & (d >= 5))
    val = val + up.to(torch.int64)
    ok = ok & ~over & (val < _POW10[to.precision])
    return torch.where(neg, -val, val), ok
