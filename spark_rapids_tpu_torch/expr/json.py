"""JSON expressions: ``get_json_object`` over flat string bytes.

Counterpart of spark_rapids_tpu/expr/json.py. The JAX package runs its
path kernel over the padded ``(capacity, pad_bucket)`` string view: a
``lax.scan`` across the columns for the in-string / escape state
machine, a cumsum of unquoted brackets for the structural depth, then
``_narrow_key`` / ``_narrow_index`` / ``_extract_final`` per path
segment (JAX :85-325). Here the same steps are segmented scans over the
column's flat bytes, so work and memory follow the bytes, not rows x
the longest document:

- the state machine is a segmented prefix scan of its byte transitions
  (four states, so a transition is one byte: four two-bit entries, and
  two compose through a 64 KiB table) in log2(longest document)
  doubling steps,
- the depth is a segmented cumsum of the unquoted brackets,
- "the first position at or after s in each row where m holds" is a
  scatter-min of the byte positions by row, reading the padding past a
  row's end as the JAX padded view does (a zero byte: not whitespace,
  the row's final depth and string state),
- the result's bytes are gathered once from the final spans.

Semantic envelope, kept as the JAX package has it (ROADMAP C17): a
nested object or array result is the raw input span (whitespace kept),
and ``\\uXXXX`` escapes pass through undecoded; a malformed document
(unbalanced brackets, an open string) gives NULL. Scalar extractions
match Spark. ``from_json`` / ``to_json`` run on the CPU engine (the
planner's gate sends them there).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (ColumnarBatch, StringColumn, round_pow2,
                               rows_from_offsets)
from .core import Expression, Schema, cpu_fallback


class JsonPathUnsupported(TypeError):
    pass


def parse_json_path(path: str) -> List[Tuple[str, object]]:
    """'$.a[2].b' -> [('key', 'a'), ('index', 2), ('key', 'b')] (copied
    from the JAX package). Wildcards and recursive descent raise
    JsonPathUnsupported."""
    if not path.startswith("$"):
        raise JsonPathUnsupported(f"JSON path must start with $: {path!r}")
    i = 1
    segs: List[Tuple[str, object]] = []
    while i < len(path):
        c = path[i]
        if c == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            name = path[i + 1:j]
            if not name or "*" in name:
                raise JsonPathUnsupported(f"unsupported segment in {path!r}")
            segs.append(("key", name))
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                raise JsonPathUnsupported(f"unterminated [ in {path!r}")
            body = path[i + 1:j].strip()
            if body.startswith("'") and body.endswith("'"):
                segs.append(("key", body[1:-1]))
            else:
                try:
                    segs.append(("index", int(body)))
                except ValueError:
                    raise JsonPathUnsupported(
                        f"unsupported subscript {body!r} in {path!r}")
            i = j + 1
        else:
            raise JsonPathUnsupported(f"bad JSON path {path!r} at {i}")
    return segs


#: the "not found" position (every real position is below it)
_LIM = 1 << 40

_QUOTE, _BSLASH = ord('"'), ord("\\")
_WS = (ord(" "), ord("\t"), ord("\n"), ord("\r"))


def _transition(q: bool, b: bool) -> int:
    """A byte's step of the string state machine (JAX :85-110) over the
    states in_string * 2 + escaped, packed two bits a state."""
    out = 0
    for s in range(4):
        in_s, esc = s >> 1, s & 1
        toggles = int(q and not esc)
        new_in = in_s ^ toggles
        new_esc = int(b and not esc and bool(in_s))
        out |= (new_in * 2 + new_esc) << (2 * s)
    return out


_COMPOSE = {}


def _compose_table(device) -> torch.Tensor:
    """uint8[65536]: entry g * 256 + f is "f, then g"."""
    if device not in _COMPOSE:
        f = torch.arange(256, dtype=torch.int64)
        g = torch.arange(256, dtype=torch.int64)
        out = torch.zeros(256, 256, dtype=torch.int64)
        for s in range(4):
            mid = (f >> (2 * s)) & 3
            fin = (g[:, None] >> (2 * mid[None, :])) & 3
            out |= fin << (2 * s)
        _COMPOSE[device] = out.flatten().to(torch.uint8).to(device)
    return _COMPOSE[device]


def _next_at_or_after(mask: torch.Tensor, pos: torch.Tensor):
    """Per position, the least position >= it where ``mask`` holds, or
    _LIM (a binary search among the set positions: ``torch.cummin`` runs
    as one thread block on the card)."""
    at = torch.nonzero(mask).flatten()
    if not at.numel():
        return torch.full_like(pos, _LIM)
    i = torch.searchsorted(at, pos)
    return torch.where(i < at.numel(), at[i.clamp(max=at.numel() - 1)],
                       _LIM)


def _last_at_or_before(mask: torch.Tensor, pos: torch.Tensor):
    """Per position, the greatest position <= it where ``mask`` holds,
    or -1."""
    at = torch.nonzero(mask).flatten()
    if not at.numel():
        return torch.full_like(pos, -1)
    i = torch.searchsorted(at, pos, right=True) - 1
    return torch.where(i >= 0, at[i.clamp(min=0)], -1)


class _Doc:
    """Per-byte masks of one string column: row, position in the row,
    whitespace, in-string, structural depth; per row the final depth and
    string state."""

    def __init__(self, col: StringColumn):
        dev = col.device
        self.dev = dev
        o = col.offsets.to(torch.int64)
        self.start = o[:-1]
        self.lens = o[1:] - o[:-1]
        self.n = col.capacity
        total = int(o[-1]) if self.n else 0
        self.total = total
        self.chars = col.chars[:total].to(torch.int64)
        self.row = rows_from_offsets(self.start, self.lens, total)
        self.j = torch.arange(total, device=dev) - self.start[self.row]
        c = self.chars
        ws = torch.zeros(total, dtype=torch.bool, device=dev)
        for w in _WS:
            ws |= c == w
        self.ws = ws
        q, b = c == _QUOTE, c == _BSLASH
        steps = torch.tensor([_transition(False, False),
                              _transition(True, False),
                              _transition(False, True)],
                             dtype=torch.int64, device=dev)
        f = steps[q.to(torch.int64) + 2 * b.to(torch.int64)]
        # segmented inclusive scan: F[p] = f[p] o ... o f[row start]
        table = _compose_table(dev).to(torch.int64)
        longest = int(self.lens.max()) if self.n else 0
        d = 1
        while d < longest:
            prev = torch.empty_like(f)
            prev[d:] = f[:-d]
            take = self.j >= d
            f = torch.where(take, table[f * 256 + torch.where(take, prev,
                                                              0)], f)
            d *= 2
        after = f & 3  # state after each byte, from (False, False)
        before = torch.zeros_like(after)
        before[1:] = after[:-1]
        before = torch.where(self.j == 0, 0, before)
        in_s, esc = before >> 1, before & 1
        toggles = q & (esc == 0)
        self.inside = (in_s == 1) & ~toggles
        opens = ((c == ord("{")) | (c == ord("["))) & ~self.inside
        closes = ((c == ord("}")) | (c == ord("]"))) & ~self.inside
        step = opens.to(torch.int64) - closes.to(torch.int64)
        cs = torch.cumsum(step, 0)
        base = torch.zeros(self.n + 1, dtype=torch.int64, device=dev)
        base[1:] = torch.cumsum(
            torch.zeros(self.n, dtype=torch.int64, device=dev).index_add_(
                0, self.row, step) if total else
            torch.zeros(self.n, dtype=torch.int64, device=dev), 0)
        self.depth = cs - base[self.row]
        last = (o[1:] - 1).clamp(min=0)
        has = self.lens > 0
        self.final_depth = torch.where(
            has, self.depth[last.clamp(max=max(total - 1, 0))]
            if total else 0, 0)
        self.final_inside = has & (
            self.inside[last.clamp(max=max(total - 1, 0))]
            if total else has)
        # next non-whitespace at or after each byte (the row's end when
        # only whitespace follows: the padding reads as non-whitespace),
        # by a binary search among the non-whitespace positions
        pos = torch.arange(total, device=dev)
        self.nn = torch.minimum(_next_at_or_after(~ws, pos),
                                o[1:][self.row]) - self.start[self.row]

    def at(self, flat: torch.Tensor, x: torch.Tensor, beyond):
        """Per row, ``flat`` at local position x (clamped at 0); past the
        row's end, ``beyond`` (the padding's value)."""
        x = x.clamp(min=0)
        ok = x < self.lens
        idx = (self.start + x.clamp(max=_LIM)).clamp(
            max=max(self.total - 1, 0))
        v = flat[idx] if self.total else torch.zeros_like(x)
        return torch.where(ok, v, beyond)

    def first(self, mask: torch.Tensor, start: torch.Tensor, limit,
              pad=False):
        """Per row, the least local position >= start where ``mask``
        holds, or ``limit`` (JAX ``_first_true_at_or_after``); ``pad``
        says whether the padding past the row's end holds."""
        cand = mask & (self.j >= start[self.row])
        out = torch.full((self.n,), _LIM, dtype=torch.int64,
                         device=self.dev)
        out.scatter_reduce_(0, self.row, torch.where(cand, self.j, _LIM),
                            "amin")
        pad = torch.as_tensor(pad, device=self.dev)
        out = torch.where(pad, torch.minimum(
            out, torch.maximum(start, self.lens)), out)
        return torch.minimum(out, torch.as_tensor(limit, device=self.dev))

    def value_span(self, vstart: torch.Tensor, limit):
        """(vstart, vend) of the value starting at vstart (JAX
        ``_value_span``)."""
        c = self.chars
        first = self.at(c, vstart, 0)
        base = self.at(self.depth, vstart - 1, self.final_depth)
        base = torch.where(vstart > 0, base, 0)
        is_str = first == _QUOTE
        is_nest = (first == ord("{")) | (first == ord("["))
        str_close = self.first((c == _QUOTE) & ~self.inside, vstart + 1,
                               limit)
        nest_close = self.first(self.depth <= base[self.row], vstart, limit,
                                pad=self.final_depth <= base)
        stop = ((c == ord(",")) | (c == ord("}")) | (c == ord("]")) |
                self.ws) & ~self.inside
        scal_end = self.first(stop, vstart, limit)
        lim = torch.as_tensor(limit, device=self.dev)
        vend = torch.where(is_str, torch.minimum(str_close + 1, lim),
                           torch.where(is_nest,
                                       torch.minimum(nest_close + 1, lim),
                                       scal_end))
        return vstart, vend

    def narrow_key(self, key: str, start, end):
        kb = ('"' + key + '"').encode("utf-8")
        kl = len(kb)
        c = self.chars
        row_end = self.lens[self.row]
        hit = torch.ones(self.total, dtype=torch.bool, device=self.dev)
        for off, byte in enumerate(kb):
            ok = self.j + off < row_end
            shifted = torch.zeros_like(c)
            if off:
                shifted[:-off] = c[off:]
            else:
                shifted = c
            hit &= ok & (shifted == byte)
        base = self.at(self.depth, start, self.final_depth)
        in_span = (self.j > start[self.row]) & (self.j < end[self.row])
        q = self.j + kl
        qi = (self.start[self.row] + q).clamp(max=max(self.total - 1, 0))
        after_nn = torch.where(q < row_end, self.nn[qi] if self.total
                               else q, q)
        ai = (self.start[self.row] + after_nn).clamp(
            max=max(self.total - 1, 0))
        colon = (after_nn < row_end) & (c[ai] == ord(":"))
        ok = hit & in_span & ~self.inside & \
            (self.depth == base[self.row]) & colon
        kpos = self.first(ok, start + 1, _LIM)
        found = kpos < end
        non_ws = self.first(~self.ws, kpos + kl, _LIM, pad=True)
        vstart = self.first(~self.ws, non_ws + 1, _LIM, pad=True)
        found = found & (vstart < end)
        vs, ve = self.value_span(vstart, end)
        return torch.where(found, vs, _LIM), torch.where(found, ve, _LIM)

    def narrow_index(self, idx: int, start, end):
        c = self.chars
        is_arr = self.at(c, start, 0) == ord("[")
        base = self.at(self.depth, start, self.final_depth)
        in_span = (self.j > start[self.row]) & (self.j < end[self.row])
        commas = (c == ord(",")) & ~self.inside & \
            (self.depth == base[self.row]) & in_span
        if idx == 0:
            sep = start
        else:
            cs = torch.cumsum(commas.to(torch.int64), 0)
            before = torch.zeros(self.n + 1, dtype=torch.int64,
                                 device=self.dev)
            before[1:] = torch.cumsum(torch.zeros(
                self.n, dtype=torch.int64, device=self.dev).index_add_(
                0, self.row, commas.to(torch.int64)), 0)
            n_before = cs - before[self.row]
            sep = self.first(commas & (n_before == idx), start, _LIM)
        vstart = self.first(~self.ws, sep + 1, _LIM, pad=True)
        vbyte = self.at(c, vstart, 0)
        found = is_arr & (sep < end) & (vstart < end) & (vbyte != ord("]"))
        vs, ve = self.value_span(vstart, end)
        return torch.where(found, vs, _LIM), torch.where(found, ve, _LIM)

    def extract(self, col: StringColumn, vs, ve) -> StringColumn:
        """The result column of the final spans (JAX
        ``_extract_final``): a string value unquoted with its simple
        escapes applied, a ``null`` scalar as SQL NULL, anything else
        the raw span."""
        c = self.chars
        found = (vs < _LIM) & (ve > vs)
        first = self.at(c, vs, 0)
        is_str = found & (first == _QUOTE)
        vs = torch.where(is_str, vs + 1, vs)
        ve = torch.where(is_str, ve - 1, ve)
        is_null = found & (ve - vs == 4) & ~is_str
        for off, byte in enumerate(b"null"):
            is_null &= self.at(c, vs + off, 0) == byte
        found = found & ~is_null
        in_len = torch.where(found, (ve - vs).clamp(min=0), 0)
        r = self.row
        span = (self.j >= vs[r]) & (self.j < vs[r] + in_len[r])
        bs = span & (c == _BSLASH)
        nxt = torch.zeros_like(c)
        nxt[:-1] = c[1:]
        nxt = torch.where(span & (self.j + 1 < vs[r] + in_len[r]), nxt, 0)
        simple = torch.zeros_like(bs)
        for e in b'"\\/ntrbf':
            simple |= nxt == e
        # a backslash escapes when it stands at an even place of its run
        # of backslashes within the span
        pos = torch.arange(self.total, device=self.dev)
        run_start = _last_at_or_before(~bs, pos) + 1
        run_start = torch.maximum(run_start, self.start[r] + vs[r])
        chain = bs & ((pos - run_start) % 2 == 0)
        esc = chain & simple & is_str[r]
        prev_esc = torch.zeros_like(esc)
        prev_esc[1:] = esc[:-1]
        prev_esc &= span & (self.j > vs[r])
        table = torch.arange(256, dtype=torch.int64, device=self.dev)
        for a, b in ((ord("n"), 10), (ord("t"), 9), (ord("r"), 13),
                     (ord("b"), 8), (ord("f"), 12)):
            table[a] = b
        out = torch.where(prev_esc, table[c], c).to(torch.uint8)
        keep = span & ~esc
        validity = col.validity & found
        keep &= validity[r]
        lens = torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        lens.index_add_(0, r, keep.to(torch.int64))
        offsets = torch.zeros(self.n + 1, dtype=torch.int32, device=self.dev)
        offsets[1:] = torch.cumsum(lens, 0).to(torch.int32)
        kept = out[keep]
        total = kept.shape[0]
        chars = torch.zeros(max(-(-total // 128) * 128, 128),
                            dtype=torch.uint8, device=self.dev)
        chars[:total] = kept
        longest = int(lens.max()) if self.n else 0
        return StringColumn(offsets, chars, validity,
                            pad_bucket=round_pow2(longest))


class GetJsonObject(Expression):
    """get_json_object(json, path) with a literal path."""

    def __init__(self, child: Expression, path: str):
        super().__init__(child)
        self.path = path
        self.segments = parse_json_path(path)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch) -> StringColumn:
        col = self.children[0].eval(batch)
        doc = _Doc(col)
        lens = doc.lens
        zeros = torch.zeros(doc.n, dtype=torch.int64, device=doc.dev)
        start = doc.first(~doc.ws & (doc.j < lens[doc.row]), zeros, _LIM)
        vs, ve = doc.value_span(start, lens)
        has = start < lens
        well_formed = (lens == 0) | ((doc.final_depth == 0) &
                                     ~doc.final_inside)
        ok = has & well_formed
        vs, ve = torch.where(ok, vs, _LIM), torch.where(ok, ve, _LIM)
        for kind, arg in self.segments:
            if kind == "key":
                vs, ve = doc.narrow_key(arg, vs, ve)
            else:
                vs, ve = doc.narrow_index(arg, vs, ve)
        return doc.extract(col, vs, ve)

    def __repr__(self):
        return f"get_json_object({self.children[0]!r}, {self.path!r})"


class JsonToStructs(Expression):
    """from_json(json, schema): runs on the CPU engine (the planner's
    gate sends it there, as the JAX planner does)."""

    def __init__(self, child: Expression, schema: dt.StructType):
        super().__init__(child)
        self.struct_schema = schema

    def data_type(self, schema: Schema) -> dt.DType:
        return self.struct_schema

    def eval(self, batch: ColumnarBatch):
        raise cpu_fallback("from_json", "nested gate")


class StructsToJson(Expression):
    """to_json(struct): runs on the CPU engine (the planner's gate
    sends it there)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        raise cpu_fallback("to_json", "nested gate")
