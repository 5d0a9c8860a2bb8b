"""Host table -> ORC file, without the Arrow library.

The ORC lane of spark_rapids_tpu/io/writer.py:40-42, which writes through
pyarrow's ``orc.write_table``. The file is laid out as the format says:
``ORC``, then per stripe (at most ``STRIPE_ROWS`` rows) each column's
streams and the stripe footer, then the file footer and the postscript
with its length. Streams are encoded in the host library
(csrc/host/orc.cpp): PRESENT and BOOLEAN as bit bytes (MSB first) under
byte RLE, BYTE under byte RLE, integers, dates, string lengths, decimal
scales and timestamp seconds / nanoseconds as integer RLE v1 (the
DIRECT encoding), DECIMAL as zigzag varints, FLOAT / DOUBLE as IEEE
bytes, STRING as the bytes behind their lengths; each stream framed in
chunks of ``BLOCK`` bytes under the codec. Timestamps are UTC
(``TIMESTAMP`` with writer time zone UTC): seconds from 2015-01-01
truncated toward zero and signed nanoseconds with their trailing-zero
scale, as Arrow's ORC writer stores them, so a time before 1970 reads
back exactly. The protobuf messages are written here (``PbOut``).

``compression``: ``none`` / ``uncompressed``, ``zlib``, ``snappy`` (the
default) and ``zstd``, where the build has the codec. Nested columns
raise NotImplementedError naming the column (ROADMAP A7.4).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import __version__
from ..columnar import dtypes as dt
from ..columnar.decimal128 import limbs_of_ints
from ..columnar.vector import HostStrings
from ..plan.host_table import HostColumn, HostTable
from . import host_lib as HL
from . import native_orc as O

STRIPE_ROWS = 1 << 20
BLOCK = 256 * 1024
#: compression option -> ORC CompressionKind
COMPRESSION = {"none": 0, "uncompressed": 0, "zlib": 1, "snappy": 2,
               "zstd": 5}
_LIB_CODEC = {0: 0, 1: 4, 2: 1, 5: 3}
_KINDS = {dt.BOOL: O.BOOLEAN, dt.INT8: O.BYTE, dt.INT16: O.SHORT,
          dt.INT32: O.INT, dt.INT64: O.LONG, dt.FLOAT32: O.FLOAT,
          dt.FLOAT64: O.DOUBLE, dt.STRING: O.STRING, dt.DATE: O.DATE,
          dt.TIMESTAMP: O.TIMESTAMP}


class PbOut:
    """A protobuf message being written."""

    def __init__(self):
        self.b = bytearray()

    def _varint(self, v: int) -> None:
        v &= (1 << 64) - 1
        while v >= 0x80:
            self.b.append((v & 0x7F) | 0x80)
            v >>= 7
        self.b.append(v)

    def uint(self, fn: int, v: int) -> "PbOut":
        self._varint(fn << 3)
        self._varint(int(v))
        return self

    def bytes(self, fn: int, v) -> "PbOut":
        self._varint(fn << 3 | 2)
        self._varint(len(v))
        self.b += bytes(v)
        return self

    def packed(self, fn: int, vals) -> "PbOut":
        inner = PbOut()
        for v in vals:
            inner._varint(int(v))
        return self.bytes(fn, inner.b)


def compression_of(option: str) -> int:
    key = (option or "snappy").lower()
    if key not in COMPRESSION:
        raise ValueError(f"orc compression {option!r}: one of "
                         f"{sorted(COMPRESSION)}")
    kind = COMPRESSION[key]
    if not HL.lib().srt_codec_mask() >> _LIB_CODEC[kind] & 1:
        raise HL.CodecMissing(f"orc writer: the {key} codec is not in this "
                              f"build (codecs {HL.codecs()})")
    return kind


def _call(fn, *args, what: str, cap: int) -> np.ndarray:
    """An encoder's output, growing the buffer while it is too small."""
    for _ in range(6):
        out = np.empty(cap, np.uint8)
        got = fn(*args, HL.ptr(out), cap)
        if got != -3:
            break
        cap *= 4
    if got < 0:
        raise ValueError(f"{what}: encoder code {got}")
    return out[:got]


def _byte_rle(data: np.ndarray, what: str) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    return _call(HL.lib().orc_byte_rle_encode, HL.ptr(data), len(data),
                 what=what, cap=len(data) + len(data) // 64 + 16)


def _int_rle(vals: np.ndarray, signed: bool, what: str) -> np.ndarray:
    vals = np.ascontiguousarray(vals, np.int64)
    return _call(HL.lib().orc_int_rle_v1_encode, HL.ptr(vals), len(vals),
                 int(signed), what=what, cap=11 * len(vals) + 16)


def _bools(bits: np.ndarray, what: str) -> np.ndarray:
    return _byte_rle(np.packbits(np.asarray(bits, bool)), what)


def _nanos(rem_us: np.ndarray) -> np.ndarray:
    """Signed nanoseconds in ORC's form: a non-zero value keeps its
    digits before its trailing zeros shifted left by 3, beside the count
    of those zeros less one (at most 7)."""
    nanos = rem_us * 1000
    scaled = nanos != 0
    n = _tdiv(nanos, 100)
    zeros = np.ones(len(n), np.int64)
    while True:
        more = scaled & (np.fmod(n, 10) == 0) & (zeros < 7)
        if not more.any():
            break
        n[more] = _tdiv(n[more], 10)
        zeros[more] += 1
    return np.where(scaled, (n << 3) | zeros, 0)


def _tdiv(a: np.ndarray, b: int) -> np.ndarray:
    """Integer division truncating toward zero (C's)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def _column_streams(c: HostColumn, name: str, kind: int, ci: int):
    """[(stream kind, column id, bytes)] of one column in one stripe."""
    what = f"orc writer, column {name!r}"
    valid = np.asarray(c.mask, bool)
    out = []
    if not valid.all():
        out.append((O.PRESENT, ci, _bools(valid, what)))
    t = c.dtype
    if t == dt.STRING:
        s = c.values if isinstance(c.values, HostStrings) else \
            HostStrings.from_objects([v if ok else None for v, ok in
                                      zip(c.values, valid)])
        lens = s.lengths().astype(np.int64)
        keep = np.repeat(valid, lens)
        chars = s.chars[int(s.offsets[0]):int(s.offsets[-1])]
        out.append((O.DATA, ci, chars[keep] if not valid.all() else chars))
        out.append((O.LENGTH, ci, _int_rle(lens[valid], False, what)))
        return out
    vals = c.values[valid]
    if kind == O.BOOLEAN:
        out.append((O.DATA, ci, _bools(vals, what)))
    elif kind == O.BYTE:
        out.append((O.DATA, ci, _byte_rle(vals.astype(np.int8)
                                          .view(np.uint8), what)))
    elif kind in (O.SHORT, O.INT, O.LONG, O.DATE):
        out.append((O.DATA, ci, _int_rle(vals, True, what)))
    elif kind in (O.FLOAT, O.DOUBLE):
        np_t = np.float32 if kind == O.FLOAT else np.float64
        out.append((O.DATA, ci, np.ascontiguousarray(vals, np_t)
                    .view(np.uint8)))
    elif kind == O.TIMESTAMP:
        us = vals.astype(np.int64)
        secs = _tdiv(us, 1_000_000)
        out.append((O.DATA, ci, _int_rle(secs - O.EPOCH_2015, True, what)))
        out.append((O.SECONDARY, ci,
                    _int_rle(_nanos(us - secs * 1_000_000), False, what)))
    elif kind == O.DECIMAL:
        if vals.dtype == object:
            hi, lo = limbs_of_ints(vals)
        else:
            lo = vals.astype(np.int64)
            hi = np.where(lo < 0, -1, 0).astype(np.int64)
        hi = np.ascontiguousarray(hi, np.int64)
        lo = np.ascontiguousarray(lo, np.int64)
        out.append((O.DATA, ci, _call(
            HL.lib().orc_decimal_encode, HL.ptr(hi), HL.ptr(lo), len(lo),
            what=what, cap=20 * len(lo) + 16)))
        out.append((O.SECONDARY, ci, _int_rle(
            np.full(len(lo), t.scale, np.int64), True, what)))
    return out


def _frame(data: np.ndarray, kind: int) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    return _call(HL.lib().orc_frame, HL.ptr(data), len(data), kind, BLOCK,
                 what="orc writer", cap=len(data) + 3 * (len(data) // BLOCK
                                                         + 2) + 1024)


def _kind_of(name: str, t: dt.DType) -> int:
    if isinstance(t, dt.DecimalType):
        return O.DECIMAL
    kind = _KINDS.get(t)
    if kind is None:
        raise NotImplementedError(
            f"orc writer: column {name!r} ({t}): "
            + ("nested columns are not written by this port (ROADMAP "
               "A7.4)" if t.is_nested else "this type is not written"))
    return kind


def write_orc_file(table: HostTable, path: str,
                   compression: str = "snappy",
                   stripe_rows: int = STRIPE_ROWS) -> int:
    """Write ``table`` to ``path``; returns the file's bytes."""
    kinds = [_kind_of(n, c.dtype) for n, c in zip(table.names,
                                                  table.columns)]
    comp = compression_of(compression)
    ncols = len(kinds)
    n = table.num_rows
    stripes: List[bytes] = []
    has_null = [False] * ncols
    pos = 3
    with open(path, "wb") as fh:
        fh.write(b"ORC")
        for start in range(0, max(n, 1), stripe_rows):
            if n == 0:
                break
            part = table.slice(start, min(start + stripe_rows, n))
            rows = part.num_rows
            sf = PbOut()
            body = []
            for ci, (name, c, kind) in enumerate(zip(table.names,
                                                     part.columns,
                                                     kinds), 1):
                has_null[ci - 1] |= not bool(np.all(c.mask))
                for skind, col, data in _column_streams(c, name, kind, ci):
                    framed = _frame(data, comp)
                    body.append(framed)
                    sf.bytes(1, PbOut().uint(1, skind).uint(2, col)
                             .uint(3, len(framed)).b)
            for _ in range(ncols + 1):
                sf.bytes(2, PbOut().uint(1, O.DIRECT).b)
            sf.bytes(3, b"UTC")
            footer = _frame(np.frombuffer(bytes(sf.b), np.uint8), comp)
            data_len = sum(len(b) for b in body)
            for b in body:
                fh.write(memoryview(b))
            fh.write(memoryview(footer))
            stripes.append(PbOut().uint(1, pos).uint(2, 0).uint(3, data_len)
                           .uint(4, len(footer)).uint(5, rows).b)
            pos += data_len + len(footer)
        ft = PbOut().uint(1, 3).uint(2, pos)
        for s in stripes:
            ft.bytes(3, s)
        root = PbOut().uint(1, O.STRUCT).packed(2, range(1, ncols + 1))
        for name in table.names:
            root.bytes(3, name.encode("utf-8"))
        ft.bytes(4, root.b)
        for c, kind in zip(table.columns, kinds):
            ty = PbOut().uint(1, kind)
            if kind == O.DECIMAL:
                ty.uint(5, c.dtype.precision).uint(6, c.dtype.scale)
            ft.bytes(4, ty.b)
        ft.uint(6, n)
        ft.bytes(7, PbOut().uint(1, n).uint(10, 0).b)
        for c, nulls in zip(table.columns, has_null):
            ft.bytes(7, PbOut().uint(1, int(np.sum(c.mask)))
                     .uint(10, int(nulls)).b)
        ft.uint(8, 0)
        ft.bytes(12, f"spark_rapids_tpu_torch {__version__}".encode())
        footer = _frame(np.frombuffer(bytes(ft.b), np.uint8), comp)
        fh.write(memoryview(footer))
        ps = PbOut().uint(1, len(footer)).uint(2, comp).uint(3, BLOCK) \
            .packed(4, [0, 12]).uint(5, 0).uint(6, 6) \
            .bytes(8000, b"ORC").b
        fh.write(bytes(ps))
        fh.write(bytes([len(ps)]))
        return pos + len(footer) + len(ps) + 1
