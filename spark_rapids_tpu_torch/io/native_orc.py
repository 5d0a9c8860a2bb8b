"""ORC file -> host tables, without the Arrow library.

The port's counterpart of spark_rapids_tpu/io/native_orc.py (the
GpuOrcScan.scala host-decode role). The cold metadata path runs here:
the postscript, the footer and each stripe footer are protobuf messages,
walked by a small varint reader (``Pb``). The byte loops run in the host
library (csrc/host/orc.cpp, bound in io/host_lib.py, without the GIL):
the compression framing (NONE, ZLIB, SNAPPY, ZSTD), PRESENT and boolean
streams, byte RLE, integer RLE v1 and v2 (SHORT_REPEAT, DIRECT, DELTA,
PATCHED_BASE) and DECIMAL varints up to 128 bits. numpy spreads each
stream's values over the stripe's rows.

Types, the flat ones the Parquet lane reads: BOOLEAN, BYTE, SHORT, INT,
LONG, FLOAT, DOUBLE, STRING / VARCHAR / CHAR (DIRECT, DIRECT_V2,
DICTIONARY, DICTIONARY_V2), DATE, TIMESTAMP and TIMESTAMP_INSTANT
(seconds from 2015-01-01 UTC plus nanoseconds with their trailing-zero
scale; the ORC C++ reader's correction for a negative second) and
DECIMAL (the 64-bit lane up to 18 digits, Python ints above). Unlike the
JAX package's native lane there is no pyarrow fallback: a LIST, MAP,
STRUCT or UNION column, BINARY, or a codec the build lacks raises
NotImplementedError naming the column (ROADMAP A7.4 holds nested ORC).
Timestamps are read as UTC; a stripe written in another time zone
raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.decimal128 import ints_of_limbs
from ..columnar.vector import HostStrings
from ..plan.host_table import HostColumn, HostTable
from . import host_lib as HL

# orc_proto Type.Kind
BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP, \
    LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR, \
    TIMESTAMP_INSTANT = range(19)
KIND_NAMES = ("BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE",
              "STRING", "BINARY", "TIMESTAMP", "LIST", "MAP", "STRUCT",
              "UNION", "DECIMAL", "DATE", "VARCHAR", "CHAR",
              "TIMESTAMP_INSTANT")
# Stream.Kind
PRESENT, DATA, LENGTH, DICTIONARY_DATA, DICTIONARY_COUNT, SECONDARY = \
    range(6)
# ColumnEncoding.Kind
DIRECT, DICTIONARY, DIRECT_V2, DICTIONARY_V2 = range(4)
#: CompressionKind the host library reads (LZO and LZ4 are not)
COMPRESSION = {0: "NONE", 1: "ZLIB", 2: "SNAPPY", 5: "ZSTD"}
#: ORC's timestamp epoch, 2015-01-01 00:00:00 UTC, in seconds
EPOCH_2015 = 1420070400
_UTC = ("", "UTC", "GMT", "Etc/UTC", "Etc/GMT", "Z", "+00:00", "UCT")

_SIMPLE = {BOOLEAN: dt.BOOL, BYTE: dt.INT8, SHORT: dt.INT16, INT: dt.INT32,
           LONG: dt.INT64, FLOAT: dt.FLOAT32, DOUBLE: dt.FLOAT64,
           STRING: dt.STRING, VARCHAR: dt.STRING, CHAR: dt.STRING,
           DATE: dt.DATE, TIMESTAMP: dt.TIMESTAMP,
           TIMESTAMP_INSTANT: dt.TIMESTAMP}


class Pb:
    """A protobuf wire-format walker."""

    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def varint(self) -> int:
        v, s = 0, 0
        while True:
            if self.i >= len(self.d):
                raise ValueError("orc: truncated protobuf varint")
            b = self.d[self.i]
            self.i += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v
            s += 7

    def fields(self):
        """(field number, wire type, value) until the end: an int for a
        varint, bytes otherwise."""
        while self.i < len(self.d):
            key = self.varint()
            fn, wt = key >> 3, key & 7
            if wt == 0:
                yield fn, wt, self.varint()
            elif wt == 2:
                n = self.varint()
                v = self.d[self.i:self.i + n]
                if len(v) != n:
                    raise ValueError("orc: truncated protobuf field")
                self.i += n
                yield fn, wt, v
            elif wt in (1, 5):
                n = 8 if wt == 1 else 4
                yield fn, wt, self.d[self.i:self.i + n]
                self.i += n
            else:
                raise ValueError(f"orc: protobuf wire type {wt}")


def _packed(wt: int, v) -> List[int]:
    if wt == 0:
        return [v]
    p = Pb(v)
    out = []
    while p.i < len(v):
        out.append(p.varint())
    return out


def deframe(data: bytes, kind: int, block: int, what: str) -> np.ndarray:
    """A stream's bytes with ORC's compression framing removed."""
    src = np.frombuffer(data, np.uint8)
    if kind == 0:
        return src
    # the bound: each compressed chunk inflates to at most a block
    cap, i = 0, 0
    while i + 3 <= len(data):
        hdr = data[i] | data[i + 1] << 8 | data[i + 2] << 16
        clen = hdr >> 1
        cap += clen if hdr & 1 else block
        i += 3 + clen
    out = np.empty(max(cap, 1), np.uint8)
    got = HL.lib().orc_deframe(HL.ptr(src), len(src), kind, HL.ptr(out),
                               len(out))
    if got == -4:
        raise HL.CodecMissing(f"{what}: the {COMPRESSION[kind]} codec is "
                              f"not in this build (codecs {HL.codecs()})")
    if got < 0:
        raise ValueError(f"{what}: corrupt {COMPRESSION[kind]} stream "
                         f"(code {got})")
    return out[:got]


class OrcMeta:
    """A file's postscript and footer: compression, stripes (offset,
    index length, data length, footer length, rows) and types (kind,
    subtypes, field names, precision, scale)."""

    def __init__(self, fh, path: str):
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        if size < 4:
            raise ValueError(f"orc file {path}: {size} bytes")
        tail_len = min(size, 1 << 14)
        fh.seek(size - tail_len)
        tail = fh.read(tail_len)
        ps_len = tail[-1]
        if ps_len + 1 > len(tail):
            raise ValueError(f"orc file {path}: a postscript of {ps_len} "
                             "bytes past the file")
        ps = Pb(tail[-1 - ps_len:-1])
        self.footer_len = self.compression = 0
        self.block = 256 * 1024
        magic = b""
        for fn, _, v in ps.fields():
            if fn == 1:
                self.footer_len = v
            elif fn == 2:
                self.compression = v
            elif fn == 3:
                self.block = v
            elif fn == 8000:
                magic = bytes(v)
        if magic != b"ORC":
            raise ValueError(f"orc file {path}: no ORC postscript")
        if self.compression not in COMPRESSION:
            raise HL.CodecMissing(
                f"orc file {path}: compression kind {self.compression} is "
                "not read by this port")
        need = 1 + ps_len + self.footer_len
        if need > len(tail):
            if need > size:
                raise ValueError(f"orc file {path}: a footer past the file")
            fh.seek(size - need)
            tail = fh.read(need)
        raw = tail[len(tail) - 1 - ps_len - self.footer_len:
                   len(tail) - 1 - ps_len]
        footer = deframe(raw, self.compression, self.block,
                         f"orc file {path} footer").tobytes()
        self.stripes: List[Tuple[int, int, int, int, int]] = []
        self.types: List[Tuple] = []
        self.num_rows = 0
        for fn, wt, v in Pb(footer).fields():
            if fn == 3:
                s = dict.fromkeys(range(1, 6), 0)
                for sfn, _, sv in Pb(v).fields():
                    if sfn in s:
                        s[sfn] = sv
                self.stripes.append(tuple(s[k] for k in range(1, 6)))
            elif fn == 4:
                kind, subs, names, precision, scale = 0, [], [], 0, 0
                for sfn, swt, sv in Pb(v).fields():
                    if sfn == 1:
                        kind = sv
                    elif sfn == 2:
                        subs += _packed(swt, sv)
                    elif sfn == 3:
                        names.append(bytes(sv).decode("utf-8"))
                    elif sfn == 5:
                        precision = sv
                    elif sfn == 6:
                        scale = sv
                self.types.append((kind, subs, names, precision, scale))
            elif fn == 6:
                self.num_rows = v
        if not self.types or self.types[0][0] != STRUCT:
            raise ValueError(f"orc file {path}: the root type is not a "
                             "struct")

    def columns(self) -> List["OrcColumn"]:
        """The top-level columns."""
        _, subs, names = self.types[0][:3]
        out = []
        for name, ci in zip(names, subs):
            kind, _, _, precision, scale = self.types[ci]
            t = _SIMPLE.get(kind)
            why = None
            if kind == DECIMAL:
                if 0 < precision <= dt.DecimalType.MAX_PRECISION:
                    t = dt.DecimalType(precision, scale)
                else:
                    why = f"DECIMAL precision {precision} is outside 1..38"
            elif t is None:
                kn = KIND_NAMES[kind] if kind < len(KIND_NAMES) else kind
                why = (f"nested {kn} columns are not read by this port "
                       "(ROADMAP A7.4)" if kind in (LIST, MAP, STRUCT,
                                                     UNION)
                       else f"{kn} columns are not read by this port")
            out.append(OrcColumn(name, ci, t, why))
        return out


class OrcColumn(NamedTuple):
    """A top-level column: its name, column id and dtype, or None and
    why the port does not read it (the shape ``scan._conform`` takes)."""
    name: str
    index: int
    dtype: Optional[dt.DType]
    why: Optional[str]

    def require(self) -> None:
        if self.dtype is None:
            raise NotImplementedError(f"orc column {self.name!r}: "
                                      f"{self.why}")


#: parsed footers by (path, size, mtime)
_METAS: Dict[tuple, OrcMeta] = {}
_METAS_LOCK = threading.Lock()


def meta_of(fh, path: str) -> OrcMeta:
    st = os.fstat(fh.fileno())
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    got = _METAS.get(key)
    if got is None:
        got = OrcMeta(fh, path)
        with _METAS_LOCK:
            if len(_METAS) >= 1 << 14:
                _METAS.clear()
            _METAS[key] = got
    return got


def file_schema(path: str) -> List:
    """[(name, DType)] of a file's top-level columns; a column the port
    does not read raises NotImplementedError naming it."""
    with open(path, "rb") as fh:
        cols = meta_of(fh, path).columns()
    for c in cols:
        c.require()
    return [(c.name, c.dtype) for c in cols]


def _ints(raw: np.ndarray, n: int, version: int, signed: bool,
          what: str) -> np.ndarray:
    out = np.empty(max(n, 1), np.int64)
    got = HL.lib().orc_int_rle(HL.ptr(raw), len(raw), version, int(signed),
                               HL.ptr(out), n)
    if got != n:
        raise ValueError(f"{what}: decoded {got} of {n} integers")
    return out[:n]


def _bools(raw: np.ndarray, n: int, what: str) -> np.ndarray:
    out = np.empty(max(n, 1), np.uint8)
    got = HL.lib().orc_bool_rle(HL.ptr(raw), len(raw), HL.ptr(out), n)
    if got != n:
        raise ValueError(f"{what}: decoded {got} of {n} booleans")
    return out[:n].view(np.bool_)


def _spread(values: np.ndarray, valid: np.ndarray, dtype) -> np.ndarray:
    if valid.all():
        return values.astype(dtype, copy=False)
    full = np.zeros(len(valid), dtype)
    full[valid] = values
    return full


class _Stripe:
    """One stripe's streams, read with one read of the stripe."""

    def __init__(self, fh, meta: OrcMeta, stripe, path: str,
                 stats) -> None:
        off, ilen, dlen, flen, rows = stripe
        fh.seek(off)
        body = fh.read(ilen + dlen + flen)
        if len(body) != ilen + dlen + flen:
            raise EOFError(f"orc stripe at {off}: {len(body)} of "
                           f"{ilen + dlen + flen} bytes")
        self.meta, self.path, self.rows = meta, path, rows
        footer = deframe(body[ilen + dlen:], meta.compression, meta.block,
                         "orc stripe footer").tobytes()
        self.streams: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.encodings: List[Tuple[int, int]] = []
        self.zone = ""
        pos = 0
        for fn, _, v in Pb(footer).fields():
            if fn == 1:
                kind = col = length = 0
                for sfn, _, sv in Pb(v).fields():
                    if sfn == 1:
                        kind = sv
                    elif sfn == 2:
                        col = sv
                    elif sfn == 3:
                        length = sv
                self.streams[(kind, col)] = (pos, length)
                pos += length
            elif fn == 2:
                ek = size = 0
                for sfn, _, sv in Pb(v).fields():
                    if sfn == 1:
                        ek = sv
                    elif sfn == 2:
                        size = sv
                self.encodings.append((ek, size))
            elif fn == 3:
                self.zone = bytes(v).decode("utf-8")
        self.body = body
        stats.bytes_read += len(body)

    def stream(self, kind: int, col: int, what: str) -> Optional[np.ndarray]:
        at = self.streams.get((kind, col))
        if at is None:
            return None
        pos, length = at
        return deframe(self.body[pos:pos + length], self.meta.compression,
                       self.meta.block, what)

    def column(self, ci: int, name: str, t: dt.DType, kind: int):
        """(host lane, mask) of column ``ci``."""
        rows = self.rows
        what = f"orc column {name!r}"
        enc, dict_size = self.encodings[ci] if ci < len(self.encodings) \
            else (DIRECT, 0)
        version = 2 if enc in (DIRECT_V2, DICTIONARY_V2) else 1
        present = self.stream(PRESENT, ci, what)
        valid = _bools(present, rows, what) if present is not None \
            else np.ones(rows, bool)
        nn = int(valid.sum())
        data = self.stream(DATA, ci, what)
        if data is None:
            data = np.zeros(0, np.uint8)
        if kind in (SHORT, INT, LONG, DATE):
            vals = _spread(_ints(data, nn, version, True, what), valid,
                           t.np_physical)
        elif kind == BYTE:
            out = np.empty(max(nn, 1), np.uint8)
            got = HL.lib().orc_byte_rle(HL.ptr(data), len(data),
                                        HL.ptr(out), nn)
            if got != nn:
                raise ValueError(f"{what}: decoded {got} of {nn} bytes")
            vals = _spread(out[:nn].view(np.int8), valid, np.int8)
        elif kind == BOOLEAN:
            vals = _spread(_bools(data, nn, what), valid, np.bool_)
        elif kind in (FLOAT, DOUBLE):
            np_t = np.float32 if kind == FLOAT else np.float64
            width = np.dtype(np_t).itemsize
            if len(data) < nn * width:
                raise ValueError(f"{what}: {len(data)} bytes for {nn} "
                                 "floats")
            vals = _spread(data[:nn * width].view(np_t), valid, np_t)
        elif kind in (STRING, VARCHAR, CHAR):
            vals = self._strings(ci, data, valid, nn, enc, dict_size,
                                 version, what)
        elif kind in (TIMESTAMP, TIMESTAMP_INSTANT):
            if kind == TIMESTAMP and self.zone not in _UTC:
                raise NotImplementedError(
                    f"{what}: timestamps written in time zone "
                    f"{self.zone!r} (the port reads UTC stripes)")
            secs = _ints(data, nn, version, True, what) + EPOCH_2015
            sec = self.stream(SECONDARY, ci, what)
            raw = _ints(sec if sec is not None else np.zeros(0, np.uint8),
                        nn, version, False, what)
            zeros = raw & 7
            nanos = (raw >> 3) * np.where(zeros > 0, 10 ** (zeros + 1), 1)
            # the ORC C++ reader's rule for a negative second
            secs = secs - ((secs < 0) & (nanos > 999_999))
            vals = _spread(secs * 1_000_000 + nanos // 1000, valid, np.int64)
        elif kind == DECIMAL:
            vals = self._decimals(ci, data, valid, nn, version, t, what)
        else:
            raise NotImplementedError(f"{what}: kind {KIND_NAMES[kind]}")
        return vals, valid

    def _strings(self, ci, data, valid, nn, enc, dict_size, version, what):
        lengths = self.stream(LENGTH, ci, what)
        if lengths is None:
            lengths = np.zeros(0, np.uint8)
        rows = self.rows
        if enc in (DICTIONARY, DICTIONARY_V2):
            dlens = _ints(lengths, dict_size, version, False, what)
            blob = self.stream(DICTIONARY_DATA, ci, what)
            blob = blob if blob is not None else np.zeros(0, np.uint8)
            doffs = np.zeros(dict_size + 1, np.int64)
            np.cumsum(dlens, out=doffs[1:])
            if doffs[-1] > len(blob):
                raise ValueError(f"{what}: a dictionary of {doffs[-1]} "
                                 f"bytes in {len(blob)}")
            idx = _ints(data, nn, version, False, what)
            if nn and (idx.min() < 0 or idx.max() >= dict_size):
                raise ValueError(f"{what}: a dictionary index out of range")
            words = HostStrings(doffs.astype(np.int32), blob)
            full = np.zeros(rows, np.int64)
            full[valid] = idx
            out = words.take(full) if dict_size else \
                HostStrings(np.zeros(rows + 1, np.int32),
                            np.zeros(0, np.uint8))
            if not valid.all():
                lens = np.where(valid, out.lengths(), 0)
                keep = np.repeat(valid, out.lengths())
                offs = np.zeros(rows + 1, np.int64)
                np.cumsum(lens, out=offs[1:])
                out = HostStrings(offs.astype(np.int32),
                                  out.chars[out.offsets[0]:][keep])
            return out
        if enc not in (DIRECT, DIRECT_V2):
            raise NotImplementedError(f"{what}: encoding {enc}")
        lens = _spread(_ints(lengths, nn, version, False, what), valid,
                       np.int64)
        offs = np.zeros(rows + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        if offs[-1] > len(data):
            raise ValueError(f"{what}: {offs[-1]} string bytes in "
                             f"{len(data)}")
        if offs[-1] >= 1 << 31:
            raise ValueError(f"{what}: more than 2 GiB of strings in one "
                             "stripe")
        return HostStrings(offs.astype(np.int32), data[:offs[-1]])

    def _decimals(self, ci, data, valid, nn, version, t, what):
        hi = np.empty(max(nn, 1), np.int64)
        lo = np.empty(max(nn, 1), np.int64)
        got = HL.lib().orc_decimal(HL.ptr(data), len(data), HL.ptr(hi),
                                   HL.ptr(lo), nn)
        if got != nn:
            raise ValueError(f"{what}: decoded {got} of {nn} decimals")
        hi, lo = hi[:nn], lo[:nn]
        sec = self.stream(SECONDARY, ci, what)
        scales = _ints(sec if sec is not None else np.zeros(0, np.uint8),
                       nn, version, True, what)
        exact = bool(np.all(scales == t.scale))
        if t.is_wide or not exact or \
                not np.array_equal(hi, lo >> 63):
            ints = ints_of_limbs(hi, lo) if nn else np.zeros(0, object)
            if not exact:
                ints = np.array([v * 10 ** (t.scale - s) if s <= t.scale
                                 else _half_up(v, s - t.scale)
                                 for v, s in zip(ints, scales)], object)
            if t.is_wide:
                full = np.zeros(len(valid), object)
                full[valid] = ints
                return full
            lo = np.array([int(v) for v in ints], np.int64)
        return _spread(lo, valid, np.int64)


def _half_up(v: int, drop: int) -> int:
    q, r = divmod(abs(v), 10 ** drop)
    q += 2 * r >= 10 ** drop
    return q if v >= 0 else -q


def iter_stripe_tables(path: str, schema, options: dict, max_rows: int,
                       partition_values: Optional[dict],
                       stats=None) -> Iterator[HostTable]:
    """Host tables of at most ``max_rows`` rows, stripe by stripe, in the
    declared ``schema`` (by name, or by position where the names
    differ; partition columns as constants), as the Parquet lane."""
    from .native_parquet import ReadStats, _cast_lane, _empty, split_rows
    from .scan import _apply_read_rebase, _conform, partition_column
    part_values = partition_values or {}
    stats = stats if stats is not None else ReadStats()
    with open(path, "rb") as fh:
        meta = meta_of(fh, path)
        plan = _conform(meta.columns(), schema, set(part_values))
        if not meta.stripes:
            yield _empty(schema)
            return
        for stripe in meta.stripes:
            t0 = time.perf_counter_ns()
            st = _Stripe(fh, meta, stripe, path, stats)
            rows = st.rows
            out = []
            for name, want, col in plan:
                if col is None:
                    out.append(partition_column(part_values.get(name), want,
                                                rows))
                    continue
                values, mask = st.column(col.index, col.name, col.dtype,
                                         meta.types[col.index][0])
                values = _cast_lane(values, mask, col.dtype, want, name)
                out.append(HostColumn(values, mask, want))
                stats.decoded_bytes += len(mask) + (
                    values.nbytes if isinstance(values, np.ndarray)
                    else values.offsets.nbytes + len(values.chars))
            stats.decode_ns += time.perf_counter_ns() - t0
            ht = HostTable(out, [n for n, _ in schema])
            _apply_read_rebase(ht, options)
            yield from split_rows(ht, max_rows)
