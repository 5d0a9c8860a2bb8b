"""Spark-bit-exact Murmur3 (Murmur3_x86_32) and XXH64 over device
columns.

Counterpart of spark_rapids_tpu/expr/hashing.py (murmur3_column,
_murmur3_string, murmur3_row_hash, ``Murmur3Hash`` — SQL ``hash`` —,
xxhash64_column and ``XxHash64``). Matching Spark bit for bit matters
because hashes decide partitioning: equal keys must land alike in every
engine.

torch has no usable uint32 arithmetic on CUDA (no unsigned multiply, no
logical shift), so a 32-bit hash lane is carried in int64 holding a
value in [0, 2^32). Every multiply by a 32-bit constant is split into
16-bit halves so that no intermediate leaves int64 (``mul32``), every
rotate and shift masks back to 32 bits, and a 64-bit column value is
hashed as its two 32-bit words taken with an arithmetic shift followed
by a mask (a logical shift). Null rows leave the running hash unchanged
(Spark semantics); the default seed is 42.

XXH64 runs in int64 lanes whose multiplies and adds wrap modulo 2^64,
which is uint64 arithmetic on the same bits; a logical right shift is an
arithmetic one masked to the low bits. It takes what the JAX package's
takes: booleans, integers, dates, timestamps and floats (strings raise,
as there). A long-backed decimal hashes as its unscaled long (Spark's
``hashLong`` of ``toUnscaledLong``) in both; a DECIMAL(p>18) hashes its
BigDecimal's bytes in Spark; the planner tags it off the device (as the
JAX planner does) and the port's CPU engine refuses it (not in this
port yet).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import Column, ColumnVector, ColumnarBatch, StringColumn
from .core import Expression, Schema, make_result

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593

Seed = Union[int, torch.Tensor]


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c,
    exact in int64: both partial products stay below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return mul32(_rotl32(mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl32(h1 ^ k1, 13)
    return (mul32(h1, 5) + 0xE6546B64) & M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _hash_int32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def _hash_int64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``v`` int64 holding the 64 bits; hashed low word first."""
    lo = v & M32
    hi = (v >> 32) & M32  # arithmetic shift + mask = logical shift
    h1 = _mix_h1(seed, _mix_k1(lo))
    h1 = _mix_h1(h1, _mix_k1(hi))
    return _fmix(h1, 8)


def _normalize_float(data: torch.Tensor) -> torch.Tensor:
    """Spark: -0.0 hashes as 0.0, every NaN as the canonical NaN."""
    data = torch.where(data == 0.0, torch.zeros((), dtype=data.dtype,
                                                device=data.device), data)
    return torch.where(torch.isnan(data), torch.full(
        (), float("nan"), dtype=data.dtype, device=data.device), data)


def _seed_lane(seed: Seed, cap: int, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64)
    return torch.full((cap,), int(seed) & M32, dtype=torch.int64,
                      device=device)


def _no_wide(col: Column) -> None:
    if dt.is_wide_decimal(col.dtype):
        from .core import cpu_fallback
        raise cpu_fallback(f"a hash of {col.dtype}",
                           "type signature of hash / xxhash64")


def murmur3_column(col: Column, seed: Seed) -> torch.Tensor:
    """Per-row Murmur3 of one column as int64 in [0, 2^32); null rows
    return the seed unchanged. ``seed`` is an int or a per-row lane."""
    h0 = _seed_lane(seed, col.capacity, col.device)
    _no_wide(col)
    if isinstance(col, StringColumn):
        h = _murmur3_string(col, h0)
    else:
        d, t = col.data, col.dtype
        if dt.is_decimal(t):
            t = dt.INT64
        if t == dt.BOOL:
            h = _hash_int32(d.to(torch.int64), h0)
        elif t in (dt.INT8, dt.INT16, dt.INT32, dt.DATE):
            # sign-extend, then wrap to 32 bits
            h = _hash_int32(d.to(torch.int64) & M32, h0)
        elif t in (dt.INT64, dt.TIMESTAMP):
            h = _hash_int64(d, h0)
        elif t == dt.FLOAT32:
            bits = _normalize_float(d).view(torch.int32).to(torch.int64)
            h = _hash_int32(bits & M32, h0)
        elif t == dt.FLOAT64:
            h = _hash_int64(_normalize_float(d).view(torch.int64), h0)
        else:
            raise TypeError(f"murmur3 unsupported for {t}")
    return torch.where(col.validity, h, h0)


def _murmur3_string(col: StringColumn, h1: torch.Tensor) -> torch.Tensor:
    """Spark's string Murmur3 straight over the Arrow offsets/chars: one
    pass per 4-byte block up to the longest string, each row mixing the
    blocks it has, then its <= 3 tail bytes one at a time, sign-extended
    (Spark's hashUnsafeBytes), then fmix with the byte length."""
    starts = col.offsets[:-1].to(torch.int64)
    lens = col.lengths().to(torch.int64)
    last = max(col.char_capacity - 1, 0)
    chars = col.chars.to(torch.int64)
    if col.char_capacity == 0:
        chars = torch.zeros(1, dtype=torch.int64, device=col.device)
    max_len = int(lens.max()) if lens.numel() else 0

    def byte_at(pos):
        return chars[pos.clamp(0, last)]

    for b in range(max_len // 4):
        base = starts + 4 * b
        word = (byte_at(base) | (byte_at(base + 1) << 8)
                | (byte_at(base + 2) << 16) | (byte_at(base + 3) << 24))
        h1 = torch.where(lens >= 4 * (b + 1), _mix_h1(h1, _mix_k1(word)),
                         h1)
    tail_start = (lens // 4) * 4
    for j in range(min(3, max_len)):
        byte = byte_at(starts + tail_start + j)
        byte = torch.where(byte >= 128, byte - 256, byte) & M32
        h1 = torch.where(tail_start + j < lens, _mix_h1(h1, _mix_k1(byte)),
                         h1)
    return _fmix(h1, lens & M32)


def to_int32(h: torch.Tensor) -> torch.Tensor:
    """A [0, 2^32) int64 hash lane as int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def murmur3_row_hash(cols: Sequence[Column], seed: int = 42
                     ) -> torch.Tensor:
    """Chained multi-column row hash (each column seeds the next), as
    Spark's int32."""
    if not cols:
        raise ValueError("need at least one column")
    h: Seed = seed
    for c in cols:
        h = murmur3_column(c, h)
    return to_int32(h)


class Murmur3Hash(Expression):
    """hash(...): Spark's Murmur3 row hash, int32, never null."""

    def __init__(self, *children: Expression, seed: int = 42):
        super().__init__(*children)
        self.seed = seed

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        cols = [c.eval(batch) for c in self.children]
        return make_result(murmur3_row_hash(cols, self.seed),
                           batch.live_mask(), dt.INT32)


# ---------------------------------------------------------------------------
# xxhash64 (Spark's XxHash64)
# ---------------------------------------------------------------------------

def _s64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr64(h, 33)
    h = h * _P2
    h = h ^ _shr64(h, 29)
    h = h * _P3
    return h ^ _shr64(h, 32)


def _xx_hash_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h = seed + _P5 + 8
    h = h ^ (_rotl64(v * _P2, 31) * _P1)
    return _xx_fmix(_rotl64(h, 27) * _P1 + _P4)


def _xx_hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark's XxHash64.hashInt: the 4-byte tail path; ``v`` in
    [0, 2^32)."""
    h = seed + _P5 + 4
    h = h ^ (v * _P1)
    return _xx_fmix(_rotl64(h, 23) * _P2 + _P3)


def xxhash64_column(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-row XXH64 of one column, int64 bits; null rows keep the
    seed."""
    if isinstance(col, StringColumn):
        raise TypeError("xxhash64 of a string is not in this port")
    _no_wide(col)
    d, t = col.data, col.dtype
    if dt.is_decimal(t):
        t = dt.INT64
    if t == dt.BOOL:
        h = _xx_hash_int(d.to(torch.int64), seed)
    elif t in (dt.INT8, dt.INT16, dt.INT32, dt.DATE):
        h = _xx_hash_int(d.to(torch.int64) & M32, seed)
    elif t in (dt.INT64, dt.TIMESTAMP):
        h = _xx_hash_long(d, seed)
    elif t == dt.FLOAT32:
        bits = _normalize_float(d).view(torch.int32).to(torch.int64)
        h = _xx_hash_int(bits & M32, seed)
    elif t == dt.FLOAT64:
        h = _xx_hash_long(_normalize_float(d).view(torch.int64), seed)
    else:
        raise TypeError(f"xxhash64 unsupported for {t}")
    return torch.where(col.validity, h, seed)


class XxHash64(Expression):
    """xxhash64(...): bigint, never null; each column seeds the next."""

    def __init__(self, *children: Expression, seed: int = 42):
        super().__init__(*children)
        self.seed = seed

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        h = torch.full((batch.capacity,), self.seed, dtype=torch.int64,
                       device=batch.device)
        for c in self.children:
            h = xxhash64_column(c.eval(batch), h)
        return make_result(h, batch.live_mask(), dt.INT64)
