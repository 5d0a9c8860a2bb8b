"""Bloom filter for runtime join filtering.

Counterpart of spark_rapids_tpu/ops/bloom.py: a filter over the
materialized build side of an inner hash join drops probe rows whose
keys cannot match before the gather-map join runs. Same double-hashing
scheme (k probe positions h1 + i*h2 over two murmur3 chains) and the
same bool[num_bits] layout, so both packages set the same bits. Hash
lanes are 32-bit values carried in int64 (expr/hashing.py); positions
are taken modulo the power-of-two size by a mask, which equals the JAX
package's wrapping uint32 arithmetic.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.vector import Column
from ..expr import hashing as H

DEFAULT_BITS_PER_KEY = 10
NUM_HASHES = 6
MIN_BITS = 1 << 10
MAX_BITS = 1 << 24


def choose_num_bits(num_keys: int,
                    bits_per_key: int = DEFAULT_BITS_PER_KEY) -> int:
    n = max(num_keys, 1) * bits_per_key
    bits = 1
    while bits < n:
        bits <<= 1
    return min(max(bits, MIN_BITS), MAX_BITS)


def _double_hash(key_cols: Sequence[Column]):
    """(h1, h2) 32-bit hash pair per row; h2 forced odd so the probe
    sequence cycles through distinct positions."""
    h1 = 0x9E3779B9
    h2 = 0x85EBCA6B
    for c in key_cols:
        h1 = H.murmur3_column(c, h1)
        h2 = H.murmur3_column(c, h2)
    return h1, h2 | 1


def _any_null(key_cols: Sequence[Column]) -> torch.Tensor:
    valid = key_cols[0].validity
    for c in key_cols[1:]:
        valid = valid & c.validity
    return ~valid


def _positions(key_cols: Sequence[Column], num_bits: int):
    h1, h2 = _double_hash(key_cols)
    mask = num_bits - 1  # num_bits is a power of two
    return [(h1 + i * h2) & mask for i in range(NUM_HASHES)]


def build_bloom(key_cols: Sequence[Column], live: torch.Tensor,
                num_bits: int) -> torch.Tensor:
    """bool[num_bits] filter over the live non-null key rows."""
    ok = live & ~_any_null(key_cols)
    # one slot past the end takes the excluded rows' writes
    bits = torch.zeros(num_bits + 1, dtype=torch.bool, device=live.device)
    for pos in _positions(key_cols, num_bits):
        bits[torch.where(ok, pos, num_bits)] = True
    return bits[:num_bits]


def might_contain(bits: torch.Tensor, key_cols: Sequence[Column]
                  ) -> torch.Tensor:
    """bool[cap]: True = possibly present. Null keys give False (they
    cannot match an inner join)."""
    hit = ~_any_null(key_cols)
    for pos in _positions(key_cols, bits.shape[0]):
        hit = hit & bits[pos]
    return hit
