"""Batch kernels: the tensor cores of the physical operators.

Counterpart of spark_rapids_tpu/ops/kernels.py, ported as deep as TPC-H
q6/q1/q3 need: filter compaction, hash bucketing, multi-key stable sort,
hash-claim and sort-based grouping with the grouped update / merge
passes, the gather-map hash join (inner, left outer, semi and anti),
limit, slice and concat. Everything is eager torch code over
ColumnarBatch; the grouped update hands its per-bucket sums to the
hand-written kernel ``device_kernels.tile_group_reduce``.

Group ids are an internal numbering (the claim order of the hash-claim
prelude, or the rank of the key in sort order); state tables are sized
``choose_capacity(num_groups + 1)`` so the slot just past the live
groups takes the dead rows.

64-bit hashes live in int64 with the bits of the JAX package's uint64:
``(h1 << 32) | h2`` is formed as ``signed(h1) * 2^32 + h2``, which never
overflows. Where the JAX package orders or min-reduces them as unsigned,
the sign bit is flipped first, and a logical right shift is an
arithmetic one followed by a mask.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar import decimal128 as d128
from ..columnar.decimal128 import Decimal128Column
from ..columnar.nested import (ListColumn, StructColumn, concat_lists,
                               concat_structs)
from ..columnar.vector import (Column, ColumnVector, ColumnarBatch,
                               StringColumn, choose_capacity,
                               compaction_indices, live_mask, round_pow2,
                               rows_from_offsets)
from ..expr import hashing as H
from ..expr import strings as S
from . import device_kernels as DK

# ---------------------------------------------------------------------------
# Filter
# ---------------------------------------------------------------------------


def compact(batch: ColumnarBatch, keep: torch.Tensor,
            out_capacity: Optional[int] = None) -> ColumnarBatch:
    """Keep rows where ``keep`` (restricted to live rows), in order, in a
    batch of ``out_capacity`` (default: the input's capacity)."""
    idx, n = compaction_indices(keep & batch.live_mask(), out_capacity)
    return batch.gather(idx, n)


def bucket_ids(key_cols: Sequence[Column], num_parts: int) -> torch.Tensor:
    """Key-hash bucket in [0, num_parts) per row: the murmur3 chain with
    seed 7 that sub-partition joins bucket both sides with, so equal
    keys always co-locate (seed 42 is the shuffle partitioner's)."""
    h = 7
    for c in key_cols:
        h = H.murmur3_column(c, h)
    return h % num_parts


def bucket_compact(batch: ColumnarBatch, ids: torch.Tensor, p: int
                   ) -> Optional[ColumnarBatch]:
    """Rows whose bucket id (from :func:`bucket_ids`) equals ``p``,
    compacted to their tight capacity; None when the bucket is empty."""
    keep = (ids == p) & batch.live_mask()
    n = int(keep.sum())
    if n == 0:
        return None
    return compact(batch, keep, choose_capacity(n))


def filter_batch(batch: ColumnarBatch, cond: ColumnVector) -> ColumnarBatch:
    """SQL WHERE: keep rows where the predicate is true and not null."""
    return compact(batch, cond.data & cond.validity)


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------


def _rank_keys(col: Column) -> List[torch.Tensor]:
    """Lower a column to sort-key tensors whose ascending order is SQL
    value order (most significant first). Strings become big-endian
    8-byte words of the padded view, biased so that signed int64 order
    is unsigned byte order, then their byte length, so that a string
    sorts after its prefix even where the rest is zero bytes (Spark's
    order, and string ``<``'s, expr/strings.py ``string_compare``);
    floats fold -0.0 into 0.0; a wide decimal gives two words, its hi
    limb and its lo limb read as unsigned (decimal128.order_words)."""
    if isinstance(col, Decimal128Column):
        return list(d128.order_words(col.hi, col.lo))
    if isinstance(col, StringColumn):
        padded = col.padded().to(torch.int64)
        cap, w = padded.shape
        words = []
        for b0 in range(0, w, 8):
            chunk = padded[:, b0:b0 + 8]
            if chunk.shape[1] < 8:
                chunk = torch.nn.functional.pad(chunk,
                                                (0, 8 - chunk.shape[1]))
            word = (chunk[:, 0] - 128) * (1 << 56)
            for k in range(1, 8):
                word = word + chunk[:, k] * (1 << (8 * (7 - k)))
            words.append(word)
        words.append(col.lengths().to(torch.int64))
        return words
    d = col.data
    if d.is_floating_point():
        return [torch.where(d == 0.0, torch.zeros((), dtype=d.dtype,
                                                  device=d.device), d)]
    if d.dtype == torch.bool:
        return [d.to(torch.int8)]
    return [d]


def _stable_argsort(key: torch.Tensor, descending: bool = False):
    return torch.sort(key, stable=True, descending=descending).indices


def sort_indices(columns: Sequence[Column], ascending: Sequence[bool],
                 nulls_first: Sequence[bool], live) -> torch.Tensor:
    """Stable multi-key sort permutation; dead rows sort last. A chain of
    stable sorts from the least to the most significant key."""
    perm = torch.arange(live.shape[0], device=live.device)
    for col, asc, nf in reversed(list(zip(columns, ascending,
                                          nulls_first))):
        for key in reversed(_rank_keys(col)):
            perm = perm[_stable_argsort(key[perm], descending=not asc)]
        valid = col.validity[perm]
        # ascending sort puts 0 first: map the class that goes first to 0
        null_key = valid if nf else ~valid
        perm = perm[_stable_argsort(null_key.to(torch.int8))]
    dead = ~live[perm]
    return perm[_stable_argsort(dead.to(torch.int8))]


def sort_batch(batch: ColumnarBatch, key_cols: Sequence[Column],
               ascending: Sequence[bool],
               nulls_first: Sequence[bool]) -> ColumnarBatch:
    perm = sort_indices(key_cols, ascending, nulls_first, batch.live_mask())
    return batch.gather(perm, batch.num_rows)


#: a float's order word for NaN: above +inf's, as sort_indices places NaN
_NAN_WORD = 0x7FF8000000000000


def _string_widths(a_cols: Sequence[Column], b_cols: Sequence[Column]):
    """One padded width per string key for both sides of a comparison,
    so that their words line up."""
    return [max(a.pad_bucket, b.pad_bucket)
            if isinstance(a, StringColumn) else 0
            for a, b in zip(a_cols, b_cols)]


def _order_words(cols: Sequence[Column], widths: Sequence[int],
                 ascending: Sequence[bool], nulls_first: Sequence[bool],
                 n: int) -> List[torch.Tensor]:
    """int64 words of the first ``n`` rows whose lexicographic order is
    ``sort_indices``'s order of the rows: per key a null-class word and
    its value words, nulls placed by ``nulls_first``, NaN above every
    number, -0.0 equal to 0.0, a descending key's words inverted."""
    words = []
    for col, w, asc, nf in zip(cols, widths, ascending, nulls_first):
        if isinstance(col, StringColumn):
            col = StringColumn(col.offsets, col.chars, col.validity, w)
        valid = col.validity[:n]
        words.append((valid if nf else ~valid).to(torch.int64))
        for key in _rank_keys(col):
            key = key[:n]
            if key.is_floating_point():
                bits = key.to(torch.float64).view(torch.int64)
                # negative floats: flip the magnitude bits, so that
                # signed int64 order is the floats' order
                bits = torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF,
                                   bits)
                key = torch.where(torch.isnan(key), _NAN_WORD, bits)
            else:
                key = key.to(torch.int64)
            if not asc:
                key = ~key
            words.append(torch.where(valid, key, 0))
    return words


def _compare_words(a: Sequence[torch.Tensor],
                   b: Sequence[torch.Tensor]) -> torch.Tensor:
    """-1 / 0 / 1 per row: row i of ``a`` orders before / ties with /
    after row i of ``b`` (``_order_words``; a side of one row
    broadcasts)."""
    cmp = None
    for x, y in zip(a, b):
        step = (x > y).to(torch.int8) - (x < y).to(torch.int8)
        cmp = step if cmp is None else torch.where(cmp == 0, step, cmp)
    return cmp


def rows_not_after(key_cols: Sequence[Column], bound_cols: Sequence[Column],
                   ascending: Sequence[bool], nulls_first: Sequence[bool],
                   live: torch.Tensor) -> int:
    """Live rows that order at or before the first row of ``bound_cols``
    under ``sort_indices``'s order. Over sorted rows they are a prefix:
    the out-of-core merge's safe prefix."""
    widths = _string_widths(key_cols, bound_cols)
    cmp = _compare_words(
        _order_words(key_cols, widths, ascending, nulls_first,
                     live.shape[0]),
        _order_words(bound_cols, widths, ascending, nulls_first, 1))
    return int(((cmp <= 0) & live).sum())


def _packed_groups(wa: List[torch.Tensor], wb: List[torch.Tensor]):
    """The words of both sides packed, most significant first, into
    int64 keys of at most 63 bits each, offset by each word's least
    value over both sides; a word whose range is wider stays a key of
    its own as it is, and a word with one value on both sides drops out.
    The keys' lexicographic order is the words'. Pairs of (a's key,
    b's key)."""
    lo_hi = torch.stack([torch.stack([torch.minimum(x.min(), y.min()),
                                      torch.maximum(x.max(), y.max())])
                         for x, y in zip(wa, wb)]).tolist()
    groups = []
    pa = pb = None
    used = 0
    for x, y, (lo, hi) in zip(wa, wb, lo_hi):
        bits = (hi - lo).bit_length()
        if bits == 0:
            continue
        if bits > 63 or used + bits > 63:
            if pa is not None:
                groups.append((pa, pb))
            pa = pb = None
            used = 0
        if bits > 63:
            groups.append((x, y))
            continue
        pa = x - lo if pa is None else (pa << bits) | (x - lo)
        pb = y - lo if pb is None else (pb << bits) | (y - lo)
        used += bits
    if pa is not None:
        groups.append((pa, pb))
    return groups


def _bound_in(sorted_a: torch.Tensor, keys: torch.Tensor,
              lo: torch.Tensor, hi: torch.Tensor, width: int,
              right: bool) -> torch.Tensor:
    """Per row, the first index of ``sorted_a`` in [lo, hi) whose value
    is above (``right``) or at least (not ``right``) the row's key; hi
    where none is. ``width`` bounds hi - lo; one vectorised binary
    search step per bit of it."""
    last = sorted_a.shape[0] - 1
    for _ in range(width.bit_length()):
        mid = (lo + hi) // 2
        v = sorted_a[mid.clamp(max=last)]
        up = v <= keys if right else v < keys
        active = lo < hi
        lo, hi = (torch.where(active & up, mid + 1, lo),
                  torch.where(active & ~up, mid, hi))
    return lo


def _rows_not_after_each(wa: List[torch.Tensor], wb: List[torch.Tensor],
                         na: int) -> torch.Tensor:
    """For each row of ``wb``, the rows of sorted ``wa`` (``na`` of them)
    that order at or before it. The words pack into few int64 keys
    (``_packed_groups``): ``searchsorted`` on the first gives each row
    the range of ``a``'s rows equal to it there, and each further key
    narrows that range with a binary search as deep as the widest
    range."""
    groups = _packed_groups(wa, wb)
    if not groups:  # every row ties with every row
        return torch.full((wb[0].shape[0],), na, dtype=torch.int64,
                          device=wb[0].device)
    ga, gb = groups[0]
    hi = torch.searchsorted(ga, gb, right=True)
    if len(groups) == 1:
        return hi
    lo = torch.searchsorted(ga, gb, right=False)
    for k, (ga, gb) in enumerate(groups[1:], 2):
        width = int((hi - lo).max())
        if width == 0:
            break
        upper = _bound_in(ga, gb, lo, hi, width, right=True)
        if k == len(groups):
            return upper
        lo, hi = _bound_in(ga, gb, lo, hi, width, right=False), upper
    return hi


def merge_sorted(a: ColumnarBatch, b: ColumnarBatch,
                 a_keys: Sequence[Column], b_keys: Sequence[Column],
                 ascending: Sequence[bool],
                 nulls_first: Sequence[bool]) -> ColumnarBatch:
    """Two batches whose live rows are sorted under ``sort_indices``'s
    order, merged into one sorted batch; rows that tie leave ``a``'s
    first. It gives what a stable sort of their concatenation gives,
    with one search of ``b``'s rows into ``a``'s and one gather."""
    na, nb = a.num_rows, b.num_rows
    dev = a.device
    cap = choose_capacity(na + nb)
    both = concat_batches([a, b], cap)
    if na == 0 or nb == 0:
        return both
    widths = _string_widths(a_keys, b_keys)
    cnt = _rows_not_after_each(
        _order_words(a_keys, widths, ascending, nulls_first, na),
        _order_words(b_keys, widths, ascending, nulls_first, nb), na)
    ia = torch.arange(na, device=dev)
    ib = torch.arange(nb, device=dev)
    idx = torch.zeros(cap, dtype=torch.int64, device=dev)
    # a's row i has the rows of b that order strictly before it,
    # those with cnt[j] <= i, ahead of it
    idx[ia + torch.searchsorted(cnt, ia, right=True)] = ia
    idx[ib + cnt] = na + ib
    return both.gather(idx, na + nb)


# ---------------------------------------------------------------------------
# Group-by (sort-based)
# ---------------------------------------------------------------------------


def _keys_eq_pairs(col: Column, ia: torch.Tensor,
                   ib: torch.Tensor) -> torch.Tensor:
    """Null-safe key equality of row pairs (ia[k], ib[k]); NaN == NaN
    for grouping."""
    va, vb = col.validity[ia], col.validity[ib]
    if isinstance(col, StringColumn):
        data_eq = S.pairs_equal(col, ia, col, ib)
    elif isinstance(col, Decimal128Column):
        data_eq = (col.hi[ia] == col.hi[ib]) & (col.lo[ia] == col.lo[ib])
    else:
        da, db = col.data[ia], col.data[ib]
        data_eq = da == db
        if da.is_floating_point():
            data_eq = data_eq | (torch.isnan(da) & torch.isnan(db))
    return (va == vb) & (~va | data_eq)


def _adjacent_equal(col: Column) -> torch.Tensor:
    """eq[i] = row i equals row i-1 under grouping equality (null ==
    null, NaN == NaN); eq[0] = False. Strings compare their Arrow bytes
    (``pairs_equal``, in bounded passes), never a padded view."""
    idx = torch.arange(col.capacity, device=col.device)
    eq = _keys_eq_pairs(col, idx, (idx - 1).clamp(min=0))
    if eq.numel():
        eq[0] = False
    return eq


def _group_ids_from_eq(eq_prev: torch.Tensor, live: torch.Tensor
                       ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """(gid, num_groups, boundary) from a rows-equal-previous mask over
    key-sorted rows."""
    boundary = live & ~eq_prev
    boundary[0] = live[0]
    gid = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(min=0)
    return gid, int(boundary.sum()), boundary


def group_ids(sorted_keys: Sequence[Column], live: torch.Tensor
              ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """(gid, num_groups, boundary) for key-sorted rows."""
    cap = live.shape[0]
    if not sorted_keys:
        # global aggregate: one group holding all live rows
        boundary = torch.zeros(cap, dtype=torch.bool, device=live.device)
        if cap:
            boundary[0] = live[0]
        return (torch.zeros(cap, dtype=torch.int64, device=live.device),
                min(int(live.sum()), 1), boundary)
    eq = torch.ones(cap, dtype=torch.bool, device=live.device)
    idx = torch.arange(cap, device=live.device)
    prev = (idx - 1).clamp(min=0)
    for c in sorted_keys:
        eq = eq & _keys_eq_pairs(c, idx, prev)
    return _group_ids_from_eq(eq, live)


def _key_batch(key_cols, key_rows: torch.Tensor, num_groups: int,
               device) -> ColumnarBatch:
    cap = key_rows.shape[0]
    klm = live_mask(cap, num_groups, device)
    key_out = [c.gather(key_rows, klm) for c in key_cols]
    return ColumnarBatch(key_out, [f"k{i}" for i in range(len(key_out))],
                         num_groups, device, capacity=cap)


def _prelude_exact(batch: ColumnarBatch, key_cols: Sequence[Column]):
    """Sort-based grouping: rank-chain sort, adjacent-equality
    boundaries, one key gather per group. Returns (perm, live_s, gid,
    num_groups, key_batch) with rows in sort order; dead rows take the
    scratch gid ``num_groups``."""
    live = batch.live_mask()
    cap = batch.capacity
    perm = sort_indices(key_cols, [True] * len(key_cols),
                        [True] * len(key_cols), live)
    live_s = live[perm]
    prev = torch.cat([perm[:1], perm[:-1]])
    eq = torch.ones(cap, dtype=torch.bool, device=batch.device)
    for c in key_cols:
        eq = eq & _keys_eq_pairs(c, perm, prev)
    eq[0] = False
    gid, num_groups, boundary = _group_ids_from_eq(eq, live_s)
    gid = torch.where(live_s, gid, num_groups)
    out_cap = choose_capacity(num_groups + 1)
    key_rows = torch.zeros(out_cap, dtype=torch.int64, device=batch.device)
    key_rows[:num_groups] = perm[torch.nonzero(boundary).flatten()]
    return perm, live_s, gid, num_groups, \
        _key_batch(key_cols, key_rows, num_groups, batch.device)


def _sorted_group_prelude(batch: ColumnarBatch, key_cols: Sequence[Column]):
    """Sort-path grouping machinery for update and merge passes (see
    _prelude_exact); the global aggregate needs no sort."""
    live = batch.live_mask()
    if not key_cols:
        gid, num_groups, _ = group_ids([], live)
        gid = torch.where(live, gid, num_groups)
        return (torch.arange(batch.capacity, device=batch.device), live,
                gid, num_groups,
                ColumnarBatch([], [], num_groups, batch.device,
                              capacity=choose_capacity(num_groups + 1)))
    return _prelude_exact(batch, key_cols)


# ---------------------------------------------------------------------------
# Group-by (hash-claim)
# ---------------------------------------------------------------------------

# multiplicative mixers for the claim rounds (odd 64-bit constants from
# splitmix64/xxhash); one claim table per round
_CLAIM_MIXERS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                 0x165667B19E3779F9, 0x27D4EB2F165667C5)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _signed64(u: int) -> int:
    """The int64 holding the bits of unsigned 64-bit ``u``."""
    return u - (1 << 64) if u >= (1 << 63) else u


def combine_hash64(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """int64 with the bits of uint64 ``(h1 << 32) | h2`` for 32-bit
    lanes held in int64: ``signed(h1) * 2^32 + h2`` cannot overflow."""
    hi = torch.where(h1 >= (1 << 31), h1 - (1 << 32), h1)
    return hi * (1 << 32) + h2


def _lshr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _prelude_fast(batch: ColumnarBatch, key_cols: Sequence[Column]):
    """Sort-free hash-claim grouping (the JAX package's _prelude_fast).

    Rows claim hash-table slots by scatter-min of a 64-bit key hash (one
    table per round; losers retry under a fresh mixer). Winners of one
    slot share a gid. Exactness is enforced by comparing every row's
    true key against its slot representative: a 64-bit collision or an
    unclaimed row sets ``ok`` False and the caller takes the sort path.
    Rows stay in their original order (perm is the identity).

    The table min-reduces hashes as unsigned 64-bit values: in int64
    the sign bit is flipped first, so signed order is unsigned order
    and the empty-slot sentinel (unsigned all-ones) is int64 max.
    Returns (ok, (perm, live, gid, num_groups, key_batch)).
    """
    live = batch.live_mask()
    cap = batch.capacity
    dev = batch.device
    h1 = 0x3C6EF372
    h2 = 0xA54FF53A
    for c in key_cols:
        h1 = H.murmur3_column(c, h1)
        h2 = H.murmur3_column(c, h2)
        # murmur3 leaves h unchanged on null rows; fold the validity
        # bit in so null patterns hash apart from values
        h1 = torch.where(c.validity, h1, h1 ^ 0x9E3779B9)
        h2 = torch.where(c.validity, h2,
                         (H.mul32(h2, 2654435761) + 1) & H.M32)
    inf = _I64_MAX  # flipped all-ones: the empty-slot sentinel
    key = (combine_hash64(h1, h2) ^ _I64_MIN).clamp(max=inf - 1)
    h = key ^ _I64_MIN  # the hash with all-ones moved off the sentinel
    T = round_pow2(cap)
    log2T = T.bit_length() - 1
    arange = torch.arange(cap, device=dev)
    unresolved = live.clone()
    gid = torch.zeros(cap, dtype=torch.int64, device=dev)
    # one slot past the end takes the writes of unoccupied table slots
    key_rows = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    for r, mix in enumerate(_CLAIM_MIXERS):
        # contested slots are the exception (low-cardinality groupings
        # resolve in round 1): skip further rounds when nothing is left
        if r and not bool(unresolved.any()):
            break
        if log2T:
            slot = _lshr64(h * _signed64(mix), 64 - log2T)
        else:
            slot = torch.zeros(cap, dtype=torch.int64, device=dev)
        tbl = torch.full((T,), inf, dtype=torch.int64, device=dev)
        tbl.scatter_reduce_(0, slot, torch.where(unresolved, key, inf),
                            "amin")
        won = unresolved & (tbl[slot] == key)
        occ = tbl != inf
        slot_gid = offset + torch.cumsum(occ.to(torch.int64), 0) - 1
        rep = torch.full((T,), cap, dtype=torch.int64, device=dev)
        rep.scatter_reduce_(0, slot, torch.where(won, arange, cap), "amin")
        gid = torch.where(won, slot_gid[slot], gid)
        key_rows[torch.where(occ, slot_gid, cap)] = rep
        offset = offset + occ.sum()
        unresolved = unresolved & ~won
    num_groups = int(offset)
    # exactness: every live row's true key equals its representative's
    rep_row = key_rows[gid.clamp(0, max(cap - 1, 0))].clamp(max=cap - 1)
    eq = torch.ones(cap, dtype=torch.bool, device=dev)
    for c in key_cols:
        eq = eq & _keys_eq_pairs(c, arange, rep_row)
    ok = not bool(unresolved.any() | (live & ~eq).any())
    gid = torch.where(live, gid, num_groups)
    out_cap = choose_capacity(num_groups + 1)
    rows = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    rows[:num_groups] = key_rows[:num_groups].clamp(max=cap - 1)
    return ok, (arange, live, gid, num_groups,
                _key_batch(key_cols, rows, num_groups, dev))


def _use_hash_grouping(batch: ColumnarBatch, key_cols, agg_fns) -> bool:
    """Static gate for the hash-claim path: grouping keys, scatter-safe
    aggregates, hashable key types and a batch big enough for the claim
    table to pay for itself."""
    return bool(key_cols) and batch.capacity >= 1024 and \
        all(not getattr(fn, "needs_sorted_groups", False)
            for fn in agg_fns) and \
        all(isinstance(c, (StringColumn, ColumnVector)) for c in key_cols)


def _grouping_prelude(batch: ColumnarBatch, key_cols: Sequence[Column],
                      agg_fns: Sequence, stats: Optional[dict]):
    """(prelude, fast): the hash-claim prelude where the gate admits it
    and it resolves exactly, else the sort path. ``stats`` (optional)
    counts ``claimResolved`` / ``claimFallbacks``."""
    if _use_hash_grouping(batch, key_cols, agg_fns):
        ok, fast = _prelude_fast(batch, key_cols)
        if stats is not None:
            name = "claimResolved" if ok else "claimFallbacks"
            stats[name] = stats.get(name, 0) + 1
        if ok:
            return fast, True
        return _prelude_exact(batch, key_cols), False
    return _sorted_group_prelude(batch, key_cols), False


def _in_group_order(prelude, fast: bool):
    """The prelude with its rows in group order, as the aggregates take
    them (their float sums add each group's rows in row order,
    expr/aggregates.py _ordered_seg_sum). The sort path's rows already
    are; the hash-claim path leaves rows in place, so its gids are
    sorted here, stably, so that each group keeps its row order."""
    if not fast:
        return prelude
    _perm, live, gid, num_groups, key_batch = prelude
    gid_s, order = torch.sort(gid, stable=True)
    return order, live[order], gid_s, num_groups, key_batch


def _update_states(prelude, agg_inputs, agg_fns, fast: bool = False
                   ) -> List[dict]:
    """Aggregate update over a prelude, its rows in group order."""
    perm, live_s, gid, _num_groups, key_batch = _in_group_order(prelude,
                                                                fast)
    states = []
    for inp, fn in zip(agg_inputs, agg_fns):
        col = inp if inp is None else inp.gather(perm, live_s)
        states.append(fn.update(gid, col, key_batch.capacity, live_s))
    return states


def group_aggregate(batch: ColumnarBatch, key_cols: Sequence[Column],
                    agg_inputs: Sequence[Optional[Column]],
                    agg_fns: Sequence, stats: Optional[dict] = None
                    ) -> Tuple[ColumnarBatch, List[dict]]:
    """Group-by update pass: raw rows -> per-group partial states (the
    stock scatter path), grouped by hash-claim or by sort."""
    prelude, fast = _grouping_prelude(batch, key_cols, agg_fns, stats)
    return prelude[4], _update_states(prelude, agg_inputs, agg_fns, fast)


def pallas_group_fns_ok(agg_inputs: Sequence[Optional[Column]],
                        agg_fns: Sequence) -> bool:
    """Gate for the grouped kernel lane: sum-decomposable aggregates only
    (Sum/Average over floats, Count, CountStar), 1 to 128 lanes. A
    grouping with no aggregate has no lane to sum and takes the stock
    path (the JAX package's gate admits it and then fails to stack zero
    lanes)."""
    from ..expr import aggregates as Agg
    lanes = 0
    for inp, fn in zip(agg_inputs, agg_fns):
        if type(fn) in (Agg.Sum, Agg.Average):
            if inp is None or not isinstance(inp, ColumnVector) or \
                    inp.dtype not in (dt.FLOAT32, dt.FLOAT64):
                return False
            lanes += 2  # value + count
        elif type(fn) is Agg.CountStar:
            lanes += 1
        elif type(fn) is Agg.Count and inp is not None:
            lanes += 1
        else:
            return False
    return 0 < lanes <= DK.GROUP_MAX_LANES


def grouped_value_lanes(agg_inputs: Sequence[Optional[Column]],
                        agg_fns: Sequence, live: torch.Tensor
                        ) -> List[torch.Tensor]:
    """The float64 value lanes tile_group_reduce sums, pre-masked so
    excluded rows carry 0: (sum, count) per Sum/Average, count per
    Count/CountStar."""
    from ..expr import aggregates as Agg
    values = []
    for inp, fn in zip(agg_inputs, agg_fns):
        if isinstance(fn, (Agg.Sum, Agg.Average)):
            m = live & inp.validity
            values.append(torch.where(m, inp.data.to(torch.float64), 0.0))
            values.append(m.to(torch.float64))
        elif isinstance(fn, Agg.CountStar):
            values.append(live.to(torch.float64))
        else:  # Count
            values.append((live & inp.validity).to(torch.float64))
    return values


def grouped_kernel_inputs(batch: ColumnarBatch, gid: torch.Tensor,
                          agg_inputs: Sequence[Optional[Column]],
                          agg_fns: Sequence, num_buckets: int
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(int32 bucket id per row, value lanes) as tile_group_reduce takes
    them, from the hash-claim prelude's gid (rows in place). Dead rows
    sit on the scratch id (clamped into range), where they add zeros."""
    gid = gid.clamp(max=num_buckets - 1).to(torch.int32)
    return gid, grouped_value_lanes(agg_inputs, agg_fns, batch.live_mask())


def grouped_lane_inputs(batch: ColumnarBatch, key_cols: Sequence[Column],
                        agg_inputs: Sequence[Optional[Column]],
                        agg_fns: Sequence, num_buckets: int = 1024,
                        stats: Optional[dict] = None):
    """The grouped kernel lane's choice for one batch: (prelude, fast,
    kernel inputs). The kernel inputs are tile_group_reduce's (gid,
    lanes) when the hash-claim prelude resolves exactly to at most
    ``num_buckets`` groups of sum-decomposable aggregates, else None;
    the prelude is None when the static gate turns the batch down
    before grouping."""
    if not (_use_hash_grouping(batch, key_cols, agg_fns)
            and batch.capacity >= num_buckets
            and pallas_group_fns_ok(agg_inputs, agg_fns)):
        return None, False, None
    prelude, fast = _grouping_prelude(batch, key_cols, agg_fns, stats)
    if not fast or prelude[3] > num_buckets:
        return prelude, fast, None
    return prelude, fast, grouped_kernel_inputs(
        batch, prelude[2], agg_inputs, agg_fns, num_buckets)


def group_aggregate_pallas(batch: ColumnarBatch, key_cols: Sequence[Column],
                           agg_inputs: Sequence[Optional[Column]],
                           agg_fns: Sequence, num_buckets: int = 1024,
                           stats: Optional[dict] = None
                           ) -> Tuple[ColumnarBatch, List[dict], bool]:
    """Grouped update pass with the grouped kernel lane.

    Same contract as :func:`group_aggregate` plus a ``used`` flag. When
    the hash-claim prelude resolves exactly and the batch has at most
    ``num_buckets`` groups, with only sum-decomposable aggregates, the
    per-group sums come from ``device_kernels.tile_group_reduce``;
    other batches take the stock scatter path (a choice by query shape,
    as in the JAX package).
    """
    from ..expr import aggregates as Agg
    prelude, fast, kernel_in = grouped_lane_inputs(
        batch, key_cols, agg_inputs, agg_fns, num_buckets, stats)
    if prelude is None:
        kb, st = group_aggregate(batch, key_cols, agg_inputs, agg_fns, stats)
        return kb, st, False
    key_batch = prelude[4]
    if kernel_in is None:
        return key_batch, _update_states(prelude, agg_inputs, agg_fns,
                                         fast), False
    # dead rows sit on the scratch id prelude[3]: the kernel skips them
    outs = DK.tile_group_reduce(*kernel_in, num_buckets=num_buckets,
                                num_groups=max(prelude[3], 1))
    cap = key_batch.capacity

    def to_cap(arr, dtype):
        a = arr[:cap].to(dtype)
        return torch.nn.functional.pad(a, (0, cap - a.shape[0]))
    states, i = [], 0
    for fn in agg_fns:
        if isinstance(fn, (Agg.Sum, Agg.Average)):
            states.append({"sum": to_cap(outs[i], torch.float64),
                           "count": to_cap(outs[i + 1], torch.int64)})
            i += 2
        else:
            states.append({"count": to_cap(outs[i], torch.int64)})
            i += 1
    return key_batch, states, True


def group_merge(batch: ColumnarBatch, key_cols: Sequence[Column],
                agg_states: Sequence[dict], agg_fns: Sequence,
                stats: Optional[dict] = None
                ) -> Tuple[ColumnarBatch, List[dict], int]:
    """Merge partial aggregation states aligned with ``batch`` rows;
    returns (key_batch, merged states, num_groups)."""
    prelude, fast = _grouping_prelude(batch, key_cols, agg_fns, stats)
    perm, live_s, gid, num_groups, key_batch = _in_group_order(prelude,
                                                               fast)

    def take(v):  # a tensor, or a string / list column state
        return v[perm] if isinstance(v, torch.Tensor) else \
            v.gather(perm, live_s)
    merged = [fn.merge(gid, {k: take(v) for k, v in states.items()},
                       key_batch.capacity)
              for states, fn in zip(agg_states, agg_fns)]
    return key_batch, merged, num_groups


# ---------------------------------------------------------------------------
# Join (sort on a 64-bit combined key hash + verification)
# ---------------------------------------------------------------------------


def _join_key_hash(cols: Sequence[Column], null_sentinel: int
                   ) -> torch.Tensor:
    """64-bit combined hash of the key columns; rows with any null key
    get the given sentinel. Probe and build use different sentinels so
    null keys never pair up; a real hash landing on a sentinel only
    makes spurious candidates that verification rejects."""
    h1 = 42
    h2 = 0xDEADBEEF
    for c in cols:
        h1 = H.murmur3_column(c, h1)
        h2 = H.murmur3_column(c, h2)
    h = combine_hash64(h1, h2)
    any_null = torch.zeros(cols[0].capacity, dtype=torch.bool,
                           device=h.device)
    for c in cols:
        any_null = any_null | ~c.validity
    return torch.where(any_null, null_sentinel, h)


def _keys_equal(a_cols: Sequence[Column], a_idx: torch.Tensor,
                b_cols: Sequence[Column], b_idx: torch.Tensor,
                null_safe: bool = False) -> torch.Tensor:
    """True key equality for candidate pairs (collision verification).
    Join equality by default (null matches nothing); ``null_safe`` gives
    grouping equality (null == null). NaN equals NaN in both, as in
    Spark, whose join hash also puts every NaN together (the JAX
    package's ``_keys_equal`` drops NaN join pairs). Strings compare
    their Arrow bytes."""
    ok = torch.ones(a_idx.shape[0], dtype=torch.bool, device=a_idx.device)
    for ca, cb in zip(a_cols, b_cols):
        va, vb = ca.validity[a_idx], cb.validity[b_idx]
        if isinstance(ca, StringColumn):
            eq = S.pairs_equal(ca, a_idx, cb, b_idx)
        elif isinstance(ca, Decimal128Column):
            eq = (ca.hi[a_idx] == cb.hi[b_idx]) & \
                (ca.lo[a_idx] == cb.lo[b_idx])
        else:
            da, db = ca.data[a_idx], cb.data[b_idx]
            if da.dtype != db.dtype:
                t = torch.promote_types(da.dtype, db.dtype)
                da, db = da.to(t), db.to(t)
            eq = da == db
            if da.is_floating_point():
                eq = eq | (torch.isnan(da) & torch.isnan(db))
        if null_safe:
            ok = ok & ((va & vb & eq) | (~va & ~vb))
        else:
            ok = ok & va & vb & eq
    return ok


def join_gather_maps(probe_keys: Sequence[Column],
                     build_keys: Sequence[Column], probe_live: torch.Tensor,
                     build_live: torch.Tensor, out_capacity: int):
    """(probe_idx, build_idx, pair_valid, total_cand, counts) gather maps
    of ``out_capacity`` candidate pairs: the build side sorted by key
    hash, each probe row's equal-hash run found by binary search, runs
    expanded, then true key equality verified. ``total_cand`` (an int)
    is the true candidate count; past ``out_capacity`` the maps are cut
    and the caller must retry with a larger capacity."""
    imax = _I64_MAX
    cap_b = build_keys[0].capacity
    bh = torch.where(build_live, _join_key_hash(build_keys, imax - 2), imax)
    bh_sorted, order = torch.sort(bh, stable=True)
    ph = torch.where(probe_live, _join_key_hash(probe_keys, imax - 3),
                     imax - 1)
    lo = torch.searchsorted(bh_sorted, ph, side="left")
    hi = torch.searchsorted(bh_sorted, ph, side="right")
    counts = torch.where(probe_live, hi - lo, 0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total_cand = int(ends[-1]) if ends.numel() else 0
    pos = torch.arange(out_capacity, device=ph.device)
    probe_row = rows_from_offsets(starts, counts, out_capacity)
    within = pos - starts[probe_row]
    build_row = order[(lo[probe_row] + within).clamp(0, cap_b - 1)]
    cand_valid = pos < total_cand
    pair_valid = cand_valid & _keys_equal(probe_keys, probe_row, build_keys,
                                          build_row)
    return probe_row, build_row, pair_valid, total_cand, counts


def inner_join(probe: ColumnarBatch, build: ColumnarBatch,
               probe_keys: Sequence[Column], build_keys: Sequence[Column],
               out_capacity: int) -> Tuple[ColumnarBatch, int]:
    """Inner join; returns (joined batch of ``out_capacity``, candidate
    total). A total past ``out_capacity`` means the batch is cut and the
    caller must retry larger."""
    p_idx, b_idx, pair_valid, total_cand, _ = join_gather_maps(
        probe_keys, build_keys, probe.live_mask(), build.live_mask(),
        out_capacity)
    take, n_out = compaction_indices(pair_valid)
    valid = live_mask(out_capacity, n_out, probe.device)
    p_take, b_take = p_idx[take], b_idx[take]
    cols = [c.gather(p_take, valid) for c in probe.columns] + \
        [c.gather(b_take, valid) for c in build.columns]
    return ColumnarBatch(cols, probe.names + build.names, n_out,
                         probe.device), total_cand


def _matched(probe: ColumnarBatch, p_idx: torch.Tensor,
             pair_valid: torch.Tensor) -> torch.Tensor:
    """bool[probe capacity]: the probe rows with a verified match."""
    matched = torch.zeros(probe.capacity, dtype=torch.bool,
                          device=probe.device)
    matched[p_idx[pair_valid]] = True
    return matched


def left_join(probe: ColumnarBatch, build: ColumnarBatch,
              probe_keys: Sequence[Column], build_keys: Sequence[Column],
              out_capacity: int) -> Tuple[ColumnarBatch, int]:
    """Left outer join, the probe side preserved: the matched pairs,
    then each probe row without a match, its build columns null.
    Returns (batch of ``out_capacity``, required capacity): the
    requirement is max(candidate total, output rows), since candidates
    past the window are lost and output rows past the capacity are
    dropped; past ``out_capacity`` the caller must retry larger (the
    batch is None when its rows do not fit)."""
    p_idx, b_idx, pair_valid, total_cand, _ = join_gather_maps(
        probe_keys, build_keys, probe.live_mask(), build.live_mask(),
        out_capacity)
    unmatched = probe.live_mask() & ~_matched(probe, p_idx, pair_valid)
    pairs, n_pairs = compaction_indices(pair_valid)
    lone = torch.nonzero(unmatched).flatten()
    n_out = n_pairs + lone.numel()
    required = max(total_cand, n_out)
    if n_out > out_capacity:
        return None, required
    p_take = p_idx[pairs]
    p_take[n_pairs:n_out] = lone
    b_take = b_idx[pairs]
    valid = live_mask(out_capacity, n_out, probe.device)
    from_pairs = live_mask(out_capacity, n_pairs, probe.device)
    cols = [c.gather(p_take, valid) for c in probe.columns] + \
        [c.gather(b_take, from_pairs) for c in build.columns]
    return ColumnarBatch(cols, probe.names + build.names, n_out,
                         probe.device), required


def semi_anti_join(probe: ColumnarBatch, build_keys: Sequence[Column],
                   probe_keys: Sequence[Column], build_live: torch.Tensor,
                   anti: bool, scratch_capacity: Optional[int] = None
                   ) -> Tuple[ColumnarBatch, int]:
    """Left semi (``anti`` False) or anti join: the probe rows with (or
    without) a key match, probe columns only. Nothing expands, but the
    candidate window can still overflow on duplicated build keys, so
    the candidate total is returned: past ``scratch_capacity`` (default
    the probe's capacity) the caller must retry larger."""
    scratch = scratch_capacity or probe.capacity
    p_idx, _, pair_valid, total_cand, _ = join_gather_maps(
        probe_keys, build_keys, probe.live_mask(), build_live, scratch)
    matched = _matched(probe, p_idx, pair_valid)
    return compact(probe, ~matched if anti else matched), total_cand


# ---------------------------------------------------------------------------
# Limit / slice
# ---------------------------------------------------------------------------


def local_limit(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The first ``n`` live rows; the rest become dead rows."""
    new_n = min(batch.num_rows, n)
    keep = live_mask(batch.capacity, new_n, batch.device)
    cols = []
    for c in batch.columns:
        if isinstance(c, StringColumn):
            cols.append(StringColumn(c.offsets, c.chars, c.validity & keep,
                                     c.pad_bucket))
        elif isinstance(c, (Decimal128Column, ListColumn, StructColumn)):
            cols.append(c.with_validity(c.validity & keep))
        else:
            cols.append(ColumnVector(torch.where(keep, c.data, torch.zeros(
                (), dtype=c.data.dtype, device=c.data.device)),
                c.validity & keep, c.dtype))
    return ColumnarBatch(cols, batch.names, new_n, batch.device,
                         capacity=batch.capacity)


def slice_batch(batch: ColumnarBatch, start: int, length: int,
                out_capacity: int) -> ColumnarBatch:
    """Rows [start, start + length) in a batch of ``out_capacity``."""
    idx = torch.arange(out_capacity, device=batch.device) + start
    n = min(length, max(batch.num_rows - start, 0), out_capacity)
    return batch.gather(idx, n)


def repack_to(batch: ColumnarBatch, capacity: int) -> ColumnarBatch:
    """The live rows in a batch of ``capacity`` (>= num_rows)."""
    return slice_batch(batch, 0, batch.num_rows, capacity)


# ---------------------------------------------------------------------------
# Concat
# ---------------------------------------------------------------------------


def _concat_columns(cols: Sequence[Column], ns: Sequence[int],
                    out_cap: int) -> Column:
    if isinstance(cols[0], ListColumn):  # lists, maps, the collect states
        return concat_lists(cols, ns, out_cap, _concat_columns)
    if isinstance(cols[0], StructColumn):
        return concat_structs(cols, ns, out_cap, _concat_columns)
    dev = cols[0].device
    total = sum(ns)
    validity = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    validity[:total] = torch.cat([c.validity[:n] for c, n in zip(cols, ns)])
    if isinstance(cols[0], StringColumn):
        lens = torch.cat([c.lengths()[:n] for c, n in zip(cols, ns)])
        offsets = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
        offsets[1:total + 1] = torch.cumsum(lens, 0).to(torch.int32)
        offsets[total + 1:] = offsets[total]
        chars = torch.cat([c.chars[int(c.offsets[0]):int(c.offsets[n])]
                           for c, n in zip(cols, ns)])
        buf = torch.zeros(max(-(-chars.numel() // 128) * 128, 128),
                          dtype=torch.uint8, device=dev)
        buf[:chars.numel()] = chars
        return StringColumn(offsets, buf, validity,
                            max(c.pad_bucket for c in cols))
    if len({c.dtype for c in cols if dt.is_decimal(c.dtype)}) > 1:
        # unscaled lanes of two scales cannot meet as they are
        raise TypeError("concat of decimal parts of different types: "
                        f"{sorted({repr(c.dtype) for c in cols})}")
    if isinstance(cols[0], Decimal128Column):
        limbs = []
        for part in ("hi", "lo"):
            out = torch.zeros(out_cap, dtype=torch.int64, device=dev)
            out[:total] = torch.cat([getattr(c, part)[:n]
                                     for c, n in zip(cols, ns)])
            limbs.append(out)
        return Decimal128Column(*limbs, validity, cols[0].dtype)
    # parts of differing widths (a UNION's children) meet at their
    # promoted physical type, as the JAX package's concat does; the
    # column keeps the first part's logical type
    live = torch.cat([c.data[:n] for c, n in zip(cols, ns)])
    data = torch.zeros(out_cap, dtype=live.dtype, device=dev)
    data[:total] = live
    return ColumnVector(data, validity, cols[0].dtype)


# ---------------------------------------------------------------------------
# Generate / explode
# ---------------------------------------------------------------------------


def explode_batch(batch: ColumnarBatch, list_col: ListColumn,
                  element_name: str, outer: bool = False,
                  pos_name: Optional[str] = None) -> ColumnarBatch:
    """One output row per list element, the generating row's columns
    repeated (JAX kernels.py:965). ``outer``: a null or empty list still
    gives one row, with a null element (explode_outer). ``pos_name``
    adds the 0-based element position (posexplode; null on an outer
    row). The output is sized from the true total, read once, where the
    JAX package grows a static capacity and retries."""
    live = batch.live_mask()
    real = torch.where(list_col.validity & live, list_col.lengths(), 0) \
        .to(torch.int64)
    eff = torch.where(live, real.clamp(min=1), 0) if outer else real
    ends = torch.cumsum(eff, 0)
    total = int(ends[-1]) if eff.numel() else 0
    cap = choose_capacity(total)
    dev = batch.device
    pos = torch.arange(cap, device=dev)
    row = rows_from_offsets(ends - eff, eff, cap)
    within = pos - (ends - eff)[row]
    gathered = batch.gather(row, total)
    elem_ok = (pos < total) & (within < real[row])
    src = list_col.offsets[:-1].to(torch.int64)[row] + within.clamp(min=0)
    element = list_col.child.gather(src, elem_ok)
    cols, names = list(gathered.columns), list(gathered.names)
    if pos_name is not None:
        cols.append(ColumnVector(torch.where(elem_ok, within, 0)
                                 .to(torch.int32), elem_ok, dt.INT32))
        names.append(pos_name)
    cols.append(element)
    names.append(element_name)
    return ColumnarBatch(cols, names, total, dev)


def concat_batches(batches: Sequence[ColumnarBatch],
                   out_capacity: int) -> ColumnarBatch:
    """Concatenate the live rows of same-schema batches into one batch
    of ``out_capacity``."""
    first = batches[0]
    ns = [b.num_rows for b in batches]
    cols = [_concat_columns([b.columns[i] for b in batches], ns,
                            out_capacity)
            for i in range(first.num_columns)]
    return ColumnarBatch(cols, first.names, sum(ns), first.device,
                         capacity=out_capacity)


def concat_stream(stream) -> Optional[ColumnarBatch]:
    """A stream's live rows in one batch (the batch itself when only one
    has rows); None when no batch has a row."""
    batches = [b for b in stream if b.num_rows > 0]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches, choose_capacity(
        sum(b.num_rows for b in batches)))
