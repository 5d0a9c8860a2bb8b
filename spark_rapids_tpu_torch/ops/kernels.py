"""Batch kernels: the tensor cores of the physical operators.

Counterpart of spark_rapids_tpu/ops/kernels.py, ported as deep as TPC-H
q6/q1 need: filter compaction, multi-key stable sort, sort-based
grouping and the grouped update / merge passes. Everything is eager
torch code over ColumnarBatch; the grouped update hands its per-bucket
sums to the hand-written kernel ``device_kernels.tile_group_reduce``.

Group ids are an internal numbering (here: the rank of the key in sort
order); state tables are sized ``choose_capacity(num_groups + 1)`` so
the slot just past the live groups takes the dead rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import (Column, ColumnVector, ColumnarBatch,
                               StringColumn, choose_capacity,
                               compaction_indices, live_mask)
from . import device_kernels as DK

# ---------------------------------------------------------------------------
# Filter
# ---------------------------------------------------------------------------


def compact(batch: ColumnarBatch, keep: torch.Tensor) -> ColumnarBatch:
    """Keep rows where ``keep`` (restricted to live rows), in order."""
    idx, n = compaction_indices(keep & batch.live_mask())
    return batch.gather(idx, n)


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
    is unsigned byte order; floats fold -0.0 into 0.0."""
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


# ---------------------------------------------------------------------------
# Group-by (sort-based)
# ---------------------------------------------------------------------------


def _keys_eq_pairs(col: Column, ia: torch.Tensor,
                   ib: torch.Tensor) -> torch.Tensor:
    """Null-safe key equality of row pairs (ia[k], ib[k]); NaN == NaN
    for grouping."""
    va, vb = col.validity[ia], col.validity[ib]
    if isinstance(col, StringColumn):
        lens = col.lengths()
        data_eq = lens[ia] == lens[ib]
        for w in _rank_keys(col):
            data_eq = data_eq & (w[ia] == w[ib])
    else:
        da, db = col.data[ia], col.data[ib]
        data_eq = da == db
        if da.is_floating_point():
            data_eq = data_eq | (torch.isnan(da) & torch.isnan(db))
    return (va == vb) & (~va | data_eq)


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
    """Grouping machinery for update and merge passes (see
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


def _update_states(prelude, agg_inputs, agg_fns) -> List[dict]:
    perm, live_s, gid, _num_groups, key_batch = prelude
    return [fn.update(gid, None if inp is None else inp.gather(perm, live_s),
                      key_batch.capacity, live_s)
            for inp, fn in zip(agg_inputs, agg_fns)]


def group_aggregate(batch: ColumnarBatch, key_cols: Sequence[Column],
                    agg_inputs: Sequence[Optional[Column]],
                    agg_fns: Sequence) -> Tuple[ColumnarBatch, List[dict]]:
    """Sort-based group-by update pass: raw rows -> per-group partial
    states (the stock scatter path)."""
    prelude = _sorted_group_prelude(batch, key_cols)
    return prelude[4], _update_states(prelude, agg_inputs, agg_fns)


def pallas_group_fns_ok(agg_inputs: Sequence[Optional[Column]],
                        agg_fns: Sequence) -> bool:
    """Gate for the grouped kernel lane: sum-decomposable aggregates only
    (Sum/Average over floats, Count, CountStar), at most 128 lanes."""
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
    return lanes <= DK.GROUP_MAX_LANES


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


def grouped_kernel_inputs(batch: ColumnarBatch, perm: torch.Tensor,
                          gid_sorted: torch.Tensor,
                          agg_inputs: Sequence[Optional[Column]],
                          agg_fns: Sequence, num_buckets: int
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(int32 bucket id per row, value lanes) as tile_group_reduce takes
    them. The id is scattered back to each row's original position, so
    the value lanes are read in place and never gathered into sort
    order; dead rows sit on the scratch id (clamped into range), where
    they add zeros."""
    gid = torch.empty_like(gid_sorted)
    gid[perm] = gid_sorted
    gid = gid.clamp(max=num_buckets - 1).to(torch.int32)
    return gid, grouped_value_lanes(agg_inputs, agg_fns, batch.live_mask())


def group_aggregate_pallas(batch: ColumnarBatch, key_cols: Sequence[Column],
                           agg_inputs: Sequence[Optional[Column]],
                           agg_fns: Sequence, num_buckets: int = 1024
                           ) -> Tuple[ColumnarBatch, List[dict], bool]:
    """Grouped update pass with the grouped kernel lane.

    Same contract as :func:`group_aggregate` plus a ``used`` flag. A
    batch whose keys resolve to at most ``num_buckets`` groups, with
    only sum-decomposable aggregates, gets its per-group sums from
    ``device_kernels.tile_group_reduce``; other batches take the stock
    scatter path (a choice by query shape, as in the JAX package).
    """
    from ..expr import aggregates as Agg
    prelude = _prelude_exact(batch, key_cols)
    perm, _live_s, gid_s, num_groups, key_batch = prelude
    if num_groups > num_buckets or \
            not pallas_group_fns_ok(agg_inputs, agg_fns):
        return key_batch, _update_states(prelude, agg_inputs, agg_fns), False
    gid, values = grouped_kernel_inputs(batch, perm, gid_s, agg_inputs,
                                        agg_fns, num_buckets)
    outs = DK.tile_group_reduce(gid, values, num_buckets=num_buckets)
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
                agg_states: Sequence[dict], agg_fns: Sequence
                ) -> Tuple[ColumnarBatch, List[dict], int]:
    """Merge partial aggregation states aligned with ``batch`` rows;
    returns (key_batch, merged states, num_groups)."""
    perm, _live_s, gid, num_groups, key_batch = \
        _sorted_group_prelude(batch, key_cols)
    merged = [fn.merge(gid, {k: v[perm] for k, v in states.items()},
                       key_batch.capacity)
              for states, fn in zip(agg_states, agg_fns)]
    return key_batch, merged, num_groups


# ---------------------------------------------------------------------------
# Concat
# ---------------------------------------------------------------------------


def _concat_columns(cols: Sequence[Column], ns: Sequence[int],
                    out_cap: int) -> Column:
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
    data = torch.zeros(out_cap, dtype=cols[0].data.dtype, device=dev)
    data[:total] = torch.cat([c.data[:n] for c, n in zip(cols, ns)])
    return ColumnVector(data, validity, cols[0].dtype)


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
