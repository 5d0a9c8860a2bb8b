"""Nested device columns: lists, structs and maps.

Counterpart of spark_rapids_tpu/columnar/nested.py. The layouts are
Arrow's / cuDF's:

- ``ListColumn``: ``offsets:int32[capacity+1]`` into a child Column
  holding the flattened elements; row i's elements are
  ``child[offsets[i]:offsets[i+1]]``. Null and dead rows have
  zero-length extents. Every list made here keeps its child compact
  (elements in row order from offset 0, no gaps), as the JAX package's
  lists do, so that element position p belongs to the row whose extent
  holds it and positions past ``offsets[capacity]`` are dead.
- ``StructColumn``: parallel child columns sharing the parent validity;
  a gather nulls every child under a null struct row.
- A map is a ``ListColumn`` of ``struct<key,value>`` that keeps its
  ``MapType`` through gathers and concatenations, so that host copies
  rebuild dicts (JAX nested.py:34-49).

The JAX package's ``pad_bucket`` dense ``(capacity, longest list)`` view
is a TPU static-shape device and is not carried: one skewed row would
make it rows x longest-list in size. The element functions of
expr/collections.py and expr/higher_order.py work over the offsets with
segment operations (``element_rows``, ``seg_count``, ``compact``).

Host lanes of nested columns are either an object array of Python
values (lists, dicts for structs and maps, or tuples in field order for
structs) or flat lanes: ``HostList`` (offsets plus the child's lane) and
``HostStruct`` (one lane per field), which carry millions of rows
without a Python object per row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .vector import (HostStrings, column_from_numpy, from_physical,
                     null_column, round_pow2, rows_from_offsets)


class ListColumn:
    __slots__ = ("offsets", "child", "validity", "dtype")

    def __init__(self, offsets: torch.Tensor, child, validity: torch.Tensor,
                 element_type: dt.DType,
                 map_type: Optional[dt.MapType] = None):
        self.offsets = offsets
        self.child = child
        self.validity = validity
        self.dtype = map_type or dt.ArrayType(element_type)

    @property
    def map_type(self) -> Optional[dt.MapType]:
        return self.dtype if isinstance(self.dtype, dt.MapType) else None

    @property
    def element_type(self) -> dt.DType:
        return self.dtype.element_type

    @property
    def capacity(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def child_capacity(self) -> int:
        return self.child.capacity

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def total(self) -> int:
        """Elements in use: positions [0, total) of the child."""
        return int(self.offsets[-1]) if self.capacity else 0

    def element_rows(self) -> torch.Tensor:
        """int64[child_capacity]: the row owning each element position
        (positions past the total map to the last row; callers mask
        with ``element_live``)."""
        return rows_from_offsets(self.offsets[:-1], self.lengths(),
                                 self.child_capacity)

    def element_live(self) -> torch.Tensor:
        return torch.arange(self.child_capacity, device=self.device) < \
            self.offsets[-1]

    def element_within(self, rows: torch.Tensor) -> torch.Tensor:
        """int64[child_capacity]: each element's 0-based position in its
        row."""
        return torch.arange(self.child_capacity, device=self.device) - \
            self.offsets[:-1].to(torch.int64)[rows]

    def with_validity(self, validity: torch.Tensor) -> "ListColumn":
        return ListColumn(self.offsets, self.child, validity,
                          self.element_type, self.map_type)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "ListColumn":
        """Gather list rows, repacking their elements into a child sized
        to the gathered total (the JAX package sizes it statically and
        drops what does not fit; eager torch reads the total)."""
        out_cap = indices.shape[0]
        safe = indices.clamp(0, max(self.capacity - 1, 0))
        starts = self.offsets[:-1][safe].to(torch.int64)
        lens = self.lengths()[safe].to(torch.int64)
        validity = self.validity[safe]
        if valid is not None:
            validity = validity & valid
            lens = torch.where(valid, lens, 0)
        ends = torch.cumsum(lens, 0)
        new_offsets = torch.zeros(out_cap + 1, dtype=torch.int32,
                                  device=self.device)
        new_offsets[1:] = ends.to(torch.int32)
        total = int(ends[-1]) if out_cap else 0
        child_cap = round_pow2(total)
        src = torch.zeros(child_cap, dtype=torch.int64, device=self.device)
        if total:
            row = torch.repeat_interleave(
                torch.arange(out_cap, device=self.device), lens,
                output_size=total)
            src[:total] = starts[row] + (torch.arange(total,
                                                      device=self.device)
                                         - (ends - lens)[row])
        elem_live = torch.arange(child_cap, device=self.device) < total
        return ListColumn(new_offsets, self.child.gather(src, elem_live),
                          validity, self.element_type, self.map_type)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy of the first ``num_rows`` rows: (object array of
        Python lists, or dicts for a map; None for a null row, mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        return _objects(to_python(self, n)), \
            self.validity[:n].cpu().numpy()

    def __repr__(self):
        return (f"ListColumn({self.dtype}, capacity={self.capacity}, "
                f"child_capacity={self.child_capacity})")


class StructColumn:
    __slots__ = ("children", "validity", "dtype")

    def __init__(self, children: Sequence, validity: torch.Tensor,
                 struct_type: dt.StructType):
        self.children = list(children)
        self.validity = validity
        self.dtype = struct_type

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def field(self, name: str):
        return self.children[self.dtype.field_names().index(name)]

    def with_validity(self, validity: torch.Tensor) -> "StructColumn":
        return StructColumn(self.children, validity, self.dtype)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "StructColumn":
        safe = indices.clamp(0, max(self.capacity - 1, 0))
        validity = self.validity[safe]
        if valid is not None:
            validity = validity & valid
        return StructColumn([c.gather(indices, validity)
                             for c in self.children], validity, self.dtype)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy: (object array of dicts, None for a null row,
        mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        return _objects(to_python(self, n)), \
            self.validity[:n].cpu().numpy()

    def __repr__(self):
        return f"StructColumn({self.dtype}, capacity={self.capacity})"


def _objects(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def to_python(col, n: int) -> list:
    """The first ``n`` rows of any column as Python values (None for
    null): lists for arrays, dicts for structs and maps, dates,
    datetimes and Decimals as ``from_physical`` gives them."""
    valid = col.validity[:n].cpu().numpy()
    if isinstance(col, ListColumn):
        offs = col.offsets[:n + 1].cpu().numpy().astype(np.int64)
        kids = to_python(col.child, int(offs[-1]) if n else 0)
        out = [kids[offs[i]:offs[i + 1]] if valid[i] else None
               for i in range(n)]
        if col.map_type is not None:
            out = [None if v is None else
                   {e["key"]: e["value"] for e in v if e is not None}
                   for v in out]
        return out
    if isinstance(col, StructColumn):
        names = col.dtype.field_names()
        kids = [to_python(c, n) for c in col.children]
        return [{f: k[i] for f, k in zip(names, kids)} if valid[i] else None
                for i in range(n)]
    vals, _ = col.to_numpy(n)
    t = col.dtype
    if t == dt.STRING:
        vals = vals.to_objects()
    elif isinstance(t, dt.DecimalType) or t in (dt.DATE, dt.TIMESTAMP):
        vals = [from_physical(v, t) for v in vals]
    else:
        vals = vals.tolist()
    return [v if ok else None for v, ok in zip(vals, valid)]


# ---------------------------------------------------------------------------
# segment helpers over a compact child
# ---------------------------------------------------------------------------


def offsets_from_lengths(lens: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                      device=lens.device)
    out[1:] = torch.cumsum(lens, 0).to(torch.int32)
    return out


def seg_count(mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """int64[rows]: set entries of the element mask in each row's
    extent (a prefix sum read at the offsets, no atomics)."""
    c = torch.zeros(mask.shape[0] + 1, dtype=torch.int64,
                    device=mask.device)
    c[1:] = torch.cumsum(mask.to(torch.int64), 0)
    o = offsets.to(torch.int64)
    return c[o[1:]] - c[o[:-1]]


def seg_first(mask: torch.Tensor, rows: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """int64[rows]: the first element position where ``mask`` is set in
    each row, or -1."""
    big = mask.shape[0]
    pos = torch.arange(big, device=mask.device)
    first = torch.full((n_rows,), big, dtype=torch.int64,
                       device=mask.device)
    first.scatter_reduce_(0, rows, torch.where(mask, pos, big), "amin")
    return torch.where(first < big, first, -1)


def compact(lc: ListColumn, keep: torch.Tensor,
            validity: Optional[torch.Tensor] = None) -> ListColumn:
    """The elements of ``lc`` where ``keep`` (bool[child_capacity]) is
    set, in order, each row keeping its kept elements."""
    keep = keep & lc.element_live()
    validity = lc.validity if validity is None else validity
    lens = torch.where(validity, seg_count(keep, lc.offsets), 0)
    offsets = offsets_from_lengths(lens)
    pos = torch.nonzero(keep).flatten()
    total = pos.shape[0]
    cap = round_pow2(total)
    src = torch.zeros(cap, dtype=torch.int64, device=lc.device)
    src[:total] = pos
    live = torch.arange(cap, device=lc.device) < total
    return ListColumn(offsets, lc.child.gather(src, live), validity,
                      lc.element_type, lc.map_type)


# ---------------------------------------------------------------------------
# empty columns and concatenation
# ---------------------------------------------------------------------------


def empty_list_column(element_type: dt.DType, capacity: int,
                      device) -> ListColumn:
    """``capacity`` empty, valid lists (the state of a group with no
    element)."""
    return ListColumn(torch.zeros(capacity + 1, dtype=torch.int32,
                                  device=device),
                      null_column(element_type, 8, device),
                      torch.ones(capacity, dtype=torch.bool, device=device),
                      element_type)


def null_nested_column(dtype: dt.DType, capacity: int, device):
    """An all-null nested column of ``dtype``."""
    invalid = torch.zeros(capacity, dtype=torch.bool, device=device)
    if isinstance(dtype, dt.StructType):
        return StructColumn([null_column(t, capacity, device)
                             for t in dtype.field_types()], invalid, dtype)
    et = dtype.element_type
    return ListColumn(torch.zeros(capacity + 1, dtype=torch.int32,
                                  device=device),
                      null_column(et, 8, device), invalid, et,
                      dtype if isinstance(dtype, dt.MapType) else None)


def concat_lists(cols: Sequence[ListColumn], ns: Sequence[int],
                 out_cap: int, concat_columns) -> ListColumn:
    """The first ``ns[k]`` rows of each list column, in order, in one
    column of ``out_cap`` rows: children concatenate as columns and the
    offsets relabel by a running sum of the lengths (dead and null rows
    carry zero-length extents)."""
    dev = cols[0].device
    total = sum(ns)
    lens = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    validity = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    if total:
        lens[:total] = torch.cat([c.lengths()[:n].to(torch.int64)
                                  for c, n in zip(cols, ns)])
        validity[:total] = torch.cat([c.validity[:n]
                                      for c, n in zip(cols, ns)])
    offsets = offsets_from_lengths(lens)
    elems = [int(c.offsets[n]) for c, n in zip(cols, ns)]
    child = concat_columns([c.child for c in cols], elems,
                           round_pow2(sum(elems)))
    return ListColumn(offsets, child, validity, cols[0].element_type,
                      cols[0].map_type)


def concat_structs(cols: Sequence[StructColumn], ns: Sequence[int],
                   out_cap: int, concat_columns) -> StructColumn:
    dev = cols[0].device
    total = sum(ns)
    validity = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    if total:
        validity[:total] = torch.cat([c.validity[:n]
                                      for c, n in zip(cols, ns)])
    kids = [concat_columns([c.children[i] for c in cols], ns, out_cap)
            for i in range(len(cols[0].children))]
    return StructColumn(kids, validity, cols[0].dtype)


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------


class HostList:
    """The host lane of a list or map column without a Python object
    per row: int64 ``offsets[n+1]`` into the child's lane (``values``,
    ``mask``), which may itself be a HostList, HostStruct, HostStrings
    or numpy array. A null row's extent may be empty or not (its
    elements are dropped on the way to the device)."""

    __slots__ = ("offsets", "values", "mask")

    def __init__(self, offsets, values, mask):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.values = values
        self.mask = np.asarray(mask, dtype=bool)

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    def take(self, idx) -> "HostList":
        idx = np.asarray(idx, dtype=np.int64)
        run = _run_of(idx)
        if run is not None:  # a slice: views of the child's range
            lo, hi = int(self.offsets[run[0]]), int(self.offsets[run[1]])
            return HostList(self.offsets[run[0]:run[1] + 1] - lo,
                            lane_range(self.values, lo, hi),
                            self.mask[lo:hi])
        starts = self.offsets[:-1][idx]
        lens = np.diff(self.offsets)[idx]
        offsets = np.zeros(idx.shape[0] + 1, np.int64)
        offsets[1:] = np.cumsum(lens)
        row = np.repeat(np.arange(idx.shape[0]), lens)
        src = starts[row] + (np.arange(int(offsets[-1])) - offsets[:-1][row])
        return HostList(offsets, self.values.take(src), self.mask[src])

    def to_objects(self, dtype: dt.DType) -> np.ndarray:
        kids = host_python(self.values, self.mask, dtype.element_type)
        out = [kids[self.offsets[i]:self.offsets[i + 1]]
               for i in range(len(self))]
        if isinstance(dtype, dt.MapType):
            out = [{e["key"]: e["value"] for e in v if e is not None}
                   for v in out]
        return _objects(out)


def _run_of(idx: np.ndarray):
    """(first, stop) when ``idx`` is a run of consecutive rows, else
    None."""
    n = idx.shape[0]
    if n and int(idx[-1]) - int(idx[0]) == n - 1 and \
            bool(np.all(np.diff(idx) == 1)):
        return int(idx[0]), int(idx[-1]) + 1
    return None


def lane_range(values, lo: int, hi: int):
    """Rows [lo, hi) of a host lane, as views where the lane allows."""
    if isinstance(values, HostStrings):
        a, b = int(values.offsets[lo]), int(values.offsets[hi])
        return HostStrings(values.offsets[lo:hi + 1] - a,
                           values.chars[a:b])
    if isinstance(values, (HostList, HostStruct)):
        return values.take(np.arange(lo, hi))
    return values[lo:hi]


class HostStruct:
    """The host lane of a struct column: one (values, mask) lane per
    field, in field order."""

    __slots__ = ("fields",)

    def __init__(self, fields):
        self.fields = [(v, np.asarray(m, dtype=bool)) for v, m in fields]

    def __len__(self) -> int:
        return len(self.fields[0][1]) if self.fields else 0

    def take(self, idx) -> "HostStruct":
        return HostStruct([(v.take(idx), m[idx]) for v, m in self.fields])

    def to_objects(self, dtype: dt.StructType) -> np.ndarray:
        kids = [host_python(v, m, t) for (v, m), t in
                zip(self.fields, dtype.field_types())]
        names = dtype.field_names()
        return _objects([{f: k[i] for f, k in zip(names, kids)}
                         for i in range(len(self))])


def concat_host_lanes(parts: Sequence):
    """Flat host lanes (HostList, HostStruct, HostStrings or numpy) of
    one kind, end to end, without a Python object per row."""
    first = parts[0]
    if isinstance(first, HostList):
        offs, kids, masks, base = [np.zeros(1, np.int64)], [], [], 0
        for p in parts:
            lo, hi = int(p.offsets[0]), int(p.offsets[-1])
            offs.append(p.offsets[1:] - lo + base)
            kids.append(lane_range(p.values, lo, hi))
            masks.append(p.mask[lo:hi])
            base += hi - lo
        return HostList(np.concatenate(offs), concat_host_lanes(kids),
                        np.concatenate(masks))
    if isinstance(first, HostStruct):
        return HostStruct([
            (concat_host_lanes([p.fields[i][0] for p in parts]),
             np.concatenate([p.fields[i][1] for p in parts]))
            for i in range(len(first.fields))])
    if isinstance(first, HostStrings):
        return HostStrings.concat(parts)
    return np.concatenate(parts)


def host_python(values, mask, dtype: dt.DType) -> list:
    """A host lane (flat lanes, an object array of Python values or a
    primitive numpy lane) as Python values, None where ``mask`` is
    clear."""
    mask = np.asarray(mask, dtype=bool)
    if isinstance(values, (HostList, HostStruct)):
        vals = values.to_objects(dtype)
    elif isinstance(values, HostStrings):
        vals = values.to_objects()
    elif dtype.is_nested or dt.is_wide_decimal(dtype):
        vals = values
        if dt.is_wide_decimal(dtype):
            vals = [from_physical(int(v), dtype) for v in values]
    elif isinstance(dtype, dt.DecimalType) or dtype in (dt.DATE,
                                                        dt.TIMESTAMP):
        vals = [from_physical(v, dtype) for v in values]
    else:
        vals = np.asarray(values).tolist()
    return [v if ok else None for v, ok in zip(vals, mask)]


def _leaf_lane(values: list, dtype: dt.DType):
    """Python values (None for null) -> (physical host lane, mask)."""
    from ..expr.core import literal_physical
    mask = np.array([v is not None for v in values], dtype=bool)
    if dtype == dt.STRING:
        return HostStrings.from_objects(values), mask
    if dt.is_wide_decimal(dtype):
        return np.array([0 if v is None else literal_physical(v, dtype)
                         for v in values], object), mask
    phys = np.dtype(bool) if dtype == dt.NULL else dtype.np_physical
    return np.array([0 if v is None else literal_physical(v, dtype)
                     for v in values], phys), mask


def nested_column_from_pylist(values, capacity: int, dtype: dt.DType,
                              mask: Optional[np.ndarray] = None, *,
                              device):
    """A device column of any type, nested or not, from Python values
    (None for null): lists for arrays, dicts (or tuples in field order)
    for structs, dicts (or (key, value) pairs) for maps (JAX
    nested.py:249)."""
    values = list(values)
    n = len(values)
    valid = np.array([v is not None for v in values], dtype=bool) \
        if mask is None else np.asarray(mask, dtype=bool) & \
        np.array([v is not None for v in values], dtype=bool)
    validity = np.zeros(capacity, dtype=bool)
    validity[:n] = valid
    vt = torch.from_numpy(validity).to(device)
    if isinstance(dtype, dt.MapType):
        def entries(v):
            pairs = v.items() if isinstance(v, dict) else v
            return [{"key": k, "value": x} for k, x in pairs]
        lc = nested_column_from_pylist(
            [entries(v) if ok else None for v, ok in zip(values, valid)],
            capacity, dt.ArrayType(dtype.element_type), device=device)
        return ListColumn(lc.offsets, lc.child, lc.validity,
                          dtype.element_type, dtype)
    if isinstance(dtype, dt.ArrayType):
        lens = np.array([len(v) if ok else 0
                         for v, ok in zip(values, valid)], np.int64)
        offsets = np.zeros(capacity + 1, dtype=np.int32)
        offsets[1:n + 1] = np.cumsum(lens)
        offsets[n + 1:] = offsets[n] if n else 0
        flat: list = []
        for v, ok in zip(values, valid):
            if ok:
                flat.extend(v)
        child = nested_column_from_pylist(flat, round_pow2(len(flat)),
                                          dtype.element_type, device=device)
        return ListColumn(torch.from_numpy(offsets).to(device), child, vt,
                          dtype.element_type)
    if isinstance(dtype, dt.StructType):
        kids = []
        for fi, (fname, ftype) in enumerate(dtype.fields):
            fvals = [None if not ok else
                     (v.get(fname) if isinstance(v, dict) else v[fi])
                     for v, ok in zip(values, valid)]
            kids.append(nested_column_from_pylist(fvals, capacity, ftype,
                                                  device=device))
        return StructColumn(kids, vt, dtype)
    lane, m = _leaf_lane(values, dtype)
    return column_from_host_lane(lane, m & valid, dtype, capacity,
                                 device=device)


def column_from_host_lane(values, mask, dtype: dt.DType, capacity: int, *,
                          device):
    """A device column of ``capacity`` rows from a host lane of any
    type: flat lanes (``HostList`` / ``HostStruct``), an object array of
    Python values for a nested type, or a primitive or string lane. The
    card's nested tables move this way: offsets and child lanes in
    bulk."""
    mask = np.asarray(mask, dtype=bool)
    n = len(mask)
    if isinstance(values, HostList):
        lens = np.diff(values.offsets)
        if (lens[~mask] > 0).any():  # drop the elements of null rows
            row = np.repeat(np.arange(n), lens)
            sub = np.nonzero(mask[row])[0] + values.offsets[0]
            lens = np.where(mask, lens, 0)
            offsets = np.zeros(n + 1, np.int64)
            offsets[1:] = np.cumsum(lens)
            values = HostList(offsets, values.values.take(sub),
                              values.mask[sub])
        start = int(values.offsets[0])
        total = int(values.offsets[-1]) - start
        idx = np.arange(start, start + total)
        cv, cm = (values.values.take(idx), values.mask[idx]) \
            if start or total != len(values.mask) else \
            (values.values, values.mask)
        et = dtype.element_type
        child = column_from_host_lane(cv, cm, et, round_pow2(total),
                                      device=device)
        offsets = np.zeros(capacity + 1, np.int32)
        offsets[1:n + 1] = values.offsets[1:] - start
        offsets[n + 1:] = offsets[n]
        validity = np.zeros(capacity, bool)
        validity[:n] = mask
        return ListColumn(torch.from_numpy(offsets).to(device), child,
                          torch.from_numpy(validity).to(device), et,
                          dtype if isinstance(dtype, dt.MapType) else None)
    if isinstance(values, HostStruct):
        validity = np.zeros(capacity, bool)
        validity[:n] = mask
        kids = [column_from_host_lane(v, m & mask, t, capacity,
                                      device=device)
                for (v, m), t in zip(values.fields, dtype.field_types())]
        return StructColumn(kids, torch.from_numpy(validity).to(device),
                            dtype)
    if dtype.is_nested:
        return nested_column_from_pylist(values, capacity, dtype, mask,
                                         device=device)
    if dt.is_wide_decimal(dtype):
        from .decimal128 import from_unscaled_ints
        return from_unscaled_ints(list(values), capacity, dtype, mask=mask,
                                  device=device)
    return column_from_numpy(values, capacity, dtype=dtype, mask=mask,
                             device=device)
