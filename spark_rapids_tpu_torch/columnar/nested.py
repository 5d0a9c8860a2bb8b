"""Nested device columns: lists.

Counterpart of spark_rapids_tpu/columnar/nested.py, cut to what the set
and list aggregate states need (``CollectList`` / ``CollectSet``, and so
``COUNT(DISTINCT ...)``): ``ListColumn`` with its row gather, its
concatenation and its host copy. Maps, structs and the element-wise list
kernels are not in this port yet.

The layout is Arrow's / cuDF's: ``offsets:int32[capacity+1]`` into a
child Column holding the flattened elements; row i's elements are
``child[offsets[i]:offsets[i+1]]``. Null and dead rows have zero-length
extents. Every list made here keeps its child compact (elements in row
order from offset 0, no gaps), as the JAX package's lists do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .vector import from_physical, null_column, round_pow2


class ListColumn:
    __slots__ = ("offsets", "child", "validity", "dtype")

    def __init__(self, offsets: torch.Tensor, child, validity: torch.Tensor,
                 element_type: dt.DType):
        self.offsets = offsets
        self.child = child
        self.validity = validity
        self.dtype = dt.ArrayType(element_type)

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

    def with_validity(self, validity: torch.Tensor) -> "ListColumn":
        return ListColumn(self.offsets, self.child, validity,
                          self.dtype.element_type)

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
                          validity, self.dtype.element_type)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy of the first ``num_rows`` rows: (object array of
        Python lists, mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        offs = self.offsets[:n + 1].cpu().numpy()
        et = self.dtype.element_type
        vals, mask = self.child.to_numpy(int(offs[-1]) if n else 0)
        if et == dt.STRING:
            vals = vals.to_objects()
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = [(vals[j] if et == dt.STRING
                       else from_physical(vals[j], et)) if mask[j] else None
                      for j in range(int(offs[i]), int(offs[i + 1]))]
        return out, self.validity[:n].cpu().numpy()

    def __repr__(self):
        return (f"ListColumn({self.dtype}, capacity={self.capacity}, "
                f"child_capacity={self.child_capacity})")


def empty_list_column(element_type: dt.DType, capacity: int,
                      device) -> ListColumn:
    """``capacity`` empty, valid lists (the state of a group with no
    element)."""
    return ListColumn(torch.zeros(capacity + 1, dtype=torch.int32,
                                  device=device),
                      null_column(element_type, 8, device),
                      torch.ones(capacity, dtype=torch.bool, device=device),
                      element_type)


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
    offsets = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0).to(torch.int32)
    elems = [int(c.offsets[n]) for c, n in zip(cols, ns)]
    child = concat_columns([c.child for c in cols], elems,
                           round_pow2(sum(elems)))
    return ListColumn(offsets, child, validity,
                      cols[0].dtype.element_type)
