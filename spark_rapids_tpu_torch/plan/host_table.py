"""Host-side columnar table and the host <-> device transitions.

Counterpart of spark_rapids_tpu/plan/host_table.py. Each column is
(values, mask) in the same physical lane encoding the device side uses
(dates = int32 days); string lanes are HostStrings (Arrow layout).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.vector import (ColumnarBatch, HostStrings, choose_capacity,
                               column_from_numpy, from_physical)

Schema = List  # [(name, DType), ...]


class HostColumn:
    __slots__ = ("values", "mask", "dtype")

    def __init__(self, values, mask: np.ndarray, dtype: dt.DType):
        if len(values) != len(mask):
            raise ValueError("values and mask differ in length")
        self.values = values
        self.mask = np.asarray(mask, dtype=bool)
        self.dtype = dtype

    def __len__(self):
        return len(self.values)

    def take(self, idx: np.ndarray) -> "HostColumn":
        return HostColumn(self.values.take(idx) if isinstance(
            self.values, HostStrings) else self.values[idx],
            self.mask[idx], self.dtype)

    def __repr__(self):
        return f"HostColumn({self.dtype}, n={len(self)})"


class HostTable:
    """Ordered named host columns."""

    def __init__(self, columns: Sequence[HostColumn], names: Sequence[str]):
        if len(columns) != len(names):
            raise ValueError("one name per column")
        self.columns = list(columns)
        self.names = list(names)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def column(self, name: str) -> HostColumn:
        return self.columns[self.names.index(name)]

    def schema(self) -> Schema:
        return [(n, c.dtype) for n, c in zip(self.names, self.columns)]

    def slice(self, start: int, stop: int) -> "HostTable":
        return HostTable([c.take(np.arange(start, min(stop, len(c))))
                          for c in self.columns], self.names)

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}"
                         for n, c in zip(self.names, self.columns))
        return f"HostTable[{cols}](n={self.num_rows})"


def concat_tables(tables: Sequence[HostTable]) -> HostTable:
    first = tables[0]
    cols = []
    for i, c0 in enumerate(first.columns):
        parts = [t.columns[i].values for t in tables]
        values = HostStrings.concat(parts) if isinstance(
            c0.values, HostStrings) else np.concatenate(parts)
        mask = np.concatenate([t.columns[i].mask for t in tables])
        cols.append(HostColumn(values, mask, c0.dtype))
    return HostTable(cols, first.names)


def to_pydict(table: HostTable) -> dict:
    """{name: [python values]} with None for nulls."""
    out = {}
    for name, c in zip(table.names, table.columns):
        if c.dtype == dt.STRING:
            vals = c.values.to_objects()
            out[name] = [vals[i] if c.mask[i] else None
                         for i in range(len(c))]
        else:
            out[name] = [from_physical(c.values[i], c.dtype)
                         if c.mask[i] else None for i in range(len(c))]
    return out


def table_to_batch(table: HostTable, capacity: Optional[int] = None,
                   device="cpu") -> ColumnarBatch:
    """Move a host table to ``device`` as one batch."""
    n = table.num_rows
    cap = capacity or choose_capacity(n)
    cols = [column_from_numpy(c.values, cap, dtype=c.dtype, mask=c.mask,
                              device=device) for c in table.columns]
    return ColumnarBatch(cols, table.names, n, device)


def batch_to_table(batch: ColumnarBatch) -> HostTable:
    """Host copy of a batch's live rows."""
    cols = []
    for c in batch.columns:
        vals, mask = c.to_numpy(batch.num_rows)
        cols.append(HostColumn(vals, mask, c.dtype))
    return HostTable(cols, batch.names)


def empty_table(schema: Schema) -> HostTable:
    no_strings = HostStrings(np.zeros(1, np.int32), np.zeros(0, np.uint8))
    cols = [HostColumn(no_strings if t == dt.STRING
                       else np.zeros(0, t.np_physical), np.zeros(0, bool), t)
            for _, t in schema]
    return HostTable(cols, [n for n, _ in schema])
