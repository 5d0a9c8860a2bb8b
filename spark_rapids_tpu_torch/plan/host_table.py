"""Host-side columnar table and the host <-> device transitions.

Counterpart of spark_rapids_tpu/plan/host_table.py. Each column is
(values, mask) in the same physical lane encoding the device side uses
(dates = int32 days, timestamps int64 microseconds, decimals their
unscaled int64, or unscaled Python ints in an object array above
precision 18). The two sides of the host differ in strings and nested
lanes:

- the device path's host tables (``batch_to_table``, ``table_to_batch``)
  keep a string lane as HostStrings (Arrow offsets and bytes) and a
  nested lane as an object array of Python values or as flat lanes
  (``HostList``, ``HostStruct``, columnar/nested.py);
- the CPU engine (cpu_eval.py, cpu_exec.py), copied from the JAX
  package, reads a string lane as an object array of ``str`` ("" under
  a null) and a nested lane as an object array of Python lists and
  dicts (None under a null).

``to_engine`` and ``from_engine`` convert between the two, losslessly;
the seams of a mixed plan (transitions.py) call them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.decimal128 import from_unscaled_ints
from ..columnar.nested import (HostList, HostStruct, column_from_host_lane,
                               concat_host_lanes, host_python)
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

    def take(self, idx: np.ndarray,
             valid: Optional[np.ndarray] = None) -> "HostColumn":
        """Rows ``idx``; where ``valid`` is given, rows it clears are
        null (an outer join's unmatched side, gathered from an empty
        column too)."""
        idx = np.asarray(idx, dtype=np.int64)
        if len(self.values) == 0 and len(idx):
            values = np.zeros(len(idx), dtype=self.values.dtype) \
                if isinstance(self.values, np.ndarray) else \
                self.values.take(np.zeros(0, np.int64))
            return HostColumn(values, np.zeros(len(idx), bool), self.dtype)
        mask = self.mask[idx]
        if valid is not None:
            mask = mask & valid
        return HostColumn(self.values.take(idx), mask, self.dtype)

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

    def take(self, idx: np.ndarray,
             valid: Optional[np.ndarray] = None) -> "HostTable":
        return HostTable([c.take(idx, valid) for c in self.columns],
                         self.names)

    def select_rows(self, mask: np.ndarray) -> "HostTable":
        return self.take(np.nonzero(mask)[0])

    def with_columns(self, columns: Sequence[HostColumn],
                     names: Sequence[str]) -> "HostTable":
        return HostTable(list(columns), list(names))

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}"
                         for n, c in zip(self.names, self.columns))
        return f"HostTable[{cols}](n={self.num_rows})"


def concat_tables(tables: Sequence[HostTable]) -> HostTable:
    first = tables[0]
    cols = []
    for i, c0 in enumerate(first.columns):
        parts = [t.columns[i].values for t in tables]
        if isinstance(c0.values, (HostList, HostStruct)):
            if all(type(p) is type(c0.values) for p in parts):
                mask = np.concatenate([t.columns[i].mask for t in tables])
                cols.append(HostColumn(concat_host_lanes(parts), mask,
                                       c0.dtype))
                continue
            parts = [p.to_objects(c0.dtype) for p in parts]
        values = HostStrings.concat(parts) if isinstance(
            c0.values, HostStrings) else np.concatenate(parts) \
            if parts[0].dtype != object else _objects(
                [v for p in parts for v in p])
        mask = np.concatenate([t.columns[i].mask for t in tables])
        cols.append(HostColumn(values, mask, c0.dtype))
    return HostTable(cols, first.names)


def to_pydict(table: HostTable) -> dict:
    """{name: [python values]} with None for nulls."""
    out = {}
    for name, c in zip(table.names, table.columns):
        if c.dtype == dt.STRING:
            vals = c.values.to_objects() \
                if isinstance(c.values, HostStrings) else c.values
            out[name] = [vals[i] if c.mask[i] else None
                         for i in range(len(c))]
        elif c.dtype.is_nested:
            out[name] = host_python(c.values, c.mask, c.dtype)
        else:
            out[name] = [from_physical(c.values[i], c.dtype)
                         if c.mask[i] else None for i in range(len(c))]
    return out


def table_to_batch(table: HostTable, capacity: Optional[int] = None, *,
                   device) -> ColumnarBatch:
    """Move a host table to ``device`` (required: the caller names the
    card or the CPU) as one batch."""
    n = table.num_rows
    cap = capacity or choose_capacity(n)
    cols = [column_from_host_lane(c.values, c.mask, c.dtype, cap,
                                  device=device)
            if c.dtype.is_nested else
            from_unscaled_ints(list(c.values), cap, c.dtype, mask=c.mask,
                               device=device)
            if dt.is_wide_decimal(c.dtype) else
            column_from_numpy(c.values, cap, dtype=c.dtype, mask=c.mask,
                              device=device) for c in table.columns]
    return ColumnarBatch(cols, table.names, n, device)


def batch_to_table(batch: ColumnarBatch) -> HostTable:
    """Host copy of a batch's live rows."""
    cols = []
    for c in batch.columns:
        vals, mask = c.to_numpy(batch.num_rows)
        cols.append(HostColumn(vals, mask, c.dtype))
    return HostTable(cols, batch.names)


def empty_like(schema: Schema) -> HostTable:
    """An empty table in the CPU engine's layout."""
    cols = [HostColumn(np.zeros(0, object)
                       if t == dt.STRING or t.is_nested
                       or dt.is_wide_decimal(t)
                       else np.zeros(0, t.np_physical or np.int32),
                       np.zeros(0, bool), t) for _, t in schema]
    return HostTable(cols, [n for n, _ in schema])


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def from_pydict(data: dict, schema: Schema) -> HostTable:
    """{name: [Python values, None for null]} in the CPU engine's
    layout (the JAX package's ``from_pydict``)."""
    from ..expr.core import literal_physical
    cols = []
    for name, t in schema:
        raw = list(data[name])
        mask = np.array([v is not None for v in raw], dtype=bool)
        if t.is_nested:
            values = _objects(raw)
        elif t == dt.STRING:
            values = _objects(["" if v is None else v for v in raw])
        elif dt.is_wide_decimal(t):
            values = _objects([0 if v is None else literal_physical(v, t)
                               for v in raw])
        else:
            values = np.array([0 if v is None else literal_physical(v, t)
                               for v in raw], t.np_physical or np.int32)
        cols.append(HostColumn(values, mask, t))
    return HostTable(cols, [n for n, _ in schema])


def to_engine(table: HostTable) -> HostTable:
    """The device path's host layout -> the CPU engine's: a string lane
    as an object array of ``str`` ("" under a null), a nested lane as
    an object array of Python values (None under a null), a wide
    decimal as Python ints."""
    cols = []
    for c in table.columns:
        values = c.values
        if c.dtype == dt.STRING:
            strs = values.to_objects() if isinstance(values, HostStrings) \
                else values
            values = _objects([s if ok else "" for s, ok in
                               zip(strs, c.mask)])
        elif c.dtype.is_nested:
            values = _objects(host_python(values, c.mask, c.dtype))
        elif dt.is_wide_decimal(c.dtype):
            values = _objects([int(v) for v in values])
        cols.append(HostColumn(values, c.mask, c.dtype))
    return HostTable(cols, table.names)


def from_engine(table: HostTable) -> HostTable:
    """The CPU engine's host layout -> the device path's (the inverse
    of ``to_engine``): strings back to HostStrings; nested lanes stay
    object arrays of Python values, which ``table_to_batch`` takes."""
    cols = []
    for c in table.columns:
        values = c.values
        if c.dtype == dt.STRING and not isinstance(values, HostStrings):
            values = HostStrings.from_objects(
                [s if ok else None for s, ok in zip(values, c.mask)])
        elif c.dtype.is_nested:
            values = _objects([v if ok else None
                               for v, ok in zip(values, c.mask)])
        cols.append(HostColumn(values, c.mask, c.dtype))
    return HostTable(cols, table.names)
