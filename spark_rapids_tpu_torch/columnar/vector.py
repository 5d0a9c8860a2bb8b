"""Device-resident columnar vectors and batches (torch tensors).

Counterpart of spark_rapids_tpu/columnar/vector.py. A column is one or
more flat device buffers plus a validity mask; a batch carries a
``capacity`` (buffer length) and a host-side ``num_rows``:

- rows ``[0, num_rows)`` are live, rows beyond are dead padding whose
  validity is False and whose data is zero,
- operations that change cardinality (filter, aggregate) move
  ``num_rows`` and keep or shrink the capacity.

PyTorch runs eagerly, so ``num_rows`` is a Python int (the JAX package
traces it inside jit). Every batch names its ``device`` explicitly.

Strings use the Arrow layout: ``offsets:int32[capacity+1]`` into a flat
``chars:uint8`` buffer. ``HostStrings`` is the same layout in numpy.
A DECIMAL(p <= 18) column is a ColumnVector of its unscaled int64; a
wider one is a ``Decimal128Column`` (columnar/decimal128.py) of two
limbs, whose host lane is an object array of unscaled Python ints.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dtypes as dt
from .decimal128 import Decimal128Column, from_unscaled_ints


def live_mask(capacity: int, num_rows: int, device) -> torch.Tensor:
    """bool[capacity] mask of live rows."""
    return torch.arange(capacity, device=device) < num_rows


def compaction_indices(keep: torch.Tensor, out_size: Optional[int] = None
                       ) -> Tuple[torch.Tensor, int]:
    """Stable-compaction gather map of ``out_size`` entries (default:
    ``keep``'s length) and the kept count: entry j (for j < count) is
    the position of the j-th kept row; tail entries are 0 (callers mask
    dead output rows)."""
    pos = torch.nonzero(keep).flatten()
    size = keep.shape[0] if out_size is None else out_size
    if pos.numel() > size:
        raise ValueError(f"{pos.numel()} kept rows exceed {size} slots")
    idx = torch.zeros(size, dtype=torch.int64, device=keep.device)
    idx[:pos.numel()] = pos
    return idx, pos.numel()


def rows_from_offsets(starts: torch.Tensor, lens: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """Owning row per flat element position. Row r owns positions
    [starts[r], starts[r] + lens[r]); spans are contiguous and
    ascending. Returns int64[out_size]; positions past the last span map
    to the last row (callers mask with a total-length check). A binary
    search of each position among the spans' ends: the number of ends at
    or before it is its row. (The JAX package takes a scatter-max and a
    running max; ``torch.cummax`` runs as one thread block on the card,
    about 1 s over 60M positions on the H100.)"""
    n = starts.shape[0]
    dev = starts.device
    if n == 0:
        return torch.zeros(out_size, dtype=torch.int64, device=dev)
    ends = starts.to(torch.int64) + lens.to(torch.int64)
    pos = torch.arange(out_size, device=dev)
    return torch.searchsorted(ends, pos, right=True).clamp_(0, n - 1)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def round_pow2(n: int, minimum: int = 8) -> int:
    """Round up to a power of two (>= minimum)."""
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


def choose_capacity(n: int, minimum: int = 8) -> int:
    """Bucket row counts to powers of two (the JAX package's capacity
    buckets; kept so both packages pad batches alike)."""
    return round_pow2(n, minimum)


class ColumnVector:
    """A flat primitive column: data buffer + validity mask.

    ``validity[i]`` is True where row i is non-null. Dead rows have
    validity False and zero data.
    """

    __slots__ = ("data", "validity", "dtype")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: dt.DType):
        self.data = data
        self.validity = validity
        self.dtype = dtype

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "ColumnVector":
        """Gather rows; slots where ``valid`` is False become null."""
        safe = indices.clamp(0, max(self.capacity - 1, 0))
        data = self.data[safe]
        validity = self.validity[safe]
        if valid is not None:
            validity = validity & valid
            data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                        device=data.device))
        return ColumnVector(data, validity, self.dtype)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy of the first ``num_rows`` rows as (values, mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        return self.data[:n].cpu().numpy(), self.validity[:n].cpu().numpy()

    def __repr__(self):
        return f"ColumnVector({self.dtype}, capacity={self.capacity})"


class HostStrings:
    """A host string lane in the Arrow layout: int32 offsets[n+1] into a
    uint8 byte buffer. The host counterpart of StringColumn, built
    without a Python object per row."""

    __slots__ = ("offsets", "chars")

    def __init__(self, offsets: np.ndarray, chars: np.ndarray):
        self.offsets = np.asarray(offsets, dtype=np.int32)
        self.chars = np.asarray(chars, dtype=np.uint8)

    @classmethod
    def from_objects(cls, values) -> "HostStrings":
        encoded = [b"" if v is None else str(v).encode("utf-8")
                   for v in values]
        lens = np.fromiter((len(e) for e in encoded), dtype=np.int64,
                           count=len(encoded))
        offsets = np.zeros(len(encoded) + 1, np.int32)
        offsets[1:] = np.cumsum(lens)
        return cls(offsets, np.frombuffer(b"".join(encoded), np.uint8))

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def take(self, idx: np.ndarray) -> "HostStrings":
        idx = np.asarray(idx, dtype=np.int64)
        starts = self.offsets[:-1][idx].astype(np.int64)
        lens = self.lengths()[idx].astype(np.int64)
        offsets = np.zeros(idx.shape[0] + 1, np.int32)
        offsets[1:] = np.cumsum(lens)
        row = np.repeat(np.arange(idx.shape[0]), lens)
        src = starts[row] + (np.arange(int(offsets[-1])) - offsets[:-1][row])
        return HostStrings(offsets, self.chars[src])

    def to_objects(self) -> np.ndarray:
        o = self.offsets
        n = len(self)
        lens = np.diff(o)
        width = int(lens.max()) if n else 0
        body = self.chars[o[0]:o[-1]] if n else self.chars[:0]
        if n and 0 < width <= 64 and bool(np.all((body > 0) & (body < 128))):
            # ASCII without NUL bytes: one padded (rows, width) byte
            # matrix read as fixed-width strings, decoded in C
            mat = np.zeros((n, width), np.uint8)
            col = np.arange(width)
            inside = col[None, :] < lens[:, None]
            mat[inside] = body
            return mat.view(f"S{width}").reshape(n).astype(
                f"U{width}").astype(object)
        raw = self.chars.tobytes()
        return np.array([raw[o[i]:o[i + 1]].decode("utf-8", errors="replace")
                         for i in range(n)], dtype=object)

    @staticmethod
    def concat(parts: Sequence["HostStrings"]) -> "HostStrings":
        offs = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            offs.append(p.offsets[1:].astype(np.int64) - p.offsets[0] + base)
            base = int(offs[-1][-1]) if len(p) else base
        chars = np.concatenate(
            [p.chars[p.offsets[0]:p.offsets[-1]] for p in parts]
            or [np.zeros(0, np.uint8)])
        return HostStrings(np.concatenate(offs).astype(np.int32), chars)


class StringColumn:
    """Variable-length UTF-8 column: int32 offsets into a flat byte
    buffer. Row i's bytes are chars[offsets[i]:offsets[i+1]]; null and
    dead rows have zero-length extents. ``pad_bucket`` is a power-of-two
    bound on the longest string (the width of ``padded()``)."""

    __slots__ = ("offsets", "chars", "validity", "dtype", "pad_bucket")

    def __init__(self, offsets: torch.Tensor, chars: torch.Tensor,
                 validity: torch.Tensor, pad_bucket: int = 64):
        self.offsets = offsets
        self.chars = chars
        self.validity = validity
        self.dtype = dt.STRING
        self.pad_bucket = pad_bucket

    @property
    def capacity(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def char_capacity(self) -> int:
        return self.chars.shape[0]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def padded(self) -> torch.Tensor:
        """(capacity, pad_bucket) uint8 fixed-width view, zero padded.
        Zero never occurs inside UTF-8 text, so byte-wise order of the
        padded rows is string order."""
        starts = self.offsets[:-1].to(torch.int64)
        lens = self.lengths()
        k = torch.arange(self.pad_bucket, device=self.device)
        idx = (starts[:, None] + k[None, :]).clamp(0, self.char_capacity - 1)
        take = self.chars[idx]
        return torch.where(k[None, :] < lens[:, None], take,
                           torch.zeros((), dtype=torch.uint8,
                                       device=self.device))

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "StringColumn":
        """Gather string rows, repacking their bytes into a new buffer
        sized to the gathered total."""
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
        char_cap = max(_round_up(total, 128), 128)
        new_chars = torch.zeros(char_cap, dtype=torch.uint8,
                                device=self.device)
        if total:
            row = torch.repeat_interleave(
                torch.arange(out_cap, device=self.device), lens,
                output_size=total)
            within = (torch.arange(total, device=self.device)
                      - (ends - lens)[row])
            new_chars[:total] = self.chars[starts[row] + within]
        return StringColumn(new_offsets, new_chars, validity, self.pad_bucket)

    def to_numpy(self, num_rows: Optional[int] = None):
        """Host copy of the first ``num_rows`` rows as (HostStrings,
        mask)."""
        n = self.capacity if num_rows is None else int(num_rows)
        offs = self.offsets[:n + 1].cpu().numpy()
        chars = self.chars[:int(offs[-1])].cpu().numpy() if n else \
            np.zeros(0, np.uint8)
        return HostStrings(offs, chars), self.validity[:n].cpu().numpy()

    def __repr__(self):
        return (f"StringColumn(capacity={self.capacity}, "
                f"char_capacity={self.char_capacity})")


Column = Union[ColumnVector, StringColumn, "Decimal128Column"]


class ColumnarBatch:
    """Named columns on one device with a capacity and a live row count:
    the unit that flows through the operators."""

    __slots__ = ("columns", "names", "num_rows", "device", "_capacity")

    def __init__(self, columns: Sequence[Column], names: Sequence[str],
                 num_rows: int, device, capacity: Optional[int] = None):
        if len(columns) != len(names):
            raise ValueError("one name per column")
        self.columns = list(columns)
        self.names = list(names)
        self.num_rows = int(num_rows)
        self.device = torch.device(device)
        # a batch without columns (a global aggregate's key batch) still
        # has a row capacity
        self._capacity = capacity

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        return self._capacity or 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def live_mask(self) -> torch.Tensor:
        return live_mask(self.capacity, self.num_rows, self.device)

    def select(self, names: Sequence[str]) -> "ColumnarBatch":
        return ColumnarBatch([self.column(n) for n in names], list(names),
                             self.num_rows, self.device)

    def gather(self, indices: torch.Tensor,
               new_num_rows: int) -> "ColumnarBatch":
        """Gather rows by index; slots at or past ``new_num_rows`` become
        dead rows."""
        valid = live_mask(indices.shape[0], new_num_rows, self.device)
        cols = [c.gather(indices, valid) for c in self.columns]
        return ColumnarBatch(cols, self.names, new_num_rows, self.device)

    def schema(self) -> List:
        return [(n, c.dtype) for n, c in zip(self.names, self.columns)]

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}"
                         for n, c in zip(self.names, self.columns))
        return (f"ColumnarBatch[{cols}](capacity={self.capacity}, "
                f"num_rows={self.num_rows}, device={self.device})")


def with_validity(col: Column, validity: torch.Tensor) -> Column:
    """``col`` with another validity mask. A string row made null must
    already have a zero-length extent (the StringColumn invariant), as
    every row the string MIN / MAX reduction leaves unfound has."""
    if isinstance(col, StringColumn):
        return StringColumn(col.offsets, col.chars, validity, col.pad_bucket)
    if not isinstance(col, ColumnVector):  # nested or a wide decimal
        return col.with_validity(validity)
    return ColumnVector(col.data, validity, col.dtype)


def null_column(dtype: dt.DType, capacity: int, device) -> Column:
    """An all-null column of ``dtype`` (NULL's own type reads as INT32):
    strings as an empty Arrow column, so every type reads as NULL, not
    as a zero or an empty string."""
    if dtype.is_nested:
        from .nested import null_nested_column
        return null_nested_column(dtype, capacity, device)
    invalid = torch.zeros(capacity, dtype=torch.bool, device=device)
    if dtype == dt.STRING:
        return StringColumn(
            torch.zeros(capacity + 1, dtype=torch.int32, device=device),
            torch.zeros(128, dtype=torch.uint8, device=device), invalid)
    if dtype == dt.NULL:
        dtype = dt.INT32
    if dt.is_wide_decimal(dtype):
        z = torch.zeros(capacity, dtype=torch.int64, device=device)
        return Decimal128Column(z, z.clone(), invalid, dtype)
    return ColumnVector(torch.zeros(capacity, dtype=dtype.physical,
                                    device=device), invalid, dtype)


def column_from_numpy(values, capacity: int, dtype: Optional[dt.DType] = None,
                      mask: Optional[np.ndarray] = None, *,
                      device) -> Column:
    """Build a column on ``device`` (required: the caller names the
    card or the CPU) from a host lane (+ optional null mask). String
    lanes may be HostStrings or an object array of str."""
    n = len(values)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} rows")
    if dtype is None:
        dtype = dt.STRING if isinstance(values, HostStrings) else \
            dt.from_numpy_dtype(np.asarray(values).dtype)
    valid = np.ones(n, dtype=bool) if mask is None else \
        np.asarray(mask, dtype=bool)
    validity = np.zeros(capacity, dtype=bool)
    validity[:n] = valid

    if dtype == dt.STRING:
        hs = values if isinstance(values, HostStrings) else \
            HostStrings.from_objects(values)
        if n == capacity and n and hs.offsets[0] == 0 and valid.all():
            # a full batch without nulls: its offsets move as they are
            total = int(hs.offsets[n])
            offsets = torch.from_numpy(hs.offsets)
            chars = torch.zeros(max(_round_up(total, 128), 128),
                                dtype=torch.uint8, device=device)
            chars[:total] = torch.from_numpy(hs.chars[:total]).to(device)
            return StringColumn(
                offsets.to(device) if torch.device(device).type != "cpu"
                else offsets.clone(), chars,
                torch.from_numpy(validity).to(device),
                pad_bucket=round_pow2(int(np.diff(hs.offsets).max())))
        lens = np.where(valid, hs.lengths(), 0).astype(np.int64)
        offsets = np.zeros(capacity + 1, dtype=np.int32)
        offsets[1:n + 1] = np.cumsum(lens)
        offsets[n + 1:] = offsets[n]
        total = int(offsets[n])
        chars = np.zeros(max(_round_up(total, 128), 128), dtype=np.uint8)
        if total == int(hs.offsets[-1] - hs.offsets[0]):
            chars[:total] = hs.chars[hs.offsets[0]:hs.offsets[-1]]
        else:  # null slots drop their bytes
            chars[:total] = hs.take(np.nonzero(valid)[0]).chars
        max_len = int(lens.max()) if n else 0
        return StringColumn(torch.from_numpy(offsets).to(device),
                            torch.from_numpy(chars).to(device),
                            torch.from_numpy(validity).to(device),
                            pad_bucket=round_pow2(max_len))

    if isinstance(dtype, dt.DecimalType):
        values = np.asarray(values)
        if values.dtype == object:  # logical values: Decimal, int, float
            values = np.array([None if not valid[i] or v is None else
                               decimal_unscaled(v, dtype)
                               for i, v in enumerate(values)], object)
        if dtype.is_wide:
            return from_unscaled_ints(list(values), capacity, dtype,
                                      mask=valid, device=device)
        values = np.where(valid, values, 0).astype(np.int64)
    phys = dtype.np_physical
    values = np.asarray(values).astype(phys, copy=False)
    if n == capacity and valid.all():
        # a full batch without nulls moves as it is (a copy on the CPU,
        # so the column never aliases the host lane)
        data = torch.from_numpy(np.ascontiguousarray(values))
        data = data.to(device) if torch.device(device).type != "cpu" \
            else data.clone()
    else:
        host = np.zeros(capacity, dtype=phys)
        host[:n] = np.where(valid, values, np.zeros(1, dtype=phys))
        data = torch.from_numpy(host).to(device)
    return ColumnVector(data, torch.from_numpy(validity).to(device), dtype)


#: exact decimal arithmetic for host conversions (38 digits and more)
_DECIMAL_CONTEXT = None


def _decimal_context():
    global _DECIMAL_CONTEXT
    if _DECIMAL_CONTEXT is None:
        import decimal
        _DECIMAL_CONTEXT = decimal.Context(prec=80,
                                           rounding=decimal.ROUND_HALF_UP)
    return _DECIMAL_CONTEXT


def decimal_unscaled(v, dtype: "dt.DecimalType") -> int:
    """The unscaled int of a logical value at ``dtype``'s scale: a
    Decimal or an int exactly (HALF_UP past the scale), a float through
    its shortest decimal (Python's repr, as Spark's
    ``BigDecimal(Double.toString(x))``)."""
    import decimal
    ctx = _decimal_context()
    if isinstance(v, float):
        v = decimal.Decimal(repr(v))
    d = decimal.Decimal(v).scaleb(dtype.scale, context=ctx)
    return int(d.to_integral_value(rounding=decimal.ROUND_HALF_UP,
                                   context=ctx))


def decimal_value(unscaled: int, scale: int):
    """The exact decimal.Decimal of an unscaled int at ``scale``."""
    import decimal
    return decimal.Decimal(int(unscaled)).scaleb(-scale,
                                                 context=_decimal_context())


def from_physical(v, dtype: dt.DType):
    """One physical lane value as its Python value (DATE -> date,
    TIMESTAMP -> a datetime in UTC, DECIMAL -> decimal.Decimal)."""
    import datetime
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(dtype, dt.DecimalType):
        return decimal_value(v, dtype.scale)
    if dtype == dt.DATE:
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
    if dtype == dt.TIMESTAMP:
        return datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc) \
            + datetime.timedelta(microseconds=int(v))
    return v
