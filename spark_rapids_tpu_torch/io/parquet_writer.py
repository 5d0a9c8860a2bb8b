"""Host table -> Parquet file, without the Arrow library.

The Parquet lane of spark_rapids_tpu/io/writer.py:34-38, which writes
through Arrow's ``write_table``. The file is written as the format lays it
out: ``PAR1``, per row group (at most ``ROW_GROUP_ROWS`` rows) one
column chunk per column, each a run of v1 data pages of about
``PAGE_BYTES`` uncompressed bytes (PLAIN values behind the RLE /
bit-packed definition levels, each page compressed; encoded in the host
library, csrc/host/parquet_encode.cpp), then the footer (io/thrift.py)
with each chunk's ``Statistics`` (min, max, null_count) and the logical
and converted types of io/parquet_schema.py, its length and ``PAR1``.

``compression``: ``none`` / ``uncompressed``, ``snappy`` (the default,
as in the JAX package), and ``gzip`` / ``zstd`` where the build links
zlib / libzstd (io/host_lib.py). A nested column (LIST, STRUCT, MAP)
is written in Arrow's and Spark's layout (io/parquet_nested.py's
``writer_elements``: every field OPTIONAL, three-level lists, a MAP's
``key_value`` group with a REQUIRED key), each leaf's repetition and
definition levels as RLE hybrid runs, a page never splitting a record;
its leaves carry no statistics.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .. import __version__
from ..columnar import dtypes as dt
from ..columnar.decimal128 import limbs_of_ints
from ..columnar.nested import HostList, HostStruct, lane_range
from ..columnar.vector import HostStrings
from ..plan.host_table import HostColumn, HostTable
from . import host_lib as HL
from . import parquet_schema as PS
from . import thrift as T

ROW_GROUP_ROWS = 1 << 20
PAGE_BYTES = 1 << 20
CREATED_BY = f"spark_rapids_tpu_torch version {__version__}"

#: compression option -> (host library codec, parquet.thrift codec)
COMPRESSION = {"none": (0, 0), "uncompressed": (0, 0), "snappy": (1, 1),
               "gzip": (2, 2), "zstd": (3, 6)}


def codec_of(compression: str) -> Tuple[int, int]:
    key = (compression or "snappy").lower()
    if key not in COMPRESSION:
        raise ValueError(f"parquet compression {compression!r}: one of "
                         f"{sorted(COMPRESSION)}")
    lib_codec, pq_codec = COMPRESSION[key]
    if not HL.lib().srt_codec_mask() >> lib_codec & 1:
        HL.check_rc(-4, "parquet writer", lib_codec)
    return lib_codec, pq_codec


def _strings(c: HostColumn) -> HostStrings:
    if isinstance(c.values, HostStrings):
        return c.values
    return HostStrings.from_objects([v if ok else None
                                     for v, ok in zip(c.values, c.mask)])


def _be_bytes(values, width: int) -> np.ndarray:
    """Unscaled ints (Python ints or int64) as big-endian two's
    complement rows of ``width`` bytes."""
    if isinstance(values, np.ndarray) and values.dtype != object:
        hi = np.where(values < 0, -1, 0).astype(np.int64)
        lo = values.astype(np.int64)
    else:
        hi, lo = limbs_of_ints(values)
    full = np.empty((len(lo), 16), np.uint8)
    full[:, :8] = hi.astype(">i8").view(np.uint8).reshape(-1, 8)
    full[:, 8:] = lo.view(np.uint64).astype(">u8").view(np.uint8) \
        .reshape(-1, 8)
    return np.ascontiguousarray(full[:, 16 - width:])


def _lane(c: HostColumn, el: T.SchemaElement):
    """(kind, values, elem, offsets) the encoder takes for a column."""
    t = c.dtype
    if t == dt.STRING:
        s = _strings(c)
        return 2, np.ascontiguousarray(s.chars), 0, \
            np.ascontiguousarray(s.offsets, np.int32)
    if t == dt.BOOL:
        return 0, np.ascontiguousarray(c.values, np.bool_).view(np.uint8), \
            1, None
    if el.type == T.FIXED_LEN_BYTE_ARRAY:
        return 1, _be_bytes(c.values, el.type_length), el.type_length, None
    np_t = {T.INT32: np.int32, T.INT64: np.int64, T.FLOAT: np.float32,
            T.DOUBLE: np.float64}[el.type]
    return 1, np.ascontiguousarray(np.asarray(c.values).astype(
        np_t, copy=False)), np.dtype(np_t).itemsize, None


def _statistics(c: HostColumn, el: T.SchemaElement, kind, values,
                offsets) -> T.Statistics:
    valid = c.mask
    n_valid = int(valid.sum())
    stats = T.Statistics(null_count=len(valid) - n_valid)
    if n_valid == 0:
        return stats
    if kind == 2:
        out = np.zeros(2, np.int64)
        HL.lib().srt_string_minmax(HL.ptr(offsets), HL.ptr(values),
                                   HL.ptr(valid.view(np.uint8)),
                                   len(valid), HL.ptr(out))
        lo, hi = (values[offsets[k]:offsets[k + 1]].tobytes() for k in out)
        stats.min_value, stats.max_value = lo, hi
        return stats
    if el.type == T.FIXED_LEN_BYTE_ARRAY:
        live = c.values[valid]
        mn, mx = min(live), max(live)
        stats.min_value = _be_bytes(np.array([mn], dtype=object),
                                    el.type_length).tobytes()
        stats.max_value = _be_bytes(np.array([mx], dtype=object),
                                    el.type_length).tobytes()
        return stats
    live = values[valid] if kind == 1 else values[valid].astype(bool)
    if el.type in (T.FLOAT, T.DOUBLE):
        live = live[~np.isnan(live)]
        if live.size == 0:
            return stats
        mn, mx = live.min(), live.max()
        # parquet's rule for signed zeros: a zero min is -0, a zero max +0
        mn = -abs(mn) if mn == 0 else mn
        mx = abs(mx) if mx == 0 else mx
    else:
        mn, mx = live.min(), live.max()
    fmt = {T.BOOLEAN: "<?", T.INT32: "<i", T.INT64: "<q", T.FLOAT: "<f",
           T.DOUBLE: "<d"}[el.type]
    stats.min_value = struct.pack(fmt, mn.item())
    stats.max_value = struct.pack(fmt, mx.item())
    return stats


def _encode_chunk(c: HostColumn, el: T.SchemaElement, codec: int,
                  page_bytes: int, levels=None):
    """(page bytes, uncompressed size, statistics) of one column chunk;
    ``levels`` = (def, rep, max_def, max_rep) for a nested leaf, whose
    ``c`` has a slot per level entry (statistics are not written for
    it)."""
    kind, values, elem, offsets = _lane(c, el)
    n = len(c.mask)
    valid = None if c.mask.all() else np.ascontiguousarray(
        c.mask).view(np.uint8)
    dl, rl, max_def, max_rep = levels if levels is not None else \
        (None, None, 1, 0)
    if kind == 2:
        raw = 4 * n + int(offsets[-1] - offsets[0])
    else:
        raw = n * elem if kind == 1 else n // 8 + 1
    pages = raw // page_bytes + 2
    cap = raw + raw // 5 + n // 8 + pages * 1200 + 4096
    info = np.zeros(2, np.int64)
    for _ in range(3):
        out = np.empty(cap, np.uint8)
        got = HL.lib().parquet_encode_chunk(
            kind, HL.ptr(values), elem, HL.ptr(offsets), HL.ptr(valid), n,
            max_def, codec, page_bytes, HL.ptr(out), cap, HL.ptr(info),
            HL.ptr(dl), HL.ptr(rl), max_rep)
        if got != -3:
            break
        cap *= 2
    HL.check_rc(got, f"parquet writer, column {el.name!r}", codec)
    stats = None if levels is not None else \
        _statistics(c, el, kind, values, offsets)
    return out[:got], int(info[0]), stats


def _slot_column(vals, present: np.ndarray, t: dt.DType) -> HostColumn:
    """A leaf's present values spread over its level entries (zero or
    empty where no value is present): the encoder's layout."""
    n = len(present)
    at = np.flatnonzero(present)
    if t == dt.STRING:
        s = vals if isinstance(vals, HostStrings) else \
            HostStrings.from_objects(list(vals))
        lens = np.zeros(n, np.int64)
        lens[at] = s.lengths()
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        lo = int(s.offsets[0]) if len(s.offsets) else 0
        chars = s.chars[lo:lo + int(offsets[-1])]
        return HostColumn(HostStrings(offsets.astype(np.int32), chars),
                          present, t)
    lane = np.zeros(n, dtype=object if dt.is_wide_decimal(t) else
                    np.asarray(vals).dtype)
    lane[at] = vals
    return HostColumn(lane, present, t)


def _nested_chunks(c: HostColumn, info: PS.ColumnInfo, paths, codec: int,
                   pq_codec: int, page_bytes: int):
    """[(data, ColumnMetaData without its offset)] for each leaf of a
    nested column, in leaf order."""
    from .parquet_nested import flat_lane, shred
    got = shred(info.node, flat_lane(c.values, c.mask, c.dtype), c.mask)
    out = []
    for leaf, path in zip(info.node.leaves(), paths):
        vals, dl, rl = got[leaf.chunk]
        present = dl == leaf.max_def
        col = _slot_column(vals, present, leaf.dtype)
        data, usize, _ = _encode_chunk(
            col, leaf.element, codec, page_bytes,
            (dl, rl if leaf.max_rep else None, leaf.max_def, leaf.max_rep))
        out.append((data, T.ColumnMetaData(
            type=leaf.element.type, encodings=[0, 3], path_in_schema=path,
            codec=pq_codec, num_values=len(dl),
            total_uncompressed_size=usize, total_compressed_size=len(data))))
    return out


def write_parquet_file(table: HostTable, path: str,
                       compression: str = "snappy",
                       row_group_rows: int = ROW_GROUP_ROWS,
                       page_bytes: int = PAGE_BYTES) -> int:
    """Write ``table`` to ``path``; returns the file's bytes."""
    from .parquet_nested import writer_elements
    codec, pq_codec = codec_of(compression)
    per_column = [writer_elements(n, c.dtype)
                  for n, c in zip(table.names, table.columns)]
    elements = [e for els, _ in per_column for e in els]
    root = T.SchemaElement(name="schema", num_children=len(per_column))
    infos = PS.file_columns(T.FileMetaData(schema=[root] + elements))
    groups: List[T.RowGroup] = []
    n = table.num_rows
    with open(path, "wb") as fh:
        fh.write(T.MAGIC)
        pos = len(T.MAGIC)
        for g, start in enumerate(range(0, n, row_group_rows)):
            part = table if (start == 0 and n <= row_group_rows) else \
                _rows(table, start, min(start + row_group_rows, n))
            rows = part.num_rows
            chunks, total_u, total_c, first = [], 0, 0, pos
            for (els, paths), info, c in zip(per_column, infos,
                                             part.columns):
                if info.node is not None:
                    encoded = _nested_chunks(c, info, paths, codec,
                                             pq_codec, page_bytes)
                else:
                    data, usize, stats = _encode_chunk(c, els[0], codec,
                                                       page_bytes)
                    encoded = [(data, T.ColumnMetaData(
                        type=els[0].type, encodings=[0, 3],
                        path_in_schema=paths[0], codec=pq_codec,
                        num_values=rows, total_uncompressed_size=usize,
                        total_compressed_size=len(data), statistics=stats))]
                for data, md in encoded:
                    fh.write(memoryview(data))
                    md.data_page_offset = pos
                    chunks.append(T.ColumnChunk(file_offset=pos,
                                                meta_data=md))
                    pos += len(data)
                    total_u += md.total_uncompressed_size
                    total_c += len(data)
            groups.append(T.RowGroup(columns=chunks, total_byte_size=total_u,
                                     num_rows=rows, file_offset=first,
                                     total_compressed_size=total_c,
                                     ordinal=g))
        meta = T.FileMetaData(
            version=2, schema=[root] + elements, num_rows=n,
            row_groups=groups, created_by=CREATED_BY,
            column_orders=[T.ColumnOrder(TYPE_ORDER=T.Empty())
                           for _, paths in per_column for _ in paths])
        tail = T.footer_bytes(meta)
        fh.write(tail)
        return pos + len(tail)


def _rows(table: HostTable, start: int, stop: int) -> HostTable:
    """Rows [start, stop) as views where the lane allows."""
    cols = []
    for c in table.columns:
        v = c.values
        if isinstance(v, HostStrings):
            v = HostStrings(v.offsets[start:stop + 1], v.chars)
        elif isinstance(v, (HostList, HostStruct)):
            v = lane_range(v, start, stop)
        else:
            v = v[start:stop]
        cols.append(HostColumn(v, c.mask[start:stop], c.dtype))
    return HostTable(cols, table.names)
