"""Parquet file -> host tables, without the Arrow library.

The port's counterpart of spark_rapids_tpu/io/native_parquet.py (the
GpuParquetScan.scala:2624 ``Table.readParquet`` role, host stage): the
footer is parsed by io/thrift.py, and every column chunk's raw bytes
decode in the host library (csrc/host/parquet_decode.cpp, bound in
io/host_lib.py) straight into numpy lanes, without the GIL, so the
reader pool decodes files in parallel while the consumer uploads
earlier ones. There is no per-column or per-file Arrow fallback: a
column outside the decoder's envelope (nested, INT96, a codec the build
lacks, an encoding it does not decode) raises, naming the column.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.vector import HostStrings
from ..plan.host_table import HostColumn, HostTable
from . import host_lib as HL
from . import parquet_schema as PS
from . import thrift as T

#: parquet.thrift CompressionCodec -> the host library's codec id
_CODECS = {0: 0, 1: 1, 2: 2, 6: 3}
#: the physical width of a fixed-width type (FLBA: its type_length)
_WIDTH = {T.BOOLEAN: 1, T.INT32: 4, T.INT64: 8, T.INT96: 12, T.FLOAT: 4,
          T.DOUBLE: 8}
_NP = {T.BOOLEAN: np.uint8, T.INT32: np.int32, T.INT64: np.int64,
       T.FLOAT: np.float32, T.DOUBLE: np.float64}


class ReadStats:
    """What one file's decode read and made (summed by the scan)."""
    __slots__ = ("bytes_read", "decoded_bytes", "decode_ns",
                 "row_groups_pruned")

    def __init__(self):
        self.bytes_read = 0
        self.decoded_bytes = 0
        self.decode_ns = 0
        self.row_groups_pruned = 0


#: parsed footers by (path, size, mtime): a scan of 229 files reads
#: each footer once per process, not once per query
_FOOTERS: Dict[tuple, Tuple[T.FileMetaData, List[PS.ColumnInfo]]] = {}
_FOOTERS_MAX = 1 << 14
_FOOTERS_LOCK = threading.Lock()


def footer(fh, path: str) -> Tuple[T.FileMetaData, List[PS.ColumnInfo]]:
    """An open file's footer and top-level columns."""
    st = os.fstat(fh.fileno())
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    got = _FOOTERS.get(key)
    if got is None:
        meta = T.read_footer(fh, path)
        got = (meta, PS.file_columns(meta))
        with _FOOTERS_LOCK:
            if len(_FOOTERS) >= _FOOTERS_MAX:
                _FOOTERS.clear()
            _FOOTERS[key] = got
    return got


def read_metadata(path: str) -> T.FileMetaData:
    with open(path, "rb") as fh:
        return footer(fh, path)[0]


def file_schema(path: str) -> List:
    """[(name, DType)] of a file's top-level columns; a column the port
    does not read raises NotImplementedError naming it."""
    with open(path, "rb") as fh:
        return [(c.name, c.require()) for c in footer(fh, path)[1]]


def _chunk_range(md: T.ColumnMetaData) -> Tuple[int, int]:
    offset = md.data_page_offset
    dpo = md.dictionary_page_offset
    if dpo is not None and 0 < dpo < offset:
        offset = dpo
    return offset, md.total_compressed_size


def _codec(md: T.ColumnMetaData, name: str) -> int:
    codec = _CODECS.get(md.codec)
    if codec is None:
        raise HL.CodecMissing(
            f"parquet column {name!r}: the "
            f"{T.CODECS[md.codec] if md.codec < len(T.CODECS) else md.codec}"
            " codec is not read by this port")
    return codec


def decode_column(fh, cc: T.ColumnChunk, info: PS.ColumnInfo, rows: int,
                  stats: Optional[ReadStats] = None
                  ) -> Tuple[object, np.ndarray]:
    """One flat column chunk -> (host lane, mask) of ``rows`` rows."""
    values, valid, _, _ = decode_leaf(fh, cc, info.element, info.require(),
                                      info.name, rows, info.max_def, 0,
                                      stats)
    return values, valid


def decode_leaf(fh, cc: T.ColumnChunk, el: T.SchemaElement, t: dt.DType,
                name: str, count: int, max_def: int, max_rep: int,
                stats: Optional[ReadStats] = None, levels: bool = False):
    """One leaf column chunk -> (host lane, valid, def levels, rep
    levels) of ``count`` level entries (rows, for a flat column). The
    levels come back for a nested column's leaf (``levels``, or any leaf
    with repetition or more than one definition level), else None. The
    lane has a slot per entry, zero where no value is present."""
    md = cc.meta_data
    codec = _codec(md, name)
    offset, length = _chunk_range(md)
    fh.seek(offset)
    raw = fh.read(length)
    if len(raw) != length:
        raise EOFError(f"parquet column {name!r}: chunk of {length} "
                       f"bytes at {offset} ends after {len(raw)}")
    chunk = np.frombuffer(raw, np.uint8)
    valid = np.empty(count, np.uint8)
    nested = levels or max_def > 1 or max_rep > 0
    dl = np.empty(count, np.uint8) if nested else None
    rl = np.empty(count, np.uint8) if nested else None
    scratch_len = max(2 * (md.total_uncompressed_size or 0), 1 << 16)
    what = f"parquet column {name!r}"
    if el.type == T.BYTE_ARRAY:
        offsets = np.zeros(count + 1, np.int32)
        cap = max(md.total_uncompressed_size or 0, 4 * count, 1 << 16)
        for _ in range(8):
            scratch = np.empty(scratch_len, np.uint8)
            out = np.empty(cap, np.uint8)
            got = HL.lib().parquet_decode_chunk_binary(
                HL.ptr(chunk), len(chunk), codec, count, max_def, max_rep,
                HL.ptr(offsets), HL.ptr(out), cap, HL.ptr(valid),
                HL.ptr(dl), HL.ptr(rl), HL.ptr(scratch), scratch_len)
            if got != -3 or cap >= 1 << 31:
                break
            # too little room for the strings or the dictionary
            cap = min(cap * 4, 1 << 31)
            scratch_len *= 2
        if HL.check_rc(got, what, codec) != count:
            raise ValueError(f"{what}: decoded {got} of {count} values")
        used = int(offsets[count])
        chars = out[:used].copy() if used * 5 < cap * 4 else out[:used]
        values = PS.var_decimal_lane(offsets, chars, t) \
            if isinstance(t, dt.DecimalType) else HostStrings(offsets, chars)
        nbytes = offsets.nbytes + used
    else:
        width = el.type_length if el.type == T.FIXED_LEN_BYTE_ARRAY \
            else _WIDTH.get(el.type)
        if not width:
            raise NotImplementedError(f"{what}: physical type "
                                      f"{T.TYPE_NAMES[el.type]}")
        lane = np.empty(count * width, np.uint8) \
            if el.type in (T.FIXED_LEN_BYTE_ARRAY, T.INT96) \
            else np.empty(count, _NP[el.type])
        for _ in range(4):
            scratch = np.empty(scratch_len, np.uint8)
            got = HL.lib().parquet_decode_chunk(
                HL.ptr(chunk), len(chunk), codec, el.type, width, count,
                max_def, max_rep, HL.ptr(lane), lane.nbytes, HL.ptr(valid),
                HL.ptr(dl), HL.ptr(rl), HL.ptr(scratch), scratch_len)
            if got != -3:
                break
            scratch_len *= 4   # a dictionary larger than the pages
        if HL.check_rc(got, what, codec) != count:
            raise ValueError(f"{what}: decoded {got} of {count} values")
        values = PS.to_host_lane(lane, el, t)
        nbytes = lane.nbytes
    if stats is not None:
        stats.bytes_read += length
        stats.decoded_bytes += nbytes + count
    return values, valid.view(np.bool_), dl, rl


def decode_nested(fh, rg: T.RowGroup, info: PS.ColumnInfo,
                  stats: Optional[ReadStats] = None):
    """A nested column's leaf chunks of one row group -> (host lane,
    mask) of its rows (io/parquet_nested.py assembles the levels)."""
    from .parquet_nested import assemble
    decoded = {}
    for leaf in info.node.leaves():
        cc = rg.columns[leaf.chunk]
        vals, _, dl, rl = decode_leaf(
            fh, cc, leaf.element, leaf.dtype, f"{info.name}.{leaf.name}",
            cc.meta_data.num_values, leaf.max_def, leaf.max_rep, stats,
            levels=True)
        decoded[leaf.chunk] = (vals, dl, rl)
    lane, mask = assemble(info.node, decoded)
    if len(mask) != rg.num_rows:
        raise ValueError(f"parquet column {info.name!r}: {len(mask)} rows "
                         f"assembled of {rg.num_rows}")
    return lane, mask


def _cast_lane(values, mask, file_t: dt.DType, want: dt.DType, name: str):
    """A file column under a declared type: the same type, or a widening
    the JAX package's conform casts (integers and floats to wider ones,
    a DECIMAL to one of the same scale and more digits)."""
    if file_t == want:
        return values
    if isinstance(want, dt.DecimalType) and isinstance(file_t,
                                                       dt.DecimalType):
        if want.scale == file_t.scale and want.precision >= file_t.precision:
            if want.is_wide and not file_t.is_wide:
                out = np.empty(len(values), dtype=object)
                out[:] = [int(v) for v in values]
                return out
            return values
    elif (want.is_integral or want.is_floating) and \
            (file_t.is_integral or file_t.is_floating) and \
            np.can_cast(file_t.np_physical, want.np_physical, "safe"):
        return values.astype(want.np_physical)
    raise ValueError(f"column {name}: file type {file_t} != declared {want}")


def iter_row_group_tables_native(
        path: str, schema, options: dict, max_rows: int,
        partition_values: Optional[dict],
        stats: Optional[ReadStats] = None) -> Iterator[HostTable]:
    """Host tables of at most ``max_rows`` rows, row group by row group,
    in the declared ``schema``: its columns by name (or by position
    where the file names differ, ``scan._conform``), partition columns
    as constants, each row group decoded column by column in the host
    library. A file with no row groups gives one empty table."""
    from .scan import _apply_read_rebase, _conform, partition_column
    part_values = partition_values or {}
    stats = stats if stats is not None else ReadStats()
    with open(path, "rb") as fh:
        meta, columns = footer(fh, path)
        plan = _conform(columns, schema, set(part_values))
        groups = meta.row_groups or []
        if not groups:
            yield _empty(schema)
            return
        keep = _row_group_filter(groups, plan, options)
        if not any(keep):
            stats.row_groups_pruned += len(groups)
            yield _empty(schema)
            return
        for rg, kept in zip(groups, keep):
            if not kept:
                stats.row_groups_pruned += 1
                continue
            rows = rg.num_rows
            t0 = time.perf_counter_ns()
            cols = []
            for name, want, info in plan:
                if info is None:
                    cols.append(partition_column(part_values.get(name),
                                                 want, rows))
                    continue
                if info.node is not None:
                    values, mask = decode_nested(fh, rg, info, stats)
                    if info.dtype != want:
                        raise ValueError(f"column {name}: file type "
                                         f"{info.dtype} != declared {want}")
                else:
                    values, mask = decode_column(fh, rg.columns[info.chunk],
                                                 info, rows, stats)
                    values = _cast_lane(values, mask, info.dtype, want,
                                        name)
                cols.append(HostColumn(values, mask, want))
            stats.decode_ns += time.perf_counter_ns() - t0
            ht = HostTable(cols, [n for n, _ in schema])
            _apply_read_rebase(ht, options)
            yield from split_rows(ht, max_rows)


def split_rows(ht: HostTable, max_rows: int) -> Iterator[HostTable]:
    """``ht`` in slices of at most ``max_rows`` rows."""
    if ht.num_rows <= max_rows:
        yield ht
        return
    for start in range(0, ht.num_rows, max_rows):
        yield ht.slice(start, start + max_rows)


def _row_group_filter(groups, plan, options) -> List[bool]:
    """Per row group, whether its statistics let a row pass the scan's
    translated filter (``options["_row_group_filter"]``,
    io/pruning.py)."""
    node = options.get("_row_group_filter")
    if node is None:
        return [True] * len(groups)
    from .pruning import column_stats, might_match
    infos = {name: info for name, _, info in plan if info is not None}
    types = {name: want for name, want, info in plan if info is not None}
    calendar_ok = options.get("datetimeRebaseMode",
                              "CORRECTED") == "CORRECTED"
    out = []
    for rg in groups:
        stats = {n: column_stats(rg.columns[i.chunk], i, rg.num_rows)
                 for n, i in infos.items()}
        out.append(might_match(node, stats, types, calendar_ok))
    return out


def _empty(schema) -> HostTable:
    cols = []
    for _, t in schema:
        if t == dt.STRING:
            values = HostStrings(np.zeros(1, np.int32), np.zeros(0, np.uint8))
        elif dt.is_wide_decimal(t):
            values = np.zeros(0, dtype=object)
        else:
            values = np.zeros(0, t.np_physical)
        cols.append(HostColumn(values, np.zeros(0, bool), t))
    return HostTable(cols, [n for n, _ in schema])
