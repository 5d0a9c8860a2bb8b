"""Columnar writer: Parquet files, partitioned output, write statistics.

Counterpart of spark_rapids_tpu/io/writer.py (ColumnarOutputWriter.scala
+ GpuFileFormatDataWriter.scala + BasicColumnarWriteStatsTracker.scala)
for its Parquet and ORC lanes, written by the port's own encoders
(io/parquet_writer.py, io/orc_writer.py): a single directory or a
hive-style partitioned layout (``k=v`` subdirectories, names and values
escaped as Spark escapes them), the save modes error / overwrite /
append / ignore, and per-job statistics (files, rows, bytes,
partitions). Each file is written to a ``.tmp`` name and renamed, so a
writer killed mid-file leaves no truncated file under a final name. The
other formats of the JAX package's writer raise NotImplementedError
(ROADMAP A9).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.vector import HostStrings
from ..expr import timezone as TZ
from ..plan.host_table import HostColumn, HostTable, to_pydict
from .parquet_writer import ROW_GROUP_ROWS, write_parquet_file
from .scan import partition_dir


@dataclass
class WriteStats:
    """BasicColumnarWriteJobStatsTracker equivalent."""
    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    partitions: List[str] = field(default_factory=list)
    #: the files this write produced, full paths
    files: List[str] = field(default_factory=list)


MODES = ("error", "overwrite", "append", "ignore")


def _apply_write_rebase(table: HostTable, options: dict) -> HostTable:
    """datetimeRebaseModeInWrite: LEGACY converts pre-1582-10-15 lanes
    to the hybrid Julian calendar before encoding; EXCEPTION refuses
    them (datetimeRebaseUtils.scala, write side)."""
    mode = options.get("datetimeRebaseMode", "CORRECTED")
    if mode == "CORRECTED":
        return table
    cols = list(table.columns)
    for i, col in enumerate(cols):
        if isinstance(col.dtype, dt.DateType):
            if not ((col.values < TZ._GREGORIAN_CUTOVER_DAYS)
                    & col.mask).any():
                continue
            if mode == "EXCEPTION":
                raise ValueError(
                    f"column {table.names[i]!r} has dates before "
                    "1582-10-15; set datetimeRebaseModeInWrite to "
                    "LEGACY or CORRECTED")
            cols[i] = HostColumn(
                TZ.rebase_gregorian_to_julian_days(col.values)
                .astype(col.values.dtype), col.mask, col.dtype)
        elif isinstance(col.dtype, dt.TimestampType):
            if not ((col.values < TZ._CUTOVER_US) & col.mask).any():
                continue
            if mode == "EXCEPTION":
                raise ValueError(
                    f"column {table.names[i]!r} has timestamps before "
                    "1582-10-15; set datetimeRebaseModeInWrite to "
                    "LEGACY or CORRECTED")
            cols[i] = HostColumn(
                TZ.rebase_gregorian_to_julian_micros(col.values),
                col.mask, col.dtype)
    return HostTable(cols, list(table.names))


def write_file(table: HostTable, full: str, options: dict,
               fmt: str = "parquet") -> int:
    """One Parquet or ORC file through a ``.tmp`` name; returns its
    bytes."""
    tmp = f"{full}.{os.getpid()}.tmp"
    try:
        if fmt == "orc":
            from .orc_writer import STRIPE_ROWS, write_orc_file
            size = write_orc_file(
                table, tmp, options.get("compression", "snappy"),
                stripe_rows=int(options.get("stripeRows", STRIPE_ROWS)))
        else:
            size = write_parquet_file(
                table, tmp, options.get("compression", "snappy"),
                row_group_rows=int(options.get("rowGroupRows",
                                               ROW_GROUP_ROWS)))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    os.replace(tmp, full)
    return size


def write_host_table(table: HostTable, path: str, fmt: str = "parquet",
                     partition_by: Optional[List[str]] = None,
                     mode: str = "error",
                     options: Optional[dict] = None) -> WriteStats:
    """Write ``table`` under the directory ``path``."""
    if fmt not in ("parquet", "orc"):
        raise NotImplementedError(f"the {fmt} writer is not in this port "
                                  "yet (ROADMAP A9)")
    if mode not in MODES:
        raise ValueError(f"save mode {mode!r}: one of {MODES}")
    options = options or {}
    table = _apply_write_rebase(table, options)
    stats = WriteStats()
    exists = (bool(os.listdir(path)) if os.path.isdir(path)
              else os.path.exists(path))
    if exists:
        if mode == "error":
            raise FileExistsError(path)
        if mode == "ignore":
            return stats
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        # append: new files beside the old ones
    os.makedirs(path, exist_ok=True)
    job_id = uuid.uuid4().hex[:8]

    def emit(index: int, sub: HostTable, directory: str) -> int:
        os.makedirs(directory, exist_ok=True)
        full = os.path.join(directory, f"part-{index:05d}-{job_id}.{fmt}")
        size = write_file(sub, full, options, fmt)
        stats.files.append(full)
        return size

    def done(size: int, rows: int, label: str) -> None:
        stats.num_bytes += size
        stats.num_files += 1
        stats.num_rows += rows
        stats.partitions.append(label or ".")

    if not partition_by:
        done(emit(0, table, path), table.num_rows, "")
        return stats

    # hive-style dynamic partitioning (GpuDynamicPartitionDataWriter):
    # one file a partition, written on a pool (the encoder releases the
    # interpreter lock)
    part_idx = [table.names.index(c) for c in partition_by]
    data_idx = [i for i in range(len(table.names)) if i not in part_idx]
    part_names = [table.names[i] for i in part_idx]

    def one(index, key, rows):
        label = "/".join(partition_dir(c, v)
                         for c, v in zip(part_names, key))
        sub = HostTable([table.columns[i].take(rows) for i in data_idx],
                        [table.names[i] for i in data_idx])
        return emit(index, sub, os.path.join(path, label)), len(rows), label

    groups = _partition_groups(table, part_names)
    with cf.ThreadPoolExecutor(max(1, min(len(groups), 8))) as pool:
        for size, rows, label in pool.map(lambda g: one(g[0], *g[1]),
                                          enumerate(groups)):
            done(size, rows, label)
    return stats


def key_codes(c: HostColumn):
    """(codes, k): integer codes in [0, k) equal where the column's
    values are equal, -1 for a null; no Python object per row. Strings
    group by a 64-bit hash of their bytes and length, checked against
    the bytes (a collision falls back to sorting the bytes)."""
    v = c.values
    if c.dtype == dt.STRING:
        hs = v if isinstance(v, HostStrings) else HostStrings.from_objects(
            [s if ok else None for s, ok in zip(v, c.mask)])
        lens = hs.lengths().astype(np.int64)
        # the bytes zero-padded to whole 8-byte words, read as uint64
        width = max(-(-int(lens.max() if len(lens) else 0) // 8), 1) * 8
        mat = np.zeros((len(lens), width), np.uint8)
        mat[np.arange(width)[None, :] < lens[:, None]] = \
            hs.chars[hs.offsets[0]:hs.offsets[-1]]
        words = mat.view(np.uint64)
        h = lens.astype(np.uint64)
        for j in range(words.shape[1]):
            h = (h * np.uint64(1099511628211)) ^ words[:, j]
        _, first, inv = np.unique(h, return_index=True, return_inverse=True)
        inv = inv.reshape(-1)
        rep = first[inv]
        if not (np.array_equal(words, words[rep]) and
                np.array_equal(lens, lens[rep])):
            keyed = np.concatenate([mat, lens.astype(">u8").view(np.uint8)
                                    .reshape(-1, 8)], axis=1)
            _, inv = np.unique(keyed.view(f"V{width + 8}").reshape(-1),
                               return_inverse=True)
        k = int(inv.max()) + 1 if len(inv) else 0
    else:
        _, inv = np.unique(np.asarray(v), return_inverse=True)
        k = int(inv.max()) + 1 if len(inv) else 0
    return np.where(c.mask, inv.reshape(-1), -1).astype(np.int64), k


def _partition_groups(table: HostTable, part_names: List[str]):
    """[(key values, row indices)] per distinct partition key, in the
    order each key first appears (the JAX writer's order)."""
    key = np.zeros(table.num_rows, np.int64)
    span = 1
    for name in part_names:
        codes, k = key_codes(table.column(name))
        span *= k + 1
        if span >= 1 << 62:
            raise ValueError(f"partition_by {part_names}: more than 2^62 "
                             "key combinations")
        key = key * (k + 1) + codes + 1
    _, first, inverse = np.unique(key, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    rows = np.argsort(inverse, kind="stable")
    by_group = np.split(rows, np.cumsum(np.bincount(inverse))[:-1])
    keys = to_pydict(HostTable([table.column(n).take(first)
                                for n in part_names], part_names))
    return [(tuple(keys[n][g] for n in part_names), by_group[g])
            for g in np.argsort(first, kind="stable")]


class DataFrameWriter:
    """``df.write.mode(...).partition_by(...).option(...).parquet(path)``."""

    def __init__(self, df):
        self.df = df
        self._mode = "error"
        self._partition_by: Optional[List[str]] = None
        self._options: dict = {}

    def mode(self, m: str) -> "DataFrameWriter":
        if m not in MODES:
            raise ValueError(f"save mode {m!r}: one of {MODES}")
        self._mode = m
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def parquet(self, path: str) -> WriteStats:
        return self._write(path, "parquet")

    def orc(self, path: str) -> WriteStats:
        """ORC files (io/orc_writer.py), partitioned as ``parquet``; the
        options ``compression`` (none / zlib / snappy / zstd) and
        ``stripeRows``."""
        return self._write(path, "orc")

    def _write(self, path: str, fmt: str) -> WriteStats:
        from ..conf import PARQUET_REBASE_WRITE
        table = self.df.session.execute(self.df.plan)
        options = dict(self._options)
        options.setdefault("datetimeRebaseMode",
                           self.df.session.conf.get(PARQUET_REBASE_WRITE))
        return write_host_table(table, path, fmt, self._partition_by,
                                self._mode, options)

    def _not_ported(self, fmt: str):
        raise NotImplementedError(f"df.write.{fmt}: the {fmt} writer is not "
                                  "in this port yet (ROADMAP A9)")

    def csv(self, path):
        self._not_ported("csv")

    def json(self, path):
        self._not_ported("json")

    def avro(self, path):
        self._not_ported("avro")

    def delta(self, path: str) -> int:
        """Standard-format Delta Lake commit (io/delta_format.py);
        returns the committed version."""
        from .delta_format import write_delta_table
        table = self.df.session.execute(self.df.plan)
        return write_delta_table(table, path, self._partition_by,
                                 self._mode, self.df.session.conf)

    def hive_text(self, path):
        self._not_ported("hive_text")
