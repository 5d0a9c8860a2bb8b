"""File scans: the FileScan logical node and FileSourceScanExec.

Counterpart of spark_rapids_tpu/io/scan.py (GpuParquetScan.scala /
GpuOrcScan.scala / GpuMultiFileReader.scala / GpuFileSourceScanExec.scala)
for Parquet and ORC: host threads decode files (io/native_parquet.py,
io/native_orc.py, the host library)
without holding the device semaphore, and decoded tables upload to the
card as batches, the semaphore held for the upload alone. The
reference's three reader types (``srt.sql.format.parquet.reader.type``)
are kept:

- PERFILE       one file at a time (each batch knows its file, for
                ``input_file_name()``);
- COALESCING    files concatenated into batches of at least
                ``srt.sql.reader.batchSizeRows`` rows before the upload;
                the port decodes the files on the reader pool, in
                submission order, as the reference's coalescing reader
                copies its blocks on host threads (the JAX package reads
                them one after another);
- MULTITHREADED the reader pool decodes whole files concurrently,
                tables flow in submission order, one batch per table.

A Filter above a scan is pushed into it (``pushed_filter``): its
conjuncts over partition columns prune files (``pruned_paths``,
``partitionsPruned``), and the rest prune row groups whose footer
statistics prove that no row passes (io/pruning.py,
``rowGroupsPruned``, under ``srt.sql.parquet.filterPushdown``). A
broadcast join installs a runtime partition filter
(``runtime_part_filter``, DPP: ``dppPrunedFiles``) before the scan's
first file opens. The Filter above the scan still runs.

A producer thread uploads the decoded tables, up to ``UPLOAD_AHEAD``
batches ahead of the operators above (the JAX package uploads in the
consumer). Metrics: ``scanTime`` (the uploads, as in the JAX package),
``scanDecodeTime`` (the decode, summed over the reader threads),
``scanBytesRead`` (column chunk bytes read from the files),
``scanDecodedBytes`` (the host lanes made), ``scanFiles``,
``partitionsPruned``, ``rowGroupsPruned`` and ``dppPrunedFiles``.
"""

from __future__ import annotations

import concurrent.futures as cf
import errno
import glob as globlib
import logging
import os
import queue
import struct as structlib
import threading
import time
from collections import deque
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnarBatch, HostStrings
from ..conf import (IGNORE_CORRUPT_FILES, IGNORE_MISSING_FILES,
                    MAX_READER_BATCH_SIZE_ROWS, PARQUET_FILTER_PUSHDOWN,
                    PARQUET_REBASE_READ, READER_THREADS, READER_TYPE,
                    SrtConf)
from ..exec.base import ExecContext, Metric, Schema, TpuExec
from ..expr import core as E
from ..expr import timezone as TZ
from ..plan.host_table import (HostColumn, HostTable, concat_tables,
                               table_to_batch)
from ..plan.logical import LogicalPlan
from ..robustness.faults import fault_point
from ..robustness.integrity import DataCorruption
from .native_parquet import (ReadStats, file_schema,
                             iter_row_group_tables_native)

logger = logging.getLogger("spark_rapids_tpu_torch.scan")

FORMATS = ("parquet", "orc")
#: batches the scan's producer thread uploads ahead of its consumer
UPLOAD_AHEAD = 2
_DONE = object()


def _roots(path_or_paths) -> List[str]:
    raw = ([path_or_paths] if isinstance(path_or_paths, str)
           else list(path_or_paths))
    return [p[len("file://"):] if p.startswith("file://") else p
            for p in raw]


def expand_paths(path_or_paths) -> List[str]:
    """Files under directories (``_`` / ``.`` names and ``.tmp`` staging
    leftovers skipped), glob matches, and plain paths."""
    out: List[str] = []
    for p in _roots(path_or_paths):
        if os.path.isdir(p):
            # skip _metadata/.hidden AND *.tmp staging leftovers from
            # writers killed between encode and rename (io/writer.py)
            for root, dirs, files in os.walk(p):
                dirs.sort()
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith(("_", "."))
                           and not f.endswith(".tmp"))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    return out


HIVE_NULL_PART = "__HIVE_DEFAULT_PARTITION__"
#: the characters Spark escapes in a partition directory's name as %XX
#: (ExternalCatalogUtils.charToEscape, less the Windows-only ones)
_PATH_ESCAPED = frozenset([chr(c) for c in range(1, 0x20)] +
                          list('"#%\'*/:=?\\\x7f{[]^'))


def escape_path_name(s: str) -> str:
    """ExternalCatalogUtils.escapePathName."""
    return "".join(f"%{ord(c):02X}" if c in _PATH_ESCAPED else c for c in s)


def unescape_path_name(s: str) -> str:
    """ExternalCatalogUtils.unescapePathName: each %XX of two hex
    digits back to its character, anything else kept."""
    if "%" not in s:
        return s
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "%" and i + 3 <= len(s) and \
                all(h in "0123456789abcdefABCDEF" for h in s[i + 1:i + 3]):
            out.append(chr(int(s[i + 1:i + 3], 16)))
            i += 3
        else:
            out.append(c)
            i += 1
    return "".join(out)


def partition_dir(name: str, value) -> str:
    """The ``name=value`` directory Spark writes for a partition value:
    NULL and '' as __HIVE_DEFAULT_PARTITION__, the rest escaped."""
    if isinstance(value, bool):
        value = "true" if value else "false"   # Spark's cast to string
    v = HIVE_NULL_PART if value is None or value == "" else \
        escape_path_name(str(value))
    return f"{escape_path_name(name)}={v}"


def discover_partitions(roots: List[str], files: List[str]):
    """Hive-style key=value directory partitioning (the reference reads
    these through Spark's PartitioningAwareFileIndex; partition columns
    surface as constant columns per file).

    Returns (partition_schema, per-file value dicts) with types inferred
    int64 -> float64 -> string like Spark's partition inference. Names
    and values are unescaped as Spark writes them (``partition_dir``).
    """
    values: List[dict] = []
    key_order: List[str] = []
    for f in files:
        root = next((r for r in roots
                     if f.startswith(r.rstrip(os.sep) + os.sep)), None)
        vals = {}
        if root is not None:
            rel = os.path.relpath(f, root)
            for seg in rel.split(os.sep)[:-1]:
                if "=" in seg:
                    k, _, v = seg.partition("=")
                    k = unescape_path_name(k)
                    vals[k] = None if v == HIVE_NULL_PART else \
                        unescape_path_name(v)
                    if k not in key_order:
                        key_order.append(k)
        values.append(vals)
    if not key_order:
        return [], values

    def infer(strs):
        present = [v for v in strs if v is not None]
        try:
            for v in present:
                int(v)
            return dt.INT64, int
        except ValueError:
            pass
        try:
            for v in present:
                float(v)
            return dt.FLOAT64, float
        except ValueError:
            return dt.STRING, str
    schema = []
    for k in key_order:
        col = [v.get(k) for v in values]
        t, conv = infer(col)
        for d in values:
            if k in d and d[k] is not None:
                d[k] = conv(d[k])
        schema.append((k, t))
    return schema, values


class FileScan(LogicalPlan):
    """Logical scan of Parquet or ORC files (GpuFileSourceScanExec
    meta). The schema is the first file's unless given, with the
    partition columns after it. ``partition_info`` = (partition schema,
    {path: {column: value}}) takes the place of the directory layout's
    partitions where a table format carries them in its metadata
    (Delta's ``partitionValues``). ``delta_table`` is (root, version) on a scan
    of a Delta snapshot, else None."""

    def __init__(self, paths, fmt: str = "parquet",
                 schema: Optional[List] = None,
                 options: Optional[dict] = None,
                 pushed_filter: Optional[E.Expression] = None,
                 partition_info=None):
        super().__init__()
        if fmt not in FORMATS:
            raise NotImplementedError(f"the {fmt} format is not read by "
                                      "this port (ROADMAP A9)")
        self.paths = expand_paths(paths)
        if not self.paths:
            raise FileNotFoundError(f"no files match {paths!r}")
        self.fmt = fmt
        self.options = dict(options or {})
        self.pushed_filter = pushed_filter
        self.delta_table = None
        if partition_info is not None:
            pschema, by_path = partition_info
            self.partition_schema = list(pschema)
            self._part_values = [dict(by_path.get(p, {}))
                                 for p in self.paths]
        else:
            self.partition_schema, self._part_values = \
                discover_partitions(_roots(paths), self.paths)
        if schema is None:
            schema = schema_of(self.paths[0], fmt)
            names = [n for n, _ in schema]
            schema = list(schema) + [(k, t) for k, t in
                                     self.partition_schema
                                     if k not in names]
        self._schema = list(schema)

    def partition_values_for(self, path: str) -> dict:
        try:
            return self._part_values[self.paths.index(path)]
        except (ValueError, IndexError):
            return {}

    def pruned_paths(self) -> List[str]:
        """Static partition pruning: pushed-filter conjuncts that
        reference ONLY partition columns evaluate per file on its
        partition values; files they reject never open (the
        PartitionPruning role)."""
        if self.pushed_filter is None or not self.partition_schema:
            return self.paths
        from ..expr import predicates as P
        from ..plan import cpu_eval
        part_names = {k for k, _ in self.partition_schema}

        def conjuncts(e):
            if isinstance(e, P.And):
                return conjuncts(e.children[0]) + conjuncts(e.children[1])
            return [e]

        applicable = [c for c in conjuncts(self.pushed_filter)
                      if c.references() and c.references() <= part_names]
        if not applicable:
            return self.paths
        keep = []
        for path, vals in zip(self.paths, self._part_values):
            cols, names = [], []
            for k, t in self.partition_schema:
                v = vals.get(k)
                mask = np.array([v is not None])
                if t == dt.STRING:
                    arr = np.array([v if v is not None else ""],
                                   dtype=object)
                else:
                    arr = np.array([v if v is not None else 0],
                                   dtype=t.np_physical)
                cols.append(HostColumn(arr, mask, t))
                names.append(k)
            row = HostTable(cols, names)
            ok = True
            for c in applicable:
                res = cpu_eval.evaluate(c, row)
                if not (len(res.values) and res.mask[0]
                        and bool(res.values[0])):
                    ok = False
                    break
            if ok:
                keep.append(path)
        return keep

    @property
    def schema(self) -> Schema:
        return self._schema

    def _copy(self) -> "FileScan":
        out = FileScan.__new__(FileScan)
        LogicalPlan.__init__(out)
        out._built_from = self._built_from
        out.paths, out.fmt = self.paths, self.fmt
        out.options = dict(self.options)
        out.pushed_filter = self.pushed_filter
        out._schema = list(self._schema)
        out.partition_schema = self.partition_schema
        out._part_values = self._part_values
        out.delta_table = self.delta_table
        return out

    def with_pushed_filter(self, f: Optional[E.Expression]) -> "FileScan":
        out = self._copy()
        out.pushed_filter = f
        return out

    def with_schema(self, keep: Schema) -> "FileScan":
        """Column-pruned copy (ColumnPruning: scans are shared across
        DataFrames, so the original stays intact)."""
        out = self._copy()
        out._schema = list(keep)
        return out

    def with_options(self, **kw) -> "FileScan":
        out = self._copy()
        out.options.update(kw)
        return out

    def with_children(self, children) -> "FileScan":
        return self

    def node_description(self) -> str:
        pushed = f", pushed={self.pushed_filter!r}" \
            if self.pushed_filter is not None else ""
        cols = ", ".join(n for n, _ in self._schema)
        return f"FileScan[{self.fmt}, {len(self.paths)} files, {cols}" \
            f"{pushed}]"


# ---------------------------------------------------------------------------
# host-side file reading (no device semaphore held)
# ---------------------------------------------------------------------------

#: error classes treated as "this file is corrupt" under
#: srt.sql.ignoreCorruptFiles (Spark catches IOException +
#: RuntimeException inside FilePartitionReader the same broad way):
#: checksum failures, truncated or garbled files (EOF, struct unpack),
#: decoder rejections (ValueError, the footer's ThriftError among them).
#: NotImplementedError (a column outside the port) is not among them.
_CORRUPT_ERRORS = (DataCorruption, OSError, EOFError, ValueError,
                   structlib.error)


def _is_missing_file_error(e: BaseException) -> bool:
    return isinstance(e, FileNotFoundError) or (
        isinstance(e, OSError) and e.errno == errno.ENOENT)


def iter_file_tables(path: str, fmt: str, schema: Schema, options: dict,
                     max_rows: int, conf: Optional[SrtConf] = None,
                     partition_values: Optional[dict] = None,
                     stats: Optional[ReadStats] = None
                     ) -> Iterator[HostTable]:
    """Path-naming wrapper over one file's decode: any decode error is
    re-raised with the failing file's path prepended (same exception
    type), the GpuMultiFileReader contract that a multi-file task
    failure names WHICH file broke.

    Also the per-file seam of Spark's lenient scans:
    ``srt.sql.ignoreMissingFiles`` skips files deleted between planning
    and read, ``srt.sql.ignoreCorruptFiles`` skips decode failures; both
    warn and keep the rows the file already yielded
    (FilePartitionReader.ignoreCorruptFiles). Both default to false:
    fail fast. ``conf`` is passed explicitly from pool threads."""
    cnf = conf or SrtConf()
    try:
        fault_point("scan.file", detail=path)
        yield from _named_file_tables(path, fmt, schema, options, max_rows,
                                      partition_values, stats)
    except Exception as e:
        if _is_missing_file_error(e):
            if cnf.get(IGNORE_MISSING_FILES):
                logger.warning(
                    "skipping missing file %s (srt.sql.ignoreMissingFiles"
                    "=true): %s", path, e)
                return
        elif isinstance(e, _CORRUPT_ERRORS):
            if cnf.get(IGNORE_CORRUPT_FILES):
                logger.warning(
                    "skipping corrupt file %s (srt.sql.ignoreCorruptFiles"
                    "=true): %s", path, e)
                return
        raise


def schema_of(path: str, fmt: str) -> List:
    """[(name, DType)] of a Parquet or ORC file's top-level columns."""
    if fmt == "orc":
        from .native_orc import file_schema as orc_schema
        return orc_schema(path)
    return file_schema(path)


def _named_file_tables(path: str, fmt: str, schema: Schema, options: dict,
                       max_rows: int, partition_values: Optional[dict],
                       stats: Optional[ReadStats]) -> Iterator[HostTable]:
    if fmt == "orc":
        from .native_orc import iter_stripe_tables as tables
    else:
        tables = iter_row_group_tables_native
    try:
        yield from tables(path, schema, options, max_rows, partition_values,
                          stats)
    except Exception as e:
        if path not in str(e):
            if isinstance(e, OSError):
                # OSError renders str() from errno/strerror/filename:
                # raise a same-type replacement (errno and filename kept)
                if e.errno is not None:
                    ne = type(e)(e.errno, f"while reading {fmt} file "
                                 f"{path}: {e.strerror or e}", e.filename)
                else:
                    ne = type(e)(f"while reading {fmt} file {path}: {e}")
                raise ne.with_traceback(e.__traceback__) from e
            head = str(e.args[0]) if e.args else str(e)
            e.args = (f"while reading {fmt} file {path}: {head}",
                      ) + tuple(e.args[1:])
        raise


def read_file_to_tables(path: str, fmt: str, schema: Schema, options: dict,
                        max_rows: int, conf: Optional[SrtConf] = None,
                        partition_values: Optional[dict] = None
                        ) -> Tuple[List[HostTable], ReadStats]:
    """The whole file's tables and what its decode read (the reader
    pool's unit of work)."""
    stats = ReadStats()
    return list(iter_file_tables(path, fmt, schema, options, max_rows,
                                 conf, partition_values, stats)), stats


def partition_column(v, t: dt.DType, rows: int) -> HostColumn:
    """A partition value as a constant host column (null for None)."""
    mask = np.full(rows, v is not None)
    if t == dt.STRING:
        raw = str(v).encode("utf-8") if v is not None else b""
        offsets = (np.arange(rows + 1, dtype=np.int64) * len(raw)) \
            .astype(np.int32)
        chars = np.frombuffer(raw * rows, np.uint8) if raw else \
            np.zeros(0, np.uint8)
        return HostColumn(HostStrings(offsets, chars), mask, t)
    if dt.is_wide_decimal(t):
        vals = np.empty(rows, dtype=object)
        vals[:] = int(v) if v is not None else 0
        return HostColumn(vals, mask, t)
    return HostColumn(np.full(rows, v if v is not None else 0,
                              dtype=t.np_physical), mask, t)


def _apply_read_rebase(ht: HostTable, options: dict) -> None:
    """datetimeRebaseModeInRead (datetimeRebaseUtils.scala): LEGACY
    rebases pre-1582-10-15 date / timestamp lanes from the hybrid Julian
    calendar the file was written with; EXCEPTION refuses them."""
    mode = options.get("datetimeRebaseMode", "CORRECTED")
    if mode == "CORRECTED":
        return
    for name, col in zip(ht.names, ht.columns):
        if isinstance(col.dtype, dt.DateType):
            old_mask = (col.values < TZ._GREGORIAN_CUTOVER_DAYS) & col.mask
            if not old_mask.any():
                continue
            if mode == "EXCEPTION":
                raise ValueError(
                    f"column {name!r} has dates before 1582-10-15; set "
                    "datetimeRebaseMode=LEGACY or CORRECTED "
                    "(spark.sql.parquet.datetimeRebaseModeInRead)")
            col.values = TZ.rebase_julian_to_gregorian_days(
                col.values).astype(col.values.dtype)
        elif isinstance(col.dtype, dt.TimestampType):
            old_mask = (col.values < TZ._CUTOVER_US) & col.mask
            if not old_mask.any():
                continue
            if mode == "EXCEPTION":
                raise ValueError(
                    f"column {name!r} has timestamps before 1582-10-15; "
                    "set datetimeRebaseMode=LEGACY or CORRECTED")
            col.values = TZ.rebase_julian_to_gregorian_micros(col.values)


def _conform(columns, schema: Schema, part_names) -> List[Tuple]:
    """The read-schema projection the reference's scans apply: each
    declared column as (name, declared type, the file's column: a
    Parquet ColumnInfo or an ORC OrcColumn), or (name, type, None) for
    a partition column. Declared names all in
    the file select by name; otherwise (a user schema renaming columns)
    the file's first columns map by position."""
    by_name = {c.name: c for c in columns}
    data = [(n, t) for n, t in schema if n not in part_names]
    if all(n in by_name for n, _ in data):
        picked = [by_name[n] for n, _ in data]
    else:
        if len(columns) < len(data):
            raise ValueError(f"file has {len(columns)} columns, schema "
                             f"declares {len(data)}")
        picked = columns[:len(data)]
    for c in picked:
        c.require()
    it = iter(picked)
    return [(n, t, None if n in part_names else next(it))
            for n, t in schema]


class _ScanTotals:
    """What the scan's files read and made, summed in the consumer
    thread."""

    def __init__(self):
        self.files = 0
        self.stats = ReadStats()

    def add(self, s: ReadStats) -> None:
        self.files += 1
        for k in ReadStats.__slots__:
            setattr(self.stats, k, getattr(self.stats, k) + getattr(s, k))


class FileSourceScanExec(TpuExec):
    """Leaf exec: decode files on host threads, upload to the card.

    reader type (``srt.sql.format.parquet.reader.type``, or the
    ``_reader_override`` option the planner sets for ``input_file_*``):
    PERFILE | COALESCING | MULTITHREADED
    """

    def __init__(self, scan: FileScan):
        super().__init__()
        self.scan = scan
        self._schema = scan.schema
        #: runtime dynamic partition pruning (GpuDynamicPruningExpression
        #: role): {partition column -> allowed values}, installed by a
        #: broadcast join after its build side materializes and before
        #: this scan's first file opens (exec/join.py)
        self.runtime_part_filter: Optional[dict] = None

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def reader_type(self, conf: SrtConf) -> str:
        return (self.scan.options.get("_reader_override")
                or conf.get(READER_TYPE)).upper()

    def _host_tables(self, ctx: ExecContext, totals: _ScanTotals
                     ) -> Iterator[Tuple[Optional[str], HostTable]]:
        conf = ctx.conf
        reader = self.reader_type(conf)
        max_rows = conf.get(MAX_READER_BATCH_SIZE_ROWS)
        # conf-driven per-read settings resolved here, once per scan
        options = dict(self.scan.options)
        options.setdefault("datetimeRebaseMode",
                           conf.get(PARQUET_REBASE_READ))
        if self.scan.pushed_filter is not None and \
                conf.get(PARQUET_FILTER_PUSHDOWN):
            from .pruning import translate
            options["_row_group_filter"] = translate(
                self.scan.pushed_filter,
                frozenset(k for k, _ in self.scan.partition_schema))
        args = (self.scan.fmt, self._schema, options, max_rows, conf)
        scan_paths = self.scan.pruned_paths()
        pruned = len(self.scan.paths) - len(scan_paths)
        if pruned:
            ctx.metric(self.exec_id, "partitionsPruned").add(pruned)
        if self.runtime_part_filter:
            before = len(scan_paths)
            scan_paths = [
                p for p in scan_paths
                if all(self.scan.partition_values_for(p).get(k) in vals
                       for k, vals in self.runtime_part_filter.items())]
            ctx.metric(self.exec_id, "dppPrunedFiles").add(
                before - len(scan_paths))

        def pv(p):
            return self.scan.partition_values_for(p)

        if reader in ("MULTITHREADED", "COALESCING") and len(scan_paths) > 1:
            threads = conf.get(READER_THREADS)
            with cf.ThreadPoolExecutor(max_workers=threads) as pool:
                # bounded in-flight window (2x threads) so decoded tables
                # don't pile up ahead of the consumer
                window = threads * 2
                pending = deque()
                paths = iter(scan_paths)
                for p in paths:
                    pending.append((p, pool.submit(read_file_to_tables, p,
                                                   *args, pv(p))))
                    if len(pending) >= window:
                        break
                held: List[HostTable] = []
                rows = 0
                while pending:
                    fp, fut = pending.popleft()
                    tables, stats = fut.result()  # submission order
                    totals.add(stats)
                    nxt = next(paths, None)
                    if nxt is not None:
                        pending.append((nxt, pool.submit(
                            read_file_to_tables, nxt, *args, pv(nxt))))
                    if reader == "MULTITHREADED":
                        for t in tables:
                            yield fp, t
                        continue
                    for t in tables:
                        held.append(t)
                        rows += t.num_rows
                        if rows >= max_rows:
                            yield None, concat_tables(held)
                            held, rows = [], 0
                if held:
                    yield None, concat_tables(held)
            return
        for p in scan_paths:
            stats = ReadStats()
            for t in iter_file_tables(p, *args, pv(p), stats):
                yield p, t
            totals.add(stats)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        """Batches in the readers' order. A producer thread pulls the
        decoded tables and uploads each (the semaphore held for the
        upload alone) up to UPLOAD_AHEAD batches ahead of the consumer,
        so decode, upload and the operators above overlap; an error in
        it is raised here."""
        from ..expr.misc import set_input_file
        scan_time = ctx.metric(self.exec_id, "scanTime", Metric.MODERATE,
                               "ns")
        totals = _ScanTotals()
        ready: queue.Queue = queue.Queue(maxsize=UPLOAD_AHEAD)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            tables = self._host_tables(ctx, totals)
            try:
                empty = True
                for path, table in tables:
                    if table.num_rows == 0 and not empty:
                        continue
                    empty = False
                    t0 = time.perf_counter_ns()
                    with ctx.semaphore:  # held only for the upload
                        batch = table_to_batch(table, device=ctx.device)
                    scan_time.add(time.perf_counter_ns() - t0)
                    if not put((path, batch)):
                        return
            except BaseException as e:  # raised again in the consumer
                put(e)
            finally:
                tables.close()
                put(_DONE)

        producer = threading.Thread(target=produce, daemon=True,
                                    name=f"{self.exec_id} upload")
        producer.start()
        sizes = {}
        try:
            while True:
                item = ready.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                path, batch = item
                # file context for input_file_name() / blocks: whole-file
                # reads report (0, file size); coalesced multi-file
                # batches have no single file (empty name, Spark's rule)
                if path is not None:
                    if path not in sizes:
                        sizes[path] = os.path.getsize(path)
                    set_input_file(path, 0, sizes[path])
                else:
                    set_input_file(None)
                yield batch
        finally:
            stop.set()
            producer.join()
            s = totals.stats
            for name, value, unit in (
                    ("scanFiles", totals.files, ""),
                    ("scanDecodeTime", s.decode_ns, "ns"),
                    ("scanBytesRead", s.bytes_read, ""),
                    ("scanDecodedBytes", s.decoded_bytes, ""),
                    ("rowGroupsPruned", s.row_groups_pruned, "")):
                ctx.metric(self.exec_id, name, Metric.MODERATE,
                           unit).add(value)

    def node_description(self) -> str:
        return "Tpu" + self.scan.node_description()
