"""Standard Delta Lake table format: log replay, reads, basic writes.

Counterpart of spark_rapids_tpu/io/delta_format.py (the delta-lake/
module family, SURVEY §2.6 component 68; GpuDeltaLog / GpuReadDeltaLog
on the read side) over the port's Parquet scan and writer. The engine's
own ACID layer (delta/) keeps its compact log for engine-managed
tables; THIS module speaks the interchange format other engines write:

- ``_delta_log/NNNNNNNNNNNNNNNNNNNN.json`` commits with protocol /
  metaData / add / remove actions, ``minReaderVersion`` at most 2,
- metaData.schemaString (Spark JSON schema) -> engine dtypes,
- add.partitionValues -> typed partition columns attached per file
  (Delta files do NOT contain partition columns),
- time travel by ``version_as_of``.

A ``_last_checkpoint`` names a ``NNN.checkpoint.parquet`` state
snapshot (or its parts), whose nested struct / map / list columns the
port's Parquet reader decodes (io/parquet_nested.py): the replay reads
its protocol, metaData, add and remove rows, then the later JSON
commits; a ``version_as_of`` before it replays the JSON commits, as the
JAX package does. ``write_checkpoint`` writes one through the port's
nested writer.

``write_delta_table`` emits the same format (protocol 1/2, metaData,
add actions with partitionValues), committed through the transaction
log's put-if-absent protocol (delta/log.py), so engine-written tables
are readable by Spark/delta-rs (no OPTIMIZE/vacuum writer parity).
"""

from __future__ import annotations

import json
import os
import random
import time
import uuid as _uuid
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

from ..columnar import dtypes as dt

LOG_DIR = "_delta_log"


class DeltaFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Spark JSON schema <-> engine dtypes
# ---------------------------------------------------------------------------

_PRIM = {
    "string": dt.STRING, "long": dt.INT64, "integer": dt.INT32,
    "short": dt.INT16, "byte": dt.INT8, "double": dt.FLOAT64,
    "float": dt.FLOAT32, "boolean": dt.BOOL, "date": dt.DATE,
    "timestamp": dt.TIMESTAMP, "binary": dt.STRING,
}


def spark_type_to_dtype(t) -> dt.DType:
    if isinstance(t, str):
        if t in _PRIM:
            return _PRIM[t]
        if t.startswith("decimal("):
            p, s = t[len("decimal("):-1].split(",")
            return dt.DecimalType(int(p), int(s))
        raise DeltaFormatError(f"spark type {t!r}")
    kind = t.get("type")
    if kind == "struct":
        return dt.StructType([(f["name"],
                               spark_type_to_dtype(f["type"]))
                              for f in t["fields"]])
    if kind == "array":
        return dt.ArrayType(spark_type_to_dtype(t["elementType"]))
    if kind == "map":
        return dt.MapType(spark_type_to_dtype(t["keyType"]),
                          spark_type_to_dtype(t["valueType"]))
    raise DeltaFormatError(f"spark type {t!r}")


def dtype_to_spark_type(t: dt.DType):
    for k, v in _PRIM.items():
        if v == t and k != "binary":
            return k
    if isinstance(t, dt.DecimalType):
        return f"decimal({t.precision},{t.scale})"
    if isinstance(t, dt.ArrayType):
        return {"type": "array",
                "elementType": dtype_to_spark_type(t.element_type),
                "containsNull": True}
    if isinstance(t, dt.StructType):
        return {"type": "struct", "fields": [
            {"name": n, "type": dtype_to_spark_type(ft),
             "nullable": True, "metadata": {}} for n, ft in t.fields]}
    raise DeltaFormatError(f"cannot encode {t}")


def schema_from_string(schema_string: str) -> List[Tuple[str, dt.DType]]:
    parsed = json.loads(schema_string)
    if parsed.get("type") != "struct":
        raise DeltaFormatError("schemaString must be a struct")
    return [(f["name"], spark_type_to_dtype(f["type"]))
            for f in parsed["fields"]]


def schema_to_string(schema) -> str:
    return json.dumps({"type": "struct", "fields": [
        {"name": n, "type": dtype_to_spark_type(t), "nullable": True,
         "metadata": {}} for n, t in schema]})


# ---------------------------------------------------------------------------
# log replay
# ---------------------------------------------------------------------------

def _commit_files(log_dir: str) -> List[Tuple[int, str]]:
    out = []
    for f in os.listdir(log_dir):
        if f.endswith(".json") and f[:-5].isdigit():
            out.append((int(f[:-5]), os.path.join(log_dir, f)))
    return sorted(out)


def _checkpoint_paths(log_dir: str, version: int, meta: dict) -> List[str]:
    """The files of the checkpoint at ``version``: one, or the ``parts``
    of a multi-part checkpoint."""
    parts = int(meta.get("parts") or 0)
    if parts > 1:
        return [os.path.join(log_dir, f"{version:020d}.checkpoint."
                             f"{i:010d}.{parts:010d}.parquet")
                for i in range(1, parts + 1)]
    return [os.path.join(log_dir, f"{version:020d}.checkpoint.parquet")]


def _read_checkpoint(log_dir: str, version_limit: Optional[int]):
    """(checkpoint_version, actions) from _last_checkpoint, if usable
    (the JAX package's reading, io/delta_format.py:116-135): the
    ``metaData``, ``add``, ``remove`` and ``protocol`` rows of the
    Parquet checkpoint, whose nested columns the port's reader decodes.
    A ``version_as_of`` before the checkpoint replays the JSON."""
    from .native_parquet import file_schema, iter_row_group_tables_native
    from ..plan.host_table import to_pydict
    lc = os.path.join(log_dir, "_last_checkpoint")
    if not os.path.exists(lc):
        return -1, []
    with open(lc) as f:
        meta = json.load(f)
    v = int(meta["version"])
    if version_limit is not None and v > version_limit:
        return -1, []  # time travel before the checkpoint: replay json
    paths = _checkpoint_paths(log_dir, v, meta)
    if not all(os.path.exists(p) for p in paths):
        return -1, []
    actions = []
    for path in paths:
        schema = [(n, t) for n, t in file_schema(path)
                  if n in CHECKPOINT_ACTIONS]
        for table in iter_row_group_tables_native(path, schema, {}, 1 << 20,
                                                  None):
            cols = to_pydict(table)
            for i in range(table.num_rows):
                for key in CHECKPOINT_ACTIONS:
                    if key in cols and cols[key][i] is not None:
                        actions.append({key: cols[key][i]})
    return v, actions


#: the actions a checkpoint's rows carry that the replay reads
CHECKPOINT_ACTIONS = ("protocol", "metaData", "add", "remove")
_S, _L, _B = dt.STRING, dt.INT64, dt.BOOL
_SMAP = dt.MapType(dt.STRING, dt.STRING)
#: Delta's checkpoint schema (PROTOCOL.md "Checkpoint Schema"), for the
#: actions ``write_checkpoint`` writes
CHECKPOINT_SCHEMA = [
    ("protocol", dt.StructType([("minReaderVersion", dt.INT32),
                                ("minWriterVersion", dt.INT32)])),
    ("metaData", dt.StructType([
        ("id", _S), ("name", _S), ("description", _S),
        ("format", dt.StructType([("provider", _S), ("options", _SMAP)])),
        ("schemaString", _S), ("partitionColumns", dt.ArrayType(_S)),
        ("configuration", _SMAP), ("createdTime", _L)])),
    ("add", dt.StructType([
        ("path", _S), ("partitionValues", _SMAP), ("size", _L),
        ("modificationTime", _L), ("dataChange", _B), ("stats", _S),
        ("tags", _SMAP)])),
    ("remove", dt.StructType([
        ("path", _S), ("deletionTimestamp", _L), ("dataChange", _B),
        ("extendedFileMetadata", _B), ("partitionValues", _SMAP),
        ("size", _L)])),
]


def write_checkpoint(root: str, version: Optional[int] = None) -> int:
    """Write the table's state at ``version`` (the head by default) as
    ``NNN.checkpoint.parquet`` in Delta's checkpoint schema, through the
    port's nested Parquet writer, and point ``_last_checkpoint`` at it;
    returns the version. One row per action: the protocol, the metaData
    and each live add file."""
    from ..plan.host_table import from_engine, from_pydict
    from .parquet_writer import write_parquet_file
    table = DeltaFormatTable(root, version)
    log_dir = os.path.join(root, LOG_DIR)
    rows = [{"protocol": table.protocol}, {"metaData": table.metadata}]
    rows += [{"add": a} for a in table.adds]
    data = {}
    for name, t in CHECKPOINT_SCHEMA:
        fields = t.field_names()
        data[name] = [None if r.get(name) is None else
                      {f: r[name].get(f) for f in fields} for r in rows]
    ht = from_engine(from_pydict(data, CHECKPOINT_SCHEMA))
    path = os.path.join(log_dir, f"{table.version:020d}.checkpoint.parquet")
    tmp = f"{path}.{os.getpid()}.tmp"
    write_parquet_file(ht, tmp)
    os.replace(tmp, path)
    last = os.path.join(log_dir, "_last_checkpoint")
    with open(f"{last}.{os.getpid()}.tmp", "w") as f:
        json.dump({"version": table.version, "size": len(rows)}, f)
    os.replace(f"{last}.{os.getpid()}.tmp", last)
    return table.version


class DeltaFormatTable:
    """Replayed table state at one version."""

    def __init__(self, root: str, version_as_of: Optional[int] = None):
        self.root = root
        log_dir = os.path.join(root, LOG_DIR)
        if not os.path.isdir(log_dir):
            raise FileNotFoundError(
                f"not a delta table: {root!r} has no {LOG_DIR}/")
        ckpt_version, actions = _read_checkpoint(log_dir, version_as_of)
        commits = [(v, p) for v, p in _commit_files(log_dir)
                   if v > ckpt_version and
                   (version_as_of is None or v <= version_as_of)]
        if version_as_of is not None and not commits and \
                ckpt_version < version_as_of and ckpt_version < 0:
            raise ValueError(f"version {version_as_of} not found")
        self.version = max([v for v, _ in commits], default=ckpt_version)
        for _v, p in commits:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        actions.append(json.loads(line))
        self.metadata: Optional[dict] = None
        self.protocol = {"minReaderVersion": 1, "minWriterVersion": 2}
        live: Dict[str, dict] = {}
        for a in actions:
            if "metaData" in a:
                self.metadata = a["metaData"]
            elif "add" in a:
                live[a["add"]["path"]] = a["add"]
            elif "remove" in a:
                live.pop(a["remove"]["path"], None)
            elif "protocol" in a:
                self.protocol = a["protocol"]
                mrv = a["protocol"].get("minReaderVersion", 1)
                if mrv > 2:
                    raise DeltaFormatError(
                        f"minReaderVersion {mrv} not supported (<=2); "
                        "table uses reader features beyond this engine")
        if self.metadata is None:
            raise DeltaFormatError("no metaData action in the log")
        self.adds = list(live.values())

    @property
    def schema(self) -> List[Tuple[str, dt.DType]]:
        return schema_from_string(self.metadata["schemaString"])

    @property
    def partition_columns(self) -> List[str]:
        return list(self.metadata.get("partitionColumns", []))

    def scan_info(self):
        """(paths, schema, (partition_schema, values_by_path)) for
        FileScan."""
        from urllib.parse import unquote
        schema = self.schema
        by_name = dict(schema)
        pschema = [(c, by_name[c]) for c in self.partition_columns]

        def typed(v, t):
            # partitionValues hold the values themselves (the path,
            # not they, is URI-encoded)
            if v is None:
                return None
            if t in (dt.INT8, dt.INT16, dt.INT32, dt.INT64):
                return int(v)
            if t in (dt.FLOAT32, dt.FLOAT64):
                return float(v)
            return v
        paths, by_path = [], {}
        for add in self.adds:
            p = os.path.join(self.root, unquote(add["path"]))
            paths.append(p)
            pv = add.get("partitionValues") or {}
            by_path[p] = {c: typed(pv.get(c), t) for c, t in pschema}
        return paths, schema, (pschema, by_path)


def read_delta(session, path: str,
               version_as_of: Optional[int] = None):
    """session.read.delta(): standard-format Delta table -> DataFrame."""
    table = DeltaFormatTable(path, version_as_of)
    paths, schema, partition_info = table.scan_info()
    if not paths:
        return session.create_dataframe({n: [] for n, _ in schema},
                                        schema)
    from ..plan.session import DataFrame
    from .scan import FileScan
    scan = FileScan(paths, "parquet", schema, partition_info=partition_info)
    # snapshot provenance: which Delta table, at which commit version
    # (the JAX package's serving result cache keys on it; ROADMAP A11)
    scan.delta_table = (os.path.abspath(path), table.version)
    return DataFrame(session, scan)


# ---------------------------------------------------------------------------
# standard-format writes
# ---------------------------------------------------------------------------

def write_delta_table(table, root: str,
                      partition_by: Optional[List[str]] = None,
                      mode: str = "error", conf=None) -> int:
    """HostTable -> a standard Delta commit (parquet files + JSON log
    actions). Returns the committed version. ``mode``: error | append |
    overwrite (overwrite emits remove actions for the live set it read).

    The files are written first; the commit then goes through the
    transaction log's put-if-absent protocol (delta/log.py: the commit
    file fsynced, linked with O_EXCL, the directory fsynced), and a
    writer that loses the race for a version rebuilds its actions over
    the new head and tries the next one. The commit adds only the files
    this write produced, each with the partition values its directory
    names (``scan.partition_dir``, read back exactly)."""
    from ..conf import (DELTA_CHECKPOINT_INTERVAL, DELTA_COMMIT_BACKOFF_MS,
                        DELTA_COMMIT_MAX_RETRIES, SrtConf)
    from ..delta.log import CommitConflict, TransactionLog
    from .scan import HIVE_NULL_PART, unescape_path_name
    from .writer import write_host_table
    if mode not in ("error", "append", "overwrite"):
        raise ValueError(f"delta save mode {mode!r}: error, append or "
                         "overwrite")
    base = conf if conf is not None else SrtConf()
    # the standard format keeps no engine checkpoint beside its commits
    log = TransactionLog(root, SrtConf(
        {**base._settings, DELTA_CHECKPOINT_INTERVAL.key: 0}))
    if mode == "error" and log.latest_version() >= 0:
        raise FileExistsError(f"delta table exists at {root!r}")
    written = write_host_table(table, root, "parquet",
                               partition_by=partition_by, mode="append")
    ts = int(time.time() * 1000)
    adds = []
    for full in sorted(written.files):
        rel = os.path.relpath(full, root)
        pvals = {}
        for seg in rel.split(os.sep)[:-1]:
            k, _, v = seg.partition("=")
            pvals[unescape_path_name(k)] = (
                None if v == HIVE_NULL_PART else unescape_path_name(v))
        adds.append({"add": {
            "path": quote(rel.replace(os.sep, "/"), safe="/="),
            "partitionValues": pvals, "size": os.path.getsize(full),
            "modificationTime": ts, "dataChange": True}})
    retries = int(base.get(DELTA_COMMIT_MAX_RETRIES))
    backoff_s = float(base.get(DELTA_COMMIT_BACKOFF_MS)) / 1e3
    for attempt in range(retries + 1):
        read_v = log.latest_version()
        if read_v >= 0 and mode == "error":
            raise FileExistsError(f"delta table exists at {root!r}")
        actions = []
        if read_v < 0:
            actions.append({"protocol": {"minReaderVersion": 1,
                                         "minWriterVersion": 2}})
            actions.append({"metaData": {
                "id": str(_uuid.uuid4()),
                "format": {"provider": "parquet", "options": {}},
                "schemaString": schema_to_string(table.schema()),
                "partitionColumns": list(partition_by or []),
                "configuration": {}, "createdTime": ts}})
        elif mode == "overwrite":
            actions.extend({"remove": {"path": rm["path"],
                                       "deletionTimestamp": ts,
                                       "dataChange": True}}
                           for rm in DeltaFormatTable(root, read_v).adds)
        try:
            return log.commit(read_v, actions + adds, "WRITE")
        except CommitConflict:
            if attempt == retries:
                raise
            time.sleep(backoff_s * min(2 ** attempt, 32) *
                       (0.5 + random.random()))
    raise AssertionError("unreachable")
