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
snapshot, whose columns are nested structs and maps: the port's Parquet
reader does not decode those (ROADMAP A7.3), so a replay that needs the
checkpoint raises NotImplementedError, and a ``version_as_of`` before it
replays the JSON commits as the JAX package does.

``write_delta_table`` emits the same format (protocol 1/2, metaData,
add actions with partitionValues) so engine-written tables are readable
by Spark/delta-rs (no OPTIMIZE/vacuum writer parity).
"""

from __future__ import annotations

import json
import os
import uuid as _uuid
from typing import Dict, List, Optional, Tuple

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


def _read_checkpoint(log_dir: str, version_limit: Optional[int]):
    """(checkpoint_version, actions) from _last_checkpoint, if usable;
    a checkpoint the replay needs raises (ROADMAP A7.3)."""
    lc = os.path.join(log_dir, "_last_checkpoint")
    if not os.path.exists(lc):
        return -1, []
    with open(lc) as f:
        meta = json.load(f)
    v = int(meta["version"])
    if version_limit is not None and v > version_limit:
        return -1, []  # time travel before the checkpoint: replay json
    path = os.path.join(log_dir, f"{v:020d}.checkpoint.parquet")
    if not os.path.exists(path):
        return -1, []
    raise NotImplementedError(
        f"delta table {os.path.dirname(log_dir)!r}: replay needs the "
        f"Parquet checkpoint {os.path.basename(path)}, whose nested "
        "columns this port does not read yet (ROADMAP A7.3)")


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
        live: Dict[str, dict] = {}
        for a in actions:
            if "metaData" in a:
                self.metadata = a["metaData"]
            elif "add" in a:
                live[a["add"]["path"]] = a["add"]
            elif "remove" in a:
                live.pop(a["remove"]["path"], None)
            elif "protocol" in a:
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
            if v is None:
                return None
            v = unquote(v)
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
                      mode: str = "error") -> int:
    """HostTable -> a standard Delta commit (parquet files + JSON log
    actions). Returns the committed version. ``mode``: error | append |
    overwrite (overwrite emits remove actions for the previous live
    set)."""
    from .writer import write_host_table
    if mode not in ("error", "append", "overwrite"):
        raise ValueError(f"delta save mode {mode!r}: error, append or "
                         "overwrite")
    log_dir = os.path.join(root, LOG_DIR)
    exists = os.path.isdir(log_dir) and _commit_files(log_dir)
    if exists and mode == "error":
        raise FileExistsError(f"delta table exists at {root!r}")
    os.makedirs(log_dir, exist_ok=True)
    version = (max(v for v, _ in _commit_files(log_dir)) + 1
               if exists else 0)
    prev_adds = (DeltaFormatTable(root).adds
                 if exists and mode == "overwrite" else [])

    before = set()
    for dirpath, _dirs, files in os.walk(root):
        if LOG_DIR in dirpath:
            continue
        for f in files:
            before.add(os.path.join(dirpath, f))
    write_host_table(table, root, "parquet",
                     partition_by=partition_by, mode="append")
    actions = []
    import time as _time
    ts = int(_time.time() * 1000)
    if version == 0:
        actions.append({"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}})
        actions.append({"metaData": {
            "id": str(_uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": schema_to_string(table.schema()),
            "partitionColumns": list(partition_by or []),
            "configuration": {}, "createdTime": ts}})
    for rm in prev_adds:
        actions.append({"remove": {"path": rm["path"],
                                   "deletionTimestamp": ts,
                                   "dataChange": True}})
    for dirpath, _dirs, files in os.walk(root):
        if LOG_DIR in dirpath:
            continue
        for f in sorted(files):
            full = os.path.join(dirpath, f)
            if full in before:
                continue
            rel = os.path.relpath(full, root)
            pvals = {}
            for seg in rel.split(os.sep)[:-1]:
                if "=" in seg:
                    k, _, v = seg.partition("=")
                    pvals[k] = (None if v == "__HIVE_DEFAULT_PARTITION__"
                                else v)
            actions.append({"add": {
                "path": rel.replace(os.sep, "/"),
                "partitionValues": pvals,
                "size": os.path.getsize(full),
                "modificationTime": ts, "dataChange": True}})
    commit = os.path.join(log_dir, f"{version:020d}.json")
    with open(commit, "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
    # standard-format writes bypass TransactionLog.commit, so feed the
    # commit listeners here too
    from ..delta.log import _notify_commit
    _notify_commit(root, version)
    return version
