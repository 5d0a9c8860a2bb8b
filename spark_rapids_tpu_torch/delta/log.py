"""Transaction log: ordered JSON commits with optimistic concurrency.

Counterpart of spark_rapids_tpu/delta/log.py, copied: the same files,
actions, fsyncs and O_EXCL arbitration, so either package reads a log
the other wrote. The GpuOptimisticTransaction equivalent (delta-lake/.../
GpuOptimisticTransaction.scala): writers prepare actions against a read
snapshot, then race to create the next numbered commit file with
O_CREAT|O_EXCL (the filesystem is the arbiter, like Delta's LogStore
contract). A loser whose read snapshot went stale raises
CommitConflict; idempotent retries re-validate against the new head.

Action vocabulary (one JSON object per line, Delta-style):
  {"metaData": {"schemaString": ..., "partitionColumns": [...]}}
  {"add":    {"path": ..., "numRecords": N, "dataChange": true}}
  {"remove": {"path": ..., "dataChange": true}}
  {"txn":    {"appId": ..., "version": N, "epoch": E}}
  {"commitInfo": {"operation": ..., "timestamp": ...}}

Crash consistency (the transactional commit protocol):

- **Durable commits** (``srt.delta.durableCommits``): the commit file
  is fsynced before the O_EXCL link makes it the version, and the log
  directory is fsynced after — a crash immediately after ``commit()``
  returns can never lose or tear the version.
- **Idempotent txn actions**: a ``{"txn": {appId, version}}`` action
  records the highest micro-batch version an application has
  committed; ``txn_version(appId)`` lets a retried/resumed writer skip
  batches that already landed (exactly-once, Delta's SetTransaction).
  The optional ``epoch`` field carries writer-incarnation fencing for
  streaming (delta/streaming.py).
- **Log checkpoints** (``srt.delta.checkpointInterval``): every N
  commits the folded state is compacted into ``NNN.checkpoint.json``
  and ``_last_checkpoint`` points at it with a crc32 — replay reads
  the checkpoint plus the commits after it instead of the whole log.
  A torn or corrupt checkpoint fails its crc and replay silently
  falls back to the full JSON log (a checkpoint is a cache, never the
  source of truth).
- **Tmp hygiene**: commit tmps are ``<name>.<pid>[-<seq>].tmp``; listings
  ignore them and ``sweep_stale_tmp_files`` reclaims ones whose owner
  pid is dead (the spill-dir stale-pid sweep, applied to the log).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..robustness.faults import corrupt_point, fault_point

LAST_CHECKPOINT = "_last_checkpoint"

# --- commit listeners ------------------------------------------------------
# Process-wide callbacks fired after every successful commit() with
# (table_path, version). The serving result cache, which registers here
# in the JAX package to drop results over a table's old snapshot, is
# not in this port yet (ROADMAP A11); listeners must never raise into
# the committer — a broken observer is not a failed commit.
_COMMIT_LISTENERS: List = []


def register_commit_listener(fn) -> None:
    """``fn(table_path: str, version: int)`` after each commit."""
    if fn not in _COMMIT_LISTENERS:
        _COMMIT_LISTENERS.append(fn)


def unregister_commit_listener(fn) -> None:
    try:
        _COMMIT_LISTENERS.remove(fn)
    except ValueError:
        pass


def _notify_commit(table_path: str, version: int) -> None:
    for fn in list(_COMMIT_LISTENERS):
        try:
            fn(table_path, version)
        except Exception:
            pass

#: per-process staging sequence: two threads racing the same commit
#: version must not share a tmp name (the loser's link would find the
#: winner already unlinked it)
_STAGE_SEQ = itertools.count()

#: ``<anything>.<pid>[-<seq>].tmp`` — the staging-name convention
#: shared by commit tmps (log dir) and staged data files (table dir);
#: the optional sequence disambiguates threads within one process
_TMP_RE = re.compile(r"\.(\d+)(?:-\d+)?\.tmp$")


class CommitConflict(RuntimeError):
    """Another writer committed the version this transaction targeted."""


class MetadataChangedConflict(CommitConflict):
    """A concurrent transaction changed the table metadata/schema —
    not retryable (Delta's MetadataChangedException role)."""


class StaleWriterEpoch(RuntimeError):
    """A newer incarnation of this streaming writer acquired the
    table; the fenced incumbent must not commit (delta/streaming.py
    writer-epoch fencing — the membership zombie-fencing pattern
    applied to the ingestion lane)."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists but not ours (EPERM etc.)
    return True


def sweep_stale_tmp_files(directory: str) -> List[str]:
    """Remove ``*.N.tmp`` files whose owning pid is dead (a committer
    or stager killed between staging and promotion), as the spill tier
    sweeps a dead process's directories. Returns swept names."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    swept = []
    for name in names:
        m = _TMP_RE.search(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(directory, name))
            swept.append(name)
        except OSError:
            pass
    return swept


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Persist a directory entry (the rename/link itself). Some
    filesystems refuse O_RDONLY fsync on directories — treat that as
    best-effort, like Delta's LogStore does."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class TransactionLog:
    def __init__(self, table_path: str, conf=None):
        self.table_path = table_path
        self.log_dir = os.path.join(table_path, "_delta_log")
        self._conf = conf

    def _get(self, entry):
        from ..conf import SrtConf
        conf = self._conf if self._conf is not None else SrtConf()
        return conf.get(entry)

    @property
    def durable(self) -> bool:
        from ..conf import DELTA_DURABLE_COMMITS
        return bool(self._get(DELTA_DURABLE_COMMITS))

    def exists(self) -> bool:
        return os.path.isdir(self.log_dir)

    # --- reading ---
    def versions(self) -> List[int]:
        if not self.exists():
            return []
        out = []
        for f in os.listdir(self.log_dir):
            # crashed committers leave NNN.json.<pid>.tmp; checkpoints
            # are NNN.checkpoint.json — neither is a commit version
            if not f.endswith(".json") or f.endswith(".checkpoint.json") \
                    or _TMP_RE.search(f):
                continue
            try:
                out.append(int(f[:-5]))
            except ValueError:
                pass
        return sorted(out)

    def latest_version(self) -> int:
        vs = self.versions()
        return vs[-1] if vs else -1

    def read_actions(self, version: int) -> List[dict]:
        path = os.path.join(self.log_dir, f"{version:020d}.json")
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    # --- checkpoint plumbing ---
    def _read_last_checkpoint(self) -> Optional[dict]:
        path = os.path.join(self.log_dir, LAST_CHECKPOINT)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(rec, dict) or "version" not in rec:
            return None
        return rec

    def _load_checkpoint(self, rec: dict) -> Optional[List[dict]]:
        """Read and crc-verify a checkpoint; None (full-replay
        fallback) on any mismatch or read failure."""
        path = os.path.join(self.log_dir,
                            f"{int(rec['version']):020d}.checkpoint.json")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        if "crc32" in rec and zlib.crc32(raw) != int(rec["crc32"]):
            from ..obs import events as _events
            _events.emit("CorruptionDetected", kind="delta_checkpoint",
                         path=path, version=int(rec["version"]))
            return None
        try:
            return [json.loads(line) for line in raw.decode().splitlines()
                    if line.strip()]
        except (ValueError, UnicodeDecodeError):
            from ..obs import events as _events
            _events.emit("CorruptionDetected", kind="delta_checkpoint",
                         path=path, version=int(rec["version"]))
            return None

    def checkpoint(self, version: Optional[int] = None) -> int:
        """Compact the folded state at ``version`` (default head) into
        ``NNN.checkpoint.json`` and atomically repoint
        ``_last_checkpoint``. Returns the checkpointed version."""
        v = self.latest_version() if version is None else version
        if v < 0:
            raise FileNotFoundError(f"no table at {self.table_path}")
        meta, files, txns = self._fold(v, use_checkpoint=False)
        actions: List[dict] = []
        if meta:
            actions.append({"metaData": meta})
        actions.extend({"add": a} for a in files.values())
        actions.extend({"txn": dict(t, appId=app)}
                       for app, t in sorted(txns.items()))
        payload = "".join(json.dumps(a) + "\n" for a in actions).encode()
        fault_point("delta.checkpoint", f"version={v};")
        payload = corrupt_point("delta.checkpoint.bytes", payload,
                                f"version={v};")
        path = os.path.join(self.log_dir, f"{v:020d}.checkpoint.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        rec = {"version": v, "size": len(actions),
               "crc32": zlib.crc32(payload)}
        ptr = os.path.join(self.log_dir, LAST_CHECKPOINT)
        ptr_tmp = f"{ptr}.{os.getpid()}.tmp"
        with open(ptr_tmp, "w") as f:
            json.dump(rec, f)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(ptr_tmp, ptr)
        if self.durable:
            fsync_dir(self.log_dir)
        from ..obs import events as _events
        _events.emit("DeltaLogCheckpointed", table=self.table_path,
                     version=v, actions=len(actions))
        return v

    def _fold(self, v: int, use_checkpoint: bool = True
              ) -> Tuple[dict, Dict[str, dict], Dict[str, dict]]:
        """Fold the log to (metadata, {path: add}, {appId: txn}) at
        version ``v``, starting from the newest usable checkpoint."""
        meta: dict = {}
        files: Dict[str, dict] = {}
        txns: Dict[str, dict] = {}
        start = 0
        if use_checkpoint:
            rec = self._read_last_checkpoint()
            # a checkpoint NEWER than the target version cannot seed a
            # time-travel read; fall back to full replay
            if rec is not None and int(rec["version"]) <= v:
                actions = self._load_checkpoint(rec)
                if actions is not None:
                    start = int(rec["version"]) + 1
                    for action in actions:
                        self._fold_action(action, meta, files, txns)
        for ver in self.versions():
            if ver < start:
                continue
            if ver > v:
                break
            for action in self.read_actions(ver):
                self._fold_action(action, meta, files, txns)
        return meta, files, txns

    @staticmethod
    def _fold_action(action: dict, meta: dict, files: Dict[str, dict],
                     txns: Dict[str, dict]) -> None:
        if "metaData" in action:
            meta.clear()
            meta.update(action["metaData"])
        elif "add" in action:
            files[action["add"]["path"]] = action["add"]
        elif "remove" in action:
            files.pop(action["remove"]["path"], None)
        elif "txn" in action:
            t = action["txn"]
            app = t.get("appId")
            cur = txns.setdefault(app, {"version": -1, "epoch": 0})
            # versions and epochs only ever advance (an epoch-acquire
            # commit carries version=-1; a fenced stale batch can
            # never regress either)
            cur["version"] = max(cur["version"],
                                 int(t.get("version", -1)))
            cur["epoch"] = max(cur["epoch"], int(t.get("epoch", 0)))

    def snapshot(self, version: Optional[int] = None
                 ) -> Tuple[dict, Dict[str, dict]]:
        """Fold the log to (metadata, {path: add_action}) at ``version``
        (default: head). Time travel = pass an older version."""
        head = self.latest_version()
        if head < 0:
            raise FileNotFoundError(f"no table at {self.table_path}")
        v = head if version is None else version
        if v > head:
            raise ValueError(f"version {v} > latest {head}")
        meta, files, _ = self._fold(v)
        return meta, files

    def txn_state(self, app_id: str) -> Dict[str, int]:
        """{"version": highest committed batch (-1 if none),
        "epoch": current writer epoch (0 if never acquired)}."""
        head = self.latest_version()
        if head < 0:
            return {"version": -1, "epoch": 0}
        _, _, txns = self._fold(head)
        return dict(txns.get(app_id, {"version": -1, "epoch": 0}))

    def txn_version(self, app_id: str) -> int:
        return self.txn_state(app_id)["version"]

    def txn_epoch(self, app_id: str) -> int:
        return self.txn_state(app_id)["epoch"]

    # --- writing ---
    def commit(self, read_version: int, actions: List[dict],
               operation: str) -> int:
        """Atomically commit as version read_version+1; CommitConflict
        if that version exists (optimistic loser). With
        ``srt.delta.durableCommits`` the commit file is fsynced before
        the link and the log dir after, so a returned version survives
        a machine crash."""
        os.makedirs(self.log_dir, exist_ok=True)
        version = read_version + 1
        payload = list(actions)
        payload.append({"commitInfo": {
            "operation": operation,
            "timestamp": int(time.time() * 1000),
            "readVersion": read_version,
        }})
        path = os.path.join(self.log_dir, f"{version:020d}.json")
        tmp = path + f".{os.getpid()}-{next(_STAGE_SEQ)}.tmp"
        fault_point("delta.commit", f"version={version};op={operation};")
        with open(tmp, "w") as f:
            for a in payload:
                f.write(json.dumps(a) + "\n")
            if self.durable:
                fault_point("delta.commit.fsync",
                            f"version={version};op={operation};")
                f.flush()
                os.fsync(f.fileno())
        try:
            # O_EXCL link: the filesystem arbitrates the race
            os.link(tmp, path)
        except FileExistsError:
            raise CommitConflict(
                f"version {version} already committed "
                f"(read snapshot {read_version} is stale)")
        finally:
            os.unlink(tmp)
        if self.durable:
            fsync_dir(self.log_dir)
        from ..obs import events as _events
        _events.emit("DeltaCommit", table=self.table_path,
                     version=version, operation=operation,
                     actions=len(payload))
        _notify_commit(self.table_path, version)
        self._maybe_checkpoint(version)
        return version

    def _maybe_checkpoint(self, version: int) -> None:
        from ..conf import DELTA_CHECKPOINT_INTERVAL
        interval = int(self._get(DELTA_CHECKPOINT_INTERVAL))
        if interval <= 0 or version <= 0 or version % interval != 0:
            return
        try:
            self.checkpoint(version)
        except OSError:
            pass  # a failed checkpoint is a lost optimization, not a
        #         lost commit — the JSON log remains the source of truth

    def history(self) -> List[dict]:
        out = []
        for v in self.versions():
            for a in self.read_actions(v):
                if "commitInfo" in a:
                    info = dict(a["commitInfo"])
                    info["version"] = v
                    out.append(info)
        return out
