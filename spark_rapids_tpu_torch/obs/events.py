"""Structured JSONL event log, Spark-history-server style.

Counterpart of spark_rapids_tpu/obs/events.py, copied: one writer per
process appends one JSON object per line to ``events-<pid>.jsonl``
inside ``srt.eventLog.dir``, rotated at ``srt.eventLog.maxBytes``. In
this port the Delta layer emits to it (``DeltaCommit``,
``DeltaLogCheckpointed``, ``DeltaOrphanSwept``, ``StreamBatchCommitted``,
``StreamBatchSkipped``, ``StaleWriterFenced``), the fault plan
(``FaultInjected``) and the integrity layer (``CorruptionDetected``);
``read_all_events`` reads a directory back in write order, and the JAX
package's reader reads the same files.

Zero-overhead contract: ``emit()`` is a module-global ``is None``
check when no sink is installed, the same discipline as the unarmed
``fault_point`` sites. ``configure_from_conf`` mirrors
``faults.arm_from_conf``. Emission never breaks the engine: writer I/O
errors are swallowed (the event log is a best-effort flight recorder,
not a transaction log). Each line is flushed at once, so a ``crash``
fault (``os._exit``) still leaves its ``FaultInjected`` event on disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

# Known event types (informational; the log is schema-on-read).
EVENT_TYPES = (
    "QueryStart", "QueryEnd",
    "StageSubmitted", "StageCompleted",
    "TaskEnd",
    "SpillToHost", "SpillToDisk",
    "ShuffleWrite",
    "FetchFailed", "RetryAttempt",
    "FaultInjected", "CorruptionDetected",
    "WorkerEvicted",
    "ProgramCompiled", "RooflineSummary",
    "QueryAdmitted", "AdmissionQueued", "AdmissionRejected",
    "AdmissionAbandoned", "QueryCancelled", "DeadlineExceeded",
    "CrossQuerySpill", "PrefetchThreadLeak", "ClusterCancelBroadcast",
    "AdaptivePlanChanged", "SkewSplit", "SpeculativeTask",
    "WorkerDecommissioned", "BlockMigrated", "ZombieFenced",
    "ReplicaFetch", "RecoveryTimed",
    "DeltaCommit", "DeltaLogCheckpointed", "DeltaOrphanSwept",
    "StreamBatchCommitted", "StreamBatchSkipped", "StaleWriterFenced",
    "ServeSessionOpen", "ServeSessionClose", "ServeLoadShed",
    "ResultCacheHit", "ResultCacheMiss", "ResultCacheEvict",
    "ResultCacheInvalidate", "ResultCacheCorrupt",
)


class EventLogWriter:
    """Append-only JSONL sink. Thread-safe, flush-per-line, and
    silent on I/O failure — an event log must never take the query
    down with it.

    With ``max_bytes > 0`` (``srt.eventLog.maxBytes``) the file
    rotates once it exceeds the cap: the live file rolls to ``.1``,
    a previous ``.1`` to ``.2``, and an old ``.2`` is dropped —
    bounding a long-running/serving process to roughly three segments.
    Readers (``iter_log_files``) stitch ``.2``, ``.1``, live back in
    write order."""

    def __init__(self, log_dir: str, max_bytes: int = 0):
        self.log_dir = log_dir
        self.max_bytes = int(max_bytes or 0)
        self.path = os.path.join(log_dir, f"events-{os.getpid()}.jsonl")
        self._lock = threading.Lock()
        self._file = None
        self._size = 0
        self._broken = False

    def _rollover_locked(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        self._size = 0
        try:
            if os.path.exists(self.path + ".1"):
                os.replace(self.path + ".1", self.path + ".2")
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # keep appending to the oversized live file

    def emit(self, event: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"event": event, "ts": time.time(),
                               "pid": os.getpid()}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str)
        except Exception:
            return
        with self._lock:
            if self._broken:
                return
            try:
                if self._file is None:
                    os.makedirs(self.log_dir, exist_ok=True)
                    self._file = open(self.path, "a")
                    self._size = self._file.tell()
                self._file.write(line + "\n")
                self._file.flush()
                self._size += len(line) + 1
                if self.max_bytes and self._size > self.max_bytes:
                    self._rollover_locked()
            except OSError:
                self._broken = True

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# --- module-global sink (the zero-overhead guard) ---
_SINK: Optional[EventLogWriter] = None
# True when the installed sink came from configure_from_conf, so a
# later disabled conf only tears down what conf management installed
# (manually installed test sinks survive interleaved sessions).
_CONF_MANAGED = False


def enabled() -> bool:
    return _SINK is not None


def emit(event: str, **fields: Any) -> None:
    sink = _SINK
    if sink is None:
        return
    sink.emit(event, **fields)


def install(sink: Optional[EventLogWriter]) -> None:
    """Install (or clear, with None) the process-wide sink."""
    global _SINK, _CONF_MANAGED
    old = _SINK
    _SINK = sink
    _CONF_MANAGED = False
    if old is not None and old is not sink:
        old.close()


def configure_from_conf(conf) -> None:
    """Install / refresh the sink from a conf (the Delta ingester child
    calls it with its own), the same hand-off as
    ``faults.arm_from_conf``."""
    global _SINK, _CONF_MANAGED
    from ..conf import (EVENT_LOG_DIR, EVENT_LOG_ENABLED,
                        EVENT_LOG_MAX_BYTES)
    try:
        on = bool(conf.get(EVENT_LOG_ENABLED))
        log_dir = conf.get(EVENT_LOG_DIR) or ""
        max_bytes = int(conf.get(EVENT_LOG_MAX_BYTES) or 0)
    except Exception:
        return
    if on:
        log_dir = log_dir or os.path.join(".", "srt-events")
        if (_SINK is not None and _SINK.log_dir == log_dir
                and _SINK.max_bytes == max_bytes):
            return  # already pointed at the right place
        old = _SINK
        _SINK = EventLogWriter(log_dir, max_bytes=max_bytes)
        _CONF_MANAGED = True
        if old is not None:
            old.close()
    elif _CONF_MANAGED:
        old = _SINK
        _SINK = None
        _CONF_MANAGED = False
        if old is not None:
            old.close()


def log_dir() -> Optional[str]:
    sink = _SINK
    return sink.log_dir if sink is not None else None


# --- reading side ---
def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL file, skipping torn/garbage lines (a crashed
    writer may leave a partial final line)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "event" in rec:
                out.append(rec)
    return out


def _with_rolled(path: str) -> Iterator[str]:
    """Yield a log file's rolled segments oldest-first (``.2``, ``.1``)
    before the live file itself."""
    for suffix in (".2", ".1"):
        if os.path.exists(path + suffix):
            yield path + suffix
    if os.path.exists(path):
        yield path


def iter_log_files(path: str) -> Iterator[str]:
    """Yield event-log files under ``path`` (a file, or a dir holding
    ``events-*.jsonl`` from several processes), including rotation
    segments (``.2`` then ``.1`` then live, per process — write
    order)."""
    if os.path.isdir(path):
        # key on the BASE name so a process whose live file rolled
        # away (last emit crossed the cap, or crashed post-rollover)
        # still gets its .1/.2 segments read
        bases = set()
        for name in os.listdir(path):
            for suffix in (".jsonl", ".jsonl.1", ".jsonl.2"):
                if name.startswith("events-") and name.endswith(suffix):
                    bases.add(name[:len(name) - len(suffix)] + ".jsonl")
                    break
        for base in sorted(bases):
            yield from _with_rolled(os.path.join(path, base))
    else:
        yield from _with_rolled(path)


def read_all_events(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for f in iter_log_files(path):
        out.extend(read_events(f))
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out
