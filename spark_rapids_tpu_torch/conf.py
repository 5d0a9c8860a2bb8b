"""Configuration: the keys the ported query path reads.

Counterpart of spark_rapids_tpu/conf.py, cut to the keys the ported
path reads, with the same names and defaults. The device pool
``srt.memory.tpu.poolSize`` keeps its TPU-era name; at 0 it is
``srt.memory.tpu.allocFraction`` of the free memory that
``torch.cuda.mem_get_info`` reports on the session's device when the
budget is first used. Two TPU-only keys are not carried: ``srt.sql.pallas.tileRows`` (the Pallas grid tile) and
``srt.exec.pallas.groupAgg.maxCapacity`` (a float32 count ceiling; the
port counts in float64). Nor is
``srt.sql.format.parquet.nativeDecode.enabled``: the port's Parquet
scan has only the native lane (io/native_parquet.py), no Arrow one.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional


class ConfEntry:
    """One registered configuration key."""

    def __init__(self, key: str, conv: Callable[[Any], Any], default: Any,
                 doc: str):
        self.key = key
        self.conv = conv
        self.default = default
        self.doc = doc

    def get(self, settings: Dict[str, Any]) -> Any:
        raw = settings.get(self.key)
        return self.default if raw is None else self.conv(raw)


def _bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() == "true"
    return bool(v)


def _fraction(v) -> float:
    f = float(v)
    if not 0.0 < f <= 1.0:
        raise ValueError(f"expected a fraction in (0, 1], got {v!r}")
    return f


def _non_negative_int(v) -> int:
    n = int(v)
    if n < 0:
        raise ValueError(f"expected an integer >= 0, got {v!r}")
    return n


def _one_of(*choices):
    def conv(v) -> str:
        s = str(v).upper()
        if s not in choices:
            raise ValueError(f"expected one of {choices}, got {v!r}")
        return s
    return conv


def _positive_int(v) -> int:
    n = int(v)
    if n <= 0:
        raise ValueError(f"expected a positive integer, got {v!r}")
    return n


def _non_negative_float(v) -> float:
    f = float(v)
    if f < 0:
        raise ValueError(f"expected a number >= 0, got {v!r}")
    return f


def _bytes(v) -> int:
    """'512m', '2g', '1024' -> bytes (>= 0), as the JAX package parses
    a byte size."""
    if isinstance(v, str):
        s = v.strip().lower()
        units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
                 "b": 1}
        n = (int(float(s[:-1]) * units[s[-1]]) if s and s[-1] in units
             else int(s))
    else:
        n = int(v)
    if n < 0:
        raise ValueError(f"expected a byte size >= 0, got {v!r}")
    return n


_REGISTRY: Dict[str, ConfEntry] = {}


def _register(entry: ConfEntry) -> ConfEntry:
    _REGISTRY[entry.key] = entry
    return entry


SQL_ENABLED = _register(ConfEntry(
    "srt.sql.enabled", _bool, True,
    "Run SQL operators on the device. When false every plan runs on "
    "the CPU engine (plan/cpu_exec.py). (spark.rapids.sql.enabled)"))

EXPLAIN = _register(ConfEntry(
    "srt.sql.explain", _one_of("NONE", "NOT_ON_TPU", "ALL"), "NONE",
    "Explain mode at planning: NONE, NOT_ON_TPU (print the operators "
    "that run on the CPU engine and why), ALL (print every operator "
    "with its mark). (spark.rapids.sql.explain)"))

OPTIMIZER_ENABLED = _register(ConfEntry(
    "srt.sql.optimizer.enabled", _bool, False,
    "Cost model (plan/cost.py): keep plan sections below its "
    "ROW_THRESHOLD on the CPU engine where device launch and transfer "
    "overheads dominate. Its weights are the JAX package's, not measured "
    "on the H100. (spark.rapids.sql.optimizer.enabled)"))

BATCH_SIZE_ROWS = _register(ConfEntry(
    "srt.sql.batchSizeRows", _positive_int, 1 << 20,
    "Target rows per columnar batch."))

PALLAS_ENABLED = _register(ConfEntry(
    "srt.sql.pallas.enabled", _bool, True,
    "Run eligible global filter+aggregate pipelines as one fused "
    "reduction kernel per batch (tile_reduce)."))

PALLAS_GROUPED_ENABLED = _register(ConfEntry(
    "srt.sql.pallas.groupedAgg.enabled", _bool, True,
    "Run eligible grouped sum/avg/count updates through the grouped "
    "reduction kernel (tile_group_reduce) for batches of <= 1024 groups."))

WINDOW_BATCHED_RUNNING = _register(ConfEntry(
    "srt.sql.window.batchedRunning.enabled", _bool, True,
    "Stream running-frame window functions (rank family, ROWS "
    "unbounded-preceding..current-row aggregates) batch-at-a-time over a "
    "sorted child with carried state instead of materializing whole "
    "partitions (GpuRunningWindowExec/BatchedRunningWindowFixer role)."))

BROADCAST_THRESHOLD_ROWS = _register(ConfEntry(
    "srt.sql.broadcastRowThreshold", _positive_int, 100_000,
    "Estimated build-side row count at or below which a join uses a "
    "broadcast hash join instead of a shuffled one."))

JOIN_SUB_PARTITION_ROWS = _register(ConfEntry(
    "srt.sql.join.subPartitionRows", _positive_int, 1 << 22,
    "Join build sides above this many rows are hash-split into "
    "sub-partitions and joined pair-wise, so the build working set "
    "stays bounded."))

JOIN_GROWTH_STEPS = _register(ConfEntry(
    "srt.sql.join.outputGrowthSteps", _positive_int, 4,
    "Max output-capacity regrowths for a join whose true match count "
    "overflows the estimate."))

JOIN_BLOOM_ENABLED = _register(ConfEntry(
    "srt.sql.join.bloomFilter.enabled", _bool, True,
    "Build a bloom filter over the materialized build side of inner "
    "hash joins and pre-filter probe batches with it."))

JOIN_BLOOM_MIN_PROBE_ROWS = _register(ConfEntry(
    "srt.sql.join.bloomFilter.minProbeRows", _positive_int, 4096,
    "Skip the bloom pre-filter for probe batches smaller than this."))

JOIN_BLOOM_BITS_PER_KEY = _register(ConfEntry(
    "srt.sql.join.bloomFilter.bitsPerKey", _positive_int, 10,
    "Bloom filter sizing: bits per build-side key (rounded up to a power "
    "of two, clamped to [2^10, 2^24] bits)."))


CONCURRENT_TASKS = _register(ConfEntry(
    "srt.sql.concurrentTpuTasks", _positive_int, 2,
    "Number of host threads allowed to submit device work "
    "concurrently (the device semaphore's permits)."))

DEVICE_MEMORY_LIMIT = _register(ConfEntry(
    "srt.memory.tpu.poolSize", _non_negative_int, 0,
    "Device budget in bytes for spillable batches; 0 derives it from the "
    "device (allocFraction of its free memory). Exceeding it spills "
    "and retries."))

DEVICE_MEMORY_FRACTION = _register(ConfEntry(
    "srt.memory.tpu.allocFraction", _fraction, 0.75,
    "Fraction of the device's free memory usable for batches when "
    "poolSize=0."))

HOST_SPILL_LIMIT = _register(ConfEntry(
    "srt.memory.host.spillStorageSize", _positive_int, 4 << 30,
    "Host memory for spilled buffers before overflowing to disk."))

SPILL_DIR = _register(ConfEntry(
    "srt.memory.spill.dir", str,
    os.path.join(tempfile.gettempdir(), "srt_spill"),
    "Directory for disk-tier spill files (one file per buffer, under a "
    "per-process session directory). The default is srt_spill in the "
    "temporary directory (TMPDIR), /tmp/srt_spill as in the JAX package "
    "when TMPDIR is unset."))

RETRY_MAX_SPLITS = _register(ConfEntry(
    "srt.memory.retry.maxSplits", _positive_int, 8,
    "Max recursive halvings of an input batch under split-and-retry "
    "before giving up."))

OOM_INJECTION_MODE = _register(ConfEntry(
    "srt.test.oomInjection.mode", _one_of("NONE", "RETRY", "SPLIT"),
    "NONE",
    "Test-only: fail the first allocation attempt of each query with a "
    "synthetic OOM (RmmSpark.forceRetryOOM analogue). NONE|RETRY|SPLIT"))

LEAK_DETECTION = _register(ConfEntry(
    "srt.memory.leakDetection.enabled", _bool, False,
    "Track the creation stack of every SpillableBatch and report entries "
    "still registered (a leaked spillable)."))

INTEGRITY_CHECKSUM = _register(ConfEntry(
    "srt.integrity.checksum.enabled", _bool, True,
    "Checksum spilled host and disk buffers and verify them when they "
    "return to the device; a mismatch raises DataCorruption."))

SORT_OOC_ROWS = _register(ConfEntry(
    "srt.sql.sort.oocRowBudget", _positive_int, 1 << 22,
    "Sort partitions whose total rows exceed this merge their spilled "
    "sorted runs with a bounded-memory k-way chunk merge instead of one "
    "full-size concat and sort."))

AGG_MERGE_PARTITION_ROWS = _register(ConfEntry(
    "srt.sql.agg.mergePartitionRows", _positive_int, 1 << 22,
    "Aggregate merges whose concatenated partial rows exceed this are "
    "re-partitioned by group-key hash and merged bucket by bucket."))

ANSI_ENABLED = _register(ConfEntry(
    "srt.sql.ansi.enabled", _bool, False,
    "ANSI mode: arithmetic overflow, division by zero and invalid casts "
    "raise instead of returning null or wrapping "
    "(spark.sql.ansi.enabled semantics; GpuCast.scala AnsiCast paths)."))

SESSION_TIMEZONE = _register(ConfEntry(
    "srt.sql.session.timeZone", str, "UTC",
    "Session time zone (spark.sql.session.timeZone): the field "
    "functions of a timestamp (hour, year, ...) read its wall clock "
    "there. A zone id is a fixed offset ('+08:00', 'GMT-3') or a name "
    "that zoneinfo resolves; an unknown name raises."))


READER_TYPE = _register(ConfEntry(
    "srt.sql.format.parquet.reader.type",
    _one_of("PERFILE", "COALESCING", "MULTITHREADED"), "COALESCING",
    "Parquet reader strategy: PERFILE, COALESCING, or MULTITHREADED "
    "(cloud). (spark.rapids.sql.format.parquet.reader.type, "
    "GpuParquetScan.scala:1862,2057)"))

READER_THREADS = _register(ConfEntry(
    "srt.sql.multiThreadedRead.numThreads", _positive_int, 8,
    "Host threads for the reader pool of the COALESCING and "
    "MULTITHREADED readers. "
    "(spark.rapids.sql.multiThreadedRead.numThreads)"))

MAX_READER_BATCH_SIZE_ROWS = _register(ConfEntry(
    "srt.sql.reader.batchSizeRows", _positive_int, 1 << 20,
    "Soft cap on rows per scan batch. "
    "(spark.rapids.sql.reader.batchSizeRows)"))

PARQUET_FILTER_PUSHDOWN = _register(ConfEntry(
    "srt.sql.parquet.filterPushdown", _bool, True,
    "Skip a Parquet row group whose footer statistics prove that no "
    "row passes the filter pushed into the scan (io/pruning.py; "
    "spark.sql.parquet.filterPushdown). The Filter above the scan "
    "still runs."))

DPP_ENABLED = _register(ConfEntry(
    "srt.sql.dpp.enabled", _bool, True,
    "Runtime dynamic partition pruning: when a broadcast join's probe "
    "side scans a partitioned table on a partition column, the "
    "materialized build side's distinct keys prune the scan's file "
    "list before any probe file opens (GpuSubqueryBroadcastExec / "
    "DynamicPruningExpression role; JAX conf.py:912)."))

PARQUET_REBASE_READ = _register(ConfEntry(
    "srt.sql.parquet.datetimeRebaseModeInRead",
    _one_of("CORRECTED", "LEGACY", "EXCEPTION"), "CORRECTED",
    "How to treat pre-1582-10-15 dates/timestamps in parquet "
    "reads: CORRECTED (as written, proleptic Gregorian), LEGACY "
    "(rebase from the hybrid Julian calendar), EXCEPTION (fail). "
    "(spark.sql.parquet.datetimeRebaseModeInRead, "
    "datetimeRebaseUtils.scala)"))

PARQUET_REBASE_WRITE = _register(ConfEntry(
    "srt.sql.parquet.datetimeRebaseModeInWrite",
    _one_of("CORRECTED", "LEGACY", "EXCEPTION"), "CORRECTED",
    "Calendar for pre-1582-10-15 dates/timestamps in parquet "
    "writes: CORRECTED, LEGACY (rebase to hybrid Julian), or "
    "EXCEPTION. (spark.sql.parquet.datetimeRebaseModeInWrite)"))

IGNORE_CORRUPT_FILES = _register(ConfEntry(
    "srt.sql.ignoreCorruptFiles", _bool, False,
    "Skip-and-warn instead of failing when a file is corrupt "
    "(unreadable, truncated, bad checksum) during a scan: "
    "Spark's spark.sql.files.ignoreCorruptFiles semantics: rows "
    "already decoded from the broken file are kept, the rest of "
    "the file is dropped with a warning. Default FAILFAST "
    "(raise)."))

IGNORE_MISSING_FILES = _register(ConfEntry(
    "srt.sql.ignoreMissingFiles", _bool, False,
    "Skip-and-warn instead of failing when a scan file has been "
    "deleted between planning and execution: Spark's "
    "spark.sql.files.ignoreMissingFiles semantics."))


DELTA_DURABLE_COMMITS = _register(ConfEntry(
    "srt.delta.durableCommits", _bool, True,
    "Crash-durable Delta commits: every transaction-log commit "
    "fsyncs the commit file and its parent directory (and every "
    "staged data file before its rename promotes it), so a "
    "machine crash immediately after commit() returns can never "
    "lose or tear the version. Disable only to A/B the fsync "
    "overhead (the ingest_rows_per_s bench lane measures it)."))

DELTA_COMMIT_MAX_RETRIES = _register(ConfEntry(
    "srt.delta.commit.maxRetries", _non_negative_int, 10,
    "How many times an optimistic Delta committer re-validates "
    "and retries after losing the O_EXCL race for its target "
    "version before surfacing CommitConflict."))

DELTA_COMMIT_BACKOFF_MS = _register(ConfEntry(
    "srt.delta.commit.backoffMs", _non_negative_int, 15,
    "Base backoff in milliseconds between Delta commit-conflict "
    "retries; grows exponentially per attempt with +-50% jitter, "
    "capped at 32x the base. 0 retries immediately."))

DELTA_CHECKPOINT_INTERVAL = _register(ConfEntry(
    "srt.delta.checkpointInterval", _non_negative_int, 10,
    "Write a compacted log checkpoint (NNN.checkpoint.json + "
    "_last_checkpoint pointer) every this many commits, bounding "
    "snapshot replay to the commits after the checkpoint. The "
    "checkpoint carries a crc32 — a torn/corrupt checkpoint is "
    "detected and replay falls back to the full JSON log. "
    "0 disables checkpointing."))

DELTA_VACUUM_RETENTION_SEC = _register(ConfEntry(
    "srt.delta.vacuum.retentionSec", _non_negative_float, 600.0,
    "VACUUM's retention guard for files the log has never "
    "referenced (crash orphans: staged .tmp files and promoted-"
    "but-uncommitted data files): younger files survive the "
    "sweep because they may belong to a commit in flight. "
    "Staging files whose owning pid is provably dead are swept "
    "regardless of age. Files tombstoned by a committed remove "
    "action are always reclaimable."))

EVENT_LOG_ENABLED = _register(ConfEntry(
    "srt.eventLog.enabled", _bool, False,
    "Write a structured JSONL event log (in this port: the Delta "
    "commits, checkpoints, orphan sweeps and stream batches, "
    "FaultInjected, CorruptionDetected) to srt.eventLog.dir, one "
    "events-<pid>.jsonl per process, Spark history-server role. Off by "
    "default: when disabled no event sink is instantiated and every "
    "emit site is a single None check (obs/events.py)."))

EVENT_LOG_DIR = _register(ConfEntry(
    "srt.eventLog.dir", str, "",
    "Directory for event-log files. Created on first emit; defaults to "
    "./srt-events when enabled without a dir (spark.eventLog.dir "
    "role)."))

EVENT_LOG_MAX_BYTES = _register(ConfEntry(
    "srt.eventLog.maxBytes", _bytes, 0,
    "Rotate events-<pid>.jsonl when it exceeds this many bytes: "
    "the live file rolls to .1 (and .1 to .2, which is dropped "
    "on the next roll), bounding a long-running process to about "
    "three segments of this size. 0 disables rotation. The reader "
    "(obs/events.py read_all_events) stitches rolled segments back in "
    "order (spark.eventLog.rolling role)."))

FAULT_PLAN_SPEC = _register(ConfEntry(
    "srt.test.faultPlan", str, "",
    "Fault-injection plan spec (robustness/faults.py grammar), armed in "
    "a process that calls faults.arm_from_conf with this conf (the "
    "Delta ingester child does). Empty disables injection."))


class SrtConf:
    """Immutable snapshot of settings, one per session."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        for k, v in self._settings.items():
            if k not in _REGISTRY:
                raise KeyError(f"unknown config {k!r}; registered: "
                               f"{sorted(_REGISTRY)}")
            _REGISTRY[k].conv(v)  # fail at set time, not mid-query

    def get(self, entry: ConfEntry):
        return entry.get(self._settings)

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS)

    @property
    def ansi(self) -> bool:
        return self.get(ANSI_ENABLED)
