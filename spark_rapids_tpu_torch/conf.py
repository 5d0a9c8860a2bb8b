"""Configuration: the keys the ported query path reads.

Counterpart of spark_rapids_tpu/conf.py, cut to the keys the ported
path reads, with the same names and defaults. Two TPU-only keys are not
carried: ``srt.sql.pallas.tileRows`` (the Pallas grid tile) and
``srt.exec.pallas.groupAgg.maxCapacity`` (a float32 count ceiling; the
port counts in float64).
"""

from __future__ import annotations

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


def _positive_int(v) -> int:
    n = int(v)
    if n <= 0:
        raise ValueError(f"expected a positive integer, got {v!r}")
    return n


_REGISTRY: Dict[str, ConfEntry] = {}


def _register(entry: ConfEntry) -> ConfEntry:
    _REGISTRY[entry.key] = entry
    return entry


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
