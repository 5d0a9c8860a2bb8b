"""ACID table format: transaction log + DML (the Delta Lake layer).

Counterpart of spark_rapids_tpu/delta/ (the reference's delta-lake/
integration, SURVEY §2.6: GpuOptimisticTransaction,
GpuMergeIntoCommand, GpuUpdateCommand, GpuDeleteCommand) as a
first-party table format over the port's own Parquet writer:

- an append-only ``_delta_log`` of JSON commit files; a snapshot is the
  fold of add/remove actions up to a version (time travel = fold to an
  older version),
- optimistic concurrency: commit N is an O_EXCL link of ``N.json`` —
  losers re-read, re-validate, retry,
- DML rewrites data files copy-on-write and commits add+remove pairs
  atomically.

Either package reads a table the other wrote.
"""

from .log import (CommitConflict, MetadataChangedConflict,
                  StaleWriterEpoch, TransactionLog,
                  sweep_stale_tmp_files)
from .table import AcidTable

__all__ = ["AcidTable", "TransactionLog", "CommitConflict",
           "MetadataChangedConflict", "StaleWriterEpoch",
           "DeltaIngestor", "sweep_stale_tmp_files"]


def __getattr__(name):
    # streaming pulls in the session layer; keep it import-lazy
    if name == "DeltaIngestor":
        from .streaming import DeltaIngestor
        return DeltaIngestor
    raise AttributeError(name)
