"""Streaming micro-batch ingestion with exactly-once Delta commits.

Counterpart of spark_rapids_tpu/delta/streaming.py. The
continuous-ingestion lane the integrity/fault/telemetry stack was
built for: an application appends micro-batches to an AcidTable, each
batch committed with an idempotent ``txn`` action carrying the app id
and the batch number. The protocol gives two crash guarantees:

- **Exactly-once resume.** A killed ingester restarts, reads
  ``txn_version(app_id)`` from the log, and re-enters the stream at
  the first uncommitted batch — batches that already landed are
  skipped without re-reading their source (the source contract is a
  replayable ``batch_fn(batch_id)``, Spark Structured Streaming's
  replayable-source requirement). Duplicated delivery is impossible
  because the batch's txn action commits atomically with its data.
- **Writer-epoch fencing.** Each ingester incarnation acquires an
  epoch by committing an epoch bump (the cluster-membership zombie-
  fencing pattern applied to the ingestion lane). A replaced
  incumbent — a zombie that lost a lease, a speculative duplicate —
  fails its next commit with ``StaleWriterEpoch`` before any data
  becomes visible, and the refusal is observable
  (``StaleWriterFenced`` event).

The module doubles as the crash harness's ingester child::

    python -m spark_rapids_tpu_torch.delta.streaming TABLE APP N_BATCHES \
        ROWS_PER_BATCH [--fault-plan SPEC] [--events-dir DIR] [--create] \
        [--device {cuda,cpu}]

A seeded ``crash`` clause at a Delta fault site kills it mid-ingest
(exit code 137); a relaunch resumes, and the table then holds each
batch exactly once and no orphan after ``vacuum``. The child runs on
the card unless ``--device cpu``; its parent starts it with
``subprocess`` (a parent holding a CUDA context must not fork).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, Optional

from .log import StaleWriterEpoch
from .table import AcidTable


class DeltaIngestor:
    """One writer incarnation for ``app_id`` over ``table``.

    Construction commits the epoch acquisition (fencing every earlier
    incarnation); ``ingest`` then appends micro-batches exactly-once.
    """

    def __init__(self, table: AcidTable, app_id: str):
        self.table = table
        self.app_id = app_id
        self.epoch = table.acquire_writer_epoch(app_id)

    def committed_batch(self) -> int:
        """Highest batch id this app has committed (-1 if none)."""
        return self.table.log.txn_version(self.app_id)

    def ingest(self, batch_fn: Callable[[int], object],
               num_batches: int,
               on_batch: Optional[Callable[[int, int], None]] = None
               ) -> Dict[str, int]:
        """Append batches ``0..num_batches-1``, resuming past the ones
        already in the log. ``batch_fn(b)`` must be replayable: asked
        again for the same ``b`` after a crash, it must produce the
        same logical rows. Returns {"committed", "skipped"}.
        Raises StaleWriterEpoch the moment a newer incarnation fences
        this one."""
        from ..obs import events as _events
        start = self.committed_batch() + 1
        if start > 0:
            _events.emit("StreamBatchSkipped", table=self.table.path,
                         appId=self.app_id, epoch=self.epoch,
                         resumeBatch=start, skipped=start)
        stats = {"committed": 0, "skipped": max(start, 0)}
        for b in range(start, num_batches):
            df = batch_fn(b)
            t0 = time.perf_counter()
            version = self.table.append(
                df, txn_app_id=self.app_id, txn_version=b,
                txn_epoch=self.epoch,
                operation=f"STREAMING UPDATE app={self.app_id};"
                          f"batch={b};")
            stats["committed"] += 1
            _events.emit("StreamBatchCommitted", table=self.table.path,
                         appId=self.app_id, epoch=self.epoch, batch=b,
                         version=version,
                         commit_ms=round(
                             (time.perf_counter() - t0) * 1e3, 3))
            if on_batch is not None:
                on_batch(b, version)
        return stats


def ingest(table: AcidTable, app_id: str,
           batch_fn: Callable[[int], object],
           num_batches: int) -> Dict[str, int]:
    """One-shot convenience: acquire an epoch and ingest the stream."""
    return DeltaIngestor(table, app_id).ingest(batch_fn, num_batches)


# --------------------------------------------------------------------------
# Deterministic demo stream — shared by the crash harness (parent
# asserts against the same closed-form totals the child ingested)
# --------------------------------------------------------------------------

def demo_schema():
    from ..columnar import dtypes as dt
    return [("id", dt.INT64), ("v", dt.FLOAT64)]


def demo_batch_table(batch: int, rows_per_batch: int):
    """Batch ``b`` = ids [b*R, (b+1)*R) with v = id * 0.5, as a host
    table: replayable and closed-form checkable (sum(v) = 0.25*N*(N-1)
    over N total; the JAX package's ``demo_batch_dict`` rows)."""
    import numpy as np

    from ..plan.host_table import HostColumn, HostTable
    ids = np.arange(batch * rows_per_batch, (batch + 1) * rows_per_batch,
                    dtype=np.int64)
    ok = np.ones(rows_per_batch, bool)
    (_, t_id), (_, t_v) = demo_schema()
    return HostTable([HostColumn(ids, ok, t_id),
                      HostColumn(ids * 0.5, ok, t_v)], ["id", "v"])


def demo_expected(num_batches: int, rows_per_batch: int
                  ) -> Dict[str, float]:
    n = num_batches * rows_per_batch
    return {"rows": n, "distinct_ids": n,
            "sum_v": 0.25 * n * (n - 1)}


def _child_main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="crash-harness ingester child")
    ap.add_argument("table")
    ap.add_argument("app_id")
    ap.add_argument("num_batches", type=int)
    ap.add_argument("rows_per_batch", type=int)
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--events-dir", default="")
    ap.add_argument("--create", action="store_true",
                    help="create the table if it does not exist")
    ap.add_argument("--no-durable", action="store_true")
    ap.add_argument("--checkpoint-interval", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..conf import SrtConf
    from ..obs import events as _events
    from ..plan.session import TpuSession
    from ..robustness import faults

    settings = {
        "srt.delta.durableCommits":
            "false" if args.no_durable else "true",
        "srt.delta.checkpointInterval": str(args.checkpoint_interval),
    }
    if args.events_dir:
        settings["srt.eventLog.enabled"] = "true"
        settings["srt.eventLog.dir"] = args.events_dir
    if args.fault_plan:
        settings["srt.test.faultPlan"] = args.fault_plan
    conf = SrtConf(settings)
    faults.arm_from_conf(conf)
    _events.configure_from_conf(conf)
    session = TpuSession(conf, device=args.device)

    if args.create and not os.path.isdir(
            os.path.join(args.table, "_delta_log")):
        table = AcidTable.create(session, args.table, demo_schema())
    else:
        table = AcidTable.for_path(session, args.table)

    def batch_fn(b):
        return session.create_dataframe(
            demo_batch_table(b, args.rows_per_batch))

    try:
        stats = DeltaIngestor(table, args.app_id).ingest(
            batch_fn, args.num_batches)
    except StaleWriterEpoch as e:
        print(f"[ingest-child] fenced: {e}", file=sys.stderr, flush=True)
        return 3
    print(f"[ingest-child] done: {stats}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
