"""AcidTable: DML over the transaction log.

Counterpart of spark_rapids_tpu/delta/table.py (GpuMergeIntoCommand /
GpuUpdateCommand / GpuDeleteCommand, SURVEY §2.6). All DML is
copy-on-write: affected files are rewritten through the session (scan
-> filter / project / join on the device -> the port's Parquet writer)
and the log commits the add / remove pairs in one atomic version.

Two departures from the JAX package, neither visible in the log's
format: a commit's rows are split over files of at most
``ROWS_PER_FILE`` rows, encoded on a pool of writer threads, as adds of
the same commit (the JAX package writes one file a commit); and MERGE's
duplicate-key check runs in numpy over each key's value and validity
lanes (the JAX package asks pandas).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import random
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..expr.cast import Cast
from ..expr.conditional import If
from ..expr.core import Alias, Expression, col, lit
from ..expr.predicates import Not
from ..io.scan import FileScan
from ..io.writer import key_codes, write_file
from ..plan import logical as L
from ..plan.host_table import HostTable
from ..robustness.faults import fault_point
from .log import (_TMP_RE, CommitConflict, MetadataChangedConflict,
                  StaleWriterEpoch, TransactionLog, _pid_alive,
                  fsync_dir, fsync_file, sweep_stale_tmp_files)

#: rows a data file holds at most; a larger commit writes several files
ROWS_PER_FILE = 1 << 20
#: writer threads encoding one commit's files (the encoder releases the
#: interpreter lock)
WRITE_THREADS = 8

_DTYPE_TAGS = {"boolean": dt.BOOL, "tinyint": dt.INT8, "smallint": dt.INT16,
               "int": dt.INT32, "bigint": dt.INT64, "float": dt.FLOAT32,
               "double": dt.FLOAT64, "string": dt.STRING, "date": dt.DATE,
               "timestamp": dt.TIMESTAMP}


def _schema_to_json(schema) -> str:
    return json.dumps([[n, repr(t) if not isinstance(t, dt.DecimalType)
                        else f"decimal({t.precision},{t.scale})"]
                       for n, t in schema])


def _tag_dtype(tag: str) -> dt.DType:
    """A schemaString type tag (the JAX package's serializer tags)."""
    if tag.startswith("decimal("):
        p, s = tag[8:-1].split(",")
        return dt.DecimalType(int(p), int(s))
    if tag in _DTYPE_TAGS:
        return _DTYPE_TAGS[tag]
    raise ValueError(f"unknown dtype tag {tag!r}")


def _schema_from_json(s: str):
    return [(n, _tag_dtype(tag)) for n, tag in json.loads(s)]


def _cast_to(e: Expression, schema, t: dt.DType) -> Expression:
    return e if e.data_type(schema) == t else Cast(e, t)


def has_duplicate_rows(table: HostTable) -> bool:
    """Whether two rows of ``table`` are equal, comparing each column's
    value and validity: NULL equals NULL only, NaN equals NaN and
    neither is 0 (Spark's grouping of keys); strings by their bytes."""
    n = table.num_rows
    if n < 2:
        return False
    codes = []
    for c in table.columns:
        k, width = key_codes(c)
        codes.append((k, width + 1))
    key = np.zeros(n, np.int64)
    span = 1
    for k, width in codes:
        span *= width
        if span >= 1 << 62:
            # too many combinations for one int64: sort the code rows
            mat = np.stack([k for k, _ in codes])
            order = np.lexsort(mat[::-1])
            s = mat[:, order]
            return bool(np.any(np.all(s[:, 1:] == s[:, :-1], axis=0)))
        key = key * width + k + 1
    return len(np.unique(key)) < n


class _StagedWrite:
    """Data files written to ``<final>.<pid>.tmp`` names, promoted to
    their final paths by rename only at commit time. A crash before
    ``promote()`` leaves only tmp names (invisible to every reader,
    reclaimed by the stale-pid sweep); a crash between ``promote()``
    and the log commit leaves unreferenced final-named files, which
    VACUUM's orphan sweep reclaims behind the retention guard."""

    def __init__(self, durable: bool, detail: str = ""):
        self.pairs: List[Tuple[str, str]] = []   # (tmp, final)
        self.actions: List[dict] = []
        self.durable = durable
        self.detail = detail
        self.promoted = False

    def promote(self) -> None:
        if self.promoted:
            return
        parents = set()
        for tmp, final in self.pairs:
            fault_point("delta.rename",
                        f"{self.detail}file={os.path.basename(final)};")
            if self.durable:
                fsync_file(tmp)
            os.replace(tmp, final)
            parents.add(os.path.dirname(final))
        if self.durable:
            for d in parents:
                fsync_dir(d)
        self.promoted = True

    def discard(self) -> None:
        """Undo an uncommitted write: tmp names before promotion,
        final names after (the log never referenced either)."""
        for tmp, final in self.pairs:
            for p in ((final,) if self.promoted else (tmp,)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        self.pairs = []
        self.actions = []


class AcidTable:
    """A transactional Parquet table (DeltaTable API shape)."""

    def __init__(self, session, path: str):
        self.session = session
        self.path = path
        self.log = TransactionLog(path, conf=session.conf)
        # reclaim staging leftovers from committers killed mid-write
        # (the spill-dir stale-pid sweep, applied at catalog init)
        sweep_stale_tmp_files(path)
        sweep_stale_tmp_files(self.log.log_dir)

    # --- commit-protocol conf ---
    def _conf(self, entry):
        return self.session.conf.get(entry)

    def _retry_budget(self) -> Tuple[int, float]:
        from ..conf import DELTA_COMMIT_BACKOFF_MS, DELTA_COMMIT_MAX_RETRIES
        return (int(self._conf(DELTA_COMMIT_MAX_RETRIES)),
                float(self._conf(DELTA_COMMIT_BACKOFF_MS)) / 1e3)

    @staticmethod
    def _backoff(attempt: int, base_s: float) -> None:
        if base_s <= 0:
            return
        cap = min(base_s * (2 ** attempt), base_s * 32)
        time.sleep(cap * (0.5 + random.random()))

    # --- creation ---
    @classmethod
    def create(cls, session, path: str, schema) -> "AcidTable":
        t = cls(session, path)
        if t.log.exists():
            raise FileExistsError(f"table exists at {path}")
        os.makedirs(path, exist_ok=True)
        t.log.commit(-1, [{"metaData": {
            "schemaString": _schema_to_json(schema),
            "partitionColumns": [],
        }}], "CREATE TABLE")
        return t

    @classmethod
    def for_path(cls, session, path: str) -> "AcidTable":
        t = cls(session, path)
        if not t.log.exists():
            raise FileNotFoundError(f"no table at {path}")
        return t

    # --- reads ---
    def schema(self, version: Optional[int] = None):
        meta, _ = self.log.snapshot(version)
        return _schema_from_json(meta["schemaString"])

    def files(self, version: Optional[int] = None) -> List[str]:
        _, files = self.log.snapshot(version)
        return sorted(os.path.join(self.path, p) for p in files)

    def to_df(self, version: Optional[int] = None):
        """The table at ``version`` (default: the head); an older
        version is time travel."""
        from ..plan.session import DataFrame
        schema = self.schema(version)
        files = self.files(version)
        if not files:
            return self.session.create_dataframe(
                {n: [] for n, _ in schema}, schema)
        scan = FileScan(files, "parquet", schema)
        # snapshot provenance: which table, at which version (the JAX
        # package's serving result cache keys on it; ROADMAP A11)
        pinned = version if version is not None \
            else self.log.latest_version()
        scan.delta_table = (os.path.abspath(self.path), pinned)
        return DataFrame(self.session, scan)

    def version(self) -> int:
        return self.log.latest_version()

    def history(self) -> List[dict]:
        return self.log.history()

    # --- writes ---
    def _write_files(self, table: HostTable,
                     detail: str = "") -> _StagedWrite:
        """Stage the rows as Parquet files of at most ``ROWS_PER_FILE``
        rows, each as ``<final>.<pid>.tmp``; the add actions name the
        FINAL paths, which exist only after ``promote()`` renames them
        at commit time. The files of one commit share a name stem and
        sort in row order."""
        staged = _StagedWrite(self.log.durable, detail)
        n = table.num_rows
        if n == 0:
            return staged
        stem = f"part-{uuid.uuid4().hex[:12]}"
        starts = list(range(0, n, ROWS_PER_FILE))
        names = [f"{stem}.parquet" if len(starts) == 1 else
                 f"{stem}-{i:05d}.parquet" for i in range(len(starts))]
        for fname in names:
            full = os.path.join(self.path, fname)
            fault_point("delta.stage", f"{detail}file={fname};")
            staged.pairs.append((f"{full}.{os.getpid()}.tmp", full))

        def encode(i: int) -> None:
            part = table if len(starts) == 1 else \
                table.slice(starts[i], starts[i] + ROWS_PER_FILE)
            write_file(part, staged.pairs[i][0], {"compression": "snappy"})

        try:
            if len(starts) == 1:
                encode(0)
            else:
                with cf.ThreadPoolExecutor(
                        min(WRITE_THREADS, len(starts))) as pool:
                    list(pool.map(encode, range(len(starts))))
        except BaseException:
            staged.discard()
            raise
        for fname, start in zip(names, starts):
            staged.actions.append(
                {"add": {"path": fname,
                         "numRecords": min(ROWS_PER_FILE, n - start),
                         "dataChange": True}})
        return staged

    def _winner_actions(self, read_v: int) -> List[dict]:
        """All actions committed by OTHER writers after our snapshot."""
        out: List[dict] = []
        for v in self.log.versions():
            if v > read_v:
                out.extend(self.log.read_actions(v))
        return out

    def _check_conflict(self, read_v: int, operation: str) -> None:
        """The optimistic-concurrency conflict matrix
        (GpuOptimisticTransaction / Delta's ConflictChecker):

        - winner changed METADATA (schema evolution) -> abort: our
          actions were computed against the old schema
          (MetadataChangedException role),
        - winner only APPENDED -> safe to recompute/replay (appends
          never invalidate a read file set),
        - winner REMOVED files -> a rewrite recomputes from the new
          head (the retry loop re-reads), which preserves
          serializability because build_actions is a pure function of
          the current snapshot."""
        for a in self._winner_actions(read_v):
            if "metaData" in a:
                raise MetadataChangedConflict(
                    f"{operation}: a concurrent transaction changed "
                    "the table schema; re-run against the new schema")

    def _check_txn(self, txn, staged: Optional[_StagedWrite]
                   ) -> Optional[int]:
        """Idempotency + fencing gate, re-evaluated against the LIVE
        head on every commit attempt. Returns the head version when
        the batch already committed (exactly-once no-op); raises
        StaleWriterEpoch when a newer writer incarnation holds the
        table; None means proceed."""
        app_id, batch_version, epoch = txn
        state = self.log.txn_state(app_id)
        if epoch is not None and state["epoch"] != epoch:
            if staged is not None:
                staged.discard()
            from ..obs import events as _events
            _events.emit("StaleWriterFenced", table=self.path,
                         appId=app_id, writerEpoch=epoch,
                         currentEpoch=state["epoch"],
                         batch=batch_version)
            raise StaleWriterEpoch(
                f"writer epoch {epoch} for app {app_id!r} fenced by "
                f"epoch {state['epoch']} — a replaced incumbent must "
                "not commit")
        if batch_version is not None \
                and state["version"] >= batch_version:
            if staged is not None:
                staged.discard()
            return self.log.latest_version()
        return None

    @staticmethod
    def _txn_action(txn) -> List[dict]:
        app_id, batch_version, epoch = txn
        t: dict = {"appId": app_id,
                   "version": -1 if batch_version is None
                   else batch_version,
                   "lastUpdated": int(time.time() * 1000)}
        if epoch is not None:
            t["epoch"] = epoch
        return [{"txn": t}]

    def _commit_blind(self, staged: _StagedWrite, operation: str,
                      txn: Optional[Tuple] = None) -> int:
        """Snapshot-independent commits (append): retrying the same
        actions against a newer head is safe — unless the schema
        changed underneath. ``txn=(appId, batchVersion, epoch|None)``
        adds the idempotent-transaction action and its exactly-once /
        fencing checks; staged files are promoted by rename exactly
        once, immediately before the first commit attempt."""
        retries, backoff_s = self._retry_budget()
        actions = list(staged.actions)
        if txn is not None:
            actions += self._txn_action(txn)
        for attempt in range(retries + 1):
            read_v = self.log.latest_version()
            if txn is not None:
                done = self._check_txn(txn, staged)
                if done is not None:
                    return done
            staged.promote()
            try:
                return self.log.commit(read_v, actions, operation)
            except CommitConflict:
                self._check_conflict(read_v, operation)
                if attempt == retries:
                    staged.discard()
                    raise
                self._backoff(attempt, backoff_s)
        raise AssertionError("unreachable")

    def _commit_rewrite(self, build_actions, operation: str) -> int:
        """Copy-on-write commits: ``build_actions(read_version)`` must
        read the CURRENT snapshot and return ``(actions, staged)`` —
        on conflict the whole rewrite recomputes against the winner's
        table state (optimistic losers must not replay stale file
        sets) and the loser's uncommitted files are reclaimed."""
        retries, backoff_s = self._retry_budget()
        for attempt in range(retries + 1):
            read_v = self.log.latest_version()
            actions, staged = build_actions(read_v)
            staged.promote()
            try:
                return self.log.commit(read_v,
                                       actions + staged.actions,
                                       operation)
            except CommitConflict:
                staged.discard()
                self._check_conflict(read_v, operation)
                if attempt == retries:
                    raise
                self._backoff(attempt, backoff_s)
        raise AssertionError("unreachable")

    def _remove_all_current(self, read_v: int) -> List[dict]:
        _, files = self.log.snapshot(read_v)
        return [{"remove": {"path": p, "dataChange": True}}
                for p in files]

    def append(self, df, txn_app_id: Optional[str] = None,
               txn_version: Optional[int] = None,
               txn_epoch: Optional[int] = None,
               operation: str = "WRITE (append)") -> int:
        """Append ``df``. With ``txn_app_id``/``txn_version`` the
        commit is exactly-once: a retried/resumed writer whose batch
        already landed returns without writing (Delta's
        SetTransaction idempotency); ``txn_epoch`` additionally fences
        stale writer incarnations (StaleWriterEpoch)."""
        txn = detail = None
        if txn_app_id is not None:
            txn = (txn_app_id, txn_version, txn_epoch)
            detail = f"app={txn_app_id};batch={txn_version};"
            # resumed writer: skip even the plan execution when the
            # batch is already in the log
            done = self._check_txn(txn, None)
            if done is not None:
                return done
        table = self.session.execute(df.plan)
        staged = self._write_files(table, detail or "")
        return self._commit_blind(staged, operation, txn=txn)

    def acquire_writer_epoch(self, app_id: str) -> int:
        """Claim the streaming-writer role for ``app_id``: commits an
        epoch bump that fences every earlier incarnation (their next
        commit raises StaleWriterEpoch). Returns the new epoch."""
        retries, backoff_s = self._retry_budget()
        for attempt in range(retries + 1):
            read_v = self.log.latest_version()
            epoch = self.log.txn_epoch(app_id) + 1
            actions = self._txn_action((app_id, None, epoch))
            try:
                self.log.commit(read_v, actions,
                                f"STREAM EPOCH app={app_id};")
                return epoch
            except CommitConflict:
                self._check_conflict(read_v, "STREAM EPOCH")
                if attempt == retries:
                    raise
                self._backoff(attempt, backoff_s)
        raise AssertionError("unreachable")

    def overwrite(self, df) -> int:
        table = self.session.execute(df.plan)

        def build(read_v: int):
            return (self._remove_all_current(read_v),
                    self._write_files(table))
        return self._commit_rewrite(build, "WRITE (overwrite)")

    def delete(self, condition: Expression) -> int:
        """DELETE WHERE cond (GpuDeleteCommand): rewrite surviving rows."""

        def build(read_v: int):
            keep = self.to_df(version=read_v).filter(Not(condition))
            table = self.session.execute(keep.plan)
            return (self._remove_all_current(read_v),
                    self._write_files(table))
        return self._commit_rewrite(build, "DELETE")

    def update(self, set_exprs: Dict[str, Expression],
               condition: Optional[Expression] = None) -> int:
        """UPDATE SET col=expr [WHERE cond] (GpuUpdateCommand)."""
        cond = condition if condition is not None else lit(True)

        def build(read_v: int):
            df = self.to_df(version=read_v)
            projected = []
            for name, t in self.schema(read_v):
                if name in set_exprs:
                    e = If(cond, set_exprs[name], col(name))
                    projected.append(Alias(_cast_to(e, df.schema, t), name))
                else:
                    projected.append(col(name))
            table = self.session.execute(L.Project(df.plan, projected))
            return (self._remove_all_current(read_v),
                    self._write_files(table))
        return self._commit_rewrite(build, "UPDATE")

    def merge(self, source, on: Sequence[str],
              when_matched_update: Optional[Dict[str, Expression]] = None,
              when_matched_delete: bool = False,
              when_not_matched_insert: bool = True,
              schema_evolution: bool = False) -> int:
        """MERGE INTO target USING source ON target.k = source.k
        (GpuMergeIntoCommand shape):

        - matched + update: matched target rows take source-side values
          from ``when_matched_update`` ({target_col: expr over source
          columns prefixed 'src_'}),
        - matched + delete: matched target rows drop,
        - not matched + insert: source rows absent from the target
          insert (columns matched by name),
        - ``schema_evolution``: source columns missing from the target
          APPEND to the schema (delta.schema.autoMerge role,
          MergeIntoCommandMeta's canMergeSchema path); existing rows
          read NULL for the new columns and the commit carries the
          metaData update — which is exactly what aborts concurrent
          writers through the conflict matrix.
        """
        if when_matched_update and when_matched_delete:
            raise ValueError("update and delete are mutually exclusive")
        src_renamed = source.select(
            *[Alias(col(n), f"src_{n}") for n in source.columns])
        lk = [col(n) for n in on]
        rk = [col(f"src_{n}") for n in on]

        # Delta contract: a target row may match at most one source
        # row. Checked on the host over the keys' value and validity
        # lanes, so NULL stays distinct from NaN and from zero (Spark's
        # grouping of keys), without a group-by plan
        key_ht = self.session.execute(
            source.select(*[col(n) for n in on]).plan)
        if has_duplicate_rows(key_ht):
            raise ValueError(
                "MERGE: multiple source rows matched the same key")

        def build(read_v: int):
            target_df = self.to_df(version=read_v)
            schema = self.schema(read_v)
            meta_actions: List[dict] = []
            if schema_evolution:
                known = {n for n, _ in schema}
                new_cols = [(n, t) for n, t in source.schema
                            if n not in known]
                if new_cols:
                    schema = list(schema) + new_cols
                    meta_actions.append({"metaData": {
                        "schemaString": _schema_to_json(schema),
                        "partitionColumns": [],
                    }})
            else:
                extra = [n for n in source.columns
                         if n not in {s for s, _ in schema}]
                if extra:
                    raise ValueError(
                        f"MERGE source columns {extra} not in the "
                        "target schema (pass schema_evolution=True)")
            target_names = {n for n, _ in self.schema(read_v)}
            if when_matched_update and not when_matched_delete:
                joined = L.Join(target_df.plan, src_renamed.plan, lk, rk,
                                "inner")
                projected = []
                for name, t in schema:
                    default = col(name) if name in target_names \
                        else col(f"src_{name}")  # evolved col: source
                    e = when_matched_update.get(name, default)
                    projected.append(
                        Alias(_cast_to(e, joined.schema, t), name))
                matched_part = L.Project(joined, projected)
            else:
                matched_part = None  # matched rows vanish or stay

            if matched_part is None and not when_matched_delete:
                # no matched clause: EVERY target row survives
                # unchanged (insert-only merge)
                unmatched_target = target_df.plan
            else:
                # target rows with no source match survive unchanged
                unmatched_target = L.Join(target_df.plan,
                                          src_renamed.plan,
                                          lk, rk, "left_anti")
            if len(schema) > len(target_names):
                # evolved columns read NULL on surviving rows
                unmatched_target = L.Project(unmatched_target, [
                    col(n) if n in target_names else
                    Alias(lit(None, t), n) for n, t in schema])
            parts = [unmatched_target]
            if matched_part is not None:
                parts.append(matched_part)
            if when_not_matched_insert:
                unmatched_src = L.Join(
                    src_renamed.plan, target_df.plan, rk, lk, "left_anti")
                insert_cols = []
                src_cols = set(source.columns)
                for name, t in schema:
                    if name in src_cols:
                        e = _cast_to(col(f"src_{name}"),
                                     unmatched_src.schema, t)
                        insert_cols.append(Alias(e, name))
                    else:
                        insert_cols.append(Alias(lit(None, t), name))
                parts.append(L.Project(unmatched_src, insert_cols))
            plan = parts[0] if len(parts) == 1 else L.Union(*parts)
            table = self.session.execute(plan)
            return (meta_actions + self._remove_all_current(read_v),
                    self._write_files(table))
        return self._commit_rewrite(build, "MERGE")

    def optimize(self, zorder_by: Optional[Sequence[str]] = None) -> int:
        """OPTIMIZE [ZORDER BY cols]: rewrite the table in one commit,
        z-order-clustered when columns are given (delta-lake z-order
        optimize write, GpuOptimisticTransaction + ZOrderRules)."""
        from ..expr.bitwise import InterleaveBits

        def build(read_v: int):
            df = self.to_df(version=read_v)
            if zorder_by:
                df = df.sort(InterleaveBits(
                    *[col(c) for c in zorder_by]))
            table = self.session.execute(df.plan)
            return (self._remove_all_current(read_v),
                    self._write_files(table))
        return self._commit_rewrite(
            build, f"OPTIMIZE{' ZORDER' if zorder_by else ''}")

    def vacuum(self, retention_sec: Optional[float] = None) -> List[str]:
        """Reclaim dead bytes: data files the log has tombstoned
        (committed, then removed — always reclaimable), plus crash
        orphans the log never referenced — staged ``.tmp`` files and
        promoted-but-uncommitted data files. Orphans younger than
        ``retention_sec`` (default ``srt.delta.vacuum.retentionSec``)
        survive, because they may belong to a commit in flight;
        staging files whose owner pid is dead are swept regardless."""
        if retention_sec is None:
            from ..conf import DELTA_VACUUM_RETENTION_SEC
            retention_sec = float(self._conf(DELTA_VACUUM_RETENTION_SEC))
        _, files = self.log.snapshot()
        live = set(files)
        # every path any commit ever added: present-but-not-live means
        # tombstoned; never-referenced means a crash orphan
        referenced = set()
        for v in self.log.versions():
            for a in self.log.read_actions(v):
                if "add" in a:
                    referenced.add(a["add"]["path"])
        now = time.time()
        removed: List[str] = []
        orphans = 0
        for f in sorted(os.listdir(self.path)):
            full = os.path.join(self.path, f)
            if f in live or not os.path.isfile(full):
                continue
            m = _TMP_RE.search(f)
            if m is not None:
                pid = int(m.group(1))
                if pid != os.getpid() and not _pid_alive(pid):
                    pass          # dead stager: reclaim regardless of age
                elif self._age(full, now) < retention_sec:
                    continue      # possibly mid-commit: retention guard
                orphans += 1
            elif f.endswith(".parquet"):
                if f not in referenced \
                        and self._age(full, now) < retention_sec:
                    continue      # promoted, commit may be in flight
                if f not in referenced:
                    orphans += 1
            else:
                continue
            try:
                os.unlink(full)
                removed.append(f)
            except OSError:
                pass
        swept_log = sweep_stale_tmp_files(self.log.log_dir)
        removed.extend(swept_log)
        from ..obs import events as _events
        _events.emit("DeltaOrphanSwept", table=self.path,
                     removed=len(removed), orphans=orphans,
                     logTmps=len(swept_log),
                     retentionSec=retention_sec)
        return removed

    @staticmethod
    def _age(path: str, now: float) -> float:
        try:
            return now - os.path.getmtime(path)
        except OSError:
            return float("inf")   # gone already: no need to guard it
