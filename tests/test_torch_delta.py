"""The port's Delta layer (spark_rapids_tpu_torch/delta/) held against the
JAX package's: the same operations through both packages' ``AcidTable``
in separate directories, compared at every version (rows and the
operations of ``history()``), and the commit protocol's guarantees
(txn replay, OCC conflicts and retries, checkpoints, writer fencing,
exactly-once resume, VACUUM's guard, the fsyncs of a durable commit)
checked in both. Cross-reads: each package opens a table the other
wrote. The crash sites of the JAX package's tests/test_delta_txn.py
kill one child of the port each (``--device cpu``), and the resume runs
in this process. The JAX side runs its CPU engine
(``srt.sql.enabled=false``) under ``patch_jax_compiles`` (C1); the port
runs its device path on CPU tensors.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from jax_reference import patch_jax_compiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: pid guaranteed dead (pid_max on Linux caps below 2**22 by default)
DEAD_PID = 99999999


class Pkg:
    """One package's Delta-facing names; ``port`` tells which."""

    def __init__(self, root: str):
        def m(sub):
            return importlib.import_module(f"{root}.{sub}")
        self.port = root == "spark_rapids_tpu_torch"
        self.dt = m("columnar.dtypes")
        core = m("expr.core")
        self.col, self.lit = core.col, core.lit
        self.SrtConf = m("conf").SrtConf
        self.TpuSession = m("plan.session").TpuSession
        self.delta = m("delta")
        self.log = m("delta.log")
        self.streaming = m("delta.streaming")
        self.events = m("obs.events")
        self.faults = m("robustness.faults")

    def session(self, **conf):
        settings = {"srt.delta.checkpointInterval": "0", **conf}
        if self.port:
            return self.TpuSession(self.SrtConf(settings), device="cpu")
        settings.setdefault("srt.sql.enabled", False)
        return self.TpuSession(self.SrtConf(settings))

    def schema(self, *extra):
        dt = self.dt
        return [("id", dt.INT64), ("v", dt.FLOAT64), ("tag", dt.STRING),
                *[(n, getattr(dt, t)) for n, t in extra]]

    def df(self, s, data):
        """The table's three columns, NULL where ``data`` has none."""
        n = len(data["id"])
        return s.create_dataframe(
            {c: data.get(c, [None] * n) for c in ("id", "v", "tag")},
            self.schema())


PORT = Pkg("spark_rapids_tpu_torch")


@pytest.fixture(scope="module")
def jax_pkg():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        import spark_rapids_tpu  # noqa: F401  (x64 and the jax config)
        yield Pkg("spark_rapids_tpu")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for root in ("spark_rapids_tpu_torch", "spark_rapids_tpu"):
        if root in sys.modules:
            importlib.import_module(f"{root}.robustness.faults") \
                .disarm_fault_plan()
            importlib.import_module(f"{root}.obs.events").install(None)


def _key(v):
    if v is None:
        return (0, 0)
    if isinstance(v, float) and math.isnan(v):
        return (2, 0)
    return (1, v)


def rows_of(df):
    """Rows as tuples in column order, sorted (None first)."""
    rows = [tuple(r.values()) for r in df.collect()]
    return sorted(rows, key=lambda r: [_key(v) for v in r])


def ids_of(t):
    return sorted(r["id"] for r in t.to_df().collect())


def ops_of(t):
    return [h["operation"] for h in t.history()]


# ------------------------------------------- one sequence, both packages

def _sequence(pkg, root):
    """CREATE, appends (txn replay a no-op), DELETE, UPDATE, MERGE
    (upsert / delete / insert-only / schema evolution), OPTIMIZE
    ZORDER, overwrite and VACUUM; returns ({version: rows}, history
    operations, what replays and VACUUM returned)."""
    s = pkg.session()
    col, lit = pkg.col, pkg.lit
    t = pkg.delta.AcidTable.create(s, root, pkg.schema())
    out = {}
    t.append(pkg.df(s, {"id": [1, 2, 3, 4, 5, 6],
                        "v": [10.0, 20.0, None, 40.0, 50.0, -0.0],
                        "tag": ["a", "b", "a", "c", None, "b"]}))
    v = t.append(pkg.df(s, {"id": [7, 8], "v": [70.5, 80.25],
                            "tag": ["é", "a"]}),
                 txn_app_id="s", txn_version=0)
    out["replay_is_noop"] = t.append(
        pkg.df(s, {"id": [7, 8], "v": [70.5, 80.25], "tag": ["é", "a"]}),
        txn_app_id="s", txn_version=0) == v == t.version()
    out["txn"] = (t.log.txn_version("s"), t.log.txn_version("other"))
    gone = col("tag") == "a"
    if not pkg.port:
        # the JAX package's DELETE also drops the rows whose condition
        # is NULL (C23); a two-valued condition gives it Delta's rule
        gone = importlib.import_module(
            "spark_rapids_tpu.expr.conditional").Coalesce(gone, lit(False))
    t.delete(gone)
    t.update({"v": col("v") * lit(2.0)}, col("id") >= 4)
    t.merge(pkg.df(s, {"id": [2, 7, 20], "v": [200.0, 700.0, 2000.0],
                       "tag": ["B", None, "NEW"]}), on=["id"],
            when_matched_update={"v": col("src_v"), "tag": col("src_tag")})
    t.merge(pkg.df(s, {"id": [4, 21], "v": [0.0, 0.0], "tag": ["", ""]}),
            on=["id"], when_matched_delete=True,
            when_not_matched_insert=False)
    t.merge(pkg.df(s, {"id": [5, 22], "v": [5.5, 22.5],
                       "tag": ["x", "z"]}), on=["id"],
            when_not_matched_insert=True)
    src = s.create_dataframe(
        {"id": [2, 30], "v": [2.5, 30.5], "tag": ["m", "n"],
         "extra": [200, 300]}, pkg.schema(("extra", "INT64")))
    with pytest.raises(ValueError, match="schema_evolution"):
        t.merge(src, on=["id"], when_matched_update={"v": col("src_v")})
    t.merge(src, on=["id"], when_matched_update={
        "v": col("src_v"), "extra": col("src_extra")},
        schema_evolution=True)
    t.optimize(zorder_by=["id", "extra"])
    t.overwrite(s.create_dataframe(
        {"id": [100, 101], "v": [1.0, 2.0], "tag": ["o", None],
         "extra": [None, 7]}, pkg.schema(("extra", "INT64"))))
    for ver in range(t.version() + 1):
        out[ver] = rows_of(t.to_df(version=ver))
    out["schema"] = [(n, repr(tp)) for n, tp in t.schema()]
    out["ops"] = ops_of(t)
    out["vacuumed"] = len(t.vacuum())
    out["after_vacuum"] = rows_of(t.to_df())
    return out


@pytest.fixture(scope="module")
def sequences(jax_pkg, tmp_path_factory):
    base = tmp_path_factory.mktemp("seq")
    return (_sequence(PORT, str(base / "port")),
            _sequence(jax_pkg, str(base / "jax")))


SEQUENCE_VERSIONS = list(range(11))


@pytest.mark.parametrize("version", SEQUENCE_VERSIONS)
def test_rows_at_every_version_equal_jax(sequences, version):
    port, jax = sequences
    assert port[version] == jax[version]


@pytest.mark.parametrize("what", ["ops", "schema", "txn", "vacuumed",
                                  "after_vacuum", "replay_is_noop"])
def test_sequence_outcomes_equal_jax(sequences, what):
    port, jax = sequences
    assert port[what] == jax[what]
    if what == "ops":
        assert port["ops"] == [
            "CREATE TABLE", "WRITE (append)", "WRITE (append)", "DELETE",
            "UPDATE", "MERGE", "MERGE", "MERGE", "MERGE", "OPTIMIZE ZORDER",
            "WRITE (overwrite)"]
        assert len(SEQUENCE_VERSIONS) == len(port["ops"])


# ------------------------------------------------------------- z-order

def test_zorder_row_order_equals_jax(jax_pkg, tmp_path):
    """OPTIMIZE ZORDER BY (k, flag) over keys spread across their
    ranges (no z-value ties): the rewritten rows in the same order."""
    rng = np.random.default_rng(5)
    k = rng.integers(-(1 << 62), 1 << 62, 400).tolist()
    flag = rng.integers(-(1 << 30), 1 << 30, 400).tolist()
    got = {}
    for pkg in (PORT, jax_pkg):
        s = pkg.session()
        schema = [("k", pkg.dt.INT64), ("flag", pkg.dt.INT32)]
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       schema)
        t.append(s.create_dataframe({"k": k, "flag": flag}, schema))
        t.optimize(zorder_by=["k", "flag"])
        got[pkg.port] = [tuple(r.values()) for r in t.to_df().collect()]
    assert got[True] == got[False]
    assert sorted(got[True]) == sorted(zip(k, flag))


# ---------------------------------------------------- duplicate keys

DUP_CASES = {
    "int_dup": ([("id", "INT64")], {"id": [1, 2, 1]}),
    "int_distinct": ([("id", "INT64")], {"id": [1, 2, 3]}),
    "null_dup": ([("id", "INT64")], {"id": [None, 1, None]}),
    "null_and_zero": ([("id", "INT64")], {"id": [None, 0]}),
    "nan_dup": ([("id", "FLOAT64")], {"id": [float("nan"), float("nan")]}),
    "nan_zero_null": ([("id", "FLOAT64")],
                      {"id": [float("nan"), 0.0, None]}),
    "negzero_dup": ([("id", "FLOAT64")], {"id": [0.0, -0.0]}),
    "str_dup": ([("id", "STRING")], {"id": ["ab", "a", "ab"]}),
    "str_prefix": ([("id", "STRING")], {"id": ["a", "ab", "", None]}),
    "pair_dup": ([("id", "INT64"), ("tag", "STRING")],
                 {"id": [1, 2, 1], "tag": ["x", "x", "x"]}),
    "pair_distinct": ([("id", "INT64"), ("tag", "STRING")],
                      {"id": [1, 2, 1, 1], "tag": ["x", None, None, "y"]}),
}


@pytest.mark.parametrize("case", list(DUP_CASES))
def test_merge_duplicate_source_keys_as_jax(jax_pkg, tmp_path, case):
    """A MERGE with a matched clause whose source repeats a key that a
    target row holds raises in the port, and only then (Delta's rule,
    C24): NaN equals NaN, -0.0 equals 0.0, neither equals 0, strings by
    their bytes, and a NULL key matches no target row, so a repeated
    NULL key is allowed. The target holds the source's rows. The JAX
    package raises for every repeated source key, NULL included."""
    types, data = DUP_CASES[case]
    raised = {}
    for pkg in (PORT, jax_pkg):
        s = pkg.session()
        schema = [(n, getattr(pkg.dt, t)) for n, t in types] + \
            [("w", pkg.dt.INT64)]
        rows = dict(data, w=list(range(len(data["id"]))))
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       schema)
        t.append(s.create_dataframe(rows, schema))
        try:
            t.merge(s.create_dataframe(rows, schema),
                    on=[n for n, _ in types],
                    when_matched_update={"w": pkg.col("src_w")})
            raised[pkg.port] = None
        except ValueError as e:
            raised[pkg.port] = str(e)
    expect = case.endswith("dup") and case != "null_dup"
    assert (raised[True] is not None) == expect, raised
    assert (raised[False] is not None) == case.endswith("dup"), raised


# ------------------------------------------------ concurrency (OCC)

def _both(jax_pkg, fn):
    return fn(PORT), fn(jax_pkg)


def test_occ_conflict_as_jax(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session(**{"srt.delta.commit.maxRetries": "0"})
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        read_v = t.log.latest_version()
        t.log.commit(read_v, [], "WRITE")
        with pytest.raises(pkg.delta.CommitConflict):
            t.log.commit(read_v, [], "WRITE")
        return t.log.versions()
    port, jax = _both(jax_pkg, run)
    assert port == jax == [0, 1]


def test_concurrent_committers_all_land(jax_pkg, tmp_path):
    """Threads racing blind appends through the optimistic loop all
    land: contiguous versions and the union of the rows."""
    def run(pkg):
        s = pkg.session(**{"srt.delta.commit.maxRetries": "30",
                           "srt.delta.commit.backoffMs": "2"})
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        errors = []

        def worker(k):
            try:
                for i in range(3):
                    t.append(pkg.df(s, {"id": [k * 1000 + i]}))
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not errors, errors
        return t.log.versions(), ids_of(t)
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert port[0] == list(range(13))


def test_committer_stress(tmp_path):
    """More committing threads than cores, switching often: every blind
    append lands once, as contiguous versions."""
    s = PORT.session(**{"srt.delta.commit.maxRetries": "60",
                        "srt.delta.commit.backoffMs": "1"})
    t = PORT.delta.AcidTable.create(s, str(tmp_path / "t"), PORT.schema())
    errors = []

    def worker(k):
        try:
            for i in range(2):
                t.append(PORT.df(s, {"id": [k * 10 + i]}))
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    n = 2 * (os.cpu_count() or 4)
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert t.log.versions() == list(range(2 * n + 1))
    assert ids_of(t) == sorted(k * 10 + i for k in range(n) for i in range(2))


def _racing(t, operation, fire):
    """Patch ``t.log.commit`` so that ``fire()`` commits a competing
    transaction just before the first commit of ``operation``."""
    orig = t.log.commit
    fired = {"done": False}

    def racing_commit(read_v, actions, op):
        if not fired["done"] and (operation is None or op == operation):
            fired["done"] = True
            fire()
        return orig(read_v, actions, op)
    t.log.commit = racing_commit


def test_losing_rewrites_recompute_as_jax(jax_pkg, tmp_path):
    """A DELETE losing to another DELETE and an UPDATE losing to an
    append recompute against the winner's head (no lost update)."""
    def run(pkg):
        s = pkg.session()
        col, lit = pkg.col, pkg.lit
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1, 2, 3, 4],
                            "v": [10.0, 20.0, 30.0, 40.0]}))
        other = pkg.delta.AcidTable.for_path(s, t.path)
        _racing(t, "DELETE", lambda: other.delete(col("id") == 4))
        t.delete(col("id") == 1)
        t2 = pkg.delta.AcidTable.for_path(s, t.path)
        _racing(t2, None, lambda: other.append(
            pkg.df(s, {"id": [10], "v": [100.0]})))
        t2.update({"v": col("v") * lit(2.0)})
        return rows_of(t2.to_df()), ops_of(t2)
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert [r[:2] for r in port[0]] == [(2, 40.0), (3, 60.0), (10, 200.0)]


def test_concurrent_schema_change_aborts_as_jax(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session()
        col, lit = pkg.col, pkg.lit
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1, 2], "v": [1.0, 2.0]}))
        t_b = pkg.delta.AcidTable.for_path(s, t.path)
        src = s.create_dataframe({"id": [1], "v": [1.5], "tag": ["a"],
                                  "extra": [7]},
                                 pkg.schema(("extra", "INT64")))
        _racing(t_b, None, lambda: t.merge(
            src, on=["id"], when_matched_update={"v": col("src_v")},
            schema_evolution=True))
        with pytest.raises(pkg.log.MetadataChangedConflict):
            t_b.update({"v": col("v") * lit(2.0)})
        return rows_of(t.to_df()), ops_of(t)
    port, jax = _both(jax_pkg, run)
    assert port == jax


# ------------------------------------------------------- checkpoints

def _full_replay(log):
    return log._fold(log.latest_version(), use_checkpoint=False)


def test_checkpoint_compaction_equivalence(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session(**{"srt.delta.checkpointInterval": "3"})
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        for i in range(4):
            t.append(pkg.df(s, {"id": [i]}), txn_app_id="s",
                     txn_version=i)
        t.overwrite(pkg.df(s, {"id": [100, 101]}))
        for i in range(4, 7):
            t.append(pkg.df(s, {"id": [i]}), txn_app_id="s",
                     txn_version=i)
        rec = json.load(open(os.path.join(t.log.log_dir,
                                          "_last_checkpoint")))
        assert rec["version"] % 3 == 0 and "crc32" in rec
        folded = t.log._fold(t.log.latest_version())
        assert folded == _full_replay(t.log)
        # replay reads no commit at or below the checkpoint
        reads = []
        orig = pkg.log.TransactionLog.read_actions

        def counting(self, version):
            reads.append(version)
            return orig(self, version)
        pkg.log.TransactionLog.read_actions = counting
        try:
            t.log.snapshot()
        finally:
            pkg.log.TransactionLog.read_actions = orig
        assert reads and min(reads) > rec["version"]
        return (rec["version"], rec["size"], folded[0], sorted(folded[2]),
                t.log.txn_version("s"), ids_of(t))
    port, jax = _both(jax_pkg, run)
    assert port == jax


def test_corrupt_checkpoint_full_replay(jax_pkg, tmp_path):
    """A flipped byte in a checkpoint on disk, and one injected as it is
    written (``delta.checkpoint.bytes``): the crc catches both, replay
    reads the whole JSON log, the event log records it."""
    def run(pkg):
        events_dir = str(tmp_path / f"events-{pkg.port}")
        pkg.events.install(pkg.events.EventLogWriter(events_dir))
        s = pkg.session(**{"srt.delta.checkpointInterval": "2"})
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        for i in range(4):
            t.append(pkg.df(s, {"id": [i]}))
        ck = sorted(f for f in os.listdir(t.log.log_dir)
                    if f.endswith(".checkpoint.json"))
        path = os.path.join(t.log.log_dir, ck[-1])
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        first = ids_of(t)
        pkg.faults.arm_fault_plan("delta.checkpoint.bytes:corrupt@1")
        t.append(pkg.df(s, {"id": [4]}))
        t.append(pkg.df(s, {"id": [5]}))  # version 6 writes the checkpoint
        log = [(e.site, e.kind, e.hit)
               for e in pkg.faults.active_plan().log]
        pkg.faults.disarm_fault_plan()
        second = ids_of(t)
        t.append(pkg.df(s, {"id": [6]}))
        t.append(pkg.df(s, {"id": [7]}))  # a good checkpoint again
        pkg.events.install(None)
        kinds = [r.get("kind") for r in
                 pkg.events.read_all_events(events_dir)
                 if r["event"] == "CorruptionDetected"]
        return first, second, log, ids_of(t), kinds
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert port[0] == [0, 1, 2, 3] and port[3] == list(range(8))
    assert port[2] == [("delta.checkpoint.bytes", "corrupt", 1)]
    assert port[4] and set(port[4]) == {"delta_checkpoint"}


def test_time_travel_below_checkpoint(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session(**{"srt.delta.checkpointInterval": "2"})
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        for i in range(5):
            t.append(pkg.df(s, {"id": [i]}))
        return [sorted(r["id"] for r in t.to_df(version=v).collect())
                for v in range(t.version() + 1)]
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert port[1] == [0]


# ------------------------------------------ fencing, resume, txn apps

def test_writer_epoch_fencing_and_resume(jax_pkg, tmp_path):
    def run(pkg):
        events_dir = str(tmp_path / f"events-{pkg.port}")
        pkg.events.install(pkg.events.EventLogWriter(events_dir))
        s = pkg.session()
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())

        def bf(b):
            return pkg.df(s, {"id": list(range(b * 10, b * 10 + 10))})
        a = pkg.streaming.DeltaIngestor(t, "app")
        a.ingest(bf, 2)
        b = pkg.streaming.DeltaIngestor(t, "app")
        with pytest.raises(pkg.delta.StaleWriterEpoch):
            a.ingest(bf, 3)
        stats = b.ingest(bf, 3)
        again = pkg.streaming.DeltaIngestor(t, "app").ingest(bf, 5)
        pkg.events.install(None)
        recs = pkg.events.read_all_events(events_dir)
        fenced = [(r["writerEpoch"], r["currentEpoch"]) for r in recs
                  if r["event"] == "StaleWriterFenced"]
        return ((a.epoch, b.epoch), stats, again, fenced, ids_of(t),
                t.log.txn_state("app"),
                [r["event"] for r in recs
                 if r["event"].startswith(("Stream", "Stale"))])
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert port[1] == {"committed": 1, "skipped": 2}
    assert port[2] == {"committed": 2, "skipped": 3}
    assert port[3] == [(1, 2)] and port[4] == list(range(50))


def test_txn_apps_are_independent(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session()
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1]}), txn_app_id="a", txn_version=0)
        t.append(pkg.df(s, {"id": [2]}), txn_app_id="b", txn_version=0)
        return ([t.log.txn_version(a) for a in "abc"], ids_of(t))
    port, jax = _both(jax_pkg, run)
    assert port == jax == ([0, 0, -1], [1, 2])


# --------------------------------------------- tmp hygiene and VACUUM

def test_vacuum_retention_guard_as_jax(jax_pkg, tmp_path):
    def run(pkg):
        s = pkg.session()
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1]}))
        junk = {"orphan": "part-orphan00001.parquet",
                "dead_tmp": f"part-q.parquet.{DEAD_PID}.tmp",
                "live_tmp": f"part-y.parquet.{os.getpid()}.tmp"}
        for name in junk.values():
            with open(os.path.join(t.path, name), "w") as f:
                f.write("x")
        dead_log = os.path.join(t.log.log_dir,
                                f"{9:020d}.json.{DEAD_PID}.tmp")
        with open(dead_log, "w") as f:
            f.write("x")
        first = sorted(t.vacuum(retention_sec=3600.0))
        second = sorted(t.vacuum(retention_sec=0.0))
        before = {f for f in os.listdir(t.path) if f.endswith(".parquet")}
        t.overwrite(pkg.df(s, {"id": [9]}))
        tomb = set(t.vacuum()) & before == before
        return first, second, tomb, ids_of(t), os.path.exists(dead_log)
    port, jax = _both(jax_pkg, run)
    assert port == jax
    assert port[0] == [f"{9:020d}.json.{DEAD_PID}.tmp",
                       f"part-q.parquet.{DEAD_PID}.tmp"]
    assert port[1] == ["part-orphan00001.parquet",
                       f"part-y.parquet.{os.getpid()}.tmp"]
    assert port[2] and port[3] == [9]


def test_versions_ignore_tmp_and_checkpoint_files(tmp_path):
    s = PORT.session()
    t = PORT.delta.AcidTable.create(s, str(tmp_path / "t"), PORT.schema())
    t.append(PORT.df(s, {"id": [1, 2]}))
    for junk in (f"{2:020d}.json.{DEAD_PID}.tmp",
                 f"{1:020d}.checkpoint.json", "garbage.json"):
        with open(os.path.join(t.log.log_dir, junk), "w") as f:
            f.write("{}\n")
    assert t.log.versions() == [0, 1]
    assert len(t.log.snapshot()[1]) == 1
    live = os.path.join(t.path, f"part-y.parquet.{os.getpid()}.tmp")
    dead = os.path.join(t.path, f"part-x.parquet.{DEAD_PID}.tmp")
    for p in (live, dead):
        with open(p, "w") as f:
            f.write("x")
    PORT.delta.AcidTable.for_path(s, t.path)  # the init sweep
    assert os.path.exists(live) and not os.path.exists(dead)


def test_staged_files_promoted_only_at_commit(tmp_path, monkeypatch):
    s = PORT.session(**{"srt.delta.commit.maxRetries": "0"})
    t = PORT.delta.AcidTable.create(s, str(tmp_path / "t"), PORT.schema())

    def no_commit(read_version, actions, operation):
        raise RuntimeError("die before the log link")
    monkeypatch.setattr(t.log, "commit", no_commit)
    with pytest.raises(RuntimeError):
        t.append(PORT.df(s, {"id": [7, 8]}))
    monkeypatch.undo()
    assert t.to_df().collect() == []
    assert t.vacuum(retention_sec=0.0)  # the promoted orphan


def test_durable_commit_fsyncs_as_jax(jax_pkg, tmp_path, monkeypatch):
    """An append fsyncs as often in the port as in the JAX package (the
    data file, the commit file, their directories); relaxed, never."""
    counts = {}
    real = os.fsync
    calls = []
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd),
                                                 real(fd))[1])
    for pkg in (PORT, jax_pkg):
        for durable in ("true", "false"):
            s = pkg.session(**{"srt.delta.durableCommits": durable})
            t = pkg.delta.AcidTable.create(
                s, str(tmp_path / f"{pkg.port}-{durable}"), pkg.schema())
            calls.clear()
            t.append(pkg.df(s, {"id": [1, 2]}))
            counts[pkg.port, durable] = len(calls)
    assert counts[True, "true"] == counts[False, "true"] >= 3
    assert counts[True, "false"] == counts[False, "false"] == 0


def test_large_commit_splits_into_files(tmp_path, monkeypatch):
    """A commit above ROWS_PER_FILE rows writes several files of one
    stem, read back in row order."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    from spark_rapids_tpu_torch.delta import table as T
    from spark_rapids_tpu_torch.plan.host_table import (HostColumn,
                                                        HostTable)
    monkeypatch.setattr(T, "ROWS_PER_FILE", 1000)
    s = PORT.session()
    t = PORT.delta.AcidTable.create(s, str(tmp_path / "t"), PORT.schema())
    n = 3500
    ids = np.arange(n, dtype=np.int64)[::-1].copy()
    ok = np.ones(n, bool)
    dt = PORT.dt
    t.append(s.create_dataframe(HostTable(
        [HostColumn(ids, ok, dt.INT64), HostColumn(ids * 0.5, ok, dt.FLOAT64),
         HostColumn(HostStrings.from_objects(["t"] * n), ok, dt.STRING)],
        ["id", "v", "tag"])))
    files = t.files()
    assert len(files) == 4 and len({os.path.basename(f)[:17]
                                    for f in files}) == 1
    adds = [a["add"] for a in t.log.read_actions(1) if "add" in a]
    assert [a["numRecords"] for a in adds] == [1000, 1000, 1000, 500]
    got = [r["id"] for r in t.to_df().collect()]
    assert got == ids.tolist()


# ------------------------------------------------------- cross-reads

def _history_rows(t):
    return ops_of(t), [rows_of(t.to_df(version=v))
                       for v in range(t.version() + 1)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_read(jax_pkg, tmp_path, writer):
    """A table one package wrote (appends, a MERGE, a DELETE and a
    checkpoint) opened by the other's ``AcidTable.for_path``: the same
    operations and rows at every version, and it appends on."""
    w, r = (jax_pkg, PORT) if writer == "jax" else (PORT, jax_pkg)
    root = str(tmp_path / "t")
    s = w.session(**{"srt.delta.checkpointInterval": "3"})
    t = w.delta.AcidTable.create(s, root, w.schema())
    t.append(w.df(s, {"id": [1, 2, 3], "v": [1.5, None, 3.5],
                      "tag": ["a", "bb", None]}))
    t.merge(w.df(s, {"id": [2, 4], "v": [20.0, 40.0], "tag": ["x", "y"]}),
            on=["id"], when_matched_update={"v": w.col("src_v")})
    t.delete(w.col("id") == 1)
    t.append(w.df(s, {"id": [5]}), txn_app_id="app", txn_version=3)
    want = _history_rows(t)
    rs = r.session(**{"srt.delta.checkpointInterval": "3"})
    back = r.delta.AcidTable.for_path(rs, root)
    assert _history_rows(back) == want
    assert back.log.txn_version("app") == 3
    back.append(r.df(rs, {"id": [6]}))
    assert ids_of(w.delta.AcidTable.for_path(s, root)) == [2, 3, 4, 5, 6]


# ---------------------------------------------- crash, then resume

CRASH_SITES = [
    # every fault site of the commit protocol (JAX tests/
    # test_delta_txn.py's list): a kill, and the resume exactly-once
    "delta.stage:crash@2",
    "delta.rename:crash@2",
    "delta.commit:crash@4",       # CREATE + epoch are hits 1-2
    "delta.commit.fsync:crash@3",
    "delta.checkpoint:crash@1",
]


@pytest.mark.parametrize("clause", CRASH_SITES)
def test_crash_then_resume_exactly_once(tmp_path, clause):
    table = str(tmp_path / "crash")
    batches, rows = 6, 40
    cmd = [sys.executable, "-m", "spark_rapids_tpu_torch.delta.streaming",
           table, "chaos", str(batches), str(rows), "--fault-plan",
           f"seed=13|{clause}", "--create", "--device", "cpu"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert p.returncode == 137, \
        f"child should die at {clause}: rc={p.returncode}\n{p.stderr}"
    sm = PORT.streaming
    conf = {"srt.delta.checkpointInterval": "4"}
    s = PORT.session(**conf)
    t = PORT.delta.AcidTable.for_path(s, table)
    stats = sm.DeltaIngestor(t, "chaos").ingest(
        lambda b: s.create_dataframe(sm.demo_batch_table(b, rows)), batches)
    assert stats["committed"] + stats["skipped"] == batches
    got = t.to_df().collect()
    exp = sm.demo_expected(batches, rows)
    assert len(got) == exp["rows"]
    assert len({r["id"] for r in got}) == exp["distinct_ids"]
    assert sum(r["v"] for r in got) == exp["sum_v"]
    t.vacuum(retention_sec=0.0)
    on_disk = {f for f in os.listdir(table) if f.endswith(".parquet")}
    assert on_disk == set(t.log.snapshot()[1])
    assert not [f for d in (table, t.log.log_dir) for f in os.listdir(d)
                if f.endswith(".tmp")]


# ------------------------------------- C23 / C24: Delta's own DML rules

def test_delete_keeps_rows_whose_condition_is_null(jax_pkg, tmp_path):
    """C23. DELETE removes only the rows whose condition is true (Delta's
    DeleteCommand keeps ``NOT (cond <=> true)``): over v = 1.0, NULL,
    3.0, NaN, ``delete(v > 0.5)`` keeps the NULL row alone (NaN sorts
    above every number, so NaN > 0.5). The JAX package drops it too."""
    vs = [1.0, None, 3.0, float("nan")]
    # plain Python, Spark's three-valued rule
    want = [i for i, v in enumerate(vs, 1)
            if v is None or not (math.isnan(v) or v > 0.5)]
    got = {}
    for pkg in (PORT, jax_pkg):
        s = pkg.session()
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1, 2, 3, 4], "v": vs}))
        t.delete(pkg.col("v") > pkg.lit(0.5))
        got[pkg.port] = ids_of(t)
    assert got[True] == want == [2]
    assert got[False] == []


C24_CASES = {
    # source ids, clause, plain Python's ids after the MERGE (None: it
    # raises); the target holds ids 1 and 2
    "insert_only_dup": ([99, 99], "insert", [1, 2, 99, 99]),
    "dup_no_target_row": ([99, 99, 1], "update", [1, 2, 99, 99]),
    "null_keys": ([None, None], "update", [None, None, 1, 2]),
    "dup_matched_update": ([1, 1], "update", None),
    # an unconditional delete may meet several source rows: the
    # target row goes (MergeIntoCommand's isOnlyOneUnconditionalDelete)
    "dup_matched_delete": ([2, 2], "delete", [1]),
}


@pytest.mark.parametrize("case", list(C24_CASES))
def test_merge_fails_only_on_a_multiply_matched_target_row(jax_pkg,
                                                           tmp_path, case):
    """C24. MERGE fails only when a target row that a matched update
    modifies meets several source rows; an unconditional delete may
    meet several, and NULL keys never match. The JAX package refuses
    every repeated source key."""
    ids, clause, want = C24_CASES[case]
    outcome = {}
    for pkg in (PORT, jax_pkg):
        s = pkg.session()
        t = pkg.delta.AcidTable.create(s, str(tmp_path / str(pkg.port)),
                                       pkg.schema())
        t.append(pkg.df(s, {"id": [1, 2], "v": [1.0, 2.0]}))
        src = pkg.df(s, {"id": ids, "v": [float(k or 0) + 0.5
                                           for k in ids]})
        kw = {"insert": {"when_not_matched_insert": True},
              "update": {"when_matched_update": {"v": pkg.col("src_v")}},
              "delete": {"when_matched_delete": True,
                         "when_not_matched_insert": False}}[clause]
        try:
            t.merge(src, on=["id"], **kw)
            outcome[pkg.port] = sorted(
                (r["id"] for r in t.to_df().collect()),
                key=lambda v: (v is not None, v or 0))
        except ValueError as e:
            assert "multiple source rows" in str(e)
            outcome[pkg.port] = None
    assert outcome[True] == want
    assert outcome[False] is None
    if case == "dup_no_target_row":
        # the matched row took the source's value
        s = PORT.session()
        t = PORT.delta.AcidTable.for_path(s, str(tmp_path / "True"))
        assert {r["id"]: r["v"] for r in t.to_df().collect()}[1] == 1.5
