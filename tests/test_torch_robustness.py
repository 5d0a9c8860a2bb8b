"""The port's fault plans (robustness/faults.py), integrity envelope
(robustness/integrity.py) and event log (obs/events.py) held against the
JAX package's: the same specs and the same hit sequences fire the same
faults (``plan.log`` equal), ``corrupt_point`` flips the same byte, the
envelope's bytes are equal, and an event log the port writes reads back
equal through the JAX package's ``read_all_events``. No JAX program is
compiled (the JAX package's modules here are numpy and the stdlib).
"""

import importlib
import os

import numpy as np
import pytest

from jax_reference import patch_jax_compiles


def mods(root):
    return (importlib.import_module(f"{root}.robustness.faults"),
            importlib.import_module(f"{root}.robustness.integrity"),
            importlib.import_module(f"{root}.obs.events"))


PORT = "spark_rapids_tpu_torch"


@pytest.fixture(scope="module")
def jax_root():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        import spark_rapids_tpu  # noqa: F401
        yield "spark_rapids_tpu"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for root in (PORT, "spark_rapids_tpu"):
        faults, _, events = mods(root)
        faults.disarm_fault_plan()
        events.install(None)


SPECS = [
    "seed=7|delta.commit:delay@2+0.0|delta.stage:drop*2%0.5",
    "seed=3|scan.file:corrupt%0.3*4~part-|delta.rename:refuse@3",
    "delta.commit:reset@1~op=MERGE|delta.commit:refuse%0.4*3",
    "seed=11|delta.checkpoint:truncate@2|delta.commit.fsync:delay%0.5*5+0",
]

HITS = [("delta.commit", "version=1;op=WRITE;"),
        ("delta.stage", "file=part-a.parquet;"),
        ("scan.file", "/t/part-1.parquet"),
        ("delta.commit", "version=2;op=MERGE;"),
        ("delta.rename", "file=part-b.parquet;"),
        ("delta.stage", "file=part-c.parquet;"),
        ("delta.checkpoint", "version=4;"),
        ("delta.commit.fsync", "version=3;op=WRITE;"),
        ("scan.file", "/t/other.parquet"),
        ("delta.checkpoint", "version=8;")] * 3


def _replay(root, spec):
    faults = mods(root)[0]
    plan = faults.arm_fault_plan(spec)
    raised = []
    for site, detail in HITS:
        try:
            faults.fault_point(site, detail)
            raised.append(None)
        except Exception as e:  # noqa: BLE001
            raised.append(type(e).__name__)
    log = [(e.site, e.kind, e.detail, e.hit) for e in plan.log]
    return plan.spec_string(), raised, log


@pytest.mark.parametrize("spec", SPECS)
def test_same_spec_fires_the_same_faults(jax_root, spec):
    port, jax = _replay(PORT, spec), _replay(jax_root, spec)
    assert port == jax
    assert port[2], "the spec fires at least one fault"


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_corrupt_point_mutates_the_same_bytes(jax_root, kind):
    out = {}
    for root in (PORT, jax_root):
        faults = mods(root)[0]
        plan = faults.arm_fault_plan(
            f"seed=5|delta.checkpoint.bytes:{kind}%0.5*3")
        data = [faults.corrupt_point("delta.checkpoint.bytes",
                                     bytes(range(40)) * (i + 1),
                                     f"version={i};") for i in range(8)]
        arr = faults.corrupt_point("delta.checkpoint.bytes",
                                   np.arange(64, dtype=np.int64), "arr")
        out[root] = (data, arr.tobytes(),
                     [(e.kind, e.detail, e.hit) for e in plan.log])
    assert out[PORT] == out[jax_root]


def test_spec_parse_errors_match(jax_root):
    for bad in ("nosep", "delta.commit:explode@1"):
        for root in (PORT, jax_root):
            with pytest.raises(ValueError):
                mods(root)[0].FaultPlan.parse(bad)


def test_crash_kind_exits_137(tmp_path):
    """``crash`` is ``os._exit(137)`` after its FaultInjected event is on
    disk (a child process, as the Delta crash tests run it)."""
    import subprocess
    import sys
    events_dir = str(tmp_path / "ev")
    code = (
        "from spark_rapids_tpu_torch.obs import events as ev\n"
        "from spark_rapids_tpu_torch.robustness import faults\n"
        f"ev.install(ev.EventLogWriter({events_dir!r}))\n"
        "faults.arm_fault_plan('seed=2|delta.commit:crash@2')\n"
        "faults.fault_point('delta.commit', 'a')\n"
        "faults.fault_point('delta.commit', 'b')\n"
        "print('not reached')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 137 and "not reached" not in p.stdout
    recs = mods(PORT)[2].read_all_events(events_dir)
    assert [(r["event"], r["site"], r["detail"], r["hit"]) for r in recs] \
        == [("FaultInjected", "delta.commit", "b", 2)]


def test_integrity_envelope_equals_jax(jax_root):
    port, jax = mods(PORT)[1], mods(jax_root)[1]
    payload = bytes(np.random.default_rng(1).integers(0, 256, 1000,
                                                      dtype=np.uint8))
    assert port.wrap(payload) == jax.wrap(payload)
    assert port.unwrap(jax.wrap(payload)) == payload
    arr = np.arange(100, dtype=np.float64)[::3]
    assert port.array_checksum(arr) == jax.array_checksum(arr)
    bad = bytearray(port.wrap(payload))
    bad[-1] ^= 1
    for m in (port, jax):
        with pytest.raises(m.DataCorruption, match="checksum mismatch"):
            m.unwrap(bytes(bad))
    with pytest.raises(port.DataCorruption, match="truncated"):
        port.verify_framed(b"\x00" * 4)


def test_event_log_reads_back_through_jax(jax_root, tmp_path):
    """Events the port writes (Delta commits of a small table, a fault,
    a corruption, rotation at srt.eventLog.maxBytes) read back equal
    through the JAX package's reader."""
    faults, integrity, events = mods(PORT)
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.delta import AcidTable
    from spark_rapids_tpu_torch.plan.session import TpuSession
    log_dir = str(tmp_path / "events")
    conf = SrtConf({"srt.eventLog.enabled": True, "srt.eventLog.dir": log_dir,
                    "srt.eventLog.maxBytes": "1k",
                    "srt.delta.checkpointInterval": "2",
                    "srt.test.faultPlan": "delta.stage:delay@1+0"})
    events.configure_from_conf(conf)
    faults.arm_from_conf(conf)
    s = TpuSession(conf, device="cpu")
    t = AcidTable.create(s, str(tmp_path / "t"), [("id", dt.INT64)])
    for i in range(3):
        t.append(s.create_dataframe({"id": [i]}, [("id", dt.INT64)]))
    integrity.DataCorruption("spill buffer", 1, 2, "test")
    t.vacuum()
    events.configure_from_conf(SrtConf({}))
    assert not events.enabled()
    ours = events.read_all_events(log_dir)
    theirs = mods(jax_root)[2].read_all_events(log_dir)
    assert ours == theirs
    names = [r["event"] for r in ours]
    assert names.count("DeltaCommit") == 4 and "FaultInjected" in names
    assert "DeltaLogCheckpointed" in names and "DeltaOrphanSwept" in names
    assert "CorruptionDetected" in names
    assert any(f.endswith(".jsonl.1") for f in os.listdir(log_dir))
