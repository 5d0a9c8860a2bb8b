"""The memory layer (budget, spillable batches, split-and-retry) and the
operators that hold batches, through both packages on the CPU.

Each case of the JAX package's memory suites (tests/test_memory.py but
its native pool, slab and map-count cases; tests/test_ooc_sort.py; and
tests/test_retry_suite.py) runs as a function of a package namespace:
the same seeded numpy data go through the JAX package and the port, and
their observations must be equal (rows as multisets or in order where
the case sorts, floats to 1e-9 relative; tiers, counts and flags
exactly). The JAX side runs once for the module, every case in this
process, under a patch that makes each JAX cache read a miss
(tests/conftest.py wraps jax's ``_cache_read`` with four arguments, this
jax passes five); the JAX package is imported under that patch.

Where the port departs from the JAX package, the case says how:
- a corrupted spilled buffer: the JAX side corrupts it through its
  seeded fault plan (``spill.materialize:corrupt``), the port, which
  has no fault harness yet, by flipping a byte of the first spilled
  host buffer; both must raise ``DataCorruption`` and a fresh run must
  then sort right;
- the translation of ``torch.cuda.OutOfMemoryError`` and the split
  halves that the port's per-batch retry blocks hand B1 and B3 have no
  JAX counterpart and are held against plain Python.
"""

import importlib
import math
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar.vector import (ColumnarBatch,
                                                    choose_capacity,
                                                    column_from_numpy)
from spark_rapids_tpu_torch.memory import retry as port_retry
from spark_rapids_tpu_torch.memory.spill import DataCorruption
from spark_rapids_tpu_torch.ops import device_kernels as DK

RTOL = 1e-9
N = 4000
SORT_BUDGET = 512


def _ns(pkg: str) -> SimpleNamespace:
    """One package's memory API, operators and DataFrame pieces under
    common names."""
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "memory.budget", "memory.spill", "memory.retry", "conf",
        "exec.base", "exec.sort", "exec.basic", "expr.core",
        "expr.aggregates", "expr.window", "plan.session")}
    b, s, r = mod["memory.budget"], mod["memory.spill"], mod["memory.retry"]
    return SimpleNamespace(
        pkg=pkg, MemoryBudget=b.MemoryBudget, RetryOOM=b.RetryOOM,
        SplitAndRetryOOM=b.SplitAndRetryOOM,
        reset_task_context=b.reset_task_context,
        task_context=b.task_context, SpillableBatch=s.SpillableBatch,
        reset_spill_catalog=s.reset_spill_catalog,
        spill_catalog=s.spill_catalog,
        with_retry=r.with_retry, with_retry_no_split=r.with_retry_no_split,
        split=r.split_spillable_in_half_by_rows,
        with_restore_on_retry=r.with_restore_on_retry,
        SrtConf=mod["conf"].SrtConf, TpuExec=mod["exec.base"].TpuExec,
        ExecContext=mod["exec.base"].ExecContext,
        SortExec=mod["exec.sort"].SortExec,
        SortOrder=mod["exec.sort"].SortOrder,
        CoalesceBatchesExec=mod["exec.basic"].CoalesceBatchesExec,
        col=mod["expr.core"].col, Alias=mod["expr.core"].Alias,
        Sum=mod["expr.aggregates"].Sum,
        CountStar=mod["expr.aggregates"].CountStar,
        WindowSpec=mod["expr.window"].WindowSpec,
        TpuSession=mod["plan.session"].TpuSession)


# --- package adapters ---------------------------------------------------------

def _batch(m, data: dict):
    """A batch of {name: list} (ints, floats, strings; None for null)."""
    if m.pkg == "spark_rapids_tpu":
        from spark_rapids_tpu.columnar.vector import batch_from_pydict
        return batch_from_pydict(data)
    n = len(next(iter(data.values())))
    cols = []
    for vals in data.values():
        mask = np.array([v is not None for v in vals])
        live = [v for v in vals if v is not None]
        if live and isinstance(live[0], str):
            lane = np.array([v or "" for v in vals], dtype=object)
        elif live and isinstance(live[0], float):
            lane = np.array([v or 0.0 for v in vals], np.float64)
        else:
            lane = np.array([v or 0 for v in vals], np.int64)
        cols.append(column_from_numpy(lane, choose_capacity(n), mask=mask,
                                      device="cpu"))
    return ColumnarBatch(cols, list(data), n, "cpu")


def _pydict(m, batch) -> dict:
    if m.pkg == "spark_rapids_tpu":
        from spark_rapids_tpu.columnar.vector import batch_to_pydict
        return batch_to_pydict(batch)
    out = {}
    for name, c in zip(batch.names, batch.columns):
        vals, mask = c.to_numpy(batch.num_rows)
        if hasattr(vals, "to_objects"):
            vals = vals.to_objects()
        out[name] = [v.item() if hasattr(v, "item") else v
                     for v in (x if ok else None
                               for x, ok in zip(vals, mask))]
    return out


def _session(m, settings=None):
    conf = m.SrtConf(dict(settings or {}))
    if m.pkg == "spark_rapids_tpu":
        return m.TpuSession(conf)
    return m.TpuSession(conf, device="cpu")


def _frame(m, session, data: dict):
    if m.pkg == "spark_rapids_tpu":
        return session.create_dataframe(data)
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    schema = [(k, dt.FLOAT64 if isinstance(v[0], float) else dt.INT64)
              for k, v in data.items()]
    return session.create_dataframe(data, schema)


def _ctx(m, conf):
    return m.ExecContext(conf) if m.pkg == "spark_rapids_tpu" \
        else m.ExecContext(conf, "cpu")


def _source(m, batches):
    class Source(m.TpuExec):
        def __init__(self):
            super().__init__()

        @property
        def output_schema(self):
            return batches[0].schema()

        def do_execute(self, ctx):
            yield from batches
    return Source()


def _fresh(m, tmp, limit=1 << 30, host_limit=1 << 20):
    m.reset_task_context()
    return m.reset_spill_catalog(budget=m.MemoryBudget(limit),
                                 host_limit=host_limit, spill_dir=str(tmp))


# --- test_memory.py cases -----------------------------------------------------

def _two_cols(m, n):
    return _batch(m, {"a": list(range(n)), "b": [i * 0.5 for i in range(n)]})


def case_spill_roundtrip(m, tmp):
    cat = _fresh(m, tmp)
    b = _two_cols(m, 50)
    expected = _pydict(m, b)
    sb = m.SpillableBatch(b)
    seen = [sb.tier, cat.budget.used == sb.nbytes]
    seen += [sb.spill_to_host() == sb.nbytes, sb.tier, cat.budget.used]
    sb.spill_to_disk()
    seen.append(sb.tier)
    out = _pydict(m, sb.get())
    seen += [sb.tier, out == expected]
    sb.close()
    return seen + [cat.budget.used, out]


def case_budget_triggers_spill(m, tmp):
    cat = _fresh(m, tmp)
    b1 = m.SpillableBatch(_two_cols(m, 100))
    cat.budget.limit = int(b1.nbytes * 1.5)
    b2 = m.SpillableBatch(_two_cols(m, 100))
    tiers = [b1.tier, b2.tier]
    b1.close()
    b2.close()
    return tiers


def case_oom_when_nothing_to_spill(m, tmp):
    cat = _fresh(m, tmp)
    cat.budget.limit = 16
    try:
        m.SpillableBatch(_two_cols(m, 1000))
    except m.RetryOOM:
        return "RetryOOM"
    return "no error"


def case_injected_retry_then_success(m, tmp):
    cat = _fresh(m, tmp)
    ctx = m.reset_task_context()
    ctx.force_retry_oom(num_allocs_before=0)
    calls = []

    def body():
        calls.append(1)
        cat.budget.reserve(8)
        cat.budget.release(8)
        return "ok"
    return [m.with_retry_no_split(body), len(calls), ctx.retry_count]


def case_split_policy(m, tmp):
    _fresh(m, tmp)
    ctx = m.reset_task_context()
    sb = m.SpillableBatch(_two_cols(m, 64))
    seen_rows, armed = [], [True]

    def fn(s):
        if armed[0]:
            armed[0] = False
            raise m.SplitAndRetryOOM("synthetic")
        seen_rows.append(int(s.get().num_rows))
        s.close()
        return True
    results = list(m.with_retry(sb, fn, split_policy=m.split))
    return [results, seen_rows, ctx.split_count]


def case_split_content(m, tmp):
    _fresh(m, tmp)
    b = _two_cols(m, 10)
    expected = _pydict(m, b)
    lo, hi = m.split(m.SpillableBatch(b))
    out, out2 = _pydict(m, lo.get()), _pydict(m, hi.get())
    lo.close()
    hi.close()
    merged = {k: out[k] + out2[k] for k in out}
    return [merged == expected, len(out["a"]), len(out2["a"])]


def case_host_limit_overflows_to_disk(m, tmp):
    cat = _fresh(m, tmp)
    cat.host_limit = 1  # any host spill overflows to disk
    sb = m.SpillableBatch(_two_cols(m, 100))
    expected = _pydict(m, sb.get())
    cat.synchronous_spill(sb.nbytes)
    tier = sb.tier
    out = _pydict(m, sb.get())
    sb.close()
    return [tier, out == expected]


def case_leak_report(m, tmp):
    conf = m.SrtConf({"srt.memory.leakDetection.enabled": True})
    m.reset_task_context()
    if m.pkg == "spark_rapids_tpu":
        from spark_rapids_tpu.conf import set_active_conf
        set_active_conf(conf)
        try:
            cat = m.reset_spill_catalog(budget=m.MemoryBudget(1 << 30),
                                        spill_dir=str(tmp))
        finally:
            set_active_conf(m.SrtConf({}))
    else:
        cat = m.reset_spill_catalog(budget=m.MemoryBudget(1 << 30),
                                    spill_dir=str(tmp), conf=conf)
    leaked = m.SpillableBatch(_two_cols(m, 8), catalog=cat)
    closed = m.SpillableBatch(_two_cols(m, 8), catalog=cat)
    closed.close()
    report = cat.leak_report()
    seen = [len(report), report[0]["handle"] == leaked.handle,
            "case_leak_report" in report[0]["creation_stack"],
            cat.log_leaks()]
    leaked.close()
    return seen + [cat.leak_report()]


def case_restore_on_retry(m, tmp):
    """with_restore_on_retry puts a checkpointed state back before the
    retry re-runs the body."""
    _fresh(m, tmp)

    class Counter:
        def __init__(self):
            self.value, self.saved = 0, None

        def checkpoint(self):
            self.saved = self.value

        def restore(self):
            self.value = self.saved
    target, seen = Counter(), []

    def body():
        with m.with_restore_on_retry(target):
            target.value += 1
            seen.append(target.value)
            if len(seen) == 1:
                raise m.RetryOOM("synthetic")
            return target.value
    return [m.with_retry_no_split(body), seen]


UNIT_CASES = {f.__name__[5:]: f for f in (
    case_spill_roundtrip, case_budget_triggers_spill,
    case_oom_when_nothing_to_spill, case_injected_retry_then_success,
    case_split_policy, case_split_content,
    case_host_limit_overflows_to_disk, case_leak_report,
    case_restore_on_retry)}


# --- test_ooc_sort.py cases (at oocRowBudget 512) -----------------------------

def _sort_data(n_batches, rows, seed, nulls=False, strings=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        v = [int(x) for x in rng.integers(-10_000, 10_000, rows)]
        if nulls:
            v = [None if rng.random() < 0.1 else x for x in v]
        d = {"v": v, "t": [float(x) for x in rng.random(rows)]}
        if strings:
            d["s"] = [f"k{x}" for x in rng.integers(0, 300, rows)]
        out.append(d)
    return out


def _run_sort(m, data, budget, keys=("v",), descending=False):
    batches = [_batch(m, d) for d in data]
    settings = {"srt.sql.sort.oocRowBudget": budget}
    if m.pkg == "spark_rapids_tpu":
        # the JAX merge unfused (the same steps, bit-identical as its
        # sort says): fused, it compiles one more program per carry
        # capacity, a tenth of this file's time
        settings["srt.exec.fusion.sort"] = False
    conf = m.SrtConf(settings)
    order = [m.SortOrder(m.col(k), ascending=not descending) for k in keys]
    if m.pkg == "spark_rapids_tpu":
        node = m.SortExec(_source(m, batches), order, global_sort=True)
    else:
        node = m.SortExec(_source(m, batches), order)
    ctx = _ctx(m, conf)
    rows = {k: [] for k in data[0]}
    for b in node.execute(ctx):
        for k, v in _pydict(m, b).items():
            rows[k] += v
    peak = ctx.metrics.get(node.exec_id, {}).get("sortOocPeakRows")
    return rows, peak.value if peak else 0


SORT_CASES = {
    "ascending": dict(data=(6, 300, 0), kw={}),
    "descending": dict(data=(6, 300, 3), kw={"descending": True}),
    "nulls": dict(data=(6, 300, 4, True), kw={}),
    "string_keys": dict(data=(2, 300, 6, False, True),
                        kw={"keys": ("s", "v")}),
    "many_runs_cascade": dict(data=(12, 300, 5), kw={}),
    "in_core": dict(data=(3, 300, 1), kw={}, budget=1 << 22),
    "injected_retry": dict(data=(6, 300, 7), kw={}, inject=20),
}


def case_sort(m, tmp, name):
    spec = SORT_CASES[name]
    _fresh(m, tmp)
    if "inject" in spec:
        m.task_context().force_retry_oom(num_allocs_before=spec["inject"])
    rows, peak = _run_sort(m, _sort_data(*spec["data"]),
                           spec.get("budget", SORT_BUDGET), **spec["kw"])
    return {"rows": rows, "peak": peak,
            "retries": m.task_context().retry_count}


# --- test_retry_suite.py cases --------------------------------------------------

def _retry_data(m, session, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return _frame(m, session, {
        "k": [int(x) for x in rng.integers(0, 40, n)],
        "v": [float(x) for x in rng.uniform(0, 10, n)]})


def _inject_each_alloc(m, run, probes=8):
    """Run once clean for the oracle (counting allocation attempts), then
    with RetryOOM injected at offsets spread over the whole attempt
    range; every injected run must equal the oracle and every injection
    must reach a retry. Returns the oracle."""
    m.reset_task_context()
    oracle = run()
    total = m.task_context().alloc_attempts
    assert total > 0, f"{m.pkg}: no allocation attempt"
    offsets = sorted({(total - 1) * i // max(probes - 1, 1)
                      for i in range(probes)})
    for at in offsets:
        m.reset_task_context()
        m.task_context().force_retry_oom(num_allocs_before=at)
        assert run() == oracle, f"{m.pkg}: divergence at {at}"
        assert m.task_context().retry_count, \
            f"{m.pkg}: the injection at {at} reached no retry"
    return oracle


def _rounded(rows, keys):
    return sorted(tuple(round(r[k], 9) if isinstance(r[k], float) else r[k]
                        for k in keys) for r in rows)


def case_aggregate_merge(m, tmp):
    s = _session(m, {"srt.shuffle.partitions": 4}
                 if m.pkg == "spark_rapids_tpu" else {})
    g = _retry_data(m, s).group_by("k").agg(
        m.Alias(m.Sum(m.col("v")), "s"), m.Alias(m.CountStar(), "c"))
    return _inject_each_alloc(m, lambda: _rounded(g.collect(),
                                                  ("k", "s", "c")))


def case_aggregate_repartition_merge(m, tmp):
    extra = {"srt.shuffle.partitions": 2} if m.pkg == "spark_rapids_tpu" \
        else {}
    s = _session(m, {**extra, "srt.sql.agg.mergePartitionRows": 256,
                     "srt.sql.batchSizeRows": 512})
    g = _retry_data(m, s).group_by("k").agg(m.Alias(m.Sum(m.col("v")), "s"))
    return _inject_each_alloc(m, lambda: _rounded(g.collect(), ("k", "s")))


def case_sub_partition_join(m, tmp):
    extra = {"srt.shuffle.partitions": 2} if m.pkg == "spark_rapids_tpu" \
        else {}
    s = _session(m, {**extra, "srt.sql.join.subPartitionRows": 512,
                     "srt.sql.broadcastRowThreshold": 1})
    fact = _retry_data(m, s, seed=3)
    dim = _frame(m, s, {"k": list(range(40)),
                        "w": [i * 3 for i in range(40)]})
    j = fact.join(dim, ([m.col("k")], [m.col("k")]), how="inner")
    return _inject_each_alloc(m, lambda: _rounded(j.collect(),
                                                  ("k", "v", "w")))


def case_window(m, tmp):
    s = _session(m, {"srt.shuffle.partitions": 4}
                 if m.pkg == "spark_rapids_tpu" else {})
    spec = m.WindowSpec(partition_by=[m.col("k")], order_fields=[])
    w = _retry_data(m, s, seed=5).select(
        m.col("k"), m.col("v"), m.Alias(m.Sum(m.col("v")).over(spec), "ws"))
    return _inject_each_alloc(m, lambda: _rounded(w.collect(),
                                                  ("k", "v", "ws")))


def case_merge_step_after_spill(m, tmp):
    """Partials forced to the spill tier before each run, so the merge's
    get() reserves and an injection lands inside merge_all."""
    s = _session(m, {"srt.shuffle.partitions": 4}
                 if m.pkg == "spark_rapids_tpu" else {})
    g = _retry_data(m, s, n=2000, seed=11).group_by("k").agg(
        m.Alias(m.Sum(m.col("v")), "s"))
    m.reset_task_context()
    oracle = _rounded(g.collect(), ("k", "s"))
    for at in range(0, 40, 3):
        m.reset_task_context()
        m.spill_catalog().synchronous_spill(1 << 40)
        m.task_context().force_retry_oom(num_allocs_before=at)
        assert _rounded(g.collect(), ("k", "s")) == oracle, \
            f"{m.pkg}: divergence at {at}"
    return oracle


RETRY_CASES = {f.__name__[5:]: f for f in (
    case_aggregate_merge, case_aggregate_repartition_merge,
    case_sub_partition_join, case_window, case_merge_step_after_spill)}


def _retry_case(m, tmp, name):
    # tiny device budget: the spillables spill, so their re-gets reserve
    _fresh(m, tmp, limit=1 << 18, host_limit=4 << 30)
    try:
        return RETRY_CASES[name](m, tmp)
    finally:
        _fresh(m, tmp, limit=1 << 40, host_limit=4 << 30)


def _corrupt_then_recompute(m, tmp, arm, disarm):
    """A spilled run corrupted before it returns to the device raises
    DataCorruption; a fresh run then sorts right."""
    data = _sort_data(6, 300, 13)

    def fresh():
        _fresh(m, tmp, limit=1 << 14, host_limit=4 << 30)
        return _run_sort(m, data, SORT_BUDGET)[0]["v"]
    arm()
    try:
        fresh()
        raised = "no error"
    except Exception as e:  # the package's own DataCorruption
        raised = type(e).__name__
    finally:
        disarm()
    got = fresh()
    want = sorted(v for d in data for v in d["v"])
    return [raised, got == want]


# --- the JAX side ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every case through the JAX package, in this process."""
    tmp = tmp_path_factory.mktemp("jax_memory")
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        m = _ns("spark_rapids_tpu")
        from spark_rapids_tpu.robustness.faults import (arm_fault_plan,
                                                        disarm_fault_plan)
        out = {}
        try:
            for name, fn in UNIT_CASES.items():
                out[name] = fn(m, tmp)
            for name in SORT_CASES:
                out[f"sort_{name}"] = case_sort(m, tmp, name)
            for name in RETRY_CASES:
                out[f"retry_{name}"] = _retry_case(m, tmp, name)
            out["corruption"] = _corrupt_then_recompute(
                m, tmp,
                lambda: arm_fault_plan("seed=7|spill.materialize:corrupt@1"),
                disarm_fault_plan)
            coalesce = m.CoalesceBatchesExec(_source(m, [
                _batch(m, {"x": list(range(i * 5, i * 5 + 5))})
                for i in range(8)]), target_rows=20)
            out["coalesce"] = [_pydict(m, b)["x"] for b in coalesce.execute(
                _ctx(m, m.SrtConf({})))]
        finally:
            m.reset_spill_catalog(budget=m.MemoryBudget(1 << 40))
        yield out


PORT = _ns("spark_rapids_tpu_torch")


def _close(got, want):
    """Equal, floats to RTOL relative."""
    if isinstance(got, float) and isinstance(want, float):
        return math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0)
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            _close(g, w) for g, w in zip(got, want))
    if isinstance(got, dict) and isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _close(got[k], want[k]) for k in got)
    return got == want


@pytest.fixture
def fresh_port(tmp_path):
    yield tmp_path
    PORT.reset_spill_catalog(budget=PORT.MemoryBudget(1 << 40),
                             spill_dir=str(tmp_path))
    PORT.reset_task_context()


@pytest.mark.parametrize("name", list(UNIT_CASES))
def test_memory_case_matches_jax(name, jax_side, fresh_port):
    got = UNIT_CASES[name](PORT, fresh_port)
    assert _close(got, jax_side[name]), (got, jax_side[name])


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_ooc_sort_matches_jax(name, jax_side, fresh_port):
    got = case_sort(PORT, fresh_port, name)
    want = jax_side[f"sort_{name}"]
    # the key columns in order; whole rows as a multiset, since rows tied
    # on the keys leave the JAX merge in merge order (the port keeps
    # their input order: test_ooc_merge_keeps_ties_in_input_order)
    keys = SORT_CASES[name]["kw"].get("keys", ("v",))
    assert all(got["rows"][k] == want["rows"][k] for k in keys)

    def row_set(rows):
        return sorted(zip(*(rows[k] for k in sorted(rows))),
                      key=lambda r: tuple((x is None, x) for x in r))
    assert _close(row_set(got["rows"]), row_set(want["rows"])), keys
    spec = SORT_CASES[name]
    flat = [v for d in _sort_data(*spec["data"]) for v in d["v"]]
    if name == "ascending":
        assert got["rows"]["v"] == sorted(flat)
    if name == "descending":
        assert got["rows"]["v"] == sorted(flat, reverse=True)
    if "budget" in spec:
        # the in-core path: no merge ran in either package
        assert got["peak"] == want["peak"] == 0
    else:
        # the merge ran, and its carry stayed within the row budget
        # (twice the budget where the runs cascade, as in the JAX suite)
        bound = 2 * SORT_BUDGET if name == "many_runs_cascade" \
            else SORT_BUDGET
        assert 0 < got["peak"] <= bound and 0 < want["peak"] <= bound
    if "inject" in spec:
        assert got["retries"] >= 1 and want["retries"] >= 1


@pytest.mark.parametrize("name", list(RETRY_CASES))
def test_retry_case_matches_jax(name, jax_side, fresh_port):
    got = _retry_case(PORT, fresh_port, name)
    assert _close(got, jax_side[f"retry_{name}"])


def test_corrupted_spill_raises_then_recomputes(jax_side, fresh_port,
                                                monkeypatch):
    from spark_rapids_tpu_torch.memory.spill import SpillableBatch
    real = SpillableBatch.spill_to_host
    armed = [False]

    def corrupting(self):
        freed = real(self)
        if armed[0] and freed:
            armed[0] = False
            self._host[0].view(torch.uint8).reshape(-1)[0] ^= 0xFF
        return freed

    def arm():
        armed[0] = True
        monkeypatch.setattr(SpillableBatch, "spill_to_host", corrupting)

    def disarm():
        monkeypatch.setattr(SpillableBatch, "spill_to_host", real)
    got = _corrupt_then_recompute(PORT, fresh_port, arm, disarm)
    assert jax_side["corruption"] == ["DataCorruption", True]
    assert got == jax_side["corruption"]


def test_corrupted_disk_buffer_raises(fresh_port):
    """A spilled file cut short on disk is at-rest corruption too."""
    cat = _fresh(PORT, fresh_port)
    sb = PORT.SpillableBatch(_two_cols(PORT, 64))
    sb.spill_to_host()
    sb.spill_to_disk()
    path = sb._paths[0][0]
    with open(path, "r+b") as f:
        f.truncate(3)
    with pytest.raises(DataCorruption):
        sb.get()
    assert sb.tier == "closed" and cat.budget.used == 0


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_decimal128_column_spills_bit_equal(tier, fresh_port):
    """A SpillableBatch of a Decimal128Column (hi, lo and validity) and a
    long-backed decimal comes back bit-equal from host and disk."""
    import decimal
    from spark_rapids_tpu_torch.columnar import dtypes as pdt
    from spark_rapids_tpu_torch.columnar.decimal128 import (
        Decimal128Column, from_unscaled_ints)
    _fresh(PORT, fresh_port)
    rng = np.random.default_rng(5)
    wide = [None if v % 7 == 0 else int(v) * (1 << 64) + int(w) for v, w in
            zip(rng.integers(-(1 << 62), 1 << 62, 300),
                rng.integers(0, 1 << 63, 300))]
    wide[:3] = [10 ** 38 - 1, -(10 ** 38 - 1), (1 << 64) - 1]
    dcol = from_unscaled_ints(wide, 512, pdt.DecimalType(38, 6),
                              device="cpu")
    narrow = column_from_numpy(
        np.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                  rng.integers(-10 ** 9, 10 ** 9, 300)], object), 512,
        pdt.DecimalType(12, 2), device="cpu")
    batch = ColumnarBatch([dcol, narrow], ["w", "m"], 300, "cpu")
    sb = PORT.SpillableBatch(batch)
    sb.spill_to_host()
    if tier == "disk":
        sb.spill_to_disk()
    back = sb.get()
    got = back.column("w")
    assert isinstance(got, Decimal128Column) and \
        got.dtype == pdt.DecimalType(38, 6)
    for a, b in ((got.hi, dcol.hi), (got.lo, dcol.lo),
                 (got.validity, dcol.validity),
                 (back.column("m").data, narrow.data)):
        assert torch.equal(a, b)
    assert got.to_numpy(3)[0].tolist() == wide[:3]
    sb.close()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_allocator_oom_while_unspilling_keeps_the_batch(tier, fresh_port,
                                                        monkeypatch):
    """A CUDA allocator failure in the copies back to the device leaves
    the batch in its spill tier with its reservation released; the
    retry block then brings it back bit-equal."""
    cat = _fresh(PORT, fresh_port)
    b = _batch(PORT, {"a": list(range(64)),
                      "b": [i * 0.5 for i in range(64)],
                      "s": [None if i % 7 == 0 else f"s{i}" for i in
                            range(64)]})
    want = [t.clone() for t in (b.column("a").data, b.column("b").data,
                                b.column("s").chars)]
    sb = PORT.SpillableBatch(b)
    del b
    sb.spill_to_host()
    if tier == "disk":
        sb.spill_to_disk()
    real = torch.Tensor.to
    fails = [0]

    def failing_to(self, *args, **kwargs):
        if fails[0]:
            fails[0] -= 1
            _oom()
        return real(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "to", failing_to)
    fails[0] = 1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sb.get()
    assert sb.tier == tier and cat.budget.used == 0
    fails[0] = 1
    got = PORT.with_retry_no_split(sb.get)
    assert PORT.task_context().retry_count == 1
    assert sb.tier == "device" and cat.budget.used == sb.nbytes
    for g, w in zip((got.column("a").data, got.column("b").data,
                     got.column("s").chars), want):
        assert g.dtype == w.dtype and torch.equal(
            g.view(torch.uint8), w.view(torch.uint8))
    sb.close()
    assert cat.budget.used == 0
    assert not list(fresh_port.rglob("*.buf"))


def test_a_cuda_budget_warns_without_expandable_segments(monkeypatch):
    """The allocator setting spill under a cap needs is read from the
    environment, and a budget for the card says when it is missing."""
    from spark_rapids_tpu_torch.memory import budget as B
    monkeypatch.delenv("PYTORCH_ALLOC_CONF", raising=False)
    conf = PORT.SrtConf({"srt.memory.tpu.poolSize": 1 << 20})
    for setting, on in (("", False), ("expandable_segments:False", False),
                        ("max_split_size_mb:64,expandable_segments:True",
                         True)):
        monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", setting)
        assert B.expandable_segments_enabled() is on
        B.reset_device_budget(None)
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                assert B.device_budget(conf, "cuda").limit == 1 << 20
                B.reset_device_budget(None)
                B.device_budget(conf, "cpu")
        finally:
            B.reset_device_budget(None)
        assert [w.category for w in seen] == \
            ([] if on else [RuntimeWarning]), setting


def test_coalesce_batches_matches_jax(jax_side):
    node = PORT.CoalesceBatchesExec(_source(PORT, [
        _batch(PORT, {"x": list(range(i * 5, i * 5 + 5))})
        for i in range(8)]), target_rows=20)
    got = [_pydict(PORT, b)["x"] for b in node.execute(
        _ctx(PORT, PORT.SrtConf({})))]
    assert got == jax_side["coalesce"]
    assert sum(got, []) == list(range(40)) and len(got) <= 3


# --- beyond the JAX suites ------------------------------------------------------

def _oom(*_):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")


def test_device_oom_spills_then_retries(fresh_port):
    """A CUDA allocator failure inside with_retry_no_split becomes a
    retry after every registered device batch has spilled."""
    _fresh(PORT, fresh_port)
    held = PORT.SpillableBatch(_two_cols(PORT, 64))
    fails = [1]

    def body():
        if fails[0]:
            fails[0] -= 1
            _oom()
        return "ok"
    assert PORT.with_retry_no_split(body) == "ok"
    assert PORT.task_context().retry_count == 1
    assert held.tier == "host"
    held.close()


def test_device_oom_that_repeats_splits(fresh_port):
    """A device OOM that repeats past the spill splits the attempt; the
    halves run on their own."""
    _fresh(PORT, fresh_port)
    ctx = PORT.reset_task_context()
    sb = PORT.SpillableBatch(_two_cols(PORT, 64))
    fails, rows = [2], []

    def fn(s):
        if fails[0]:
            fails[0] -= 1
            _oom()
        rows.append(s.get().num_rows)
        s.close()
        return True
    assert list(PORT.with_retry(sb, fn, split_policy=PORT.split)) == \
        [True, True]
    assert rows == [32, 32]
    assert (ctx.retry_count, ctx.split_count) == (1, 1)
    # a device OOM that never goes away ends in SplitAndRetryOOM once
    # the batch cannot be split further
    one = PORT.SpillableBatch(_two_cols(PORT, 1))
    with pytest.raises(PORT.SplitAndRetryOOM):
        list(PORT.with_retry(one, _oom, split_policy=PORT.split))
    assert isinstance(port_retry.DeviceOOM("x"), PORT.RetryOOM)


@pytest.mark.parametrize("lane", ["grouped", "global"])
def test_split_halves_take_the_kernel_lanes(lane, fresh_port):
    """An injected SplitAndRetryOOM at each per-batch retry block of the
    partial aggregate: the halves go through B3 (grouped) or B1 (global)
    on their own, one more kernel call per split, and the rows equal the
    clean run's and plain Python's."""
    _fresh(PORT, fresh_port)
    s = _session(PORT, {"srt.sql.batchSizeRows": 2048})
    df = _retry_data(PORT, s, n=N, seed=21)
    q = df.group_by("k").agg(PORT.Alias(PORT.Sum(PORT.col("v")), "s")) \
        if lane == "grouped" else df.agg(PORT.Alias(PORT.Sum(
            PORT.col("v")), "s"))
    keys = ("k", "s") if lane == "grouped" else ("s",)
    counter = DK.tile_group_reduce if lane == "grouped" else DK.tile_reduce
    DK.reset_counts()
    clean = _rounded(q.collect(), keys)
    clean_calls = counter.plain_calls
    assert clean_calls == 2  # one per 2048-row input batch
    rng = np.random.default_rng(21)
    k, v = rng.integers(0, 40, N), rng.uniform(0, 10, N)
    want = {}
    for kk, vv in zip(k.tolist(), v.tolist()):
        want[kk if lane == "grouped" else None] = \
            want.get(kk if lane == "grouped" else None, 0.0) + vv
    got = {(r[0] if lane == "grouped" else None): r[-1] for r in clean}
    assert got.keys() == want.keys() and all(
        math.isclose(got[x], want[x], rel_tol=RTOL) for x in want)
    total = PORT.task_context().alloc_attempts
    for at in range(total):
        PORT.task_context().force_split_and_retry_oom(num_allocs_before=at)
        DK.reset_counts()
        assert _rounded(q.collect(), keys) == clean
        tc = PORT.task_context()
        assert tc.retry_count + tc.split_count == 1, at
        assert counter.plain_calls == clean_calls + tc.split_count
        memory = s._last_execution[1].memory
        assert memory["splitAndRetryCount"] == tc.split_count


def test_oom_injection_conf_reaches_a_retry(fresh_port):
    _fresh(PORT, fresh_port)
    rows = {}
    for mode in ("NONE", "RETRY", "SPLIT"):
        s = _session(PORT, {"srt.test.oomInjection.mode": mode})
        g = _retry_data(PORT, s, n=500).group_by("k").agg(
            PORT.Alias(PORT.Sum(PORT.col("v")), "s"))
        rows[mode] = _rounded(g.collect(), ("k", "s"))
        mem = s._last_execution[1].memory
        assert (mem["retryCount"] + mem["splitAndRetryCount"] > 0) == \
            (mode != "NONE"), mode
    assert rows["RETRY"] == rows["NONE"] == rows["SPLIT"]


@pytest.mark.parametrize("n_batches,rows,budget,batch_rows", [
    (6, 300, 512, None), (12, 100, 512, None), (5, 700, 1024, 200),
    (8, 600, 4096, None), (8, 600, 4096, 500)])
@pytest.mark.parametrize("descending", [False, True])
def test_ooc_merge_keeps_ties_in_input_order(n_batches, rows, budget,
                                             batch_rows, descending,
                                             fresh_port):
    """Rows tied on the sort key leave the out-of-core merge (with and
    without the cascade, one chunk or several at a step, re-batched or
    not) in input order, as numpy's stable argsort and the in-core
    stable sort give them, and no step holds more rows than the
    budget."""
    _fresh(PORT, fresh_port)
    rng = np.random.default_rng(n_batches)
    data = [{"v": [None if rng.random() < 0.2 else int(x)
                   for x in rng.integers(0, 7, rows)],
             "p": list(range(i * rows, (i + 1) * rows))}
            for i in range(n_batches)]
    order = [PORT.SortOrder(PORT.col("v"), ascending=not descending)]
    node = PORT.SortExec(_source(PORT, [_batch(PORT, d) for d in data]),
                         order, batch_rows=batch_rows)
    ctx = _ctx(PORT, PORT.SrtConf({"srt.sql.sort.oocRowBudget": budget}))
    out = [_pydict(PORT, b) for b in node.execute(ctx)]
    assert 0 < ctx.metrics[node.exec_id]["sortOocPeakRows"].value <= budget
    assert all(list(o) == ["v", "p"] for o in out)
    if batch_rows is not None:
        assert all(len(o["p"]) == batch_rows for o in out[:-1])
    v = np.array([-1 if x is None else x for d in data for x in d["v"]])
    # ascending: nulls first; descending: nulls last
    key = v if not descending else np.where(v < 0, 99, -v)
    want = np.arange(len(v))[np.argsort(key, kind="stable")]
    assert [p for o in out for p in o["p"]] == want.tolist()


def _merge_keys(rng, n, wide):
    """Sort keys with ties, NULLs, NaN, -0.0 and strings of two lengths;
    with ``wide`` the integers span the whole int64 range."""
    ints = rng.integers(0, 5, n)
    if wide:
        ints = (ints - 2) * (1 << 61)
    floats = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan], n)
    strs = np.array([["ab", "abc", "b", "", "abcdefghij"][i]
                     for i in rng.integers(0, 5, n)], dtype=object)
    cap = choose_capacity(n)
    return [column_from_numpy(lane, cap, mask=rng.random(n) > 0.2,
                              device="cpu")
            for lane in (ints, floats, strs)]


@pytest.mark.parametrize("keys,wide", [
    ((0,), False), ((0,), True), ((0, 1, 2), False)],
    ids=["packed_ints", "searched_ints", "mixed"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_sorted_equals_a_stable_sort_of_the_concatenation(
        keys, wide, seed):
    """The out-of-core merge step: two sorted batches merged in linear
    time give the rows, in order, that the stable sort of their
    concatenation gives, under every key kind and direction, through
    the packed key and through the binary search."""
    from spark_rapids_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(seed)
    order = [int(x) for x in rng.permutation(keys)]
    asc = [bool(x) for x in rng.integers(0, 2, len(order))]
    nf = [bool(x) for x in rng.integers(0, 2, len(order))]
    sides = []
    for n, base in ((int(rng.integers(1, 300)), 0),
                    (int(rng.integers(1, 300)), 1000)):
        pos = column_from_numpy(np.arange(base, base + n),
                                choose_capacity(n), device="cpu")
        b = ColumnarBatch(_merge_keys(rng, n, wide) + [pos],
                          ["i", "f", "s", "p"], n, "cpu")
        sides.append(K.sort_batch(b, [b.columns[o] for o in order], asc,
                                  nf))
    a, b = sides
    got = K.merge_sorted(a, b, [a.columns[o] for o in order],
                         [b.columns[o] for o in order], asc, nf)
    both = K.concat_batches([a, b], choose_capacity(a.num_rows +
                                                    b.num_rows))
    want = K.sort_batch(both, [both.columns[o] for o in order], asc, nf)
    assert got.num_rows == want.num_rows == a.num_rows + b.num_rows
    assert _pydict(PORT, got)["p"] == _pydict(PORT, want)["p"]
