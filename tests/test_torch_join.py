"""The port's join, bloom, hash-claim grouping and top-N pieces held
against the JAX package on the same seeded inputs, on the CPU.

- ``join_gather_maps`` / ``inner_join``: the same candidate pairs in the
  same order and the same candidate totals (exact), on keys with nulls,
  duplicates and one zipf-heavy key whose matches overflow the first
  output capacity;
- the join execs through both DataFrame APIs: the direct path, the
  sub-partition path (``srt.sql.join.subPartitionRows`` set low in both
  packages' conf) with its hot-key chunking, the growth retry and the
  bloom pre-filter; joined rows equal as multisets, exactly (a join
  copies values);
- the bloom filter's bits (exact);
- ``_prelude_fast``: group ids, ``ok`` and group count (exact), and the
  fall back to the sort path when ``ok`` is false;
- ``TopNExec`` against the JAX package's sort + limit (exact order);
- ``left_join`` and ``semi_anti_join`` against the JAX package's, with
  their capacity reports, and every join type (left, right and full
  outer, semi, anti) through both DataFrame APIs and plain Python, on
  the direct and the sub-partition path (a hot key's bucket runs whole
  for the outer and anti joins), with the bloom pre-filter only where it
  is sound; an empty build side; NaN join keys (fault C5: Spark joins
  NaN to NaN, the JAX package does not, so plain Python is the
  reference); the nested-loop join with and without a condition; and
  ``session.sql``'s LEFT / RIGHT / FULL OUTER, CROSS and comma joins
  against plain Python.

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

import datetime

import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.expr import aggregates as Agg
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.core import Alias, col, lit
from spark_rapids_tpu_torch.ops import bloom as B
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.plan import host_table
from spark_rapids_tpu_torch.plan.session import DataFrame, TpuSession


@pytest.fixture(scope="module", autouse=True)
def _jax_cache_miss():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        global jK, jB, jdt, jhost, jcol, JConf, JSession
        import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.expr.core import col as jcol
        from spark_rapids_tpu.ops import bloom as jB
        from spark_rapids_tpu.ops import kernels as jK
        from spark_rapids_tpu.plan import host_table as jhost
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        yield


_JT = {}


def _jtypes():
    if not _JT:
        _JT.update({"bigint": jdt.INT64, "int": jdt.INT32,
                    "double": jdt.FLOAT64, "string": jdt.STRING,
                    "date": jdt.DATE})
    return _JT


def _both_batches(lanes, cap):
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=cap, device="cpu")
    jbatch = jhost.table_to_batch(jhost.HostTable(
        [jhost.HostColumn(v, m, _jtypes()[t]) for v, m, t in lanes.values()],
        list(lanes)), cap)
    return batch, jbatch


def _skewed_keys(rng, n, heavy, heavy_n, space):
    """int64 keys in [0, space) with ``heavy`` repeated ``heavy_n`` times
    and about 5% nulls."""
    keys = rng.integers(0, space, n).astype(np.int64)
    keys[rng.choice(n, heavy_n, replace=False)] = heavy
    return keys, rng.random(n) > 0.05


def _join_sides(seed=0, n_probe=1500, n_build=1000):
    rng = np.random.default_rng(seed)
    pk, pm = _skewed_keys(rng, n_probe, 7, 30, 400)
    bk, bm = _skewed_keys(rng, n_build, 7, 250, 400)
    words = np.array(["a", "bb", "ccc", "", "dddd"], dtype=object)
    probe = {"pk": (pk, pm, "bigint"),
             "ps": (words[rng.integers(0, 5, n_probe)],
                    rng.random(n_probe) > 0.1, "string"),
             "pv": (rng.uniform(-1, 1, n_probe), np.ones(n_probe, bool),
                    "double")}
    build = {"bk": (bk, bm, "bigint"),
             "bs": (words[rng.integers(0, 5, n_build)],
                    rng.random(n_build) > 0.1, "string"),
             "bv": (rng.uniform(-1, 1, n_build), rng.random(n_build) > 0.2,
                    "double")}
    return probe, build


def _valid_pairs(p_idx, b_idx, valid):
    v = np.asarray(valid)
    return np.asarray(p_idx)[v].astype(np.int64), \
        np.asarray(b_idx)[v].astype(np.int64)


@pytest.mark.parametrize("keys,out_cap", [
    (["pk"], 2048),        # cut: the heavy key overflows the capacity
    (["pk", "ps"], 8192),  # two keys, one a string, all candidates fit
])
def test_join_gather_maps_match_jax(keys, out_cap):
    probe, build = _join_sides()
    p, jp = _both_batches(probe, 2048)
    b, jb = _both_batches(build, 1024)
    bkeys = {"pk": "bk", "ps": "bs"}
    pk = [p.column(k) for k in keys]
    bk = [b.column(bkeys[k]) for k in keys]
    got = K.join_gather_maps(pk, bk, p.live_mask(), b.live_mask(), out_cap)
    ref = jK.join_gather_maps([jp.column(k) for k in keys],
                              [jb.column(bkeys[k]) for k in keys],
                              jp.live_mask(), jb.live_mask(), out_cap)
    assert got[3] == int(ref[3])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    for g, r in zip(_valid_pairs(*got[:3]), _valid_pairs(*ref[:3])):
        np.testing.assert_array_equal(g, r)


def _canon(rows):
    """Rows as a sorted multiset; a join copies values, so they compare
    exactly."""
    return sorted((tuple(r) for r in rows), key=repr)


def _rows(table):
    return _canon(zip(*host_table.to_pydict(table).values()))


def test_inner_join_matches_jax_and_reports_overflow():
    probe, build = _join_sides(seed=1)
    p, jp = _both_batches(probe, 2048)
    b, jb = _both_batches(build, 1024)
    pk, bk = [p.column("pk")], [b.column("bk")]
    small, total = K.inner_join(p, b, pk, bk, 2048)
    _, jtotal = jK.inner_join(jp, jb, [jp.column("pk")], [jb.column("bk")],
                              2048)
    assert total == int(jtotal) > 2048  # the heavy key overflows
    cap = 1 << (total - 1).bit_length()  # the retry's capacity
    out, total2 = K.inner_join(p, b, pk, bk, cap)
    jout, _ = jK.inner_join(jp, jb, [jp.column("pk")], [jb.column("bk")],
                            cap)
    assert total2 == total <= cap
    assert out.num_rows == int(jout.num_rows)
    got = _rows(host_table.batch_to_table(out))
    ref = _canon(zip(*jhost.to_pydict(jhost.batch_to_table(jout)).values()))
    assert got == ref
    assert small.num_rows < out.num_rows


SETTINGS = {"srt.sql.batchSizeRows": 1024,
            "srt.sql.join.bloomFilter.minProbeRows": 16}


def _join_both(settings, probe, build):
    """The same inner join through both DataFrame APIs; returns (port
    rows, JAX rows, port metric totals)."""
    session = TpuSession(carry.conf_from_dict(settings), device="cpu")
    pdf = session.create_dataframe(carry.host_table_from_lanes(probe))
    bdf = session.create_dataframe(carry.host_table_from_lanes(build))
    port = pdf.join(bdf, on=([col("pk")], [col("bk")])).to_table()
    metrics = session._last_execution[1].metric_totals()
    jsession = JSession(JConf(settings))

    def jdf(lanes):
        table = jhost.HostTable([jhost.HostColumn(v, m, _jtypes()[t])
                                 for v, m, t in lanes.values()], list(lanes))
        return jsession.create_dataframe(jhost.to_pydict(table),
                                         table.schema())
    ref = jdf(probe).join(jdf(build),
                          on=([jcol("pk")], [jcol("bk")])).collect()
    return _rows(port), _canon(r.values() for r in ref), metrics


@pytest.mark.parametrize("sub_rows", [None, 400])
def test_join_exec_matches_jax(sub_rows):
    probe, build = _join_sides(seed=2)
    settings = dict(SETTINGS)
    if sub_rows:
        settings["srt.sql.join.subPartitionRows"] = sub_rows
    got, ref, metrics = _join_both(settings, probe, build)
    assert got == ref and len(got) > 2500
    assert metrics.get("joinOverflowRetries", 0) > 0
    assert metrics.get("bloomFilteredRows", 0) > 0
    if sub_rows:
        # 1000 build rows over 400 per sub-partition; the hot key's
        # bucket is still over the threshold and joins in row chunks
        assert metrics["joinSubPartitions"] == 3
        assert metrics["joinSubPartitionSkew"] >= 1
    else:
        assert "joinSubPartitions" not in metrics


@pytest.mark.parametrize("parts", [2, 7])
def test_bucket_compact_matches_jax(parts):
    """Both packages put each key in the same sub-partition bucket."""
    probe, _ = _join_sides(seed=4)
    p, jp = _both_batches(probe, 2048)
    keys, jkeys = [p.column("pk"), p.column("ps")], \
        [jp.column("pk"), jp.column("ps")]
    ids = K.bucket_ids(keys, parts)
    total = 0
    for part in range(parts):
        got = K.bucket_compact(p, ids, part)
        ref = jK.bucket_compact(jp, jkeys, parts, part)
        if got is None:
            assert int(ref.num_rows) == 0
            continue
        assert got.num_rows == int(ref.num_rows)
        assert _rows(host_table.batch_to_table(got)) == _canon(
            zip(*jhost.to_pydict(jhost.batch_to_table(ref)).values()))
        total += got.num_rows
    assert total == p.num_rows


def test_bloom_filter_bits_match_jax():
    probe, build = _join_sides(seed=3)
    p, jp = _both_batches(probe, 2048)
    b, jb = _both_batches(build, 1024)
    nbits = B.choose_num_bits(b.num_rows)
    assert nbits == jB.choose_num_bits(jb.num_rows)
    bits = B.build_bloom([b.column("bk"), b.column("bs")], b.live_mask(),
                         nbits)
    jbits = jB.build_bloom([jb.column("bk"), jb.column("bs")],
                           jb.live_mask(), nbits)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    hit = B.might_contain(bits, [p.column("pk"), p.column("ps")])
    jhit = jB.might_contain(jbits, [jp.column("pk"), jp.column("ps")])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    # no false negatives: every probe row with a real match is kept
    _, b_idx, valid, _, _ = K.join_gather_maps(
        [p.column("pk"), p.column("ps")], [b.column("bk"), b.column("bs")],
        p.live_mask(), b.live_mask(), 1 << 15)
    p_idx = K.join_gather_maps(
        [p.column("pk"), p.column("ps")], [b.column("bk"), b.column("bs")],
        p.live_mask(), b.live_mask(), 1 << 15)[0]
    assert bool(hit[p_idx[valid]].all())


def _group_lanes(n, distinct, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, distinct, n).astype(np.int64)
    f = np.round(rng.uniform(0, 5, n), 0)
    f[::19] = np.nan
    words = np.array([f"w{i}" for i in range(7)] + ["", "longer word"],
                     dtype=object)
    return {"k": (k, rng.random(n) > 0.05, "bigint"),
            "f": (f, rng.random(n) > 0.05, "double"),
            "s": (words[rng.integers(0, len(words), n)],
                  rng.random(n) > 0.1, "string"),
            "v": (rng.uniform(-1, 1, n), np.ones(n, bool), "double")}


@pytest.mark.parametrize("n,distinct,keys,seed", [
    (3000, 40, ["k", "s"], 0),      # few groups, strings with nulls
    (3000, 2500, ["k"], 1),         # mostly distinct keys
    (4000, 9, ["f", "s"], 2),       # NaN and null float keys
])
def test_prelude_fast_matches_jax(n, distinct, keys, seed):
    lanes = _group_lanes(n, distinct, seed)
    batch, jbatch = _both_batches(lanes, 4096)
    ok, (_, live, gid, num_groups, kb) = K._prelude_fast(
        batch, [batch.column(k) for k in keys])
    jok, (_, _, jgid, jnum, _) = jK._prelude_fast(
        jbatch, [jbatch.column(k) for k in keys])
    assert ok == bool(jok) and ok
    assert num_groups == int(jnum) == kb.num_rows
    live = live.numpy()
    np.testing.assert_array_equal(gid.numpy()[live],
                                  np.asarray(jgid)[live])
    assert bool((gid[~torch.from_numpy(live)] == num_groups).all())


def test_group_aggregate_falls_back_when_claim_fails(monkeypatch):
    lanes = _group_lanes(3000, 50, 4)
    batch, _ = _both_batches(lanes, 4096)
    keys = [batch.column("k"), batch.column("s")]
    v = batch.column("v")
    fns = [Agg.Sum(col("v")), Agg.CountStar()]
    stats = {}
    kb, st = K.group_aggregate(batch, keys, [v, None], fns, stats=stats)
    assert stats == {"claimResolved": 1}

    real = K._prelude_fast
    # a claim that reports a collision: the sort path must run instead
    monkeypatch.setattr(K, "_prelude_fast",
                        lambda b, k: (False, real(b, k)[1]))
    stats = {}
    kb2, st2 = K.group_aggregate(batch, keys, [v, None], fns, stats=stats)
    assert stats == {"claimFallbacks": 1}

    def by_key(kbatch, states):
        cols = [c.to_numpy(kbatch.num_rows) for c in kbatch.columns]
        keys_ = [list(vals.to_objects()) if hasattr(vals, "to_objects")
                 else list(vals) for vals, _ in cols]
        return {tuple(k[r] if m[r] else None for k, (_, m) in
                      zip(keys_, cols)):
                (round(float(states[0]["sum"][r]), 9),
                 int(states[1]["count"][r]))
                for r in range(kbatch.num_rows)}
    assert by_key(kb, st) == by_key(kb2, st2)


def test_top_n_matches_jax():
    rng = np.random.default_rng(7)
    n = 5000
    x = np.round(rng.uniform(-100, 100, n), 1)
    x[::97] = np.nan
    lanes = {"x": (x, rng.random(n) > 0.05, "double"),
             "i": (np.arange(n, dtype=np.int64), np.ones(n, bool), "bigint")}
    session = TpuSession(carry.conf_from_dict({"srt.sql.batchSizeRows": 512}),
                         device="cpu")
    df = session.create_dataframe(carry.host_table_from_lanes(lanes))
    for asc in (False, True):
        q = df.sort("x", "i", ascending=[asc, True]).limit(25)
        assert "TopN[25]" in q.explain()
        got = q.collect()
        table = jhost.HostTable([jhost.HostColumn(v, m, _jtypes()[t])
                                 for v, m, t in lanes.values()], list(lanes))
        jdf = JSession(JConf({"srt.sql.batchSizeRows": 512})) \
            .create_dataframe(jhost.to_pydict(table), table.schema())
        ref = jdf.sort("x", "i", ascending=[asc, True]).limit(25).collect()
        assert len(got) == len(ref) == 25
        for g, r in zip(got, ref):
            assert g["i"] == r["i"]
            assert (g["x"] is None and r["x"] is None) or \
                np.isnan(g["x"]) and np.isnan(r["x"]) or g["x"] == r["x"]


def test_limit_without_sort_keeps_the_first_rows():
    lanes = {"i": (np.arange(3000, dtype=np.int64), np.ones(3000, bool),
                   "bigint")}
    session = TpuSession(carry.conf_from_dict({"srt.sql.batchSizeRows": 512}),
                         device="cpu")
    q = session.create_dataframe(carry.host_table_from_lanes(lanes)) \
        .limit(700)
    assert "LocalLimit[700]" in q.explain()
    assert [r["i"] for r in q.collect()] == list(range(700))


def test_exec_context_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ExecContext().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecContext()
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuSession()
    assert ExecContext(device="cpu").device.type == "cpu"


def test_join_refuses_what_is_not_ported():
    """A condition on an outer, semi or anti join and a keyless outer
    join run on the CPU engine (the name is kept from when the port
    refused them; ROADMAP C10), against plain Python: the condition
    decides which key-matched pairs match, and an unmatched row is
    null-extended."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.plan import logical as L
    session = TpuSession(device="cpu")
    a = [0, 1, 2, 3, 3, None]
    df = session.create_dataframe({"a": a}, [("a", dt.INT64)])
    other = session.create_dataframe({"b": [1, 3, 3, 5, None]},
                                     [("b", dt.INT64)])
    bs = [1, 3, 3, 5, None]
    cond = P.GreaterThan(col("b"), lit(2))
    cases = [("left_outer", True), ("left_semi", True), ("left_anti", True),
             ("full_outer", True), ("left_outer", False),
             ("right_outer", False)]
    for how, keyed in cases:
        keys = ([col("a")], [col("b")]) if keyed else ([], [])
        plan = L.Join(df.plan, other.plan, *keys, how,
                      condition=cond if keyed else
                      P.LessThan(col("a"), col("b")))
        q = DataFrame(session, plan)
        assert q.explain("NOT_ON_TPU").splitlines()[0].startswith(
            "! Join"), how
        got = sorted((tuple(r.values()) for r in q.collect()), key=repr)

        def match(x, y):
            if x is None or y is None:
                return False
            return (x == y and y > 2) if keyed else x < y
        li = [(x, [y for y in bs if match(x, y)]) for x in a]
        if how == "left_semi":
            want = [(x,) for x, m in li if m]
        elif how == "left_anti":
            want = [(x,) for x, m in li if not m]
        else:
            want = [(x, y) for x, m in li for y in (m or [None])]
            if how == "right_outer":
                want = [(x, y) for x, y in want if y is not None] + [
                    (None, y) for y in bs
                    if not any(match(x, y) for x in a)]
            if how == "full_outer":
                want += [(None, y) for y in bs
                         if not any(match(x, y) for x in a)]
        assert got == sorted(want, key=repr), how
    with pytest.raises(ValueError, match="unknown join type"):
        df.join(other, on=([col("a")], [col("b")]), how="sideways")


def test_join_keys_of_differing_types_meet_through_a_cast():
    """bigint = int keys join after a Cast of the int side to bigint
    (the JAX planner's _coerce_join_keys)."""
    from spark_rapids_tpu_torch.expr.cast import Cast
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    session = TpuSession(device="cpu")
    df = session.create_dataframe(carry.host_table_from_lanes(
        {"a": (np.arange(4, dtype=np.int64), np.ones(4, bool), "bigint")}))
    other = session.create_dataframe(carry.host_table_from_lanes(
        {"b": (np.array([3, 1, 1, 9], np.int32),
               np.array([1, 1, 1, 0], bool), "int")}))
    joined = df.join(other, on=([col("a")], [col("b")]))
    physical = apply_overrides(joined.plan, session.conf)
    assert isinstance(physical.right_keys[0], Cast)
    rows = sorted((r["a"], r["b"]) for r in joined.collect())
    assert rows == [(1, 1), (1, 1), (3, 3)]


def test_join_using_keeps_the_key_once():
    session = TpuSession(device="cpu")
    left = session.create_dataframe(carry.host_table_from_lanes(
        {"a": (np.array([1, 2, 2, 3], np.int64), np.ones(4, bool), "bigint"),
         "x": (np.array([10, 20, 21, 30], np.int64), np.ones(4, bool),
               "bigint")}))
    right = session.create_dataframe(carry.host_table_from_lanes(
        {"a": (np.array([2, 3, 3, 4], np.int64), np.ones(4, bool), "bigint"),
         "y": (np.array([5, 6, 7, 8], np.int64), np.ones(4, bool),
               "bigint")}))
    rows = left.join(right, on="a").collect()
    assert sorted((r["a"], r["x"], r["y"]) for r in rows) == [
        (2, 20, 5), (2, 21, 5), (3, 30, 6), (3, 30, 7)]
    assert list(rows[0]) == ["a", "x", "y"]


def test_dates_join_as_keys():
    session = TpuSession(device="cpu")
    d = np.array([8000, 8001, 8001, 9000], np.int32)
    left = session.create_dataframe(carry.host_table_from_lanes(
        {"d": (d, np.ones(4, bool), "date")}))
    right = session.create_dataframe(carry.host_table_from_lanes(
        {"e": (d[::-1].copy(), np.ones(4, bool), "date")}))
    rows = left.join(right, on=([col("d")], [col("e")])).collect()
    assert len(rows) == 6
    assert all(r["d"] == r["e"] and isinstance(r["d"], datetime.date)
               for r in rows)


# --- outer, semi, anti and nested-loop joins --------------------------------


def _py_rows(lanes):
    """Rows of {name: (values, mask, type)} lanes as tuples of Python
    values, None for null."""
    cols = [[(v.item() if hasattr(v, "item") else v) if m else None
             for v, m in zip(vals, mask)] for vals, mask, _ in lanes.values()]
    return list(zip(*cols))


def _key_eq(a, b):
    """Spark's join key equality: a null matches nothing, NaN = NaN."""
    if a is None or b is None:
        return False
    return a == b or (a != a and b != b)


def _py_join(left, right, li, ri, how, n_left, n_right):
    """Plain Python join of row tuples on column li = column ri."""
    out, right_hit = [], set()
    for lrow in left:
        hits = [j for j, r in enumerate(right) if _key_eq(lrow[li], r[ri])]
        right_hit.update(hits)
        if how == "left_semi":
            out += [lrow] if hits else []
        elif how == "left_anti":
            out += [] if hits else [lrow]
        else:
            out += [lrow + right[j] for j in hits]
            if not hits and how in ("left_outer", "full_outer"):
                out.append(lrow + (None,) * n_right)
    if how in ("right_outer", "full_outer"):
        out += [(None,) * n_left + r for j, r in enumerate(right)
                if j not in right_hit]
    return out


def _repr_canon(rows):
    """Rows as a sorted multiset of reprs (NaN != NaN as a float)."""
    return sorted(repr(tuple(r)) for r in rows)


_HOW = {"left": "left_outer", "right": "right_outer", "full": "full_outer",
        "semi": "left_semi", "anti": "left_anti", "inner": "inner"}


def test_c5_nan_keys_join_as_in_spark():
    """y = (0.0, -0.0, NaN, -NaN) joined to z = (-0.0, NaN) on y = z:
    both zeros match -0.0 and both NaNs match NaN, 4 rows (the JAX
    package keeps only the two zero rows)."""
    y = np.array([0.0, -0.0, np.nan, -np.nan])
    z = np.array([-0.0, np.nan])
    left = {"y": (y, np.ones(4, bool), "double")}
    right = {"z": (z, np.ones(2, bool), "double")}
    want = _py_join(_py_rows(left), _py_rows(right), 0, 0, "inner", 1, 1)
    assert len(want) == 4
    session = TpuSession(device="cpu")
    ldf = session.create_dataframe(carry.host_table_from_lanes(left))
    rdf = session.create_dataframe(carry.host_table_from_lanes(right))
    got = ldf.join(rdf, on=([col("y")], [col("z")])).collect()
    assert _repr_canon(tuple(r.values()) for r in got) == _repr_canon(want)
    anti = ldf.join(rdf, on=([col("y")], [col("z")]), how="anti").collect()
    assert anti == []
    # the kernel itself: every candidate pair verifies
    lb, rb = (host_table.table_to_batch(carry.host_table_from_lanes(x),
                                        device="cpu") for x in (left, right))
    _, _, valid, total, _ = K.join_gather_maps(
        [lb.column("y")], [rb.column("z")], lb.live_mask(), rb.live_mask(),
        8)
    assert total == int(valid.sum()) == 4


def test_left_join_kernel_matches_jax_and_reports_its_need():
    probe, build = _join_sides(seed=5)
    p, jp = _both_batches(probe, 2048)
    b, jb = _both_batches(build, 1024)
    pk, bk = [p.column("pk")], [b.column("bk")]
    jpk, jbk = [jp.column("pk")], [jb.column("bk")]
    out, need = K.left_join(p, b, pk, bk, 2048)
    _, jneed = jK.left_join(jp, jb, jpk, jbk, 2048)
    assert out is None and need == int(jneed) > 2048
    cap = 1 << (need - 1).bit_length()
    out, need2 = K.left_join(p, b, pk, bk, cap)
    jout, jneed2 = jK.left_join(jp, jb, jpk, jbk, cap)
    # with every candidate in the window, the unmatched probe rows are
    # known: the output outgrows the candidates, still within the retry
    assert need < need2 == int(jneed2) == out.num_rows <= cap
    assert out.num_rows == int(jout.num_rows)
    got = _rows(host_table.batch_to_table(out))
    assert got == _canon(zip(*jhost.to_pydict(
        jhost.batch_to_table(jout)).values()))
    want = _py_join(_py_rows(probe), _py_rows(build), 0, 0, "left_outer",
                    3, 3)
    assert _repr_canon(got) == _repr_canon(want)


@pytest.mark.parametrize("anti", [False, True])
def test_semi_anti_join_kernel_matches_jax(anti):
    probe, build = _join_sides(seed=6)
    p, jp = _both_batches(probe, 2048)
    b, jb = _both_batches(build, 1024)
    args = ([b.column("bk")], [p.column("pk")], b.live_mask(), anti)
    jargs = ([jb.column("bk")], [jp.column("pk")], jb.live_mask(), anti)
    _, total = K.semi_anti_join(p, *args)
    _, jtotal = jK.semi_anti_join(jp, *jargs)
    # the candidate window overflows the probe's capacity: the exec retries
    assert total == int(jtotal) > p.capacity
    cap = 1 << (total - 1).bit_length()
    out, _ = K.semi_anti_join(p, *args, scratch_capacity=cap)
    jout, _ = jK.semi_anti_join(jp, *jargs, scratch_capacity=cap)
    got = _rows(host_table.batch_to_table(out))
    assert got == _canon(zip(*jhost.to_pydict(
        jhost.batch_to_table(jout)).values()))
    how = "left_anti" if anti else "left_semi"
    want = _py_join(_py_rows(probe), _py_rows(build), 0, 0, how, 3, 3)
    assert _repr_canon(got) == _repr_canon(want)


def _dfs(session, probe, build):
    return (session.create_dataframe(carry.host_table_from_lanes(probe)),
            session.create_dataframe(carry.host_table_from_lanes(build)))


@pytest.mark.parametrize("sub_rows", [None, 400])
@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_join_types_match_jax_and_python(how, sub_rows):
    """Each join type through both DataFrame APIs and plain Python, on
    null and duplicated keys whose matches overflow the first output
    capacity; with a small ``subPartitionRows`` the hot key's bucket
    stays over the threshold and runs whole (row chunks of the build
    side would emit a left outer or anti row once per chunk)."""
    probe, build = _join_sides(seed=8)
    settings = dict(SETTINGS)
    if sub_rows:
        settings["srt.sql.join.subPartitionRows"] = sub_rows
    session = TpuSession(carry.conf_from_dict(settings), device="cpu")
    pdf, bdf = _dfs(session, probe, build)
    on = ([col("pk")], [col("bk")])
    got = _rows(pdf.join(bdf, on=on, how=how).to_table())
    metrics = session._last_execution[1].metric_totals()
    jsession = JSession(JConf(settings))

    def jdf(lanes):
        table = jhost.HostTable([jhost.HostColumn(v, m, _jtypes()[t])
                                 for v, m, t in lanes.values()], list(lanes))
        return jsession.create_dataframe(jhost.to_pydict(table),
                                         table.schema())
    ref = jdf(probe).join(jdf(build), on=([jcol("pk")], [jcol("bk")]),
                          how=how).collect()
    assert got == _canon(r.values() for r in ref)
    want = _py_join(_py_rows(probe), _py_rows(build), 0, 0, _HOW[how], 3, 3)
    assert _repr_canon(got) == _repr_canon(want)
    if sub_rows and how in ("left", "semi", "anti"):
        assert metrics["joinSubPartitions"] == 3
        assert metrics["joinSubPartitionSkew"] >= 1
    # the bloom pre-filter runs only where a dropped row makes no output
    assert ("bloomFilteredRows" in metrics) == (how == "semi")
    assert metrics.get("joinOverflowRetries", 0) > 0 or how == "anti"


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_with_an_empty_build_side(how):
    """No build row: nothing for inner and semi joins, the probe rows
    for anti, null-extended rows (strings read as NULL) for the outer
    joins that preserve the non-empty side."""
    probe, build = _join_sides(seed=9, n_probe=300, n_build=300)
    session = TpuSession(device="cpu")
    pdf, bdf = _dfs(session, probe, build)
    empty = bdf.filter(P.LessThan(col("bk"), lit(-1)))
    rows = pdf.join(empty, on=([col("pk")], [col("bk")]), how=how).collect()
    want = _py_join(_py_rows(probe), [], 0, 0, _HOW[how], 3, 3)
    assert _repr_canon(tuple(r.values()) for r in rows) == \
        _repr_canon(want)
    if how in ("left", "full"):
        assert len(rows) == 300 and all(r["bs"] is None for r in rows)


@pytest.mark.parametrize("with_condition", [False, True])
def test_nested_loop_join_matches_jax_and_python(with_condition):
    """cross_join with and without a condition; the exec pairs in tiles
    of 7 rows, so tiles cross probe rows."""
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    rng = np.random.default_rng(10)
    left = {"a": (rng.integers(0, 9, 23), rng.random(23) > 0.1, "bigint"),
            "s": (np.array(["x", "yy", ""], object)[rng.integers(0, 3, 23)],
                  rng.random(23) > 0.1, "string")}
    right = {"b": (rng.integers(0, 9, 11), rng.random(11) > 0.1, "bigint")}
    session = TpuSession(device="cpu")
    ldf, rdf = _dfs(session, left, right)
    cond = P.LessThan(col("a"), col("b")) if with_condition else None
    q = ldf.cross_join(rdf, cond)
    physical = apply_overrides(q.plan, session.conf)
    assert type(physical).__name__ == ("BroadcastNestedLoopJoinExec"
                                       if with_condition
                                       else "CartesianProduct"
                                       "Exec")
    physical.tile_rows = 7
    got = _canon(r for b in physical.execute(ExecContext(device="cpu"))
                 for r in zip(*host_table.to_pydict(
                     host_table.batch_to_table(b)).values()))
    want = [l + r for l in _py_rows(left) for r in _py_rows(right)
            if not with_condition or (l[0] is not None and r[0] is not None
                                      and l[0] < r[0])]
    assert got == _canon(want)
    assert _rows(q.to_table()) == got
    jsession = JSession(JConf({}))

    def jdf(lanes):
        table = jhost.HostTable([jhost.HostColumn(v, m, _jtypes()[t])
                                 for v, m, t in lanes.values()], list(lanes))
        return jsession.create_dataframe(jhost.to_pydict(table),
                                         table.schema())
    from spark_rapids_tpu.expr import predicates as jP
    jcond = jP.LessThan(jcol("a"), jcol("b")) if with_condition else None
    ref = jdf(left).cross_join(jdf(right), jcond).collect()
    assert got == _canon(r.values() for r in ref)


def _sql_tables():
    """l(k, a) and r(k, b) with NULL and duplicated keys."""
    rng = np.random.default_rng(11)

    def side(n, name):
        return {"k": (rng.integers(0, 6, n).astype(np.int64),
                      rng.random(n) > 0.15, "bigint"),
                name: (np.arange(n, dtype=np.int64) * 10, np.ones(n, bool),
                       "bigint")}
    return side(17, "a"), side(13, "b")


@pytest.mark.parametrize("kind", ["LEFT JOIN", "RIGHT JOIN",
                                  "FULL OUTER JOIN", "JOIN"])
def test_sql_outer_joins_match_python(kind):
    """``session.sql``'s LEFT, RIGHT and FULL OUTER JOIN against plain
    Python, NULL keys matching nothing and null-extended rows reading
    NULL in every column of the other side."""
    left, right = _sql_tables()
    session = TpuSession(device="cpu")
    ldf, rdf = _dfs(session, left, right)
    session.create_or_replace_temp_view("l", ldf)
    session.create_or_replace_temp_view("r", rdf)
    rows = session.sql(f"SELECT l.k, a, r.k AS rk, b FROM l {kind} r "
                       "ON l.k = r.k").collect()
    how = {"LEFT JOIN": "left_outer", "RIGHT JOIN": "right_outer",
           "FULL OUTER JOIN": "full_outer", "JOIN": "inner"}[kind]
    want = _py_join(_py_rows(left), _py_rows(right), 0, 0, how, 2, 2)
    assert _repr_canon(tuple(r.values()) for r in rows) == \
        _repr_canon(want)


@pytest.mark.parametrize("text,cond", [
    ("SELECT a, b FROM l CROSS JOIN r", lambda a, b: True),
    ("SELECT a, b FROM l, r WHERE a < b", lambda a, b: a < b),
])
def test_sql_cross_and_comma_joins_match_python(text, cond):
    left, right = _sql_tables()
    session = TpuSession(device="cpu")
    ldf, rdf = _dfs(session, left, right)
    session.create_or_replace_temp_view("l", ldf)
    session.create_or_replace_temp_view("r", rdf)
    rows = session.sql(text).collect()
    want = [(l[1], r[1]) for l in _py_rows(left) for r in _py_rows(right)
            if cond(l[1], r[1])]
    assert _repr_canon(tuple(r.values()) for r in rows) == \
        _repr_canon(want)
