"""The port's conditional, cast, substring and IN expressions held
against the JAX package's on the same seeded 200-row batch with nulls,
on the CPU: ``If``, ``CaseWhen`` (numeric, string and mixed-width
branches, with and without ELSE), ``Coalesce``, ``NullIf``, ``Nvl``,
``Nvl2``, ``Cast`` between numeric, boolean and date types (NaN, the
infinities and out-of-range values included), ``Substring`` and ``InSet``
over strings and integers (a null in the integer set), string ``<>``,
and the arithmetic and comparison coercions of the NDS texts. Values and
null masks must be equal exactly.

Two string cases are held against plain Python over the same lanes
instead, because the JAX package gets them wrong (ROADMAP.md C4): its
string ``Coalesce`` cuts a result whose bytes outgrow both inputs' char
buffers ('dd ee' comes back 'dd e'), and its string ``IN`` fails on a
null in the set. So are the faults this port repairs and the JAX
package keeps (ROADMAP.md C8, C9): a float cast to SMALLINT or TINYINT
goes through INT and wraps, and ``Substring`` counts code points with
Spark's ``substringSQL`` bounds. String MIN / MAX in a GROUP BY (C7)
run through both packages' ``session.sql`` and plain Python, and string
``<`` / ``>`` raise ``SqlError`` in the port's analyzer.

Every JAX cache read is made a miss for this module (tests/conftest.py
wraps jax's ``_cache_read`` with four arguments; this jax passes five),
and the JAX package is imported under that patch.
"""

import types

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.vector import ColumnarBatch
from spark_rapids_tpu_torch.expr import cast, conditional, predicates
from spark_rapids_tpu_torch.expr import strings
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.plan import host_table

N, CAP = 200, 256


@pytest.fixture(scope="module", autouse=True)
def jax_ns():
    from jax._src import compiler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiler, "_cache_read", lambda *a, **k: (None, None))
        import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.columnar import vector as jvector
        from spark_rapids_tpu.expr import cast as jcast
        from spark_rapids_tpu.expr import conditional as jcond
        from spark_rapids_tpu.expr import predicates as jpred
        from spark_rapids_tpu.expr import strings as jstr
        from spark_rapids_tpu.expr.core import col as jcol
        from spark_rapids_tpu.expr.core import lit as jlit
        from spark_rapids_tpu.plan import host_table as jhost
        yield types.SimpleNamespace(
            dt=jdt, col=jcol, lit=jlit, cond=jcond, cast=jcast, pred=jpred,
            str=jstr, host=jhost, vector=jvector)


def _lanes():
    rng = np.random.default_rng(4)
    v = rng.uniform(-50, 50, N)
    v[:6] = [np.nan, np.inf, -np.inf, 3e10, -3e19, 2.0 ** 63]
    words = np.array(["a", "bc", "", "ccc", "store7", "dd ee"], dtype=object)
    return {
        "k": (rng.integers(-3, 9, N).astype(np.int64),
              rng.random(N) > 0.1, "bigint"),
        "i": (rng.integers(-2 ** 31, 2 ** 31 - 1, N).astype(np.int64),
              rng.random(N) > 0.1, "bigint"),
        "v": (v, rng.random(N) > 0.15, "double"),
        "w": (rng.uniform(0, 1, N), rng.random(N) > 0.5, "double"),
        "s": (words[rng.integers(0, 6, N)], rng.random(N) > 0.1, "string"),
        "s2": (words[rng.integers(0, 6, N)], rng.random(N) > 0.1, "string"),
        "d": (rng.integers(9000, 11000, N).astype(np.int32),
              rng.random(N) > 0.1, "date"),
        "b": (rng.random(N) > 0.5, rng.random(N) > 0.1, "boolean"),
    }


@pytest.fixture(scope="module")
def batches(jax_ns):
    lanes = _lanes()
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=CAP, device="cpu")
    jt = {"bigint": jax_ns.dt.INT64, "double": jax_ns.dt.FLOAT64,
          "string": jax_ns.dt.STRING, "date": jax_ns.dt.DATE,
          "boolean": jax_ns.dt.BOOL}
    jbatch = jax_ns.host.table_to_batch(jax_ns.host.HostTable(
        [jax_ns.host.HostColumn(v, m, jt[t]) for v, m, t in lanes.values()],
        list(lanes)), CAP)
    return batch, jbatch


def _port_ns():
    return types.SimpleNamespace(dt=dt, col=col, lit=lit, cond=conditional,
                                 cast=cast, pred=predicates, str=strings)


#: name -> the expression, made from either package's namespace
EXPRS = {
    "if_double": lambda m: m.cond.If(m.col("v") > 0.0, m.col("v"),
                                     m.col("w")),
    "if_string": lambda m: m.cond.If(m.col("k") < 3, m.col("s"),
                                     m.col("s2")),
    "case_int_literals": lambda m: m.cond.CaseWhen(
        [(m.col("k") < 0, m.lit(1)), (m.col("k") < 5, m.lit(2))],
        m.lit(0)),
    "case_no_else": lambda m: m.cond.CaseWhen([(m.col("k") > 2,
                                                m.col("v"))]),
    "case_mixed_width": lambda m: m.cond.CaseWhen(
        [(m.col("k") < 5, m.col("k"))], m.lit(0)),
    "case_double_else": lambda m: m.cond.CaseWhen(
        [(m.col("s") == "a", m.col("w"))], m.lit(0.0)),
    "case_string": lambda m: m.cond.CaseWhen(
        [(m.col("k") < 2, m.col("s")), (m.col("k") < 6, m.lit("mid"))],
        m.col("s2")),
    "coalesce_double": lambda m: m.cond.Coalesce(m.col("v"), m.col("w"),
                                                 m.lit(-1.0)),
    "nullif_int": lambda m: m.cond.NullIf(m.col("k"), m.lit(3)),
    "nullif_string": lambda m: m.cond.NullIf(m.col("s"), m.lit("a")),
    "nvl": lambda m: m.cond.Nvl(m.col("w"), m.lit(0.5)),
    "nvl2": lambda m: m.cond.Nvl2(m.col("w"), m.col("v"), m.lit(7.0)),
    "cast_double_bigint": lambda m: m.cast.Cast(m.col("v"), m.dt.INT64),
    "cast_double_int": lambda m: m.cast.Cast(m.col("v"), m.dt.INT32),
    "cast_double_smallint": lambda m: m.cast.Cast(m.col("v"), m.dt.INT16),
    "cast_bigint_int": lambda m: m.cast.Cast(m.col("i"), m.dt.INT32),
    "cast_bigint_tinyint": lambda m: m.cast.Cast(m.col("i"), m.dt.INT8),
    "cast_bigint_double": lambda m: m.cast.Cast(m.col("i"), m.dt.FLOAT64),
    "cast_bigint_float": lambda m: m.cast.Cast(m.col("i"), m.dt.FLOAT32),
    "cast_double_boolean": lambda m: m.cast.Cast(m.col("v"), m.dt.BOOL),
    "cast_boolean_int": lambda m: m.cast.Cast(m.col("b"), m.dt.INT32),
    "cast_boolean_double": lambda m: m.cast.Cast(m.col("b"), m.dt.FLOAT64),
    "cast_date_int": lambda m: m.cast.Cast(m.col("d"), m.dt.INT32),
    "cast_date_bigint": lambda m: m.cast.Cast(m.col("d"), m.dt.INT64),
    "substring_mid": lambda m: m.str.Substring(m.col("s"), 2, 3),
    "substring_tail": lambda m: m.str.Substring(m.col("s"), -2),
    "substring_zero": lambda m: m.str.Substring(m.col("s"), 0, 2),
    "substring_q79": lambda m: m.str.Substring(m.col("s"), 1, 30),
    "substring_past_end": lambda m: m.str.Substring(m.col("s"), 4, 2),
    "in_strings": lambda m: m.pred.InSet(m.col("s"), ["a", "ccc"]),
    "in_ints": lambda m: m.pred.InSet(m.col("k"), [1, 5, None]),
    "not_in_strings": lambda m: m.pred.Not(m.pred.InSet(
        m.col("s"), ["store7", "bc"])),
    "string_ne": lambda m: m.pred.Not(m.pred.EqualTo(m.col("s"),
                                                     m.col("s2"))),
    # the literal and column coercions of the NDS texts: int - int
    # against an int literal (q62), a negative double literal (q43),
    # int columns against double literals, BETWEEN's lowering
    "int_minus_int_le": lambda m: (m.col("i") - m.col("k")) <= 30,
    "unary_minus": lambda m: -m.col("v"),
    "int_gt_double_literal": lambda m: m.col("k") > 2.5,
    "double_eq_negative_literal": lambda m: m.col("w") == m.lit(-5.0),
    "between_doubles": lambda m: (m.col("v") >= 0.99) & (m.col("v") <= 1.49),
    "case_sum_lane": lambda m: m.cond.CaseWhen(
        [((m.col("i") - m.col("k") > 30) & (m.col("i") - m.col("k") <= 60),
          m.lit(1))], m.lit(0)),
}


def _spark_to_int(x):
    """Spark's non-ANSI double -> int: NaN is 0, saturate at INT's
    range, truncate toward zero."""
    if x != x:
        return 0
    return int(max(min(x, 2 ** 31 - 1), -2 ** 31))


def _wrap(i, bits):
    i &= (1 << bits) - 1
    return i - (1 << bits) if i >= 1 << (bits - 1) else i


#: cases the JAX package gets wrong (ROADMAP.md C8: it saturates a
#: float cast to TINYINT or SMALLINT at the target's range), held
#: against plain Python over the same lanes instead
PYTHON_REFS = {
    "cast_double_smallint": lambda: [
        None if v is None else _wrap(_spark_to_int(v), 16)
        for v in _python_lane("v")],
    "cast_double_tinyint": lambda: [
        None if v is None else _wrap(_spark_to_int(v), 8)
        for v in _python_lane("v")],
}
EXPRS["cast_double_tinyint"] = lambda m: m.cast.Cast(m.col("v"), m.dt.INT8)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name, batches, jax_ns):
    batch, jbatch = batches
    e = EXPRS[name](_port_ns())
    if name in PYTHON_REFS:
        got = host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
            [e.eval(batch)], ["x"], N, "cpu")))["x"]
        want = PYTHON_REFS[name]()
        assert got == want
        # the lanes reach past INT's range and both signs of the wrap
        assert min(g for g in got if g is not None) < 0 and \
            any(v is not None and abs(v) > 2 ** 31
                for v in _python_lane("v"))
        return
    je = EXPRS[name](jax_ns)
    assert repr(e.data_type(batch.schema())) == \
        repr(je.data_type(jbatch.schema()))
    got = host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
        [e.eval(batch)], ["x"], N, "cpu")))["x"]
    ref = jax_ns.host.to_pydict(jax_ns.host.batch_to_table(
        jax_ns.vector.ColumnarBatch([je.eval(jbatch)], ["x"], N)))["x"]
    assert len(got) == len(ref) == N
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, float) and np.isnan(r):
            assert isinstance(g, float) and np.isnan(g), (i, g, r)
        else:
            assert g == r and type(g) is type(r), (i, g, r)


def test_cast_string_is_not_in_this_port(batches):
    batch, _ = batches
    with pytest.raises(TypeError, match="not in this port yet"):
        cast.Cast(col("s"), dt.INT32).eval(batch)
    with pytest.raises(TypeError, match="not in this port yet"):
        cast.Cast(col("k"), dt.STRING).eval(batch)


def test_case_result_type_meets_branches():
    schema = [("k", dt.INT64), ("v", dt.FLOAT64)]
    case = conditional.CaseWhen([(col("k") < 5, col("k"))], lit(0))
    assert case.data_type(schema) == dt.INT64
    case = conditional.CaseWhen([(col("k") < 5, lit(1))], lit(0.0))
    assert case.data_type(schema) == dt.FLOAT64
    assert conditional.CaseWhen([(col("k") < 5, col("v"))]).data_type(
        schema) == dt.FLOAT64
    assert cast.Cast(col("k"), dt.DATE).data_type(schema) == dt.DATE


def _python_lane(name):
    values, mask, _ = _lanes()[name]
    return [v if m else None for v, m in zip(values, mask)]


def _port_strings(e, batch):
    return host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
        [e.eval(batch)], ["x"], N, "cpu")))["x"]


def test_string_coalesce_matches_python(batches):
    batch, _ = batches
    s, s2 = _python_lane("s"), _python_lane("s2")
    got = _port_strings(conditional.Coalesce(col("s"), col("s2")), batch)
    assert got == [a if a is not None else b for a, b in zip(s, s2)]
    got = _port_strings(conditional.Coalesce(col("s"), lit("none")), batch)
    assert got == [a if a is not None else "none" for a in s]


def test_string_in_with_a_null_matches_python(batches):
    """A null in the set matches nothing; a null input gives null."""
    batch, _ = batches
    got = _port_strings(predicates.InSet(col("s"), ["a", "ccc", None]),
                        batch)
    assert got == [None if v is None else v in ("a", "ccc")
                   for v in _python_lane("s")]


@pytest.mark.parametrize("bytes_per_pass", [1, 3, 7, 64, 1 << 25])
def test_pairs_equal_in_bounded_passes(bytes_per_pass):
    """String pair equality gives the same answer whatever the byte
    budget of one pass (a pair longer than the budget passes alone)."""
    rng = np.random.default_rng(9)
    words = np.array(["", "a", "ab", "abc", "abd", "store7", "store71",
                      "x" * 40], dtype=object)
    n = 300
    lanes = {"s": (words[rng.integers(0, 8, n)], rng.random(n) > 0.1,
                   "string")}
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=512, device="cpu")
    c = batch.column("s")
    ia = torch.from_numpy(rng.integers(0, n, 1000))
    ib = torch.from_numpy(rng.integers(0, n, 1000))
    got = strings.pairs_equal(c, ia, c, ib, bytes_per_pass=bytes_per_pass)
    vals = [v if m else "" for v, m in zip(*lanes["s"][:2])]
    want = [vals[i] == vals[j] for i, j in zip(ia.tolist(), ib.tolist())]
    assert got.tolist() == want


def _spark_substring(v, pos, length):
    """Spark's UTF8String.substringSQL over code points."""
    n = len(v)
    start = pos - 1 if pos > 0 else n + pos if pos < 0 else 0
    end = start + length
    start = max(start, 0)
    return v[start:end] if start < end else ""


@pytest.mark.parametrize("pos,length", [(0, 2), (1, 1), (2, 3), (-3, 2),
                                        (-9, 4), (7, 5), (3, -1)])
def test_c9_substring_counts_code_points(pos, length):
    """SUBSTRING('héllo', 0, 2) = 'hé' (the JAX package returns 'h' and
    half of 'é'); multi-byte text of 2, 3 and 4 bytes a code point."""
    words = ["héllo", "日本語テキスト", "a\U0001F600b", "", "abc", None,
             "ñ"]
    lanes = {"s": (np.array([w or "" for w in words], object),
                   np.array([w is not None for w in words]), "string")}
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8, device="cpu")
    got = host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
        [strings.Substring(col("s"), pos, length).eval(batch)], ["x"],
        len(words), "cpu")))["x"]
    assert got == [None if w is None else _spark_substring(w, pos, length)
                   for w in words]


def test_c7_string_min_max_group_by_matches_jax_and_python(jax_ns):
    """String MIN / MAX in a GROUP BY and a global aggregate, over
    partials of several batches (the merge pass), nulls, empty strings
    and a group with no value; the JAX package answers the same."""
    from spark_rapids_tpu.conf import SrtConf as JConf
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    from spark_rapids_tpu_torch.plan.session import TpuSession
    rng = np.random.default_rng(12)
    n = 300
    words = np.array(["", "a", "ab", "b", "ba", "zz", "é", "store7"], object)
    k = rng.integers(0, 9, n).astype(np.int64)
    mask = (rng.random(n) > 0.2) & (k != 8)  # group 8 has no value
    lanes = {"k": (k, np.ones(n, bool), "bigint"),
             "s": (words[rng.integers(0, len(words), n)], mask, "string")}
    settings = {"srt.sql.batchSizeRows": 64}
    session = TpuSession(carry.conf_from_dict(settings), device="cpu")
    session.create_or_replace_temp_view("t", session.create_dataframe(
        carry.host_table_from_lanes(lanes)))
    jsession = JSession(JConf(settings))
    table = jax_ns.host.HostTable(
        [jax_ns.host.HostColumn(lanes["k"][0], lanes["k"][1],
                                jax_ns.dt.INT64),
         jax_ns.host.HostColumn(lanes["s"][0], lanes["s"][1],
                                jax_ns.dt.STRING)], ["k", "s"])
    jsession.create_or_replace_temp_view("t", jsession.create_dataframe(
        jax_ns.host.to_pydict(table), table.schema()))
    py = {}
    for kk, v, m in zip(k.tolist(), lanes["s"][0], mask):
        py.setdefault(kk, [])
        if m:
            py[kk].append(v.encode())
    for text, want in (
            ("SELECT k, MIN(s) AS mn, MAX(s) AS mx FROM t GROUP BY k "
             "ORDER BY k",
             [{"k": kk, "mn": min(vs).decode() if vs else None,
               "mx": max(vs).decode() if vs else None}
              for kk, vs in sorted(py.items())]),
            ("SELECT MIN(s) AS mn, MAX(s) AS mx FROM t",
             [{"mn": "", "mx": "é"}]),
            ("SELECT MIN(s) AS mn FROM t WHERE k = 8", [{"mn": None}])):
        got = session.sql(text).collect()
        assert got == want == jsession.sql(text).collect(), text
    assert any(r["mn"] is None for r in session.sql(
        "SELECT k, MIN(s) AS mn FROM t GROUP BY k").collect())


@pytest.mark.parametrize("pred", ["s < 'b'", "s >= s2", "'a' > s",
                                  "s BETWEEN 'a' AND 'c'"])
def test_c7_string_order_comparison_is_refused(pred):
    from spark_rapids_tpu_torch.plan.session import TpuSession
    from spark_rapids_tpu_torch.sql.parser import SqlError
    session = TpuSession(device="cpu")
    session.create_or_replace_temp_view("t", session.create_dataframe(
        carry.host_table_from_lanes(_lanes())))
    with pytest.raises(SqlError, match="not in this port yet"):
        session.sql(f"SELECT k FROM t WHERE {pred}")
    assert session.sql("SELECT k FROM t WHERE k < 3 AND s = 'a'").collect()
