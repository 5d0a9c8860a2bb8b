"""The DECIMAL type through both packages on the CPU.

- The two-limb arithmetic (``columnar/decimal128.py``) against the JAX
  package's ``decimal128`` functions and Python ints, exactly, on
  numpy-seeded values with the edges: +-(10^38 - 1), -2^127, lo =
  2^64 - 1, carries across both limbs, a divide by 1 and by -1.
- ``decimal_result_type`` over the JAX package's own table
  (tests/test_decimal128.py).
- The decimal expressions (literals, arithmetic with Spark's coercion,
  comparisons, casts, floor / ceil / round, hashes), the aggregates
  (SUM, AVG, MIN, MAX, COUNT, grouped and global) and the windows
  through both packages' ``session.sql`` on one seeded table, each as
  one SELECT, so that the JAX side compiles one program a query.
  Decimals and NULLs compare exactly; doubles too (both divide the same
  128-bit value by the same power of ten).
- TPC-H q1, q6 and q3 with DECIMAL(12,2) money columns at 20,000
  lineitem rows against the JAX package (its q3 sorts on the wide
  revenue on its CPU fallback).
- Every case the planner sends to the CPU engine (a DECIMAL(p>18) key,
  window aggregate, div / % / pmod, least / greatest, or cast to or from
  STRING) runs there, against the JAX package's rows, or Python's
  decimal where the JAX package raises.
- The port's departures from the JAX package, where the port follows
  Spark (ROADMAP.md C14, C15), against Python's ``decimal`` at 80 digits
  with ROUND_HALF_UP.

The JAX side runs under ``decimal.localcontext`` at 80 digits: its host
conversions (``Decimal.scaleb``) take the context's precision, and 28
digits would round a 38-digit value.
"""

import decimal
from decimal import ROUND_FLOOR, ROUND_HALF_EVEN, ROUND_HALF_UP, Decimal

import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.columnar import decimal128 as D
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.plan.session import TpuSession
from spark_rapids_tpu_torch.sql import SqlError

CTX = decimal.Context(prec=80, rounding=ROUND_HALF_UP)
N = 96
SEED = 10
TWO64, TWO127 = 1 << 64, 1 << 127
P38 = 10 ** 38 - 1

# --- the limb functions ----------------------------------------------------

EDGES = [0, 1, -1, P38, -P38, -TWO127, TWO127 - 1, TWO64 - 1, TWO64,
         -TWO64, 1 << 63, -(1 << 63), (1 << 64) + (1 << 63), 10 ** 19,
         -(10 ** 19) + 7]


def _limb_values():
    rng = np.random.default_rng(SEED)
    wide = [int(h) * TWO64 + int(lo) for h, lo in zip(
        rng.integers(-(1 << 62), 1 << 62, 40),
        rng.integers(0, 1 << 63, 40))]
    mid = [int(v) * int(w) for v, w in zip(
        rng.integers(-10 ** 15, 10 ** 15, 40),
        rng.integers(1, 10 ** 9, 40))]
    return EDGES + wide + mid


def _wrap(v):
    v %= 1 << 128
    return v - (1 << 128) if v >= TWO127 else v


def _t(vals):
    h, lo = D.limbs_of_ints(vals)
    return torch.from_numpy(h), torch.from_numpy(lo)


def _ints(h, lo):
    return [int(v) for v in D.ints_of_limbs(np.asarray(h, np.int64),
                                            np.asarray(lo).view(np.int64))]


def _gids(n):
    """Five groups of rows in group order, as the grouping hands them."""
    return np.sort(np.arange(n) % 5)


def _half_up_div(n, d):
    q, r = divmod(abs(n), abs(d))
    q += 2 * r >= abs(d)
    return -q if (n < 0) != (d < 0) else q


@pytest.fixture(scope="module")
def jax_limbs():
    """The JAX package's limb functions on the same values."""
    vals = _limb_values()
    a, b = vals, vals[::-1]
    small = [v for v in vals if abs(v) < 10 ** 19]
    divisors = [1, -1, 7, -10 ** 9, 3 * 10 ** 17, -(10 ** 25), P38]
    nums = [v for v in vals if abs(v) < 10 ** 30][:len(divisors) * 4]
    den = (divisors * 8)[:len(nums)]
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        import jax.numpy as jnp
        from spark_rapids_tpu.columnar import decimal128 as J

        def limbs(vs):
            h, lo = D.limbs_of_ints(vs)
            return jnp.asarray(h), jnp.asarray(lo.view(np.uint64))

        def ints(h, lo):
            return _ints(np.asarray(h), np.asarray(lo).view(np.int64))
        ah, al = limbs(a)
        bh, bl = limbs(b)
        sh, sl = limbs(small)
        rh, rl = limbs(small[::-1])
        nh, nl = limbs(nums)
        dh, dl = limbs(den)
        gid = jnp.asarray(_gids(len(vals)))
        out = {
            "add": ints(*J.d128_add(ah, al, bh, bl)),
            "sub": ints(*J.d128_sub(ah, al, bh, bl)),
            "neg": ints(*J.d128_neg(ah, al)),
            "abs": ints(*J.d128_abs(ah, al)),
            "lt": np.asarray(J.d128_lt(ah, al, bh, bl)).tolist(),
            "eq": np.asarray(J.d128_eq(ah, al, ah, al)).tolist(),
            "mul": ints(*J.d128_mul(sh, sl, rh, rl)[:2]),
            "mul_exact": {k: ints(*J.d128_mul_exact(sh, sl, rh, rl, k)[:2])
                          for k in (0, 4, 9)},
            "div_exact": {k: ints(*J.d128_div_exact(nh, nl, dh, dl, k)[:2])
                          for k in (0, 6, 15)},
            "div_trunc": [ints(*q) for q in zip(
                *[iter(J.d128_div_trunc(nh, nl, dh, dl))] * 2)],
            "pow10": {k: ints(*J.d128_mul_pow10(sh, sl, k)[:2])
                      for k in (1, 18, 20)},
            "half_up": {k: ints(*J.d128_div_pow10_half_up(ah, al, k))
                        for k in (1, 9, 20, 38)},
            "trunc": {k: ints(*J.d128_div_pow10_trunc(ah, al, k))
                      for k in (2, 19)},
            "fits": {p: np.asarray(J.d128_fits_precision(
                ah, al, p)).tolist() for p in (18, 38)},
            "rescale": ints(*J.d128_rescale(sh, sl, 2, 6)[:2]),
            "to_f64": np.asarray(J.d128_to_f64(ah, al)).tolist(),
            "from_f64": ints(*J.f64_to_d128(jnp.asarray(
                [0.0, 1.5, -2.5, 1e30, -3.25e20, 9.7e37]))),
            "seg_sum": ints(*J.seg_sum128(ah, al, gid, 5)),
            "seg_min": ints(*J.seg_minmax128(ah, al, jnp.ones(len(vals),
                                                              bool),
                                             gid, 5, False)),
            "seg_max": ints(*J.seg_minmax128(ah, al, jnp.ones(len(vals),
                                                              bool),
                                             gid, 5, True)),
        }
    yield {"a": a, "b": b, "small": small, "nums": nums, "den": den,
           **out}


def test_limb_add_sub_neg_abs_compare(jax_limbs):
    a, b = jax_limbs["a"], jax_limbs["b"]
    ah, al = _t(a)
    bh, bl = _t(b)
    assert _ints(*D.d128_add(ah, al, bh, bl)) == jax_limbs["add"] == \
        [_wrap(x + y) for x, y in zip(a, b)]
    assert _ints(*D.d128_sub(ah, al, bh, bl)) == jax_limbs["sub"] == \
        [_wrap(x - y) for x, y in zip(a, b)]
    assert _ints(*D.d128_neg(ah, al)) == jax_limbs["neg"] == \
        [_wrap(-x) for x in a]
    assert _ints(*D.d128_abs(ah, al)) == jax_limbs["abs"] == \
        [_wrap(abs(x)) for x in a]
    assert D.d128_lt(ah, al, bh, bl).tolist() == jax_limbs["lt"] == \
        [x < y for x, y in zip(a, b)]
    assert D.d128_eq(ah, al, ah, al).tolist() == jax_limbs["eq"]


def test_limb_multiply(jax_limbs):
    small = jax_limbs["small"]
    other = small[::-1]
    sh, sl = _t(small)
    rh, rl = _t(other)
    assert _ints(*D.d128_mul(sh, sl, rh, rl)[:2]) == jax_limbs["mul"] == \
        [_wrap(x * y) for x, y in zip(small, other)]
    for k, want in jax_limbs["mul_exact"].items():
        h, lo, ovf = D.d128_mul_exact(sh, sl, rh, rl, k)
        got = _ints(h, lo)
        assert got == want
        for x, y, g, o in zip(small, other, got, ovf.tolist()):
            q = _half_up_div(x * y, 10 ** k)
            assert o == (abs(q) >= TWO127)
            if not o:
                assert g == q
    for k, want in jax_limbs["pow10"].items():
        h, lo, ovf = D.d128_mul_pow10(sh, sl, k)
        assert _ints(h, lo) == want
        assert ovf.tolist() == [abs(x * 10 ** k) >= TWO127 for x in small]


def test_limb_divide(jax_limbs):
    nums, den = jax_limbs["nums"], jax_limbs["den"]
    nh, nl = _t(nums)
    dh, dl = _t(den)
    for k, want in jax_limbs["div_exact"].items():
        h, lo, ovf = D.d128_div_exact(nh, nl, dh, dl, k)
        got = _ints(h, lo)
        assert got == want
        for x, y, g, o in zip(nums, den, got, ovf.tolist()):
            q = _half_up_div(x * 10 ** k, y)
            assert o == (abs(q) >= TWO127)
            if not o:
                assert g == q
    q = D.d128_div_trunc(nh, nl, dh, dl)
    got_q, got_r = _ints(q[0], q[1]), _ints(q[2], q[3])
    assert [got_q, got_r] == jax_limbs["div_trunc"]
    for x, y, gq, gr in zip(nums, den, got_q, got_r):
        tq = abs(x) // abs(y) * (-1 if (x < 0) != (y < 0) else 1)
        assert (gq, gr) == (tq, x - tq * y)


def test_limb_scale_and_bounds(jax_limbs):
    a = jax_limbs["a"]
    ah, al = _t(a)
    for k, want in jax_limbs["half_up"].items():
        got = _ints(*D.d128_div_pow10_half_up(ah, al, k))
        assert got == want
        # -2^127's magnitude wraps in either package; every other value
        # is Python's HALF_UP
        assert [g for g, x in zip(got, a) if x != -TWO127] == \
            [_half_up_div(x, 10 ** k) for x in a if x != -TWO127]
    for k, want in jax_limbs["trunc"].items():
        assert _ints(*D.d128_div_pow10_trunc(ah, al, k)) == want
    for p, want in jax_limbs["fits"].items():
        got = D.d128_fits_precision(ah, al, p).tolist()
        assert got == [abs(x) < 10 ** p for x in a]
        # the JAX package's abs(-2^127) wraps and reads as fitting
        assert [g for g, x in zip(got, a) if x != -TWO127] == \
            [w for w, x in zip(want, a) if x != -TWO127]
    sh, sl = _t(jax_limbs["small"])
    assert _ints(*D.d128_rescale(sh, sl, 2, 6)[:2]) == jax_limbs["rescale"]
    assert D.d128_to_f64(ah, al).tolist() == jax_limbs["to_f64"]
    x = torch.tensor([0.0, 1.5, -2.5, 1e30, -3.25e20, 9.7e37],
                     dtype=torch.float64)
    assert _ints(*D.f64_to_d128(x)) == jax_limbs["from_f64"]


def test_limb_segmented(jax_limbs):
    a = jax_limbs["a"]
    ah, al = _t(a)
    gid = torch.from_numpy(_gids(len(a)))
    sums = _ints(*D.seg_sum128(ah, al, gid, 5))
    assert sums == jax_limbs["seg_sum"]
    valid = torch.ones(len(a), dtype=torch.bool)
    mins = _ints(*D.seg_minmax128(ah, al, valid, gid, 5, False))
    maxs = _ints(*D.seg_minmax128(ah, al, valid, gid, 5, True))
    assert mins == jax_limbs["seg_min"] and maxs == jax_limbs["seg_max"]
    for g in range(5):
        grp = [x for x, k in zip(a, _gids(len(a))) if k == g]
        assert sums[g] == _wrap(sum(grp))
        assert (mins[g], maxs[g]) == (min(grp), max(grp))
    # the sort words order as the values do
    w0, w1 = D.order_words(ah, al)
    order = sorted(range(len(a)), key=lambda i: (int(w0[i]), int(w1[i])))
    assert [a[i] for i in order] == sorted(a)


RESULT_TYPES = [  # tests/test_decimal128.py::test_result_type_rules
    ("add", (38, 10), (38, 10), (38, 9)),
    ("mul", (38, 10), (38, 10), (38, 6)),
    ("div", (38, 10), (38, 10), (38, 6)),
    ("mul", (10, 2), (8, 3), (19, 5)),
    ("sub", (12, 2), (1, 0), (13, 2)),
    ("mul", (26, 4), (13, 2), (38, 6)),
    ("div", (12, 2), (12, 2), (27, 15)),
    ("mod", (7, 2), (12, 4), (9, 4)),
]


@pytest.mark.parametrize("op, a, b, want", RESULT_TYPES)
def test_decimal_result_type(op, a, b, want):
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        jt = jdt.decimal_result_type(op, jdt.DecimalType(*a),
                                     jdt.DecimalType(*b))
    got = dt.decimal_result_type(op, dt.DecimalType(*a), dt.DecimalType(*b))
    assert (got.precision, got.scale) == (jt.precision, jt.scale) == want
    assert dt.from_name(repr(got)) == got


# --- one seeded table through both sessions --------------------------------

TYPES = {"a": (7, 2), "b": (12, 4), "c": (30, 6), "d": (38, 10),
         "w": (20, 1)}


def _decimal_lane(rng, p, s, n):
    digits = []
    left = p
    while left > 0:
        step = min(left, 15)
        digits.append((step, rng.integers(0, 10 ** step, n)))
        left -= step
    sign = rng.integers(0, 2, n)
    width = rng.integers(1, p + 1, n)  # small magnitudes too
    out = []
    for i in range(n):
        v = 0
        for step, arr in digits:
            v = v * 10 ** step + int(arr[i])
        v %= 10 ** int(width[i])
        out.append(Decimal(-v if sign[i] else v).scaleb(-s, context=CTX))
    return out


def _table():
    rng = np.random.default_rng(SEED)
    data = {name: _decimal_lane(rng, p, s, N)
            for name, (p, s) in TYPES.items()}
    # ties, negative ties and the corners of each width
    data["a"][:6] = [Decimal("-2.50"), Decimal("2.50"), Decimal("-0.05"),
                     Decimal("99999.99"), Decimal("-99999.99"),
                     Decimal("0.00")]
    data["b"][:4] = [Decimal("-2.5000"), Decimal("0.0500"),
                     Decimal("1.0000"), Decimal("-99999999.9999")]
    data["d"][:2] = [Decimal(P38).scaleb(-10, context=CTX),
                     Decimal(-P38).scaleb(-10, context=CTX)]
    data["i"] = [int(v) for v in rng.integers(-1000, 1000, N)]
    data["l"] = [int(v) for v in rng.integers(-10 ** 12, 10 ** 12, N)]
    data["f"] = [float(v) for v in rng.normal(0, 1000, N)]
    data["k"] = [int(v) for v in rng.integers(0, 5, N)]
    data["s"] = [f"{v:.5f}" for v in rng.uniform(-99, 99, N)]
    nulls = rng.random((len(data), N)) < 0.08
    for row, name in zip(nulls, list(data)):
        if name in ("k", "s"):
            continue
        data[name] = [None if z else v for v, z in zip(data[name], row)]
    return data


def _schema(m):
    return [(n, m.DecimalType(*t)) for n, t in TYPES.items()] + [
        ("i", m.INT32), ("l", m.INT64), ("f", m.FLOAT64), ("k", m.INT32),
        ("s", m.STRING)]


#: expressions that equal the JAX package's, each query one program
EXPRS = [
    "a + b", "a - b", "a * b", "a / b", "c + d", "c - d", "c * a",
    "c * d", "c / a", "d / c", "a * c", "-c", "abs(c)", "-a", "abs(b)",
    "a + i", "a * l", "b - i", "a + f", "a * 1", "2 * a", "1 - a",
    "a % b", "b % a", "pmod(a, abs(b))", "a div b", "c * 100000000000000000000",
    "a < b", "a = b", "c < d", "c >= a", "a <= i", "a <> f", "c = c",
    "b > 0", "a BETWEEN b AND 5", "c BETWEEN -1 AND 1",
    "CAST(a AS DECIMAL(38,10))", "CAST(c AS DECIMAL(10,2))",
    "CAST(d AS DECIMAL(20,0))", "CAST(b AS DECIMAL(5,1))",
    "CAST(a AS DOUBLE)", "CAST(c AS DOUBLE)", "CAST(d AS FLOAT)",
    "CAST(a AS BIGINT)", "CAST(b AS INT)", "CAST(a AS BOOLEAN)",
    "CAST(i AS DECIMAL(12,2))", "CAST(l AS DECIMAL(20,0))",
    "CAST(i AS DECIMAL(3,1))", "CAST(a AS STRING)", "CAST(b AS STRING)",
    "CAST(s AS DECIMAL(10,3))", "floor(a)", "ceil(a)", "floor(b)",
    "ceil(b)", "hash(a)", "hash(b, i)", "xxhash64(a)", "xxhash64(b)",
    "CASE WHEN k = 1 THEN a ELSE -a END", "coalesce(c, -c)",
    "least(a, -a)", "greatest(b, -b)",
]

#: round / bround: the same values as the JAX package's, at Spark's
#: result type (C15)
ROUNDS = ["round(a, 1)", "round(a, 0)", "round(b, 2)", "round(b, 0)",
          "round(b, 3)", "round(b, 6)"]

AGGS = ("SELECT k, sum(a), sum(b), sum(c), sum(d), avg(a), avg(b), "
        "avg(c), min(a), max(b), min(c), max(d), count(c), "
        "sum(a * b), avg(c * a) FROM t GROUP BY k ORDER BY k")
GLOBAL = ("SELECT sum(a), sum(c), avg(d), min(d), max(c), count(d) "
          "FROM t WHERE a > 0")
WINDOWS = ("SELECT k, a, b, "
           "sum(a) OVER (PARTITION BY k ORDER BY a, b ROWS BETWEEN "
           "UNBOUNDED PRECEDING AND CURRENT ROW) AS rs, "
           "min(b) OVER (PARTITION BY k) AS mn, "
           "max(a) OVER (PARTITION BY k ORDER BY a, b ROWS BETWEEN 2 "
           "PRECEDING AND 1 FOLLOWING) AS mx, "
           "count(a) OVER (PARTITION BY k) AS n, "
           "sum(a) OVER (PARTITION BY k ORDER BY b RANGE BETWEEN 50 "
           "PRECEDING AND CURRENT ROW) AS rg "
           "FROM t ORDER BY k, a, b")
ORDERED = ("SELECT c, d, a FROM t ORDER BY c DESC, d, a LIMIT 20")
#: long-backed decimals as group-by and join keys (their int64 lanes)
KEYS = ("SELECT x.a, x.n, y.i FROM (SELECT a, COUNT(*) AS n, SUM(b) AS s "
        "FROM t GROUP BY a) x JOIN t y ON x.a = y.a ORDER BY x.a, y.i")


def _sql_texts():
    return {"exprs": "SELECT " + ", ".join(
                f"{e} AS e{i}" for i, e in enumerate(EXPRS)) + " FROM t",
            "rounds": "SELECT " + ", ".join(
                f"{e} AS r{i}" for i, e in enumerate(ROUNDS)) + " FROM t",
            "aggs": AGGS, "global": GLOBAL, "windows": WINDOWS,
            "ordered": ORDERED, "keys": KEYS}


# --- TPC-H with DECIMAL(12,2) money ----------------------------------------

ROWS = 20_000
MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "o_totalprice")

Q1 = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem WHERE l_shipdate <= date '1998-09-02'
GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""

Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem
WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""

Q3 = """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
  AND l_shipdate > date '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate LIMIT 10"""

TPCH_TYPES = {"q1": [("sum_qty", (22, 2)), ("sum_base_price", (22, 2)),
                     ("sum_disc_price", (36, 4)), ("sum_charge", (38, 6)),
                     ("avg_qty", (16, 6))],
              "q6": [("revenue", (35, 4))], "q3": [("revenue", (36, 4))]}


def decimal_tpch_lanes(lanes):
    """The generated float money lanes as DECIMAL(12,2): x 100,
    truncated toward zero, as the JAX datagen makes a decimal."""
    out = {}
    for name, (values, mask, type_name) in lanes.items():
        if name in MONEY:
            values = (np.asarray(values, np.float64) * 100).astype(np.int64)
            type_name = "decimal(12,2)"
        out[name] = (values, mask, type_name)
    return out


@pytest.fixture(scope="module")
def tpch_lanes():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu.datagen import (generate_chunk, lineitem_spec,
                                              orders_spec)
        from spark_rapids_tpu.models.tpch import customer_spec
        specs = [lineitem_spec(ROWS), orders_spec(ROWS // 4),
                 customer_spec(ROWS // 40)]
        tables = {s.name: generate_chunk(s, 0, s.num_rows) for s in specs}
    return {n: decimal_tpch_lanes(carry.lanes_of(t))
            for n, t in tables.items()}


@pytest.fixture(scope="module")
def jax_side(tpch_lanes):
    """Every query through the JAX package's session.sql."""
    data = _table()
    with pytest.MonkeyPatch.context() as mp, \
            decimal.localcontext(CTX):
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan.host_table import (HostColumn, HostTable,
                                                      to_pydict)
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        session = JSession(JConf({"srt.shuffle.partitions": 1,
                                  "srt.sql.batchSizeRows": 4096}))
        session.create_or_replace_temp_view(
            "t", session.create_dataframe(data, _schema(jdt)))
        out = {}
        for name, text in _sql_texts().items():
            df = session.sql(text)
            out[name] = (df.schema, df.collect())
        for tname, lanes in tpch_lanes.items():
            table = HostTable([HostColumn(v, m, jdt.DecimalType(12, 2)
                                          if t == "decimal(12,2)" else
                                          {repr(x): x for x in (
                                              jdt.INT32, jdt.INT64,
                                              jdt.STRING, jdt.DATE)}[t])
                               for v, m, t in lanes.values()], list(lanes))
            session.create_or_replace_temp_view(
                tname, session.create_dataframe(to_pydict(table),
                                                table.schema()))
        for q, text in (("q1", Q1), ("q6", Q6), ("q3", Q3)):
            df = session.sql(text)
            out[q] = (df.schema, df.collect())
        for text in FALLBACK:
            try:
                out[text] = session.sql(text).collect()
            except Exception as e:  # noqa: BLE001 - C16's refusals
                out[text] = e
    return out


@pytest.fixture(scope="module")
def port():
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4096}),
                         device="cpu")
    session.create_or_replace_temp_view(
        "t", session.create_dataframe(_table(), _schema(dt)))
    return session


@pytest.fixture(scope="module")
def port_tpch(tpch_lanes):
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4096}),
                         device="cpu")
    for name, lanes in tpch_lanes.items():
        table = carry.host_table_from_lanes(lanes)
        session.create_or_replace_temp_view(
            name, session.create_dataframe(table))
    return session


def _types(schema):
    """Type names, the JAX package's DecimalType repr read as the SQL
    name."""
    return [repr(dt.from_name(repr(t))) for _, t in schema]


def _same(g, w):
    if g is None or w is None:
        return g is None and w is None
    if isinstance(w, float) and np.isnan(w):
        return isinstance(g, float) and np.isnan(g)
    return g == w and type(g) is type(w)


def _same_rows(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            assert _same(g[key], w[key]), (what, i, key, g[key], w[key])


@pytest.mark.parametrize("name", ["exprs", "aggs", "global", "ordered",
                                  "keys"])
def test_queries_match_jax(port, jax_side, name):
    """Arithmetic, coercion, comparisons, casts, floor / ceil, hashes,
    conditionals, least / greatest, the aggregates, a wide ORDER BY and
    long-backed group-by and join keys: types and values equal to the
    JAX package's."""
    df = port.sql(_sql_texts()[name])
    want_schema, want = jax_side[name]
    assert _types(df.schema) == _types(want_schema)
    _same_rows(df.collect(), want, name)


def test_rounds_match_jax_values(port, jax_side):
    """round / bround: the JAX package's values; the type is Spark's
    (C15), the JAX package keeps the input's precision."""
    df = port.sql(_sql_texts()["rounds"])
    _, want = jax_side["rounds"]
    _same_rows(df.collect(), want, "rounds")
    assert [repr(t) for _, t in df.schema] == [
        "decimal(7,1)", "decimal(6,0)", "decimal(11,2)", "decimal(9,0)",
        "decimal(12,3)", "decimal(13,4)"]


def test_windows_match_jax(port, jax_side):
    """Decimal SUM (running and RANGE over a decimal key), MIN, MAX
    (sliding) and COUNT windows: the JAX package's values."""
    df = port.sql(WINDOWS)
    want_schema, want = jax_side["windows"]
    assert _types(df.schema) == _types(want_schema)
    _same_rows(df.collect(), want, "windows")


@pytest.mark.parametrize("q", ["q1", "q6", "q3"])
def test_decimal_tpch_matches_jax(port_tpch, jax_side, q):
    """TPC-H over DECIMAL(12,2) money at 20,000 lineitem rows: Spark's
    result types and the JAX package's exact values; q3 sorts on its
    DECIMAL(36,4) revenue in the port, on the JAX package's CPU
    fallback there."""
    df = port_tpch.sql({"q1": Q1, "q6": Q6, "q3": Q3}[q])
    types = dict(df.schema)
    for name, (p, s) in TPCH_TYPES[q]:
        assert types[name] == dt.DecimalType(p, s), (q, name)
    got = df.collect()
    want_schema, want = jax_side[q]
    assert _types(df.schema) == _types(want_schema)
    assert len(got) > 0
    _same_rows(got, want, q)


def test_decimal_q1_split_and_retry_equals_clean(port_tpch):
    """An injected RetryOOM and SplitAndRetryOOM in decimal q1: the
    halves' two-limb states merge to the clean run's rows."""
    from spark_rapids_tpu_torch.memory.budget import task_context
    clean = port_tpch.sql(Q1).collect()
    for arm in ("force_retry_oom", "force_split_and_retry_oom"):
        getattr(task_context(), arm)(1)
        got = port_tpch.sql(Q1).collect()
        mem = port_tpch._last_execution[1].memory
        assert got == clean, arm
        assert sum(mem.values()) > 0, (arm, mem)


# --- what the planner sends to the CPU engine ------------------------------

FALLBACK = [
    "SELECT c, count(*) FROM t GROUP BY c",
    "SELECT sum(a) FROM t GROUP BY d",
    "SELECT x.a FROM t x JOIN t y ON x.c = y.c",
    "SELECT sum(a) OVER (PARTITION BY c) FROM t",
    "SELECT row_number() OVER (ORDER BY d) FROM t",
    "SELECT sum(c) OVER (PARTITION BY k) FROM t",
    "SELECT avg(CAST(b AS DECIMAL(16,4))) OVER (PARTITION BY k) FROM t",
    "SELECT max(d) OVER (PARTITION BY k ORDER BY a) FROM t",
    "SELECT c div a FROM t",
    "SELECT c % a FROM t",
    "SELECT pmod(d, b) FROM t",
    "SELECT least(c, d) FROM t",
    "SELECT greatest(a, c) FROM t",
    "SELECT CAST(c AS STRING) FROM t",
    "SELECT CAST(s AS DECIMAL(30,2)) FROM t",
]


def _python_reference(text):
    """Python's decimal at 80 digits, for the texts the JAX package's CPU
    engine fails on (its join and window keys call ``.item()`` on a
    Python int; its least / greatest refuse two decimal types, C16)."""
    with decimal.localcontext(CTX):
        return _python_rows(text, _table())


def _python_rows(text, data):
    rows = range(len(data["k"]))
    if text.startswith("SELECT x.a FROM t x JOIN"):
        return [data["a"][i] for i in rows for j in rows
                if data["c"][i] is not None and data["c"][i] == data["c"][j]]
    if text.startswith("SELECT sum(c) OVER"):
        sums = {}
        for i in rows:
            if data["c"][i] is not None:
                sums[data["k"][i]] = sums.get(data["k"][i], 0) + data["c"][i]
        return [sums.get(data["k"][i]) for i in rows]
    if text.startswith("SELECT max(d) OVER"):
        def key(i):  # ascending, NULLs first
            return (data["a"][i] is not None, data["a"][i] or 0)
        out = []
        for i in rows:
            peers = [data["d"][j] for j in rows
                     if data["k"][j] == data["k"][i] and key(j) <= key(i)
                     and data["d"][j] is not None]
            out.append(max(peers) if peers else None)
        return out
    x, y = ("c", "d") if "least" in text else ("a", "c")
    pick = min if "least" in text else max
    return [pick([v for v in (data[x][i], data[y][i]) if v is not None])
            if data[x][i] is not None or data[y][i] is not None else None
            for i in rows]


@pytest.mark.parametrize("text", FALLBACK)
def test_cpu_fallback_cases_run(port, jax_side, text):
    """Each sends the planner to the CPU engine (a DECIMAL(p>18) group-by,
    join or window key, window aggregate, div / % / pmod, least /
    greatest, or cast to or from STRING): the rows equal the JAX
    package's, or Python's decimal where the JAX package raises."""
    df = port.sql(text)
    assert any(line.lstrip().startswith("!")
               for line in df.explain("NOT_ON_TPU").splitlines())
    got = [r[df.columns[-1]] for r in df.collect()]
    want = jax_side[text]
    if isinstance(want, Exception):
        want = _python_reference(text)
    else:
        want = [r[list(r)[-1]] for r in want]
    if "GROUP BY" in text or "JOIN" in text:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w) or (isinstance(g, Decimal) and g == w), \
            (text, i, g, w)


def test_union_of_two_decimal_types_raises(port):
    """Spark widens a UNION column of two decimal types; the port's
    Union keeps its first child's types, so it refuses rather than meet
    two scales' unscaled lanes as they are."""
    with pytest.raises(NotImplementedError, match="UNION of decimal"):
        port.sql("SELECT a FROM t UNION ALL SELECT b FROM t").collect()
    rows = port.sql("SELECT a FROM t UNION ALL SELECT a FROM t").collect()
    assert [r["a"] for r in rows] == _table()["a"] * 2


# --- departures from the JAX package, against Python's decimal -------------

def _py(v, s):
    return None if v is None else Decimal(v).quantize(
        Decimal(1).scaleb(-s), context=CTX)


def test_c14_numeric_literals_stay_double(port):
    """C14: 0.05 is DOUBLE in both packages' parsers (Spark types it
    DECIMAL(2,2)), so a decimal against it compares and multiplies as
    doubles."""
    df = port.sql("SELECT a * 0.05 AS x, a > 0.05 AS y FROM t")
    assert dict(df.schema)["x"] == dt.FLOAT64
    data = _table()
    for r, a in zip(df.collect(), data["a"]):
        assert r["x"] == (None if a is None else float(a) * 0.05)
        assert r["y"] == (None if a is None else float(a) > 0.05)


def test_c15_floor_ceil_types(port):
    """floor / ceil of DECIMAL(20,1) are DECIMAL(20,0) (Spark's p - s +
    1; the JAX package caps it at 18), exactly Python's."""
    df = port.sql("SELECT floor(w) AS f, ceil(w) AS c, floor(c) AS fc "
                  "FROM t")
    assert [repr(t) for _, t in df.schema] == \
        ["decimal(20,0)", "decimal(20,0)", "decimal(25,0)"]
    data = _table()
    for r, w, c in zip(df.collect(), data["w"], data["c"]):
        assert r["f"] == (None if w is None else
                          w.to_integral_value(ROUND_FLOOR))
        assert r["c"] == (None if w is None else -(
            (-w).to_integral_value(ROUND_FLOOR)))
        assert r["fc"] == (None if c is None else
                           c.to_integral_value(ROUND_FLOOR))


def test_c15_window_avg_is_exact(port):
    """A window AVG of DECIMAL(7,2) is DECIMAL(11,6), HALF_UP (the JAX
    package divides float sums and returns doubles)."""
    df = port.sql("SELECT k, a, avg(a) OVER (PARTITION BY k) AS v, "
                  "avg(a) OVER (PARTITION BY k ORDER BY a ROWS BETWEEN 1 "
                  "PRECEDING AND 1 FOLLOWING) AS w FROM t ORDER BY k, a")
    assert dict(df.schema)["v"] == dt.DecimalType(11, 6)
    data = _table()
    rows = df.collect()
    for k in range(5):
        vals = [a for a, kk in zip(data["a"], data["k"]) if kk == k]
        got = [r for r in rows if r["k"] == k]
        live = [v for v in vals if v is not None]
        mean = _py(sum(live) / len(live), 6) if live else None
        assert all(r["v"] == mean for r in got)
        ordered = [r["a"] for r in got]
        for i, r in enumerate(got):
            frame = [v for v in ordered[max(i - 1, 0):i + 2]
                     if v is not None]
            want = _py(sum(frame) / len(frame), 6) if frame else None
            assert r["w"] == want, (k, i)


def test_c15_half_up_ties_and_rounding(port):
    """HALF_UP on negative ties (away from zero) in round, CAST and
    division; HALF_EVEN in bround; a float's decimal string rounded
    HALF_UP (1.005 -> 1.01, where the binary product gives 1.00)."""
    rows = port.sql(
        "SELECT round(CAST(-2.5 AS DECIMAL(2,1)), 0) AS r1, "
        "round(CAST(-0.005 AS DECIMAL(4,3)), 2) AS r2, "
        "bround(CAST(-2.5 AS DECIMAL(2,1)), 0) AS b1, "
        "CAST(CAST(-1.25 AS DECIMAL(3,2)) AS DECIMAL(2,1)) AS c1, "
        "CAST(-1 AS DECIMAL(3,0)) / CAST(8 AS DECIMAL(3,0)) AS q, "
        "CAST(1.005 AS DECIMAL(3,2)) AS f1, "
        "CAST(-0.285 AS DECIMAL(3,2)) AS f2 FROM t LIMIT 1").collect()[0]
    assert rows == {
        "r1": Decimal(-2.5).quantize(Decimal(1), ROUND_HALF_UP),
        "r2": Decimal("-0.005").quantize(Decimal("0.01"), ROUND_HALF_UP),
        "b1": Decimal(-2.5).quantize(Decimal(1), ROUND_HALF_EVEN),
        "c1": Decimal("-1.25").quantize(Decimal("0.1"), ROUND_HALF_UP),
        "q": (Decimal(-1) / Decimal(8)).quantize(Decimal("1E-10"),
                                                 ROUND_HALF_UP),
        "f1": Decimal(repr(1.005)).quantize(Decimal("0.01"), ROUND_HALF_UP),
        "f2": Decimal(repr(-0.285)).quantize(Decimal("0.01"),
                                             ROUND_HALF_UP)}


def test_c15_pmod_and_negative_round(port):
    """pmod with a negative divisor is Spark's (r + n) % n, r itself
    (the JAX package adds |n|); round(x, -2) rounds to hundreds (the
    JAX package rounds a decimal to units there)."""
    data = _table()
    rows = port.sql("SELECT pmod(a, b) AS p, round(a, -2) AS r, "
                    "round(b, -1) AS q FROM t").collect()

    def java_mod(x, n):
        r = abs(x) % abs(n)
        return -r if x < 0 else r
    for row, a, b in zip(rows, data["a"], data["b"]):
        if a is None or b is None or b == 0:
            assert row["p"] is None
        else:
            r = java_mod(a, b)
            v = java_mod(r + b, b) if r < 0 else r
            # past DECIMAL(9,4), the mod type, it is null (CheckOverflow)
            assert row["p"] == (v if abs(v) < 10 ** 5 else None)
        assert row["r"] == (None if a is None else
                            a.quantize(Decimal("1E2"), ROUND_HALF_UP))
        assert row["q"] == (None if b is None else
                            b.quantize(Decimal("1E1"), ROUND_HALF_UP))


def test_c15_decimal_to_integral_wraps(port):
    """Past the target's range a decimal -> integral cast truncates and
    wraps as Spark's Decimal.toLong / toInt do (the JAX package makes
    the row null)."""
    big = 2 ** 63 + 5
    rows = port.sql(
        f"SELECT CAST(CAST({big} AS DECIMAL(20,0)) AS BIGINT) AS l, "
        "CAST(CAST(3000000000.7 AS DECIMAL(11,1)) AS INT) AS i, "
        "CAST(CAST(-129.9 AS DECIMAL(4,1)) AS TINYINT) AS b FROM t "
        "LIMIT 1").collect()[0]

    def wrap(v, bits):
        v %= 1 << bits
        return v - (1 << bits) if v >= 1 << (bits - 1) else v
    assert rows == {"l": wrap(big, 64), "i": wrap(3000000000, 32),
                    "b": wrap(-129, 8)}


def test_c15_strings_of_decimals(port):
    """A negative decimal under 1 prints as -0.50; a string parses
    exactly (HALF_UP past the scale; the JAX package reads it as a
    double first and loses the 17th digit)."""
    rows = port.sql(
        "SELECT CAST(CAST(-0.5 AS DECIMAL(3,2)) AS STRING) AS s1, "
        "CAST(CAST(-0.05 AS DECIMAL(4,3)) AS STRING) AS s2, "
        "CAST('0.12345678901234565' AS DECIMAL(18,16)) AS p1, "
        "CAST('-9.99999999999999995' AS DECIMAL(18,16)) AS p2, "
        "CAST(' 1.5e2 ' AS DECIMAL(5,1)) AS p3, "
        "CAST('12a' AS DECIMAL(5,1)) AS p4 FROM t LIMIT 1").collect()[0]
    assert rows["s1"] == "-0.50" and rows["s2"] == "-0.050"
    assert rows["p1"] == Decimal("0.12345678901234565").quantize(
        Decimal("1E-16"), ROUND_HALF_UP)
    assert rows["p2"] == Decimal("-9.99999999999999995").quantize(
        Decimal("1E-16"), ROUND_HALF_UP)       # -10.0000000000000000
    assert rows["p3"] == Decimal("150.0") and rows["p4"] is None


def test_c15_comparisons_by_value(port):
    """IN and <=> compare by value across scales (the JAX package's IN
    compares a decimal's unscaled lane with the literal, and its <=>
    the unscaled lanes of both sides)."""
    from spark_rapids_tpu_torch.expr import predicates as P
    from spark_rapids_tpu_torch.expr.core import col
    data = _table()
    df = port.sql("SELECT a IN (2.5, -2.5, 0) AS x, c IN (1, 2) AS z, a, b "
                  "FROM t")
    rows = df.select(col("x"), col("z"),
                     P.EqualNullSafe(col("a"), col("b")).alias("y")
                     ).collect()
    for r, a, b, c in zip(rows, data["a"], data["b"], data["c"]):
        assert r["x"] == (None if a is None else a in (Decimal("2.5"),
                                                       Decimal("-2.5"), 0))
        assert r["y"] == (a == b if a is not None and b is not None
                          else a is None and b is None)
        assert r["z"] == (None if c is None else c in (1, 2))


def test_c15_sum_at_the_38_digit_bound(port):
    """A sum that lands exactly on +-(10^38 - 1) is kept; one just past
    it is null; a sum past 2^127 (the limbs wrap) is null through the
    float64 shadow sum, whatever order it adds in."""
    top = P38 // 2
    s = TpuSession(SrtConf(), device="cpu")
    s.create_or_replace_temp_view("u", s.create_dataframe(
        {"g": [0, 0, 1, 1, 2, 2, 3, 3, 3, 4, 4],
         "v": [Decimal(v) if v is not None else None for v in (
             top, top + 1, -top, -top - 1, top, top + 2, P38, P38, P38,
             -top, None)]},
        [("g", dt.INT32), ("v", dt.DecimalType(38, 0))]))
    rows = s.sql("SELECT g, sum(v) AS t, avg(v) AS m FROM u GROUP BY g "
                 "ORDER BY g").collect()
    assert [r["t"] for r in rows] == [P38, -P38, None, None, -top]
    # AVG is DECIMAL(38, 4): 34 integral digits, so these are past it
    assert [r["m"] for r in rows] == [None] * 5


def test_carry_round_trips_decimal_lanes():
    """A JAX host table with DECIMAL(12,2) and DECIMAL(38,6) columns
    crosses ``carry`` and back to host lanes unchanged."""
    with pytest.MonkeyPatch.context() as mp, decimal.localcontext(CTX):
        patch_jax_compiles(mp)
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.plan.host_table import from_pydict
        vals = [Decimal("12.34"), None, Decimal("-0.05")]
        wide = [Decimal(P38).scaleb(-6, context=CTX), Decimal("-1.000001"),
                None]
        jt = from_pydict({"m": vals, "w": wide},
                         [("m", jdt.DecimalType(12, 2)),
                          ("w", jdt.DecimalType(38, 6))])
    table = carry.host_tables_from({"x": jt})["x"]
    assert [t for _, t in table.schema()] == [dt.DecimalType(12, 2),
                                              dt.DecimalType(38, 6)]
    from spark_rapids_tpu_torch.plan.host_table import (batch_to_table,
                                                        table_to_batch,
                                                        to_pydict)
    back = batch_to_table(table_to_batch(table, device="cpu"))
    assert to_pydict(back) == {"m": vals, "w": wide}
    lanes = carry.lanes_of(back)
    assert lanes["w"][0].tolist()[:2] == [P38, -1000001]


def test_datagen_decimal_bytes_equal_jax():
    """A decimal ColumnSpec generates the JAX package's unscaled lane
    (x 10^scale in float64, truncated toward zero: 0.29 gives 28)."""
    from spark_rapids_tpu_torch import datagen as P
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_compiles(mp)
        from spark_rapids_tpu import datagen as J
        from spark_rapids_tpu.columnar import dtypes as jdt

        def spec(m, t):
            return m.TableSpec("d", [
                m.ColumnSpec("p", t(12, 2), "uniform", lo=900, hi=105_000),
                m.ColumnSpec("q", t(7, 2), "choice",
                             choices=[0.07, 0.29, 1.0]),
                m.ColumnSpec("r", t(20, 4), "normal", mean=0, std=1e6,
                             null_prob=0.1)], 5000)
        want = J.generate_chunk(spec(J, jdt.DecimalType), 0, 5000)
    got = P.generate_chunk(spec(P, dt.DecimalType), 0, 5000)
    for name in ("p", "q", "r"):
        g, w = got.column(name), want.column(name)
        assert np.array_equal(g.mask, w.mask)
        assert np.array_equal(np.asarray(g.values, np.int64),
                              np.asarray(w.values, np.int64)), name
    assert 28 in set(got.column("q").values.tolist())
