"""The port's scalar expression library held against the JAX package's
on the CPU: strings, LIKE and regex, dates, timestamps and time zones,
integral arithmetic, math, hashes, casts and FIRST / LAST.

One seeded batch carries the edge cases of the JAX package's own suites
(tests/test_strings_regex.py, test_regex_submatch.py, test_timezone.py,
test_misc_exprs.py and the datetime part of
test_matrix_decimal_datetime.py): NULLs, NaN, +-0.0 and the infinities,
empty strings, multi-byte text, leap days, month ends and days before
the epoch. Each family of expressions runs through the JAX package as
one jitted projection (compiled once, in a module-scoped fixture); each
expression is one parametrised case, held to the JAX package's values:
floats to 1e-9 relative, everything else exactly. The JAX side runs in
eight subprocesses of this file (its ``__main__`` block), one core each,
started before the first test, while the port's side and the
plain-Python cases run here.

Where the JAX package departs from Spark and the port follows Spark
(ROADMAP.md C13), the case is held against plain Python instead: string
order past a shared prefix of zero bytes, ``pmod`` with a negative
divisor, ``make_date`` of a day past its month, LIKE's ``_`` and
multi-byte literals, ``reverse`` / ``lpad`` / ``rpad`` / ``locate`` on
multi-byte text, ``replace`` with an empty search, a double cast to
STRING (which the JAX package refuses), STRING to DOUBLE (``'0.3'``),
a padded boolean string, and Java's ``pow`` / ``floor`` / ``signum``
special cases. About ten SQL texts run through both packages'
``session.sql``.
"""

import datetime
import math
import os
import pickle
import re
import subprocess
import sys
import types
from decimal import Decimal

import numpy as np
import pytest

from jax_reference import SUBPROCESS_XLA_FLAGS
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.vector import ColumnarBatch
from spark_rapids_tpu_torch.expr import aggregates as Agg
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import cast as C
from spark_rapids_tpu_torch.expr import datetime as D
from spark_rapids_tpu_torch.expr import hashing as H
from spark_rapids_tpu_torch.expr import mathfns as M
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import regex as RX
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import timezone as TZ
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.plan import host_table

N, CAP = 48, 64
EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)

WORDS = ["", "a", "ab cd", "  pad me  ", "héllo wörld", "日本語",
         "a\U0001F600b", "abc-123", "x9y", "no digits", "aabbcc", "1-URGENT",
         "5-LOW", "TAB\there", "xaby", "abcc", "MiXeD cAsE", "ab",
         "a1b22c333", "zz99"]
NUMS = ["12", "-3", " 7 ", "12.7", "1e3", "abc", "", "NaN", "-Infinity",
        "0.3", "9223372036854775807", "-9223372036854775808", "true", "no",
        "2020-02-29", "2019-02-29", "2000-1-5", "2021-12-31T10:00", " Y ",
        "1.5E-7", "+4", "128", "-129", "1996", "1996-07"]
DATES = [datetime.date(*t) for t in (
    (2000, 2, 29), (2020, 2, 29), (1999, 12, 31), (2019, 1, 31),
    (1969, 12, 31), (1970, 1, 1), (1900, 3, 1), (2100, 2, 28),
    (1995, 3, 15), (2024, 10, 31), (1600, 2, 29), (2023, 5, 31))]


def _days(d):
    return (d - datetime.date(1970, 1, 1)).days


def _lanes():
    rng = np.random.default_rng(20261018)
    pick = lambda xs: np.array(xs, dtype=object)[  # noqa: E731
        rng.integers(0, len(xs), N)]
    valid = lambda p: rng.random(N) > p  # noqa: E731
    v = rng.uniform(-1e4, 1e4, N)
    v[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e7, 1e-3, 9999999.0,
              0.1, -2.5e-7, 1e300, 123.456]
    w = rng.uniform(-3, 3, N)
    w[:6] = [0.0, -0.0, 1.0, -1.0, np.nan, np.inf]
    k = rng.integers(-1000, 1000, N).astype(np.int64)
    k[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -7]
    j = rng.choice([-7, -3, -1, 0, 1, 2, 3, 97], N).astype(np.int64)
    days = np.array([_days(d) for d in DATES] +
                    list(rng.integers(-30000, 40000, N - len(DATES))),
                    np.int32)
    t = rng.integers(-2 * 10 ** 15, 2 * 10 ** 15, N)
    t[:4] = [0, -1, 1_583_020_800_123_456, 951_782_400_000_000]
    return {
        "s": (pick(WORDS), valid(0.1), "string"),
        "s2": (pick(WORDS), valid(0.1), "string"),
        "num": (np.array((NUMS * 2)[:N], dtype=object), valid(0.05),
                "string"),
        "v": (v, valid(0.1), "double"),
        "w": (w, valid(0.1), "double"),
        "f": (rng.uniform(-50, 50, N).astype(np.float32), valid(0.1),
              "float"),
        "k": (k, valid(0.1), "bigint"),
        "j": (j, valid(0.1), "bigint"),
        "i": (rng.integers(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32),
              valid(0.1), "int"),
        "d": (days, valid(0.1), "date"),
        "d2": (np.roll(days, 5), valid(0.1), "date"),
        "n": (rng.integers(-400, 400, N).astype(np.int64), valid(0.1),
              "bigint"),
        "t": (t.astype(np.int64), valid(0.1), "timestamp"),
        "b": (rng.random(N) > 0.5, valid(0.1), "boolean"),
    }


def _jax_namespace():
    import jax
    import spark_rapids_tpu  # noqa: F401  (x64 and jax config)
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.columnar import vector as jvector
    from spark_rapids_tpu.expr import aggregates as jagg
    from spark_rapids_tpu.expr import arithmetic as ja
    from spark_rapids_tpu.expr import cast as jc
    from spark_rapids_tpu.expr import datetime as jd
    from spark_rapids_tpu.expr import hashing as jh
    from spark_rapids_tpu.expr import mathfns as jm
    from spark_rapids_tpu.expr import predicates as jp
    from spark_rapids_tpu.expr import regex as jrx
    from spark_rapids_tpu.expr import strings as js
    from spark_rapids_tpu.expr import timezone as jtz
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.expr.core import lit as jlit
    from spark_rapids_tpu.plan import host_table as jhost
    return types.SimpleNamespace(
        jax=jax, dt=jdt, vector=jvector, Agg=jagg, A=ja, C=jc, D=jd, H=jh,
        M=jm, P=jp, RX=jrx, S=js, TZ=jtz, col=jcol, lit=jlit, host=jhost)


PORT = types.SimpleNamespace(dt=dt, Agg=Agg, A=A, C=C, D=D, H=H, M=M, P=P,
                             RX=RX, S=S, TZ=TZ, col=col, lit=lit)


@pytest.fixture(scope="module")
def batches():
    return host_table.table_to_batch(carry.host_table_from_lanes(_lanes()),
                                     capacity=CAP, device="cpu")


def _jax_batch(j):
    jt = {"bigint": j.dt.INT64, "double": j.dt.FLOAT64, "float":
          j.dt.FLOAT32, "int": j.dt.INT32, "string": j.dt.STRING,
          "date": j.dt.DATE, "timestamp": j.dt.TIMESTAMP,
          "boolean": j.dt.BOOL}
    return j.host.table_to_batch(j.host.HostTable(
        [j.host.HostColumn(v, m, jt[t]) for v, m, t in _lanes().values()],
        list(_lanes())), CAP)


def _lane(name):
    values, mask, _ = _lanes()[name]
    return [v if m else None for v, m in zip(values, mask)]


# --- the cases: family -> {name: expression made from either package} -------

#: the regexes held against plain Python's ``re`` on the same bytes (all
#: of them) and against the JAX package (the ``JAX_*`` subsets: its
#: unrolled automata take about a second of compiling each)
RLIKE_PATTERNS = [
    "abc", "a.c", "a*", "a+b", "ab?c", "[abc]+", "[^ab]", "[a-c0-2]+",
    "a|bc|d", "(ab)+c", "(?:a|b)c", "a{2}", "a{2,}b", "a{1,3}c",
    r"\d+", r"\w+\s\w+", r"\S+", "^ab", "ab$", "^a.*c$", "a.*b", "", "^$",
    ".*", "x", "[abc]{2,4}$", r"\bab", r"cd\b", "RGE", "^[0-9]-",
]
EXTRACTS = [(r"\d+", 0), (r"(\d+)", 1), (r"([a-c]+)\d", 1),
            (r"(\w+)-(\d+)", 2), (r"x(\d*)y", 1), (r"^(\w+)", 1),
            (r"^([0-9])-", 1), (r"(b+)(c*)$", 2)]
REPLACES = [(r"\d+", "#"), (r"\d", ""), (r"[aeiou]+", "<>"), (r"\s+", "_"),
            (r"^[0-9]-", "")]
JAX_RLIKE = ["a.c", "(ab)+c", r"\d+", "^a.*c$", r"\bab", "^[0-9]-"]
JAX_EXTRACT = [(r"(\w+)-(\d+)", 2), (r"^([0-9])-", 1)]
JAX_REPLACE = [(r"\d+", "#"), (r"^[0-9]-", "")]
LIKES = ["a%", "%b%", "_b%", "a_c%", "%", "", "ab cd", "%99", "%\\_%",
         "1-%", "%URGENT", "%_%_%"]


def _families(m):
    c, lit = m.col, m.lit
    S, RX, D, A, M, H, C, TZ, d = m.S, m.RX, m.D, m.A, m.M, m.H, m.C, m.TZ, \
        m.dt
    fam = {}
    fam["strings"] = {
        "length": S.Length(c("s")), "octet_length": S.OctetLength(c("s")),
        "upper": S.Upper(c("s")), "lower": S.Lower(c("s")),
        "initcap": S.InitCap(c("s")),
        "concat": S.Concat(c("s"), lit("-"), c("s2")),
        "concat_ws": S.ConcatWs("-", c("s"), c("s2"), lit("z")),
        "endswith": S.EndsWith(c("s"), "cd"),
        "contains": S.Contains(c("s"), "b"),
        "contains_empty": S.Contains(c("s"), ""),
        "startswith": S.StartsWith(c("s"), "a"),
        "trim": S.StringTrim(c("s")), "ltrim": S.StringTrimLeft(c("s")),
        "rtrim": S.StringTrimRight(c("s")),
        "repeat": S.StringRepeat(c("s"), 3),
        "repeat_zero": S.StringRepeat(c("s"), 0),
        "replace_ab": S.StringReplace(c("s"), "ab", "Z"),
        "replace_longer": S.StringReplace(c("s"), "a", "longer"),
        "replace_drop": S.StringReplace(c("s"), "c", ""),
        "translate": S.StringTranslate(c("s"), "abc", "xy"),
        "locate_start0": S.StringLocate(c("s"), "b", 0),
        "lt_columns": m.P.LessThan(c("s"), c("s2")),
        "ge_literal": m.P.GreaterThanOrEqual(c("s"), lit("ab")),
        "lt_literal_left": m.P.LessThan(lit("b"), c("s")),
        "between": m.P.And(m.P.GreaterThanOrEqual(c("s"), lit("a")),
                           m.P.LessThanOrEqual(c("s"), lit("b"))),
    }
    for i, pat in enumerate(LIKES):
        fam["strings"][f"like_{i}"] = S.Like(c("s"), pat)
    fam["regex"] = {f"rlike_{i}": RX.RLike(c("s"), p)
                    for i, p in enumerate(JAX_RLIKE)}
    for i, (p, g) in enumerate(JAX_EXTRACT):
        fam["regex"][f"extract_{i}"] = RX.RegExpExtract(c("s"), p, g)
    for i, (p, r) in enumerate(JAX_REPLACE):
        fam["regex"][f"replace_{i}"] = RX.RegExpReplace(c("s"), p, r)
    fam["dates"] = {
        "year": D.Year(c("d")), "month": D.Month(c("d")),
        "day": D.DayOfMonth(c("d")), "quarter": D.Quarter(c("d")),
        "dayofweek": D.DayOfWeek(c("d")), "weekday": D.WeekDay(c("d")),
        "dayofyear": D.DayOfYear(c("d")), "last_day": D.LastDay(c("d")),
        "year_ts": D.Year(c("t")), "dayofyear_ts": D.DayOfYear(c("t")),
        "hour": D.Hour(c("t")), "minute": D.Minute(c("t")),
        "second": D.Second(c("t")),
        "date_add": D.DateAdd(c("d"), c("n")),
        "date_sub": D.DateSub(c("d"), c("n")),
        "datediff": D.DateDiff(c("d"), c("d2")),
        "datediff_ts": D.DateDiff(c("t"), c("d")),
        "add_months": D.AddMonths(c("d"), c("n")),
        "add_months_lit": D.AddMonths(c("d"), lit(1)),
        "trunc_year": D.TruncDate(c("d"), "year"),
        "trunc_month": D.TruncDate(c("d"), "mm"),
        "trunc_quarter": D.TruncDate(c("d"), "quarter"),
        "trunc_week": D.TruncDate(c("d"), "week"),
        "unix_timestamp": D.UnixTimestampToSeconds(c("t")),
        "unix_timestamp_date": D.UnixTimestampToSeconds(c("d")),
        "from_unixtime": D.FromUnixTime(c("n")),
    }
    fam["zones"] = {}
    for zone in ("America/Los_Angeles", "Asia/Kolkata", "Europe/London",
                 "Australia/Lord_Howe", "+08:00", "UTC-3", "GMT+05:30"):
        fam["zones"][f"from_utc_{zone}"] = TZ.FromUTCTimestamp(c("t"), zone)
        fam["zones"][f"to_utc_{zone}"] = TZ.ToUTCTimestamp(c("t"), zone)
    fam["arith"] = {
        "div": A.IntegralDivide(c("k"), c("j")),
        "div_double": A.IntegralDivide(c("v"), lit(3.5)),
        "rem": A.Remainder(c("k"), c("j")),
        "rem_int32": A.Remainder(c("i"), lit(97)),
        "rem_double": A.Remainder(c("v"), c("w")),
        "pmod_positive": A.Pmod(c("k"), lit(7)),
        "pmod_double_positive": A.Pmod(c("v"), lit(2.5)),
        "least_double": A.Least(c("v"), c("w")),
        "greatest_double": A.Greatest(c("v"), c("w"), lit(0.5)),
        "least_int": A.Least(c("k"), c("j")),
        "greatest_int_long": A.Greatest(c("i"), c("k")),
        "least_date": A.Least(c("d"), c("d2")),
        "unary_positive": A.UnaryPositive(c("v")),
        "abs_long": A.Abs(c("k")), "abs_double": A.Abs(c("v")),
    }
    fam["math"] = {name: cls(c("w")) for name, cls in (
        ("sqrt", M.Sqrt), ("exp", M.Exp), ("expm1", M.Expm1),
        ("ln", M.Log), ("log1p", M.Log1p), ("log2", M.Log2),
        ("log10", M.Log10), ("sin", M.Sin), ("cos", M.Cos), ("tan", M.Tan),
        ("asin", M.Asin), ("acos", M.Acos), ("atan", M.Atan),
        ("sinh", M.Sinh), ("cosh", M.Cosh), ("tanh", M.Tanh),
        ("asinh", M.Asinh), ("acosh", M.Acosh), ("atanh", M.Atanh),
        ("degrees", M.ToDegrees), ("radians", M.ToRadians),
        ("rint", M.Rint))}
    fam["math"].update({
        "cbrt": M.Cbrt(c("v")), "ln_int": M.Log(c("k")),
        "floor_finite": M.Floor(c("f")), "ceil_finite": M.Ceil(c("f")),
        "floor_long": M.Floor(c("k")),
        "atan2": M.Atan2(c("w"), c("v")), "hypot": M.Hypot(c("w"), c("v")),
    })
    fam["hashes"] = {
        "hash_string": H.Murmur3Hash(c("s")),
        "hash_mixed": H.Murmur3Hash(c("k"), c("d"), c("v"), c("b"),
                                    c("i")),
        "hash_string_date": H.Murmur3Hash(c("s"), c("d")),
        "xxhash64_mixed": H.XxHash64(c("k"), c("v"), c("i"), c("d"),
                                     c("b"), c("f")),
        "xxhash64_timestamp": H.XxHash64(c("t")),
    }
    fam["casts"] = {
        "str_to_int": C.Cast(c("num"), d.INT32),
        "str_to_bigint": C.Cast(c("num"), d.INT64),
        "str_to_tinyint": C.Cast(c("num"), d.INT8),
        "str_to_date": C.Cast(c("num"), d.DATE),
        "long_to_str": C.Cast(c("k"), d.STRING),
        "int_to_str": C.Cast(c("i"), d.STRING),
        "bool_to_str": C.Cast(c("b"), d.STRING),
        "date_to_str": C.Cast(c("d"), d.STRING),
        "ts_to_str": C.Cast(c("t"), d.STRING),
        "date_to_ts": C.Cast(c("d"), d.TIMESTAMP),
        "ts_to_date": C.Cast(c("t"), d.DATE),
        "ts_to_long": C.Cast(c("t"), d.INT64),
        "long_to_ts": C.Cast(c("n"), d.TIMESTAMP),
        "str_roundtrip_long": C.Cast(C.Cast(c("k"), d.STRING), d.INT64),
        "str_roundtrip_date": C.Cast(C.Cast(c("d"), d.STRING), d.DATE),
    }
    return fam


FAMILIES = _families(PORT)
CASES = [(f, n) for f, cases in FAMILIES.items() for n in sorted(cases)]


def _port_values(e, batch):
    return host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
        [e.eval(batch)], ["x"], N, "cpu")))["x"]


def _jax_families(j, families):
    """{(family, name): (type, values)}: each family of the JAX package
    evaluated as one jitted projection of the batch."""
    jbatch = _jax_batch(j)
    schema = jbatch.schema()
    out = {}
    for fam, cases in _families(j).items():
        if fam not in families:
            continue
        names = sorted(cases)
        exprs = [cases[n] for n in names]
        cols = j.jax.jit(lambda b, es=exprs: [e.eval(b) for e in es])(jbatch)
        for n, e, c in zip(names, exprs, cols):
            out[(fam, n)] = (repr(e.data_type(schema)), j.host.to_pydict(
                j.host.batch_to_table(j.vector.ColumnarBatch(
                    [c], ["x"], N)))["x"])
    return out


#: the JAX side's jobs (a subprocess each, balanced by their compile
#: times): the families apart from regex, the regex family, and the SQL
#: texts
JAX_JOBS = [[("families", ("strings", "dates", "zones", "arith", "math",
                           "hashes", "casts")), ("sql", (16,))],
            [("families", ("regex",))], [("sql", (0, 1, 2, 3))],
            [("sql", (4, 5, 6, 7))], [("sql", (8, 9, 10, 11))],
            [("sql", (12, 13))], [("sql", (14,))], [("sql", (15,))]]


def _jax_side(out_path: str, job: int) -> None:
    """This file run as a script: one JAX job, on one core, its results
    pickled to ``out_path``."""
    if hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[job % len(cores)]})
    j = _jax_namespace()
    # a compile cache of the job's own, beside its results: every run
    # compiles afresh, as on a machine that never ran these tests
    j.jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(out_path), f"jax_cache{job}"))
    out = {}
    for kind, which in JAX_JOBS[job]:
        if kind == "families":
            out.update(_jax_families(j, which))
            continue
        from spark_rapids_tpu.conf import SrtConf as JConf
        from spark_rapids_tpu.plan.session import TpuSession as JSession
        session = JSession(JConf(SQL_SETTINGS))
        session.create_or_replace_temp_view("t", session.create_dataframe(
            _sql_table(), [(n, getattr(j.dt, t.upper()))
                           for n, t in SQL_SCHEMA]))
        out.update({("sql", i): session.sql(SQL_TEXTS[i]).collect()
                    for i in which})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def jax_procs(tmp_path_factory):
    """The JAX side, started before this module's first test."""
    tmp = tmp_path_factory.mktemp("scalar_jax")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        + SUBPROCESS_XLA_FLAGS).strip()
    procs = []
    for job in range(len(JAX_JOBS)):
        out = str(tmp / f"out{job}.pkl")
        # stderr to a file: a pipe left unread would stall the process
        err = open(str(tmp / f"err{job}.txt"), "wb")
        procs.append((out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, str(job)],
            env=env, stdout=subprocess.DEVNULL, stderr=err)))
    yield procs
    for _, err, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


@pytest.fixture(scope="module")
def jax_values(jax_procs):
    """Every JAX job's results (pickled by this file's own subprocesses)."""
    results = {}
    for out, err, proc in jax_procs:
        if proc.wait(timeout=600) != 0:
            err.flush()
            with open(err.name, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            pytest.fail(f"JAX side failed (rc {proc.returncode}):\n{tail}")
        with open(out, "rb") as f:
            results.update(pickle.load(f))
    return results


def _same(g, r):
    if isinstance(r, float) and isinstance(g, float):
        if math.isnan(r):
            return math.isnan(g)
        if r == g:
            return math.copysign(1, r) == math.copysign(1, g)
        return abs(g - r) <= 1e-9 * max(abs(r), abs(g))
    return g == r and type(g) is type(r)


def _assert_values(got, want, what=""):
    assert len(got) == len(want)
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w)]
    assert not bad, (what, bad[:5])


@pytest.mark.parametrize("family,name", CASES)
def test_scalar_expression_matches_jax(family, name, batches, jax_values):
    batch = batches
    e = FAMILIES[family][name]
    jtype, want = jax_values[(family, name)]
    assert repr(e.data_type(batch.schema())) == jtype
    _assert_values(_port_values(e, batch), want, name)


# --- the regexes against plain Python -----------------------------------------

def _py_rows(name):
    return [None if v is None else v.encode("utf-8") for v in _lane(name)]


REGEX_PY = (
    [("rlike", i, p, None) for i, p in enumerate(RLIKE_PATTERNS)]
    + [("extract", i, p, g) for i, (p, g) in enumerate(EXTRACTS)]
    + [("replace", i, p, r) for i, (p, r) in enumerate(REPLACES)])


@pytest.mark.parametrize("kind,i,pattern,arg", REGEX_PY)
def test_regex_matches_python_re(kind, i, pattern, arg, batches):
    """Every pattern against ``re`` over the same UTF-8 bytes (the
    engine matches bytes, as the JAX package's does): search for
    RLIKE, the group of the first match or '' for regexp_extract, and
    ``re.sub`` (Java's replaceAll for these patterns) for
    regexp_replace."""
    batch = batches
    pat = pattern.encode()
    if kind == "rlike":
        e = RX.RLike(col("s"), pattern)
        want = [None if v is None else re.search(pat, v) is not None
                for v in _py_rows("s")]
    elif kind == "extract":
        e = RX.RegExpExtract(col("s"), pattern, arg)
        want = [None if v is None else
                (m.group(arg).decode() if (m := re.search(pat, v)) else "")
                for v in _py_rows("s")]
    else:
        e = RX.RegExpReplace(col("s"), pattern, arg)
        want = [None if v is None else re.sub(pat, arg.encode(), v).decode()
                for v in _py_rows("s")]
    _assert_values(_port_values(e, batch), want, pattern)


# --- where the JAX package departs from Spark (ROADMAP.md C13) --------------

def _strings_batch(words):
    lanes = {"s": (np.array([w or "" for w in words], object),
                   np.array([w is not None for w in words]), "string")}
    return host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                     capacity=round_up(len(words)),
                                     device="cpu")


def round_up(n):
    return max(8, 1 << (n - 1).bit_length())


def _eval_all(e, batch, n):
    return host_table.to_pydict(host_table.batch_to_table(ColumnarBatch(
        [e.eval(batch)], ["x"], n, "cpu")))["x"]


def test_c13_string_order_past_zero_bytes():
    """'a' < 'a\\0' < 'a\\0b' (the JAX package finds the first two
    equal); string ``<`` and ORDER BY agree with Python's bytes order."""
    from spark_rapids_tpu_torch.ops import kernels as K
    words = ["a\x00", "a", "", "a\x00b", "\x00", "ab", "a\x00", None, "b"]
    batch = _strings_batch(words)
    b2 = _strings_batch(list(reversed(words)))
    got = _eval_all(P.LessThan(col("s"), lit("a\x00")), batch, len(words))
    assert got == [None if w is None else w.encode() < b"a\x00"
                   for w in words]
    pairs = list(zip(words, reversed(words)))
    e = P.LessThanOrEqual(col("s"), col("s2"))
    both = ColumnarBatch([batch.column("s"), b2.column("s")], ["s", "s2"],
                         len(words), "cpu")
    assert _eval_all(e, both, len(words)) == [
        None if a is None or b is None else a.encode() <= b.encode()
        for a, b in pairs]
    perm = K.sort_indices([batch.column("s")], [True], [False],
                          batch.live_mask())[:len(words)].tolist()
    assert [words[i] for i in perm] == sorted(
        [w for w in words if w is not None],
        key=lambda w: w.encode()) + [None]


@pytest.mark.parametrize("a,n,want", [
    (-7, -3, -1), (-7, 3, 2), (7, -3, 1), (7, 3, 1), (-9, -3, 0),
    (0, -5, 0), (-1, 97, 96), (-1, -97, -1)])
def test_c13_pmod_takes_sparks_sign(a, n, want):
    """pmod(a, n) = r = a % n, then (r + n) % n for a negative r: a
    negative divisor keeps its sign (the JAX package gives |n| + r)."""
    lanes = {"a": (np.array([a]), np.array([True]), "bigint"),
             "n": (np.array([n]), np.array([True]), "bigint")}
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8, device="cpu")
    assert _eval_all(A.Pmod(col("a"), col("n")), batch, 1) == [want]
    dbl = A.Pmod(C.Cast(col("a"), dt.FLOAT64), C.Cast(col("n"), dt.FLOAT64))
    assert _eval_all(dbl, batch, 1) == [float(want)]


def test_c13_make_date_of_a_missing_day_is_null():
    lanes = {"y": (np.array([2019, 2020, 2019, 2000, 1900]), np.ones(5, bool),
                   "int"),
             "m": (np.array([2, 2, 4, 13, 2]), np.ones(5, bool), "int"),
             "d": (np.array([29, 29, 31, 1, 29]), np.ones(5, bool), "int")}
    batch = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                      capacity=8, device="cpu")
    got = _eval_all(D.MakeDate(col("y"), col("m"), col("d")), batch, 5)
    assert got == [None, datetime.date(2020, 2, 29), None, None, None]


def _like_re(pattern):
    out, i = "", 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out += re.escape(pattern[i + 1])
            i += 2
            continue
        out += ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        i += 1
    return re.compile(out, re.DOTALL)


MULTI = ["héllo wörld", "日本語", "a\U0001F600b", "é", "ab", "", None, "hé"]


@pytest.mark.parametrize("pattern", ["h_llo%", "hé%", "%ö%", "日_語", "_",
                                     "a_b", "__", "%\U0001F600%"])
def test_c13_like_counts_characters(pattern):
    """``_`` is one character and a literal any character (the JAX
    package matches ``_`` to one byte and refuses a multi-byte
    literal)."""
    got = _eval_all(S.Like(col("s"), pattern), _strings_batch(MULTI),
                    len(MULTI))
    rx = _like_re(pattern)
    assert got == [None if w is None else rx.fullmatch(w) is not None
                   for w in MULTI]


def _spark_pad(w, n, pad, left):
    if n <= 0:
        return ""
    if len(w) >= n or not pad:
        return w[:n]
    fill = (pad * n)[:n - len(w)]
    return fill + w if left else w + fill


@pytest.mark.parametrize("fn", ["reverse", "lpad", "rpad", "lpad_multi",
                                "locate", "locate_from", "locate_empty",
                                "replace_empty", "regexp_replace_empty",
                                "length"])
def test_c13_multibyte_text_counts_characters(fn):
    """reverse, lpad / rpad, locate and the empty-match advance of
    regexp_replace count characters, as Spark does (the JAX package
    counts bytes); replace with an empty search changes nothing (the
    JAX package raises)."""
    batch = _strings_batch(MULTI)
    e, ref = {
        "reverse": (S.Reverse(col("s")), lambda w: w[::-1]),
        "lpad": (S.Lpad(col("s"), 4, "*"),
                 lambda w: _spark_pad(w, 4, "*", True)),
        "rpad": (S.Rpad(col("s"), 5, "ö"),
                 lambda w: _spark_pad(w, 5, "ö", False)),
        "lpad_multi": (S.Lpad(col("s"), 7, "日x"),
                       lambda w: _spark_pad(w, 7, "日x", True)),
        "locate": (S.StringLocate(col("s"), "l"),
                   lambda w: w.find("l") + 1),
        "locate_from": (S.StringLocate(col("s"), "l", 5),
                        lambda w: w.find("l", 4) + 1),
        "locate_empty": (S.StringLocate(col("s"), "", 3), lambda w: 1),
        "replace_empty": (S.StringReplace(col("s"), "", "x"), lambda w: w),
        "regexp_replace_empty": (RX.RegExpReplace(col("s"), "q*", "-"),
                                 lambda w: re.sub("q*", "-", w)),
        "length": (S.Length(col("s")), len),
    }[fn]
    assert _eval_all(e, batch, len(MULTI)) == [
        None if w is None else ref(w) for w in MULTI]


def java_float_string(x, f32=False):
    """Java's Double.toString / Float.toString from Python's shortest
    repr."""
    if x != x:
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0:
        return "-0.0" if math.copysign(1, x) < 0 else "0.0"
    r = str(np.float32(abs(x))) if f32 else repr(float(abs(x)))
    t = Decimal(r).normalize().as_tuple()
    digits = "".join(map(str, t.digits))
    sx = len(digits) - 1 + t.exponent
    sign = "-" if x < 0 else ""
    if -3 <= sx < 7:
        if sx >= 0:
            return sign + (digits + "0" * 8)[:sx + 1] + "." + \
                (digits[sx + 1:] or "0")
        return sign + "0." + "0" * (-sx - 1) + digits
    return sign + digits[0] + "." + (digits[1:] or "0") + "E" + str(sx)


def test_c13_float_to_string_is_javas(batches):
    """CAST(double AS STRING) and CAST(float AS STRING) give Java's
    shortest form (the JAX package refuses both), over the batch's
    doubles and floats and random bit patterns of every exponent."""
    batch = batches
    got = _port_values(C.Cast(col("v"), dt.STRING), batch)
    assert got == [None if x is None else java_float_string(x)
                   for x in _lane("v")]
    got = _port_values(C.Cast(col("f"), dt.STRING), batch)
    assert got == [None if x is None else java_float_string(float(x), True)
                   for x in _lane("f")]
    rng = np.random.default_rng(7)
    bits = rng.integers(-2 ** 63, 2 ** 63 - 1, 4000, dtype=np.int64)
    xs = bits.view(np.float64)
    lanes = {"x": (xs, np.ones(xs.shape[0], bool), "double")}
    b = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                  capacity=4096, device="cpu")
    got = _eval_all(C.Cast(col("x"), dt.STRING), b, xs.shape[0])
    assert got == [java_float_string(float(x)) for x in xs]


def _spark_double(text):
    t = text.strip(" \t\n\r")
    low = t.lower()
    if low in ("nan",):
        return math.nan
    if low.lstrip("+-") in ("inf", "infinity"):
        return -math.inf if low.startswith("-") else math.inf
    if not re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", t):
        return None
    return float(t)


def _spark_bool(text):
    t = text.strip(" \t\n\r").lower()
    return True if t in ("true", "t", "yes", "y", "1") else \
        False if t in ("false", "f", "no", "n", "0") else None


def test_c13_string_to_double_and_boolean(batches):
    """STRING -> DOUBLE reads the nearest double ('0.3' is 0.3; the JAX
    package multiplies by an inexact power of ten), STRING -> BOOLEAN
    trims whitespace first (the JAX package does not)."""
    batch = batches
    got = _port_values(C.Cast(col("num"), dt.FLOAT64), batch)
    for g, t in zip(got, _lane("num")):
        want = None if t is None else _spark_double(t)
        assert _same(g, want) if want is not None else g is None, t
    got = _port_values(C.Cast(col("num"), dt.BOOL), batch)
    assert got == [None if t is None else _spark_bool(t)
                   for t in _lane("num")]


def _java_pow(x, y):
    if y != y or (abs(x) == 1.0 and math.isinf(y)):
        return math.nan
    try:
        return math.pow(x, y)
    except OverflowError:
        return math.inf if x > 0 or float(y).is_integer() and y % 2 == 0 \
            else -math.inf
    except ValueError:
        return math.nan


def _java_to_long(x):
    if x != x:
        return 0
    return int(max(min(x, 2 ** 63 - 1), -2 ** 63))


def test_c13_java_math_special_cases(batches):
    """pow with a NaN exponent or +-1 to an infinite power is NaN,
    floor / ceil of NaN or past BIGINT's range take Spark's cast, and
    signum keeps -0.0 and NaN."""
    batch = batches
    v, w = _lane("v"), _lane("w")
    got = _port_values(M.Pow(col("w"), col("v")), batch)
    want = [None if a is None or b is None else _java_pow(a, b)
            for a, b in zip(w, v)]
    _assert_values(got, want)
    lanes = {"x": (np.array([1.0, -1.0, 2.0, 0.0]), np.ones(4, bool),
                   "double"),
             "y": (np.array([np.nan, np.inf, np.nan, np.nan]),
                   np.ones(4, bool), "double")}
    b = host_table.table_to_batch(carry.host_table_from_lanes(lanes),
                                  capacity=8, device="cpu")
    assert all(math.isnan(g) for g in
               _eval_all(M.Pow(col("x"), col("y")), b, 4))
    for cls, fn in ((M.Floor, math.floor), (M.Ceil, math.ceil)):
        got = _port_values(cls(col("v")), batch)
        assert got == [None if x is None else
                       _java_to_long(fn(x) if math.isfinite(x) else x)
                       for x in v]
    got = _port_values(M.Signum(col("w")), batch)
    _assert_values(got, [None if x is None else
                         x if x == 0 or x != x else math.copysign(1.0, x)
                         for x in w])


# --- SQL through both packages' session.sql ----------------------------------

def _sql_table():
    rng = np.random.default_rng(5)
    n = 300
    words = np.array(["ab", "1-URGENT", "5-LOW", "héllo", "", "x9y",
                      "abc-123", "zz"], object)
    ascii_words = np.array(["ab cd", " x-1 ", "Hello World", "q", "",
                            "abc-123", "mIxEd"], object)
    ts = [EPOCH + datetime.timedelta(seconds=int(u) // 10 ** 6)
          for u in rng.integers(-10 ** 15, 10 ** 15, n)]
    data = {
        "k": list(range(n)),
        "g": [int(x) for x in rng.integers(0, 5, n)],
        "s": [None if m else str(w) for w, m in
              zip(words[rng.integers(0, len(words), n)], rng.random(n) < .1)],
        "s2": [str(w) for w in words[rng.integers(0, len(words), n)]],
        "a": [str(w) for w in ascii_words[rng.integers(0, len(ascii_words),
                                                       n)]],
        "v": [None if m else float(x) for x, m in
              zip(rng.uniform(-100, 100, n), rng.random(n) < .1)],
        "d": [None if m else DATES[i % len(DATES)] for i, m in
              enumerate(rng.random(n) < .1)],
        "ts": ts,
    }
    return data


SQL_TEXTS = [
    "SELECT k, s FROM t WHERE s LIKE '%-%' ORDER BY k",
    "SELECT k, d + INTERVAL 3 DAYS AS a, d - INTERVAL 1 MONTH AS b, "
    "d + INTERVAL 2 YEARS AS c, d - INTERVAL 2 WEEKS AS w FROM t ORDER BY k",
    "SELECT k, k % 7 AS r, k div 7 AS q, pmod(k - 150, 7) AS p FROM t "
    "ORDER BY k",
    "SELECT k, s || '-' || s2 AS c FROM t ORDER BY k",
    "SELECT k FROM t WHERE s BETWEEN 'a' AND 'b' OR s2 > 'x' ORDER BY k",
    "SELECT g, first(k) AS f, last(k) AS l, first(v) AS fv, "
    "last(v) AS lv, COUNT(*) AS n FROM t GROUP BY g ORDER BY g",
    "SELECT k FROM t WHERE ts < TIMESTAMP '1990-01-01 00:00:00' ORDER BY k",
    "SELECT k, upper(s) AS u, length(s) AS l, regexp_extract(s, '(\\\\d+)', 1)"
    " AS e, s RLIKE '^[0-9]-' AS r FROM t ORDER BY k",
    "SELECT k, year(d) AS y, month(d) AS m, datediff(d, DATE '2000-01-01') "
    "AS dd, last_day(d) AS ld, dayofweek(d) AS dw FROM t ORDER BY k",
    "SELECT k, CAST(d AS TIMESTAMP) AS t2, CAST(k AS STRING) AS ks, "
    "hour(ts) AS h, CAST(ts AS DATE) AS td FROM t ORDER BY k",
    "SELECT g, SUM(sqrt(abs(v))) AS r, MAX(greatest(v, 0.0)) AS mg, "
    "MIN(hash(s)) AS h FROM t GROUP BY g ORDER BY g",
    # every function name that left the port's _NOT_PORTED, by family
    "SELECT k, sqrt(v) AS a1, cbrt(v) AS a2, exp(v / 50) AS a3, ln(v) AS a4,"
    " log(v) AS a5, log2(v) AS a6, log10(v) AS a7, sin(v) AS a8, cos(v) AS"
    " a9, tan(v) AS a10, asin(v / 100) AS a11, acos(v / 100) AS a12, "
    "atan(v) AS a13, sinh(v / 50) AS a14, cosh(v / 50) AS a15, tanh(v) AS "
    "a16, degrees(v) AS a17, radians(v) AS a18, sign(v) AS a19, signum(v) "
    "AS a20, floor(v) AS a21, ceil(v) AS a22, ceiling(v) AS a23, pow(v, 2.0)"
    " AS a24, power(v, 3.0) AS a25, atan2(v, k) AS a26, hypot(v, k) AS a27,"
    " pmod(k, 7) AS a28, least(v, k) AS a29, greatest(v, k, 0.5) AS a30 "
    "FROM t ORDER BY k",
    "SELECT k, length(a) AS b1, char_length(a) AS b2, octet_length(a) AS b3,"
    " upper(a) AS b4, ucase(a) AS b5, lower(a) AS b6, lcase(a) AS b7, "
    "trim(a) AS b8, ltrim(a) AS b9, rtrim(a) AS b10 FROM t ORDER BY k",
    "SELECT k, year(d) AS c1, month(d) AS c2, day(d) AS c3, dayofmonth(d) "
    "AS c4, quarter(d) AS c5, dayofweek(d) AS c6, dayofyear(d) AS c7, "
    "weekday(d) AS c8, last_day(d) AS c9, hour(ts) AS c10, minute(ts) AS "
    "c11, second(ts) AS c12, date_add(d, 40) AS c13, date_sub(d, 40) AS "
    "c14, datediff(d, DATE '2001-02-03') AS c15, add_months(d, -13) AS c16,"
    " from_unixtime(k * 86400) AS c17, make_date(2000 + g, g + 1, g + 27) "
    "AS c18, from_utc_timestamp(ts, 'Asia/Kolkata') AS c19, "
    "to_utc_timestamp(ts, '-03:30') AS c20 FROM t ORDER BY k",
    "SELECT k, hash(a, k) AS e1, xxhash64(k, v) AS e2, rlike(a, '^[a-z]') "
    "AS e5, regexp_like(a, 'd$') AS e6, regexp(a, '[0-9]') AS e7 FROM t "
    "ORDER BY k",
    "SELECT k, reverse(a) AS b11, initcap(a) AS b12, concat(a, '|', s2) AS "
    "b13, concat_ws('+', a, s) AS b14, lpad(a, 8, '*') AS b15, rpad(a, 3, "
    "'-') AS b16, replace(a, 'b', 'BB') AS b17, translate(a, 'abc', 'xy') "
    "AS b18, locate('b', a) AS b19, position('-', a) AS b20 FROM t "
    "ORDER BY k",
    "SELECT k, regexp_extract(a, '([0-9]+)', 1) AS e3, regexp_replace(a, "
    "'[aeiou]', '#') AS e4 FROM t ORDER BY k",
]


SQL_SETTINGS = {"srt.sql.batchSizeRows": 64}
SQL_SCHEMA = [("k", "int64"), ("g", "int64"), ("s", "string"),
              ("s2", "string"), ("a", "string"), ("v", "float64"),
              ("d", "date"), ("ts", "timestamp")]


@pytest.fixture(scope="module")
def port_session():
    from spark_rapids_tpu_torch.plan.session import TpuSession
    port = TpuSession(carry.conf_from_dict(SQL_SETTINGS), device="cpu")
    port.create_or_replace_temp_view("t", port.create_dataframe(
        _sql_table(), [(n, getattr(dt, t.upper())) for n, t in SQL_SCHEMA]))
    return port


@pytest.mark.parametrize("i", range(len(SQL_TEXTS)))
def test_sql_matches_jax(i, port_session, jax_values):
    """LIKE, INTERVAL, %, div, pmod, ||, string BETWEEN and >, FIRST /
    LAST over several batches, a TIMESTAMP literal, regexes, date
    fields, casts and hashes: the same rows through both packages."""
    text = SQL_TEXTS[i]
    got = port_session.sql(text).collect()
    want = jax_values[("sql", i)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert _same(g[key], w[key]), (text, key, g, w)


@pytest.mark.parametrize("text, what", [
    ("SELECT CAST(v AS DECIMAL(39,2)) FROM t", "no decimal(39,2)"),
    ("SELECT CAST(s AS NUMERIC(5,6)) FROM t", "no decimal(5,6)"),
    ("SELECT get_json_object(s, '$.*') FROM t", "get_json_object"),
    ("SELECT from_json(s, 'a INT') FROM t", "from_json"),
    ("SELECT to_json(s) FROM t", "to_json"),
    ("SELECT from_utc_timestamp(ts, 'Mars/Olympus_Mons') FROM t",
     "from_utc_timestamp"),
    ("SELECT CAST(s AS TIMESTAMP) FROM t", "cast string -> timestamp"),
    ("SELECT translate(s, 'é', 'e') FROM t", "non-ASCII"),
])
def test_what_the_port_cannot_run_raises(port_session, text, what):
    from spark_rapids_tpu_torch.sql import SqlError
    if what in _LOWERED:
        # refused here until the analyzer lowered them as the JAX
        # analyzer does: they plan, on the CPU engine
        marks = port_session.sql(text).explain("NOT_ON_TPU")
        assert marks.startswith("! Project") and _LOWERED[what] in marks
        return
    with pytest.raises(SqlError) as e:
        port_session.sql(text)
    assert what in str(e.value)


#: SQL functions of the list above that the analyzer now lowers
_LOWERED = {"from_json": "JsonToStructs", "to_json": "StructsToJson"}


@pytest.mark.parametrize("text, pattern, fn", [
    ("SELECT s, s RLIKE 'a(?=b)' AS r FROM t", "a(?=b)",
     lambda m, v: m is not None),
    ("SELECT s, regexp_extract(s, 'a|b', 0) AS r FROM t", "a|b",
     lambda m, v: m.group(0) if m else ""),
    ("SELECT s, regexp_replace(s, '(a)', '<$1>') AS r FROM t", None,
     lambda m, v: re.sub("(a)", r"<\g<1>>", v, flags=re.ASCII)),
])
def test_regex_the_device_refuses_runs_on_the_cpu_engine(port_session, text,
                                                         pattern, fn):
    """A pattern the device's transpiler refuses (lookaround,
    alternation under extract) and group references in a replacement
    run on the CPU engine through Python's ``re``."""
    df = port_session.sql(text)
    assert df.explain("NOT_ON_TPU").splitlines()[0].startswith("! Project")
    for r in df.collect():
        v = r["s"]
        want = None if v is None else fn(
            re.search(pattern, v, re.ASCII) if pattern else None, v)
        assert r["r"] == want, (text, v, r["r"], want)


if __name__ == "__main__":
    _jax_side(sys.argv[1], int(sys.argv[2]))


@pytest.mark.parametrize("fmt", ["year", "yy", "mm", "month", "quarter",
                                 "week"])
def test_c13_trunc_through_sql(port_session, fmt):
    """trunc(d, fmt) through SQL (the JAX analyzer passes the format as
    a Literal, which its TruncDate cannot read) against Python's
    calendar."""
    rows = port_session.sql(
        f"SELECT k, d, trunc(d, '{fmt}') AS t FROM t ORDER BY k").collect()
    for r in rows:
        d = r["d"]
        if d is None:
            assert r["t"] is None
            continue
        want = {"year": d.replace(month=1, day=1),
                "month": d.replace(day=1),
                "quarter": d.replace(month=(d.month - 1) // 3 * 3 + 1,
                                     day=1),
                "week": d - datetime.timedelta(days=d.weekday())}[
            {"yy": "year", "mm": "month"}.get(fmt, fmt)]
        assert r["t"] == want, r
