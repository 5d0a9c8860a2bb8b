"""Tag-then-convert planning and the CPU engine, on the CPU.

The port's planner tags each logical node for the device or the CPU
engine (``plan/overrides.py``), and a mixed plan moves its data across
seams (``plan/transitions.py``). Here, at a few thousand rows made from
a numpy seed:

- every expression class the port runs on the device, through its CPU
  evaluator (``plan/cpu_eval.py``) against its device evaluator on the
  same inputs (``EVAL_CASES``);
- the seams' lane conversion, lossless for strings, NULLs, dates,
  timestamps, wide decimals and nested lanes;
- each logical node through the port's ``execute_cpu`` against the JAX
  package's ``execute_cpu`` on the same host table, and rebuilt over
  inputs cut to the columns it reads (``with_children``);
- the port's ``tag_only(...).explain_lines()`` marks against the JAX
  package's, with every case where the port's device runs more listed
  (``WIDER``) and asserted;
- the shapes of the card's fallback phase (F1-F6 of ``chip_smoke.py``)
  through the port's session on the CPU against the JAX session, or
  against Python's ``decimal`` at 80 digits where the JAX package
  raises (ROADMAP C16);
- TPC-H q1 / q3 / q6 with ``srt.sql.enabled=false`` against the device
  path;
- ``apply_cost_model`` placements against the JAX package's on the plans
  of ``tests/test_cost_model.py``.
"""

import datetime
import decimal
import math

import numpy as np
import pytest
import torch

from jax_reference import patch_jax_compiles
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.vector import ColumnarBatch
from spark_rapids_tpu_torch.conf import SrtConf
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import bitwise as BW
from spark_rapids_tpu_torch.expr import collections as CX
from spark_rapids_tpu_torch.expr import conditional as Cond
from spark_rapids_tpu_torch.expr import datetime as D
from spark_rapids_tpu_torch.expr import hashing as H
from spark_rapids_tpu_torch.expr import higher_order as HO
from spark_rapids_tpu_torch.expr import json as JX
from spark_rapids_tpu_torch.expr import mathfns as M
from spark_rapids_tpu_torch.expr import misc as MX
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import regex as RX
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import timezone as TZ
from spark_rapids_tpu_torch.expr.cast import Cast
from spark_rapids_tpu_torch.expr.core import Alias, col, lit
from spark_rapids_tpu_torch.expr.misc import MonotonicallyIncreasingID
from spark_rapids_tpu_torch.plan import cpu_eval
from spark_rapids_tpu_torch.plan.host_table import (
    batch_to_table, from_engine, table_to_batch, to_engine, to_pydict)
from spark_rapids_tpu_torch.plan.session import TpuSession

CPU = torch.device("cpu")
RTOL = 1e-9
N = 2048
SEED = 20261018
CTX = decimal.Context(prec=80)


# --- the shared table ------------------------------------------------------

def _table_data(n: int = N, seed: int = SEED):
    """{name: [Python values]} with NULLs, edge values and nested rows."""
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        keep = rng.random(len(vals)) >= p
        return [v if k else None for v, k in zip(vals, keep)]

    words = ["", "a", "ab", "Hello World", " pad ", "é", "日本語", "x_y%z",
             "abcabc", "Aa Bb", "zz", "12", "-3.5", "1e3", "true", "no"]
    ints = [int(x) for x in rng.integers(-50, 50, n)]
    ints[:4] = [2147483647, -2147483648, 0, -1]
    longs = [int(x) for x in rng.integers(-10 ** 12, 10 ** 12, n)]
    longs[:3] = [2 ** 63 - 1, -2 ** 63, 0]
    floats = [float(x) for x in rng.normal(0, 100, n)]
    floats[:6] = [float("nan"), -0.0, float("inf"), float("-inf"), 0.5,
                  2.5]
    dates = [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(x))
             for x in rng.integers(-20000, 30000, n)]
    stamps = [datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
              + datetime.timedelta(microseconds=int(x))
              for x in rng.integers(-2 * 10 ** 15, 4 * 10 ** 15, n)]
    narrow = [decimal.Decimal(int(x)).scaleb(-2)
              for x in rng.integers(-10 ** 9, 10 ** 9, n)]
    wide = [decimal.Decimal(int(x) * 10 ** 12 + int(y)).scaleb(-4)
            for x, y in zip(rng.integers(-10 ** 12, 10 ** 12, n),
                            rng.integers(0, 10 ** 12, n))]
    arrays = [None if k % 11 == 0 else
              [None if (k + j) % 7 == 0 else int(v)
               for j, v in enumerate(rng.integers(-5, 6, k % 5))]
              for k in range(n)]
    sarrays = [None if k % 13 == 0 else
               [words[(k + j) % len(words)] for j in range(k % 4)]
               for k in range(n)]
    structs = [None if k % 9 == 0 else
               {"x": int(k % 17) - 8, "y": words[k % len(words)]}
               for k in range(n)]
    docs = ['{"a": %d, "b": {"c": "%s"}, "d": [1, 2.5, null]}'
            % (k, words[k % len(words)]) for k in range(n)]
    return {
        "i": nulls(ints), "l": nulls(longs), "f": nulls(floats),
        "s": nulls([words[int(x)] for x in rng.integers(0, len(words), n)]),
        "d": nulls(dates), "ts": nulls(stamps), "n": nulls(narrow),
        "w": nulls(wide), "b": nulls([bool(x) for x in rng.integers(0, 2, n)]),
        "k": [int(x) for x in rng.integers(0, 40, n)],
        "a": arrays, "sa": sarrays, "st": structs, "j": nulls(docs),
        "pos": [int(x) for x in rng.integers(-3, 4, n)],
    }


SCHEMA = [("i", dt.INT32), ("l", dt.INT64), ("f", dt.FLOAT64),
          ("s", dt.STRING), ("d", dt.DATE), ("ts", dt.TIMESTAMP),
          ("n", dt.DecimalType(12, 2)), ("w", dt.DecimalType(30, 4)),
          ("b", dt.BOOL), ("k", dt.INT64),
          ("a", dt.ArrayType(dt.INT64)), ("sa", dt.ArrayType(dt.STRING)),
          ("st", dt.StructType((("x", dt.INT64), ("y", dt.STRING)))),
          ("j", dt.STRING), ("pos", dt.INT32)]

_BATCH = {}


def _batch() -> ColumnarBatch:
    if "b" not in _BATCH:
        from spark_rapids_tpu_torch.plan.session import \
            _host_table_from_pydict
        _BATCH["b"] = table_to_batch(
            _host_table_from_pydict(_table_data(), SCHEMA), device=CPU)
    return _BATCH["b"]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-300)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


# --- every device expression against its CPU evaluator ---------------------

def _hof(cls, child, fn):
    v = HO.LambdaVariable()
    return cls(child, v, fn(v))


def _map_lambda(cls, child, fn):
    k, v = HO.LambdaVariable(), HO.LambdaVariable()
    return cls(child, k, v, fn(k, v))


_M = HO.create_map(col("k"), col("f"), lit(70), col("i"))


def _ansi(expr):
    from spark_rapids_tpu_torch.expr.ansi import enable_ansi
    return enable_ansi(expr)


def _bloom_bits():
    """A filter over the even ``l`` values, built by ops/bloom.py."""
    from spark_rapids_tpu_torch.columnar.vector import ColumnVector
    from spark_rapids_tpu_torch.ops import bloom as B
    keys = torch.tensor([v for v in _table_data()["l"][::2] if v is not None],
                        dtype=torch.int64)
    ones = torch.ones(len(keys), dtype=torch.bool)
    return B.build_bloom([ColumnVector(keys, ones, dt.INT64)], ones,
                         B.choose_num_bits(len(keys)))


_BLOOM = _bloom_bits()
_UNARY_MATH = ["Acos", "Acosh", "Asin", "Asinh", "Atan", "Atanh", "Cbrt",
               "Cos", "Cosh", "Exp", "Expm1", "Log", "Log10", "Log1p",
               "Log2", "Rint", "Signum", "Sin", "Sinh", "Sqrt", "Tan",
               "Tanh", "ToDegrees", "ToRadians"]

EVAL_CASES = {
    # arithmetic
    "add_int": lambda: A.Add(col("i"), col("pos")),
    "add_long_wraps": lambda: A.Add(col("l"), col("l")),
    "add_decimal": lambda: A.Add(col("n"), col("n")),
    "add_wide": lambda: A.Add(col("w"), col("n")),
    "subtract": lambda: A.Subtract(col("f"), col("i")),
    "multiply_decimal": lambda: A.Multiply(col("n"), col("n")),
    "multiply_wide": lambda: A.Multiply(col("w"), lit(3)),
    "divide": lambda: A.Divide(col("i"), col("pos")),
    "divide_decimal": lambda: A.Divide(col("n"), Cast(col("pos"),
                                                      dt.DecimalType(5, 1))),
    "integral_divide": lambda: A.IntegralDivide(col("l"), col("pos")),
    "integral_divide_decimal": lambda: A.IntegralDivide(col("n"), lit(7)),
    "remainder": lambda: A.Remainder(col("i"), col("pos")),
    "remainder_float": lambda: A.Remainder(col("f"), lit(3.0)),
    "pmod": lambda: A.Pmod(col("i"), col("pos")),
    "pmod_decimal": lambda: A.Pmod(col("n"), lit(7)),
    "unary_minus": lambda: A.UnaryMinus(col("i")),
    "unary_positive": lambda: A.UnaryPositive(col("n")),
    "abs": lambda: A.Abs(col("l")),
    "abs_decimal": lambda: A.Abs(col("w")),
    "least": lambda: A.Least(col("i"), col("pos"), lit(3)),
    "greatest_float": lambda: A.Greatest(col("f"), lit(1.5)),
    "greatest_string": lambda: A.Greatest(col("s"), lit("b")),
    "least_decimal": lambda: A.Least(col("n"), lit(2)),
    "bitwise_and": lambda: BW.BitwiseAnd(col("l"), lit(255)),
    "shift_right": lambda: BW.ShiftRight(col("i"), col("pos")),
    "bitwise_or": lambda: BW.BitwiseOr(col("l"), col("i")),
    "bitwise_xor": lambda: BW.BitwiseXor(col("i"), col("pos")),
    "bitwise_not": lambda: BW.BitwiseNot(col("l")),
    "shift_left": lambda: BW.ShiftLeft(col("l"), col("pos")),
    "shift_right_unsigned": lambda: BW.ShiftRightUnsigned(col("i"),
                                                          col("pos")),
    "bit_count": lambda: BW.BitCount(col("l")),
    "bit_count_bool": lambda: BW.BitCount(col("b")),
    "interleave_bits": lambda: BW.InterleaveBits(col("i"), col("l"),
                                                 col("pos")),
    # ANSI lanes on rows that do not raise, and guards a conditional
    # keeps from the rows that would
    "ansi_add": lambda: _ansi(A.Add(col("k"), col("pos"))),
    "ansi_divide_guarded": lambda: _ansi(Cond.If(
        P.Not(P.EqualTo(col("pos"), lit(0))),
        A.IntegralDivide(col("k"), col("pos")), lit(-1))),
    "ansi_case_cast": lambda: _ansi(Cond.CaseWhen(
        [(P.EqualTo(col("s"), lit("12")), Cast(col("s"), dt.INT32))],
        lit(0))),
    "ansi_and": lambda: _ansi(P.And(
        P.GreaterThan(col("pos"), lit(0)),
        P.GreaterThan(A.Remainder(col("i"), col("pos")), lit(1)))),
    "ansi_coalesce": lambda: _ansi(Cond.Coalesce(
        col("pos"), A.IntegralDivide(col("l"), lit(0)))),
    "ansi_decimal_cast": lambda: _ansi(Cast(col("n"),
                                            dt.DecimalType(20, 1))),
    # misc
    "spark_partition_id": lambda: MX.SparkPartitionID(),
    "uuid": lambda: MX.Uuid(seed=7),
    "version": lambda: MX.Version(),
    "input_file_name": lambda: MX.InputFileName(),
    "input_file_block_start": lambda: MX.InputFileBlockStart(),
    "input_file_block_length": lambda: MX.InputFileBlockLength(),
    "raise_error_unreached": lambda: Cond.If(
        P.GreaterThan(col("k"), lit(100)), MX.RaiseError("boom"), col("s")),
    "might_contain": lambda: H.BloomFilterMightContain(col("l"), _BLOOM),
    "hash_wide_decimal": lambda: H.Murmur3Hash(col("w"), col("i")),
    "xxhash64_wide_decimal": lambda: H.XxHash64(col("w")),
    # casts
    "cast_int_string": lambda: Cast(col("i"), dt.STRING),
    "cast_float_string": lambda: Cast(col("f"), dt.STRING),
    "cast_decimal_string": lambda: Cast(col("n"), dt.STRING),
    "cast_date_string": lambda: Cast(col("d"), dt.STRING),
    "cast_ts_string": lambda: Cast(col("ts"), dt.STRING),
    "cast_bool_string": lambda: Cast(col("b"), dt.STRING),
    "cast_string_int": lambda: Cast(col("s"), dt.INT32),
    "cast_string_double": lambda: Cast(col("s"), dt.FLOAT64),
    "cast_string_decimal": lambda: Cast(col("s"), dt.DecimalType(8, 2)),
    "cast_string_date": lambda: Cast(Cast(col("d"), dt.STRING), dt.DATE),
    "cast_float_long": lambda: Cast(col("f"), dt.INT64),
    "cast_long_int": lambda: Cast(col("l"), dt.INT32),
    "cast_decimal_long": lambda: Cast(col("n"), dt.INT64),
    "cast_decimal_int_wraps": lambda: Cast(col("w"), dt.INT32),
    "cast_decimal_double": lambda: Cast(col("w"), dt.FLOAT64),
    "cast_double_decimal": lambda: Cast(col("f"), dt.DecimalType(10, 3)),
    "cast_decimal_rescale": lambda: Cast(col("w"), dt.DecimalType(12, 1)),
    "cast_ts_date": lambda: Cast(col("ts"), dt.DATE),
    "cast_date_ts": lambda: Cast(col("d"), dt.TIMESTAMP),
    "cast_ts_long": lambda: Cast(col("ts"), dt.INT64),
    "cast_int_bool": lambda: Cast(col("pos"), dt.BOOL),
    "cast_wide_string": lambda: Cast(col("w"), dt.STRING),
    "cast_string_wide": lambda: Cast(Cast(col("w"), dt.STRING),
                                     dt.DecimalType(25, 3)),
    # predicates
    "equal_to": lambda: P.EqualTo(col("i"), col("pos")),
    "equal_float_nan": lambda: P.EqualTo(col("f"), col("f")),
    "equal_decimals": lambda: P.EqualTo(col("n"), col("w")),
    "less_than_string": lambda: P.LessThan(col("s"), lit("b")),
    "greater_than": lambda: P.GreaterThan(col("f"), lit(0.0)),
    "le_date": lambda: P.LessThanOrEqual(col("d"),
                                         lit(datetime.date(2000, 1, 1))),
    "ge_wide": lambda: P.GreaterThanOrEqual(col("w"), lit(0)),
    "equal_null_safe": lambda: P.EqualNullSafe(col("i"), col("pos")),
    "and_or_not": lambda: P.Or(P.And(col("b"), P.IsNull(col("i"))),
                               P.Not(col("b"))),
    "is_nan": lambda: P.IsNaN(col("f")),
    "is_not_null": lambda: P.IsNotNull(col("s")),
    "in_set": lambda: P.InSet(col("i"), [1, 2, 3, None]),
    "in_set_string": lambda: P.InSet(col("s"), ["a", "zz"]),
    # conditionals
    "case_when": lambda: Cond.CaseWhen(
        [(P.GreaterThan(col("i"), lit(0)), col("n")),
         (col("b"), col("w"))], lit(0)),
    "if_string": lambda: Cond.If(col("b"), col("s"), lit("no")),
    "coalesce": lambda: Cond.Coalesce(col("i"), col("pos")),
    "nullif": lambda: Cond.NullIf(col("i"), col("pos")),
    "nvl": lambda: Cond.Nvl(col("s"), lit("?")),
    "nvl2": lambda: Cond.Nvl2(col("s"), col("i"), col("pos")),
    # dates and times
    "year": lambda: D.Year(col("d")), "month": lambda: D.Month(col("ts")),
    "day": lambda: D.DayOfMonth(col("d")),
    "quarter": lambda: D.Quarter(col("d")),
    "day_of_week": lambda: D.DayOfWeek(col("d")),
    "week_day": lambda: D.WeekDay(col("d")),
    "day_of_year": lambda: D.DayOfYear(col("d")),
    "last_day": lambda: D.LastDay(col("d")),
    "hour": lambda: D.Hour(col("ts")), "minute": lambda: D.Minute(col("ts")),
    "second": lambda: D.Second(col("ts")),
    "date_add": lambda: D.DateAdd(col("d"), col("pos")),
    "date_sub": lambda: D.DateSub(col("d"), col("k")),
    "date_diff": lambda: D.DateDiff(col("d"), lit(datetime.date(2001, 2, 3))),
    "add_months": lambda: D.AddMonths(col("d"), col("pos")),
    "unix_timestamp": lambda: D.UnixTimestampToSeconds(col("ts")),
    "from_unixtime": lambda: D.FromUnixTime(col("i")),
    "make_date": lambda: D.MakeDate(lit(2020), col("pos") + lit(4),
                                    col("k")),
    "trunc_month": lambda: D.TruncDate(col("d"), "month"),
    "from_utc": lambda: TZ.FromUTCTimestamp(col("ts"), "America/New_York"),
    "to_utc": lambda: TZ.ToUTCTimestamp(col("ts"), "+05:30"),
    # hashes
    "murmur3": lambda: H.Murmur3Hash(col("i"), col("s"), col("f")),
    "xxhash64": lambda: H.XxHash64(col("l"), col("d"), col("n")),
    # math
    "floor": lambda: M.Floor(col("f")), "ceil": lambda: M.Ceil(col("n")),
    "pow": lambda: M.Pow(col("f"), lit(2.0)),
    "atan2": lambda: M.Atan2(col("f"), col("i")),
    "hypot": lambda: M.Hypot(col("f"), col("i")),
    "round_float": lambda: M.Round(col("f"), 1),
    "round_decimal": lambda: M.Round(col("n"), 1),
    "bround_int": lambda: M.BRound(col("i"), -1),
    # strings
    "length": lambda: S.Length(col("s")),
    "octet_length": lambda: S.OctetLength(col("s")),
    "upper": lambda: S.Upper(col("s")), "lower": lambda: S.Lower(col("s")),
    "substring": lambda: S.Substring(col("s"), 2, 3),
    "substring_negative": lambda: S.Substring(col("s"), -2),
    "concat": lambda: S.Concat(col("s"), lit("-"), col("s")),
    "concat_ws": lambda: S.ConcatWs(",", col("s"), col("s")),
    "starts_with": lambda: S.StartsWith(col("s"), "a"),
    "ends_with": lambda: S.EndsWith(col("s"), "b"),
    "contains": lambda: S.Contains(col("s"), "l"),
    "like": lambda: S.Like(col("s"), "%a_%"),
    "like_multibyte": lambda: S.Like(col("s"), "_本%"),
    "trim": lambda: S.StringTrim(col("s")),
    "ltrim": lambda: S.StringTrimLeft(col("s")),
    "rtrim": lambda: S.StringTrimRight(col("s")),
    "reverse": lambda: S.Reverse(col("s")),
    "lpad": lambda: S.Lpad(col("s"), 6, "*"),
    "rpad": lambda: S.Rpad(col("s"), 3),
    "initcap": lambda: S.InitCap(col("s")),
    "locate": lambda: S.StringLocate(col("s"), "b"),
    "repeat": lambda: S.StringRepeat(col("s"), 2),
    "replace": lambda: S.StringReplace(col("s"), "a", "XY"),
    "translate": lambda: S.StringTranslate(col("s"), "al", "1"),
    "rlike": lambda: RX.RLike(col("s"), "^[a-z]+$"),
    "regexp_extract": lambda: RX.RegExpExtract(col("s"), "([a-z])([a-z]*)",
                                               2),
    "regexp_replace": lambda: RX.RegExpReplace(col("s"), "[ab]", "_"),
    "get_json_object": lambda: JX.GetJsonObject(col("j"), "$.b.c"),
    # collections
    "create_array": lambda: CX.array(col("i"), col("pos")),
    "size": lambda: CX.Size(col("a")),
    "get_array_item": lambda: CX.GetArrayItem(col("a"), lit(1)),
    "element_at": lambda: CX.ElementAt(col("a"), col("pos")),
    "array_contains": lambda: CX.ArrayContains(col("a"), lit(2)),
    "array_min": lambda: CX.ArrayMin(col("a")),
    "array_max": lambda: CX.ArrayMax(col("a")),
    "sort_array": lambda: CX.SortArray(col("a"), False),
    "array_distinct": lambda: CX.ArrayDistinct(col("a")),
    "array_union": lambda: CX.ArrayUnion(col("a"), CX.array(lit(1))),
    "array_intersect": lambda: CX.ArrayIntersect(col("a"), CX.array(lit(1),
                                                                   lit(2))),
    "array_except": lambda: CX.ArrayExcept(col("a"), CX.array(lit(0))),
    "arrays_overlap": lambda: CX.ArraysOverlap(col("a"), CX.array(lit(3))),
    "array_remove": lambda: CX.ArrayRemove(col("a"), lit(1)),
    "array_position": lambda: CX.ArrayPosition(col("a"), lit(-2)),
    "slice": lambda: CX.Slice(col("a"), lit(2), lit(2)),
    "array_reverse": lambda: CX.ArrayReverse(col("a")),
    "array_repeat": lambda: CX.ArrayRepeat(col("i"), lit(2)),
    "flatten": lambda: CX.Flatten(CX.array(col("a"), col("a"))),
    "arrays_zip": lambda: CX.ArraysZip(col("a"), col("a")),
    "array_join": lambda: CX.ArrayJoin(col("sa"), "|", "NULL"),
    "zip_with": lambda: CX.zip_with(col("a"), col("a"),
                                    lambda x, y: x + y),
    "named_struct": lambda: CX.struct(p=col("i"), q=col("s")),
    "get_struct_field": lambda: CX.GetStructField(col("st"), "y"),
    # higher-order functions and maps
    "transform": lambda: _hof(HO.ArrayTransform, col("a"),
                              lambda v: v * lit(2)),
    "exists": lambda: _hof(HO.ArrayExists, col("a"), lambda v: v > lit(2)),
    "forall": lambda: _hof(HO.ArrayForAll, col("a"), lambda v: v > lit(-4)),
    "filter": lambda: _hof(HO.ArrayFilter, col("a"), lambda v: v > lit(0)),
    "aggregate": lambda: HO.aggregate(col("a"), lit(0),
                                      lambda acc, v: acc + v),
    "create_map": lambda: _M,
    "map_keys": lambda: HO.MapKeys(_M), "map_values": lambda: HO.MapValues(_M),
    "map_entries": lambda: HO.MapEntries(_M),
    "get_map_value": lambda: HO.GetMapValue(_M, lit(7)),
    "map_contains_key": lambda: HO.MapContainsKey(_M, col("pos")),
    "transform_values": lambda: _map_lambda(HO.TransformValues, _M,
                                            lambda k, v: v + k),
    "transform_keys": lambda: _map_lambda(HO.TransformKeys, _M,
                                          lambda k, v: k * lit(3)),
    "map_filter": lambda: _map_lambda(HO.MapFilter, _M,
                                      lambda k, v: v > lit(0.0)),
    "map_from_arrays": lambda: HO.MapFromArrays(
        CX.array(lit(1), lit(2)), CX.array(col("s"), col("s"))),
    "monotonically_increasing_id": lambda: MonotonicallyIncreasingID(),
    "alias": lambda: Alias(col("i") + lit(1), "x"),
}
EVAL_CASES.update({
    f"math_{name.lower()}": (lambda cls: lambda: cls(col("f")))(
        getattr(M, name)) for name in _UNARY_MATH})

#: cases only the CPU engine runs: the device raises (the planner tags
#: them off the device)
CPU_ONLY = {"cast_wide_string", "cast_string_wide"}


def _device_rows(expr):
    b = _batch()
    out = expr.eval(b)
    vals, mask = out.to_numpy(b.num_rows)
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    return to_pydict(HostTable([HostColumn(vals, mask, out.dtype)],
                               ["r"]))["r"]


def _cpu_rows(expr):
    table = to_engine(batch_to_table(_batch()))
    c = cpu_eval.evaluate(expr, table)
    from spark_rapids_tpu_torch.plan.host_table import HostTable
    return to_pydict(from_engine(HostTable([c], ["r"])))["r"]


def check_evaluator(name, build):
    cpu = _cpu_rows(build())
    if name in CPU_ONLY:
        with pytest.raises(NotImplementedError, match="planner fault"):
            _device_rows(build())
        return cpu
    dev = _device_rows(build())
    assert len(cpu) == len(dev) == N
    bad = [(i, c, d) for i, (c, d) in enumerate(zip(cpu, dev))
           if not _same(c, d)]
    assert not bad, (name, len(bad), bad[:5])
    return cpu


def test_every_device_class_has_a_cpu_evaluator_and_a_case():
    """Each expression class the planner can put on the device has a
    CPU evaluator, and a case below (Explode is a Generate node)."""
    from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
    from spark_rapids_tpu_torch.expr.window import WindowFunction
    from spark_rapids_tpu_torch.plan.overrides import \
        _concrete_expression_classes
    covered = set()
    for build in EVAL_CASES.values():
        stack = [build()]
        while stack:
            e = stack.pop()
            covered.add(type(e))
            stack.extend(e.children)
            stack.extend(getattr(e, "bodies", lambda: [])())
    for cls in _concrete_expression_classes():
        if issubclass(cls, (AggregateFunction, WindowFunction)) or \
                cls is CX.Explode:
            continue
        assert cls in cpu_eval._EVALUATORS, cls
        if cls not in (JX.JsonToStructs, JX.StructsToJson, CX.MapConcat,
                       HO.LambdaVariable):
            assert cls in covered, cls


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_cpu_evaluator_matches_device_evaluator(name):
    check_evaluator(name, EVAL_CASES[name])


# --- the seams' lane conversion --------------------------------------------

SEAM_SCHEMA = [
    ("s", dt.STRING), ("d", dt.DATE), ("ts", dt.TIMESTAMP),
    ("w", dt.DecimalType(38, 10)), ("n", dt.DecimalType(9, 3)),
    ("f", dt.FLOAT64), ("a", dt.ArrayType(dt.STRING)),
    ("st", dt.StructType((("x", dt.INT64), ("y", dt.ArrayType(dt.INT32))))),
    ("m", dt.MapType(dt.INT64, dt.STRING))]


def _seam_data(n=600, seed=SEED):
    rng = np.random.default_rng(seed)
    full = _table_data(n, seed)
    big = decimal.Decimal(10 ** 38 - 1).scaleb(-10, context=CTX)
    wide = [None if k % 9 == 0 else
            (big if k % 7 == 0 else -big if k % 5 == 0 else
             decimal.Decimal(int(v)).scaleb(-10))
            for k, v in enumerate(rng.integers(-10 ** 15, 10 ** 15, n))]
    return {
        "s": full["s"], "d": full["d"], "ts": full["ts"], "w": wide,
        "n": [None if v is None else
              (v / 1000).quantize(decimal.Decimal("0.001"))
              for v in full["n"]],
        "f": full["f"], "a": full["sa"],
        "st": [None if k % 6 == 0 else
               {"x": None if k % 4 == 0 else k,
                "y": None if k % 5 == 0 else list(range(k % 3))}
               for k in range(n)],
        "m": [None if k % 8 == 0 else
              {j: (None if j % 2 else f"v{j}é") for j in range(k % 4)}
              for k in range(n)]}


def test_seams_are_lossless():
    """Device -> host -> CPU engine layout -> host -> device gives the
    same values: strings (multi-byte, empty, NULL), dates, timestamps,
    wide decimals at +-(10^38 - 1), NaN and -0.0, nested lanes with NULL
    rows, fields and elements."""
    from spark_rapids_tpu_torch.plan.session import _host_table_from_pydict
    data = _seam_data()
    host = _host_table_from_pydict(data, SEAM_SCHEMA)
    batch = table_to_batch(host, device=CPU)
    back = table_to_batch(from_engine(to_engine(batch_to_table(batch))),
                          device=CPU)
    got = to_pydict(batch_to_table(back))
    for name, _ in SEAM_SCHEMA:
        assert all(_same(g, w) for g, w in zip(got[name], data[name])), \
            name
    # and through a plan's two seams: a CPU-engine projection between
    # device operators
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": 128}),
                         device="cpu")
    df = session.create_dataframe(data, SEAM_SCHEMA)
    q = df.select(*[col(n) for n, _ in SEAM_SCHEMA],
                  Alias(Cast(col("w"), dt.STRING), "ws")).filter(
        P.IsNotNull(col("d")) | P.IsNull(col("d")))
    assert q.explain("NOT_ON_TPU").splitlines()[0].lstrip().startswith(
        "! Project")
    rows = q.collect()
    physical, ctx = session._last_execution
    totals = ctx.metric_totals()
    assert totals["transitionRows"] == 2 * len(data["s"])
    for name, _ in SEAM_SCHEMA:
        assert all(_same(r[name], w) for r, w in zip(rows, data[name])), \
            name
    assert [r["ws"] for r in rows] == [
        None if v is None else format(v.quantize(decimal.Decimal(
            "1e-10"), context=CTX), "f") for v in data["w"]]


# --- each logical node through both packages' execute_cpu ------------------

def _exec_data():
    rng = np.random.default_rng(SEED + 1)
    n = 1500
    full = _table_data(n, SEED + 1)
    return {"k": [int(x) for x in rng.integers(0, 12, n)],
            "i": full["i"], "f": full["f"], "s": full["s"],
            "d": full["d"], "n": full["n"], "a": full["a"]}


def _exec_schema(t):
    return [("k", t.INT64), ("i", t.INT32), ("f", t.FLOAT64),
            ("s", t.STRING), ("d", t.DATE), ("n", t.DecimalType(12, 2)),
            ("a", t.ArrayType(t.INT64))]


def _exec_plans(m):
    """Every logical node the CPU engine runs, over one LocalRelation,
    built with either package's modules (``m``)."""
    L, c, lt = m.L, m.col, m.lit
    rel = L.LocalRelation(_exec_data(), _exec_schema(m.dt))
    right = L.LocalRelation({"k2": list(range(0, 16, 2)),
                             "v": [f"r{j}" for j in range(8)]},
                            [("k2", m.dt.INT64), ("v", m.dt.STRING)])
    win = m.W.Window.partition_by("k").order_by("i", "f")
    return {
        "project": L.Project(rel, [m.Alias(c("i") * lt(3) + c("k"), "x"),
                                   m.Alias(m.S.Concat(c("s"), lt("!")),
                                           "u"),
                                   m.Alias(c("n") * c("n"), "nn")]),
        "filter": L.Filter(rel, (c("i") > lt(0)) & m.P.IsNotNull(c("s"))),
        "aggregate": L.Aggregate(rel, [c("s")], [
            (m.Agg.Sum(c("i")), "si"), (m.Agg.Average(c("f")), "af"),
            (m.Agg.Min(c("d")), "md"), (m.Agg.Max(c("n")), "mn"),
            (m.Agg.Count(c("f")), "cf"), (m.Agg.CountStar(), "c"),
            (m.Agg.StddevSamp(c("i")), "sd")]),
        "global_aggregate": L.Aggregate(rel, [], [
            (m.Agg.Sum(c("n")), "sn"), (m.Agg.Max(c("s")), "ms")]),
        "sort": L.Sort(rel, [L.SortField(c("s"), False),
                             L.SortField(c("f"), True),
                             L.SortField(c("i"), True, False)]),
        "limit": L.Limit(L.Sort(rel, [L.SortField(c("i")),
                                      L.SortField(c("f"))]), 25),
        "union": L.Union(rel, L.Filter(rel, c("k") > lt(5))),
        "expand": L.Expand(rel, [[c("k"), c("i")], [c("k"), lt(None)]],
                           ["k", "i2"]),
        "window": L.Window(rel, [
            (m.W.RowNumber().over(win), "rn"),
            (m.Agg.Sum(c("i")).over(win), "rs"),
            (m.W.Lag(c("s"), 1).over(win), "lg")]),
        **{f"join_{how}": L.Join(rel, right, [c("k")], [c("k2")], how)
           for how in ("inner", "left_outer", "right_outer", "full_outer",
                       "left_semi", "left_anti")},
        "generate": L.Generate(rel, m.CX.Explode(c("a"), True, True),
                               "e", "p"),
    }


def _namespace(pkg):
    import importlib
    from types import SimpleNamespace

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    core = mod("expr.core")
    return SimpleNamespace(
        L=mod("plan.logical"), dt=mod("columnar.dtypes"), col=core.col,
        lit=core.lit, Alias=core.Alias, S=mod("expr.strings"),
        P=mod("expr.predicates"), Agg=mod("expr.aggregates"),
        W=mod("expr.window"), CX=mod("expr.collections"),
        exec=mod("plan.cpu_exec"), host=mod("plan.host_table"),
        ov=mod("plan.overrides"), conf=mod("conf"))


ORDERED = {"sort", "limit"}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's side of every comparison here, in-process."""
    with pytest.MonkeyPatch.context() as mp, \
            decimal.localcontext(decimal.Context(prec=80)):
        patch_jax_compiles(mp)
        m = _namespace("spark_rapids_tpu")
        out = {"exec": {k: m.host.to_pydict(m.exec.execute_cpu(p))
                        for k, p in _exec_plans(m).items()}}
        out["marks"] = _jax_marks(m)
        out["cost"] = _cost_marks(m)
        out["shapes"] = _jax_shapes(m)
    return out


@pytest.fixture(scope="module")
def port_ns():
    return _namespace("spark_rapids_tpu_torch")


def _rows(d: dict):
    return [tuple(d[k][i] for k in d) for i in range(len(next(iter(
        d.values()))))]


def _same_rows(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert all(_same(a, b) for a, b in zip(g, w)), (i, g, w)


@pytest.mark.parametrize("node", list(_exec_plans(_namespace(
    "spark_rapids_tpu_torch"))))
def test_execute_cpu_matches_jax(node, port_ns, jax_side):
    got = port_ns.host.to_pydict(port_ns.exec.execute_cpu(
        _exec_plans(port_ns)[node]))
    want = jax_side["exec"][node]
    assert list(got) == list(want)
    _same_rows(_rows(got), _rows(want), node in ORDERED)


@pytest.mark.parametrize("node", list(_exec_plans(_namespace(
    "spark_rapids_tpu_torch"))))
def test_node_rebuilds_over_pruned_inputs(node, port_ns):
    """``with_children`` rebuilds each node over its children cut to the
    columns it reads (what a pruned DeviceToHost seam hands a CPU-engine
    node); its rows equal the whole node's on the columns both give."""
    plan = _exec_plans(port_ns)[node]
    reads = port_ns.ov._refs(plan)
    kids = []
    for c in plan.children:
        keep = [n for n, _ in c.schema if n in reads] or [c.schema[0][0]]
        kids.append(port_ns.L.Project(c, [port_ns.col(n) for n in keep]))
    rebuilt = plan.with_children(kids)
    assert type(rebuilt) is type(plan) and rebuilt.children == kids
    assert len(rebuilt.schema) < len(plan.schema) or node in (
        "project", "aggregate", "global_aggregate", "expand")
    got = port_ns.host.to_pydict(port_ns.exec.execute_cpu(rebuilt))
    want = port_ns.host.to_pydict(port_ns.exec.execute_cpu(plan))
    assert set(got) <= set(want)
    _same_rows(_rows(got), _rows({k: want[k] for k in got}),
               node in ORDERED)


# --- tagging: the port's marks against the JAX package's -------------------

def _mark_data():
    rng = np.random.default_rng(SEED + 2)
    n = 300
    full = _table_data(n, SEED + 2)
    return {"k": [int(x) for x in rng.integers(0, 6, n)], "i": full["i"],
            "f": full["f"], "s": full["s"], "d": full["d"],
            "a": full["n"], "c": full["w"]}


def _mark_schema(t):
    return [("k", t.INT64), ("i", t.INT32), ("f", t.FLOAT64),
            ("s", t.STRING), ("d", t.DATE), ("a", t.DecimalType(12, 2)),
            ("c", t.DecimalType(30, 4))]


#: plans whose marks equal the JAX package's
MARK_TEXTS = [
    "SELECT k, sum(f) AS x FROM t WHERE i > 0 GROUP BY k",
    "SELECT a + c AS x, a * a AS y FROM t",
    "SELECT x.k, y.f FROM t x JOIN t y ON x.k = y.i",
    "SELECT k, sum(i) OVER (PARTITION BY k ORDER BY i) AS w FROM t",
    "SELECT c, count(*) AS n FROM t GROUP BY c",
    "SELECT x.k FROM t x JOIN t y ON x.c = y.c",
    "SELECT sum(a) OVER (PARTITION BY c) AS w FROM t",
    "SELECT c div a AS x FROM t",
    "SELECT c % a AS x FROM t",
    "SELECT pmod(c, a) AS x FROM t",
    "SELECT CAST(c AS STRING) AS x FROM t",
    "SELECT CAST(s AS DECIMAL(30,2)) AS x FROM t",
    "SELECT k, stddev_samp(f) OVER (PARTITION BY k) AS w FROM t",
    "SELECT k, max(s) OVER (PARTITION BY k) AS w FROM t",
    "SELECT regexp_replace(s, '(a)', '$1$1') AS x FROM t",
    "SELECT s RLIKE 'a(?=b)' AS x FROM t",
]

#: where the port's device runs more than the JAX planner admits: text ->
#: why (the JAX planner marks the node ``!``, the port ``*``)
WIDER = {
    "SELECT greatest(s, 'b') AS x FROM t":
        "string greatest folds on the device",
    "SELECT s LIKE '_本%' AS x FROM t":
        "LIKE takes multi-byte literals on the device (C13)",
    "SELECT c FROM t ORDER BY c":
        "a DECIMAL(p>18) sorts on the device (two sort words a key)",
}

#: where the port tags a node the JAX planner leaves on its device:
#: text -> why
NARROWER = {
    "SELECT x.k FROM t x JOIN t y ON CAST(x.k AS DECIMAL(18,0)) = "
    "CAST(y.i AS DECIMAL(10,3))":
        "the keys' common type DECIMAL(21,3) is wide (C16): the port tags "
        "the coerced key, the JAX planner each side's own type",
}


def _marks(lines):
    return [line.strip()[0] + line.strip()[2:].split("[", 1)[0]
            for line in lines]


def _leafless(marks):
    """Marks without the leaf (LocalRelation in the JAX package,
    DeviceRelation in the port)."""
    return [mk for mk in marks if not mk[1:].endswith("Relation")]


def _jax_marks(m):
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    session = JSession(m.conf.SrtConf({"srt.shuffle.partitions": 1}))
    session.create_or_replace_temp_view("t", session.create_dataframe(
        _mark_data(), _mark_schema(m.dt)))
    return {text: _leafless(_marks(m.ov.tag_only(
        session.sql(text).plan, session.conf).explain_lines()))
        for text in [*MARK_TEXTS, *WIDER, *NARROWER]}


@pytest.fixture(scope="module")
def port_marks():
    from spark_rapids_tpu_torch.plan.overrides import tag_only
    session = TpuSession(SrtConf({}), device="cpu")
    session.create_or_replace_temp_view("t", session.create_dataframe(
        _mark_data(), _mark_schema(dt)))
    return {text: _leafless(_marks(tag_only(session.sql(text).plan,
                                            session.conf).explain_lines()))
            for text in [*MARK_TEXTS, *WIDER, *NARROWER]}


@pytest.mark.parametrize("text", MARK_TEXTS)
def test_marks_match_jax(text, port_marks, jax_side):
    assert port_marks[text] == jax_side["marks"][text]


@pytest.mark.parametrize("text", [*WIDER, *NARROWER])
def test_marks_differ_where_listed(text, port_marks, jax_side):
    """Each listed difference holds: the same nodes, one mark apart."""
    got, want = port_marks[text], jax_side["marks"][text]
    assert [m[1:] for m in got] == [m[1:] for m in want]
    flips = [(g[0], w[0]) for g, w in zip(got, want) if g != w]
    assert flips == ([("*", "!")] if text in WIDER else [("!", "*")]), \
        (got, want)


# --- the cost model against the JAX package's ------------------------------

def _cost_plans(m):
    """tests/test_cost_model.py's plans over in-memory relations: a tiny
    projection, a 200,000-row grouped aggregate, a ten-row projection."""
    L, c, lt = m.L, m.col, m.lit
    rng = np.random.default_rng(3)
    n = 200_000
    big = L.LocalRelation({"k": rng.integers(0, 100, n).tolist(),
                           "v": rng.uniform(0, 1, n).tolist()},
                          [("k", m.dt.INT64), ("v", m.dt.FLOAT64)])
    return {
        "tiny": L.Project(L.LocalRelation({"a": [1, 2, 3]},
                                          [("a", m.dt.INT64)]),
                          [m.Alias(c("a") + lt(1), "b")]),
        "big": L.Aggregate(big, [c("k")], [(m.Agg.Sum(c("v")), "s"),
                                           (m.Agg.CountStar(), "c")]),
        "ten": L.Project(L.LocalRelation({"a": list(range(10))},
                                         [("a", m.dt.INT64)]),
                         [m.Alias(c("a") + lt(1), "b")]),
    }


def _cost_marks(m):
    conf = m.conf.SrtConf({"srt.sql.optimizer.enabled": True})
    return {k: _marks(m.ov.tag_only(p, conf).explain_lines())
            for k, p in _cost_plans(m).items()}


@pytest.mark.parametrize("plan", ["tiny", "big", "ten"])
def test_cost_model_places_as_jax(plan, port_ns, jax_side):
    """``apply_cost_model`` puts each section where the JAX package's
    does; the tiny plan still runs, on the CPU engine."""
    from spark_rapids_tpu_torch.plan.overrides import tag_only
    conf = SrtConf({"srt.sql.optimizer.enabled": True})
    got = _marks(tag_only(_cost_plans(port_ns)[plan], conf).explain_lines())
    assert got == jax_side["cost"][plan]
    if plan == "tiny":
        session = TpuSession(conf, device="cpu")
        from spark_rapids_tpu_torch.plan.session import DataFrame
        rows = DataFrame(session, _cost_plans(port_ns)["tiny"]).collect()
        assert [r["b"] for r in rows] == [2, 3, 4]
        assert not isinstance(session._last_execution[0],
                              __import__("spark_rapids_tpu_torch.exec.base",
                                         fromlist=["TpuExec"]).TpuExec)


# --- the fallback phase's shapes (F1-F6 of chip_smoke.py) -------------------

SHAPE_ROWS = 60_000
#: F4's lineitem rows (the port's side alone: the JAX analyzer refuses
#: its keys): one month of orders joins two of lineitem, about one
#: lineitem row in 20,000
F4_ROWS = 200_000
MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "o_totalprice")
SHAPE_SESSIONS = {"f1": "float", "f2": "float", "f3": "decimal",
                  "f4": "f4", "f5": "nds"}


def _tpch(rows):
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.models import tpch
    return {s.name: generate_chunk(s, 0, s.num_rows)
            for s in tpch.tpch_table_specs(rows)}


def _shape_tables():
    """{session kind: {view: port host table}}: TPC-H at SHAPE_ROWS
    lineitem rows with float money and with DECIMAL(12,2) money (x 100,
    truncated toward zero, as chip_smoke.py's decimal phase makes it),
    and store_sales / item / date_dim at SHAPE_ROWS NDS rows."""
    from spark_rapids_tpu_torch.models.nds import register_nds
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    flt = _tpch(SHAPE_ROWS)
    money = dt.DecimalType(12, 2)
    dec = {n: HostTable([HostColumn((c.values * 100.0).astype(np.int64),
                                    c.mask, money) if name in MONEY else c
                         for name, c in zip(t.names, t.columns)], t.names)
           for n, t in flt.items()}
    host = {}
    register_nds(TpuSession(SrtConf({}), device="cpu"), SHAPE_ROWS,
                 host_tables=host)
    nds = {n: host[n] for n in ("store_sales", "item", "date_dim")}
    return {"float": flt, "decimal": dec, "nds": nds}


def _jtype(jdt, t):
    if dt.is_decimal(t):
        return jdt.DecimalType(t.precision, t.scale)
    return {x.sql_name: x for x in (jdt.BOOL, jdt.INT32, jdt.INT64,
                                    jdt.FLOAT64, jdt.STRING, jdt.DATE)
            }[t.sql_name]


def _jax_shapes(m):
    from spark_rapids_tpu.models import tpch as jtpch
    from spark_rapids_tpu.plan.session import TpuSession as JSession
    from spark_rapids_tpu_torch.models import fallback as FB
    sessions = {}
    for kind, tables in _shape_tables().items():
        s = sessions[kind] = JSession(m.conf.SrtConf(
            {"srt.shuffle.partitions": 1}))
        for name, t in tables.items():
            s.create_or_replace_temp_view(name, s.create_dataframe(
                to_pydict(t), [(n, _jtype(m.dt, c.dtype))
                               for n, c in zip(t.names, t.columns)]))
    out = {}
    for q, text in FB.QUERIES.items():
        if q == "f4":
            continue  # its keys' DECIMAL(21,3): the JAX analyzer refuses
        out[q] = sessions[SHAPE_SESSIONS[q]].sql(text).collect()
    with pytest.raises(TypeError, match="decimal promotion"):
        sessions["float"].sql(FB.F4).collect()
    li = sessions["float"].table("lineitem")
    out["f6_q6"] = jtpch.q6(li).collect()
    out["f6_q1"] = jtpch.q1(li).collect()
    return out


@pytest.fixture(scope="module")
def port_shapes():
    """The port's sessions over the same tables; F6's with
    srt.sql.enabled=false."""
    out = {}
    for kind, tables in (*_shape_tables().items(), ("f4", _tpch(F4_ROWS))):
        s = out[kind] = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4096}),
                                   device="cpu")
        for name, t in tables.items():
            s.create_or_replace_temp_view(name, s.create_dataframe(t))
    off = out["off"] = TpuSession(SrtConf({"srt.sql.batchSizeRows": 4096,
                                           "srt.sql.enabled": False}),
                                  device="cpu")
    off.create_or_replace_temp_view("lineitem", off.create_dataframe(
        _shape_tables()["float"]["lineitem"]))
    return out


def _shape_rows(rows):
    return [tuple(r.values()) for r in rows]


@pytest.mark.parametrize("q", ["f1", "f2", "f3", "f4", "f5"])
def test_fallback_shapes_match_jax(q, port_shapes, jax_side):
    """F1-F5 plan with exactly the CPU-engine nodes chip_smoke.py expects,
    run on a CPU session, and equal the JAX session's rows."""
    from spark_rapids_tpu_torch.models import fallback as FB
    session = port_shapes[SHAPE_SESSIONS[q]]
    df = session.sql(FB.QUERIES[q])
    assert FB.not_on_device(df.explain("NOT_ON_TPU").splitlines()) == \
        FB.CPU_NODES[q]
    got = df.collect()
    totals = session._last_execution[1].metric_totals()
    assert totals["transitionRows"] > 0 and totals["cpuTimeNs"] > 0
    # F4's keys meet at DECIMAL(21,3), which the JAX analyzer refuses
    # (C16): plain Python instead
    want = _python_f4(_tpch(F4_ROWS)) if q == "f4" else \
        jax_side["shapes"][q]
    assert got, q
    _same_rows(_shape_rows(got), _shape_rows(want), "ORDER BY" in
               FB.QUERIES[q])


def _python_f4(tables):
    """F4 in plain Python: January 1995's orders joined to the lineitems
    shipped in January and February 1995 on the order key's value, per
    priority the rows and their quantities' sum."""
    od = to_pydict(tables["orders"])
    li = to_pydict(tables["lineitem"])
    lo, hi = datetime.date(1995, 1, 1), datetime.date(1995, 2, 1)
    prio = {k: p for k, p, d in zip(od["o_orderkey"], od["o_orderpriority"],
                                    od["o_orderdate"])
            if d is not None and lo <= d < hi}
    out = {}
    for k, qty, d in zip(li["l_orderkey"], li["l_quantity"],
                         li["l_shipdate"]):
        if d is None or not lo <= d < datetime.date(1995, 3, 1) or \
                k not in prio:
            continue
        n, total = out.get(prio[k], (0, 0.0))
        out[prio[k]] = (n + 1, total + (qty or 0.0))
    return [{"o_orderpriority": p, "n": n, "qty": t}
            for p, (n, t) in sorted(out.items())]


@pytest.mark.parametrize("q", ["q6", "q1"])
def test_f6_sql_disabled_runs_on_the_cpu_engine(q, port_shapes, jax_side):
    """srt.sql.enabled=false: every node on the CPU engine, no device
    operator, the JAX package's rows."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.plan.transitions import CpuPhysical
    session = port_shapes["off"]
    df = getattr(tpch, q)(session.table("lineitem"))
    got = df.collect()
    physical = session._last_execution[0]

    def nodes(n):
        yield n
        for c in n.children:
            yield from nodes(c)
    assert all(isinstance(n, CpuPhysical) for n in nodes(physical))
    assert not any(isinstance(n, TpuExec) for n in nodes(physical))
    _same_rows(_shape_rows(got), _shape_rows(jax_side["shapes"][f"f6_{q}"]),
               True)


@pytest.mark.parametrize("q", ["q6", "q1", "q3"])
def test_tpch_with_sql_disabled_matches_the_device_path(q):
    """TPC-H q6 / q1 / q3 through the CPU engine alone equal the device
    path's rows."""
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.models import tpch
    tables = {s.name: generate_chunk(s, 0, s.num_rows)
              for s in tpch.tpch_table_specs(8000)}
    out = []
    for enabled in (True, False):
        s = TpuSession(SrtConf({"srt.sql.batchSizeRows": 2048,
                                "srt.sql.enabled": enabled}), device="cpu")
        dfs = {n: s.create_dataframe(t) for n, t in tables.items()}
        df = tpch.q3(dfs["customer"], dfs["orders"], dfs["lineitem"]) \
            if q == "q3" else getattr(tpch, q)(dfs["lineitem"])
        out.append(_shape_rows(df.collect()))
    _same_rows(out[1], out[0], True)


def test_earlier_queries_plan_on_the_device_alone():
    """Every query the device ran before the CPU engine existed still
    plans with no CPU-engine node: the 99 NDS texts and TPC-H q1 / q3 /
    q6."""
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models.nds import NDS_QUERIES, register_nds
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    from spark_rapids_tpu_torch.plan.transitions import CpuPhysical

    def cpu_nodes(n):
        return isinstance(n, CpuPhysical) or any(
            cpu_nodes(c) for c in getattr(n, "children", []))
    s = TpuSession(SrtConf({}), device="cpu")
    register_nds(s, 200)
    for q, text in NDS_QUERIES.items():
        assert not cpu_nodes(apply_overrides(s.sql(text).plan, s.conf)), q
    dfs = {sp.name: s.create_dataframe(generate_chunk(sp, 0, sp.num_rows))
           for sp in tpch.tpch_table_specs(400)}
    for df in (tpch.q6(dfs["lineitem"]), tpch.q1(dfs["lineitem"]),
               tpch.q3(dfs["customer"], dfs["orders"], dfs["lineitem"])):
        assert not cpu_nodes(apply_overrides(df.plan, s.conf))
