"""The queries of ANSI mode's errors at scale (E2 of ``chip_smoke.py``'s
phase 5f) over TPC-H lineitem, for both packages' ``session.sql``.

Each case is an aggregate, so that its result is one row at any scale:
under ``srt.sql.ansi.enabled`` it raises the JAX package's exception
type with the JAX package's first message line (``tests/test_torch_ansi.py``
holds both against the JAX package); without ANSI it gives the null or
wrapped rows that a numpy reference computes. ``E2_GUARDED`` divides
only where its CASE selects a non-zero divisor and must not raise.
"""

from __future__ import annotations

#: lineitem's l_discount is one of 0.00 .. 0.10: about one row in 11 has
#: a zero divisor here
DIVISOR = "CAST(l_discount * 100 AS BIGINT)"

_ARITH = "SparkArithmeticException"
_CAST = "SparkCastOverflowException"

#: name -> (SQL, the exception's class name, its message's first line)
E2 = {
    # each row fits (l_partkey <= 200,000); the sum passes 2^63
    "sum_overflow": (
        "SELECT SUM(l_partkey * 1000000000000) AS v FROM lineitem",
        _ARITH, "long overflow"),
    # the row itself passes 2^63 where l_partkey > 92,233
    "row_overflow": (
        "SELECT SUM(l_partkey * 100000000000000) AS v FROM lineitem",
        _ARITH, "bigint overflow"),
    "divide_by_zero": (
        f"SELECT SUM(l_partkey % {DIVISOR}) AS v, "
        f"COUNT(l_partkey % {DIVISOR}) AS n FROM lineitem",
        _ARITH, "Division by zero. Use `try_divide` to tolerate divisor "
                "being 0 and return NULL instead."),
    "string_cast": (
        "SELECT SUM(CAST(l_returnflag AS INT)) AS v, "
        "COUNT(CAST(l_returnflag AS INT)) AS n FROM lineitem",
        "SparkNumberFormatException",
        "invalid input syntax for type int (ANSI mode cast)"),
    "int_cast": (
        "SELECT SUM(CAST(l_extendedprice * 100000 AS INT)) AS v "
        "FROM lineitem",
        _CAST, "casting double to int causes overflow (ANSI mode)"),
    # prices of 100,000.00 and up do not fit DECIMAL(7,2)
    "decimal_cast": (
        "SELECT SUM(CAST(l_extendedprice AS DECIMAL(7,2))) AS v, "
        "COUNT(CAST(l_extendedprice AS DECIMAL(7,2))) AS n FROM lineitem",
        _CAST, "cast to DecimalType(precision=7, scale=2) causes overflow "
               "(ANSI mode)"),
}

E2_GUARDED = (
    f"SELECT SUM(CASE WHEN {DIVISOR} <> 0 THEN l_partkey % {DIVISOR} END) "
    f"AS v, COUNT(CASE WHEN {DIVISOR} <> 0 THEN l_partkey % {DIVISOR} END) "
    "AS n FROM lineitem")
