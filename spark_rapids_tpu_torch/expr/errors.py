"""ANSI-mode error types (spark.sql.ansi.enabled semantics).

Copy of spark_rapids_tpu/expr/errors.py. Mirrors the reference's error
surface: Spark raises
SparkArithmeticException ("long overflow", "Division by zero",
"Casting ... causes overflow") and SparkNumberFormatException (invalid
string casts) when ANSI mode is on — the GPU plugin reproduces the
same classes from device-side checks (GpuCast.scala:212-252 ansiMode,
GpuOverrides.scala:1113-1122 overflow checks). Both this engine's
device lane AND the CPU oracle raise THESE types so the differential
harness can assert error equality (the reference's
assert_gpu_and_cpu_error pattern, integration_tests/.../asserts.py:644).
"""

from __future__ import annotations


class SparkArithmeticException(ArithmeticError):
    """Arithmetic overflow / division by zero under ANSI mode."""


class SparkCastOverflowException(SparkArithmeticException):
    """Numeric cast target cannot represent the value under ANSI."""


class SparkNumberFormatException(ValueError):
    """Invalid string -> number/date cast under ANSI mode."""


class SparkDateTimeException(ValueError):
    """Invalid string -> date/timestamp cast under ANSI mode."""


def overflow_message(type_name: str) -> str:
    return f"{type_name} overflow"


DIVIDE_BY_ZERO = ("Division by zero. Use `try_divide` to tolerate "
                  "divisor being 0 and return NULL instead.")
