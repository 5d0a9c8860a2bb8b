"""Date and time expressions.

Counterpart of spark_rapids_tpu/expr/datetime.py. A DATE is int32 days
and a TIMESTAMP int64 microseconds since the epoch in UTC; a field of a
timestamp is read in UTC here (the analyzer wraps a timestamp argument
in ``FromUTCTimestamp`` for a session zone other than UTC). Calendar
arithmetic is Hinnant's civil-date algorithms in integer torch ops
(floor division throughout, so days before the epoch need no
correction).
"""

from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result, merged_validity

MICROS_PER_DAY = 86_400_000_000


def civil_from_days(z: torch.Tensor):
    """int64 days since the epoch -> (year, month, day), proleptic
    Gregorian."""
    z = z + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) int64 -> days since the epoch."""
    y = torch.where(m <= 2, y - 1, y)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def to_days(c: ColumnVector) -> torch.Tensor:
    """int64 days of a DATE or TIMESTAMP column (a timestamp's day in
    UTC)."""
    if c.dtype == dt.TIMESTAMP:
        return c.data // MICROS_PER_DAY
    return c.data.to(torch.int64)


class _DateField(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        days = to_days(c)
        return make_result(self._pick(days).to(torch.int32), c.validity,
                           dt.INT32)

    def _pick(self, days):
        raise NotImplementedError


class Year(_DateField):
    def _pick(self, days):
        return civil_from_days(days)[0]


class Month(_DateField):
    def _pick(self, days):
        return civil_from_days(days)[1]


class DayOfMonth(_DateField):
    def _pick(self, days):
        return civil_from_days(days)[2]


class Quarter(_DateField):
    def _pick(self, days):
        return (civil_from_days(days)[1] - 1) // 3 + 1


class DayOfWeek(_DateField):
    """1 = Sunday ... 7 = Saturday (1970-01-01 was a Thursday)."""

    def _pick(self, days):
        return (days + 4) % 7 + 1


class WeekDay(_DateField):
    """0 = Monday ... 6 = Sunday."""

    def _pick(self, days):
        return (days + 3) % 7


class DayOfYear(_DateField):
    def _pick(self, days):
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


def _last_of_month(y, m):
    """Days of the last day of month (y, m)."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    return days_from_civil(ny, nm, torch.ones_like(nm)) - 1


class LastDay(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.DATE

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        y, m, _ = civil_from_days(to_days(c))
        return make_result(_last_of_month(y, m).to(torch.int32), c.validity,
                           dt.DATE)


class _TimeField(Expression):
    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        if c.dtype == dt.DATE:  # a date is midnight
            sec = torch.zeros_like(c.data, dtype=torch.int64)
        else:
            sec = (c.data % MICROS_PER_DAY) // 1_000_000
        return make_result(self._pick(sec).to(torch.int32), c.validity,
                           dt.INT32)

    def _pick(self, s):
        raise NotImplementedError


class Hour(_TimeField):
    def _pick(self, s):
        return s // 3600


class Minute(_TimeField):
    def _pick(self, s):
        return (s % 3600) // 60


class Second(_TimeField):
    def _pick(self, s):
        return s % 60


class _DateShift(Expression):
    sign = 1

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.DATE

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        data = to_days(a) + self.sign * b.data.to(torch.int64)
        return make_result(data.to(torch.int32), merged_validity(a, b),
                           dt.DATE)


class DateAdd(_DateShift):
    """date_add(d, n): n days later (a timestamp's UTC day)."""

    sign = 1


class DateSub(_DateShift):
    sign = -1


class DateDiff(Expression):
    """datediff(end, start): days from start to end."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT32

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        b = self.children[1].eval(batch)
        return make_result((to_days(a) - to_days(b)).to(torch.int32),
                           merged_validity(a, b), dt.INT32)


class AddMonths(Expression):
    """add_months(d, n): the same day n months later, clamped to the
    target month's last day (Spark 3: 2019-01-31 + 1 is 2019-02-28, and
    a month's last day is not kept as such)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.DATE

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        a = self.children[0].eval(batch)
        n = self.children[1].eval(batch)
        y, m, d = civil_from_days(to_days(a))
        months = y * 12 + (m - 1) + n.data.to(torch.int64)
        ny, nm = months // 12, months % 12 + 1
        last_d = civil_from_days(_last_of_month(ny, nm))[2]
        data = days_from_civil(ny, nm, torch.minimum(d, last_d))
        return make_result(data.to(torch.int32), merged_validity(a, n),
                           dt.DATE)


_TRUNC_FORMATS = {"year": "year", "yyyy": "year", "yy": "year",
                  "month": "month", "mon": "month", "mm": "month",
                  "quarter": "quarter", "week": "week"}


class TruncDate(Expression):
    """trunc(date, fmt) for fmt in year / yyyy / yy, month / mon / mm,
    quarter and week (to its Monday). An unknown format raises when the
    expression is made (Spark gives NULL for every row)."""

    def __init__(self, child: Expression, fmt: str):
        super().__init__(child)
        if fmt.lower() not in _TRUNC_FORMATS:
            raise TypeError(f"trunc format {fmt!r} is not supported")
        self.fmt = _TRUNC_FORMATS[fmt.lower()]

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.DATE

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        days = to_days(c)
        y, m, _ = civil_from_days(days)
        one = torch.ones_like(m)
        if self.fmt == "year":
            out = days_from_civil(y, one, one)
        elif self.fmt == "month":
            out = days_from_civil(y, m, one)
        elif self.fmt == "quarter":
            out = days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        else:
            out = days - (days + 3) % 7
        return make_result(out.to(torch.int32), c.validity, dt.DATE)

    def __repr__(self):
        return f"TruncDate({self.children[0]!r}, {self.fmt!r})"


class UnixTimestampToSeconds(Expression):
    """unix_timestamp(ts): seconds since the epoch (a date: its
    midnight in UTC)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.INT64

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        data = c.data.to(torch.int64) * 86_400 if c.dtype == dt.DATE \
            else c.data // 1_000_000
        return make_result(data, c.validity, dt.INT64)


class FromUnixTime(Expression):
    """Seconds since the epoch -> a timestamp (the JAX package's
    ``from_unixtime``, which keeps the timestamp rather than formatting
    it)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.TIMESTAMP

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c = self.children[0].eval(batch)
        return make_result(c.data.to(torch.int64) * 1_000_000, c.validity,
                           dt.TIMESTAMP)


class MakeDate(Expression):
    """make_date(y, m, d); null where there is no such day, as in Spark
    (the JAX package rolls 2019-02-30 over to 2019-03-02; ROADMAP.md
    C13)."""

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.DATE

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        y, m, d = (c.eval(batch) for c in self.children)
        validity = merged_validity(y, m, d)
        yy, mm, dd = (c.data.to(torch.int64) for c in (y, m, d))
        ok = (mm >= 1) & (mm <= 12) & (dd >= 1)
        mm = torch.where(ok, mm, 1)
        last = civil_from_days(_last_of_month(yy, mm))[2]
        ok = ok & (dd <= last)
        days = days_from_civil(yy, mm, torch.where(ok, dd, 1))
        return make_result(days.to(torch.int32), validity & ok, dt.DATE)
