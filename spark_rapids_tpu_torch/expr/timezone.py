"""Time zones: each zone's offsets as a transition table on the device.

Counterpart of spark_rapids_tpu/expr/timezone.py (``zone_transitions``,
``FromUTCTimestamp``, ``ToUTCTimestamp``; the Julian-calendar rebase of
the parquet / ORC readers is not here). A zone's UTC-offset history is
read from the system tz database (zoneinfo) once, into two sorted int64
arrays: the transition instants (UTC microseconds) and the offset in
force from each one. A conversion is then a ``torch.searchsorted`` and
an add per row. Transitions are found by probing the zone every 28 days
over 1800-2200 and bisecting each change to the second.

A fixed offset (``+05:30``, ``-08:00``, ``GMT+8``, ``UTC-3``; ``UTC``,
``GMT``, ``UT`` and ``Z`` alone are offset 0) needs no database. A name
that zoneinfo cannot resolve raises.

Semantics (Spark's DateTimeUtils):
- from_utc_timestamp(ts, tz): ts is UTC; the result is tz's wall clock,
  kept in the TIMESTAMP lane.
- to_utc_timestamp(ts, tz): ts is a wall clock in tz; the result is
  UTC. An ambiguous wall time (a fall-back hour) takes the earlier
  offset, a time in a spring-forward gap moves forward, as java.time.
"""

from __future__ import annotations

import datetime
import functools
import re
from typing import Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.vector import ColumnVector, ColumnarBatch
from .core import Expression, Schema, make_result

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
# most zones leave Local Mean Time in the 1880s: probe from 1800
_PROBE_START = datetime.datetime(1800, 1, 1, tzinfo=datetime.timezone.utc)
_PROBE_END = datetime.datetime(2200, 1, 1, tzinfo=datetime.timezone.utc)
_US = 1_000_000
_I64_MIN = np.iinfo(np.int64).min


def _offset_us(tz, instant_utc: datetime.datetime) -> int:
    return int(instant_utc.astimezone(tz).utcoffset().total_seconds()) * _US


def fixed_offset_us(name: str):
    """Microseconds of a fixed-offset zone id Spark accepts ('+05:30',
    '-08:00', 'GMT+8', 'UTC-3', 'UT+02:30'; 'UTC', 'GMT', 'UT', 'Z'),
    else None."""
    name = name.strip()
    if name in ("UTC", "GMT", "UT", "Z"):
        return 0
    m = re.fullmatch(r"(?:GMT|UTC|UT)?([+-])(\d{1,2})(?::(\d{2}))?", name)
    if not m:
        return None
    sign = 1 if m.group(1) == "+" else -1
    hours, mins = int(m.group(2)), int(m.group(3) or 0)
    if hours > 18 or mins > 59:
        return None
    return sign * (hours * 3600 + mins * 60) * _US


@functools.lru_cache(maxsize=None)
def zone_transitions(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_us, offsets_us): offsets[i] is in force for UTC
    instants in [transitions[i], transitions[i + 1]); transitions[0] is
    int64's minimum, carrying the zone's earliest offset."""
    fixed = fixed_offset_us(name)
    if fixed is not None:
        return (np.asarray([_I64_MIN], np.int64),
                np.asarray([fixed], np.int64))
    import zoneinfo
    tz = zoneinfo.ZoneInfo(name)
    probes = []
    t = _PROBE_START
    while t <= _PROBE_END:
        probes.append(t)
        t += datetime.timedelta(days=28)
    trans = [_I64_MIN]
    offs = [_offset_us(tz, _PROBE_START)]
    for a, b in zip(probes, probes[1:]):
        oa, ob = _offset_us(tz, a), _offset_us(tz, b)
        if oa == ob:
            continue
        lo, hi = a, b
        while (hi - lo).total_seconds() > 1:
            mid = lo + (hi - lo) / 2
            if _offset_us(tz, mid) == oa:
                lo = mid
            else:
                hi = mid
        instant = hi.replace(microsecond=0)
        if _offset_us(tz, instant) == oa:  # align to the whole second
            instant += datetime.timedelta(seconds=1)
        trans.append(int((instant - _EPOCH).total_seconds()) * _US)
        offs.append(ob)
    return np.asarray(trans, np.int64), np.asarray(offs, np.int64)


def offset_at(ts_us: torch.Tensor, trans: torch.Tensor,
              offs: torch.Tensor) -> torch.Tensor:
    """Per-row UTC offset (microseconds) at UTC instants ``ts_us``."""
    idx = torch.searchsorted(trans, ts_us, right=True) - 1
    return offs[idx.clamp(0, offs.shape[0] - 1)]


class _TzConvertBase(Expression):
    """children[0]: a timestamp column; the zone is a plan-time string
    (resolved when the expression is made, so an unknown zone raises
    then)."""

    def __init__(self, child: Expression, zone: str):
        super().__init__(child)
        self.zone = zone
        zone_transitions(zone)

    def data_type(self, schema: Schema) -> dt.DType:
        return dt.TIMESTAMP

    def _tables(self, device):
        trans, offs = zone_transitions(self.zone)
        return (torch.from_numpy(trans).to(device),
                torch.from_numpy(offs).to(device))

    def _micros(self, batch: ColumnarBatch):
        c = self.children[0].eval(batch)
        us = c.data.to(torch.int64)
        if c.dtype == dt.DATE:  # a date is its midnight in UTC
            us = us * 86_400_000_000
        return c, us

    def __repr__(self):
        return f"{type(self).__name__}({self.children[0]!r}, {self.zone!r})"


class FromUTCTimestamp(_TzConvertBase):
    """from_utc_timestamp(ts, zone)."""

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c, us = self._micros(batch)
        trans, offs = self._tables(us.device)
        return make_result(us + offset_at(us, trans, offs), c.validity,
                           dt.TIMESTAMP)


class ToUTCTimestamp(_TzConvertBase):
    """to_utc_timestamp(ts, zone): the offset guessed at the wall time
    read as UTC, then resolved again at the instant it gives (the
    earlier offset for an ambiguous wall time)."""

    def eval(self, batch: ColumnarBatch) -> ColumnVector:
        c, us = self._micros(batch)
        trans, offs = self._tables(us.device)
        o1 = offset_at(us, trans, offs)
        o2 = offset_at(us - o1, trans, offs)
        return make_result(us - o2, c.validity, dt.TIMESTAMP)
