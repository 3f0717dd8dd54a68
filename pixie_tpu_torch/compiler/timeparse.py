"""Time expression resolution (reference planner/compiler/analyzer time
resolution rules + src/carnot/planner/ir/time.cc).

PxL accepts start_time/end_time as:
  * relative strings: "-5m", "-1h30m", "-30s", "10d" (negative = before now)
  * absolute ints (ns since epoch)
  * datetime objects
All are resolved at compile time against a fixed `now_ns` captured once per
compilation, so every time reference in one query sees the same "now".
Copied from the reference package (pixie_tpu/compiler/timeparse.py).
"""
from __future__ import annotations

import datetime
import re
import time

NS = 1
US = 1_000
MS = 1_000_000
SECOND = 1_000_000_000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE
DAY = 24 * HOUR

_UNITS = {
    "d": DAY,
    "h": HOUR,
    "m": MINUTE,
    "s": SECOND,
    "ms": MS,
    "us": US,
    "ns": NS,
}

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(d|h|ms|us|ns|m|s)")


def parse_duration_ns(s: str) -> int:
    """'1h30m' → ns. Sign prefix allowed."""
    s = s.strip()
    neg = s.startswith("-")
    if s and s[0] in "+-":
        s = s[1:]
    pos = 0
    total = 0.0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"bad duration {s!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"bad duration {s!r}")
    return -int(total) if neg else int(total)


def now_ns() -> int:
    return time.time_ns()


def resolve_time(value, now: int) -> int:
    """Resolve a PxL time argument to absolute ns since epoch."""
    if value is None:
        raise ValueError("time value is None")
    if isinstance(value, bool):
        raise ValueError("boolean is not a time")
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return int(value)
    if isinstance(value, datetime.datetime):
        return _datetime_ns(value)
    if isinstance(value, str):
        # Relative durations resolve against now; absolute ISO strings parse.
        try:
            return now + parse_duration_ns(value)
        except ValueError:
            pass
        try:
            dt = datetime.datetime.fromisoformat(value)
        except ValueError:
            raise ValueError(f"cannot parse time {value!r}") from None
        return _datetime_ns(dt)
    raise ValueError(f"cannot parse time {value!r}")


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _datetime_ns(dt: datetime.datetime) -> int:
    """Exact ns since epoch.  float timestamp() has only ~us precision at
    current epochs, which nondeterministically shifts boundary rows; timedelta
    arithmetic is exact at datetime's native microsecond resolution."""
    delta = _as_utc(dt) - _EPOCH
    return (delta.days * 86400 + delta.seconds) * SECOND + delta.microseconds * 1000


def _as_utc(dt: datetime.datetime) -> datetime.datetime:
    """Naive datetimes are UTC by convention (queries must resolve identically
    regardless of the compiling host's timezone)."""
    if dt.tzinfo is None:
        return dt.replace(tzinfo=datetime.timezone.utc)
    return dt
