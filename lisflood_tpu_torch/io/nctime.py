"""CF time-coordinate encoding/decoding (replaces netCDF4.num2date/date2num).

Supports the real-world calendars (proleptic_gregorian / gregorian /
standard) and the fixed-length CF model calendars (360_day,
noleap/365_day, all_leap/366_day) with units
"<seconds|minutes|hours|days> since <datetime>" — the same set the
reference reaches through netCDF4/cftime (settings.py:700-790). The
fixed-length calendars use a small pure-Python day-count (no cftime
dependency); dates that have no real-calendar equivalent (e.g. Feb 30 in
360_day) decode to a CFDateTime value that carries the same fields.

The port's copy of lisflood_tpu/io/nctime.py.
"""
from __future__ import annotations

import datetime
import re
from dataclasses import dataclass

from ..utils.errors import LisfloodError

_UNIT_SECONDS = {
    "second": 1.0,
    "seconds": 1.0,
    "sec": 1.0,
    "secs": 1.0,
    "minute": 60.0,
    "minutes": 60.0,
    "min": 60.0,
    "mins": 60.0,
    "hour": 3600.0,
    "hours": 3600.0,
    "hr": 3600.0,
    "hrs": 3600.0,
    "h": 3600.0,
    "day": 86400.0,
    "days": 86400.0,
    "d": 86400.0,
}

_REAL_CALENDARS = {"proleptic_gregorian", "gregorian", "standard", "", None}
_MONTH_DAYS_365 = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
_MONTH_DAYS_366 = (31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)

_SINCE_RE = re.compile(
    r"^\s*(?P<unit>\w+)\s+since\s+(?P<date>[\d-]+)(?:[ T](?P<time>[\d:.]+))?", re.IGNORECASE
)


@dataclass(frozen=True)
class CFDateTime:
    """A date in a fixed-length CF calendar that has no real-calendar
    datetime equivalent (e.g. 30 February in 360_day). Carries the same
    field names as datetime so calendar-agnostic consumers can read it;
    it never compares equal to a real datetime, which is the correct
    matching semantics for a model running a real calendar."""

    year: int
    month: int
    day: int
    hour: int = 0
    minute: int = 0
    second: int = 0
    microsecond: int = 0

    def strftime(self, fmt):
        return (fmt.replace("%Y", f"{self.year:04d}").replace("%m", f"{self.month:02d}")
                .replace("%d", f"{self.day:02d}").replace("%H", f"{self.hour:02d}")
                .replace("%M", f"{self.minute:02d}").replace("%S", f"{self.second:02d}"))


def parse_time_units(units: str):
    """Parse CF units string -> (seconds_per_unit, epoch datetime)."""
    if isinstance(units, bytes):
        units = units.decode()
    m = _SINCE_RE.match(units)
    if not m:
        raise LisfloodError(f"Cannot parse time units {units!r}")
    unit = m.group("unit").lower()
    if unit not in _UNIT_SECONDS:
        raise LisfloodError(f"Unsupported time unit {unit!r} in {units!r}")
    date_part = m.group("date")
    ymd = [int(x) for x in date_part.split("-")]
    hms = [0, 0, 0]
    micro = 0
    if m.group("time"):
        bits = m.group("time").split(":")
        for i, b in enumerate(bits[:3]):
            if "." in b:
                sec, frac = b.split(".")
                hms[i] = int(sec)
                micro = int(round(float("0." + frac) * 1e6)) if frac else 0
            else:
                hms[i] = int(b)
    epoch = (ymd[0], ymd[1], ymd[2], hms[0], hms[1], hms[2], micro)
    return _UNIT_SECONDS[unit], epoch


def _calendar_kind(calendar):
    if isinstance(calendar, bytes):
        calendar = calendar.decode()
    if calendar in _REAL_CALENDARS:
        return "real"
    c = str(calendar).lower()
    if c in _REAL_CALENDARS:
        return "real"
    if c == "360_day":
        return "360"
    if c in ("noleap", "365_day"):
        return "365"
    if c in ("all_leap", "366_day"):
        return "366"
    raise LisfloodError(f"Calendar {calendar!r} not supported")


def check_calendar(calendar):
    _calendar_kind(calendar)


def _fixed_month_days(kind):
    return _MONTH_DAYS_365 if kind == "365" else _MONTH_DAYS_366


def _abs_days(kind, year, month, day):
    """Day count from year 0 in a fixed-length calendar."""
    if kind == "360":
        return year * 360 + (month - 1) * 30 + (day - 1)
    md = _fixed_month_days(kind)
    ylen = sum(md)
    return year * ylen + sum(md[: month - 1]) + (day - 1)


def _from_abs_days(kind, days):
    if kind == "360":
        year, rem = divmod(days, 360)
        month, day = divmod(rem, 30)
        return int(year), int(month) + 1, int(day) + 1
    md = _fixed_month_days(kind)
    ylen = sum(md)
    year, rem = divmod(days, ylen)
    month = 0
    while rem >= md[month]:
        rem -= md[month]
        month += 1
    return int(year), month + 1, int(rem) + 1


def num_to_date(value, units, calendar="proleptic_gregorian"):
    """Numeric time value -> datetime (or CFDateTime when the decoded
    fixed-calendar date does not exist in the real calendar)."""
    kind = _calendar_kind(calendar)
    spu, epoch = parse_time_units(units)
    y, mo, d, h, mi, s, us = epoch
    if kind == "real":
        epoch_dt = datetime.datetime(y, mo, d, h, mi, s, us)
        return epoch_dt + datetime.timedelta(seconds=float(value) * spu)
    total_us = (
        _abs_days(kind, y, mo, d) * 86400_000_000
        + (h * 3600 + mi * 60 + s) * 1_000_000 + us
        + int(round(float(value) * spu * 1_000_000)))
    days, rem_us = divmod(total_us, 86400_000_000)
    yy, mm, dd = _from_abs_days(kind, days)
    rem_s, us2 = divmod(rem_us, 1_000_000)
    hh, rem = divmod(rem_s, 3600)
    mi2, ss = divmod(rem, 60)
    try:
        return datetime.datetime(yy, mm, dd, int(hh), int(mi2), int(ss), int(us2))
    except ValueError:
        return CFDateTime(yy, mm, dd, int(hh), int(mi2), int(ss), int(us2))


def date_to_num(date, units, calendar="proleptic_gregorian"):
    """datetime (or CFDateTime) -> numeric time value in `units`."""
    kind = _calendar_kind(calendar)
    spu, epoch = parse_time_units(units)
    y, mo, d, h, mi, s, us = epoch
    if kind == "real":
        epoch_dt = datetime.datetime(y, mo, d, h, mi, s, us)
        return (date - epoch_dt).total_seconds() / spu
    day_delta = _abs_days(kind, date.year, date.month, date.day) - _abs_days(kind, y, mo, d)
    sec_delta = ((date.hour - h) * 3600 + (date.minute - mi) * 60
                 + (date.second - s) + (date.microsecond - us) / 1e6)
    return (day_delta * 86400.0 + sec_delta) / spu
