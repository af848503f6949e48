"""Date <-> step arithmetic.

Re-implements the calendar utilities of the reference
(lisflood/global_modules/settings.py:700-790): settings values may be either
step numbers or day-first date strings; steps are counted from
CalendarDayStart with step length DtSec, 1-based.

Calendars: the reference supports any CF calendar through cftime. cftime is
not available in this environment; proleptic_gregorian / standard / gregorian
are handled natively with datetime (identical for dates after 1582, and
python's datetime is proleptic-Gregorian so pre-1582 and pre-1970 dates also
work, covering the reference's 1950s meteo test set).

The port's copy of lisflood_tpu/config/calendar.py. Date strings are parsed
with datetime alone (the JAX package calls pandas.to_datetime with
dayfirst=True), in the forms that LISFLOOD settings use: dd/mm/yyyy and
dd-mm-yyyy, each optionally followed by " HH:MM" or " HH:MM:SS", and ISO
yyyy-mm-dd[ HH:MM[:SS]] (year, month, day; pandas 3 with dayfirst=True reads
an ISO date whose day is at most 12 with day and month swapped).
"""
from __future__ import annotations

import datetime
import re

from ..utils.errors import LisfloodError

_SUPPORTED_CALENDARS = {
    "proleptic_gregorian",
    "gregorian",
    "standard",
    "",
    None,
}

# day first: dd/mm/yyyy or dd-mm-yyyy; ISO: yyyy-mm-dd; either with an
# optional " HH:MM[:SS]"
_TIME = r"(?:\s+(?P<H>\d{1,2}):(?P<M>\d{2})(?::(?P<S>\d{2}))?)?"
_DAY_FIRST = re.compile(r"(?P<d>\d{1,2})(?P<sep>[/-])(?P<m>\d{1,2})(?P=sep)(?P<y>\d{4})" + _TIME)
_ISO = re.compile(r"(?P<y>\d{4})-(?P<m>\d{1,2})-(?P<d>\d{1,2})" + _TIME)


def _parse_date(text):
    """A settings date string -> datetime; ValueError for any other form or
    a date that does not exist."""
    text = text.strip()
    m = _DAY_FIRST.fullmatch(text) or _ISO.fullmatch(text)
    if m is None:
        raise ValueError(f"not a date: {text!r}")
    g = m.groupdict()
    return datetime.datetime(int(g["y"]), int(g["m"]), int(g["d"]), int(g["H"] or 0),
                             int(g["M"] or 0), int(g["S"] or 0))


def parse_date_or_step(value, calendar_type="proleptic_gregorian"):
    """Parse a settings value: a number is a step count (float), otherwise a
    day-first date string -> datetime (reference settings.py:700-725)."""
    try:
        return float(value)
    except (ValueError, TypeError):
        pass
    if calendar_type not in _SUPPORTED_CALENDARS:
        # Non-real-world calendars (360_day, 365_day) would need a custom date
        # type; none of the reference test data uses them.
        raise LisfloodError(
            f"Calendar {calendar_type!r} not supported (only real-world calendars)"
        )
    try:
        return _parse_date(value)
    except (ValueError, TypeError, AttributeError):
        raise LisfloodError(
            f"Wrong step or date format in settings: {value!r}"
        )


def date_to_step(value, calendar_day_start, dt_sec, calendar_type="proleptic_gregorian"):
    """Number of DtSec steps from CalendarDayStart to `value`, 1-based
    (reference settings.py:728-763). Returns (int_step, display_string)."""
    parsed = parse_date_or_step(value, calendar_type)
    begin = parse_date_or_step(calendar_day_start, calendar_type)
    if isinstance(parsed, datetime.datetime):
        seconds = int((parsed - begin).total_seconds())
        step = int(seconds / float(dt_sec) + 1)
        return step, parsed.strftime("%d/%m/%Y %H:%M")
    return int(parsed), str(parsed)


def step_to_date(step, ref_date, dt_sec):
    """Date corresponding to `step` steps after `ref_date`
    (reference settings.py:766-790)."""
    dt_day = float(dt_sec) / 86400.0
    return ref_date + datetime.timedelta(days=step * dt_day)
