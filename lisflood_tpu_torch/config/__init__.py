from .settings import Settings, load_settings, parse_flags
from .options import DEFAULT_OPTIONS, REPORTED_MAPS, TIMESERIES, ReportedMap, TimeSeries
from .calendar import date_to_step, step_to_date, parse_date_or_step

__all__ = [
    "Settings", "load_settings", "parse_flags",
    "DEFAULT_OPTIONS", "REPORTED_MAPS", "TIMESERIES", "ReportedMap", "TimeSeries",
    "date_to_step", "step_to_date", "parse_date_or_step",
]
