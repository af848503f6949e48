"""XML settings parser.

LISFLOOD-compatible settings: one XML file with three sections
(reference lisflood/global_modules/settings.py:349-680):

- ``<lfuser>``    user variables and path macros, substituted into bindings
                  via ``$(name)`` placeholders;
- ``<lfbinding>`` the ~1,400 binding keys (file paths / scalar parameters);
- ``<lfoptions>`` ``<setoption choice= name=>`` booleans merged over the
                  default option registry.

Unlike the reference there are no process-global singletons: a ``Settings``
object is an explicit value passed to the model builder, which keeps the
framework usable from multiple threads / ensembles without the reference's
ThreadSingleton machinery (settings.py:85-122).

The port's copy of lisflood_tpu/config/settings.py.
"""
from __future__ import annotations

import datetime
import os
import warnings
import xml.dom.minidom
from dataclasses import dataclass, field

from .calendar import date_to_step, parse_date_or_step, step_to_date
from .options import REPORTED_MAPS, TIMESERIES, default_options
from ..utils.errors import LisfloodError


def _substitute(expr: str, user: dict) -> str:
    """Expand $(var) placeholders using lfuser variables
    (reference settings.py:548-559)."""
    while "$(" in expr:
        a1 = expr.find("$(")
        a2 = expr.find(")", a1)
        key = expr[a1 + 2 : a2]
        if key not in user:
            # Reference is lenient here (settings.py:553-557 prints a warning
            # and moves on); such bindings are never consumed in practice.
            # Leave the placeholder intact so a later consumer fails loudly.
            warnings.warn(f"no lfuser variable {key!r} for expression {expr!r}")
            return expr
        expr = expr[:a1] + user[key] + expr[a2 + 1 :]
    return expr


def _parse_report_steps(spec: str, step_start: int, step_end: int):
    """Parse the ReportSteps mini-DSL: value, comma list, 'a..b' ranges and
    'a+s..b' strided ranges; 'starttime'/'endtime' aliases
    (reference settings.py:566-593)."""
    spec = str(spec).replace("starttime", str(step_start)).replace("endtime", str(step_end))
    values = []
    for part in spec.split(","):
        part = part.strip()
        if ".." in part:
            lo, hi = part.split("..")
            if "+" in lo:
                start, stride = (int(x) for x in lo.split("+"))
                values.extend(range(start, int(hi) + 1, stride))
            else:
                values.extend(range(int(lo), int(hi) + 1))
        elif part:
            values.append(int(part))
    return values


_FLAG_NAMES = (
    ("q", "quiet"),
    ("v", "veryquiet"),
    ("l", "loud"),
    ("c", "checkfiles"),
    ("h", "noheader"),
    ("t", "printtime"),
    ("d", "debug"),
    ("n", "nancheck"),
    ("i", "initonly"),
    ("s", "skipvalreplace"),
)


def parse_flags(sys_args):
    """CLI short/long flags (reference settings.py:501-527)."""
    flags = {long: False for _, long in _FLAG_NAMES}
    short_map = {f"-{s}": long for s, long in _FLAG_NAMES}
    long_map = {f"--{long}": long for _, long in _FLAG_NAMES}
    for arg in sys_args or ():
        if arg in short_map:
            flags[short_map[arg]] = True
        elif arg in long_map:
            flags[long_map[arg]] = True
    return flags


@dataclass
class Settings:
    """Parsed settings: bindings, options, model/report steps, flags."""

    settings_path: str
    binding: dict
    options: dict
    user: dict
    flags: dict = field(default_factory=dict)
    report_steps: list = field(default_factory=list)
    report_timeseries: dict = field(default_factory=dict)
    report_maps_steps: dict = field(default_factory=dict)
    report_maps_all: dict = field(default_factory=dict)
    report_maps_end: dict = field(default_factory=dict)
    step_start_int: int = 1
    step_end_int: int = 1
    step_start_dt: datetime.datetime | None = None
    step_end_dt: datetime.datetime | None = None
    filter_steps: list = field(default_factory=list)
    ens_members: int = 1
    ncores: int = 1

    @property
    def output_dir(self):
        return self.user["PathOut"] if "PathOut" in self.user else self.binding["PathOut"]

    @property
    def maskpath(self):
        return self.binding["MaskMap"]

    @property
    def timestep_init(self):
        return self.binding.get("timestepInit") or None

    @property
    def settings_dir(self):
        return os.path.dirname(self.settings_path)

    def for_subdir(self, name):
        """Settings clone whose output paths land in <output_dir>/<name>/ —
        the per-sample directories of the reference MonteCarloFramework
        (each sample reports its maps/TSS into PathOut/<sample>/;
        reference main.py:98-115, Lisflood_monteCarlo.py:24-44)."""
        import copy

        out = os.path.normpath(self.output_dir)
        sub = os.path.join(out, str(name))
        new = copy.copy(self)
        new.binding = dict(self.binding)
        new.user = dict(self.user)
        for k, v in self.binding.items():
            if isinstance(v, str):
                vn = os.path.normpath(v)
                if vn == out or vn.startswith(out + os.sep):
                    new.binding[k] = os.path.join(sub, os.path.relpath(vn, out)) \
                        if vn != out else sub
        if "PathOut" in new.user:
            new.user["PathOut"] = sub
        return new


def load_settings(settings_file, sys_args=(), opts_to_set=(), opts_to_unset=(), vars_to_set=None) -> Settings:
    """Parse a LISFLOOD XML settings file into a Settings value.

    opts_to_set / opts_to_unset / vars_to_set allow programmatic overrides
    (the reference's tests rewrite the XML on the fly via BeautifulSoup,
    tests/test_utils.py:16-58; we support the same semantics directly).
    """
    settings_file = os.path.abspath(settings_file)
    dom = xml.dom.minidom.parse(settings_file)
    settings_dir = os.path.normpath(os.path.dirname(settings_file))
    vars_to_set = dict(vars_to_set or {})

    # lfuser variables, with built-in path macros
    user = {
        "ProjectDir": settings_dir,
        "ProjectPath": settings_dir,
        "SettingsDir": settings_dir,
        "SettingsPath": settings_dir,
    }
    for node in dom.getElementsByTagName("lfuser")[0].getElementsByTagName("textvar"):
        name = node.attributes["name"].value
        user[name] = vars_to_set.get(name, str(node.attributes["value"].value))

    # lfbinding keys with $(var) substitution
    binding = {}
    for node in dom.getElementsByTagName("lfbinding")[0].getElementsByTagName("textvar"):
        name = node.attributes["name"].value
        raw = vars_to_set.get(name, str(node.attributes["value"].value))
        binding[name] = _substitute(raw, user)
    binding["calendar_type"] = binding.get("CalendarConvention", "proleptic_gregorian")
    # programmatic overrides for keys the template does not declare
    # (e.g. AsyncOutput, RoutingKernel): visible via binding like any
    # declared key
    for name, raw in vars_to_set.items():
        if name not in binding:
            binding[name] = _substitute(str(raw), user)

    # lfoptions over defaults
    options = default_options()
    for node in dom.getElementsByTagName("lfoptions")[0].getElementsByTagName("setoption"):
        options[node.attributes["name"].value.strip()] = bool(int(node.attributes["choice"].value))
    for opt in opts_to_set:
        options[opt] = True
    for opt in opts_to_unset:
        options[opt] = False
    options["nonInit"] = not options["InitLisflood"]

    # simulation window
    cal_start = binding["CalendarDayStart"]
    dt_sec = float(binding["DtSec"])
    cal_type = binding["calendar_type"]
    int_start, str_start = date_to_step(binding["StepStart"], cal_start, dt_sec, cal_type)
    int_end, str_end = date_to_step(binding["StepEnd"], cal_start, dt_sec, cal_type)
    if int_start < 0 or int_end < 0 or int_end < int_start:
        raise LisfloodError(
            f"Simulation dates do not match CalendarDayStart: start {str_start} ({int_start}), end {str_end} ({int_end})"
        )
    binding["StepStartInt"] = int_start
    binding["StepEndInt"] = int_end
    ref_date = parse_date_or_step(cal_start, cal_type)
    step_start_dt = step_to_date(int_start - 1, ref_date, dt_sec)
    step_end_dt = step_to_date(int_end - 1, ref_date, dt_sec)

    report_steps = _parse_report_steps(user.get("ReportSteps", "1..9999"), int_start, int_end)

    settings = Settings(
        settings_path=settings_file,
        binding=binding,
        options=options,
        user=user,
        flags=parse_flags(sys_args),
        report_steps=report_steps,
        step_start_int=int_start,
        step_end_int=int_end,
        step_start_dt=step_start_dt,
        step_end_dt=step_end_dt,
        ens_members=int(user.get("EnsMembers", 1) or 1),
        ncores=int(user.get("nrCores", 1) or 1),
    )
    _build_report_dicts(settings)
    _parse_filter_steps(settings, user)
    return settings


def _active(options, report_options, restricted_options):
    """A report entry is active when at least one repoption is on and, if it
    has restrictoptions, all of them are on (reference settings.py:666-680)."""
    allow = any(options.get(o) for o in report_options)
    if allow and restricted_options:
        allow = all(options.get(o) for o in restricted_options)
    return allow


def _build_report_dicts(settings: Settings):
    opts = settings.options
    settings.report_timeseries = {
        name: ts for name, ts in TIMESERIES.items() if _active(opts, ts.repoption, ts.restrictoption)
    }
    settings.report_maps_steps = {
        name: rm for name, rm in REPORTED_MAPS.items() if _active(opts, rm.steps, rm.restrictoption)
    }
    settings.report_maps_all = {
        name: rm for name, rm in REPORTED_MAPS.items() if _active(opts, rm.all, rm.restrictoption)
    }
    settings.report_maps_end = {
        name: rm for name, rm in REPORTED_MAPS.items() if _active(opts, rm.end, rm.restrictoption)
    }


def _parse_filter_steps(settings: Settings, user):
    """EnKF filter steps (reference settings.py:609-636)."""
    raw = user.get("FilterSteps")
    if not raw:
        settings.filter_steps = []
        return
    parts = [p.strip() for p in str(raw).split(",")]
    if parts and parts[-1] in ("endtime", settings.binding.get("StepEnd")):
        parts[-1] = "0"
    res = []
    for part in parts:
        try:
            val = int(part)
        except ValueError:
            delta = parse_date_or_step(part, settings.binding["calendar_type"]) - parse_date_or_step(
                settings.binding["CalendarDayStart"], settings.binding["calendar_type"]
            )
            val = delta.days
        if val < settings.binding["StepEndInt"]:
            res.append(val)
    settings.filter_steps = res
