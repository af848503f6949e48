"""Declarative option / reported-output registry.

The registry contents (option defaults, 225 ReportedMap and 86 TimeSeries
declarations) are LISFLOOD configuration data shared with the reference
(lisflood/global_modules/default_options.py:1-1490); they are stored in
registry.json (extracted as data, see scripts/extract_registry.py) and loaded
into lightweight dataclasses here.

The port's copy of lisflood_tpu/config/options.py.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

_REGISTRY_PATH = os.path.join(os.path.dirname(__file__), "registry.json")


@dataclass(frozen=True)
class ReportedMap:
    """A map output declaration: which model attribute to write, under which
    binding key, and which rep* options trigger end/steps/all reporting."""

    name: str
    output_var: str
    unit: str
    end: tuple = ()
    steps: tuple = ()
    all: tuple = ()
    restrictoption: tuple = ()
    monthly: bool = False
    yearly: bool = False


@dataclass(frozen=True)
class TimeSeries:
    """A gauge time-series declaration (sampling location set + operation)."""

    name: str
    output_var: str
    where: str
    repoption: tuple = ()
    restrictoption: tuple = ()
    operation: tuple = field(default_factory=tuple)


def _load_registry():
    with open(_REGISTRY_PATH) as f:
        raw = json.load(f)
    options = dict(raw["options"])
    reported_maps = {
        k: ReportedMap(
            name=k,
            output_var=v["output_var"],
            unit=v["unit"],
            end=tuple(v["end"]),
            steps=tuple(v["steps"]),
            all=tuple(v["all"]),
            restrictoption=tuple(v["restrictoption"]),
            monthly=v["monthly"],
            yearly=v["yearly"],
        )
        for k, v in raw["reported_maps"].items()
    }
    timeseries = {
        k: TimeSeries(
            name=k,
            output_var=v["output_var"],
            where=v["where"],
            repoption=tuple(v["repoption"]),
            restrictoption=tuple(v["restrictoption"]),
            operation=tuple(v["operation"]) if isinstance(v["operation"], list) else (v["operation"],),
        )
        for k, v in raw["timeseries"].items()
    }
    return options, reported_maps, timeseries


DEFAULT_OPTIONS, REPORTED_MAPS, TIMESERIES = _load_registry()


def default_options():
    """Fresh copy of the boolean option defaults."""
    return dict(DEFAULT_OPTIONS)
