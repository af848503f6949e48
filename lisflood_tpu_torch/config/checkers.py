"""Pre-flight settings validation.

Equivalent of the reference's ModulesInputs/MeteoForcings checkers
(global_modules/checkers.py:32-101): for every activated option, every
binding key each involved module declares (hydrological_modules/*
input_files_keys, extracted to input_keys.json) must exist as a readable
path or parse as a number.

The port's copy of lisflood_tpu/config/checkers.py.
"""
from __future__ import annotations

import json
import os

from ..utils.errors import LisfloodError

_KEYS_PATH = os.path.join(os.path.dirname(__file__), "input_keys.json")
with open(_KEYS_PATH) as _f:
    MODULE_INPUT_KEYS = json.load(_f)

# option -> modules (class names) activated by it (checkers.py:35-56)
OPTION_MODULES = {
    "all": ["surface_routing", "snow", "routing", "leafarea", "landusechange",
            "frost", "groundwater", "miscInitial", "soil"],
    "inflow": ["inflow"],
    "wateruse": ["wateruse"],
    "groundwaterSmooth": ["waterabstraction"],
    "wateruseRegion": ["waterabstraction"],
    "drainedIrrigation": ["soilloop", "soil"],
    "riceIrrigation": ["riceirrigation", "waterabstraction"],
    "indicator": ["lakes", "indicatorcalc", "waterabstraction"],
    "openwaterevapo": ["evapowater"],
    "varfractionwater": ["evapowater"],
    "TransientLandUseChange": ["landusechange", "indicatorcalc", "waterabstraction"],
    "simulateLakes": ["lakes", "indicatorcalc", "routing", "waterabstraction", "waterbalance"],
    "simulateReservoirs": ["reservoir", "indicatorcalc", "routing", "waterabstraction", "waterbalance"],
    "simulatePF": ["soilloop", "soil"],
    "simulateWaterLevels": ["waterlevel"],
    "TransLoss": ["transmission"],
    "gridSizeUserDefined": ["miscInitial"],
}


def _is_number(v):
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _is_path(v):
    if not v:
        return False
    base, ext = os.path.splitext(v)
    alt = base + (".nc" if ext in (".map", "") else ".map")
    ok = os.path.isfile(v) or os.access(v, os.W_OK)
    alt_ok = os.path.isfile(alt) or os.access(alt, os.W_OK)
    return ok or alt_ok


def check_modules_inputs(settings):
    """Raise LisfloodError listing every missing/misconfigured binding."""
    binding = settings.binding
    errors = []
    out_dir = settings.output_dir
    if not (os.path.isdir(out_dir) and os.access(out_dir, os.W_OK)):
        errors.append(f"Path defined in PathOut is not writable: {out_dir}")
    for option, modules in OPTION_MODULES.items():
        if option != "all" and not settings.options.get(option):
            continue
        for module in modules:
            keys = MODULE_INPUT_KEYS.get(module, {}).get(option, [])
            for key in keys:
                value = binding.get(key)
                if not value:
                    errors.append(f"[{module}]: setting {key!r} is missing in settings file")
                elif not (_is_path(value) or _is_number(value)):
                    errors.append(
                        f"[{module}]: setting {key} refers to a non existing path "
                        f"or a not well-formed float value: {value}")
    if errors:
        raise LisfloodError(
            "Missing files or misconfigured paths to run LISFLOOD, according to "
            "activated modules. Please check your settings file "
            f"{settings.settings_path}.\n" + "\n".join(errors))


def check_meteo_forcings(settings):
    """Verify the forcing stacks cover the simulation window
    (reference add1.py:798-855 checknetcdf, applied to the 4 forcings). A
    PCRaster numbered-map stack, which the runner reads where no netCDF file
    of the binding's name exists (io/forcing.open_forcing_stack), passes when
    it has the map of the first step: a later step without a map reuses the
    last one (readmapsparse). The JAX package checks netCDF stacks only."""
    from ..io.forcing import CsfStackReader
    from ..io.ncdf import NcFile
    from ..io.nctime import num_to_date

    binding = settings.binding
    errors = []
    for key in ("PrecipitationMaps", "TavgMaps", "ET0Maps", "E0Maps"):
        path = binding.get(key)
        if not path:
            errors.append(f"forcing binding {key} missing")
            continue
        nc_path = path if path.endswith(".nc") else os.path.splitext(path)[0] + ".nc"
        if not os.path.exists(nc_path):
            first = CsfStackReader(path, None, None).path_for_step(settings.step_start_int)
            if not os.path.exists(first):
                errors.append(f"forcing {key}: neither {nc_path} nor the PCRaster map "
                              f"{first} of the first step exists")
            continue
        try:
            with NcFile(path) as nc:
                units, cal = nc.time_units(), nc.time_calendar()
                first = num_to_date(nc.time_values()[0], units, cal)
                last = num_to_date(nc.time_values()[-1], units, cal)
        except Exception as e:  # noqa: BLE001
            errors.append(f"forcing {key}: {e}")
            continue
        if settings.step_start_dt < first:
            errors.append(f"{key}: simulation starts {settings.step_start_dt} before data {first}")
        if settings.step_end_dt > last:
            errors.append(f"{key}: simulation ends {settings.step_end_dt} after data {last}")
    if errors:
        raise LisfloodError("Meteo forcing check failed:\n" + "\n".join(errors))
