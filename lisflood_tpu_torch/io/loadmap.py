"""Binding-driven static map loader.

Re-implements the reference's `loadmap` semantics (add1.py:318-541): a
binding value may be a constant float, a PCRaster map, or a netCDF map
(single 2-D map, or a time stack selected at `timestepInit` for warm
starts, with 'exact'/'closest' timestamp matching and average-year
support). Maps are cut to the clone window, normalized to x-ascending /
y-descending, masked and compressed to (P,) land-pixel vectors.

The port's copy of lisflood_tpu/io/loadmap.py.
"""
from __future__ import annotations

import datetime
import os
from bisect import bisect_left

import numpy as np

from . import csf
from .ncdf import NcFile
from .nctime import date_to_num, num_to_date
from ..config.calendar import parse_date_or_step
from ..utils.errors import LisfloodError


def _normalize_xy(data, x, y):
    """Flip to x ascending / y descending (reference add1.py:406-418)."""
    if len(y) > 1 and y[0] < y[-1]:
        data = np.flip(data, axis=-2)
        y = y[::-1]
    if len(x) > 1 and x[0] > x[-1]:
        data = np.flip(data, axis=-1)
        x = x[::-1]
    return data, x, y


def _take_closest_left(sorted_vals, number):
    """Closest LEFT value (clamped floor lookup): the reference's
    takeClosest (add1.py:544-565) always returns the element at pos-1 —
    its nearest-after branch is commented out — clamped to the ends."""
    pos = bisect_left(sorted_vals, number)
    if pos == 0:
        return sorted_vals[0]
    if pos == len(sorted_vals):
        return sorted_vals[-1]
    return sorted_vals[pos - 1]


class MapsCache:
    """Cross-run static-map cache (reference decorators.py:50-117 `Cache`
    + add1.py:322-336 loadmap_cached): keyed by resolved file path and
    stack-selection arguments, surviving across LisfloodRunner instances
    so calibration loops re-reading the same static maps hit memory
    instead of disk. Enabled by the `MapsCaching` binding (textvar)."""

    cache = {}
    found = {}

    @classmethod
    def get(cls, key):
        hit = cls.cache.get(key)
        if hit is not None:
            cls.found[key] = cls.found.get(key, 0) + 1
        return hit

    @classmethod
    def put(cls, key, value):
        cls.cache[key] = value

    @classmethod
    def clear(cls):
        cls.cache.clear()
        cls.found.clear()

    @classmethod
    def size(cls):
        return len(cls.cache)

    @classmethod
    def values_found(cls):
        return sum(cls.found.values())

    @classmethod
    def extract(cls):
        import copy
        return copy.deepcopy(cls.cache)

    @classmethod
    def apply(cls, cache_in):
        for k, v in cache_in.items():
            cls.cache[k] = v

    @classmethod
    def info(cls):
        print("Caching")
        print(f"Number of items cached: {cls.size()}")
        print(f"Number of items retrieved: {cls.values_found()}")
        for key in cls.cache:
            print(f"   - {key}")


class MapLoader:
    """Loads binding-named static maps as (P,) compressed vectors."""

    def __init__(self, settings, grid):
        self.settings = settings
        self.binding = settings.binding
        self.grid = grid
        self._cache = {}
        self.flags = getattr(settings, "flags", {}) or {}
        # -c checkfiles audit rows: (name, path, nonMV, missing-in-mask,
        # min, mean, max)  (reference zusatz.py:49-113 checkmap)
        self.check_rows = []

    def _audit(self, name, value, vec):
        """checkfiles (-c) statistics + nancheck (-n) warning for a loaded
        map (reference zusatz.py:49-113, add1.py:981-986)."""
        if self.flags.get("checkfiles"):
            if np.isscalar(vec):
                self.check_rows.append((name, str(value), "nonmap", "", "", "", ""))
            else:
                finite = np.isfinite(vec)
                n = int(finite.sum())
                missing = int(vec.size - n)
                vmin = float(np.nanmin(vec)) if n else float("nan")
                vmax = float(np.nanmax(vec)) if n else float("nan")
                vmean = float(np.nansum(vec) / n) if n else float("nan")
                self.check_rows.append((name, str(value), n, missing, vmin, vmean, vmax))
        if self.flags.get("nancheck") and not np.isscalar(vec):
            if np.isnan(vec).any():
                import warnings
                from ..utils.errors import LisfloodWarning
                warnings.warn(LisfloodWarning(f"Warning: NaN values in map {name} ({value})"))

    # ------------------------------------------------------------------
    def load(self, name, timestampflag="exact", averageyearflag=False, default=None):
        """Load binding `name` -> python float (constant) or (P,) float64."""
        value = self.binding.get(name)
        if value is None:
            if default is not None:
                return default
            raise LisfloodError(f"No binding for map {name!r}")
        try:
            scalar = float(value)
            self._audit(name, value, scalar)
            return scalar
        except (TypeError, ValueError):
            pass
        data2d, from_int = self._read_2d_typed(name, value, timestampflag, averageyearflag)
        if from_int:
            # integer source maps (sites, regions, ldd): missing cells inside
            # the mask keep a -9999 sentinel instead of raising (the
            # reference's NaN check only applies to float maps, add1.py:277-280)
            vec = self.grid.compress(data2d)
            self._audit(name, value, vec)
            return np.where(np.isnan(vec), -9999.0, vec).astype(np.float64)
        vec = self.grid.compress(data2d, check_name=value).astype(np.float64)
        self._audit(name, value, vec)
        return vec

    def load_2d(self, name, timestampflag="exact", averageyearflag=False):
        """Load binding `name` as the raw 2-D clone-window raster (float,
        NaN = missing). For LDD / site / gauge maps that need 2-D topology."""
        value = self.binding.get(name)
        if value is None:
            raise LisfloodError(f"No binding for map {name!r}")
        return self._read_2d_typed(name, value, timestampflag, averageyearflag)[0]

    # ------------------------------------------------------------------
    def _read_2d_typed(self, name, value, timestampflag, averageyearflag):
        # MapsCaching is a binding (textvar), not an option — the
        # reference tests set it via vars_to_set (netcdf.py:333,403)
        if str(self.binding.get("MapsCaching", "False")) == "True":
            # the uncached read also depends on the grid ORIGIN (cut_window)
            # and — for numeric timestepInit — on CalendarDayStart/DtSec, so
            # both are part of the key: two runs in one process with
            # different same-size masks or calendars must not collide
            key = (value, timestampflag, averageyearflag,
                   str(getattr(self.settings, "timestep_init", None)),
                   str(self.binding.get("CalendarDayStart")),
                   str(self.binding.get("DtSec")),
                   self.grid.nrows, self.grid.ncols,
                   float(self.grid.west), float(self.grid.north),
                   float(self.grid.cell))
            hit = MapsCache.get(key)
            if hit is not None:
                data, from_int = hit
                return data.copy(), from_int
            data, from_int = self._read_2d_typed_uncached(
                name, value, timestampflag, averageyearflag)
            MapsCache.put(key, (data.copy(), from_int))
            return data, from_int
        return self._read_2d_typed_uncached(name, value, timestampflag, averageyearflag)

    def _read_2d_typed_uncached(self, name, value, timestampflag, averageyearflag):
        # a PCRaster map under any name, as the reference's readmap takes it
        # (the JAX package takes .map names only, ROADMAP.md Queue 3)
        if (value.endswith(".map") and os.path.exists(value)) or csf.is_csf(value):
            m = csf.read_map(value)
            if (m.nrows, m.ncols) != (self.grid.nrows, self.grid.ncols):
                raise LisfloodError(f"{value} has a different size than the clone map")
            data = m.data.astype(np.float64)
            data[m.mv_mask] = np.nan
            return data, not np.issubdtype(m.data.dtype, np.floating)
        path = os.path.splitext(value)[0] + ".nc"
        with NcFile(path) as nc:
            varname = nc.main_variable()
            xd, yd = nc.spatial_dims
            x = nc.coord(xd)
            y = nc.coord(yd)
            x_sorted = np.sort(x)
            y_sorted = np.sort(y)[::-1]
            cut0, cut1, cut2, cut3 = self.grid.cut_window(x_sorted, y_sorted)

            if nc.has_time and self.settings.timestep_init:
                data = self._select_stack_step(nc, varname, timestampflag, averageyearflag)
            else:
                data = nc.read(varname)
                if data.ndim == 3:
                    data = data[0]
            from_int = not np.issubdtype(data.dtype, np.floating)
            data, x, y = _normalize_xy(data, x, y)
            data = data[..., cut2:cut3, cut0:cut1]
            data = np.asarray(data, dtype=np.float64)
            fv = nc.fill_value(varname)
            if fv is not None and not np.isnan(fv):
                data = np.where(data == fv, np.nan, data)
            return data, from_int

    def _select_stack_step(self, nc, varname, timestampflag, averageyearflag):
        """Select the timestepInit slice inside a state-map stack
        (reference add1.py:424-484)."""
        binding = self.binding
        t_vals = nc.time_values()
        t_units = nc.time_units()
        t_cal = nc.time_calendar()
        timestep_init = self.settings.timestep_init
        parsed = parse_date_or_step(timestep_init, binding["calendar_type"])
        if isinstance(parsed, datetime.datetime):
            target_date = parsed
        else:
            begin = parse_date_or_step(binding["CalendarDayStart"], binding["calendar_type"])
            dt_day = float(binding["DtSec"]) / 86400.0
            target_date = begin + datetime.timedelta(days=(parsed - 1) * dt_day)
        if averageyearflag:
            ref_year = num_to_date(t_vals[0], t_units, t_cal).year
            try:
                target_date = target_date.replace(year=ref_year)
            except ValueError:
                target_date = target_date.replace(day=28, year=ref_year)
        target = date_to_num(target_date, t_units, t_cal)
        if target not in t_vals:
            if timestampflag == "exact":
                raise LisfloodError(
                    f"time step {int(target) + 1} is not stored in {nc.path}")
            target = _take_closest_left(sorted(t_vals.tolist()), target)
        itime = int(np.where(t_vals == target)[0][0])
        return nc.read(varname, index=itime)


def defsoil(loader, name1, name2=None, name3=None):
    """Load a parameter for the 3 land uses -> (3, P) array or list of
    scalars (reference add1.py:64-88; missing names fall back to name1)."""
    v1 = loader.load(name1) if isinstance(name1, str) else name1
    v2 = (loader.load(name2) if isinstance(name2, str) else name2) if name2 is not None else v1
    v3 = (loader.load(name3) if isinstance(name3, str) else name3) if name3 is not None else v1
    return [v1, v2, v3]
