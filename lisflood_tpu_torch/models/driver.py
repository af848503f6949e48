"""Run driver: time loop, forcing pipeline and output writing — the port of
lisflood_tpu/models/driver.py.

The counterpart of the reference's lisfloodexe and DynamicFramework run loop
(main.py:56-157, zusatz.py:116-171) and its output module
(output.py:485-586): it assembles the forcing on the host and moves it to
the device (a chunk of days as one stack in `run_scanned`), runs each day's
step there (the channel kernel and the overland sweep launch once a day; on
the card a replay of the step captured as a CUDA graph, models/graph.py)
and feeds the declarative outputs (PCRaster or netCDF map stacks,
PCRaster-style TSS gauge series) on the host.

Only what the outputs read goes back to the host: `OutputManager.fields_at`
names the diagnostic fields a day reports, and `run_scanned` copies them
(with the soil's `SoilCourantCapHit`) once per chunk of days, one copy per
dtype. The TSS `total` operation and the compound expressions of the
registry run on the host in NumPy, on the host copy of the parameters.
"""
from __future__ import annotations

import datetime
import os
import queue
import re
import threading
import time as _time
import types
import warnings

import numpy as np
import torch

from ..config.calendar import parse_date_or_step
from ..device import to_device
from ..io import ncdf
from ..io.csf import VS_SCALAR, write_map
from ..io.forcing import ForcingReader, open_forcing_stack, run_dates
from ..io.tss import TssWriter
from ..utils.errors import LisfloodError, LisfloodWarning
from . import graph
from .initial import METEO_KEYS, _field, build_model
from .step import LANDUSE_FRACTIONS, build_step, prepare_state, state_keys

_INDEXED = re.compile(r"^(\w+)\[(\d+)\]$")

# the water demands of the water-use option and the binding of their maps
DEMAND_KEYS = (("DomesticDemandMM", "DomesticDemandMaps"),
               ("IndustrialDemandMM", "IndustrialDemandMaps"),
               ("LivestockDemandMM", "LivestockDemandMaps"),
               ("EnergyDemandMM", "EnergyDemandMaps"))


def resolve_output(diag, expr):
    """Resolve a ReportedMap/TimeSeries output_var expression against the
    diagnostics dict (host arrays): a plain name ('LZ'), an indexed name
    ('Theta1a[2]'), or an arithmetic expression as the reference evals them
    ('EvaAddM3*self.var.M3toMM', output.py:566)."""
    m = _INDEXED.match(expr)
    if m:
        return np.asarray(diag[m.group(1)])[int(m.group(2))]
    if expr in diag:
        return np.asarray(diag[expr])
    ns = {k: np.asarray(v) for k, v in diag.items()}
    ns["self"] = types.SimpleNamespace(var=types.SimpleNamespace(**ns))
    return np.asarray(eval(expr, {"__builtins__": {}}, ns))


def output_var_fields(expr):
    """Diagnostic field names an output_var expression depends on."""
    return {t for t in re.findall(r"[A-Za-z_]\w*", expr.replace("self.var.", " "))
            if t not in ("self", "var")}


def _coord_pairs(value):
    """Parse a 'x1 y1 x2 y2 ...' gauge coordinate string; None if the value
    is not an even-length list of numbers (reference output.py:513-515)."""
    toks = str(value).split()
    if not toks or len(toks) % 2 != 0:
        return None
    try:
        return [float(t) for t in toks]
    except ValueError:
        return None


def _gauges_from_coords(coords, grid):
    """Build a compressed gauge-id vector (i+1 at each coordinate's cell)
    from map coordinates (reference valuecell, add1.py:102-132)."""
    ids2d = np.zeros((grid.nrows, grid.ncols))
    for i in range(len(coords) // 2):
        col = int((coords[2 * i] - grid.west) / grid.cell)
        row = int((grid.north - coords[2 * i + 1]) / grid.cell)
        if not (0 <= row < grid.nrows and 0 <= col < grid.ncols):
            raise LisfloodError(
                f"Gauge coordinates {coords[2*i]},{coords[2*i+1]} outside mask "
                f"map - col,row: {col},{row}")
        ids2d[row, col] = i + 1
    return grid.compress(ids2d)


class GaugeSampler:
    """PCRaster TimeoutputTimeseries sampling: per gauge-id region average
    (zusatz.py:294-400 + pcraster areaaverage semantics)."""

    def __init__(self, ids_vec):
        ids_vec = np.nan_to_num(np.asarray(ids_vec), nan=0.0).astype(np.int64)
        self.ids = np.unique(ids_vec[ids_vec > 0])
        self.masks = [ids_vec == gid for gid in self.ids]

    def sample(self, values):
        values = np.asarray(values)
        return np.array([values[m].mean() if m.any() else np.nan for m in self.masks])


_H5_INTERNAL_ATTRS = ("CLASS", "NAME", "REFERENCE_LIST", "DIMENSION_LIST",
                      "_Netcdf4Dimid", "_Netcdf4Coordinates", "_FillValue")


class TemplateMeta:
    """Coordinate + projection metadata from the netCDF template — the
    analogue of the reference's NetCDFMetadata singleton
    (settings.py:285-326), consumed by the map writer so geographic grids
    get lon/lat dims + the projection variable exactly like
    write_netcdf_header (netcdf.py:494-530)."""

    _XY_DEFAULTS = {
        "x": {"units": "Meter", "standard_name": "projection_x_coordinate",
              "long_name": "x coordinate of projection"},
        "y": {"units": "Meter", "standard_name": "projection_y_coordinate",
              "long_name": "y coordinate of projection"},
        "lon": {"units": "degrees_east", "standard_name": "longitude",
                "long_name": "longitude coordinate"},
        "lat": {"units": "degrees_north", "standard_name": "latitude",
                "long_name": "latitude coordinate"},
    }

    def __init__(self, settings):
        self.dims = ("x", "y")      # (x-like, y-like)
        self.coord_attrs = {}
        self.proj = None            # (var_name, attrs)
        path = (settings.binding.get("netCDFtemplate")
                or settings.binding.get("PrecipitationMaps"))
        if path:
            try:
                with ncdf.NcFile(path) as nc:
                    xd, yd = nc.spatial_dims
                    self.dims = (xd, yd)
                    for d in (xd, yd):
                        self.coord_attrs[d] = {
                            k: v for k, v in nc.attrs(d).items()
                            if k not in _H5_INTERNAL_ATTRS}
                    # the grid mapping that the template's variable names
                    # (a geographic grid's latitude_longitude too; the JAX
                    # package looks for the laea names only, ROADMAP.md
                    # Queue 3), else a variable of the laea names
                    named = nc.attrs(nc.main_variable()).get("grid_mapping")
                    for name in ((str(named),) if named else ()) + (
                            "laea", "lambert_azimuthal_equal_area"):
                        if nc.has(name):
                            self.proj = (name, {
                                k: v for k, v in nc.attrs(name).items()
                                if k not in _H5_INTERNAL_ATTRS})
                            break
            except Exception:
                pass

    def attrs_for(self, dim):
        at = dict(self._XY_DEFAULTS.get(dim, {}))
        at.update(self.coord_attrs.get(dim, {}))
        return at


class MapStackWriter:
    """netCDF-4 stack writer for one reported map (output.py:68-167 +
    netcdf.py:432-584); through h5py, which raises LisfloodError where it is
    not installed."""

    def __init__(self, settings, grid, map_key, entry, rep_steps, frequency, single,
                 meta=None):
        self.settings = settings
        self.grid = grid
        self.map_key = map_key
        self.entry = entry
        self.frequency = frequency
        self.single = single          # end map: single 2-D field
        self.meta = meta or TemplateMeta(settings)
        path = settings.binding.get(map_key)
        self.path = os.path.normpath(path) + ".nc"
        self.var_name = os.path.basename(os.path.normpath(path))
        self.rep_steps = list(rep_steps) if rep_steps is not None else None
        self._file = None

    def _create(self):
        binding = self.settings.binding
        f = ncdf.create_nc(self.path)
        f.attrs["settingsfile"] = self.settings.settings_path
        f.attrs["date_created"] = _time.ctime()
        f.attrs["Source_Software"] = "LISFLOOD-TPU"
        f.attrs["source"] = "Lisflood output maps"
        f.attrs["Conventions"] = "CF-1.6"
        xd, yd = self.meta.dims
        ncdf.add_dimension(f, xd, self.grid.coords_x(), self.meta.attrs_for(xd))
        ncdf.add_dimension(f, yd, self.grid.coords_y(), self.meta.attrs_for(yd))
        dtype = binding.get("OutputMapsDataType", "float64")
        attrs = {"standard_name": self.map_key, "long_name": self.entry.output_var,
                 "units": self.entry.unit}
        if self.meta.proj is not None:
            proj_name, proj_attrs = self.meta.proj
            proj = f.create_dataset(proj_name, data=np.int32(0))
            for k, v in proj_attrs.items():
                proj.attrs[k] = v
            attrs["grid_mapping"] = proj_name
        if self.single:
            ncdf.add_variable(f, self.var_name, (yd, xd), dtype, fill_value=-9999.0, attrs=attrs)
        else:
            dt_sec = float(binding["DtSec"])
            start = parse_date_or_step(binding["CalendarDayStart"], binding["calendar_type"])
            if dt_sec >= 86400:
                units = "days since %s" % start.strftime("%Y-%m-%d %H:%M:%S.0")
            elif dt_sec >= 3600:
                units = "hours since %s" % start.strftime("%Y-%m-%d %H:%M:%S.0")
            else:
                units = "minutes since %s" % start.strftime("%Y-%m-%d %H:%M:%S.0")
            ncdf.add_unlimited_time(f, units, binding["calendar_type"])
            ncdf.add_variable(f, self.var_name, ("time", yd, xd), dtype, fill_value=-9999.0,
                              chunks=(1, self.grid.nrows, self.grid.ncols), attrs=attrs)
        self._file = f
        return f

    def write_step(self, date, vec, step=None):
        if self._file is None:
            self._create()
        data2d = self.grid.decompress(np.asarray(vec, dtype=np.float64))
        data2d = np.where(np.isnan(data2d), -9999.0, data2d)
        if self.single:
            self._file[self.var_name][:, :] = data2d
        else:
            ncdf.append_time_step(self._file, self.var_name, date, data2d)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class PCRasterStackWriter:
    """PCRaster-format map output (output.py:170-188): one CSF .map per
    reported step with 8.3-style numbered names (add1.py:858-889), plus the
    plain name for end maps."""

    def __init__(self, settings, grid, map_key, entry, single):
        self.grid = grid
        self.map_key = map_key
        self.entry = entry
        self.single = single
        self.path = os.path.normpath(settings.binding.get(map_key))

    def _numbered(self, step):
        head, tail = os.path.split(self.path)
        nr = str(step)
        tail = tail[:8]
        space = 11 - (len(tail) + len(nr))
        result = f"{tail}{'0' * space}{nr}"
        return os.path.join(head, f"{result[:8]}.{result[8:]}")

    def write_step(self, date, vec, step=None):
        data2d = self.grid.decompress(np.asarray(vec, dtype=np.float64))
        if self.single:
            # bindings like '.../avgdis.map' already carry the extension
            path = self.path if self.path.endswith(".map") else self.path + ".map"
        else:
            path = self._numbered(step)
        write_map(path, data2d.astype(np.float32), self.grid.west, self.grid.north,
                  self.grid.cell, VS_SCALAR)

    def close(self):
        pass


class OutputManager:
    """Declarative outputs: builds all active map writers and TSS samplers
    from the settings registries (output.py:387-447,485-586). `report`
    takes the day's diagnostics as host arrays (`fields_at` names the ones
    it reads); `params` are the host parameters of build_model."""

    def __init__(self, settings, grid, params, aux, config):
        self.settings = settings
        self.grid = grid
        self.config = config
        binding = settings.binding
        self.rep_steps = [x for x in settings.report_steps
                          if settings.step_start_int <= x <= settings.step_end_int]
        self.map_writers = []       # (writer, trigger, frequency), trigger 'end'/'steps'/'all'
        seen_paths = set()
        # map writes on one writer thread (reference output.py:449-480), so
        # that the host's map writing overlaps the device's next steps;
        # AsyncOutput=False writes in line
        self._async = str(binding.get("AsyncOutput", "True")) != "False"
        self._write_queue = None
        self._write_worker = None
        self._write_error = None

        write_nc = settings.options.get("writeNetcdf") or settings.options.get("writeNetcdfStack")
        meta = TemplateMeta(settings)

        # TSS `operation` (reference output.py:566-574): catchment 'total' =
        # accuflux(value*PixelArea)/UpArea; 'mapmaximum' = the map's maximum
        self._params = params
        self._graph = aux.get("graph_full")
        self._pixel_area = np.asarray(params["PixelArea"], np.float64)
        up_area = np.asarray(params["UpArea"], np.float64)
        self._inv_up_area = np.where(up_area > 0, 1.0 / up_area, 0.0)

        def add(map_key, entry, trigger, frequency):
            path = binding.get(map_key)
            if not path:
                return
            if trigger == "steps" and not self.rep_steps:
                return
            if write_nc:
                w = MapStackWriter(settings, grid, map_key, entry, self.rep_steps, frequency,
                                   single=(trigger == "end"), meta=meta)
            else:
                w = PCRasterStackWriter(settings, grid, map_key, entry, single=(trigger == "end"))
            if w.path in seen_paths:
                return
            seen_paths.add(w.path)
            self.map_writers.append((w, trigger, frequency))

        for key, entry in settings.report_maps_end.items():
            add(key, entry, "end", None)
        for key, entry in settings.report_maps_steps.items():
            freq = "monthly" if entry.monthly else ("yearly" if entry.yearly else "all")
            add(key, entry, "steps", freq)
        for key, entry in settings.report_maps_all.items():
            freq = "monthly" if entry.monthly else ("yearly" if entry.yearly else "all")
            add(key, entry, "all", freq)

        # TSS
        self.tss_writers = {}
        self.tss_samplers = {}
        # whether drop_unavailable has seen the step's diagnostics
        self.checked = False
        loader = aux["loader"]
        for name, ts in settings.report_timeseries.items():
            where = ts.where
            if where == "Catchments":
                ids_vec = params["Catchments"]
            elif _coord_pairs(binding.get(where, "")) is not None:
                # coordinate-pair gauges: 'x1 y1 x2 y2 ...' placed on the
                # grid by inverse cell arithmetic (reference valuecell,
                # add1.py:102-132; dispatch output.py:513-515)
                ids_vec = _gauges_from_coords(_coord_pairs(binding[where]), grid)
            else:
                try:
                    ids_vec = loader.load(where)
                except LisfloodError:
                    continue
                if np.isscalar(ids_vec):
                    continue
            sampler = GaugeSampler(ids_vec)
            path = binding.get(name)
            if not path:
                continue
            self.tss_writers[name] = TssWriter(path, sampler.ids.tolist(),
                                               settings_path=settings.settings_path,
                                               write_header=not settings.flags.get("noheader"))
            self.tss_samplers[name] = (sampler, ts)

    def drop_unavailable(self, diag):
        """Leave out, with one LisfloodWarning naming them, the outputs whose
        expression reads a field that is neither among the step's
        diagnostics `diag` nor a parameter: the registry declares a few
        that no step computes (WaterUseTS's WUseSumM3, PolderFluxTS's
        PolderFlux and four maps of repTotalAbs), where the JAX package's
        run fails with a KeyError (ROADMAP.md Queue 3). The run calls it
        with its first step's diagnostics, before the first report; no file
        of an output left out has been written then."""
        if self.checked:
            return
        self.checked = True

        def missing(expr):
            return sorted(f for f in output_var_fields(expr)
                          if f not in diag and f not in self._params)

        gone = {w.map_key: missing(w.entry.output_var) for w, _, _ in self.map_writers}
        gone.update({name: missing(ts.output_var) for name, (_, ts) in self.tss_samplers.items()})
        gone = {k: v for k, v in gone.items() if v}
        if not gone:
            return
        self.map_writers = [m for m in self.map_writers if m[0].map_key not in gone]
        for name in gone:
            self.tss_samplers.pop(name, None)
            self.tss_writers.pop(name, None)
        warnings.warn(LisfloodWarning(
            "outputs left out, their fields are computed by no step: "
            + ", ".join(f"{k} ({', '.join(v)})" for k, v in sorted(gone.items()))))

    def _writer_loop(self):
        while True:
            item = self._write_queue.get()
            if item is None:
                return
            if self._write_error is not None:
                continue                  # first failure wins; drain the rest
            w, date, vec, step = item
            try:
                w.write_step(date, vec, step=step)
            except Exception as e:        # surfaced at close()
                self._write_error = e

    def _dispatch_write(self, w, date, vec, step):
        """Stage a map write on the writer thread (reference
        output.py:449-480 OutputMapsFactoryThreads). The queue is bounded, so
        a slow file system holds the run back instead of buffering it; the
        thread gets a float64 array of its own."""
        if not self._async:
            w.write_step(date, vec, step=step)
            return
        if self._write_queue is None:
            self._write_queue = queue.Queue(maxsize=64)
            self._write_worker = threading.Thread(target=self._writer_loop, daemon=True)
            self._write_worker.start()
        self._write_queue.put((w, date, np.array(vec, np.float64), step))

    def _drain_writes(self):
        if self._write_queue is not None:
            self._write_queue.put(None)
            self._write_worker.join()
            self._write_queue = None
            self._write_worker = None

    def _map_due(self, trigger, freq, step, is_last, monthend, yearend):
        freq_ok = (freq == "all" or freq is None or (freq == "monthly" and monthend)
                   or (freq == "yearly" and yearend))
        if trigger == "end":
            return is_last
        if trigger == "steps":
            return step in self.rep_steps and freq_ok
        return freq_ok

    def _fields(self, exprs):
        fields = set()
        for e in exprs:
            fields |= output_var_fields(e)
        return {f for f in fields if f not in self._params}

    def needed_fields(self):
        """Diagnostic fields the active outputs read (params excluded —
        compound expressions may reference converters like M3toMM, which
        resolve from the params side instead)."""
        return self._fields([w.entry.output_var for w, _, _ in self.map_writers]
                            + [ts.output_var for _, ts in self.tss_samplers.values()])

    def fields_at(self, step, is_last=False, monthend=False, yearend=False):
        """The diagnostic fields that `report` reads for this step: every
        TSS's, and the maps' that are due (the end maps on the last step
        only)."""
        return self._fields([w.entry.output_var for w, trigger, freq in self.map_writers
                             if self._map_due(trigger, freq, step, is_last, monthend, yearend)]
                            + [ts.output_var for _, ts in self.tss_samplers.values()])

    def _resolve(self, diag, expr):
        try:
            return resolve_output(diag, expr)
        except (KeyError, AttributeError):
            merged = dict(self._params)
            merged.update(diag)
            return resolve_output(merged, expr)

    def report(self, step, date, diag, monthend=False, yearend=False, is_last=False):
        for w, trigger, freq in self.map_writers:
            if self._map_due(trigger, freq, step, is_last, monthend, yearend):
                self._dispatch_write(w, date, self._resolve(diag, w.entry.output_var), step)

        for name, (sampler, ts) in self.tss_samplers.items():
            field = np.asarray(self._resolve(diag, ts.output_var), np.float64)
            op = ts.operation[0] if ts.operation else ""
            if op == "mapmaximum":
                # reference output.py:568-570: sample the map-wide maximum
                field = np.full_like(field, np.nanmax(field))
            elif op == "total" and self._graph is not None:
                # reference output.py:571-573: upstream-average via
                # catchmenttotal(value*PixelArea, Ldd) * InvUpArea
                field = (self._graph.accuflux(np.nan_to_num(field) * self._pixel_area)
                         * self._inv_up_area)
            values = sampler.sample(field)
            self.tss_writers[name].sample(step, values)

    def close(self):
        # drain the writer thread, then close/flush EVERY writer before
        # surfacing a staged write error — a failed map write must not leave
        # the other output files unflushed
        self._drain_writes()
        try:
            for w, _, _ in self.map_writers:
                w.close()
            for w in self.tss_writers.values():
                w.flush()
        finally:
            if self._write_error is not None:
                err, self._write_error = self._write_error, None
                raise err


def to_host(tensors):
    """Tensors (name -> tensor) as NumPy arrays: one copy to the host per
    device and dtype (the tensors of a kind are joined on their device
    first). Each array is a view of its kind's host buffer."""
    by_kind = {}
    for k, v in tensors.items():
        by_kind.setdefault((v.device, v.dtype), []).append(k)
    out = {}
    for keys in by_kind.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in keys]).cpu().numpy()
        pos = 0
        for k in keys:
            n = tensors[k].numel()
            out[k] = flat[pos:pos + n].reshape(tuple(tensors[k].shape))
            pos += n
    return out


def period_ends(config, date):
    """(month end, year end) of the step at `date`: only with water use and
    the indicators both on (reference quirk, indicatorcalc.py:92-96)."""
    if not (config.water_use and config.indicator):
        return False, False
    nxt = date + datetime.timedelta(seconds=config.dt_sec)
    return nxt.month != date.month, nxt.year != date.year


class HostForcing:
    """The forcing of every step on the host, as the JAX package's
    LisfloodRunner.forcing_for assembles it: `forcing(offset, date, dtype)`
    is a dict of NumPy arrays (floats in `dtype`). The readers open here and
    close in `close`:
      - the meteo (precipitation, temperature, ET0, E0) from netCDF or
        PCRaster stacks, CalendarDay, LAIInterval and VarWMonth;
      - MonthEnd and YearEnd, with water use and the indicators;
      - QInM3, the inflow hydrograph's row for step StepStart + offset;
      - `<Fraction>_t`, and `_nt` (the next step's) with repMBTs, from the
        yearly land-use stacks;
      - the transient water demands times dt_day. The static demands are
        parameters of build_model: `static_demands` reads them as it does."""

    def __init__(self, settings, config, aux):
        self.settings = settings
        self.config = config
        self.aux = aux
        self.dates = run_dates(settings)
        grid = aux["grid"]
        binding = settings.binding
        skip_val = settings.flags.get("skipvalreplace", False)
        self.meteo, self.demand, self.landuse = {}, {}, {}
        try:
            for key, name in METEO_KEYS:
                # netCDF stack, or PCRaster numbered-map stack (readmapsparse)
                self.meteo[key] = open_forcing_stack(binding[name], grid, self.dates,
                                                     first_step=settings.step_start_int,
                                                     skip_valid_replace=skip_val)
            if config.water_use and config.transient_water_demand:
                for key, name in DEMAND_KEYS:
                    self.demand[key] = ForcingReader(
                        binding[name], grid, self.dates, indexer="ffill",
                        climatology=config.water_demand_ave_year,
                        skip_valid_replace=skip_val)
            if config.transient_landuse:
                # yearly land-use fraction stacks, nearest-date indexed
                # (landusechange.py:94-148)
                for key in LANDUSE_FRACTIONS:
                    self.landuse[key] = ForcingReader(
                        binding[key + "Maps"], grid, self.dates, indexer="closest",
                        skip_valid_replace=skip_val)
        except BaseException:
            self.close()
            raise
        self.lai_lookup = aux["lai_day_to_interval"]
        self.varw_lookup = aux.get("varW_day_to_month")
        if config.inflow:
            # per-step inflow vector from the hydrograph tss (inflow.py:113-127)
            ids, data, steps = aux["inflow_tss"]
            self._inflow = (aux["inflow_points"], {pid: i for i, pid in enumerate(ids)},
                            {int(st): i for i, st in enumerate(steps)}, data)

    def close(self):
        """Close the readers (joins their prefetch threads)."""
        for readers in (self.meteo, self.demand, self.landuse):
            for r in readers.values():
                r.close()

    def static_demands(self):
        """The water demands without TransientWaterDemandChange, as
        build_model reads them into the parameters (the maps nearest the
        run's start, times dt_day)."""
        loader, P = self.aux["loader"], self.config.num_pixels
        return {key: _field(loader.load(name, timestampflag="closest"), P) * self.config.dt_day
                for key, name in DEMAND_KEYS}

    def __call__(self, offset, date, dtype=np.float64):
        """Step `offset`'s forcing, the step of `date`, floats in `dtype`."""
        cfg = self.config
        cal_day = int(date.strftime("%j"))
        f = {key: np.asarray(r[offset], dtype) for key, r in self.meteo.items()}
        f["CalendarDay"] = np.asarray(cal_day, dtype)
        f["LAIInterval"] = np.int32(self.lai_lookup[cal_day])
        if self.varw_lookup is not None:
            f["VarWMonth"] = np.int32(self.varw_lookup[cal_day])
        if cfg.water_use and cfg.indicator:
            f["MonthEnd"], f["YearEnd"] = (np.bool_(e) for e in period_ends(cfg, date))
        if cfg.inflow:
            pts, col_of, row_of, data = self._inflow
            qin = np.zeros(cfg.num_pixels)
            row = row_of.get(self.settings.step_start_int + offset)
            if row is not None:
                for pid, col in col_of.items():
                    val = data[row, col]
                    if np.isfinite(val) and val < 1e30:
                        qin[pts == pid] = val
            f["QInM3"] = np.asarray(qin * cfg.dt_sec, dtype)
        if cfg.transient_landuse:
            n = len(self.dates)
            for key, reader in self.landuse.items():
                f[key + "_t"] = np.asarray(reader[offset], dtype)
                if cfg.rep_mbts:
                    f[key + "_nt"] = np.asarray(reader[min(offset + 1, n - 1)], dtype)
        if cfg.water_use and cfg.transient_water_demand:
            for key, reader in self.demand.items():
                f[key] = np.asarray(reader[offset], dtype) * dtype(cfg.dt_day)
        return f


# the Precision binding: 'double' (the reference's arithmetic, the default)
# or 'single'
_SINGLE = ("single", "float32", "f32")


class LisfloodRunner:
    """End-to-end deterministic run of the settings' catchment on `device`
    (None: CUDA, which raises on a machine without a card)."""

    def __init__(self, settings, dtype=None, device=None):
        self.settings = settings
        t0 = _time.perf_counter()
        self.config, params_np, state_np, aux = build_model(settings)
        t1 = _time.perf_counter()
        self.aux = aux
        self.grid = aux["grid"]
        self.params_np = params_np
        if dtype is None:
            prec = str(settings.binding.get("Precision", "double")).lower()
            dtype = torch.float32 if prec in _SINGLE else torch.float64
        self.dtype = dtype
        self.step, self.params = build_step(self.config, params_np, aux, dtype=dtype,
                                            device=device)
        self.device = self.step.device
        # the step's state contract: build_model may emit entries the step
        # does not carry (split-routing state in an InitLisflood prerun)
        allowed = {k[3:] if k.startswith("pk$") else k for k in state_keys(self.config)}
        self.state = self.step.prepare_state(
            {k: v for k, v in state_np.items() if k in allowed}, dtype)
        self.dates = run_dates(settings)
        self.forcing = HostForcing(settings, self.config, aux)
        try:
            self.outputs = OutputManager(settings, self.grid, params_np, aux, self.config)
        except BaseException:
            self.forcing.close()
            raise
        # host seconds by part of the run: build_model, the step built and the
        # state moved to the device, each day's forcing read and moved, the
        # step calls (they return when the host has queued the day's work,
        # or waited for the device where the step reads back), the step's
        # capture as a CUDA graph on the card (models/graph.py), the copies
        # to the host (which wait for the device), the reports and close
        self.seconds = {"build_model": t1 - t0, "to_device": _time.perf_counter() - t1,
                        "forcing": 0.0, "steps": 0.0, "capture": 0.0, "to_host": 0.0,
                        "report": 0.0, "close": 0.0}

    def close(self):
        """Close the forcing readers and flush the outputs."""
        t0 = _time.perf_counter()
        self.forcing.close()
        self.outputs.close()
        self.seconds["close"] += _time.perf_counter() - t0

    def forcing_for(self, offset, date):
        """Step `offset`'s forcing on the device, in the runner's dtype."""
        t0 = _time.perf_counter()
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        f = self._with_demands(to_device(self.forcing(offset, date, np_dtype), self.device,
                                         self.dtype))
        self.seconds["forcing"] += _time.perf_counter() - t0
        return f

    def forcing_chunk(self, offsets):
        """The forcing of the step offsets `offsets` on the device as one
        stack per entry, a day a row, moved in one copy per entry (as the JAX
        package's run_scanned stacks a chunk); the static water demands are
        not in it."""
        t0 = _time.perf_counter()
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        days = [self.forcing(o, self.dates[o], np_dtype) for o in offsets]
        stack = to_device({k: np.stack([f[k] for f in days]) for k in days[0]}, self.device,
                          self.dtype)
        self.seconds["forcing"] += _time.perf_counter() - t0
        return stack

    def _with_demands(self, f):
        """The forcing `f` with the static water demands, the parameters
        themselves (without TransientWaterDemandChange)."""
        if self.config.water_use and not self.config.transient_water_demand:
            for key, _ in DEMAND_KEYS:
                f[key] = self.params[key]
        return f

    def _timed(self, part, fn, *args):
        t0 = _time.perf_counter()
        out = fn(*args)
        self.seconds[part] += _time.perf_counter() - t0
        return out

    def _warn_soil_cap(self, hit):
        """One-shot warning when the Courant safety cap truncated soil
        sub-stepping (the reference's per-pixel loop is unbounded,
        soilloop.py:249)."""
        if hit and not getattr(self, "_soil_cap_warned", False):
            self._soil_cap_warned = True
            warnings.warn(LisfloodWarning(
                f"soil Courant sub-step count exceeded the safety cap "
                f"(max_soil_substeps={self.config.max_soil_substeps}); "
                f"inter-layer seepage was truncated on some pixels"))

    def _prepared(self):
        """The runner's state in the step's packed layout (it is natural
        after a run, for its callers)."""
        return prepare_state(self.config, self.step.routers, self.state)

    def _steps(self, max_steps):
        n = self.settings.step_end_int - self.settings.step_start_int + 1
        return n if max_steps is None else min(n, max_steps)

    def _capture_apart(self, runner):
        """The step's capture (none on the CPU) out of the step calls'
        seconds, into its own part."""
        cap = getattr(runner, "capture_seconds", None) or 0.0
        self.seconds["steps"] -= cap
        self.seconds["capture"] += cap

    def _reported(self, step, is_last, ends, extra=()):
        """The diagnostics a day copies out of the step: None (every one) on
        the first day, before drop_unavailable has seen them; then the
        fields the day reports, SoilCourantCapHit and `extra`."""
        if not self.outputs.checked:
            return None
        return self.outputs.fields_at(step, is_last, *ends) | {"SoilCourantCapHit", *extra}

    def run_scanned(self, chunk_steps=16, progress=False, max_steps=None):
        """The production run: chunks of `chunk_steps` days, each chunk's
        forcing moved to the device as one stack, each day the runner's step
        (on the card a replay of the captured step, models/graph.py), the
        fields that the chunk's days report copied to the host once at the
        chunk's end and reported there."""
        settings = self.settings
        start, end = settings.step_start_int, settings.step_end_int
        n = self._steps(max_steps)
        runner = graph.stepper(self.step)
        state = self._prepared()
        offset = 0
        while offset < n:
            k = min(chunk_steps, n - offset)
            stack = self.forcing_chunk(range(offset, offset + k))
            days, kept = [], {}
            for i in range(k):
                step, date = start + offset + i, self.dates[offset + i]
                ends = period_ends(self.config, date)
                f = self._with_demands({key: v[i] for key, v in stack.items()})
                state, d = self._timed("steps", runner, state, f,
                                       self._reported(step, step == end, ends))
                self.outputs.drop_unavailable(d)
                fields = self.outputs.fields_at(step, step == end, *ends)
                kept.update({(i, key): d[key] for key in fields | {"SoilCourantCapHit"}})
                days.append((step, date, ends, fields))
            host = self._timed("to_host", to_host, kept)
            self._warn_soil_cap(any(bool(host[(i, "SoilCourantCapHit")]) for i in range(k)))
            for i, (step, date, (monthend, yearend), fields) in enumerate(days):
                self._timed("report", self.outputs.report, step, date,
                            {key: host[(i, key)] for key in fields}, monthend, yearend,
                            step == end)
            if progress:
                print(f"\r{start + offset + k - 1} - {self.dates[offset + k - 1]:%d/%m/%Y %H:%M}",
                      end="", flush=True)
            offset += k
        if progress:
            print()
        self._capture_apart(runner)
        # natural-space state for downstream consumers (warm dumps, tests)
        self.state = self.step.natural_state(runner.keep(state))
        self.close()
        return self.state

    def _debug_dump(self, fname, chan_m3, chan2_m3=None, cross2_area=None):
        """-d debug: per-pixel channel state text dump (reference
        Lisflood_initial.py:239-250 / Lisflood_dynamic.py:252-262),
        including the reference's range(nelements-1) quirk."""
        inv_dx = 1.0 / np.asarray(self.params_np["ChanLength"], np.float64)
        chan_m3 = np.asarray(chan_m3, np.float64)
        tcsa = chan_m3 * inv_dx
        with open(fname, "w") as f:
            if chan2_m3 is not None and cross2_area is not None:
                c2 = np.asarray(cross2_area, np.float64)
                m2 = np.asarray(chan2_m3, np.float64)
                for i in range(chan_m3.size - 1):
                    print(i, tcsa[i], c2[i], chan_m3[i], m2[i], file=f)
            else:
                for i in range(chan_m3.size - 1):
                    print(i, tcsa[i], chan_m3[i], file=f)

    def _debug_state(self, fname, chan_m3=None):
        """The -d dump of the current state (ChanM3Kin, or `chan_m3` where
        given, with the split-routing second lane)."""
        keys = ("ChanM3Kin", "Chan2M3Kin", "CrossSection2Area")
        st = self.step.natural_state({k: v for k, v in self.state.items()
                                      if k.removeprefix("pk$") in keys})
        st = to_host({**st, **({"ChanM3": chan_m3} if chan_m3 is not None else {})})
        split = "Chan2M3Kin" in st and "CrossSection2Area" in st
        self._debug_dump(fname, st.get("ChanM3", st["ChanM3Kin"]),
                         st.get("Chan2M3Kin") if split else None,
                         st.get("CrossSection2Area") if split else None)

    def _loud_dis(self, diag):
        """First-gauge average discharge for the -l per-step line
        (reference output.py:557-563 firstout of DisTS)."""
        pair = self.outputs.tss_samplers.get("DisTS")
        if pair is None:
            return None
        sampler, _ = pair
        try:
            return float(sampler.sample(np.asarray(diag["ChanQAvg"]))[0])
        except Exception:
            return None

    def run(self, progress=False, max_steps=None):
        """The run day by day, with the -l line and the -d dumps of each
        day: the fields a day reports go to the host after that day; on the
        card each day is a replay of the captured step (models/graph.py)."""
        settings = self.settings
        flags = settings.flags
        loud = flags.get("loud")
        debug = flags.get("debug")
        start, end = settings.step_start_int, settings.step_end_int
        n = self._steps(max_steps)
        runner = graph.stepper(self.step)
        self.state = self._prepared()
        if debug:
            self._debug_state(os.path.join(settings.output_dir, f"Debug_init_{start}.txt"))
        for offset in range(n):
            step, date = start + offset, self.dates[offset]
            f = self.forcing_for(offset, date)
            ends = period_ends(self.config, date)
            extra = ("ChanQAvg",) * bool(loud) + ("ChanM3",) * bool(debug)
            self.state, d = self._timed("steps", runner, self.state, f,
                                        self._reported(step, step == end, ends, extra))
            self.outputs.drop_unavailable(d)
            monthend, yearend = ends
            fields = self.outputs.fields_at(step, step == end, monthend, yearend)
            want = fields | {"SoilCourantCapHit"} | ({"ChanQAvg"} & set(d) if loud else set())
            host = self._timed("to_host", to_host, {k: d[k] for k in want})
            self._warn_soil_cap(bool(host["SoilCourantCapHit"]))
            self._timed("report", self.outputs.report, step, date, host, monthend, yearend,
                        step == end)
            if loud:
                dis = self._loud_dis(host)
                line = "%-6i %20s" % (step, date.strftime("%d/%m/%Y %H:%M"))
                if dis is not None:
                    line += " %10.2f" % dis
                print(line, flush=True)
            elif progress:
                print(f"\r{step} - {date:%d/%m/%Y %H:%M}", end="", flush=True)
            if debug:
                self._debug_state(os.path.join(settings.output_dir, f"Debug_out_{step}.txt"),
                                  d.get("ChanM3"))
        if progress and not loud:
            print()
        self._capture_apart(runner)
        self.state = self.step.natural_state(runner.keep(self.state))
        self.close()
        return self.state


def lisfloodexe(settings, device=None):
    """Run orchestrator (reference main.py:56-157): pre-flight checkers,
    model build, then the deterministic run — or the MonteCarlo / EnKF
    ensemble when EnsMembers/FilterSteps are configured — honouring the
    -c/-i audit flags. `device` None is CUDA."""
    from ..config.checkers import check_meteo_forcings, check_modules_inputs

    flags = settings.flags
    check_modules_inputs(settings)
    check_meteo_forcings(settings)
    runner = LisfloodRunner(settings, device=device)

    if flags.get("checkfiles"):
        # -c: per-map statistics audit, no model run (zusatz.py:49-113)
        rows = runner.aux["loader"].check_rows
        print(f"{'Name':20s} {'File/Value':40s} {'nonMV':>10s} {'MV-in-mask':>10s} "
              f"{'min':>12s} {'mean':>12s} {'max':>12s}")
        for name, value, n, miss, vmin, vmean, vmax in rows:
            fmt = lambda v: f"{v:12.4g}" if isinstance(v, float) else f"{v:>12}"
            print(f"{name:20s} {value[-40:]:40s} {n!s:>10s} {miss!s:>10s} "
                  f"{fmt(vmin)} {fmt(vmean)} {fmt(vmax)}")
        return runner

    if flags.get("initonly"):
        print("initonly flag activated... Stopping now before entering time loop.")
        return runner

    # MonteCarlo/EnKF wrap is gated on the OPTIONS, not on EnsMembers —
    # templates carry EnsMembers=2 by default and the reference still runs
    # deterministically unless MonteCarlo/EnKF is switched on
    # (settings.py:404-410, main.py:98-115)
    init = settings.options.get("InitLisflood")
    mc_set = bool(settings.options.get("MonteCarlo")) and not init
    enkf_set = bool(settings.options.get("EnKF")) and not init
    if (mc_set or enkf_set) and settings.ens_members > 1:
        from .ensemble import run_from_settings
        runner.ensemble = run_from_settings(runner, settings)
    elif flags.get("loud") or flags.get("debug"):
        # per-step diagnostics need host visibility of every step
        runner.run(progress=not settings.flags.get("veryquiet"))
    else:
        # the production path: chunks of days, one host copy per chunk
        runner.run_scanned(progress=not settings.flags.get("veryquiet"))
    return runner
