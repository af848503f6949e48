"""The port's host layers (lisflood_tpu_torch/config, io, utils) against the
JAX package's: both read the same files, written by the JAX package's
writers in tmp_path, and the reads are bitwise equal. netCDF content is also
written as netCDF classic with scipy.io.netcdf_file: the port reads that file
(through SciPy) and the netCDF-4 file (through h5py) to the same bits as the
JAX package's read of the netCDF-4 file. The card's machine has neither
pandas nor h5py: a subprocess that hides both imports the port, builds a
small catchment with classic netCDF and takes one step on the CPU."""
import dataclasses
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings as hyp_settings, strategies as st

from lisflood_tpu.config import calendar as jax_calendar
from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.io import csf as jax_csf
from lisflood_tpu.io import ncdf as jax_ncdf
from lisflood_tpu.io import tss as jax_tss
from lisflood_tpu.io.forcing import ForcingReader as JaxForcingReader
from lisflood_tpu.io.forcing import open_forcing_stack as jax_open_forcing_stack
from lisflood_tpu.io.grid import build_grid as jax_build_grid
from lisflood_tpu.io.loadmap import MapLoader as JaxMapLoader
from lisflood_tpu.io.tables import lookup_scalar as jax_lookup_scalar
from lisflood_tpu_torch.config import calendar
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io import csf, ncdf, tss
from lisflood_tpu_torch.io.forcing import ForcingReader, open_forcing_stack
from lisflood_tpu_torch.io.grid import build_grid
from lisflood_tpu_torch.io.loadmap import MapLoader
from lisflood_tpu_torch.io.tables import lookup_scalar
from lisflood_tpu_torch.utils.errors import LisfloodError

REPO = Path(__file__).resolve().parent.parent
NROWS, NCOLS, CELL, WEST, NORTH = 12, 10, 1000.0, 4000000.0, 3000000.0


def _same(a, b):
    """Same dtype, shape and bits, NaN-aware."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _mask(tmp_path):
    """A mask map with a missing corner, and the settings-free loader of
    both packages on it."""
    rng = np.random.default_rng(1)
    area = np.ones((NROWS, NCOLS), np.uint8)
    area[:3, :2] = 0
    path = str(tmp_path / "mask.map")
    jax_csf.write_map(path, area, WEST, NORTH, CELL, value_scale=jax_csf.VS_BOOLEAN)
    return path, rng


SCALES = [(jax_csf.VS_BOOLEAN, np.uint8, lambda r: r.integers(0, 2, (NROWS, NCOLS))),
          (jax_csf.VS_NOMINAL, np.int32, lambda r: r.integers(1, 9, (NROWS, NCOLS))),
          (jax_csf.VS_ORDINAL, np.int32, lambda r: r.integers(-5, 50, (NROWS, NCOLS))),
          (jax_csf.VS_SCALAR, np.float32, lambda r: r.normal(0, 100, (NROWS, NCOLS))),
          (jax_csf.VS_DIRECTION, np.float32, lambda r: r.uniform(0, 360, (NROWS, NCOLS))),
          (jax_csf.VS_LDD, np.uint8, lambda r: r.integers(1, 10, (NROWS, NCOLS)))]


@pytest.mark.parametrize("scale,dtype,draw", SCALES, ids=["boolean", "nominal", "ordinal",
                                                          "scalar", "direction", "ldd"])
def test_csf_maps(tmp_path, scale, dtype, draw):
    """A CSF map of each value scale, with missing cells, read by both
    packages' csf.read_map and MapLoader.load on a masked grid."""
    mask, rng = _mask(tmp_path)
    data = draw(rng).astype(dtype)
    missing = rng.random((NROWS, NCOLS)) < 0.1
    if np.dtype(dtype).kind == "f":
        # a float map may miss cells only outside the mask; an integer map's
        # missing cells inside it load as -9999
        missing[3:, :] = missing[:, 2:] = False
        missing[0, 0] = True
    path = str(tmp_path / "m.map")
    jax_csf.write_map(path, data, WEST, NORTH, CELL, value_scale=scale, mv_mask=missing)
    ref, got = jax_csf.read_map(path), csf.read_map(path)
    for f in dataclasses.fields(ref):
        _same(getattr(ref, f.name), getattr(got, f.name))
    binding = {"MaskMap": mask, "M": path}
    jset = type("S", (), {"binding": binding, "flags": {}, "timestep_init": None})()
    jgrid, grid = jax_build_grid(mask), build_grid(mask)
    for f in ("west", "north", "cell", "nrows", "ncols", "mask2d", "land_flat", "num_pixels"):
        _same(getattr(jgrid, f), getattr(grid, f))
    _same(JaxMapLoader(jset, jgrid).load("M"), MapLoader(jset, grid).load("M"))


def test_forcing_stack_pcraster(tmp_path):
    """A PCRaster stack through open_forcing_stack: each step's map, and a
    step without a map reusing the last one (sparse stacks)."""
    mask, rng = _mask(tmp_path)
    grid, jgrid = build_grid(mask), jax_build_grid(mask)
    prefix = str(tmp_path / "pr")
    for step in (3, 4, 6):
        jax_csf.write_map(str(tmp_path / f"pr000000.00{step}"),
                          rng.uniform(0, 10, (NROWS, NCOLS)).astype(np.float32), WEST, NORTH, CELL)
    dates = [datetime.datetime(2000, 1, 1) + datetime.timedelta(days=i) for i in range(4)]
    ref = jax_open_forcing_stack(prefix, jgrid, dates, first_step=3)
    got = open_forcing_stack(prefix, grid, dates, first_step=3)
    assert type(got).__name__ == "CsfStackReader"
    for i in range(4):
        _same(ref[i], got[i])
    _same(got[2], got[1])


def _nc_content(rng):
    x = WEST + CELL * (np.arange(NCOLS) + 0.5)
    y = NORTH - CELL * (np.arange(NROWS) + 0.5)
    data = rng.uniform(0, 50, (5, NROWS, NCOLS)).astype(np.float32)
    data[:, 0, 0] = -9999.0               # fill value
    data[1, 2, 3] = np.nan
    return x, y, np.arange(5, dtype=np.float64), data


@pytest.fixture
def nc_files(tmp_path):
    """The same content as netCDF-4 (JAX writer) and netCDF classic (SciPy):
    a 5-step stack over a projected x/y grid, with fill values."""
    from scipy.io import netcdf_file
    x, y, t, data = _nc_content(np.random.default_rng(2))
    units = "days since 2000-01-01 00:00:00"
    nc4 = str(tmp_path / "stack.nc")
    f = jax_ncdf.create_nc(nc4)
    jax_ncdf.add_dimension(f, "x", x, {"units": "m"})
    jax_ncdf.add_dimension(f, "y", y, {"units": "m"})
    jax_ncdf.add_dimension(f, "time", t, {"units": units, "calendar": "proleptic_gregorian"})
    jax_ncdf.add_variable(f, "pr", ("time", "y", "x"), "f4", fill_value=-9999.0,
                          attrs={"units": "mm"})[...] = data
    f.close()
    classic = str(tmp_path / "classic" / "stack.nc")
    os.makedirs(os.path.dirname(classic))
    with netcdf_file(classic, "w") as g:
        for name, values in (("x", x), ("y", y), ("time", t)):
            g.createDimension(name, values.size)
            g.createVariable(name, values.dtype, (name,))[:] = values
        g.variables["x"].units = "m"
        g.variables["y"].units = "m"
        g.variables["time"].units = units
        g.variables["time"].calendar = "proleptic_gregorian"
        v = g.createVariable("pr", "f4", ("time", "y", "x"))
        v[:] = data
        v._FillValue = np.float32(-9999.0)
        v.units = "mm"
    return nc4, classic


def test_netcdf_both_formats(tmp_path, nc_files):
    """NcFile on the netCDF-4 and the classic file, and the forcing reader
    and map loader on both, against the JAX package's reads of the
    netCDF-4 file: bitwise equal."""
    nc4, classic = nc_files
    with open(classic, "rb") as fh:
        assert fh.read(3) == b"CDF"
    mask, _ = _mask(tmp_path)
    jgrid, grid = jax_build_grid(mask), build_grid(mask)
    dates = [datetime.datetime(2000, 1, 1) + datetime.timedelta(days=i) for i in range(5)]
    with jax_ncdf.NcFile(nc4) as ref:
        want = {"main": ref.main_variable(), "dims": ref.spatial_dims,
                "x": ref.coord("x"), "y": ref.coord("y"), "fill": ref.fill_value("pr"),
                "all": ref.read("pr"), "slice": ref.read("pr", index=1),
                "t": ref.time_values(), "units": ref.time_units(), "cal": ref.time_calendar(),
                "dates": ref.time_dates(), "attrs": ref.attrs("pr")["units"]}
    jreader = JaxForcingReader(nc4, jgrid, dates, prefetch=0)
    jread = [jreader[i] for i in (0, 2, 4)]
    jreader.close()
    jset = type("S", (), {"binding": {"M": nc4}, "flags": {}, "timestep_init": None})()
    jmap = JaxMapLoader(jset, jgrid).load("M")
    for path in (nc4, classic):
        with ncdf.NcFile(path) as nc:
            got = {"main": nc.main_variable(), "dims": nc.spatial_dims,
                   "x": nc.coord("x"), "y": nc.coord("y"), "fill": nc.fill_value("pr"),
                   "all": nc.read("pr"), "slice": nc.read("pr", index=1),
                   "t": nc.time_values(), "units": nc.time_units(), "cal": nc.time_calendar(),
                   "dates": nc.time_dates(), "attrs": nc.attrs("pr")["units"]}
            assert nc.has_time and nc.has("pr") and set(nc.variables) == {"x", "y", "time", "pr"}
        for k in ("main", "dims", "units", "cal", "dates", "attrs"):
            assert got[k] == want[k], (path, k)
        for k in ("x", "y", "fill", "all", "slice", "t"):
            _same(want[k], got[k])
        reader = ForcingReader(path, grid, dates, prefetch=0)
        for i, ref in zip((0, 2, 4), jread):
            _same(ref, reader[i])
        reader.close()
        s = type("S", (), {"binding": {"M": path}, "flags": {}, "timestep_init": None})()
        _same(jmap, MapLoader(s, grid).load("M"))


def test_netcdf_refuses_other_files(tmp_path):
    """A file that is neither netCDF-4 nor classic raises LisfloodError; a
    missing one the file error."""
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"not a netCDF file")
    with pytest.raises(LisfloodError, match="neither"):
        ncdf.NcFile(str(bad))
    with pytest.raises(LisfloodError):
        ncdf.NcFile(str(tmp_path / "missing.nc"))


def test_tss_and_tables(tmp_path):
    """A TSS file written by the JAX writer, and a lookup table, read by
    both packages."""
    path = str(tmp_path / "dis.tss")
    w = jax_tss.TssWriter(path, [3, 7, 11], flush_every=2)
    rng = np.random.default_rng(3)
    for step in range(1, 6):
        w.sample(step, np.r_[rng.uniform(0, 1e3, 2), np.nan])
    w.flush()
    ref, got = jax_tss.read_tss(path), tss.read_tss(path)
    assert ref[0] == got[0]
    _same(ref[1], got[1])
    _same(ref[2], got[2])
    table = tmp_path / "lake.txt"
    table.write_text("# lake areas\n1 1.5e7\n2 2.25e7\n5 3e6\n")
    ids = np.array([0, 1, 2, 5, 2, 0])
    _same(jax_lookup_scalar(str(table), ids), lookup_scalar(str(table), ids))
    with pytest.raises(LisfloodError):
        lookup_scalar(str(table), np.array([4]))


SETTINGS_XML = """<?xml version="1.0" encoding="UTF-8"?>
<lfsettings>
<lfuser>
  <textvar name="PathRoot" value="{root}"/>
  <textvar name="PathMaps" value="{root}/maps"/>
  <textvar name="PathOut" value="{root}/out"/>
  <textvar name="ReportSteps" value="2,5..7,10+3..20,endtime"/>
  <textvar name="FilterSteps" value="3,6,endtime"/>
  <textvar name="EnsMembers" value="4"/>
</lfuser>
<lfoptions>
  <setoption choice="0" name="InitLisflood"/>
  <setoption choice="1" name="SplitRouting"/>
  <setoption choice="1" name="repMBTs"/>
  <setoption choice="1" name="wateruse"/>
</lfoptions>
<lfbinding>
  <textvar name="MaskMap" value="$(PathMaps)/mask.map"/>
  <textvar name="Ldd" value="$(PathMaps)/ldd.map"/>
  <textvar name="Nested" value="$(PathRoot)/x/$(PathMaps)"/>
  <textvar name="Unknown" value="$(NoSuchVar)/y"/>
  <textvar name="CalendarDayStart" value="01/01/1990 06:00"/>
  <textvar name="StepStart" value="02/01/1990 06:00"/>
  <textvar name="StepEnd" value="30"/>
  <textvar name="DtSec" value="86400"/>
  <textvar name="DtSecChannel" value="14400"/>
  <textvar name="beta" value="0.6"/>
</lfbinding>
</lfsettings>
"""


def test_settings(tmp_path):
    """A settings file with $(...) substitutions (nested, and one with no
    lfuser variable), CLI flags, report and filter steps, set and unset
    options and variable overrides: every field of both packages' Settings
    equal."""
    path = tmp_path / "settings.xml"
    path.write_text(SETTINGS_XML.format(root=tmp_path))
    kw = dict(sys_args=["-q", "--checkfiles", "-t", "--bogus"], opts_to_set=["simulateLakes"],
              opts_to_unset=["wateruse"], vars_to_set={"beta": "0.55", "RoutingKernel": "packed"})
    with pytest.warns(UserWarning, match="NoSuchVar"):
        ref = jax_load_settings(str(path), **kw)
    with pytest.warns(UserWarning, match="NoSuchVar"):
        got = load_settings(str(path), **kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(a, dict) and a and dataclasses.is_dataclass(next(iter(a.values()))):
            a = {k: dataclasses.asdict(v) for k, v in a.items()}
            b = {k: dataclasses.asdict(v) for k, v in b.items()}
        assert a == b, f.name
    assert got.binding["Nested"] == f"{tmp_path}/x/{tmp_path}/maps"
    assert got.options["simulateLakes"] and not got.options["wateruse"] and got.flags["quiet"]
    assert got.report_steps[:5] == [2, 5, 6, 7, 10] and got.step_start_int == 2


_DAY_FIRST_FORMS = ("%d/%m/%Y", "%d/%m/%Y %H:%M", "%d/%m/%Y %H:%M:%S", "%d-%m-%Y")
_ISO_FORMS = ("%Y-%m-%d", "%Y-%m-%d %H:%M", "%Y-%m-%d %H:%M:%S")


@hyp_settings(max_examples=300, deadline=None)
@given(st.datetimes(min_value=datetime.datetime(1900, 1, 1),
                    max_value=datetime.datetime(2100, 12, 31)).map(lambda d: d.replace(microsecond=0)),
       st.sampled_from(_DAY_FIRST_FORMS + _ISO_FORMS))
def test_parse_date_or_step(date, form):
    """The port parses the settings' date forms with datetime alone, as the
    JAX package does with pandas (dayfirst=True). pandas 3 reads an ISO
    date whose day is at most 12 with day and month swapped (1950-03-04 as
    3 April); the port reads every ISO date as year, month, day, and is held
    to the JAX package where the two readings coincide."""
    text = date.strftime(form)
    want = date if "%S" in form else date.replace(second=0)
    want = want if "%H" in form else want.replace(hour=0, minute=0)
    got = calendar.parse_date_or_step(text)
    assert got == want
    if form in _DAY_FIRST_FORMS or date.day > 12 or date.day == date.month:
        assert got == jax_calendar.parse_date_or_step(text)


@pytest.mark.parametrize("value", ["31/02/2000", "2000/01/02", "02.01.2000", "abc", "",
                                   "01/13/2000", "13-13-2000 10:00"])
def test_parse_date_refuses(value):
    """Other forms, and dates that do not exist, raise LisfloodError; a
    number is a step."""
    with pytest.raises(LisfloodError):
        calendar.parse_date_or_step(value)
    assert calendar.parse_date_or_step("12") == 12.0


def test_card_path_without_pandas_and_h5py(tmp_path, nc_files):
    """In a process where pandas and h5py cannot be imported, as on the
    card's machine: the port imports, builds the catchment of
    write_catchment with classic netCDF and takes one step on the CPU; a
    netCDF-4 file raises the LisfloodError that names h5py."""
    nc4, _ = nc_files
    code = f"""
import sys
sys.modules["pandas"] = None
sys.modules["h5py"] = None
import numpy as np, torch
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.io.ncdf import NcFile
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_multi_step
from lisflood_tpu_torch.models.synthetic import write_catchment
from lisflood_tpu_torch.utils.errors import LisfloodError
settings = load_settings(write_catchment({str(tmp_path / 'c')!r}, 24, 20, n_steps=1,
                                         nc_format="classic"))
cfg, params, state, aux = build_model(settings)
multi, _ = build_multi_step(cfg, params, aux, dtype=torch.float32, device="cpu")
f = to_device(meteo_forcing(settings, cfg, aux)[0], "cpu", torch.float32)
s, _ = multi.step(multi.prepare_state(state), f)
assert not multi.routers["tochan"].no_edges
assert all(bool(torch.isfinite(v).all()) for v in s.values() if v.is_floating_point())
try:
    NcFile({nc4!r})
except LisfloodError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("a netCDF-4 file opened without h5py")
bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", "h5py", "jax", "lisflood_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", cfg.num_pixels)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
