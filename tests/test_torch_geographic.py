"""The port on a geographic grid (lisflood_tpu_torch/io/grid.py, io/forcing.py,
io/ncdf.py, io/projection.py, io/loadmap.py, models/initial.py,
models/driver.py), against the JAX package on the CPU: a 48x40
write_catchment of 0.05 degree lat/lon cells with gridSizeUserDefined (the
PixelLengthUser and PixelAreaUser maps), gauges given as coordinate pairs,
netCDF-4 meteo whose window is 2 cells wider than the mask on every side
(meteo_margin=2) with latitude ascending, and the outputs bound.

Held:
  - build_model: both packages bit for bit; PixelLength and PixelArea are
    the user maps, not the grid's cell;
  - the meteo window: the port cuts the wider stacks and flips them to the
    mask's window bit for bit. The JAX package truncates the window's
    offset (Grid.cut_window, int of 1.9999999999999 is 1) and reads one row
    off, so its runs here read the same catchment written without the
    margin (the same values inside), where no cut is needed; the fault is
    in ROADMAP.md Queue 3 and test_cut_window shows it;
  - lisfloodexe, 4 days in float64 (writeNetcdf): the same files, TSS rows
    and netCDF maps within 1e-10 of each field's max, and the end state.
    The netCDF outputs carry lon/lat with degrees_east/degrees_north. The
    port also carries the template's grid mapping (wgs_1984,
    latitude_longitude) and names it in each variable's grid_mapping; the
    JAX package carries only a laea mapping (ROADMAP.md Queue 3);
  - the TSS at the coordinate gauges are those of the run with the gauge
    map (through the port's command line), bit for bit, and the coordinates
    land on the map's cells; a
    coordinate outside the mask raises LisfloodError in both packages;
  - MapsCaching (tests/test_caching.py:42-83): a second build adds no entry,
    hits the cache and gives the same arrays bit for bit; extract, clear and
    apply; nothing is cached with the binding off; both packages cache the
    same number of maps. The cache is keyed by the binding's path, so a file
    rewritten in place is served from the cache as first read, in both
    packages (as the reference's cache does: kept, ROADMAP.md Queue 3);
  - the loader's other host paths: -n (nancheck) warns of the missing cells
    of an integer map inside the mask, and remote_input_access retries a
    transient I/O error, fails fast on a missing file and re-raises an
    error that is not transient, in both packages
    (tests/test_caching.py:86-139, which skips without the reference
    data)."""
import errno
import os
import re
import warnings

import numpy as np
import pytest

from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.io.forcing import ForcingReader as JaxForcingReader
from lisflood_tpu.io.loadmap import MapLoader as JaxMapLoader
from lisflood_tpu.io.loadmap import MapsCache as JaxMapsCache
from lisflood_tpu.io.ncdf import NcFile as JaxNcFile
from lisflood_tpu.models.driver import LisfloodRunner as JaxRunner
from lisflood_tpu.models.driver import _gauges_from_coords as jax_gauges_from_coords
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.utils import retry as jax_retry
from lisflood_tpu.utils.errors import LisfloodError as JaxLisfloodError
from lisflood_tpu.utils.errors import LisfloodFileError as JaxLisfloodFileError
from lisflood_tpu.utils.errors import LisfloodWarning as JaxLisfloodWarning
from lisflood_tpu_torch import main as port_main
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io import csf
from lisflood_tpu_torch.io.forcing import ForcingReader, run_dates
from lisflood_tpu_torch.io.loadmap import MapLoader, MapsCache
from lisflood_tpu_torch.io.ncdf import NcFile
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import LisfloodRunner, _coord_pairs, _gauges_from_coords
from lisflood_tpu_torch.models.driver import lisfloodexe
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.synthetic import GEO_CELL, GEO_MAPPING, write_catchment
from lisflood_tpu_torch.utils import retry
from lisflood_tpu_torch.utils.errors import LisfloodError, LisfloodFileError, LisfloodWarning
from test_torch_build_model import _same_arrays
from test_torch_driver import JAX_PIPELINE, _held, _nc_attrs, _tss_header, held_state

DAYS = 4
GEO = dict(n_steps=DAYS, grid="geographic", gauges="coords", meteo_format="netcdf",
           lat_ascending=True, outputs=True)
MARGIN = 2
PACKAGES = {"jax": (jax_load_settings, jax_build_model, JaxMapsCache),
            "port": (load_settings, build_model, MapsCache)}


@pytest.fixture(scope="module")
def catchments(tmp_path_factory):
    """"margin": the meteo MARGIN cells wider than the mask; "window": the
    same catchment with the meteo on the mask's window."""
    root = tmp_path_factory.mktemp("geo")
    return {k: write_catchment(root / k, 48, 40, seed=0, meteo_margin=m, **GEO)
            for k, m in (("margin", MARGIN), ("window", 0))}


@pytest.fixture
def no_cache():
    """Both packages' MapsCache empty before and after the test: it is a
    class-level dict that outlives a run."""
    for cache in (MapsCache, JaxMapsCache):
        cache.clear()
    yield
    for cache in (MapsCache, JaxMapsCache):
        cache.clear()


def test_build_model(catchments):
    """Both build_models bit for bit; the pixel sizes are the user maps."""
    path = catchments["margin"]
    jmodel, tmodel = jax_build_model(jax_load_settings(path)), build_model(load_settings(path))
    _same_arrays(jmodel, tmodel)
    cfg, params, _, aux = tmodel
    grid = aux["grid"]
    assert grid.cell == GEO_CELL and grid.west == 5.0 and grid.north == 56.0
    maps = os.path.join(os.path.dirname(path), "maps")
    for key, name in (("PixelLength", "PixelLengthUser"), ("PixelArea", "PixelAreaUser")):
        user = grid.compress(csf.read_map(os.path.join(maps, name + ".map")).data)
        assert np.array_equal(params[key], user.astype(np.float64)), key
    # a degree-sized cell would be 0.05 m long: the user maps are metres,
    # and shrink to the north
    assert 3000 < params["PixelLength"].min() < params["PixelLength"].max() < 4500
    assert np.array_equal(params["MMtoM3"], 0.001 * params["PixelArea"])
    lat = np.degrees(params["lat_rad"])
    assert np.allclose(lat, 56.0 - GEO_CELL * (np.flatnonzero(grid.land_flat) // 40 + 0.5))


def test_cut_window(catchments):
    """Each forcing stack of the wider, latitude-ascending files read by the
    port is the window catchment's, bit for bit, and the JAX reader's of the
    window catchment. The JAX Grid.cut_window puts the wider window one row
    off (it truncates the quotient 1.9999999999999)."""
    settings = {k: load_settings(p) for k, p in catchments.items()}
    grid = build_model(settings["margin"])[3]["grid"]
    jgrid = jax_build_model(jax_load_settings(catchments["window"]))[3]["grid"]
    dates = run_dates(settings["margin"])
    for key in ("PrecipitationMaps", "TavgMaps", "E0Maps"):
        readers = [ForcingReader(settings["margin"].binding[key], grid, dates, prefetch=0),
                   ForcingReader(settings["window"].binding[key], grid, dates, prefetch=0),
                   JaxForcingReader(settings["window"].binding[key], jgrid, dates, prefetch=0)]
        try:
            assert readers[0].flip_y and readers[0].cut == (MARGIN, MARGIN + 40, MARGIN, MARGIN + 48)
            for i in range(DAYS):
                a, b, c = (np.asarray(r[i]) for r in readers)
                assert np.array_equal(a, b) and np.array_equal(a, c), (key, i)
        finally:
            for r in readers:
                r.close()
    with NcFile(settings["margin"].binding["PrecipitationMaps"]) as nc:
        x, y = np.sort(nc.coord("lon")), np.sort(nc.coord("lat"))[::-1]
    assert grid.cut_window(x, y) == (2, 42, 2, 50)
    assert jgrid.cut_window(x, y) == (2, 42, 1, 49)


@pytest.fixture(scope="module")
def runs(catchments, tmp_path_factory):
    """4 days in float64 with writeNetcdf: the JAX package on the window
    catchment, the port on the wider one, each into its own PathOut."""
    root = tmp_path_factory.mktemp("geo_runs")
    out = {k: os.path.join(root, k) for k in ("jax", "port")}
    for d in out.values():
        os.makedirs(d)
    js = jax_load_settings(catchments["window"], opts_to_set=["writeNetcdf"], sys_args=["-v"],
                           vars_to_set={**JAX_PIPELINE, "PathOut": out["jax"]})
    ts = load_settings(catchments["margin"], opts_to_set=["writeNetcdf"], sys_args=["-v"],
                       vars_to_set={"PathOut": out["port"]})
    return jax_lisfloodexe(js), lisfloodexe(ts, device="cpu"), out


def _nc_geo_held(a, b, state):
    """The JAX package's netCDF output `a` and the port's `b`: lon/lat
    coordinates in degrees, the same variables, attributes and values (within
    1e-10), and in the port's also the template's grid mapping."""
    mapping, attrs = GEO_MAPPING
    with JaxNcFile(a) as ja, NcFile(b) as pa:
        assert ja.spatial_dims == pa.spatial_dims == ("lon", "lat")
        assert sorted(pa.variables) == sorted(ja.variables + [mapping]), b
        assert _nc_attrs(pa, mapping) == attrs
        # the two runs read settings files of their own
        skip = ("date_created", "Source_Software", "settingsfile")
        assert _nc_attrs(ja, skip=skip) == _nc_attrs(pa, skip=skip)
        for name in ja.variables:
            extra = {}
            if name not in ("lon", "lat", "time"):
                extra = {"grid_mapping": mapping}
            assert {**_nc_attrs(ja, name), **extra} == _nc_attrs(pa, name), name
            x, y = np.asarray(ja.read(name)), np.asarray(pa.read(name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if x.dtype.kind == "f" and x.ndim >= 2:
                _held(name, x, y, False, state)
            else:
                assert np.array_equal(x, y), name
        for dim, units in (("lon", "degrees_east"), ("lat", "degrees_north")):
            assert _nc_attrs(pa, dim)["units"] == units


def _header(path):
    """A TSS header but its date and the settings file's directory."""
    return [re.sub(r"settingsfile: .*/", "settingsfile: ", line) for line in _tss_header(path)]


def test_lisfloodexe_against_jax(runs):
    """The same files; TSS headers (but their date and the settings file's
    directory: the JAX run reads the window catchment), steps and rows within
    1e-10; every netCDF output as _nc_geo_held holds it; the end state."""
    jax_runner, port_runner, out = runs
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["port"]))
    assert {"dis.tss", "lz.nc", "chanqend.nc"} <= set(names)
    for name in names:
        a, b = os.path.join(out["jax"], name), os.path.join(out["port"], name)
        if name.endswith(".tss"):
            assert _header(a) == _header(b), name
            (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
            assert ia == ib and np.array_equal(sa, sb), name
            _held(name, da, db, False)
        elif name.endswith(".nc"):
            _nc_geo_held(a, b, jax_runner.state)
    held_state(jax_runner.state, port_runner.state, False)


def test_coordinate_gauges(catchments, runs, tmp_path, monkeypatch):
    """The coordinates land on the gauge map's cells (in both packages), and
    the port's command line (`main([settings, "-v"])`) on a copy of the
    settings file with the gauge map writes the coordinate run's TSS, bit
    for bit, and ends in its state."""
    path = catchments["margin"]
    _, coord_runner, out = runs
    with open(path) as fh:
        text = fh.read()
    coord_binding = re.search(r'name="Gauges" value="([^"]*)"', text).group(1)
    text = text.replace(coord_binding, "$(PathMaps)/Gauges.map")
    text = re.sub(r'name="PathOut" value="[^"]*"', f'name="PathOut" value="{tmp_path}"', text)
    xml = os.path.join(os.path.dirname(path), "settings_gauge_map.xml")
    with open(xml, "w") as fh:
        fh.write(text)
    held = {}
    monkeypatch.setattr(port_main, "lisfloodexe",
                        lambda *a, _run=port_main.lisfloodexe, **k: held.setdefault(
                            "runner", _run(*a, **k)))
    assert port_main.main([xml, "-v"], device="cpu") == 0
    map_runner = held["runner"]
    assert map_runner.grid.cell == GEO_CELL and map_runner.device.type == "cpu"
    grid = coord_runner.grid
    coords = _coord_pairs(coord_binding)
    assert len(coords) == 6
    from_map = MapLoader(map_runner.settings, grid).load("Gauges")
    for place in (_gauges_from_coords, jax_gauges_from_coords):
        assert np.array_equal(place(coords, grid), np.where(from_map < 0, 0, from_map))
    tss = sorted(n for n in os.listdir(out["port"]) if n.endswith(".tss"))
    assert "dis.tss" in tss and tss == sorted(n for n in os.listdir(tmp_path) if n.endswith(".tss"))
    for name in tss:
        (ia, da, sa), (ib, db, sb) = read_tss(os.path.join(out["port"], name)), \
            read_tss(os.path.join(tmp_path, name))
        assert ia == ib and np.array_equal(sa, sb) and np.array_equal(da, db), name
    assert len(read_tss(os.path.join(tmp_path, "dis.tss"))[0]) == 3
    held_state({k: v.numpy() for k, v in map_runner.state.items()}, coord_runner.state, False)


@pytest.mark.parametrize("where", ["west of the grid", "south of the grid"])
def test_bad_coordinates(catchments, tmp_path, where):
    """A gauge coordinate outside the mask's window raises LisfloodError in
    both packages' runners."""
    x, y = {"west of the grid": (3.0, 55.0), "south of the grid": (6.0, 40.0)}[where]
    gauges = f"6.0 55.0 {x} {y}"
    for load, runner, error in ((jax_load_settings, JaxRunner, JaxLisfloodError),
                                (load_settings, lambda s: LisfloodRunner(s, device="cpu"),
                                 LisfloodError)):
        s = load(catchments["window"], vars_to_set={"PathOut": str(tmp_path), "Gauges": gauges})
        with pytest.raises(error, match="outside mask"):
            runner(s)


def _build(pkg, path, caching):
    load, build, _ = PACKAGES[pkg]
    return build(load(path, vars_to_set={"MapsCaching": "True" if caching else "False"}))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_maps_caching_roundtrip(catchments, no_cache, pkg):
    """A second build with MapsCaching adds no entry, hits the cache and
    builds the same arrays bit for bit; extract, clear and apply; a build
    from the applied snapshot hits it."""
    cache = PACKAGES[pkg][2]
    path = catchments["margin"]
    first = _build(pkg, path, True)
    n_cached = cache.size()
    assert n_cached > 20
    hits = cache.values_found()
    second = _build(pkg, path, True)
    assert cache.size() == n_cached and cache.values_found() > hits
    _same_arrays(first, second)
    snapshot = cache.extract()
    cache.clear()
    assert cache.size() == 0 and cache.values_found() == 0
    cache.apply(snapshot)
    assert cache.size() == n_cached
    third = _build(pkg, path, True)
    assert cache.values_found() > 0 and cache.size() == n_cached
    _same_arrays(first, third)


def test_maps_caching_both_packages(catchments, no_cache):
    """Both packages cache the same maps (the same number of entries and of
    hits over two builds), and nothing with MapsCaching off."""
    path = catchments["margin"]
    counts = {}
    for pkg, (_, _, cache) in PACKAGES.items():
        _build(pkg, path, False)
        assert cache.size() == 0
        _build(pkg, path, True)
        _build(pkg, path, True)
        counts[pkg] = (cache.size(), cache.values_found())
    assert counts["jax"] == counts["port"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_maps_caching_keyed_by_path(catchments, no_cache, tmp_path, pkg):
    """With MapsCaching, a map rewritten in place under the same binding is
    served as first read; without it the new values are read."""
    load, build, _ = PACKAGES[pkg]
    loader_cls = {"jax": JaxMapLoader, "port": MapLoader}[pkg]
    path = catchments["margin"]
    grid = build(load(path))[3]["grid"]
    file = str(tmp_path / "lzinit.map")

    def write(value):
        csf.write_map(file, np.full((48, 40), value, np.float32), grid.west, grid.north, grid.cell)

    def read(caching):
        s = load(path, vars_to_set={"LZInitValue": file,
                                    "MapsCaching": "True" if caching else "False"})
        return loader_cls(s, grid).load("LZInitValue")

    write(1.0)
    assert (read(True) == 1.0).all()
    write(2.0)
    assert (read(True) == 1.0).all()
    assert (read(False) == 2.0).all()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_nancheck(catchments, pkg):
    """-n: loading the gauge map, whose cells but the gauges' are missing,
    warns LisfloodWarning; without the flag it does not."""
    load, build, _ = PACKAGES[pkg]
    loader_cls, warning = {"jax": (JaxMapLoader, JaxLisfloodWarning),
                           "port": (MapLoader, LisfloodWarning)}[pkg]
    path = catchments["margin"]
    grid = build(load(path))[3]["grid"]
    gauges = {"Gauges": "$(PathMaps)/Gauges.map"}
    with pytest.warns(warning, match="NaN values in map Gauges"):
        loader_cls(load(path, sys_args=["-n"], vars_to_set=gauges), grid).load("Gauges")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loader_cls(load(path, vars_to_set=gauges), grid).load("Gauges")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_remote_input_access(tmp_path, monkeypatch, pkg):
    """Transient I/O errors are retried with a pause, a missing file fails
    at once with LisfloodFileError, a persistent transient error stops after
    MAX_READ_TRIALS with IOError from it, an error that is not transient
    re-raises at once."""
    module, file_error = {"jax": (jax_retry, JaxLisfloodFileError),
                          "port": (retry, LisfloodFileError)}[pkg]
    monkeypatch.setattr(module, "READ_PAUSE", 0.001)
    target = tmp_path / "data.bin"
    target.write_bytes(b"ok")
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) < 3:
            raise OSError(errno.ENETDOWN, "transient network error")
        return open(path, "rb").read()

    assert module.remote_input_access(flaky, str(target)) == b"ok" and len(calls) == 3
    with pytest.raises(file_error):
        module.remote_input_access(lambda p: open(p, "rb"), str(tmp_path / "nope.bin"))
    monkeypatch.setattr(module, "MAX_READ_TRIALS", 3)
    calls.clear()

    def down(path):
        calls.append(path)
        raise OSError(errno.ESTALE, "still down")

    with pytest.raises(IOError) as excinfo:
        module.remote_input_access(down, str(target))
    assert len(calls) == 3 and isinstance(excinfo.value.__cause__, OSError)
    calls.clear()

    def corrupt(path):
        calls.append(path)
        raise OSError("unable to open file (truncated file)")

    with pytest.raises(OSError, match="truncated"):
        module.remote_input_access(corrupt, str(target))
    assert len(calls) == 1
