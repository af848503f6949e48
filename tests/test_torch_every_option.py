"""Every option that build_model reads from maps, from a catchment on disk:
the port (lisflood_tpu_torch) against the JAX package on the same files.

models/synthetic.write_catchment writes each option's inputs (rice,
polders, pF, water levels, groundwater smoothing, water regions, the
average-year demand, drained irrigation, temperature in kelvin,
transmission loss, beside inflow, water use, the indicators, transient
land use and the variable water fraction) and, with `outputs`, binds the
reports those options switch on (`option_reports`). Held here on a 48x40
catchment, 6 days from 28/12/1999 (a month end and a year end):
  - what the inputs make the model do: every phase of the rice calendar
    falls in the run, the water regions' ldd cut runs both of its branches
    (the region outlets and the cells where the channel leaves a region);
  - the climatology indexer of both packages across a year end;
  - both production runs with every option on (`main([settings, "-v"])`
    in float64, `lisfloodexe` in float32 against the JAX per-step run):
    the same files, TSS and maps, the end state, and a file set equal to
    what the registry's activation rule predicts (`expected_outputs`);
  - report gating: combinations of report options, each writing exactly
    the registry's files in both packages;
  - the read paths: a netCDF MaskMap, the "ncols nrows cellsize west
    north" mask string, netCDF inputs with x descending, and the
    average-year stack selection of the map loader;
  - the faults of the JAX package found on these paths (ROADMAP.md
    Queue 3).
The per-option build_model cases are OPTION_INPUTS of
tests/test_torch_build_model.py.

Gates: float64 within 1e-10 of each field's max; float32 within 1.5e-4
after several steps (tests/test_torch_options.py, :206), Sideflow1Chan
within 1e-2, CrossSection2Area on the Chan2M3Kin/4000 scale, TransCum on
the volume the largest discharge passes in a routing sub-step and the two
mass-balance residuals on their totals (tests/test_torch_options.py::
_f32_scales). The JAX runs take RoutingPipeline "substeps", as
tests/test_torch_driver.py's do."""
import dataclasses
import datetime
import os
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

import lisflood_tpu.main as jax_main_module
from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.config.settings import _build_report_dicts as jax_build_report_dicts
from lisflood_tpu.io import forcing as jax_forcing
from lisflood_tpu.io.loadmap import MapLoader as JaxMapLoader
from lisflood_tpu.io.ncdf import NcFile as JaxNcFile
from lisflood_tpu.models.driver import LisfloodRunner as JaxRunner
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.utils.errors import LisfloodError as JaxLisfloodError
from lisflood_tpu_torch import main as port_main
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.config.settings import _build_report_dicts
from lisflood_tpu_torch.io import csf, forcing
from lisflood_tpu_torch.io.loadmap import MapLoader
from lisflood_tpu_torch.io.ncdf import NcFile
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import HostForcing, lisfloodexe
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.synthetic import (EVERY_OPTION, EVERY_OPTION_INPUTS, UNREPORTED,
                                                 expected_outputs, rice_calendars,
                                                 write_catchment)
from lisflood_tpu_torch.utils.errors import LisfloodError, LisfloodWarning
from test_torch_build_model import _same_arrays
from test_torch_driver import JAX_PIPELINE, _held, _pair, _tss_header, held_outputs

DAYS = 6
START = datetime.date(1999, 12, 28)

@pytest.fixture(scope="module")
def every_option(tmp_path_factory):
    """The catchment with every option and report on, netCDF-4 meteo (the
    JAX package's command line takes netCDF meteo only)."""
    return write_catchment(tmp_path_factory.mktemp("every"), 48, 40, seed=3, n_steps=DAYS,
                           options=EVERY_OPTION, outputs=True, start=START,
                           meteo_format="netcdf")


@pytest.fixture(scope="module")
def port_model(every_option):
    settings = load_settings(every_option)
    return settings, build_model(settings)


def test_every_option_inputs(every_option, port_model):
    """What write_catchment's inputs make the model do: the options are on;
    every phase of the rice calendar falls on a day of the run on some rice
    cell, and each calendar gives a phase; the polders sit on channel cells
    with their areas; the water regions' cut marks outlets by upstream area
    that are not the region's pits, and cells where the channel leaves a
    region (each branch of models/initial.py's cut runs); the demand stacks
    are one average year of another year; the temperature is in kelvin."""
    settings, (cfg, params, state, aux) = port_model
    assert cfg.rice_irrigation and cfg.simulate_polders and cfg.simulate_pf
    assert cfg.simulate_water_levels and cfg.groundwater_smooth and cfg.water_use_region
    assert cfg.water_demand_ave_year and cfg.drained_irrigation and cfg.temperature_in_kelvin
    assert cfg.trans_loss and cfg.rep_average_dis and cfg.num_wregions == 7

    # the rice phases (riceirrigation.py:78-179), day by day of the run
    days = [(START + datetime.timedelta(days=i)).timetuple().tm_yday for i in range(DAYS)]
    assert days == [362, 363, 364, 365, 1, 2]
    pl, ha = params["RicePlantingDay1"], params["RiceHarvestDay1"]
    rice = params["RiceFraction"] > 0
    assert 0.1 < rice.mean() < 0.6 and (params["OtherFraction"] >= 0).all()
    before = lambda d0, n: np.where(d0 - n < 0, 365 + d0 - n, d0 - n)
    seen = set()
    for day in days:
        phases = {"saturation": (before(pl, 20) <= day) & (day < before(pl, 10)),
                  "flooding": (before(pl, 10) <= day) & (day < pl),
                  "growing": (pl <= day) & (day < before(ha, 20)),
                  "drainage": (before(ha, 10) <= day) & (day < ha)}
        seen |= {k for k, v in phases.items() if (v & rice).any()}
    assert seen == {"saturation", "flooding", "growing", "drainage"}
    pairs = {(float(a), float(b)) for a, b in zip(pl[rice], ha[rice])}
    assert pairs == {(float(a), float(b)) for a, b in rice_calendars(days)}

    # polders on the channels, their areas from the table
    assert params["IsPolder"].sum() == 3 and params["IsChannel"][params["IsPolder"]].all()
    assert (params["PolderArea"][params["IsPolder"]] > 1e5).all()
    assert np.allclose(state["PolderStorageM3"], 0.5 * params["PolderArea"])

    # the region cut's two branches, recomputed from its definition
    region = params["WUseRegionC"]
    assert set(np.unique(region)) == set(range(1, 7))
    graph = aux["graph_chan"]
    pits = params["AtLastPointC"]
    up = params["UpArea"]
    outlet = np.zeros(len(region), bool)
    for r in range(1, 7):
        outlet |= (region == r) & (up == up[region == r].max())
    down = graph.downstream
    leaves = (down >= 0) & (region != region[np.maximum(down, 0)])
    marked = params["WaterRegionOutflowPoints"]
    assert np.array_equal(marked, pits | outlet | leaves)
    assert (outlet & ~pits).any() and (leaves & ~pits & ~outlet).any()
    assert params["WaterRegionInflowPoints"].any()
    assert (params["downWRegion"] != params["downstruct"]).any()

    # the demands: twelve maps dated 2010, read across the year end
    src = HostForcing(settings, cfg, aux)
    try:
        assert src.demand["DomesticDemandMM"].index_map == [11, 11, 11, 11, 0, 0]
        tavg = np.stack([src(i, d)["Tavg"] for i, d in enumerate(src.dates)])
    finally:
        src.close()
    assert 268.0 < tavg.min() and tavg.max() < 293.2


def test_climatology_index_map(every_option):
    """The climatology indexer of both packages (`_map_dates_index`, the
    file's and the run's dates moved to 2020): a run across a year end and
    a leap day against a monthly average year of 2010 takes December, then
    January; February 29 of a leap year takes February. Both packages'
    ForcingReader give the demand stack of the catchment the same index
    map and the same maps."""
    files = [datetime.datetime(2010, m, 1) for m in range(1, 13)]
    dates = [datetime.datetime(1999, 12, 28) + datetime.timedelta(days=i) for i in range(6)]
    dates += [datetime.datetime(2000, 2, 28), datetime.datetime(2000, 2, 29),
              datetime.datetime(2000, 3, 1), datetime.datetime(2001, 12, 31)]
    want = [11] * 4 + [0] * 2 + [1, 1, 2, 11]
    for module in (forcing, jax_forcing):
        assert module._map_dates_index(dates, files, "ffill", True) == want
        with pytest.raises(LisfloodError if module is forcing else Exception):
            module._map_dates_index(dates, files, "ffill", False)
    settings = load_settings(every_option)
    _, _, _, aux = build_model(settings)
    path = settings.binding["DomesticDemandMaps"]
    run = dates[:6]
    port = forcing.ForcingReader(path, aux["grid"], run, indexer="ffill", climatology=True)
    jax = jax_forcing.ForcingReader(path, aux["grid"], run, indexer="ffill", climatology=True)
    try:
        assert port.index_map == jax.index_map == [11, 11, 11, 11, 0, 0]
        for i in range(6):
            assert np.array_equal(port[i], np.asarray(jax[i]))
    finally:
        port.close()
        jax.close()


def _f32_scales(state):
    """The float32 scales that are not a field's own max (the module's
    docstring)."""
    q = np.abs(np.asarray(state["ChanQ"], np.float64)).max()
    return {"CrossSection2Area": np.abs(np.asarray(state["Chan2M3Kin"])).max() / 4000.0,
            "TransCum": q * 86400.0 / 24,
            "MBError": np.abs(np.asarray(state["WaterInit"])).max(),
            "MBErrorSplitRoutingM3": np.abs(np.asarray(state["StorageStepINIT"])).max()}


def _held_f32_outputs(jax_dir, port_dir, state, catch_area):
    """held_outputs of tests/test_torch_driver.py in float32, with the
    mass-balance TSS on the scale of the totals they are residuals of
    (tests/test_torch_options.py::_f32_scales): mbError on WaterInit,
    mbErrorMM on 1000 WaterInit / CatchArea, mbErrorStorage (MBError /
    WaterInit) on 1, mbErrorSplitRouting on StorageStepINIT."""
    water = np.abs(np.asarray(state["WaterInit"], np.float64))
    scales = {"mbError": water.max(), "mbErrorMM": (1000.0 * water / catch_area).max(),
              "mbErrorStorage": 1.0, "mbErrorSplitRouting": _f32_scales(state)[
                  "MBErrorSplitRoutingM3"]}
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    for name in names:
        a, b = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        key = name.split(".")[0]
        if key in scales:
            assert _tss_header(a) == _tss_header(b), name
            (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
            assert ia == ib and np.array_equal(sa, sb), name
            err = np.abs(da - db).max() / scales[key]
            assert err <= 1.5e-4, f"{name}: {err:.3e}"
        else:
            _held_file(a, b, key, state)
    return names


def _held_file(a, b, key, state):
    """One output file of each package within the float32 gates of
    tests/test_torch_driver.py::_gate."""
    if a.endswith(".tss"):
        assert _tss_header(a) == _tss_header(b), a
        (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
        assert ia == ib and np.array_equal(sa, sb), a
        _held(key, da, db, True)
    else:
        ma, mb = csf.read_map(a), csf.read_map(b)
        assert np.array_equal(ma.mv_mask, mb.mv_mask), a
        _held(key, np.where(ma.mv_mask, np.nan, ma.data), np.where(mb.mv_mask, np.nan, mb.data),
              True, state)


def _held_state(jax_state, port_state, f32):
    assert set(jax_state) == set(port_state)
    scales = _f32_scales(jax_state) if f32 else {"CrossSection2Area": _f32_scales(jax_state)[
        "CrossSection2Area"]}
    tol = 1.5e-4 if f32 else 1e-10
    for k, v in jax_state.items():
        ref = np.asarray(v, np.float64)
        got = port_state[k].numpy().astype(np.float64)
        assert np.array_equal(np.isnan(ref), np.isnan(got)), k
        scale = scales.get(k, max(float(np.nanmax(np.abs(ref))) if ref.size else 0.0, 1e-30))
        err = np.nanmax(np.abs(ref - got)) / scale if ref.size else 0.0
        assert err <= (1e-2 if f32 and k == "Sideflow1Chan" else tol), f"{k}: {err:.3e}"


def _command_line_copy(path, out_dir, xml):
    """`path`'s settings with its PathOut `out_dir` and the JAX package's
    sequential sub-step loop, written to `xml`."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r'name="PathOut" value="[^"]*"', f'name="PathOut" value="{out_dir}"', text)
    text = text.replace("<lfbinding>", '<lfbinding>\n  <textvar name="RoutingPipeline" '
                        'value="substeps"/>')
    with open(xml, "w") as fh:
        fh.write(text)


@pytest.mark.parametrize("case", ["command line, float64", "float32"])
def test_every_option_run(every_option, tmp_path, monkeypatch, case):
    """The production run with every option on, 6 days across a year end:
    in float64 through both command lines (`main([settings, "-v"])`) into
    the same PathOut in turn; in float32 (Precision single) the port's
    lisfloodexe against the JAX runner's per-step run. The same file names,
    TSS headers and rows, maps and end state within the gates, and the
    file set is the registry rule's (expected_outputs)."""
    out = str(tmp_path)
    f32 = case == "float32"
    if f32:
        js, ts = _pair(every_option, out, vars_to_set={"Precision": "single"}, sys_args=["-v"])
        jax_runner = JaxRunner(js)
        jax_runner.run()
        port_runner = lisfloodexe(ts, device="cpu")
        assert port_runner.dtype == torch.float32
        dirs = js.output_dir, ts.output_dir
    else:
        out_dir = os.path.join(out, "out")
        os.makedirs(out_dir)
        xml = os.path.join(out, "settings.xml")
        _command_line_copy(every_option, out_dir, xml)
        runners = {}
        for key, module in (("jax", jax_main_module), ("port", port_main)):
            run = module.lisfloodexe
            monkeypatch.setattr(module, "lisfloodexe",
                                lambda *a, _run=run, _key=key, **k:
                                runners.setdefault(_key, _run(*a, **k)))
        assert jax_main_module.main([xml, "-v"]) == 0
        shutil.move(out_dir, out_dir + "_jax")
        os.makedirs(out_dir)
        assert port_main.main([xml, "-v"], device="cpu") == 0
        jax_runner, port_runner = runners["jax"], runners["port"]
        assert port_runner.dtype == torch.float64
        dirs = out_dir + "_jax", out_dir
        ts = port_runner.settings
    if f32:
        names = _held_f32_outputs(*dirs, jax_runner.state, port_runner.params_np["CatchArea"])
    else:
        names = held_outputs(*dirs, False, jax_runner.state)
    assert set(names) == expected_outputs(ts)
    # the option reports are there: indicators at the month end, pF maps
    # every day, water levels and polder levels
    assert {"WaterLevelTS.tss", "PolderLevelTS.tss", "PF1AvUpsTS.tss", "watersec.004",
            "regionmo.004", "upstream.004", "pf1other.006", "totalwat.006",
            "polderlevelend.map", "totalpad.006"} <= set(names)
    state = port_runner.state
    for k in ("TransCum", "PaddyRiceWaterAbstractionFromSurfaceWaterM3", "avgdis",
              "PolderStorageM3", "wateruseCum"):
        assert np.abs(state[k].numpy()).max() > 0, k
    _held_state(jax_runner.state, state, f32)


# report options, each combination with every other report option off
GATING = {"water use and totals": ("repWaterUse", "repTotalWaterStorageMaps"),
          "indicators and abstractions": ("repWIndex", "repWaterUse", "repTotalAbs"),
          "pF, water levels and polders": ("repPFMaps", "repPFUpsGauges", "repWaterLevelTs",
                                           "repsimulatePolders", "repEndMaps")}


def _gated(load, path, out_dir, reports):
    """`path`'s settings loaded by `load`, the two days up to the year end,
    netCDF outputs into `out_dir`, the report options `reports` on and
    every other off (tests/test_options.py:182-190)."""
    s = load(path, opts_to_set=["writeNetcdf"],
             vars_to_set={"PathOut": out_dir, "StepStart": "30/12/1999 00:00",
                          "StepEnd": "31/12/1999 00:00", **JAX_PIPELINE})
    for name, on in list(s.options.items()):
        if name.startswith("rep"):
            s.options[name] = name in reports
    return s


@pytest.mark.parametrize("case", list(GATING))
def test_report_gating(every_option, tmp_path, case):
    """Each combination of report options writes exactly the files that the
    registry's activation rule predicts (expected_outputs, the rule of
    tests/test_options.py:158-201: a report option on, its restrictoptions
    on, its binding set), with netCDF outputs, over two days that end a
    month: the port's run and the JAX package's, the same file set."""
    reports = GATING[case]
    names = {}
    for pkg, load, rebuild, exe in (("jax", jax_load_settings, jax_build_report_dicts,
                                     jax_lisfloodexe),
                                    ("port", load_settings, _build_report_dicts,
                                     lambda s: lisfloodexe(s, device="cpu"))):
        out_dir = str(tmp_path / pkg)
        os.makedirs(out_dir)
        s = _gated(load, every_option, out_dir, reports)
        rebuild(s)
        exe(s)
        names[pkg] = set(os.listdir(out_dir))
        if pkg == "port":
            expected = expected_outputs(s)
    assert names["jax"] == names["port"] == expected
    assert all(n.endswith((".nc", ".tss")) for n in expected)
    # each report option of the combination writes files of its own
    for report in reports:
        s.options[report] = False
        assert expected_outputs(s) < expected, report
        s.options[report] = True


# ---------------------------------------------------------------------------
# read paths


@pytest.fixture(scope="module")
def read_paths(tmp_path_factory):
    """The same 48x40 catchment (every physics option, netCDF-4 meteo)
    written four ways: as it is, with a netCDF MaskMap, with the mask
    string, and with every netCDF file's x axis descending."""
    root = tmp_path_factory.mktemp("read")
    kw = dict(seed=4, n_steps=3, options=EVERY_OPTION_INPUTS, start=START,
              meteo_format="netcdf")
    return {k: write_catchment(root / k.replace(" ", "_"), 48, 40, **kw, **extra)
            for k, extra in (("map", {}), ("netcdf mask", {"mask_format": "netcdf"}),
                             ("mask string", {"mask_format": "string"}),
                             ("x descending", {"lon_descending": True}))}


@pytest.mark.parametrize("case", ["netcdf mask", "mask string"])
def test_mask_forms(read_paths, case):
    """A netCDF MaskMap and the "ncols nrows cellsize west north" string
    (io/grid.py::build_grid): both packages' build_models agree bit for
    bit, and the port's is the PCRaster mask's, bit for bit."""
    path = read_paths[case]
    binding = load_settings(path).binding["MaskMap"]
    assert binding.endswith("MaskMap.nc") if case == "netcdf mask" else \
        binding == "40 48 5000.0 2500000.0 5500000.0"
    port = build_model(load_settings(path))
    _same_arrays(jax_build_model(jax_load_settings(path)), port)
    _same_arrays(port, build_model(load_settings(read_paths["map"])))
    assert port[3]["grid"].num_pixels == port[0].num_pixels == 1852


def test_x_descending(read_paths):
    """netCDF inputs whose x axis runs east to west, flipped on read
    (io/loadmap.py::_normalize_xy, the forcing reader's flip_x): the port's
    build_model and every day's forcing are those of the x-ascending files,
    bit for bit, and so are the JAX package's forcing and its model but
    LAIX. The JAX build_model reads the LAI stacks without flipping them,
    so its LAIX is mirrored east to west (ROADMAP.md Queue 3): the port
    flips them."""
    desc, asc = read_paths["x descending"], read_paths["map"]
    port = build_model(load_settings(desc))
    _same_arrays(port, build_model(load_settings(asc)))
    jax = jax_build_model(jax_load_settings(desc))
    stacks = ("LAIX", "varW")
    read = {k: jax[1].pop(k) for k in stacks}
    _same_arrays(jax, (None, {k: v for k, v in port[1].items() if k not in stacks},
                       port[2], None))
    grid = port[3]["grid"]
    mirror = lambda v: grid.compress(grid.decompress(v)[:, ::-1])
    for k, v in read.items():
        # the mirror of a land cell that is sea has no value in the model
        mirrored = np.apply_along_axis(mirror, -1, port[1][k])
        both = np.isfinite(mirrored)
        assert both.mean() > 0.9 and np.array_equal(v[both], mirrored[both]), k
        assert not np.array_equal(v, port[1][k]), k

    js = jax_load_settings(desc, vars_to_set=JAX_PIPELINE)
    runner = JaxRunner(js)
    src = HostForcing(load_settings(asc), port[0], port[3])
    try:
        for i, date in enumerate(src.dates):
            ref, got = src(i, date), runner.forcing_for(i, date)
            for k in ("Precipitation", "Tavg", "ETRef", "EWRef", "DomesticDemandMM",
                      "ForestFraction_t"):
                assert np.array_equal(ref[k], np.asarray(got[k])), (date, k)
    finally:
        src.close()
        runner.close()


@pytest.mark.parametrize("flag", ["closest", "exact"])
def test_average_year_stack_selection(every_option, flag):
    """The map loader's average-year selection (`_select_stack_step(...,
    averageyearflag=True)`, io/loadmap.py), which no build path of either
    package calls: on the catchment's demand stack (twelve monthly maps of
    2010) with timestepInit a date of 1999 or 2000, the date moves to the
    stack's year; "closest" takes the map at or before it, "exact" the map
    of that day or an error. Both packages' loaders select the same map."""
    cases = {"30/12/1999 00:00": 11, "01/03/2000 00:00": 2, "29/02/2000 00:00": 1}
    for init, index in cases.items():
        picked = []
        for load, loader, nc_file in ((load_settings, MapLoader, NcFile),
                                      (jax_load_settings, JaxMapLoader, JaxNcFile)):
            s = load(every_option, vars_to_set={"timestepInit": init})
            _, _, _, aux = build_model(load_settings(every_option))
            ld = loader(s, aux["grid"])
            with nc_file(s.binding["DomesticDemandMaps"]) as nc:
                var = nc.main_variable()
                want = np.asarray(nc.read(var, index=index))
                try:
                    picked.append(np.asarray(ld._select_stack_step(nc, var, flag, True)))
                except (LisfloodError, JaxLisfloodError):
                    picked.append(None)
        if flag == "exact" and init != "01/03/2000 00:00":
            assert picked == [None, None], init
        else:
            for got in picked:
                assert np.array_equal(got, want, equal_nan=True), init


# ---------------------------------------------------------------------------
# faults of the JAX package on these paths


# (outputs left out, the settings that bind them and switch them on)
UNAVAILABLE = {
    "no step computes them": (UNREPORTED, dict(
        opts_to_set=["repwateruseGauges"],
        vars_to_set={k: f"$(PathOut)/unrep{i}" for i, k in enumerate(UNREPORTED)})),
    "repWIndex without repWaterUse": (
        ("abstraction_allSources_actual_irrigation_M3MonthRegion",
         *(f"consumption_{k}_M3MonthRegion" for k in (
             "actual_irrigation", "required_domestic", "required_energy", "required_industry",
             "required_irrigation", "required_livestock"))),
        dict(opts_to_unset=["repWaterUse"]))}


@pytest.mark.parametrize("case", list(UNAVAILABLE))
def test_unavailable_outputs(every_option, tmp_path, case):
    """Outputs of the registry that read a field the step does not compute,
    bound and switched on, two days to a month end: the ones no step
    computes (synthetic.UNREPORTED: WaterUseTS's WUseSumM3, PolderFluxTS's
    PolderFlux, four maps of repTotalAbs), and seven monthly region sums
    of repWIndex (abstraction_allSources_actual_irrigation and the six
    consumption_*_M3MonthRegion), whose restrictoptions do not ask for
    repWaterUse but whose fields both steps accumulate with repWaterUse
    only. The JAX package's run
    fails with a KeyError; the port leaves them out with a LisfloodWarning
    that names them and writes every other output: its file set is the
    registry rule's without theirs."""
    left_out, kw = UNAVAILABLE[case]
    kw = {**kw, "sys_args": ["-v"], "vars_to_set": {
        "StepStart": "30/12/1999 00:00", "StepEnd": "31/12/1999 00:00",
        **kw.get("vars_to_set", {})}}
    js, ts = _pair(every_option, str(tmp_path), **kw)
    with pytest.raises(KeyError):
        jax_lisfloodexe(js)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lisfloodexe(ts, device="cpu")
    said = " ".join(str(w.message) for w in caught if issubclass(w.category, LisfloodWarning))
    assert all(k in said for k in left_out), said
    kept = dataclasses.replace(ts, binding={k: v for k, v in ts.binding.items()
                                            if k not in left_out})
    expected, written = expected_outputs(ts), expected_outputs(kept)
    assert len(expected - written) >= len(left_out)
    assert set(os.listdir(ts.output_dir)) == written
