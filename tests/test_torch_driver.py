"""The port's run driver (lisflood_tpu_torch/models/driver.py and main.py)
against the JAX package's, on catchments written by the port's
models/synthetic.write_catchment (48x40 cells, netCDF-4, the outputs bound):
the same settings file through both packages, each writing into its own
PathOut (or, for the command line, the same one in turn), on the CPU.

Held: the output files (names, TSS headers but their date, TSS rows, end
maps, the LZ state-map stack, netCDF variables and attributes), the end
state key by key, the -l lines, the -d dumps, the -c and -i output, and each
day's forcing of every option. Gates: float64 within 1e-10 of each field's
max; float32 within 1.5e-4 (after several steps) and Sideflow1Chan within
1e-2 (tests/test_pallas_routing.py:53-60,87-108). CrossSection2Area is the
difference of the second lane's storage and its start (both ~1e6 times
larger here, `Chan2M3Kin`): it is held on the Chan2M3Kin/4000 scale, as in
tests/test_torch_build_model.py, in both dtypes.

The JAX runs take its sequential sub-step scan (RoutingPipeline
"substeps", a binding the port does not read), as
tests/test_torch_build_model.py does: its reference path, and the quickest
to compile on the CPU.

The JAX package's run_scanned builds its multi-step in float64 whatever
Precision says and fails with Precision single; its float32 run here is its
per-step `run` (ROADMAP.md Queue 3). Its meteo checker takes netCDF stacks
only, so its runs read netCDF meteo, and the run with water use and inflow
(PCRaster meteo) calls its runner directly."""
import contextlib
import datetime
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.io.ncdf import NcFile as JaxNcFile
import lisflood_tpu.main as jax_main_module
from lisflood_tpu.models.driver import LisfloodRunner as JaxRunner
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu_torch import main as port_main
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.config.checkers import check_meteo_forcings
from lisflood_tpu_torch.io import csf
from lisflood_tpu_torch.io.ncdf import NcFile
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import LisfloodRunner, lisfloodexe
from lisflood_tpu_torch.models.initial import meteo_forcing
from lisflood_tpu_torch.models.synthetic import EVERY_OPTION_INPUTS, write_catchment
from lisflood_tpu_torch.utils.errors import LisfloodError

DAYS = 6
# the JAX package's sequential sub-step scan (a binding the port ignores)
JAX_PIPELINE = {"RoutingPipeline": "substeps"}
# every option whose forcing the driver adds to the meteo, in one catchment;
# the run starts on 28/12/1999, so it crosses a month end and a year end
OPTIONS = {"inflow": True, "wateruse": True, "TransientWaterDemandChange": True,
           "indicator": True, "TransientLandUseChange": True, "varfractionwater": True}
FORCING_CASES = {"every option": OPTIONS,
                 "static demand": {"wateruse": True, "inflow": True},
                 "every option from maps": EVERY_OPTION_INPUTS}


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """The main path's catchment, meteo as netCDF-4 stacks, outputs bound."""
    return write_catchment(tmp_path_factory.mktemp("driver"), 48, 40, seed=0, n_steps=DAYS,
                           outputs=True, meteo_format="netcdf")


def _quiet(fn, *args, **kw):
    """fn(*args, **kw) and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def _pair(path, out, **kw):
    """Both packages' settings of `path`, each writing into its own
    directory under `out`."""
    dirs = {pkg: os.path.join(out, pkg) for pkg in ("jax", "port")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    vars_to_set = kw.pop("vars_to_set", {})
    return (jax_load_settings(path, vars_to_set={**vars_to_set, **JAX_PIPELINE,
                                                 "PathOut": dirs["jax"]}, **kw),
            load_settings(path, vars_to_set={**vars_to_set, "PathOut": dirs["port"]}, **kw))


def _gate(key, ref, f32, state=None):
    """(scale, tolerance) of a field or output file `key`."""
    tol = 1.5e-4 if f32 else 1e-10
    if key in ("CrossSection2Area", "crosssection2end") and state is not None:
        return np.abs(np.asarray(state["Chan2M3Kin"])).max() / 4000.0, tol
    scale = max(float(np.nanmax(np.abs(ref))) if np.size(ref) else 0.0, 1e-30)
    if f32 and key in ("Sideflow1Chan", "chsideend"):
        return scale, 1e-2
    return scale, tol


def _held(key, ref, got, f32, state=None):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, key
    assert np.array_equal(np.isnan(ref), np.isnan(got)), key
    scale, tol = _gate(key, ref, f32, state)
    err = np.nanmax(np.abs(ref - got)) / scale if ref.size else 0.0
    assert err <= tol, f"{key}: {err:.3e} of its scale (tol {tol:g})"


def _tss_header(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    n = int(lines[1])
    return [re.sub(r" date: .*", "", lines[0])] + lines[1:2 + n]


def held_outputs(jax_dir, port_dir, f32, state):
    """The two directories hold the same file names, and each file's
    contents agree (TSS headers but their date, TSS rows and steps, maps
    with their missing values)."""
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert any(n.endswith(".tss") for n in names)
    for name in names:
        a, b = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        key = name.split(".")[0]
        if name.endswith(".tss"):
            assert _tss_header(a) == _tss_header(b), name
            (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
            assert ia == ib and np.array_equal(sa, sb), name
            _held(key, da, db, f32)
        elif name.endswith(".txt"):
            continue
        else:
            ma, mb = csf.read_map(a), csf.read_map(b)
            assert np.array_equal(ma.mv_mask, mb.mv_mask), name
            _held(key, np.where(ma.mv_mask, np.nan, ma.data), np.where(mb.mv_mask, np.nan, mb.data),
                  f32, state)
    return names


def held_state(jax_state, port_state, f32):
    assert set(jax_state) == set(port_state)
    for k, v in jax_state.items():
        _held(k, v, port_state[k].numpy(), f32, jax_state)


RUNS = ("command line, float64", "float32")


@pytest.mark.parametrize("case", RUNS)
def test_run_against_jax(catchment, tmp_path, monkeypatch, case):
    """The production run (run_scanned, 6 days, PCRaster maps, the TSS with
    repBal1's upstream totals and compound expressions): in float64 through
    both command lines (`main([settings, "-v"])`) into the same PathOut in
    turn, and in float32 (Precision single) through lisfloodexe against the
    JAX per-step run. The same files, TSS rows and maps within the gates,
    the end state."""
    out = str(tmp_path)
    if case == "float32":
        js, ts = _pair(catchment, out, opts_to_set=["repBal1"],
                       vars_to_set={"Precision": "single"}, sys_args=["-v"])
        jax_runner = JaxRunner(js)
        jax_runner.run()
        port_runner = lisfloodexe(ts, device="cpu")
        dirs = js.output_dir, ts.output_dir
        assert port_runner.dtype == torch.float32
    else:
        # the command line takes the settings file as it is: a copy with
        # repBal1 on and its own PathOut, which both packages write in turn
        out_dir = os.path.join(out, "out")
        os.makedirs(out_dir)
        with open(catchment) as fh:
            text = fh.read().replace("<lfoptions>",
                                     '<lfoptions>\n  <setoption choice="1" name="repBal1"/>')
        text = re.sub(r'name="PathOut" value="[^"]*"', f'name="PathOut" value="{out_dir}"', text)
        text = text.replace("<lfbinding>", '<lfbinding>\n  <textvar name="RoutingPipeline" '
                            'value="substeps"/>')
        xml = os.path.join(out, "settings.xml")
        with open(xml, "w") as fh:
            fh.write(text)
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
        dirs = out_dir + "_jax", out_dir
        jax_runner, port_runner = runners["jax"], runners["port"]
        assert port_runner.device.type == "cpu" and port_runner.dtype == torch.float64
    names = held_outputs(*dirs, case == "float32", jax_runner.state)
    assert {"dis.tss", "totalRunoffUps.tss", "evaOpenWaterUps.tss", "mbErrorMM.tss",
            "chanqend.map", "lz000000.006"} <= set(names)
    held_state(jax_runner.state, port_runner.state, case == "float32")


# HDF5 attributes of the dimension scales (object references)
_H5_SCALES = ("CLASS", "NAME", "REFERENCE_LIST", "DIMENSION_LIST")


def _nc_attrs(nc, name=None, skip=()):
    return {k: np.asarray(v).tolist() for k, v in nc.attrs(name).items()
            if k not in _H5_SCALES and k not in skip}


def _nc_held(a, b, scale=None, state=None):
    """Both packages' NcFile read the same variables, shapes, attributes
    (but the creation date and software) and values from `a` and `b`
    (`state` gives CrossSection2Area its scale, as in _gate)."""
    with JaxNcFile(a) as ja, NcFile(b) as pa:
        assert sorted(ja.variables) == sorted(pa.variables), a
        assert ja.spatial_dims == pa.spatial_dims and ja.has_time == pa.has_time
        skip = ("date_created", "Source_Software")
        assert _nc_attrs(ja, skip=skip) == _nc_attrs(pa, skip=skip)
        for name in ja.variables:
            assert _nc_attrs(ja, name) == _nc_attrs(pa, name), name
            x, y = np.asarray(ja.read(name)), np.asarray(pa.read(name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if x.dtype.kind == "f" and x.ndim >= 2:
                _held(name, x, y, False, state)
                if scale is not None:
                    assert np.nanmax(np.abs(x - y)) / scale <= 1e-10, name
            else:
                assert np.array_equal(x, y), name


def test_netcdf_outputs(catchment, tmp_path):
    """writeNetcdf: the end maps and the LZ stack as netCDF-4, 3 days in
    float64; every file read back by both packages' NcFile holds the same
    variables, dimensions, coordinates and attributes but the creation date
    and software, and the same values."""
    js, ts = _pair(catchment, str(tmp_path), opts_to_set=["writeNetcdf"], sys_args=["-v"],
                   vars_to_set={"StepEnd": "03/01/2000 00:00"})
    jax_runner = jax_lisfloodexe(js)
    port_runner = lisfloodexe(ts, device="cpu")
    names = sorted(os.listdir(js.output_dir))
    assert names == sorted(os.listdir(ts.output_dir))
    ncs = [n for n in names if n.endswith(".nc")]
    assert "lz.nc" in ncs and "chanqend.nc" in ncs and len(ncs) == 36
    for n in ncs:
        scale = _gate("crosssection2end", None, False, jax_runner.state)[0]
        _nc_held(os.path.join(js.output_dir, n), os.path.join(ts.output_dir, n),
                 scale if n == "crosssection2end.nc" else None)
    with NcFile(os.path.join(ts.output_dir, "lz.nc")) as nc:
        assert nc.read("lz").shape == (3, 48, 40)
    held_state(jax_runner.state, port_runner.state, False)


def _parse_dump(path):
    with open(path) as fh:
        return np.array([[float(v) for v in line.split()] for line in fh])


def test_loud_and_debug(catchment, tmp_path):
    """-l -d through lisfloodexe (the per-step `run`), 3 days in float64:
    the printed lines are equal, and so are the Debug_init / Debug_out dumps
    (columns: pixel, cross-section, second-lane cross-section, storages),
    parsed, within 1e-10."""
    js, ts = _pair(catchment, str(tmp_path), sys_args=["-l", "-d"],
                   vars_to_set={"StepEnd": "03/01/2000 00:00"})
    jax_runner, jax_out = _quiet(jax_lisfloodexe, js)
    port_runner, port_out = _quiet(lisfloodexe, ts, device="cpu")
    lines = port_out.splitlines()
    assert lines == jax_out.splitlines() and len(lines) == 3
    assert re.fullmatch(r"1 +01/01/2000 00:00 +\d+\.\d\d", lines[0])
    dumps = sorted(n for n in os.listdir(js.output_dir) if n.startswith("Debug_"))
    assert dumps == ["Debug_init_1.txt", "Debug_out_1.txt", "Debug_out_2.txt",
                     "Debug_out_3.txt"]
    assert dumps == sorted(n for n in os.listdir(ts.output_dir) if n.startswith("Debug_"))
    for n in dumps:
        a = _parse_dump(os.path.join(js.output_dir, n))
        b = _parse_dump(os.path.join(ts.output_dir, n))
        assert a.shape == b.shape and a.shape == (1851, 5), n
        assert np.array_equal(a[:, 0], b[:, 0])
        # the second lane's cross-section on its storage's scale
        scales = np.abs(a).max(0)
        scales[2] = scales[4] / 4000.0
        assert (np.abs(a - b).max(0) / np.maximum(scales, 1e-30) <= 1e-10).all(), n
    held_outputs(js.output_dir, ts.output_dir, False, jax_runner.state)
    held_state(jax_runner.state, port_runner.state, False)


@pytest.mark.parametrize("flag", ["-c", "-i"])
def test_checkfiles_and_initonly(catchment, tmp_path, flag):
    """-c prints the loader's table of the maps it read, -i stops before the
    time loop: both print the same as the JAX package, and run no step."""
    js, ts = _pair(catchment, str(tmp_path), sys_args=[flag])
    _, jax_out = _quiet(jax_lisfloodexe, js)
    _, port_out = _quiet(lisfloodexe, ts, device="cpu")
    assert port_out == jax_out
    assert len(port_out.splitlines()) > (20 if flag == "-c" else 0)
    assert os.listdir(ts.output_dir) == []


def test_prerun(catchment, tmp_path):
    """The InitLisflood prerun (lakes, reservoirs and repMBTs off), 6 days in
    float64: its end maps avgdis and lzavin (the bindings AvgDis and
    LZAvInflowMap, inputs of the main run, re-pointed under each PathOut)
    and its end state. The split routing's end maps are unbound: the prerun
    routes one lane and has no CrossSection2Area or Sideflow1Chan, which
    fails both packages' runs (ROADMAP.md Queue 3)."""
    out = str(tmp_path)
    maps = {"AvgDis": "avgdis.map", "LZAvInflowMap": "lzavin.map"}
    unbound = {"CrossSection2End": "", "ChSideEnd": ""}
    settings = []
    for pkg, load in (("jax", jax_load_settings), ("port", load_settings)):
        d = os.path.join(out, pkg)
        os.makedirs(d)
        settings.append(load(catchment, sys_args=["-v"],
                             opts_to_set=["InitLisflood", "repLZAvInflowMap"],
                             opts_to_unset=["simulateLakes", "simulateReservoirs", "repMBTs"],
                             vars_to_set={"PathOut": d, **unbound, **JAX_PIPELINE,
                                          **{k: os.path.join(d, v) for k, v in maps.items()}}))
    js, ts = settings
    jax_runner = jax_lisfloodexe(js)
    port_runner = lisfloodexe(ts, device="cpu")
    names = held_outputs(js.output_dir, ts.output_dir, False, jax_runner.state)
    assert {"avgdis.map", "lzavin.map"} <= set(names)
    held_state(jax_runner.state, port_runner.state, False)


@pytest.fixture(scope="module")
def options_catchments(tmp_path_factory):
    """Case -> settings path: a catchment with the case's options on, PCRaster
    meteo, 6 days from 28/12/1999, outputs bound."""
    return {case: write_catchment(tmp_path_factory.mktemp("options"), 48, 40, seed=1,
                                  n_steps=DAYS, outputs=True, options=opts,
                                  start=datetime.date(1999, 12, 28))
            for case, opts in FORCING_CASES.items()}


@pytest.mark.parametrize("case", list(FORCING_CASES))
@pytest.mark.parametrize("precision", ["double", "single"])
def test_forcing_for(options_catchments, tmp_path, case, precision):
    """forcing_for against the JAX runner's, key by key and every day, bit
    for bit and in the same dtype, for the options meteo_forcing refused
    before: inflow, water use with transient demand and the indicators
    (MonthEnd true once, on 31/12, and YearEnd), transient land use
    (`_t`, `_nt`), the variable water fraction; and the static demands;
    and every option that write_catchment writes inputs for, the demands as
    one average year (the climatology indexer across the year end) and the
    temperature in kelvin among them. meteo_forcing gives the same in
    float64."""
    js, ts = _pair(options_catchments[case], str(tmp_path), vars_to_set={"Precision": precision})
    jax_runner, port_runner = JaxRunner(js), LisfloodRunner(ts, device="cpu")
    host = meteo_forcing(ts, port_runner.config, port_runner.aux)
    ends = []
    try:
        for i, date in enumerate(port_runner.dates):
            ref, got = jax_runner.forcing_for(i, date), port_runner.forcing_for(i, date)
            assert set(ref) == set(got) == set(host[i])
            for k, v in ref.items():
                a, b = np.asarray(v), got[k].numpy()
                assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
                assert a.dtype == b.dtype or a.dtype.kind == "i", k
                assert np.array_equal(a, b), (date, k)
                if precision == "double":
                    assert np.array_equal(a, host[i][k]), (date, k)
            if "MonthEnd" in got:
                ends.append((bool(got["MonthEnd"]), bool(got["YearEnd"])))
    finally:
        jax_runner.close()
        port_runner.close()
    keys = set(ref)
    if case != "static demand":
        assert {"QInM3", "DomesticDemandMM", "VarWMonth", "ForestFraction_t",
                "ForestFraction_nt"} <= keys
        assert ends == [(False, False)] * 3 + [(True, True)] + [(False, False)] * 2
        first, last = port_runner.forcing_for(0, port_runner.dates[0]), got
        assert not torch.equal(first["ForestFraction_t"], last["ForestFraction_t"])
    else:
        assert "DomesticDemandMM" in keys and "QInM3" in keys and "MonthEnd" not in keys


def test_run_with_water_use_and_inflow(options_catchments, tmp_path):
    """6 days with water use and inflow on (static demands; PCRaster meteo,
    which the port's lisfloodexe checks and reads), float64: held as the
    production run is, to the JAX runner's run_scanned."""
    path = options_catchments["static demand"]
    js, ts = _pair(path, str(tmp_path), sys_args=["-v"])
    with pytest.raises(LisfloodError):
        check_meteo_forcings(load_settings(path, vars_to_set={"PathOut": ts.output_dir,
                                                              "PrecipitationMaps": "/nowhere/pr"}))
    jax_runner = JaxRunner(js)
    jax_runner.run_scanned()
    port_runner = lisfloodexe(ts, device="cpu")
    names = held_outputs(js.output_dir, ts.output_dir, False, jax_runner.state)
    assert "dis.tss" in names
    held_state(jax_runner.state, port_runner.state, False)
