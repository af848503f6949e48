"""A warm start of the port (lisflood_tpu_torch/models/driver.py,
io/loadmap.py, models/initial.py): a run that starts from the end maps of an
earlier run and from one slice of its LZ state-map stack, chosen by
timestepInit, on the 48x40 catchment of tests/test_torch_driver.py (6 days
from 01/01/2000, outputs bound), on the CPU.

Held:
  - the port against itself: 6 days cold against 3 days and a warm 3 days
    from the half run's files, in float32 (PCRaster end maps, LZ from the
    stack's third map lz000000.003) and in float64 (netCDF end maps through
    writeNetcdf, LZ from the stack lz.nc at timestepInit). The state keys of
    tests/test_model.py:301-307 and the dis.tss rows of days 4-6.
      * Bitwise in both dtypes: the dis.tss rows as printed, and BITWISE.
      * The rest within the gates of tests/test_torch_driver.py (float64
        1e-10 of each field's max, float32 1.5e-4, CrossSection2Area on the
        Chan2M3Kin/4000 scale, float32 Sideflow1Chan 1e-2). They are not
        bitwise because a warm start rebuilds them from what the end maps
        hold: soil moisture from the moisture content Theta (W = Theta x
        SoilDepth after Theta = W / SoilDepth), ChanM3Kin and ChanQKin from
        the cross-section area (ChanM3Kin / ChanLength), the overland and
        second-lane discharges from their storages, and in float32 the
        float64 products of a float32 map are rounded once more.
      * The balance books (WaterInit, StorageStepINIT, the cumulative sums)
        and the mass-balance TSS restart at zero in a warm run by design, so
        they are not compared.
  - timestepInit as a date and as a step number pick the same slice of the
    stack, in both packages' loaders; a date the stack does not hold raises
    LisfloodError under "exact" and reads the slice before it, clamped to
    the stack's ends, under "closest";
  - the port against the JAX package: both warm runs start from the port's
    half-run files (netCDF end maps and the lz.nc stack), float64; their
    outputs and end state within 1e-10 of each field's max. The JAX run
    takes its sequential sub-step scan (RoutingPipeline "substeps"), as in
    tests/test_torch_driver.py."""
import os

import numpy as np
import pytest

from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.io.loadmap import MapLoader as JaxMapLoader
from lisflood_tpu.models.driver import lisfloodexe as jax_lisfloodexe
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.utils.errors import LisfloodError as JaxLisfloodError
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io.loadmap import MapLoader
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.driver import lisfloodexe
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.synthetic import warm_start, write_catchment
from lisflood_tpu_torch.utils.errors import LisfloodError
from test_torch_driver import JAX_PIPELINE, _held, _nc_held, _tss_header, held_state

DAYS = 6
HALF_END = "03/01/2000 00:00"           # day 3, step 3
WARM_START = "04/01/2000 00:00"
# the state of a warm start held to the cold run (tests/test_model.py:301-307)
KEYS = ("W1a", "W1b", "W2", "UZ", "LZ", "SnowCoverS", "FrostIndex", "ChanQKin", "ChanM3Kin",
        "ChanQ", "DSLR", "CumInterception", "CumInterSealed", "Chan2QKin", "Chan2M3Kin",
        "CrossSection2Area", "Sideflow1Chan", "LakeStorageM3CC", "LakeInflowOldCC",
        "LakeOutflowCC", "ReservoirStorageM3CC", "ReservoirFillCC", "OFM3Direct", "OFM3Other",
        "OFM3Forest")
# read back as they were written, and updated from the forcing and
# themselves alone, so nothing that a warm start rebuilds reaches them. LZ
# and the lakes' state came out bitwise here too, but they depend on the
# rebuilt soil and channel state (percolation from UZ, the lakes' inflow)
# and are not bitwise on every catchment: they are held with the rest
BITWISE = ("SnowCoverS", "FrostIndex", "DSLR", "CumInterception", "CumInterSealed")
# Precision, netCDF end maps
PRECISIONS = {"float32": ("single", False), "float64": ("double", True)}


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(tmp_path_factory.mktemp("warm"), 48, 40, seed=0, n_steps=DAYS,
                           outputs=True, meteo_format="netcdf")


def _settings(load, path, out, netcdf, vars_to_set):
    os.makedirs(out, exist_ok=True)
    return load(path, opts_to_set=["writeNetcdf"] if netcdf else [],
                vars_to_set={"PathOut": out, **vars_to_set})


def warm_bindings(half_dir, netcdf):
    """The warm run's bindings: from day 4, the half run's end maps, LZ from
    its stack at day 3."""
    return {"StepStart": WARM_START, "timestepInit": HALF_END,
            **warm_start(half_dir, netcdf=netcdf, lz_step=3)}


@pytest.fixture(scope="module")
def port_runs(catchment, tmp_path_factory):
    """precision -> {"cold" | "half" | "warm": (runner, PathOut)}, run once."""
    root = tmp_path_factory.mktemp("warm_runs")
    done = {}

    def runs(precision):
        if precision not in done:
            prec, netcdf = PRECISIONS[precision]
            out = {k: os.path.join(root, precision, k) for k in ("cold", "half", "warm")}
            extra = {"cold": {}, "half": {"StepEnd": HALF_END},
                     "warm": warm_bindings(out["half"], netcdf)}
            done[precision] = {
                k: (lisfloodexe(_settings(load_settings, catchment, out[k], netcdf,
                                          {"Precision": prec, **extra[k]}), device="cpu"), out[k])
                for k in ("cold", "half", "warm")}
        return done[precision]
    return runs


def _dis_rows(out):
    _, rows, steps = read_tss(os.path.join(out, "dis.tss"))
    return rows, steps


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_warm_against_cold(port_runs, precision):
    """Days 4-6 warm from the half run's files against the cold run's days
    4-6: BITWISE and the dis.tss rows bit for bit, the other keys of KEYS
    within the gates."""
    runs = port_runs(precision)
    (cold, cold_out), (_, half_out), (warm, warm_out) = (runs[k] for k in ("cold", "half", "warm"))
    f32 = precision == "float32"
    assert warm.dates[0].day == 4 and len(warm.dates) == 3
    lz_file = "lz.nc" if not f32 else "lz000000.003"
    assert os.path.exists(os.path.join(half_out, lz_file))
    ref = {k: v.double().numpy() for k, v in cold.state.items()}
    for k in KEYS:
        a, b = ref[k], warm.state[k].double().numpy()
        if k in BITWISE:
            assert np.array_equal(a, b), k
        else:
            _held(k, a, b, f32, ref)
    # the warm run does differ where the end maps cannot carry the bits
    assert not np.array_equal(ref["W1a"], warm.state["W1a"].double().numpy())
    (cold_rows, cold_steps), (warm_rows, warm_steps) = _dis_rows(cold_out), _dis_rows(warm_out)
    sel = np.isin(cold_steps, warm_steps)
    assert list(warm_steps) == [4, 5, 6] and sel.sum() == 3
    assert np.array_equal(cold_rows[sel], warm_rows)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_timestep_init_forms(port_runs, catchment, pkg):
    """On the float64 half run's LZ stack lz.nc (days 1-3): timestepInit
    "03/01/2000 00:00" and "3" read the same slice, the half run's end LZ,
    bit for bit; "2" reads another; a date the stack does not hold raises
    LisfloodError under "exact", and under "closest" reads the slice before
    it (the last, 03/01) or the first slice for a date before the stack."""
    runs = port_runs("float64")
    (half, half_out) = runs["half"]
    load, build, loader_cls, error = {
        "jax": (jax_load_settings, jax_build_model, JaxMapLoader, JaxLisfloodError),
        "port": (load_settings, build_model, MapLoader, LisfloodError)}[pkg]
    grid = build(load(catchment))[3]["grid"]
    stack = os.path.join(half_out, "lz")

    def lz(tsi):
        settings = load(catchment, vars_to_set={"LZInitValue": stack, "timestepInit": tsi})
        return loader_cls(settings, grid).load("LZInitValue")

    by_date, by_step = lz(HALF_END), lz("3")
    assert np.array_equal(by_date, by_step)
    assert np.array_equal(by_date, half.state["LZ"].numpy())
    assert not np.array_equal(lz("2"), by_date)
    with pytest.raises(error):
        lz("10/01/2000 00:00")
    # "closest": the stack's slice at or before the date, clamped to its ends
    settings = load(catchment, vars_to_set={"LZInitValue": stack,
                                            "timestepInit": "10/01/2000 00:00"})
    assert np.array_equal(loader_cls(settings, grid).load("LZInitValue", timestampflag="closest"),
                          by_date)
    settings = load(catchment, vars_to_set={"LZInitValue": stack,
                                            "timestepInit": "31/12/1999 00:00"})
    assert np.array_equal(loader_cls(settings, grid).load("LZInitValue", timestampflag="closest"),
                          lz("1"))


def held_files(jax_dir, port_dir, state):
    """The two directories hold the same files; TSS headers (but their
    date), steps and rows within the gates, netCDF maps as _nc_held holds
    them (CrossSection2Area on the Chan2M3Kin/4000 scale)."""
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    for name in names:
        a, b = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        if name.endswith(".tss"):
            assert _tss_header(a) == _tss_header(b), name
            (ia, da, sa), (ib, db, sb) = read_tss(a), read_tss(b)
            assert ia == ib and np.array_equal(sa, sb), name
            _held(name, da, db, False)
        elif name.endswith(".nc"):
            _nc_held(a, b, state=state)
    return names


def test_warm_against_jax(port_runs, catchment, tmp_path):
    """The JAX package's warm run from the port's float64 half-run files
    against the port's warm run: the same files, TSS and netCDF maps within
    1e-10, the end state within 1e-10."""
    runs = port_runs("float64")
    (_, half_out), (warm, warm_out) = runs["half"], runs["warm"]
    js = _settings(jax_load_settings, catchment, str(tmp_path), True,
                   {**JAX_PIPELINE, **warm_bindings(half_out, True)})
    jax_runner = jax_lisfloodexe(js)
    names = held_files(js.output_dir, warm_out, jax_runner.state)
    assert {"dis.tss", "lz.nc", "chanqend.nc"} <= set(names)
    held_state(jax_runner.state, warm.state, False)


def test_pcraster_stack_member(port_runs, catchment):
    """LZInitValue bound to a member of the float32 half run's PCRaster LZ
    stack (lz000000.003, a CSF map without the .map name): the port reads
    it, as the reference's readmap does, and it is the half run's end map
    lzend.map; the JAX package's loader takes PCRaster maps under a .map
    name only and fails on it (ROADMAP.md Queue 3)."""
    half_out = port_runs("float32")["half"][1]
    member = os.path.join(half_out, "lz000000.003")
    jgrid = jax_build_model(jax_load_settings(catchment))[3]["grid"]
    grid = build_model(load_settings(catchment))[3]["grid"]
    bindings = {"LZInitValue": member, "LZEnd": os.path.join(half_out, "lzend.map")}
    loader = MapLoader(load_settings(catchment, vars_to_set=bindings), grid)
    assert np.array_equal(loader.load("LZInitValue"), loader.load("LZEnd"))
    jax_loader = JaxMapLoader(jax_load_settings(catchment, vars_to_set=bindings), jgrid)
    with pytest.raises(JaxLisfloodError):
        jax_loader.load("LZInitValue")
