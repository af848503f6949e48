"""The port's build_model (lisflood_tpu_torch/models/initial.py) against the
JAX package's, on a catchment written to disk by the port's
models/synthetic.write_catchment (48x40 cells, 4 days of meteo, netCDF-4,
which the JAX package's reader takes): the same settings file through both
load_settings and both build_models, key for key and bit for bit; then the
step built from each model, 3 days from the meteo stacks, on the main path
(split routing, lakes, reservoirs, open-water evaporation, mass-balance
reports) and on the InitLisflood prerun of the same catchment.

Gates of the steps: float64 within 1e-10 of each field's max; float32
within 3e-5 after one step and 1.5e-4 after more, CrossSection2Area on the
Chan2M3Kin/4000 scale and Sideflow1Chan within 1e-2
(tests/test_pallas_routing.py:53-60,87-108).

write_catchment's option inputs and output bindings: with each option that
reads inputs of its own (inflow, water use with transient or static demand
and the indicators, transient land use, the variable water fraction, rice
irrigation, polders, pF, water levels, groundwater smoothing, water
regions, the average-year demand, drained irrigation, temperature in
kelvin, transmission loss), and with the outputs bound, both build_models
still agree bit for bit."""
import dataclasses
import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.models.step import state_keys as jax_state_keys
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_multi_step
from lisflood_tpu_torch.models.synthetic import write_catchment

# the prerun of the same catchment: InitLisflood on; the JAX step cannot run
# the prerun with structures or the mass-balance reports (ROADMAP.md Queue 3)
PATHS = {"main": {},
         "prerun": dict(opts_to_set=["InitLisflood"],
                        opts_to_unset=["simulateLakes", "simulateReservoirs", "repMBTs"])}
STEPS = 3


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(tmp_path_factory.mktemp("catchment"), 48, 40, seed=0, n_steps=4)


@pytest.fixture(scope="module", params=list(PATHS))
def models(request, catchment):
    """(path, JAX (cfg, params, state, aux), port's, port's settings)."""
    kw = PATHS[request.param]
    settings = load_settings(catchment, **kw)
    return (request.param, jax_build_model(jax_load_settings(catchment, **kw)),
            build_model(settings), settings)


def _same_arrays(jax_model, port_model):
    """params and state: the same keys, and every array the same bits
    (NaN-aware) with the same dtype."""
    (_, jp, js, _), (_, tp, ts, _) = jax_model, port_model
    assert set(jp) == set(tp) and set(js) == set(ts)
    for ref, got in ((jp, tp), (js, ts)):
        for k, v in ref.items():
            a, b = np.asarray(v), np.asarray(got[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), k


def test_build_model_arrays(models):
    """params and state: the same keys, and every array the same bits
    (NaN-aware) with the same dtype."""
    _, jmodel, tmodel, _ = models
    _same_arrays(jmodel, tmodel)


# write_catchment's options that read inputs of their own, and the outputs
OPTION_INPUTS = {
    "inflow": {"inflow": True},
    "water use, transient demand, indicators": {"wateruse": True,
                                                "TransientWaterDemandChange": True,
                                                "indicator": True},
    "water use, static demand": {"wateruse": True},
    "transient land use": {"TransientLandUseChange": True},
    "variable water fraction": {"varfractionwater": True},
    "outputs bound": None,
    "rice irrigation": {"wateruse": True, "riceIrrigation": True},
    "polders": {"simulatePolders": True},
    "pF": {"simulatePF": True},
    "water levels": {"simulateWaterLevels": True},
    "groundwater smoothing": {"wateruse": True, "groundwaterSmooth": True},
    "water regions": {"wateruse": True, "wateruseRegion": True, "indicator": True},
    "average-year demand": {"wateruse": True, "TransientWaterDemandChange": True,
                            "useWaterDemandAveYear": True},
    "drained irrigation": {"drainedIrrigation": True},
    "temperature in kelvin": {"TemperatureInKelvin": True},
    "transmission loss": {"TransLoss": True},
}


@pytest.mark.parametrize("case", list(OPTION_INPUTS))
def test_build_model_option_inputs(tmp_path, case):
    """Both build_models on write_catchment's option inputs (6 days from
    28/12/1999, across a year end), bit for bit; the options' own entries
    are there."""
    opts = OPTION_INPUTS[case]
    path = write_catchment(tmp_path, 48, 40, seed=2, n_steps=6, options=opts,
                           outputs=opts is None, start=datetime.date(1999, 12, 28))
    jmodel, tmodel = jax_build_model(jax_load_settings(path)), build_model(load_settings(path))
    _same_arrays(jmodel, tmodel)
    cfg, params, state, aux = tmodel
    expected = {"inflow": ("InflowPoints", "inflow_tss"), "wateruse": ("WUseRegionC",),
                "indicator": ("Population",), "TransientLandUseChange": ("ForestFraction",),
                "varfractionwater": ("varW", "varW_day_to_month"),
                "riceIrrigation": ("RicePlantingDay1", "RiceHarvestDay2", "RiceFlooding"),
                "simulatePolders": ("IsPolder", "PolderArea", "PolderStorageIniM3"),
                "simulatePF": ("HeadMax",), "simulateWaterLevels": ("FloodPlainWidth",),
                "groundwaterSmooth": ("LZSmoothRangeCells", "GroundwaterCatch"),
                "wateruseRegion": ("downWRegion", "WaterRegionOutflowPoints"),
                "TransLoss": ("UpTrans", "TransSub", "TransPower2")}
    for option in opts or ():
        for k in expected.get(option, ()):
            assert k in params or k in aux, (option, k)
    assert cfg.water_use == bool((opts or {}).get("wateruse"))
    # the options' inputs are not their defaults
    if "simulatePolders" in (opts or ()):
        assert params["IsPolder"].sum() == 3 and params["PolderStorageIniM3"].max() > 0
    if "drainedIrrigation" in (opts or ()):
        assert params["DrainedFraction"] == 0.3
    if "TransLoss" in (opts or ()):
        assert 0 < params["UpTrans"].sum() < cfg.num_pixels
    if "riceIrrigation" in (opts or ()):
        assert 0 < (params["RiceFraction"] > 0).mean() < 0.6
    if "useWaterDemandAveYear" in (opts or ()):
        assert cfg.water_demand_ave_year and "DomesticDemandMM" not in params
    if opts == {"wateruse": True}:
        assert params["DomesticDemandMM"].shape == (cfg.num_pixels,)


def test_build_model_config_and_schedules(models):
    """The ModelConfig fields the two packages share are equal (the JAX
    package's schedule choice routing_pipeline has no counterpart, the
    port's ensemble fold `members` is 1); the channel and
    overland schedules are equal in chunks and downstream, at chunk 256;
    the overland graph has edges, so the step runs the sweep."""
    path, (jc, _, _, ja), (tc, _, _, ta), _ = models
    port = dataclasses.asdict(tc)
    assert port.pop("members") == 1
    ref = {k: v for k, v in dataclasses.asdict(jc).items()
           if k != "routing_pipeline"}
    assert ref == port
    assert tc.init_lisflood == (path == "prerun") and tc.no_rout_steps == (1 if path == "prerun" else 24)
    for k in ("schedule_kin", "schedule_tochan"):
        np.testing.assert_array_equal(ja[k].chunks, ta[k].chunks)
        np.testing.assert_array_equal(ja[k].downstream, ta[k].downstream)
        assert ta[k].chunk_size == 256
    down = ta["schedule_tochan"].downstream[:tc.num_pixels]
    assert 0 < (down < tc.num_pixels).sum() < tc.num_pixels


def _run_jax(model, forcing, dtype):
    cfg, params, state, aux = model
    step, _ = jax_build_step(dataclasses.replace(cfg, routing_pipeline="substeps"),
                             params, aux, dtype=dtype)
    cv = lambda v: jnp.asarray(v, dtype if np.asarray(v).dtype.kind == "f" else None)
    allowed = set(jax_state_keys(cfg))
    s = {k: v for k, v in step.prepare_state({k: cv(v) for k, v in state.items()}).items()
         if k in allowed}
    out = []
    for f in forcing:
        s, _ = step(s, {k: cv(v) for k, v in f.items()})
        out.append({k: np.asarray(v) for k, v in step.natural_state(s).items()})
    return out


def _run_port(model, forcing, dtype):
    cfg, params, state, aux = model
    multi, _ = build_multi_step(cfg, params, aux, dtype=dtype, device="cpu")
    assert not multi.routers["tochan"].no_edges
    s = multi.prepare_state(state)
    out = []
    for f in forcing:
        s, _ = multi.step(s, to_device(f, "cpu", dtype))
        out.append({k: v.numpy() for k, v in multi.natural_state(s).items()})
    return out


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_catchment_steps(models, dt):
    """Three days of the map-built model, meteo read from the PCRaster
    stacks by the port's reader: the port's step against the JAX step, each
    from its own build_model, with overland edges."""
    path, jmodel, tmodel, settings = models
    forcing = meteo_forcing(settings, tmodel[0], tmodel[3])[:STEPS]
    assert len(forcing) == STEPS and forcing[0]["Precipitation"].shape == (tmodel[0].num_pixels,)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[dt]
    refs = _run_jax(jmodel, forcing, jdt)
    gots = _run_port(tmodel, forcing, tdt)
    for i, (ref, got) in enumerate(zip(refs, gots)):
        assert set(ref) == set(got)
        scales, tol = {}, {k: 1e-10 for k in ref}
        if dt == "f32":
            tol = {k: 3e-5 if i == 0 else 1.5e-4 for k in ref}
            tol["Sideflow1Chan"] = 1e-2
            if "Chan2M3Kin" in ref:
                scales["CrossSection2Area"] = np.abs(ref["Chan2M3Kin"]).max() / 4000.0
        for k, a in ref.items():
            err = np.abs(a - got[k]).max() / scales.get(k, max(np.abs(a).max(), 1e-30))
            assert err <= tol[k], f"{path}, step {i + 1}, {k}: {err:.3e}"
