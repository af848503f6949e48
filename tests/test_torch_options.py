"""The port's all-options step (lisflood_tpu_torch) against the JAX package's:
water use with groundwater smoothing, rice irrigation, inflow hydrographs,
transmission loss, the open-water evaporation chain inside and outside the
routing kernel, water levels, pF, polders and the mass-balance reports.

The inputs come from `with_options` (NumPy arrays from a seed; the JAX
package's synthetic model has none of these options' inputs) and go
unchanged through both packages: the JAX side through its sequential
`substeps` routing pipeline, the port through the plain PyTorch version of
its routing kernel on the CPU. Tolerances are relative to each field's
largest magnitude unless stated."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.config import ModelConfig as JaxConfig
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.ops import indicators as jax_ind
from lisflood_tpu.ops import physics as jax_ph
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.convert import config_from_reference, from_reference
from lisflood_tpu_torch.models.step import Step, build_step, segment_orders
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options)
from lisflood_tpu_torch.ops import indicators as ind
from lisflood_tpu_torch.ops import physics as ph

SIZE = dict(nrows=24, ncols=20, no_rout_steps=6, chunk_size=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
DIAGNOSTICS = ("ChanQAvg", "TransCum", "MBError", "MBErrorSplitRoutingM3")


def options_model(eva_outside_window=False):
    return with_options(build_synthetic_model(**SIZE), eva_outside_window=eva_outside_window)


def jax_config(cfg, **kw):
    """The JAX package's ModelConfig with the port config's field values (all
    but `members`, the port's ensemble fold, which is 1 here)."""
    fields = dataclasses.asdict(cfg)
    assert fields.pop("members") == 1
    return JaxConfig(**fields, **kw)


def forcing_of(cfg, aux, seed=0):
    return {**synthetic_forcing(cfg.num_pixels, seed=seed), **aux["forcing_options"]}


def rel_err(got, ref, scale=None):
    return np.abs(got - ref).max() / (scale or max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# each ported function against its JAX counterpart, float64


@pytest.fixture(scope="module")
def one_step():
    """The all-options model, and the state, parameters and diagnostics of
    one float64 step of the port as NumPy arrays: the common inputs of the
    function-level comparisons."""
    cfg, params, state, aux = options_model()
    step, p = build_step(cfg, params, aux, dtype=torch.float64, device="cpu")
    s = step.prepare_state(state)
    _, d = step(s, to_device(forcing_of(cfg, aux), "cpu", torch.float64))
    d_np = {k: v.numpy() for k, v in d.items() if not k.startswith("pk$")}
    d_np["ChanM3Kin"] = state["ChanM3Kin"]      # start-of-step storage, as the callers pass
    return cfg, params, state, d_np


def _both(cfg, params, state, d_np):
    """(JAX cfg, p, s, d) and (port cfg, p, s, d) from the same arrays."""
    jp = {k: (v if np.isscalar(v) else jnp.asarray(v)) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    jd = {k: jnp.asarray(v) for k, v in d_np.items()}
    tp = {k: v for k, v in params.items() if np.isscalar(v)}
    tp.update(to_device({k: v for k, v in params.items() if not np.isscalar(v)},
                        "cpu", torch.float64))
    ts = to_device(state, "cpu", torch.float64)
    td = to_device(d_np, "cpu", torch.float64)
    tp.update(segment_orders(cfg, params, "cpu"))
    return (jax_config(cfg), jp, js, jd), (cfg, tp, ts, td)


def _compare(got, ref, tol=1e-12):
    assert set(got) == set(ref)
    for k, r in ref.items():
        err = rel_err(got[k].numpy(), np.asarray(r))
        assert err <= tol, f"{k}: {err:.3e}"


@pytest.mark.parametrize("stencil", [True, False])
def test_evapowater_step(one_step, stencil):
    """The evaporation chain outside the kernel, as the 2-D stencil and as
    the segment-sum scatter: 1e-12 (measured 0 in both)."""
    cfg, params, state, d_np = one_step
    cfg = dataclasses.replace(cfg, eva_stencil=stencil)
    (jc, jp, js, jd), (tc, tp, ts, td) = _both(cfg, params, state, d_np)
    assert tc.use_eva_stencil("cpu") == stencil and "evaDir2D" in tp
    _compare(ph.evapowater_step(tc, tp, ts, td), jax_ph.evapowater_step(jc, jp, js, jd))


def test_rice_irrigation_step(one_step):
    """1e-12 (measured 0); the calendar puts pixels in every phase."""
    (jc, jp, js, jd), (tc, tp, ts, td) = _both(*one_step)
    ref = jax_ph.rice_irrigation_step(jc, jp, js, jd)
    assert np.count_nonzero(np.asarray(ref["PaddyRiceWaterAbstractionFromSurfaceWaterM3"])) > 20
    _compare(ph.rice_irrigation_step(tc, tp, ts, td), ref)


def test_water_abstraction_step(one_step):
    """1e-12 (measured 0), the per-sector report terms included."""
    (jc, jp, js, jd), (tc, tp, ts, td) = _both(*one_step)
    ref = jax_ph.water_abstraction_step(jc, jp, js, jd)
    assert "consumption_actual_irrigation_MM" in ref and float(ref["withdrawal_CH_actual_M3"].sum()) > 0
    _compare(ph.water_abstraction_step(tc, tp, ts, td), ref)


def test_groundwater_smooth(one_step):
    """1e-12 (measured 3.6e-16)."""
    (jc, jp, js, jd), (tc, tp, ts, td) = _both(*one_step)
    ref = jax_ind.groundwater_smooth(jc, jp, js["LZ"], jp["LandRows"], jp["LandCols"],
                                     jc.grid_rows, jc.grid_cols)
    got = ind.groundwater_smooth(tc, tp, ts["LZ"], tp["LandRows"], tp["LandCols"],
                                 tc.grid_rows, tc.grid_cols)
    assert rel_err(np.asarray(ref), np.asarray(js["LZ"])) > 1e-4       # it smooths
    _compare({"LZ": got}, {"LZ": ref})


def test_waterlevel_and_pf_steps(one_step):
    """waterlevel_step and pf_step: 1e-12 (measured 0 and 2.0e-16)."""
    (jc, jp, js, jd), (tc, tp, ts, td) = _both(*one_step)
    _compare(ph.waterlevel_step(tc, tp, ts, td), jax_ph.waterlevel_step(jc, jp, js, jd))
    _compare(ph.pf_step(tc, tp, td), jax_ph.pf_step(jc, jp, jd))


# ---------------------------------------------------------------------------
# the slice as a whole


def _run_both(eva_outside_window, n_steps, dt):
    """Natural-space states plus DIAGNOSTICS of the last step: (JAX, port)."""
    jdt, tdt = DTYPES[dt]
    cfg, params, state, aux = options_model(eva_outside_window)
    forcing = forcing_of(cfg, aux)

    step, _ = jax_build_step(jax_config(cfg, routing_pipeline="substeps"), params, aux, dtype=jdt)
    cv = lambda v: jnp.asarray(v, jdt if np.asarray(v).dtype.kind == "f" else None)
    s = step.prepare_state({k: cv(v) for k, v in state.items()})
    f = {k: cv(v) for k, v in forcing.items()}
    for _ in range(n_steps):
        s, d = step(s, f)
    ref = {k: np.asarray(v) for k, v in step.natural_state(s).items()}
    ref.update({k: np.asarray(d[k]) for k in DIAGNOSTICS})

    port, _ = build_step(cfg, params, aux, dtype=tdt, device="cpu")
    assert port.eva_in_kernel == (not eva_outside_window)
    s_t = port.prepare_state(state)
    f_t = to_device(forcing, "cpu", tdt)
    for _ in range(n_steps):
        s_t, d_t = port(s_t, f_t)
    got = {k: v.numpy() for k, v in port.natural_state(s_t).items()}
    got.update({k: d_t[k].numpy() for k in DIAGNOSTICS})
    assert set(ref) == set(got)
    return ref, got


@pytest.mark.parametrize("eva_outside_window", [False, True], ids=["eva-in-kernel", "eva-outside"])
def test_options_step_f64_two_steps(eva_outside_window):
    """float64, two steps, every state entry and ChanQAvg, TransCum, MBError,
    MBErrorSplitRoutingM3 within 1e-10: with the evaporation chain inside
    the kernel next to water use, inflow and transmission loss, and with an
    evaporation edge that leaves the window (the chain runs outside and the
    kernel takes `eva`). Measured 2.8e-12 (CrossSection2Area, a difference of
    near-equal operands; 1.0e-14 on ChanQ)."""
    ref, got = _run_both(eva_outside_window, 2, "f64")
    for k in ("TransCum", "QInM3Old", "wateruseCum", "WaterInit", "PolderStorageM3"):
        assert k in got
    assert np.abs(ref["TransCum"]).max() > 0 and not np.isnan(ref["TransCum"]).any()
    for k in ref:
        err = rel_err(got[k], ref[k])
        assert err <= 1e-10, f"{k}: {err:.3e}"


def _f32_scales(ref):
    """Scales of the float32 comparisons that are not the field's own max:
    CrossSection2Area on the Chan2M3Kin/4000 scale
    (tests/test_pallas_routing.py); the two mass-balance residuals, which
    are differences of catchment totals, on the scale of those totals; and
    TransCum, a sum of differences chanq - (chanq**tp2 - tsub)**tp1 of
    near-equal operands (the loss is a fraction of a percent of the
    discharge), on the scale of those operands: the volume the largest
    discharge passes in one routing sub-step. On its own max TransCum
    differs by 6.5e-5 after one step: one ulp of `pow` at a 3000 m3/s lane
    is 3.5 m3 of loss per sub-step."""
    return {"CrossSection2Area": np.abs(ref["Chan2M3Kin"]).max() / 4000.0,
            "TransCum": np.abs(ref["ChanQAvg"]).max() * 86400.0 / SIZE["no_rout_steps"],
            "MBError": np.abs(ref["WaterInit"]).max(),
            "MBErrorSplitRoutingM3": np.abs(ref["StorageStepINIT"]).max()}


@pytest.mark.parametrize("eva_outside_window", [False, True], ids=["eva-in-kernel", "eva-outside"])
@pytest.mark.parametrize("n_steps,tol", [(1, 3e-5), (2, 1.5e-4)])
def test_options_step_f32(eva_outside_window, n_steps, tol):
    """float32, the gates of tests/test_torch_step.py: 3e-5 after one step,
    1.5e-4 after two, 1e-2 for the cancellation-amplified Sideflow1Chan.
    Measured 1.3e-5 (one step, ChanQ) and 1.8e-5 (two steps,
    LakeInflowOldCC)."""
    ref, got = _run_both(eva_outside_window, n_steps, "f32")
    scales = _f32_scales(ref)
    for k in ref:
        err = rel_err(got[k], ref[k], scales.get(k))
        assert err < (1e-2 if k == "Sideflow1Chan" else tol), f"{k}: {err:.3e}"


# ---------------------------------------------------------------------------
# the mass balance of the port alone


@pytest.mark.parametrize("which", ["routing", "catchment"])
def test_mass_balance_closes(which):
    """float64, three steps, |error| < 1e-6 mm of water over the catchment.

    'routing': MBErrorSplitRoutingM3, the balance of the routing kernel's
    sideflow against AddedTRUN, with water use, rice, the ramping inflow
    and evaporation. The reference's routing balance leaves out the
    transmission loss and the water taken from lakes and reservoirs, so
    those two are off here. 'catchment': MBErrorMM with evaporation,
    polders and inflow; the reference's catchment balance books the inflow
    a step late and the water-use and transmission sums cumulatively, so
    the inflow is constant and those options are off. Measured 1.1e-13 and
    5.1e-13 mm."""
    cfg, params, state, aux = options_model()
    forcing = dict(aux["forcing_options"])
    if which == "routing":
        cfg = dataclasses.replace(cfg, trans_loss=False)
        params = {**params, "FractionLakeReservoirWaterUsed": np.zeros(cfg.num_pixels)}
    else:
        cfg = dataclasses.replace(cfg, trans_loss=False, water_use=False, rice_irrigation=False)
        forcing["QInM3"] = state["QInM3Old"]
        state = {**state, "sumInWB": state["QInM3Old"]}
    step, p = build_step(cfg, params, aux, dtype=torch.float64, device="cpu")
    s = step.prepare_state(state)
    for i in range(3):
        f = to_device({**synthetic_forcing(cfg.num_pixels, seed=i), **forcing}, "cpu", torch.float64)
        s, d = step(s, f)
        err = d["MBErrorSplitRoutingM3"] if which == "routing" else d["MBError"]
        err_mm = float((1000.0 * err / p["CatchArea"]).abs().max())
        assert err_mm < 1e-6, f"step {i}: {err_mm:.3e} mm"
        assert float(d["ChanQAvg"].max()) > 0


# ---------------------------------------------------------------------------
# carrying a configuration over


def test_config_from_reference_refuses_lost_fields():
    """A JAX configuration field without a counterpart raises when set; the
    XLA schedule field routing_pipeline is ignored; every shared field is
    carried."""
    jcfg = JaxConfig(water_use=True, groundwater_smooth=True, rep_water_use=True,
                     num_wregions=3, routing_pipeline="substeps", num_shards=4)
    cfg = config_from_reference(jcfg)
    assert cfg.groundwater_smooth and cfg.rep_water_use and cfg.num_wregions == 3

    @dataclasses.dataclass(frozen=True)
    class Extended(JaxConfig):
        new_option: bool = False

    assert config_from_reference(Extended()).water_use is False
    with pytest.raises(ValueError, match="new_option"):
        config_from_reference(Extended(new_option=True))


def test_from_reference_types_option_parameters():
    """from_reference gives the options' parameters their types: masks bool,
    region and catchment labels int64, the kernel's packed mask bool."""
    cfg, params, state, aux = options_model()
    cfg_t, p, s, routers = from_reference(jax_config(cfg), params, state, aux, device="cpu",
                                          dtype=torch.float32)
    assert cfg_t == cfg
    assert p["UpTrans"].dtype == torch.bool and p["kinp$UpTrans"].dtype == torch.bool
    assert p["WUseRegionC"].dtype == torch.int64 and p["Catchments"].dtype == torch.int64
    assert p["kinp$TransPower1"].dtype == torch.float32 and p["LZSmoothRangeCells"] == 5
    assert s["pk$TransCum"].shape == (routers["kin"].ps.p_pad,)
    step = Step(cfg_t, p, routers, "cpu")
    s2, d = step(s, to_device(forcing_of(cfg, aux), "cpu", torch.float32))
    assert set(s2) == set(s) and bool(torch.isfinite(d["WaterLevel"]).all())
