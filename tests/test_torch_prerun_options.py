"""The step's last options in the port (lisflood_tpu_torch) against the JAX
package: the InitLisflood prerun (single routing, no structures, the
evaporation chain outside the routing kernel as its `eva` operand),
InitLisfloodwithoutSplit, the water-security indicators across a month end,
and transient land use with the mass balance.

The same NumPy inputs (`build_synthetic_model`, `with_options`,
`landuse_forcing`) go through both packages: the JAX side through its
sequential `substeps` routing pipeline, the port through the plain PyTorch
version of its routing kernel on the CPU. Float64 is held within 1e-10 of
each field's largest magnitude, float32 within the gates of
tests/test_torch_step.py (3e-5 after one step, 1.5e-4 after two)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.config import ModelConfig as JaxConfig
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.ops import indicators as jax_ind
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.step import LANDUSE_FRACTIONS, build_step, segment_orders
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, landuse_forcing,
                                                 synthetic_forcing, with_options)
from lisflood_tpu_torch.ops import indicators as ind

SIZE = dict(nrows=24, ncols=20, no_rout_steps=6, chunk_size=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
INDICATOR_OUTPUTS = ("WEI_Dem", "WEI_Abs", "WEI_Cns", "WEI_Plus", "WaterSecurityIndex",
                     "WaterDependencyIndex", "WaterSustainabilityIndex", "FalkenmarkM3Capita3",
                     "RegionMonthExternalInflowM3", "MonthETdifMM",
                     "consumption_required_domestic_M3MonthRegion")


def jax_config(cfg, **kw):
    """The JAX package's ModelConfig with the port config's field values and
    the sequential sub-step pipeline."""
    fields = dataclasses.asdict(cfg)
    assert fields.pop("members") == 1
    return JaxConfig(**fields, routing_pipeline="substeps", **kw)


def rel_err(got, ref, scale=None):
    return np.abs(got - ref).max() / (scale or max(np.abs(ref).max(), 1e-30))


def forcings(cfg, aux, n_steps, month_end=()):
    """The forcing of each step: synthetic_forcing, the options' entries,
    MonthEnd True on the steps in `month_end`, the land-use stacks' step."""
    out = []
    for t in range(n_steps):
        f = {**synthetic_forcing(cfg.num_pixels, seed=t), **aux.get("forcing_options", {})}
        if "MonthEnd" in f:
            f["MonthEnd"] = np.bool_(t in month_end)
        if cfg.transient_landuse:
            f.update(landuse_forcing(aux, t))
        out.append(f)
    return out


def run_both(model, dt, n_steps, diagnostics=(), month_end=(), **options):
    """Natural-space states and `diagnostics` of every step: (JAX, port)."""
    jdt, tdt = DTYPES[dt]
    cfg, params, state, aux = model
    cfg = dataclasses.replace(cfg, **options)
    fs = forcings(cfg, aux, n_steps, month_end)

    step, _ = jax_build_step(jax_config(cfg), params, aux, dtype=jdt)
    cv = lambda v: jnp.asarray(v, jdt if np.asarray(v).dtype.kind == "f" else None)
    s = step.prepare_state({k: cv(v) for k, v in state.items()})
    ref = []
    for f in fs:
        s, d = step(s, {k: cv(v) for k, v in f.items()})
        out = {k: np.asarray(v) for k, v in step.natural_state(s).items()}
        out.update({k: np.asarray(d[k]) for k in diagnostics})
        ref.append(out)

    port, _ = build_step(cfg, params, aux, dtype=tdt, device="cpu")
    s_t = port.prepare_state(state)
    got = []
    for f in fs:
        s_t, d_t = port(s_t, to_device(f, "cpu", tdt))
        out = {k: v.numpy() for k, v in port.natural_state(s_t).items()}
        out.update({k: d_t[k].numpy() for k in diagnostics})
        got.append(out)
    assert all(set(r) == set(g) for r, g in zip(ref, got))
    return ref, got, port


def assert_close(ref, got, tol, scales=None, loose=None):
    for k in ref:
        err = rel_err(got[k], ref[k], (scales or {}).get(k))
        assert err <= (loose or {}).get(k, tol), f"{k}: {err:.3e}"


# ---------------------------------------------------------------------------
# the InitLisflood prerun


@pytest.mark.parametrize("dt,tol", [("f64", 1e-10), ("f32", 1.5e-4)])
def test_init_lisflood_two_steps(dt, tol):
    """InitLisflood on the main-path model (split routing, lakes, reservoirs,
    open water): two steps, every state entry. The prerun routes one lane,
    simulates no structure and runs the evaporation chain before the
    routing kernel, which takes it as `eva`. float64 1e-10 (measured
    3.0e-15, W1a), float32 1.5e-4, the two-step gate (measured 1.7e-6, W1a)."""
    ref, got, port = run_both(build_synthetic_model(**SIZE), dt, 2, init_lisflood=True)
    assert not port.eva_in_kernel and port.pipeline == "reference"
    last = got[-1]
    for k in ("Chan2QKin", "LakeStorageM3CC", "ReservoirStorageM3CC"):
        assert k not in last
    assert last["CumQ"].max() > 0 and last["LZInflowCUM"].max() > 0
    np.testing.assert_allclose(last["avgdis"], last["CumQ"] / 2.0, rtol=1e-6)
    assert_close(ref[-1], last, tol)


def test_init_lisflood_kernel_operands():
    """The prerun's routing-kernel operands: one lane (no split rows), no
    structures, the evaporation result as `eva` and no evaporation chain
    in the kernel."""
    from lisflood_tpu_torch.ops.routing_ops import kernel_operands
    cfg, params, state, aux = build_synthetic_model(**SIZE)
    cfg = dataclasses.replace(cfg, init_lisflood=True)
    step, p = build_step(cfg, params, aux, device="cpu")
    s = step.prepare_state(state)
    f = to_device(synthetic_forcing(cfg.num_pixels), "cpu", torch.float64)
    spec, xs = kernel_operands(cfg, p, s, step.land_phase(s, f), step.routers)
    assert not spec.split and spec.E == 0
    assert "eva" in xs and "lk_pos" not in xs and "rs_pos" not in xs and "adx2" not in xs
    assert float(xs["eva"].abs().max()) > 0


def test_init_lisflood_all_options():
    """InitLisflood with every option of with_options, float64, two steps,
    within 1e-10 (measured 2.5e-14, TransCum). The JAX step fails under
    InitLisflood with the total-storage report, the mass balance or the
    indicators, which read the lake and reservoir storages that the prerun
    does not simulate (`KeyError: 'LakeStorageM3Balance'`): the port refuses
    each of those three at build, and the comparison runs with them off."""
    model = with_options(build_synthetic_model(**SIZE))
    cfg, params, state, aux = model
    off = dict(rep_total_water_storage=False, rep_mbts=False, indicator=False)
    jcfg = jax_config(dataclasses.replace(cfg, init_lisflood=True))
    step, _ = jax_build_step(jcfg, params, aux)
    s = step.prepare_state({k: jnp.asarray(v) for k, v in state.items()})
    f = {k: jnp.asarray(v) for k, v in forcings(cfg, aux, 1)[0].items()}
    with pytest.raises(KeyError, match="LakeStorageM3Balance"):
        step(s, f)
    for on in off:
        with pytest.raises(ValueError, match="InitLisflood"):
            build_step(dataclasses.replace(cfg, init_lisflood=True, **{**off, on: True}),
                       params, aux, device="cpu")
    ref, got, _ = run_both(model, "f64", 2, ("ChanQAvg", "TransCum"), init_lisflood=True, **off)
    assert_close(ref[-1], got[-1], 1e-10)


def test_init_lisflood_without_split():
    """InitLisfloodwithoutSplit ends the step after the groundwater: the
    routing state stays as it was, the land state advances. float64, two
    steps, 1e-10 (measured 3.0e-15, W1a)."""
    cfg, params, state, aux = model = build_synthetic_model(**SIZE)
    ref, got, _ = run_both(model, "f64", 2, init_lisflood_without_split=True)
    np.testing.assert_array_equal(got[-1]["ChanQ"], state["ChanQ"])
    assert rel_err(got[-1]["LZ"], state["LZ"]) > 1e-3
    assert_close(ref[-1], got[-1], 1e-10)


# ---------------------------------------------------------------------------
# the indicators


@pytest.fixture(scope="module")
def options_step():
    """One float64 step of the all-options model (indicators on), as NumPy
    arrays: model, the state before, the diagnostics of the step."""
    cfg, params, state, aux = model = with_options(build_synthetic_model(**SIZE))
    step, _ = build_step(cfg, params, aux, device="cpu")
    s = step.prepare_state(state)
    _, d = step(s, to_device(forcings(cfg, aux, 1)[0], "cpu", torch.float64))
    return model, {k: v.numpy() for k, v in d.items() if not k.startswith("pk$")}


def test_indicator_step(options_step):
    """indicator_step on the same arrays as JAX's, with accumulators drawn
    at random: every output within 1e-12."""
    (cfg, params, state, aux), d_np = options_step
    rng = np.random.default_rng(3)
    s_np = {k: rng.uniform(0, 10, cfg.num_pixels) for k in ind.indicator_keys(cfg)}
    s_np["DayCounter"] = np.float64(4.0)
    ref = jax_ind.indicator_step(jax_config(cfg), {k: (v if np.isscalar(v) else jnp.asarray(v))
                                                   for k, v in params.items()},
                                 {k: jnp.asarray(v) for k, v in s_np.items()},
                                 {k: jnp.asarray(v) for k, v in d_np.items()})
    tp = {k: v for k, v in params.items() if np.isscalar(v)}
    tp.update(to_device({k: v for k, v in params.items() if not np.isscalar(v)}, "cpu",
                        torch.float64))
    tp.update(segment_orders(cfg, params, "cpu"))
    got = ind.indicator_step(cfg, tp, to_device(s_np, "cpu", torch.float64),
                             to_device(d_np, "cpu", torch.float64))
    assert set(got) == set(ref) and "RegionMonthReservoirAndLakeStorageM3" in got
    assert float(np.asarray(ref["RegionMonthExternalInflowM3"]).max()) > 0
    for k, r in ref.items():
        assert rel_err(got[k].numpy(), np.asarray(r)) <= 1e-12, k
    zero = ind.indicator_state_zero(cfg, cfg.num_pixels, torch.float64)
    assert set(zero) == set(ind.indicator_keys(cfg)) and zero["DayCounter"].dim() == 0


def test_indicators_across_month_end():
    """The all-options step (indicators on) over three steps with MonthEnd
    on the second: the accumulators reset there and start again. Every
    state entry and the indicators of each step within 1e-10 (measured
    6.3e-12, CrossSection2Area, a difference of near-equal operands)."""
    model = with_options(build_synthetic_model(**SIZE))
    ref, got, _ = run_both(model, "f64", 3, INDICATOR_OUTPUTS, month_end=(1,))
    assert [float(g["DayCounter"]) for g in got] == [1.0, 0.0, 1.0]
    assert got[1]["MonthDisM3"].max() == 0 and got[2]["MonthDisM3"].max() > 0
    assert got[1]["WEI_Dem"].max() > 0
    for r, g in zip(ref, got):
        assert_close(r, g, 1e-10)


# ---------------------------------------------------------------------------
# transient land use


def test_transient_landuse_mass_balance():
    """Transient land use with the mass balance on: fractions that change
    from step to step, the next step's fractions re-pricing WaterInit and
    AverageFractions. float64, two steps, every state entry, MBError,
    AverageFractions and ChanQAvg within 1e-10 (measured 4.8e-12,
    CrossSection2Area; MBError 2.3e-14)."""
    model = with_options(build_synthetic_model(**SIZE))
    ref, got, _ = run_both(model, "f64", 2, ("MBError", "AverageFractions", "ChanQAvg"),
                           transient_landuse=True)
    assert np.abs(got[1]["WaterInit"] - got[0]["WaterInit"]).max() > 0
    for r, g in zip(ref, got):
        assert_close(r, g, 1e-10)


def test_transient_landuse_leaves_params():
    """A step's fractions are its own: two steps with different stacks use
    different fractions, and the step's parameters are the model's after
    them (no step's land use leaks into the next)."""
    cfg, params, state, aux = with_options(build_synthetic_model(**SIZE))
    cfg = dataclasses.replace(cfg, transient_landuse=True)
    step, p = build_step(cfg, params, aux, device="cpu")
    fs = [to_device(f, "cpu", torch.float64) for f in forcings(cfg, aux, 2)]
    s = step.prepare_state(state)
    used = []
    for f in fs:
        used.append(step.step_params(f)["SoilFraction"])
        s, _ = step(s, f)
    assert not torch.equal(used[0], used[1])
    torch.testing.assert_close(used[1][1], fs[1]["ForestFraction_t"], rtol=0, atol=0)
    for k in LANDUSE_FRACTIONS + ("SoilFraction", "PermeableFraction"):
        np.testing.assert_array_equal(step.params[k].numpy(), params[k], err_msg=k)
    total = sum(aux["landuse"][k] for k in LANDUSE_FRACTIONS)
    np.testing.assert_allclose(total, 1.0, rtol=0, atol=1e-12)
