"""The step with RoutingKernel sharded in the port (lisflood_tpu_torch)
against the JAX package's: the sequential sub-step loop around the sharded
sweep (the plain version of K6 on the CPU), on the synthetic model with
every option of with_options and on a catchment written by the port's
models/synthetic.write_catchment, through build_multi_step and through both
command lines. The same NumPy inputs go through both packages; the JAX
steps run its sequential sub-step loop (`routing_pipeline substeps`), the
only loop it takes with more than one shard.

Gates: float64 within 1e-10 of each field's max; float32 within 3e-5 after
one step and 1.5e-4 after more (CrossSection2Area on the Chan2M3Kin/4000
scale, Sideflow1Chan within 1e-2, TransCum on the scale of the volume the
largest discharge passes in a sub-step, as tests/test_torch_options.py
holds them); the port's sharded step against its packed step as
tests/test_model.py:123-127 holds the JAX package's."""
import dataclasses
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lisflood_tpu.main as jax_main_module
from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.models.config import ModelConfig as JaxConfig
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.models.step import state_keys as jax_state_keys
from lisflood_tpu_torch import main as port_main
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_multi_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options, write_catchment)

STEPS = 3
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
SHARDED = {"RoutingKernel": "sharded", "RoutingShards": "4"}


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """A 48x40 catchment with transmission loss (write_catchment's inputs:
    the cells whose average discharge, the AvgDis map, exceeds 20 m3/s lose
    water), its outputs bound and netCDF meteo (which the JAX package's run
    needs)."""
    return write_catchment(tmp_path_factory.mktemp("sharded"), 48, 40, seed=0, n_steps=STEPS,
                           outputs=True, meteo_format="netcdf", options={"TransLoss": True})


@pytest.fixture(scope="module")
def catchment_models(catchment):
    """The catchment with RoutingKernel sharded, as both build_models read
    it: (port settings, JAX model, port model)."""
    kw = dict(vars_to_set=SHARDED)
    settings = load_settings(catchment, **kw)
    return (settings, jax_build_model(jax_load_settings(catchment, **kw)),
            build_model(settings))


def _f32_scales(ref):
    """The float32 scales that are not the field's own max:
    CrossSection2Area on Chan2M3Kin/4000 (a difference of storages ~1e6
    times larger), TransCum on the volume the largest discharge passes in a
    day's sub-step at NoRoutSteps 24 (a sum of differences of near-equal
    pow results, tests/test_torch_options.py::_f32_scales)."""
    return {"CrossSection2Area": np.abs(ref["Chan2M3Kin"]).max() / 4000.0,
            "TransCum": np.abs(ref["ChanQ"]).max() * 86400.0 / 24}


def _held(refs, gots, f32):
    """Each step's natural state, key by key, within the module's gates."""
    for i, (ref, got) in enumerate(zip(refs, gots)):
        assert set(ref) == set(got)
        scales = _f32_scales(ref) if f32 else {}
        for k, a in ref.items():
            tol = (3e-5 if i == 0 else 1.5e-4) if f32 else 1e-10
            if f32 and k == "Sideflow1Chan":
                tol = 1e-2
            err = np.abs(a - got[k]).max() / scales.get(k, max(np.abs(a).max(), 1e-30))
            assert err <= tol, f"step {i + 1}, {k}: {err:.3e}"


def _run_jax(cfg, params, state, aux, forcing, dtype):
    step, _ = jax_build_step(cfg, params, aux, dtype=dtype)
    cv = lambda v: jnp.asarray(v, dtype if np.asarray(v).dtype.kind == "f" else None)
    allowed = set(jax_state_keys(cfg))
    s = {k: v for k, v in step.prepare_state({k: cv(v) for k, v in state.items()}).items()
         if k in allowed}
    out = []
    for f in forcing:
        s, _ = step(s, {k: cv(v) for k, v in f.items()})
        out.append({k: np.asarray(v) for k, v in step.natural_state(s).items()})
    return out


def _run_port(cfg, params, state, aux, forcing, dtype):
    multi, _ = build_multi_step(cfg, params, aux, dtype=dtype, device="cpu")
    assert multi.step.pipeline == "substeps"
    s = multi.prepare_state(state)
    assert not any(k.startswith("pk$") for k in s)
    out = []
    for f in forcing:
        s, _ = multi.step(s, to_device(f, "cpu", dtype))
        out.append({k: v.numpy() for k, v in multi.natural_state(s).items()})
    return out, multi.routers


def _jax_config(cfg):
    fields = dataclasses.asdict(cfg)
    assert fields.pop("members") == 1
    return JaxConfig(**fields, routing_pipeline="substeps")


@pytest.fixture(scope="module")
def synthetic_sharded():
    """The synthetic 16x16 model with every option of with_options (split
    routing, lakes, reservoirs, open-water evaporation, water use, inflow,
    transmission loss, the mass-balance reports, ...), routed sharded on 4
    shards, and its forcing."""
    cfg, params, state, aux = with_options(build_synthetic_model(16, 16, no_rout_steps=6,
                                                                 chunk_size=16))
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=4)
    forcing = {**synthetic_forcing(cfg.num_pixels), **aux["forcing_options"]}
    return (cfg, params, state, aux), [forcing] * STEPS


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_step_synthetic_matches_jax(synthetic_sharded, dt):
    """Three steps of the all-options synthetic model, sharded on 4 shards
    with cut edges on the channel graph: the port's sequential loop against
    the JAX package's. Measured 4.8e-14 (float64, CrossSection2Area) and
    6.9e-6 (float32, DischargeM3Out)."""
    (cfg, params, state, aux), forcing = synthetic_sharded
    jdt, tdt = DTYPES[dt]
    refs = _run_jax(_jax_config(cfg), params, state, aux, forcing, jdt)
    gots, routers = _run_port(cfg, params, state, aux, forcing, tdt)
    assert routers["kin"].has_cuts and routers["tochan"].no_edges
    assert len(routers["partition_stats"]["cut_edges"]) > 0
    assert all(k in gots[0] for k in ("TransCum", "LakeStorageM3CC", "ReservoirFillCC",
                                      "Chan2QKin", "WaterInit", "EvaCumM3"))
    _held(refs, gots, dt == "f32")


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_step_catchment_matches_jax(catchment_models, dt):
    """Three days of the 48x40 catchment (split routing, lakes, reservoirs,
    open-water evaporation, mass-balance reports, transmission loss),
    sharded on 4 shards, meteo from its stacks: the port's step against
    the JAX step, each from its own build_model; the overland graph has
    cut edges. Measured 1.3e-12 (float64, TransCum) and 3.3e-5 (float32,
    LakeInflowOldCC, third day)."""
    settings, jmodel, tmodel = catchment_models
    cfg = tmodel[0]
    assert cfg.routing_kernel == "sharded" and cfg.num_shards == 4 and cfg.trans_loss
    assert jmodel[0].num_shards == 4 and cfg.rep_mbts and cfg.split_routing
    forcing = meteo_forcing(settings, cfg, tmodel[3])[:STEPS]
    jdt, tdt = DTYPES[dt]
    refs = _run_jax(dataclasses.replace(jmodel[0], routing_pipeline="substeps"),
                    *jmodel[1:], forcing, jdt)
    gots, routers = _run_port(*tmodel, forcing, tdt)
    assert routers["tochan"].has_cuts and not routers["kin"].has_cuts
    assert np.abs(refs[-1]["TransCum"]).max() > 0
    _held(refs, gots, dt == "f32")


def test_sharded_step_matches_packed(catchment_models):
    """The port's sharded step against its packed step (the sub-step
    kernel's plain version), float64, three days: rtol 1e-9, atol 1e-9, as
    the JAX package holds its own (tests/test_model.py:123-127). Measured
    4.8e-13 of TransCum's max."""
    settings, _, (cfg, params, state, aux) = catchment_models
    forcing = meteo_forcing(settings, cfg, aux)[:STEPS]
    sharded, _ = _run_port(cfg, params, state, aux, forcing, torch.float64)
    packed_cfg = dataclasses.replace(cfg, routing_kernel="packed", num_shards=1)
    multi, _ = build_multi_step(packed_cfg, params, aux, dtype=torch.float64, device="cpu")
    assert multi.step.pipeline == "reference"
    s = multi.prepare_state(state)
    for f in forcing:
        s, _ = multi.step(s, to_device(f, "cpu", torch.float64))
    packed = {k: v.numpy() for k, v in multi.natural_state(s).items()}
    assert set(packed) == set(sharded[-1])
    for k, v in packed.items():
        np.testing.assert_allclose(sharded[-1][k], v, rtol=1e-9, atol=1e-9, err_msg=k)


def _settings_copy(path, out_dir, xml):
    """`path`'s settings with RoutingKernel sharded on 4 shards, the JAX
    package's sequential loop and PathOut `out_dir`, written to `xml`."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r'name="PathOut" value="[^"]*"', f'name="PathOut" value="{out_dir}"', text)
    bindings = {**SHARDED, "RoutingPipeline": "substeps"}
    text = text.replace("<lfbinding>", "<lfbinding>\n" + "\n".join(
        f'  <textvar name="{k}" value="{v}"/>' for k, v in bindings.items()))
    with open(xml, "w") as fh:
        fh.write(text)


def test_command_line_sharded_matches_jax(catchment, tmp_path, monkeypatch):
    """A settings file that says RoutingKernel sharded through both
    packages' command lines (`main([settings, "-v"])`, the production
    lisfloodexe run), float64, three days, into the same PathOut in turn:
    the same TSS files, their rows within 1e-10 of each series' max, and
    the end state within 1e-10 of each field's max (CrossSection2Area on
    the Chan2M3Kin/4000 scale)."""
    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    xml = str(tmp_path / "settings.xml")
    _settings_copy(catchment, out_dir, xml)
    runners = {}
    for key, module in (("jax", jax_main_module), ("port", port_main)):
        run = module.lisfloodexe
        monkeypatch.setattr(module, "lisfloodexe", lambda *a, _run=run, _key=key, **k:
                            runners.setdefault(_key, _run(*a, **k)))
    assert jax_main_module.main([xml, "-v"]) == 0
    shutil.move(out_dir, out_dir + "_jax")
    os.makedirs(out_dir)
    assert port_main.main([xml, "-v"], device="cpu") == 0
    jax_runner, port_runner = runners["jax"], runners["port"]
    assert port_runner.config.routing_kernel == "sharded" and port_runner.config.num_shards == 4
    assert port_runner.dtype == torch.float64 and port_runner.step.pipeline == "substeps"
    tss = sorted(n for n in os.listdir(out_dir) if n.endswith(".tss"))
    assert "dis.tss" in tss and tss == sorted(n for n in os.listdir(out_dir + "_jax")
                                              if n.endswith(".tss"))
    for name in tss:
        (ia, ra, sa), (ib, rb, sb) = (read_tss(os.path.join(d, name))
                                      for d in (out_dir + "_jax", out_dir))
        assert ia == ib and np.array_equal(sa, sb) and len(sa) == STEPS, name
        assert np.abs(ra - rb).max() <= 1e-10 * max(np.abs(ra).max(), 1e-30), name
    ref = jax_runner.state
    assert set(ref) == set(port_runner.state)
    for k, v in ref.items():
        v = np.asarray(v, np.float64)
        scale = (np.abs(np.asarray(ref["Chan2M3Kin"])).max() / 4000.0
                 if k == "CrossSection2Area" else max(np.abs(v).max(), 1e-30))
        err = np.abs(port_runner.state[k].numpy() - v).max() / scale
        assert err <= 1e-10, f"{k}: {err:.3e}"


