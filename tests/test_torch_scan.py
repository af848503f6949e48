"""RoutingKernel scan in the port (lisflood_tpu_torch) against the JAX
package's: the natural-order router (ops/kinwave.py, the plain version of
K6 on its natural tables on the CPU) below the step, the step through
build_multi_step on the synthetic model with every option of with_options
and on a catchment written by models/synthetic.write_catchment, the three
routers against each other, and both command lines. The same NumPy inputs
go through both packages; the JAX steps run its sequential sub-step loop
(`routing_pipeline substeps`).

Gates: the routers at 1e-12 of each lane's max in float64; the step within
1e-10 of each field's max in float64, and in float32 within 3e-5 after one
step and 1.5e-4 after more (CrossSection2Area on the Chan2M3Kin/4000 scale,
Sideflow1Chan within 1e-2, TransCum on the scale of the volume the largest
discharge passes in a sub-step, as tests/test_torch_sharded_step.py holds
them); scan against packed and sharded at rtol 1e-9, atol 1e-9 in float64,
as tests/test_model.py:81-127 holds the JAX package's."""
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
from lisflood_tpu.graph.ldd import build_schedule as jax_build_schedule
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu.ops.kinwave import KinematicWaveRouter as JaxKinematicWaveRouter
from lisflood_tpu.ops.kinwave import ScanRouter as JaxScanRouter
from lisflood_tpu_torch import main as port_main
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.convert import schedule_from_reference
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options, write_catchment)
from lisflood_tpu_torch.ops import kinwave as kw
from lisflood_tpu_torch.ops import kinwave_sharded as kss
from test_torch_sharded_step import DTYPES, STEPS, _held, _jax_config, _run_jax, _run_port

SCAN = {"RoutingKernel": "scan"}


def _lanes(P, L, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (L, P)) for lo, hi in ((0, 100), (0, 5), (1e-3, 1e3))]


@pytest.mark.parametrize("L", [1, 3])
def test_router_matches_jax(L):
    """ScanRouter.route_batched on the synthetic 48x40 channel graph (chunk
    64) against the JAX ScanRouter, float64, L lanes: within 1e-12 of each
    lane's max; `_route_batched` is the plain version of the wrapper on the
    CPU, bit for bit, and K6's tables tile every pixel."""
    cfg, params, state, aux = build_synthetic_model(48, 40, chunk_size=64)
    sched = aux["schedule_kin"]
    router = kw.ScanRouter(schedule_from_reference(sched), device="cpu")
    q0, lat, adx = (torch.as_tensor(a) for a in _lanes(cfg.num_pixels, L))
    got = router.route_batched(q0, lat, adx, 0.6)
    ref = np.asarray(JaxScanRouter(sched).route_batched(*(jnp.asarray(a.numpy())
                                                          for a in (q0, lat, adx)), 0.6))
    err = np.abs(got.numpy() - ref).max(1) / np.abs(ref).max(1)
    assert err.max() <= 1e-12, err
    plain = kw._route_batched(q0, lat, adx, router.chunks, router.ups.long(), 0.6)
    assert torch.equal(got, plain)
    tiles = router.sweep_tiles()
    assert tiles.pad.numel() == 0 and int(tiles.count.sum()) == cfg.num_pixels
    assert not router.no_edges and router.pack(q0) is q0 and router.unpack(q0) is q0


def test_kinematic_wave_router_matches_jax():
    """KinematicWaveRouter.routing, main channel and floodplains, against the
    JAX package's on a built schedule with spatial alpha, float64: within
    1e-12 of the field's max."""
    cfg, params, state, aux = build_synthetic_model(32, 24, chunk_size=32)
    graph = aux["graph_kin"]
    sched = jax_build_schedule(graph, chunk_size=32)
    rng = np.random.default_rng(2)
    P = graph.num_pixels
    alpha, alpha2 = rng.uniform(0.5, 5, P), rng.uniform(2, 20, P)
    dx = rng.uniform(500, 5000, P)
    jr = JaxKinematicWaveRouter.build(sched, alpha, 0.6, dx, 3600.0, alpha_floodplains=alpha2)
    tr = kw.KinematicWaveRouter.build(schedule_from_reference(sched), alpha, 0.6, dx, 3600.0,
                                      alpha_floodplains=alpha2, device="cpu")
    q, side = rng.uniform(0, 50, P), rng.uniform(0, 1e-3, P)
    for section in ("main_channel", "floodplains"):
        ref = np.asarray(jr.routing(jnp.asarray(q), jnp.asarray(side), section=section))
        got = tr.routing(torch.as_tensor(q), torch.as_tensor(side), section=section).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), section
    with pytest.raises(ValueError):
        tr.routing(torch.as_tensor(q), torch.as_tensor(side), section="bank")


@pytest.fixture(scope="module")
def synthetic_scan():
    """The synthetic 16x16 model with every option of with_options, routed
    scan, and its forcing."""
    cfg, params, state, aux = with_options(build_synthetic_model(16, 16, no_rout_steps=6,
                                                                 chunk_size=16))
    cfg = dataclasses.replace(cfg, routing_kernel="scan", num_shards=1)
    forcing = {**synthetic_forcing(cfg.num_pixels), **aux["forcing_options"]}
    return (cfg, params, state, aux), [forcing] * STEPS


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_step_synthetic_matches_jax(synthetic_scan, dt):
    """Three steps of the all-options synthetic model routed scan: the
    port's sequential loop against the JAX package's."""
    (cfg, params, state, aux), forcing = synthetic_scan
    jdt, tdt = DTYPES[dt]
    refs = _run_jax(_jax_config(cfg), params, state, aux, forcing, jdt)
    gots, routers = _run_port(cfg, params, state, aux, forcing, tdt)
    assert isinstance(routers["kin"], kw.ScanRouter) and routers["tochan"].no_edges
    assert not routers["kin"].no_edges
    assert all(k in gots[0] for k in ("TransCum", "LakeStorageM3CC", "ReservoirFillCC",
                                      "Chan2QKin", "WaterInit", "EvaCumM3"))
    _held(refs, gots, dt == "f32")


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """A 48x40 catchment with its outputs bound and netCDF meteo (which the
    JAX package's run needs)."""
    return write_catchment(tmp_path_factory.mktemp("scan"), 48, 40, seed=0, n_steps=STEPS,
                           outputs=True, meteo_format="netcdf")


@pytest.fixture(scope="module")
def catchment_models(catchment):
    """The catchment with RoutingKernel scan as both build_models read it:
    (port settings, JAX model, port model)."""
    settings = load_settings(catchment, vars_to_set=SCAN)
    return (settings, jax_build_model(jax_load_settings(catchment, vars_to_set=SCAN)),
            build_model(settings))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_step_catchment_matches_jax(catchment_models, dt):
    """Three days of the 48x40 catchment (split routing, lakes, reservoirs,
    open-water evaporation, mass-balance reports) routed scan, meteo from
    its stacks: the port's step against the JAX step, each from its own
    build_model; both graphs have edges, so K6's plain version routes
    both."""
    settings, jmodel, tmodel = catchment_models
    cfg = tmodel[0]
    assert cfg.routing_kernel == "scan" and jmodel[0].routing_kernel == "scan" and cfg.rep_mbts
    forcing = meteo_forcing(settings, cfg, tmodel[3])[:STEPS]
    jdt, tdt = DTYPES[dt]
    refs = _run_jax(dataclasses.replace(jmodel[0], routing_pipeline="substeps"),
                    *jmodel[1:], forcing, jdt)
    gots, routers = _run_port(*tmodel, forcing, tdt)
    assert not routers["kin"].no_edges and not routers["tochan"].no_edges
    assert set(routers["seconds"]) == {"router_kin", "router_tochan"}
    _held(refs, gots, dt == "f32")


def _port_states(cfg, params, state, aux, forcing, kernel, **extra):
    step, _ = build_step(dataclasses.replace(cfg, routing_kernel=kernel, **extra), params, aux,
                         dtype=torch.float64, device="cpu")
    s = step.prepare_state(state)
    for f in forcing:
        s, _ = step(s, {k: torch.as_tensor(v) for k, v in f.items()})
    return {k: v.numpy() for k, v in step.natural_state(s).items()}


def test_routers_agree(catchment_models):
    """The port's three routers on the catchment, float64, three days: scan
    against packed and against sharded (4 shards), rtol 1e-9, atol 1e-9, as
    tests/test_model.py:81-127 holds the JAX package's."""
    settings, _, (cfg, params, state, aux) = catchment_models
    forcing = meteo_forcing(settings, cfg, aux)[:STEPS]
    scan = _port_states(cfg, params, state, aux, forcing, "scan")
    for kernel, extra in (("packed", {}), ("sharded", {"num_shards": 4})):
        other = _port_states(cfg, params, state, aux, forcing, kernel, **extra)
        assert set(other) == set(scan)
        for k, v in other.items():
            np.testing.assert_allclose(scan[k], v, rtol=1e-9, atol=1e-9, err_msg=f"{kernel} {k}")


def test_sweep_dispatch():
    """kinwave_sharded_sweep on natural tables: the CPU runs the plain
    version of the tiles (kinwave._sweep_scan), bit for bit with
    _route_batched, and a shape other than (L, P) raises."""
    cfg, params, state, aux = build_synthetic_model(24, 20, chunk_size=16)
    router = kw.ScanRouter(schedule_from_reference(aux["schedule_kin"]), device="cpu")
    q0, lat, adx = (torch.as_tensor(a) for a in _lanes(cfg.num_pixels, 2, seed=4))
    const, adx_e = router.sweep_operands(q0, lat, adx, 0.6)
    tiles = router.sweep_tiles(64)
    got = kss.kinwave_sharded_sweep(const, adx_e, tiles, 0.6)
    assert torch.equal(got, kw._route_batched(q0, lat, adx, router.chunks, router.ups.long(), 0.6))
    assert tiles.p_pad == cfg.num_pixels and tiles.n_tiles > 1
    with pytest.raises(ValueError):
        kss.kinwave_sharded_sweep(const[:, :-1], adx_e[:, :-1], tiles, 0.6)


def _settings_copy(path, out_dir, xml):
    """`path`'s settings with RoutingKernel scan, the JAX package's
    sequential loop and PathOut `out_dir`, written to `xml`."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r'name="PathOut" value="[^"]*"', f'name="PathOut" value="{out_dir}"', text)
    bindings = {**SCAN, "RoutingPipeline": "substeps"}
    text = text.replace("<lfbinding>", "<lfbinding>\n" + "\n".join(
        f'  <textvar name="{k}" value="{v}"/>' for k, v in bindings.items()))
    with open(xml, "w") as fh:
        fh.write(text)


def test_command_line_scan_matches_jax(catchment, tmp_path, monkeypatch):
    """A settings file that says RoutingKernel scan through both packages'
    command lines (`main([settings, "-v"])`, the production lisfloodexe
    run), float64, three days, into the same PathOut in turn: the same TSS
    files, their rows within 1e-10 of each series' max, and the end state
    within 1e-10 of each field's max (CrossSection2Area on the
    Chan2M3Kin/4000 scale)."""
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
    assert port_runner.config.routing_kernel == "scan"
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
