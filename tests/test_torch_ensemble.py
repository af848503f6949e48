"""The port's ensemble (lisflood_tpu_torch/models/ensemble.py) against the
JAX package's: the M-member model folded into the pixel axis, its
interleaved schedule and tables; the ensemble step against `jax.vmap` of
the JAX step over the same stacked states; each member against the port's
single step; the perturbation, the EnKF analysis and the state dumps.

M = 3 members of the small synthetic model, whose states differ by a
perturbation drawn with numpy. Float64 is held within 1e-10 of each field's
largest magnitude, float32 within 3e-5 after one step (the gates of
tests/test_torch_step.py)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lisflood_tpu.models.config import ModelConfig as JaxConfig
from lisflood_tpu.models.ensemble import EnsembleRunner as JaxEnsembleRunner
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.ensemble import (EnsembleRunner, ensemble_model, fold_states,
                                                member_state, perturb_state, replicate_schedule,
                                                tile_forcing)
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options)
from lisflood_tpu_torch.ops.kinwave_packed import pack_schedule
from lisflood_tpu_torch.ops.kinwave_substep import ring_slots

SIZE = dict(nrows=24, ncols=20, no_rout_steps=6, chunk_size=64)
M = 3
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
PERTURBED = ("UZ", "LZ", "SnowCoverS", "ChanQKin", "ChanM3Kin", "ChanQ")


def jax_config(cfg, **kw):
    fields = dataclasses.asdict(cfg)
    assert fields.pop("members") == 1
    return JaxConfig(**fields, routing_pipeline="substeps", **kw)


def model_of(name):
    base = build_synthetic_model(**SIZE)
    return with_options(base) if name == "options" else base


def member_inputs(state, seed=0):
    """M natural-space member states: the model's, some fields scaled by
    0.9-1.1 per member and element."""
    rng = np.random.default_rng(seed)
    return [{k: (v * rng.uniform(0.9, 1.1, np.shape(v)) if k in PERTURBED else v)
             for k, v in state.items()} for _ in range(M)]


def forcing_of(cfg, aux):
    return {**synthetic_forcing(cfg.num_pixels), **aux.get("forcing_options", {})}


def rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# the folded model


def test_replicated_model_and_schedule():
    """The M-member model: counts, index offsets (pits stay pits), the
    interleaved schedule with window W M, the kernel's tables of each
    member's chunks mapped onto the interleaved positions, and both kernel
    conditions (feeders earlier, evaporation edges in the window) kept."""
    cfg, params, state, aux = model_of("options")
    cfg_e, p_e, aux_e = ensemble_model(cfg, params, aux, M)
    P = cfg.num_pixels
    assert (cfg_e.num_pixels, cfg_e.members, cfg_e.grid_rows) == (M * P, M, M * cfg.grid_rows)
    assert cfg_e.num_catchments == M * cfg.num_catchments and cfg_e.num_lakes == M * cfg.num_lakes
    for m in range(M):
        sl = slice(m * P, (m + 1) * P)
        np.testing.assert_array_equal(p_e["LakeIndex"][m * 2:(m + 1) * 2], params["LakeIndex"] + m * P)
        down = p_e["downstruct"][sl]
        np.testing.assert_array_equal(down, np.where(params["downstruct"] < P,
                                                     params["downstruct"] + m * P, M * P))
        np.testing.assert_array_equal(p_e["Catchments"][sl], params["Catchments"] + m * cfg.num_catchments)
        np.testing.assert_array_equal(p_e["WUseRegionC"][sl], params["WUseRegionC"] + m * 4)
        np.testing.assert_array_equal(p_e["LandRows"][sl], params["LandRows"] + m * cfg.grid_rows)
        np.testing.assert_array_equal(p_e["LAIX"][..., sl], params["LAIX"])

    single, folded = pack_schedule(aux["schedule_kin"]), pack_schedule(aux_e["schedule_kin"])
    assert folded.n_chunks == M * single.n_chunks and folded.window == M * single.window
    sched = replicate_schedule(aux["schedule_kin"], M)
    for m in range(M):
        ch = sched.chunks[m::M]
        np.testing.assert_array_equal(ch, np.where(aux["schedule_kin"].chunks < P,
                                                   aux["schedule_kin"].chunks + m * P, M * P))

    step1, p1 = build_step(cfg, params, aux, device="cpu")
    step_e, pe = build_step(cfg_e, p_e, aux_e, device="cpu")
    kin = step_e.routers["kin"]
    assert kin.struct_feeders_earlier and kin.eva_window_ok and step_e.eva_in_kernel
    n1 = single.n_chunks
    deps1, deps_e = p1["kinp$wf_deps"].numpy(), pe["kinp$wf_deps"].numpy()
    for m in range(M):
        mapped = np.where(deps1 >= 0, deps1 * M + m, -1)
        np.testing.assert_array_equal(deps_e[m::M][:, :deps1.shape[1]], mapped)
        assert (deps_e[m::M][:, deps1.shape[1]:] == -1).all()
    assert pe["kinp$wf_sdep_list"].numel() == M * p1["kinp$wf_sdep_list"].numel()
    assert ring_slots(96, type("S", (), {"window": kin.ps.window, "n_chunks": M * n1})) == \
        min(2 * 96 + M * single.window, M * n1)


def test_fold_round_trip():
    """fold_states and member_state are inverse; a shared scalar that the
    members disagree on is refused."""
    cfg, params, state, aux = model_of("options")
    states = member_inputs(state)
    step1, _ = build_step(cfg, params, aux, device="cpu")
    packed = [{k: v.numpy() for k, v in step1.prepare_state(s).items()} for s in states]
    C = step1.routers["kin"].ps.chunk
    folded = fold_states(packed, C)
    for m in range(M):
        back = member_state(folded, m, M, C)
        for k, v in packed[m].items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    packed[1]["TimeSinceStart"] = np.float64(3.0)
    with pytest.raises(ValueError, match="TimeSinceStart"):
        fold_states(packed, C)


# ---------------------------------------------------------------------------
# the ensemble step against the JAX package's vmap


def _vmap_both(name, dt, n_steps=1):
    """Each member's natural state after the steps: (JAX, port) lists."""
    jdt, tdt = DTYPES[dt]
    cfg, params, state, aux = model_of(name)
    states = member_inputs(state)
    forcing = forcing_of(cfg, aux)

    step, _ = jax_build_step(jax_config(cfg), params, aux, dtype=jdt)
    cv = lambda v: jnp.asarray(v, jdt if np.asarray(v).dtype.kind == "f" else None)
    members = [step.prepare_state({k: cv(v) for k, v in s.items()}) for s in states]
    s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    # vmap of the jitted step; jax.jit around the vmap (as the JAX
    # package's EnsembleRunner has it) is wrong on this CPU backend: soil
    # moisture 2.9% off the single step (ROADMAP.md Queue 3)
    vstep = jax.vmap(step, in_axes=(0, None))
    f = {k: cv(v) for k, v in forcing.items()}
    for _ in range(n_steps):
        s, _ = vstep(s, f)
    ref = [{k: np.asarray(v) for k, v in
            step.natural_state({k: v[m] for k, v in s.items()}).items()} for m in range(M)]

    cfg_e, p_e, aux_e = ensemble_model(cfg, params, aux, M)
    port, _ = build_step(cfg_e, p_e, aux_e, dtype=tdt, device="cpu")
    s_t = port.prepare_state(fold_states(states, port.routers["kin"].ps.chunk), tdt)
    f_t = tile_forcing(to_device(forcing, "cpu", tdt), M, cfg.num_pixels)
    for _ in range(n_steps):
        s_t, _ = port(s_t, f_t)
    nat = {k: v.numpy() for k, v in port.natural_state(s_t).items()}
    got = [member_state(nat, m, M, 0) for m in range(M)]
    return ref, got


@pytest.mark.parametrize("name,dt,tol", [("main", "f64", 1e-10), ("main", "f32", 3e-5),
                                         ("options", "f64", 1e-10)])
def test_ensemble_step_matches_vmap(name, dt, tol):
    """One ensemble step against jax.vmap(step, in_axes=(0, None)) on the
    same stacked states, every state entry of every member: the main path
    in float64 (measured 1.4e-12, CrossSection2Area) and float32 (one-step
    gates: 3e-5, 1e-2 for the cancellation-amplified CrossSection2Area and
    Sideflow1Chan; measured 2.6e-5 on ChanQ, as for one model), and the
    all-options model in float64, where groundwater smoothing's mean
    correction is per member (measured 5.7e-13)."""
    ref, got = _vmap_both(name, dt)
    loose = {"CrossSection2Area": 1e-2, "Sideflow1Chan": 1e-2} if dt == "f32" else {}
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for k in r:
            err = rel_err(g[k], r[k])
            assert err <= loose.get(k, tol), f"{k}: {err:.3e}"
    assert rel_err(got[0]["LZ"], got[1]["LZ"]) > 1e-4       # the members differ


_MEMBER_CHECK = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
from tests.test_torch_ensemble import member_vs_single
print(member_vs_single({name!r}, torch.{dt}))
"""


def member_vs_single(name, dtype, n_steps=2):
    """The largest relative difference, over members and state entries,
    between member m of the ensemble and the port's single step on member
    m's state, after `n_steps` steps."""
    cfg, params, state, aux = model_of(name)
    states = member_inputs(state)
    f = to_device(forcing_of(cfg, aux), "cpu", dtype)
    cfg_e, p_e, aux_e = ensemble_model(cfg, params, aux, M)
    step_e, _ = build_step(cfg_e, p_e, aux_e, dtype=dtype, device="cpu")
    C = step_e.routers["kin"].ps.chunk
    s_e = step_e.prepare_state(fold_states(states, C), dtype)
    step1, _ = build_step(cfg, params, aux, dtype=dtype, device="cpu")
    singles = [step1.prepare_state(s, dtype) for s in states]
    for _ in range(n_steps):
        s_e, _ = step_e(s_e, tile_forcing(f, M, cfg.num_pixels))
        singles = [step1(s, f)[0] for s in singles]
    worst = 0.0
    for m in range(M):
        mine = member_state(s_e, m, M, C)
        for k, v in singles[m].items():
            if not torch.equal(torch.nan_to_num(mine[k]), torch.nan_to_num(v)):
                worst = max(worst, float((mine[k] - v).abs().max() / v.abs().max()))
    return worst


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_member_matches_single_step(dt):
    """Member m of the ensemble against the port's single Step on member m's
    state, all-options model, two steps: bitwise with PyTorch's CPU kernels
    in plain C++ (ATEN_CPU_CAPABILITY=default). With the SIMD kernels
    float64 may differ in the last bit (measured 0 here; 9.1e-17 on three
    cells when the soil moisture of the members is perturbed too): the
    soil's Courant sub-steps compact the lanes that need more of them into
    one short vector, a member's lanes start at another offset there than
    the single model's, and a lane that moves between the vector body and
    the scalar remainder gets `pow` from the other implementation."""
    code = _MEMBER_CHECK.format(root=os.path.dirname(os.path.dirname(__file__)),
                                name="options", dt=dt)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "ATEN_CPU_CAPABILITY": "default"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip().splitlines()[-1]) == 0.0
    assert member_vs_single("options", getattr(torch, dt)) <= (0.0 if dt == "float32" else 1e-15)


# ---------------------------------------------------------------------------
# perturbation, analysis, dumps


def test_perturb_state():
    """The same generator seed gives the same draw and another seed another;
    only the named fields change; the clamp at min_val holds."""
    cfg, params, state, aux = model_of("main")
    s = to_device(state, "cpu", torch.float64)
    draw = lambda seed, sigma=0.05, **kw: perturb_state(
        torch.Generator().manual_seed(seed), s, ("UZ", "LZ"), sigma, **kw)
    a, b, c = draw(4), draw(4), draw(5)
    for k in s:
        if k in ("UZ", "LZ"):
            assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]) and not torch.equal(a[k], s[k])
        else:
            assert a[k] is s[k]
    wide = draw(4, sigma=5.0, min_val=1.0)
    assert float(wide["UZ"].min()) == 1.0 and float(wide["LZ"].min()) == 1.0
    rel = (a["LZ"] / s["LZ"] - 1.0) / 0.05
    assert abs(float(rel.mean())) < 0.2 and 0.8 < float(rel.std()) < 1.2


@pytest.fixture(scope="module")
def runners():
    """The port's runner and a JAX EnsembleRunner (driven by a stub runner)
    on the same float64 member states after one step."""
    cfg, params, state, aux = model = model_of("main")
    port = EnsembleRunner(model, M, dtype=torch.float64, device="cpu")
    step, _ = jax_build_step(jax_config(cfg), params, aux)
    states = member_inputs(state, seed=1)
    port.state = port.fold(states)
    port.advance({k: v[None] for k, v in to_device(forcing_of(cfg, aux), "cpu", torch.float64).items()})
    jax_runner = JaxEnsembleRunner.__new__(JaxEnsembleRunner)
    jax_runner.n = M
    jax_runner.runner = type("Stub", (), {"step_fn": step})()
    members = [{k: jnp.asarray(v) for k, v in s.items()} for s in port.member_states()]
    jax_runner.state = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    return port, jax_runner


def gauge_values(port, field, gauges):
    """(M, n_gauges) values of a schedule-packed state field at the single
    model's pixels `gauges`."""
    pos = port.step.routers["kin"].ps.inv_perm[
        (np.arange(M)[:, None] * port.pixels + gauges[None]).reshape(-1)]
    return port.state["pk$" + field][torch.as_tensor(pos)].numpy().reshape(M, -1)


def test_enkf_analysis_matches_jax(runners):
    """enkf_analysis against the JAX package's on the same ensemble, gauges
    at the outlets (up to four) and one inner pixel: every analysed field of every
    member within 1e-10 (measured 1.9e-16); the analysed discharge
    (ChanQKin) at the gauges moves toward the observation."""
    port, jax_runner = runners
    cfg, params = build_synthetic_model(**SIZE)[:2]
    gauges = np.r_[np.flatnonzero(params["AtLastPointC"])[:4], cfg.num_pixels // 2]
    hx = port._gauge_discharge(gauges)
    np.testing.assert_allclose(hx, jax_runner._gauge_discharge(gauges), rtol=0, atol=0)
    # an observation two ensemble spreads above the mean, a tenth of a
    # spread accurate
    obs = hx.mean(0) + 2 * hx.std(0)
    sigma = 0.1 * hx.std(0)
    before = gauge_values(port, "ChanQKin", gauges).mean(0)
    ref = jax_runner.enkf_analysis(obs, gauges, sigma, seed=7)
    port.enkf_analysis(obs, gauges, sigma, seed=7)
    after = gauge_values(port, "ChanQKin", gauges).mean(0)
    assert np.abs(after - obs).sum() < np.abs(before - obs).sum()
    got = port.member_states()
    for m in range(M):
        for k in ("pk$ChanQKin", "pk$ChanM3Kin", "UZ", "LZ", "W1a", "W1b", "W2"):
            err = rel_err(got[m][k], np.asarray(ref[k][m]))
            assert err <= 1e-10, f"member {m} {k}: {err:.3e}"


def test_dump_load_round_trip(runners, tmp_path):
    """dump_states then load_states gives the same state back; a JAX dump
    of the same ensemble loads into the port as the same state, and the
    port's dump into the JAX runner."""
    port, jax_runner = runners
    members = [{k: jnp.asarray(v) for k, v in s.items()} for s in port.member_states()]
    jax_runner.state = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    before = {k: v.clone() for k, v in port.state.items()}
    port.dump_states(str(tmp_path / "port"), 5)
    assert sorted(os.listdir(tmp_path / "port")) == [f"stateVar_{m}_5.npz" for m in range(1, M + 1)]
    port.state = {k: torch.zeros_like(v) for k, v in before.items()}
    port.load_states(str(tmp_path / "port"), 5)
    for k, v in before.items():
        assert torch.equal(port.state[k], v), k
    jax_runner.dump_states(str(tmp_path / "jax"), 5)
    port.load_states(str(tmp_path / "jax"), 5)
    for k, v in before.items():
        assert torch.equal(port.state[k], v), k
    jax_runner.load_states(str(tmp_path / "port"), 5)
    assert set(jax_runner.state) == set(before)


@pytest.mark.parametrize("members", [2, 3])
def test_eva_stencil_chosen_per_member(members):
    """The evaporation stencil is chosen by a member's grid: an ensemble of a
    model with P <= 200,000 and M·P above it answers as its single model on
    a CUDA device (use_eva_stencil reads only the device's type, so no card
    is needed), and the CPU keeps the segment-sum form in both."""
    cfg = dataclasses.replace(build_synthetic_model(**SIZE)[0], num_pixels=150_000)
    folded = dataclasses.replace(cfg, num_pixels=members * cfg.num_pixels, members=members)
    assert folded.num_pixels > 200_000
    assert folded.use_eva_stencil("cuda") == cfg.use_eva_stencil("cuda") is True
    assert folded.use_eva_stencil("cpu") == cfg.use_eva_stencil("cpu") is False
    large = dataclasses.replace(cfg, num_pixels=250_000)
    assert dataclasses.replace(large, num_pixels=members * 250_000,
                               members=members).use_eva_stencil("cuda") is False
