"""The folded ensemble (lisflood_tpu_torch/models/ensemble.py) with
RoutingKernel sharded and scan: the single model's sharded schedules
replicated (member m's shard s is shard m S + s) or its natural schedules
replicated, one sweep of K6's plain version a sub-step for all members.

Held to the JAX package's `jax.vmap(step, in_axes=(0, None))` of its
sharded and scan steps on the same stacked states (unjitted around the
vmap: jax.jit(jax.vmap) is wrong on XLA's CPU backend, ROADMAP.md Queue 3),
float64 within 1e-10 and float32 within 3e-5 of each field's largest
magnitude (1e-2 for the cancellation-amplified CrossSection2Area and
Sideflow1Chan, as tests/test_torch_ensemble.py holds the packed ensemble);
each member bit for bit to the port's single step; and through
run_from_settings (MonteCarlo and EnKF from the settings of a
write_catchment catchment, whose overland graph has edges), each member's
outputs up to the filter step to a single run from its perturbed start."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lisflood_tpu.models.step import build_step as jax_build_step
from lisflood_tpu.models.step import state_keys as jax_state_keys
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.driver import lisfloodexe
from lisflood_tpu_torch.models.ensemble import (EnsembleRunner, ensemble_model, fold_states,
                                                member_state, tile_forcing)
from lisflood_tpu_torch.models.step import build_step, sharded_schedules
from lisflood_tpu_torch.ops.kinwave_sharded import (ShardedRouter, replicate_sharded_schedule,
                                                    upstream_positions)
from lisflood_tpu_torch.ops.kinwave import ScanRouter
from lisflood_tpu_torch.io.tss import read_tss
from lisflood_tpu_torch.models.synthetic import build_synthetic_model, with_options, write_catchment
from test_torch_driver_ensemble import _held, _single_run, _starts
from test_torch_ensemble import (DTYPES, M, forcing_of, jax_config, member_inputs, model_of,
                                 rel_err)

# (routing kernel, shards) of each router
ROUTERS = {"sharded-1": ("sharded", 1), "sharded-3": ("sharded", 3),
           "sharded-4": ("sharded", 4), "scan": ("scan", 1)}


def routed(name, router, small=True, no_rout_steps=6):
    """The synthetic model with every option of with_options for name
    "options", the main path's for "main", with the router's RoutingKernel
    and shards: 16x16 (NoRoutSteps 6, chunk 16), or with `small` False
    tests/test_torch_ensemble.py's 24x20, on which the float32 gates were
    measured (the JAX package's single float32 step and the port's differ
    by 3.8e-5 of ChanQ's max on the 16x16 main path, with every router)."""
    if small:
        base = build_synthetic_model(16, 16, no_rout_steps=no_rout_steps, chunk_size=16)
        cfg, params, state, aux = with_options(base) if name == "options" else base
    else:
        cfg, params, state, aux = model_of(name)
    kernel, shards = ROUTERS[router]
    return dataclasses.replace(cfg, routing_kernel=kernel, num_shards=shards), params, state, aux


def test_replicated_sharded_schedule():
    """replicate_sharded_schedule of the 3-shard channel schedule: member m's
    positions are the single schedule's plus m p_pad, in its order, with its
    shards numbered m S + s; every edge stays in its member and lands in a
    later chunk; each position's sources are the single model's, offset;
    the cut edges are the members' own, listed member by member."""
    cfg, params, state, aux = routed("options", "sharded-3")
    single = sharded_schedules(cfg, aux)
    ps = single["kin"]
    folded = replicate_sharded_schedule(ps, M)
    P, p_pad = ps.num_pixels, ps.p_pad
    assert (folded.n_shards, folded.n_chunks, folded.chunk, folded.window) == \
        (M * ps.n_shards, ps.n_chunks, ps.chunk, ps.window)
    assert folded.p_pad == M * p_pad and folded.num_pixels == M * P
    for m in range(M):
        sl = slice(m * p_pad, (m + 1) * p_pad)
        np.testing.assert_array_equal(folded.perm[sl], np.where(ps.perm < P, ps.perm + m * P,
                                                                M * P))
        np.testing.assert_array_equal(folded.inv_perm[m * P:(m + 1) * P], ps.inv_perm + m * p_pad)
        np.testing.assert_array_equal(folded.down_pos[sl], np.where(
            ps.down_pos < p_pad, ps.down_pos + m * p_pad, M * p_pad))
    np.testing.assert_array_equal(folded.perm[folded.inv_perm], np.arange(M * P))
    has = folded.down_pos < folded.p_pad
    chunk_of = (np.arange(folded.p_pad) % (ps.n_chunks * ps.chunk)) // ps.chunk
    assert (chunk_of[folded.down_pos[has]] > chunk_of[has]).all()
    ups1, ups = upstream_positions(ps), upstream_positions(folded)
    for m in range(M):
        want = np.where(ups1 >= 0, ups1 + m * p_pad, -1)
        np.testing.assert_array_equal(ups[:ups1.shape[0], m * p_pad:(m + 1) * p_pad], want)
    pad = ps.n_shards * ps.chunk
    n_cut = (ps.cut_src != pad).sum(1)
    assert n_cut.sum() > 0
    np.testing.assert_array_equal((folded.cut_src != M * pad).sum(1), M * n_cut)
    for c in np.flatnonzero(n_cut):
        src = folded.cut_src[c, :M * n_cut[c]].reshape(M, -1)
        dst = folded.cut_dst[c, :M * n_cut[c]].reshape(M, -1)
        for m in range(M):
            np.testing.assert_array_equal(src[m], ps.cut_src[c, :n_cut[c]] + m * pad)
            np.testing.assert_array_equal(dst[m], ps.cut_dst[c, :n_cut[c]]
                                          + m * ps.n_shards * ps.window * ps.chunk)
    assert ShardedRouter(folded, device="cpu").has_cuts


def test_fold_round_trip_natural_state():
    """With the sharded router the state is natural (no pk$ entry):
    fold_states joins the members along the pixel axis, member_state takes
    them apart again, and the ensemble's gauge discharge reads ChanQ at
    each member's pixels."""
    cfg, params, state, aux = routed("options", "sharded-4")
    states = member_inputs(state)
    step1, _ = build_step(cfg, params, aux, device="cpu")
    prepared = [{k: v.numpy() for k, v in step1.prepare_state(s).items()} for s in states]
    assert not any(k.startswith("pk$") for k in prepared[0])
    folded = fold_states(prepared, step1.routers["kin"].ps.chunk)
    for m in range(M):
        back = member_state(folded, m, M, 0)
        for k, v in prepared[m].items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    ens = EnsembleRunner((cfg, params, state, aux), M, dtype=torch.float64, device="cpu")
    ens.state = ens.fold(states)
    gauges = np.array([0, 7, cfg.num_pixels - 1])
    np.testing.assert_array_equal(ens._gauge_discharge(gauges),
                                  np.stack([states[m]["ChanQ"][gauges] for m in range(M)]))


def _vmap_both(name, router, dt):
    """Each member's natural state after one step: (JAX vmap, port); the
    float32 cases on the 24x20 model."""
    jdt, tdt = DTYPES[dt]
    cfg, params, state, aux = routed(name, router, small=dt == "f64")
    states = member_inputs(state)
    forcing = forcing_of(cfg, aux)
    jcfg = jax_config(cfg)
    step, _ = jax_build_step(jcfg, params, aux, dtype=jdt)
    cv = lambda v: jnp.asarray(v, jdt if np.asarray(v).dtype.kind == "f" else None)
    allowed = set(jax_state_keys(jcfg))
    members = [{k: v for k, v in step.prepare_state({k: cv(v) for k, v in s.items()}).items()
                if k in allowed} for s in states]
    s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    s, _ = jax.vmap(step, in_axes=(0, None))(s, {k: cv(v) for k, v in forcing.items()})
    ref = [{k: np.asarray(v) for k, v in
            step.natural_state({k: v[m] for k, v in s.items()}).items()} for m in range(M)]

    cfg_e, p_e, aux_e = ensemble_model(cfg, params, aux, M)
    port, _ = build_step(cfg_e, p_e, aux_e, dtype=tdt, device="cpu")
    kin = port.routers["kin"]
    assert isinstance(kin, ShardedRouter if router != "scan" else ScanRouter)
    if router != "scan":
        assert kin.ps.n_shards == M * ROUTERS[router][1]
    s_t = port.prepare_state(fold_states(states, kin.ps.chunk), tdt)
    s_t, _ = port(s_t, tile_forcing(to_device(forcing, "cpu", tdt), M, cfg.num_pixels))
    nat = {k: v.numpy() for k, v in port.natural_state(s_t).items()}
    return ref, [member_state(nat, m, M, 0) for m in range(M)]


@pytest.mark.parametrize("name,router,dt,tol", [
    ("options", "sharded-1", "f64", 1e-10), ("options", "sharded-3", "f64", 1e-10),
    ("main", "sharded-4", "f32", 3e-5), ("options", "scan", "f64", 1e-10),
    ("main", "scan", "f32", 3e-5)])
def test_ensemble_step_matches_vmap(name, router, dt, tol):
    """One ensemble step against jax.vmap of the JAX sharded or scan step on
    the same stacked states, every state entry of every member: the
    all-options model (the in-loop catchment totals over kinp$Catchments,
    groundwater smoothing per member) in float64 at 16x16, the main path in
    float32 at 24x20."""
    ref, got = _vmap_both(name, router, dt)
    loose = {"CrossSection2Area": 1e-2, "Sideflow1Chan": 1e-2} if dt == "f32" else {}
    for r, g in zip(ref, got):
        assert set(r) <= set(g)
        for k in r:
            err = rel_err(g[k], r[k])
            assert err <= loose.get(k, tol), f"{k}: {err:.3e}"
    assert rel_err(got[0]["LZ"], got[1]["LZ"]) > 1e-4       # the members differ


def member_vs_single(router, dtype, n_steps=1):
    """The largest relative difference, over members and state entries,
    between member m of the all-options ensemble (16x16, NoRoutSteps 2) and
    the port's single step on member m's state after `n_steps` steps (0.0:
    the same bits)."""
    cfg, params, state, aux = routed("options", router, no_rout_steps=2)
    states = member_inputs(state)
    f = to_device(forcing_of(cfg, aux), "cpu", dtype)
    cfg_e, p_e, aux_e = ensemble_model(cfg, params, aux, M)
    step_e, _ = build_step(cfg_e, p_e, aux_e, dtype=dtype, device="cpu")
    s_e = step_e.prepare_state(fold_states(states, 0), dtype)
    step1, _ = build_step(cfg, params, aux, dtype=dtype, device="cpu")
    singles = [step1.prepare_state(s, dtype) for s in states]
    for _ in range(n_steps):
        s_e, _ = step_e(s_e, tile_forcing(f, M, cfg.num_pixels))
        singles = [step1(s, f)[0] for s in singles]
    worst = 0.0
    for m in range(M):
        mine = member_state(s_e, m, M, 0)
        for k, v in singles[m].items():
            if not torch.equal(torch.nan_to_num(mine[k]), torch.nan_to_num(v)):
                worst = max(worst, float((mine[k] - v).abs().max() / v.abs().max()))
    return worst


_MEMBER_CHECK = """
import sys, torch
sys.path[:0] = [{root!r}, {tests!r}]
from test_torch_ensemble_routers import member_vs_single
print(max(member_vs_single(r, d) for r in ("sharded-3", "scan")
          for d in (torch.float32, torch.float64)))
"""


def test_member_matches_single_step():
    """Member m of the sharded (3 shards, 9 in the ensemble) and the scan
    ensemble against the port's single step on member m's state, the
    all-options model (K7's in-loop catchment totals over kinp$Catchments
    included): bitwise in float32 and float64 with PyTorch's CPU kernels in
    plain C++ (ATEN_CPU_CAPABILITY=default). With the SIMD kernels a lane
    that moves between the vector body and the scalar remainder (the soil's
    Courant sub-steps compact a member's lanes at another offset than the
    single model's) may differ in the last bit, as for the packed ensemble
    (tests/test_torch_ensemble.py::test_member_matches_single_step): 8.6e-8
    of a field's max measured in float32 on this model."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = _MEMBER_CHECK.format(root=os.path.dirname(tests), tests=tests)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "ATEN_CPU_CAPABILITY": "default"}, timeout=600)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip().splitlines()[-1]) == 0.0


DAYS, FILTER_STEP = 2, 1
SETTINGS_ROUTERS = {"sharded": {"RoutingKernel": "sharded", "RoutingShards": "4"},
                    "scan": {"RoutingKernel": "scan"}}


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """A 24x20 catchment with MonteCarlo and EnKF on, EnsMembers 3 and one
    filter step, after day 1 of 2."""
    return write_catchment(tmp_path_factory.mktemp("ensemble_routers"), 24, 20, seed=0,
                           n_steps=DAYS, outputs=True,
                           options={"MonteCarlo": True, "EnKF": True},
                           user={"EnsMembers": M, "FilterSteps": FILTER_STEP})


@pytest.mark.parametrize("router", list(SETTINGS_ROUTERS))
def test_run_from_settings_members(catchment, router, tmp_path):
    """lisfloodexe with MonteCarlo and EnKF and RoutingKernel sharded (4
    shards) or scan runs the folded ensemble (run_from_settings): one
    directory of outputs per member and the filter step's dumps; each
    member's TSS rows and dump at the filter step equal a single run of the
    first day from the member's perturbed start (float64, within 1e-10 as
    tests/test_torch_driver_ensemble.py holds the packed members)."""
    out = tmp_path / "ensemble"
    out.mkdir()
    ts = load_settings(catchment, vars_to_set={"PathOut": str(out), **SETTINGS_ROUTERS[router]})
    assert ts.ens_members == M and ts.filter_steps == [FILTER_STEP]
    runner = lisfloodexe(ts, device="cpu")
    ens = runner.ensemble
    assert ens.cfg.routing_kernel == router and ens.cfg.members == M
    if router == "sharded":
        assert ens.step.routers["kin"].ps.n_shards == 4 * M
        assert ens.step.routers["tochan"].has_cuts
    assert sorted(os.listdir(out)) == [str(m) for m in range(1, M + 1)] + ["stateVar"]
    assert not any(k.startswith("pk$") for k in ens.state)
    for m, start in enumerate(_starts(ts), 1):
        single_dir = tmp_path / f"single{m}"
        single_dir.mkdir()
        s = load_settings(catchment, opts_to_unset=["MonteCarlo", "EnKF"],
                          vars_to_set={"PathOut": str(single_dir), "StepEnd": "01/01/2000 00:00",
                                       **SETTINGS_ROUTERS[router]})
        single = _single_run(s, start)
        tss = [n for n in os.listdir(single_dir) if n.endswith(".tss")]
        assert tss
        for n in tss:
            (ia, da, sa), (ib, db, sb) = read_tss(single_dir / n), read_tss(out / str(m) / n)
            assert ia == ib and list(sa) == [1] and list(sb) == [1, 2], n
            _held(n, da, db[:1], single.state)
        with np.load(out / "stateVar" / f"stateVar_{m}_{FILTER_STEP}.npz") as d:
            dump = {k: d[k] for k in d.files}
        assert set(dump) == set(single.state)
        for k, v in single.state.items():
            _held(k, v.numpy(), dump[k], single.state)
