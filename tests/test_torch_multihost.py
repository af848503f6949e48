"""The port's multi-process step (lisflood_tpu_torch/parallel/): ranks
owning whole logical shards of RoutingKernel sharded, over torch.distributed
with gloo on the CPU.

- The layout (shard_model.RankLayout): ranks partition the schedules'
  positions, each rank's halo is exactly the set of other ranks' positions
  upstream of its own, and K6's tables of a rank's own positions plus its
  halo give the one-process sweep's bits at its positions, through the
  tables' plain version and through an emulation of the kernel's launch
  (tests/test_torch_sharded_tiles.emulate). In-process, no process group.
  The synthetic 240x200 case runs in tests/test_torch_multihost_sweep240.py
  through this file's helpers.
- The command line (`python -m lisflood_tpu_torch.parallel.multihost`, the
  counterpart of tests/test_multihost.py:56): 1, 2 and 4 processes give the
  same gathered state bit for bit, at 4 and at 8 logical shards.
- Two and four ranks of the all-options synthetic model (groundwater
  smoothing off: tests/test_torch_multihost_packed.py runs it across ranks)
  and two ranks of a
  48x40 catchment through shard_runner_step (overland halo, lakes,
  reservoirs, split routing, repMBTs) against the one-process step, bit for
  bit, state and reports.
- Two ranks held to the JAX package's one-device sharded step at the port's
  gates.
- What more than one rank refuses: a folded ensemble, on any router.

Every process runs with ATEN_CPU_CAPABILITY=default: PyTorch's vectorised CPU
loops compute a lane in the scalar remainder of a vector loop (pow) in
another last bit than in its body, and a rank's pixel count moves lanes
between the two (ROADMAP.md, "Differences"); the card has no such effect.
One intra-op thread a process keeps N processes from contending for the
cores. Each child is killed past its timeout.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.step import sharded_schedules
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 write_catchment)
from lisflood_tpu_torch.ops import kinwave_sharded as kss
from lisflood_tpu_torch.parallel import multihost, shard_model
from test_torch_sharded_step import _f32_scales, _jax_config, _run_jax
from test_torch_sharded_tiles import _plan, emulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "ATEN_CPU_CAPABILITY": "default", "OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
TIMEOUT = 240
STEPS = 3


def _launch(jobs):
    """Run every job's commands (one a rank) at once, the jobs side by side;
    every process must end 0 within TIMEOUT. `jobs` is a list of (commands,
    the file rank 0 saves); returns each job's saved arrays."""
    procs = [(j, r, subprocess.Popen(c, cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT))
             for j, (cmds, _) in enumerate(jobs) for r, c in enumerate(cmds)]
    fail = []
    for j, rank, p in procs:
        try:
            text, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            text, _ = p.communicate()
            fail.append((j, rank, "timeout", text))
            continue
        if p.returncode != 0:
            fail.append((j, rank, p.returncode, text))
    assert not fail, "\n".join(f"job {j} rank {r} rc={rc}:\n{t.decode(errors='replace')[-3000:]}"
                               for j, r, rc, t in fail)
    return [dict(np.load(out)) for _, out in jobs]


# ---------------------------------------------------------------------------
# the layout, in-process


def _synthetic(n):
    cfg, params, state, aux = build_synthetic_model(n[0], n[1])
    return cfg, aux


def _catchment(path):
    cfg, _, _, aux = build_model(load_settings(path))
    return cfg, aux


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(str(tmp_path_factory.mktemp("ranks")), 48, 40, seed=0, n_steps=2)


# the synthetic 240x200 case runs in tests/test_torch_multihost_sweep240.py,
# on another worker of the tier-1 run
LAYOUT_CASES = [("synthetic", (16, 16), 4), ("catchment", (48, 40), 4),
                ("catchment", (96, 80), 4)]
case_id = lambda c: f"{c[0]}{c[1][0]}x{c[1][1]}S{c[2]}"


def _downstream_owners(down, owner):
    """Each pixel's set of ranks downstream of it, by walking every chain
    (pointer jumping, independent of the graph's levels)."""
    bits = np.zeros(down.size, np.int64)
    cur = down.copy()
    while (cur >= 0).any():
        on = cur >= 0
        bits[on] |= np.int64(1) << owner[cur[on]].astype(np.int64)
        cur[on] = down[cur[on]]
    return bits


def build_layouts(cases, tmp_path_factory, catchment):
    """Each case's (cfg routed sharded on its S shards, aux, schedules)."""
    out = {}
    for kind, size, S in cases:
        if kind == "synthetic":
            cfg, aux = _synthetic(size)
        else:
            cfg, aux = _catchment(catchment if size == (48, 40) else write_catchment(
                str(tmp_path_factory.mktemp("layout")), size[0], size[1], seed=0, n_steps=1))
        cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=S)
        out[kind, size] = (cfg, aux, sharded_schedules(cfg, aux))
    return out


def build_rank_routers(cases, layouts):
    """Each case's RankRouters (CPU, no group) for both graphs, N = 2, 4,
    with their tables at the default cap."""
    out = {}
    for kind, size, S in cases:
        cfg, aux, sched = layouts[kind, size]
        for N in (2, 4):
            for r in range(N):
                lay = shard_model.RankLayout(cfg, aux, r, N, sched=sched)
                for key in ("kin", "tochan"):
                    router = kss.RankRouter(sched[key], lay.part(key), lay.owned, None, "cpu")
                    if not router.no_edges:
                        router.sweep_tiles()
                    out[kind, size, key, N, r] = router
    return out


@pytest.fixture(scope="module")
def layouts(tmp_path_factory, catchment):
    return build_layouts(LAYOUT_CASES, tmp_path_factory, catchment)


@pytest.fixture(scope="module")
def rank_routers(layouts):
    return build_rank_routers(LAYOUT_CASES, layouts)


def check_layout_halo(layouts, case):
    """For N = 1, 2, 4 ranks: the ranks' blocks partition each schedule's
    positions and their pixels the grid, every rank's halo is the set of
    other ranks' positions with one of its own downstream, the send lists
    hold exactly the positions some halo reads, and halo_src points at
    them. Channel edges between ranks occur at synthetic 240x200 and 8
    shards (the card's phase 14 runs it on 4 ranks)."""
    kind, size, S = case
    cfg, aux, sched = layouts[kind, size]
    P = cfg.num_pixels
    for N in (1, 2, 4):
        lays = [shard_model.RankLayout(cfg, aux, r, N, sched=sched) for r in range(N)]
        assert np.array_equal(np.sort(np.concatenate([l.pixels for l in lays])), np.arange(P))
        owner = lays[0].natural.owner
        for key in ("kin", "tochan"):
            ps = sched[key]
            down = np.asarray(aux["graph_" + key].downstream, np.int64)
            bits = _downstream_owners(down, owner)
            parts = lays[0].parts[key]
            assert [p["lo"] for p in parts] == [0] + [p["hi"] for p in parts[:-1]]
            assert parts[-1]["hi"] == ps.p_pad
            gathered = np.zeros(N * parts[0]["send_max"], np.int64) - 1
            for o, p in enumerate(parts):
                gathered[o * p["send_max"]:o * p["send_max"] + p["send"].size] = p["send"]
            for r, lay in enumerate(lays):
                part = lay.part(key)
                real = ps.perm[part["lo"]:part["hi"]]
                assert np.array_equal(np.sort(real[real < P]), lay.pixels)
                want = np.sort(ps.inv_perm[(owner != r) & (((bits >> r) & 1) > 0)])
                assert np.array_equal(part["halo"], want), (key, N, r)
                assert np.array_equal(gathered[part["halo_src"]], part["halo"])
            need = np.unique(np.concatenate([p["halo"] for p in parts]))
            assert np.array_equal(np.sort(np.concatenate([p["send"] for p in parts])), need)
            assert parts[0]["exchange"] == bool(need.size)
    if (kind, size, S) == ("synthetic", (240, 200), 8):
        assert shard_model.RankLayout(cfg, aux, 0, 4, sched=sched).cut_edges("kin", aux) > 0


def check_rank_sweep(layouts, rank_routers, case, dt):
    """K6 on each rank's tables (its own positions plus its halo, RankTiles)
    against the one-process `_sweep_sharded` at the rank's positions, bit for
    bit, for both graphs and N = 2, 4, with the halo's operands copied from
    their owners' positions: through the tables' plain version and, on the
    smaller cases, through the kernel's emulated launch. A graph with no
    edge (the synthetic overland graph) has no sweep."""
    kind, size, S = case
    cfg, aux, sched = layouts[kind, size]
    rng = np.random.default_rng(1)
    emulated = size[0] * size[1] <= 48 * 40
    for key in ("kin", "tochan"):
        ps = sched[key]
        L = 3 if key == "tochan" else 2
        const = torch.as_tensor(rng.uniform(0, 5, (L, ps.p_pad)), dtype=dt)
        adx = torch.as_tensor(rng.uniform(1e-2, 1e2, (L, ps.p_pad)), dtype=dt)
        if rank_routers[kind, size, key, 2, 0].no_edges:
            continue
        ups = torch.as_tensor(kss.upstream_positions(ps)).long()
        full = kss._sweep_sharded(const, adx, ups, ps.n_chunks, ps.n_shards, ps.chunk, 0.6)
        for N in (2, 4):
            for r in range(N):
                router = rank_routers[kind, size, key, N, r]
                tiles = router.sweep_tiles()
                glob = tiles.glob
                q = tiles.reference(const[:, glob].contiguous(), adx[:, glob].contiguous(), 0.6)
                n_own = router.hi - router.lo
                assert torch.equal(q[:, :n_own], full[:, router.lo:router.hi]), (key, N, r)
                if emulated:
                    plan = _plan(tiles, L, const.element_size())
                    qe = emulate(const[:, glob].contiguous(), adx[:, glob].contiguous(), tiles,
                                 plan)
                    assert torch.equal(qe[:, :n_own], q[:, :n_own]), (key, N, r)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=case_id)
def test_layout_halo(layouts, case):
    """check_layout_halo on the case."""
    check_layout_halo(layouts, case)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=case_id)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rank_sweep_bitwise(layouts, rank_routers, case, dt):
    """check_rank_sweep on the case."""
    check_rank_sweep(layouts, rank_routers, case, dt)


# ---------------------------------------------------------------------------
# the command line


def _cli(n, shards, tmp):
    """The command line's job of n processes at `shards` shards."""
    init, out = f"file://{tmp}/pg_{n}_{shards}", str(tmp / f"s{n}_{shards}.npz")
    return [[sys.executable, "-m", "lisflood_tpu_torch.parallel.multihost",
             "--rank", str(r), "--nprocs", str(n), "--steps", str(STEPS),
             "--device", "cpu", "--init-method", init, "--shards", str(shards)]
            + (["--out", out] if r == 0 else []) for r in range(n)], out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    runs = {}
    for group in (((1, 4), (2, 4), (4, 4)), ((1, 8), (2, 8))):
        runs.update(zip(group, _launch([_cli(n, S, tmp) for n, S in group])))
    return runs


@pytest.mark.parametrize("shards", [4, 8])
def test_cli_processes_bitwise(cli_runs, shards):
    """The synthetic 16x16 model, float64, 3 steps, RoutingKernel sharded:
    1, 2 (and at 4 shards 4) processes of the command line give the same
    gathered state, every entry bit for bit; at 8 shards 2 ranks have
    channel edges between them."""
    ref = cli_runs[1, shards]
    for n in (2, 4) if shards == 4 else (2,):
        got = cli_runs[n, shards]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{n} processes, {k}")
    assert ref["ChanQKin"].max() > 0
    cfg, aux = _synthetic((16, 16))
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=shards)
    cuts = shard_model.RankLayout(cfg, aux, 0, 2).cut_edges("kin", aux)
    assert (cuts > 0) == (shards == 8)


# ---------------------------------------------------------------------------
# ranks against one process: the all-options model and a catchment

_RANKS = """
import dataclasses, json, sys
import numpy as np
import torch
sys.path[:0] = [{root!r}]
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options)
from lisflood_tpu_torch.parallel import multihost, shard_model

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
N, S, dtype, T = spec["nranks"], spec["shards"], getattr(torch, spec["dtype"]), spec["steps"]
group = multihost.initialize(spec["init"], N, rank)
if spec["case"] == "catchment":
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.driver import LisfloodRunner
    settings = load_settings(spec["path"], vars_to_set={{"RoutingKernel": "sharded",
                                                         "RoutingShards": str(S)}})
    runner = LisfloodRunner(settings, dtype=dtype, device="cpu")
    days = [runner.forcing_for(i, runner.dates[i]) for i in range(T)]
    if N == 1:
        step, s = runner.step, runner.state
    else:
        step, s = shard_model.shard_runner_step(runner, group)
        days = [step.shard_forcing(f) for f in days]
elif spec["case"] == "synthetic" and N > 1:
    step, s, f, cfg = shard_model.build_sharded_model_step(group, 16, 16, dtype, "sharded", S,
                                                           "cpu")
    days = [f] * T
else:
    if spec["case"] == "options":
        cfg, params, state, aux = with_options(build_synthetic_model(16, 16, no_rout_steps=6,
                                                                     chunk_size=16))
        cfg = dataclasses.replace(cfg, groundwater_smooth=False)
        f = {{**synthetic_forcing(cfg.num_pixels), **aux["forcing_options"]}}
    else:
        cfg, params, state, aux = build_synthetic_model(16, 16)
        f = synthetic_forcing(cfg.num_pixels)
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=S)
    if N == 1:
        step, _ = build_step(cfg, params, aux, dtype=dtype, device="cpu")
        days = [to_device(f, "cpu", dtype)] * T
    else:
        step = multihost.multihost_step((cfg, params, aux),
                                        shard_model.RankLayout(cfg, aux, rank, N), group,
                                        dtype, "cpu")
        days = [step.shard_forcing(f)] * T
    s = step.prepare_state(state, dtype)
out = {{}}
for i, f in enumerate(days):
    s, d = step(s, f)
    reports = {{k: d[k] for k in spec["reports"] if k in d}}
    if N > 1:
        reports = step.gather(reports, reports)
    out.update({{f"{{k}}@{{i}}": v.cpu().numpy() for k, v in reports.items()}})
    out[f"SoilCourantCapHit@{{i}}"] = np.asarray(bool(d["SoilCourantCapHit"]))
out.update(multihost.gather_state(step, s))
if N > 1:
    multihost.collectives.destroy_group()
if rank == 0:
    np.savez(spec["out"], **out)
"""

# per-pixel reports gathered each step besides the state
REPORTS = ("ChanQAvg", "MBError", "MBErrorMM", "MB_WaterIn", "MB_WaterStored",
           "MB_DisStructures", "TotalWaterStorageMM", "MBErrorSplitRoutingM3",
           "OutletDischargeErrorSplitRouting", "EvaAddM3", "LakeInflowM3S",
           "ReservoirOutflowM3S", "WaterLevel", "UpstreamSumMonthDis", "WEI_Dem",
           "areatotal_withdrawal_SW_actual_M3", "RegionMonthExternalInflowM3", "pF1",
           "OFQDirect", "SurfaceRunoff")


def _ranks(spec, counts, tmp):
    """The child program's runs of `spec` at each rank count of `counts`,
    side by side; returns their saved arrays."""
    jobs = []
    for n in counts:
        sp = dict(spec, nranks=n, out=str(tmp / f"{spec['case']}_{n}.npz"),
                  init=f"file://{tmp}/pg_{spec['case']}_{n}", reports=REPORTS)
        jobs.append(([[sys.executable, "-c", _RANKS.format(root=ROOT), json.dumps(sp), str(r)]
                      for r in range(n)], sp["out"]))
    return _launch(jobs)


def _bitwise(ref, got, what):
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")


OPTIONS = {"case": "options", "shards": 4, "dtype": "float64", "steps": STEPS}


@pytest.fixture(scope="module")
def options_runs(tmp_path_factory):
    return dict(zip((1, 2, 4), _ranks(OPTIONS, (1, 2, 4), tmp_path_factory.mktemp("options"))))


@pytest.mark.parametrize("nranks", [2, 4])
def test_options_ranks_bitwise(options_runs, nranks):
    """The all-options synthetic model (split routing, lakes, reservoirs,
    open-water evaporation outside the kernel, water use and its region
    totals, the indicators, inflow, transmission loss, polders, water
    levels, pF, the mass-balance reports) on 4 shards, 3 steps in float64:
    2 and 4 ranks against one process, state and reports bit for bit."""
    ref, got = options_runs[1], options_runs[nranks]
    assert {"WEI_Dem@0", "MBError@2", "LakeInflowM3S@1", "UpstreamSumMonthDis@2"} <= set(ref)
    _bitwise(ref, got, f"{nranks} ranks")


def test_catchment_two_ranks_bitwise(catchment, tmp_path):
    """A 48x40 catchment from its maps (split routing, lakes, reservoirs,
    open-water evaporation, repMBTs), RoutingKernel sharded on 4 shards, two
    days in float64 through LisfloodRunner: 2 ranks through
    shard_runner_step against the runner's own step, state and reports bit
    for bit; the overland graph has a halo on both ranks."""
    spec = {"case": "catchment", "path": catchment, "shards": 4, "dtype": "float64", "steps": 2}
    ref, got = _ranks(spec, (1, 2), tmp_path)
    assert {"MBErrorSplitRoutingM3@1", "LakeInflowM3S@0", "ReservoirOutflowM3S@1"} <= set(ref)
    _bitwise(ref, got, "2 ranks")
    settings = load_settings(catchment, vars_to_set={"RoutingKernel": "sharded",
                                                     "RoutingShards": "4"})
    cfg, _, _, aux = build_model(settings)
    halos = [shard_model.RankLayout(cfg, aux, r, 2).part("tochan")["halo"].size for r in (0, 1)]
    assert min(halos) > 0, halos


# ---------------------------------------------------------------------------
# held to the JAX package


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_two_ranks_match_jax(cli_runs, tmp_path, dt):
    """Two ranks of the synthetic 16x16 model (RoutingKernel sharded, 4
    shards, 3 steps; float64 the command line's run, float32 through
    build_sharded_model_step) against the JAX package's one-device sharded step (its
    sequential sub-step loop) on the same arrays: float64 within 1e-10 and
    float32 within 1.5e-4 of each field's max after the 3 steps (the gates of
    tests/test_torch_sharded_step.py after more than one step).
    Measured 2.0e-13 (float64) and 6.5e-5 (float32, ChanQ)."""
    if dt == "f64":
        got = cli_runs[2, 4]
    else:
        got, = _ranks({"case": "synthetic", "shards": 4, "dtype": "float32", "steps": STEPS},
                      (2,), tmp_path)
    cfg, params, state, aux = build_synthetic_model(16, 16)
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=4)
    jdt = jnp.float64 if dt == "f64" else jnp.float32
    ref = _run_jax(_jax_config(cfg), params, state, aux,
                   [synthetic_forcing(cfg.num_pixels)] * STEPS, jdt)[-1]
    f32 = dt == "f32"
    scales = _f32_scales(ref) if f32 else {}
    worst = 0.0
    for k, a in ref.items():
        tol = (1e-2 if k == "Sideflow1Chan" else 1.5e-4) if f32 else 1e-10
        err = np.abs(a - got[k]).max() / scales.get(k, max(np.abs(a).max(), 1e-30))
        assert err <= tol, f"{k}: {err:.3e}"
        worst = max(worst, err)
    print(f"two ranks against the JAX step, {dt}: {worst:.3e} of a field's max")


# ---------------------------------------------------------------------------
# what more than one rank refuses


@pytest.mark.parametrize("change", [{"routing_kernel": "scan", "members": 2}, {"members": 2}],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_refused_across_ranks(change, monkeypatch):
    """Across ranks a folded ensemble raises NotImplementedError on the scan
    and the sharded router (one rank runs it); run_demo refuses it before it
    joins a group; a rank with no device given takes the CUDA card and
    raises without one."""
    cfg, params, state, aux = build_synthetic_model(16, 16)
    cfg = dataclasses.replace(cfg, routing_kernel="sharded", num_shards=4)
    bad = dataclasses.replace(cfg, **change)
    shard_model.check_ranks(bad, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        shard_model.check_ranks(bad, 2)
    monkeypatch.setattr(multihost, "build_synthetic_model",
                        lambda *size: (bad, params, state, aux))
    with pytest.raises(NotImplementedError):
        multihost.run_demo(0, 2, device="cpu", routing_kernel=bad.routing_kernel)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        shard_model.rank_device(None, 0)
