"""The port's multi-process step on the scan router (RoutingKernel scan):
lisflood_tpu_torch/parallel/ over torch.distributed with gloo on the CPU.

- The layout (shard_model.ScanRankLayout): the ranks partition the natural
  pixels, and each rank's halo is exactly the set of other ranks' pixels
  upstream of its own over the downstream of the schedule the router
  sweeps, found by pointer jumping; the send lists hold what the halos
  read. In-process, no process group.
- A rank's sweep: K6's tables of its own pixels plus its halo
  (ops/kinwave.RankScanTiles), through their plain version and through an
  emulation of the kernel's launch (tests/test_torch_sharded_tiles.emulate),
  give the whole schedule's `_sweep_scan` bits at its pixels.
- The command line (`--kernel scan`): 1, 2 and 4 processes give the same
  gathered state bit for bit.
- The all-options synthetic model with groundwater smoothing and transient
  land use on 2 and 4 scan ranks against one process, bit for bit.
- A 48x40 catchment (lakes, reservoirs, split routing, repMBTs) on 2 ranks
  through shard_runner_step of a scan LisfloodRunner against the runner's
  own step, state and reports bit for bit; the same ranks held to the JAX
  package's one-device scan step in float64 and float32.

Every process runs with ATEN_CPU_CAPABILITY=default and one intra-op thread
(tests/test_torch_multihost.py says why).
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.config import load_settings as jax_load_settings
from lisflood_tpu.models.initial import build_model as jax_build_model
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.synthetic import build_synthetic_model, write_catchment
from lisflood_tpu_torch.ops import kinwave as kw
from lisflood_tpu_torch.parallel import shard_model
from test_torch_multihost import REPORTS, ROOT, _bitwise, _downstream_owners, _launch
from test_torch_multihost_packed import OPTIONS
from test_torch_multihost_packed import _job as _options_job
from test_torch_sharded_step import _held, _run_jax
from test_torch_sharded_tiles import _plan, emulate

STEPS = 3
SCAN = {"RoutingKernel": "scan"}


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    """A 48x40 catchment with netCDF meteo (which the JAX package's reader
    needs)."""
    return write_catchment(str(tmp_path_factory.mktemp("scan_ranks")), 48, 40, seed=0,
                           n_steps=STEPS, meteo_format="netcdf")


def _model(case, catchment, tmp_path_factory):
    """(cfg with RoutingKernel scan on S logical shards, params, aux) of a
    layout case."""
    kind, size, S = case
    if kind == "synthetic":
        cfg, params, _, aux = build_synthetic_model(*size)
    else:
        path = catchment if size == (48, 40) else write_catchment(
            str(tmp_path_factory.mktemp("layout")), size[0], size[1], seed=0, n_steps=1)
        cfg, params, _, aux = build_model(load_settings(path))
    return dataclasses.replace(cfg, routing_kernel="scan", num_shards=S), params, aux


LAYOUT_CASES = [("synthetic", (16, 16), 8), ("synthetic", (240, 200), 8),
                ("catchment", (48, 40), 4), ("catchment", (96, 80), 4)]
case_id = lambda c: f"{c[0]}{c[1][0]}x{c[1][1]}S{c[2]}"


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=case_id)
def test_scan_layout_halo(case, catchment, tmp_path_factory):
    """For N = 2 and 4 ranks: the ranks' pixels partition the grid, each is
    its own position space; each rank's halo, for the channel and the
    overland schedule, is the set of other ranks' pixels with one of its
    own downstream (pointer jumping over the schedule's downstream); the
    send lists hold exactly the pixels some halo reads and halo_src points
    at them; K6's local tables build (every source of a local pixel is
    local). Channel halos occur at synthetic 240x200 and 8 shards, overland
    halos on the catchments. rank_step refuses another router's layout."""
    cfg, params, aux = _model(case, catchment, tmp_path_factory)
    P = cfg.num_pixels
    halos = {"kin": 0, "tochan": 0}
    for N in (2, 4):
        lays = [shard_model.rank_layout(cfg, params, aux, r, N) for r in range(N)]
        assert all(isinstance(l, shard_model.ScanRankLayout) for l in lays)
        assert np.array_equal(np.sort(np.concatenate([l.pixels for l in lays])), np.arange(P))
        owner = lays[0].natural.owner
        for key in ("kin", "tochan"):
            down = np.asarray(aux["schedule_" + key].downstream, np.int64)[:P]
            bits = _downstream_owners(np.where(down < P, down, -1), owner)
            parts = lays[0].parts[key]
            gathered = np.full(N * parts[0]["send_max"], -1, np.int64)
            for o, p in enumerate(parts):
                gathered[o * p["send_max"]:o * p["send_max"] + p["send"].size] = p["send"]
            for r, lay in enumerate(lays):
                part = lay.part(key)
                assert np.array_equal(part["own"], lay.pixels)
                assert np.array_equal(lay.position_index(), lay.pixels)
                want = np.flatnonzero((owner != r) & (((bits >> r) & 1) > 0))
                assert np.array_equal(part["halo"], want), (key, N, r)
                assert np.array_equal(gathered[part["halo_src"]], part["halo"])
                halos[key] += part["halo"].size
                router = kw.RankScanRouter(aux["schedule_" + key], part, None, "cpu")
                if not router.no_edges:
                    tiles = router.sweep_tiles()
                    assert np.array_equal(tiles.glob.numpy(), np.r_[lay.pixels, part["halo"]])
            need = np.unique(np.concatenate([p["halo"] for p in parts]))
            assert np.array_equal(np.sort(np.concatenate([p["send"] for p in parts])), need)
            assert parts[0]["exchange"] == bool(need.size)
    if case == ("synthetic", (240, 200), 8):
        assert halos["kin"] > 0
    if case[0] == "catchment":
        assert halos["tochan"] > 0
    # rank_step refuses a layout of another router
    other = shard_model.PackedRankLayout(cfg, params, aux, 0, 2)
    with pytest.raises(ValueError, match="scan on a PackedRankLayout"):
        shard_model.rank_step(cfg, params, aux, other, None, device="cpu")


@pytest.mark.parametrize("case", [LAYOUT_CASES[0], LAYOUT_CASES[2]], ids=case_id)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rank_scan_sweep_bitwise(case, dt, catchment, tmp_path_factory):
    """K6 on each rank's tables (its own pixels plus its halo, RankScanTiles)
    against the whole schedule's `_sweep_scan` at its own and halo pixels,
    bit for bit, for both graphs and N = 2, 4, with the halo's operands
    copied from their owners' pixels: through the tables' plain version
    (the schedule's chunks cut to the local pixels) and through the
    kernel's emulated launch."""
    cfg, params, aux = _model(case, catchment, tmp_path_factory)
    P = cfg.num_pixels
    rng = np.random.default_rng(1)
    halos = 0
    for key in ("kin", "tochan"):
        whole = kw.ScanRouter(aux["schedule_" + key], "cpu")
        if whole.no_edges:
            continue
        L = 3 if key == "tochan" else 2
        const = torch.as_tensor(rng.uniform(0, 5, (L, P)), dtype=dt)
        adx = torch.as_tensor(rng.uniform(1e-2, 1e2, (L, P)), dtype=dt)
        full = kw._sweep_scan(const, adx, whole.chunks, whole.ups.long(), 0.6)
        for N in (2, 4):
            for r in range(N):
                lay = shard_model.rank_layout(cfg, params, aux, r, N)
                router = kw.RankScanRouter(aux["schedule_" + key], lay.part(key), None, "cpu")
                tiles = router.sweep_tiles()
                glob = tiles.glob
                halos += router.halo.size
                c_loc, a_loc = const[:, glob].contiguous(), adx[:, glob].contiguous()
                q = tiles.reference(c_loc, a_loc, 0.6)
                assert torch.equal(q, full[:, glob]), (key, N, r)
                qe = emulate(c_loc, a_loc, tiles, _plan(tiles, L, const.element_size()))
                assert torch.equal(qe, q), (key, N, r)
    assert halos > 0


# ---------------------------------------------------------------------------
# processes: the command line and the catchment


def _cli(n, tmp, shards=8):
    """The command line's job of n processes at `shards` logical shards."""
    init, out = f"file://{tmp}/pg_cli_{n}", str(tmp / f"cli_{n}.npz")
    return [[sys.executable, "-m", "lisflood_tpu_torch.parallel.multihost", "--kernel", "scan",
             "--rank", str(r), "--nprocs", str(n), "--steps", str(STEPS), "--device", "cpu",
             "--init-method", init, "--shards", str(shards)]
            + (["--out", out] if r == 0 else []) for r in range(n)], out


_RANKS = """
import json, sys
import numpy as np
import torch
sys.path[:0] = [{root!r}]
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.models.driver import LisfloodRunner
from lisflood_tpu_torch.parallel import multihost, shard_model

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
N, dtype, T = spec["nranks"], getattr(torch, spec["dtype"]), spec["steps"]
group = multihost.initialize(spec["init"], N, rank)
runner = LisfloodRunner(load_settings(spec["path"], vars_to_set={{"RoutingKernel": "scan"}}),
                        dtype=dtype, device="cpu")
assert runner.config.routing_kernel == "scan"
days = [runner.forcing_for(i, runner.dates[i]) for i in range(T)]
if N == 1:
    step, s = runner.step, runner.state
else:
    step, s = shard_model.shard_runner_step(runner, group)
    assert isinstance(step.layout, shard_model.ScanRankLayout)
    days = [step.shard_forcing(f) for f in days]
out = {{}}
for i, f in enumerate(days):
    s, d = step(s, f)
    reports = {{k: d[k] for k in spec["reports"] if k in d}}
    if N > 1:
        reports = step.gather(reports, reports)
    out.update({{f"{{k}}@{{i}}": v.cpu().numpy() for k, v in reports.items()}})
    out.update({{f"state@{{i}}${{k}}": v for k, v in multihost.gather_state(step, s).items()}})
if N > 1:
    halo = sum(step.layout.part(k)["halo"].size for k in ("kin", "tochan"))
    out["halo"] = np.asarray(multihost.collectives.all_reduce_max(
        torch.tensor([float(halo)]), group))
    multihost.collectives.barrier(group)
    multihost.collectives.destroy_group()
if rank == 0:
    np.savez(spec["out"], **out)
"""


def _job(spec, n, tmp):
    tag = f"{spec['dtype']}_{n}"
    sp = dict(spec, nranks=n, out=str(tmp / f"catchment_{tag}.npz"),
              init=f"file://{tmp}/pg_{tag}", reports=REPORTS)
    return ([[sys.executable, "-c", _RANKS.format(root=ROOT), json.dumps(sp), str(r)]
             for r in range(n)], sp["out"])


# every option of with_options (groundwater smoothing on) with transient
# land use, on 8 logical shards (channel halos)
SCAN_OPTIONS = dict(OPTIONS, router="scan", shards=8, landuse=True, eva_outside=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, catchment):
    """Every process run of the module, in two waves side by side: the
    command line at 1, 2 and 4 processes (8 logical shards) and the
    all-options model on 1, 2 and 4 ranks (14 processes); then the 48x40
    catchment on 1 and 2 ranks in float64 and on 2 ranks in float32 (5)."""
    tmp = tmp_path_factory.mktemp("runs")
    spec = {"path": catchment, "steps": STEPS}
    waves = [{("cli", n): _cli(n, tmp) for n in (1, 2, 4)},
             {("catchment", dt, n): _job(dict(spec, dtype=dt), n, tmp)
              for dt, n in (("float64", 1), ("float64", 2), ("float32", 2))}]
    waves[0].update({("options", n): _options_job(SCAN_OPTIONS, n, tmp) for n in (1, 2, 4)})
    got = {}
    for jobs in waves:
        got.update(zip(jobs, _launch(list(jobs.values()))))
    return got


@pytest.mark.parametrize("nranks", [2, 4])
def test_cli_scan_processes_bitwise(runs, nranks):
    """The synthetic 16x16 model, float64, 3 steps, RoutingKernel scan on 8
    logical shards: 2 and 4 processes of the command line give one
    process's gathered state, every entry bit for bit; ranks there have
    channel pixels upstream of another rank's (a channel halo)."""
    ref = runs["cli", 1]
    _bitwise(ref, runs["cli", nranks], f"{nranks} processes")
    assert ref["ChanQKin"].max() > 0
    cfg, params, _, aux = build_synthetic_model(16, 16)
    cfg = dataclasses.replace(cfg, routing_kernel="scan", num_shards=8)
    shard_model.check_ranks(cfg, nranks)
    halo = [shard_model.rank_layout(cfg, params, aux, r, nranks).part("kin")["halo"].size
            for r in range(nranks)]
    assert max(halo) > 0, halo


@pytest.mark.parametrize("nranks", [2, 4])
def test_options_scan_ranks_bitwise(runs, nranks):
    """The all-options synthetic model on the scan router (split routing,
    lakes, reservoirs, the evaporation chain, water use with groundwater
    smoothing, the indicators, inflow, transmission loss, polders, water
    levels, pF, the mass-balance reports) with transient land use, 8
    logical shards, 3 steps in float64: 2 and 4 ranks against one process,
    state and reports bit for bit."""
    ref = runs["options", 1]
    assert {"WEI_Dem@0", "MBError@2", "LakeInflowM3S@1", "UpstreamSumMonthDis@2"} <= set(ref)
    _bitwise(ref, runs["options", nranks], f"{nranks} ranks")


def test_catchment_scan_two_ranks_bitwise(runs):
    """The 48x40 catchment from its maps (split routing, lakes, reservoirs,
    open-water evaporation, repMBTs), RoutingKernel scan, three days in
    float64 through LisfloodRunner: 2 ranks through shard_runner_step
    against the runner's own step, the state after every day and the
    reports bit for bit; the ranks have a halo."""
    ref, got = runs["catchment", "float64", 1], runs["catchment", "float64", 2]
    assert {"MBErrorSplitRoutingM3@1", "LakeInflowM3S@0", "ReservoirOutflowM3S@2"} <= set(ref)
    assert float(got.pop("halo")[0]) > 0
    _bitwise(ref, got, "2 ranks")


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_scan_ranks_match_jax(runs, catchment, dt):
    """Two scan ranks of the 48x40 catchment (three days, meteo from its
    stacks) against the JAX package's one-device scan step (its sequential
    sub-step loop) from its own build_model, day by day, at the gates of
    tests/test_torch_scan.py: float64 within 1e-10 of each field's max,
    float32 within 3e-5 after one day and 1.5e-4 after more (on the scales
    of tests/test_torch_sharded_step._f32_scales)."""
    settings = load_settings(catchment, vars_to_set=SCAN)
    cfg, _, _, aux = build_model(settings)
    forcing = meteo_forcing(settings, cfg, aux)[:STEPS]
    jmodel = jax_build_model(jax_load_settings(catchment, vars_to_set=SCAN))
    assert jmodel[0].routing_kernel == "scan"
    jdt = jnp.float64 if dt == "f64" else jnp.float32
    refs = _run_jax(dataclasses.replace(jmodel[0], routing_pipeline="substeps"), *jmodel[1:],
                    forcing, jdt)
    got = runs["catchment", "float64" if dt == "f64" else "float32", 2]
    gots = [{k.split("$", 1)[1]: v for k, v in got.items() if k.startswith(f"state@{i}$")}
            for i in range(STEPS)]
    _held(refs, gots, dt == "f32")
