"""The port's multi-process step on the packed router (RoutingKernel
packed, the default), and groundwater smoothing and transient land use
across ranks on both routers: lisflood_tpu_torch/parallel/ over
torch.distributed with gloo on the CPU.

- The layout (shard_model.PackedRankLayout): each rank's halo is the closure
  upstream of its own positions over the edges the sub-step kernel reads
  (the routing graph, the evaporation chain in the kernel, the lakes' and
  reservoirs' feeders) and over the overland graph; the kept chunks keep
  every edge 1..W chunks long. In-process, no process group.
- A rank's sub-step (the kernel's plain version, substep_reference, on its
  kept chunks) and its overland sweep (`_sweep` on K5's tables of its kept
  chunks) give the one-process bits at its own and halo positions.
- The command line (`--kernel packed`): 1, 2 and 4 processes give the same
  gathered state bit for bit, at 4 and 8 logical shards.
- The all-options synthetic model (groundwater smoothing on) on 2 and 4
  ranks, and a 48x40 catchment on 2 ranks through shard_runner_step of a
  packed LisfloodRunner, against one process bit for bit, state and reports;
  the halo's routing state is its owner's.
- Groundwater smoothing and transient land use (with the evaporation chain
  outside the kernel) on 2 ranks of both routers, bit for bit.
- Two packed ranks held to the JAX package's one-device packed step.

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
from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.initial import build_model, meteo_forcing
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options, write_catchment)
from lisflood_tpu_torch.ops import kinwave_packed as kp
from lisflood_tpu_torch.ops import kinwave_substep as ks
from lisflood_tpu_torch.ops.routing_ops import kernel_operands, overland_operands
from lisflood_tpu_torch.parallel import shard_model
from test_torch_multihost import REPORTS, ROOT, _bitwise, _launch
from test_torch_sharded_step import _f32_scales, _jax_config, _run_jax

STEPS = 3


# ---------------------------------------------------------------------------
# the layout, in-process


def _synthetic(size, S, options=False):
    model = build_synthetic_model(size[0], size[1], **({"no_rout_steps": 6, "chunk_size": 16}
                                                       if options else {}))
    cfg, params, state, aux = with_options(model) if options else model
    return dataclasses.replace(cfg, num_shards=S), params, state, aux


@pytest.fixture(scope="module")
def catchment(tmp_path_factory):
    return write_catchment(str(tmp_path_factory.mktemp("packed")), 48, 40, seed=0, n_steps=STEPS)


def _model(case, catchment, tmp_path_factory):
    kind, size, S = case
    if kind == "synthetic":
        return _synthetic(size, S)
    path = catchment if size == (48, 40) else write_catchment(
        str(tmp_path_factory.mktemp("layout")), size[0], size[1], seed=0, n_steps=1)
    cfg, params, state, aux = build_model(load_settings(path))
    return dataclasses.replace(cfg, num_shards=S), params, state, aux


LAYOUT_CASES = [("synthetic", (16, 16), 4), ("synthetic", (240, 200), 8),
                ("catchment", (48, 40), 4), ("catchment", (96, 80), 4)]


def _closure(n, src, tgt, own):
    """The positions upstream of `own` over the edges src -> tgt, by
    breadth-first search (independent of the schedule's chunks)."""
    order = np.argsort(tgt, kind="stable")
    ups_of = src[order]
    ptr = np.searchsorted(tgt[order], np.arange(n + 1))
    seen = np.zeros(n, bool)
    seen[own] = True
    front = own
    while front.size:
        count = ptr[front + 1] - ptr[front]
        first = np.repeat(ptr[front] - np.cumsum(count) + count, count)
        ups = ups_of[first + np.arange(count.sum())]
        front = np.unique(ups[~seen[ups]])
        seen[front] = True
    seen[own] = False
    return np.flatnonzero(seen)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: f"{c[0]}{c[1][0]}x{c[1][1]}S{c[2]}")
def test_packed_layout_halo(case, catchment, tmp_path_factory):
    """For N = 2 and 4 ranks: the ranks' own positions partition each whole
    packed schedule's real positions and their pixels the grid; each rank's
    halo is the closure upstream of its own positions over the channel
    kernel's edges (routing, the evaporation chain where it runs in the
    kernel, the structures' feeders) and over the overland graph, found by
    a search independent of the schedule; its kept chunks are exactly those
    that hold an own or halo position, their lanes where they were; every
    edge between kept lanes, and every source of the remapped tables, lies
    1..W chunks upstream; the send lists hold exactly what some halo reads.
    Ranks at synthetic 240x200 and 8 shards read across on the channel
    graph, and a lake's feeders can sit on another rank."""
    cfg, params, _, aux = _model(case, catchment, tmp_path_factory)
    P = cfg.num_pixels
    for N in (2, 4):
        lays = [shard_model.PackedRankLayout(cfg, params, aux, r, N) for r in range(N)]
        assert np.array_equal(np.sort(np.concatenate([l.pixels for l in lays])), np.arange(P))
        lay0 = lays[0]
        edges = {"kin": shard_model.channel_edges(lay0.kinp, lay0.eva_window_ok)}
        tochan = lay0.ps["tochan"]
        has = tochan.down_pos < tochan.p_pad
        edges["tochan"] = (np.flatnonzero(has), tochan.down_pos[has].astype(np.int64))
        for key, (src, tgt) in edges.items():
            ps = lay0.ps[key]
            C, W = ps.chunk, ps.window
            parts = lay0.parts[key]
            gathered = np.full(N * parts[0]["send_max"], -1, np.int64)
            for o, p in enumerate(parts):
                gathered[o * p["send_max"]:o * p["send_max"] + p["send"].size] = p["send"]
            own_all = np.sort(np.concatenate([p["own"] for p in parts]))
            assert np.array_equal(own_all, np.flatnonzero(ps.perm < P))
            for r, lay in enumerate(lays):
                part = lay.part(key)
                assert np.array_equal(np.sort(ps.perm[part["own"]]), lay.pixels)
                want = _closure(ps.p_pad, src, tgt, part["own"])
                assert np.array_equal(part["halo"], want), (key, N, r)
                assert np.array_equal(gathered[part["halo_src"]], part["halo"])
                lanes = np.union1d(part["own"], part["halo"])
                assert np.array_equal(part["chunks"], np.unique(lanes // C))
                local = lay.local[key]
                loc = lay.loc_of[key][lanes]
                assert np.array_equal(loc % C, lanes % C)
                assert np.array_equal(local.perm[loc], ps.perm[lanes])
                s_loc = np.flatnonzero(local.down_pos < local.p_pad)
                d = local.down_pos[s_loc] // C - s_loc // C
                assert ((1 <= d) & (d <= W)).all()
                if key == "kin":
                    for name in ("UpsTable", "EvaUpsTable"):
                        t = lay.kinp_local.get("kinp$" + name)
                        if t is None:
                            continue
                        row, col = np.nonzero(t >= 0)
                        d = col // C - t[row, col] // C
                        assert ((1 <= d) & (d <= W)).all(), name
            need = np.unique(np.concatenate([p["halo"] for p in parts]))
            assert np.array_equal(np.sort(np.concatenate([p["send"] for p in parts])), need)
            assert parts[0]["exchange"] == bool(need.size)
    if case == ("synthetic", (240, 200), 8):
        assert shard_model.PackedRankLayout(cfg, params, aux, 0, 4).cut_edges("kin", aux) > 0


# ---------------------------------------------------------------------------
# a rank's sub-step and overland sweep, in-process


def rank_operands(spec, xs, lay):
    """The sub-step kernel's operands of `lay`'s rank, cut from the whole
    schedule's (spec, xs): the rows of its kept chunks, its tables
    (rank_kinp) and the structures on its kept lanes."""
    glob = torch.as_tensor(lay.position_index())
    n = glob.numel() // spec.chunk
    kin = {k[5:]: torch.as_tensor(v) for k, v in lay.kinp_local.items()}
    out = {k: v.reshape(-1)[glob].reshape(n, spec.chunk).contiguous() for k, v in xs.items()
           if tuple(v.shape) == (spec.n_chunks, spec.chunk)}
    out["ups"] = kin["UpsTable"]
    if "ev_ups" in xs:
        out["ev_ups"] = kin["EvaUpsTable"]
    for prefix, name in (("lk", "Lake"), ("rs", "Res")):
        if prefix + "_pos" in xs:
            rows = torch.as_tensor(lay.struct_rows[prefix])
            out.update({k: v.index_select(0, rows).contiguous() for k, v in xs.items()
                        if k.startswith(prefix + "_") and k[3:] not in ("pos", "fee")})
            out[prefix + "_pos"], out[prefix + "_fee"] = kin[name + "Pos"], kin[name + "Fee"]
    return dataclasses.replace(spec, n_chunks=n), out


@pytest.mark.parametrize("nranks", [2, 70])
def test_rank_sets_any_rank_count(nranks):
    """The ranks each pixel reaches downstream, on a chain of 140 pixels
    (pixel i drains to i + 1, rank i * N // 140 owns it): the natural
    graph's sets (downstream_ranks) and a packed schedule's of one pixel a
    chunk (downstream_rank_sets) hold exactly the owners of the pixels
    below, also with more ranks than a 64-bit set holds."""
    P = 140
    down = np.r_[np.arange(1, P), -1]
    owner = np.arange(P) * nranks // P
    want = np.zeros((P, nranks), bool)
    for i in range(P - 1):
        want[i, owner[i + 1:]] = True
    assert np.array_equal(shard_model.downstream_ranks(down, owner, nranks), want)
    src = np.arange(P - 1)
    got = shard_model.downstream_rank_sets(1, src, src + 1, owner, nranks)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_rank_substep_bitwise(dt):
    """The all-options synthetic 24x20 model (split routing, lakes,
    reservoirs, the evaporation chain in the kernel, water use, inflow and
    transmission loss in the sideflow), one step in, then the sub-step
    kernel's plain version on each rank's kept chunks (N = 2, 4, 4 shards)
    against it on the whole schedule: every output at the rank's own and
    halo lanes, and every kept structure's, bit for bit."""
    cfg, params, state, aux = _synthetic((24, 20), 4, options=True)
    step, p = build_step(cfg, params, aux, dtype=dt, device="cpu")
    f = to_device({**synthetic_forcing(cfg.num_pixels), **aux["forcing_options"]}, "cpu", dt)
    s, _ = step(step.prepare_state(state), f)
    spec, xs = kernel_operands(cfg, p, s, step.land_phase(s, f), step.routers)
    assert spec.E and spec.split and {"lk_pos", "rs_pos", "wuse", "qin_old", "uptrans"} <= set(xs)
    ys = ks.substep_reference(spec, xs)
    halos = 0
    for N in (2, 4):
        for r in range(N):
            lay = shard_model.PackedRankLayout(cfg, params, aux, r, N)
            lanes = np.union1d(lay.part("kin")["own"], lay.part("kin")["halo"])
            halos += lay.part("kin")["halo"].size
            loc = torch.as_tensor(lay.loc_of["kin"][lanes])
            got = ks.substep_reference(*rank_operands(spec, xs, lay))
            for k, v in got.items():
                if v.dim() == 2:
                    a, b = v.reshape(-1)[loc], ys[k].reshape(-1)[torch.as_tensor(lanes)]
                else:
                    a, b = v, ys[k][torch.as_tensor(lay.struct_rows[k[:2]])]
                assert torch.equal(a, b), (k, N, r)
    assert halos > 0


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_rank_sweep_bitwise(catchment, dt):
    """The 48x40 catchment's overland sweep (K5) on each rank's kept chunks
    of the overland schedule (N = 2, 4, 4 shards), through its plain
    version `_sweep` on the rank's tables (RankPackedRouter.sweep_tiles)
    and through the router's own sweep_operands with the halo's operands
    copied in, against the whole schedule's sweep at the rank's own and
    halo positions, bit for bit."""
    cfg, params, state, aux = _model(("catchment", (48, 40), 4), catchment, None)
    step, p = build_step(cfg, params, aux, dtype=dt, device="cpu")
    f = to_device(meteo_forcing(load_settings(catchment), cfg, aux)[0], "cpu", dt)
    s = step.prepare_state(state)
    d = step.land_phase(s, f)
    _, q0, lat, adx = overland_operands(cfg, p, s, d)
    whole = step.routers["tochan"]
    const_w, adx_w = whole.sweep_operands(q0, lat, adx, p["Beta"])
    q_w = kp._sweep(const_w, adx_w, whole.ups.long(), float(p["Beta"]))
    L = q0.shape[0]
    flat = lambda x: x.transpose(0, 1).reshape(L, -1)
    halos = 0
    for N in (2, 4):
        for r in range(N):
            lay = shard_model.PackedRankLayout(cfg, params, aux, r, N)
            part = lay.part("tochan")
            halos += part["halo"].size
            router = kp.RankPackedRouter(lay.local["tochan"], lay.router_part("tochan"), None,
                                         "cpu")
            assert not router.no_edges
            tiles = router.sweep_tiles()
            glob = torch.as_tensor(part["glob"])
            nat = torch.as_tensor(lay.pixels)
            router.exchange = False       # no group: the halo is copied in below
            c_loc, a_loc = router.sweep_operands(q0[:, nat], lat[:, nat], adx[:, nat], p["Beta"])
            halo = torch.as_tensor(lay.loc_of["tochan"][part["halo"]])
            c_loc, a_loc = flat(c_loc), flat(a_loc)
            c_loc[:, halo] = flat(const_w)[:, torch.as_tensor(part["halo"])]
            a_loc[:, halo] = flat(adx_w)[:, torch.as_tensor(part["halo"])]
            shape = (L, -1, router.ps.chunk)
            c_loc = c_loc.reshape(shape).transpose(0, 1).contiguous()
            a_loc = a_loc.reshape(shape).transpose(0, 1).contiguous()
            q = kp.kinwave_sweep(c_loc, a_loc, tiles, float(p["Beta"]))
            lanes = np.union1d(part["own"], part["halo"])
            loc = torch.as_tensor(lay.loc_of["tochan"][lanes])
            assert torch.equal(flat(q)[:, loc], flat(q_w)[:, torch.as_tensor(lanes)]), (N, r)
            # the router's own sweep: its own pixels, unpacked
            assert torch.equal(router.unpack(flat(q)), flat(q_w)[:, whole.inv_perm[nat]])
            assert glob.numel() == tiles.ups.shape[1]
    assert halos > 0


# ---------------------------------------------------------------------------
# processes: the command line, the all-options model, a catchment, the
# options across ranks


def _cli(n, shards, tmp):
    init, out = f"file://{tmp}/pg_{n}_{shards}", str(tmp / f"s{n}_{shards}.npz")
    return [[sys.executable, "-m", "lisflood_tpu_torch.parallel.multihost", "--kernel", "packed",
             "--rank", str(r), "--nprocs", str(n), "--steps", str(STEPS), "--device", "cpu",
             "--init-method", init, "--shards", str(shards)]
            + (["--out", out] if r == 0 else []) for r in range(n)], out


_RANKS = """
import dataclasses, json, sys
import numpy as np
import torch
sys.path[:0] = [{root!r}]
from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, landuse_forcing,
                                                 synthetic_forcing, with_options)
from lisflood_tpu_torch.parallel import multihost, shard_model

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
N, S, dtype, T = spec["nranks"], spec["shards"], getattr(torch, spec["dtype"]), spec["steps"]
group = multihost.initialize(spec["init"], N, rank)
out = {{}}
if spec["case"] == "catchment":
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.driver import LisfloodRunner
    runner = LisfloodRunner(load_settings(spec["path"]), dtype=dtype, device="cpu")
    assert runner.config.routing_kernel == "packed"
    days = [runner.forcing_for(i, runner.dates[i]) for i in range(T)]
    if N == 1:
        step, s = runner.step, runner.state
    else:
        step, s = shard_model.shard_runner_step(runner, group)
        days = [step.shard_forcing(f) for f in days]
elif spec["case"] == "synthetic":
    step, s, f, cfg = shard_model.build_sharded_model_step(group, 16, 16, dtype, "packed", S,
                                                           "cpu")
    days = [f] * T
else:
    cfg, params, state, aux = with_options(
        build_synthetic_model(16, 16, no_rout_steps=6, chunk_size=16),
        eva_outside_window=spec["eva_outside"])
    cfg = dataclasses.replace(cfg, routing_kernel=spec["router"], num_shards=S,
                              transient_landuse=spec["landuse"])
    base = {{**synthetic_forcing(cfg.num_pixels), **aux["forcing_options"]}}
    days = [{{**base, **(landuse_forcing(aux, i) if spec["landuse"] else {{}})}}
            for i in range(T)]
    if N == 1:
        step, _ = build_step(cfg, params, aux, dtype=dtype, device="cpu")
        days = [to_device(f, "cpu", dtype) for f in days]
    else:
        layout = shard_model.rank_layout(cfg, params, aux, rank, N)
        step = multihost.multihost_step((cfg, params, aux), layout, group, dtype, "cpu")
        days = [step.shard_forcing(f) for f in days]
    s = step.prepare_state(state, dtype)
for i, f in enumerate(days):
    s, d = step(s, f)
    reports = {{k: d[k] for k in spec["reports"] if k in d}}
    if N > 1:
        reports = step.gather(reports, reports)
    out.update({{f"{{k}}@{{i}}": v.cpu().numpy() for k, v in reports.items()}})
out.update(multihost.gather_state(step, s))
if N > 1 and spec["router"] == "packed":
    # the rank's routing state at its own and halo lanes, at their positions
    # in the whole packed schedule
    lay = step.layout
    part = lay.part("kin")
    lanes = np.union1d(part["own"], part["halo"])
    loc = torch.as_tensor(lay.loc_of["kin"][lanes])
    halo = {{"lanes": lanes, "n_halo": part["halo"].size}}
    halo.update({{k: v[..., loc].cpu().numpy() for k, v in s.items() if k.startswith("pk$")}})
    np.savez(spec["out"].replace(".npz", f"_lanes{{rank}}.npz"), **halo)
if N == 1 and spec["router"] == "packed":
    np.savez(spec["out"].replace(".npz", "_packed.npz"),
             **{{k: v.cpu().numpy() for k, v in s.items() if k.startswith("pk$")}})
if N > 1:
    multihost.collectives.barrier(group)
    multihost.collectives.destroy_group()
if rank == 0:
    np.savez(spec["out"], **out)
"""


def _job(spec, n, tmp):
    tag = "_".join(str(spec[k]) for k in ("case", "router", "landuse")) + f"_{n}"
    sp = dict(spec, nranks=n, out=str(tmp / f"{tag}.npz"), init=f"file://{tmp}/pg_{tag}",
              reports=REPORTS)
    return ([[sys.executable, "-c", _RANKS.format(root=ROOT), json.dumps(sp), str(r)]
             for r in range(n)], sp["out"])


OPTIONS = {"case": "options", "router": "packed", "shards": 4, "dtype": "float64",
           "steps": STEPS, "landuse": False, "eva_outside": False}
# groundwater smoothing (with_options switches it on) and transient land
# use, the evaporation chain outside the kernel (the packed router reads
# its result through the exchange), on each router
ACROSS = {r: dict(OPTIONS, router=r, landuse=True, eva_outside=True)
          for r in ("packed", "sharded")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, catchment):
    """Every process run of the module, in two waves of 13 processes side
    by side: the command line at 1, 2, 4 processes (4 shards) and 1, 2 (8
    shards) and the 48x40 catchment on 1 and 2 ranks; then the all-options
    packed model on 1, 2, 4 ranks and the options across ranks on 1 and 2
    ranks of each router."""
    tmp = tmp_path_factory.mktemp("runs")
    catch = dict(OPTIONS, case="catchment", path=catchment, steps=2)
    waves = [{("cli", n, S): _cli(n, S, tmp) for n, S in ((1, 4), (2, 4), (4, 4), (1, 8), (2, 8))},
             {("options", n): _job(OPTIONS, n, tmp) for n in (1, 2, 4)}]
    waves[0].update({("catchment", n): _job(catch, n, tmp) for n in (1, 2)})
    waves[1].update({(r, n): _job(sp, n, tmp) for r, sp in ACROSS.items() for n in (1, 2)})
    got = {"paths": {}}
    for jobs in waves:
        got.update(zip(jobs, _launch(list(jobs.values()))))
        got["paths"].update({k: v[1] for k, v in jobs.items()})
    return got


@pytest.mark.parametrize("shards", [4, 8])
def test_cli_packed_processes_bitwise(runs, shards):
    """The synthetic 16x16 model, float64, 3 steps, RoutingKernel packed:
    1, 2 (and at 4 shards 4) processes of the command line give the same
    gathered state, every entry bit for bit (the packed kernel's bits do
    not depend on the partition)."""
    ref = runs["cli", 1, shards]
    for n in (2, 4) if shards == 4 else (2,):
        _bitwise(ref, runs["cli", n, shards], f"{n} processes")
    assert ref["ChanQKin"].max() > 0


@pytest.mark.parametrize("nranks", [2, 4])
def test_options_packed_ranks_bitwise(runs, nranks):
    """The all-options synthetic model on the packed router (split routing,
    lakes, reservoirs, the evaporation chain in the kernel, water use with
    groundwater smoothing, the indicators, inflow, transmission loss,
    polders, water levels, pF, the mass-balance reports), 3 steps in
    float64: 2 and 4 ranks against one process, state and reports bit for
    bit."""
    ref = runs["options", 1]
    assert {"WEI_Dem@0", "MBError@2", "LakeInflowM3S@1", "UpstreamSumMonthDis@2"} <= set(ref)
    _bitwise(ref, runs["options", nranks], f"{nranks} ranks")


@pytest.mark.parametrize("router", ["packed", "sharded"])
def test_options_across_ranks_bitwise(runs, router):
    """Groundwater smoothing and transient land use (both on, with every
    other option of with_options, the evaporation chain outside the
    kernel), 3 steps in float64: 2 ranks against one process on each
    router, state and reports bit for bit."""
    ref, got = runs[router, 1], runs[router, 2]
    assert "MBError@2" in ref and "AverageFractions@0" not in REPORTS
    _bitwise(ref, got, f"2 ranks, {router}")
    assert not np.array_equal(ref["LZ"], runs["options", 1]["LZ"])


def test_catchment_packed_two_ranks_bitwise(runs):
    """A 48x40 catchment from its maps (split routing, lakes, reservoirs,
    open-water evaporation, repMBTs), RoutingKernel packed (its default),
    two days in float64 through LisfloodRunner: 2 ranks through
    shard_runner_step against the runner's own step, state and reports bit
    for bit; each rank's routing state at its own and halo lanes is the
    one-process state at their positions (a halo's owner's)."""
    ref, got = runs["catchment", 1], runs["catchment", 2]
    assert {"MBErrorSplitRoutingM3@1", "LakeInflowM3S@0", "ReservoirOutflowM3S@1"} <= set(ref)
    _bitwise(ref, got, "2 ranks")
    whole = dict(np.load(runs["paths"]["catchment", 1].replace(".npz", "_packed.npz")))
    halos = 0
    for r in (0, 1):
        lanes = dict(np.load(runs["paths"]["catchment", 2].replace(".npz", f"_lanes{r}.npz")))
        halos += int(lanes.pop("n_halo"))
        pos = lanes.pop("lanes")
        assert set(lanes) == set(whole)
        for k, v in lanes.items():
            np.testing.assert_array_equal(v, whole[k][..., pos], err_msg=f"rank {r}, {k}")
    assert halos > 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_packed_ranks_match_jax(runs, tmp_path, dt):
    """Two packed ranks of the synthetic 16x16 model (4 shards, 3 steps;
    float64 the command line's run, float32 through
    build_sharded_model_step) against the JAX package's one-device packed
    step (its sequential sub-step loop) on the same arrays: float64 within 1e-10 and float32 within 1.5e-4 of each
    field's max (the gates of tests/test_torch_multihost.py). Measured
    2.0e-13 (float64) and 5.4e-5 (float32)."""
    if dt == "f64":
        got = runs["cli", 2, 4]
    else:
        got, = _launch([_job(dict(OPTIONS, case="synthetic", dtype="float32"), 2, tmp_path)])
    cfg, params, state, aux = build_synthetic_model(16, 16)
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
    print(f"two packed ranks against the JAX packed step, {dt}: {worst:.3e} of a field's max")
