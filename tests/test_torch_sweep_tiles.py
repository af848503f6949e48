"""The overland sweep's tile tables (lisflood_tpu_torch/ops/wavefront.py:
sweep_tiles) and a plain emulation of the tile loop of
csrc/kinwave_sweep.cu run on them, on three graphs: the overland graph of a
96x80 write_catchment, the overland schedule of test_torch_kinwave.py, and a
hand-made graph with one tree larger than the cap (a chain of 3 x cap cells
with a broom of 8 at its head and side leaves along it).

The emulation follows the kernel: per tile, level by level, every (lane,
entry) pair sums its sources' q from the tile in slot order, adds const and
solves. It must give the bits of the plain `_sweep` in float32 and float64,
at caps 1, 64 and the default, and it is held to the JAX package's sweep
within the tolerances of test_torch_kinwave.py::test_sweep_overland_graph."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.ops import kinwave_packed as J
from lisflood_tpu_torch.graph.ldd import FlowGraph, build_schedule
from lisflood_tpu_torch.models.step import build_routers
from lisflood_tpu_torch.ops import kinwave_packed as K
from lisflood_tpu_torch.ops.wavefront import SWEEP_CAP, TILE_ALIGN, sweep_tiles
from test_torch_kinwave import _overland_schedule, _rel

CAPS = (1, 64, SWEEP_CAP)
GRAPHS = ("catchment", "overland", "hand")
BETA = 0.6


def _hand_schedule(n_chain):
    """A chain of n_chain cells (i -> i + 1, the last a pit) with a broom of
    8 leaves at its head and a side leaf on every 16th cell, 5 two-cell
    trees and 20 single cells; chunks of 16 (3 x 16 lane-positions, a whole
    number of ATen's float64 vector steps, as in the other graphs)."""
    down = [i + 1 for i in range(n_chain - 1)] + [-1]
    down += [0] * 8
    down += list(range(16, n_chain - 1, 16))
    for _ in range(5):
        down += [len(down) + 1, -1]
    down += [-1] * 20
    down = np.asarray(down, np.int32)
    # number the cells at random, so that positions follow no construction order
    perm = np.random.default_rng(4).permutation(down.size)
    inv = np.argsort(perm)
    renum = np.where(down >= 0, inv[np.maximum(down, 0)], -1)[perm].astype(np.int32)
    P = down.size
    return build_schedule(FlowGraph(downstream=renum, ldd=np.zeros(P, np.int8), num_pixels=P),
                          chunk_size=16)


@pytest.fixture(scope="module")
def catchment_schedule(tmp_path_factory):
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.initial import build_model
    from lisflood_tpu_torch.models.synthetic import write_catchment
    path = write_catchment(tmp_path_factory.mktemp("catchment"), 96, 80, seed=0, n_steps=1,
                           nc_format="classic")
    return build_model(load_settings(path))[3]["schedule_tochan"]


_routers = {}


def _router(request, graph, cap):
    """(schedule, CPU router) of `graph`; the hand-made graph's chain is 3 x
    cap cells (3 x 64 at cap 1)."""
    key = (graph, cap if graph == "hand" else None)
    if key not in _routers:
        if graph == "catchment":
            sched = request.getfixturevalue("catchment_schedule")
        elif graph == "overland":
            sched = _overland_schedule()
        else:
            sched = _hand_schedule(3 * max(cap, 64))
        _routers[key] = sched, K.PackedRouter(sched, "cpu")
    return _routers[key]


def _inputs(router, dtype, seed=1):
    """Natural-order (3, P) discharge, lateral inflow and alpha*dx/dt."""
    P = router.ps.num_pixels
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 2, (3, P)).astype(dtype), rng.uniform(0, 1e-2, (3, P)).astype(dtype),
            rng.uniform(1e-2, 10, (3, P)).astype(dtype))


def _solve(cc, adx):
    """newton_solve on flat batches padded to a multiple of 64 elements, so
    that every element takes ATen's vectorised loop, as _sweep's (L, C)
    batches do."""
    n = cc.numel()
    pad = -n % 64
    ones = cc.new_ones(pad)
    out = K.newton_solve(torch.cat([cc.reshape(-1), ones]), torch.cat([adx.reshape(-1), ones]),
                         BETA)
    return out[:n].reshape(cc.shape)


def emulate(const_p, adx_p, tab):
    """The kernel's tile loop in plain PyTorch on the tables of sweep_tiles:
    const_p/adx_p (n_chunks, L, C) -> q (n_chunks, L, C)."""
    n_chunks, L, C = const_p.shape
    q = torch.full_like(const_p, float("nan"))
    tile_ptr, pos, slots = tab["tile_ptr"], tab["pos"], tab["slots"]
    Kr = slots.size // pos.size
    for t in range(tile_ptr.size - 1):
        b, n_pad = int(tile_ptr[t]), int(tile_ptr[t + 1] - tile_ptr[t])
        lv = tab["lvl_off"][tab["lvl_ptr"][t]:tab["lvl_ptr"][t + 1]]
        p = torch.as_tensor(pos[b:b + lv[-1]].astype(np.int64))
        sl = torch.as_tensor(slots[Kr * b:Kr * (b + n_pad)].reshape(Kr, n_pad).astype(np.int64))
        qs = const_p[p // C, :, p % C].T.clone()          # (L, n): const, then q
        a = adx_p[p // C, :, p % C].T
        for d in range(lv.size - 1):
            e = torch.arange(int(lv[d]), int(lv[d + 1]))
            inflow = qs.new_zeros(L, e.numel())
            for k in range(Kr):
                s = sl[k, e]
                inflow = inflow + torch.where(s >= 0, qs[:, s.clamp_min(0)], 0.0)
            qs[:, e] = _solve(inflow + qs[:, e], a[:, e])
        q[p // C, :, p % C] = qs.T
    return q


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_tables(request, graph, cap):
    """Every position appears exactly once; every source lies in the same
    tile at a lower level; each entry's slots name its sources in the order
    of `ups`; padding positions are single-cell trees; a tile holds whole
    trees, at most `cap` positions unless it is one tree."""
    router = _router(request, graph, cap)[1]
    ps = router.ps
    ups = router.ups.numpy()
    tab = sweep_tiles(ps.down_pos, ups, ps.p_pad, cap)
    tile_ptr, pos, slots = (tab[k].astype(np.int64) for k in ("tile_ptr", "pos", "slots"))
    Kr = ups.shape[0]
    assert slots.size == Kr * pos.size and (np.diff(tile_ptr) % TILE_ALIGN == 0).all()
    on = pos >= 0
    np.testing.assert_array_equal(np.sort(pos[on]), np.arange(ps.p_pad))

    n_tiles = tile_ptr.size - 1
    tile_of = np.repeat(np.arange(n_tiles), np.diff(tile_ptr))
    local = np.arange(pos.size) - tile_ptr[tile_of]
    level = np.full(pos.size, -1)
    for t in range(n_tiles):
        lv = tab["lvl_off"][tab["lvl_ptr"][t]:tab["lvl_ptr"][t + 1]].astype(np.int64)
        assert lv[0] == 0 and (np.diff(lv) > 0).all()
        b = tile_ptr[t]
        level[b:b + lv[-1]] = np.repeat(np.arange(lv.size - 1), np.diff(lv))
        assert (pos[b:b + lv[-1]] >= 0).all() and (pos[b + lv[-1]:tile_ptr[t + 1]] == -1).all()
        # sorted by (level, position) within the tile
        key = level[b:b + lv[-1]] * ps.p_pad + pos[b:b + lv[-1]]
        assert (np.diff(key) > 0).all()
    assert tab["levels"] == level.max() + 1

    entry_of = np.empty(ps.p_pad, np.int64)
    entry_of[pos[on]] = np.flatnonzero(on)
    e = np.flatnonzero(on)
    row = tile_ptr[tile_of[e]] * Kr + local[e]
    n_pad = np.diff(tile_ptr)[tile_of[e]]
    for k in range(Kr):
        sl = slots[row + k * n_pad]
        src = ups[k, pos[e]]
        assert ((sl >= 0) == (src >= 0)).all()
        has = sl >= 0
        # the slot's entry holds the source `ups` names, in the same tile, lower
        se = tile_ptr[tile_of[e[has]]] + sl[has]
        np.testing.assert_array_equal(pos[se], src[has])
        assert (tile_of[se] == tile_of[e[has]]).all() and (level[se] < level[e[has]]).all()
    # a position's downstream lies in its tile: tiles hold whole trees
    down = ps.down_pos.astype(np.int64)
    has_down = down < ps.p_pad
    assert (tile_of[entry_of[has_down.nonzero()[0]]] == tile_of[entry_of[down[has_down]]]).all()
    pad = ps.perm >= ps.num_pixels
    assert not has_down[pad].any() and (ups[:, pad] == -1).all()
    size = np.diff(tile_ptr)
    count = np.array([tab["lvl_off"][tab["lvl_ptr"][t + 1] - 1] for t in range(n_tiles)])
    roots = ~has_down
    trees = np.bincount(tile_of[entry_of[roots]], minlength=n_tiles)
    assert ((count <= cap) | (trees == 1)).all() and (size >= count).all()
    assert tab["trees"] == roots.sum() and tab["largest_tile"] == count.max()
    if graph == "hand":
        assert tab["largest_tree"] > cap and Kr == 8


_plain = {}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_emulation_bitwise(request, graph, cap, dtype):
    """The kernel's tile loop, emulated on the tables, gives the bits of the
    plain version `_sweep`."""
    router = _router(request, graph, cap)[1]
    q0, lat, adx = (torch.as_tensor(v) for v in _inputs(router, dtype))
    const_p, adx_p = router.sweep_operands(q0, lat, adx, BETA)
    key = (graph, cap if graph == "hand" else None, dtype)
    if key not in _plain:
        _plain[key] = K._sweep(const_p, adx_p, router.ups.long(), BETA)
    ps = router.ps
    got = emulate(const_p, adx_p, sweep_tiles(ps.down_pos, router.ups.numpy(), ps.p_pad, cap))
    bits = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got.view(bits), _plain[key].view(bits))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
@pytest.mark.parametrize("graph", GRAPHS)
def test_emulation_vs_jax(request, graph, dtype, tol):
    """The emulated tile loop at the default cap, unpacked to natural order,
    against the JAX package's PackedRouter (an XLA scan), 3 lanes."""
    sched, router = _router(request, graph, SWEEP_CAP)
    q0, lat, adx = _inputs(router, dtype, seed=2)
    ref = np.asarray(J.PackedRouter(sched).route_batched(
        jnp.asarray(q0), jnp.asarray(lat), jnp.asarray(adx), BETA))
    ps = router.ps
    const_p, adx_p = router.sweep_operands(*(torch.as_tensor(v) for v in (q0, lat, adx)), BETA)
    q = emulate(const_p, adx_p, sweep_tiles(ps.down_pos, router.ups.numpy(), ps.p_pad, SWEEP_CAP))
    got = router.unpack(q.transpose(0, 1).reshape(3, ps.p_pad)).numpy()
    assert got.dtype == ref.dtype
    assert _rel(ref, got) <= tol, _rel(ref, got)


def test_router_tables_lazy_and_cpu_dispatch():
    """A router builds its tile tables at its first sweep, once per cap;
    the step's routers build the overland router's with the step and none
    for the channel router; on the CPU kinwave_sweep runs the plain version
    and launches nothing, and sweep_trace, whose records come from the
    kernel, refuses."""
    sched = _overland_schedule()
    routers = build_routers(SimpleNamespace(routing_kernel="packed"),
                            {"schedule_kin": sched, "schedule_tochan": sched}, "cpu")
    assert list(routers["tochan"]._tiles) == [SWEEP_CAP] and routers["kin"]._tiles == {}
    router = K.PackedRouter(sched, "cpu")
    assert router._tiles == {}
    q0, lat, adx = (torch.as_tensor(v) for v in _inputs(router, np.float32))
    launches = K.kinwave_sweep.launches
    out = router.route_batched(q0, lat, adx, BETA)
    tiles = router.sweep_tiles()
    assert list(router._tiles) == [SWEEP_CAP] and router.sweep_tiles() is tiles
    assert tiles.n_tiles == tiles.count.size and tiles.stats["seconds"] >= 0
    assert bool(torch.isfinite(out).all()) and K.kinwave_sweep.launches == launches
    ops = router.sweep_operands(q0, lat, adx, BETA)
    with pytest.raises(ValueError, match="ups"):
        K.kinwave_sweep(*ops, dataclasses.replace(tiles, ups=tiles.ups[:, :-1].contiguous()), BETA)
    with pytest.raises(ValueError, match="slots"):
        K.kinwave_sweep(*ops, dataclasses.replace(tiles, slots=tiles.slots[:-1]), BETA)
    with pytest.raises(TypeError, match="pos"):
        K.kinwave_sweep(*ops, dataclasses.replace(tiles, pos=tiles.pos.long()), BETA)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.sweep_trace(*ops, tiles, BETA)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tiles.cap = 1


# shared memory a block of an H100 can have, and the kernel's static share
# (256 level offsets of int32)
H100_OPTIN, STATIC = 232448, 1024


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [1, 3, 4, 5, 8])
def test_sweep_fit_budget(rows, itemsize):
    """sweep_fit gives the most padded entries whose shared memory, with the
    kernel's static share, fits the block's: a tile at the fit launches, one
    TILE_ALIGN entries larger would not; a table's n_smem at that fit keeps
    tiles up to it in shared memory and sends larger ones to global memory,
    the tiles just below the fit without the static share among them."""
    entry = 2 * 3 * itemsize + 4 * (4 if rows <= 4 else 8) + 4
    fit = K.sweep_fit(H100_OPTIN, STATIC, 3, rows, itemsize)
    assert fit % TILE_ALIGN == 0
    assert fit * entry + STATIC <= H100_OPTIN < (fit + TILE_ALIGN) * entry + STATIC
    loose = K.sweep_fit(H100_OPTIN, 0, 3, rows, itemsize)
    assert loose * entry <= H100_OPTIN and loose >= fit
    padded = np.array([fit - TILE_ALIGN, fit, fit + TILE_ALIGN, loose + TILE_ALIGN])
    tiles = K.SweepTiles(ups=None, tile_ptr=None, pos=None, slots=None, lvl_ptr=None,
                         lvl_off=None, cap=10 ** 6, count=padded, padded=padded, stats={})
    assert tiles.n_smem(fit) == fit
    assert int((tiles.padded > tiles.n_smem(fit)).sum()) == 2
    # a tile over the cap keeps q in global memory whatever its size
    capped = dataclasses.replace(tiles, cap=fit - TILE_ALIGN)
    assert capped.n_smem(fit) == fit - TILE_ALIGN
