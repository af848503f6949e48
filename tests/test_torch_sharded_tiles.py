"""K6's tile tables (lisflood_tpu_torch/ops/kinwave_sharded.py:sharded_tables,
from ops/wavefront.py:sweep_tiles with the schedule's padding left out), the
launch plan (sharded_plan) and a plain emulation of csrc/kinwave_sharded.cu
run on them, on sharded schedules of three kinds of graph: the synthetic
240x200 channel graph at 1, 2, 4 and 8 shards (cut edges from 2 on), and the
channel and overland graphs of write_catchment at 96x80 and 240x200 on 4
shards (the overland graph with cut edges).

The emulation follows the kernel block by block: shallow tiles level by level
from the tile's own q; deep tiles through the ring of the last two levels' q,
with the tables copied kLeadTable levels ahead and the operands kLeadGather
levels ahead into their slots, each group of copies landing either at once or
as late as cp.async.wait_group allows; tiles too wide for the ring reading q
back from the output; the padding solved elementwise. It must give the bits
of the plain `_sweep_sharded` in float32 and float64 at caps 1, 64 and 1024,
and with every tile sent down each path, and it is held to the JAX package's
sharded sweep within the tolerances of test_torch_sharded.py's router test
(float64) and of the sharded step's first step (float32). The emulation on
every graph at every cap, bit for bit with `_sweep_sharded`, is
tests/test_torch_sharded_emulation.py's (a file of its own, so that the
tier-1 run, which gives each file whole to a worker, runs it beside these)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.models.synthetic import build_synthetic_model as jax_synthetic_model
from lisflood_tpu.ops.kinwave_sharded import ShardedRouter as JaxShardedRouter
from lisflood_tpu_torch.models.step import build_routers
from lisflood_tpu_torch.ops import kinwave_sharded as S
from lisflood_tpu_torch.ops.kinwave_packed import SWEEP_THREADS, newton_solve, sweep_fit
from lisflood_tpu_torch.ops.wavefront import SWEEP_CAP, TILE_ALIGN
from lisflood_tpu_torch.parallel.partition import catchment_partition

CAPS = (1, 64, SWEEP_CAP)
GRAPHS = ("synthetic S=1", "synthetic S=2", "synthetic S=4", "synthetic S=8",
          "96x80 channel", "96x80 overland", "240x200 channel", "240x200 overland")
# graphs on which every tile is also sent down the ring and the global path
# (few tiles: the emulation walks a ring tile in Python, level by level)
FORCED = ("synthetic S=4", "synthetic S=8", "96x80 channel", "96x80 overland")
BETA = 0.6
# shared memory a block of an H100 can have, and the kernel's static share
# (256 level offsets of int32)
H100_OPTIN, STATIC = 232448, 1024


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (graph, shard_of, chunk, lanes): the JAX synthetic 240x200
    channel graph, and the catchments' graphs on their channel partition."""
    from lisflood_tpu_torch.config import load_settings
    from lisflood_tpu_torch.models.initial import build_model
    from lisflood_tpu_torch.models.synthetic import write_catchment
    out = {}
    g = jax_synthetic_model(240, 200)[3]["graph_kin"]
    for n in (1, 2, 4, 8):
        out[f"synthetic S={n}"] = (g, catchment_partition(g, n)[0], 64, 2)
    for rows, cols in ((96, 80), (240, 200)):
        path = write_catchment(tmp_path_factory.mktemp(f"c{rows}"), rows, cols, seed=0,
                               n_steps=1, nc_format="classic")
        aux = build_model(load_settings(path))[3]
        shard_of = catchment_partition(aux["graph_kin"], 4)[0]
        out[f"{rows}x{cols} channel"] = (aux["graph_kin"], shard_of, 256, 2)
        out[f"{rows}x{cols} overland"] = (aux["graph_tochan"], shard_of, 256, 3)
    return out


_routers = {}


def _router(graphs, name):
    if name not in _routers:
        graph, shard_of, chunk, _ = graphs[name]
        _routers[name] = S.ShardedRouter(graph, shard_of, chunk, device="cpu")
    return _routers[name]


def _operands(graphs, name, dtype, seed=1):
    """Natural-order (L, P) discharge, lateral inflow and alpha*dx/dt, and
    the router's packed (const, adx)."""
    router = _router(graphs, name)
    L, P = graphs[name][3], router.ps.num_pixels
    rng = np.random.default_rng(seed)
    nat = (rng.uniform(0, 100, (L, P)), rng.uniform(0, 5, (L, P)), rng.uniform(1e-3, 1e3, (L, P)))
    nat = tuple(v.astype(dtype) for v in nat)
    return nat, router.sweep_operands(*(torch.as_tensor(v) for v in nat), BETA)


def _solve(cc, adx, piece=16384):
    """newton_solve on flat batches of at most `piece` elements, each padded
    to a multiple of 64, so that every element takes ATen's vectorised loop
    in one thread (a larger batch is split over threads at boundaries of
    their own), as _sweep_sharded's (L, S*C) batches do."""
    flat_c, flat_a = cc.reshape(-1), adx.reshape(-1)
    out = []
    for i in range(0, flat_c.numel(), piece):
        c, a = flat_c[i:i + piece], flat_a[i:i + piece]
        ones = c.new_ones(-c.numel() % 64)
        out.append(newton_solve(torch.cat([c, ones]), torch.cat([a, ones]), BETA)[:c.numel()])
    return torch.cat(out).reshape(cc.shape) if out else cc.clone()


class _Tables:
    """The tables of a ShardedTiles as int64 NumPy arrays, with each entry's
    tile and level."""

    def __init__(self, tiles):
        self.K = tiles.ups.shape[0]
        self.tp, self.pos, self.slots, self.lp, self.lo, ring = (
            getattr(tiles, k).numpy().astype(np.int64)
            for k in ("tile_ptr", "pos", "slots", "lvl_ptr", "lvl_off", "ring"))
        self.R = 4 * -(-(self.K + 1) // 4)
        self.ring = ring.reshape(-1, self.R)
        n_tiles = self.tp.size - 1
        self.tile_of = np.repeat(np.arange(n_tiles), np.diff(self.tp))
        self.local = np.arange(self.pos.size) - self.tp[self.tile_of]
        self.level = np.full(self.pos.size, -1)
        for t in range(n_tiles):
            lv = self.lv(t)
            self.level[self.tp[t]:self.tp[t] + lv[-1]] = np.repeat(np.arange(lv.size - 1),
                                                                   np.diff(lv))

    def lv(self, t):
        return self.lo[self.lp[t]:self.lp[t + 1]]

    def src(self, e, k):
        """Row k of the source slots of entries e (tile-local, -1 = none)."""
        t = self.tile_of[e]
        return self.slots[self.K * self.tp[t] + k * (self.tp[t + 1] - self.tp[t]) + self.local[e]]


def paths(tiles, plan):
    """Each tile's path in the kernel under `plan`: 0 shallow, 1 ring, 2
    global (the dispatch of sharded_kernel)."""
    deep = tiles.padded > plan["n_smem"]
    ring = deep & (tiles.widths <= plan["ring_w"]) & (tiles.levels <= plan["ring_levels"])
    return np.where(~deep, 0, np.where(ring, 1, 2))


def _shallow(const_p, adx_p, q, tb, tiles_on):
    """The shallow tiles, each level by level from its own q; the tiles are
    independent, so their levels run side by side here."""
    e = np.flatnonzero(tiles_on[tb.tile_of] & (tb.level >= 0))
    if not e.size:
        return
    loc = np.full(tb.pos.size, -1)
    loc[e] = np.arange(e.size)
    p = tb.pos[e]
    qe = const_p[:, p].clone()                              # const, then q
    ae = adx_p[:, p]
    base = tb.tp[tb.tile_of[e]]
    for d in range(int(tb.level[e].max()) + 1):
        m = np.flatnonzero(tb.level[e] == d)
        inflow = const_p.new_zeros(const_p.shape[0], m.size)
        for k in range(tb.K):
            s = tb.src(e[m], k)
            on = s >= 0
            idx = np.where(on, loc[base[m] + np.maximum(s, 0)], 0)
            assert (idx[on] >= 0).all()
            inflow = inflow + torch.where(torch.as_tensor(on), qe[:, idx], 0.0)
        qe[:, m] = _solve(inflow + qe[:, m], ae[:, m])
    q[:, p] = qe


def _ring(const_p, adx_p, q, tb, t, W, late):
    """One tile through the ring (run_ring): the loop from d = -kLeadTable,
    the records and operands copied into their slots as groups that land at
    once or, `late`, at the wait of the iteration kWait + 1 after their
    issue."""
    NT, NG = S.TABLE_SLOTS, S.GATHER_SLOTS
    lead_g, lead_t = NG - 1, NT - 1
    wait = lead_g - 1
    assert lead_t == lead_g + wait + 1
    L, K = const_p.shape[0], tb.K
    lv = tb.lv(t)
    levels, b = lv.size - 1, tb.tp[t]
    ring = const_p.new_full((2, L, W), float("nan"))
    gat = const_p.new_full((NG, 2, L, W), float("nan"))
    tab = np.full((NT, W, tb.R), -(10 ** 9), np.int64)      # what has not landed
    pending = []

    def issue(group, land):
        if late:
            pending.append((group, land))
        else:
            land()
    for d in range(-lead_t, levels):
        for _, land in [g for g in pending if g[0] <= d - 1 - wait]:
            land()
        pending = [g for g in pending if g[0] > d - 1 - wait]
        x = d + lead_t
        if x < levels:
            rec = tb.ring[b + lv[x]:b + lv[x + 1]]

            def land(slot=x % NT, rec=rec):
                tab[slot, :rec.shape[0]] = rec
            issue(d, land)
        y = d + lead_g
        if 0 <= y < levels:
            p = tab[y % NT, :lv[y + 1] - lv[y], 0].copy()
            assert (p >= 0).all(), "a gather reads a position that has not landed"
            vals = const_p[:, p].clone(), adx_p[:, p].clone()

            def land(slot=y % NG, vals=vals):
                gat[slot, :, :, :vals[0].shape[1]] = torch.stack(vals)
            issue(d, land)
        if d < 0:
            continue
        cnt = lv[d + 1] - lv[d]
        td, gd, rin = tab[d % NT, :cnt], gat[d % NG], ring[(d + 1) & 1]
        inflow = const_p.new_zeros(L, cnt)
        for k in range(K):
            s = td[:, 1 + k]
            on = s >= 0
            assert (s[on] < W).all() and (s >= -1).all()
            inflow = inflow + torch.where(torch.as_tensor(on), rin[:, np.maximum(s, 0)], 0.0)
        out = _solve(inflow + gd[0, :, :cnt], gd[1, :, :cnt])
        ring[d & 1, :, :cnt] = out
        q[:, td[:, 0]] = out


def _global(const_p, adx_p, q, tb, t):
    """One tile with q read back from the output (run_global)."""
    lv = tb.lv(t)
    for d in range(lv.size - 1):
        e = tb.tp[t] + np.arange(lv[d], lv[d + 1])
        inflow = const_p.new_zeros(const_p.shape[0], e.size)
        for k in range(tb.K):
            s = tb.src(e, k)
            on = s >= 0
            src = tb.pos[tb.tp[t] + np.maximum(s, 0)]
            inflow = inflow + torch.where(torch.as_tensor(on), q[:, src], 0.0)
        p = tb.pos[e]
        q[:, p] = _solve(inflow + const_p[:, p], adx_p[:, p])


def emulate(const_p, adx_p, tiles, plan, late=True):
    """The launch of csrc/kinwave_sharded.cu in plain PyTorch on the tables
    of `tiles` and the paths of `plan` (sharded_plan): const_p/adx_p (L,
    p_pad) -> q (L, p_pad)."""
    tb = _Tables(tiles)
    q = torch.full_like(const_p, float("nan"))
    way = paths(tiles, plan)
    _shallow(const_p, adx_p, q, tb, way == 0)
    for t in np.flatnonzero(way == 1):
        _ring(const_p, adx_p, q, tb, t, plan["ring_w"], late)
    for t in np.flatnonzero(way == 2):
        _global(const_p, adx_p, q, tb, t)
    pad = tiles.pad.long()
    q[:, pad] = _solve(const_p.new_zeros(const_p.shape[0], pad.numel()) + const_p[:, pad],
                       adx_p[:, pad])
    return q


def _plan(tiles, L, itemsize, path=None):
    """sharded_plan on an H100's shared memory; `path` "ring" sends every
    tile of more than 8 entries through the ring, "global" every tile past
    the shared-memory fit to global memory."""
    plan = S.sharded_plan(tiles, H100_OPTIN, STATIC, L, itemsize)
    if path == "ring":
        ring_w = int(-(-tiles.widths.max() // S.RING_ALIGN) * S.RING_ALIGN)
        plan.update(n_smem=TILE_ALIGN, ring_w=ring_w, ring_levels=int(tiles.levels.max()))
    elif path == "global":
        plan.update(ring_w=0, ring_levels=0)
    return plan


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", GRAPHS)
def test_tables(graphs, name, cap):
    """Every real position in exactly one tile and the padding in none (it
    is `pad`); every source in its tile's level just below, at a ring offset
    within that level, which each entry's ring record holds after its
    position; the slots in the order of `ups`; whole trees, at
    most `cap` positions unless one; each tile's widest level; the deepest
    depth class first."""
    router = _router(graphs, name)
    ps, ups = router.ps, router.ups.numpy().astype(np.int64)
    tiles = router.sweep_tiles(cap)
    assert tiles is router.sweep_tiles(cap) and tiles.cap == cap
    tb = _Tables(tiles)
    real = ps.perm < ps.num_pixels
    on = tb.pos >= 0
    np.testing.assert_array_equal(np.sort(tb.pos[on]), np.flatnonzero(real))
    np.testing.assert_array_equal(tiles.pad.numpy(), np.flatnonzero(~real))
    assert (np.diff(tb.tp) % TILE_ALIGN == 0).all() and (on == (tb.level >= 0)).all()
    for t in range(tiles.n_tiles):
        lv = tb.lv(t)
        assert lv[0] == 0 and (np.diff(lv) > 0).all() and tiles.widths[t] == np.diff(lv).max()
        assert tiles.levels[t] == lv.size - 1 and tiles.count[t] == lv[-1]
    np.testing.assert_array_equal(tiles.width.numpy(), tiles.widths)

    e = np.flatnonzero(on)
    first = tb.lo[tb.lp[tb.tile_of[e]] + np.maximum(tb.level[e] - 1, 0)]
    below = tb.lo[tb.lp[tb.tile_of[e]] + tb.level[e]] - first
    for k in range(tb.K):
        s = tb.src(e, k)
        src = ups[k, tb.pos[e]]
        assert ((s >= 0) == (src >= 0)).all()
        has = s >= 0
        se = tb.tp[tb.tile_of[e[has]]] + s[has]
        np.testing.assert_array_equal(tb.pos[se], src[has])
        assert (tb.tile_of[se] == tb.tile_of[e[has]]).all()
        assert (tb.level[se] == tb.level[e[has]] - 1).all()
        ring_off = s[has] - first[has]
        assert (ring_off >= 0).all() and (ring_off < below[has]).all()
        # the ring record: the position, then the offsets into the level below
        np.testing.assert_array_equal(tb.ring[e[has], 1 + k], ring_off)
        assert (tb.ring[e[~has], 1 + k] == -1).all()
    np.testing.assert_array_equal(tb.ring[:, 0], tb.pos)
    assert (tb.ring[:, tb.K + 1:] == -1).all() and (tb.ring[~on] == -1).all()
    # whole trees: a position's downstream in its tile
    entry_of = np.full(ps.p_pad, -1)
    entry_of[tb.pos[on]] = e
    down = ps.down_pos.astype(np.int64)
    has_down = down < ps.p_pad
    assert not has_down[~real].any()
    assert (tb.tile_of[entry_of[has_down]] == tb.tile_of[entry_of[down[has_down]]]).all()
    trees = np.bincount(tb.tile_of[entry_of[real & ~has_down]], minlength=tiles.n_tiles)
    assert ((tiles.count <= cap) | (trees == 1)).all()
    assert tiles.stats["trees"] == trees.sum() and tiles.stats["seconds"] >= 0
    # deepest first: the tiles' depth classes (ceil(log2(levels))) never rise
    assert (np.diff(np.ceil(np.log2(tiles.levels))) <= 0).all()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["synthetic S=4", "96x80 channel", "96x80 overland"])
def test_plan_fits_shared_memory(graphs, name, itemsize):
    """sharded_plan: the shallow tiles and the ring both fit a block's
    shared memory, with the kernel's static share; the ring is as wide as
    the widest level of the tiles it takes, a multiple of RING_ALIGN; its
    level threads cover a ring level's (lane, entry) pairs, with
    RING_COPY_THREADS more at least to copy ahead; the padding blocks
    cover the padding. With too little shared memory for any ring, the deep
    tiles read q from global memory."""
    L = graphs[name][3]
    tiles = _router(graphs, name).sweep_tiles(64)
    K = tiles.ups.shape[0]
    plan = S.sharded_plan(tiles, H100_OPTIN, STATIC, L, itemsize)
    budget = H100_OPTIN - STATIC
    assert plan["n_smem"] == tiles.n_smem(sweep_fit(H100_OPTIN, STATIC, L, K, itemsize))
    assert S.ring_bytes(L, K, itemsize, plan["ring_w"], plan["ring_levels"]) <= budget
    way = paths(tiles, plan)
    assert plan["ring_tiles"] == (way == 1).sum() and plan["global_tiles"] == (way == 2).sum()
    assert plan["ring_tiles"] > 0 and plan["global_tiles"] == 0
    assert plan["ring_w"] % S.RING_ALIGN == 0 and plan["ring_w"] - tiles.widths[way == 1].max() < 8
    rt = plan["ring_threads"]
    assert rt % 32 == 0 and rt >= min(L * plan["ring_w"], 1024 - S.RING_COPY_THREADS)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert plan["threads"] >= max(SWEEP_THREADS, rt + S.RING_COPY_THREADS)
    assert plan["pad_blocks"] * plan["threads"] * S.PAD_PER_THREAD >= plan["n_pad"] > 0
    tight = S.ring_bytes(L, K, itemsize, 8, 1) + STATIC - 1
    starved = S.sharded_plan(tiles, max(tight, STATIC), STATIC, L, itemsize)
    assert starved["ring_tiles"] == 0 and starved["ring_w"] == starved["ring_threads"] == 0
    assert starved["global_tiles"] == (tiles.padded > starved["n_smem"]).sum() > 0


_plain = {}


def _plain_q(graphs, name, dtype, const_p, adx_p):
    key = (name, dtype)
    if key not in _plain:
        r = _router(graphs, name)
        _plain[key] = S._sweep_sharded(const_p, adx_p, r.ups.long(), r.ps.n_chunks,
                                       r.ps.n_shards, r.ps.chunk, BETA)
    return _plain[key]


def _bits(q):
    return q.view(torch.int32 if q.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("path", ["ring", "global"])
@pytest.mark.parametrize("name", FORCED)
def test_emulation_every_path(graphs, name, path, dtype):
    """Every tile of more than 8 entries through the ring (copies landing
    late and at once), or every deep tile reading q from global memory: the
    bits of `_sweep_sharded` all the same, at cap 64."""
    _, (const_p, adx_p) = _operands(graphs, name, dtype)
    tiles = _router(graphs, name).sweep_tiles(64)
    ref = _plain_q(graphs, name, dtype, const_p, adx_p)
    plan = _plan(tiles, const_p.shape[0], const_p.element_size(), path)
    way = paths(tiles, plan)
    assert (way == (1 if path == "ring" else 2)).any()
    if path == "global":
        assert not (way == 1).any()
    assert torch.equal(_bits(emulate(const_p, adx_p, tiles, plan)), _bits(ref))
    if path == "ring":
        assert torch.equal(_bits(emulate(const_p, adx_p, tiles, plan, late=False)), _bits(ref))


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-10, 1e-12), (np.float32, 3e-5, 0.0)])
@pytest.mark.parametrize("name", ["synthetic S=4", "synthetic S=8", "96x80 channel",
                                  "96x80 overland"])
def test_emulation_vs_jax(graphs, name, dtype, rtol, atol):
    """The emulated launch at the default cap, unpacked to natural order,
    against the JAX package's ShardedRouter (its XLA scan) on the same
    inputs: float64 within rtol 1e-10, atol 1e-12 (test_torch_sharded's
    router gate), float32 within 3e-5 of the max (the sharded step's first
    step; the JAX sweep solves in q-space, the port in v-space)."""
    graph, shard_of, chunk, L = graphs[name]
    nat, (const_p, adx_p) = _operands(graphs, name, dtype, seed=2)
    router = _router(graphs, name)
    tiles = router.sweep_tiles()
    q = emulate(const_p, adx_p, tiles, _plan(tiles, L, const_p.element_size()))
    got = router.unpack(q).numpy()
    ref = np.asarray(JaxShardedRouter(graph, shard_of, chunk_size=chunk).route_batched(
        *(jnp.asarray(v) for v in nat), BETA))
    assert got.dtype == ref.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    else:
        assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_router_tables_and_cpu_dispatch(graphs):
    """The step's sharded routers build their tables with the step (those
    with edges); a router builds other caps at first use, once; on the CPU
    the wrapper launches nothing; sharded_trace, whose records come from
    the kernel, refuses; the wrapper refuses tables of the wrong shape or
    type."""
    import dataclasses
    from types import SimpleNamespace
    graph, _, _, _ = graphs["96x80 channel"]
    aux = {"graph_kin": graph, "graph_tochan": graphs["96x80 overland"][0]}
    routers = build_routers(SimpleNamespace(routing_kernel="sharded", num_shards=4), aux, "cpu")
    for key in ("kin", "tochan"):
        assert list(routers[key]._tiles) == [SWEEP_CAP] and not routers[key].no_edges
    router = routers["kin"]
    tiles = router.sweep_tiles()
    assert router.sweep_tiles(64) is router.sweep_tiles(64) and len(router._tiles) == 2
    c, a = router.sweep_operands(*(torch.rand(2, graph.num_pixels, dtype=torch.float64)
                                   for _ in range(3)), BETA)
    before = S.kinwave_sharded_sweep.launches
    q = S.kinwave_sharded_sweep(c, a, tiles, BETA)
    assert S.kinwave_sharded_sweep.launches == before and bool(torch.isfinite(q).all())
    with pytest.raises(RuntimeError, match="CUDA"):
        S.sharded_trace(c, a, tiles, BETA)
    with pytest.raises(ValueError, match="width"):
        S.kinwave_sharded_sweep(c, a, dataclasses.replace(tiles, width=tiles.width[:-1]), BETA)
    with pytest.raises(TypeError, match="pad"):
        S.kinwave_sharded_sweep(c, a, dataclasses.replace(tiles, pad=tiles.pad.long()), BETA)
    with pytest.raises(ValueError, match="slots"):
        S.kinwave_sharded_sweep(c, a, dataclasses.replace(tiles, slots=tiles.slots[:-1]), BETA)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tiles.cap = 1
