"""The port's kinematic-wave solvers and packed router
(lisflood_tpu_torch/ops/kinwave_packed.py) against the JAX package's, on
the adversarial sweeps of tests/test_kinwave.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lisflood_tpu.ops import kinwave_packed as J
from lisflood_tpu_torch.graph.ldd import FlowGraph, build_schedule
from lisflood_tpu_torch.models.synthetic import synthetic_drainage
from lisflood_tpu_torch.ops import kinwave_packed as K


def _rel(a, b):
    """max |a - b| over max |a|."""
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def sweep():
    """(a, c) pairs over a in 1e-4..1e4, c in 1e-10..1e8 (test_kinwave.py
    test_newton_v_polynomial_solver) plus the channel-geometry grid of
    test_newton_fixed_iterations_converge."""
    rng = np.random.default_rng(7)
    a = 10 ** rng.uniform(-4, 4, 100000)
    c = 10 ** rng.uniform(-10, 8, 100000)
    ga, gc = np.meshgrid(np.logspace(-4, 5, 40), np.logspace(-10, 6, 40))
    return np.r_[a, ga.ravel()], np.r_[c, gc.ravel()]


@pytest.mark.parametrize("p", [0.2, 1.0 / 3.0])
def test_root_est_bitwise(sweep, p):
    """The exponent bit-hack is the same integer arithmetic: bitwise equal."""
    x = sweep[1].astype(np.float32)
    ref = np.asarray(J._root_est(jnp.asarray(x), p))
    got = K._root_est(torch.as_tensor(x), p).numpy()
    np.testing.assert_array_equal(got, ref)


def test_newton_v_bitwise(sweep):
    """Polynomial v-space Newton, float32: the same operation sequence,
    bitwise equal."""
    a, c = (v.astype(np.float32) for v in sweep)
    ref = np.asarray(J._newton_v(jnp.asarray(c), jnp.asarray(a)))
    got = K._newton_v(torch.as_tensor(c), torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype,beta,tol", [
    (np.float32, 0.6, 0.0),      # v-space: bitwise
    (np.float32, 0.72, 1e-6),    # q-space: pow's last bits differ (XLA vs ATen)
    (np.float64, 0.6, 1e-12),
    (np.float64, 0.72, 1e-12),
])
def test_newton_solve(sweep, dtype, beta, tol):
    """newton_solve's dispatch (float32 + beta 3/5 -> v-space, else the
    q-space _newton_unrolled) and its result, relative to the largest q."""
    a, c = (v.astype(dtype) for v in sweep)
    ref = np.asarray(J.newton_solve(jnp.asarray(c), jnp.asarray(a), beta))
    got = K.newton_solve(torch.as_tensor(c), torch.as_tensor(a), beta).numpy()
    assert got.dtype == ref.dtype
    assert _rel(ref, got) <= tol, _rel(ref, got)


@pytest.mark.parametrize("iters", [None, 18])
def test_newton_unrolled(sweep, iters):
    """q-space Newton, float64, at the default unroll and past the fixed
    point (18 iterations equal 6 on this sweep in the JAX package)."""
    a, c = sweep
    ref = np.asarray(J._newton_unrolled(jnp.asarray(c), jnp.asarray(a), 0.6, iters=iters))
    got = K._newton_unrolled(torch.as_tensor(c), torch.as_tensor(a), 0.6, iters=iters).numpy()
    assert _rel(ref, got) <= 1e-12


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_route_batched_with_edges(dtype, tol):
    """PackedRouter.route_batched on a schedule with edges (the chunk loop
    that stands in for the JAX package's XLA sweep), 3 lanes, against the
    JAX router on the same schedule."""
    nrows, ncols = 24, 20
    _, down = synthetic_drainage(nrows, ncols, seed=3)
    P = nrows * ncols
    graph = FlowGraph(downstream=down, ldd=np.zeros(P, np.int8), num_pixels=P)
    sched = build_schedule(graph, chunk_size=32)
    rng = np.random.default_rng(0)
    q0 = rng.uniform(0, 100, (3, P)).astype(dtype)
    lat = rng.uniform(0, 5, (3, P)).astype(dtype)
    adx = rng.uniform(1e-3, 1e3, (3, P)).astype(dtype)
    ref = np.asarray(J.PackedRouter(sched).route_batched(
        jnp.asarray(q0), jnp.asarray(lat), jnp.asarray(adx), 0.6))
    router = K.PackedRouter(sched, "cpu")
    assert not router.no_edges and router.ps.window >= 1
    got = router.route_batched(torch.as_tensor(q0), torch.as_tensor(lat),
                               torch.as_tensor(adx), 0.6).numpy()
    assert _rel(ref, got) <= tol, _rel(ref, got)


def _overland_schedule(nrows=48, ncols=40, chunk=64):
    """The overland (to-channel) schedule of a realistic catchment: the
    synthetic drainage cut by ldd_to_channel at a channel mask of the cells
    whose upstream cell count is in the top fifth."""
    from lisflood_tpu_torch.graph.ldd import build_flow_graph, ldd_to_channel
    from lisflood_tpu_torch.io.grid import Grid
    P = nrows * ncols
    ldd, down = synthetic_drainage(nrows, ncols, seed=5)
    ups = FlowGraph(downstream=down, ldd=ldd, num_pixels=P).accuflux(np.ones(P))
    grid = Grid(west=0.0, north=0.0, cell=1.0, nrows=nrows, ncols=ncols,
                mask2d=np.zeros((nrows, ncols), bool))
    tochan = build_flow_graph(ldd_to_channel(ldd, ups >= np.quantile(ups, 0.8)), grid)
    return build_schedule(tochan, chunk_size=chunk)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_sweep_overland_graph(dtype, tol):
    """The plain sweep (PackedRouter on the CPU) on a realistic overland
    graph against the JAX package's PackedRouter (an XLA scan summing
    upstream inflow with a one-hot product), 3 lanes."""
    sched = _overland_schedule()
    P = sched.num_pixels
    rng = np.random.default_rng(1)
    q0 = rng.uniform(0, 2, (3, P)).astype(dtype)
    lat = rng.uniform(0, 1e-2, (3, P)).astype(dtype)
    adx = rng.uniform(1e-2, 10, (3, P)).astype(dtype)
    ref = np.asarray(J.PackedRouter(sched).route_batched(
        jnp.asarray(q0), jnp.asarray(lat), jnp.asarray(adx), 0.6))
    router = K.PackedRouter(sched, "cpu")
    assert not router.no_edges and router.ps.n_chunks > 4
    got = router.route_batched(torch.as_tensor(q0), torch.as_tensor(lat),
                               torch.as_tensor(adx), 0.6).numpy()
    assert got.dtype == ref.dtype
    assert _rel(ref, got) <= tol, _rel(ref, got)


def test_sweep_tables_and_repeatability():
    """The sweep's tables: every position's sources ascending (-1 after
    them) and pointing to earlier chunks; the tile tables hold every
    position once, and every source in its target's tile, earlier in the
    tile's (level, position) order. The plain version gives the same bits
    in two runs."""
    router = K.PackedRouter(_overland_schedule(), "cpu")
    ps = router.ps
    tiles = router.sweep_tiles()
    ups = router.ups.numpy()
    C = ps.chunk
    assert ups.dtype == np.int32 and ups.shape[0] <= 8
    for pos in range(ps.p_pad):
        col = ups[:, pos]
        src = col[col >= 0]
        assert (col[src.size:] == -1).all() and (np.diff(src) > 0).all()
        assert (ps.down_pos[src] == pos).all() and (src // C < pos // C).all()
    assert ((ps.down_pos < ps.p_pad).sum()) == (ups >= 0).sum()
    tile_ptr, pos, slots = (getattr(tiles, k).numpy() for k in ("tile_ptr", "pos", "slots"))
    assert all(getattr(tiles, k).dtype == torch.int32
               for k in ("tile_ptr", "pos", "slots", "lvl_ptr", "lvl_off"))
    np.testing.assert_array_equal(np.sort(pos[pos >= 0]), np.arange(ps.p_pad))
    Kr = ups.shape[0]
    for t in range(tiles.n_tiles):
        b, n_pad = tile_ptr[t], tile_ptr[t + 1] - tile_ptr[t]
        sl = slots[Kr * b:Kr * (b + n_pad)].reshape(Kr, n_pad)
        for e in range(tiles.count[t]):
            s = sl[:, e][sl[:, e] >= 0]
            assert (s < e).all()
            np.testing.assert_array_equal(pos[b + s], ups[:s.size, pos[b + e]])
    rng = np.random.default_rng(2)
    shape = (ps.n_chunks, 3, C)
    const = torch.as_tensor(rng.uniform(0, 1, shape), dtype=torch.float32)
    adx = torch.as_tensor(rng.uniform(0.1, 10, shape), dtype=torch.float32)
    a = K.kinwave_sweep(const, adx, tiles, 0.6)
    b = K.kinwave_sweep(const, adx, tiles, 0.6)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert K.kinwave_sweep.launches == 0      # the CPU runs the plain version
