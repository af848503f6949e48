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
