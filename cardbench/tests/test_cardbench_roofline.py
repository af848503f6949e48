"""The roofline's counts against hand counts on small graphs, and the step's
operation counter on a hand-counted function."""
import pytest
import torch

from cardbench import roofline as rl


def test_substep_loop_hand_count():
    # a chain of 3 pixels (2 edges), 24 sub-steps, 2 lanes: a lane's solve
    # at its least, its constant and its round trip: (3 + 3 + 5) plain and
    # (1 + 1 + 2) pows of 8; 28 shared a pixel; 2 lanes x 2 edges additions
    # a sub-step
    per_lane = 11 + 4 * 8
    flops, nbytes = rl.substep_loop(3, 2, 24)
    assert flops == 24 * (3 * (2 * per_lane + 28) + 2 * 2)
    assert nbytes == 3 * (23 * 4 + 4)


def test_sweep_hand_count():
    # 5 pixels, 4 edges, 3 lanes: 1 + 3 + 1 x 8 a pixel and lane, an
    # addition an edge and lane; 3 values of 4 bytes a pixel and lane and a
    # 4-byte index a pixel
    flops, nbytes = rl.sweep(5, 4, 3)
    assert flops == 5 * 3 * (1 + 3 + 8) + 4 * 3
    assert nbytes == 5 * (3 * 12 + 4)


def test_day_bounds_take_the_larger_bound():
    graphs = {"pixels": 1_000_000, "channel_edges": 999_999, "overland_edges": 0}
    packed = rl.day_bounds(graphs, 24, "packed")
    assert set(packed) == {"kinwave_substep"}
    f, b = rl.substep_loop(1_000_000, 999_999, 24)
    assert packed["kinwave_substep"] == (max(f / rl.PEAK_FLOPS, b / rl.PEAK_BYTES) * 1e3,
                                         "operations" if f / rl.PEAK_FLOPS > b / rl.PEAK_BYTES
                                         else "bytes")
    scan = rl.day_bounds({**graphs, "overland_edges": 10}, 24, "scan")
    cf, cb = rl.sweep(1_000_000, 999_999, 2)
    of, ob = rl.sweep(1_000_000, 10, 3)
    assert scan["kinwave_sharded"][0] == pytest.approx(
        max((24 * cf + of) / rl.PEAK_FLOPS, (24 * cb + ob) / rl.PEAK_BYTES) * 1e3)


def test_step_flops_counts_elementwise_work():
    x, y = torch.rand(10, dtype=torch.float64), torch.rand(10, dtype=torch.float64)

    def fn():
        z = x * y + 1.0                      # 10 + 10
        w = torch.where(z > 1.5, z, y)       # 10 + 10
        return torch.sqrt(w) ** 0.5          # 10 x 4 + 10 x 8

    out, n = rl.step_flops(torch, fn)
    assert n == 10 + 10 + 10 + 10 + 40 + 80
    assert torch.equal(out, torch.sqrt(torch.where(x * y + 1.0 > 1.5, x * y + 1.0, y)) ** 0.5)


def test_step_flops_counts_a_solve_at_its_least():
    from types import SimpleNamespace

    x = torch.rand(6, dtype=torch.float64)

    def newton(c):
        q = c.clone()
        for _ in range(5):                    # uncounted: the solve's own iterations
            q = q - (q + q ** 0.6 - c) / (1.0 + 0.6 * q ** -0.4)
        return q

    module = SimpleNamespace(solve=newton)
    out, n = rl.step_flops(torch, lambda: module.solve(x + 1.0) * 2.0, solvers=[(module, "solve")])
    # the addition and the multiplication a result element, the solve at
    # SOLVE (3 plain and a pow of 8)
    assert n == 6 + 6 + 6 * (3 + 8)
    assert module.solve is newton
    assert torch.equal(out, newton(x + 1.0) * 2.0)
