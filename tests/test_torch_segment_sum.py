"""K7, the fixed-order segment sum (lisflood_tpu_torch/ops/segment_sum.py),
on the CPU: the plain version against np.bincount in float64 (1e-12 of
each total's magnitude sum), its bits independent of how the segments are
labelled, and a plain NumPy emulation of the kernel's three passes
(csrc/segment_sum.cu: a warp per piece of more than SMALL members with its
shuffle tree, a thread per smaller piece with its tree over SMALL lanes,
one thread a segment for the totals, one a member for the spread), bit for
bit with the plain version in float32 and float64, on the segment arrays
of every call site of the step (Catchments, the sequential loop's
kinp$Catchments, WUseRegionC, downEva, downstruct), an empty segment, one
segment holding everything and P + 1 segments of at most 8 members. The
step with these sums is held to the JAX package by the step tests
(tests/test_torch_step.py, test_torch_options.py, ...)."""
import dataclasses

import numpy as np
import pytest
import torch

from lisflood_tpu_torch.models.step import build_step
from lisflood_tpu_torch.models.synthetic import build_synthetic_model, with_options
from lisflood_tpu_torch.ops import segment_sum as ss

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _values(n, dt, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.lognormal(0, 2, n) * rng.choice([-1.0, 1.0], n, p=[0.3, 0.7])
    return v.astype(DTYPES[dt][0])


def _emulate(values, order, spread):
    """The kernel's passes on the order's tables, in NumPy, lane for lane."""
    v = np.asarray(values)
    t = v.dtype.type
    perm = order.perm.numpy().astype(np.int64)
    start, length = order.piece_start.numpy(), order.piece_len.numpy()
    partial = np.zeros(order.n_pieces, v.dtype)
    lanes = ss.LANES
    # pass 1, a warp per large piece: lane l sums members l, l + 32, ... from
    # +0, then acc[l] += acc[l + h] (the lane's own value where l + h >= 32)
    for piece in order.large.numpy():
        acc = np.zeros(lanes, v.dtype)
        m = perm[start[piece]:start[piece] + length[piece]]
        for i in range(0, m.size, lanes):
            row = np.zeros(lanes, v.dtype)
            row[:min(lanes, m.size - i)] = v[m[i:i + lanes]]
            on = np.arange(lanes) < m.size - i
            acc = np.where(on, acc + row, acc)
        h = lanes // 2
        while h >= 1:
            src = np.where(np.arange(lanes) + h < lanes, np.roll(acc, -h), acc)
            acc = acc + src
            h //= 2
        partial[piece] = acc[0]
    # a thread per small piece: x[k] = +0 + member k, the tree over SMALL
    for piece in order.small.numpy():
        x = [t(0) + v[perm[start[piece] + k]] if k < length[piece] else t(0)
             for k in range(ss.SMALL)]
        h = ss.SMALL // 2
        while h >= 1:
            for k in range(h):
                x[k] = t(x[k] + x[k + h])
            h //= 2
        partial[piece] = x[0]
    # pass 2, a thread a segment; pass 3, a thread a member
    seg_piece = order.seg_piece.numpy()
    totals = np.zeros(order.count, v.dtype)
    for s in range(order.count):
        acc = t(0)
        for j in range(seg_piece[s], seg_piece[s + 1]):
            acc = t(acc + partial[j])
        totals[s] = acc
    return totals[order.segments.numpy()] if spread else totals


def _step_segments():
    """The segment arrays of every call site, from the all-options synthetic
    model (Catchments, WUseRegionC, downEva, downstruct) and its sharded
    step (kinp$Catchments): (name, segments, num_segments, count)."""
    cfg, params, state, aux = with_options(build_synthetic_model(24, 20, no_rout_steps=6,
                                                                 chunk_size=64))
    P = cfg.num_pixels
    step, p = build_step(dataclasses.replace(cfg, routing_kernel="sharded", num_shards=4),
                         params, aux, device="cpu")
    return [("Catchments", params["Catchments"], cfg.num_catchments, None),
            ("kinp$Catchments", p["kinp$Catchments"].numpy(), cfg.num_catchments + 1, None),
            ("WUseRegionC", params["WUseRegionC"], cfg.num_wregions, None),
            ("downEva", params["downEva"], P + 1, P),
            ("downstruct", params["downstruct"], P + 1, P)]


def _synthetic_segments():
    """An empty segment among others, one segment holding everything (more
    than one piece), and P + 1 segments of at most 8 members with the pits
    in segment P, as a D8 downstream array gives them."""
    rng = np.random.default_rng(7)
    P = 3000
    down = rng.permutation(np.repeat(np.arange(P // 5), 5))      # 5 members each
    down[rng.random(P) < 0.1] = P
    assert np.bincount(down, minlength=P + 1)[:P].max() <= 8
    with_empty = rng.integers(0, 7, 2500)
    with_empty[with_empty == 3] = 4
    return [("empty segment", with_empty, 7, None),
            ("one segment", np.zeros(2 * ss.PIECE + 77, np.int64), 1, None),
            ("D8 segments", down, P + 1, P)]


CASES = {name: case for name, *case in _step_segments() + _synthetic_segments()}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_bincount(name):
    """float64: the plain version's totals against np.bincount, within 1e-12
    of the sum of each segment's magnitudes; the spread is the totals at
    each member's segment."""
    seg, n, count = CASES[name]
    seg = np.asarray(seg, np.int64)
    order = ss.SegmentOrder.build(seg, n, count)
    v = _values(seg.size, "f64")
    got = ss.segment_total(torch.as_tensor(v), order).numpy()
    keep = seg < order.count
    ref = np.bincount(seg[keep], v[keep], minlength=n)[:order.count]
    scale = np.bincount(seg[keep], np.abs(v[keep]), minlength=n)[:order.count]
    assert got.shape == (order.count,)
    assert (np.abs(got - ref) <= 1e-12 * np.maximum(scale, 1e-300)).all()
    if count is None:
        spread = ss.segment_spread(torch.as_tensor(v), order).numpy()
        np.testing.assert_array_equal(spread, got[seg])
    else:
        np.testing.assert_array_equal(ss.scatter_to_downstream(torch.as_tensor(v), order).numpy(),
                                      got)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_emulation_bitwise(name, dt):
    """The emulated kernel passes against the plain version, bit for bit."""
    seg, n, count = CASES[name]
    order = ss.SegmentOrder.build(seg, n, count)
    v = _values(order.size, dt, seed=1)
    spread = count is None
    plain = (ss.segment_spread if spread else ss.segment_total)(torch.as_tensor(v), order)
    np.testing.assert_array_equal(_emulate(v, order, spread).view(np.uint8),
                                  plain.numpy().view(np.uint8))
    if name == "one segment":
        assert order.n_pieces == 3 and order.large.numel() == 3
    if name == "D8 segments":
        assert order.large.numel() == 0 and order.stats["largest"] <= 8


@pytest.mark.parametrize("dt", list(DTYPES))
def test_bits_do_not_depend_on_labels(dt):
    """The order is fixed by the members' indices: relabelling the segments
    (a permutation of their ids) permutes the totals and keeps their bits,
    and orders built twice are the same."""
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 40, 5000)
    seg[:1500] = 5                                   # a segment of two pieces
    v = torch.as_tensor(_values(seg.size, dt, seed=2))
    relabel = rng.permutation(40)
    a = ss.segment_total(v, ss.SegmentOrder.build(seg, 40))
    b = ss.segment_total(v, ss.SegmentOrder.build(relabel[seg], 40))
    assert torch.equal(b[relabel], a)
    again = ss.SegmentOrder.build(seg, 40)
    assert torch.equal(ss.segment_total(v, again), a)


def test_checks():
    """Segment ids outside the range, a spread of a partial order, values of
    the wrong shape and an order on another device raise."""
    with pytest.raises(ValueError):
        ss.SegmentOrder.build([0, 3], 3)
    down = ss.SegmentOrder.build([1, 2, 2], 3, count=2)
    v = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        ss.segment_spread(v, down)
    with pytest.raises(ValueError):
        ss.segment_total(v[:2], down)
    with pytest.raises(TypeError):
        ss.segment_total(v.int(), down)
    with pytest.raises(ValueError):
        ss.segment_total(v.to("meta"), down)
    assert ss.scatter_to_downstream(v, down).tolist() == [0.0, 1.0]
