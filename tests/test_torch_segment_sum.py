"""K7, the fixed-order segment sum (lisflood_tpu_torch/ops/segment_sum.py),
on the CPU: the plain version against np.bincount in float64 (1e-12 of
each total's magnitude sum), its bits independent of how the segments are
labelled, and a plain NumPy emulation of the kernel's passes
(csrc/segment_sum.cu: a warp per warp item, a piece of more than SMALL
members or of a segment of several pieces, with its shuffle tree; a thread
per segment of at most SMALL members with its tree over SMALL lanes, which
writes the total or the spread itself; a segment of several pieces added in
piece order by the warp that takes its last ticket, in whatever order the
pieces finish; the spread of those segments a block a piece), bit for bit
with the plain version in float32 and float64, on the segment arrays of
every call site of the step (Catchments, the sequential loop's
kinp$Catchments, WUseRegionC, downEva, downstruct), an empty segment, one
segment holding everything, segments of one and of several pieces side by
side and P + 1 segments of at most 8 members. The step with these sums is
held to the JAX package by the step tests (tests/test_torch_step.py,
test_torch_options.py, ...)."""
import dataclasses
import re
from pathlib import Path

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


def _warp_sum(v, m):
    """A warp's sum of the members `m`: lane l sums members l, l + 32, ...
    from +0, then acc[l] += acc[l + h] (the lane's own value where l + h >=
    32, as __shfl_down_sync gives it); lane 0's value."""
    lanes = ss.LANES
    acc = np.zeros(lanes, v.dtype)
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
    return acc[0]


def _emulate(values, order, spread, tickets=None, seed=0):
    """The kernel's passes on the order's tables, in NumPy, lane for lane:
    pass 1's warp items in an order drawn from `seed` (the order in which
    the pieces finish), each multi-piece segment's total added by the item
    that takes its last ticket; pass 1's threads, one a segment of at most
    SMALL members; pass 2, a block a piece of a multi-piece segment.
    `tickets` (the order's, as NumPy) carry over between calls and are
    checked back at 0. Returns the totals or the spread."""
    v = np.asarray(values)
    t = v.dtype.type
    perm = order.perm.numpy().astype(np.int64)
    items, multi = order.items.numpy(), order.multi.numpy()
    tickets = np.zeros(len(multi), np.int64) if tickets is None else tickets
    partial = np.full(order.n_multi_items, np.nan, v.dtype)
    multi_totals = np.full(len(multi), np.nan, v.dtype)
    totals = np.full(order.count, np.nan, v.dtype)
    out = np.full(order.size, np.nan, v.dtype)
    # pass 1, the warps
    for w in np.random.default_rng(seed).permutation(len(items)):
        start, n, target, ms = items[w]
        m = perm[start:start + n]
        acc = _warp_sum(v, m)
        if ms < 0:
            total = t(t(0) + acc)
            if spread:
                out[m] = total
            else:
                totals[target] = total
            continue
        partial[target] = acc
        first, pieces, seg = multi[ms]
        tickets[ms] += 1
        if tickets[ms] != pieces:
            continue
        total = t(0)
        for j in range(pieces):
            total = t(total + partial[first + j])
        tickets[ms] = 0
        if spread:
            multi_totals[ms] = total
        else:
            totals[seg] = total
    # pass 1, the threads: x[k] = +0 + member k, the tree over SMALL
    seg_ptr = order.seg_ptr.numpy()
    for s in range(order.count):
        start, n = seg_ptr[s], seg_ptr[s + 1] - seg_ptr[s]
        if n > ss.SMALL:
            continue
        x = [t(t(0) + v[perm[start + k]]) if k < n else t(0) for k in range(ss.SMALL)]
        h = ss.SMALL // 2
        while h >= 1:
            for k in range(h):
                x[k] = t(x[k] + x[k + h])
            h //= 2
        total = t(t(0) + x[0])
        if spread:
            out[perm[start:start + n]] = total
        else:
            totals[s] = total
    assert not tickets.any()
    # pass 2, a block a piece of a multi-piece segment
    if spread:
        for start, n, _, ms in items[:order.n_multi_items]:
            out[perm[start:start + n]] = multi_totals[ms]
    return out if spread else totals


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
    than one piece), segments of one and of several pieces side by side
    (two of several pieces, one of exactly PIECE members, others of 9-40
    and of 1-8 members, and empty ones), and P + 1 segments of at most 8
    members with the pits in segment P, as a D8 downstream array gives
    them."""
    rng = np.random.default_rng(7)
    P = 3000
    down = rng.permutation(np.repeat(np.arange(P // 5), 5))      # 5 members each
    down[rng.random(P) < 0.1] = P
    assert np.bincount(down, minlength=P + 1)[:P].max() <= 8
    with_empty = rng.integers(0, 7, 2500)
    with_empty[with_empty == 3] = 4
    sizes = np.r_[3 * ss.PIECE + 5, 0, ss.PIECE, rng.integers(9, 41, 30), 2 * ss.PIECE + 1,
                  rng.integers(1, 9, 60), 0, 0]
    mixed = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    return [("empty segment", with_empty, 7, None),
            ("one segment", np.zeros(2 * ss.PIECE + 77, np.int64), 1, None),
            ("mixed pieces", mixed, sizes.size, None),
            ("mixed pieces, totals", mixed, sizes.size, sizes.size - 3),
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
    """The emulated kernel passes against the plain version, bit for bit,
    with the pieces finishing in two orders, and twice in a row on the same
    tickets, which each call leaves at 0."""
    seg, n, count = CASES[name]
    order = ss.SegmentOrder.build(seg, n, count)
    v = _values(order.size, dt, seed=1)
    spread = count is None
    plain = (ss.segment_spread if spread else ss.segment_total)(torch.as_tensor(v), order)
    tickets = order.tickets.numpy()[:order.multi.shape[0]].astype(np.int64)
    for seed in (0, 1):
        np.testing.assert_array_equal(_emulate(v, order, spread, tickets, seed).view(np.uint8),
                                      plain.numpy().view(np.uint8))
    multi = order.multi.numpy()
    if name == "one segment":
        assert order.n_pieces == 3 and order.n_multi_items == 3 and multi.tolist() == [[0, 3, 0]]
    if name == "D8 segments":
        assert order.items.shape[0] == 0 and order.stats["largest"] <= 8
    if name.startswith("mixed pieces"):
        # two segments of several pieces (4 and 3 pieces), 30 one-piece
        # warp items and the segment of exactly PIECE members
        assert multi[:, 1].tolist() == [4, 3] and order.n_multi_items == 7
        assert order.items.shape[0] == 7 + 31 and (order.items[7:, 3] == -1).all()


def test_tables():
    """The kernel's tables of a mixed segment array: seg_ptr bounds each
    segment's members in perm; the warp items cover, piece for piece, the
    multi-piece segments (slots in order) and the pieces of more than SMALL
    members of the others; the thread path (segments of at most SMALL
    members) and the items cover every summed member once; the scratch is
    zeroed and sized for float64."""
    seg, n, count = CASES["mixed pieces, totals"]
    order = ss.SegmentOrder.build(seg, n, count)
    seg_ptr, perm = order.seg_ptr.numpy(), order.perm.numpy()
    seg = np.asarray(seg)
    for s in range(order.count):
        np.testing.assert_array_equal(perm[seg_ptr[s]:seg_ptr[s + 1]], np.flatnonzero(seg == s))
    items, multi = order.items.numpy(), order.multi.numpy()
    covered = [perm[a:a + b] for a, b, _, _ in items]
    sizes = np.diff(seg_ptr)
    covered += [perm[seg_ptr[s]:seg_ptr[s + 1]] for s in np.flatnonzero(sizes <= ss.SMALL)]
    members = np.concatenate(covered)
    np.testing.assert_array_equal(np.sort(members), np.flatnonzero(seg < order.count))
    for k, (first, pieces, s) in enumerate(multi):
        rows = items[:order.n_multi_items][items[:order.n_multi_items, 3] == k]
        assert rows[:, 2].tolist() == list(range(first, first + pieces))
        assert rows[0, 0] == seg_ptr[s] and rows[:, 1].sum() == sizes[s]
    assert (items[order.n_multi_items:, 1] > ss.SMALL).all()
    assert not order.tickets.any() and order.partial.dtype == torch.float64
    assert order.partial.numel() >= order.n_multi_items


def test_args_mirror_the_kernel():
    """The ctypes mirror of SegmentArgs names its fields in the order of the
    struct in csrc/segment_sum.cu, and SMALL and LANES are the kernel's
    kSmall and kLanes."""
    src = (Path(ss.__file__).resolve().parent.parent / "csrc" / "segment_sum.cu").read_text()
    body = re.search(r"struct SegmentArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"[*\s](\w+)\s*[,;]", body)
    assert names == [f for f, _ in ss._SegmentArgs._fields_]
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert (consts["kSmall"], consts["kLanes"]) == (str(ss.SMALL), str(ss.LANES))


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


def test_one_stream_per_order():
    """An order's scratch serves one stream: the first call's stream is the
    order's, a call on another raises, and another order takes its own."""
    a, b = ss.SegmentOrder.build([0, 1, 1], 2), ss.SegmentOrder.build([0, 1, 1], 2)
    ss._claim_stream(a, 0x10)
    ss._claim_stream(a, 0x10)
    with pytest.raises(RuntimeError):
        ss._claim_stream(a, 0x20)
    ss._claim_stream(b, 0x20)
    assert a.stream == {"handle": 0x10} and b.stream == {"handle": 0x20}
