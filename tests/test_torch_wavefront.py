"""The host side of the sub-step kernel's multi-block wavefront
(lisflood_tpu_torch/ops/kinwave_substep.py, csrc/kinwave_substep.cu): the
per-chunk dependency tables, the protocol between the blocks, and the
task-granular order of the arithmetic.

The CUDA kernel itself runs only on a card (chip_smoke.py). What runs here:
  (a) wavefront_tables on synthetic models and on random drainage networks:
      every chunk a lane gathers from, over the routing and the evaporation
      graph, is in the chunk's dependency list and lies in c-W..c-1; every
      feeder chunk of a structure is in its owner's list and is earlier;
  (b) a simulator of the protocol (G workers, tickets for chunks in
      increasing order, progress flags after every evaporation hop and every
      sub-step, a ring of R slots with its reuse guard) under a random
      interleaving: it terminates, and no ring slot is overwritten while a
      task still has to read it; without the guard the overwrite is detected;
  (c) the plain arithmetic run task by task under that simulator, with the
      ring, the per-structure feeder table and the structure steps inside
      the tasks as the kernel has them: bitwise equal to substep_reference.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lisflood_tpu_torch.device import to_device
from lisflood_tpu_torch.graph.ldd import FlowGraph, build_schedule
from lisflood_tpu_torch.models.step import build_step, upstream_table
from lisflood_tpu_torch.models.synthetic import (build_synthetic_model, synthetic_forcing,
                                                 with_options)
from lisflood_tpu_torch.ops import kinwave_substep as ks
from lisflood_tpu_torch.ops.kinwave_packed import pack_schedule
from lisflood_tpu_torch.ops.routing_ops import kernel_operands

FEEDERS = ks.FEEDERS


# ---------------------------------------------------------------------------
# operands


def model_operands(nrows, ncols, dtype, options, T, chunk):
    """(spec, operands) the routing kernel gets in the first step of a
    synthetic model on the CPU, wavefront tables included."""
    model = build_synthetic_model(nrows, ncols, no_rout_steps=T, chunk_size=chunk)
    cfg, params, state, aux = with_options(model) if options else model
    step, p = build_step(cfg, params, aux, dtype=dtype, device="cpu")
    s = step.prepare_state(state)
    f = to_device({**synthetic_forcing(cfg.num_pixels, seed=0),
                   **aux.get("forcing_options", {})}, "cpu", dtype)
    return kernel_operands(cfg, p, s, step.land_phase(s, f), step.routers)


_OPERANDS = {}


def cached_operands(*key):
    if key not in _OPERANDS:
        _OPERANDS[key] = model_operands(*key)
    return _OPERANDS[key]


def lists(ptr, values):
    """Per-chunk lists of a (offsets, values) table."""
    ptr = np.asarray(ptr)
    return [list(np.asarray(values)[ptr[c]:ptr[c + 1]]) for c in range(len(ptr) - 1)]


# ---------------------------------------------------------------------------
# (a) the tables


def check_tables(tables, n, C, W, ups, ev_ups, pos, fee):
    """The properties the kernel relies on. `pos` (N,) and `fee` (N, 8) are
    the structures' and their feeders' positions, lakes first."""
    deps = tables["wf_deps"]
    assert deps.shape[0] == n and deps.shape[1] >= 1 and deps.dtype == np.int32
    for c in range(n):
        row = deps[c][deps[c] >= 0]
        assert list(row) == sorted(set(row)), "ascending, no repeats"
        assert all(c - W <= d <= c - 1 for d in row), (c, row)
        assert (deps[c][len(row):] == -1).all(), "padding after the entries"
    for table in (ups, ev_ups):
        if table is None:
            continue
        tgt = np.broadcast_to(np.arange(table.shape[1]) // C, table.shape)
        for c, d in set(zip(tgt[table >= 0], table[table >= 0] // C)):
            assert d in deps[c], f"chunk {c} gathers from chunk {d}"
    own = lists(tables["wf_own_ptr"], tables["wf_own_list"])
    feed = lists(tables["wf_feed_ptr"], tables["wf_feed_ent"])
    sdep = lists(tables["wf_sdep_ptr"], tables["wf_sdep_list"])
    assert sorted(sg for c in range(n) for sg in own[c]) == list(range(len(pos)))
    want_feed = set()
    for sg, p in enumerate(pos):
        assert sg in own[p // C]
        valid = [f for f in range(FEEDERS) if fee[sg, f] >= 0]
        for f in valid:
            fc = fee[sg, f] // C
            assert fc in sdep[p // C] and fc < p // C
            want_feed.add((fc, (sg * FEEDERS + f) * ks.MAX_CHUNK + fee[sg, f] % C))
        order = [f for f in tables["wf_fee_ord"][sg] if f >= 0]
        assert sorted(order) == valid
        keys = [(fee[sg, f] // C, f) for f in order]
        assert keys == sorted(keys), "summing order: by feeder chunk, then by feeder"
    assert {(c, e) for c in range(n) for e in feed[c]} == want_feed
    for c in range(n):
        assert all(d < c for d in sdep[c]) and sdep[c] == sorted(set(sdep[c]))
        assert set(sdep[c]) == {fee[sg, f] // C for sg in own[c] for f in range(FEEDERS)
                                if fee[sg, f] >= 0}


def structure_positions(xs):
    pos = np.concatenate([xs[k].numpy() for k in ("lk_pos", "rs_pos") if k in xs]
                         or [np.zeros(0, np.int64)])
    fee = np.concatenate([xs[k].numpy() for k in ("lk_fee", "rs_fee") if k in xs]
                         or [np.zeros((0, FEEDERS), np.int64)])
    return pos, fee


@pytest.mark.parametrize("grid", [(16, 16, 32), (240, 200, 512)], ids=["16x16", "240x200"])
def test_tables_of_synthetic_models(grid):
    """The tables that packed_routing_params hands the kernel, on the 16x16
    and the 240x200 synthetic model (lakes, reservoirs, evaporation chain)."""
    spec, xs = cached_operands(*grid[:2], torch.float32, False, 4, grid[2])
    tables = {k: xs[k].numpy() for k in ks.WAVEFRONT_TABLES}
    pos, fee = structure_positions(xs)
    assert len(pos) == 4 and spec.E > 0
    check_tables(tables, spec.n_chunks, spec.chunk, spec.window, xs["ups"].numpy(),
                 xs["ev_ups"].numpy(), pos, fee)
    again = ks.wavefront_operands(spec, xs)
    assert all(torch.equal(again[k], xs[k]) for k in ks.WAVEFRONT_TABLES)


def random_network(data):
    """A random drainage forest with structures, scheduled and packed:
    (n_chunks, C, W, ups, pos, fee)."""
    P = data.draw(st.integers(2, 60), label="pixels")
    C = data.draw(st.sampled_from([2, 3, 5, 8]), label="chunk")
    seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
    rng = np.random.default_rng(seed)
    down = np.full(P, -1, np.int32)
    indegree = np.zeros(P, np.int64)
    for i in range(P - 1):
        if rng.random() < 0.85:
            j = int(rng.integers(i + 1, P))
            if indegree[j] < 8:
                down[i] = j
                indegree[j] += 1
    graph = FlowGraph(downstream=down, ldd=np.full(P, 5, np.int8), num_pixels=P)
    # structures on pixels with feeders; the routing graph is cut above them
    candidates = np.flatnonzero(indegree > 0)
    n_struct = min(len(candidates), data.draw(st.integers(0, 4), label="structures"))
    cells = rng.choice(candidates, n_struct, replace=False) if n_struct else np.zeros(0, np.int64)
    cut = down.copy()
    cut[np.isin(down, cells)] = -1
    graph_kin = FlowGraph(downstream=cut, ldd=graph.ldd, num_pixels=P)
    ps = pack_schedule(build_schedule(graph_kin, C, order_graph=graph))
    has_down = ps.down_pos < ps.p_pad
    ups = upstream_table(np.flatnonzero(has_down), ps.down_pos[has_down], ps.p_pad)
    pos = ps.inv_perm[cells]
    fee = np.full((n_struct, FEEDERS), -1, np.int64)
    for i, cell in enumerate(cells):
        feeders = ps.inv_perm[np.flatnonzero(down == cell)]
        fee[i, :len(feeders)] = feeders
    return ps.n_chunks, C, ps.window, ups, pos, fee


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_tables_of_random_networks(data):
    """Random drainage forests of up to 60 pixels in chunks of 2 to 8, with
    up to 4 structures whose feeders are cut from the routing graph."""
    n, C, W, ups, pos, fee = random_network(data)
    half = len(pos) // 2
    tables = ks.wavefront_tables(n, C, W, ups, None, pos[:half], fee[:half], pos[half:], fee[half:])
    check_tables(tables, n, C, W, ups, None, pos, fee)
    proto = Protocol.of(tables, n, W, T=3, E=0, blocks=data.draw(st.integers(1, 6)))
    simulate(proto, np.random.default_rng(0))


def test_tables_refuse_a_broken_schedule():
    """A source outside the window and a feeder that is not earlier raise."""
    ups = np.full((1, 8), -1, np.int32)
    ups[0, 6] = 0                                  # chunk 3 gathers from chunk 0
    with pytest.raises(ValueError):
        ks.wavefront_tables(4, 2, 2, ups)
    ks.wavefront_tables(4, 2, 3, ups)
    fee = np.full((1, FEEDERS), -1)
    fee[0, 0] = 5                                  # feeder in the structure's own chunk
    with pytest.raises(ValueError):
        ks.wavefront_tables(4, 2, 3, ups, None, np.array([4]), fee)


# ---------------------------------------------------------------------------
# (b) the protocol


class Overwritten(Exception):
    """A task read a ring slot that no longer holds the chunk it needs."""


@dataclasses.dataclass
class Protocol:
    n: int                  # chunks
    W: int
    T: int
    E: int                  # > 0: the chunks publish their evaporation hops first
    deps: list              # per chunk, the chunks gathered from
    sdeps: list             # per chunk, the feeder chunks of its structures
    blocks: int             # G
    ring: int               # R
    guard: bool = True      # the reuse guard of the ring

    @classmethod
    def of(cls, tables, n, W, T, E, blocks, ring=None, guard=True):
        deps = [[int(d) for d in row if d >= 0] for row in np.asarray(tables["wf_deps"])]
        sdeps = [[int(d) for d in row]
                 for row in lists(tables["wf_sdep_ptr"], tables["wf_sdep_list"])]
        if ring is None:
            ring = ks.ring_slots(blocks, ks.SubstepSpec(n, 1, W, T, 1.0, 0.6, False, E))
        return cls(n, W, T, E, deps, sdeps, blocks, ring, guard)


def simulate(proto, rng, on_hop=None, on_task=None):
    """Runs the kernel's protocol with `proto.blocks` workers that a seeded
    generator interleaves. A worker claims the next ticket, a chunk; waits
    for the chunk's ring slot (chunks c-R..c-R+W finished); then runs the
    chunk's E evaporation hops and its T sub-steps as tasks, each after its
    dependencies' flags, publishing the chunk's progress after each: h+1 after
    hop h (h = 0..E-2), B+1+t after sub-step t with B = max(E-1, 0).
    `on_hop(c, h)` and `on_task(c, t)` do the work. Raises Overwritten when a
    task reads a slot that another chunk has taken, and AssertionError on a
    deadlock. Returns the largest number of chunks in flight together."""
    n, T, E, R, W = proto.n, proto.T, proto.E, proto.ring, proto.W
    B = max(E - 1, 0)
    fin = B + T
    progress = [0] * n
    reached = lambda d, need: progress[d] >= need
    owner = [None] * R                      # the chunk whose data a slot holds
    ticket = 0
    # None: idle, else [chunk, next task]: -E..-1 the hops, 0..T-1 the
    # sub-steps
    workers = [None] * proto.blocks
    done = [False] * proto.blocks
    in_flight = 0
    idle_rounds = 0

    def read_slots(c, sources):
        for d in sources + [c]:
            if owner[d % R] != d:
                raise Overwritten(f"chunk {c} needs chunk {d}, its slot holds {owner[d % R]}")

    while not all(done):
        w = int(rng.integers(proto.blocks))
        if done[w]:
            continue
        moved = True
        if workers[w] is None:
            if ticket >= n:
                done[w] = True
            else:
                workers[w] = [ticket, -E]
                ticket += 1
        else:
            c, t = workers[w]
            free = True
            if t == -E and owner[c % R] != c:
                # the chunk's first task takes its ring slot, once it is free
                free = not proto.guard or all(
                    reached(j, fin) for j in range(max(c - R, 0), c - R + W + 1))
                if free:
                    owner[c % R] = c
            if not free:
                moved = False
            elif t < 0:
                h = t + E
                if all(reached(d, h) for d in proto.deps[c]):
                    read_slots(c, proto.deps[c] if h else [])
                    if on_hop:
                        on_hop(c, h)
                    if h < E - 1:
                        progress[c] = h + 1
                    workers[w][1] = t + 1
                else:
                    moved = False
            else:
                ready = (all(reached(d, B + 1 + t) for d in proto.deps[c])
                         and (t == 0 or all(reached(d, B + t) for d in proto.sdeps[c])))
                if ready:
                    read_slots(c, proto.deps[c])
                    if on_task:
                        on_task(c, t)
                    progress[c] = B + 1 + t
                    workers[w] = [c, t + 1] if t + 1 < T else None
                else:
                    moved = False
        in_flight = max(in_flight, sum(x is not None for x in workers))
        idle_rounds = 0 if moved else idle_rounds + 1
        assert idle_rounds < 200 * proto.blocks, "no worker can move: deadlock"
    assert progress == [fin] * n
    return in_flight


@pytest.mark.parametrize("blocks", [1, 2, 7, 40])
@pytest.mark.parametrize("grid", [(16, 16, 32), (240, 200, 512)], ids=["16x16", "240x200"])
def test_protocol_terminates_and_keeps_live_slots(grid, blocks):
    """With the launcher's ring depth and with the smallest one (W + 1 slots:
    the guard alone keeps it safe), every interleaving tried runs to the end
    without a task reading an overwritten slot."""
    spec, xs = cached_operands(*grid[:2], torch.float32, False, 4, grid[2])
    tables = {k: xs[k].numpy() for k in ks.WAVEFRONT_TABLES}
    for ring in (None, spec.window + 1):
        for seed in range(3):
            proto = Protocol.of(tables, spec.n_chunks, spec.window, spec.T, spec.E, blocks, ring)
            assert proto.ring >= spec.window + 1
            in_flight = simulate(proto, np.random.default_rng(seed))
            assert (blocks > 1) <= (in_flight > 1)
            assert in_flight <= min(blocks, spec.n_chunks)


def test_protocol_without_guard_is_caught():
    """The check can fail: W + 1 slots, several blocks and no reuse guard
    lets a block that runs ahead overwrite a slot that is still to be read."""
    spec, xs = cached_operands(16, 16, torch.float32, False, 4, 32)
    tables = {k: xs[k].numpy() for k in ks.WAVEFRONT_TABLES}
    caught = 0
    for seed in range(10):
        proto = Protocol.of(tables, spec.n_chunks, spec.window, spec.T, spec.E, blocks=7,
                            ring=spec.window + 1, guard=False)
        try:
            simulate(proto, np.random.default_rng(seed))
        except Overwritten:
            caught += 1
    assert caught > 0
    # one block alone needs no guard
    proto = Protocol.of(tables, spec.n_chunks, spec.window, spec.T, spec.E, blocks=1,
                        ring=spec.window + 1, guard=False)
    simulate(proto, np.random.default_rng(0))


def test_ring_slots():
    spec = ks.SubstepSpec(n_chunks=2648, chunk=512, window=3, T=24, dt_routing=3600.0,
                          beta=0.6, split=True, E=5)
    assert ks.ring_slots(1, spec) == 5 and ks.ring_slots(33, spec) == 69
    assert ks.ring_slots(132, dataclasses.replace(spec, n_chunks=40)) == 40
    assert ks.ring_slots(8, dataclasses.replace(spec, n_chunks=2)) == 4


# ---------------------------------------------------------------------------
# (c) the arithmetic, task by task


class TaskRun:
    """The plain arithmetic of the sub-step loop cut into the kernel's tasks:
    a ring of R slots, the feeder table (structure, feeder, t), and each
    structure's step t run inside task (c, t) from its feeders' sub-step t-1."""

    def __init__(self, spec, xs, ring):
        self.spec, self.xs, self.R = spec, xs, ring
        C, T, E = spec.chunk, spec.T, spec.E
        L = 2 if spec.split else 1
        dx = xs["dx"]
        self.ys = ks._init_outputs(spec, xs)
        # NaN where nothing was written: a read of a stale slot shows
        self.ring = dx.new_full((ring, T, L, C), float("nan"))
        self.ev_ring = dx.new_full((ring, max(E - 1, 1), C), float("nan"))
        self.NL = xs["lk_pos"].numel() if "lk_pos" in xs else 0
        n_struct = self.NL + (xs["rs_pos"].numel() if "rs_pos" in xs else 0)
        self.stage = dx.new_full((max(n_struct, 1) * FEEDERS, T), float("nan"))
        self.ups = xs["ups"].long()
        self.ev_ups = xs["ev_ups"].long() if E else None
        self.own = lists(xs["wf_own_ptr"], xs["wf_own_list"])
        self.feed = lists(xs["wf_feed_ptr"], xs["wf_feed_ent"])
        self.fee_ord = xs["wf_fee_ord"].tolist()
        self.rows = ks._row_names(spec, xs)
        self.rows_of, self.eva, self.lane_state = {}, {}, {}

    def hop(self, c, h):
        """Evaporation hop h of chunk c, from hop h-1 of its upstream lanes."""
        spec, xs, C = self.spec, self.xs, self.spec.chunk
        if c not in self.rows_of:
            self.rows_of[c] = {k: xs[k][c] for k in self.rows}
            self.eva[c] = ks._eva_state(self.rows_of[c])
        x, ev = self.rows_of[c], self.eva[c]
        up = x["ev_up0"] if h == 0 else ks._upstream_sum(
            self.ev_ring[:, h - 1], self.ev_ups[:, c * C:(c + 1) * C], C, self.R)
        hop = ks._eva_hop(ev, up)
        if h < spec.E - 1:
            self.ev_ring[c % self.R, h] = hop

    def structure_inflow(self, sg, prefix, s, t):
        xs, C = self.xs, self.spec.chunk
        if t == 0:
            return xs[prefix + "_buf0"][s]
        fee, w = xs[prefix + "_fee"][s].tolist(), xs[prefix + "_fee_w"][s]
        inflow = acc = torch.zeros((), dtype=w.dtype)
        prev = None
        for f in self.fee_ord[sg]:
            if f < 0:
                break
            if prev is not None and fee[f] // C != prev:
                inflow, acc = inflow + acc, torch.zeros((), dtype=w.dtype)
            prev = fee[f] // C
            acc = acc + self.stage[sg * FEEDERS + f, t - 1] * w[f]
        return inflow + acc if prev is not None else inflow

    def task(self, c, t):
        spec, xs, C = self.spec, self.xs, self.spec.chunk
        if t == 0:
            x = self.rows_of.setdefault(c, {k: xs[k][c] for k in self.rows})
            eva_dt = None
            if spec.E:
                self.ys["ev_add"][c] = self.eva[c]["eva_add"]
                eva_dt = self.eva.pop(c)["eva_add"] * (1.0 / spec.T)
            self.lane_state[c] = ks._lane_state(spec, x, eva_dt)
        x, state = self.rows_of[c], self.lane_state[c]
        struct_out = None
        if self.own[c]:
            struct_out = torch.zeros_like(x["dx"])
            for sg in self.own[c]:
                prefix, s = ("lk", sg) if sg < self.NL else ("rs", sg - self.NL)
                inflow = self.structure_inflow(sg, prefix, s, t)
                q_out = ks._STRUCTURE_STEP[prefix](xs, self.ys, torch.tensor([s]),
                                                   inflow.reshape(1), float(spec.dt_routing))
                struct_out[int(xs[prefix + "_pos"][s]) % C] = q_out[0]
        ups_t = ks._upstream_sum(self.ring[:, t], self.ups[:, c * C:(c + 1) * C], C, self.R)
        self.ring[c % self.R, t] = ks._substep(spec, x, state, t, ups_t, struct_out)
        for ent in self.feed[c]:
            self.stage[ent // ks.MAX_CHUNK, t] = state["chanq"][ent % ks.MAX_CHUNK]
        if t == spec.T - 1:
            ks._store_lanes(spec, x, state, self.ys, c)
            del self.lane_state[c], self.rows_of[c]


def same_bits(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
            and torch.equal(torch.signbit(a), torch.signbit(b)))


@pytest.mark.parametrize("options", [False, True], ids=["main", "sideflow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 32, 6), (240, 200, 512, 3)], ids=["16x16", "240x200"])
def test_tasks_in_shuffled_order_bitwise_equal(grid, dtype, options):
    """The tasks (c, t) run in a shuffled valid order by 7 workers over a ring
    of the launcher's depth, and by 3 over the smallest ring: every output has
    the bits of substep_reference, with lakes and reservoirs, in float32
    (polynomial solve) and float64 (q-space solve), with and without the
    optional sideflow terms."""
    nrows, ncols, chunk, T = grid
    spec, xs = cached_operands(nrows, ncols, dtype, options, T, chunk)
    assert ("wuse" in xs and "uptrans" in xs and "qin_old" in xs) == options
    assert "lk_pos" in xs and "rs_pos" in xs and spec.E > 0 and spec.split
    ref = ks.substep_reference(spec, xs)
    tables = {k: xs[k].numpy() for k in ks.WAVEFRONT_TABLES}
    for blocks, ring, seed in ((7, None, 0), (3, spec.window + 1, 1)):
        proto = Protocol.of(tables, spec.n_chunks, spec.window, spec.T, spec.E, blocks, ring)
        run = TaskRun(spec, xs, proto.ring)
        simulate(proto, np.random.default_rng(seed), run.hop, run.task)
        assert set(run.ys) == set(ref)
        for k, r in ref.items():
            assert same_bits(run.ys[k], r), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_feeder_sum_keeps_the_plain_order(dtype):
    """Every structure of the 16x16 model gets five weighted feeders spread
    over three earlier chunks, in shuffled feeder slots: the owner's sum over
    the feeder table has the bits of the plain version's chunk-by-chunk
    staging only in that version's order (per chunk ascending an accumulator
    over its feeders by slot, then buffer + accumulator)."""
    spec, xs = cached_operands(16, 16, dtype, False, 6, 32)
    xs = dict(xs)
    rng = np.random.default_rng(5)
    C = spec.chunk
    filled = (xs["ischan"] != 0).numpy()
    for prefix in ("lk", "rs"):
        fee = np.full(tuple(xs[prefix + "_fee"].shape), -1, np.int64)
        for s, pos in enumerate(xs[prefix + "_pos"].tolist()):
            assert pos // C >= 3
            lanes = [(c, int(rng.choice(np.flatnonzero(filled[c]))))
                     for c in pos // C - 1 - rng.integers(0, 3, 5)]
            assert len({c for c, _ in lanes}) >= 2
            fee[s, rng.permutation(FEEDERS)[:5]] = [c * C + lane for c, lane in lanes]
        xs[prefix + "_fee"] = torch.as_tensor(fee, dtype=torch.int32)
        xs[prefix + "_fee_w"] = torch.as_tensor(
            np.where(fee >= 0, rng.uniform(0.5, 1.5, fee.shape), 0.0), dtype=dtype)
    xs.update(ks.wavefront_operands(spec, xs))
    ref = ks.substep_reference(spec, xs)
    tables = {k: xs[k].numpy() for k in ks.WAVEFRONT_TABLES}
    proto = Protocol.of(tables, spec.n_chunks, spec.window, spec.T, spec.E, blocks=5)
    run = TaskRun(spec, xs, proto.ring)
    simulate(proto, np.random.default_rng(2), run.hop, run.task)
    for k, r in ref.items():
        assert same_bits(run.ys[k], r), k
