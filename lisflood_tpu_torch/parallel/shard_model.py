"""Ranks owning whole shards of RoutingKernel sharded — the port of
lisflood_tpu/parallel/shard_model.py.

The JAX package shards the pixel axis of its one-device step over a mesh
with `with_sharding_constraint` and lets XLA insert the collectives. PyTorch
has no such partitioner, so here every rank says what it owns and what
crosses ranks:

- Rank r of N owns the logical shards [floor(r S / N), floor((r + 1) S / N))
  of `catchment_partition` (parallel/partition.py), S = cfg.num_shards >= N.
  In the shard-major position space of the sharded schedules (pos = s
  n_chunks C + c C + l, ops/kinwave_sharded.py) that is one contiguous block
  of each schedule, and its natural pixels are the real positions of the
  block, in ascending natural order: the rank's pixel axis. Every rank builds
  the whole model, partition and schedules on the host, as every JAX process
  holds the host arrays, and moves only its own part, and its tables, to its
  device (`RankLayout`, `rank_step`).
- The column physics is pixel-local and runs on the rank's pixels alone.
- Each sweep (K6) runs on the rank's own positions plus its upstream halo,
  the positions of other ranks upstream of them, whose operands arrive
  before the launch (ops/kinwave_sharded.RankRouter): every position's
  sources are summed by the same kernel in the same table order, so the bits
  are the one-process run's.
- Every other operation that reads across pixels gathers what it reads:
  segment sums (K7: catchment, region and evaporation totals) sum the
  gathered vector in the one-process order and keep the rank's part
  (`RankOrder`); the lake and reservoir steps read their feeders' discharge
  from the ranks that own them and run on every rank, and a structure's
  owner writes its outflow (`RankIndex`); the evaporation stencil runs on the
  gathered grid; the soil's Courant cap flag is a global OR.
So the gathered state of N ranks is that of one process bit for bit, for
every N <= S.

Options whose non-local operations are not made collective (groundwater
smoothing's window, transient land use, folded ensembles) and the packed
and scan routers raise NotImplementedError with more than one rank
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..graph.ldd import graph_levels
from ..models.step import Step, packed_routing_params, segment_orders, sharded_schedules
from ..ops.kinwave_sharded import RankRouter, _rank_in_group
from ..ops.segment_sum import scatter_to_downstream, segment_spread
from .collectives import all_gather, all_reduce_max, world

# parameters that index natural pixels (RankIndex of the pixel space), that
# index the channel schedule's positions (RankIndex of its position space),
# that place the pixels on the grid (the evaporation stencil's, GridIndex),
# and that stay whole on every rank (the stencil's codes)
NATURAL_INDEX = ("LakeIndex", "ReservoirIndex")
POSITION_INDEX = ("kinp$LakePos", "kinp$ResPos", "kinp$LakeUpsIdx", "kinp$ResUpsIdx")
GRID_INDEX = ("landIdx",)
WHOLE = ("evaDir2D",)


def rank_device(device, rank):
    """`device` for rank `rank`: None or "cuda" is card rank modulo the card
    count (None raises without a card), anything else as given."""
    if device is None or str(device) == "cuda":
        resolve_device(None)
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def rank_shards(rank, nranks, n_shards):
    """The logical shards [lo, hi) rank `rank` of `nranks` owns."""
    return rank * n_shards // nranks, (rank + 1) * n_shards // nranks


def downstream_ranks(down, owner):
    """(P,) int64: for every pixel of the graph `down` (-1 = none), the bit
    set of the ranks that own a pixel on its way down (itself left out)."""
    mask = np.zeros(down.size, np.int64)
    for lv in graph_levels(down)[1:]:
        d = down[lv]
        mask[lv] = mask[d] | (np.int64(1) << owner[d].astype(np.int64))
    return mask


@dataclasses.dataclass
class SpaceMap:
    """A space split over the ranks (natural pixels or a schedule's
    positions): each entry's rank and its index among its rank's entries
    (ascending), and each rank's count."""

    owner: np.ndarray
    local: np.ndarray
    counts: np.ndarray


def graph_parts(ps, down, owner_pix, rank_of_shard):
    """Each rank's part of the sharded schedule `ps` of the graph `down`
    (natural, -1 = none), as a dict: its block [lo, hi) of positions, its
    halo (the positions of other ranks upstream of its own, ascending), the
    positions it sends (`send`, in other ranks' halos, ascending) and where
    its halo's operands lie in the gathered send buffers (`halo_src`, owner
    x send_max + index in the owner's send list). `exchange`: whether any
    rank has a halo (every rank then takes part in each exchange)."""
    N = int(rank_of_shard.max()) + 1
    B = ps.n_chunks * ps.chunk
    mask = downstream_ranks(np.asarray(down, np.int64), owner_pix)
    inv = np.asarray(ps.inv_perm, np.int64)
    halos = [np.sort(inv[(owner_pix != r) & ((mask >> r) & 1).astype(bool)]) for r in range(N)]
    owner_pos = rank_of_shard[np.arange(ps.p_pad) // B]
    needed = np.zeros(ps.p_pad, bool)
    for h in halos:
        needed[h] = True
    send = [np.flatnonzero(needed & (owner_pos == o)) for o in range(N)]
    send_max = max(1, max(s.size for s in send))
    j = np.zeros(ps.p_pad, np.int64)
    for s in send:
        j[s] = np.arange(s.size)
    exchange = any(h.size for h in halos)
    parts = []
    for r in range(N):
        lo_s, hi_s = np.flatnonzero(rank_of_shard == r)[[0, -1]]
        parts.append({"lo": int(lo_s) * B, "hi": (int(hi_s) + 1) * B, "halo": halos[r],
                      "send": send[r], "send_max": send_max, "exchange": exchange,
                      "halo_src": owner_pos[halos[r]] * send_max + j[halos[r]]})
    return parts


class RankLayout:
    """Which pixels and positions rank `rank` of `nranks` owns, on the host:
    the sharded schedules (`sharded_schedules(cfg, aux)`, or `sched`), the
    natural pixel space and the channel schedule's position space as
    SpaceMaps, and for the channel ("kin") and overland ("tochan") graphs
    every rank's part (graph_parts). `seconds` holds the host time of the
    schedules and of the layout."""

    def __init__(self, cfg, aux, rank, nranks, sched=None):
        t0 = time.perf_counter()
        sched = sched or aux.get("sharded") or sharded_schedules(cfg, aux)
        t1 = time.perf_counter()
        kin = sched["kin"]
        S, P = kin.n_shards, kin.num_pixels
        if not 1 <= nranks <= S:
            raise ValueError(f"{nranks} ranks for {S} logical shards: each rank owns whole shards")
        self.sched, self.rank, self.nranks = sched, int(rank), int(nranks)
        self.num_pixels, self.n_shards = P, S
        rank_of_shard = np.array([r for r in range(nranks)
                                  for _ in range(*rank_shards(r, nranks, S))])
        self.shards = rank_shards(rank, nranks, S)
        owner = rank_of_shard[np.asarray(sched["shard_of"], np.int64)]
        self.natural = SpaceMap(owner, _rank_in_group(owner, nranks),
                                np.bincount(owner, minlength=nranks))
        self.pixels = np.flatnonzero(owner == rank)
        self.parts = {key: graph_parts(sched[key], aux[graph].downstream, owner, rank_of_shard)
                      for key, graph in (("kin", "graph_kin"), ("tochan", "graph_tochan"))}
        B = kin.n_chunks * kin.chunk
        pos = np.arange(kin.p_pad)
        pos_owner = rank_of_shard[pos // B]
        lo = np.array([part["lo"] for part in self.parts["kin"]])
        self.positions = SpaceMap(pos_owner, pos - lo[pos_owner],
                                  np.array([p["hi"] - p["lo"] for p in self.parts["kin"]]))
        self.seconds = {"schedules": t1 - t0, "layout": time.perf_counter() - t1}

    @property
    def owned(self):
        """(P,) each pixel's index among this rank's pixels, -1 elsewhere."""
        return np.where(self.natural.owner == self.rank, self.natural.local, -1)

    def part(self, key):
        return self.parts[key][self.rank]

    def cut_edges(self, key, aux):
        """The edges of graph `key` ("kin" or "tochan", in `aux`) whose ends
        lie on two ranks."""
        down = np.asarray(aux["graph_" + key].downstream, np.int64)
        src = np.flatnonzero(down >= 0)
        return int((self.natural.owner[src] != self.natural.owner[down[src]]).sum())

    def figures(self):
        """Per graph, this rank's own, halo and sent positions, the send
        buffers' width and whether the graph exchanges."""
        out = {}
        for key, parts in self.parts.items():
            me = parts[self.rank]
            out[key] = {"own": me["hi"] - me["lo"], "halo": int(me["halo"].size),
                        "send": int(me["send"].size), "send_max": me["send_max"],
                        "exchange": me["exchange"]}
        return out


def pixel_sharding(layout, arr, num_pixels=None, p_pad=None):
    """The index of `layout`'s rank's part of `arr` along its trailing axis:
    its pixels where that axis is the pixel axis (num_pixels, the layout's
    by default), its block where it is the channel schedule's position space
    (p_pad); None (the array is replicated) otherwise."""
    if getattr(arr, "ndim", 0) == 0:
        return None
    n = arr.shape[-1]
    if n == (num_pixels or layout.num_pixels):
        return layout.pixels
    if p_pad and n == p_pad:
        part = layout.part("kin")
        return slice(part["lo"], part["hi"])
    return None


def shard_tree(layout, tree, num_pixels=None, p_pad=None):
    """The rank's part of every entry of `tree` (NumPy arrays, tensors or
    scalars) whose trailing axis pixel_sharding splits; the others as they
    are."""
    out = {}
    for k, v in tree.items():
        idx = pixel_sharding(layout, v, num_pixels, p_pad)
        if idx is None:
            out[k] = v
        elif torch.is_tensor(v):
            out[k] = v[..., torch.as_tensor(idx, device=v.device) if not isinstance(idx, slice)
                       else idx]
        else:
            out[k] = np.ascontiguousarray(np.asarray(v)[..., idx])
    return out


# ---------------------------------------------------------------------------
# the rank's device-side spaces, indices and segment orders


class RankSpace:
    """A SpaceMap on the device of one rank: `gather` makes a full vector of
    every rank's part (one all_gather of parts padded to the largest),
    `own_of` takes the rank's part of a full vector."""

    def __init__(self, smap, rank, group, device):
        self.group = group
        self.width = max(1, int(smap.counts.max()))
        self.n_own = int(smap.counts[rank])
        self.src = torch.as_tensor(smap.owner * self.width + smap.local, device=device)
        self.own = torch.as_tensor(np.flatnonzero(smap.owner == rank), device=device)

    def gather(self, x):
        buf = x.new_zeros(x.shape[:-1] + (self.width,))
        buf[..., :self.n_own] = x
        got = all_gather(buf, self.group).movedim(0, -2)
        return got.reshape(x.shape[:-1] + (-1,)).index_select(-1, self.src)

    def own_of(self, x):
        return x.index_select(-1, self.own)


class RankIndex:
    """An index array into a space split over the ranks (physics.take /
    place): `take(x)` gives x_full[index] from the rank's part `x`, one
    all_gather of the entries each rank owns (padded to the most); `place`
    writes the entries the rank owns. `index` is the full index on the
    device."""

    def __init__(self, index, smap, rank, group, device):
        index = np.ascontiguousarray(index, np.int64)
        flat = index.reshape(-1)
        uniq, inv = np.unique(flat, return_inverse=True)
        own_u = smap.owner[uniq]
        n = smap.counts.size
        self.group, self.shape = group, index.shape
        self.width = max(1, int(np.bincount(own_u, minlength=n).max(initial=0)))
        self.send = torch.as_tensor(smap.local[uniq[own_u == rank]], device=device)
        j = _rank_in_group(own_u, n)
        self.src = torch.as_tensor((own_u * self.width + j)[inv.reshape(-1)], device=device)
        mine = np.flatnonzero(smap.owner[flat] == rank)
        self.entries = torch.as_tensor(mine, device=device)
        self.dst = torch.as_tensor(smap.local[flat[mine]], device=device)

    def take(self, x):
        buf = x.new_zeros(self.width)
        buf[:self.send.numel()] = x[self.send]
        return all_gather(buf, self.group).reshape(-1)[self.src].reshape(self.shape)

    def place(self, base, vals):
        return base.index_copy_(0, self.dst, vals.index_select(0, self.entries))


@dataclasses.dataclass
class GridIndex:
    """Every pixel's grid cell (`index`, whole on the device) with the pixel
    space of one rank: the evaporation stencil
    (physics.scatter_down_stencil) runs on the gathered grid and keeps the
    rank's pixels."""

    index: torch.Tensor
    space: RankSpace


class RankOrder:
    """A SegmentOrder of the whole space on one rank: the sum runs on the
    gathered vector in the one-process order (K7 on the card), and the rank
    keeps its part."""

    def __init__(self, order, space):
        self.order, self.space = order, space

    def segment_spread(self, values):
        return self.space.own_of(segment_spread(self.space.gather(values), self.order))

    def scatter_to_downstream(self, values):
        return self.space.own_of(scatter_to_downstream(self.space.gather(values), self.order))


# ---------------------------------------------------------------------------
# the rank's step


def check_ranks(cfg, nranks):
    """Refuses what the multi-process step does not run across ranks."""
    if nranks <= 1:
        return
    if cfg.routing_kernel != "sharded":
        raise NotImplementedError(
            f"RoutingKernel {cfg.routing_kernel} across {nranks} ranks: only the sharded router "
            "runs across ranks; packed and scan are later work (ROADMAP.md)")
    for flag, what in (("groundwater_smooth", "groundwater smoothing (a window over the grid)"),
                       ("transient_landuse", "transient land use")):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{what} across ranks is later work (ROADMAP.md)")
    if cfg.members != 1:
        raise NotImplementedError("a folded ensemble across ranks is not in the JAX package "
                                  "(ROADMAP.md)")


def rank_params(cfg, params_np, kinp, layout, group, device, dtype):
    """The rank's parameters on its device: its pixels of every per-pixel
    array, its block of the channel schedule's position-space arrays, the
    structure indices as RankIndex, the evaporation grid whole, the rest
    replicated (the types as models/step.device_params gives them)."""
    rank = layout.rank
    nat = RankSpace(layout.natural, rank, group, device)
    p = {}
    for k, v in params_np.items():
        if isinstance(v, (int, float, np.floating, np.integer)):
            p[k] = int(v) if isinstance(v, (int, np.integer)) else float(v)
        elif k in NATURAL_INDEX:
            p[k] = RankIndex(v, layout.natural, rank, group, device)
        elif k in GRID_INDEX:
            p[k] = GridIndex(torch.as_tensor(np.asarray(v, np.int64), device=device), nat)
        else:
            part = v if k in WHOLE else shard_tree(layout, {k: v})[k]
            p.update(to_device({k: part}, device, dtype))
    p_pad = layout.sched["kin"].p_pad
    for k, v in kinp.items():
        if k in POSITION_INDEX:
            p[k] = RankIndex(v, layout.positions, rank, group, device)
            continue
        part = shard_tree(layout, {k: v}, num_pixels=-1, p_pad=p_pad)[k]
        if part.dtype.kind in "iu":
            p[k] = torch.as_tensor(np.ascontiguousarray(part), device=device)
        else:
            p.update(to_device({k: part}, device, dtype))
    return p, nat


class RankStep:
    """One rank's model step: `step(state, forcing) -> (state, diag)` on the
    rank's part (the wrapped models/step.Step on the rank's parameters and
    routers), with the soil's Courant cap flag made global. `prepare_state`
    and `shard_forcing` take the rank's part of whole host arrays; `gather`
    makes whole natural tensors (a collective: every rank calls it)."""

    def __init__(self, step, layout, group, seconds):
        self.step, self.layout, self.group = step, layout, group
        self.cfg, self.params, self.routers = step.cfg, step.params, step.routers
        self.device = step.device
        self.seconds = seconds
        self.space = RankSpace(layout.natural, layout.rank, group, step.device)
        self.pixel_keys = None

    def __call__(self, s, f):
        s, d = self.step(s, f)
        if "SoilCourantCapHit" in d and self.layout.nranks > 1:
            d["SoilCourantCapHit"] = all_reduce_max(d["SoilCourantCapHit"], self.group)
        return s, d

    def prepare_state(self, state, dtype=None):
        """Whole natural host state (NumPy, or tensors) -> the rank's state on
        its device; the entries split by pixel are remembered for gather."""
        state = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in state.items()}
        self.pixel_keys = {k for k, v in state.items()
                           if pixel_sharding(self.layout, v) is not None}
        return self.step.prepare_state(shard_tree(self.layout, state), dtype)

    def shard_forcing(self, f, dtype=None):
        """A whole day's forcing (NumPy, or tensors) -> the rank's on its
        device."""
        dtype = dtype or self.params["ChanLength"].dtype
        f = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in f.items()}
        return to_device(shard_tree(self.layout, f), self.device, dtype)

    def natural_state(self, s):
        return self.step.natural_state(s)

    def gather(self, tree, keys=None):
        """Whole natural tensors of the entries `keys` of `tree` (the state's
        entries split by pixel, or any per-pixel diagnostics), the others as
        they are; every rank calls it in the same order."""
        keys = self.pixel_keys if keys is None else set(keys)
        return {k: self.space.gather(v) if k in keys else v for k, v in tree.items()}


def rank_step(cfg, params_np, aux, layout, group, dtype=torch.float64, device=None):
    """The RankStep of `layout`'s rank for the host model (cfg, params_np,
    aux) on `device` (rank_device: None is card rank modulo the card count,
    raising without a card): the channel
    schedule's position-space parameters (models/step.packed_routing_params)
    and the segment orders of the whole model, built on the host, then the
    rank's part of each moved to its device, its routers (RankRouter, with
    K6's tables of its own positions and halo) and its step on them; the
    step's config counts the rank's pixels."""
    device = rank_device(device, layout.rank)
    check_ranks(cfg, layout.nranks)
    if cfg.routing_kernel != "sharded":
        raise NotImplementedError("rank_step runs RoutingKernel sharded")
    t0 = time.perf_counter()
    kinp, feeders_earlier, _ = packed_routing_params(cfg, params_np, layout.sched["kin"])
    p, nat = rank_params(cfg, params_np, kinp, layout, group, device, dtype)
    t1 = time.perf_counter()
    orders = segment_orders(cfg, params_np, device, kinp.get("kinp$Catchments"), True)
    pos = RankSpace(layout.positions, layout.rank, group, device)
    p.update({k: RankOrder(v, pos if k == "seg$kinp$Catchments" else nat)
              for k, v in orders.items()})
    t2 = time.perf_counter()
    owned = layout.owned
    routers = {}
    for key in ("kin", "tochan"):
        r = RankRouter(layout.sched[key], layout.part(key), owned, group, device)
        if not r.no_edges:
            r.sweep_tiles()
        routers[key] = r
    routers["kin"].struct_feeders_earlier, routers["kin"].eva_window_ok = feeders_earlier, False
    t3 = time.perf_counter()
    cfg_r = dataclasses.replace(cfg, num_pixels=int(layout.pixels.size),
                                eva_stencil=bool(cfg.use_eva_stencil(device)))
    seconds = dict(layout.seconds, params=t1 - t0, orders=t2 - t1, routers=t3 - t2)
    return RankStep(Step(cfg_r, p, routers, device), layout, group, seconds)


# ---------------------------------------------------------------------------
# the JAX package's entry points


def shard_runner_step(runner, group=None):
    """The step of a models/driver.LisfloodRunner (RoutingKernel sharded)
    for this process's rank of `group` (the world by default): returns
    (step, state), the RankStep on the runner's device and dtype and the
    rank's part of the runner's state."""
    rank, nranks = world(group)
    layout = RankLayout(runner.config, runner.aux, rank, nranks)
    step = rank_step(runner.config, runner.params_np, runner.aux, layout, group, runner.dtype,
                     runner.device)
    return step, step.prepare_state(runner.step.natural_state(runner.state))


def build_sharded_model_step(group=None, nrows=16, ncols=16, dtype=torch.float32,
                             routing_kernel="sharded", num_shards=None, device=None,
                             **synth_kwargs):
    """The synthetic model's step for this process's rank of `group`:
    returns (step, state, forcing, cfg), the rank's state and forcing on its
    device. `num_shards` defaults to the number of ranks."""
    from ..models.synthetic import build_synthetic_model, synthetic_forcing
    rank, nranks = world(group)
    cfg, params, state, aux = build_synthetic_model(nrows, ncols, **synth_kwargs)
    cfg = dataclasses.replace(cfg, routing_kernel=routing_kernel,
                              num_shards=num_shards or nranks)
    check_ranks(cfg, nranks)
    layout = RankLayout(cfg, aux, rank, nranks)
    step = rank_step(cfg, params, aux, layout, group, dtype, device)
    return (step, step.prepare_state(state, dtype),
            step.shard_forcing(synthetic_forcing(cfg.num_pixels), dtype), cfg)
