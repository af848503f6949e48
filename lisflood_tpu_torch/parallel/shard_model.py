"""Ranks owning whole logical shards of the pixel axis, on the packed, the
sharded and the scan router — the port of
lisflood_tpu/parallel/shard_model.py.

The JAX package shards the pixel axis of its one-device step over a mesh
with `with_sharding_constraint` and lets XLA insert the collectives. PyTorch
has no such partitioner, so here every rank says what it owns and what
crosses ranks:

- Rank r of N owns the logical shards [floor(r S / N), floor((r + 1) S / N))
  of `catchment_partition` (parallel/partition.py): S = cfg.num_shards >= N
  for RoutingKernel sharded, S = max(cfg.num_shards, N) for packed and
  scan. Its natural pixels, ascending, are the rank's pixel axis. Every
  rank builds the whole model, partition and schedules on the host, as
  every JAX process holds the host arrays, and moves only its own part,
  and its tables, to its device (`RankLayout`, `PackedRankLayout`,
  `ScanRankLayout`, `rank_step`).
- The column physics is pixel-local and runs on the rank's pixels alone.
- RoutingKernel sharded (`RankLayout`): the rank's positions are one
  contiguous block of each shard-major sharded schedule (pos = s n_chunks C
  + c C + l, ops/kinwave_sharded.py); each sweep (K6) runs on its own
  positions plus its upstream halo, the positions of other ranks upstream
  of them, whose operands arrive before the launch (RankRouter).
- RoutingKernel packed, the default (`PackedRankLayout`): the rank runs the
  unchanged sub-step kernel on its kept chunks of the whole packed
  schedule, every chunk that holds a position it owns or one of its halo,
  in order, each lane where it was (ops/kinwave_packed.RankPackedRouter).
  The halo is closed upstream over every edge the kernel reads (the routing
  graph, the evaporation chain in the kernel, the lakes' and reservoirs'
  feeders), so dropping the other chunks only shortens distances and keeps
  every order: the kernel's contract holds, its tables are the whole
  schedule's remapped (rank_kinp), and the land phase's rows of the halo
  arrive in one all_gather before the launch. The rank steps its halo's
  routing state itself, bit for bit its owner's; each structure's state
  comes from the rank that owns its cell, one gather a step. The overland
  sweep (K5) runs on the rank's kept overland chunks the same way.
- RoutingKernel scan (`ScanRankLayout`): the position space is the natural
  pixel space, so the rank's positions are its own pixels; each sweep (K6)
  runs on the natural graph cut to its own pixels plus its upstream halo
  (the other ranks' pixels upstream of them over the downstream of the
  schedule it sweeps), whose operands arrive before the launch
  (ops/kinwave.RankScanRouter).
- Whatever the router, every position's sources are summed by the same
  kernel in the same table order, so the bits are the one-process run's.
- Every other operation that reads across pixels gathers what it reads:
  segment sums (K7: catchment, region and evaporation totals) sum the
  gathered vector in the one-process order and keep the rank's part
  (`RankOrder`); the lake and reservoir steps of the sharded router read
  their feeders' discharge from the ranks that own them, and a structure's
  owner writes its outflow (`RankIndex`); the evaporation stencil and
  groundwater smoothing's window run on the gathered grid (`GridIndex`,
  `GridPixels`); the soil's Courant cap flag is a global OR. Transient land
  use reads per-pixel forcing, split as any other.
So the gathered state of N ranks is that of one process bit for bit, for
every N <= S (the packed and the scan router's bits do not depend on S at
all).

A folded ensemble raises NotImplementedError with more than one rank (the
JAX package has none across devices; ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..graph.ldd import graph_levels
from ..models.step import (PACKED_FILLS, Step, packed_routing_keys, packed_routing_params,
                           segment_orders, sharded_schedules)
from ..ops.kinwave import RankScanRouter, natural_schedule
from ..ops.kinwave_packed import PackedSchedule, RankPackedRouter, pack_schedule
from ..ops.kinwave_sharded import RankRouter, _rank_in_group
from ..ops.segment_sum import scatter_to_downstream, segment_spread
from ..ops.wavefront import WAVEFRONT_TABLES, wavefront_tables
from .collectives import all_gather, all_reduce_max, world
from .partition import catchment_partition

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


def rank_of_shards(nranks, n_shards):
    """(n_shards,) the rank that owns each logical shard."""
    return np.array([r for r in range(nranks) for _ in range(*rank_shards(r, nranks, n_shards))])


def downstream_ranks(down, owner, nranks):
    """(P, nranks) bool: for every pixel of the graph `down` (-1 = none),
    the ranks that own a pixel on its way down (itself left out)."""
    mask = np.zeros((down.size, nranks), bool)
    for lv in graph_levels(down)[1:]:
        d = down[lv]
        m = mask[d]
        m[np.arange(d.size), owner[d]] = True
        mask[lv] = m
    return mask


@dataclasses.dataclass
class SpaceMap:
    """A space split over the ranks (natural pixels or a schedule's
    positions): each entry's rank and its index among its rank's entries
    (ascending), and each rank's count."""

    owner: np.ndarray
    local: np.ndarray
    counts: np.ndarray


def send_lists(halos, owner, nranks):
    """The exchange of every rank's halo (entries of a space whose ranks
    are `owner`, -1 = no rank): the entries each rank sends (`send`, in some
    halo, ascending), the send buffers' width (`send_max`), where each
    halo's values lie in the gathered send buffers (`halo_src`, owner x
    send_max + index in the owner's send list) and whether any rank has a
    halo (`exchange`)."""
    needed = np.zeros(owner.size, bool)
    for h in halos:
        needed[h] = True
    send = [np.flatnonzero(needed & (owner == o)) for o in range(nranks)]
    send_max = max(1, max(x.size for x in send))
    j = np.zeros(owner.size, np.int64)
    for x in send:
        j[x] = np.arange(x.size)
    return {"send": send, "send_max": send_max, "exchange": any(h.size for h in halos),
            "halo_src": [owner[h] * send_max + j[h] for h in halos]}


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
    mask = downstream_ranks(np.asarray(down, np.int64), owner_pix, N)
    inv = np.asarray(ps.inv_perm, np.int64)
    halos = [np.sort(inv[(owner_pix != r) & mask[:, r]]) for r in range(N)]
    ex = send_lists(halos, rank_of_shard[np.arange(ps.p_pad) // B], N)
    parts = []
    for r in range(N):
        lo_s, hi_s = np.flatnonzero(rank_of_shard == r)[[0, -1]]
        parts.append({"lo": int(lo_s) * B, "hi": (int(hi_s) + 1) * B, "halo": halos[r],
                      "send": ex["send"][r], "send_max": ex["send_max"],
                      "exchange": ex["exchange"], "halo_src": ex["halo_src"][r]})
    return parts


class _Layout:
    """What the layouts share: the natural pixel space (`natural`, a
    SpaceMap), the rank and every rank's part of each graph (`parts`)."""

    @property
    def owned(self):
        """(P,) each pixel's index among this rank's pixels, -1 elsewhere."""
        return np.where(self.natural.owner == self.rank, self.natural.local, -1)

    def part(self, key):
        return self.parts[key][self.rank]

    def figures(self):
        """Per graph, this rank's own, halo and sent entries (positions or
        pixels), the send buffers' width and whether the graph
        exchanges."""
        out = {}
        for key, parts in self.parts.items():
            me = parts[self.rank]
            out[key] = {"own": me["hi"] - me["lo"] if "lo" in me else int(me["own"].size),
                        "halo": int(me["halo"].size), "send": int(me["send"].size),
                        "send_max": me["send_max"], "exchange": me["exchange"]}
        return out

    def cut_edges(self, key, aux):
        """The edges of graph `key` ("kin" or "tochan", in `aux`) whose ends
        lie on two ranks."""
        down = np.asarray(aux["graph_" + key].downstream, np.int64)
        src = np.flatnonzero(down >= 0)
        return int((self.natural.owner[src] != self.natural.owner[down[src]]).sum())


class RankLayout(_Layout):
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
        rank_of_shard = rank_of_shards(nranks, S)
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

    def position_index(self):
        """The rank's part of the channel schedule's position space: its
        block."""
        part = self.part("kin")
        return slice(part["lo"], part["hi"])


def owner_of_pixels(cfg, aux, nranks, n_shards=None):
    """(owner (P,), n_shards): each pixel's rank when rank r
    of `nranks` owns the logical shards rank_shards(r, nranks, S) of
    catchment_partition(aux["graph_kin"], S), S = n_shards or
    max(cfg.num_shards, nranks)."""
    S = int(n_shards or max(cfg.num_shards, nranks))
    if not 1 <= nranks <= S:
        raise ValueError(f"{nranks} ranks for {S} logical shards: each rank owns whole shards")
    shard_of, _ = catchment_partition(aux["graph_kin"], S)
    return rank_of_shards(nranks, S)[np.asarray(shard_of, np.int64)], S


def downstream_rank_sets(chunk, src, tgt, owner_pos, nranks):
    """(p_pad, nranks) bool: for every position of a packed schedule with
    the edges src -> tgt (positions of real pixels), each ending in a later
    chunk, the ranks owning a position it reaches (itself left out). The
    chunks are visited from the last: every target's set is final when
    read."""
    reach = np.zeros((owner_pos.size, nranks), bool)
    if not src.size:
        return reach
    if (tgt // chunk <= src // chunk).any():
        raise ValueError("an edge of the packed schedule does not end in a later chunk")
    order = np.lexsort((src, -(src // chunk)))
    src, tgt = src[order], tgt[order]
    cut = np.flatnonzero(np.diff(src // chunk)) + 1
    for a, b in zip(np.r_[0, cut], np.r_[cut, src.size]):
        s, t = src[a:b], tgt[a:b]
        v = reach[t]
        v[np.arange(t.size), owner_pos[t]] = True
        first = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        reach[s[first]] |= np.logical_or.reduceat(v, first, axis=0)
    return reach


def packed_parts(ps, src, tgt, owner_pix, nranks):
    """Each rank's part of the whole packed schedule `ps` whose lanes read
    across along the edges src -> tgt (positions), as a dict: its own
    positions, its halo (the other ranks' positions upstream of its own),
    the kept chunks (every chunk that holds one of either, ascending) and
    their positions `glob` (kept chunk j's lane l is local position j C +
    l), the positions it sends (in other ranks' halos, ascending), and where
    its halo's values lie in the gathered send buffers (`halo_src`, owner x
    send_max + index in the owner's send list); `exchange`: whether any rank
    has a halo."""
    C, P = ps.chunk, ps.num_pixels
    real = ps.perm < P
    owner_pos = np.full(ps.p_pad, -1, np.int64)
    owner_pos[real] = owner_pix[ps.perm[real]]
    reach = downstream_rank_sets(C, np.asarray(src, np.int64), np.asarray(tgt, np.int64),
                                 owner_pos, nranks)
    halos = [np.flatnonzero((owner_pos >= 0) & (owner_pos != r) & reach[:, r])
             for r in range(nranks)]
    ex = send_lists(halos, owner_pos, nranks)
    parts = []
    for r in range(nranks):
        own = np.flatnonzero(owner_pos == r)
        lanes = np.union1d(own, halos[r])
        chunks = np.unique(lanes // C)
        parts.append({"own": own, "halo": halos[r], "lanes": lanes, "chunks": chunks,
                      "glob": (chunks[:, None] * C + np.arange(C)).reshape(-1),
                      "send": ex["send"][r], "send_max": ex["send_max"],
                      "exchange": ex["exchange"], "halo_src": ex["halo_src"][r]})
    return parts


def kept_schedule(ps, part):
    """(the PackedSchedule of a rank's kept chunks of `ps`, loc_of): each
    kept lane where it was, the other lanes padding, the edges between kept
    lanes (each still 1..W chunks long); loc_of (p_pad + 1,) each position's
    local position, -1 where it is not kept (and at p_pad, none). Raises
    where a kept lane lost one of its sources: the halo is not closed
    upstream."""
    C, P, glob = ps.chunk, ps.num_pixels, part["glob"]
    n = glob.size
    loc_of = np.full(ps.p_pad + 1, -1, np.int64)
    loc_of[part["lanes"]] = np.searchsorted(glob, part["lanes"])
    kept = loc_of[glob] >= 0
    down = np.where(kept, loc_of[np.minimum(ps.down_pos[glob], ps.p_pad)], -1)
    has = down >= 0
    whole = np.bincount(ps.down_pos[ps.down_pos < ps.p_pad], minlength=ps.p_pad)[glob]
    if (np.bincount(down[has], minlength=n) != np.where(kept, whole, 0)).any():
        raise ValueError("a kept lane's upstream source is not kept: the halo is not closed")
    perm = np.where(kept, ps.perm[glob], P)
    inv_perm = np.full(P, -1, np.int64)
    inv_perm[perm[kept]] = np.flatnonzero(kept)
    src = np.flatnonzero(has)
    down_local = np.full(n, ps.window * C, np.int32)
    down_local[src] = down[src] - (src // C + 1) * C
    down_pos = np.full(n, n, np.int32)
    down_pos[src] = down[src]
    return PackedSchedule(perm=perm, inv_perm=inv_perm, down_local=down_local.reshape(-1, C),
                          down_pos=down_pos, n_chunks=n // C, chunk=C, window=ps.window,
                          num_pixels=P), loc_of


def _remap_sources(table, loc_of, kept, what):
    """A (K, n) source table of the kept chunks' lanes in whole-schedule
    positions -> local positions, in the same row order, -1 on lanes that
    are not kept; raises where a kept lane lost a source."""
    table = np.asarray(table, np.int64)
    out = np.where(table >= 0, loc_of[np.where(table >= 0, table, -1)], -1)
    if ((table >= 0) & (out < 0) & kept).any():
        raise ValueError(f"{what}: a kept lane's source is not kept: the halo is not closed")
    return np.where(kept, out, -1).astype(np.int32)


def rank_kinp(kinp, ps, part, loc_of):
    """The sub-step kernel's parameters (packed_routing_params of the whole
    schedule `ps`) cut to a rank's kept chunks: the per-position rows, with
    PACKED_FILLS on the lanes that are neither own nor halo; the upstream
    tables remapped to local positions in the same row order; the lakes and
    reservoirs whose cells are kept, their feeders remapped; then
    wavefront_tables of the remapped tables. Returns (params, the kept
    structures' indices by prefix "lk" / "rs")."""
    glob = part["glob"]
    kept = loc_of[glob] >= 0
    out, rows = {}, {}
    for k, v in kinp.items():
        name = k[len("kinp$"):]
        if name in PACKED_FILLS:
            out[k] = np.where(kept, v[glob], PACKED_FILLS[name]).astype(v.dtype)
        elif name in ("UpsTable", "EvaUpsTable"):
            out[k] = _remap_sources(v[:, glob], loc_of, kept, name)
    for name, prefix in (("Lake", "lk"), ("Res", "rs")):
        if f"kinp${name}Pos" not in kinp:
            continue
        loc = loc_of[kinp[f"kinp${name}Pos"]]
        idx = np.flatnonzero(loc >= 0)
        rows[prefix] = idx
        fee = kinp[f"kinp${name}Fee"][idx]
        out[f"kinp${name}Pos"] = loc[idx].astype(np.int32)
        out[f"kinp${name}Fee"] = _remap_sources(fee, loc_of, True, name + " feeders")
        w = kinp[f"kinp${name}UpsW"][idx]
        out[f"kinp${name}UpsW"] = w
        out[f"kinp${name}UpsIdx"] = np.where(w > 0, loc_of[kinp[f"kinp${name}UpsIdx"][idx]],
                                             0).astype(np.int32)
    handled = set(out) | {"kinp$" + k for k in WAVEFRONT_TABLES}
    if set(kinp) - handled:
        raise ValueError(f"rank_kinp: no rule for {sorted(set(kinp) - handled)}")
    if "kinp$wf_deps" in kinp:
        tables = wavefront_tables(glob.size // ps.chunk, ps.chunk, ps.window,
                                  out["kinp$UpsTable"], out.get("kinp$EvaUpsTable"),
                                  out.get("kinp$LakePos"), out.get("kinp$LakeFee"),
                                  out.get("kinp$ResPos"), out.get("kinp$ResFee"))
        out.update({"kinp$" + k: v for k, v in tables.items()})
    return out, rows


def channel_edges(kinp, eva_window_ok):
    """(src, tgt): the positions along which the sub-step kernel reads
    across lanes of the whole schedule — the routing graph's hand-over
    (kinp$UpsTable), the evaporation chain where it runs in the kernel
    (kinp$EvaUpsTable) and every lake's and reservoir's feeders (the graph
    before the structure cut)."""
    src, tgt = [], []
    tables = ["kinp$UpsTable"] + (["kinp$EvaUpsTable"] if eva_window_ok else [])
    for k in tables:
        t = np.asarray(kinp[k], np.int64)
        row, col = np.nonzero(t >= 0)
        src.append(t[row, col])
        tgt.append(col)
    for name in ("Lake", "Res"):
        if f"kinp${name}Pos" in kinp:
            fee = np.asarray(kinp[f"kinp${name}Fee"], np.int64)
            i, f = np.nonzero(fee >= 0)
            src.append(fee[i, f])
            tgt.append(np.asarray(kinp[f"kinp${name}Pos"], np.int64)[i])
    return np.concatenate(src), np.concatenate(tgt)


class PackedRankLayout(_Layout):
    """Which pixels and positions rank `rank` of `nranks` owns for the
    packed router (RoutingKernel packed), on the host. The pixels are owned
    as by RankLayout: rank r owns the logical shards rank_shards(r, nranks,
    S) of catchment_partition(graph_kin, S), S = n_shards or
    max(cfg.num_shards, nranks) (cfg.num_shards keeps its meaning: 1 unless
    the settings say sharded). The positions are those of the whole packed
    schedules (aux["schedule_kin"], ["schedule_tochan"]):

    - channel ("kin"): the halo is the closure upstream of the rank's
      positions over the edges the sub-step kernel reads (channel_edges:
      the routing graph, the evaporation chain where it runs in the kernel,
      the structures' feeders); the kernel's parameters are
      packed_routing_params of the whole schedule (`kinp`, with
      `feeders_earlier` and `eva_window_ok`), cut to the kept chunks
      (rank_kinp: `kinp_local`, the kept structures in `struct_rows`);
    - overland ("tochan"): the closure over its routing graph.

    For each graph `parts` holds every rank's part (packed_parts) and
    `local` this rank's kept-chunk schedule (kept_schedule); `router_part`
    gives its RankPackedRouter's tables. `seconds` holds the host time of
    the partition, the whole tables and the layout."""

    def __init__(self, cfg, params_np, aux, rank, nranks, n_shards=None):
        t0 = time.perf_counter()
        owner, S = owner_of_pixels(cfg, aux, nranks, n_shards)
        t1 = time.perf_counter()
        self.rank, self.nranks, self.n_shards = int(rank), int(nranks), S
        P = owner.size
        self.num_pixels = P
        self.natural = SpaceMap(owner, _rank_in_group(owner, nranks),
                                np.bincount(owner, minlength=nranks))
        self.pixels = np.flatnonzero(owner == rank)
        self.ps = {key: pack_schedule(aux["schedule_" + key]) for key in ("kin", "tochan")}
        self.kinp, self.feeders_earlier, self.eva_window_ok = packed_routing_params(
            cfg, params_np, self.ps["kin"])
        t2 = time.perf_counter()
        tochan = self.ps["tochan"]
        has = tochan.down_pos < tochan.p_pad
        edges = {"kin": channel_edges(self.kinp, self.eva_window_ok),
                 "tochan": (np.flatnonzero(has), tochan.down_pos[has].astype(np.int64))}
        self.no_edges = {"kin": False, "tochan": not has.any()}
        self.parts, self.local, self.loc_of = {}, {}, {}
        for key, (src, tgt) in edges.items():
            self.parts[key] = packed_parts(self.ps[key], src, tgt, owner, nranks)
            self.local[key], self.loc_of[key] = kept_schedule(self.ps[key], self.part(key))
        self.kinp_local, self.struct_rows = rank_kinp(self.kinp, self.ps["kin"], self.part("kin"),
                                                      self.loc_of["kin"])
        self.struct_owner = {}
        for name, prefix in (("Lake", "lk"), ("Res", "rs")):
            if prefix in self.struct_rows:
                idx = np.asarray(params_np["LakeIndex" if prefix == "lk" else "ReservoirIndex"],
                                 np.int64)
                self.struct_owner[prefix] = owner[idx]
        self.seconds = {"partition": t1 - t0, "tables": t2 - t1,
                        "layout": time.perf_counter() - t2}

    def position_index(self):
        """The rank's part of the whole channel schedule's position space:
        the positions of its kept chunks."""
        return self.part("kin")["glob"]

    def router_part(self, key):
        """The tables of graph `key`'s RankPackedRouter (see there)."""
        part, loc_of, ps = self.part(key), self.loc_of[key], self.ps[key]
        nat = self.natural
        n_own = int(self.pixels.size)
        local = self.local[key]
        real = local.perm < self.num_pixels
        own = np.zeros(real.size, bool)
        own[real] = nat.owner[local.perm[real]] == self.rank
        perm = np.full(real.size, n_own, np.int64)
        perm[own] = nat.local[local.perm[own]]
        out = {"perm": perm, "inv_perm": loc_of[ps.inv_perm[self.pixels]],
               "halo": loc_of[part["halo"]], "halo_src": part["halo_src"],
               "send": nat.local[ps.perm[part["send"]]], "send_max": part["send_max"],
               "exchange": part["exchange"], "no_edges": self.no_edges[key]}
        if key == "kin":
            out["struct_rows"] = self.struct_rows
            out["struct_src"] = {}
            for prefix, rows in self.struct_rows.items():
                owner = self.struct_owner[prefix]
                index = _rank_in_group(owner, self.nranks)
                mine = np.flatnonzero(owner[rows] == self.rank)
                out["struct_src"][prefix] = (mine, owner, index)
        return out

    def figures(self):
        """_Layout.figures with each graph's kept chunks of all."""
        out = super().figures()
        for key, fig in out.items():
            fig.update(chunks=int(self.part(key)["chunks"].size), of_chunks=self.ps[key].n_chunks)
        return out


def scan_parts(down, owner, nranks):
    """Each rank's part of the natural graph `down` (-1 = none) whose pixels'
    ranks are `owner`, as a dict: its own pixels, its halo (the other ranks'
    pixels upstream of its own, ascending) and its exchange (send_lists)."""
    mask = downstream_ranks(down, owner, nranks)
    halos = [np.flatnonzero((owner != r) & mask[:, r]) for r in range(nranks)]
    ex = send_lists(halos, owner, nranks)
    return [{"own": np.flatnonzero(owner == r), "halo": halos[r], "send": ex["send"][r],
             "send_max": ex["send_max"], "exchange": ex["exchange"],
             "halo_src": ex["halo_src"][r]} for r in range(nranks)]


class ScanRankLayout(_Layout):
    """Which pixels rank `rank` of `nranks` owns for the scan router
    (RoutingKernel scan), on the host. The pixels are owned as by
    PackedRankLayout (owner_of_pixels: S = n_shards or max(cfg.num_shards,
    nranks)). The router's position space is the natural pixel space, so
    `positions` is `natural` and a rank's positions are its own pixels. For
    the channel ("kin") and overland ("tochan") graphs, by the downstream of
    the schedules the router sweeps (`sched`: aux["schedule_kin"],
    ["schedule_tochan"]), `parts` holds every rank's part (scan_parts).
    `seconds` holds the host time of the partition and of the layout."""

    def __init__(self, cfg, aux, rank, nranks, n_shards=None):
        t0 = time.perf_counter()
        owner, S = owner_of_pixels(cfg, aux, nranks, n_shards)
        t1 = time.perf_counter()
        self.rank, self.nranks, self.n_shards = int(rank), int(nranks), S
        P = owner.size
        self.num_pixels = P
        self.natural = SpaceMap(owner, _rank_in_group(owner, nranks),
                                np.bincount(owner, minlength=nranks))
        self.positions = self.natural
        self.pixels = np.flatnonzero(owner == rank)
        self.sched = {key: aux["schedule_" + key] for key in ("kin", "tochan")}
        self.parts = {}
        for key, sched in self.sched.items():
            down = natural_schedule(sched).down_pos.astype(np.int64)
            self.parts[key] = scan_parts(np.where(down < P, down, -1), owner, nranks)
        self.seconds = {"partition": t1 - t0, "layout": time.perf_counter() - t1}

    def position_index(self):
        """The rank's part of the natural position space: its pixels."""
        return self.pixels


# the layout of each router across ranks
LAYOUTS = {"packed": PackedRankLayout, "sharded": RankLayout, "scan": ScanRankLayout}


def rank_layout(cfg, params_np, aux, rank, nranks, n_shards=None):
    """The layout of rank `rank` of `nranks` for cfg's router: a
    PackedRankLayout for RoutingKernel packed, a RankLayout (whole shards of
    the sharded schedules) for sharded, a ScanRankLayout for scan (n_shards:
    the logical shard count of packed and scan)."""
    if cfg.routing_kernel == "packed":
        return PackedRankLayout(cfg, params_np, aux, rank, nranks, n_shards)
    if cfg.routing_kernel == "scan":
        return ScanRankLayout(cfg, aux, rank, nranks, n_shards)
    if cfg.routing_kernel != "sharded":
        raise ValueError(f"unknown routing_kernel {cfg.routing_kernel!r}")
    return RankLayout(cfg, aux, rank, nranks)


def pixel_sharding(layout, arr, num_pixels=None, p_pad=None):
    """The index of `layout`'s rank's part of `arr` along its trailing axis:
    its pixels where that axis is the pixel axis (num_pixels, the layout's
    by default), its part of the channel schedule's position space where
    that is the axis (p_pad: a RankLayout's block, a PackedRankLayout's kept
    chunks, a ScanRankLayout's pixels); None (the array is replicated)
    otherwise."""
    if getattr(arr, "ndim", 0) == 0:
        return None
    n = arr.shape[-1]
    if n == (num_pixels or layout.num_pixels):
        return layout.pixels
    if p_pad and n == p_pad:
        return layout.position_index()
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
    """Refuses what the multi-process step does not run across ranks: a
    folded ensemble (every router runs across ranks)."""
    if nranks <= 1:
        return
    if cfg.members != 1:
        raise NotImplementedError("a folded ensemble across ranks is not in the JAX package "
                                  "(ROADMAP.md)")


@dataclasses.dataclass
class GridPixels:
    """The whole grid's pixel rows and columns and the groundwater
    smoothing's parameters (`params`), with the pixel space of one rank: a
    rank's step (models/step.Step.smooth_lz) runs
    ops/indicators.groundwater_smooth on the gathered LZ with the whole
    grid's sums, in the one-process order, and keeps the rank's pixels."""

    rows: torch.Tensor
    cols: torch.Tensor
    params: dict
    space: RankSpace


def rank_params(cfg, params_np, layout, group, device, dtype):
    """The rank's natural parameters on its device: its pixels of every
    per-pixel array, the structure indices as RankIndex, the evaporation
    grid whole, the rest replicated (the types as models/step.device_params
    gives them). Returns (params, the natural RankSpace, and with
    groundwater smoothing the whole grid's GridPixels, else None)."""
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
    grid = None
    if cfg.groundwater_smooth:
        whole = to_device({k: params_np[k] for k in ("LandRows", "LandCols", "GroundwaterBodies",
                                                     "GroundwaterCatch")}, device, dtype)
        whole["LZSmoothRangeCells"] = p["LZSmoothRangeCells"]
        grid = GridPixels(whole.pop("LandRows"), whole.pop("LandCols"), whole, nat)
    return p, nat, grid


def _kinp_to_device(kinp, device, dtype):
    """Position-space parameters on the device: integer tables keep their
    type, bool stays bool, floats take `dtype` (as device_params)."""
    p = {}
    for k, v in kinp.items():
        if v.dtype.kind in "iu":
            p[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
        else:
            p.update(to_device({k: v}, device, dtype))
    return p


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
        its device; the entries split by pixel are remembered for gather.
        With the packed router the routing entries are packed over the
        whole schedule and cut to the rank's kept chunks (its halo's state
        with them); a whole packed state (pk$ entries) is cut as it is."""
        state = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in state.items()}
        layout = self.layout
        if isinstance(layout, PackedRankLayout):
            ps, glob = layout.ps["kin"], layout.position_index()
            pk = set(packed_routing_keys(self.cfg))
            self.pixel_keys = {k[3:] if k.startswith("pk$") else k for k, v in state.items()
                               if k.startswith("pk$") or pixel_sharding(layout, v) is not None}
            local = {}
            for k, v in state.items():
                if k.startswith("pk$"):
                    local[k] = np.ascontiguousarray(np.asarray(v)[..., glob])
                elif k in pk:
                    local["pk$" + k] = np.ascontiguousarray(ps.pack_np(v)[..., glob])
                else:
                    local.update(shard_tree(layout, {k: v}))
            return self.step.prepare_state(local, dtype)
        self.pixel_keys = {k for k, v in state.items()
                           if pixel_sharding(layout, v) is not None}
        return self.step.prepare_state(shard_tree(layout, state), dtype)

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
    raising without a card). The whole model's tables are built on the
    host and the rank's part of each moved to its device:

    - RoutingKernel sharded (a RankLayout): the channel schedule's
      position-space parameters (models/step.packed_routing_params) of the
      rank's block, its routers (RankRouter, with K6's tables of its own
      positions and halo);
    - RoutingKernel packed (a PackedRankLayout): the sub-step kernel's
      parameters of its kept chunks (rank_kinp) and its routers
      (RankPackedRouter: the channel's on its kept chunks, the overland's
      with K5's tables of its kept chunks);
    - RoutingKernel scan (a ScanRankLayout): the natural position space's
      parameters (packed_routing_params of the NaturalSchedule) of its
      pixels, its routers (ops/kinwave.RankScanRouter, with K6's tables of
      its own pixels and halo);

    then the segment orders of the whole model (RankOrder; the sequential
    loop's in-loop catchment totals over the sharded schedule's or the
    natural space) and the step on them; the step's config counts the
    rank's pixels."""
    device = rank_device(device, layout.rank)
    check_ranks(cfg, layout.nranks)
    kind = cfg.routing_kernel
    if type(layout) is not LAYOUTS.get(kind):
        raise ValueError(f"RoutingKernel {kind} on a {type(layout).__name__}")
    t0 = time.perf_counter()
    p, nat, grid = rank_params(cfg, params_np, layout, group, device, dtype)
    if kind == "packed":
        p.update(_kinp_to_device(layout.kinp_local, device, dtype))
        feeders_earlier, eva_window_ok = layout.feeders_earlier, layout.eva_window_ok
        position_catchments = None
    else:
        ps = layout.sched["kin"] if kind == "sharded" else natural_schedule(layout.sched["kin"])
        kinp, feeders_earlier, _ = packed_routing_params(cfg, params_np, ps)
        eva_window_ok = False
        for k, v in kinp.items():
            if k in POSITION_INDEX:
                p[k] = RankIndex(v, layout.positions, layout.rank, group, device)
            else:
                p.update(_kinp_to_device(shard_tree(layout, {k: v}, num_pixels=-1,
                                                    p_pad=ps.p_pad), device, dtype))
        position_catchments = kinp.get("kinp$Catchments")
    t1 = time.perf_counter()
    eva_in_kernel = cfg.open_water_evapo and not cfg.init_lisflood and eva_window_ok
    orders = segment_orders(cfg, params_np, device, position_catchments, not eva_in_kernel)
    pos = RankSpace(layout.positions, layout.rank, group, device) if kind == "sharded" else nat
    p.update({k: RankOrder(v, pos if k == "seg$kinp$Catchments" else nat)
              for k, v in orders.items()})
    t2 = time.perf_counter()
    routers = {}
    for key in ("kin", "tochan"):
        if kind == "packed":
            r = RankPackedRouter(layout.local[key], layout.router_part(key), group, device)
        elif kind == "scan":
            r = RankScanRouter(layout.sched[key], layout.part(key), group, device)
        else:
            r = RankRouter(layout.sched[key], layout.part(key), layout.owned, group, device)
        if not r.no_edges and (key == "tochan" or kind != "packed"):
            r.sweep_tiles()
        routers[key] = r
    routers["kin"].struct_feeders_earlier = feeders_earlier
    routers["kin"].eva_window_ok = eva_window_ok
    t3 = time.perf_counter()
    cfg_r = dataclasses.replace(cfg, num_pixels=int(layout.pixels.size),
                                eva_stencil=bool(cfg.use_eva_stencil(device)))
    seconds = dict(layout.seconds, params=t1 - t0, orders=t2 - t1, routers=t3 - t2)
    return RankStep(Step(cfg_r, p, routers, device, grid), layout, group, seconds)


# ---------------------------------------------------------------------------
# the JAX package's entry points


def shard_runner_step(runner, group=None):
    """The step of a models/driver.LisfloodRunner (any RoutingKernel) for
    this process's rank of `group` (the world by default):
    returns (step, state), the RankStep on the runner's device and dtype and
    the rank's part of the runner's state."""
    rank, nranks = world(group)
    check_ranks(runner.config, nranks)
    layout = rank_layout(runner.config, runner.params_np, runner.aux, rank, nranks)
    step = rank_step(runner.config, runner.params_np, runner.aux, layout, group, runner.dtype,
                     runner.device)
    return step, step.prepare_state(runner.step.natural_state(runner.state))


def build_sharded_model_step(group=None, nrows=16, ncols=16, dtype=torch.float32,
                             routing_kernel="sharded", num_shards=None, device=None,
                             **synth_kwargs):
    """The synthetic model's step for this process's rank of `group`:
    returns (step, state, forcing, cfg), the rank's state and forcing on its
    device. `num_shards` defaults to the number of ranks (the packed and
    the scan router's layouts take it as their logical shard count)."""
    from ..models.synthetic import build_synthetic_model, synthetic_forcing
    rank, nranks = world(group)
    cfg, params, state, aux = build_synthetic_model(nrows, ncols, **synth_kwargs)
    cfg = dataclasses.replace(cfg, routing_kernel=routing_kernel,
                              num_shards=num_shards or nranks)
    check_ranks(cfg, nranks)
    layout = rank_layout(cfg, params, aux, rank, nranks)
    step = rank_step(cfg, params, aux, layout, group, dtype, device)
    return (step, step.prepare_state(state, dtype),
            step.shard_forcing(synthetic_forcing(cfg.num_pixels), dtype), cfg)
