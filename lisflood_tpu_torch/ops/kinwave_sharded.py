"""Shard-local packed kinematic-wave sweep — the port of
lisflood_tpu/ops/kinwave_sharded.py.

Pixels are partitioned into S shards along subtree boundaries
(parallel/partition.py) and renumbered into (shard, chunk, lane) positions,
shard-major: pos = s * n_chunks * C + c * C + l, p_pad = S * n_chunks * C.
The chunks close in GLOBAL topological lockstep (a chunk closes for all
shards at once), so every edge, within a shard or cut between two, targets
a strictly later chunk, and one sweep over the chunks in order routes every
pixel after all of its sources.

The JAX package's `_sweep_sharded` (an XLA scan: a one-hot product scatters
each shard's discharge into its window, a dense (L, K) x (K, S*W*C) product
carries the cut edges) is `kinwave_sharded_sweep` here: the CUDA kernel
csrc/kinwave_sharded.cu (K6) on a CUDA device, and its plain PyTorch version
`_sweep_sharded` on the CPU. Both GATHER each position's sources, local and
cut edges alike, from an upstream table (upstream_positions) instead of
scattering into windows. The table lists a pixel's sources by ascending
natural pixel index, so the sum order of a pixel's inflow depends neither on
S nor on how the shards are spread over processes: the sweep gives the same
bits for every shard count. The plain version walks the lockstep chunks in
order; the kernel walks tiles of whole trees level by level (the tables of
`sharded_tables`, built with the router's step, whose slots keep the
table's order), so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..graph.ldd import graph_levels
from ..parallel.collectives import all_gather
from .kinwave_packed import (SWEEP_THREADS, PackedRouter, PackedSchedule, SweepTiles,
                             newton_solve, sweep_fit)
from .wavefront import SWEEP_CAP, sweep_tiles, upstream_table


@dataclass
class ShardedSchedule:
    """Host-side renumbering into (shard, chunk, lane) positions.

    Flat position space is shard-major: pos = s*(n_chunks*C) + c*C + l,
    p_pad = S*n_chunks*C; padding positions map to pixel index P."""

    perm: np.ndarray         # (p_pad,) position -> natural pixel (P = pad)
    inv_perm: np.ndarray     # (P,) natural pixel -> position
    down_local: np.ndarray   # (n_chunks, S, C) int32 window offset; W*C = none
    down_pos: np.ndarray     # (p_pad,) int32 downstream position; p_pad = pit
    cut_src: np.ndarray      # (n_chunks, K) int32 lane in (S*C); S*C = pad
    cut_dst: np.ndarray      # (n_chunks, K) int32 index in (S*W*C); pad slot 0
    n_chunks: int
    n_shards: int
    chunk: int
    window: int
    num_pixels: int

    @property
    def p_pad(self):
        return self.n_shards * self.n_chunks * self.chunk

    pack_np = PackedSchedule.pack_np


def _rank_in_group(keys, n_keys):
    """For each entry, the number of earlier entries with the same key."""
    order = np.argsort(keys, kind="stable")
    start = np.zeros(n_keys + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_keys), out=start[1:])
    rank = np.empty(keys.size, np.int64)
    rank[order] = np.arange(keys.size) - start[keys[order]]
    return rank


def build_sharded_schedule(graph, shard_of, chunk_size=256) -> ShardedSchedule:
    """Chunk the graph in global topological lockstep with per-shard lane
    capacity: iterating headwaters -> outlets (by hop distance to the pit,
    then pixel index), a pixel joins the current chunk unless one of its
    upstreams is already in it or its shard's lanes are full — then the
    chunk closes for ALL shards. The JAX package's arrays, bit for bit.

    The JAX package walks the pixels one by one; here a level (one hop
    distance) is a few array passes: its pixels' upstreams all lie in the
    level before, so only the level's first pixels can meet one in the open
    chunk, and once a chunk closes within the level the next ones close on
    lane capacity alone, at the first shard to reach C lanes."""
    P = graph.num_pixels
    shard_of = np.asarray(shard_of, np.int32)
    S = int(shard_of.max()) + 1
    C = int(chunk_size)
    down = np.asarray(graph.downstream, np.int64)

    chunk_of = np.full(P, -1, np.int64)
    lane_of = np.full(P, -1, np.int64)
    counts = np.zeros(S, np.int64)      # lanes of each shard in the open chunk
    nc = 0                              # the open chunk
    prev = np.zeros(0, np.int64)
    mark = np.zeros(P, bool)
    for lv in reversed(graph_levels(down)):
        sh = shard_of[lv].astype(np.int64)
        occ = _rank_in_group(sh, S)
        tails = down[prev[chunk_of[prev] == nc]]
        mark[tails] = True
        conflict = mark[lv]
        mark[tails] = False
        stop = np.flatnonzero(conflict | (counts[sh] + occ >= C))
        a = int(stop[0]) if stop.size else lv.size
        chunk_of[lv[:a]] = nc
        lane_of[lv[:a]] = counts[sh[:a]] + occ[:a]
        counts += np.bincount(sh[:a], minlength=S)
        if a < lv.size:
            where = [np.flatnonzero(sh == s) for s in range(S)]
            while a < lv.size:
                nc += 1
                base = np.array([np.searchsorted(w, a) for w in where])
                ends = [w[b + C] for w, b in zip(where, base) if b + C < w.size]
                end = int(min(ends)) if ends else lv.size
                chunk_of[lv[a:end]] = nc
                lane_of[lv[a:end]] = occ[a:end] - base[sh[a:end]]
                counts = np.bincount(sh[a:end], minlength=S)
                a = end
        prev = lv
    n_chunks = nc + 1 if P else 0

    # perm / inv_perm (shard-major flat layout)
    B = n_chunks * C
    p_pad = S * B
    perm = np.full(p_pad, P, np.int64)
    pos = shard_of.astype(np.int64) * B + chunk_of * C + lane_of
    perm[pos] = np.arange(P)
    inv_perm = pos

    # edges (a dependency-free graph, e.g. the synthetic model's all-pit
    # overland graph, has none; the router then solves elementwise)
    src_valid = np.flatnonzero(down >= 0)
    dst = down[src_valid]
    if src_valid.size:
        delta = chunk_of[dst] - chunk_of[src_valid]
        if delta.min() < 1:
            raise ValueError("sharded schedule: a downstream pixel is not in a later chunk")
        W = int(max(1, delta.max()))
    else:
        W = 1

    down_local = np.full((n_chunks, S, C), W * C, np.int32)
    down_pos = np.full(p_pad, p_pad, np.int32)
    same = shard_of[src_valid] == shard_of[dst]
    ls, ld = src_valid[same], dst[same]
    down_local[chunk_of[ls], shard_of[ls], lane_of[ls]] = (
        (chunk_of[ld] - chunk_of[ls] - 1) * C + lane_of[ld]).astype(np.int32)
    down_pos[pos[src_valid]] = pos[dst].astype(np.int32)

    # cut edges, grouped by source chunk in source pixel order
    cs, cd = src_valid[~same], dst[~same]
    K = int(np.bincount(chunk_of[cs]).max()) if cs.size else 0
    cut_src = np.full((n_chunks, max(K, 1)), S * C, np.int32)
    cut_dst = np.zeros((n_chunks, max(K, 1)), np.int32)
    if cs.size:
        c = chunk_of[cs]
        j = _rank_in_group(c, n_chunks)
        cut_src[c, j] = shard_of[cs].astype(np.int64) * C + lane_of[cs]
        cut_dst[c, j] = (shard_of[cd].astype(np.int64) * (W * C)
                         + (chunk_of[cd] - c - 1) * C + lane_of[cd])
    return ShardedSchedule(perm=perm, inv_perm=inv_perm, down_local=down_local,
                           down_pos=down_pos, cut_src=cut_src, cut_dst=cut_dst,
                           n_chunks=n_chunks, n_shards=S, chunk=C, window=W,
                           num_pixels=P)


def replicate_sharded_schedule(ps, M):
    """The sharded schedule of M copies of `ps`'s graph, copy m on pixels
    [m P, (m+1) P) (models/ensemble.py): shard s of copy m is shard m S + s,
    with the single schedule's chunks, lanes and window, so copy m holds the
    positions [m p_pad, (m+1) p_pad) in the single schedule's order. Every
    edge stays within its copy and keeps its chunks; a chunk's cut edges are
    listed copy by copy, each copy's in its own order (ascending pixel, as
    build_sharded_schedule lists them). The copies are not partitioned anew:
    catchment_partition packs by size, and M copies would get other shards,
    other positions and other cut edges than the single model's."""
    P, S, C, W = ps.num_pixels, ps.n_shards, ps.chunk, ps.window
    p_pad = ps.p_pad
    m = np.arange(M, dtype=np.int64)[:, None]
    perm = np.where(ps.perm[None] < P, ps.perm[None] + m * P, M * P).reshape(-1)
    inv_perm = (np.asarray(ps.inv_perm, np.int64)[None] + m * p_pad).reshape(-1)
    down = ps.down_pos.astype(np.int64)[None]
    down_pos = np.where(down < p_pad, down + m * p_pad, M * p_pad).reshape(-1).astype(np.int32)
    # cut edges (n_chunks, K) of each copy, offset into its shards, then
    # the valid ones of a chunk first, in copy order
    src = ps.cut_src.astype(np.int64)[:, None]                       # (n, 1, K)
    valid = np.broadcast_to(src < S * C, (ps.n_chunks, M, src.shape[2]))
    off = np.arange(M, dtype=np.int64)[None, :, None]
    cut_src = np.where(valid, src + off * S * C, M * S * C).reshape(ps.n_chunks, -1)
    cut_dst = np.where(valid, ps.cut_dst.astype(np.int64)[:, None] + off * S * W * C,
                       0).reshape(ps.n_chunks, -1)
    order = np.argsort(~valid.reshape(ps.n_chunks, -1), axis=1, kind="stable")
    K = max(int(valid.sum(axis=(1, 2)).max(initial=0)), 1)
    cut_src = np.take_along_axis(cut_src, order, 1)[:, :K].astype(np.int32)
    cut_dst = np.take_along_axis(cut_dst, order, 1)[:, :K].astype(np.int32)
    return ShardedSchedule(perm=perm, inv_perm=inv_perm,
                           down_local=np.tile(ps.down_local, (1, M, 1)), down_pos=down_pos,
                           cut_src=cut_src, cut_dst=cut_dst, n_chunks=ps.n_chunks,
                           n_shards=M * S, chunk=C, window=W, num_pixels=M * P)


def upstream_positions(ps):
    """(K, p_pad) int32: the source positions of every position, -1 where
    there are fewer than K, each position's sources in ascending order of
    their natural pixel index (so the same for every partition)."""
    P, p_pad = ps.num_pixels, ps.p_pad
    has_down = ps.down_pos < p_pad
    nat = upstream_table(ps.perm[has_down], ps.perm[ps.down_pos[has_down]], P).astype(np.int64)
    real = ps.perm < P
    table = np.full((nat.shape[0], p_pad), -1, np.int32)
    table[:, real] = np.where(nat >= 0, ps.inv_perm[nat], -1)[:, ps.perm[real]]
    return table


# ---------------------------------------------------------------------------
# the sweep: plain version, kernel wrapper


def _chunk_positions(n_chunks, n_shards, chunk, device):
    """(S*C,) int64: the positions of chunk 0, shard by shard; chunk c's are
    these + c*C."""
    B = n_chunks * chunk
    lanes = torch.arange(chunk, device=device)
    return (torch.arange(n_shards, device=device)[:, None] * B + lanes).reshape(-1)


def _sweep_sharded(const_p, adx_p, ups, n_chunks, n_shards, chunk, beta):
    """The plain version of the sweep, one lockstep chunk at a time.

    const_p/adx_p: (L, p_pad) in the schedule's position space; ups:
    (K, p_pad) int64 source positions of every position (upstream_positions),
    -1 = none. Returns q (L, p_pad). Each chunk's S*C positions sum their
    sources' discharges in the table's order (every source lies in an
    earlier chunk), add const and solve."""
    L = const_p.shape[0]
    base = _chunk_positions(n_chunks, n_shards, chunk, const_p.device)
    q = torch.zeros_like(const_p)
    for c in range(n_chunks):
        idx = base + c * chunk
        src = ups[:, idx]                                     # (K, S*C)
        valid = src >= 0
        vals = q[:, src.clamp_min(0)]                         # (L, K, S*C)
        inflow = const_p.new_zeros(L, idx.numel())
        for k in range(src.shape[0]):
            inflow = inflow + torch.where(valid[k], vals[:, k], 0.0)
        q[:, idx] = newton_solve(inflow + const_p[:, idx], adx_p[:, idx], beta)
    return q


@dataclass(frozen=True)
class RingTiles(SweepTiles):
    """K6's tables on one device: the SweepTiles of a graph's positions
    (ops/wavefront.sweep_tiles, positions left out of `keep` solved apart),
    each tile's widest level (`width`; `widths` and `levels` on the host),
    each entry's ring record (`ring`: its position and its sources' offsets
    into the level below) and the positions left out `pad`. A subclass
    gives the position space's size `p_pad` and the plain version
    (`reference`), which reads `ups` and its own geometry."""

    width: torch.Tensor
    ring: torch.Tensor
    pad: torch.Tensor
    widths: np.ndarray
    levels: np.ndarray

    @property
    def p_pad(self):
        raise NotImplementedError

    def reference(self, const_p, adx_p, beta):
        raise NotImplementedError


@dataclass(frozen=True)
class ShardedTiles(RingTiles):
    """K6's tables of a sharded schedule: its real positions tiled, the
    padding in `pad`, and the schedule's geometry, which the plain version
    `_sweep_sharded` reads."""

    n_chunks: int
    n_shards: int
    chunk: int

    @property
    def p_pad(self):
        return self.n_shards * self.n_chunks * self.chunk

    def reference(self, const_p, adx_p, beta):
        return _sweep_sharded(const_p, adx_p, self.ups.long(), self.n_chunks, self.n_shards,
                              self.chunk, beta)


def ring_tables(cls, down_pos, ups, p_pad, cap=SWEEP_CAP, keep=None, **fields):
    """A RingTiles subclass `cls` (with its own `fields`) of the graph given
    by each position's downstream position `down_pos` (p_pad = none) and its
    source table `ups` (K, p_pad) int32, on ups's device, tiles of at most
    `cap` positions, the positions outside `keep` in `pad`; `stats` holds
    the host seconds of the build."""
    t0 = time.perf_counter()
    device = ups.device
    tab = sweep_tiles(down_pos, ups.cpu().numpy(), p_pad, cap, keep=keep, ring=True)
    lvl_ptr = tab["lvl_ptr"].astype(np.int64)
    dev = lambda k: torch.as_tensor(tab[k], device=device)
    stats = {k: tab[k] for k in ("trees", "largest_tree", "levels", "largest_tile")}
    stats["seconds"] = time.perf_counter() - t0
    return cls(ups=ups, tile_ptr=dev("tile_ptr"), pos=dev("pos"), slots=dev("slots"),
               lvl_ptr=dev("lvl_ptr"), lvl_off=dev("lvl_off"), cap=int(cap),
               count=tab["lvl_off"][lvl_ptr[1:] - 1].astype(np.int64),
               padded=np.diff(tab["tile_ptr"].astype(np.int64)), stats=stats,
               width=dev("width"), ring=dev("ring"), pad=dev("pad"),
               widths=tab["width"].astype(np.int64), levels=np.diff(lvl_ptr) - 1, **fields)


def sharded_tables(ps, ups, cap=SWEEP_CAP):
    """ShardedTiles of the sharded schedule `ps` from its source table `ups`
    (K, p_pad) int32 (upstream_positions), on ups's device, tiles of at most
    `cap` positions; `stats` holds the host seconds of the build."""
    return ring_tables(ShardedTiles, ps.down_pos, ups, ps.p_pad, cap,
                       keep=ps.perm < ps.num_pixels, n_chunks=ps.n_chunks,
                       n_shards=ps.n_shards, chunk=ps.chunk)


# the ring path's copy slots (csrc/kinwave_sharded.cu: kGatherSlots operand
# slots of const and adx, kTableSlots slots of the entries' ring records),
# and the ring's width rounded up to a multiple of RING_ALIGN
GATHER_SLOTS, TABLE_SLOTS = 4, 7
RING_ALIGN = 8
# threads of a ring tile's block that copy ahead while the others run its
# levels (at least; the block's threads beyond those that run a level copy)
RING_COPY_THREADS = 128
# padding positions a thread of the padding blocks solves: short blocks leave
# a short tail after the tiles
PAD_PER_THREAD = 1


def ring_bytes(L, K, itemsize, ring_w, ring_levels):
    """Shared bytes of the ring path (as smem_bytes in
    csrc/kinwave_sharded.cu): the ring of two levels' q and the operand
    slots, L lanes each, the record slots (a position and K offsets, rounded
    up to a multiple of 4 int32), and the tile's level offsets."""
    rec = 4 * -(-(K + 1) // 4)
    return ((2 + 2 * GATHER_SLOTS) * L * ring_w * itemsize
            + TABLE_SLOTS * rec * ring_w * 4 + 4 * (ring_levels + 1))


def sharded_plan(tiles, optin, static_bytes, L, itemsize):
    """How a launch runs each tile, from the shared memory a block can have
    (`optin` bytes, less the kernel's `static_bytes`): n_smem, the padded
    entries up to which a tile runs in shared memory (its q and tables,
    kinwave_packed.sweep_fit); for the others, the ring's width (the widest
    level, rounded up to RING_ALIGN, of the tiles whose ring fits) and its
    levels (the most of a tile whose ring fits at that width); a tile that
    fits neither reads q back from global memory. A ring tile's levels run
    on ring_threads threads, one a (lane, entry) pair of its widest level
    (at most 1024 - RING_COPY_THREADS), and the block's other threads, at
    least RING_COPY_THREADS, copy ahead; the block has SWEEP_THREADS threads
    or as many as that takes. Padding blocks of PAD_PER_THREAD positions a
    thread. Returns a dict with the counts of ring and global tiles."""
    K = tiles.ups.shape[0]
    budget = optin - static_bytes
    n_smem = tiles.n_smem(sweep_fit(optin, static_bytes, L, K, itemsize))
    rest = tiles.padded > n_smem
    w8 = -(-tiles.widths // RING_ALIGN) * RING_ALIGN
    fits = rest & (ring_bytes(L, K, itemsize, w8, tiles.levels) <= budget)
    ring_w = int(w8[fits].max()) if fits.any() else 0
    fits &= ring_bytes(L, K, itemsize, ring_w, tiles.levels) <= budget
    ring_levels = int(tiles.levels[fits].max()) if fits.any() else 0
    ring = rest & (tiles.widths <= ring_w) & (tiles.levels <= ring_levels)
    threads, ring_threads = SWEEP_THREADS, 0
    if ring.any():
        ring_threads = min(-(-L * ring_w // 32) * 32, 1024 - RING_COPY_THREADS)
        threads = max(threads, ring_threads + RING_COPY_THREADS)
    n_pad = tiles.pad.numel()
    return {"n_smem": n_smem, "ring_w": ring_w, "ring_levels": ring_levels, "threads": threads,
            "ring_threads": ring_threads,
            "pad_blocks": -(-n_pad // (threads * PAD_PER_THREAD)), "n_pad": n_pad,
            "ring_tiles": int(ring.sum()), "global_tiles": int((rest & ~ring).sum())}


class _ShardedArgs(ctypes.Structure):
    """Mirror of struct ShardedArgs in csrc/kinwave_sharded.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_tiles", "pad_blocks", "lanes", "K", "p_pad",
                                             "threads", "n_smem", "ring_w", "ring_levels",
                                             "ring_threads", "n_pad")]
                + [("beta", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in ("cst", "adx", "q", "tile_ptr", "pos", "slots",
                                                  "lvl_ptr", "lvl_off", "width", "ring", "pad",
                                                  "trace")])


@functools.cache
def _library():
    from . import _build
    lib = _build.load("kinwave_sharded")
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.kinwave_sharded_smem.argtypes = [ctypes.c_int, int_p, int_p]
    lib.kinwave_sharded_smem.restype = ctypes.c_int
    lib.kinwave_sharded_launch.argtypes = [ctypes.POINTER(_ShardedArgs), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p, int_p]
    lib.kinwave_sharded_launch.restype = ctypes.c_int
    lib.kinwave_sharded_error_string.argtypes = [ctypes.c_int]
    lib.kinwave_sharded_error_string.restype = ctypes.c_char_p
    return lib


def _lib_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"kinwave_sharded {what} failed: "
                           + lib.kinwave_sharded_error_string(rc).decode())


@functools.cache
def _smem(device_index, is_double):
    """(opt-in shared bytes of a block, the kernel's static shared bytes) on
    one device, asked of the library once."""
    lib = _library()
    optin, static = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _lib_check(lib, lib.kinwave_sharded_smem(is_double, ctypes.byref(optin),
                                                 ctypes.byref(static)), "shared memory query")
    return optin.value, static.value


def _launch(const_p, adx_p, tiles, beta, trace=None):
    """One launch of csrc/kinwave_sharded.cu on the current stream, one
    block per tile and the padding blocks. The plan is left in
    `kinwave_sharded_sweep.last_plan`. `trace`, an int64 (blocks, 5) tensor
    on the card, gets each block's record (see sharded_trace)."""
    lib = _library()
    dev = const_p.device
    L = const_p.shape[0]
    is_double = int(const_p.dtype == torch.float64)
    poly = int(const_p.dtype == torch.float32 and abs(float(beta) - 0.6) < 1e-9)
    plan = sharded_plan(tiles, *_smem(dev.index, is_double), L, const_p.element_size())
    q = torch.empty_like(const_p)
    ptr = lambda v: v.data_ptr()
    args = _ShardedArgs(n_tiles=tiles.n_tiles, pad_blocks=plan["pad_blocks"], lanes=L,
                        K=tiles.ups.shape[0], p_pad=const_p.shape[1], threads=plan["threads"],
                        n_smem=plan["n_smem"], ring_w=plan["ring_w"],
                        ring_levels=plan["ring_levels"], ring_threads=plan["ring_threads"],
                        n_pad=plan["n_pad"], beta=float(beta),
                        cst=ptr(const_p), adx=ptr(adx_p), q=ptr(q),
                        **{k: ptr(getattr(tiles, k)) for k in ("tile_ptr", "pos", "slots",
                                                               "lvl_ptr", "lvl_off", "width",
                                                               "ring", "pad")},
                        trace=None if trace is None else ptr(trace))
    smem = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib_check(lib, lib.kinwave_sharded_launch(ctypes.byref(args), is_double, poly,
                                                   ctypes.c_void_p(stream), ctypes.byref(smem)),
                   "launch")
    kinwave_sharded_sweep.launches += 1
    kinwave_sharded_sweep.last_plan = {"tiles": tiles.n_tiles, "cap": tiles.cap,
                                       "smem_bytes": smem.value, **plan}
    return q


def _check(const_p, adx_p, tiles):
    """Device, dtype, shape and contiguity of the sweep's operands and
    tables."""
    p_pad = tiles.p_pad
    if const_p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"const: dtype {const_p.dtype}")
    if const_p.dim() != 2 or const_p.shape[1] != p_pad or not 1 <= const_p.shape[0] <= 8:
        raise ValueError(f"const: shape {tuple(const_p.shape)}, want (1..8, {p_pad})")
    if const_p.numel() >= 2 ** 31:
        raise ValueError(f"const: {const_p.numel()} elements, the kernel indexes with int32")
    if tuple(adx_p.shape) != tuple(const_p.shape) or adx_p.dtype != const_p.dtype:
        raise ValueError(f"adx: {tuple(adx_p.shape)} {adx_p.dtype}, want const's")
    ups = tiles.ups
    if ups.dim() != 2 or ups.shape[1] != p_pad or not 1 <= ups.shape[0] <= 8:
        raise ValueError(f"ups: shape {tuple(ups.shape)}, want (1..8, {p_pad})")
    n_tiles, N, K = tiles.n_tiles, int(tiles.padded.sum()), ups.shape[0]
    want = {"tile_ptr": n_tiles + 1, "lvl_ptr": n_tiles + 1, "pos": N, "slots": K * N,
            "width": n_tiles, "ring": 4 * -(-(K + 1) // 4) * N, "lvl_off": None, "pad": None}
    for name, size in want.items():
        v = getattr(tiles, name)
        if v.dim() != 1 or (size is not None and v.shape[0] != size):
            raise ValueError(f"{name}: shape {tuple(v.shape)}, want ({size},)")
    for name, v in (("const", const_p), ("adx", adx_p), ("ups", ups),
                    *((k, getattr(tiles, k)) for k in want)):
        if v.device != const_p.device or not v.is_contiguous():
            raise ValueError(f"{name}: not contiguous on {const_p.device}")
        if name not in ("const", "adx") and v.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {v.dtype}, want int32")


def kinwave_sharded_sweep(const_p, adx_p, tiles, beta):
    """One kinematic-wave time step over a graph's tiles: const_p / adx_p
    (L, p_pad) in its position space and its RingTiles (sharded_tables for a
    sharded schedule, ops/kinwave.ScanRouter.sweep_tiles for the natural
    one). A CUDA tensor launches the kernel (and counts the launch in
    `kinwave_sharded_sweep.launches`), a CPU tensor runs the tiles' plain
    version (`_sweep_sharded`, `kinwave._sweep_scan`); any other device
    raises. Returns q (L, p_pad)."""
    _check(const_p, adx_p, tiles)
    kind = const_p.device.type
    if kind == "cuda":
        return _launch(const_p, adx_p, tiles, beta)
    if kind == "cpu":
        return tiles.reference(const_p, adx_p, beta)
    raise RuntimeError(f"no sharded sweep kernel for device {kind!r}")


def sharded_trace(const_p, adx_p, tiles, beta):
    """One launch of K6 on CUDA tensors with each block's record, as a NumPy
    (blocks, 5) int64 array, the tiles' blocks first, then the padding
    blocks: the block's SM, the global nanosecond clock at its start and at
    its end, and its SM's cycles from its start to the end of its staging (a
    ring tile: to its first level) and to its end. Returns (q, records). The
    launch is counted as any other."""
    _check(const_p, adx_p, tiles)
    if const_p.device.type != "cuda":
        raise RuntimeError("sharded_trace: the records come from the kernel, on a CUDA device")
    plan = sharded_plan(tiles, *_smem(const_p.device.index, int(const_p.dtype == torch.float64)),
                        const_p.shape[0], const_p.element_size())
    trace = torch.zeros(tiles.n_tiles + plan["pad_blocks"], 5, dtype=torch.int64,
                        device=const_p.device)
    q = _launch(const_p, adx_p, tiles, beta, trace=trace)
    return q, trace.cpu().numpy()


kinwave_sharded_sweep.launches = 0
kinwave_sharded_sweep.last_plan = None


def _edges(ps):
    """Whether the sharded schedule `ps` has no edge at all, and whether it
    has cut edges."""
    pad = ps.n_shards * ps.chunk
    no_edges = bool((ps.down_local == ps.window * ps.chunk).all() and (ps.cut_src == pad).all())
    return no_edges, bool((ps.cut_src != pad).any())


class ShardedRouter:
    """Router over a subcatchment-sharded schedule, with the interface of
    ops/kinwave_packed.PackedRouter (pack / unpack / route_packed /
    route_batched / route and the position space `ps`). An edge-free graph
    solves elementwise."""

    def __init__(self, schedule_or_graph, shard_of=None, chunk_size=256, device=None):
        if isinstance(schedule_or_graph, ShardedSchedule):
            ps = schedule_or_graph
        else:
            ps = build_sharded_schedule(schedule_or_graph, shard_of, chunk_size)
        self.ps = ps
        self.device = resolve_device(device)
        self.no_edges, self.has_cuts = _edges(ps)
        self.perm = torch.as_tensor(np.where(ps.perm < ps.num_pixels, ps.perm, ps.num_pixels),
                                    device=self.device)
        self.inv_perm = torch.as_tensor(ps.inv_perm, device=self.device)
        self.ups = torch.as_tensor(upstream_positions(ps), device=self.device)
        self._tiles = {}

    def sweep_tiles(self, cap=SWEEP_CAP):
        """K6's ShardedTiles at `cap`, built at first use, once per cap
        (models/step.build_routers builds them with the step)."""
        if cap not in self._tiles:
            self._tiles[cap] = sharded_tables(self.ps, self.ups, cap)
        return self._tiles[cap]

    pack = PackedRouter.pack
    unpack = PackedRouter.unpack

    def sweep(self, constant, a_dx_div_dt, beta):
        """The sweep on packed (L, p_pad) operands."""
        adx = a_dx_div_dt.expand_as(constant).contiguous()
        return kinwave_sharded_sweep(constant.contiguous(), adx, self.sweep_tiles(), float(beta))

    def sweep_operands(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) natural-order lanes -> the sweep's packed (const, adx)."""
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        return self.pack(constant), self.pack(a_dx_div_dt.expand_as(constant), 1.0)

    def route_packed(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, p_pad) packed operands -> (L, p_pad) routed discharge."""
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        if self.no_edges:
            return newton_solve(constant, a_dx_div_dt, float(beta))
        return self.sweep(constant, a_dx_div_dt, beta)

    def route_batched(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) natural-order operands -> (L, P) routed discharge."""
        if self.no_edges:
            constant = a_dx_div_dt * discharge ** beta + lateral_inflow
            return newton_solve(constant, a_dx_div_dt, float(beta))
        return self.unpack(self.sweep(*self.sweep_operands(discharge, lateral_inflow,
                                                           a_dx_div_dt, beta), beta))

    def route(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """Single-lane convenience wrapper."""
        return self.route_batched(discharge[None], lateral_inflow[None],
                                  a_dx_div_dt[None], beta)[0]


# ---------------------------------------------------------------------------
# one rank's part of the sweep (parallel/shard_model.py): its own positions
# and its upstream halo


@dataclass(frozen=True)
class RankTiles(RingTiles):
    """K6's tables of one rank's local graph: its block of the sharded
    schedule's positions, then its halo (the positions of other ranks
    upstream of them), `glob` (n_loc,) their positions in the schedule. The
    plain version places the local operands at those positions of the whole
    schedule (const 0 and adx 1 elsewhere), runs `_sweep_sharded` on the
    schedule's source table `full_ups` and reads the local positions back:
    what the one-process sweep gives there whenever the halo holds every
    position upstream of the rank's own."""

    glob: torch.Tensor
    full_ups: torch.Tensor
    n_chunks: int
    n_shards: int
    chunk: int

    @property
    def p_pad(self):
        return self.glob.numel()

    def reference(self, const_p, adx_p, beta):
        L, n = const_p.shape[0], self.n_shards * self.n_chunks * self.chunk
        full_c = const_p.new_zeros(L, n).index_copy_(1, self.glob, const_p)
        full_a = adx_p.new_ones(L, n).index_copy_(1, self.glob, adx_p)
        q = _sweep_sharded(full_c, full_a, self.full_ups.long(), self.n_chunks, self.n_shards,
                           self.chunk, beta)
        return q.index_select(1, self.glob)


def rank_tables(ps, ups_np, full_ups, glob, cap=SWEEP_CAP):
    """RankTiles of the positions `glob` (the rank's block, then its halo,
    closed upstream) of the sharded schedule `ps` with source table `ups_np`
    (K, p_pad) (upstream_positions; `full_ups` the same on the device):
    local downstream positions (none where the downstream lies outside
    `glob`) and local sources, in the table's order; the padding positions
    solved apart."""
    n = glob.size
    loc_of = np.full(ps.p_pad + 1, -1, np.int64)
    loc_of[glob] = np.arange(n)
    down = loc_of[ps.down_pos[glob]]
    down_loc = np.where(down >= 0, down, n).astype(np.int32)
    src = ups_np[:, glob].astype(np.int64)
    ups_loc = np.where(src >= 0, loc_of[np.where(src >= 0, src, ps.p_pad)], -1)
    if ((src >= 0) & (ups_loc < 0)).any():
        raise ValueError("rank_tables: a source of a local position lies outside them")
    device = full_ups.device
    ups_loc = torch.as_tensor(np.ascontiguousarray(ups_loc, np.int32), device=device)
    return ring_tables(RankTiles, down_loc, ups_loc, n, cap, keep=ps.perm[glob] < ps.num_pixels,
                       glob=torch.as_tensor(glob, device=device), full_ups=full_ups,
                       n_chunks=ps.n_chunks, n_shards=ps.n_shards, chunk=ps.chunk)


class RankRouter(ShardedRouter):
    """One rank's ShardedRouter (parallel/shard_model.RankLayout): its
    operands are (L, hi - lo) over its block [lo, hi) of the schedule's
    positions, and pack / unpack map its own natural pixels (`nat_local`,
    each pixel's index among its rank's, ascending) to that block. Before
    each sweep the operands (const, adx) of its halo come from their owners,
    one all_gather of every rank's `send` positions (padded to `send_max`),
    when any rank has a halo; K6 then runs on the rank's own tables
    (RankTiles) and the rank keeps its block. No value crosses ranks inside
    a launch."""

    def __init__(self, ps, part, nat_local, group, device):
        self.ps = ps
        self.device = torch.device(device)
        self.group = group
        self.no_edges, self.has_cuts = _edges(ps)
        self.lo, self.hi = part["lo"], part["hi"]
        self.halo = part["halo"]
        self.exchange = part["exchange"]
        self.send_max = part["send_max"]
        P, n_own = ps.num_pixels, int((nat_local >= 0).sum())
        block = ps.perm[self.lo:self.hi]
        self.perm = torch.as_tensor(np.where(block < P, nat_local[np.minimum(block, P - 1)], n_own),
                                    device=self.device)
        own = np.flatnonzero(nat_local >= 0)
        self.inv_perm = torch.as_tensor(ps.inv_perm[own] - self.lo, device=self.device)
        self.send = torch.as_tensor(part["send"] - self.lo, device=self.device)
        self.halo_src = torch.as_tensor(part["halo_src"], device=self.device)
        self._ups = None
        self._tiles = {}

    def sweep_tiles(self, cap=SWEEP_CAP):
        """K6's RankTiles at `cap`, built at first use, once per cap."""
        if cap not in self._tiles:
            if self._ups is None:
                ups = upstream_positions(self.ps)
                self._ups = (ups, torch.as_tensor(ups, device=self.device))
            glob = np.r_[np.arange(self.lo, self.hi), self.halo]
            self._tiles[cap] = rank_tables(self.ps, *self._ups, glob, cap)
        return self._tiles[cap]

    def with_halo(self, const_p, adx_p):
        """The rank's own (L, n_own) operands -> the local graph's (L,
        n_loc): its own, then its halo's from their owners (one
        all_gather)."""
        if not self.exchange:
            return const_p, adx_p
        L = const_p.shape[0]
        both = torch.cat([const_p, adx_p])
        buf = both.new_zeros(2 * L, self.send_max)
        buf[:, :self.send.numel()] = both.index_select(1, self.send)
        got = all_gather(buf, self.group).transpose(0, 1).reshape(2 * L, -1)
        halo = got.index_select(1, self.halo_src)
        return (torch.cat([const_p, halo[:L]], 1).contiguous(),
                torch.cat([adx_p, halo[L:]], 1).contiguous())

    def sweep(self, constant, a_dx_div_dt, beta):
        """The sweep on the rank's (L, hi - lo) operands: K6 on its tables."""
        adx = a_dx_div_dt.expand_as(constant).contiguous()
        const_l, adx_l = self.with_halo(constant.contiguous(), adx)
        q = kinwave_sharded_sweep(const_l, adx_l, self.sweep_tiles(), float(beta))
        return q[:, :self.hi - self.lo]
