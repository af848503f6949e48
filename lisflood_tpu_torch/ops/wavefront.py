"""Host-built tables of the port's kernels (csrc/kinwave_substep.cu,
csrc/kinwave_sweep.cu and csrc/kinwave_sharded.cu): the upstream sources of
every schedule position in the order the kernels sum them; the per-chunk
lists of the flag protocol through which the sub-step kernel's persistent
blocks meet; and the tiles of whole trees of the two sweeps."""
from __future__ import annotations

import numpy as np

# feeder slots per lake or reservoir; chunk-size bound of a feeder entry's
# lane field
FEEDERS = 8
MAX_CHUNK = 512


def upstream_table(src_pos, tgt_pos, p_pad):
    """(K, p_pad) int32: the source positions of every target position, in
    ascending order, -1 where there are fewer than K. The kernels and their
    plain versions sum upstream inflow in this order."""
    src_pos = np.asarray(src_pos, np.int64)
    tgt_pos = np.asarray(tgt_pos, np.int64)
    if src_pos.size == 0:
        return np.full((1, p_pad), -1, np.int32)
    order = np.lexsort((src_pos, tgt_pos))
    s, t = src_pos[order], tgt_pos[order]
    first = np.r_[0, np.flatnonzero(np.diff(t)) + 1]
    counts = np.diff(np.r_[first, t.size])
    rank = np.arange(t.size) - np.repeat(first, counts)
    table = np.full((int(counts.max()), p_pad), -1, np.int32)
    table[rank, t] = s
    return table


WAVEFRONT_TABLES = ("wf_deps", "wf_own_ptr", "wf_own_list", "wf_feed_ptr", "wf_feed_ent",
                    "wf_sdep_ptr", "wf_sdep_list", "wf_fee_ord")


def _csr(n, keys, values):
    """(n + 1 offsets, values sorted by key) as int32, the list never empty."""
    keys = np.asarray(keys, np.int64)
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    vals = np.asarray(values, np.int64)[order]
    return ptr.astype(np.int32), (vals if vals.size else np.zeros(1, np.int64)).astype(np.int32)


def wavefront_tables(n_chunks, C, W, ups, ev_ups=None, lk_pos=None, lk_fee=None,
                     rs_pos=None, rs_fee=None):
    """The per-chunk tables of the kernel's dependency protocol, as int32
    NumPy arrays, from the upstream tables `ups` / `ev_ups` (K, p_pad) and the
    structures' positions (N,) and feeder positions (N, 8), -1 = none.
    Structures are numbered lakes first.

      wf_deps (n_chunks, D): the chunks that chunk c gathers from over the
          routing and the evaporation graph, ascending, -1 padded; all lie
          in c-W..c-1;
      wf_own_ptr, wf_own_list: per chunk (offsets into the list) the
          structures on its lanes;
      wf_feed_ptr, wf_feed_ent: per chunk its feeder entries, slot * 512 +
          lane with slot = structure * 8 + feeder;
      wf_sdep_ptr, wf_sdep_list: per chunk the feeder chunks of the structures
          it owns; all are earlier chunks;
      wf_fee_ord (N, 8): each structure's feeders ordered by (chunk, feeder),
          -1 padded: the order in which the owner sums them.

    Raises ValueError where a source lies outside the window or a feeder does
    not lie in an earlier chunk than its structure."""
    pairs = []
    for table in (ups, ev_ups):
        if table is None:
            continue
        table = np.asarray(table, np.int64)
        tgt = np.broadcast_to(np.arange(table.shape[1]) // C, table.shape)
        on = table >= 0
        pairs.append(np.unique(tgt[on] * n_chunks + table[on] // C))
    pairs = np.unique(np.concatenate(pairs)) if pairs else np.zeros(0, np.int64)
    tgt, src = pairs // n_chunks, pairs % n_chunks
    if ((src >= tgt) | (src < tgt - W)).any():
        raise ValueError("an upstream source lies outside the schedule window")
    first = np.searchsorted(tgt, tgt)
    deps = np.full((n_chunks, max(int((np.arange(tgt.size) - first).max(initial=0)) + 1, 1)),
                   -1, np.int32)
    deps[tgt, np.arange(tgt.size) - first] = src

    pos = np.concatenate([np.asarray(v, np.int64).reshape(-1)
                          for v in (lk_pos, rs_pos) if v is not None] or [np.zeros(0, np.int64)])
    fee = np.concatenate([np.asarray(v, np.int64).reshape(-1, FEEDERS)
                          for v in (lk_fee, rs_fee) if v is not None]
                         or [np.zeros((0, FEEDERS), np.int64)])
    sg, f = np.nonzero(fee >= 0)
    fp = fee[sg, f]
    if (fp // C >= pos[sg] // C).any():
        raise ValueError("a structure's feeder does not lie in an earlier chunk")
    out = {"wf_deps": deps}
    out["wf_own_ptr"], out["wf_own_list"] = _csr(n_chunks, pos // C, np.arange(pos.size))
    out["wf_feed_ptr"], out["wf_feed_ent"] = _csr(n_chunks, fp // C,
                                                  (sg * FEEDERS + f) * MAX_CHUNK + fp % C)
    sdep = np.unique((pos[sg] // C) * n_chunks + fp // C)
    out["wf_sdep_ptr"], out["wf_sdep_list"] = _csr(n_chunks, sdep // n_chunks, sdep % n_chunks)
    key = np.where(fee >= 0, (fee // C) * FEEDERS + np.arange(FEEDERS), np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    out["wf_fee_ord"] = np.where(np.take_along_axis(fee, order, 1) >= 0, order, -1).astype(np.int32)
    if not pos.size:
        out["wf_fee_ord"] = np.full((1, FEEDERS), -1, np.int32)
    return out


# the overland sweep's tile size: positions of whole trees per block
# (csrc/kinwave_sweep.cu); 1024 was the fastest of 256-4096 on an H100 at the
# 1200x1000 overland graph (chip_smoke.py phase 8)
SWEEP_CAP = 1024
# entries of a tile's tables are padded to a multiple of this, so that every
# tile's tables start on a 16-byte boundary (the kernel's cp.async copies)
TILE_ALIGN = 8


def sweep_tiles(down_pos, ups, p_pad, cap=SWEEP_CAP, keep=None, ring=False):
    """The tile tables of the tree-tiled sweeps (csrc/kinwave_sweep.cu,
    csrc/kinwave_sharded.cu), as NumPy arrays, from the downstream position
    of every schedule position (p_pad = none) and its source table `ups`
    (K, p_pad) (ascending, or any fixed order: the slots keep it).

    `keep` (p_pad,) bool, all by default, names the positions to tile; the
    others, which must have no edge (a sharded schedule's padding), lie in
    no tile and are listed in `pad`. Every tiled position belongs to one
    tree, rooted at the position that has no downstream; a tiled position
    with no edge (the packed schedule's padding) is a single-cell tree.
    Tiles hold whole trees, up to `cap` positions; a tree larger than `cap`
    has a tile of its own. Trees are packed by depth class (ceil(log2(depth
    + 1)), deepest first), in the order of their roots' positions within a
    class: a tile runs as many
    levels as its deepest tree, so trees of like depth share tiles, while
    root order keeps a tile's positions close together. A position's level
    in its tile is the tile's greatest depth less its own depth below its
    root, so every source lies in the level just below its target, and a
    level is one band of equal distance to the pits, which a schedule
    ordered by that distance (graph/ldd.build_schedule) keeps contiguous.
    Per tile, its entries are sorted by (level, position) and padded to a
    multiple of TILE_ALIGN:

      tile_ptr (n_tiles + 1,): the first entry of each tile;
      pos (N,): each entry's schedule position, -1 on the padding;
      slots (K * N,): tile t's block of K rows of n_pad (its padded entry
          count) from K * tile_ptr[t]: each entry's sources as entries of
          its tile, in the order of `ups`, -1 where none;
      lvl_ptr (n_tiles + 1,), lvl_off: tile t's level offsets
          lvl_off[lvl_ptr[t]:lvl_ptr[t + 1]], from 0 to its entry count;
      width (n_tiles,): the most entries of a level of each tile;
      pad: the positions left out, ascending;
      ring (R * N,), with `ring`: each entry's record of R = 4 * ceil((K +
          1) / 4) int32 (16-byte aligned): its position, then its sources'
          offsets into the level just below, in the order of `ups`, -1
          where none (and on the padding).

    Also returns counts for the reports: trees, the largest tree, the most
    levels of a tile, the largest tile."""
    if cap < 1:
        raise ValueError(f"sweep_tiles: cap {cap} < 1")
    down = np.asarray(down_pos, np.int64)
    ups = np.asarray(ups, np.int64)
    K = ups.shape[0]
    keep = np.ones(p_pad, bool) if keep is None else np.asarray(keep, bool)
    idx = np.flatnonzero(keep)
    n = idx.size

    # depth below the root and the root, from the roots up through `ups`
    depth = np.full(p_pad, -1, np.int64)
    root = np.full(p_pad, -1, np.int64)
    front = np.flatnonzero((down >= p_pad) & keep)
    root[front] = front
    d = 0
    while front.size:
        depth[front] = d
        src = ups[:, front]
        on = src >= 0
        root[src[on]] = np.broadcast_to(root[front], src.shape)[on]
        front = src[on]
        d += 1
    if (depth[idx] < 0).any():
        raise ValueError("sweep_tiles: the graph has a cycle, or an edge ends outside `keep`")
    if (depth[~keep] >= 0).any() or (down[~keep] < p_pad).any():
        raise ValueError("sweep_tiles: a position left out of `keep` has an edge")

    # trees by depth class, deepest first, in the order of their roots within
    # a class, packed whole into tiles of <= cap
    depth_k = depth[idx]
    roots, tree_of, size = np.unique(root[idx], return_inverse=True, return_counts=True)
    height = np.zeros(roots.size, np.int64)
    np.maximum.at(height, tree_of, depth_k)
    rank = np.lexsort((roots, -np.ceil(np.log2(height + 1))))
    cum = np.cumsum(size[rank])
    first = []
    i = 0
    while i < roots.size:
        first.append(i)
        base = cum[i - 1] if i else 0
        i = max(int(np.searchsorted(cum, base + cap, side="right")), i + 1)
    opens = np.zeros(roots.size, np.int64)
    opens[first[1:]] = 1
    tile_of_tree = np.empty(roots.size, np.int64)
    tile_of_tree[rank] = np.cumsum(opens)
    tile = tile_of_tree[tree_of]
    n_tiles = len(first)
    levels = np.zeros(n_tiles, np.int64)
    np.maximum.at(levels, tile, depth_k + 1)
    level = levels[tile] - 1 - depth_k
    order = np.lexsort((idx, level, tile))
    count = np.bincount(tile, minlength=n_tiles)
    padded = -(-count // TILE_ALIGN) * TILE_ALIGN
    tile_ptr = np.r_[0, np.cumsum(padded)]
    start = np.r_[0, np.cumsum(count)][:-1]
    t_sorted = tile[order]
    local = np.arange(n) - start[t_sorted]
    slot = np.empty(p_pad, np.int64)
    slot[idx[order]] = local
    N = int(tile_ptr[-1])
    pos = np.full(N, -1, np.int32)
    pos[tile_ptr[t_sorted] + local] = idx[order]

    slots = np.full(K * N, -1, np.int32)
    base = K * tile_ptr[t_sorted] + local
    for k in range(K):
        src = ups[k, idx[order]]
        on = src >= 0
        slots[base[on] + k * padded[t_sorted[on]]] = slot[src[on]]

    lvl_ptr = np.r_[0, np.cumsum(levels + 1)]
    at_level = np.bincount(lvl_ptr[tile] + 1 + level, minlength=int(lvl_ptr[-1]))
    run = np.cumsum(at_level)
    lvl_off = run - np.repeat(run[lvl_ptr[:-1]], levels + 1)
    out = {"tile_ptr": tile_ptr.astype(np.int32), "pos": pos, "slots": slots,
           "lvl_ptr": lvl_ptr.astype(np.int32), "lvl_off": lvl_off.astype(np.int32),
           "width": np.maximum.reduceat(at_level, lvl_ptr[:-1]).astype(np.int32),
           "pad": np.flatnonzero(~keep).astype(np.int32),
           "trees": int(roots.size), "largest_tree": int(size.max()),
           "levels": int(levels.max()), "largest_tile": int(count.max())}
    if ring:
        R = 4 * -(-(K + 1) // 4)
        entry = tile_ptr[t_sorted] + local
        lev = level[order]
        below = lvl_off[lvl_ptr[t_sorted] + np.maximum(lev - 1, 0)]
        rec = np.full((N, R), -1, np.int32)
        rec[entry, 0] = idx[order]
        for k in range(K):
            src = ups[k, idx[order]]
            on = src >= 0
            rec[entry[on], 1 + k] = slot[src[on]] - below[on]
        out["ring"] = rec.reshape(-1)
    return out
