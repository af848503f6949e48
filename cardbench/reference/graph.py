"""Drainage graphs in NumPy: levels, accumulated flux, catchments.

Frozen copies of the level-wise passes of lisflood_tpu_torch/graph/ldd.py
(commit c77b93b), used by the input generators and by the plain reference.
A graph is its `down` array: the downstream pixel of every pixel, -1 at a
pit.
"""
from __future__ import annotations

import numpy as np

# keypad code of a (row, column) step, as PCRaster's LDD numbers them
LDD_OFFSETS = {1: (1, -1), 2: (1, 0), 3: (1, 1), 4: (0, -1),
               6: (0, 1), 7: (-1, -1), 8: (-1, 0), 9: (-1, 1)}


def upstream_csr(down):
    """(ptr, src): the sources of pixel p are src[ptr[p]:ptr[p+1]], ascending."""
    down = np.asarray(down, np.int64)
    P = down.size
    src = np.flatnonzero(down >= 0)
    tgt = down[src]
    ptr = np.zeros(P + 1, np.int64)
    np.cumsum(np.bincount(tgt, minlength=P), out=ptr[1:])
    return ptr, src[np.argsort(tgt, kind="stable")]


def hop_levels(down):
    """The pixels by hop distance to their pit: level 0 the pits, level i
    the pixels draining into level i-1, each ascending. Raises where a
    pixel reaches no pit."""
    down = np.asarray(down, np.int64)
    ptr, src = upstream_csr(down)
    frontier = np.flatnonzero(down < 0)
    levels, seen = [], np.zeros(down.size, bool)
    while frontier.size:
        levels.append(frontier)
        seen[frontier] = True
        lo, n = ptr[frontier], ptr[frontier + 1] - ptr[frontier]
        idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
        frontier = np.sort(src[idx])
    if not seen.all():
        raise ValueError(f"{int((~seen).sum())} pixels drain into a cycle")
    return levels


def accuflux(down, material):
    """Sum of `material` over each pixel and everything upstream of it
    (PCRaster accuflux), headwaters first."""
    acc = np.asarray(material, dtype=np.float64).copy()
    down = np.asarray(down, np.int64)
    for lv in reversed(hop_levels(down)[1:]):
        kids = lv[::-1]
        np.add.at(acc, down[kids], acc[kids])
    return acc


def catchment_labels(down):
    """Every pixel labelled with its pit: pits 1..Npits in index order."""
    down = np.asarray(down, np.int64)
    labels = np.zeros(down.size, np.int32)
    pits = np.flatnonzero(down < 0)
    labels[pits] = np.arange(1, pits.size + 1, dtype=np.int32)
    for lv in hop_levels(down)[1:]:
        labels[lv] = labels[down[lv]]
    return labels


def upstream_sum(down, values):
    """Sum of `values` over each pixel's immediate sources."""
    down = np.asarray(down, np.int64)
    out = np.zeros(down.size)
    valid = down >= 0
    np.add.at(out, down[valid], np.asarray(values, np.float64)[valid])
    return out


def direction_codes(down, flat_idx, nrows, ncols):
    """(codes2d, all_adjacent): each cell's keypad code toward its
    downstream cell on the grid, 0 where it has none."""
    down = np.asarray(down, np.int64)
    flat_idx = np.asarray(flat_idx, np.int64)
    codes2d = np.zeros(nrows * ncols, np.int8)
    valid = down >= 0
    src = flat_idx[valid]
    tgt = flat_idx[down[valid]]
    dr = tgt // ncols - src // ncols
    dc = tgt % ncols - src % ncols
    codes = np.zeros(src.size, np.int8)
    for code, (r_, c_) in LDD_OFFSETS.items():
        codes[(dr == r_) & (dc == c_)] = code
    codes2d[src] = codes
    return codes2d, bool((codes != 0).all())


def sweep_levels(down):
    """The order a natural sweep takes: the pixels grouped by their longest
    path from a headwater (level 0 the headwaters), each group ascending, so
    that every source of a pixel lies in an earlier group. Returns the list
    of index arrays."""
    down = np.asarray(down, np.int64)
    P = down.size
    depth = np.zeros(P, np.int64)
    # the longest path from a headwater: walk the hop levels from the top
    for lv in reversed(hop_levels(down)[1:]):
        np.maximum.at(depth, down[lv], depth[lv] + 1)
    order = np.argsort(depth, kind="stable")
    cuts = np.flatnonzero(np.diff(depth[order])) + 1
    return np.split(order, cuts)
