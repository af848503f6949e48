"""Subcatchment-aware domain decomposition — the port's counterpart of
lisflood_tpu/parallel/partition.py.

Pixels are partitioned into S shards along subtree boundaries, so that the
sharded sweep (ops/kinwave_sharded.py) is shard-local but for the few cut
LDD edges:

- whole catchments are bin-packed (LPT) onto shards, balanced by pixel
  count; a whole-catchment partition has no cut edge;
- a catchment larger than the shard budget is split at subtree roots, the
  largest subtrees that fit the budget, and what is left (the stem near the
  outlet) is one more unit; each split root's downstream link is a cut edge.

`catchment_partition` returns the JAX package's shard_of and stats bit for
bit. It reaches them with array passes over the graph's levels (hop distance
to the pit) instead of one scan of the pixels per catchment and a peeling
loop per oversized catchment, so that a graph of a million cells and as many
catchments partitions in seconds. The peel needs no loop: roots are visited
by decreasing subtree size, so every ancestor comes before its descendants,
and the units of an oversized catchment are exactly the subtrees whose root
fits the budget and whose parent does not.
"""
from __future__ import annotations

import heapq

import numpy as np

from ..graph.ldd import graph_levels, upstream_csr


def subtree_pixels(graph, root):
    """All pixels draining through `root` (inclusive), in the JAX package's
    depth-first order."""
    ptr, src = upstream_csr(graph.downstream)
    out = []
    stack = [int(root)]
    while stack:
        p = stack.pop()
        out.append(p)
        stack.extend(int(u) for u in src[ptr[p]:ptr[p + 1]])
    return np.asarray(out, dtype=np.int64)


def catchment_partition(graph, n_shards, slack=0.10):
    """Partition pixels into `n_shards` shards along subtree boundaries.

    Returns (shard_of, stats): shard_of is (P,) int32; stats carries the cut
    edges ((n, 2) int64 source, target) and the per-shard pixel counts."""
    P = graph.num_pixels
    down = np.asarray(graph.downstream, np.int64)
    if n_shards <= 1:
        return np.zeros(P, np.int32), {"cut_edges": np.zeros((0, 2), np.int64),
                                       "shard_sizes": np.array([P])}
    levels = graph_levels(down)
    # catchment labels 1..N (pits in pixel order) and subtree sizes
    labels = np.zeros(P, np.int64)
    labels[levels[0]] = np.arange(1, levels[0].size + 1)
    for lv in levels[1:]:
        labels[lv] = labels[down[lv]]
    upc = np.ones(P, np.int64)
    for lv in levels[:0:-1]:
        np.add.at(upc, down[lv], upc[lv])
    cap = int(np.ceil(P / n_shards) * (1.0 + slack))

    # units in the JAX package's order: catchments by label; an oversized
    # one gives its peeled subtrees by decreasing size, then its stem
    n_lab = levels[0].size
    size = np.bincount(labels, minlength=n_lab + 1)[1:]
    big = np.flatnonzero(size > cap) + 1
    in_big = np.isin(labels, big)
    fits = upc <= cap
    parent_fits = np.zeros(P, bool)
    has_down = down >= 0
    parent_fits[has_down] = fits[down[has_down]]
    is_root = in_big & fits & ~parent_fits
    root_of = np.where(is_root, np.arange(P), -1)
    for lv in levels[1:]:
        inner = lv[in_big[lv] & fits[lv] & ~is_root[lv]]
        root_of[inner] = root_of[down[inner]]

    n_units = np.ones(n_lab, np.int64)
    peeled, stems = {}, {}
    for lab in big:
        pix = np.flatnonzero(labels == lab)
        order = pix[np.argsort(-upc[pix])]
        peeled[lab] = order[is_root[order]]
        stems[lab] = np.count_nonzero(~fits[pix])
        n_units[lab - 1] = peeled[lab].size + (stems[lab] > 0)
    first = np.concatenate([[0], np.cumsum(n_units)[:-1]])
    unit_size = np.repeat(size, n_units)
    unit_of = first[labels - 1]
    for lab in big:
        u0 = first[lab - 1]
        roots = peeled[lab]
        unit_size[u0:u0 + roots.size] = upc[roots]
        root_unit = np.full(P, -1, np.int64)
        root_unit[roots] = u0 + np.arange(roots.size)
        mine = labels == lab
        unit_of[mine & fits] = root_unit[root_of[mine & fits]]
        if stems[lab]:
            unit_size[u0 + roots.size] = stems[lab]
            unit_of[mine & ~fits] = u0 + roots.size

    # LPT bin packing: units by decreasing size (stable), each to the shard
    # of least load, the first of equal loads
    heap = [(0, s) for s in range(n_shards)]
    unit_shard = np.empty(unit_size.size, np.int64)
    for u in np.argsort(-unit_size, kind="stable").tolist():
        load, s = heap[0]
        unit_shard[u] = s
        heapq.heapreplace(heap, (load + int(unit_size[u]), s))
    shard_of = unit_shard[unit_of].astype(np.int32)
    loads = np.bincount(shard_of, minlength=n_shards).astype(np.int64)

    # cut edges: LDD edges crossing shards
    src = np.flatnonzero(has_down)
    dst = down[src]
    cross = shard_of[src] != shard_of[dst]
    cut = np.stack([src[cross], dst[cross]], axis=1)
    return shard_of, {"cut_edges": cut, "shard_sizes": loads}
