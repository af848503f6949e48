"""Local-drain-direction (LDD) graph preprocessing — host-side NumPy.

The port's copy of lisflood_tpu/graph/ldd.py. Only the NumPy
implementations are kept: the JAX package's native C++ pass (graph_preproc.cpp) is an
accelerator of the same functions and gives identical schedules.

The routing *schedule* produced here (`build_schedule`) is the device-side
contract: pixels packed into fixed-width chunks such that every pixel's
upstream neighbours sit in strictly earlier chunks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# LDD keypad encoding: code -> (row shift, col shift); 5 = pit
LDD_OFFSETS = {
    1: (1, -1), 2: (1, 0), 3: (1, 1),
    4: (0, -1), 5: (0, 0), 6: (0, 1),
    7: (-1, -1), 8: (-1, 0), 9: (-1, 1),
}
PIT = 5


@dataclass
class FlowGraph:
    """Compressed-space drainage graph."""

    downstream: np.ndarray      # (P,) int32; index of downstream pixel, -1 = none (pit/MV)
    ldd: np.ndarray             # (P,) int8 compressed ldd codes (0 = missing)
    num_pixels: int

    @property
    def is_pit(self):
        return self.downstream == -1

    def upstream_counts(self):
        cnt = np.zeros(self.num_pixels, dtype=np.int32)
        valid = self.downstream >= 0
        np.add.at(cnt, self.downstream[valid], 1)
        return cnt

    def topo_distance(self):
        """Hop distance to the terminal pit: pits get 1, their upstreams 2, …
        (reference kinematic_wave_parallel.py:92-106)."""
        levels, rest = hop_levels(self.downstream)
        dist = -np.ones(self.num_pixels, dtype=np.int64)
        for i, lv in enumerate(levels):
            dist[lv] = i + 1
        down = self.downstream
        for p in rest:      # pixels that reach no pit, after all the others
            dist[p] = dist[down[p]] + 1
        return dist

    def topo_order_down_up(self):
        """Pixel indices ordered outlets-first (each pixel after its
        downstream neighbour): the hop levels from the pits, each in
        ascending index order, then the pixels that reach no pit (a cycle
        of missing-ldd cells) as if they were pits."""
        levels, rest = hop_levels(self.downstream)
        return np.concatenate([np.zeros(0, np.int64), *levels, rest])

    def upstream_lists(self):
        """List of immediate upstream pixel indices per pixel."""
        lists = [[] for _ in range(self.num_pixels)]
        for p in np.flatnonzero(self.downstream >= 0):
            lists[self.downstream[p]].append(int(p))
        return lists

    def accuflux(self, material):
        """Accumulated flux: for each pixel the sum of `material` over all
        upstream pixels incl. itself (PCRaster accuflux), headwaters first:
        a pixel adds its upstream pixels' totals in descending index order,
        one hop level at a time (np.add.at adds in the order given)."""
        acc = np.asarray(material, dtype=np.float64).copy()
        down = self.downstream
        levels, rest = hop_levels(down)
        for p in rest[::-1]:
            acc[down[p]] += acc[p]
        for lv in reversed(levels[1:]):
            kids = lv[::-1]
            np.add.at(acc, down[kids], acc[kids])
        return acc

    def catchment_labels(self, point_ids=None):
        """Label every pixel with the id of its terminal pit: pits numbered
        1..Npits in compressed (row-major) order (reference
        routing.py:168-178), or `point_ids` at the pits when given."""
        labels = np.zeros(self.num_pixels, dtype=np.int32)
        pits = np.flatnonzero(self.downstream < 0)
        if point_ids is None:
            labels[pits] = np.arange(1, pits.size + 1, dtype=np.int32)
        else:
            labels[pits] = point_ids[pits]
        down = self.downstream
        levels, rest = hop_levels(down)
        for lv in levels[1:]:
            labels[lv] = labels[down[lv]]
        for p in rest:
            labels[p] = labels[down[p]]
        return labels

    def downstream_value(self, values, pit_value=None):
        """Value of `values` at the downstream pixel; at pits the pixel's own
        value (PCRaster downstream)."""
        values = np.asarray(values)
        out = values.copy()
        valid = self.downstream >= 0
        out[valid] = values[self.downstream[valid]]
        if pit_value is not None:
            out[~valid] = pit_value
        return out

    def upstream_sum(self, values):
        """Sum of `values` over immediate upstream pixels (PCRaster upstream)."""
        out = np.zeros(self.num_pixels, dtype=np.float64)
        valid = self.downstream >= 0
        np.add.at(out, self.downstream[valid], np.asarray(values, dtype=np.float64)[valid])
        return out


def build_flow_graph(ldd_compressed, grid) -> FlowGraph:
    """Build the compressed-space FlowGraph from a compressed LDD vector.

    Cells whose LDD is missing (NaN/0) are isolated pits; cells draining
    outside the grid or into masked cells become pits (the net effect of
    PCRaster lddmask + the boundary guard in the reference's upDownLookups,
    kinematic_wave_parallel_tools.py:111-130)."""
    P = grid.num_pixels
    ldd = np.nan_to_num(np.asarray(ldd_compressed, dtype=np.float64), nan=0.0).astype(np.int8)
    # compressed index -> (row, col)
    flat_idx = np.flatnonzero(grid.land_flat)
    rows, cols = np.divmod(flat_idx, grid.ncols)
    # land lookup: (row, col) -> compressed index
    land_points = -np.ones(grid.nrows * grid.ncols, dtype=np.int64)
    land_points[flat_idx] = np.arange(P)

    downstream = -np.ones(P, dtype=np.int32)
    for code, (dr, dc) in LDD_OFFSETS.items():
        if code == PIT:
            continue
        sel = np.flatnonzero(ldd == code)
        if sel.size == 0:
            continue
        r2 = rows[sel] + dr
        c2 = cols[sel] + dc
        inside = (r2 >= 0) & (r2 < grid.nrows) & (c2 >= 0) & (c2 < grid.ncols)
        tgt = np.full(sel.size, -1, dtype=np.int64)
        tgt[inside] = land_points[r2[inside] * grid.ncols + c2[inside]]
        downstream[sel] = tgt.astype(np.int32)
    return FlowGraph(downstream=downstream, ldd=ldd, num_pixels=P)


def ldd_to_channel(ldd_compressed, is_channel):
    """LddToChan: set channel pixels to pits so runoff routes overland to the
    nearest channel (reference routing.py:125, lddrepair(ifthenelse(...)))."""
    ldd = np.asarray(ldd_compressed, dtype=np.float64).copy()
    ldd[np.asarray(is_channel, dtype=bool)] = PIT
    return ldd


def ldd_mask(ldd_compressed, keep):
    """lddmask: restrict the ldd to `keep` cells; others become missing (0)."""
    ldd = np.nan_to_num(np.asarray(ldd_compressed, dtype=np.float64), nan=0.0).copy()
    ldd[~np.asarray(keep, dtype=bool)] = 0.0
    return ldd


def cut_structures(ldd_compressed, graph: FlowGraph, is_structure):
    """Insert pits at cells immediately upstream of structures
    (reservoirs/lakes), so the kinematic wave stops there; the structure's
    outflow is re-injected downstream (reference structures.py:43-61).
    Returns (new_ldd, is_ups_of_structure)."""
    is_structure = np.asarray(is_structure, dtype=bool)
    down_ok = graph.downstream >= 0
    is_ups = np.zeros(graph.num_pixels, dtype=bool)
    is_ups[down_ok] = is_structure[graph.downstream[down_ok]]
    new_ldd = np.asarray(ldd_compressed, dtype=np.float64).copy()
    new_ldd[is_ups] = PIT
    return new_ldd, is_ups


@dataclass
class RoutingSchedule:
    """Chunked wavefront schedule for the kinematic-wave sweep.

    chunks:      (n_chunks, chunk) int32 pixel indices, padded with P;
    downstream:  (P+1,) int32 downstream index per pixel, P for pits/padding
                 (the reference's downstruct convention, routing.py:159-164).
    """

    chunks: np.ndarray
    downstream: np.ndarray
    num_pixels: int
    chunk_size: int

    @property
    def num_chunks(self):
        return self.chunks.shape[0]


def upstream_csr(downstream):
    """(ptr, src): the upstream pixels of pixel p are src[ptr[p]:ptr[p+1]],
    ascending (as FlowGraph.upstream_lists orders them)."""
    down = np.asarray(downstream, np.int64)
    P = down.size
    src = np.flatnonzero(down >= 0)
    tgt = down[src]
    ptr = np.zeros(P + 1, np.int64)
    np.cumsum(np.bincount(tgt, minlength=P), out=ptr[1:])
    return ptr, src[np.argsort(tgt, kind="stable")]


def _gather(ptr, src, pixels):
    """The upstream pixels of `pixels` in order, each pixel's ascending, and
    for each the index into `pixels` of the pixel it drains into."""
    lo, n = ptr[pixels], ptr[pixels + 1] - ptr[pixels]
    idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    return src[idx], np.repeat(np.arange(pixels.size), n)


def hop_levels(downstream):
    """(levels, rest): the pixels by hop distance to their pit, as a list of
    ascending index arrays (level 0 the pits, level i the pixels draining
    into level i-1), and the pixels that reach no pit (a cycle), ascending."""
    down = np.asarray(downstream, np.int64)
    ptr, src = upstream_csr(down)
    frontier = np.flatnonzero(down < 0)
    levels, seen = [], np.zeros(down.size, bool)
    while frontier.size:
        levels.append(frontier)
        seen[frontier] = True
        frontier = np.sort(_gather(ptr, src, frontier)[0])
    return levels, np.flatnonzero(~seen)


def graph_levels(downstream):
    """The hop levels of hop_levels (FlowGraph.topo_distance is i + 1 on
    level i). Raises ValueError where a pixel reaches no pit (a cycle)."""
    levels, rest = hop_levels(downstream)
    if rest.size:
        raise ValueError(f"{rest.size} pixels drain into a cycle")
    return levels


def build_schedule(graph: FlowGraph, chunk_size=256, order_graph=None) -> RoutingSchedule:
    """Pack pixels into fixed-width chunks in topological (headwater->outlet)
    order such that each pixel's upstream neighbours are in strictly earlier
    chunks (reference kinematic_wave_parallel.py:140-158, with consecutive
    sparse levels fused into one chunk).

    `order_graph` (optional) supplies extra ordering constraints: chunks are
    packed against its (superset) edge set while the schedule's downstream
    table stays `graph`'s. The structure-cut routing graph uses the pre-cut
    channel graph here so lake/reservoir cells land in chunks strictly after
    their upstream feeders, which the routing kernel's structure chains
    rely on.

    The pixels are taken headwaters (largest distance) first, by index
    within a distance, and a pixel joins the open chunk unless one of its
    upstream pixels is in it or it is full. A distance's upstream pixels all
    lie at the distance before, so within a distance only the pixels before
    the open chunk's first close can meet one, and the chunks after it close
    on width alone: a distance is a few array passes. A distance with an
    upstream pixel at the same distance (a cycle) is walked pixel by pixel."""
    P = graph.num_pixels
    og = order_graph if order_graph is not None else graph
    dist = og.topo_distance()
    # iterate headwaters (max dist) -> outlets (dist 1), stable by pixel index
    order = np.lexsort((np.arange(P), -dist))
    ptr, src = upstream_csr(og.downstream)
    C = int(chunk_size)
    chunk_of = -np.ones(P, dtype=np.int64)
    nc, cnt = 0, 0          # the open chunk and its pixels
    for g in np.split(order, np.flatnonzero(np.diff(dist[order])) + 1):
        if not g.size:
            continue
        ups, owner = _gather(ptr, src, g)
        if (dist[ups] == dist[g[0]]).any():
            for p in g:
                conflict = (chunk_of[src[ptr[p]:ptr[p + 1]]] == nc).any()
                if conflict or cnt >= C:
                    nc, cnt = nc + 1, 0
                chunk_of[p] = nc
                cnt += 1
            continue
        conflict = np.zeros(g.size, bool)
        conflict[owner[chunk_of[ups] == nc]] = True
        stop = np.flatnonzero(conflict | (cnt + np.arange(g.size) >= C))
        a = int(stop[0]) if stop.size else g.size
        chunk_of[g[:a]] = nc
        cnt += a
        if a < g.size:
            n = g.size - a
            chunk_of[g[a:]] = nc + 1 + np.arange(n) // C
            nc += 1 + (n - 1) // C
            cnt = n - (n - 1) // C * C
    n_chunks = nc + 1 if P else 0

    packed = np.full((n_chunks, chunk_size), P, dtype=np.int32)
    co = chunk_of[order]
    packed[co, np.arange(P) - np.searchsorted(co, co)] = order
    downstream = np.full(P + 1, P, dtype=np.int32)
    valid = graph.downstream >= 0
    downstream[:P][valid] = graph.downstream[valid]
    return RoutingSchedule(chunks=packed, downstream=downstream,
                           num_pixels=P, chunk_size=chunk_size)


def direction_codes(downstream, flat_idx, nrows, ncols):
    """Per-2D-cell LDD keypad code recomputed from a downstream table: 0
    where the pixel has no downstream. Returns (codes2d, all_adjacent)."""
    downstream = np.asarray(downstream)
    flat_idx = np.asarray(flat_idx, np.int64)
    codes2d = np.zeros(nrows * ncols, np.int8)
    valid = downstream >= 0
    src = flat_idx[valid]
    tgt = flat_idx[downstream[valid]]
    dr = tgt // ncols - src // ncols
    dc = tgt % ncols - src % ncols
    codes = np.zeros(src.size, np.int8)
    for code, (r_, c_) in LDD_OFFSETS.items():
        if code == PIT:
            continue
        codes[(dr == r_) & (dc == c_)] = code
    # every edge must be grid-adjacent for the stencil to be exact
    all_adjacent = bool((codes != 0).all())
    codes2d[src] = codes
    return codes2d, all_adjacent


def window_total(values2d, window_cells):
    """PCRaster windowtotal on the 2-D grid: sum over a square window of
    `window_cells` x `window_cells` cells centred on each cell (used by
    groundwaterSmooth, reference waterabstraction.py:602-628). NaN cells
    contribute 0."""
    k = int(window_cells)
    half = k // 2
    data = np.nan_to_num(np.asarray(values2d, dtype=np.float64), nan=0.0)
    # summed-area table with zero padding
    padded = np.zeros((data.shape[0] + k, data.shape[1] + k))
    padded[half:half + data.shape[0], half:half + data.shape[1]] = data
    sat = padded.cumsum(0).cumsum(1)
    sat = np.pad(sat, ((1, 0), (1, 0)))
    out = (sat[k:, k:] - sat[:-k, k:] - sat[k:, :-k] + sat[:-k, :-k])
    return out[: data.shape[0], : data.shape[1]]
