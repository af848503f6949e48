"""Local-drain-direction (LDD) graph preprocessing — host-side NumPy.

The port's copy of the parts of lisflood_tpu/graph/ldd.py that the synthetic
model and the routing schedule need. Only the NumPy implementations are
kept: the JAX package's native C++ pass (graph_preproc.cpp) is an
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

    def topo_distance(self):
        """Hop distance to the terminal pit: pits get 1, their upstreams 2, …
        (reference kinematic_wave_parallel.py:92-106)."""
        dist = -np.ones(self.num_pixels, dtype=np.int64)
        down = self.downstream
        for p in self.topo_order_down_up():
            d = down[p]
            dist[p] = 1 if d < 0 else dist[d] + 1
        return dist

    def topo_order_down_up(self):
        """Pixel indices ordered outlets-first (each pixel after its
        downstream neighbour). Iterative BFS from pits."""
        down = self.downstream
        ups_lists = self.upstream_lists()
        order = np.empty(self.num_pixels, dtype=np.int64)
        head = 0
        seen = np.zeros(self.num_pixels, dtype=bool)
        queue = list(np.flatnonzero(down < 0))
        while queue:
            nxt = []
            for p in queue:
                order[head] = p
                head += 1
                seen[p] = True
                nxt.extend(ups_lists[p])
            queue = nxt
        if head != self.num_pixels:
            # disconnected missing-ldd cells: append them as pits
            rest = np.flatnonzero(~seen)
            order[head:head + rest.size] = rest
        return order

    def upstream_lists(self):
        """List of immediate upstream pixel indices per pixel."""
        lists = [[] for _ in range(self.num_pixels)]
        for p in np.flatnonzero(self.downstream >= 0):
            lists[self.downstream[p]].append(int(p))
        return lists

    def accuflux(self, material):
        """Accumulated flux: for each pixel the sum of `material` over all
        upstream pixels incl. itself (PCRaster accuflux)."""
        acc = np.asarray(material, dtype=np.float64).copy()
        down = self.downstream
        for p in self.topo_order_down_up()[::-1]:   # headwaters first
            d = down[p]
            if d >= 0:
                acc[d] += acc[p]
        return acc

    def catchment_labels(self):
        """Label every pixel with the id of its terminal pit, pits numbered
        1..Npits in compressed (row-major) order (reference
        routing.py:168-178)."""
        labels = np.zeros(self.num_pixels, dtype=np.int32)
        pits = np.flatnonzero(self.downstream < 0)
        labels[pits] = np.arange(1, pits.size + 1, dtype=np.int32)
        down = self.downstream
        for p in self.topo_order_down_up():
            d = down[p]
            if d >= 0:
                labels[p] = labels[d]
        return labels

    def upstream_sum(self, values):
        """Sum of `values` over immediate upstream pixels (PCRaster upstream)."""
        out = np.zeros(self.num_pixels, dtype=np.float64)
        valid = self.downstream >= 0
        np.add.at(out, self.downstream[valid], np.asarray(values, dtype=np.float64)[valid])
        return out


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
    rely on."""
    P = graph.num_pixels
    og = order_graph if order_graph is not None else graph
    dist = og.topo_distance()
    # iterate headwaters (max dist) -> outlets (dist 1), stable by pixel index
    order = np.lexsort((np.arange(P), -dist))
    chunk_of = -np.ones(P, dtype=np.int64)
    chunks = []
    current = []
    ups_lists = og.upstream_lists()
    # a pixel joins the current chunk unless one of its upstreams is in it
    for p in order:
        conflict = any(chunk_of[u] == len(chunks) for u in ups_lists[p])
        if conflict or len(current) >= chunk_size:
            chunks.append(current)
            current = []
        current.append(int(p))
        chunk_of[p] = len(chunks)
    if current:
        chunks.append(current)

    packed = np.full((len(chunks), chunk_size), P, dtype=np.int32)
    for i, ch in enumerate(chunks):
        packed[i, : len(ch)] = ch
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
