"""The port's host graph passes (lisflood_tpu_torch/graph/ldd.py:
topo_distance, accuflux, catchment_labels, build_schedule), which walk hop
levels with array operations, against the per-pixel loops they replace,
kept here as the reference: the same arrays and the same bits, on the
synthetic drainage of several sizes, on a catchment's channel and overland
graphs (write_catchment), at several chunk widths, with an order graph, and
on a graph with a cycle, whose pixels reach no pit."""
import numpy as np
import pytest

from lisflood_tpu_torch.config import load_settings
from lisflood_tpu_torch.graph.ldd import FlowGraph, build_schedule, graph_levels, hop_levels
from lisflood_tpu_torch.models.initial import build_model
from lisflood_tpu_torch.models.synthetic import synthetic_drainage, write_catchment


def loop_order(g):
    """Outlets first, breadth first from the pits, the rest appended."""
    down, ups = g.downstream, g.upstream_lists()
    order, seen, queue = [], np.zeros(g.num_pixels, bool), list(np.flatnonzero(down < 0))
    while queue:
        nxt = []
        for p in queue:
            order.append(p)
            seen[p] = True
            nxt.extend(ups[p])
        queue = nxt
    return np.asarray(order + list(np.flatnonzero(~seen)), np.int64)


def loop_distance(g):
    dist = -np.ones(g.num_pixels, np.int64)
    for p in loop_order(g):
        d = g.downstream[p]
        dist[p] = 1 if d < 0 else dist[d] + 1
    return dist


def loop_accuflux(g, material):
    acc = np.asarray(material, np.float64).copy()
    for p in loop_order(g)[::-1]:
        d = g.downstream[p]
        if d >= 0:
            acc[d] += acc[p]
    return acc


def loop_labels(g):
    labels = np.zeros(g.num_pixels, np.int32)
    pits = np.flatnonzero(g.downstream < 0)
    labels[pits] = np.arange(1, pits.size + 1)
    for p in loop_order(g):
        d = g.downstream[p]
        if d >= 0:
            labels[p] = labels[d]
    return labels


def loop_chunks(graph, chunk_size, order_graph=None):
    P = graph.num_pixels
    og = order_graph if order_graph is not None else graph
    dist = loop_distance(og)
    order = np.lexsort((np.arange(P), -dist))
    chunk_of = -np.ones(P, np.int64)
    chunks, current, ups = [], [], og.upstream_lists()
    for p in order:
        if any(chunk_of[u] == len(chunks) for u in ups[p]) or len(current) >= chunk_size:
            chunks.append(current)
            current = []
        current.append(int(p))
        chunk_of[p] = len(chunks)
    if current:
        chunks.append(current)
    packed = np.full((len(chunks), chunk_size), P, np.int32)
    for i, ch in enumerate(chunks):
        packed[i, :len(ch)] = ch
    return packed


def drainage(n, m, seed):
    ldd, down = synthetic_drainage(n, m, seed)
    return FlowGraph(downstream=down, ldd=ldd, num_pixels=down.size)


@pytest.fixture(scope="module")
def catchment_graphs(tmp_path_factory):
    """The channel and overland graphs of a 48x40 catchment."""
    settings = load_settings(write_catchment(tmp_path_factory.mktemp("ldd"), 48, 40, seed=2,
                                             n_steps=1))
    aux = build_model(settings)[3]
    return {k: aux[k] for k in ("graph_kin", "graph_tochan")}


def check(g, order_graph=None, widths=(1, 7, 64, 256)):
    rng = np.random.default_rng(g.num_pixels)
    material = rng.lognormal(0, 2, g.num_pixels)
    np.testing.assert_array_equal(g.topo_distance(), loop_distance(g))
    assert np.array_equal(g.accuflux(material).view(np.int64),
                          loop_accuflux(g, material).view(np.int64))
    np.testing.assert_array_equal(g.catchment_labels(), loop_labels(g))
    for w in widths:
        np.testing.assert_array_equal(build_schedule(g, w, order_graph).chunks,
                                      loop_chunks(g, w, order_graph))


@pytest.mark.parametrize("shape,seed", [((1, 1), 0), ((16, 16), 1), ((60, 50), 2),
                                        ((120, 90), 3)])
def test_synthetic_drainage(shape, seed):
    """Distances, accumulated flux (bit for bit), labels and the schedule at
    four chunk widths against the loops."""
    check(drainage(*shape, seed))


def test_catchment_graphs(catchment_graphs):
    """A catchment's overland graph, and its channel graph (cut at the
    structures) packed against the overland graph's edges as well."""
    kin, tochan = catchment_graphs["graph_kin"], catchment_graphs["graph_tochan"]
    check(tochan)
    check(kin, order_graph=tochan, widths=(64, 256))


def test_cycle():
    """Pixels 5-7 drain in a cycle and 8 into it: they reach no pit. The
    levels leave them out (graph_levels refuses the graph) and every pass
    treats them as the loops do, after all the others."""
    down = np.array([-1, 0, 0, 1, -1, 6, 7, 5, 6, 4], np.int32)
    g = FlowGraph(downstream=down, ldd=np.zeros(down.size, np.int8), num_pixels=down.size)
    levels, rest = hop_levels(down)
    np.testing.assert_array_equal(rest, [5, 6, 7, 8])
    assert [lv.tolist() for lv in levels] == [[0, 4], [1, 2, 9], [3]]
    with pytest.raises(ValueError, match="cycle"):
        graph_levels(down)
    check(g, widths=(1, 2, 4))
