"""The yardstick of the per-layer shares: the card's peaks and the work of
each kernel's function, counted from the problem.

The work is counted from the model's sizes: its real pixels, the edges of
its graphs and its sub-steps, never from a kernel's padding lanes, tiles
or tables, so that any kernel doing the same function is judged against the
same count. An operation is an addition, a multiplication, a division, a
comparison or a selection; a `pow` counts POW_FLOPS (a base-2 logarithm and
an exponential on the special-function units, each a quarter of the FMA
rate) and a square root, exponential or sine SFU_FLOPS. Each input is read
once and each output written once, in float32 (ITEM bytes), and a graph
costs one int32 downstream index a pixel.

A kinematic-wave solve (Q + adx Q^beta = c, which has no closed form) is
counted at its least work, whatever solver a kernel or the reference uses:
one evaluation of the equation at its root (SOLVE). Any solver has to make
at least that, so a kernel with a cheaper solver than the reference's still
reads under 100%, and one that iterates more shows it as time, not as work.

`step_flops` counts the operations of the plain reference's step as it
runs them (reference/), the solves at SOLVE, the work of the whole step,
for its share of the card's peak.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM (data sheet, no sparsity): float32 outside the tensor
# cores and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
POW_FLOPS = 8
SFU_FLOPS = 4
ITEM = 4
INDEX = 4
# one kinematic-wave solve at a pixel and lane, as (plain, pow): the least
# work, one evaluation of q + adx q^beta - c (a multiplication, an addition,
# a subtraction and a pow); the reference's Newton makes 91 and 9
SOLVE = (3, 1)
# the constant of the solve (3 and 1 pow) and, in the sub-step loop, the
# storage and discharge round trip of the lane (5 and 2 pow)
CONST = (3, 1)
ROUND_TRIP = (5, 2)
# shared by the two lanes of a pixel at a sub-step with split routing: the
# sideflow (6), its split between the lanes (16), the discharge, its day
# sum and the floodplain's cross-section (6)
SPLIT_SHARED = 6 + 16 + 6
# the sub-step loop reads 15 values a pixel (the lateral and evaporation
# inflows, 8 parameters, the 5 routing states) and writes 8 (the 5 states,
# the day's discharge sum, the floodplain's cross-section, the sideflow)
LOOP_READ, LOOP_WRITE = 15, 8


def flops(plain, pows):
    return plain + pows * POW_FLOPS


def bound_ms(n_flops, n_bytes):
    """(ms, 'operations' or 'bytes'): the least time of the work."""
    t_ops, t_bytes = n_flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def substep_loop(pixels, edges, substeps, lanes=2):
    """(flops, bytes) of one day's channel sub-step loop (the sub-step
    kernel's function): `substeps` sub-steps of `lanes` lanes at every
    pixel, one addition an edge and lane of the structure-cut channel
    graph."""
    per_lane = flops(SOLVE[0] + CONST[0] + ROUND_TRIP[0], SOLVE[1] + CONST[1] + ROUND_TRIP[1])
    n = substeps * (pixels * (lanes * per_lane + SPLIT_SHARED) + lanes * edges)
    return n, pixels * ((LOOP_READ + LOOP_WRITE) * ITEM + INDEX)


def sweep(pixels, edges, lanes):
    """(flops, bytes) of one sweep of a graph (the overland sweep's and the
    natural sweep's function): the constant plus the sources' discharge
    and a solve at every pixel and lane; the constant and the coefficient
    read and the discharge written at each."""
    n = pixels * lanes * (1 + flops(*SOLVE)) + edges * lanes
    return n, pixels * (lanes * 3 * ITEM + INDEX)


def graph_sizes(model, members):
    """The sizes the counts take from the reference's model: its pixels and
    the edges of its channel (structure-cut) and overland graphs, for all
    members."""
    edges = lambda down: members * int((np.asarray(down) >= 0).sum())
    return {"pixels": members * len(model["down_kin"]), "channel_edges": edges(model["down_kin"]),
            "overland_edges": edges(model["down_tochan"])}


def day_bounds(graphs, substeps, router):
    """The least device time a day (ms) of each kernel's function on the
    graphs of the model (`pixels`, `channel_edges`, `overland_edges`), by
    kernel name, with what bounds it."""
    P = graphs["pixels"]
    out = {}
    if router == "packed":
        out["kinwave_substep"] = bound_ms(*substep_loop(P, graphs["channel_edges"], substeps))
        if graphs["overland_edges"]:
            out["kinwave_sweep"] = bound_ms(*sweep(P, graphs["overland_edges"], 3))
    else:
        ch_f, ch_b = sweep(P, graphs["channel_edges"], 2)
        ov_f, ov_b = sweep(P, graphs["overland_edges"], 3)
        out["kinwave_sharded"] = bound_ms(substeps * ch_f + ov_f, substeps * ch_b + ov_b)
    return out


def step_flops(torch, fn, solvers=()):
    """(result of fn(), the operations its torch calls made): every
    elementwise arithmetic, comparison or selection counts one a result
    element, a pow POW_FLOPS and a root, exponential or sine SFU_FLOPS.
    Each (module, name) of `solvers` names a kinematic-wave solve that fn
    calls through that module: a call counts flops(*SOLVE) an element of
    its result, and nothing of what it runs inside."""
    from torch.overrides import TorchFunctionMode

    weight = {n: 1 for n in (
        "add", "sub", "mul", "div", "true_divide", "neg", "abs", "where", "minimum", "maximum",
        "clamp", "clamp_min", "clamp_max", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
        "logical_or", "logical_not", "ceil", "sum", "index_add_", "isnan", "deg2rad",
        "__add__", "__radd__", "__iadd__", "__sub__", "__rsub__", "__isub__", "__mul__",
        "__rmul__", "__imul__", "__truediv__", "__rtruediv__", "__itruediv__", "__neg__",
        "__abs__", "__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__", "__and__",
        "__or__", "__invert__")}
    weight.update({n: POW_FLOPS for n in ("pow", "__pow__", "__rpow__", "__ipow__")})
    weight.update({n: SFU_FLOPS for n in ("sqrt", "exp", "sin", "log")})

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.total = 0
            self.inside = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            w = None if self.inside else weight.get(getattr(func, "__name__", ""))
            if w and isinstance(out, torch.Tensor):
                size = out.numel()
                if func.__name__ == "sum" and args:
                    size = args[0].numel()
                self.total += w * size
            return out

    def least(solve):
        def counted(*args, **kwargs):
            count.inside += 1
            try:
                out = solve(*args, **kwargs)
            finally:
                count.inside -= 1
            count.total += flops(*SOLVE) * out.numel()
            return out
        return counted

    saved = [(module, name, getattr(module, name)) for module, name in solvers]
    with Count() as count:
        for module, name, solve in saved:
            setattr(module, name, least(solve))
        try:
            result = fn()
        finally:
            for module, name, solve in saved:
                setattr(module, name, solve)
    return result, count.total
