"""The soil Courant tail (K8): sub-steps 1..no_subs-1 of the three-layer
Darcy seepage, the port of the tail of lisflood_tpu/ops/physics.py
soil_columns_step (`tail_loop`, a lax.while_loop over the lanes that
lax.top_k compacts, with a whole-grid fallback on overflow).

`soil_tail` runs the CUDA kernel csrc/soil_tail.cu on CUDA tensors (a
block a tile of lanes, in rounds of ROUND interleaved across the grid,
which compacts the lanes that sub-step in shared memory, groups them by
count and runs them 32 to a warp, the longest first: one launch a step, no
read on the host; counted in `soil_tail.launches`) and the plain version
`soil_tail_reference` on CPU tensors; any other device raises. The plain
version compacts the lanes that sub-step with `nonzero` and loops to the
largest count, every update masked per lane in the kernel's order, so the
two compute the same operations on every lane.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# the float parameters and the masks the tail reads, in the order of
# SoilTailArgs.par and .psnz in csrc/soil_tail.cu
FLOAT_KEYS = ("WRes1a", "WRes1b", "WRes2", "WS1a", "WS1b", "WS2",
              "KSat1a", "KSat1b", "KSat2", "GenuInvM1a", "GenuInvM1b",
              "GenuInvM2", "GenuM1a", "GenuM1b", "GenuM2")
MASK_KEYS = ("PoreSpaceNotZero1a", "PoreSpaceNotZero1b", "PoreSpaceNotZero2")
SOIL_KEYS = FLOAT_KEYS + MASK_KEYS

# the kernel's threads a block, lanes whose counts a block reads a round (4
# a thread) and the most lanes a tile (kThreads, kRound, kTile in
# csrc/soil_tail.cu); a tile is the fewest whole rounds that keep the grid
# within BLOCKS_PER_SM blocks for each of the card's SMs, the blocks of
# float32 lanes that fit on an SM at once (by registers), so that every
# lane's chain starts in the first wave
THREADS = 256
ROUND = 4 * THREADS
TILE = 7 * ROUND
BLOCKS_PER_SM = 4


def tile_lanes(n, sms):
    """The lanes of a tile for `n` lanes on a card of `sms` SMs: the fewest
    whole rounds that give at most BLOCKS_PER_SM blocks an SM, at most
    TILE."""
    want = -(-n // (sms * BLOCKS_PER_SM))
    return min(TILE, max(ROUND, -(-want // ROUND) * ROUND))


def unsat_conductivity(w, psnz, wres, ws, ksat, inv_m, m):
    """Van Genuchten unsaturated conductivity of a layer from its storage
    `w` (soilloop.py): ksat sqrt(sat) (1 - (1 - sat^(1/m))^m)^2."""
    sat = torch.where(psnz, torch.clamp((w - wres) / torch.where(psnz, ws - wres, 1.0), 0.0, 1.0), 0.0)
    return ksat * torch.sqrt(sat) * (1 - (1 - sat ** inv_m) ** m) ** 2


def soil_tail_reference(aw, seep, no_subs, dt_sub, q):
    """The plain version: `aw` the three layers' storage above the residual
    after sub-step 0, `seep` their seepage sums after it (updated in place
    and returned), `no_subs` (int32) and `dt_sub` each lane's count and
    sub-step length, `q` the parameters of SOIL_KEYS; all of one shape. The
    lanes with more than one sub-step are compacted and iterate together,
    a lane's update masked once its count is reached."""
    shape = no_subs.shape
    idx = torch.nonzero((no_subs > 1).reshape(-1)).squeeze(1)
    if not idx.numel():
        return seep
    g = lambda x: torch.broadcast_to(x, shape).reshape(-1)[idx]
    q = {k: g(q[k]) for k in SOIL_KEYS}
    ns_t, dtsub_t = g(no_subs), g(dt_sub)
    a1a, a1b, a2 = (g(x) for x in aw)
    sa, sb, sgw = (g(x) for x in seep)
    # caps recomputed from the current storage each sub-step, which equals
    # the explicit cap carry of soilloop.py
    for i in range(1, int(ns_t.max())):
        active = i < ns_t
        wt1a = a1a + q["WRes1a"]
        wt1b = a1b + q["WRes1b"]
        wt2 = a2 + q["WRes2"]
        k1a = unsat_conductivity(wt1a, q["PoreSpaceNotZero1a"], q["WRes1a"], q["WS1a"], q["KSat1a"], q["GenuInvM1a"], q["GenuM1a"])
        k1b = unsat_conductivity(wt1b, q["PoreSpaceNotZero1b"], q["WRes1b"], q["WS1b"], q["KSat1b"], q["GenuInvM1b"], q["GenuM1b"])
        k2 = unsat_conductivity(wt2, q["PoreSpaceNotZero2"], q["WRes2"], q["WS2"], q["KSat2"], q["GenuInvM2"], q["GenuM2"])
        s_a = torch.minimum(k1a * dtsub_t, q["WS1b"] - wt1b)
        s_b = torch.minimum(k1b * dtsub_t, q["WS2"] - wt2)
        s_g = torch.minimum(k2 * dtsub_t, a2)
        sel = lambda n, o: torch.where(active, n, o)
        a1a, a1b, a2 = sel(a1a - s_a, a1a), sel(a1b + s_a - s_b, a1b), sel(a2 + s_b - s_g, a2)
        sa, sb, sgw = sel(sa + s_a, sa), sel(sb + s_b, sb), sel(sgw + s_g, sgw)
    for full, comp in zip(seep, (sa, sb, sgw)):
        full.view(-1).index_copy_(0, idx, comp)
    return seep


# ---------------------------------------------------------------------------
# the kernel


class _SoilTailArgs(ctypes.Structure):
    """Mirror of struct SoilTailArgs in csrc/soil_tail.cu."""
    _fields_ = ([("n", ctypes.c_longlong)]
                + [(k, ctypes.c_void_p) for k in ("no_subs", "dt_sub", "aw1a", "aw1b", "aw2",
                                                  "seep_a", "seep_b", "seep_gw")]
                + [("par", ctypes.c_void_p * len(FLOAT_KEYS)),
                   ("psnz", ctypes.c_void_p * len(MASK_KEYS))])


@functools.cache
def _library():
    from . import _build
    lib = _build.load("soil_tail")
    lib.soil_tail_launch.argtypes = [ctypes.POINTER(_SoilTailArgs), ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.soil_tail_launch.restype = ctypes.c_int
    lib.soil_tail_error_string.argtypes = [ctypes.c_int]
    lib.soil_tail_error_string.restype = ctypes.c_char_p
    return lib


def _launch(aw, seep, no_subs, dt_sub, q):
    """One launch of csrc/soil_tail.cu on the current stream over every lane,
    in tiles of tile_lanes; the seepage sums are updated in place."""
    lib = _library()
    dev = no_subs.device
    tile = tile_lanes(no_subs.numel(), torch.cuda.get_device_properties(dev).multi_processor_count)
    ptr = lambda v: v.data_ptr()
    # a parameter of the lanes' shape is passed as it is (expand and
    # contiguous return it); a broadcast one is made whole first
    full = lambda v: v.expand(no_subs.shape).contiguous()
    params = [full(q[k]) for k in FLOAT_KEYS]
    masks = [full(q[k]) for k in MASK_KEYS]
    for k, v in zip(FLOAT_KEYS, params):
        if v.dtype != dt_sub.dtype or v.device != dev:
            raise TypeError(f"{k}: {v.dtype} on {v.device}, want {dt_sub.dtype} on {dev}")
    for k, v in zip(MASK_KEYS, masks):
        if v.dtype != torch.bool or v.device != dev:
            raise TypeError(f"{k}: {v.dtype} on {v.device}, want bool on {dev}")
    args = _SoilTailArgs(n=no_subs.numel(), no_subs=ptr(no_subs), dt_sub=ptr(dt_sub),
                         aw1a=ptr(aw[0]), aw1b=ptr(aw[1]), aw2=ptr(aw[2]),
                         seep_a=ptr(seep[0]), seep_b=ptr(seep[1]), seep_gw=ptr(seep[2]),
                         par=(ctypes.c_void_p * len(FLOAT_KEYS))(*map(ptr, params)),
                         psnz=(ctypes.c_void_p * len(MASK_KEYS))(*map(ptr, masks)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.soil_tail_launch(ctypes.byref(args), int(tile), int(dt_sub.dtype == torch.float64),
                                  ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("soil_tail launch failed: " + lib.soil_tail_error_string(rc).decode())
    soil_tail.launches += 1
    return seep


def _check(aw, seep, no_subs, dt_sub):
    if no_subs.dtype != torch.int32:
        raise TypeError(f"no_subs: dtype {no_subs.dtype}, want int32")
    if dt_sub.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dt_sub: dtype {dt_sub.dtype}")
    for name, v in (("no_subs", no_subs), ("dt_sub", dt_sub),
                    *((f"aw[{i}]", x) for i, x in enumerate(aw)),
                    *((f"seep[{i}]", x) for i, x in enumerate(seep))):
        if v.shape != no_subs.shape or v.device != no_subs.device or not v.is_contiguous():
            raise ValueError(f"{name}: {tuple(v.shape)} on {v.device}, want contiguous "
                             f"{tuple(no_subs.shape)} on {no_subs.device}")
        if name != "no_subs" and v.dtype != dt_sub.dtype:
            raise TypeError(f"{name}: dtype {v.dtype}, want {dt_sub.dtype}")


def soil_tail(aw, seep, no_subs, dt_sub, q):
    """Sub-steps 1..no_subs-1 of the soil's Darcy seepage on every lane:
    `aw` (aw1a, aw1b, aw2) the storage above the residual after sub-step 0,
    `seep` (seep_a, seep_b, seep_gw) the seepage sums after sub-step 0, both
    in the lanes' shape with `no_subs` (int32) and `dt_sub`; `q` the
    parameters of SOIL_KEYS. The sums are updated in place and returned:
    csrc/soil_tail.cu on CUDA tensors, the plain version on CPU tensors; any
    other device raises."""
    _check(aw, seep, no_subs, dt_sub)
    kind = no_subs.device.type
    if kind == "cuda":
        return _launch(aw, seep, no_subs, dt_sub, q)
    if kind == "cpu":
        return soil_tail_reference(aw, seep, no_subs, dt_sub, q)
    raise RuntimeError(f"no soil tail kernel for device {kind!r}")


soil_tail.launches = 0
