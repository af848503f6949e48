"""Packed kinematic-wave routing — the port of lisflood_tpu/ops/kinwave_packed.py.

The schedule's pixels are renumbered host-side into *schedule order*, so
chunk ``c`` occupies positions ``[c*C, (c+1)*C)``, and a pixel's downstream
neighbour falls inside a bounded window of the next W chunks. The Newton
solvers reproduce the reference (kinematic_wave_parallel_tools.py:48-87)
with a fixed iteration count; the float32 beta=3/5 path solves the
transcendental-free polynomial v^5 + a*v^3 = c.

The JAX package's `_sweep` (an XLA scan that scatters each chunk's discharge
into a rolling window with a one-hot matrix product) is `kinwave_sweep`
here: the CUDA kernel csrc/kinwave_sweep.cu on a CUDA device, and its plain
PyTorch version `_sweep` on the CPU. The plain version runs chunk by chunk;
the kernel runs tiles of whole trees of the overland forest, level by level
(the tables of ops/wavefront.sweep_tiles, which the overland router builds
with the step). Both sum every position's upstream inflow from its sources in
ascending order (ops/wavefront.upstream_table), so they agree to rounding
and have the same bits in every run. The sweep serves overland routing on
schedules with edges (every catchment built from maps); an edge-free
schedule (the synthetic model marks every cell a channel) solves
elementwise with `newton_solve`.
"""
from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.collectives import all_gather
from .wavefront import SWEEP_CAP, TILE_ALIGN, sweep_tiles, upstream_table

NEWTON_TOL = 1e-12
# 6 masked q-space iterations reach <=1e-12 over the adversarial sweep in
# tests/test_kinwave.py; float32 iterates freeze at the ulp after 4
NEWTON_FIXED_ITERS = 6
NEWTON_FIXED_ITERS_F32 = 4
# v-space iteration count: 5 reach the float32 noise floor
NEWTON_V_ITERS = 5


def _root_est(x, p):
    """Exponent bit-hack estimate of x**p for float32 x > 0, p in (0, 1):
    scale the float's bit pattern linearly. Error <~7%, always polished by
    Newton. `.to(torch.int32)` truncates toward zero like numpy's astype."""
    i = x.view(torch.int32)
    f = i.to(torch.float32) * p + (1.0 - p) * 1065353216.0
    return f.to(torch.int32).view(torch.float32)


def _newton_v(cc, a, iters=NEWTON_V_ITERS):
    """Kinematic-wave solve for beta = 3/5 with no transcendentals:
    q + a*q^0.6 = cc with v = q^(1/5) is v^5 + a*v^3 = cc. Newton from the
    bit-hack guess min(cc^(1/5), (cc/a)^(1/3)) * 1.12 converges monotonically
    from above. Returns v (callers use v^3 = q^0.6 and v^5 = q).

    Caller contract: cc > 0 (mask cc <= NEWTON_TOL outside)."""
    va = _root_est(cc, 0.2)
    vb = _root_est(cc / a, 1.0 / 3.0)
    v = torch.minimum(va, vb) * 1.12
    for _ in range(iters):
        v2 = v * v
        v3 = v2 * v
        v4 = v2 * v2
        g = v * v4 + a * v3 - cc
        gp = 5.0 * v4 + 3.0 * a * v2
        v = v - g / gp
    return v


def newton_solve(const_plus_ups, a_dx_div_dt, beta, iters=None):
    """Solver dispatch for Q + a*dx/dt*Q^beta = const: float32 with
    beta = 3/5 takes the polynomial v-space path; float64 and any other beta
    the reference q-space iteration (_newton_unrolled)."""
    if const_plus_ups.dtype == torch.float32 and abs(float(beta) - 0.6) < 1e-9:
        small = const_plus_ups <= NEWTON_TOL
        cc = torch.where(small, 1.0, const_plus_ups)
        v = _newton_v(cc, a_dx_div_dt, iters=iters or NEWTON_V_ITERS)
        v3 = v * v * v
        return torch.where(small, 0.0, v3 * v * v)
    return _newton_unrolled(const_plus_ups, a_dx_div_dt, beta, iters)


def _newton_unrolled(const_plus_ups, a_dx_div_dt, beta, iters=None):
    """Newton-Raphson for Q + a*dx/dt*Q^beta = const_plus_ups with the
    reference's secant-bound initial guess and convergence mask, run for a
    fixed iteration count (converged lanes freeze)."""
    if iters is None:
        iters = (NEWTON_FIXED_ITERS_F32
                 if const_plus_ups.dtype == torch.float32 else NEWTON_FIXED_ITERS)
    inv_beta = 1.0 / beta
    b_minus_1 = beta - 1.0
    b_a_dx = beta * a_dx_div_dt

    small = const_plus_ups <= NEWTON_TOL
    c = torch.where(small, 1.0, const_plus_ups)

    a_cpui_pow = b_a_dx * c ** b_minus_1
    secant_bound = torch.where(
        a_cpui_pow <= 1.0,
        c / (1.0 + a_cpui_pow),
        c / (1.0 + a_cpui_pow ** inv_beta),
    )
    other_bound = ((c - secant_bound) / a_dx_div_dt) ** inv_beta
    q = 0.5 * (secant_bound + other_bound)
    prev = torch.full_like(q, -1.0)
    for _ in range(iters):
        powq = q ** beta
        err = q + a_dx_div_dt * powq - c
        active = (err.abs() > NEWTON_TOL) & (q != prev)
        q_next = torch.clamp_min(q - err / (1.0 + b_a_dx * powq / q), NEWTON_TOL)
        q, prev = torch.where(active, q_next, q), torch.where(active, q, prev)
    q = torch.where(q == NEWTON_TOL, 0.0, q)
    return torch.where(small, 0.0, q)


@dataclass
class PackedSchedule:
    """Host-side renumbering of a RoutingSchedule into schedule order."""

    perm: np.ndarray         # (p_pad,) position -> natural pixel index (P = padding)
    inv_perm: np.ndarray     # (P,) natural pixel -> position
    down_local: np.ndarray   # (n_chunks, C) int32 local window offset in [0, W*C]; W*C = none
    down_pos: np.ndarray     # (p_pad,) int32 downstream position, p_pad = pit/padding
    n_chunks: int
    chunk: int
    window: int              # W: max chunk distance to the downstream chunk
    num_pixels: int

    @property
    def p_pad(self):
        return self.n_chunks * self.chunk

    def pack_np(self, x, fill=0.0):
        """Host-side natural -> packed reorder of a trailing pixel axis."""
        x = np.asarray(x)
        shape = x.shape[:-1] + (1,)
        xp = np.concatenate([x, np.full(shape, fill, x.dtype)], axis=-1)
        src = np.where(self.perm < self.num_pixels, self.perm, self.num_pixels)
        return xp[..., src]


def pack_schedule(schedule) -> PackedSchedule:
    """Renumber a schedule (anything with `chunks`, `downstream`,
    `num_pixels`) into positions and express every pixel's downstream as a
    local offset into the window of the next W chunks."""
    P = int(schedule.num_pixels)
    chunks = np.asarray(schedule.chunks)          # (n_chunks, C), pad value = P
    n_chunks, C = chunks.shape
    perm = chunks.reshape(-1).astype(np.int64)    # position -> pixel (P = pad)
    p_pad = n_chunks * C
    valid = perm < P
    inv_perm = np.empty(P, dtype=np.int64)
    inv_perm[perm[valid]] = np.flatnonzero(valid)

    down_nat = np.asarray(schedule.downstream)    # (P+1,), P = pit
    pos = np.flatnonzero(valid)
    tgt_nat = down_nat[perm[valid]]
    has_down = tgt_nat < P
    tgt_pos = np.full(pos.size, -1, dtype=np.int64)
    tgt_pos[has_down] = inv_perm[tgt_nat[has_down]]

    src_chunk = pos // C
    delta = tgt_pos // C - src_chunk
    if has_down.any():
        if delta[has_down].min() < 1:
            raise ValueError("schedule: a downstream pixel is not in a later chunk")
        window = int(delta[has_down].max())
    else:
        window = 1
    down_local = np.full(p_pad, window * C, dtype=np.int32)
    local = tgt_pos - (src_chunk + 1) * C
    down_local[pos[has_down]] = local[has_down].astype(np.int32)
    down_pos = np.full(p_pad, p_pad, dtype=np.int32)
    down_pos[pos[has_down]] = tgt_pos[has_down].astype(np.int32)
    return PackedSchedule(perm=perm, inv_perm=inv_perm,
                          down_local=down_local.reshape(n_chunks, C),
                          down_pos=down_pos,
                          n_chunks=n_chunks, chunk=C, window=window,
                          num_pixels=P)


def _sweep(const_p, adx_p, ups, beta):
    """The plain version of the sweep, one chunk at a time.

    const_p/adx_p: (n_chunks, L, C); ups: (K, n_chunks * C) int64 source
    positions of every position, ascending, -1 = none. Returns q
    (n_chunks, L, C). Each chunk's inflow is the sum of its sources'
    discharges in the table's order, then the chunk's Newton solve."""
    n_chunks, L, C = const_p.shape
    qs = torch.zeros_like(const_p)
    for c in range(n_chunks):
        src = ups[:, c * C:(c + 1) * C]                       # (K, C)
        valid = src >= 0
        s = src.clamp_min(0)
        vals = qs[s // C, :, s % C]                           # (K, C, L)
        inflow = const_p.new_zeros(C, L)
        for k in range(src.shape[0]):
            inflow = inflow + torch.where(valid[k, :, None], vals[k], 0.0)
        qs[c] = newton_solve(inflow.T + const_p[c], adx_p[c], beta)
    return qs


@dataclass(frozen=True)
class SweepTiles:
    """The overland sweep's tables on one device: the tile tables of
    ops/wavefront.sweep_tiles, which the kernel reads, and the source table
    `ups` (K, p_pad), which the plain version reads. `count` and `padded`
    are the tiles' entry counts on the host; `stats` the host function's
    counts and the build's host seconds."""

    ups: torch.Tensor
    tile_ptr: torch.Tensor
    pos: torch.Tensor
    slots: torch.Tensor
    lvl_ptr: torch.Tensor
    lvl_off: torch.Tensor
    cap: int
    count: np.ndarray
    padded: np.ndarray
    stats: dict

    @property
    def n_tiles(self):
        return self.count.size

    def n_smem(self, n_fit):
        """The largest padded tile within the cap that `n_fit` entries of
        shared memory hold: tiles up to it keep q in shared memory."""
        ok = (self.count <= self.cap) & (self.padded <= n_fit)
        return int(self.padded[ok].max()) if ok.any() else 0


def sweep_tables(down_pos, ups, cap=SWEEP_CAP):
    """SweepTiles of a packed schedule's graph, from its down_pos (p_pad,)
    and its source table `ups`, a (K, p_pad) int32 tensor: on ups's device,
    tiles of at most `cap` positions."""
    t0 = time.perf_counter()
    device = ups.device
    tab = sweep_tiles(down_pos, ups.cpu().numpy(), ups.shape[1], cap)
    tile_ptr = tab["tile_ptr"].astype(np.int64)
    lvl_end = tab["lvl_off"][tab["lvl_ptr"][1:] - 1]
    dev = lambda k: torch.as_tensor(tab[k], device=device)
    stats = {k: tab[k] for k in ("trees", "largest_tree", "levels", "largest_tile")}
    stats["seconds"] = time.perf_counter() - t0
    return SweepTiles(ups=ups, tile_ptr=dev("tile_ptr"),
                      pos=dev("pos"), slots=dev("slots"), lvl_ptr=dev("lvl_ptr"),
                      lvl_off=dev("lvl_off"), cap=int(cap), count=lvl_end.astype(np.int64),
                      padded=np.diff(tile_ptr), stats=stats)


class _SweepArgs(ctypes.Structure):
    """Mirror of struct SweepArgs in csrc/kinwave_sweep.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_tiles", "chunk", "lanes", "K", "n_smem",
                                             "threads")]
                + [("beta", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in ("cst", "adx", "q", "tile_ptr", "pos", "slots",
                                                  "lvl_ptr", "lvl_off", "trace")])


@functools.cache
def _sweep_library():
    from . import _build
    lib = _build.load("kinwave_sweep")
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.kinwave_sweep_smem.argtypes = [ctypes.c_int, int_p, int_p]
    lib.kinwave_sweep_smem.restype = ctypes.c_int
    lib.kinwave_sweep_launch.argtypes = [ctypes.POINTER(_SweepArgs), ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.kinwave_sweep_launch.restype = ctypes.c_int
    lib.kinwave_sweep_error_string.argtypes = [ctypes.c_int]
    lib.kinwave_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _sweep_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"kinwave_sweep {what} failed: "
                           + lib.kinwave_sweep_error_string(rc).decode())


def sweep_fit(optin, static_bytes, L, K, itemsize):
    """The padded entries (a multiple of TILE_ALIGN) of the largest tile
    whose q and tables fit a block's shared memory: `optin` bytes a block
    can have, less the kernel's `static_bytes`, over the bytes of an entry
    (const/q and adx of L lanes, K source slots rounded up to 4 or 8 rows,
    one offset; as entry_bytes in csrc/kinwave_sweep.cu)."""
    entry = 2 * L * itemsize + 4 * (4 if K <= 4 else 8) + 4
    return max(optin - static_bytes, 0) // entry // TILE_ALIGN * TILE_ALIGN


@functools.cache
def _sweep_smem(device_index, is_double):
    """(opt-in shared bytes of a block, the kernel's static shared bytes) on
    one device, asked of the library once."""
    lib = _sweep_library()
    optin, static = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _sweep_check(lib, lib.kinwave_sweep_smem(is_double, ctypes.byref(optin),
                                                 ctypes.byref(static)), "shared memory query")
    return optin.value, static.value


# threads per block of the sweep kernel: four blocks of 512 fill an SM's 2,048
# threads, and most levels of a tile of SWEEP_CAP positions fit one round
SWEEP_THREADS = 512


def _launch_sweep(const_p, adx_p, tiles, beta, trace=None):
    """One launch of csrc/kinwave_sweep.cu on the current stream, one block
    per tile. The plan is left in `kinwave_sweep.last_plan`. `trace`, an
    int64 (n_tiles, 5) tensor on the card, gets each block's record (see
    sweep_trace)."""
    n_chunks, L, C = const_p.shape
    lib = _sweep_library()
    dev = const_p.device
    K = tiles.ups.shape[0]
    is_double = int(const_p.dtype == torch.float64)
    poly = int(const_p.dtype == torch.float32 and abs(float(beta) - 0.6) < 1e-9)
    n_smem = tiles.n_smem(sweep_fit(*_sweep_smem(dev.index, is_double), L, K,
                                    const_p.element_size()))
    q = torch.empty_like(const_p)
    args = _SweepArgs(n_tiles=tiles.n_tiles, chunk=C, lanes=L, K=K, n_smem=n_smem,
                      threads=SWEEP_THREADS,
                      beta=float(beta), cst=const_p.data_ptr(), adx=adx_p.data_ptr(),
                      q=q.data_ptr(), tile_ptr=tiles.tile_ptr.data_ptr(),
                      pos=tiles.pos.data_ptr(), slots=tiles.slots.data_ptr(),
                      lvl_ptr=tiles.lvl_ptr.data_ptr(), lvl_off=tiles.lvl_off.data_ptr(),
                      trace=None if trace is None else trace.data_ptr())
    smem = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _sweep_check(lib, lib.kinwave_sweep_launch(ctypes.byref(args), is_double, poly,
                                                   ctypes.c_void_p(stream), ctypes.byref(smem)),
                     "launch")
    kinwave_sweep.launches += 1
    kinwave_sweep.last_plan = {"tiles": tiles.n_tiles, "cap": tiles.cap,
                               "threads": SWEEP_THREADS,
                               "smem_bytes": smem.value,
                               "global_tiles": int((tiles.padded > n_smem).sum())}
    return q


def _check_sweep(const_p, adx_p, tiles):
    """Device, dtype, shape and contiguity of the sweep's operands and
    tables."""
    n_chunks, L, C = const_p.shape
    if const_p.numel() >= 2 ** 31:
        raise ValueError(f"const: {const_p.numel()} elements, the kernel indexes with int32")
    if const_p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"const: dtype {const_p.dtype}")
    if tuple(adx_p.shape) != tuple(const_p.shape) or adx_p.dtype != const_p.dtype:
        raise ValueError(f"adx: {tuple(adx_p.shape)} {adx_p.dtype}, want const's")
    ups = tiles.ups
    if ups.dim() != 2 or ups.shape[1] != n_chunks * C or not 1 <= ups.shape[0] <= 8:
        raise ValueError(f"ups: shape {tuple(ups.shape)}, want (1..8, {n_chunks * C})")
    n_tiles, N = tiles.n_tiles, int(tiles.padded.sum())
    want = {"tile_ptr": n_tiles + 1, "lvl_ptr": n_tiles + 1, "pos": N,
            "slots": ups.shape[0] * N, "lvl_off": None}
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


def kinwave_sweep(const_p, adx_p, tiles, beta):
    """One kinematic-wave time step over a packed schedule: const_p / adx_p
    (n_chunks, L, C) and the SweepTiles of its graph (sweep_tables). A CUDA
    tensor launches the kernel (and counts the launch in
    `kinwave_sweep.launches`), a CPU tensor runs the plain version `_sweep`;
    any other device raises. Returns q (n_chunks, L, C)."""
    _check_sweep(const_p, adx_p, tiles)
    kind = const_p.device.type
    if kind == "cuda":
        return _launch_sweep(const_p, adx_p, tiles, beta)
    if kind == "cpu":
        return _sweep(const_p, adx_p, tiles.ups.long(), beta)
    raise RuntimeError(f"no sweep kernel for device {kind!r}")


def sweep_trace(const_p, adx_p, tiles, beta):
    """One launch of the sweep kernel on CUDA tensors with each block's
    record, as a NumPy (n_tiles, 5) int64 array: the block's SM, the global
    nanosecond clock at its start and at its end, and its SM's cycles from
    its start to the end of its staging and to its end. Returns (q,
    records). The launch is counted as any other."""
    _check_sweep(const_p, adx_p, tiles)
    if const_p.device.type != "cuda":
        raise RuntimeError("sweep_trace: the records come from the kernel, on a CUDA device")
    trace = torch.zeros(tiles.n_tiles, 5, dtype=torch.int64, device=const_p.device)
    q = _launch_sweep(const_p, adx_p, tiles, beta, trace=trace)
    return q, trace.cpu().numpy()


kinwave_sweep.launches = 0
kinwave_sweep.last_plan = None


class PackedRouter:
    """Wavefront router over a packed schedule; natural-order interface
    (reference semantics: kinematic_wave_parallel.py:160-184 +
    kinematic_wave_parallel_tools.py:34-92)."""

    def __init__(self, schedule, device):
        ps = pack_schedule(schedule)
        self.ps = ps
        self.device = torch.device(device)
        # an edge-free graph (every pixel its own pit) solves elementwise
        self.no_edges = bool((ps.down_local == ps.window * ps.chunk).all())
        # gather indices: padding positions read slot P of a (P+1)-padded source
        self.perm = torch.as_tensor(
            np.where(ps.perm < ps.num_pixels, ps.perm, ps.num_pixels), device=self.device)
        self.inv_perm = torch.as_tensor(ps.inv_perm, device=self.device)
        self._tiles = {}

    @functools.cached_property
    def ups(self):
        """(K, p_pad) int32: every position's sources, ascending, -1 = none."""
        ps = self.ps
        has_down = ps.down_pos < ps.p_pad
        return torch.as_tensor(
            upstream_table(np.flatnonzero(has_down), ps.down_pos[has_down], ps.p_pad),
            device=self.device)

    def sweep_tiles(self, cap=SWEEP_CAP):
        """The sweep's SweepTiles at `cap`, built at first use, once per
        cap: only the router that sweeps, the overland one, pays for them
        (models/step.build_routers builds them with the step)."""
        if cap not in self._tiles:
            self._tiles[cap] = sweep_tables(self.ps.down_pos, self.ups, cap)
        return self._tiles[cap]

    def pack(self, x, fill=0.0):
        """Natural (..., P) -> packed (..., p_pad) reorder on the device."""
        xp = torch.cat([x, x.new_full(x.shape[:-1] + (1,), fill)], dim=-1)
        return xp[..., self.perm]

    def unpack(self, xp):
        """Packed (..., p_pad) -> natural (..., P)."""
        return xp[..., self.inv_perm]

    def pack_rows(self, rows, fills=None):
        """pack of each natural row of `rows`, with its fill of `fills` (0
        by default). A rank's router (RankPackedRouter) takes its halo's
        values from their owners here, for all the rows at once."""
        return [self.pack(x, f) for x, f in zip(rows, fills or [0.0] * len(rows))]

    def structures(self, prefix, x):
        """The entries of the lake ("lk") or reservoir ("rs") array `x`
        whose lanes the sub-step kernel runs: all of them."""
        return x

    def structure_state(self, ys):
        """The sub-step kernel's outputs `ys` with every structure's state:
        as they are."""
        return ys

    def sweep_operands(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) natural-order lanes -> the sweep's packed (const, adx)
        operands, each (n_chunks, L, C)."""
        ps = self.ps
        constant = self.pack(a_dx_div_dt * discharge ** beta + lateral_inflow)
        adx = self.pack(a_dx_div_dt, 1.0)
        shape = (constant.shape[0], ps.n_chunks, ps.chunk)
        return (constant.reshape(shape).transpose(0, 1).contiguous(),
                adx.reshape(shape).transpose(0, 1).contiguous())

    def route_batched(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, P) natural-order operands -> (L, P) routed discharge."""
        if self.no_edges:
            constant = a_dx_div_dt * discharge ** beta + lateral_inflow
            return newton_solve(constant, a_dx_div_dt, float(beta))
        qs = kinwave_sweep(*self.sweep_operands(discharge, lateral_inflow, a_dx_div_dt, beta),
                           self.sweep_tiles(), float(beta))
        return self.unpack(qs.transpose(0, 1).reshape(discharge.shape[0], self.ps.p_pad))

    def route(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """Single-lane convenience wrapper."""
        return self.route_batched(discharge[None], lateral_inflow[None],
                                  a_dx_div_dt[None], beta)[0]


# ---------------------------------------------------------------------------
# one rank's part of the packed routers (parallel/shard_model.py): the whole
# schedule's chunks that hold a position it owns or reads


class RankPackedRouter(PackedRouter):
    """One rank's PackedRouter (parallel/shard_model.PackedRankLayout). Its
    schedule `ps` is the rank's kept chunks of the whole packed schedule:
    every chunk that holds a position it owns or one of its halo (the
    positions of other ranks upstream of its own), in order, each lane where
    it was; the other lanes of those chunks are padding. So every edge of
    the whole schedule between kept lanes ends 1..W chunks later, and every
    source table keeps its order: the sub-step kernel and the sweep run on
    them unchanged and give the one-process bits at the rank's own and halo
    lanes.

    `part` holds, as NumPy arrays: `perm` (p_pad,) each local position's
    index among the rank's own pixels (n_own elsewhere) and `inv_perm` the
    reverse; `halo` the halo's local positions and `halo_src` where their
    values lie in the gathered send buffers (owner x send_max + index in
    the owner's send list); `send` the own pixels other ranks read, as
    indices among the rank's own; `send_max`; `exchange` (whether any rank
    has a halo: every rank then takes part); `no_edges` (the whole graph's);
    and for the channel `struct_rows` (prefix -> the structures on kept
    lanes, ascending) and `struct_src` (prefix -> (owned, owner, index)):
    each structure's owning rank and index among that rank's structures,
    and the positions of this rank's own structures among its kept ones.
    pack_rows takes the halo's rows from their owners (one all_gather of
    every row), structure_state every structure's state from its owner (one
    all_gather a step)."""

    def __init__(self, ps, part, group, device):
        self.ps = ps
        self.device = torch.device(device)
        self.group = group
        self.no_edges = bool(part["no_edges"])
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        self.perm, self.inv_perm = dev(part["perm"]), dev(part["inv_perm"])
        self.exchange, self.send_max = bool(part["exchange"]), int(part["send_max"])
        self.send, self.halo, self.halo_src = dev(part["send"]), dev(part["halo"]), dev(
            part["halo_src"])
        self.struct_rows = {k: dev(v) for k, v in part.get("struct_rows", {}).items()}
        self.struct_src = part.get("struct_src", {})
        self._struct_gather = None
        self._tiles = {}

    def pack_rows(self, rows, fills=None):
        """The natural rows `rows` (each (..., n_own)) -> packed (...,
        p_pad): the rank's own values, its halo's from their owners in one
        all_gather of every row (when any rank has a halo), `fills` (0 by
        default) on the other lanes."""
        fills = fills or [0.0] * len(rows)
        flat = [x.reshape(-1, x.shape[-1]) for x in rows]
        x = torch.cat(flat)
        fill = torch.cat([x.new_full((f.shape[0], 1), v) for f, v in zip(flat, fills)])
        xp = torch.cat([x, fill], 1).index_select(1, self.perm)
        if self.exchange:
            buf = x.new_zeros(x.shape[0], self.send_max)
            buf[:, :self.send.numel()] = x.index_select(1, self.send)
            got = all_gather(buf, self.group).transpose(0, 1).reshape(x.shape[0], -1)
            xp.index_copy_(1, self.halo, got.index_select(1, self.halo_src))
        out, i = [], 0
        for r, f in zip(rows, flat):
            out.append(xp[i:i + f.shape[0]].reshape(r.shape[:-1] + (-1,)))
            i += f.shape[0]
        return out

    def sweep_operands(self, discharge, lateral_inflow, a_dx_div_dt, beta):
        """(L, n_own) natural lanes -> the sweep's (const, adx) operands on
        the kept chunks, (n_chunks, L, C), the halo's from their owners."""
        ps = self.ps
        constant = a_dx_div_dt * discharge ** beta + lateral_inflow
        constant, adx = self.pack_rows([constant, a_dx_div_dt.expand_as(constant)], [0.0, 1.0])
        shape = (constant.shape[0], ps.n_chunks, ps.chunk)
        return (constant.reshape(shape).transpose(0, 1).contiguous(),
                adx.reshape(shape).transpose(0, 1).contiguous())

    def structures(self, prefix, x):
        """The entries of `x` of the structures on kept lanes."""
        return x.index_select(0, self.struct_rows[prefix])

    def structure_state(self, ys):
        """Every structure's entries of the kernel's outputs `ys` (the
        structures on kept lanes) from the rank that owns its cell: one
        all_gather of each rank's own structures' entries."""
        if not self.struct_rows:
            return ys
        keys = {p: sorted(k for k in ys if k.startswith(p + "_")) for p in self.struct_rows}
        if self._struct_gather is None:
            self._struct_gather = self._gather_plan({p: len(k) for p, k in keys.items()})
        width, owned, src = self._struct_gather
        mine = [torch.stack([ys[k] for k in keys[p]]).index_select(1, owned[p]).reshape(-1)
                for p in keys]
        x = torch.cat(mine)
        buf = x.new_zeros(width)
        buf[:x.numel()] = x
        got = all_gather(buf, self.group).reshape(-1)
        out = dict(ys)
        for p, ks in keys.items():
            vals = got.index_select(0, src[p].reshape(-1)).reshape(src[p].shape)
            out.update(zip(ks, vals))
        return out

    def _gather_plan(self, n_keys):
        """(buffer width, the positions of the rank's own structures among
        its kept ones, each structure's entries' places in the gathered
        buffers) for `n_keys` entries of each prefix: rank o's buffer holds
        its own structures' entries, prefix by prefix, key-major."""
        n_ranks = max(int(o.max(initial=-1)) for _, o, _ in self.struct_src.values()) + 1
        base = np.zeros(n_ranks, np.int64)
        offset = {}
        for p, (_, owner, index) in self.struct_src.items():
            counts = np.bincount(owner, minlength=n_ranks)
            offset[p] = base[owner] + np.arange(n_keys[p])[:, None] * counts[owner] + index
            base += n_keys[p] * counts
        width = max(int(base.max()), 1)
        src = {p: torch.as_tensor(self.struct_src[p][1] * width + off, device=self.device)
               for p, off in offset.items()}
        owned = {p: torch.as_tensor(o, device=self.device)
                 for p, (o, _, _) in self.struct_src.items()}
        return width, owned, src
